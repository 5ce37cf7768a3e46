"""Command-line entry points of the port, one per reference eval script
(reference: seedx_tpu/inference/eval_cli.py):

  python -m seedx_tpu_torch.inference.eval_cli img2text --image X --question Q
      <- src/inference/eval_img2text_seed_x_i.py (--prompt_style pretrain:
         eval_img2text_seed_x.py)
  ... ground     --image X --question Q   <- eval_img2text_seed_x_i.py
  ... text2img   --caption C              <- eval_text2img_seed_x_i.py
  ... edit       --image X --instruction I <- eval_img2edit_seed_x_edit.py
  ... detokenize --image X [--condition Y] <- eval_seed_x_detokenizer.py /
                                     eval_seed_x_detokenizer_with_condition.py
  ... serve --requests reqs.jsonl [--engine batched|continuous [--paged]]
  ... chat

each with ``--debug [--device cpu]``.  Generated images are saved as PNGs
under ``--out_dir`` (default ``vis``) and their paths printed; with
``--score_against PATH`` the first is scored against that image
(``fidelity: {...}``, ``utils/image_metrics.score_images``).

JSONL in (one request per line: ``{"kind": "comprehend", "image": PATH,
"question": Q}``, ``{"kind": "t2i", "caption": C}``, ``{"kind": "edit",
"image": PATH, "instruction": I}`` or ``{"kind": "raw", "text": T}`` /
``{"input_ids": [...]}``, each with an optional ``max_new_tokens``; stdin
by default), one JSONL result per request out, in request order.
``--engine batched`` groups requests into prompt buckets
(``ServingEngine``); ``continuous`` runs a slot pool with rolling
admission (``ContinuousEngine``, ``--paged`` for the page pool), then the
SDXL adapter over each result's image spans; either engine warms up
(``warmup``: its captured decode programs) before the first request.  A
result's ``images`` lists
the saved PNGs of its generated images (null without any).

``chat`` reads one user turn per stdin line (``img:PATH text`` attaches an
image; ``exit`` or ``quit`` ends) and prints each reply (and the paths of
its images), over one ``ChatSession`` with its KV prefix cache.
``--spec_k`` decodes img2text, ground, text2img, edit and chat replies
with exact n-gram speculative decoding (greedy, one request at a time).

``--ckpt_root DIR`` builds the runtime from the release checkpoints
under DIR (the reference README's ./pretrained layout) through
``SeedXRuntime.from_pretrained`` with manifest validation (``--model``
picks the released model, ``--quantization`` the LLM's weights: int4 is
the serving config); ``--debug`` (or SEEDX_DEBUG=1) runs the tiny random
stack with the debug SDXL adapter.  Everything runs on the card unless
``--device cpu``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys


def _save_images(images, out_dir: str, stem: str):
    """[N, H, W, 3] floats in [0, 1] -> PNG paths under ``out_dir``."""
    import numpy as np
    from PIL import Image

    os.makedirs(out_dir, exist_ok=True)
    paths = []
    for i, img in enumerate(np.asarray(images)):
        path = os.path.join(out_dir, f"{stem}_{i}.png")
        Image.fromarray((np.clip(img, 0, 1) * 255).astype(np.uint8)
                        ).save(path)
        paths.append(path)
    return paths


def _load_runtime(args):
    from seedx_tpu_torch.inference.runtime import SeedXRuntime

    if args.debug or os.environ.get("SEEDX_DEBUG") in ("1", "True"):
        return SeedXRuntime.debug(device=args.device, with_adapter=True)
    if args.ckpt_root:
        return SeedXRuntime.from_pretrained(
            root=args.ckpt_root, model=args.model,
            quantization=args.quantization, device=args.device)
    raise SystemExit(
        "non-debug runtime requires the release checkpoints: pass "
        "--ckpt_root pretrained (reference README.md:74-87 layout) for "
        "real weights, or --debug / SEEDX_DEBUG=1 for the tiny random "
        "stack; power users can also assemble SeedXRuntime directly from "
        "seedx_tpu_torch.models.factory builders")


def _raw_request(rt, r):
    tok = rt.tokenizer
    return {"input_ids": r.get("input_ids")
            or [tok.bos_token_id] + tok.encode(r["text"])}


def _request(rt, r):
    """One JSONL line -> a generate_batch request dict (continuous
    engine)."""
    from PIL import Image

    from seedx_tpu_torch.inference.apps import _prepare_image_prompt
    from seedx_tpu_torch.text import prompts

    kind = r.get("kind", "raw")
    if kind in ("comprehend", "edit"):
        src = Image.open(r["image"]).convert("RGB")
        ids, cm, emb, ecm, pp = _prepare_image_prompt(
            rt, src, r["question" if kind == "comprehend" else "instruction"])
        return {"input_ids": ids, "image_embeds": emb,
                "embeds_cmp_mask": ecm, "ids_cmp_mask": cm,
                "patch_positions": pp}
    if kind == "t2i":
        tok = rt.tokenizer
        return {"input_ids": [tok.bos_token_id]
                + tok.encode(prompts.generation_prompt(r["caption"]))}
    return _raw_request(rt, r)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("command", choices=["img2text", "ground", "text2img",
                                       "edit", "detokenize", "chat",
                                       "serve"])
    p.add_argument("--requests",
                   help="JSONL file of requests (default stdin)")
    p.add_argument("--engine", default="batched",
                   choices=["batched", "continuous"],
                   help="bucket-batched ServingEngine or slot-pool "
                        "ContinuousEngine")
    p.add_argument("--max_batch_size", type=int, default=8)
    p.add_argument("--slots", type=int, default=8)
    p.add_argument("--paged", action="store_true",
                   help="--engine continuous: paged KV (shared page pool + "
                        "block tables; needs an int4 runtime)")
    p.add_argument("--pool_tokens", type=int, default=0,
                   help="paged KV pool size in tokens (default: the dense "
                        "footprint, slots x (max bucket + max_new_tokens))")
    p.add_argument("--image")
    p.add_argument("--condition")
    p.add_argument("--question", default="What is in this image?")
    p.add_argument("--caption", default="a red car on a beach")
    p.add_argument("--instruction", default="make it a sunset")
    p.add_argument("--prompt_style", default="instruct",
                   choices=["instruct", "pretrain"])
    p.add_argument("--max_new_tokens", type=int, default=512)
    p.add_argument("--num_inference_steps", type=int, default=50)
    p.add_argument("--solver", default="euler",
                   choices=["euler", "dpmpp_2m", "dpmpp_3m"],
                   help="diffusion sampler (euler: the reference's)")
    p.add_argument("--spec_k", type=int, default=0,
                   help="n-gram speculative decoding draft length (greedy "
                        "B=1 only; 0 disables): the same tokens, fewer "
                        "weight passes on self-similar replies")
    p.add_argument("--image_cfg", type=float, default=None,
                   help="edit: image_guidance_scale (default: the adapter "
                        "config's 1.5; exactly 1.0 drops the uncond CFG "
                        "branch)")
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--out_dir", default="vis")
    p.add_argument("--score_against", metavar="PATH",
                   help="text2img/edit/detokenize: score the first "
                        "generated image against this reference image "
                        "(SSIM/PSNR/MSE always; LPIPS when perceptual "
                        "weights are present), printed as a "
                        "'fidelity: {...}' line")
    p.add_argument("--ckpt_root", metavar="DIR",
                   help="release checkpoint root (the reference README's "
                        "./pretrained layout) — builds the REAL-weight "
                        "runtime via SeedXRuntime.from_pretrained with "
                        "manifest validation; see --model")
    p.add_argument("--model", default="seed_x_i",
                   choices=["seed_x", "seed_x_i", "seed_x_edit"],
                   help="which released model under --ckpt_root")
    p.add_argument("--quantization", default="none",
                   choices=["none", "int8", "int4"],
                   help="--ckpt_root: LLM weight quantization (int4 = the "
                        "single-card serving config)")
    p.add_argument("--debug", action="store_true")
    p.add_argument("--device", default="cuda",
                   help="torch device of the runtime (default: the card)")
    args = p.parse_args(argv)

    from PIL import Image

    from seedx_tpu_torch.inference import apps
    from seedx_tpu_torch.text import prompts

    rt = _load_runtime(args)
    if args.command == "chat":
        return _chat(rt, args)
    if args.command != "serve":
        return _app(rt, args)
    if args.requests:
        with open(args.requests) as f:
            reqs = [json.loads(ln) for ln in f if ln.strip()]
    else:
        reqs = [json.loads(ln) for ln in sys.stdin if ln.strip()]

    if args.engine == "batched":
        from seedx_tpu_torch.inference.serving import ServingEngine

        eng = ServingEngine(rt, max_batch_size=args.max_batch_size,
                            max_new_tokens=args.max_new_tokens,
                            num_inference_steps=args.num_inference_steps,
                            seed=args.seed,
                            image_guidance_scale=args.image_cfg).warmup()
        submit = {"comprehend": eng.submit_comprehend,
                  "edit": eng.submit_edit}
        for r in reqs:
            kind = r.get("kind", "raw")
            if kind in submit:
                src = Image.open(r["image"]).convert("RGB")
                submit[kind](src, r["question" if kind == "comprehend"
                                    else "instruction"])
            elif kind == "t2i":
                eng.submit_text_to_image(r["caption"])
            else:
                eng.submit_raw(_raw_request(rt, r))
        results = eng.flush()
    else:
        from seedx_tpu_torch.inference.continuous import ContinuousEngine

        eng = ContinuousEngine(rt, slots=args.slots,
                               max_new_tokens=args.max_new_tokens,
                               paged=args.paged,
                               pool_tokens=args.pool_tokens).warmup()
        order = [eng.submit(_request(rt, r),
                            max_new_tokens=r.get("max_new_tokens"))
                 for r in reqs]
        done = eng.run()
        results = [done[rid] for rid in order]
        for r, res in zip(reqs, results):
            res["images"] = None
            if res["has_img_output"] and rt.adapter is not None:
                cond = None
                if r.get("kind") == "edit":      # one condition per span
                    src = Image.open(r["image"]).convert("RGB")
                    cond = apps.condition_input(rt, src).expand(
                        res["num_gen_imgs"], -1, -1, -1)
                res["images"] = rt.adapter.generate(
                    res["img_gen_feat"], latent_image=cond, seed=args.seed,
                    num_inference_steps=args.num_inference_steps,
                    solver=args.solver,
                    image_guidance_scale=(args.image_cfg if cond is not None
                                          else None))
    for i, res in enumerate(results):
        paths = None
        if res.get("images") is not None:
            paths = _save_images(res["images"], args.out_dir, f"serve_{i}")
        print(json.dumps({
            "id": i, "text": prompts.strip_markup(res["text"]),
            "num_gen_imgs": int(res.get("num_gen_imgs", 0)),
            "images": paths}))
    return 0


def _app(rt, args) -> int:
    """img2text, ground, text2img, edit and detokenize (reference
    eval_cli.py): one app call, its text printed and its images saved."""
    from PIL import Image

    from seedx_tpu_torch.inference import apps

    image = Image.open(args.image).convert("RGB") if args.image else None
    gen = dict(seed=args.seed, num_inference_steps=args.num_inference_steps,
               solver=args.solver)
    images, stem = None, args.command
    if args.command == "img2text":
        out = apps.comprehend(rt, image, args.question,
                              prompt_style=args.prompt_style,
                              max_new_tokens=args.max_new_tokens,
                              spec_k=args.spec_k)
        print(out["clean_text"])
        return 0
    if args.command == "ground":
        out = apps.ground(rt, image, args.question,
                          max_new_tokens=args.max_new_tokens,
                          spec_k=args.spec_k)
        print(out["clean_text"])
        print("boxes:", out.get("boxes_pixels"))
        if out["boxes_image"] is not None:
            os.makedirs(args.out_dir, exist_ok=True)
            path = os.path.join(args.out_dir, "ground.png")
            out["boxes_image"].save(path)
            print("saved:", path)
        return 0
    if args.command == "text2img":
        out = apps.text_to_image(rt, args.caption,
                                 max_new_tokens=args.max_new_tokens,
                                 spec_k=args.spec_k, **gen)
        print(out["text"])
        images, stem = out["images"], "t2i"
    elif args.command == "edit":
        out = apps.edit_image(rt, image, args.instruction,
                              max_new_tokens=args.max_new_tokens,
                              spec_k=args.spec_k,
                              image_guidance_scale=args.image_cfg, **gen)
        print(out["text"])
        images = out["images"]
    else:                                # detokenize
        if args.condition:
            cond = Image.open(args.condition).convert("RGB")
            images = apps.reconstruct_with_condition(rt, image, cond, **gen)
        else:
            images = apps.reconstruct(rt, image, **gen)
        stem = "recon"
    if images is None:
        print("(no image span generated)")
    else:
        print("saved:", _save_images(images, args.out_dir, stem))
        if args.score_against:
            import numpy as np

            from seedx_tpu_torch.utils.image_metrics import score_images

            ref = Image.open(args.score_against).convert("RGB")
            print("fidelity:",
                  json.dumps(score_images(ref, np.asarray(images)[0])))
    return 0


def _chat(rt, args) -> int:
    """One ChatSession over stdin lines (reference eval_cli.py:196-220)."""
    from PIL import Image

    from seedx_tpu_torch.inference.chat import ChatSession

    session = ChatSession(rt)
    n_img = 0
    print("chat ready: 'img:PATH text' attaches an image, 'exit' quits",
          flush=True)
    for line in sys.stdin:
        line = line.strip()
        if not line:
            continue
        if line in ("exit", "quit"):
            break
        image = None
        if line.startswith("img:"):
            path, _, line = line[4:].partition(" ")
            image = Image.open(path).convert("RGB")
        out = session.send(line, image=image,
                           max_new_tokens=args.max_new_tokens,
                           num_inference_steps=args.num_inference_steps,
                           seed=args.seed, spec_k=args.spec_k)
        print(out["text"], flush=True)
        if out["images"] is not None:
            n_img += len(out["images"])
            print("saved:", _save_images(out["images"], args.out_dir,
                                         f"chat_{n_img}"), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
