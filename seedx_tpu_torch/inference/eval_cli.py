"""Command-line entry points of the port (reference:
seedx_tpu/inference/eval_cli.py): ``serve`` and ``chat``.

  python -m seedx_tpu_torch.inference.eval_cli serve --requests reqs.jsonl \\
      --debug [--device cpu] [--engine batched|continuous [--paged]]
  python -m seedx_tpu_torch.inference.eval_cli chat --debug [--device cpu]

JSONL in (one request per line: ``{"kind": "comprehend", "image": PATH,
"question": Q}``, ``{"kind": "t2i", "caption": C}``, ``{"kind": "edit",
"image": PATH, "instruction": I}`` or ``{"kind": "raw", "text": T}`` /
``{"input_ids": [...]}``, each with an optional ``max_new_tokens``; stdin
by default), one JSONL result per request out, in request order.
``--engine batched`` groups requests into prompt buckets
(``ServingEngine``); ``continuous`` runs a slot pool with rolling
admission (``ContinuousEngine``, ``--paged`` for the page pool).  The
SDXL adapter is not ported, so t2i / edit requests give text and
``images: null``.

``chat`` reads one user turn per stdin line (``img:PATH text`` attaches an
image; ``exit`` or ``quit`` ends) and prints each reply, over one
``ChatSession`` with its KV prefix cache.

``--debug`` (or SEEDX_DEBUG=1) runs the tiny random stack; the released
weights cannot be loaded yet.  Everything runs on the card unless
``--device cpu``.  The other subcommands (img2text, ground, text2img,
edit, detokenize) are not ported yet.
"""

from __future__ import annotations

import argparse
import json
import os
import sys


def _load_runtime(args):
    from seedx_tpu_torch.inference.runtime import SeedXRuntime

    if args.debug or os.environ.get("SEEDX_DEBUG") in ("1", "True"):
        return SeedXRuntime.debug(device=args.device)
    raise SystemExit(
        "non-debug runtime requires released checkpoints, which the port "
        "cannot load yet: pass --debug or SEEDX_DEBUG=1 for the tiny random "
        "stack")


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
    p.add_argument("command", choices=["serve", "chat"])
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
    p.add_argument("--max_new_tokens", type=int, default=512)
    p.add_argument("--debug", action="store_true")
    p.add_argument("--device", default="cuda",
                   help="torch device of the runtime (default: the card)")
    args = p.parse_args(argv)

    from PIL import Image

    from seedx_tpu_torch.text import prompts

    rt = _load_runtime(args)
    if args.command == "chat":
        return _chat(rt, args.max_new_tokens)
    if args.requests:
        with open(args.requests) as f:
            reqs = [json.loads(ln) for ln in f if ln.strip()]
    else:
        reqs = [json.loads(ln) for ln in sys.stdin if ln.strip()]

    if args.engine == "batched":
        from seedx_tpu_torch.inference.serving import ServingEngine

        eng = ServingEngine(rt, max_batch_size=args.max_batch_size,
                            max_new_tokens=args.max_new_tokens)
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
                               pool_tokens=args.pool_tokens)
        order = [eng.submit(_request(rt, r),
                            max_new_tokens=r.get("max_new_tokens"))
                 for r in reqs]
        done = eng.run()
        results = [done[rid] for rid in order]
    for i, res in enumerate(results):
        print(json.dumps({
            "id": i, "text": prompts.strip_markup(res["text"]),
            "num_gen_imgs": int(res.get("num_gen_imgs", 0)),
            "images": None}))
    return 0


def _chat(rt, max_new_tokens: int) -> int:
    """One ChatSession over stdin lines (reference eval_cli.py:196-220)."""
    from PIL import Image

    from seedx_tpu_torch.inference.chat import ChatSession

    session = ChatSession(rt)
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
        out = session.send(line, image=image, max_new_tokens=max_new_tokens)
        print(out["text"], flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
