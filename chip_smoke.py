"""Drive the PyTorch port's image-in comprehension turn once on one NVIDIA
GPU, at the full SEED-X-I width, and check its two CUDA kernels.

    python3 chip_smoke.py

Phases (each prints its own lines; any failure ends the run non-zero):

1. environment: torch / CUDA versions, the card's name and power limit;
   TF32 off for matmuls and cuDNN;
2. build: both kernels from ``seedx_tpu_torch/csrc`` (nvcc, sm_90a);
3. kernels: each against its plain PyTorch version at the turn's shapes
   (max abs / rel error against a stated tolerance; median of 10 timed
   runs after warm-up, CUDA events); a tiny stack on the card against the
   same weights on the CPU (plain versions);
4. the turn: ViT-bigG/14-448 (bf16) and the SEED-X agent (LLaMA2-13B,
   int4 weights, int8 KV cache, 64-query resamplers) with random weights
   drawn on the card from a seed; three ``comprehend`` requests on images
   of three aspect ratios and one ``generate`` request ending in ``<img>``
   (the forced 65-token chunk and the output resampler); launch counters
   reset just before and read just after;
5. a JSON line of the kernels, the ``nvidia-smi`` line, and last a JSON
   line ``{"ok": true, "device": {...}}``.

In the kernels line, ``max_abs_err`` is the largest over the kernel's
shapes, ``ms`` and ``plain_ms`` the sums of one call at each shape.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

import numpy as np


def log(msg: str) -> None:
    print(msg, flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, flush=None, warmup: int = 3, iters: int = 10) -> float:
    """Median milliseconds of ``fn`` over ``iters`` runs (CUDA events);
    ``flush`` (a buffer rewritten before each run) evicts the 50 MB L2 so
    weights stream from HBM as they do in the 40-layer decode."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        if flush is not None:
            flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def check_kernels(dev):
    """Phase 3: each kernel against its plain version at the slice shapes."""
    import torch

    from seedx_tpu_torch.ops import flash_attention as fa
    from seedx_tpu_torch.ops import int4_matmul as i4
    from seedx_tpu_torch.utils.quantize import quantize_kernel_int4

    g = torch.Generator(device=dev).manual_seed(1234)
    flush = torch.empty(96 << 20, dtype=torch.uint8, device=dev)
    rows = []

    # flash: (name, B, Sq, Skv, H, causal, start, end, q_offset); D = 128
    # (ViT-bigG's 104 is zero-padded to 128 by the dispatch)
    for name, b, sq, skv, h, causal, start, end, qoff in (
            ("vit_5tiles", 5, 1024, 1024, 16, False, 0, 1024, 0),
            ("prefill_512", 1, 512, 544, 40, True, 300, 512, 0),
            ("chunk_65", 1, 65, 544, 40, True, 300, 577, 512)):
        q, k, v = (torch.randn((b, s, h, 128), generator=g, device=dev
                               ).to(torch.bfloat16) for s in (sq, skv, skv))
        st = torch.full((b,), start, dtype=torch.int32, device=dev)
        en = torch.full((b,), end, dtype=torch.int32, device=dev)
        args = (q, k, v, st, en, qoff, causal, 128 ** -0.5)
        out, lse = fa.flash_fwd(*args)
        ref, lse_ref = fa.flash_fwd_plain(*args)
        torch.cuda.synchronize()
        err = (out.float() - ref.float()).abs().max().item()
        rel = err / ref.float().abs().max().item()
        live = lse_ref > -1e30
        lse_err = (lse[live] - lse_ref[live]).abs().max().item()
        tol = 2e-2      # bf16 output of O(1): a few ULPs + per-tile rescale
        ok = (err <= tol and lse_err <= 1e-3
              and torch.equal(lse > -1e30, live))
        ms = cuda_ms(lambda: fa.flash_fwd(*args))
        plain_ms = cuda_ms(lambda: fa.flash_fwd_plain(*args))
        log(f"kernel flash_fwd {name} B{b} Sq{sq} Skv{skv} H{h} D128 "
            f"causal={causal}: max_abs_err {err:.3e} max_rel_err {rel:.3e} "
            f"lse_err {lse_err:.3e} tol {tol:g} {'ok' if ok else 'FAIL'} "
            f"kernel {ms:.4f} ms plain {plain_ms:.4f} ms")
        rows.append(("flash_fwd", ok, err, ms, plain_ms))

    for n_in, n_out in ((5120, 5120), (5120, 13824), (13824, 5120)):
        w = torch.randn((n_in, n_out), generator=g, device=dev) * 0.02
        packed, scale = quantize_kernel_int4(w)
        del w
        for r in (1, 65, 512):
            x = torch.randn((r, n_in), generator=g,
                            device=dev).to(torch.bfloat16)
            out = i4.int4_matmul(x, packed, scale)
            ref = i4.int4_matmul_plain(x, packed, scale)
            torch.cuda.synchronize()
            mag = ref.float().abs().max().item()
            err = (out.float() - ref.float()).abs().max().item()
            # exact int32 group dots; fp32 split-K order differs; one bf16
            # rounding: two bf16 ULPs of the output magnitude
            tol = 2 * 2 ** -7 * mag
            ok = err <= tol
            ms = cuda_ms(lambda: i4.int4_matmul(x, packed, scale), flush)
            plain_ms = cuda_ms(lambda: i4.int4_matmul_plain(x, packed, scale),
                               flush)
            log(f"kernel int4_w4a8 rows{r} {n_in}->{n_out}: max_abs_err "
                f"{err:.3e} max_rel_err {err / mag:.3e} tol {tol:.3e} "
                f"{'ok' if ok else 'FAIL'} kernel {ms:.4f} ms plain "
                f"{plain_ms:.4f} ms")
            rows.append(("int4_w4a8", ok, err, ms, plain_ms))
    del flush
    return rows


def check_tiny_stack(dev):
    """A tiny int4 + int8-KV stack on the card (kernels) against the same
    weights on the CPU (plain versions): ViT features and prefill logits."""
    import torch
    from PIL import Image

    from seedx_tpu_torch.inference.apps import _prepare_image_prompt
    from seedx_tpu_torch.inference.runtime import SeedXRuntime

    rts = {d: SeedXRuntime.debug(seed=7, device=d, quantization="int4",
                                 kv_quantization="int8")
           for d in ("cpu", dev)}
    rts[dev].vit.load_state_dict(rts["cpu"].vit.state_dict())
    rts[dev].agent.load_state_dict(rts["cpu"].agent.state_dict())
    rng = np.random.default_rng(7)
    img = Image.fromarray((rng.random((90, 150, 3)) * 255).astype(np.uint8))
    res = {}
    for d, rt in rts.items():
        ids, cmp, emb, ecm, ppos = _prepare_image_prompt(rt, img, "Why?")
        with torch.no_grad():
            pe = rt.agent.embed_with_images(
                torch.as_tensor(ids, device=d)[None], emb,
                torch.as_tensor(cmp, device=d)[None],
                torch.as_tensor(ecm, device=d), ppos)
            pos = torch.arange(len(ids), device=d)[None]
            logits, _, _ = rt.agent.llm_step(pe, pos)
        res[d] = (emb.float().cpu(), logits.float().cpu())
    worst = 0.0
    for i, what in enumerate(("vit", "prefill_logits")):
        ref, got = res["cpu"][i], res[dev][i]
        rel = ((got - ref).abs().max() / ref.abs().max()).item()
        worst = max(worst, rel)
        log(f"tiny stack {what}: card vs CPU max_rel_err {rel:.3e}")
    # bf16 on both sides with different summation orders, and int8
    # activation / KV codes that can flip on a rounding edge
    tol = 5e-2
    if not worst <= tol:
        raise AssertionError(f"tiny stack disagrees: {worst:.3e} > {tol}")
    log(f"tiny stack: ok (tol {tol})")


def run_turn(dev):
    """Phase 4: the full-width turn through the public entry points."""
    import torch
    from PIL import Image

    from seedx_tpu_torch.inference.apps import comprehend
    from seedx_tpu_torch.inference.runtime import SeedXRuntime
    from seedx_tpu_torch.models.agent import AgentConfig
    from seedx_tpu_torch.models.llama import llama2_13b
    from seedx_tpu_torch.models.vit import qwen_vitg_448
    from seedx_tpu_torch.ops.flash_attention import flash_fwd
    from seedx_tpu_torch.ops.int4_matmul import int4_matmul

    t0 = time.perf_counter()
    agent_cfg = AgentConfig(
        llm=llama2_13b(quantization="int4", kv_quantization="int8"),
        vit_dim=4096, resampler_heads=32, num_img_in_tokens=64,
        num_img_out_tokens=64)
    rt = SeedXRuntime.random(qwen_vitg_448(), agent_cfg, seed=0, device=dev)
    torch.cuda.synchronize()
    log(f"turn: built ViT-bigG/14-448 bf16 + LLaMA2-13B int4/int8-KV agent "
        f"on the card in {time.perf_counter() - t0:.1f} s, "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated")

    rng = np.random.default_rng(0)
    images = [Image.fromarray((rng.random((h, w, 3)) * 255).astype(np.uint8))
              for w, h in ((448, 448), (896, 448), (896, 896))]
    tok = rt.tokenizer
    img_ids = [tok.bos_token_id] + tok.encode(
        "[INST] Generate an image: a red bicycle by a lake [/INST]\n<img>")

    torch.cuda.reset_peak_memory_stats()
    flash_fwd.launches = 0
    int4_matmul.launches = 0
    outs = []
    for i, img in enumerate(images):
        t = {}
        out = comprehend(rt, img, "Describe the image.", max_new_tokens=32,
                         timings=t)
        outs.append(out)
        log(f"request {i} comprehend {img.size[0]}x{img.size[1]}: "
            f"{t['n_tiles']} tiles, vit {t['vit'] * 1e3:.1f} ms, prefill "
            f"{t['prefill'] * 1e3:.1f} ms, decode {t['decode'] * 1e3:.1f} ms "
            f"for {t['decode_tokens']} tokens "
            f"({t['decode_tokens'] / t['decode']:.2f} tok/s)")
    t = {}
    gen = rt.generate(img_ids, max_new_tokens=72, timings=t)
    torch.cuda.synchronize()
    counts = {"flash_fwd": flash_fwd.launches,
              "int4_w4a8": int4_matmul.launches}
    log(f"request 3 generate <img>: prefill {t['prefill'] * 1e3:.1f} ms, "
        f"decode {t['decode'] * 1e3:.1f} ms for {t['decode_tokens']} tokens "
        f"in {t['decode_forwards']} forwards")
    log(f"turn: max_memory_allocated "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    log(f"turn: launches {json.dumps(counts)}")

    vocab = tok.vocab
    for out in outs:
        toks = np.asarray(out["tokens"])
        if not (toks.size and toks.min() >= 0
                and toks.max() < agent_cfg.llm.vocab_size):
            raise AssertionError(f"bad token stream {toks[:8]}")
    forced = list(range(vocab.img_token_start, vocab.img_token_start + 64))
    if list(gen["tokens"][:65]) != forced + [vocab.eoi]:
        raise AssertionError("the <img> request did not emit the forced span")
    feat = gen["img_gen_feat"]
    if feat is None or tuple(feat.shape) != (1, 64, 4096) or \
            not torch.isfinite(feat.float()).all():
        raise AssertionError(f"bad img_gen_feat: "
                             f"{None if feat is None else feat.shape}")
    log(f"turn: outputs ok (token ids in range, forced span, img_gen_feat "
        f"{tuple(feat.shape)} finite)")
    for name, n in counts.items():
        if n <= 0:
            raise AssertionError(f"kernel {name} was not launched by the turn")
    return counts


def main() -> int:
    import torch

    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]}")
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device (torch.cuda.is_available"
                         "() is False)")
    smi = nvidia_smi_line()
    log(f"card: {smi}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"tf32: matmul {torch.backends.cuda.matmul.allow_tf32} "
        f"cudnn {torch.backends.cudnn.allow_tf32}")
    dev = torch.device("cuda", 0)

    from seedx_tpu_torch.ops import _build
    from seedx_tpu_torch.ops import flash_attention as fa
    from seedx_tpu_torch.ops import int4_matmul as i4

    for name, lib in (("flash_fwd", fa.library), ("int4_w4a8", i4.library)):
        t0 = time.perf_counter()
        lib()
        secs, report = _build.build_log[name]
        regs = [ln.strip() for ln in report.splitlines() if "registers" in ln]
        log(f"build {name}: {time.perf_counter() - t0:.2f} s "
            f"(nvcc {secs:.2f} s; {'; '.join(regs) or 'cached'})")

    rows = check_kernels(dev)
    if not all(ok for _, ok, *_ in rows):
        raise AssertionError("a kernel disagrees with its plain version")
    check_tiny_stack(dev)

    counts = run_turn(dev)

    kernels = []
    for name, source, replaces in (
            ("flash_fwd", "seedx_tpu_torch/csrc/flash_fwd.cu",
             "seedx_tpu/ops/flash_attention.py:43"),
            ("int4_w4a8", "seedx_tpu_torch/csrc/int4_w4a8.cu",
             "seedx_tpu/ops/int4_matmul.py:49")):
        mine = [r for r in rows if r[0] == name]
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": counts[name],
            "max_abs_err": max(r[2] for r in mine),
            "ms": sum(r[3] for r in mine),
            "plain_ms": sum(r[4] for r in mine)})
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
