"""Drive the PyTorch port on one NVIDIA GPU at the full SEED-X-I width:
the image-in comprehension turn, batched / continuous (fused prefill too)
/ HTTP serving, multi-turn chat with a KV prefix cache, speculative
decoding and beam search, image out (the SDXL adapter: text to image,
reconstruction, editing), SEED-X SFT through the ``train_sft`` entry
point over the repo's YAMLs and files on disk, de-tokenizer (adapter)
training at the SDXL width and a runtime loaded from release checkpoint
files, and check its CUDA kernels.

    python3 chip_smoke.py

Phases (each prints its own lines; any failure ends the run non-zero):

1. environment: torch / CUDA versions, the card's name and power limit;
   TF32 off for matmuls and cuDNN;
2. build: the kernel sources of ``seedx_tpu_torch/csrc`` (one nvcc
   each, started together, sm_90a);
3. kernels: each against its plain PyTorch version at the shapes of the
   turn, of batched decode, of the fused step's stair (K3's multi-query
   mode) and of the attention backward (K4, K5; two runs bit-equal) of
   the SFT step and of adapter training (the UNet's self-attention), and
   the UNet's and VAE's GroupNorm (+ SiLU) and LayerNorm at 1024^2, and
   K6 at DeepSeek-V2-Lite's expert widths (a 32-slot decode step's rows,
   a 2048- and a 4096-token prefill's; ``torch._grouped_mm`` as the
   library yardstick), its relu2 epilogue and K7 (the Mamba-2 state step)
   at Nemotron-3-Nano's widths (max abs / rel error against a stated
   tolerance; median of 10 timed
   runs after warm-up, CUDA events), beside its bound (the larger
   of bytes / 3.35 TB/s and operations / the tensor cores' peak for the
   input type) and, where one exists, the time of the PyTorch call
   computing the same function (K2 at rows 1 / 8 / 24 / 65 / 512 / 2048
   on the 13B's three shapes and a debug shape, with a cuBLAS int8
   ``torch._int_mm`` yardstick line at rows >= 24, which has no group
   scales and so is no library time); the agent's quantizers (int4 group
   128 and int8 at the 13B's projection shapes, the int8 embedding) on
   the card against the CPU, byte for byte; then a tiny stack on the card
   against the same weights on the CPU (plain versions): ViT features,
   prefill logits and batched decode steps, and the debug adapter's
   ``reconstruct_with_condition`` images from the same noise;
4. the turn: ViT-bigG/14-448 (bf16) and the SEED-X agent (LLaMA2-13B,
   int4 weights, int8 KV cache, 64-query resamplers) with random weights
   drawn on the card from a seed; three ``comprehend`` requests on images
   of three aspect ratios and one ``generate`` request ending in ``<img>``
   (the forced 65-token chunk and the output resampler).  Decode runs as
   it does for a user: its one-token step a captured CUDA graph,
   replayed (``seedx_tpu_torch/utils/graphs.py``), and so do the denoise
   loop's UNet evals and the engines' steps in the phases below;
5. serving on the same runtime: a ``ServingEngine`` flush of 8 requests,
   ``ContinuousEngine`` with 8 slots over 16 requests, dense, paged, fused
   dense and fused paged, each run with its step programs captured and
   then again eager (token streams and hidden states bit-equal; paged
   streams must equal dense ones, fused paged fused dense); then the
   non-fused dense engine's tokens are forced (``Teacher``, eager)
   through the fused engine and through the batched loop: the fused
   run's logits must lie within ``LOGIT_FACTOR`` times the batched loop's
   difference from the engine, and where the greedy fused and non-fused
   streams part the gap is logged; a torch.profiler window over one
   decode chunk at 1 and at 8 live slots and over one fused mixed chunk
   at 8, captured and eager (device busy share, K3's device ms), and
   ``SeedXServer`` (warmed up) answering 4 concurrent HTTP requests on 127.0.0.1; and, once the
   phase-4 runtime is freed (after phase 10), the same 16 requests
   through ``ContinuousEngine`` on a runtime of their own whose agent has
   DeepSeek-V2-Lite as its LLM at its published sizes (bf16, a bf16
   latent KV cache; ``run_moe_serving``), captured and then eager: the
   token streams and hidden states bit-equal, and K6 launched twice a MoE
   layer for every step run and every prefill group; then, that runtime
   freed, 16 text requests likewise on an agent with Nemotron-3-Nano as
   its LLM at its published sizes (bf16 weights and KV, the fp32 SSM
   state; ``run_nemotron_serving``): K7 launched once a Mamba block of
   every step run, K6 twice an expert block (its relu2 share once) of
   every step run and every prefill group, K3 once an attention block of
   every step run;
6. chat: three turns (an image in the first) through a ``ChatSession``
   with the KV prefix cache and one without (the cache must be reused),
   a cached session forced along the uncached replies (its logits held to
   the same limit), then two ``/v1/chat`` POSTs on one session;
7. graphs: the turn at B 1 (the ``<img>`` request and a comprehension
   reply), ``generate_batch`` at B 8 and three chat turns (the last
   ending at n == t), each with its decode captured and then eager:
   tokens, hidden states, finished flags, the chat cache's bytes and the
   kernels' launches must be equal; decode ms a step and tok/s of both;
8. generation: speculative decoding at ``spec_k`` 4 under two 128-token
   scripts (an echo of the prompt's document and one with no n-gram
   repeats), plain and spec, captured and eager: each stream is its
   script, captured = eager bit for bit, the counters those of the
   port's 2-layer agent on the CPU; then plain / spec / spec / plain in
   turns (tok/s, ms a verify round and a plain step, accepted a round,
   gate flips) and a profiled window of each program; beam search at K
   3 / 4, B 1 / 2, captured and eager bit for bit (ms a step, the cache
   gather's share, peak memory), K 1 against the greedy stream; three
   ``/v1/chat`` turns with ``spec_k`` 4;
9. parity: the agent cut to ``PARITY_LAYERS`` layers at the same width and
   seed runs phase 5's 16 requests non-fused and fused, and phase 6's chat
   turns; the streams must be equal or part only at a tie (``TIE_ULPS``
   bf16 steps of the forced logits), and the greedy spec stream at k 1 /
   4 / 8 against the plain one by the same rule;
10. image out on the phase-4 runtime with a full-width adapter (random
   weights from seed 0: ResamplerXL, the SDXL base UNet in bf16, the SDXL
   VAE in fp32): one UNet eval with K1 against the plain attention
   (``UNET_K1_REL``), the UNet's device ms a step at CFG 2 and 3 with a
   profiled eval (busy share, K1's ms), the denoise loop's CFG eval
   captured and eager (eps bit-equal; wall ms, busy share, capture time
   and graph pool of each: base bf16 and int8 at CFG 2, edit bf16 and
   int8 at CFG 3), ResamplerXL / VAE ms; ``text_to_image`` (the forced
   ``<img>`` span, 30 Euler steps at 1024^2) captured and again eager
   (the images bit-equal), ``reconstruct`` of a 448^2 image, 2 steps of
   the int8 UNet; then the 8-channel edit adapter:
   ``reconstruct_with_condition`` at 1024^2 (3-way CFG), the gi = 1.0
   collapse, a ``ServingEngine`` flush of a t2i and an edit request and
   one ``/v1/generate`` POST.  Every UNet eval must launch K1 70 times,
   every eps, latent and image (before the clip) be finite, every image
   [B, 1024, 1024, 3]; then the split denoise (``run_split_image``): the
   base adapter's ``generate`` at 1024^2, Euler 30, CFG 2, captured,
   unsplit and then on a one-rank NCCL mesh (``SDXLAdapter.shard``: the
   CFG branches over data, the latent rows over tensor), images
   bit-equal, the collectives of one split eval against the prediction,
   the captured eval's ms both ways; the sharded phase adds the split at
   tensor 2 on two ranks over gloo (``run_two_rank_image``);
11. train: SEED-X SFT at full width through the entry point a user
   runs, ``train_sft.main`` with the repo's transform, tokenizer,
   visual-encoder and ``agent_seed_x.yaml`` configs (ViT-bigG frozen,
   LLaMA2-13B bf16 frozen, LoRA r32 on the seven projections, both
   resamplers, the embedding and LM head trainable in fp32; random
   weights from the factories' seed) over synthetic files written from a
   seed (webdataset caption shards, a LLaVA jsonl with its images, an
   edit jsonl; the data YAML is configs/data/sft_comprehension_gen.yaml
   with only its paths rewritten; the edit YAML's builders make one
   batch; the caption builder's host ms a batch under each tar reader):
   ``CLI_STEPS`` steps (each step's ms by phase, trained tok/s, the
   host's wait for its batch, launches and peak memory; which tar reader
   ran), the frozen weights bit-equal after and the trainable ones
   changed, the final checkpoint read back bit-equal; on the
   models it built a profiled step and one step with gradient
   accumulation 2 (SFT batches from the port's encoders and
   ``collate_anyres``: 2 conversations at 880 tokens with 8 anyres
   tiles, 8 captions at 260), then a gradient check of the agent cut to
   ``PARITY_LAYERS`` layers, K1 / K4 / K5 against the plain attention
   under ordinary autograd, which a zero-delta backward must fail; last
   ``main(--resume)`` to ``CLI_RESUME_STEPS``: the checkpoint restored,
   the trained batches skipped, the factories' frozen weights the same,
   the trainable ones moved on from the checkpoint; then ``main(--parallel
   configs/parallel/fsdp.yaml)`` on a one-rank NCCL mesh, fed the first
   run's two batches: losses, grad norms and the trainable leaves
   bit-equal to its first two steps (``train_cli_parallel``); then
   training on two ranks on the card over gloo at ``PARITY_LAYERS``
   layers, fsdp 2 and tensor 2, against the unsharded steps and the
   fsdp checkpoint's step on one rank (``run_mesh_train``);
12. adapter training: ``make_adapter_train_step`` at the full SDXL base
   width (ResamplerXL ``DetokenizerConfig()``, the base UNet bf16 with
   its to_k / to_v and conv_in as fp32 masters, AdamW) on a batch of
   ``ADAPTER_BATCH`` 1024^2 images (the fp32 VAE encoder's scaled latents,
   ViT-bigG features pooled to 64 tokens): ``ADAPTER_STEPS`` steps on one
   repeated draw of t and noise, each launching K1, K4 and K5 70 times
   (the UNet's self-attentions, forward and backward), the loss finite
   and lower after the first update, ms a step and peak memory, a
   profiled step, the trainable leaves changed and the frozen ones
   bit-equal after;
13. load: a synthetic release tree in a temporary directory (the port's
   manifests' keys and shapes, random values drawn on the card from a
   seed, bf16 and the VAE fp32, in the ``from_pretrained`` layout and
   through all four reader routes: the LLM dir as an HF shard dir, the
   UNet and VAE as diffusers safetensors files, written by the smoke's
   own writer, the ViT as a ``.pt`` pickle, the agent and the
   detokenizer, with its UNet to_k / to_v deltas, as
   ``pytorch_model.bin``; ViT-bigG at 48 layers, the SDXL base UNet and
   VAE whole, the 13B's LLM dir and agent at full width cut to
   ``LOAD_LAYERS`` layers; fails if the directory has no room for it),
   then the runtime built from the files through the port's factories
   with the manifest checks on (an int4 agent with an int8 KV cache,
   quantized as it loads) and one broken artifact that must raise with
   its diff; every loaded tensor bit-equal to the converters on the
   tensors in memory and the K2 codes to ``quantize_kernel_int4`` of the
   written weights; on the loaded runtime phase 4's turn,
   ``text_to_image`` at 1024^2 for ``LOAD_T2I_STEPS`` Euler steps, the
   int8 ViT's features against the bf16 ViT's (``VIT_INT8_REL``,
   ``VIT_INT8_RMS``) and one step of the int8 UNet; last the int4 LLM's
   ``export_serving`` artifact read back into a fresh agent bit for bit,
   with the same greedy tokens; write / read / build seconds, GB/s, host
   and device peak memory, cold start from release files and from the
   export;
14. a JSON line of the kernels, the ``nvidia-smi`` line, and last a JSON
   line ``{"ok": true, "device": {...}}``.

Every path of phases 4-13 runs with the launch counters set to 0 just
before it and read just after, and fails unless each kernel it runs was
launched (the fused engines: K3 in its multi-query mode); a captured
program adds its launches at every replay, so the counters count what
ran.  In the kernels line ``launches`` is the sum over the main path's
runs of phases 4-6, 8, 10, 11, 12 and 13 (the turn, the serving engines
and HTTP, the chat sessions, the warm captured scripted runs, the beams
and the spec chat, the image-out runs, the split denoise on the one-rank
mesh, the CLI's, the ``--parallel`` CLI's, the accumulation and the
two-rank mesh train steps, the adapter steps, the loaded stack's turn, text to image,
int8 ViT and int8 UNet step; phase 5's DeepSeek-V2-Lite and
Nemotron-3-Nano engines captured), with K3's by mode, K2's by row tile
(``launches_by_tile``; its calls by row band are logged) and K6's by
epilogue (``launches_by_epilogue``); the eager
twins of phases 5, 7, 8 and 10, the forced runs, phase 9, the gradient
check and the profiled train and adapter steps, the UNet's
K1-against-plain eval and the restored agent's comparison print theirs
on a line of their own.
``max_abs_err`` is the largest over the kernel's shapes, and ``ms``,
``plain_ms`` and ``bound_ms`` sums of one call at each shape;
``library_ms`` sums the shapes named in ``library_shapes``.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import gc
import itertools
import json
import os
import statistics
import subprocess
import sys
import threading
import time

import numpy as np

HBM_BYTES_PER_S = 3.35e12                       # H100 SXM, 700 W
PEAK_OPS = {"bf16": 989e12, "int8": 1979e12,    # dense tensor-core peaks
            "fp32": 67e12}                      # fp32 outside them
SPIN_CYCLES = 20_000_000      # ~10 ms at the H100's 1.98 GHz boost clock
# the continuous engine of every serving run: 8 slots of 512 + 128
ENGINE = dict(slots=8, max_new_tokens=128, chunk_steps=16,
              prompt_buckets=(128, 256, 512), page_size=128)
# fused serving: the continuous engine's chunked prefill, 16 prompt tokens
# a step beside the 8 slots' decode tokens
FUSED = {"fused_prefill": True, "prefill_width": 16}
# two greedy streams may part only where the logits of the two tokens, from
# one of the paths teacher-forced along the other's tokens, are within this
# many bf16 steps of the logit scale
TIE_ULPS = 8
# The random 13B amplifies rounding differences past that rule between
# any two arithmetic paths of the port: W4A8 re-quantizes every
# projection's input to int8, so a one-ulp difference flips codes, and the
# flips compound with depth (at 40 layers the batched flush and the
# continuous engine, both non-fused, part by up to 30 bf16 steps).  So at
# full depth the paths are held by their logits instead: teacher-forced
# along the non-fused engine's tokens, a path's logits must lie within
# LOGIT_FACTOR times the noise floor, the largest logit difference between
# the batched loop and the non-fused engine forced along the same tokens.
# The tie rule on streams is enforced on the agent cut to PARITY_LAYERS
# layers at the same width and seed, and only logged at full depth.
LOGIT_FACTOR = 2.0
PARITY_LAYERS = 2
KERNELS = (("flash_fwd", "seedx_tpu_torch/csrc/flash_fwd.cu",
            "seedx_tpu/ops/flash_attention.py:43"),
           ("flash_bwd_dq", "seedx_tpu_torch/csrc/flash_bwd.cu",
            "seedx_tpu/ops/flash_attention.py:247"),
           ("flash_bwd_dkv", "seedx_tpu_torch/csrc/flash_bwd.cu",
            "seedx_tpu/ops/flash_attention.py:298"),
           ("int4_w4a8", "seedx_tpu_torch/csrc/int4_w4a8.cu",
            "seedx_tpu/ops/int4_matmul.py:49"),
           ("int4_dequant", "seedx_tpu_torch/csrc/int4_dequant.cu", "none"),
           ("decode_attn", "seedx_tpu_torch/csrc/decode_attn.cu",
            "seedx_tpu/ops/decode_attention.py:115"),
           ("group_norm", "seedx_tpu_torch/csrc/norms.cu", "none"),
           ("layer_norm", "seedx_tpu_torch/csrc/norms.cu", "none"),
           ("moe_gemm", "seedx_tpu_torch/csrc/moe_gemm.cu", "none"),
           ("ssm_step", "seedx_tpu_torch/csrc/ssm_step.cu", "none"),
           ("bias_residual", "seedx_tpu_torch/csrc/epilogue.cu", "none"),
           ("bias_geglu", "seedx_tpu_torch/csrc/epilogue.cu", "none"))


def log(msg: str) -> None:
    print(msg, flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, flush=None, warmup: int = 3, iters: int = 10) -> float:
    """Median device milliseconds of ``fn`` over ``iters`` runs (CUDA
    events).  A spin kernel queued before the start event keeps the card
    busy while the host queues ``fn``, so the time is the device's, not the
    host's launch overhead.  ``flush`` (a buffer rewritten before each run)
    evicts the 50 MB L2 so weights and caches stream from HBM as they do
    in the 40-layer loop."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        if flush is not None:
            flush.zero_()
        torch.cuda._sleep(SPIN_CYCLES)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def stream_ms(calls, reps: int = 4, iters: int = 5) -> float:
    """Device ms a call in a stream of back-to-back launches, as a captured
    eval launches its kernels: ``calls`` (each on inputs of its own, more
    than the 50 MB L2 holds together, so each finds its inputs cold)
    captured ``reps`` times over in one CUDA graph, the median of
    ``iters`` replays' CUDA-event time over the launches.  A single
    launch's time (``cuda_ms``) carries a fixed few microseconds of
    launch and event overhead, most of a kernel of a few MB."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for fn in calls:
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            for fn in calls:
                fn()
    graph.replay()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / (reps * len(calls)))
    del graph
    return statistics.median(times)


def bound(n_bytes: float, n_ops: float, kind: str):
    """(least ms the card could take, what bounds it)."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / PEAK_OPS[kind] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def counters():
    """The kernels' launch counters (the registry ``ops/_build.launches``),
    each kernel module imported so that every kernel's are registered."""
    from seedx_tpu_torch.ops import (decode_attention, epilogue,  # noqa: F401
                                     flash_attention, int4_matmul, moe,
                                     norms, ssm)
    from seedx_tpu_torch.ops._build import launches

    return launches


def reset_counts() -> None:
    registry = counters()
    for name in registry:
        registry[name] = 0


def read_counts():
    """Each kernel's launches since the last reset, by the registry's
    names: K3's also by mode ("decode_attn one_query": a 3-D q;
    "decode_attn multi_query": the stair) and K2's by row tile
    ("int4_w4a8 m16") and by row band ("int4_w4a8 rows 2-16")."""
    return dict(counters())


def k3_modes():
    """K3's launches since the last reset, by mode."""
    return {m: counters()[f"decode_attn {m}"]
            for m in ("one_query", "multi_query")}


def row(kernel, shape, ok, err, ms, plain_ms, bnd, library_ms=None):
    return {"kernel": kernel, "shape": shape, "ok": ok, "err": err,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bnd[0],
            "bound_by": bnd[1], "library_ms": library_ms}


def fmt_row(r, extra: str = "") -> str:
    lib = ("none" if r["library_ms"] is None
           else f"{r['library_ms']:.4f} ms")
    return (f"kernel {r['kernel']} {r['shape']}: max_abs_err {r['err']:.3e}"
            f"{extra} {'ok' if r['ok'] else 'FAIL'} kernel {r['ms']:.4f} ms "
            f"plain {r['plain_ms']:.4f} ms library {lib} bound "
            f"{r['bound_ms']:.4f} ms ({r['bound_by']})")


# K1 at every shape the main path runs it at: (name, B, Sq, Skv, H, D,
# causal, starts, ends, q_offset), one start / end per batch row.  D 128
# is ViT-bigG's 104 zero-padded by the dispatch; the UNet rows are SDXL's
# self-attention at 1024^2 (levels 1 and 2) at CFG batch 2 (text to image,
# the edit collapse) and 3 (edit)
FLASH_SHAPES = (
    ("vit_5tiles", 5, 1024, 1024, 16, 128, False, (0,) * 5, (1024,) * 5, 0),
    ("prefill_512", 1, 512, 544, 40, 128, True, (300,), (512,), 0),
    ("chunk_65", 1, 65, 544, 40, 128, True, (300,), (577,), 512),
    ("train_comprehension", 2, 880, 880, 40, 128, True, (0, 0), (880, 611),
     0),
    ("train_generation", 8, 260, 260, 40, 128, True, (0,) * 8,
     (260, 211, 174, 260, 143, 238, 197, 160), 0),
    ("vit_train_8tiles", 8, 1024, 1024, 16, 128, False, (0,) * 8,
     (1024,) * 8, 0),
    ("unet_4096", 2, 4096, 4096, 10, 64, False, (0, 0), (4096, 4096), 0),
    ("unet_1024", 2, 1024, 1024, 20, 64, False, (0, 0), (1024, 1024), 0),
    ("unet_edit_4096", 3, 4096, 4096, 10, 64, False, (0,) * 3, (4096,) * 3,
     0),
    ("unet_edit_1024", 3, 1024, 1024, 20, 64, False, (0,) * 3, (1024,) * 3,
     0),
    # a rank's local query rows against the gathered keys (the split
    # denoise at tensor 2) and a rank's rows / heads of the generation
    # batch (training at fsdp 2 / tensor 2)
    ("unet_4096_split2", 2, 2048, 4096, 10, 64, False, (0, 0), (4096, 4096),
     0),
    ("unet_1024_split2", 2, 512, 1024, 20, 64, False, (0, 0), (1024, 1024),
     0),
    ("train_generation_fsdp2", 4, 260, 260, 40, 128, True, (0,) * 4,
     (260, 211, 174, 260), 0),
    ("train_generation_tensor2", 8, 260, 260, 20, 128, True, (0,) * 8,
     (260, 211, 174, 260, 143, 238, 197, 160), 0))


def check_flash(dev, g, shapes=FLASH_SHAPES):
    """K1 against ``flash_fwd_plain`` at ``shapes``: the output within 2e-2
    of the largest output (at most 2e-2 absolute), live lse within 1e-3, the
    same dead rows; timed beside the plain version and SDPA (with the bool
    mask where causal or windowed)."""
    import torch
    import torch.nn.functional as F

    from seedx_tpu_torch.ops import flash_attention as fa

    rows = []
    for name, b, sq, skv, h, d, causal, st_, en_, qoff in shapes:
        q, k, v = (torch.randn((b, s, h, d), generator=g, device=dev
                               ).to(torch.bfloat16) for s in (sq, skv, skv))
        st = torch.tensor(st_, dtype=torch.int32, device=dev)
        en = torch.tensor(en_, dtype=torch.int32, device=dev)
        args = (q, k, v, st, en, qoff, causal, d ** -0.5)
        out, lse = fa.flash_fwd(*args)
        ref, lse_ref = fa.flash_fwd_plain(*args)
        torch.cuda.synchronize()
        err = (out.float() - ref.float()).abs().max().item()
        mag = ref.float().abs().max().item()
        rel = err / mag
        live = lse_ref > -1e30
        lse_err = (lse[live] - lse_ref[live]).abs().max().item()
        # both round the output to bf16 once; the kernel rounds P against
        # each tile's running max, the plain version against the row's: a
        # few bf16 ULPs of the outputs' scale, which a softmax over 4096
        # keys brings down to ~0.02 (tests/test_torch_cuda.py flash_limit)
        tol = 2e-2 * min(1.0, mag)
        ok = (err <= tol and lse_err <= 1e-3
              and torch.equal(lse > -1e30, live))
        # the function's work on this data: the (q, k) pairs the windows
        # and the causal mask leave, and each input read / output written
        # once (k / v over each row's window)
        mask = fa._window_mask(st, en, sq, skv, qoff, causal, dev).expand(
            b, 1, sq, skv)
        pairs = int(mask.sum())
        window = int((en.clamp(max=skv) - st.clamp(min=0)).clamp(min=0).sum())
        n_bytes = h * d * 2 * (2 * b * sq + 2 * window) + b * h * sq * 4
        bnd = bound(n_bytes, 4 * h * d * pairs, "bf16")
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        full = not causal and all(s_ == 0 and e_ >= skv
                                  for s_, e_ in zip(st_, en_))
        am = None if full else mask
        lib = cuda_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=am, scale=d ** -0.5))
        ms = cuda_ms(lambda: fa.flash_fwd(*args))
        r = row("flash_fwd", f"{name} B{b} Sq{sq} Skv{skv} H{h} D{d} "
                f"causal={causal} windows {list(zip(st_, en_))[:2]}"
                f"{'...' if b > 2 else ''} q_offset {qoff}, {pairs} pairs, "
                f"tile (q rows, keys) "
                f"{fa.tile_shape(b, sq, h, d, causal, fa.sm_count(0))}",
                ok, err, ms, cuda_ms(lambda: fa.flash_fwd_plain(*args)), bnd,
                lib)
        log(fmt_row(r, f" max_rel_err {rel:.3e} lse_err {lse_err:.3e} "
                       f"tol {tol:.3e}; kernel / library {ms / lib:.3f}"))
        rows.append(r)
    return rows


# the attention backward of the SFT train step and of adapter training
# (the UNet's self-attention at 1024^2, levels 1 and 2, at the training
# batch 2): (name, B, S, H, D, causal, starts, ends); q and kv of one
# length, q_offset 0
FLASH_BWD_SHAPES = (
    ("comprehension", 2, 880, 40, 128, True, (0, 0), (880, 611)),
    ("generation", 8, 260, 40, 128, True, (0,) * 8,
     (260, 211, 174, 260, 143, 238, 197, 160)),
    ("d64_noncausal", 2, 512, 16, 64, False, (0, 7), (512, 400)),
    ("unet_4096", 2, 4096, 10, 64, False, (0, 0), (4096, 4096)),
    ("unet_1024", 2, 1024, 20, 64, False, (0, 0), (1024, 1024)),
    # a rank's rows (fsdp 2) and heads (tensor 2) of the generation batch
    ("generation_fsdp2", 4, 260, 40, 128, True, (0,) * 4,
     (260, 211, 174, 260)),
    ("generation_tensor2", 8, 260, 20, 128, True, (0,) * 8,
     (260, 211, 174, 260, 143, 238, 197, 160)))


def check_flash_bwd(dev, g, shapes=FLASH_BWD_SHAPES):
    """K4 (dq) and K5 (dk, dv) against ``flash_bwd_plain`` at ``shapes``;
    two runs must give the same bits.  The plain version and the library
    call (autograd through SDPA with the same bool mask) compute dq, dk and
    dv together; their times stand on both rows."""
    import torch
    import torch.nn.functional as F

    from seedx_tpu_torch.ops import flash_attention as fa

    rows = []
    for name, b, s, h, d, causal, st_, en_ in shapes:
        q, k, v, do = (torch.randn((b, s, h, d), generator=g, device=dev
                                   ).to(torch.bfloat16) for _ in range(4))
        st = torch.tensor(st_, dtype=torch.int32, device=dev)
        en = torch.tensor(en_, dtype=torch.int32, device=dev)
        scale = d ** -0.5
        out, lse = fa.flash_fwd(q, k, v, st, en, 0, causal, scale)
        args = (q, k, v, do, lse, fa.row_delta(do, out), st, en, 0, causal,
                scale)
        got = (fa.flash_bwd_dq(*args),) + fa.flash_bwd_dkv(*args)
        again = (fa.flash_bwd_dq(*args),) + fa.flash_bwd_dkv(*args)
        ref = fa.flash_bwd_plain(*args)
        torch.cuda.synchronize()
        same = all(torch.equal(a, a2) for a, a2 in zip(got, again))
        errs = [((a.float() - r.float()).abs().max().item(),
                 r.float().abs().max().item()) for a, r in zip(got, ref)]
        # work on this data: the (q, k) pairs the window and the causal
        # mask leave; bytes: each input read once (k / v over the window),
        # each output written once
        mask = fa._window_mask(st, en, s, s, 0, causal, dev).expand(
            b, 1, s, s)
        pairs = int(mask.sum())
        window = int((en - st).clamp(min=0).sum())
        qdo = 2 * b * s * h * d * 2
        kv = 2 * window * h * d * 2
        rowstats = 2 * b * h * s * 4
        bnd = {"flash_bwd_dq": bound(qdo + kv + rowstats + b * s * h * d * 2,
                                     3 * 2 * d * h * pairs, "bf16"),
               "flash_bwd_dkv": bound(qdo + kv + rowstats
                                      + 2 * b * s * h * d * 2,
                                      4 * 2 * d * h * pairs, "bf16")}
        plain_ms = cuda_ms(lambda: fa.flash_bwd_plain(*args), iters=5)
        leaves = [t.transpose(1, 2).detach().requires_grad_()
                  for t in (q, k, v)]
        lib_out = F.scaled_dot_product_attention(
            *leaves, attn_mask=mask, scale=scale)
        do_t = do.transpose(1, 2)
        lib = cuda_ms(lambda: torch.autograd.grad(
            lib_out, leaves, do_t, retain_graph=True))
        del lib_out, leaves
        tiles = fa.bwd_tile_shape(b, s, s, h, d, causal, fa.sm_count(0))
        for kname, fn, idx, tile in (
                ("flash_bwd_dq", lambda: fa.flash_bwd_dq(*args), (0,),
                 tiles[0]),
                ("flash_bwd_dkv", lambda: fa.flash_bwd_dkv(*args), (1, 2),
                 tiles[1])):
            shape = (f"{name} B{b} S{s} H{h} D{d} causal={causal} "
                     f"ends {list(en_)}, {pairs} pairs, tile (q rows, keys) "
                     f"{tile}")
            err = max(errs[i][0] for i in idx)
            # P and dS enter the tensor cores as bf16 and the outputs are
            # rounded once to bf16 (2^-8 of them): 1e-2 of the largest
            tol_ok = all(errs[i][0] <= 1e-2 * errs[i][1] for i in idx)
            rel = max(errs[i][0] / errs[i][1] for i in idx)
            r = row(kname, shape, tol_ok and same, err, cuda_ms(fn),
                    plain_ms, bnd[kname], lib)
            log(fmt_row(r, f" max_rel_err {rel:.3e} tol 1e-2 of the largest;"
                           f" two runs bit-equal {same}"))
            rows.append(r)
        both = rows[-2]["ms"] + rows[-1]["ms"]
        log(f"flash_bwd {name}: K4 + K5 {both:.4f} ms, library {lib:.4f} ms, "
            f"K4 + K5 / library {both / lib:.3f}")
    return rows


# K2's rows: the decode GEMV (1), the engines' decode batch (8), the fused
# mixed step (24), the <img> chunk (65), a prefill bucket (512) and the
# most rows it takes (2048), on the 13B's three projection shapes and the
# debug agent's (hidden 128, intermediate 256)
INT4_ROWS = (1, 4, 5, 8, 24, 65, 512, 2048)
INT4_SHAPES = ((5120, 5120), (5120, 13824), (13824, 5120), (128, 256))


def check_int4(dev, g, flush):
    """K2 against ``int4_matmul_plain`` at every row count and shape above;
    at rows >= 24 a yardstick line for cuBLAS's int8 GEMM
    (``torch._int_mm``) on the unpacked weights -- not the same function
    (no group scales, no row quantization), so not the library time."""
    import torch

    from seedx_tpu_torch.ops import int4_matmul as i4
    from seedx_tpu_torch.ops._build import sm_count
    from seedx_tpu_torch.utils.quantize import quantize_kernel_int4

    rows = []
    for n_in, n_out in INT4_SHAPES:
        w = torch.randn((n_in, n_out), generator=g, device=dev) * 0.02
        packed, scale = quantize_kernel_int4(w)
        del w
        w8 = i4.unpack_int4(packed)
        for r_ in INT4_ROWS:
            x = torch.randn((r_, n_in), generator=g,
                            device=dev).to(torch.bfloat16)
            out = i4.int4_matmul(x, packed, scale)
            ref = i4.int4_matmul_plain(x, packed, scale)
            torch.cuda.synchronize()
            mag = ref.float().abs().max().item()
            err = (out.float() - ref.float()).abs().max().item()
            # exact int32 group dots; fp32 split-K order and FMA against
            # mul + add differ; one bf16 rounding: two bf16 ULPs of the
            # output magnitude
            tol = 2 * 2 ** -7 * mag
            n_bytes = (x.numel() * 2 + packed.numel() + scale.numel() * 4
                       + r_ * n_out * 2)
            tile, splits = i4.plan(r_, n_in, n_out, n_in // scale.shape[0],
                                   sm_count(dev.index or 0))
            # no PyTorch call computes W4A8 over this nibble packing
            r = row("int4_w4a8", f"rows{r_} {n_in}->{n_out}", err <= tol,
                    err,
                    cuda_ms(lambda: i4.int4_matmul(x, packed, scale), flush),
                    cuda_ms(lambda: i4.int4_matmul_plain(x, packed, scale),
                            flush),
                    bound(n_bytes, 2 * r_ * n_in * n_out, "int8"))
            log(fmt_row(r, f" max_rel_err {err / mag:.3e} tol {tol:.3e} "
                           f"tile m{tile} splits {splits}"))
            rows.append(r)
            if r_ >= 24:
                x8 = torch.randint(-127, 128, (r_, n_in), generator=g,
                                   device=dev, dtype=torch.int8)
                ms = cuda_ms(lambda: torch._int_mm(x8, w8), flush)
                log(f"yardstick int4_w4a8 rows{r_} {n_in}->{n_out}: cuBLAS "
                    f"int8 torch._int_mm on the unpacked weights {ms:.4f} "
                    f"ms (kernel / cuBLAS {r['ms'] / ms:.3f}; no group "
                    f"scales, not the library time)")
        del w8
    return rows


# the W4A16 branch's dequant at the 7B agent's projections, group 128
DEQUANT_SHAPES = ((4096, 4096), (4096, 11008), (11008, 4096))


def check_int4_dequant(dev, g, flush, shapes=DEQUANT_SHAPES):
    """The W4A16 dequant kernel against ``dequant_int4_plain`` at
    ``shapes``, bit for bit, on every byte value and scales over six
    decades; timed a single launch (L2 flushed) and in a stream of
    launches over four weights, as a prefill group runs it.  A yardstick
    line gives the whole W4A16 call at a 3072-row prefill group beside the
    same dot after the plain chain, and both branches at the 2048 rows
    where the dispatch passes from K2 to W4A16."""
    import torch

    from seedx_tpu_torch.ops import int4_matmul as i4

    rows = []
    for n_in, n_out in shapes:
        sets = [(torch.randint(0, 256, (n_in // 2, n_out), generator=g,
                               device=dev, dtype=torch.uint8),
                 10.0 ** (6 * torch.rand((n_in // 128, n_out), generator=g,
                                         device=dev) - 5))
                for _ in range(4)]
        packed, scale = sets[0]
        w = i4.dequant_int4(packed, scale)
        ref = i4.dequant_int4_plain(packed, scale)
        same = torch.equal(w, ref)
        err = (w.float() - ref.float()).abs().max().item()
        del w, ref
        n_bytes = packed.numel() + 4 * scale.numel() + 2 * n_in * n_out
        r = row("int4_dequant", f"{n_in}->{n_out} g128", same, err,
                cuda_ms(lambda: i4.dequant_int4(packed, scale), flush),
                cuda_ms(lambda: i4.dequant_int4_plain(packed, scale), flush),
                bound(n_bytes, 0, "bf16"))
        stream = stream_ms([lambda p=p, s=s: i4.dequant_int4(p, s)
                            for p, s in sets])
        del sets
        log(fmt_row(r, f" bit-equal {same}; kernel / bound "
                       f"{r['ms'] / r['bound_ms']:.2f}, in a stream "
                       f"{stream:.4f} ms ({stream / r['bound_ms']:.2f}x)"))
        rows.append(r)
        x = torch.randn((3072, n_in), generator=g,
                        device=dev).to(torch.bfloat16)
        x2k = x[:i4.MAX_KERNEL_ROWS].contiguous()
        call = cuda_ms(lambda: i4.int4_matmul_unpack(x, packed, scale),
                       flush)
        plain = cuda_ms(lambda: x @ i4.dequant_int4_plain(packed, scale),
                        flush)
        k2 = cuda_ms(lambda: i4.int4_matmul(x2k, packed, scale), flush)
        w4a16 = cuda_ms(lambda: i4.int4_matmul_unpack(x2k, packed, scale),
                        flush)
        log(f"yardstick int4_dequant {n_in}->{n_out}: the W4A16 call at "
            f"3072 rows {call:.4f} ms, with the plain chain {plain:.4f} ms; "
            f"at {i4.MAX_KERNEL_ROWS} rows K2 {k2:.4f} ms, W4A16 "
            f"{w4a16:.4f} ms")
        del x, x2k
    return rows


# B 8 windows: a full row, one-token rows, an empty row, ragged rows
WINDOWS_8 = ((0, 1280), (5, 6), (3, 3), (100, 900), (0, 1), (640, 1100),
             (7, 1000), (200, 1280))


# K3's one-query rows: (name, B, S, Hq, Hkv, D, int8, page, windows)
DECODE_ROWS = (
    ("int8_b1", 1, 1280, 40, 40, 128, True, 0, ((0, 300),)),
    ("int8_b8", 8, 1280, 40, 40, 128, True, 0, WINDOWS_8),
    ("bf16_b8", 8, 1280, 40, 40, 128, False, 0, WINDOWS_8),
    ("int8_paged_b8", 8, 1280, 40, 40, 128, True, 128, WINDOWS_8),
    ("bf16_gqa_b8", 8, 1280, 40, 8, 128, False, 0, WINDOWS_8),
    ("int8_d32_b8", 8, 1280, 4, 4, 32, True, 0, WINDOWS_8))


def check_decode(dev, g, flush, rows=DECODE_ROWS):
    """K3's one-query mode at ``rows``."""
    import torch
    import torch.nn.functional as F

    from seedx_tpu_torch.models.llama import quantize_kv
    from seedx_tpu_torch.ops import decode_attention as da

    spec, rows = rows, []
    for name, b, s, hq, hkv, d, int8, page, wins in spec:
        q = torch.randn((b, hq, d), generator=g,
                        device=dev).to(torch.bfloat16)
        k, v = (torch.randn((b, s, hkv, d), generator=g, device=dev
                            ).to(torch.bfloat16) for _ in range(2))
        kw = {}
        if int8:
            (k, ks), (v, vs) = quantize_kv(k), quantize_kv(v)
            kw = dict(k_scale=ks[..., 0].contiguous(),
                      v_scale=vs[..., 0].contiguous())
        dense_k, dense_v = k.reshape(b, s, -1), v.reshape(b, s, -1)
        k, v = dense_k, dense_v
        if page:
            n_tiles = s // page
            perm = torch.randperm(2 * b * n_tiles, generator=g, device=dev)
            tables = perm[:b * n_tiles].reshape(b, n_tiles).to(torch.int32)
            prow = (tables.long()[:, :, None] * page
                    + torch.arange(page, device=dev)).reshape(b, s)

            def pool(x):
                out = torch.zeros((2 * b * n_tiles * page,) + x.shape[2:],
                                  dtype=x.dtype, device=dev)
                out[prow] = x
                return out

            k, v = pool(k), pool(v)
            kw = {n: pool(t) for n, t in kw.items()}
            kw.update(block_tables=tables.contiguous(), page=page)
        st = torch.tensor([w[0] for w in wins], dtype=torch.int32,
                          device=dev)
        en = torch.tensor([w[1] for w in wins], dtype=torch.int32,
                          device=dev)
        out = da.ragged_decode_attention(q, k, v, st, en, **kw)
        ref = da.ragged_decode_attention_plain(q, k, v, st, en, **kw)
        torch.cuda.synchronize()
        err = (out.float() - ref.float()).abs().max().item()
        mag = ref.float().abs().max().item()
        empty = en <= st
        tol = 2e-2      # bf16 output of O(1), as for the flash kernel
        ok = err <= tol and bool((out[empty] == 0).all())
        n_pos = int(torch.clamp(en - st, min=0).sum())
        item = 1 if int8 else 2
        n_bytes = (2 * q.numel() * 2 + 2 * n_pos * hkv * d * item
                   + (2 * n_pos * hkv * 2 if int8 else 0) + 8 * b
                   + (kw["block_tables"].numel() * 4 if page else 0))
        bnd = bound(n_bytes, 4 * n_pos * hq * d, "int8" if int8 else "bf16")
        path = None
        if int8 and not page:
            # the path K3 replaces (decode_attention="never"): dequantize
            # the whole layer cache, then plain attention under the mask
            path = cuda_ms(lambda: never_path(q, k, v, kw["k_scale"],
                                              kw["v_scale"], st, en), flush)
        lib = None
        if not int8 and not page:
            # the same function as one library call: SDPA over the dense
            # cache with a boolean window mask (an empty row gives NaN
            # there, zeros here)
            pos = torch.arange(s, device=dev)
            am = ((pos >= st[:, None]) & (pos < en[:, None]))[:, None, None]
            kt = dense_k.view(b, s, hkv, d).transpose(1, 2)
            vt = dense_v.view(b, s, hkv, d).transpose(1, 2)
            lib = cuda_ms(lambda: F.scaled_dot_product_attention(
                q[:, :, None], kt, vt, attn_mask=am,
                enable_gqa=hq != hkv), flush)
        r = row("decode_attn", f"{name} B{b} S{s} Hq{hq} Hkv{hkv} D{d} "
                f"{'int8' if int8 else 'bf16'}"
                f"{f' page{page}' if page else ''} positions {n_pos}", ok,
                err, cuda_ms(lambda: da.ragged_decode_attention(
                    q, k, v, st, en, **kw), flush),
                cuda_ms(lambda: da.ragged_decode_attention_plain(
                    q, k, v, st, en, **kw), flush), bnd, lib)
        extra = ("" if path is None
                 else f" dequantize-then-attend path {path:.4f} ms")
        log(fmt_row(r, f" max_rel_err {err / mag:.3e} tol {tol:g}") + extra)
        rows.append(r)
    return rows


# The stair mix of a fused serving step at 8 slots, S 512 + 128: three
# rows prefilling w tokens at offsets 0 / 64 / 300 (slot 0's end = offset
# + 1), five rows decoding (width 1; their other slots compute garbage the
# engine discards), one of them near the cache end so its stair clamps.
STAIR_ENDS_8 = (1, 65, 301, 520, 600, 130, 410, 639)


def stair_ends(ends, w: int, s: int):
    """Per row, the ends of its w query slots: slot i ends at
    min(end + i, S)."""
    return [[min(e + i, s) for i in range(w)] for e in ends]


# K3's stair rows at B 8, S STAIR_S, D 128: (name, Hq, Hkv, int8, page, w)
STAIR_S = 640
STAIR_ROWS = (("stair_int8_w8", 40, 40, True, 0, 8),
              ("stair_int8_w16", 40, 40, True, 0, 16),
              ("stair_int8_paged_w8", 40, 40, True, 128, 8),
              ("stair_int8_paged_w16", 40, 40, True, 128, 16),
              ("stair_bf16_gqa_w8", 40, 8, False, 0, 8),
              ("stair_int8_w1", 40, 40, True, 0, 1))


def check_stair(dev, g, flush, rows=STAIR_ROWS):
    """K3's multi-query ("stair") mode at the fused step's shapes."""
    import torch
    import torch.nn.functional as F

    from seedx_tpu_torch.models.llama import quantize_kv
    from seedx_tpu_torch.ops import decode_attention as da

    spec, rows = rows, []
    b, s, d = 8, STAIR_S, 128
    for name, hq, hkv, int8, page, w in spec:
        q = torch.randn((b, w, hq, d), generator=g,
                        device=dev).to(torch.bfloat16)
        k, v = (torch.randn((b, s, hkv, d), generator=g, device=dev
                            ).to(torch.bfloat16) for _ in range(2))
        kw = {}
        if int8:
            (k, ks), (v, vs) = quantize_kv(k), quantize_kv(v)
            kw = dict(k_scale=ks[..., 0].contiguous(),
                      v_scale=vs[..., 0].contiguous())
        dense_k, dense_v = k.reshape(b, s, -1), v.reshape(b, s, -1)
        k, v = dense_k, dense_v
        if page:
            n_tiles = s // page
            perm = torch.randperm(2 * b * n_tiles, generator=g, device=dev)
            tables = perm[:b * n_tiles].reshape(b, n_tiles).to(torch.int32)
            prow = (tables.long()[:, :, None] * page
                    + torch.arange(page, device=dev)).reshape(b, s)

            def pool(x):
                out = torch.zeros((2 * b * n_tiles * page,) + x.shape[2:],
                                  dtype=x.dtype, device=dev)
                out[prow] = x
                return out

            k, v = pool(k), pool(v)
            kw = {n: pool(t) for n, t in kw.items()}
            kw.update(block_tables=tables.contiguous(), page=page)
        st = torch.zeros((b,), dtype=torch.int32, device=dev)
        en = torch.tensor(STAIR_ENDS_8, dtype=torch.int32, device=dev)
        out = da.ragged_decode_attention(q, k, v, st, en, **kw)
        ref = da.ragged_decode_attention_plain(q, k, v, st, en, **kw)
        torch.cuda.synchronize()
        err = (out.float() - ref.float()).abs().max().item()
        mag = ref.float().abs().max().item()
        tol = 2e-2      # bf16 output of O(1), as for the one-query mode
        ok = err <= tol
        extra = ""
        if w == 1:
            one = da.ragged_decode_attention(q[:, 0].contiguous(), k, v, st,
                                             en, **kw)
            torch.cuda.synchronize()
            same = bool(torch.equal(out[:, 0], one))
            ok = ok and same
            extra = f" equals the one-query call: {same}"
        ends_i = stair_ends(STAIR_ENDS_8, w, s)
        item = 1 if int8 else 2
        # each row's longest stair window read once (codes + scales), q
        # and out once; the work is each query's own window
        longest = sum(max(e) for e in ends_i)
        n_bytes = (2 * q.numel() * 2 + 2 * longest * hkv * d * item
                   + (2 * longest * hkv * 2 if int8 else 0) + 8 * b
                   + (kw["block_tables"].numel() * 4 if page else 0))
        pairs = sum(sum(e) for e in ends_i)
        bnd = bound(n_bytes, 4 * d * hq * pairs, "int8" if int8 else "bf16")
        lib = None
        if not int8 and not page:
            # one library call for the same function: SDPA over the dense
            # cache with a boolean stair mask
            pos = torch.arange(s, device=dev)
            e_t = torch.tensor(ends_i, device=dev)            # [B, w]
            am = (pos[None, None] < e_t[:, :, None])[:, None]  # [B,1,w,S]
            kt = dense_k.view(b, s, hkv, d).transpose(1, 2)
            vt = dense_v.view(b, s, hkv, d).transpose(1, 2)
            qt = q.transpose(1, 2)
            lib = cuda_ms(lambda: F.scaled_dot_product_attention(
                qt, kt, vt, attn_mask=am, enable_gqa=hq != hkv), flush)
        r = row("decode_attn", f"{name} B{b} w{w} S{s} Hq{hq} Hkv{hkv} D{d} "
                f"{'int8' if int8 else 'bf16'}"
                f"{f' page{page}' if page else ''} stair ends "
                f"{list(STAIR_ENDS_8)} positions {pairs}", ok, err,
                cuda_ms(lambda: da.ragged_decode_attention(
                    q, k, v, st, en, **kw), flush),
                cuda_ms(lambda: da.ragged_decode_attention_plain(
                    q, k, v, st, en, **kw), flush), bnd, lib)
        log(fmt_row(r, f" max_rel_err {err / mag:.3e} tol {tol:g}{extra}"))
        rows.append(r)
    return rows


def never_path(q, k, v, ks, vs, starts, ends):
    """The one-token step of models/llama.py with decode_attention
    "never": the int8 layer cache dequantized to bf16, then plain
    attention over all positions under the window mask."""
    import torch

    from seedx_tpu_torch.ops.attention import dot_product_attention

    b, s, f = k.shape
    hkv = ks.shape[-1]
    d = f // hkv
    kk = k.reshape(b, s, hkv, d).to(torch.bfloat16) * ks[..., None]
    vv = v.reshape(b, s, hkv, d).to(torch.bfloat16) * vs[..., None]
    pos = torch.arange(s, device=k.device)
    valid = (pos >= starts[:, None]) & (pos < ends[:, None])
    return dot_product_attention(q[:, None], kk, vv, kv_valid=valid,
                                 impl="plain")[:, 0]


# the UNet's and VAE's norms at 1024^2, CFG 2: (name, kind, shape, groups,
# eps, dtype, silu); GroupNorm at level 0 (resnet and Transformer2D), the
# up blocks' widest concatenations and a VAE decoder level, LayerNorm at
# the transformer blocks' two widths
NORM_SHAPES = (
    ("unet_resnet_l0", "group_norm", (2, 128, 128, 320), 32, 1e-5, "bf16",
     True),
    ("unet_attn_l0", "group_norm", (2, 128, 128, 320), 32, 1e-6, "bf16",
     False),
    ("unet_up_2560", "group_norm", (2, 32, 32, 2560), 32, 1e-5, "bf16",
     True),
    ("unet_up_1920", "group_norm", (2, 64, 64, 1920), 32, 1e-5, "bf16",
     True),
    ("vae_512", "group_norm", (1, 256, 256, 512), 32, 1e-6, "fp32", True),
    ("unet_block_640", "layer_norm", (2, 4096, 640), None, 1e-5, "bf16",
     False),
    ("unet_block_1280", "layer_norm", (2, 1024, 1280), None, 1e-5, "bf16",
     False))


def check_norms(dev, g, flush, shapes=NORM_SHAPES):
    """The GroupNorm (+ SiLU) and LayerNorm kernels against their plain
    chains: the norm within one bf16 ULP (relative 2^-7) plus 1e-5 of the
    output's scale, 1e-5 of it in fp32; with SiLU, within one ULP of
    ``F.silu`` of the kernel's own norm (the same fp32 SiLU of the same
    rounded value: a one-ULP difference in the norm can grow through SiLU);
    timed (the kernel, and the plain chain with ``F.silu`` where the kernel
    applies it) with the L2 flushed (the UNet's
    activations come from the layer before, mostly out of L2), beside
    their bound (input read once, output written once) and
    ``F.group_norm`` / ``F.layer_norm`` (+ ``F.silu``) in x's type, a
    yardstick only."""
    import torch
    import torch.nn.functional as F

    from seedx_tpu_torch.ops import norms

    types = {"bf16": torch.bfloat16, "fp32": torch.float32}
    rows = []
    for name, kind, shape, groups, eps, dt, silu in shapes:
        dtype, c = types[dt], shape[-1]
        x = (torch.randn(shape, generator=g, device=dev) * 1.5
             + torch.randn(c, generator=g, device=dev)).to(dtype)
        scale = 1.0 + 0.2 * torch.randn(c, generator=g, device=dev)
        bias = 0.2 * torch.randn(c, generator=g, device=dev)
        if kind == "group_norm":
            def kernel():
                return norms.group_norm(x, scale, bias, groups, eps,
                                        silu=silu)

            def plain():
                y = norms.group_norm_fp32_stats(x, scale, bias, groups, eps)
                return F.silu(y) if silu else y

            xc = x.permute(0, 3, 1, 2)
            sc, bi = scale.to(dtype), bias.to(dtype)

            def library():
                y = F.group_norm(xc, groups, sc, bi, eps)
                return F.silu(y) if silu else y
        else:
            def kernel():
                return norms.layer_norm(x, scale, bias, eps)

            def plain():
                return norms.layer_norm_fp32_stats(x, scale, bias, eps)

            sc, bi = scale.to(dtype), bias.to(dtype)

            def library():
                return F.layer_norm(x, (c,), sc, bi, eps)
        out = kernel()
        if kind == "group_norm":
            normed = norms.group_norm(x, scale, bias, groups, eps)
            ref = norms.group_norm_fp32_stats(x, scale, bias, groups, eps)
        else:
            normed, ref = out, plain()
        torch.cuda.synchronize()
        diff = (normed.float() - ref.float()).abs()
        mag = ref.float().abs().max().item()
        rtol = 2.0 ** -7 if dtype == torch.bfloat16 else 1e-6
        ok = bool((diff <= 1e-5 * mag + rtol * ref.float().abs()).all())
        if silu:
            act = F.silu(normed).float()
            ok = ok and bool(((out.float() - act).abs()
                              <= rtol * act.abs()).all())
        again = torch.equal(kernel(), out)
        n_bytes = 2 * x.numel() * x.element_size() + 8 * c
        bnd = bound(n_bytes, 0, "bf16")
        ms = cuda_ms(kernel, flush)
        r = row(kind, f"{name} {list(shape)} {dt}"
                f"{f' G{groups}' if groups else ''} eps {eps:g}"
                f"{' + silu' if silu else ''}", ok and again,
                diff.max().item(), ms, cuda_ms(plain, flush), bnd,
                cuda_ms(library, flush))
        log(fmt_row(r, f" bit-equal rerun {again}; kernel / bound "
                       f"{ms / bnd[0]:.2f}; plain / kernel "
                       f"{r['plain_ms'] / ms:.2f}"))
        rows.append(r)
    return rows


# the UNet's Dense epilogues at 1024^2, CFG 2, and the VAE decoder's:
# (name, kind, rows, columns in, dtype, residual, int8 scale); to_out /
# ff_out at level 2 (2048 x 1280) and level 1 (8192 x 640), the int8
# UNet's, GEGLU's projection at both levels (2F in, F out), the VAE mid
# attention's to_out (fp32)
EPILOGUE_SHAPES = (
    ("to_out_l2", "bias_residual", 2048, 1280, "bf16", True, False),
    ("to_out_l1", "bias_residual", 8192, 640, "bf16", True, False),
    ("to_out_l2_int8", "bias_residual", 2048, 1280, "bf16", True, True),
    ("geglu_l2", "bias_geglu", 2048, 10240, "bf16", False, False),
    ("geglu_l1", "bias_geglu", 8192, 5120, "bf16", False, False),
    ("vae_to_out", "bias_residual", 16384, 512, "fp32", True, False))


def ulps_apart(a, b):
    """How many representable values of a's type (bf16 or fp32) lie
    between a and b, elementwise: sign-magnitude bits made ordered."""
    import torch

    it, top = ((torch.int16, 1 << 15) if a.dtype == torch.bfloat16
               else (torch.int32, 1 << 31))

    def ordered(t):
        i = t.contiguous().view(it).long()
        return torch.where(i < 0, -(i + top), i)

    return (ordered(a) - ordered(b)).abs()


def check_epilogue(dev, g, flush, shapes=EPILOGUE_SHAPES):
    """The Dense epilogue kernels against their plain chains (the ones the
    UNet ran before them): ``bias_residual`` bit for bit, ``bias_geglu``
    within one ULP of its type (GELU's erff); a rerun gives the same bits.
    Timed with the L2 flushed (y comes from the GEMM before, the residual
    from earlier in the block), beside their bound (the inputs read once,
    the output written once) and the plain chain; and the calls an SDXL
    base eval makes of each (``epilogue_launches_per_eval``, which the
    image-out phase holds the replays to).  A kernel of a few MB is
    mostly fixed cost in a single launch's time, and the flush of the
    other rows (a zeroed buffer) leaves up to 50 MB of dirty lines in L2
    that its reads write back; so each is timed again in a stream of
    launches over eight input sets (``stream_ms``), as the captured eval
    runs it."""
    import torch

    from seedx_tpu_torch.models.sdxl.unet import (epilogue_launches_per_eval,
                                                  sdxl_base_unet)
    from seedx_tpu_torch.ops import epilogue

    per_eval = dict(zip(("bias_residual", "bias_geglu"),
                        epilogue_launches_per_eval(sdxl_base_unet())))
    types = {"bf16": torch.bfloat16, "fp32": torch.float32}
    rows_out = []
    for name, kind, rows, n, dt, res, scaled in shapes:
        dtype = types[dt]

        def inputs():
            return ((torch.randn((rows, n), generator=g, device=dev) * 2
                     ).to(dtype),
                    (0.3 * torch.randn(n, generator=g, device=dev)).to(dtype),
                    (torch.randn((rows, n), generator=g, device=dev).to(dtype)
                     if res else None),
                    ((0.02 * torch.rand(n, generator=g, device=dev) + 1e-3
                      ).to(dtype) if scaled else None))

        def call(fn, y, bias, resid, scale):
            if kind == "bias_residual":
                return lambda: fn(y, bias, resid, scale)
            return lambda: fn(y, bias, scale)

        y, bias, resid, scale = inputs()
        kernel = call(getattr(epilogue, kind), y, bias, resid, scale)
        plain = call(getattr(epilogue, kind + "_plain"), y, bias, resid,
                     scale)
        n_out = n if kind == "bias_residual" else n // 2
        out, ref = kernel(), plain()
        torch.cuda.synchronize()
        apart = ulps_apart(out, ref).max().item()
        err = (out.float() - ref.float()).abs().max().item()
        ok = apart == 0 if kind == "bias_residual" else apart <= 1
        again = torch.equal(kernel(), out)
        item = y.element_size()
        n_bytes = (rows * n * item * (2 if res else 1) + rows * n_out * item
                   + n * item * (2 if scaled else 1))
        bnd = bound(n_bytes, 0, "bf16")
        ms = cuda_ms(kernel, flush)
        sets = [call(getattr(epilogue, kind), *inputs()) for _ in range(7)]
        streamed = stream_ms([kernel] + sets)
        del sets
        r = row(kind, f"{name} [{rows},{n}] {dt}"
                f"{' + residual' if res else ''}"
                f"{' * scale' if scaled else ''}", ok and again, err, ms,
                cuda_ms(plain, flush), bnd)
        log(fmt_row(r, f" ({apart} ULP) bit-equal rerun {again}; bound / "
                       f"kernel {100 * bnd[0] / ms:.1f}%; in a stream "
                       f"{streamed:.4f} ms, {100 * bnd[0] / streamed:.1f}%; "
                       f"plain / kernel {r['plain_ms'] / ms:.2f}; "
                       f"{per_eval[kind]} calls an SDXL base eval"))
        rows_out.append(r)
    return rows_out


# K6 at DeepSeek-V2-Lite's expert widths (64 experts, hidden 2048, width
# 1408): (name, routed rows, gated): a decode step of 32 slots x top-6, a
# 2048-token and a 4096-token prefill, gate / up (SwiGLU epilogue) and down
MOE_SHAPES = (("decode_gate_up", 192, True), ("decode_down", 192, False),
              ("prefill2048_gate_up", 12288, True),
              ("prefill2048_down", 12288, False),
              ("prefill4096_gate_up", 24576, True),
              ("prefill4096_down", 24576, False))


def check_moe(dev, g, flush, shapes=MOE_SHAPES):
    """K6 against moe_gemm_plain (the per-expert fp32 matmul loop, TF32
    off): within one bf16 ULP of the largest value for the gated (bf16)
    output, 1e-5 of it for the fp32 one; rows spread at random over the
    experts
    (at 192 rows some get none, and read no weight); timed with the L2
    flushed beside its bound (each active expert's weights read once, the
    rows in and out once) and ``torch._grouped_mm`` on the same rows, a
    library yardstick only (the main path never calls it)."""
    import torch

    from seedx_tpu_torch.ops import moe

    e, d, f = 64, 2048, 1408
    rows_out = []
    for name, rows, gated in shapes:
        k_in, n_out = (d, f) if gated else (f, d)
        pick = torch.randint(0, e, (rows,), generator=g, device=dev)
        counts = torch.bincount(pick, minlength=e)
        offsets = torch.nn.functional.pad(torch.cumsum(counts, 0),
                                          (1, 0)).to(torch.int32)
        x = torch.randn((rows, k_in), generator=g, device=dev).to(
            torch.bfloat16)
        w = (torch.randn((e, k_in, n_out), generator=g, device=dev)
             * 0.02).to(torch.bfloat16)
        w2 = ((torch.randn((e, k_in, n_out), generator=g, device=dev)
               * 0.02).to(torch.bfloat16) if gated else None)

        def kernel():
            return moe.moe_gemm(x, w, offsets, w2)

        def plain():
            return moe.moe_gemm_plain(x, w, offsets, w2)

        out = kernel()
        saved = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = False
        try:
            ref = plain()
            plain_ms = cuda_ms(plain, flush, warmup=1, iters=3)
        finally:
            torch.backends.cuda.matmul.allow_tf32 = saved
        torch.cuda.synchronize()
        err = (out.float() - ref.float()).abs().max().item()
        mag = ref.float().abs().max().item()
        ok = err <= (2.0 ** -7 if gated else 1e-5) * mag
        again = torch.equal(kernel(), out)
        active = int((counts > 0).sum())
        nb = 2 if gated else 1
        n_bytes = (active * nb * k_in * n_out * 2
                   + rows * (k_in * 2 + n_out * (2 if gated else 4)))
        bnd = bound(n_bytes, 2.0 * nb * rows * k_in * n_out, "bf16")
        ms = cuda_ms(kernel, flush)
        lib_ms = None
        grouped = getattr(torch, "_grouped_mm", None)
        if grouped is not None:
            ends = offsets[1:].contiguous()
            # column-major experts, the layout the library takes
            wt = w.transpose(-2, -1).contiguous().transpose(-2, -1)
            wt2 = (w2.transpose(-2, -1).contiguous().transpose(-2, -1)
                   if gated else None)

            def library():
                y = grouped(x, wt, offs=ends)
                if gated:
                    y = torch.nn.functional.silu(y) * grouped(x, wt2,
                                                              offs=ends)
                return y

            try:
                lib_ms = cuda_ms(library, flush)
            except (RuntimeError, TypeError) as exc:
                log(f"torch._grouped_mm refused {name}: "
                    f"{str(exc).splitlines()[0][:160]}")
        r = row("moe_gemm", f"{name} R{rows} [{k_in}->{n_out}] E{e} "
                f"active {active}", ok and again, err, ms, plain_ms, bnd,
                lib_ms)
        log(fmt_row(r, f" bit-equal rerun {again}; kernel / bound "
                       f"{ms / bnd[0]:.2f}"))
        rows_out.append(r)
    return rows_out


MOE_RELU2_SHAPES = (("decode_up_relu2", 384, True),
                    ("decode_down", 384, False),
                    ("prefill1024_up_relu2", 6144, True),
                    ("prefill1024_down", 6144, False))


def check_moe_relu2(dev, g, flush, shapes=MOE_RELU2_SHAPES):
    """K6's relu2 epilogue at Nemotron-H's expert widths (E128, d2688,
    f1856: the 64- and 128-row tiles end in a 64-column tile) against
    moe_gemm_plain (TF32 off): within one bf16 ULP of the largest value
    for the relu2 (bf16) output, 1e-5 of it for the fp32 down; a decode
    step's rows (64 slots x top-6) and a 1024-token prefill's; timed with
    the L2 flushed beside its bound, and in a stream over the 23 expert
    blocks' weights (as a decode step runs them)."""
    import torch

    from seedx_tpu_torch.ops import moe

    e, d, f, blocks = 128, 2688, 1856, 23
    rows_out = []
    for name, rows, up in shapes:
        k_in, n_out = (d, f) if up else (f, d)
        act = "relu2" if up else None
        pick = torch.randint(0, e, (rows,), generator=g, device=dev)
        counts = torch.bincount(pick, minlength=e)
        offsets = torch.nn.functional.pad(torch.cumsum(counts, 0),
                                          (1, 0)).to(torch.int32)
        x = torch.randn((rows, k_in), generator=g, device=dev).to(
            torch.bfloat16)
        w = (torch.randn((e, k_in, n_out), generator=g, device=dev)
             * 0.02).to(torch.bfloat16)

        def kernel(w=w):
            return moe.moe_gemm(x, w, offsets, None, None, act)

        out = kernel()
        saved = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = False
        try:
            ref = moe.moe_gemm_plain(x, w, offsets, None, None, act)
            plain_ms = cuda_ms(lambda: moe.moe_gemm_plain(
                x, w, offsets, None, None, act), flush, warmup=1, iters=3)
        finally:
            torch.backends.cuda.matmul.allow_tf32 = saved
        torch.cuda.synchronize()
        err = (out.float() - ref.float()).abs().max().item()
        mag = ref.float().abs().max().item()
        ok = err <= (2.0 ** -7 if up else 1e-5) * mag
        again = torch.equal(kernel(), out)
        active = int((counts > 0).sum())
        n_bytes = (active * k_in * n_out * 2
                   + rows * (k_in * 2 + n_out * (2 if up else 4)))
        bnd = bound(n_bytes, 2.0 * rows * k_in * n_out, "bf16")
        ms = cuda_ms(kernel, flush)
        stream = ""
        if rows <= 384:
            ws = [w] + [(torch.randn((e, k_in, n_out), generator=g,
                                     device=dev) * 0.02).to(torch.bfloat16)
                        for _ in range(blocks - 1)]
            s_ms = stream_ms([lambda w=w_: kernel(w) for w_ in ws])
            stream = (f"; in a stream of {blocks} {s_ms:.4f} ms "
                      f"({bnd[0] / s_ms * 100:.1f}% of the bound)")
            del ws
        r = row("moe_gemm",
                f"{name} R{rows} [{k_in}->{n_out}] E{e} active {active}",
                ok and again, err, ms, plain_ms, bnd)
        log(fmt_row(r, f" bit-equal rerun {again}; kernel / bound "
                       f"{ms / bnd[0]:.2f}{stream}"))
        rows_out.append(r)
    return rows_out


def check_ssm_step(dev, g, flush, slots=(1, 64)):
    """K7 (the Mamba-2 state step) at Nemotron-H's widths (64 heads of
    64, state 128, 8 groups) against ssm_step_plain: the state within
    1e-5 of its largest value and y within 1e-5 of its own (fp32 sums in
    another order, expf / log1pf against torch's), a rerun bit-equal;
    timed with the L2 flushed beside its bound (the state read and
    written once, xbc and dt in, y out), and at 64 slots in a stream of
    23 launches over 23 states (a decode step's Mamba blocks)."""
    import torch

    from seedx_tpu_torch.ops import ssm

    h, p, gr, n, blocks = 64, 64, 8, 128, 23
    width = h * p + 2 * gr * n
    rows_out = []
    for b in slots:
        def inputs():
            state = torch.randn((b, h, p, n), generator=g, device=dev) * 0.5
            proj = torch.randn((b, width + h), generator=g, device=dev).to(
                torch.bfloat16)
            return state, proj[:, :width].contiguous(), proj[:, width:]

        state0, xbc, dt_raw = inputs()
        dt_bias, a_log, d_skip = (
            (torch.randn((h,), generator=g, device=dev) * 0.5).to(
                torch.bfloat16) for _ in range(3))
        args = (dt_bias, a_log, d_skip, h, p, gr)
        st = [state0.clone() for _ in range(3)]
        y = ssm.ssm_step(st[0], xbc, dt_raw, *args)
        y2 = ssm.ssm_step(st[1], xbc, dt_raw, *args)
        ref = ssm.ssm_step_plain(st[2], xbc, dt_raw, *args)
        torch.cuda.synchronize()
        again = torch.equal(y, y2) and torch.equal(st[0], st[1])
        err_s = (st[0] - st[2]).abs().max().item()
        err_y = (y - ref).abs().max().item()
        ok = (err_s <= 1e-5 * st[2].abs().max().item()
              and err_y <= 1e-5 * ref.abs().max().item())

        def kernel(state=state0, xbc=xbc, dt_raw=dt_raw):
            return ssm.ssm_step(state, xbc, dt_raw, *args)

        def plain():
            return ssm.ssm_step_plain(state0, xbc, dt_raw, *args)

        n_bytes = b * (2 * h * p * n * 4 + width * 2 + h * 2 + h * p * 4)
        bnd = bound(n_bytes, 5.0 * b * h * p * n, "fp32")
        ms = cuda_ms(kernel, flush)
        plain_ms = cuda_ms(plain, flush, warmup=1, iters=3)
        stream = ""
        if b == 64:
            sets = [(state0, xbc, dt_raw)] + [inputs()
                                              for _ in range(blocks - 1)]
            s_ms = stream_ms([lambda a=a_: kernel(*a) for a_ in sets])
            stream = (f"; in a stream of {blocks} {s_ms:.4f} ms "
                      f"({bnd[0] / s_ms * 100:.1f}% of the bound)")
            del sets
        r = row("ssm_step", f"B{b} H{h} P{p} N{n} G{gr}", ok and again,
                max(err_s, err_y), ms, plain_ms, bnd)
        log(fmt_row(r, f" bit-equal rerun {again}; kernel / bound "
                       f"{ms / bnd[0]:.2f}{stream}"))
        rows_out.append(r)
    return rows_out


def check_kernels(dev):
    """Phase 3: each kernel against its plain version at the path shapes."""
    import torch

    g = torch.Generator(device=dev).manual_seed(1234)
    flush = torch.empty(96 << 20, dtype=torch.uint8, device=dev)
    rows = check_flash(dev, g) + check_flash_bwd(dev, g)
    rows += check_int4(dev, g, flush)
    rows += check_int4_dequant(dev, g, flush)
    rows += check_decode(dev, g, flush)
    rows += check_stair(dev, g, flush)
    rows += check_stair_verify(dev, g, flush)
    rows += check_norms(dev, g, flush)
    rows += check_epilogue(dev, g, flush)
    rows += check_moe(dev, g, flush)
    rows += check_moe_relu2(dev, g, flush)
    rows += check_ssm_step(dev, g, flush)
    del flush
    return rows


def check_quantizers(dev) -> None:
    """The agent's quantizers on the card against the CPU, byte for byte:
    ``quantize_kernel_int4`` (group 128) and ``quantize_kernel`` at the
    13B's three projection shapes, ``quantize_embedding`` over the 32330
    x 5120 table."""
    import torch

    from seedx_tpu_torch.utils import quantize as q

    g = torch.Generator().manual_seed(11)
    cases = []
    for n_in, n_out in ((5120, 5120), (5120, 13824), (13824, 5120)):
        w = torch.empty((n_in, n_out)).normal_(0.0, 0.02, generator=g)
        cases += [(f"int4 {n_in}->{n_out}", lambda x: q.quantize_kernel_int4(
            x, 128), w), (f"int8 {n_in}->{n_out}", q.quantize_kernel, w)]
    cases.append(("embedding 32330x5120", q.quantize_embedding,
                  torch.empty((32330, 5120)).normal_(0.0, 0.02,
                                                     generator=g)))
    for name, fn, w in cases:
        want = fn(w)
        got = fn(w.to(dev))
        same = all(a.dtype == b.dtype and torch.equal(a.cpu(), b)
                   for a, b in zip(got, want))
        if not same:
            diff = [int((a.cpu() != b).sum()) for a, b in zip(got, want)]
            raise AssertionError(f"quantizer {name}: the card's codes / "
                                 f"scales differ from the CPU's in {diff} "
                                 f"elements")
    log(f"quantizers: {len(cases)} cases (int4 group 128 and int8 at the "
        f"13B's projection shapes, the int8 embedding) bit-equal on the "
        f"card and the CPU")


def check_tiny_stack(dev):
    """A tiny int4 + int8-KV stack on the card (kernels) against the same
    weights on the CPU (plain versions): ViT features, prefill logits, and
    the logits of four batched decode steps over left-padded prompts (the
    ragged decode kernel at head_dim 32 against its plain version)."""
    import torch
    from PIL import Image

    from seedx_tpu_torch.inference.apps import _prepare_image_prompt
    from seedx_tpu_torch.inference.runtime import SeedXRuntime
    from seedx_tpu_torch.models.llama import init_kv_cache

    rts = {d: SeedXRuntime.debug(seed=7, device=d, quantization="int4",
                                 kv_quantization="int8",
                                 decode_attention="force")
           for d in ("cpu", dev)}
    rts[dev].vit.load_state_dict(rts["cpu"].vit.state_dict())
    rts[dev].agent.load_state_dict(rts["cpu"].agent.state_dict())
    rng = np.random.default_rng(7)
    img = Image.fromarray((rng.random((90, 150, 3)) * 255).astype(np.uint8))
    tok = rts["cpu"].tokenizer
    prompts = ["Hi", "Tell me about the red bicycle by the lake.",
               "What is two plus two?"]
    p_len, steps = 64, 4
    ids = np.zeros((3, p_len), np.int64)
    mask = np.zeros((3, p_len), bool)
    for i, t in enumerate(prompts):
        x = [tok.bos_token_id] + tok.encode(t)
        ids[i, p_len - len(x):] = x
        mask[i, p_len - len(x):] = True
    res = {}
    for d, rt in rts.items():
        reset_counts()
        pr_ids, cmp, emb, ecm, ppos = _prepare_image_prompt(rt, img, "Why?")
        with torch.no_grad():
            pe = rt.agent.embed_with_images(
                torch.as_tensor(pr_ids, device=d)[None], emb,
                torch.as_tensor(cmp, device=d)[None],
                torch.as_tensor(ecm, device=d), ppos)
            pos = torch.arange(len(pr_ids), device=d)[None]
            logits, _, _ = rt.agent.llm_step(pe, pos)
            # batched decode: prefill 3 left-padded prompts into a cache,
            # then 4 one-token steps with the same fed tokens on both sides
            m = torch.as_tensor(mask, device=d)
            cache = init_kv_cache(rt.agent_cfg.llm, 3, p_len + steps,
                                  device=d)
            positions = torch.clamp(torch.cumsum(m.long(), -1) - 1, min=0)
            valid = torch.cat([m, torch.zeros((3, steps), dtype=torch.bool,
                                              device=d)], 1)
            rt.agent.llm_step(rt.agent.embed_ids(torch.as_tensor(
                ids, device=d)), positions, valid, cache, 0)
            step_logits = []
            for n in range(steps):
                valid[:, p_len + n] = True
                tok_n = torch.full((3, 1), 300 + 7 * n, device=d)
                out, _, _ = rt.agent.llm_step(
                    rt.agent.embed_ids(tok_n), positions[:, -1:] + 1 + n,
                    valid, cache, p_len + n)
                step_logits.append(out[:, 0].float().cpu())
        res[d] = (emb.float().cpu(), logits.float().cpu(),
                  torch.stack(step_logits))
        if d != "cpu":
            launches = read_counts()["decode_attn"]
            n_layers = rt.agent_cfg.llm.num_layers
            if launches != n_layers * steps:
                raise AssertionError(f"tiny stack: decode_attn launched "
                                     f"{launches} times, want "
                                     f"{n_layers * steps}")
    worst = 0.0
    for i, what in enumerate(("vit", "prefill_logits", "decode_logits")):
        ref, got = res["cpu"][i], res[dev][i]
        rel = ((got - ref).abs().max() / ref.abs().max()).item()
        worst = max(worst, rel)
        log(f"tiny stack {what}: card vs CPU max_rel_err {rel:.3e}")
    # bf16 on both sides with different summation orders, and int8
    # activation / KV codes that can flip on a rounding edge
    tol = 5e-2
    if not worst <= tol:
        raise AssertionError(f"tiny stack disagrees: {worst:.3e} > {tol}")
    log(f"tiny stack: ok (tol {tol}; decode_attn launched "
        f"{rts[dev].agent_cfg.llm.num_layers * steps} times in the decode "
        f"steps)")


def path_counts(name: str, needed=("flash_fwd", "int4_w4a8", "decode_attn")):
    """Read the counters after a path and fail unless each kernel it runs
    was launched."""
    counts = read_counts()
    log(f"{name}: launches {json.dumps(counts)}")
    for k in needed:
        if counts[k] <= 0:
            raise AssertionError(f"kernel {k} was not launched by {name}")
    return counts


# launches of the check runs (teacher-forced runs, the parity agent): read
# like the main path's, printed on their own line, not in the kernels line
CHECKS = {}


def add_counts(into, counts) -> None:
    for k, n in counts.items():
        into[k] = into.get(k, 0) + n


class Teacher:
    """Teacher forcing through a greedy decode loop.  While active it
    stands in for ``_sample`` in ``module`` (``models.generation``: the
    batched loop and chat; ``inference.continuous``: the engine) and runs
    ``rt``'s programs eagerly (a Python stand-in runs only when a step is
    traced, not when a captured graph replays).  On each call
    ``where(call)`` gives every row's key (a request; -1 for none) and the
    index of the token it samples (an int, or a tensor of one per row).  A
    row whose key has a sequence in ``seqs`` takes that sequence's token,
    any other row its argmax.  The constrained logits of every call are
    kept by (key, index), a later call winning: a slot that is still
    prefilling records garbage, which its first decode step overwrites
    (and a predicated step after decode stopped records garbage past
    every sequence's end)."""

    def __init__(self, rt, module, where, seqs=None):
        self.rt, self.module, self.where = rt, module, where
        self.seqs = seqs or {}
        self.calls = []
        self._table = self._index = None

    def __enter__(self):
        self.base = self.module._sample
        self.module._sample = self._sample
        self.graphs = self.rt.graphs.enabled
        self.rt.graphs.enabled = False
        return self

    def __exit__(self, *exc):
        self.module._sample = self.base
        self.rt.graphs.enabled = self.graphs
        self.where = self.rt = None   # they may hold an engine, a KV cache

    def _sample(self, logits, cfg, generator=None, noise=None):
        import torch

        keys, idx = self.where(len(self.calls))
        dev = logits.device
        k = torch.as_tensor(keys, device=dev)
        i = idx if torch.is_tensor(idx) else torch.full_like(k, idx)
        token = torch.argmax(logits, dim=-1)
        if self.seqs:
            if self._table is None:
                # [requests, longest] forced tokens, -1 past each sequence
                self._table = torch.full(
                    (max(self.seqs) + 1, max(map(len, self.seqs.values()))),
                    -1, dtype=torch.int64, device=dev)
                for key, seq in self.seqs.items():
                    self._table[key, :len(seq)] = torch.as_tensor(seq)
            r, t = self._table.shape
            f = self._table[k.clamp(0, r - 1), i.clamp(0, t - 1)]
            token = torch.where((k >= 0) & (k < r) & (i < t) & (f >= 0), f,
                                token)
        self.calls.append((list(keys), i.clone(), logits.clone()))
        return token

    def along(self, key: int, n: int):
        """[n, V] logits the rows of request ``key`` were given at token
        indices 0..n-1."""
        import torch

        if self._index is None:
            self._index = {}
            for c, (keys, idx, _) in enumerate(self.calls):
                for r, (kk, ii) in enumerate(zip(keys, idx.tolist())):
                    if kk >= 0:
                        self._index[(kk, ii)] = (c, r)
        miss = [j for j in range(n) if (key, j) not in self._index]
        if miss:
            raise AssertionError(f"no logits for request {key} at tokens "
                                 f"{miss[:4]}")
        return torch.stack([self.calls[c][2][r] for c, r in
                            (self._index[(key, j)] for j in range(n))])


def keep_hidden(eng) -> dict:
    """{request id: its hidden states [n, D]}, filled as ``eng``
    harvests each request."""
    store = {}
    base = eng._harvest

    def harvest():
        running = eng.state["running"].cpu()
        n = eng.state["n"].cpu()
        for i, rid in enumerate(eng._slot_req):
            if rid is not None and not running[i]:
                store[rid] = eng.state["out_hidden"][i, :n[i]].clone()
        base()

    eng._harvest = harvest
    return store


@contextlib.contextmanager
def stash_decode():
    """Every decode loop's outputs (tokens, hidden, finished; copies)
    while active, in call order."""
    from seedx_tpu_torch.models import generation

    outs = []
    base = generation._decode_loop

    def keep(*a, **kw):
        out, info = base(*a, **kw)
        outs.append({k: v.clone() for k, v in out.items()})
        return out, info

    generation._decode_loop = keep
    try:
        yield outs
    finally:
        generation._decode_loop = base


def same_outputs(a, b) -> bool:
    """Two stashes of decode outputs equal bit for bit."""
    return len(a) == len(b) and all(
        torch_equal(x[k], y[k]) for x, y in zip(a, b) for k in x)


def torch_equal(x, y) -> bool:
    """Two tensors (or two Nones) equal bit for bit."""
    import torch

    if x is None or y is None:
        return x is None and y is None
    return x.shape == y.shape and torch.equal(x, y)


def log_programs(label: str, programs) -> None:
    """Each captured program's capture time, graph pool memory, replays
    and kernel launches a replay."""
    for i, p in enumerate(programs):
        st = p.stats()
        if st["captured"]:
            log(f"{label}: graph {i}: captured in {st['capture_s'] * 1e3:.1f}"
                f" ms, pool {st['pool_bytes'] / 2**20:.1f} MiB, "
                f"{st['replays']} replays, {st['launches_per_replay']} "
                f"kernel launches a replay")


def engine_rows(eng):
    """``Teacher.where`` for a ``ContinuousEngine``: each slot's request
    id and the index of the token it samples next."""
    return lambda call: ([-1 if r is None else r for r in eng._slot_req],
                         eng.state["n"])


def forcing_sequence(stream, tokenizer):
    """A greedy stream as a sequence to force: cut at its first ``<img>``,
    which EOS replaces (after ``<img>`` the batched loop runs the forced
    span as one chunk, which no per-token forcing follows)."""
    seq = [int(x) for x in stream]
    boi = tokenizer.vocab.boi
    return (seq[:seq.index(boi)] + [tokenizer.eos_token_id] if boi in seq
            else seq)


def logit_diff(ref, got, seqs) -> float:
    """The largest |logit| difference between two teacher-forced runs over
    every token of every forced sequence."""
    return max((ref.along(k, len(s)) - got.along(k, len(s))).abs().max()
               .item() for k, s in seqs.items())


def forced_engine(rt, requests, budgets, seqs, label: str, **kw):
    """The continuous engine over ``requests``, teacher-forced along
    ``seqs`` (request i along ``seqs[i]``); returns its ``Teacher``.  Every
    request must come out as its sequence."""
    import torch

    from seedx_tpu_torch.inference import continuous

    reset_counts()
    t0 = time.perf_counter()
    eng = continuous.ContinuousEngine(rt, **ENGINE, **kw)
    with Teacher(rt, continuous, engine_rows(eng), seqs) as t:
        ids = [eng.submit(r, max_new_tokens=b)
               for r, b in zip(requests, budgets)]
        res = eng.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    bad = [i for i in ids if [int(x) for x in res[i]["tokens"]] != seqs[i]]
    if bad:
        raise AssertionError(f"{label}: forcing failed for requests {bad}")
    counts = path_counts(label, ("int4_w4a8", "decode_attn"))
    if kw.get("fused_prefill") and k3_modes()["multi_query"] <= 0:
        raise AssertionError(f"{label}: K3 never ran its multi-query mode")
    add_counts(CHECKS, counts)
    st = eng.stats()
    if kw.get("paged") and st["kv_tiles_free"] != st["kv_tiles_total"]:
        raise AssertionError(f"{label}: paged pool leaked pages: {st}")
    log(f"{label}: {st['mixed_steps']} mixed and {st['decode_steps']} "
        f"decode steps in {wall:.2f} s (forcing included)")
    return t


@contextlib.contextmanager
def stair_shift(shift: int):
    """A deliberately broken fused step: the stair's ends moved by
    ``shift`` keys in every multi-query call of the layer loop."""
    import torch

    from seedx_tpu_torch.models import llama

    base = llama.ragged_decode_attention

    def shifted(q, k, v, starts, ends, *a, **kw):
        if q.dim() == 4:
            ends = torch.maximum(ends + shift, starts)
        return base(q, k, v, starts, ends, *a, **kw)

    llama.ragged_decode_attention = shifted
    try:
        yield
    finally:
        llama.ragged_decode_attention = base


def forced_batched(rt, requests, seqs):
    """The batched loop (``generate_batch``, all requests in one batch),
    teacher-forced along ``seqs``; returns its ``Teacher``."""
    from seedx_tpu_torch.models import generation

    tok = rt.tokenizer
    reset_counts()
    gen_cfg = generation.GenerationConfig(
        max_new_tokens=max(map(len, seqs.values())),
        num_img_gen_tokens=rt.agent_cfg.num_img_out_tokens,
        eos_token_id=tok.eos_token_id, pad_token_id=tok.pad_token_id,
        prompt_buckets=ENGINE["prompt_buckets"])
    keys = list(range(len(requests)))
    with Teacher(rt, generation, lambda call: (keys, call), seqs) as t:
        outs = generation.generate_batch(rt.agent, tok, requests, gen_cfg)
    bad = [i for i, o in enumerate(outs)
           if [int(x) for x in o["tokens"][:len(seqs[i])]] != seqs[i]]
    if bad:
        raise AssertionError(f"forced batched: forcing failed for requests "
                             f"{bad}")
    add_counts(CHECKS, path_counts("forced batched"))
    return t


def tie_check(label: str, got, want, logits, enforce: bool):
    """None if the two greedy streams are equal; else the gap between the
    two tokens where they part, in bf16 steps of the logit scale, read
    from ``logits`` [n, V] (the path that gave ``got``, teacher-forced
    along ``want``), which must be a tie (``TIE_ULPS``) when ``enforce``;
    NaN where they part past the forced tokens (an ``<img>``)."""
    import math

    got, want = [int(x) for x in got], [int(x) for x in want]
    if got == want:
        return None
    n = min(len(got), len(want))
    i = next((j for j in range(n) if got[j] != want[j]), n)
    if i == n:
        raise AssertionError(f"{label}: streams differ in length only "
                             f"({len(got)} vs {len(want)} tokens)")
    if i >= logits.shape[0]:
        log(f"{label}: streams part at token {i}, past the forced tokens; "
            f"gap not measured")
        return float("nan")
    lg = logits[i]
    gap = abs(float(lg[got[i]]) - float(lg[want[i]]))
    scale = float(lg.abs().max())
    steps = gap / 2.0 ** (math.floor(math.log2(scale)) - 7)
    log(f"{label}: streams part at token {i} ({got[i]} vs {want[i]}): "
        f"logit gap {gap:.5g} = {steps:g} bf16 steps at logit scale "
        f"{scale:.5g} (a tie is <= {TIE_ULPS})")
    if enforce and steps > TIE_ULPS:
        raise AssertionError(f"{label}: streams part at token {i} with a "
                             f"logit gap of {steps:g} bf16 steps: not a tie")
    return steps


def parting_summary(parts) -> str:
    gaps = [g for g in parts if g is not None and g == g]
    return (f"equal on {parts.count(None)} of {len(parts)}, largest parting "
            f"gap {max(gaps or [0]):g} bf16 steps")


def build_runtime(dev, num_layers: int = 40):
    import torch

    from seedx_tpu_torch.inference.runtime import SeedXRuntime
    from seedx_tpu_torch.models.agent import AgentConfig
    from seedx_tpu_torch.models.llama import llama2_13b
    from seedx_tpu_torch.models.vit import qwen_vitg_448

    t0 = time.perf_counter()
    agent_cfg = AgentConfig(
        llm=llama2_13b(quantization="int4", kv_quantization="int8",
                       num_layers=num_layers),
        vit_dim=4096, resampler_heads=32, num_img_in_tokens=64,
        num_img_out_tokens=64)
    rt = SeedXRuntime.random(qwen_vitg_448(), agent_cfg, seed=0, device=dev)
    torch.cuda.synchronize()
    log(f"built ViT-bigG/14-448 bf16 + LLaMA2-13B int4/int8-KV agent "
        f"({num_layers} layers) on the card in "
        f"{time.perf_counter() - t0:.1f} s, "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated")
    return rt


def check_tokens(tokens, vocab_size: int, budget: int) -> None:
    toks = np.asarray(tokens)
    if not (toks.size and toks.size <= budget and toks.min() >= 0
            and toks.max() < vocab_size):
        raise AssertionError(f"bad token stream {toks[:8]}")


def run_turn(rt, label: str = "turn"):
    """Phase 4: the full-width turn through the public entry points
    (phase 12 runs it on the loaded runtime)."""
    import torch
    from PIL import Image

    from seedx_tpu_torch.inference.apps import comprehend

    rng = np.random.default_rng(0)
    images = [Image.fromarray((rng.random((h, w, 3)) * 255).astype(np.uint8))
              for w, h in ((448, 448), (896, 448), (896, 896))]
    tok = rt.tokenizer
    img_ids = [tok.bos_token_id] + tok.encode(
        "[INST] Generate an image: a red bicycle by a lake [/INST]\n<img>")

    torch.cuda.reset_peak_memory_stats()
    reset_counts()
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
    counts = path_counts(label)
    log(f"request 3 generate <img>: prefill {t['prefill'] * 1e3:.1f} ms, "
        f"decode {t['decode'] * 1e3:.1f} ms for {t['decode_tokens']} tokens "
        f"in {t['decode_forwards']} forwards")
    log(f"{label}: max_memory_allocated "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")

    vocab = tok.vocab
    for out in outs:
        check_tokens(out["tokens"], rt.agent_cfg.llm.vocab_size, 32)
    forced = list(range(vocab.img_token_start, vocab.img_token_start + 64))
    if list(gen["tokens"][:65]) != forced + [vocab.eoi]:
        raise AssertionError("the <img> request did not emit the forced span")
    feat = gen["img_gen_feat"]
    if feat is None or tuple(feat.shape) != (1, 64, rt.agent_cfg.vit_dim) \
            or not torch.isfinite(feat.float()).all():
        raise AssertionError(f"bad img_gen_feat: "
                             f"{None if feat is None else feat.shape}")
    log(f"{label}: outputs ok (token ids in range, forced span, img_gen_feat "
        f"{tuple(feat.shape)} finite)")
    return counts


def engine_line(name, n_req, n_tok, wall, ms_step, counts) -> None:
    import torch

    log(f"{name}: {n_req} requests, {n_tok} generated tokens in "
        f"{wall:.2f} s ({n_tok / wall:.2f} tok/s), decode {ms_step}, "
        f"decode_attn launches {counts['decode_attn']}, peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")


def serving_inputs(rt):
    """Phase 5's traffic: 4 images with questions and 4 text prompts, and
    the continuous engine's 16 requests (those 8 twice, images encoded)
    with budgets 8..64.  Returns (images, questions, raw ids, requests,
    budgets)."""
    from PIL import Image

    from seedx_tpu_torch.inference.apps import _prepare_image_prompt

    rng = np.random.default_rng(1)
    images = [Image.fromarray((rng.random((h, w, 3)) * 255).astype(np.uint8))
              for w, h in ((448, 448), (896, 448), (448, 896), (896, 896))]
    tok = rt.tokenizer
    questions = ["Describe the image.", "What colors do you see?",
                 "Is there a person?", "What is in the corner?"]
    texts = ["Write a short poem about the sea.",
             "What is the capital of France?", "List three colors.",
             "Explain in one sentence why the sky is blue."]
    raw = [[tok.bos_token_id] + tok.encode(f"[INST] {t} [/INST]\n")
           for t in texts]
    requests = []
    for img, q in zip(images, questions):
        ids, cm, emb, ecm, pp = _prepare_image_prompt(rt, img, q)
        requests.append({"input_ids": ids, "image_embeds": emb,
                         "embeds_cmp_mask": ecm, "ids_cmp_mask": cm,
                         "patch_positions": pp})
    requests += [{"input_ids": ids} for ids in raw]
    return (images, questions, raw, requests * 2,
            [8 + (56 * i) // 15 for i in range(16)])


def run_serving(rt):
    """Phase 5: the serving engines at full width on the turn's runtime."""
    import base64
    import io
    import urllib.request
    from http.server import ThreadingHTTPServer

    import torch

    from seedx_tpu_torch.inference import continuous, serving
    from seedx_tpu_torch.inference.server import SeedXServer
    from seedx_tpu_torch.models import layers
    from seedx_tpu_torch.ops import int4_matmul as i4

    vocab_size = rt.agent_cfg.llm.vocab_size
    images, questions, raw, requests, budgets = serving_inputs(rt)
    totals = {}

    # -- ServingEngine: one flush of 8 requests, bucket groups of <= 8
    groups = []
    base_generate = serving.generate_batch

    def timed_generate(model, tokenizer, requests, gen_cfg=None):
        t = {}
        out = base_generate(model, tokenizer, requests, gen_cfg=gen_cfg,
                            timings=t)
        groups.append((len(requests), t))
        return out

    # the branch each int4 projection of the flush takes, by row count:
    # W4A8 (K2) up to int4_matmul.MAX_KERNEL_ROWS rows, W4A16 above
    branches = collections.Counter()
    base_auto = layers.int4_matmul_auto

    def logged_auto(x, packed, scale):
        rows = x.numel() // x.shape[-1]
        branches[(i4.int4_branch(rows), rows)] += 1
        return base_auto(x, packed, scale)

    serving.generate_batch = timed_generate
    layers.int4_matmul_auto = logged_auto
    try:
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        t0 = time.perf_counter()
        eng = serving.ServingEngine(rt, max_batch_size=8, max_new_tokens=32)
        for img, q in zip(images, questions):
            eng.submit_comprehend(img, q)
        for ids in raw:
            eng.submit_raw({"input_ids": ids})
        outs = eng.flush()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        serving.generate_batch = base_generate
        layers.int4_matmul_auto = base_auto
    add_counts(totals, path_counts("serving batched"))
    log("serving batched: int4 projections by branch and rows: " + ", ".join(
        f"{br} rows {rows} x{n}" for (br, rows), n in sorted(branches.items())))
    for out in outs:
        check_tokens(out["tokens"], vocab_size, 32)
    steps = ", ".join(f"B{b} {t['decode'] / t['decode_forwards'] * 1e3:.2f} "
                      f"ms/step over {t['decode_forwards']} steps"
                      for b, t in groups)
    engine_line("serving batched", len(outs),
                sum(len(o["tokens"]) for o in outs), wall, steps,
                read_counts())

    # -- ContinuousEngine: 8 slots, 16 requests with budgets 8..64; each
    # variant with its step programs captured (the main path), then the
    # same run eager: streams and hidden states must be bit-equal
    # per-chunk host time (closed by the chunk's host read) of both kinds
    timed = {"decode": [0.0, 0], "mixed": [0.0, 0]}
    base_chunk = continuous.run_chunk
    current = {}

    def timed_chunk(program, state, k, *a):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        n = base_chunk(program, state, k, *a)
        kind = ("mixed" if program is current["eng"]._programs.get("mixed")
                else "decode")
        timed[kind][0] += time.perf_counter() - t1
        timed[kind][1] += n
        return n

    streams, eager_streams = {}, {}
    variants = (("dense", {}), ("paged", {"paged": True}),
                ("fused dense", FUSED),
                ("fused paged", dict(FUSED, paged=True)))
    continuous.run_chunk = timed_chunk
    try:
        for variant, kw in variants:
            hidden = {}
            for mode in ("graphs", "eager"):
                name = f"serving continuous {variant} ({mode})"
                rt.graphs.enabled = mode == "graphs"
                for v in timed.values():
                    v[:] = [0.0, 0]
                torch.cuda.empty_cache()
                torch.cuda.reset_peak_memory_stats()
                reset_counts()
                t0 = time.perf_counter()
                eng = continuous.ContinuousEngine(rt, **ENGINE, **kw)
                current["eng"] = eng
                hidden[mode] = keep_hidden(eng)
                # the non-fused dense eager run keeps its logits: the
                # reference the forced runs below are held to (greedy
                # tokens unchanged)
                rec = (Teacher(rt, continuous, engine_rows(eng))
                       if (variant, mode) == ("dense", "eager")
                       else contextlib.nullcontext())
                with rec as t:
                    ids = [eng.submit(r, max_new_tokens=b)
                           for r, b in zip(requests, budgets)]
                    res = eng.run()
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
                if (variant, mode) == ("dense", "eager"):
                    ref = t
                fused = "fused_prefill" in kw
                counts = path_counts(
                    name, ("int4_w4a8", "decode_attn") if fused
                    else ("flash_fwd", "int4_w4a8", "decode_attn"))
                add_counts(totals if mode == "graphs" else CHECKS, counts)
                modes = k3_modes()
                if fused and modes["multi_query"] <= 0:
                    raise AssertionError(f"{name}: K3 never ran its "
                                         f"multi-query mode: {modes}")
                got = [list(res[i]["tokens"]) for i in ids]
                (streams if mode == "graphs" else eager_streams)[variant] = got
                hidden[mode] = [hidden[mode][i] for i in ids]
                for s_, b in zip(got, budgets):
                    check_tokens(s_, vocab_size, b)
                st = eng.stats()
                per = ", ".join(
                    f"{kind} {t_ / n * 1e3:.2f} ms/step over {n} steps"
                    for kind, (t_, n) in timed.items() if n)
                engine_line(name, len(ids), sum(map(len, got)), wall,
                            f"B8 {per} in {st['chunks']} chunks "
                            f"({st['mixed_chunks']} mixed)", read_counts())
                if mode == "graphs":
                    log_programs(name, eng._programs.values())
                if kw.get("paged") and (st["kv_tiles_free"]
                                        != st["kv_tiles_total"]):
                    raise AssertionError(f"paged pool leaked pages: {st}")
                del eng
                current.clear()
            same = (streams[variant] == eager_streams[variant],
                    all(torch.equal(a, b) for a, b in
                        zip(hidden["graphs"], hidden["eager"])))
            if not all(same):
                raise AssertionError(f"serving continuous {variant}: the "
                                     f"captured run differs from the eager "
                                     f"one (streams, hidden equal: {same})")
            log(f"serving continuous {variant}: captured and eager token "
                f"streams and hidden states bit-equal for all "
                f"{len(requests)} requests")
    finally:
        continuous.run_chunk = base_chunk
        rt.graphs.enabled = True
    for a_, b_ in (("paged", "dense"), ("fused paged", "fused dense")):
        if streams[a_] != streams[b_]:
            bad = [i for i, (x, y) in enumerate(zip(streams[a_],
                                                    streams[b_])) if x != y]
            raise AssertionError(f"{a_} token streams differ from {b_} at "
                                 f"requests {bad}")
    log("serving continuous: paged token streams equal dense, fused paged "
        "equal fused dense, for all 16 requests; every page returned to "
        "the pool")
    limit = fused_logits_check(rt, requests, budgets, streams, ref)

    for graphs in (True, False):
        rt.graphs.enabled = graphs
        for slots in (1, 8):
            profile_decode(rt, requests, slots)
        profile_mixed(rt, requests)
    rt.graphs.enabled = True

    # -- SeedXServer: 4 concurrent POSTs on 127.0.0.1
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    server = SeedXServer(rt, max_batch_size=8, max_new_tokens=16).warmup()
    httpd = ThreadingHTTPServer(("127.0.0.1", 0), server.make_handler())
    serve_thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    serve_thread.start()
    url = f"http://127.0.0.1:{httpd.server_address[1]}"
    buf = io.BytesIO()
    images[1].save(buf, format="PNG")
    img_b64 = base64.b64encode(buf.getvalue()).decode("ascii")
    bodies = [("/v1/comprehend", {"image": img_b64, "question": q})
              for q in questions[:2]]
    bodies += [("/v1/raw", {"input_ids": ids}) for ids in raw[:2]]
    replies = {}

    def post(i, path, body):
        req = urllib.request.Request(
            url + path, data=json.dumps(body).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=300) as r:
            replies[i] = (r.status, json.loads(r.read()))

    t0 = time.perf_counter()
    posts = [threading.Thread(target=post, args=(i, p, b))
             for i, (p, b) in enumerate(bodies)]
    try:
        for t in posts:
            t.start()
        for t in posts:
            t.join(300)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        stats = server.stats()
    finally:
        httpd.shutdown()
        httpd.server_close()
        server.shutdown()
        serve_thread.join(60)
    add_counts(totals, path_counts("serving http"))
    if sorted(replies) != [0, 1, 2, 3] or any(
            s != 200 or not isinstance(r.get("text"), str)
            for s, r in replies.values()):
        raise AssertionError(f"http replies: {replies}")
    log(f"serving http: 4 concurrent POSTs answered 200 in {wall:.2f} s "
        f"in {stats['batches']} engine batches, decode_attn launches "
        f"{read_counts()['decode_attn']}, peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; server stats "
        f"{json.dumps(stats)}")
    return totals, requests, budgets, limit


def dsv2_lite_llm():
    """DeepSeek-V2-Lite's LLM at its published sizes (deepseek-ai/
    DeepSeek-V2-Lite config.json), bf16."""
    from seedx_tpu_torch.models.llama import LlamaConfig

    return LlamaConfig(
        vocab_size=102400, hidden_size=2048, intermediate_size=10944,
        num_layers=27, num_heads=16, num_kv_heads=16, rope_theta=10000.0,
        rms_eps=1e-6, max_position_embeddings=163840, kv_lora_rank=512,
        qk_nope_head_dim=128, qk_rope_head_dim=64, v_head_dim=128,
        n_routed_experts=64, num_experts_per_tok=6, moe_intermediate_size=1408,
        n_shared_experts=2, first_k_dense_replace=1, routed_scaling_factor=1.0,
        yarn_factor=40.0, yarn_original_max_position=4096, yarn_beta_fast=32,
        yarn_beta_slow=1, yarn_mscale=0.707, yarn_mscale_all_dim=0.707)


def serve_captured_and_eager(rt, label, requests, budgets, want):
    """``requests`` through ``ContinuousEngine`` (``ENGINE``) on ``rt``,
    captured (the main path) and then eager: token streams and hidden
    states bit-equal, and each kernel's launches as ``want(steps, groups)``
    gives them ({counter: launches}) for the steps run (replays and warm
    runs) and the prefill groups.  Returns the captured run's launches."""
    import torch

    from seedx_tpu_torch.inference import continuous

    llm = rt.agent_cfg.llm
    # the tokenizer has no entry for the LLM's rows past its multimodal
    # vocabulary: a result's text leaves those ids out
    tok = rt.tokenizer
    decode, limit = tok.decode, tok.vocab.vocab_size
    tok.decode = lambda ids, skip_special_tokens=False: decode(
        [int(t) for t in ids if int(t) < limit], skip_special_tokens)
    active = rt.agent.llm.layers.experts_active
    blocks = llm.num_layers - llm.dense_layers - llm.block_pattern.count(
        "M") - llm.block_pattern.count("*")
    steps = [0]
    base_chunk = continuous.run_chunk

    def counted_chunk(program, state, k, *a, **kw):
        steps[0] += k
        return base_chunk(program, state, k, *a, **kw)

    totals, streams, hidden = {}, {}, {}
    continuous.run_chunk = counted_chunk
    try:
        for mode in ("graphs", "eager"):
            name = f"serving continuous {label} ({mode})"
            rt.graphs.enabled = mode == "graphs"
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            eng = continuous.ContinuousEngine(rt, **ENGINE)
            groups = [0]
            group = eng._prefill_group

            def counted_group(reqs, bucket, group=group, groups=groups):
                groups[0] += 1
                return group(reqs, bucket)

            eng._prefill_group = counted_group
            kept = keep_hidden(eng)
            steps[0] = 0
            a0 = int(active)
            reset_counts()
            t1 = time.perf_counter()
            ids = [eng.submit(r, max_new_tokens=b)
                   for r, b in zip(requests, budgets)]
            res = eng.run()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t1
            expected = want(steps[0], groups[0])
            counts = path_counts(name, tuple(expected))
            add_counts(totals if mode == "graphs" else CHECKS, counts)
            for k, n in expected.items():
                if counts[k] != n:
                    raise AssertionError(
                        f"{name}: {k} launched {counts[k]} times, want {n} "
                        f"for {steps[0]} steps and {groups[0]} prefill "
                        f"groups")
            got = [list(res[i]["tokens"]) for i in ids]
            for s_, b in zip(got, budgets):
                check_tokens(s_, llm.vocab_size, b)
            streams[mode] = got
            hidden[mode] = [kept[i] for i in ids]
            n_act = int(active) - a0
            log(f"{name}: {len(ids)} requests, {sum(map(len, got))} tokens "
                f"in {wall:.2f} s, {steps[0]} steps run in "
                f"{eng.stats()['chunks']} chunks, {groups[0]} prefill "
                f"groups; launches as expected: {json.dumps(expected)}; "
                f"{n_act} (block, pass) expert activations, "
                f"{n_act / (blocks * (steps[0] + groups[0])):.1f} experts "
                f"an expert block a pass; peak memory "
                f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
            if mode == "graphs":
                log_programs(name, eng._programs.values())
            del eng
    finally:
        continuous.run_chunk = base_chunk
        rt.graphs.enabled = True
    same = (streams["graphs"] == streams["eager"],
            all(torch.equal(a, b) for a, b in zip(hidden["graphs"],
                                                   hidden["eager"])))
    if not all(same):
        raise AssertionError(f"serving continuous {label}: the captured run "
                             f"differs from the eager one (streams, hidden "
                             f"equal: {same})")
    log(f"serving continuous {label}: captured and eager token streams and "
        f"hidden states bit-equal for all {len(requests)} requests")
    return totals


def run_moe_serving(dev):
    """Phase 5's 16 requests through ``ContinuousEngine`` on ViT-bigG and
    an agent with DeepSeek-V2-Lite as its LLM (random weights from seed
    0), captured (the main path) and then eager: token streams and hidden
    states bit-equal, and K6 launched twice in each MoE layer of every
    step run (replays and warm runs) and of every prefill group.  Returns
    the captured run's launches."""
    import torch

    from seedx_tpu_torch.inference.runtime import SeedXRuntime
    from seedx_tpu_torch.models.agent import AgentConfig
    from seedx_tpu_torch.models.vit import qwen_vitg_448

    t0 = time.perf_counter()
    llm = dsv2_lite_llm()
    rt = SeedXRuntime.random(
        qwen_vitg_448(), AgentConfig(llm=llm, vit_dim=4096,
                                     resampler_heads=32, num_img_in_tokens=64,
                                     num_img_out_tokens=64),
        seed=0, device=dev)
    torch.cuda.synchronize()
    log(f"built ViT-bigG/14-448 + DeepSeek-V2-Lite agent (bf16) on the "
        f"card in {time.perf_counter() - t0:.1f} s, "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated")
    requests, budgets = serving_inputs(rt)[3:]
    per_pass = 2 * (llm.num_layers - llm.dense_layers)
    totals = serve_captured_and_eager(
        rt, "DeepSeek-V2-Lite", requests, budgets,
        lambda steps, groups: {"moe_gemm": per_pass * (steps + groups)})
    del rt
    gc.collect()
    torch.cuda.empty_cache()
    return totals


def nemotron_nano_llm():
    """NVIDIA Nemotron-3-Nano-30B-A3B's LLM at its published sizes
    (nvidia/NVIDIA-Nemotron-3-Nano-30B-A3B-BF16 config.json), bf16: 23
    Mamba-2 mixers, 23 relu2 expert blocks (128 experts top-6, sigmoid
    router) and 6 NoPE GQA blocks."""
    from seedx_tpu_torch.models.llama import LlamaConfig

    pattern = "MEMEM*EMEMEM*EMEMEM*EMEMEM*EMEMEM*EMEMEMEM*EMEMEMEME"
    return LlamaConfig(
        vocab_size=131072, hidden_size=2688, intermediate_size=1856,
        num_layers=len(pattern), num_heads=32, num_kv_heads=2,
        attn_head_dim=128, rope=False, rms_eps=1e-5,
        max_position_embeddings=262144, block_pattern=pattern,
        mamba_heads=64, mamba_head_dim=64, ssm_state_size=128,
        mamba_groups=8, conv_kernel=4, ssm_chunk=128, n_routed_experts=128,
        num_experts_per_tok=6, moe_intermediate_size=1856,
        n_shared_experts=1, shared_intermediate_size=3712,
        routed_scaling_factor=2.5, expert_act="relu2",
        router_scoring="sigmoid")


def run_nemotron_serving(dev):
    """Text requests through ``ContinuousEngine`` on ViT-bigG and an agent
    with Nemotron-3-Nano as its LLM (random weights from seed 0, ~67 GB),
    captured (the main path) and then eager: token streams and hidden
    states bit-equal; K7 launched once a Mamba block of every step run,
    K6 twice an expert block (both relu2's up and the down) of every step
    run and every prefill group.  16 requests over 8 slots (slots
    reused), prompts in the 128 and 512 buckets.  Returns the captured
    run's launches."""
    import torch

    from seedx_tpu_torch.inference.runtime import SeedXRuntime
    from seedx_tpu_torch.models.agent import AgentConfig
    from seedx_tpu_torch.models.vit import qwen_vitg_448

    t0 = time.perf_counter()
    llm = nemotron_nano_llm()
    rt = SeedXRuntime.random(
        qwen_vitg_448(), AgentConfig(llm=llm, vit_dim=4096,
                                     resampler_heads=32, num_img_in_tokens=64,
                                     num_img_out_tokens=64),
        seed=0, device=dev)
    torch.cuda.synchronize()
    log(f"built ViT-bigG/14-448 + Nemotron-3-Nano agent (bf16) on the card "
        f"in {time.perf_counter() - t0:.1f} s, "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated")
    tok = rt.tokenizer
    texts = ["Write a short poem about the sea.",
             "What is the capital of France?", "List three colors.",
             "Summarize: " + " ".join(["the tide rises and falls"] * 12)]
    requests = [{"input_ids": [tok.bos_token_id]
                 + tok.encode(f"[INST] {t} [/INST]\n")} for t in texts] * 4
    budgets = [8 + (56 * i) // 15 for i in range(16)]
    mamba = llm.block_pattern.count("M")
    experts = llm.block_pattern.count("E")
    totals = serve_captured_and_eager(
        rt, "Nemotron-3-Nano", requests, budgets,
        lambda steps, groups: {
            "ssm_step": mamba * steps,
            "moe_gemm": 2 * experts * (steps + groups),
            "moe_gemm relu2": experts * (steps + groups),
            "decode_attn": llm.block_pattern.count("*") * steps})
    del rt
    gc.collect()
    torch.cuda.empty_cache()
    return totals


def fused_logits_check(rt, requests, budgets, streams, ref) -> float:
    """The fused step at full depth, held by its logits: the non-fused
    dense engine's tokens are forced through the fused dense engine and
    through the batched loop, whose difference from the non-fused engine
    is the noise floor.  Returns the
    limit (``LOGIT_FACTOR`` x the noise floor); logs the greedy partings
    of fused and non-fused dense with their gap in the fused logits."""
    import torch

    seqs = {i: forcing_sequence(s, rt.tokenizer)
            for i, s in enumerate(streams["dense"])}
    torch.cuda.empty_cache()
    fused = forced_engine(rt, requests, budgets, seqs,
                          "forced fused packed dense", **FUSED)
    noise = logit_diff(ref, forced_batched(rt, requests, seqs), seqs)
    limit = LOGIT_FACTOR * noise
    log(f"logits, 40 layers, teacher-forced along the non-fused dense "
        f"engine's {sum(map(len, seqs.values()))} tokens: noise floor (the "
        f"batched loop vs the engine) max |diff| {noise:.5g}; limit "
        f"{LOGIT_FACTOR:g} x that = {limit:.5g}")
    d = logit_diff(ref, fused, seqs)
    log(f"logits, 40 layers: fused packed dense vs non-fused dense max "
        f"|diff| {d:.5g} ({d / max(noise, 1e-30):.3g} x the noise floor)")
    if not d <= limit:
        raise AssertionError(f"fused packed dense: logits differ from the "
                             f"non-fused engine's by {d:.5g} > {limit:.5g}")
    # the limit must catch a broken stair: the fused step's stair shifted
    # by one key, so each query attends one key too few or one too many
    for shift in (-1, 1):
        with stair_shift(shift):
            t = forced_engine(rt, requests, budgets, seqs,
                              f"forced fused packed dense, stair shifted "
                              f"{shift:+d}", **FUSED)
        d = logit_diff(ref, t, seqs)
        log(f"logits, 40 layers: the stair shifted {shift:+d} gives max "
            f"|diff| {d:.5g} ({d / max(noise, 1e-30):.3g} x the noise "
            f"floor)")
        if not d > limit:
            raise AssertionError(f"the logit limit {limit:.5g} misses a "
                                 f"stair shifted by {shift:+d} ({d:.5g})")
    parts = [tie_check(f"fused vs dense request {i}",
                       streams["fused dense"][i], streams["dense"][i],
                       fused.along(i, len(seqs[i])), enforce=False)
             for i in range(len(requests))]
    log(f"serving continuous, 40 layers: fused dense vs non-fused dense "
        f"streams {parting_summary(parts)} (logged, not held: see "
        f"LOGIT_FACTOR)")
    return limit


def chat_image():
    rng = np.random.default_rng(3)
    from PIL import Image

    return Image.fromarray((rng.random((448, 896, 3)) * 255).astype(
        np.uint8))


def chat_turns(rt, label: str, enforce: bool, limit=None):
    """Three chat turns (an 896x448 image in the first) through a session
    with the KV prefix cache and one without; returns the launches, read
    right after those six sends.  Then a third session with the prefix
    cache is teacher-forced along the uncached session's replies: its
    logits give the gap where the greedy replies part, and, given
    ``limit``, must stay within it of the uncached session's."""
    import torch

    from seedx_tpu_torch.inference.chat import ChatSession
    from seedx_tpu_torch.models import generation

    image = chat_image()
    sends = [("Describe the image in detail.", image),
             ("What colors stand out?", None),
             ("Write one sentence about it.", None)]
    sessions = {"cached": ChatSession(rt, prefix_cache=True,
                                      cache_capacity=2048),
                "full": ChatSession(rt, prefix_cache=False)}
    one_row = (lambda call: ([0], call))
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    outs, refs = [], []
    for turn, (text, img) in enumerate(sends, 1):
        out = {}
        for name, sess in sessions.items():
            t = {}
            # the uncached session keeps its logits (greedy tokens unchanged)
            with (Teacher(rt, generation, one_row) if name == "full"
                  else contextlib.nullcontext()) as rec:
                out[name] = sess.send(text, image=img, max_new_tokens=32,
                                      timings=t)
            if name == "full":
                refs.append(rec)
            check_tokens(out[name]["tokens"], rt.agent_cfg.llm.vocab_size,
                         32)
            log(f"{label} {name} turn {turn}: prefill "
                f"{sess.last_prefill_tokens} tokens in "
                f"{t['prefill'] * 1e3:.1f} ms (reused "
                f"{sess.last_reused}), decode {t['decode'] * 1e3:.1f} ms "
                f"for {t['decode_tokens']} tokens")
        if turn > 1 and sessions["cached"].last_reused <= 0:
            raise AssertionError(f"{label} turn {turn}: the prefix cache "
                                 f"was not reused")
        outs.append(out)
    counts = path_counts(label)
    log(f"{label}: peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")

    reset_counts()
    forced = ChatSession(rt, prefix_cache=True, cache_capacity=2048)
    compared, worst = True, 0.0
    for turn, ((text, img), out, ref) in enumerate(zip(sends, outs, refs),
                                                   1):
        seq = forcing_sequence(out["full"]["tokens"], rt.tokenizer)
        with Teacher(rt, generation, one_row, {0: seq}) as t:
            got = forced.send(text, image=img, max_new_tokens=32)
        if [int(x) for x in got["tokens"]] != seq:
            raise AssertionError(f"{label} turn {turn}: forcing failed")
        lg = t.along(0, len(seq))
        worst = max(worst, (ref.along(0, len(seq)) - lg).abs().max().item())
        if compared:
            gap = tie_check(f"{label} turn {turn}", out["cached"]["tokens"],
                            out["full"]["tokens"], lg, enforce)
            if gap is None:
                log(f"{label} turn {turn}: cached and full-prefill replies "
                    f"equal ({len(seq)} tokens)")
            else:
                compared = False       # the histories differ from here on
                log(f"{label}: later turns' greedy histories differ after "
                    f"the parting; not compared")
        if len(seq) != len(out["full"]["tokens"]):
            log(f"{label}: the reply of turn {turn} holds <img>; later "
                f"turns not forced")
            break
    add_counts(CHECKS, path_counts(f"{label} forced"))
    if limit is not None:
        log(f"{label}: logits of the forced cached session vs the full "
            f"prefill max |diff| {worst:.5g} (limit {limit:.5g})")
        if not worst <= limit:
            raise AssertionError(f"{label}: cached chat logits differ by "
                                 f"{worst:.5g} > {limit:.5g}")
    return counts


def run_chat(rt, limit: float):
    """Phase 6: chat turns with and without the KV prefix cache at full
    depth (their logits held to ``limit``), then two POSTs to /v1/chat on
    one session."""
    import base64
    import io
    import urllib.request
    from http.server import ThreadingHTTPServer

    import torch

    from seedx_tpu_torch.inference.server import SeedXServer

    totals = chat_turns(rt, "chat", enforce=False, limit=limit)
    image = chat_image()

    # -- /v1/chat: two POSTs on one session
    torch.cuda.empty_cache()
    reset_counts()
    server = SeedXServer(rt, max_new_tokens=16).warmup()
    httpd = ThreadingHTTPServer(("127.0.0.1", 0), server.make_handler())
    serve_thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    serve_thread.start()
    url = f"http://127.0.0.1:{httpd.server_address[1]}"
    buf = io.BytesIO()
    image.save(buf, format="PNG")
    bodies = [{"session": "smoke", "message": "What is this?",
               "image": base64.b64encode(buf.getvalue()).decode("ascii"),
               "max_new_tokens": 16},
              {"session": "smoke", "message": "And the colors?",
               "max_new_tokens": 16}]
    replies = []
    t0 = time.perf_counter()
    try:
        for body in bodies:
            req = urllib.request.Request(
                url + "/v1/chat", data=json.dumps(body).encode(),
                headers={"Content-Type": "application/json"})
            with urllib.request.urlopen(req, timeout=300) as r:
                replies.append((r.status, json.loads(r.read())))
        wall = time.perf_counter() - t0
        stats = server.stats()
        reused = server._sessions["smoke"].last_reused
    finally:
        httpd.shutdown()
        httpd.server_close()
        server.shutdown()
        serve_thread.join(60)
    add_counts(totals, path_counts("chat http"))
    if (len(replies) != 2 or any(s_ != 200 or r.get("session") != "smoke"
                                 or not isinstance(r.get("text"), str)
                                 for s_, r in replies)
            or stats["chat_sessions"] != 1):
        raise AssertionError(f"/v1/chat: {replies} {stats}")
    log(f"chat http: 2 POSTs on one session answered 200 in {wall:.2f} s, "
        f"second turn reused {reused} cached tokens; server stats "
        f"{json.dumps(stats)}")
    return totals


def decode_twin(rt, label: str, fn, extra=None):
    """``fn(timings)`` (a request through the runtime's public entry
    points) with the decode programs captured -- twice: the first call
    may capture, the second replays -- then eager: every decode loop's
    tokens, hidden states and finished flags must be bit-equal (and
    ``extra(result, eager result)``, where given), and the kernels'
    launches equal (the counters count replays).  Logs decode ms a step
    and tok/s of each; returns {mode: (result, timings)}.  Launches go to
    CHECKS."""
    import torch

    res = {}
    for mode in ("graphs, first call", "graphs", "eager"):
        rt.graphs.enabled = mode != "eager"
        t = {}
        reset_counts()
        with stash_decode() as outs:
            out = fn(t)
        torch.cuda.synchronize()
        counts = read_counts()
        add_counts(CHECKS, counts)
        res[mode] = (out, outs, t, counts)
        log(f"{label} ({mode}): prefill {t['prefill'] * 1e3:.1f} ms, "
            f"decode {t['decode'] * 1e3:.1f} ms for {t['decode_tokens']} "
            f"tokens in {t['decode_forwards']} forwards = "
            f"{t['decode'] / t['decode_forwards'] * 1e3:.2f} ms a step, "
            f"{t['decode_tokens'] / t['decode']:.2f} tok/s")
    rt.graphs.enabled = True
    e = res["eager"]
    for mode in ("graphs, first call", "graphs"):
        g = res[mode]
        ok = (same_outputs(g[1], e[1]), g[3] == e[3],
              extra(g[0], e[0]) if extra else True)
        if not all(ok):
            raise AssertionError(f"{label}: {mode} vs eager (outputs, "
                                 f"launches, results) equal: {ok}; "
                                 f"launches {g[3]} vs {e[3]}")
    log(f"{label}: captured and eager tokens, hidden states and finished "
        f"flags bit-equal, the same kernel launches "
        f"{ {k: n for k, n in e[3].items() if n} }")
    return {m: (r[0], r[2]) for m, r in res.items()}


def run_graph_twins(rt, requests, smi: str) -> None:
    """The turn at B 1 (with the forced ``<img>`` chunk), a comprehension
    reply at B 1, ``generate_batch`` at B 8 and three chat turns (the last
    ending at n == t), each with its decode captured and then eager, held
    bit for bit; decode ms a step and tok/s of both (``smi``: the card)."""
    import torch

    from seedx_tpu_torch.inference.chat import ChatSession
    from seedx_tpu_torch.models.generation import decode_programs

    tok = rt.tokenizer
    img_ids = [tok.bos_token_id] + tok.encode(
        "[INST] Generate an image: a red bicycle by a lake [/INST]\n<img>")

    def same_feat(a, b):
        return torch_equal(a["img_gen_feat"], b["img_gen_feat"])

    decode_twin(rt, "graphs turn B1 <img>", lambda t: rt.generate(
        img_ids, max_new_tokens=72, timings=t), same_feat)
    decode_twin(rt, "graphs turn B1 comprehend", lambda t: rt.generate_batch(
        requests[:1], max_new_tokens=32, timings=t))
    decode_twin(rt, "graphs generate_batch B8", lambda t: rt.generate_batch(
        requests[:8], max_new_tokens=32, timings=t))

    sends = [("Describe the image in detail.", chat_image(), 32),
             ("What colors stand out?", None, 32),
             ("One word.", None, 8)]
    res = {}
    for mode in ("graphs", "eager"):
        rt.graphs.enabled = mode == "graphs"
        sess = ChatSession(rt, prefix_cache=True, cache_capacity=2048)
        reset_counts()
        with stash_decode() as outs:
            replies, ns = [], []
            for text, img, n_new in sends:
                t = {}
                replies.append(list(sess.send(text, image=img,
                                              max_new_tokens=n_new,
                                              timings=t)["tokens"]))
                ns.append(t["decode_tokens"])
        torch.cuda.synchronize()
        add_counts(CHECKS, read_counts())
        n_cached = len(sess._cached_ids)
        res[mode] = (replies, ns, outs,
                     [c[:, :, :n_cached].clone() for c in sess._cache])
        log(f"graphs chat ({mode}): 3 turns, decoded {ns} tokens")
    rt.graphs.enabled = True
    g, e = res["graphs"], res["eager"]
    ok = (g[0] == e[0], same_outputs(g[2], e[2]),
          all(torch_equal(a, b) for a, b in zip(g[3], e[3])),
          g[1][-1] == sends[-1][2])
    if not all(ok):
        raise AssertionError(f"graphs chat: (replies, decode outputs, "
                             f"cache bytes, last turn at n == t) {ok}")
    log(f"graphs chat: captured and eager replies, hidden states and the "
        f"session cache bytes bit-equal over 3 turns; the last turn ended "
        f"at n == t = {sends[-1][2]} ({smi})")
    log_programs("graphs agent", decode_programs(rt.agent).programs())


MEM_NEW_TOKENS = 64     # the server's 512 cut: 32 flushes in ~1 minute


def run_graph_memory(rt, smi: str) -> None:
    """The memory the captured decode programs hold, on a mixed-shape
    serving run: a warmed ``ServingEngine`` (max batch 8, max_new_tokens
    ``MEM_NEW_TOKENS``) flushing every batch size 1-8 at every prompt
    bucket, then three chat sessions kept open.  Logs the agent's decode
    states, their shared KV storage and small buffers, the graph pool, the
    memory held after the run (allocated, against before it) and the peak
    (``smi``: the card).  The image-out phase runs after with all of it
    still held, and logs its own peaks."""
    import torch

    from seedx_tpu_torch.inference.chat import ChatSession
    from seedx_tpu_torch.inference.serving import ServingEngine
    from seedx_tpu_torch.models.generation import decode_programs

    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    held0 = torch.cuda.memory_allocated()
    pool0 = torch.cuda.memory_reserved()
    tok = rt.tokenizer
    words = tok.encode(" ".join(["the quick brown fox jumps over the lazy "
                                 "dog"] * 150))
    reset_counts()
    t0 = time.perf_counter()
    eng = ServingEngine(rt, max_batch_size=8,
                        max_new_tokens=MEM_NEW_TOKENS).warmup()
    warm_s = time.perf_counter() - t0
    buckets = eng._gen_cfg().prompt_buckets
    flushes = 0
    for bucket in buckets:
        for b in range(1, 9):
            for i in range(b):
                eng.submit_raw({"input_ids": [tok.bos_token_id]
                                + words[:bucket - 2 - i]})
            for out in eng.flush():
                check_tokens(out["tokens"], rt.agent_cfg.llm.vocab_size,
                             MEM_NEW_TOKENS)
            flushes += 1
    sessions = [ChatSession(rt, prefix_cache=True, cache_capacity=2048)
                for _ in range(3)]
    for i, sess in enumerate(sessions):
        sess.send(f"Say something about the number {i}.", max_new_tokens=16)
    torch.cuda.synchronize()
    add_counts(CHECKS, read_counts())
    store = decode_programs(rt.agent)
    progs = store.programs() + [sess._decode.program for sess in sessions]

    def small_bytes(st):
        return sum(v.numel() * v.element_size() for v in vars(st).values()
                   if torch.is_tensor(v))

    storage = sum(x.numel() * x.element_size() for x in store._storage)
    small = sum(small_bytes(st) for st in store.states.values())
    per_pos = storage / (8 * (max(buckets) + MEM_NEW_TOKENS))
    session_kv = sum(x.numel() * x.element_size() for sess in sessions
                     for x in sess._cache)
    gib = 2**30
    log(f"graphs memory: warmup {warm_s:.2f} s, {flushes} flushes (B 1-8 x "
        f"buckets {list(buckets)}, {MEM_NEW_TOKENS} new tokens) and 3 chat "
        f"sessions in {time.perf_counter() - t0:.1f} s; "
        f"{len(store.states)} decode states kept, "
        f"{sum(p.graph is not None for p in progs)} graphs")
    log(f"graphs memory: shared KV storage {storage / gib:.3f} GiB "
        f"({per_pos / 2**20:.3f} MiB a position a row), the states' own "
        f"buffers {small / gib:.3f} GiB, the sessions' caches "
        f"{session_kv / gib:.3f} GiB; the graph pool grew "
        f"{sum(p.pool_bytes for p in progs) / gib:.3f} GiB over "
        f"{sum(p.graph is not None for p in progs)} captures; held after the "
        f"run {(torch.cuda.memory_allocated() - held0) / gib:.3f} GiB more "
        f"than before it (reserved "
        f"{(torch.cuda.memory_reserved() - pool0) / gib:.3f} GiB more); "
        f"peak allocated "
        f"{torch.cuda.max_memory_allocated() / gib:.2f} GiB, reserved "
        f"{torch.cuda.max_memory_reserved() / gib:.2f} GiB ({smi})")
    del sessions


def run_parity(dev, requests, budgets) -> None:
    """Phase 7: the tie rule, enforced on an agent of the same width cut to
    PARITY_LAYERS layers (same seed): the continuous engine's 16 requests
    non-fused and fused (the gaps from the fused engine teacher-forced
    along the non-fused streams), and the chat turns with and without the
    prefix cache.  Its launches go to ``CHECKS``."""
    import torch

    from seedx_tpu_torch.inference.continuous import ContinuousEngine

    rt = build_runtime(dev, PARITY_LAYERS)
    streams = {}
    for variant, kw in (("dense", {}), ("fused dense", FUSED)):
        reset_counts()
        eng = ContinuousEngine(rt, **ENGINE, **kw)
        ids = [eng.submit(r, max_new_tokens=b)
               for r, b in zip(requests, budgets)]
        res = eng.run()
        torch.cuda.synchronize()
        add_counts(CHECKS, path_counts(
            f"parity {variant}", ("int4_w4a8", "decode_attn") if kw
            else ("flash_fwd", "int4_w4a8", "decode_attn")))
        streams[variant] = [list(res[i]["tokens"]) for i in ids]
    seqs = {i: forcing_sequence(s, rt.tokenizer)
            for i, s in enumerate(streams["dense"])}
    fused = forced_engine(rt, requests, budgets, seqs,
                          "parity forced fused dense", **FUSED)
    parts = [tie_check(f"parity {PARITY_LAYERS} layers request {i}",
                       streams["fused dense"][i], streams["dense"][i],
                       fused.along(i, len(seqs[i])), enforce=True)
             for i in range(len(requests))]
    log(f"parity, {PARITY_LAYERS} layers: fused dense vs non-fused dense "
        f"streams {parting_summary(parts)}; every parting a tie")
    add_counts(CHECKS, chat_turns(rt, f"chat {PARITY_LAYERS} layers",
                                  enforce=True))
    spec_unforced(rt, f"parity {PARITY_LAYERS} layers")


# ---- image out (phase 8) ------------------------------------------------

# denoise steps: text to image at the SamplerConfig default (Euler, g 7.5),
# the other runs a few
T2I_STEPS = 30
RECON_STEPS = 10
EDIT_STEPS = 4
SERVE_STEPS = 3
INT8_STEPS = 2
# one full-width UNet eval with K1 against the same weights and inputs
# with the plain attention: the largest eps difference within this
# fraction of the largest |eps| (bf16 on both sides; the kernel rounds P
# against each tile's running max, the plain path against the row's, a few
# bf16 ULPs of each of the 70 attention outputs, carried through the
# residual stream)
UNET_K1_REL = 5e-2
# the debug adapter on the card against the CPU: images in [0, 1] after
# bf16 UNets (K1 against the plain attention, cuDNN against ATen's CPU
# convolutions) and the fp32 VAE
TINY_IMAGE_TOL = 5e-2


@contextlib.contextmanager
def forced_image_prompts():
    """The generation and instruction prompt templates end in ``<img>``
    while active: the random agent then emits one image span (the forced
    64-token chunk and ``</img>``), as a trained agent does for an image
    request."""
    from seedx_tpu_torch.text import prompts

    saved = prompts.GENERATION_PROMPT, prompts.INSTRUCTION_PROMPT
    prompts.GENERATION_PROMPT += "<img>"
    prompts.INSTRUCTION_PROMPT += "<img>"
    try:
        yield
    finally:
        prompts.GENERATION_PROMPT, prompts.INSTRUCTION_PROMPT = saved


class UNetWatch:
    """While active: K1's launches and the GroupNorm / LayerNorm and
    Dense epilogue kernel calls in each CFG UNet eval of the denoise loop
    (``pipeline.CFGEval``, a replay of its captured graph or an eager eval;
    each must be ``flash_launches_per_eval``, ``norm_launches_per_eval``
    and ``epilogue_launches_per_eval``: the counters count replays), each
    eval's eps std and finiteness, and whether the VAE decoder's latents
    and images (before the clip) are finite, with their shapes.  The
    statistics stay on the device until ``check`` reads them."""

    def __init__(self, adapter):
        import torch

        from seedx_tpu_torch.models.sdxl import pipeline
        from seedx_tpu_torch.models.sdxl.unet import (
            epilogue_launches_per_eval, flash_launches_per_eval,
            norm_launches_per_eval)

        self.want = ((flash_launches_per_eval(adapter.cfg.unet),)
                     + norm_launches_per_eval(adapter.cfg.unet)
                     + epilogue_launches_per_eval(adapter.cfg.unet))
        self.size = adapter.cfg.sampler.height
        self.per_eval, self.stds, self.finite, self.images = [], [], [], []
        ks = ("flash_fwd", "group_norm", "layer_norm", "bias_residual",
              "bias_geglu")
        registry = counters()
        base = pipeline.CFGEval.__call__

        def call(ev, lat, sigma, t):
            before = [registry[k] for k in ks]
            eps = base(ev, lat, sigma, t)
            self.per_eval.append(tuple(registry[k] - b
                                       for k, b in zip(ks, before)))
            self.stds.append(eps.float().std())
            self.finite.append(torch.isfinite(eps).all())
            return eps

        def vae(module, args, imgs):
            self.finite.append(torch.isfinite(args[0]).all()
                               & torch.isfinite(imgs).all())
            self.images.append(tuple(imgs.shape))

        pipeline.CFGEval.__call__ = call
        self.restore = lambda: setattr(pipeline.CFGEval, "__call__", base)
        self.handles = [adapter.vae_decoder.register_forward_hook(vae)]

    def check(self, label: str, steps: int, images=None) -> None:
        """Remove the hooks; fail unless every eval made ``self.want`` (K1,
        GroupNorm, LayerNorm, bias_residual, bias_geglu) calls, ``steps``
        evals ran, every latent, eps and image was finite, and the images
        have shape [B, size, size, 3] at the sampler's size."""
        import torch

        self.restore()
        for h in self.handles:
            h.remove()
        if len(self.per_eval) != steps or set(self.per_eval) != {self.want}:
            raise AssertionError(f"{label}: (K1, GroupNorm, LayerNorm, "
                                 f"bias_residual, bias_geglu) calls per "
                                 f"UNet eval {self.per_eval}, want "
                                 f"{self.want} in each of {steps}")
        if not all(bool(f) for f in self.finite):
            raise AssertionError(f"{label}: a non-finite eps, latent or "
                                 f"image")
        stds = torch.stack(self.stds).tolist()
        if images is not None:
            if (images.ndim != 4 or images.shape[1:] != (self.size,) * 2
                    + (3,) or not np.isfinite(images).all()):
                raise AssertionError(f"{label}: images {images.shape}")
        log(f"{label}: {steps} UNet evals, K1 {self.want[0]} launches, "
            f"GroupNorm {self.want[1]}, LayerNorm {self.want[2]}, "
            f"bias_residual {self.want[3]} and bias_geglu {self.want[4]} in "
            f"each; "
            f"eps std per step " + " ".join(f"{x:.3f}" for x in stds)
            + f"; decoded {self.images}, finite before the clip")


def wall_ms(fn, iters: int = 5) -> float:
    """Host ms a call of ``fn`` over ``iters`` calls after one warm call,
    closed by a synchronize: what a caller waits, launch overhead and
    all."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / iters


def cfg_eval_twin(adapter, dev, g, n: int, label: str, smi: str) -> dict:
    """One CFG UNet eval at the adapter's 1024^2 with ``n`` branches (2:
    text to image on the base UNet or the edit's collapse; 3: the edit's
    3-way), as the denoise loop's captured program and eager: eps must be
    bit-equal.  Logs the wall ms an eval of each, the device-busy share of
    one profiled eval of each, the capture time and graph pool.  Returns
    {mode: wall ms}.  Launches go to CHECKS."""
    import torch

    from seedx_tpu_torch.models.sdxl.pipeline import CFGEval
    from seedx_tpu_torch.utils.graphs import Graphs

    lat, _, ctx, pooled, tids = unet_inputs(adapter, n, dev, g)
    lat = lat[:1, ..., :4].contiguous()
    cond = (torch.randn((n,) + lat.shape[1:], generator=g, device=dev)
            if adapter.cfg.with_latent_image else None)
    sigma = torch.tensor(7.0, device=dev)
    t = torch.tensor(501.0, device=dev)
    out, ms, eps = {}, {}, {}
    reset_counts()
    for mode in ("graphs", "eager"):
        switch = Graphs(enabled=mode == "graphs")
        ev = CFGEval(adapter.unet, lat, ctx, pooled, tids, cond, 7.5, 1.5,
                     0.0, switch)
        ev.set_conditioning(ctx, pooled, tids, cond)
        with torch.no_grad():
            ev(lat, sigma, t)                 # graphs: warm run + capture
            eps[mode] = ev(lat, sigma, t).clone()    # graphs: a replay
            ms[mode] = wall_ms(lambda: ev(lat, sigma, t))
            prof = device_profile(lambda: (ev(lat, sigma, t), 1)[1])
        if prof is None:
            busy = "not measured (the profiler saw no device events)"
        else:
            _, wall, by_name = prof
            b_ms = sum(t_ for t_, _ in by_name.values())
            busy = (f"{b_ms:.2f} ms busy of {wall:.2f} ms profiled = "
                    f"{100 * b_ms / wall:.1f}%, "
                    f"{sum(c for _, c in by_name.values())} device events")
        pool = ""
        if mode == "graphs":
            st = ev.program.stats()
            pool = (f"; captured in {st['capture_s'] * 1e3:.1f} ms, graph "
                    f"pool {st['pool_bytes'] / 2**30:.2f} GiB")
        log(f"image out: UNet {label} CFG {n} ({mode}): {ms[mode]:.2f} ms "
            f"an eval (wall); profiled eval: {busy}{pool} ({smi})")
        out[mode] = ms[mode]
        del ev, switch
        gc.collect()
        torch.cuda.empty_cache()
    add_counts(CHECKS, read_counts())
    if not torch_equal(eps["graphs"], eps["eager"]):
        raise AssertionError(f"UNet {label} CFG {n}: the captured eval's "
                             f"eps differs from the eager one")
    log(f"image out: UNet {label} CFG {n}: captured and eager eps "
        f"bit-equal; eager / captured wall "
        f"{ms['eager'] / ms['graphs']:.2f}")
    return out


def build_adapter(dev, vit, edit: bool):
    """The full-width SEED-X image stack with random weights from seed 0:
    ResamplerXL (``DetokenizerConfig()``), the SDXL base UNet (the
    8-channel edit UNet with ``edit``) in bf16, the SDXL VAE in fp32,
    sharing the runtime's ViT-bigG for its CFG negatives."""
    import torch

    from seedx_tpu_torch.models.adapter import AdapterConfig, SDXLAdapter
    from seedx_tpu_torch.models.detokenizer import DetokenizerConfig
    from seedx_tpu_torch.models.sdxl.unet import (sdxl_base_unet,
                                                  sdxl_edit_unet)

    t0 = time.perf_counter()
    cfg = AdapterConfig(unet=sdxl_edit_unet() if edit else sdxl_base_unet(),
                        resampler=DetokenizerConfig(),
                        with_latent_image=edit)
    adapter = SDXLAdapter.random(cfg, seed=0, device=dev, visual_encoder=vit)
    torch.cuda.synchronize()
    n = {name: sum(t.numel() for t in getattr(adapter, name).state_dict(
        ).values()) for name in ("unet", "resampler", "vae_decoder",
                                 "vae_encoder")}
    log(f"image out: built the {'edit (8-channel)' if edit else 'base'} "
        f"adapter in {time.perf_counter() - t0:.1f} s: "
        + ", ".join(f"{k} {v / 1e6:.1f} M" for k, v in n.items())
        + f"; {torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated")
    return adapter


def unet_inputs(adapter, batch: int, dev, g):
    """Random UNet inputs at the adapter's latent size (128 x 128 for
    1024^2 images): scaled latents (+ condition latents), a mid timestep,
    64 context tokens, pooled embeds, the default time ids."""
    import torch

    from seedx_tpu_torch.models.sdxl.pipeline import default_time_ids

    cfg, sampler = adapter.cfg.unet, adapter.cfg.sampler
    h, w = sampler.latent_hw
    pooled = (cfg.projection_class_embeddings_input_dim
              - 6 * cfg.addition_time_embed_dim)
    tids = default_time_ids(sampler, batch, dev)
    return (torch.randn((batch, h, w, cfg.in_channels), generator=g,
                        device=dev),
            torch.full((batch,), 501.0, device=dev),
            torch.randn((batch, 64, cfg.cross_attention_dim), generator=g,
                        device=dev).to(torch.bfloat16),
            torch.randn((batch, pooled), generator=g,
                        device=dev).to(torch.bfloat16), tids)


@contextlib.contextmanager
def plain_unet_attention():
    """The UNet's attention through the plain path while active (the
    K1-against-plain check; the package has no knob for it)."""
    from seedx_tpu_torch.models.sdxl import unet as unet_mod

    orig = unet_mod.dot_product_attention

    def plain(*args, **kw):
        return orig(*args, **{**kw, "impl": "plain"})

    unet_mod.dot_product_attention = plain
    try:
        yield
    finally:
        unet_mod.dot_product_attention = orig


def check_unet_k1(adapter, dev, g) -> None:
    """One full-width UNet eval at CFG batch 2 with K1 against the same
    weights and inputs with the plain attention; K1 must launch 70 times
    in the first and never in the second.  Its launches go to CHECKS."""
    import torch

    from seedx_tpu_torch.models.sdxl.unet import flash_launches_per_eval

    args = unet_inputs(adapter, 2, dev, g)
    reset_counts()
    with torch.no_grad():
        eps = adapter.unet(*args)
        torch.cuda.synchronize()
        k1 = read_counts()["flash_fwd"]
        with plain_unet_attention():
            ref = adapter.unet(*args)
        torch.cuda.synchronize()
    add_counts(CHECKS, read_counts())
    want = flash_launches_per_eval(adapter.cfg.unet)
    plain_k1 = read_counts()["flash_fwd"] - k1
    err = (eps.float() - ref.float()).abs().max().item()
    mag = ref.float().abs().max().item()
    ok = (k1 == want and plain_k1 == 0 and err <= UNET_K1_REL * mag
          and bool(torch.isfinite(eps).all()))
    log(f"image out: UNet eval B2 at {tuple(args[0].shape[1:3])} latents, "
        f"K1 ({k1} "
        f"launches) against the plain attention ({plain_k1}): max_abs_err "
        f"{err:.3e} of max |eps| {mag:.3e} = {err / mag:.3e} (limit "
        f"{UNET_K1_REL}) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("full-width UNet: K1 disagrees with the plain "
                             "attention")


def unet_step_ms(adapter, dev, g, label: str, smi: str,
                 batches=(2, 3)) -> dict:
    """Device ms of one UNet eval at 1024^2 at each CFG batch (CUDA
    events, median of 5 after 2 warm-ups) and a torch.profiler window
    over one eval at the first batch: device busy share, K1's device ms."""
    import torch

    out = {}
    with torch.no_grad():
        for b in batches:
            args = unet_inputs(adapter, b, dev, g)
            out[b] = cuda_ms(lambda: adapter.unet(*args), warmup=2, iters=5)
            if b == batches[0]:
                prof = device_profile(lambda: (adapter.unet(*args), 1)[1])
    line = ", ".join(f"CFG {b} {ms:.2f} ms" for b, ms in out.items())
    if prof is None:
        log(f"image out: UNet {label} per step: {line}; the profiler saw "
            f"no device events: K1 ms and busy share not measured "
            f"({smi})")
        return out
    _, wall, by_name = prof
    busy = sum(t for t, _ in by_name.values())
    k1_ms, k1_n = kernel_ms(by_name, "flash_fwd_kernel")
    n_events = sum(n for _, n in by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:4]
    log(f"image out: UNet {label} per step: {line}; profiled eval at CFG "
        f"{batches[0]}: wall {wall:.2f} ms, device busy {busy:.2f} ms = "
        f"{100 * busy / wall:.1f}%, K1 {k1_ms:.3f} ms over {k1_n} launches "
        f"= {100 * k1_ms / busy:.1f}% of busy, {n_events} device events; "
        f"top: " + "; ".join(f"{n[:40]} {t:.2f} ms x{c}"
                             for n, (t, c) in top) + f" ({smi})")
    return out


def image_module_ms(adapter, dev, g, smi: str) -> None:
    """Device ms (CUDA events) of ResamplerXL over a CFG pair of 64
    agent tokens, and of the fp32 VAE decode and encode at the sampler's
    size (1024^2)."""
    import torch

    sampler = adapter.cfg.sampler
    x = torch.randn((2, 64, adapter.cfg.resampler.embedding_dim),
                    generator=g, device=dev).to(torch.bfloat16)
    lat = torch.randn((1, *sampler.latent_hw, 4), generator=g, device=dev)
    img = torch.rand((1, sampler.height, sampler.width, 3), generator=g,
                     device=dev) * 2 - 1
    with torch.no_grad():
        res = cuda_ms(lambda: adapter.resampler(x), warmup=2, iters=10)
        dec = cuda_ms(lambda: adapter.vae_decoder(lat), warmup=1, iters=3)
        enc = cuda_ms(lambda: adapter.vae_encoder(img), warmup=1, iters=3)
    log(f"image out: ResamplerXL B2 x 64 tokens {res:.3f} ms, VAE decode "
        f"{sampler.height}^2 fp32 {dec:.2f} ms, VAE encode fp32 {enc:.2f} "
        f"ms (TF32 off; {smi})")


def timed_run(label: str, fn, needed=("flash_fwd",)):
    """Run ``fn`` with the counters at 0, the peak memory reset and its
    wall time; returns (its result, the launch counts)."""
    import torch

    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = path_counts(label, needed)
    log(f"{label}: wall {wall:.2f} s, peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    return out, counts


def run_image_out(rt, dev, smi: str):
    """Phase 8: image out at full width on the phase-4 runtime.  The base
    adapter: the K1-against-plain UNet check, the UNet / ResamplerXL / VAE
    times, ``text_to_image`` (agent + 30 Euler steps at 1024^2, CFG 2),
    ``reconstruct`` (raw ViT-bigG features, unpooled negative), then the
    int8 UNet; the edit adapter: ``reconstruct_with_condition`` at 1024^2
    (the VAE encoder, 3-way CFG at batch 3), the gi = 1.0 collapse (batch
    2), a ``ServingEngine`` flush with a t2i and an edit request and one
    ``/v1/generate`` POST."""
    import base64
    import io
    import urllib.request
    from http.server import ThreadingHTTPServer

    import torch
    from PIL import Image

    from seedx_tpu_torch.inference import apps
    from seedx_tpu_torch.inference.server import SeedXServer
    from seedx_tpu_torch.inference.serving import ServingEngine
    from seedx_tpu_torch.models.generation import decode_programs

    t_phase = time.perf_counter()
    totals = {}
    g = torch.Generator(device=dev).manual_seed(99)
    rng = np.random.default_rng(9)
    src = Image.fromarray((rng.random((448, 448, 3)) * 255).astype(np.uint8))
    agent = ("flash_fwd", "int4_w4a8", "decode_attn")

    gc.collect()
    torch.cuda.empty_cache()
    base = build_adapter(dev, rt.vit, edit=False)
    rt.adapter = base                  # takes the runtime's graphs switch
    check_unet_k1(base, dev, g)
    unet_step_ms(base, dev, g, "base bf16", smi)
    cfg_eval_twin(base, dev, g, 2, "base bf16", smi)
    image_module_ms(base, dev, g, smi)

    # (1) text to image (SEED-X-I): the agent's forced span, 30 steps
    watch = UNetWatch(base)
    timings = {}
    with forced_image_prompts():
        out, counts = timed_run("image out text_to_image", lambda: (
            apps.text_to_image(rt, "a red bicycle by a lake", seed=0,
                               num_inference_steps=T2I_STEPS,
                               max_new_tokens=72, timings=timings)), agent)
    add_counts(totals, counts)
    watch.check("image out text_to_image", T2I_STEPS, out["images"])
    feat = out["img_gen_feat"]
    want = (1, rt.agent_cfg.num_img_out_tokens, rt.agent_cfg.vit_dim)
    if feat is None or tuple(feat.shape) != want:
        raise AssertionError(f"text_to_image: no forced image span {want}")
    log("image out text_to_image: " + ", ".join(
        f"{k} {v * 1e3:.1f} ms" for k, v in timings.items()
        if isinstance(v, float)) + f"; {T2I_STEPS} steps, "
        f"{timings['denoise'] * 1e3 / T2I_STEPS:.1f} ms a step (host); "
        f"images {out['images'].shape}")
    # the same request with the runtime's programs eager: the same image
    timings = {}
    rt.graphs.enabled = False
    try:
        with forced_image_prompts():
            eager, counts = timed_run(
                "image out text_to_image (eager)", lambda: (
                    apps.text_to_image(rt, "a red bicycle by a lake", seed=0,
                                       num_inference_steps=T2I_STEPS,
                                       max_new_tokens=72, timings=timings)),
                agent)
    finally:
        rt.graphs.enabled = True
    add_counts(CHECKS, counts)
    log("image out text_to_image (eager): " + ", ".join(
        f"{k} {v * 1e3:.1f} ms" for k, v in timings.items()
        if isinstance(v, float)))
    if not np.array_equal(out["images"], eager["images"]):
        raise AssertionError("text_to_image: the captured run's image "
                             "differs from the eager run's")
    log("image out text_to_image: captured and eager images bit-equal")

    # (2) reconstruct: raw ViT-bigG features, the unpooled negative
    watch = UNetWatch(base)
    images, counts = timed_run("image out reconstruct", lambda: (
        apps.reconstruct(rt, src, seed=1, num_inference_steps=RECON_STEPS)))
    add_counts(totals, counts)
    watch.check("image out reconstruct", RECON_STEPS, images)

    # (5) the int8 UNet (weights int8, scales on the outputs)
    base.quantize_unet()
    gc.collect()
    torch.cuda.empty_cache()
    unet_step_ms(base, dev, g, "base int8", smi)
    cfg_eval_twin(base, dev, g, 2, "base int8", smi)
    watch = UNetWatch(base)
    images, counts = timed_run("image out int8 UNet", lambda: (
        base.generate(feat, seed=0, num_inference_steps=INT8_STEPS)))
    add_counts(totals, counts)
    watch.check("image out int8 UNet", INT8_STEPS, images)
    rt.adapter = base = None
    gc.collect()
    torch.cuda.empty_cache()

    # (3) the edit variant (SEED-X-Edit): the VAE encoder, 3-way CFG
    edit = build_adapter(dev, rt.vit, edit=True)
    rt.adapter = edit
    unet_step_ms(edit, dev, g, "edit bf16", smi, batches=(3, 2))
    cfg_eval_twin(edit, dev, g, 3, "edit bf16", smi)
    watch = UNetWatch(edit)
    timings = {}
    images, counts = timed_run("image out reconstruct_with_condition", lambda: (
        apps.reconstruct_with_condition(rt, src, src, seed=2,
                                        num_inference_steps=EDIT_STEPS,
                                        timings=timings)))
    add_counts(totals, counts)
    watch.check("image out reconstruct_with_condition (3-way, B3)",
                EDIT_STEPS, images)
    log("image out reconstruct_with_condition: " + ", ".join(
        f"{k} {v * 1e3:.1f} ms" for k, v in timings.items()))
    watch = UNetWatch(edit)
    with torch.no_grad():
        embeds = rt.encode_image_single(src)
    images, counts = timed_run("image out edit collapse", lambda: (
        edit.generate(embeds, from_vit=True,
                      latent_image=apps.condition_input(rt, src), seed=2,
                      num_inference_steps=EDIT_STEPS,
                      image_guidance_scale=1.0)))
    add_counts(totals, counts)
    watch.check("image out edit collapse (gi 1.0, B2)", EDIT_STEPS, images)

    # (4) serving: one flush with a t2i and an edit request, one POST
    watch = UNetWatch(edit)
    with forced_image_prompts():
        eng = ServingEngine(rt, max_new_tokens=72,
                            num_inference_steps=SERVE_STEPS, seed=3)
        eng.submit_text_to_image("a red bicycle by a lake")
        eng.submit_edit(src, "make it a sunset")
        results, counts = timed_run("image out serving flush", eng.flush,
                                    agent)
    add_counts(totals, counts)
    size = edit.cfg.sampler.height
    for kind, res in zip(("t2i", "edit"), results):
        if res["images"] is None or res["images"].shape != (1, size, size,
                                                            3):
            raise AssertionError(f"serving flush {kind}: no {size}^2 image")
    watch.check("image out serving flush (t2i, edit)", 2 * SERVE_STEPS)

    server = SeedXServer(rt, max_new_tokens=72,
                         num_inference_steps=2).warmup()
    httpd = ThreadingHTTPServer(("127.0.0.1", 0), server.make_handler())
    serve_thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    serve_thread.start()
    url = f"http://127.0.0.1:{httpd.server_address[1]}"

    def post():
        req = urllib.request.Request(
            url + "/v1/generate",
            data=json.dumps({"caption": "a red bicycle"}).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=300) as r:
            return r.status, json.loads(r.read())

    try:
        with forced_image_prompts():
            (status, reply), counts = timed_run("image out /v1/generate",
                                                post, agent)
    finally:
        httpd.shutdown()
        httpd.server_close()
        server.shutdown()
        serve_thread.join(60)
    add_counts(totals, counts)
    pngs = reply.get("images") or []
    size = (Image.open(io.BytesIO(base64.b64decode(pngs[0]))).size
            if pngs else None)
    if status != 200 or len(pngs) != 1 or size != (edit.cfg.sampler.width,
                                                   edit.cfg.sampler.height):
        raise AssertionError(f"/v1/generate: {status} {len(pngs)} images "
                             f"{size}")
    log(f"image out /v1/generate: 200, one {size[0]}x{size[1]} PNG")
    log_programs("image out", decode_programs(rt.agent).programs()
                 + [ev.program for ev in edit.evals.values()])
    edit.quantize_unet()
    cfg_eval_twin(edit, dev, g, 3, "edit int8", smi)
    rt.adapter = None
    del edit, server
    gc.collect()
    torch.cuda.empty_cache()
    log(f"image out: phase done in {time.perf_counter() - t_phase:.1f} s")
    return totals


def check_tiny_adapter(dev):
    """The debug adapter on the card (K1 in the UNet's self-attention at
    head dim 32 padded to 64, CFG batch 3) against the same weights on the
    CPU (plain attention): ``reconstruct_with_condition`` from the same
    initial noise, the images within ``TINY_IMAGE_TOL``."""
    import torch
    from PIL import Image

    from seedx_tpu_torch.inference import apps
    from seedx_tpu_torch.inference.runtime import SeedXRuntime
    from seedx_tpu_torch.models import adapter as adapter_mod

    rts = {d: SeedXRuntime.debug(seed=7, device=d, with_adapter=True)
           for d in ("cpu", dev)}
    rts[dev].vit.load_state_dict(rts["cpu"].vit.state_dict())
    for name in ("unet", "resampler", "vae_decoder", "vae_encoder"):
        getattr(rts[dev].adapter, name).load_state_dict(
            getattr(rts["cpu"].adapter, name).state_dict())
    noise = torch.randn((1, 32, 32, 4), generator=torch.Generator(
        ).manual_seed(7))

    def same_noise(generator, batch, cfg, schedule, dtype=torch.float32):
        return noise.to(generator.device, dtype) * schedule.init_noise_sigma

    rng = np.random.default_rng(8)
    img = Image.fromarray((rng.random((90, 150, 3)) * 255).astype(np.uint8))
    out, orig = {}, adapter_mod.prepare_latents
    adapter_mod.prepare_latents = same_noise
    try:
        for d, rt in rts.items():
            watch = UNetWatch(rt.adapter) if d != "cpu" else None
            out[d] = apps.reconstruct_with_condition(rt, img, img, seed=0,
                                                     num_inference_steps=3)
            if watch is not None:
                watch.check("tiny adapter on the card", 3, out[d])
    finally:
        adapter_mod.prepare_latents = orig
    err = float(np.abs(out[dev] - out["cpu"]).max())
    if not err <= TINY_IMAGE_TOL:
        raise AssertionError(f"tiny adapter disagrees: {err:.3e} > "
                             f"{TINY_IMAGE_TOL}")
    log(f"tiny adapter: reconstruct_with_condition on the card vs the CPU "
        f"max_abs_err {err:.3e} (tol {TINY_IMAGE_TOL}) ok")


def device_profile(run):
    """torch.profiler over one window: ``run()`` does its work and returns
    how many steps it ran.  Returns the steps, the profiled wall ms (the
    profiler's own overhead lengthens it, so a busy share from it is a
    lower bound) and {kernel name: (device ms, calls)}, or None where the
    profiler saw no device events."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        steps = run()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    events = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not events:
        return None
    by_name = {}
    for e in events:
        t, n = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (t + e.time_range.elapsed_us() / 1e3, n + 1)
    return steps, wall, by_name


def kernel_ms(by_name, key: str):
    """(device ms, calls) of the kernels whose name holds ``key``."""
    hits = [v for name, v in by_name.items() if key in name]
    return sum(t for t, _ in hits), sum(n for _, n in hits)


def profile_window(label: str, run, top_n: int = 5) -> None:
    """Device busy share of one window (``device_profile``), the device
    time of the flash kernels, K1, K4, K5 and K3, and the ``top_n`` kernels
    by time."""
    got = device_profile(run)
    if got is None:
        log(f"profile {label}: the profiler saw no device events; busy "
            f"share not measured")
        return
    steps, wall, by_name = got
    busy = sum(t for t, _ in by_name.values())
    flash = sum(t for name, (t, _) in by_name.items() if "flash_" in name)
    k1_ms, k1_n = kernel_ms(by_name, "flash_fwd_kernel")
    k4_ms, k4_n = kernel_ms(by_name, "flash_bwd_dq_kernel")
    k5_ms, k5_n = kernel_ms(by_name, "flash_bwd_dkv_kernel")
    k3_ms, k3_n = kernel_ms(by_name, "decode_attn")
    n_events = sum(n for _, n in by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:top_n]
    log(f"profile {label}: {steps} steps, {wall:.1f} ms wall (profiled), "
        f"device busy {busy:.1f} ms = {100 * busy / wall:.1f}%, flash "
        f"kernels {flash:.2f} ms (K1 {k1_ms:.2f} ms over {k1_n} calls, K4 "
        f"{k4_ms:.2f} ms over {k4_n}, K5 {k5_ms:.2f} ms over {k5_n}), "
        f"K3 {k3_ms:.2f} ms over {k3_n} calls "
        f"({k3_ms / max(steps, 1):.3f} ms a step), "
        f"{n_events / max(steps, 1):.0f} device events per step; top: "
        + "; ".join(f"{name[:48]} {t:.2f} ms x{n}"
                    for name, (t, n) in top))


def steady_engine(rt, requests, slots: int, fused: bool):
    """A continuous engine with ``slots`` slots all taken by the first
    requests (budget 64), past its admission and first chunk: its next
    ``step()`` is a steady decode chunk or, fused, a mixed chunk (the
    prompts still prefilling 16 tokens a step)."""
    from seedx_tpu_torch.inference.continuous import ContinuousEngine

    eng = ContinuousEngine(rt, **dict(ENGINE, slots=slots),
                           **(FUSED if fused else {}))
    for r in requests[:slots]:
        eng.submit(r, max_new_tokens=64)
    eng.step()
    return eng


def engine_chunk(eng, kind: str):
    """One ``step()`` of ``eng``; returns its steps of ``kind`` ("decode"
    or "mixed"), failing if it ran another kind."""
    key = f"{kind}_steps"
    before = eng.stats()[key]
    eng.step()
    n = eng.stats()[key] - before
    if n <= 0:
        raise AssertionError(f"the engine ran no {kind} steps: "
                             f"{eng.stats()}")
    return n


def profile_decode(rt, requests, slots: int) -> None:
    """Device busy share of a steady decode window: one 16-step chunk of
    the continuous engine with every slot live and nothing waiting, its
    steps replayed as a captured program or eager, as ``rt.graphs``
    says."""
    eng = steady_engine(rt, requests, slots, fused=False)
    mode = "graphs" if rt.graphs.enabled else "eager"
    profile_window(f"B{slots} decode ({mode})",
                   lambda: engine_chunk(eng, "decode"))


def profile_mixed(rt, requests, slots: int = 8) -> None:
    """The same over one fused mixed chunk (prefill + decode, K3's
    multi-query mode) with every slot live."""
    eng = steady_engine(rt, requests, slots, fused=True)
    mode = "graphs" if rt.graphs.enabled else "eager"
    profile_window(f"B{slots} fused mixed ({mode})",
                   lambda: engine_chunk(eng, "mixed"))


# the SFT phase: the SEED-X agent (configs/clm_models/agent_seed_x.yaml
# width: LLaMA2-13B bf16 base, LoRA r32 alpha 32 dropout 0.05, 64 / 64
# resampler queries, vit_dim 4096, rec_loss_scale 6); the tolerances of
# the gradient check (bf16 on both sides; a leaf is held to at least
# GRAD_FLOOR of the model's largest gradient, the rounding noise's level:
# a key bias's true gradient is zero)
GRAD_LOSS_REL, GRAD_REL, GRAD_FLOOR = 1e-2, 2e-2, 1e-2
CONVERSATIONS = (
    ["Describe this picture in detail, please.",
     "The picture shows a quiet harbour at dawn. Small fishing boats rest "
     "on calm water, their hulls painted red, blue and white. Behind them a "
     "row of stone houses climbs a green hill, and a lighthouse stands on "
     "the far pier. Thin clouds catch the first orange light.",
     "What time of year could it be?",
     "The trees on the hill are full and green and the people on the pier "
     "wear light jackets, so it is probably late spring or early summer. "
     "The low sun suggests an early morning.",
     "Is there anything unusual in the scene?",
     "One boat carries a stack of yellow crates on its deck, while the "
     "others are empty; it may be about to leave for the market."],
    ["What is shown here?",
     "A street market with stalls of fruit and vegetables under striped "
     "awnings. A woman in a green coat is choosing oranges.",
     "How many stalls can you count?",
     "I can see four stalls clearly and the edge of a fifth one on the "
     "right side of the image."])
CAPTIONS = ("a red bicycle leaning against a white fence in the sun",
            "two cats sleeping on a wooden chair by a window",
            "a bowl of ramen with egg, scallions and sliced pork",
            "a snowy mountain above a blue lake at sunrise",
            "an old lighthouse on a rocky coast during a storm",
            "a child flying a yellow kite on a windy beach",
            "a stack of pancakes with berries and maple syrup",
            "a vintage green car parked on a cobblestone street",
            "a field of sunflowers under a cloudy sky",
            "a black dog catching a frisbee in a park")


def train_agent_cfg(num_layers: int = 40, **llm_kw):
    from seedx_tpu_torch.models.agent import AgentConfig
    from seedx_tpu_torch.models.llama import llama2_13b

    return AgentConfig(
        llm=llama2_13b(num_layers=num_layers, lora_rank=32, lora_alpha=32.0,
                       lora_dropout=0.05, **llm_kw),
        vit_dim=4096, resampler_heads=32, num_img_in_tokens=64,
        num_img_out_tokens=64, rec_loss_scale=6.0)


def sft_batches(tok, image_size: int, n_in: int, n_out: int):
    """The two kinds of configs/data/sft_comprehension_gen.yaml, through
    the port's encoders and collate_anyres: (a) 2 conversations at
    max_length 880, each with one anyres image (896x448: 3 tiles, 896x896:
    5 tiles); (b) two batches of 8 captions at max_length 260, the image
    last (generation, one tile each).  Returns (a, b, b2)."""
    from PIL import Image

    from seedx_tpu_torch.data.anyres import (grid_pinpoints_from_strings,
                                             process_anyres_image)
    from seedx_tpu_torch.data.encoding import (encode_caption_sample,
                                               encode_conversation_sample)
    from seedx_tpu_torch.data.pipeline import collate_anyres
    from seedx_tpu_torch.data.transforms import get_transform
    from seedx_tpu_torch.inference.runtime import DEFAULT_RESOLUTION_GRIDS

    rng = np.random.default_rng(5)
    transform = get_transform("clip", keep_ratio=False, image_size=image_size)
    grids = grid_pinpoints_from_strings(DEFAULT_RESOLUTION_GRIDS, image_size)
    conv = []
    for turns, (w, h) in zip(CONVERSATIONS, ((2, 2), (2, 1))):
        img = Image.fromarray((rng.random((h * image_size, w * image_size,
                                           3)) * 255).astype(np.uint8))
        tiles, ppos = process_anyres_image(img, transform, grids, image_size)
        # the longer conversation fills max_length: turns repeated
        s = encode_conversation_sample(
            turns * 2, tok, max_length=880, patch_length=len(tiles),
            num_img_in_tokens=n_in, rng=np.random.default_rng(len(conv)))
        s.update(images=tiles, patch_positions=ppos)
        conv.append(s)
    batch_a = collate_anyres(conv, max_images=8, image_size=image_size)

    def captions(offset):
        out = []
        for i in range(8):
            img = Image.fromarray((rng.random((image_size, image_size, 3))
                                   * 255).astype(np.uint8))
            s = encode_caption_sample(
                CAPTIONS[(i + offset) % len(CAPTIONS)], tok, max_length=260,
                img_first_ratio=0.0, num_img_in_tokens=n_in,
                num_img_out_tokens=n_out, add_gen_prompt=True,
                rng=np.random.default_rng(100 + i + offset))
            s["images"] = transform(img)[None]
            out.append(s)
        return collate_anyres(out, max_images=8, image_size=image_size)

    return batch_a, captions(0), captions(3)


def bit_checksum(tensors) -> int:
    """A checksum of the bits of every tensor (int64 sums of 16-bit words,
    one leading slice of a stacked tensor at a time)."""
    import torch

    total = 0
    for t in tensors:
        for part in (t if t.dim() > 2 else [t]):
            words = part.contiguous().view(-1).view(torch.int16)
            total += int(words.sum(dtype=torch.int64))
    return total


def grad_diff(got, want, floor_rel: float):
    """(worst error over the leaves relative to max(the leaf's largest
    gradient, floor_rel x the model's largest), that leaf)."""
    top = max(w.float().abs().max().item() for w in want.values())
    worst, leaf = 0.0, None
    for n, w in want.items():
        scale = max(w.float().abs().max().item(), floor_rel * top)
        err = (got[n].float() - w.float()).abs().max().item() / scale
        if err > worst:
            worst, leaf = err, n
    return worst, leaf


@contextlib.contextmanager
def zero_delta():
    """A deliberately broken backward: delta = rowsum(dO * O) taken as 0."""
    import torch

    from seedx_tpu_torch.ops import flash_attention as fa

    base = fa.row_delta
    fa.row_delta = lambda do, out: torch.zeros_like(base(do, out))
    try:
        yield
    finally:
        fa.row_delta = base


def grad_check(dev, batch):
    """The agent cut to PARITY_LAYERS layers at full width, batch (a): loss
    and trainable grads through K1 / K4 / K5 against the plain attention
    under ordinary autograd (no dropout); a zero-delta backward must fail
    the same check.  Launches go to ``CHECKS``."""
    import dataclasses

    import torch

    from seedx_tpu_torch.models.agent import ContinuousLVLM
    from seedx_tpu_torch.models.layers import init_normal_
    from seedx_tpu_torch.train.trainer import (TrainConfig, compute_grads,
                                               create_train_state)

    gen = torch.Generator(device=dev).manual_seed(11)
    cfg = train_agent_cfg(PARITY_LAYERS)
    agent = init_normal_(ContinuousLVLM(cfg, dev), gen)
    st = create_train_state(agent, TrainConfig())
    runs = {}
    for name in ("kernels", "plain", "zero delta"):
        reset_counts()
        layers = agent.llm.layers
        if name == "plain":
            layers.cfg = dataclasses.replace(cfg.llm, attention_impl="plain")
        with zero_delta() if name == "zero delta" else \
                contextlib.nullcontext():
            grads, losses = compute_grads(agent, st.params, batch)
        torch.cuda.synchronize()
        layers.cfg = cfg.llm
        runs[name] = (grads, float(losses["total_loss"]))
        counts = read_counts()
        add_counts(CHECKS, counts)
        log(f"grad check {PARITY_LAYERS} layers, {name}: loss "
            f"{runs[name][1]:.6f}, launches {json.dumps(counts)}")
        if name != "plain" and min(counts["flash_fwd"],
                                   counts["flash_bwd_dq"],
                                   counts["flash_bwd_dkv"]) <= 0:
            raise AssertionError(f"grad check {name}: a flash kernel was "
                                 f"not launched")
    want, loss_p = runs["plain"]
    loss_rel = abs(runs["kernels"][1] - loss_p) / abs(loss_p)
    worst, leaf = grad_diff(runs["kernels"][0], want, GRAD_FLOOR)
    m_worst, m_leaf = grad_diff(runs["zero delta"][0], want, GRAD_FLOOR)
    log(f"grad check: kernels vs plain loss rel {loss_rel:.3e} (tol "
        f"{GRAD_LOSS_REL:g}), worst leaf {leaf} {worst:.3e} (tol "
        f"{GRAD_REL:g} of max(its largest, {GRAD_FLOOR:g} x the model's "
        f"largest)) over {len(want)} leaves; the zero-delta mutant: worst "
        f"leaf {m_leaf} {m_worst:.3e}")
    if not (loss_rel <= GRAD_LOSS_REL and worst <= GRAD_REL):
        raise AssertionError("grad check: kernels disagree with the plain "
                             "attention")
    if not m_worst > GRAD_REL:
        raise AssertionError("grad check: the zero-delta mutant passes the "
                             "check")


class StepCounts:
    """Wraps the batches of a run without accumulation: each step's
    launches, peak memory and the host ms the loop waited for its batch
    (the data stream's decode, transforms and tokenization), read when
    the loop asks for the next batch."""

    def __init__(self, batches):
        self.batches, self.steps, self._open = batches, [], False
        self._fetch_ms = 0.0

    def __iter__(self):
        import torch

        it = iter(self.batches)
        while True:
            self._close()
            t = time.perf_counter()
            try:
                b = next(it)
            except StopIteration:
                return
            self._fetch_ms = (time.perf_counter() - t) * 1e3
            reset_counts()
            torch.cuda.reset_peak_memory_stats()
            self._open = True
            yield b

    def _close(self):
        import torch

        if self._open:
            torch.cuda.synchronize()
            self.steps.append((read_counts(),
                               torch.cuda.max_memory_allocated(),
                               self._fetch_ms))
            self._open = False


# the SFT entry point's run: steps, then a resume to a later step; the
# synthetic data written for it (numbers of files and samples)
CLI_STEPS, CLI_RESUME_STEPS = 4, 6
# (LLM layers, ViT layers, hidden size, LoRA rank) the YAMLs give
SFT_WIDTH = (40, 48, 5120, 32)
SFT_CONFIGS = (("image_transform",
                "configs/processer/qwen_448_transform.yaml"),
               ("tokenizer",
                "configs/tokenizer/clm_llama_tokenizer_224loc_anyres.yaml"),
               ("visual_encoder", "configs/visual_encoder/qwen_vitg_448.yaml"),
               ("agent_model", "configs/clm_models/agent_seed_x.yaml"))


def _jpeg(rng, w: int, h: int) -> bytes:
    import io

    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray((rng.random((h, w, 3)) * 255).astype(np.uint8)).save(
        buf, format="JPEG")
    return buf.getvalue()


def write_sft_data(root: str, seed: int = 0) -> dict:
    """Synthetic SFT data under ``root``, from ``seed``, in the formats the
    builders read: 2 webdataset shards of 8 captioned images each (jpg +
    txt + json similarity), a LLaVA jsonl of 6 conversations over images
    of 1-5 anyres tiles, and an edit jsonl of 4 source / target pairs.
    Returns {"comprehension_gen": yaml, "edit": yaml}: the repo's data
    YAMLs with only ``data_dir`` / ``image_dir`` rewritten."""
    import io
    import os
    import tarfile

    import yaml

    rng = np.random.default_rng(seed)
    shards = os.path.join(root, "webdataset")
    os.makedirs(shards)
    for s in range(2):
        with tarfile.open(os.path.join(shards, f"{s:05d}.tar"), "w") as tf:
            for i in range(8):
                key = f"{s:02d}{i:04d}"
                for ext, data in (
                        ("jpg", _jpeg(rng, int(rng.integers(448, 700)),
                                      int(rng.integers(448, 700)))),
                        ("txt", CAPTIONS[(s * 8 + i) % len(CAPTIONS)]
                         .encode()),
                        ("json", json.dumps({"similarity": 0.3}).encode())):
                    info = tarfile.TarInfo(f"{key}.{ext}")
                    info.size = len(data)
                    tf.addfile(info, io.BytesIO(data))
    img_dir = os.path.join(root, "images")
    os.makedirs(img_dir)
    lines = []
    for i, (w, h) in enumerate(((896, 896), (896, 448), (448, 448),
                                (448, 1344), (600, 450), (1344, 448))):
        with open(os.path.join(img_dir, f"conv_{i}.jpg"), "wb") as f:
            f.write(_jpeg(rng, w, h))
        lines.append({"image": f"conv_{i}.jpg",
                      "data": CONVERSATIONS[i % len(CONVERSATIONS)]})
    conv_dir = os.path.join(root, "llava")
    os.makedirs(conv_dir)
    with open(os.path.join(conv_dir, "conv.jsonl"), "w") as f:
        f.writelines(json.dumps(x) + "\n" for x in lines)
    edit_dir = os.path.join(root, "edit")
    os.makedirs(edit_dir)
    with open(os.path.join(edit_dir, "edit.jsonl"), "w") as f:
        for i in range(4):
            for side in ("src", "tgt"):
                with open(os.path.join(img_dir, f"{side}_{i}.jpg"),
                          "wb") as g:
                    g.write(_jpeg(rng, 512, 512))
            f.write(json.dumps({"source_image": f"src_{i}.jpg",
                                "target_image": f"tgt_{i}.jpg",
                                "instruction": "make the sky red"}) + "\n")
    out = {}
    with open("configs/data/sft_comprehension_gen.yaml") as f:
        cfg = yaml.safe_load(f)
    llava, caption = cfg["datapipes"]
    llava.update(data_dir=conv_dir, image_dir=img_dir)
    caption.update(data_dir=[shards])
    out["comprehension_gen"] = os.path.join(root, "comprehension_gen.yaml")
    with open("configs/data/sft_edit.yaml") as f:
        edit = yaml.safe_load(f)
    for dp in edit["datapipes"]:
        dp.update(data_dir=[edit_dir], image_dir=img_dir)
    out["edit"] = os.path.join(root, "edit.yaml")
    for key, c in (("comprehension_gen", cfg), ("edit", edit)):
        with open(out[key], "w") as f:
            yaml.safe_dump(c, f)
    return out


def cli_argv(dataset: str, out_dir: str, dev, *extra) -> list:
    argv = []
    for flag, path in SFT_CONFIGS:
        argv += [f"--{flag}", path]
    return argv + ["--train_dataset", dataset, "--output_dir", out_dir,
                   "--warmup_steps", "0", "--save_steps", "1000000",
                   "--trackers", "jsonl",
                   "--device", str(dev), *extra]


class CliRun:
    """Wraps ``train_sft.train_loop`` while ``main`` runs: logs every step,
    keeps the agent and ViT the factories built, the frozen weights' bit
    checksum before the first step, and each batch's launches and peak
    memory
    (``StepCounts``; on a resume the first entries are the skipped
    batches, which launch nothing)."""

    def __init__(self, feed=None):
        from seedx_tpu_torch.train import train_sft

        self.mod, self.real = train_sft, train_sft.train_loop
        self.agent = self.vit = self.steps = self.frozen_before = None
        self.trainable_names = self.trainable_before = None
        # ``feed``: batches handed to the loop in place of its stream; the
        # first two batches the loop took, and the trainable leaves' bit
        # checksum once two steps are done
        self.feed, self.first, self.after_two = feed, [], None

    def __enter__(self):
        self.mod.train_loop = self._loop
        return self

    def __exit__(self, *exc):
        self.mod.train_loop = self.real

    def _watch(self, it):
        for i, b in enumerate(it):
            if i == 2:
                self.after_two = self.params_sum()
            if i < 2:
                self.first.append(b)
            yield b
        if len(self.first) == 2 and self.after_two is None:
            self.after_two = self.params_sum()

    def params_sum(self) -> int:
        return bit_checksum(p.detach() for _, p in sorted(
            self.agent.named_parameters()))

    def _loop(self, agent, vit, data_iter, train_cfg, run_cfg, device,
              mesh=None):
        from seedx_tpu_torch.train.partition import path_labels

        self.agent, self.vit = agent, vit
        self.frozen_before = self.frozen_sum()
        # the trainable leaves as the fp32 masters the loop will make
        state = agent.state_dict()
        self.trainable_names = sorted(
            n for n, lab in path_labels(
                state.keys(), train_cfg.trainable_patterns).items()
            if lab == "trainable")
        self.trainable_before = bit_checksum(
            state[n].float() for n in self.trainable_names)
        del state                  # no second reference to any weight
        if self.feed is not None:
            data_iter = iter(self.feed)
        self.steps = StepCounts(self._watch(data_iter))
        # every step logged (the CLI's default logs every 10th)
        return self.real(agent, vit, iter(self.steps), train_cfg,
                         dataclasses.replace(run_cfg, log_steps=1),
                         device=device, mesh=mesh)

    def frozen_names(self):
        from seedx_tpu_torch.train.partition import path_labels

        return [n for n, lab in path_labels(
            self.agent.state_dict().keys()).items() if lab == "frozen"]

    def frozen_sum(self) -> int:
        state = self.agent.state_dict()
        return bit_checksum([state[n] for n in self.frozen_names()]
                            + list(self.vit.state_dict().values()))

    def trained_sum(self, state) -> int:
        if sorted(state.params) != self.trainable_names:
            raise AssertionError("train cli: the trainable set is not the "
                                 "config's")
        return bit_checksum(state.params[n] for n in self.trainable_names)


def cli_steps(label: str, run: CliRun, metrics, n_layers: int,
              vit_layers: int, totals) -> None:
    """Log each logged step of a CLI run (losses, ms by phase, trained
    tokens / s, the host's wait for the batch, peak memory, K1 / K4 / K5
    launches) and hold its launches
    to the SFT step's: K1 2 x the LLM's layers (forward and recompute) +
    the ViT's, K4 and K5 the LLM's layers."""
    counted = [s for s in run.steps.steps if s[0]["flash_fwd"]]
    if len(counted) != len(metrics):
        raise AssertionError(f"{label}: {len(counted)} steps launched "
                             f"kernels, {len(metrics)} logged")
    for m, (counts, peak, fetch_ms) in zip(metrics, counted):
        add_counts(totals, counts)
        ms = m["vit_ms"] + m["fwd_bwd_ms"] + m["opt_ms"]
        log(f"{label} step {m['step']}: total_loss {m['total_loss']:.5f} "
            f"lm_loss {m['lm_loss']:.5f} rec_loss {m['rec_loss']:.5f} "
            f"grad_norm {m['grad_norm']:.4f} lr {m['lr']:.3e}; vit "
            f"{m['vit_ms']:.1f} ms, fwd+bwd {m['fwd_bwd_ms']:.1f} ms, "
            f"optimizer {m['opt_ms']:.1f} ms, {ms:.1f} ms a step, "
            f"{m['tokens']} tokens, {m['tokens'] / ms * 1e3:.1f} trained "
            f"tok/s; the batch's host wait {fetch_ms:.1f} ms; "
            f"max_memory_allocated {peak / 2**30:.2f} GiB; launches "
            f"flash_fwd {counts['flash_fwd']} flash_bwd_dq "
            f"{counts['flash_bwd_dq']} flash_bwd_dkv "
            f"{counts['flash_bwd_dkv']}")
        want = (2 * n_layers + vit_layers, n_layers, n_layers)
        got = (counts["flash_fwd"], counts["flash_bwd_dq"],
               counts["flash_bwd_dkv"])
        if got != want or not np.isfinite(m["total_loss"]):
            raise AssertionError(f"{label} step {m['step']}: launches {got}"
                                 f" (want {want}), loss {m['total_loss']}")


def train_cli_parallel(dev, dataset: str, out_dir: str, unsharded,
                       n_layers: int, vit_layers: int) -> dict:
    """``main(--parallel configs/parallel/fsdp.yaml)`` at full width on a
    one-rank NCCL mesh (torchrun's environment for one process): the
    factories' weights placed by ``place_params``, every collective of the
    forward, the backward and the optimizer a one-rank NCCL call, fed the
    unsharded CLI run's first two batches (the threaded tar reader's order
    is not fixed from run to run).  Losses and grad norms of both steps
    and the trainable leaves after them must be bit-equal to the unsharded
    run's.  Logs ms a step both ways, the collectives a step (host calls)
    and K1 / K4 / K5 launches a step.  Returns the launches."""
    import torch
    import torch.distributed as dist

    from seedx_tpu_torch.parallel.distributed import COLLECTIVES
    from seedx_tpu_torch.train import train_sft

    batches, ref_metrics, ref_sum = unsharded
    totals = {}
    start_one_rank_group()
    before = dict(COLLECTIVES)
    t0 = time.perf_counter()
    try:
        with CliRun(feed=batches) as run:
            # the unsharded run's schedule (its lr decays over
            # CLI_STEPS); the loop ends with the two batches fed
            state = train_sft.main(cli_argv(
                dataset, out_dir, dev, "--max_steps", str(CLI_STEPS),
                "--parallel", "configs/parallel/fsdp.yaml"))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        calls = {k: (COLLECTIVES[k] - before[k]) / 2 for k in COLLECTIVES}
        with open(os.path.join(out_dir, "metrics.jsonl")) as f:
            metrics = [json.loads(x) for x in f]
        cli_steps("train cli --parallel", run, metrics, n_layers,
                  vit_layers, totals)
        keys = ("total_loss", "lm_loss", "rec_loss", "grad_norm")
        same = ([[m[k] for k in keys] for m in metrics]
                == [[m[k] for k in keys] for m in ref_metrics])
        ms = [[m["vit_ms"] + m["fwd_bwd_ms"] + m["opt_ms"] for m in ms_]
              for ms_ in (metrics, ref_metrics)]
        log(f"train cli --parallel configs/parallel/fsdp.yaml (one-rank "
            f"NCCL mesh, {state.step} steps in {wall:.1f} s, the build "
            f"included): ms a step {', '.join(f'{x:.1f}' for x in ms[0])} "
            f"vs {', '.join(f'{x:.1f}' for x in ms[1])} unsharded; "
            f"collectives a step (host calls) {json.dumps(calls)}; losses "
            f"and grad norms bit-equal: {same}; trainable leaves after 2 "
            f"steps bit-equal (checksum): {run.after_two == ref_sum}")
        if not same or run.after_two != ref_sum or state.step != 2:
            raise AssertionError("train cli --parallel: the one-rank mesh "
                                 "run differs from the unsharded one")
        del state, run
    finally:
        dist.destroy_process_group()
        for var in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR",
                    "MASTER_PORT"):
            os.environ.pop(var, None)
    return totals


READER_BATCHES = 6


def reader_times(data_yaml: str, tokenizer, transform) -> dict:
    """Host ms a batch of the CLI data YAML's caption builder (B8 at 260,
    the builder that reads the tar shards) under each tar reader, and each
    reader's samples / s over the shards alone (the tar parse and the
    image decode, no transform), in turns native / python / python /
    native.  The first batch fills the builder's 64-sample shuffle buffer,
    so it is kept apart.  -> {reader: {"first": [ms], "rest": [ms],
    "samples_per_s": [x]}}"""
    import glob
    import os

    from seedx_tpu_torch import config as config_lib
    from seedx_tpu_torch.data import native, pipeline

    caption = config_lib.load_config(data_yaml)["datapipes"][1]
    shards = sorted(glob.glob(os.path.join(caption["data_dir"][0],
                                           "*.tar"))) * 4
    base = native.available
    out = {}
    try:
        for name in ("native", "python", "python", "native"):
            native.available = base if name == "native" else (lambda: False)
            rec = out.setdefault(name, {"first": [], "rest": [],
                                        "samples_per_s": []})
            it = config_lib.instantiate(caption, tokenizer=tokenizer,
                                        image_transform=transform)
            for i in range(READER_BATCHES):
                t = time.perf_counter()
                next(it)
                rec["first" if i == 0 else "rest"].append(
                    (time.perf_counter() - t) * 1e3)
            t = time.perf_counter()
            n = sum(1 for _ in pipeline.read_tar_shards_multi(
                shards, native=name == "native"))
            rec["samples_per_s"].append(n / (time.perf_counter() - t))
    finally:
        native.available = base
    return out


def run_train(dev):
    """Phase 11: SFT at full SEED-X width (see the module docstring): the
    ``train_sft`` entry point over the repo's YAMLs and synthetic files on
    disk, a resume, then a profiled step, accumulation 2 and the gradient
    check on the models it built.  Returns the main path's launches (the
    CLI's steps and the accumulation step)."""
    import os
    import shutil
    import tempfile

    import torch

    from seedx_tpu_torch import config as config_lib
    from seedx_tpu_torch.data import native
    from seedx_tpu_torch.text.tokenizer import load_tokenizer
    from seedx_tpu_torch.train import checkpoints, train_sft
    from seedx_tpu_torch.train.trainer import TrainConfig, make_train_step

    t0 = time.perf_counter()
    root = tempfile.mkdtemp(prefix="chip_smoke_sft_")
    totals = {}
    saves = []
    base_save = checkpoints.CheckpointManager.save

    def timed_save(self, step, state):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        path = base_save(self, step, state)
        saves.append((path, time.perf_counter() - t1))
        return path

    try:
        checkpoints.CheckpointManager.save = timed_save
        yamls = write_sft_data(os.path.join(root, "data"))
        reader = "native (g++)" if native.available() else "python tarfile"
        log(f"train cli: synthetic data written in "
            f"{time.perf_counter() - t0:.1f} s; tar reader: {reader}")
        transform = config_lib.instantiate_from_file(SFT_CONFIGS[0][1])
        # the caption builder's batches under each tar reader, host only
        # (the Python reader alone where no g++ builds the native one)
        times = (reader_times(yamls["comprehension_gen"], load_tokenizer(),
                              transform) if native.available() else {})
        for name, rec in times.items():
            rest = sorted(rec["rest"])
            log(f"train cli: caption batch (B8) under the {name} reader: "
                f"first {', '.join(f'{x:.1f}' for x in rec['first'])} ms "
                f"(the shuffle buffer's 64 samples), then median "
                f"{rest[len(rest) // 2]:.1f} ms (min {rest[0]:.1f}, max "
                f"{rest[-1]:.1f}) over {len(rest)}; the shards alone "
                f"{', '.join(f'{x:.1f}' for x in rec['samples_per_s'])} "
                f"samples/s")
        # the edit YAML's builders on the same files: one batch, host only
        edit = next(config_lib.instantiate(
            config_lib.load_config(yamls["edit"]), tokenizer=load_tokenizer(),
            image_transform=transform))
        log(f"train cli: sft_edit.yaml batch input_ids "
            f"{edit['input_ids'].shape}, images {edit['images'].shape}, "
            f"generation slots {int(edit['embeds_gen_mask'].sum())}")
        if edit["input_ids"].shape != (6, 320) or int(
                edit["embeds_gen_mask"].sum()) != 6:
            raise AssertionError("train cli: the edit batch is malformed")

        out_dir = os.path.join(root, "run")
        t1 = time.perf_counter()
        with CliRun() as run:
            state = train_sft.main(cli_argv(
                yamls["comprehension_gen"], out_dir, dev, "--max_steps",
                str(CLI_STEPS)))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t1
        agent, vit = run.agent, run.vit
        n, vit_layers = agent.cfg.llm.num_layers, vit.cfg.layers
        if (n, vit_layers, agent.cfg.llm.hidden_size,
                agent.cfg.llm.lora_rank) != SFT_WIDTH:
            raise AssertionError(f"train cli: not the full-width agent: "
                                 f"{agent.cfg.llm}")
        with open(os.path.join(out_dir, "metrics.jsonl")) as f:
            metrics = [json.loads(x) for x in f]
        if state.step != CLI_STEPS or len(metrics) != CLI_STEPS:
            raise AssertionError(f"train cli: {state.step} steps, "
                                 f"{len(metrics)} logged")
        log(f"train cli: main() built ViT-bigG/14-448 + the SEED-X agent "
            f"(LLaMA2-13B bf16, LoRA r32) from the repo's YAMLs and trained "
            f"{CLI_STEPS} steps in {wall:.1f} s (the build and the data "
            f"stream included)")
        cli_steps("train cli", run, metrics, n, vit_layers, totals)
        # the unsharded run's first two steps: the mesh run's reference
        unsharded = (run.first, metrics[:2], run.after_two)
        if run.frozen_sum() != run.frozen_before:
            raise AssertionError("train cli: a frozen weight changed")
        log(f"train cli: frozen weights unchanged ({len(run.frozen_names())}"
            f" agent leaves and the ViT, bit checksum)")
        trained_ref = run.trained_sum(state)
        if trained_ref == run.trainable_before:
            raise AssertionError("train cli: no trainable leaf changed")
        log(f"train cli: the {len(run.trainable_names)} trainable leaves "
            f"changed (bit checksum)")
        path, secs = saves[-1]
        nbytes = os.path.getsize(os.path.join(path, "state.pt"))
        t1 = time.perf_counter()
        back = checkpoints.CheckpointManager(os.path.dirname(path)).restore(
            map_location=dev)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t1
        live = state.state_dict()
        same = back["step"] == live["step"] and all(
            torch.equal(back["trainable"][k], p)
            for k, p in live["trainable"].items()) and all(
            torch.equal(back["opt_state"][m][k], t)
            for m in ("mu", "nu") for k, t in live["opt_state"][m].items())
        log(f"train cli: checkpoint {os.path.basename(path)} "
            f"{nbytes / 2**30:.2f} GiB written in {secs:.2f} s, read back in "
            f"{load_s:.2f} s, bit-equal to the live state: {same}")
        if not same:
            raise AssertionError("train cli: the checkpoint differs from "
                                 "the live state")
        frozen_ref = run.frozen_before
        del back, live
        gc.collect()
        torch.cuda.empty_cache()

        # on the models main() built: one more step of batch (a) under
        # torch.profiler (a check run, so not in the kernels line)
        batch_a, batch_b, batch_b2 = sft_batches(
            load_tokenizer(), vit.cfg.image_size, 64, 64)
        train_cfg = TrainConfig(warmup_steps=0, max_steps=CLI_STEPS)
        step_fn = make_train_step(agent, train_cfg)
        dev_a = train_sft._to_device(batch_a, dev)
        images_a = dev_a.pop("images")

        def one_step():
            with torch.no_grad():
                dev_a["image_embeds"] = vit(images_a,
                                            dev_a["patch_positions"])
            step_fn(state, dev_a, torch.Generator(device=dev).manual_seed(9))
            return 1

        reset_counts()
        profile_window("train step (a)", one_step, top_n=8)
        add_counts(CHECKS, read_counts())
        del state
        gc.collect()
        torch.cuda.empty_cache()

        # gradient accumulation: one step over two generation batches, the
        # ViT encoding their 16 tiles in one pass
        acc_dir = os.path.join(root, "accum")
        reset_counts()
        torch.cuda.reset_peak_memory_stats()
        state = train_sft.train_loop(
            agent, vit, iter([batch_b, batch_b2]),
            TrainConfig(warmup_steps=0, max_steps=1,
                        gradient_accumulation_steps=2),
            train_sft.RunConfig(output_dir=acc_dir, log_steps=1,
                                trackers=("jsonl",), seed=1), device=dev)
        torch.cuda.synchronize()
        counts = read_counts()
        add_counts(totals, counts)
        with open(os.path.join(acc_dir, "metrics.jsonl")) as f:
            m = json.loads(f.readline())
        log(f"train accum 2: total_loss {m['total_loss']:.5f} rec_loss "
            f"{m['rec_loss']:.5f} grad_norm {m['grad_norm']:.4f}; vit "
            f"{m['vit_ms']:.1f} ms (16 tiles), fwd+bwd {m['fwd_bwd_ms']:.1f} "
            f"ms, optimizer {m['opt_ms']:.1f} ms, {m['tokens']} tokens; "
            f"max_memory_allocated "
            f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; launches "
            f"{json.dumps(counts)}")
        want = (4 * n + vit_layers, 2 * n, 2 * n)
        got = (counts["flash_fwd"], counts["flash_bwd_dq"],
               counts["flash_bwd_dkv"])
        if state.step != 1 or got != want or not np.isfinite(
                m["total_loss"]):
            raise AssertionError(f"train accum 2: step {state.step}, "
                                 f"launches {got} (want {want}), {m}")
        shutil.rmtree(acc_dir, ignore_errors=True)
        del state, agent, step_fn, run
        gc.collect()
        torch.cuda.empty_cache()

        # the 2-layer gradient check on batch (a), the CLI's ViT features
        grad_check(dev, dev_a)
        del dev_a, images_a, vit
        gc.collect()
        torch.cuda.empty_cache()

        # save -> resume: a new main() (the factories draw the same random
        # weights) restores the last checkpoint, skips the batches already
        # trained on, and trains on to CLI_RESUME_STEPS
        t1 = time.perf_counter()
        with CliRun() as run:
            state = train_sft.main(cli_argv(
                yamls["comprehension_gen"], out_dir, dev, "--max_steps",
                str(CLI_RESUME_STEPS), "--resume"))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t1
        with open(os.path.join(out_dir, "metrics.jsonl")) as f:
            metrics = [json.loads(x) for x in f]
        resumed = [m for m in metrics if m["step"] >= CLI_STEPS]
        if state.step != CLI_RESUME_STEPS or [m["step"] for m in resumed] \
                != list(range(CLI_STEPS, CLI_RESUME_STEPS)):
            raise AssertionError(f"train cli resume: step {state.step}, "
                                 f"logged {[m['step'] for m in metrics]}")
        if run.frozen_before != frozen_ref:
            raise AssertionError("train cli resume: the factories built "
                                 "other frozen weights")
        log(f"train cli resume: main(--resume) restored "
            f"checkpoint-{CLI_STEPS}, skipped {CLI_STEPS} batches and "
            f"trained to step {state.step} in {wall:.1f} s (the build "
            f"included)")
        cli_steps("train cli resume", run, resumed, n, vit_layers, totals)
        if run.frozen_sum() != frozen_ref:
            raise AssertionError("train cli resume: a frozen weight changed")
        if run.trained_sum(state) == trained_ref:
            raise AssertionError("train cli resume: no trainable leaf "
                                 f"changed after checkpoint-{CLI_STEPS}")
        del state, run
        gc.collect()
        torch.cuda.empty_cache()
        add_counts(totals, train_cli_parallel(
            dev, yamls["comprehension_gen"], os.path.join(root, "mesh"),
            unsharded, n, vit_layers))
    finally:
        checkpoints.CheckpointManager.save = base_save
        shutil.rmtree(root, ignore_errors=True)
        gc.collect()
        torch.cuda.empty_cache()
    log(f"train: phase done in {time.perf_counter() - t0:.1f} s")
    return totals


# ---- de-tokenizer (adapter) training at full SDXL width (phase 12) --------

ADAPTER_STEPS = 3
ADAPTER_BATCH = 2


def adapter_batch(adapter, vit, dev):
    """(latents, image_embeds) of ADAPTER_BATCH seeded 1024^2 images: the
    fp32 VAE encoder's scaled latents [B, 128, 128, 4] (the mode) and the
    frozen ViT-bigG's features of the 448^2 images pooled by
    ``vit_downsample`` [B, 64, 4096]."""
    import torch
    from PIL import Image

    from seedx_tpu_torch.data.transforms import get_transform
    from seedx_tpu_torch.models.sdxl.vae import sample_moments
    from seedx_tpu_torch.models.vit import vit_downsample

    rng = np.random.default_rng(21)
    size = adapter.cfg.sampler.height            # 1024
    images = [Image.fromarray((rng.random((size, size, 3)) * 255).astype(
        np.uint8)) for _ in range(ADAPTER_BATCH)]
    sd = get_transform("sd", keep_ratio=False, image_size=size)
    clip = get_transform("clip", keep_ratio=False, image_size=448)
    with torch.no_grad():
        pix = torch.from_numpy(np.stack([sd(i) for i in images])).to(dev)
        latents = sample_moments(adapter.vae_encoder(pix)) \
            * adapter.cfg.sampler.vae_scaling_factor
        tiles = torch.from_numpy(np.stack([clip(i) for i in images])).to(
            dev, torch.bfloat16)
        embeds = vit_downsample(vit(tiles))
    return {"latents": latents.float().contiguous(),
            "image_embeds": embeds.contiguous()}


def run_adapter_train(dev, smi: str):
    """Phase 12: de-tokenizer training (``make_adapter_train_step``) at the
    full SDXL base width on 1024^2 latents: ResamplerXL + the base UNet's
    to_k / to_v and conv_in trainable (fp32 masters, AdamW), the rest of
    the UNet frozen bf16; ADAPTER_STEPS steps at batch ADAPTER_BATCH on
    one repeated draw of t and noise, each launching K1, K4 and K5 at all
    70 self-attentions and the norm kernels at all 46 GroupNorms and 210
    LayerNorms (their backward plain torch), the loss finite and lower
    after the first update, the trainable leaves changed and the frozen
    ones bit-equal after.  Returns the steps' launches."""
    import torch

    from seedx_tpu_torch.models.layers import init_normal_
    from seedx_tpu_torch.models.sdxl.pipeline import default_time_ids
    from seedx_tpu_torch.models.sdxl.unet import (flash_launches_per_eval,
                                                  norm_launches_per_eval)
    from seedx_tpu_torch.models.vit import VisionTransformer, qwen_vitg_448
    from seedx_tpu_torch.train.train_adapter import (AdapterTrainConfig,
                                                     make_adapter_train_step)

    t0 = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(13)
    vit = init_normal_(VisionTransformer(qwen_vitg_448(), dev).eval(), gen)
    adapter = build_adapter(dev, vit, edit=False)
    batch = adapter_batch(adapter, vit, dev)
    adapter.vae_decoder = adapter.vae_encoder = adapter.visual_encoder = None
    del vit
    gc.collect()
    torch.cuda.empty_cache()
    unet, res = adapter.unet, adapter.resampler
    cfg = AdapterTrainConfig(warmup_steps=0, max_steps=ADAPTER_STEPS)
    init_state, train_step = make_adapter_train_step(
        unet, res, cfg, default_time_ids(adapter.cfg.sampler, 1, dev)[0])
    state = init_state()
    n_train = sum(p.numel() for p in state.params.values())
    frozen = [b for m in (unet, res) for b in m.buffers()]
    before = bit_checksum(frozen)
    trained_before = bit_checksum(state.params.values())
    log(f"adapter train: latents {tuple(batch['latents'].shape)} (VAE "
        f"scaled, std {batch['latents'].std().item():.3f}), image_embeds "
        f"{tuple(batch['image_embeds'].shape)}; {len(state.params)} "
        f"trainable leaves, {n_train / 1e6:.1f} M values (fp32 masters + "
        f"AdamW), {sum(b.numel() for b in frozen) / 1e6:.1f} M frozen; "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated; set up "
        f"in {time.perf_counter() - t0:.1f} s")
    per = flash_launches_per_eval(adapter.cfg.unet)
    norms = norm_launches_per_eval(adapter.cfg.unet)
    totals = {}
    losses = []
    for i in range(ADAPTER_STEPS):
        reset_counts()
        torch.cuda.reset_peak_memory_stats()
        # every step draws the same t and noise: the loss is then taken on
        # one repeated (batch, t, noise) and must fall after an update
        m = train_step(state, batch,
                       torch.Generator(device=dev).manual_seed(0))
        losses.append(m["total_loss"])
        torch.cuda.synchronize()
        counts = read_counts()
        add_counts(totals, counts)
        peak = torch.cuda.max_memory_allocated()
        got = (counts["flash_fwd"], counts["flash_bwd_dq"],
               counts["flash_bwd_dkv"])
        got_norms = (counts["group_norm"], counts["layer_norm"])
        log(f"adapter train step {i}: total_loss {m['total_loss']:.5f} "
            f"grad_norm {m['grad_norm']:.4f} lr {m['lr']:.3e}; fwd+bwd "
            f"{m['fwd_bwd_ms']:.1f} ms, optimizer {m['opt_ms']:.1f} ms, "
            f"{m['fwd_bwd_ms'] + m['opt_ms']:.1f} ms a step; "
            f"max_memory_allocated {peak / 2**30:.2f} GiB; launches "
            f"flash_fwd {got[0]} flash_bwd_dq {got[1]} flash_bwd_dkv "
            f"{got[2]} group_norm {got_norms[0]} layer_norm {got_norms[1]} "
            f"({smi})")
        if (got != (per, per, per) or got_norms != norms
                or not (np.isfinite(m["total_loss"])
                        and np.isfinite(m["grad_norm"]))):
            raise AssertionError(f"adapter train step {i}: launches {got} "
                                 f"(want {per} each), norms {got_norms} "
                                 f"(want {norms}), {m}")
    if state.step != ADAPTER_STEPS:
        raise AssertionError(f"adapter train: {state.step} steps")
    if not losses[1] < losses[0]:
        raise AssertionError(f"adapter train: one update did not lower the "
                             f"loss on the repeated draw: {losses}")
    if bit_checksum(state.params.values()) == trained_before:
        raise AssertionError("adapter train: no trainable leaf changed")
    log(f"adapter train: the loss on the repeated draw {losses[0]:.5f} -> "
        f"{losses[1]:.5f} after one update; the {len(state.params)} "
        f"trainable leaves changed (bit checksum)")
    # one more step under torch.profiler: the device's busy share and where
    # its time goes (a check run, so not in the kernels line)
    reset_counts()
    profile_window("adapter train step", lambda: train_step(
        state, batch, torch.Generator(device=dev).manual_seed(0)) and 1,
        top_n=8)
    add_counts(CHECKS, read_counts())
    if bit_checksum(frozen) != before:
        raise AssertionError("adapter train: a frozen leaf changed")
    log(f"adapter train: frozen UNet / resampler leaves unchanged (bit "
        f"checksum); phase done in {time.perf_counter() - t0:.1f} s")
    del state, adapter, unet, res, batch
    gc.collect()
    torch.cuda.empty_cache()
    return totals


# ---- the rest of generation (phase 8) ------------------------------------

GEN_T = 128                 # each script's length
GEN_K = 4                   # the draft length of the scripted runs
GEN_BUCKET = 512
BEAM_T = 16                 # beam steps at full width
BEAM_SHAPES = ((1, 3), (1, 4), (2, 3), (2, 4))      # (B, K)
GEN_DOC = ("Quarterly report. Subscription renewals in the enterprise "
           "segment grew by eleven percent, driven by the new annual plans "
           "and a lower churn rate among mid-sized customers. Hardware "
           "revenue fell for the third quarter in a row, while services "
           "margins held steady at forty-two percent.")


def gen_prompt(tok):
    """A document-QA prompt (the doc quoted in it) and the doc's ids."""
    doc = tok.encode(GEN_DOC)
    ids = ([tok.bos_token_id] + tok.encode("[INST] Read the report.\n") + doc
           + tok.encode("\nWhat happened to renewals? [/INST]\n"))
    return ids, doc


def gen_scripts(tok, prompt, doc):
    """Two scripted replies of ``GEN_T`` tokens: "echo" quotes long runs
    of the prompt's document, as doc-QA and grounding replies do;
    "adversarial" repeats no n-gram (distinct ids the prompt lacks)."""
    first = len(tok.encode(GEN_DOC[:GEN_DOC.index("Subscription")]))
    second = len(tok.encode(GEN_DOC[:GEN_DOC.index("Hardware")]))
    echo = (doc[first:first + 70] + tok.encode(" and that ")
            + doc[second:])[:GEN_T]
    rng = np.random.default_rng(0)
    pool = np.setdiff1d(np.arange(3, 30000), np.asarray(prompt))
    adversarial = [int(x) for x in rng.choice(pool, GEN_T, replace=False)]
    if len(echo) != GEN_T:
        raise AssertionError(f"echo script of {len(echo)} tokens")
    return {"echo": [int(x) for x in echo], "adversarial": adversarial}


def script_cfg(rt, spec_k: int, bucket: int = GEN_BUCKET):
    from seedx_tpu_torch.models import generation

    tok = rt.tokenizer
    return generation.GenerationConfig(
        max_new_tokens=GEN_T, num_img_gen_tokens=rt.agent_cfg.
        num_img_out_tokens, eos_token_id=tok.eos_token_id,
        pad_token_id=tok.pad_token_id, prompt_buckets=(bucket,),
        spec_k=spec_k)


def padded_prompt(ids, dev, bucket: int = GEN_BUCKET):
    import torch

    padded = torch.zeros((1, bucket), dtype=torch.int64, device=dev)
    padded[0, bucket - len(ids):] = torch.tensor(ids, device=dev)
    return padded, padded != 0


def script_run(rt, prompt, script, gen_cfg, bucket: int = GEN_BUCKET):
    """``generate_tokens`` at B 1 with the prompt's ids and a script:
    (out, timings)."""
    import torch

    from seedx_tpu_torch.models import generation

    padded, mask = padded_prompt(prompt, rt.device, bucket)
    t = {}
    with torch.no_grad():
        out = generation.generate_tokens(
            rt.agent, rt.agent.embed_ids(padded), mask,
            torch.tensor([prompt[-1]], device=rt.device), gen_cfg,
            rt.tokenizer.vocab, timings=t, prompt_ids=padded,
            script_ids=torch.tensor(script))
    if rt.device.type == "cuda":
        torch.cuda.synchronize()
    return out, t


def cpu_counters(prompt, scripts):
    """(spec_rounds, spec_accepted) of each script on the port's 2-layer
    debug agent on the CPU (the plain versions): under forcing they are a
    function of the token stream alone."""
    from seedx_tpu_torch.inference.runtime import SeedXRuntime

    cpu = SeedXRuntime.debug(device="cpu", quantization="int4",
                             kv_quantization="int8")
    out = {}
    for name, script in scripts.items():
        res, _ = script_run(cpu, prompt, script, script_cfg(cpu, GEN_K))
        out[name] = (int(res["spec_rounds"]), int(res["spec_accepted"]))
    return out


def run_generation(rt, dev, smi: str):
    """Phase 8 on the full-width runtime: speculative decoding under
    script forcing (an echo and an adversarial script, plain and k 4,
    each captured twice (the first call captures) and eager), beam
    search at K 3 / 4 and B 1 / 2 (captured and eager; K 1 against the
    greedy stream), and three ``/v1/chat`` turns with ``spec_k`` 4.
    Returns the main path's launches (the warm captured runs, the beams
    and the chat); the other runs' go to ``CHECKS``."""
    import torch

    tok = rt.tokenizer
    prompt, doc = gen_prompt(tok)
    scripts = gen_scripts(tok, prompt, doc)
    t0 = time.perf_counter()
    want = cpu_counters(prompt, scripts)
    log(f"generation: the scripts' counters on the 2-layer CPU agent "
        f"{json.dumps(want)} ({time.perf_counter() - t0:.1f} s)")
    launches = {}
    for name, script in scripts.items():
        res = {}
        for k in (0, GEN_K):
            for mode in ("graphs, first call", "graphs", "eager"):
                rt.graphs.enabled = mode != "eager"
                reset_counts()
                out, t = script_run(rt, prompt, script, script_cfg(rt, k))
                label = f"generation {name} k {k} ({mode})"
                counts = path_counts(label)
                add_counts(launches if mode == "graphs" else CHECKS, counts)
                if out["tokens"][0].tolist() != script:
                    raise AssertionError(f"{label}: the stream is not the "
                                         f"script")
                if k and mode != "eager" and not (
                        counts["decode_attn multi_query"] > 0
                        and counts["int4_w4a8 rows 2-16"] > 0):
                    raise AssertionError(f"{label}: no verify round ran "
                                         f"K3's stair and K2 at k + 1 rows")
                res[(k, mode)] = (out, t)
                rounds, acc = int(out["spec_rounds"]), int(
                    out["spec_accepted"])
                verify = (f"verify "
                          f"{t['verify_s'] / t['verify_replays'] * 1e3:.2f}"
                          f" ms a round over {t['verify_replays']} replays "
                          if t["verify_replays"] else "")
                plain = (f"plain "
                         f"{t['plain_s'] / t['plain_replays'] * 1e3:.2f}"
                         f" ms a step over {t['plain_replays']} replays, "
                         if t["plain_replays"] else "")
                log(f"{label}: {t['decode_tokens']} tokens in "
                    f"{t['decode'] * 1e3:.1f} ms "
                    f"({t['decode_tokens'] / t['decode']:.2f} tok/s), "
                    f"{t['decode_forwards']} forwards; {verify}{plain}"
                    f"rounds {rounds}, accepted {acc} "
                    f"({acc / max(rounds, 1):.2f} a round), gate flips "
                    f"{t['gate_flips']} ({smi})")
            e = res[(k, "eager")][0]
            for mode in ("graphs, first call", "graphs"):
                g = res[(k, mode)][0]
                if not all(torch_equal(g[key], e[key]) for key in g):
                    raise AssertionError(f"generation {name} k {k}: {mode} "
                                         f"and eager outputs differ")
        got = (int(res[(GEN_K, "graphs")][0]["spec_rounds"]),
               int(res[(GEN_K, "graphs")][0]["spec_accepted"]))
        if got != want[name]:
            raise AssertionError(f"generation {name}: counters {got} at "
                                 f"full width, {want[name]} on the CPU")
        log(f"generation {name}: the stream is the script in all six "
            f"runs, captured = eager bit for bit, counters {got} = the CPU "
            f"run's")
        # the times kept: captured, plain and spec in turns (plain, spec,
        # spec, plain) on the same card
        rt.graphs.enabled = True
        turns = {0: [], GEN_K: []}
        for k in (0, GEN_K, GEN_K, 0):
            reset_counts()
            turns[k].append(script_run(rt, prompt, script,
                                       script_cfg(rt, k))[1])
            add_counts(CHECKS, read_counts())

        def rate(ts, what):
            n = sum(t[f"{what}_replays"] for t in ts)
            return sum(t[f"{what}_s"] for t in ts) / n * 1e3 if n else 0.0

        tok_s = {k: [t["decode_tokens"] / t["decode"] for t in ts]
                 for k, ts in turns.items()}
        sp_t = turns[GEN_K]
        log(f"generation {name}, in turns: plain {tok_s[0][0]:.2f} / "
            f"{tok_s[0][1]:.2f} tok/s ({rate(turns[0], 'plain'):.2f} ms a "
            f"step), spec k {GEN_K} {tok_s[GEN_K][0]:.2f} / "
            f"{tok_s[GEN_K][1]:.2f} tok/s "
            f"({statistics.mean(tok_s[GEN_K]) / statistics.mean(tok_s[0]):.3f}"
            f"x plain): verify {rate(sp_t, 'verify'):.2f} ms a round "
            f"({sp_t[0]['verify_replays']} a run), its plain steps "
            f"{rate(sp_t, 'plain'):.2f} ms ({sp_t[0]['plain_replays']} a "
            f"run), {got[1] / max(got[0], 1):.2f} accepted a round, "
            f"{sp_t[0]['gate_flips']} gate flips ({smi})")
    rt.graphs.enabled = True
    # device time of each program a replay (a replay after decode stopped
    # runs the same forward, its writes masked)
    from seedx_tpu_torch.models import generation

    store = generation.decode_programs(rt.agent)
    st = {k: store.states[(1, GEN_BUCKET + GEN_T + k, script_cfg(rt, k),
                           tok.vocab, k, True)] for k in (0, GEN_K)}
    reset_counts()
    for label, prog in (("plain step, plain state", st[0].program),
                        ("plain step, spec state", st[GEN_K].program),
                        ("verify round", st[GEN_K].spec_program)):
        profile_window(f"generation {label}",
                       lambda prog=prog: [prog() for _ in range(8)] and 8)
    add_counts(CHECKS, read_counts())
    add_counts(launches, run_beams(rt, prompt, smi))
    add_counts(launches, spec_chat(rt))
    return launches


def run_beams(rt, prompt, smi: str):
    """Beam search at full width: each (B, K) of ``BEAM_SHAPES`` captured
    (the first call captures, the second replays) and eager, bit for bit;
    ms a step, the cache gather's device ms a step and peak memory; K 1
    against the greedy stream."""
    import torch

    from seedx_tpu_torch.models import generation

    tok, dev = rt.tokenizer, rt.device
    second = [tok.bos_token_id] + tok.encode(
        "[INST] Name three colors of the sea. [/INST]\n")
    rows = [padded_prompt(prompt, dev), padded_prompt(second, dev)]
    launches = {}

    def beam(b, k, timings=None):
        cfg = dataclasses.replace(script_cfg(rt, 0), max_new_tokens=BEAM_T,
                                  num_beams=k)
        padded = torch.cat([r[0] for r in rows[:b]])
        mask = torch.cat([r[1] for r in rows[:b]])
        with torch.no_grad():
            out = generation.generate_tokens_beam(
                rt.agent, rt.agent.embed_ids(padded), mask, padded[:, -1],
                cfg, tok.vocab, timings=timings)
        torch.cuda.synchronize()
        return out, cfg

    for b, k in BEAM_SHAPES:
        res = {}
        torch.cuda.reset_peak_memory_stats()
        for mode in ("graphs, first call", "graphs", "eager"):
            rt.graphs.enabled = mode != "eager"
            reset_counts()
            t = {}
            out, cfg = beam(b, k, t)
            counts = path_counts(f"beam B{b} K{k} ({mode})")
            add_counts(launches if mode == "graphs" else CHECKS, counts)
            res[mode] = (out, t)
            if mode == "graphs" and not (
                    counts["decode_attn one_query"] > 0
                    and counts["int4_w4a8 rows 2-16"] > 0):
                raise AssertionError(f"beam B{b} K{k}: K3 one-query or K2 "
                                     f"at B * K rows not launched")
        rt.graphs.enabled = True
        for mode in ("graphs, first call", "graphs"):
            if not all(torch_equal(res[mode][0][key], res["eager"][0][key])
                       for key in res["eager"][0]):
                raise AssertionError(f"beam B{b} K{k}: {mode} and eager "
                                     f"differ")
        out = res["graphs"][0]
        if not bool(torch.isfinite(out["scores"]).all()):
            raise AssertionError(f"beam B{b} K{k}: scores not finite")
        # the step's cache gather alone, at this shape
        (st,) = [s for key, s in generation.decode_programs(
            rt.agent).states.items() if key[:4] == ("beam", b, GEN_BUCKET,
                                                     cfg)]
        sel = torch.arange(b * k, device=dev).flip(0)
        gather_ms = cuda_ms(lambda: [generation._gather_rows(c, sel)
                                     for c in st.cache])
        bytewise_ms = cuda_ms(lambda: [c.copy_(c.index_select(1, sel))
                                       for c in st.cache])
        step = {m: res[m][1]["decode"] / BEAM_T * 1e3 for m in res}
        n_bytes = sum(c.numel() * c.element_size() for c in st.cache)
        log(f"beam B{b} K{k}: {BEAM_T} steps, {step['graphs']:.2f} ms a "
            f"step captured ({step['graphs, first call']:.2f} first call, "
            f"eager {step['eager']:.2f}); the cache gather "
            f"{gather_ms:.3f} ms a step ({gather_ms / step['graphs']:.1%} "
            f"of it, {n_bytes / 2**20:.1f} MiB gathered; element by "
            f"element {bytewise_ms:.3f} ms); peak memory "
            f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; "
            f"captured = eager bit for bit ({smi})")
    # one beam is the greedy stream
    out, cfg = beam(1, 1)
    seq, _, _ = generation._backtrack_beam(out, cfg, 0)
    padded, mask = rows[0]
    with torch.no_grad():
        greedy = generation.generate_tokens(
            rt.agent, rt.agent.embed_ids(padded), mask, padded[:, -1],
            dataclasses.replace(cfg, num_beams=1), tok.vocab)
    if list(seq) != greedy["tokens"][0].tolist():
        raise AssertionError(f"beam K1 {list(seq)} vs greedy "
                             f"{greedy['tokens'][0].tolist()}")
    log(f"beam K1: the greedy stream ({BEAM_T} tokens)")
    return launches


def spec_chat(rt):
    """Three ``/v1/chat`` turns on one session with ``spec_k`` 4 through
    ``SeedXServer``: its decode state speculates, the prefix is reused."""
    import urllib.request
    from http.server import ThreadingHTTPServer

    from seedx_tpu_torch.inference.server import SeedXServer

    reset_counts()
    server = SeedXServer(rt, max_new_tokens=32)
    httpd = ThreadingHTTPServer(("127.0.0.1", 0), server.make_handler())
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    url = f"http://127.0.0.1:{httpd.server_address[1]}"
    replies, reused = [], []
    t0 = time.perf_counter()
    try:
        for msg in ("Summarize: " + GEN_DOC, "Repeat the first sentence.",
                    "And the second one?"):
            body = {"session": "spec", "message": msg, "max_new_tokens": 32,
                    "spec_k": GEN_K}
            req = urllib.request.Request(
                url + "/v1/chat", data=json.dumps(body).encode(),
                headers={"Content-Type": "application/json"})
            with urllib.request.urlopen(req, timeout=300) as r:
                replies.append((r.status, json.loads(r.read())))
            reused.append(server._sessions["spec"].last_reused)
        wall = time.perf_counter() - t0
        st = server._sessions["spec"]._decode
        rounds = [int(x) for x in st.sp[:2]]
    finally:
        httpd.shutdown()
        httpd.server_close()
        server.shutdown()
        thread.join(60)
    counts = path_counts("generation chat http spec_k 4")
    if (any(s_ != 200 or not isinstance(r.get("text"), str)
            for s_, r in replies) or st.spec_k != GEN_K
            or not all(reused[1:])
            or counts["decode_attn multi_query"] <= 0):
        raise AssertionError(f"/v1/chat spec_k: {replies} reused {reused}")
    log(f"generation chat http: 3 turns with spec_k {GEN_K} answered 200 in "
        f"{wall:.2f} s, reused {reused} cached tokens; the last turn "
        f"{rounds[0]} rounds, {rounds[1]} drafts accepted")
    return counts


def through_eos(tokens, tok):
    """A decoded row as a list, cut after its first EOS."""
    row = [int(x) for x in tokens]
    return (row[:row.index(tok.eos_token_id) + 1]
            if tok.eos_token_id in row else row)


def spec_unforced(rt, tag: str):
    """On the depth-cut agent: the greedy spec stream (k 1 / 4 / 8,
    captured) against the greedy plain stream, by the tie rule (the plain
    loop's own logits, recorded eagerly, give the gap where they part)."""
    import torch

    from seedx_tpu_torch.models import generation

    tok = rt.tokenizer
    prompt, _ = gen_prompt(tok)
    padded, mask = padded_prompt(prompt, rt.device)
    embeds = rt.agent.embed_ids(padded)
    last = torch.tensor([prompt[-1]], device=rt.device)

    def run(k):
        with torch.no_grad():
            return generation.generate_tokens(
                rt.agent, embeds, mask, last,
                dataclasses.replace(script_cfg(rt, k), max_new_tokens=64),
                tok.vocab, prompt_ids=padded)

    holder = {}
    base = generation.decode_step

    def step(model, st, *a, **kw):
        holder["st"] = st
        return base(model, st, *a, **kw)

    generation.decode_step = step
    try:
        with Teacher(rt, generation,
                     lambda call: ([0], holder["st"].n.view(1).clone())
                     ) as rec:
            plain = through_eos(run(0)["tokens"][0], tok)
    finally:
        generation.decode_step = base
    logits = rec.along(0, len(plain))
    reset_counts()
    for k in (1, 4, 8):
        out = run(k)
        gap = tie_check(f"{tag} spec k {k}",
                        through_eos(out["tokens"][0], tok), plain, logits,
                        enforce=True)
        log(f"{tag} spec k {k}: {int(out['spec_rounds'])} rounds, "
            f"{int(out['spec_accepted'])} accepted; "
            + ("the plain greedy stream" if gap is None
               else f"parts from it at a tie ({gap:g} bf16 steps)"))
    add_counts(CHECKS, path_counts(f"{tag} spec"))


def check_stair_verify(dev, g, flush, widths=(GEN_K + 1,)):
    """K3's stair at the verify round's shape: B 1, w = k + 1, the int8
    dense cache of a B 1 spec request (bucket + T + k positions), its
    window from the prompt's first position to the middle of decode."""
    import torch

    from seedx_tpu_torch.models.llama import quantize_kv
    from seedx_tpu_torch.ops import decode_attention as da
    from seedx_tpu_torch.text.tokenizer import load_tokenizer

    prompt, _ = gen_prompt(load_tokenizer())
    h, d = 40, 128
    rows = []
    for w in widths:
        s = GEN_BUCKET + GEN_T + w - 1
        q = torch.randn((1, w, h, d), generator=g,
                        device=dev).to(torch.bfloat16)
        (k, ks), (v, vs) = (quantize_kv(torch.randn(
            (1, s, h, d), generator=g, device=dev).to(torch.bfloat16))
            for _ in range(2))
        k, v = k.reshape(1, s, -1), v.reshape(1, s, -1)
        kw = dict(k_scale=ks[..., 0].contiguous(),
                  v_scale=vs[..., 0].contiguous())
        start, end = GEN_BUCKET - len(prompt), GEN_BUCKET + GEN_T // 2
        st = torch.tensor([start], dtype=torch.int32, device=dev)
        en = torch.tensor([end], dtype=torch.int32, device=dev)
        out = da.ragged_decode_attention(q, k, v, st, en, **kw)
        ref = da.ragged_decode_attention_plain(q, k, v, st, en, **kw)
        torch.cuda.synchronize()
        err = (out.float() - ref.float()).abs().max().item()
        mag = ref.float().abs().max().item()
        tol = 2e-2      # bf16 output of O(1), as for the other stair rows
        # the longest slot's window read once (codes + scales), q and out
        # once; the work is each slot's own window
        pos = end + w - 1 - start
        pairs = sum(end + i - start for i in range(w))
        n_bytes = 2 * q.numel() * 2 + 2 * pos * h * d + 2 * pos * h * 2 + 8
        r = row("decode_attn", f"stair_verify_int8_b1 B1 w{w} S{s} Hq{h} "
                f"Hkv{h} D{d} int8 window [{start}, {end}) positions "
                f"{pairs}", err <= tol, err,
                cuda_ms(lambda: da.ragged_decode_attention(
                    q, k, v, st, en, **kw), flush),
                cuda_ms(lambda: da.ragged_decode_attention_plain(
                    q, k, v, st, en, **kw), flush),
                bound(n_bytes, 4 * d * h * pairs, "int8"))
        log(fmt_row(r, f" max_rel_err {err / mag:.3e} tol {tol:g}"))
        rows.append(r)
    return rows


# ---------------------------------------------------------------------------
# Phase 12: load the release checkpoints
# ---------------------------------------------------------------------------

# the LLM dir and the agent checkpoint at full width, cut to this depth
# (each 40-layer artifact is ~26 GB, which the smoke's time cannot write)
LOAD_LAYERS = 4
LOAD_T2I_STEPS = 4
# the int8 ViT-bigG's features against the bf16 one's: max |int8 - bf16| /
# max |bf16|, and the RMS of the difference over the RMS of the features
# (the JAX package's tests/test_quantize.py holds the second to 5e-2)
VIT_INT8_REL = 0.1
VIT_INT8_RMS = 5e-2
ST_DTYPES = {"torch.bfloat16": "BF16", "torch.float32": "F32",
             "torch.float16": "F16", "torch.int8": "I8", "torch.uint8": "U8",
             "torch.int32": "I32", "torch.int64": "I64"}


def write_safetensors(path: str, sd) -> None:
    """The smoke's own ``.safetensors`` writer (the card's machine has no
    ``safetensors`` package): an 8-byte little-endian header length, the
    JSON header padded with spaces to 8 bytes, then each tensor's bytes
    in header order."""
    import struct

    import torch

    header, offset = {}, 0
    for k, t in sd.items():
        n = t.numel() * t.element_size()
        header[k] = {"dtype": ST_DTYPES[str(t.dtype)],
                     "shape": list(t.shape), "data_offsets": [offset,
                                                              offset + n]}
        offset += n
    raw = json.dumps(header).encode()
    raw += b" " * (-len(raw) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(raw)))
        f.write(raw)
        for t in sd.values():
            if t.numel():
                f.write(t.contiguous().reshape(-1).view(torch.uint8)
                        .numpy().data)


def release_state(name: str, gen, dev, num_layers=None, deltas=False):
    """{release key: host tensor} for the port's manifest ``name`` (its
    keys of layers below ``num_layers``; ``deltas``: the detokenizer's
    optional UNet to_k / to_v too, shaped from the UNet manifest), values
    drawn on the card from ``gen``, bf16 (the VAE fp32): norm scales
    1 + N(0, 0.1), biases N(0, 0.02), the rest N(0, s) with s = min(0.02,
    fan_in ** -0.5).  In PEFT's key order: a wrapped module's
    ``original_module`` copy before its ``modules_to_save`` one."""
    import math

    import torch

    from seedx_tpu_torch.utils.manifest import deeper_layer, load_manifest

    m = load_manifest(name)
    shapes = {k: s for k, s in m["keys"].items()
              if not deeper_layer(k, num_layers)}
    if deltas:
        unet = load_manifest("sdxl_unet")["keys"]
        shapes.update({k: unet[k[len("unet."):]] for k in m["optional"]
                       if k.startswith("unet.")})
    dtype = torch.float32 if name == "sdxl_vae" else torch.bfloat16
    out = {}
    for key in sorted(shapes, key=lambda k: "modules_to_save" in k):
        shape = shapes[key]
        t = torch.randn(shape, generator=gen, device=dev)
        if len(shape) == 1 and key.endswith("weight"):
            t = 1.0 + 0.1 * t
        elif key.endswith("bias"):
            t = 0.02 * t
        else:
            t = t * min(0.02, 1.0 / math.sqrt(max(1, math.prod(shape[1:]))))
        out[key] = t.to(dtype).cpu()
    return out


def state_bytes(sd) -> int:
    return sum(t.numel() * t.element_size() for t in sd.values())


class RssPeak:
    """While active: the process's peak resident memory from
    ``/proc/self/status`` (VmRSS, and RssAnon / RssFile where the kernel
    reports them), sampled every 20 ms on a thread, and ``getrusage``'s
    peak RSS, each as growth over its value at the start."""

    FIELDS = ("VmRSS", "RssAnon", "RssFile")

    def __enter__(self):
        import resource

        self.ru0 = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
        self.base = self.read()
        self.peak = dict(self.base)
        self.stop = threading.Event()
        self.thread = threading.Thread(target=self.sample, daemon=True)
        self.thread.start()
        return self

    @classmethod
    def read(cls):
        out = {}
        with open("/proc/self/status") as f:
            for line in f:
                k, _, v = line.partition(":")
                if k in cls.FIELDS:
                    out[k] = int(v.split()[0]) * 1024
        return out

    def sample(self):
        while not self.stop.wait(0.02):
            for k, v in self.read().items():
                self.peak[k] = max(self.peak.get(k, v), v)

    def __exit__(self, *exc):
        import resource

        self.stop.set()
        self.thread.join(timeout=5)
        self.ru_growth = (resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
                          - self.ru0) * 1024

    def line(self) -> str:
        names = {"VmRSS": "resident", "RssAnon": "anonymous",
                 "RssFile": "file-backed (mapped checkpoint pages)"}
        return (f"host peak RSS growth (getrusage) "
                f"{self.ru_growth / 2**30:.2f} GiB; sampled peaks: " + ", ".join(
                    f"{names[k]} +{(self.peak[k] - self.base[k]) / 2**30:.2f}"
                    f" GiB" for k in self.FIELDS if k in self.base))


def same_as_memory(module, converted, prefix: str = "") -> int:
    """Fail unless every leaf the converter gives (a ``LayerStack`` layer
    by layer) is bit-equal to ``module``'s loaded buffer, cast to its
    dtype on its device; a converted leaf the module holds quantized
    (absent from its state) is left to the quantizer checks.  Returns the
    leaves compared."""
    import torch

    from seedx_tpu_torch.utils.weights import LayerStack

    state = module.state_dict()
    n = 0
    for key, src in converted.items():
        dst = state.get(prefix + key)
        if dst is None:
            continue
        parts = ([(i, src.get(i)) for i in range(src.n)]
                 if isinstance(src, LayerStack) else [(None, src)])
        for i, part in parts:
            d = dst if i is None else dst[i]
            if not torch.equal(d, part.to(d.device).to(d.dtype)):
                raise AssertionError(
                    f"load: {prefix + key}{'' if i is None else [i]} "
                    f"differs from the in-memory conversion")
        n += 1
    return n


def check_k2_codes(agent, agent_sd, dev) -> int:
    """Fail unless the loaded int4 agent's K2 codes and group scales of
    every projection of every layer, and its int8 embedding and LM head,
    are byte-equal to the quantizers applied to the written bf16 weights
    (the agent checkpoint's, which the factory loads over the LLM dir's)."""
    import torch

    from seedx_tpu_torch.utils.quantize import (quantize_embedding,
                                                quantize_kernel,
                                                quantize_kernel_int4)

    state = agent.state_dict()
    base = "llm.base_model.model."
    n = 0
    for i in range(agent.cfg.llm.num_layers):
        for proj in ("q_proj", "k_proj", "v_proj", "o_proj", "gate_proj",
                     "up_proj", "down_proj"):
            sub = "mlp" if proj in ("gate_proj", "up_proj",
                                    "down_proj") else "self_attn"
            w = agent_sd[f"{base}model.layers.{i}.{sub}.{proj}.weight"]
            q, s = quantize_kernel_int4(w.to(dev).float().T)
            if not (torch.equal(state[f"llm.layers.{proj}.kernel_q4"][i], q)
                    and torch.equal(
                        state[f"llm.layers.{proj}.kernel_scale"][i], s)):
                raise AssertionError(f"load: K2 codes of layer {i} {proj} "
                                     f"differ from quantize_kernel_int4")
            n += 1
    q, s = quantize_embedding(
        agent_sd[f"{base}model.embed_tokens.weight"].to(dev))
    qh, sh = quantize_kernel(agent_sd[f"{base}lm_head.weight"].to(dev).T)
    if not (torch.equal(state["llm.embed_tokens.embedding_q"], q)
            and torch.equal(state["llm.embed_tokens.embedding_scale"], s)
            and torch.equal(state["llm.lm_head.kernel_q"], qh)
            and torch.equal(state["llm.lm_head.kernel_scale"], sh)):
        raise AssertionError("load: the int8 embedding / LM head differ "
                             "from their quantizers")
    return n


def write_release(root: str, mem) -> dict:
    """The ``from_pretrained`` layout under ``root``, through all four
    reader routes: the LLM dir as an HF shard dir (an index and 2
    safetensors shards), the UNet and VAE as diffusers single files, the
    ViT as a ``.pt`` pickle, the agent and the detokenizer as
    ``pytorch_model.bin``; each file synced to the disk.  Returns
    {artifact: (path, bytes, write s)}."""
    import os

    import torch

    sdxl = os.path.join(root, "stable-diffusion-xl-base-1.0")
    layout = {
        "qwen_vit": os.path.join(root, "QwenViT", "qwen_vit_G.pt"),
        "llm": os.path.join(root, "seed_x_i", "llm"),
        "agent": os.path.join(root, "seed_x_i", "agent",
                              "pytorch_model.bin"),
        "detokenizer": os.path.join(root, "seed_detokenizer", "first_stage",
                                    "pytorch_model.bin"),
        "sdxl_unet": os.path.join(sdxl, "unet"),
        "sdxl_vae": os.path.join(sdxl, "vae"),
    }
    out = {}
    for name, path in layout.items():
        sd = mem[name]
        t0 = time.perf_counter()
        if name == "llm":
            os.makedirs(path)
            keys, weight_map = list(sd), {}
            for j in range(2):
                shard = f"model-{j + 1:05d}-of-00002.safetensors"
                write_safetensors(os.path.join(path, shard),
                                  {k: sd[k] for k in keys[j::2]})
                weight_map.update({k: shard for k in keys[j::2]})
            with open(os.path.join(path, "model.safetensors.index.json"),
                      "w") as f:
                json.dump({"metadata": {"total_size": state_bytes(sd)},
                           "weight_map": weight_map}, f)
            files = [os.path.join(path, f) for f in os.listdir(path)]
        elif name.startswith("sdxl_"):
            os.makedirs(path)
            files = [os.path.join(path,
                                  "diffusion_pytorch_model.safetensors")]
            write_safetensors(files[0], sd)
        else:
            os.makedirs(os.path.dirname(path))
            torch.save(sd, path)
            files = [path]
        for f in files:
            with open(f, "rb+") as fh:
                os.fsync(fh.fileno())
        out[name] = (path, state_bytes(sd), time.perf_counter() - t0)
    return out


def run_load(dev, smi: str):
    """Phase 12: a synthetic release tree written to a temporary
    directory (the manifests' keys and shapes, random values drawn on the
    card; ViT-bigG at 48 layers, the SDXL base UNet and VAE whole, the
    13B's LLM dir and agent checkpoint at full width cut to LOAD_LAYERS
    layers), the runtime built from it through the port's factories with
    the manifest checks on (a broken artifact must raise with the diff),
    every loaded tensor held bit-equal to the in-memory conversion and the
    K2 codes to the quantizer, then the turn, text to image, the int8 ViT
    and UNet, and the int4 LLM's serving export read back."""
    import os
    import shutil
    import tempfile

    import torch
    from PIL import Image

    from seedx_tpu_torch.inference import apps
    from seedx_tpu_torch.inference.runtime import SeedXRuntime
    from seedx_tpu_torch.models.agent import ContinuousLVLM
    from seedx_tpu_torch.models.factory import (build_agent,
                                                build_llm_config,
                                                build_sdxl_adapter,
                                                build_visual_encoder)
    from seedx_tpu_torch.text.tokenizer import load_tokenizer
    from seedx_tpu_torch.train.checkpoints import restore_pytree
    from seedx_tpu_torch.utils import sdxl_weights as sw
    from seedx_tpu_torch.utils import weights as w
    from seedx_tpu_torch.utils.export import export_serving

    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    gen = torch.Generator(device=dev).manual_seed(5)
    t0 = time.perf_counter()
    mem = {"qwen_vit": release_state("qwen_vit", gen, dev),
           "llm": release_state("llm", gen, dev, num_layers=LOAD_LAYERS),
           "agent": release_state("agent", gen, dev, num_layers=LOAD_LAYERS),
           "detokenizer": release_state("detokenizer", gen, dev,
                                        deltas=True),
           "sdxl_unet": release_state("sdxl_unet", gen, dev),
           "sdxl_vae": release_state("sdxl_vae", gen, dev)}
    broken = dict(mem["sdxl_vae"])
    renamed = sorted(broken)[0]
    reshaped = sorted(broken)[1]
    broken[renamed + ".renamed"] = broken.pop(renamed)
    broken[reshaped] = broken[reshaped][:-1].clone()
    total = sum(state_bytes(sd) for sd in mem.values()) + state_bytes(broken)
    log(f"load: drew {total / 1e9:.2f} GB of release tensors on the card "
        f"in {time.perf_counter() - t0:.1f} s (" + ", ".join(
            f"{k} {state_bytes(v) / 1e9:.2f} GB" for k, v in mem.items())
        + f"; LLM dir and agent at {LOAD_LAYERS} of 40 layers)")

    tmp = tempfile.mkdtemp(prefix="seedx_release_")
    try:
        free = shutil.disk_usage(tmp).free
        log(f"load: {tmp}: {free / 1e9:.1f} GB free, {total / 1e9:.2f} GB "
            f"to write")
        if free < total + 2**30:
            raise AssertionError(f"load: not enough room in {tmp} for the "
                                 f"release tree ({free / 1e9:.1f} GB free, "
                                 f"{total / 1e9:.2f} GB needed)")
        root = os.path.join(tmp, "pretrained")
        written = write_release(root, mem)
        bad_dir = os.path.join(tmp, "broken_vae")
        os.makedirs(bad_dir)
        write_safetensors(os.path.join(
            bad_dir, "diffusion_pytorch_model.safetensors"), broken)
        for name, (path, n, secs) in written.items():
            t0 = time.perf_counter()
            sd = w.load_checkpoint_auto(path)
            read = time.perf_counter() - t0
            if sorted(sd) != sorted(mem[name]):
                raise AssertionError(f"load: {name} read back other keys")
            log(f"load: {name}: {n / 1e9:.3f} GB written in {secs:.2f} s "
                f"({n / 1e9 / secs:.2f} GB/s), read (mapped) in "
                f"{read:.3f} s, {len(sd)} tensors")
            del sd
        written_bytes = sum(n for _, n, _ in written.values())
        log(f"load: {written_bytes / 1e9:.2f} GB written in "
            f"{sum(s for _, _, s in written.values()):.1f} s ({smi})")

        try:
            build_sdxl_adapter(sdxl_vae_path=bad_dir, validate=True,
                               device=dev)
        except ValueError as e:
            msg = str(e)
            if not ("MANIFEST MISMATCH" in msg and renamed in msg
                    and reshaped in msg):
                raise AssertionError(f"load: the broken VAE raised without "
                                     f"its diff: {msg[:300]}") from e
            log("load: the broken VAE (one key renamed, one shape changed) "
                "raised: " + " | ".join(msg.splitlines()[:4]))
        else:
            raise AssertionError("load: the broken VAE artifact loaded")

        # the runtime from the files, as from_checkpoints assembles it
        vit_path = written["qwen_vit"][0]
        times = {}
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        mem0 = torch.cuda.memory_allocated()
        with RssPeak() as rss:
            t0 = time.perf_counter()
            vit = build_visual_encoder(vit_path, validate=True, device=dev)
            torch.cuda.synchronize()
            times["qwen_vit"] = time.perf_counter() - t0
            llm_cfg = build_llm_config(lora_rank=32, quantization="int4",
                                       kv_quantization="int8",
                                       num_layers=LOAD_LAYERS)
            t0 = time.perf_counter()
            agent = build_agent(llm_cfg, written["llm"][0],
                                written["agent"][0], validate=True,
                                device=dev)
            torch.cuda.synchronize()
            times["llm + agent"] = time.perf_counter() - t0
            t0 = time.perf_counter()
            adapter = build_sdxl_adapter(
                detokenizer_path=written["detokenizer"][0],
                sdxl_unet_path=written["sdxl_unet"][0],
                sdxl_vae_path=written["sdxl_vae"][0], visual_encoder=vit,
                validate=True, device=dev)
            torch.cuda.synchronize()
            times["detokenizer + unet + vae"] = time.perf_counter() - t0
        build = sum(times.values())
        size = {"qwen_vit": written["qwen_vit"][1],
                "llm + agent": written["llm"][1] + written["agent"][1],
                "detokenizer + unet + vae": sum(
                    written[k][1] for k in ("detokenizer", "sdxl_unet",
                                            "sdxl_vae"))}
        log("load: built from the files (read + convert + quantize + copy "
            "to the card): " + ", ".join(
                f"{k} {times[k]:.2f} s ({size[k] / 1e9 / times[k]:.2f} GB/s)"
                for k in times) + f"; all {build:.2f} s, "
            f"{written_bytes / 1e9 / build:.2f} GB/s")
        log(f"load: {rss.line()}; device max_memory_allocated "
            f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB "
            f"(+{(torch.cuda.memory_allocated() - mem0) / 2**30:.2f} GiB "
            f"held) ({smi})")

        # every loaded tensor against the converters on the tensors in
        # memory, no files involved; the K2 codes against the quantizer
        t0 = time.perf_counter()
        n = same_as_memory(vit, w.convert_qwen_vit(
            mem["qwen_vit"], num_layers=vit.cfg.layers,
            num_heads=vit.cfg.heads))
        parts = w.convert_agent_checkpoint(mem["agent"])
        llm_sd = parts.pop("llm_state_dict")
        n += same_as_memory(agent, parts)
        n += same_as_memory(agent, w.convert_llama_hf(
            llm_sd, num_layers=LOAD_LAYERS), prefix="llm.")
        n_k2 = check_k2_codes(agent, mem["agent"], dev)
        unet = sw.convert_sdxl_unet(mem["sdxl_unet"])
        deltas = sw.convert_sdxl_unet_deltas(
            {k[len("unet."):]: v for k, v in mem["detokenizer"].items()
             if k.startswith("unet.")})
        if deltas["skipped"] or not deltas["deltas"]:
            raise AssertionError("load: the detokenizer's UNet deltas")
        unet.update(deltas["deltas"])
        n += same_as_memory(adapter.unet, unet)
        n += same_as_memory(adapter.resampler,
                            w.convert_detokenizer_resampler(
                                mem["detokenizer"],
                                depth=adapter.cfg.resampler.depth))
        vae = sw.convert_sdxl_vae(mem["sdxl_vae"])
        n += same_as_memory(adapter.vae_encoder, vae["encoder"])
        n += same_as_memory(adapter.vae_decoder, vae["decoder"])
        log(f"load: {n} loaded leaves bit-equal to the in-memory "
            f"conversion (the UNet with the detokenizer's "
            f"{len(deltas['deltas'])} to_k / to_v deltas); the K2 codes and "
            f"scales of {n_k2} projections ({LOAD_LAYERS} layers x 7) and "
            f"the int8 embedding / LM head byte-equal to the quantizers, in "
            f"{time.perf_counter() - t0:.1f} s")
        del mem, parts, llm_sd, unet, vae
        gc.collect()

        rt = SeedXRuntime(tokenizer=load_tokenizer(), vit_cfg=vit.cfg,
                          vit=vit, agent_cfg=agent.cfg, agent=agent,
                          adapter=adapter)
        launches = run_turn(rt, "load turn")
        agent_k = ("flash_fwd", "int4_w4a8", "decode_attn")
        watch = UNetWatch(adapter)
        with forced_image_prompts():
            out, counts = timed_run("load text_to_image", lambda: (
                apps.text_to_image(rt, "a red bicycle by a lake", seed=0,
                                   num_inference_steps=LOAD_T2I_STEPS,
                                   max_new_tokens=72)), agent_k)
        add_counts(launches, counts)
        watch.check("load text_to_image", LOAD_T2I_STEPS, out["images"])
        if out["images"].shape != (1, 1024, 1024, 3):
            raise AssertionError(f"load text_to_image: images "
                                 f"{out['images'].shape}")
        feat = out["img_gen_feat"]

        # the int8 ViT (quantize_vit) against the bf16 one
        rng = np.random.default_rng(12)
        img = Image.fromarray((rng.random((448, 672, 3)) * 255
                               ).astype(np.uint8))
        ref, _ = rt.encode_image_anyres(img)
        rt.quantize_vit()
        if adapter.visual_encoder is not rt.vit:
            raise AssertionError("load: quantize_vit left the adapter on "
                                 "the bf16 ViT")
        (q8, _), counts = timed_run("load int8 ViT",
                                    lambda: rt.encode_image_anyres(img))
        add_counts(launches, counts)
        ref, q8 = ref.float(), q8.float()
        rel = ((q8 - ref).abs().max() / ref.abs().max()).item()
        rms = ((q8 - ref).square().mean().sqrt()
               / ref.square().mean().sqrt()).item()
        log(f"load: int8 ViT-bigG features {tuple(q8.shape)} against bf16: "
            f"max rel err {rel:.3e} (bound {VIT_INT8_REL}), RMS rel "
            f"{rms:.3e} (bound {VIT_INT8_RMS})")
        if not (torch.isfinite(q8).all() and rel <= VIT_INT8_REL
                and rms <= VIT_INT8_RMS):
            raise AssertionError("load: the int8 ViT is off its bound")

        # one step of the int8 UNet
        adapter.quantize_unet()
        watch = UNetWatch(adapter)
        images, counts = timed_run("load int8 UNet", lambda: (
            adapter.generate(feat, seed=0, num_inference_steps=1)))
        add_counts(launches, counts)
        watch.check("load int8 UNet", 1, images)

        # the int4 LLM's serving artifact, read into a fresh int4 agent
        path = os.path.join(tmp, "llm_int4.pt")
        t0 = time.perf_counter()
        export_serving(agent.llm.state_dict(), path, "llama", mode="int4")
        t_export = time.perf_counter() - t0
        t0 = time.perf_counter()
        fresh = ContinuousLVLM(agent.cfg, dev).eval()
        restore_pytree(path, fresh.llm)
        torch.cuda.synchronize()
        t_restore = time.perf_counter() - t0
        fresh.load_state_dict({k: v for k, v in agent.state_dict().items()
                               if not k.startswith("llm.")}, strict=False)
        mine, theirs = fresh.state_dict(), agent.state_dict()
        if not all(torch.equal(v, theirs[k]) for k, v in mine.items()):
            raise AssertionError("load: the restored int4 agent differs")
        rt2 = SeedXRuntime(tokenizer=rt.tokenizer, vit_cfg=rt.vit_cfg,
                           vit=rt.vit, agent_cfg=fresh.cfg, agent=fresh)
        reset_counts()
        a = apps.comprehend(rt, img, "Describe the image.",
                            max_new_tokens=16)["tokens"]
        b = apps.comprehend(rt2, img, "Describe the image.",
                            max_new_tokens=16)["tokens"]
        add_counts(CHECKS, read_counts())
        if list(a) != list(b):
            raise AssertionError("load: the restored agent's tokens differ")
        log(f"load: export_serving int4 LLM {os.path.getsize(path) / 1e9:.3f}"
            f" GB in {t_export:.2f} s; cold start of the agent from the "
            f"release files {times['llm + agent']:.2f} s against "
            f"{t_restore:.2f} s from the export (restore_pytree into a "
            f"fresh int4 agent); codes bit-equal, the same {len(a)} greedy "
            f"tokens on a comprehend request ({smi})")
        del rt, rt2, fresh, agent, adapter, vit
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()
    log(f"load phase: {time.perf_counter() - t_phase:.1f} s")
    return launches


# ---- phase: sharded --------------------------------------------------------

def resident_bytes(*modules) -> int:
    """Bytes of the weights the modules hold on this rank."""
    return sum(t.numel() * t.element_size() for m in modules
               for t in itertools.chain(m.buffers(), m.parameters()))


def start_one_rank_group() -> None:
    """A one-rank NCCL group under torchrun's environment, on a free
    localhost port (``parallel.distributed.maybe_initialize``)."""
    import socket

    from seedx_tpu_torch.parallel.distributed import maybe_initialize

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    os.environ.update(RANK="0", WORLD_SIZE="1", LOCAL_RANK="0",
                      MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
    if not maybe_initialize("cuda"):
        raise AssertionError("maybe_initialize started no group")


def sharded_pass(rt, label: str):
    """The turn's comprehend request and the dense engine (8 slots, the 16
    serving requests, captured) on ``rt``: (turn tokens, image embeds,
    engine streams, decode ms a step, launches)."""
    import torch

    from seedx_tpu_torch.inference import continuous
    from seedx_tpu_torch.inference.apps import comprehend

    images, _, _, requests, budgets = serving_inputs(rt)
    timed = [0.0, 0]
    base_chunk = continuous.run_chunk

    def timed_chunk(program, state, k, *a):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        n = base_chunk(program, state, k, *a)
        timed[0] += time.perf_counter() - t1
        timed[1] += n
        return n

    reset_counts()
    turn = comprehend(rt, images[1], "Describe the image.", max_new_tokens=32)
    continuous.run_chunk = timed_chunk
    try:
        eng = continuous.ContinuousEngine(rt, **ENGINE)
        ids = [eng.submit(r, max_new_tokens=b)
               for r, b in zip(requests, budgets)]
        res = eng.run()
        torch.cuda.synchronize()
    finally:
        continuous.run_chunk = base_chunk
    streams = [list(res[i]["tokens"]) for i in ids]
    for s_, b in zip(streams, budgets):
        check_tokens(s_, rt.agent_cfg.llm.vocab_size, b)
    counts = path_counts(label)
    embeds = [r["image_embeds"] for r in requests if "image_embeds" in r]
    del eng
    return (list(turn["tokens"]), embeds, streams,
            timed[0] / max(timed[1], 1) * 1e3, counts)


def check_ia3_k2(dev, g) -> None:
    """IA3 through K2 at full width: one int4 layer's down_proj (input
    scaled before the row quantization) and k / v_proj (output scaled)
    with random scales, K2 against its plain version, at K2's limit."""
    import torch

    from seedx_tpu_torch.models import layers
    from seedx_tpu_torch.ops import int4_matmul as i4
    from seedx_tpu_torch.utils.quantize import quantize_kernel_int4

    def plain_auto(x, packed, scale, *a):
        return i4.int4_matmul_plain(x.reshape(-1, x.shape[-1]), packed,
                                    scale, *a).reshape(*x.shape[:-1], -1)

    for name, n_in, n_out, ia3 in (("down_proj", 13824, 5120, "in"),
                                   ("k_proj", 5120, 5120, "out"),
                                   ("v_proj", 5120, 5120, "out")):
        d = layers.LoRADense(n_in, n_out, quantize="int4", ia3=ia3, layers=1,
                             device=dev)
        with torch.no_grad():
            w = torch.randn((n_in, n_out), generator=g, device=dev)
            d.kernel_q4[0], d.kernel_scale[0] = quantize_kernel_int4(
                w * n_in ** -0.5)
            d.ia3_scale[0] = (1.0 + 0.5 * torch.randn(
                d.ia3_scale.shape[1:], generator=g, device=dev)).to(
                    d.ia3_scale.dtype)
        for rows in (8, 64):
            x = torch.randn((rows, n_in), generator=g, device=dev).to(
                torch.bfloat16)
            reset_counts()
            with torch.no_grad():
                out = d(x, 0)
            torch.cuda.synchronize()
            n_k2 = counters()["int4_w4a8"]
            add_counts(CHECKS, read_counts())
            base = layers.int4_matmul_auto
            layers.int4_matmul_auto = plain_auto
            try:
                with torch.no_grad():
                    ref = d(x, 0)
            finally:
                layers.int4_matmul_auto = base
            err = (out.float() - ref.float()).abs().max().item()
            mag = ref.float().abs().max().item()
            tol = 2 * 2 ** -7 * mag
            log(f"sharded: IA3 {ia3} {name} {n_in}->{n_out} rows {rows}: K2 "
                f"launches {n_k2}, max_abs_err {err:.3e} tol {tol:.3e}")
            if n_k2 <= 0 or not err <= tol:
                raise AssertionError(f"IA3 through K2 ({name}, rows {rows}): "
                                     f"launches {n_k2}, err {err} > {tol}")


def check_seq_cls(dev, g) -> None:
    """LlamaForSequenceClassification at full width (2 layers, bf16), a
    right-padded batch of 4: each layer's attention through K1 held to
    its plain version on the same inputs at K1's limit (2e-2 of the output
    scale, at most 2e-2), and the logits finite."""
    import torch

    from seedx_tpu_torch.models import llama as llama_mod
    from seedx_tpu_torch.models.layers import init_normal_
    from seedx_tpu_torch.models.llama import (LlamaForSequenceClassification,
                                              llama2_13b)

    cfg = llama2_13b(num_layers=2)
    model = init_normal_(LlamaForSequenceClassification(cfg, 3, dev).eval(),
                         g)
    s, lengths = 160, (160, 127, 64, 33)
    ids = torch.randint(0, cfg.vocab_size, (4, s), generator=g, device=dev)
    mask = torch.arange(s, device=dev)[None] < torch.tensor(
        lengths, device=dev)[:, None]
    real = llama_mod.dot_product_attention
    errs = []

    def held(q, k, v, **kw):
        out = real(q, k, v, **kw)
        ref = real(q, k, v, **dict(kw, impl="plain"))
        live = mask[:, :, None, None]       # pad queries attend nothing real
        err = ((out.float() - ref.float()) * live).abs().max().item()
        errs.append((err, 2e-2 * min(1.0, (ref.float() * live).abs().max()
                                     .item())))
        return out

    reset_counts()
    llama_mod.dot_product_attention = held
    try:
        with torch.no_grad():
            out = model(ids, mask)
    finally:
        llama_mod.dot_product_attention = real
    torch.cuda.synchronize()
    n_k1 = counters()["flash_fwd"]
    add_counts(CHECKS, read_counts())
    log(f"sharded: sequence classification 2 x 5120 wide, B4 right-padded "
        f"{lengths} at S {s}: logits {tuple(out.shape)}, K1 launches {n_k1}; "
        f"each layer's K1 against its plain version: " + ", ".join(
            f"max_abs_err {e:.3e} (tol {t:.3e})" for e, t in errs))
    if out.shape != (4, 3) or not torch.isfinite(out.float()).all() \
            or n_k1 != cfg.num_layers or len(errs) != cfg.num_layers \
            or not all(e <= t for e, t in errs):
        raise AssertionError(f"sequence classification: launches {n_k1}, "
                             f"errors {errs}")


# two ranks on the one card: gloo carries the collectives on CUDA tensors
# (NCCL refuses two ranks on one device)
TWO_RANK_LAYOUTS = ((1, 1, 2), (1, 2, 1))
TWO_RANK_TOKENS = 24


def uncached_logits(rt, ids):
    """fp32 logits [S, V] of one uncached forward over ``ids``."""
    import torch

    dev = rt.device
    x = torch.tensor([ids], device=dev)
    pos = torch.arange(len(ids), device=dev)[None]
    with torch.no_grad():
        return rt.agent.llm(rt.agent.embed_ids(x), pos)[0][0].float()


def cached_logits(rt, ids, p: int):
    """fp32 logits [S - p + 1, V] at positions p - 1 .. S - 1: the
    prompt's prefill, then one cached decode step a token, teacher-forced."""
    import torch

    from seedx_tpu_torch.models.llama import init_kv_cache

    llm, dev, s = rt.agent.llm, rt.device, len(ids)
    x = rt.agent.embed_ids(torch.tensor([ids], device=dev))
    cache = init_kv_cache(llm.cfg, 1, s, device=dev, kv_heads=llm.kv_heads)
    valid = torch.zeros((1, s), dtype=torch.bool, device=dev)
    valid[:, :p] = True
    pos = torch.arange(s, device=dev)[None]
    out = []
    with torch.no_grad():
        lg, _, _ = llm(x[:, :p], pos[:, :p], valid, cache, 0)
        out.append(lg[0, -1].float())
        for t in range(p, s):
            valid[:, t] = True
            lg, _, _ = llm(x[:, t:t + 1], pos[:, t:t + 1], valid, cache, t)
            out.append(lg[0, -1].float())
    return torch.stack(out)


def two_rank_worker(rank: int, root: str, layout) -> None:
    """One of two ranks on the card (``--two-rank``): the 2-layer full-width
    runtime (seed 0, so both ranks hold the same weights), its unsharded
    greedy stream, logits and noise floor, then the same on the mesh
    ``layout``; rank 0 writes the results to ``root``."""
    import torch
    import torch.distributed as dist

    from seedx_tpu_torch.inference.apps import _prepare_image_prompt
    from seedx_tpu_torch.models import vit as vit_mod
    from seedx_tpu_torch.ops import int4_matmul as i4
    from seedx_tpu_torch.parallel import create_mesh
    from PIL import Image

    torch.cuda.set_device(0)
    dev = torch.device("cuda", 0)
    dist.init_process_group("gloo", store=dist.FileStore(
        os.path.join(root, "store"), 2), rank=rank, world_size=2)
    rt = build_runtime(dev, PARITY_LAYERS)
    tok = rt.tokenizer
    prompt = [tok.bos_token_id] + tok.encode(
        "[INST] Write a short poem about the sea. [/INST]\n")
    p = len(prompt)
    res = {"layout": list(layout)}
    reset_counts()
    rt.graphs.enabled = False          # the mesh runs eagerly under gloo
    want = [int(t) for t in rt.generate(
        prompt, max_new_tokens=TWO_RANK_TOKENS)["tokens"]]
    ids = prompt + want[:-1]
    ref = uncached_logits(rt, ids)[p - 1:]
    floor = (ref - cached_logits(rt, ids, p)).abs().max().item()
    img = Image.fromarray((np.random.default_rng(5).random((448, 896, 3))
                           * 255).astype(np.uint8))
    _, _, emb_ref, _, _ = _prepare_image_prompt(rt, img, "Describe.")
    real_attn = vit_mod.dot_product_attention
    vit_mod.dot_product_attention = (
        lambda q, k, v, **kw: real_attn(q, k, v, **dict(kw, impl="plain")))
    try:
        _, _, emb_plain, _, _ = _prepare_image_prompt(rt, img, "Describe.")
    finally:
        vit_mod.dot_product_attention = real_attn
    vit_floor = (emb_ref.float() - emb_plain.float()).abs().max().item()

    res["weight_bytes_full"] = resident_bytes(rt.vit, rt.agent)
    mesh = create_mesh(*layout, device_type="cuda")
    rt.shard(mesh)
    got = [int(t) for t in rt.generate(
        prompt, max_new_tokens=TWO_RANK_TOKENS)["tokens"]]
    sharded = uncached_logits(rt, ids)[p - 1:]
    _, _, emb_sh, _, _ = _prepare_image_prompt(rt, img, "Describe.")
    res.update(want=want, got=got, floor=floor,
               err=(sharded - ref).abs().max().item(),
               scale=ref.abs().max().item(), vit_floor=vit_floor,
               vit_err=(emb_sh.float() - emb_ref.float()).abs().max().item(),
               roles={n: rt.agent.llm.layers.get_submodule(n).tp for n in
                      ("q_proj", "o_proj", "gate_proj", "down_proj")},
               weight_bytes=resident_bytes(rt.vit, rt.agent))
    if layout[2] == 2:
        # the row-parallel K2: this rank's half of down_proj's rows,
        # quantized against the whole row's absmax, summed over the ranks,
        # against plain K2 on the unsharded layer
        g = torch.Generator(device=dev)
        g.manual_seed(9)
        n_in, n_out = 13824, 5120
        w = torch.randn((n_in, n_out), generator=g, device=dev) * n_in ** -.5
        from seedx_tpu_torch.utils.quantize import quantize_kernel_int4

        packed, scale = quantize_kernel_int4(w)
        x = torch.randn((8, n_in), generator=g, device=dev).to(torch.bfloat16)
        half, gh = n_in // 2, n_in // 2 // 128
        amax = i4.row_absmax(x[:, rank * half:(rank + 1) * half])
        dist.all_reduce(amax, op=dist.ReduceOp.MAX)
        part = i4.int4_matmul(
            x[:, rank * half:(rank + 1) * half].contiguous(),
            packed[rank * half // 2:(rank + 1) * half // 2].contiguous(),
            scale[rank * gh:(rank + 1) * gh].contiguous(), amax).float()
        dist.all_reduce(part)
        full = i4.int4_matmul_plain(x, packed, scale).float()
        res.update(k2_err=(part - full).abs().max().item(),
                   k2_tol=2 * 2 ** -7 * full.abs().max().item())
    torch.cuda.synchronize()
    res["counts"] = read_counts()
    if rank == 0:
        # teacher-forced along the unsharded stream: the tie rule's logits
        res["gap"] = tie_check(f"two ranks {layout}", got, want, sharded,
                               enforce=False)
        with open(os.path.join(root, "result.json"), "w") as f:
            json.dump(res, f)
    dist.destroy_process_group()


def run_two_ranks(smi: str) -> None:
    """(b) Two ranks on the one card over gloo, tensor 2 then fsdp 2, at
    full width cut to PARITY_LAYERS layers, eager: the mesh's
    teacher-forced logits within LOGIT_FACTOR times the noise floor (the
    unsharded prefill + cached decode against its uncached forward), its
    greedy stream by the tie rule, the ViT's features within LOGIT_FACTOR
    times K1's own (kernel against plain attention), and (tensor 2) the
    row-parallel K2 with the whole-row scale against plain K2.  Each run
    is two processes of this script, killed past their time limit."""
    import tempfile

    for layout in TWO_RANK_LAYOUTS:
        t0 = time.perf_counter()
        root = tempfile.mkdtemp(prefix="two_rank_")
        procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__),
                                   "--two-rank", str(r), root,
                                   ",".join(map(str, layout))])
                 for r in range(2)]
        try:
            for proc in procs:
                proc.wait(timeout=300)
        finally:
            for proc in procs:
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
        if any(proc.returncode for proc in procs):
            raise AssertionError(f"two ranks {layout}: exit codes "
                                 f"{[proc.returncode for proc in procs]}")
        with open(os.path.join(root, "result.json")) as f:
            res = json.load(f)
        add_counts(CHECKS, res["counts"])
        log(f"sharded: two ranks on the card, mesh {layout} (gloo, eager, "
            f"{PARITY_LAYERS} layers), {smi}: roles {res['roles']}; weights "
            f"a rank {res['weight_bytes']} bytes (unsharded "
            f"{res['weight_bytes_full']}); teacher-forced logits "
            f"max_abs_err {res['err']:.4g} vs the unsharded (noise floor "
            f"{res['floor']:.4g}, limit {LOGIT_FACTOR} x; logit scale "
            f"{res['scale']:.4g}); ViT features max_abs_err "
            f"{res['vit_err']:.4g} (K1-vs-plain {res['vit_floor']:.4g}); "
            f"greedy {TWO_RANK_TOKENS} tokens "
            + ("equal" if res["gap"] is None
               else f"part, gap {res['gap']} bf16 steps")
            + (f"; row-parallel K2 (whole-row scale) against plain K2 "
               f"max_abs_err {res['k2_err']:.4g} tol {res['k2_tol']:.4g}"
               if "k2_err" in res else "")
            + f"; {time.perf_counter() - t0:.1f} s")
        bad = [not res["err"] <= LOGIT_FACTOR * max(res["floor"], 1e-30),
               not res["vit_err"] <= LOGIT_FACTOR * res["vit_floor"],
               res["gap"] is not None and not res["gap"] <= TIE_ULPS,
               "k2_err" in res and not res["k2_err"] <= res["k2_tol"]]
        if any(bad):
            raise AssertionError(f"two ranks {layout}: checks failed "
                                 f"(logits, vit, tie, k2) {bad}: {res}")


def run_sharded(rt, dev, smi: str):
    """The sharded phase: (a) the full-width runtime placed on a one-rank
    NCCL mesh (``SeedXRuntime.shard``) serves the turn's request and the
    8-slot dense engine with captured programs, tokens bit-equal to the
    unsharded runtime (one-rank collectives are the identity); (c) IA3
    through K2; (d) sequence classification through K1."""
    import torch
    import torch.distributed as dist

    from seedx_tpu_torch.parallel import create_mesh
    from seedx_tpu_torch.parallel.distributed import COLLECTIVES

    t0 = time.perf_counter()
    before = resident_bytes(rt.vit, rt.agent)
    ref = sharded_pass(rt, "sharded: unsharded reference")
    add_counts(CHECKS, ref[4])
    start_one_rank_group()
    mesh = create_mesh(1, 1, 1)
    rt.shard(mesh)
    after = resident_bytes(rt.vit, rt.agent)
    got = sharded_pass(rt, "sharded (1 x 1 x 1 NCCL mesh)")
    names = ("turn tokens", "image embeds", "engine streams")
    same = [ref[0] == got[0],
            all(torch.equal(a, b) for a, b in zip(ref[1], got[1])),
            ref[2] == got[2]]
    log(f"sharded: {smi}: mesh {dict(zip(mesh.mesh_dim_names, mesh.shape))} "
        f"({dist.get_backend()}); resident weights a rank {after} bytes "
        f"(unsharded {before}); dense engine B8 decode "
        f"{got[3]:.2f} ms/step sharded vs {ref[3]:.2f} unsharded; "
        f"bit-equal: {dict(zip(names, same))}")
    if not all(same) or after != before:
        raise AssertionError(f"sharded run differs from the unsharded one: "
                             f"{dict(zip(names, same))}, bytes {after} vs "
                             f"{before}")
    for k in COLLECTIVES:
        COLLECTIVES[k] = 0
    x = rt.agent.embed_ids(torch.zeros((1, 1), dtype=torch.long,
                                       device=dev))
    with torch.no_grad():
        rt.agent.llm(x, torch.zeros((1, 1), dtype=torch.long, device=dev))
    log(f"sharded: collectives a one-token forward (host calls): "
        f"{json.dumps(COLLECTIVES)}")
    dist.destroy_process_group()
    for var in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR",
                "MASTER_PORT"):
        os.environ.pop(var, None)
    run_two_ranks(smi)
    run_two_rank_image(smi)
    g = torch.Generator(device=dev)
    g.manual_seed(15)
    check_ia3_k2(dev, g)
    check_seq_cls(dev, g)
    log(f"sharded phase: {time.perf_counter() - t0:.1f} s")
    return got[4]


# ---- the split denoise and training on a mesh ------------------------------

# the split denoise's collectives a CFG UNet eval at SDXL base width: one
# halo a 3x3 conv, one all-reduce a GroupNorm, one K / V gather a
# self-attention, then the rows (tensor) and the branches (data)
SPLIT_EVAL_COLLECTIVES = {"halo": 40, "all_reduce": 46, "all_gather": 72}
SPLIT2_SIZE, SPLIT2_STEPS = 512, 4   # the two-rank (gloo) denoise
# the split bf16 images' distance to the fp32 UNet's at most this many
# times the unsharded bf16 images' (a CFG of 7.5 over 4 steps lifts bf16
# rounding to ~2e-2 either way: JAX's own 2e-2, tests/test_sharding.py,
# is fp32's)
SPLIT2_FACTOR = 2.0
MESH_TRAIN_LAYOUTS = (("fsdp 2", (1, 2, 1)), ("tensor 2", (1, 1, 2)))
MESH_LOSS_REL, MESH_NORM_REL = 1e-2, 2e-2
MESH_UPDATE_REL = 5e-2


def split_eval(adapter, dev, g):
    """A CFG-2 eval of ``adapter``'s UNet on random inputs (a CFGEval):
    (eval, its call)."""
    import torch

    from seedx_tpu_torch.models.sdxl.pipeline import CFGEval
    from seedx_tpu_torch.utils.graphs import Graphs

    lat, _, ctx, pooled, tids = unet_inputs(adapter, 2, dev, g)
    lat = lat[:1, ..., :4].contiguous()
    sigma = torch.tensor(7.0, device=dev)
    t = torch.tensor(501.0, device=dev)

    def make(graphs):
        ev = CFGEval(adapter.unet, lat, ctx, pooled, tids, None, 7.5, 1.5,
                     0.0, graphs)
        ev.set_conditioning(ctx, pooled, tids, None)
        return ev, lambda: ev(lat, sigma, t)

    return make(Graphs(enabled=True)), make(None)



def eval_collectives(call) -> dict:
    """The host's collectives (``COLLECTIVES``) of one eager call."""
    import torch

    from seedx_tpu_torch.parallel.distributed import COLLECTIVES

    before = dict(COLLECTIVES)
    with torch.no_grad():
        call()
    torch.cuda.synchronize()
    return {k: COLLECTIVES[k] - before[k] for k in COLLECTIVES}


def run_split_image(rt, dev, smi: str):
    """Phase 8b: the split denoise at full width on a one-rank NCCL mesh.
    The SDXL base adapter (sharing the runtime's ViT-bigG for its CFG
    negative) generates from one set of agent features at 1024^2, Euler
    ``T2I_STEPS``, CFG 2, captured: unsplit, then ``SDXLAdapter.shard``
    on a one-rank mesh (CFG branches over data, latent rows over tensor,
    every collective a one-rank NCCL call inside the captured eval); the
    images must be bit-equal.  Logs the collectives of one eager split
    eval by kind against ``SPLIT_EVAL_COLLECTIVES``, the wall ms of a
    captured eval split and unsplit, K1 launches an eval.  Returns the
    split run's launches (the unsplit twin's go to CHECKS)."""
    import torch
    import torch.distributed as dist

    from seedx_tpu_torch.models.sdxl.unet import flash_launches_per_eval
    from seedx_tpu_torch.parallel import create_mesh

    t0 = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    base = build_adapter(dev, rt.vit, edit=False)
    g = torch.Generator(device=dev).manual_seed(61)
    embeds = torch.randn((1, 64, 4096), generator=g, device=dev).to(
        torch.bfloat16)
    runs, ms = {}, {}
    for mode in ("unsplit", "split"):
        if mode == "split":
            start_one_rank_group()
            base.shard(create_mesh(1, 1, 1))
            (_, _), (_, eager) = split_eval(base, dev, g)
            per_eval = eval_collectives(eager)
        (ev, call), _ = split_eval(base, dev, g)
        reset_counts()
        with torch.no_grad():
            call()                       # the warm run and the capture
            ms[mode] = wall_ms(call)
        add_counts(CHECKS, read_counts())
        del ev, call
        watch = UNetWatch(base)
        timings = {}
        images, counts = timed_run(f"split image: {mode}", lambda: (
            base.generate(embeds, seed=0, num_inference_steps=T2I_STEPS,
                          timings=timings)))
        watch.check(f"split image: {mode}", T2I_STEPS, images)
        runs[mode] = (images, counts, timings["denoise"] * 1e3 / T2I_STEPS)
    same = np.array_equal(runs["unsplit"][0], runs["split"][0])
    k1 = flash_launches_per_eval(base.cfg.unet)      # UNetWatch held it
    log(f"split image: SDXL base 1024^2, Euler {T2I_STEPS}, CFG 2, "
        f"captured, one-rank NCCL mesh ({smi}): collectives of one eager "
        f"split eval (host calls) {json.dumps(per_eval)} (predicted "
        f"{json.dumps(SPLIT_EVAL_COLLECTIVES)}); a captured eval "
        f"{ms['split']:.2f} ms split vs {ms['unsplit']:.2f} ms unsplit "
        f"(wall, +{ms['split'] - ms['unsplit']:.2f} ms); denoise "
        f"{runs['split'][2]:.1f} vs {runs['unsplit'][2]:.1f} ms a step "
        f"(host); K1 {k1} launches an eval; images bit-equal: {same}")
    add_counts(CHECKS, runs["unsplit"][1])
    dist.destroy_process_group()
    for var in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR",
                "MASTER_PORT"):
        os.environ.pop(var, None)
    bad = {k: v for k, v in SPLIT_EVAL_COLLECTIVES.items()
           if per_eval[k] != v}
    if not same or bad:
        raise AssertionError(f"split image: images bit-equal {same}, "
                             f"collectives off the prediction {bad}")
    del base
    gc.collect()
    torch.cuda.empty_cache()
    log(f"split image phase: {time.perf_counter() - t0:.1f} s")
    return runs["split"][1]


def rank_pair(mode: str, layout, timeout: int = 300) -> dict:
    """Two processes of this script (``mode`` RANK ROOT LAYOUT), killed past
    ``timeout``; rank 0's ``result.json``."""
    import tempfile

    root = tempfile.mkdtemp(prefix="rank_pair_")
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__),
                               mode, str(r), root,
                               ",".join(map(str, layout))])
             for r in range(2)]
    try:
        for proc in procs:
            proc.wait(timeout=timeout)
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    if any(proc.returncode for proc in procs):
        raise AssertionError(f"{mode} {layout}: exit codes "
                             f"{[proc.returncode for proc in procs]}")
    with open(os.path.join(root, "result.json")) as f:
        return json.load(f)


def gloo_pair(root: str, rank: int):
    """This process's gloo group of two on the card (NCCL refuses two
    ranks on one device)."""
    import torch
    import torch.distributed as dist

    torch.cuda.set_device(0)
    dist.init_process_group("gloo", store=dist.FileStore(
        os.path.join(root, "store"), 2), rank=rank, world_size=2)
    return torch.device("cuda", 0)


def two_rank_image_worker(rank: int, root: str, layout) -> None:
    """One of two ranks (``--two-rank-image``): the 8-channel SDXL edit
    adapter at full width (seed 0) at ``SPLIT2_SIZE``^2, Euler
    ``SPLIT2_STEPS``, eager; text to image (zeros for the condition) and
    edit, unsharded, with the plain attention (the noise floor), then
    split on the mesh ``layout``; rank 0 writes the results."""
    import torch
    import torch.distributed as dist

    from seedx_tpu_torch.models.adapter import AdapterConfig, SDXLAdapter
    from seedx_tpu_torch.models.detokenizer import DetokenizerConfig
    from seedx_tpu_torch.models.sdxl.pipeline import SamplerConfig
    from seedx_tpu_torch.models.sdxl.unet import (UNet2DCondition,
                                                  sdxl_edit_unet)
    from seedx_tpu_torch.parallel import create_mesh
    from seedx_tpu_torch.parallel.distributed import COLLECTIVES

    dev = gloo_pair(root, rank)
    cfg = AdapterConfig(unet=sdxl_edit_unet(), resampler=DetokenizerConfig(),
                        sampler=SamplerConfig(height=SPLIT2_SIZE,
                                              width=SPLIT2_SIZE),
                        with_latent_image=True)
    ad = SDXLAdapter.random(cfg, seed=0, device=dev)
    ad.graphs.enabled = False
    g = torch.Generator(device=dev).manual_seed(62)
    embeds, neg = (torch.randn((1, 64, cfg.resampler.embedding_dim),
                               generator=g, device=dev).to(torch.bfloat16)
                   for _ in range(2))
    cond = torch.rand((1, SPLIT2_SIZE, SPLIT2_SIZE, 3), generator=g,
                      device=dev) * 2 - 1

    def both():
        return [ad.generate(embeds, negative_embeds=neg, seed=0,
                            num_inference_steps=SPLIT2_STEPS),
                ad.generate(embeds, latent_image=cond, negative_embeds=neg,
                            seed=0, num_inference_steps=SPLIT2_STEPS)]

    ref = both()
    with plain_unet_attention():
        plain = both()
    # the exact images' stand-in: the same UNet weights in fp32
    unet = ad.unet
    ad.unet = UNet2DCondition(dataclasses.replace(cfg.unet,
                                                  dtype=torch.float32), dev)
    ad.unet.load_state_dict(unet.state_dict())
    exact = both()
    ad.unet = unet
    gc.collect()
    torch.cuda.empty_cache()
    ad.shard(create_mesh(*layout, device_type="cuda"))
    before = dict(COLLECTIVES)
    reset_counts()
    got = both()
    torch.cuda.synchronize()
    res = {"collectives": {k: COLLECTIVES[k] - before[k]
                           for k in COLLECTIVES},
           "counts": read_counts(),
           "err": [float(np.abs(a - b).max()) for a, b in zip(got, ref)],
           "floor": [float(np.abs(a - b).max()) for a, b in zip(plain, ref)],
           "split_exact": [float(np.abs(a - b).max())
                           for a, b in zip(got, exact)],
           "unsplit_exact": [float(np.abs(a - b).max())
                             for a, b in zip(ref, exact)],
           "shape": list(got[0].shape)}
    if rank == 0:
        with open(os.path.join(root, "result.json"), "w") as f:
            json.dump(res, f)
    dist.destroy_process_group()


def run_two_rank_image(smi: str) -> None:
    """The split denoise on two ranks on the one card over gloo, eager:
    ``tensor`` 2 (the halo path) at ``SPLIT2_SIZE``^2; text to image and
    edit no further from the fp32 UNet's images than ``SPLIT2_FACTOR``
    times the unsharded bf16 run, the collectives of the two generates as
    the modules count them.  Layouts over
    ``data`` are held on the CPU only (tests/test_torch_split_denoise.py)."""
    from seedx_tpu_torch.models.sdxl.unet import (Conv, GroupNorm,
                                                  UNet2DCondition,
                                                  flash_launches_per_eval,
                                                  sdxl_edit_unet)
    from seedx_tpu_torch.models.sdxl.vae import VAEConfig, VAEDecoder

    t0 = time.perf_counter()
    res = rank_pair("--two-rank-image", (1, 1, 2))
    add_counts(CHECKS, res["counts"])
    unet = UNet2DCondition(sdxl_edit_unet(), device="meta")
    dec = VAEDecoder(VAEConfig(), device="meta")

    def count(m, kind):
        return sum(isinstance(c, kind) and (kind is not Conv
                                            or c.kernel_size[0] == 3)
                   for c in m.modules())

    att = flash_launches_per_eval(sdxl_edit_unet())
    evals = 2 * SPLIT2_STEPS
    want = {"halo": evals * count(unet, Conv) + 2 * count(dec, Conv),
            "all_reduce": evals * count(unet, GroupNorm)
            + 2 * count(dec, GroupNorm),
            "all_gather": evals * (att + 2) + 2 * 2}
    got = {k: res["collectives"][k] for k in want}
    log(f"split image: two ranks on the card, tensor 2 (gloo, eager), "
        f"edit UNet {SPLIT2_SIZE}^2, Euler {SPLIT2_STEPS} ({smi}): text to "
        f"image / edit max_abs_err {res['err'][0]:.3e} / "
        f"{res['err'][1]:.3e} against the unsharded images (K1-vs-plain "
        f"floor {res['floor'][0]:.3e} / {res['floor'][1]:.3e}); against "
        f"the fp32 UNet's images: split {res['split_exact'][0]:.3e} / "
        f"{res['split_exact'][1]:.3e}, unsharded bf16 "
        f"{res['unsplit_exact'][0]:.3e} / {res['unsplit_exact'][1]:.3e} "
        f"(limit {SPLIT2_FACTOR} x the unsharded); collectives "
        f"{json.dumps(got)} (predicted {json.dumps(want)}); K1 "
        f"{res['counts']['flash_fwd']} launches; "
        f"{time.perf_counter() - t0:.1f} s")
    if got != want or any(s > SPLIT2_FACTOR * u for s, u in zip(
            res["split_exact"], res["unsplit_exact"])) or min(
            res["counts"]["flash_fwd"], 1) <= 0:
        raise AssertionError(f"split image two ranks: {res}")


def mesh_train_samples(tok, image_size: int):
    """Two global batches of 8 captions at 260 tokens, one image (tile) a
    row, so an fsdp split keeps each row's image with it."""
    return sft_batches(tok, image_size, 64, 64)[1:]


def two_rank_train_worker(rank: int, root: str, layouts) -> None:
    """One of two ranks (``--two-rank-train``): the SEED-X agent at full
    width cut to ``PARITY_LAYERS`` layers (bf16, LoRA r32, dropout on),
    random weights from seed 11 (the same on both ranks), two global
    caption batches encoded by a ViT-bigG (the factory's seed).  The
    unsharded steps (3: b, b2, b), the same 2 with the plain attention
    (the noise floor), then for each mesh of ``layouts`` (flattened
    (data, fsdp, tensor) triples) 2 steps on this rank's rows; under fsdp
    the mesh's checkpoint restored on one rank (no mesh) and its next
    step.  Rank 0 writes the metrics, the errors and the bytes a rank."""
    import dataclasses

    import torch
    import torch.distributed as dist

    from seedx_tpu_torch import config as config_lib
    from seedx_tpu_torch.models.agent import ContinuousLVLM
    from seedx_tpu_torch.models.layers import init_normal_
    from seedx_tpu_torch.parallel import create_mesh
    from seedx_tpu_torch.parallel.mesh import (gather_full, leaf_layout,
                                               place_params)
    from seedx_tpu_torch.text.tokenizer import load_tokenizer
    from seedx_tpu_torch.train import checkpoints as ck
    from seedx_tpu_torch.train import train_sft
    from seedx_tpu_torch.train.trainer import (TrainConfig,
                                               create_train_state,
                                               make_train_step, mesh_groups)

    dev = gloo_pair(root, rank)
    vit = config_lib.instantiate_from_file(SFT_CONFIGS[2][1], device=dev)
    batches = []
    for b in mesh_train_samples(load_tokenizer(), vit.cfg.image_size):
        d = train_sft._to_device(b, dev)
        with torch.no_grad():
            d["image_embeds"] = vit(d.pop("images"), d["patch_positions"])
        batches.append(d)
    del vit
    gc.collect()
    torch.cuda.empty_cache()
    batches.append(batches[0])
    cfg = train_agent_cfg(PARITY_LAYERS)
    tcfg = TrainConfig(warmup_steps=0, max_steps=10)

    def fresh(mesh=None):
        gen = torch.Generator(device=dev).manual_seed(11)
        agent = init_normal_(ContinuousLVLM(cfg, dev), gen)
        if mesh is not None:
            place_params(agent, mesh)
        st = create_train_state(agent, tcfg)
        return agent, st, make_train_step(agent, tcfg)

    def drop(i):
        return torch.Generator(device=dev).manual_seed(500 + i)

    def snap(agent, st):
        groups = mesh_groups(agent)
        return {n: (p.detach() if groups is None else gather_full(
            p.detach(), leaf_layout(agent, n), groups)).to("cpu", copy=True)
            for n, p in st.params.items()}

    def run(agent, st, step, rows, n, first=0):
        out = []
        for i in range(first, first + n):
            out.append((step(st, rows(batches[i]), drop(i)),
                        snap(agent, st)))
        return out

    def update_err(got, want, init):
        num = sum(float(((got[k] - want[k]).float() ** 2).sum())
                  for k in want)
        den = sum(float(((want[k] - init[k]).float() ** 2).sum())
                  for k in want)
        return (num / max(den, 1e-30)) ** 0.5

    def errs(runs, ref):
        return [{"loss": abs(m["total_loss"] - r[0]["total_loss"])
                 / abs(r[0]["total_loss"]),
                 "norm": abs(m["grad_norm"] - r[0]["grad_norm"])
                 / abs(r[0]["grad_norm"]),
                 "update": update_err(s, r[1], init)}
                for (m, s), r in zip(runs, ref)]

    def nbytes(st):
        return sum(t.numel() * t.element_size()
                   for m in st.opt_state.values() for t in m.values())

    def whole(b):
        return b

    agent, st, step = fresh()
    init = snap(agent, st)
    res = {"bytes_full": resident_bytes(agent), "opt_full": nbytes(st)}
    ref = run(agent, st, step, whole, 3)
    del agent, st, step
    agent, st, step = fresh()
    agent.llm.layers.cfg = dataclasses.replace(cfg.llm,
                                               attention_impl="plain")
    res["floor"] = errs(run(agent, st, step, whole, 2), ref)
    res["ref_metrics"] = [{k: m[k] for k in ("total_loss", "grad_norm")}
                          for m, _ in ref]
    del agent, st, step
    gc.collect()
    torch.cuda.empty_cache()
    res["layouts"] = []
    for i in range(0, len(layouts), 3):
        layout = tuple(layouts[i:i + 3])
        agent, st, step = fresh(create_mesh(*layout, device_type="cuda"))
        groups = mesh_groups(agent)
        out = {"layout": list(layout), "bytes": resident_bytes(agent),
               "opt": nbytes(st)}

        def rows(b):
            n, j = groups.batch_count, groups.batch_index
            return {k: v[j * (len(v) // n):(j + 1) * (len(v) // n)]
                    for k, v in b.items()}

        reset_counts()
        got = run(agent, st, step, rows, 2)
        torch.cuda.synchronize()
        out["counts"] = read_counts()
        out["mesh"] = errs(got, ref)
        out["metrics"] = [{k: m[k] for k in ("total_loss", "grad_norm")}
                          for m, _ in got]
        path = os.path.join(root, "ckpt")
        if layout[1] > 1:
            ck.save_train_state(ck.CheckpointManager(path), st, agent)
        del agent, st, step
        gc.collect()
        torch.cuda.empty_cache()
        if layout[1] > 1:
            if rank == 0:
                agent, st, step = fresh()
                ck.restore_train_state(ck.CheckpointManager(path), st, agent)
                out["resume"] = dict(errs(run(agent, st, step, whole, 1,
                                              first=2), ref[2:])[0],
                                     step=st.step)
                del agent, st, step
                gc.collect()
                torch.cuda.empty_cache()
            dist.barrier()
        res["layouts"].append(out)
    if rank == 0:
        with open(os.path.join(root, "result.json"), "w") as f:
            json.dump(res, f)
    dist.barrier()
    dist.destroy_process_group()


def run_mesh_train(smi: str) -> dict:
    """Training on two ranks on the one card over gloo, eager, at full
    width cut to ``PARITY_LAYERS`` layers: fsdp 2, then tensor 2, in one
    pair of processes.  Steps 1 and 2 (loss, grad norm, every trainable
    leaf's update) against the unsharded run's within the stated limits,
    beside the same numbers for the unsharded run with the plain
    attention (the noise floor); the fsdp 2 run's checkpoint restored on
    one rank and its next step held against the unsharded run's third.
    Returns the mesh steps' launches (the main path of training on a
    mesh)."""
    t0 = time.perf_counter()
    totals = {}
    res = rank_pair("--two-rank-train", sum(
        (layout for _, layout in MESH_TRAIN_LAYOUTS), ()), timeout=500)
    floor = max(f["update"] for f in res["floor"])

    def fmt(cs):
        return "; ".join(f"loss {c['loss']:.2e} norm {c['norm']:.2e} "
                         f"update {c['update']:.2e}" for c in cs)

    log(f"mesh train: the unsharded run's K1-vs-plain floor (relative): "
        f"{fmt(res['floor'])}; its metrics {json.dumps(res['ref_metrics'])}")
    for (name, _), out in zip(MESH_TRAIN_LAYOUTS, res["layouts"]):
        add_counts(totals, out["counts"])
        checks = out["mesh"] + ([out["resume"]] if "resume" in out else [])
        bad = [c for c in checks
               if not (c["loss"] <= MESH_LOSS_REL and c["norm"]
                       <= MESH_NORM_REL and c["update"]
                       <= max(MESH_UPDATE_REL, 4 * floor))]
        log(f"mesh train: {name} (gloo, eager, {PARITY_LAYERS} layers at "
            f"full width, {smi}): steps 1-2 against the unsharded run "
            f"(relative): {fmt(out['mesh'])} (limits {MESH_LOSS_REL} / "
            f"{MESH_NORM_REL} / max({MESH_UPDATE_REL}, 4 x the floor)); "
            f"metrics {json.dumps(out['metrics'])}"
            + (f"; the checkpoint restored on one rank, step 3: "
               f"{fmt([out['resume']])}" if "resume" in out else "")
            + f"; weights a rank {out['bytes']} bytes (unsharded "
            f"{res['bytes_full']}), Adam moments a rank {out['opt']} "
            f"(unsharded {res['opt_full']}); launches a rank for 2 steps "
            f"K1 {out['counts']['flash_fwd']} K4 "
            f"{out['counts']['flash_bwd_dq']} K5 "
            f"{out['counts']['flash_bwd_dkv']}")
        if bad or min(out["counts"][k] for k in (
                "flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")) <= 0:
            raise AssertionError(f"mesh train {name}: {out}")
    log(f"mesh train phase: {time.perf_counter() - t0:.1f} s")
    return totals


def ptxas_entries(report: str):
    """(mangled kernel name, registers line, spill line) of each entry
    function in a ``ptxas -v`` report."""
    out, fn, spill = [], None, ""
    for ln in report.splitlines():
        if "Function properties for" in ln:
            fn, spill = ln.split("Function properties for", 1)[1].strip(), ""
        elif "spill stores" in ln:
            spill = ln.strip()
        elif "Used" in ln and "registers" in ln and fn:
            out.append((fn, ln.split(":", 1)[1].strip(), spill))
            fn = None
    return out


def build_kernels():
    """Phase 2: one nvcc per source, all started together."""
    from seedx_tpu_torch.ops import _build
    from seedx_tpu_torch.ops import decode_attention as da
    from seedx_tpu_torch.ops import flash_attention as fa
    from seedx_tpu_torch.ops import int4_matmul as i4
    from seedx_tpu_torch.ops import epilogue, moe, norms, ssm

    libs = {"flash_fwd": fa.library, "flash_bwd": fa.bwd_library,
            "int4_w4a8": i4.library, "int4_dequant": i4.dequant_library,
            "decode_attn": da.library,
            "norms": norms.library, "moe_gemm": moe.library,
            "epilogue": epilogue.library, "ssm_step": ssm.library}
    errors = {}

    def build(name):
        try:
            libs[name]()
        except Exception as e:   # reported below; the run then fails
            errors[name] = e

    t0 = time.perf_counter()
    threads = [threading.Thread(target=build, args=(n,)) for n in libs]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise RuntimeError(f"kernel build failed: {errors}")
    log(f"build: {len(libs)} kernels in {time.perf_counter() - t0:.2f} s")
    for name in libs:
        secs, report = _build.build_log[name]
        regs = sorted({ln.split(":", 1)[1].strip() for ln in
                       report.splitlines() if "registers" in ln})
        spills = sum(int(ln.split("bytes spill stores")[0].split(",")[-1])
                     for ln in report.splitlines()
                     if "bytes spill stores" in ln)
        log(f"build {name}: nvcc {secs:.2f} s; {len(regs)} kernel variants"
            f"{'; ' + ' | '.join(regs) if regs else ' (cached)'}; spill "
            f"stores {spills} bytes in all")
        if name == "int4_w4a8":
            for fn, used, spill in ptxas_entries(report):
                log(f"build {name} {fn}: {used}; {spill}")


def main() -> int:
    import torch

    from seedx_tpu_torch.ops import int4_matmul as i4

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
    t_start = time.perf_counter()

    build_kernels()
    rows = check_kernels(dev)
    if not all(r["ok"] for r in rows):
        raise AssertionError("a kernel disagrees with its plain version")
    check_quantizers(dev)
    check_tiny_stack(dev)
    check_tiny_adapter(dev)

    rt = build_runtime(dev)
    launches = run_turn(rt)
    served, requests, budgets, limit = run_serving(rt)
    add_counts(launches, served)
    add_counts(launches, run_chat(rt, limit))
    run_graph_twins(rt, requests, smi)
    run_graph_memory(rt, smi)
    t_gen = time.perf_counter()
    add_counts(launches, run_generation(rt, dev, smi))
    log(f"generation phase: {time.perf_counter() - t_gen:.1f} s")
    run_parity(dev, requests, budgets)
    add_counts(launches, run_image_out(rt, dev, smi))
    add_counts(launches, run_split_image(rt, dev, smi))
    add_counts(launches, run_sharded(rt, dev, smi))
    # the HTTP handler classes hold the servers, and so the runtime, in
    # reference cycles: collect them before the train model is built
    del rt
    gc.collect()
    torch.cuda.empty_cache()
    add_counts(launches, run_moe_serving(dev))
    # its runtime (~34 GiB) likewise, before the next
    gc.collect()
    torch.cuda.empty_cache()
    add_counts(launches, run_nemotron_serving(dev))
    gc.collect()
    torch.cuda.empty_cache()
    add_counts(launches, run_train(dev))
    add_counts(launches, run_mesh_train(smi))
    add_counts(launches, run_adapter_train(dev, smi))
    add_counts(launches, run_load(dev, smi))
    log(f"main path (turn, serving, chat, generation, image out, train "
        f"through the train_sft entry point, adapter training, the loaded "
        f"stack; "
        f"decode, the verify round, the beam step, the engines' steps and "
        f"the UNet evals captured): launches "
        f"{json.dumps(launches)}")
    log("main path: K2 calls by row band: " + ", ".join(
        f"rows {b} {launches[f'int4_w4a8 rows {b}']}"
        for b in i4.BANDS))
    log(f"check runs (the eager twins; teacher-forced engines, batched "
        f"loop and chat; the {PARITY_LAYERS}-layer parity agent and "
        f"gradient check; the UNet's K1-against-plain eval): launches "
        f"{json.dumps(CHECKS)}; not in the kernels line")

    kernels = []
    for name, source, replaces in KERNELS:
        mine = [r for r in rows if r["kernel"] == name]
        lib = [r for r in mine if r["library_ms"] is not None]
        b_bytes = sum(r["bound_ms"] for r in mine if r["bound_by"] == "bytes")
        b_ops = sum(r["bound_ms"] for r in mine
                    if r["bound_by"] == "operations")
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches[name],
            **({"launches_by_mode": {
                m: launches[f"{name} {m}"] for m in ("one_query",
                                                     "multi_query")}}
               if name == "decode_attn" else {}),
            **({"launches_by_tile": {
                f"m{t}": launches[f"{name} m{t}"] for t in i4.ROW_TILES}}
               if name == "int4_w4a8" else {}),
            **({"launches_by_epilogue": {
                "relu2": launches[f"{name} relu2"],
                "swiglu or plain": launches[name] - launches[f"{name} relu2"]}}
               if name == "moe_gemm" else {}),
            "max_abs_err": max(r["err"] for r in mine),
            "ms": sum(r["ms"] for r in mine),
            "plain_ms": sum(r["plain_ms"] for r in mine),
            "bound_ms": b_bytes + b_ops,
            "bound_by": "bytes" if b_bytes >= b_ops else "operations",
            "library_ms": sum(r["library_ms"] for r in lib) if lib else None,
            "library_shapes": [r["shape"] for r in lib],
            "shapes": len(mine)})
    log(f"chip_smoke: all phases passed in "
        f"{time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    workers = {"--two-rank": two_rank_worker,
               "--two-rank-image": two_rank_image_worker,
               "--two-rank-train": two_rank_train_worker}
    if sys.argv[1:2] and sys.argv[1] in workers:
        workers[sys.argv[1]](int(sys.argv[2]), sys.argv[3],
                             tuple(int(v) for v in sys.argv[4].split(",")))
        sys.exit(0)
    sys.exit(main())
