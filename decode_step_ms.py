"""Time K3 (ragged decode attention) and K2 (the W4A8 int4 matmul) inside
the serving steps and a prefill on one GPU, for one or more checkouts of
the port in one call.

The full-width SEED-X-I agent (LLaMA2-13B, 40 layers, int4 projections,
int8 KV cache; ViT-bigG for the image prompts), random weights from seed
0, as ``chip_smoke.py`` builds it, takes the first 8 of ``chip_smoke.py``'s
serving requests on a ``ContinuousEngine`` of 8 slots (dense cache,
budget 64): non-fused, a steady 16-step decode chunk (K3 one query per
row, B 8); fused (16 prompt tokens a step beside the decode tokens), a
16-step mixed chunk (K3's multi-query stair).  Each chunk runs under
torch.profiler, ``ROUNDS`` times, each on a fresh engine past its
admission and first chunk.  Per step: K3's and K2's device ms and
launches (K2: its row quantization, matmul and split merge, whatever
kernels a checkout runs them as), the device busy ms (every kernel's
device time) and the profiled wall ms.  Then one B 1 prefill of a full
512-token bucket (``llm_step`` on a fresh cache, as the 896x896 turn's),
``ROUNDS`` times: K2's device ms and launches, busy ms and wall ms.

    python3 decode_step_ms.py [TREE ...]

Each TREE (default: this checkout) is a directory whose ``seedx_tpu_torch``
is timed, in a process of its own, in the order given, so that two
versions compare on one card: ``python3 decode_step_ms.py OLD . . OLD``.
The engine and profiling code is this checkout's ``chip_smoke.py``.  The
last line is a JSON object of every process's numbers.
"""

from __future__ import annotations

import importlib.util
import json
import os
import statistics
import subprocess
import sys

ROUNDS = 3
# K2's kernels in any checkout: the __dp4a design ran quantize_rows_kernel,
# w4a8_kernel and reduce_splits_kernel, the mma.sync design quantize_rows
# and w4a8_mma
K2_KEYS = ("w4a8", "quantize_rows", "reduce_splits")
PREFILL_BUCKET = 512


def k2_ms(smoke, by_name):
    hits = [smoke.kernel_ms(by_name, k) for k in K2_KEYS]
    return sum(t for t, _ in hits), sum(n for _, n in hits)


def prefill(rt, dev):
    """One B 1 prefill of PREFILL_BUCKET tokens on a fresh cache; returns
    1 (a step)."""
    import torch

    from seedx_tpu_torch.models.agent import positions_from_mask
    from seedx_tpu_torch.models.llama import init_kv_cache

    llm = rt.agent.cfg.llm
    g = torch.Generator(device=dev).manual_seed(3)
    embeds = (torch.randn((1, PREFILL_BUCKET, llm.hidden_size), generator=g,
                          device=dev) * 0.02).to(torch.bfloat16)
    mask = torch.ones((1, PREFILL_BUCKET), dtype=torch.bool, device=dev)
    cache = init_kv_cache(llm, 1, PREFILL_BUCKET + 32, device=dev)
    kv_valid = torch.cat([mask, torch.zeros((1, 32), dtype=torch.bool,
                                            device=dev)], dim=-1)
    with torch.no_grad():
        rt.agent.llm_step(embeds, positions_from_mask(mask), kv_valid,
                          cache, 0)
    return 1
HERE = os.path.dirname(os.path.abspath(__file__))


def one(tree: str) -> dict:
    """Profile the chunks with ``tree``'s package (run in a fresh
    process)."""
    sys.path.insert(0, tree)
    import torch

    import seedx_tpu_torch
    assert os.path.dirname(seedx_tpu_torch.__file__).startswith(
        os.path.abspath(tree))
    spec = importlib.util.spec_from_file_location(
        "smoke", os.path.join(HERE, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    smoke.build_kernels()
    rt = smoke.build_runtime(dev)
    requests = smoke.serving_inputs(rt)[3]
    out = {"tree": tree}
    for kind, fused in (("decode", False), ("mixed", True)):
        rounds = []
        for _ in range(ROUNDS):
            eng = smoke.steady_engine(rt, requests, 8, fused)
            got = smoke.device_profile(
                lambda: smoke.engine_chunk(eng, kind))
            if got is None:
                raise SystemExit("decode_step_ms: the profiler saw no device "
                                 "events")
            steps, wall, by_name = got
            k3_ms, k3_n = smoke.kernel_ms(by_name, "decode_attn")
            k2, k2_n = k2_ms(smoke, by_name)
            busy = sum(t for t, _ in by_name.values())
            rounds.append({"steps": steps, "k3_ms": k3_ms / steps,
                           "k3_launches": k3_n / steps,
                           "k2_ms": k2 / steps, "k2_launches": k2_n / steps,
                           "busy_ms": busy / steps, "wall_ms": wall / steps})
            print(f"{tree} {kind}: {steps} steps, per step K3 "
                  f"{k3_ms / steps:.4f} ms over {k3_n / steps:.0f} launches, "
                  f"K2 {k2 / steps:.4f} ms over {k2_n / steps:.0f} launches, "
                  f"device busy {busy / steps:.3f} ms, wall (profiled) "
                  f"{wall / steps:.3f} ms", flush=True)
            del eng
            torch.cuda.empty_cache()
        out[kind] = rounds
    prefill(rt, dev)                     # warm-up
    rounds = []
    for _ in range(ROUNDS):
        got = smoke.device_profile(lambda: prefill(rt, dev))
        if got is None:
            raise SystemExit("decode_step_ms: the profiler saw no device "
                             "events")
        _, wall, by_name = got
        k2, k2_n = k2_ms(smoke, by_name)
        busy = sum(t for t, _ in by_name.values())
        rounds.append({"steps": 1, "k2_ms": k2, "k2_launches": k2_n,
                       "busy_ms": busy, "wall_ms": wall})
        print(f"{tree} prefill B1 bucket {PREFILL_BUCKET}: K2 {k2:.3f} ms "
              f"over {k2_n} launches, device busy {busy:.3f} ms, wall "
              f"(profiled) {wall:.3f} ms", flush=True)
        torch.cuda.empty_cache()
    out["prefill"] = rounds
    return out


def main(argv) -> int:
    if argv[:1] == ["--one"]:
        print(json.dumps(one(argv[1])))
        return 0
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("decode_step_ms: no CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip()
    print(f"card: {smi}", flush=True)
    runs = []
    for tree in argv or [HERE]:
        proc = subprocess.run([sys.executable, os.path.abspath(__file__),
                               "--one", os.path.abspath(tree)],
                              capture_output=True, text=True, cwd=HERE)
        print(proc.stdout[:proc.stdout.rfind("\n{")], flush=True)
        if proc.returncode != 0:
            print(proc.stderr[-4000:], file=sys.stderr)
            return proc.returncode
        runs.append(json.loads(proc.stdout.strip().splitlines()[-1]))
    med = statistics.median
    for r in runs:
        print(f"{r['tree']}: " + "; ".join(
            f"{kind} median per step: "
            + (f"K3 {med(x['k3_ms'] for x in r[kind]):.4f} ms, "
               if kind != "prefill" else "")
            + f"K2 {med(x['k2_ms'] for x in r[kind]):.4f} ms over "
            f"{med(x['k2_launches'] for x in r[kind]):.0f} launches, busy "
            f"{med(x['busy_ms'] for x in r[kind]):.3f} ms, "
            f"wall {med(x['wall_ms'] for x in r[kind]):.3f} ms"
            for kind in ("decode", "mixed", "prefill")), flush=True)
    print(json.dumps({"card": smi, "runs": runs}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
