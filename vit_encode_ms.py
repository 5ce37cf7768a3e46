"""Time the comprehension turn's anyres ViT encode on one GPU, for one or
more checkouts of the port in one call.

ViT-bigG/14-448 in bf16 with random weights from seed 0 encodes the turn's
three images (448x448, 896x448, 896x896: 2, 3 and 5 tiles, as in
``chip_smoke.py``'s ``run_turn``) in the turn's order, ``ROUNDS`` times.
K1 is built first; round 0 then carries each shape's other first-use
costs, and the later rounds are warm.
Each encode gives its host ms closed by a synchronize (what ``comprehend``
reports as "vit": preprocessing, the copy to the card and the ViT) and
K1's launches; each shape the ViT forward alone timed by CUDA events
(medians of 5) twice: as launched, so paced by the host where it queues
kernels slower than the card runs them, and on the device, behind a spin
kernel that lets the host queue the whole forward first.

    python3 vit_encode_ms.py [TREE ...]

Each TREE (default: this checkout) is a directory whose ``seedx_tpu_torch``
is timed, in a process of its own, in the order given, so that two
versions compare on one card: ``python3 vit_encode_ms.py OLD . . OLD``.
The last line is a JSON object of every process's numbers.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np

ROUNDS = 4
# ~100 ms at the H100's 1.98 GHz boost clock: a spin kernel that long keeps
# the card busy while the host queues the whole ViT forward
SPIN_CYCLES = 200_000_000
SIZES = ((448, 448), (896, 448), (896, 896))


def one(tree: str) -> dict:
    """Time the encodes with ``tree``'s package (run in a fresh process)."""
    sys.path.insert(0, tree)
    import torch
    from PIL import Image

    from seedx_tpu_torch.inference.runtime import SeedXRuntime
    from seedx_tpu_torch.models.agent import AgentConfig
    from seedx_tpu_torch.models.llama import llama2_13b
    from seedx_tpu_torch.models.vit import qwen_vitg_448
    from seedx_tpu_torch.ops import flash_attention as fa
    from seedx_tpu_torch.ops._build import launches

    import seedx_tpu_torch
    assert os.path.dirname(seedx_tpu_torch.__file__).startswith(
        os.path.abspath(tree))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    agent_cfg = AgentConfig(
        llm=llama2_13b(quantization="int4", kv_quantization="int8",
                       num_layers=1),
        vit_dim=4096, resampler_heads=32, num_img_in_tokens=64,
        num_img_out_tokens=64)
    rt = SeedXRuntime.random(qwen_vitg_448(), agent_cfg, seed=0, device=dev)
    rng = np.random.default_rng(0)
    images = [Image.fromarray((rng.random((h, w, 3)) * 255).astype(np.uint8))
              for w, h in SIZES]
    fa.library()                     # build K1 before the first encode
    host = {}
    tiles = {}
    for rnd in range(ROUNDS):
        for img in images:
            torch.cuda.synchronize()
            n0 = launches["flash_fwd"]
            t0 = time.perf_counter()
            embeds, _ = rt.encode_image_anyres(img)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
            n = int(embeds.shape[0])
            tiles[n] = launches["flash_fwd"] - n0
            host.setdefault(n, []).append(ms)
            print(f"{tree} round {rnd} {img.size[0]}x{img.size[1]}: {n} "
                  f"tiles, host {ms:.1f} ms, K1 launches {tiles[n]}",
                  flush=True)
    paced, device = {}, {}
    with torch.no_grad():
        for n in host:
            x = torch.zeros((n, 448, 448, 3), device=dev)    # NHWC tiles
            for spin, out in ((0, paced), (SPIN_CYCLES, device)):
                times = []
                for _ in range(6):
                    torch.cuda._sleep(spin)
                    start = torch.cuda.Event(enable_timing=True)
                    end = torch.cuda.Event(enable_timing=True)
                    start.record()
                    rt.vit(x)
                    end.record()
                    end.synchronize()
                    times.append(start.elapsed_time(end))
                out[n] = statistics.median(times[1:])
            print(f"{tree} {n} tiles: ViT forward {paced[n]:.2f} ms as "
                  f"launched, {device[n]:.2f} ms on the device (medians of "
                  f"5)", flush=True)
    return {"tree": tree, "host_ms": host, "paced_ms": paced,
            "device_ms": device, "k1_launches": tiles}


def main(argv) -> int:
    if argv[:1] == ["--one"]:
        print(json.dumps(one(argv[1])))
        return 0
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("vit_encode_ms: no CUDA device")
    here = os.path.dirname(os.path.abspath(__file__))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip()
    print(f"card: {smi}", flush=True)
    runs = []
    for tree in argv or [here]:
        proc = subprocess.run([sys.executable, os.path.abspath(__file__),
                               "--one", os.path.abspath(tree)],
                              capture_output=True, text=True, cwd=here)
        print(proc.stdout[:proc.stdout.rfind("\n{")], flush=True)
        if proc.returncode != 0:
            print(proc.stderr[-4000:], file=sys.stderr)
            return proc.returncode
        runs.append(json.loads(proc.stdout.strip().splitlines()[-1]))
    for r in runs:
        print(f"{r['tree']}: " + "; ".join(
            f"{n} tiles host first {v[0]:.1f} ms, warm median "
            f"{statistics.median(v[1:]):.1f} ms, ViT as launched "
            f"{r['paced_ms'][n]:.2f} ms, on the device "
            f"{r['device_ms'][n]:.2f} ms" for n, v in r["host_ms"].items()),
            flush=True)
    print(json.dumps({"card": smi, "runs": runs}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
