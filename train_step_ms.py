"""Time the flash kernels inside the SEED-X SFT train step on one GPU, for
one or more checkouts of the port in one call.

The full-width train step as ``chip_smoke.py`` runs it: ViT-bigG/14-448
bf16 (frozen) encodes the batch's tiles, then the SEED-X agent
(LLaMA2-13B bf16 frozen, LoRA r32, both resamplers) takes one forward,
backward and optimizer step; random weights from seed 4, the batches of
``chip_smoke.sft_batches``: (a) 2 conversations at 880 tokens with 8
anyres tiles, (b) 8 captions at 260 tokens.  After one warm-up step of
each, each batch's step runs under torch.profiler ``ROUNDS`` times.  Per
step: K4's, K5's and K1's device ms and launches, the device busy ms
(every kernel's device time) and the profiled wall ms.

    python3 train_step_ms.py [TREE ...]

Each TREE (default: this checkout) is a directory whose ``seedx_tpu_torch``
is timed, in a process of its own, in the order given, so that two
versions compare on one card: ``python3 train_step_ms.py OLD . . OLD``.
The model, batch and profiling code is this checkout's ``chip_smoke.py``.
The last line is a JSON object of every process's numbers.
"""

from __future__ import annotations

import importlib.util
import json
import os
import statistics
import subprocess
import sys

ROUNDS = 3
HERE = os.path.dirname(os.path.abspath(__file__))
KERNELS = (("k4", "flash_bwd_dq_kernel"), ("k5", "flash_bwd_dkv_kernel"),
           ("k1", "flash_fwd_kernel"))


def one(tree: str) -> dict:
    """Profile the train steps with ``tree``'s package (run in a fresh
    process)."""
    sys.path.insert(0, tree)
    import torch

    import seedx_tpu_torch
    assert os.path.dirname(seedx_tpu_torch.__file__).startswith(
        os.path.abspath(tree))
    from seedx_tpu_torch.models.agent import ContinuousLVLM
    from seedx_tpu_torch.models.layers import init_normal_
    from seedx_tpu_torch.models.vit import VisionTransformer, qwen_vitg_448
    from seedx_tpu_torch.text.tokenizer import load_tokenizer
    from seedx_tpu_torch.train.train_sft import _to_device
    from seedx_tpu_torch.train.trainer import (TrainConfig,
                                               create_train_state,
                                               make_train_step)

    spec = importlib.util.spec_from_file_location(
        "smoke", os.path.join(HERE, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    smoke.build_kernels()
    gen = torch.Generator(device=dev).manual_seed(4)
    vit_cfg = qwen_vitg_448()
    vit = init_normal_(VisionTransformer(vit_cfg, dev).eval(), gen)
    batches = smoke.sft_batches(load_tokenizer(), vit_cfg.image_size, 64,
                                64)[:2]
    agent = init_normal_(ContinuousLVLM(smoke.train_agent_cfg(), dev), gen)
    train_cfg = TrainConfig(warmup_steps=0, max_steps=10 ** 6)
    state = create_train_state(agent, train_cfg)
    step_fn = make_train_step(agent, train_cfg)
    out = {"tree": tree}
    for label, batch in zip("ab", batches):
        dev_b = _to_device(batch, dev)
        images = dev_b.pop("images")

        def step():
            with torch.no_grad():
                dev_b["image_embeds"] = vit(images, dev_b["patch_positions"])
            step_fn(state, dev_b, torch.Generator(device=dev).manual_seed(9))
            return 1

        step()                                      # warm-up
        rounds = []
        for _ in range(ROUNDS):
            got = smoke.device_profile(step)
            if got is None:
                raise SystemExit("train_step_ms: the profiler saw no device "
                                 "events")
            _, wall, by_name = got
            r = {"busy_ms": sum(t for t, _ in by_name.values()),
                 "wall_ms": wall}
            for key, name in KERNELS:
                r[f"{key}_ms"], r[f"{key}_launches"] = smoke.kernel_ms(
                    by_name, name)
            rounds.append(r)
            print(f"{tree} step ({label}): K4 {r['k4_ms']:.3f} ms over "
                  f"{r['k4_launches']}, K5 {r['k5_ms']:.3f} ms over "
                  f"{r['k5_launches']}, K1 {r['k1_ms']:.3f} ms over "
                  f"{r['k1_launches']}, device busy {r['busy_ms']:.1f} ms, "
                  f"wall (profiled) {wall:.1f} ms", flush=True)
        out[label] = rounds
        del dev_b, images
        torch.cuda.empty_cache()
    return out


def main(argv) -> int:
    if argv[:1] == ["--one"]:
        print(json.dumps(one(argv[1])))
        return 0
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("train_step_ms: no CUDA device")
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
    for r in runs:
        parts = []
        for label in "ab":
            def med(key, xs=r[label]):
                return statistics.median(x[key] for x in xs)
            k45 = statistics.median(x["k4_ms"] + x["k5_ms"] for x in r[label])
            parts.append(f"step ({label}) median: " + ", ".join(
                f"{key.upper()} {med(key + '_ms'):.3f} ms"
                for key, _ in KERNELS) + f", K4 + K5 {k45:.3f} ms, busy "
                f"{med('busy_ms'):.1f} ms, wall {med('wall_ms'):.1f} ms")
        print(f"{r['tree']}: " + "; ".join(parts), flush=True)
    print(json.dumps({"card": smi, "runs": runs}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
