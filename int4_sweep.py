"""Time K2 (``seedx_tpu_torch/csrc/int4_w4a8.cu``) on one GPU at each row
count of the main path and of prefill (1, 8, 24, 65, 512, 2048) on the
13B's three projection shapes, at every built row tile, several split
counts: the times ``plan`` in ``seedx_tpu_torch/ops/int4_matmul.py`` is
chosen from.

    python3 int4_sweep.py [--quick] [--profile]

Each (shape, rows) draws x and W from a seed; every (tile, split)
variant is first held to the plain version (two bf16 ULPs of the largest
output, as ``chip_smoke.check_int4``), then timed as the smoke's rows are
(device ms, L2 flushed).  One ``sweep`` line a (shape, rows) gives the ms
of each variant, the one ``plan`` picks marked ``*``, beside the bound.
``--quick`` times only the variant ``plan`` picks; ``--profile``
also splits the picked variant's device time by kernel (the row
quantization, the matmul) with torch.profiler over 10 calls.  Exits
non-zero if any variant disagrees with the plain version.
"""

from __future__ import annotations

import sys

import chip_smoke as c

ROWS = (1, 8, 24, 40, 65, 512, 2048)
SHAPES = ((5120, 5120), (5120, 13824), (13824, 5120))
SPLITS = (1, 2, 3, 4, 6, 8, 12, 16)


def kernel_split(fn, flush, calls: int = 10):
    """{kernel name: mean device us a call} of ``fn`` over ``calls``
    calls, the L2 flushed before each."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            flush.zero_()
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA and "elementwise" not in e.name \
                and "fill" not in e.name.lower():
            out[e.name] = out.get(e.name, 0.0) + e.time_range.elapsed_us()
    return {k: v / calls for k, v in out.items()}


def sweep(dev, quick: bool, profile: bool) -> int:
    import torch

    from seedx_tpu_torch.ops import int4_matmul as i4
    from seedx_tpu_torch.ops._build import sm_count
    from seedx_tpu_torch.utils.quantize import quantize_kernel_int4

    g = torch.Generator(device=dev).manual_seed(77)
    flush = torch.empty(96 << 20, dtype=torch.uint8, device=dev)
    sms = sm_count(0)
    bad = 0
    for n_in, n_out in SHAPES:
        w = torch.randn((n_in, n_out), generator=g, device=dev) * 0.02
        packed, scale = quantize_kernel_int4(w)
        del w
        for rows in ROWS:
            x = torch.randn((rows, n_in), generator=g,
                            device=dev).to(torch.bfloat16)
            ref = i4.int4_matmul_plain(x, packed, scale).float()
            tol = 2 * 2 ** -7 * ref.abs().max().item()
            pick = i4.plan(rows, n_in, n_out, 128, sms)
            n_bytes = (x.numel() * 2 + packed.numel() + scale.numel() * 4
                       + rows * n_out * 2)
            bnd = c.bound(n_bytes, 2 * rows * n_in * n_out, "int8")
            variants = [pick]
            for tile in () if quick else i4.ROW_TILES:
                if rows > 128 and tile != i4.ROW_TILES[-1]:
                    continue
                for s in SPLITS if rows <= 128 else (1, 2, 3):
                    v = i4.plan(rows, n_in, n_out, 128, sms, tile, s)
                    if v not in variants:
                        variants.append(v)
            times = {}
            for tile, s in variants:
                def fn():
                    return i4.int4_matmul(x, packed, scale, _tile=tile,
                                          _splits=s)
                err = (fn().float() - ref).abs().max().item()
                torch.cuda.synchronize()
                if err > tol:
                    bad += 1
                    c.log(f"FAIL tile {tile} splits {s} rows "
                          f"{rows} {n_in}->{n_out}: max_abs_err {err:.3e} "
                          f"tol {tol:.3e}")
                times[(tile, s)] = c.cuda_ms(fn, flush)
            parts = []
            for (tile, s), ms in sorted(times.items(), key=lambda kv: kv[1]):
                mark = "*" if (tile, s) == pick else ""
                parts.append(f"{mark}m{tile}/s{s} {ms:.4f}")
            c.log(f"sweep rows {rows} {n_in}->{n_out} (bound {bnd[0]:.4f} "
                  f"ms, {bnd[1]}): " + ", ".join(parts))
            if profile:
                by_kernel = kernel_split(
                    lambda: i4.int4_matmul(x, packed, scale), flush)
                c.log(f"profile rows {rows} {n_in}->{n_out} (plan "
                      f"m{pick[0]}/s{pick[1]}): " + ", ".join(
                          f"{name[:40]} {us:.2f} us"
                          for name, us in by_kernel.items()))
    return bad


def main(argv) -> int:
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("int4_sweep: no CUDA device")
    c.log(f"card: {c.nvidia_smi_line()}")
    c.build_kernels()
    bad = sweep(torch.device("cuda", 0), "--quick" in argv,
                "--profile" in argv)
    c.log(f"int4_sweep: {bad} variants disagree with the plain version")
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
