"""Time K3 (``seedx_tpu_torch/csrc/decode_attn.cu``) on one GPU at each
of its main-path rows (``chip_smoke.DECODE_ROWS`` and ``STAIR_ROWS``) at
every split count up to 16: the times the split rule of ``plan`` in
``seedx_tpu_torch/ops/decode_attention.py`` is chosen from.  With
``--parts``, also K3 built with parts of its tile loop cut out, at a few
rows: what the memory pipeline alone, the arithmetic alone and the loop
without P V take, beside a one-element PyTorch kernel (the timing's
floor).

    python3 decode_sweep.py [--parts]

Each (row, split count) runs ``chip_smoke.check_decode`` or
``check_stair`` with the count forced, so every count is held to K3's
limits against the plain version and timed as the smoke's rows are.  After
their own lines, one ``sweep`` line a row gives the ms at each count,
first (``*``) the one ``plan`` picks.  The parts' builds compute wrong
outputs by design and are only timed.  Exits non-zero if any count
disagrees with the plain version.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys

import chip_smoke as c

SPLITS = (1, 2, 3, 4, 6, 8, 12, 16)
# text cut into a copy of the kernel source for each part: after the
# tile's copy is issued the loop goes on to the next tile ("memory"), the
# loop issues no copies and computes on whatever the ring holds
# ("arithmetic"), the loop stops before P V ("no P V")
_COPY_LINE = "    issue(it + kStages - 1);\n"
_PV = "    // O += P V: keys"
_SKIP = "    if (p.scale > 0.f) continue;\n"
PARTS = {"memory": (_COPY_LINE, _COPY_LINE + _SKIP),
         "arithmetic": (_COPY_LINE, "    cp_async_commit();\n"),
         "no P V": (_PV, _SKIP + _PV)}
# (name, B, w (0: one query), S, Hq, Hkv, D, int8, windows)
PART_ROWS = (("int8 B8 windows [0, 1280)", 8, 0, 1280, 40, 40, 128, True,
              ((0, 1280),) * 8),
             ("bf16 B8 windows [0, 1280)", 8, 0, 1280, 40, 40, 128, False,
              ((0, 1280),) * 8),
             ("int8 B8 windows 8", 8, 0, 1280, 40, 40, 128, True,
              c.WINDOWS_8),
             ("int8 B1 window 300", 1, 0, 1280, 40, 40, 128, True,
              ((0, 300),)),
             ("int8 B8 empty windows", 8, 0, 1280, 40, 40, 128, True,
              ((0, 0),) * 8),
             ("stair int8 w16", 8, 16, 640, 40, 40, 128, True,
              tuple((0, e) for e in c.STAIR_ENDS_8)))


def sweep(dev, g, flush) -> int:
    from seedx_tpu_torch.ops import decode_attention as da

    plan = da.plan
    bad = 0
    try:
        for check, rows in ((c.check_decode, c.DECODE_ROWS),
                            (c.check_stair, c.STAIR_ROWS)):
            for row in rows:
                picked, times = [], []
                s = row[2] if check is c.check_decode else c.STAIR_S
                # 0 first: the count plan picks, then every count in SPLITS
                for n in [0] + [x for x in SPLITS if x <= -(-s // da.TILE)]:
                    def forced(b, w, g_, hkv, s_, sms, splits=0, n=n):
                        picked.append(plan(b, w, g_, hkv, s_, sms)[2])
                        return plan(b, w, g_, hkv, s_, sms, n)

                    da.plan = forced
                    r, = check(dev, g, flush, rows=(row,))
                    bad += not r["ok"]
                    times.append(f"s{n or picked[-1]}{'' if n else '*'} "
                                 f"{r['ms']:.4f}")
                lib = ("" if r["library_ms"] is None
                       else f"library {r['library_ms']:.4f} ms | ")
                c.log(f"sweep {row[0]}: {lib}K3 ms by split count "
                      + " | ".join(times))
    finally:
        da.plan = plan
    return bad


def part_inputs(dev, g, b, w, s, hq, hkv, d, int8, windows):
    import torch

    from seedx_tpu_torch.models.llama import quantize_kv

    q = torch.randn((b, w, hq, d) if w else (b, hq, d), generator=g,
                    device=dev).to(torch.bfloat16)
    k, v = (torch.randn((b, s, hkv, d), generator=g, device=dev
                        ).to(torch.bfloat16) for _ in range(2))
    kw = {}
    if int8:
        (k, ks), (v, vs) = quantize_kv(k), quantize_kv(v)
        kw = dict(k_scale=ks[..., 0].contiguous(),
                  v_scale=vs[..., 0].contiguous())
    st, en = (torch.tensor([x[i] for x in windows], dtype=torch.int32,
                           device=dev) for i in (0, 1))
    return q, k.reshape(b, s, -1), v.reshape(b, s, -1), st, en, kw


def parts(dev, g, flush) -> None:
    import torch

    from seedx_tpu_torch.ops import _build
    from seedx_tpu_torch.ops import decode_attention as da

    with open(os.path.join(_build.CSRC, "decode_attn.cu")) as f:
        source = f.read()
    os.makedirs(_build.BUILD_DIR, exist_ok=True)
    libs = {"whole": da.library()}
    procs = {}
    for name, (old, new) in PARTS.items():
        if source.count(old) != 1:
            raise SystemExit(f"decode_sweep: part {name!r}: its anchor is "
                             f"not in decode_attn.cu once")
        stem = os.path.join(_build.BUILD_DIR,
                            "part_" + name.replace(" ", "_"))
        with open(stem + ".cu", "w") as f:
            f.write(source.replace(old, new))
        procs[name] = (stem, subprocess.Popen(
            [_build.nvcc_path(), *_build.NVCC_FLAGS, "-o", stem + ".so",
             stem + ".cu"], stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True))
    for name, (stem, proc) in procs.items():
        _, err = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"decode_sweep: part {name!r} did not build:\n"
                             f"{err[-3000:]}")
        lib = ctypes.CDLL(stem + ".so")
        lib.decode_attn.argtypes = da._SIGNATURES["decode_attn"]
        lib.decode_attn.restype = ctypes.c_int
        libs[name] = lib
    one = torch.zeros(1, device=dev)
    floor = c.cuda_ms(lambda: one.add_(1), flush)
    c.log(f"parts: a one-element PyTorch kernel {floor:.4f} ms (the "
          f"timing's floor)")
    library = da.library
    try:
        for row in PART_ROWS:
            q, k, v, st, en, kw = part_inputs(dev, g, *row[1:])
            times = []
            for name, lib in libs.items():
                da.library = lambda lib=lib: lib
                ms = c.cuda_ms(lambda: da.ragged_decode_attention(
                    q, k, v, st, en, **kw), flush)
                times.append(f"{name} {ms:.4f}")
            c.log(f"parts {row[0]}: ms " + " | ".join(times))
    finally:
        da.library = library


def main(argv) -> int:
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("decode_sweep: no CUDA device")
    c.log(f"card: {c.nvidia_smi_line()}")
    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev).manual_seed(0)
    flush = torch.empty(96 << 20, dtype=torch.uint8, device=dev)
    bad = sweep(dev, g, flush)
    if "--parts" in argv:
        parts(dev, g, flush)
    c.log(f"decode_sweep: {bad} (row, split count) pairs disagree with the "
          f"plain version")
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
