"""W4A8 int4 weight matmul: CUDA kernel + its plain PyTorch version
(reference: seedx_tpu/ops/int4_matmul.py, the Pallas kernel ``_kernel``).

Packing (must match ``utils/quantize.quantize_kernel_int4`` in both
packages): byte [r, c] of ``packed`` [in//2, out] holds W[2r, c] in its lo
nibble and W[2r+1, c] in its hi nibble, two's-complement int4; ``scale``
[in//group, out] fp32.  W4A8: x is quantized per row to int8 (absmax/127,
round half to even), each group runs an exact int32 dot, the fp32 group
scale multiplies the dot, and the row scale multiplies the sum.

Kernel source and design note: ``seedx_tpu_torch/csrc/int4_w4a8.cu``.
``int4_matmul`` launches it for CUDA tensors and runs ``int4_matmul_plain``
for CPU tensors.  ``int4_matmul_unpack`` ports the JAX package's W4A16
``int4_matmul_xla`` (unpack to bf16, then a dense dot).  ``int4_matmul_auto``
dispatches as the reference's does: W4A8 up to ``MAX_KERNEL_ROWS`` rows,
W4A16 above, on every device.
"""

from __future__ import annotations

import ctypes

import torch

from seedx_tpu_torch.ops._build import check, load_library, sm_count

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {"int4_w4a8_bf16": [_P] * 7 + [_I] * 7 + [_P]}


def library() -> ctypes.CDLL:
    return load_library("int4_w4a8", "int4_w4a8.cu", _SIGNATURES)


def unpack_int4(packed: torch.Tensor) -> torch.Tensor:
    """uint8 [..., in//2, out] -> int8 [..., in, out] (row-pair nibbles)."""
    b = packed.to(torch.int16)
    lo = ((b & 0xF) ^ 8) - 8
    hi = (((b >> 4) & 0xF) ^ 8) - 8
    *lead, half, n_out = packed.shape
    return torch.stack([lo, hi], dim=-2).reshape(*lead, 2 * half,
                                                 n_out).to(torch.int8)


def quantize_rows(x: torch.Tensor):
    """Per-row int8 activation quantization: (x8 int8, xa fp32 [rows, 1])."""
    xf = x.float()
    xa = torch.clamp(xf.abs().amax(dim=-1, keepdim=True), min=1e-8) / 127.0
    return torch.round(xf / xa).to(torch.int8), xa


def int4_matmul_plain(x: torch.Tensor, packed: torch.Tensor,
                      scale: torch.Tensor) -> torch.Tensor:
    """The kernel's contract in plain torch.  Group dots run as fp32
    matmuls of integers: |dot| <= 127 * 8 * group < 2**24 for the groups
    used here (<= 13824), so every group sum is exact; the group scales
    then accumulate in group order, as the TPU kernel does."""
    rows, n_in = x.shape
    n_groups, n_out = scale.shape
    group = n_in // n_groups
    x8, xa = quantize_rows(x)
    w = unpack_int4(packed).float().reshape(n_groups, group, n_out)
    xg = x8.float().reshape(rows, n_groups, group).transpose(0, 1)
    dots = torch.bmm(xg, w)                          # [groups, rows, out]
    acc = torch.zeros((rows, n_out), dtype=torch.float32, device=x.device)
    for g in range(n_groups):
        acc += dots[g] * scale[g].float()
    return (acc * xa).to(x.dtype)


def _launch_shape(rows: int, n_out: int, n_groups: int, sms: int):
    """(rows per thread, groups per split, splits): split the group range
    across blocks until the grid covers the SMs about twice."""
    tm = 1 if rows == 1 else 16
    blocks = -(-rows // tm) * -(-n_out // 512)
    want = max(1, min(n_groups, -(-2 * sms // blocks)))
    per_split = -(-n_groups // want)
    return tm, per_split, -(-n_groups // per_split)


def int4_matmul(x: torch.Tensor, packed: torch.Tensor,
                scale: torch.Tensor) -> torch.Tensor:
    """x [rows, in] @ dequant(packed [in//2, out], scale [in/g, out]) ->
    [rows, out] in x's dtype.  Wrapper: kernel for CUDA tensors, plain
    version for CPU tensors."""
    rows, n_in = x.shape
    n_groups, n_out = scale.shape
    if packed.shape != (n_in // 2, n_out) or n_in % n_groups:
        raise ValueError(f"int4_matmul: x {tuple(x.shape)} packed "
                         f"{tuple(packed.shape)} scale {tuple(scale.shape)}")
    if not x.is_cuda:
        return int4_matmul_plain(x, packed, scale)
    group = n_in // n_groups
    if x.dtype != torch.bfloat16:
        raise ValueError(f"int4_matmul: x must be bf16 on CUDA, got {x.dtype}")
    if packed.dtype != torch.uint8 or scale.dtype != torch.float32:
        raise ValueError("int4_matmul: packed must be uint8, scale float32")
    for name, t in (("x", x), ("packed", packed), ("scale", scale)):
        if t.device != x.device or not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"int4_matmul: {name} must be contiguous, "
                             f"16-byte aligned and on {x.device}")
    if n_in % 4 or n_out % 4 or group % 4:
        raise ValueError("int4_matmul: in, out and group must be multiples "
                         "of 4")
    tm, per_split, n_split = _launch_shape(rows, n_out, n_groups,
                                           sm_count(x.device.index or 0))
    out = torch.empty((rows, n_out), dtype=x.dtype, device=x.device)
    x8 = torch.empty((rows, n_in), dtype=torch.int8, device=x.device)
    xa = torch.empty((rows,), dtype=torch.float32, device=x.device)
    partial = (torch.empty((n_split, rows, n_out), dtype=torch.float32,
                           device=x.device) if n_split > 1 else None)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = library().int4_w4a8_bf16(
        x.data_ptr(), packed.data_ptr(), scale.data_ptr(), out.data_ptr(),
        x8.data_ptr(), xa.data_ptr(),
        partial.data_ptr() if partial is not None else None,
        rows, n_in, n_out, group, per_split, n_split, tm, stream)
    check(err, "int4_w4a8_bf16")
    int4_matmul.launches += 1
    return out


int4_matmul.launches = 0


def int4_matmul_unpack(x: torch.Tensor, packed: torch.Tensor,
                       scale: torch.Tensor) -> torch.Tensor:
    """W4A16 reference (``int4_matmul_xla``): unpack to bf16, scale per
    group in bf16, one dense bf16 dot."""
    n_groups, n_out = scale.shape
    n_in = 2 * packed.shape[0]
    w = unpack_int4(packed).to(torch.bfloat16).reshape(
        n_groups, n_in // n_groups, n_out) * scale[:, None, :].to(
            torch.bfloat16)
    return x.to(torch.bfloat16) @ w.reshape(n_in, n_out)


# rows above which the reference's int4_matmul_auto takes its W4A16 branch
MAX_KERNEL_ROWS = 2048


def int4_branch(rows: int) -> str:
    """"w4a8" (``int4_matmul``) or "w4a16" (``int4_matmul_unpack``)."""
    return "w4a8" if rows <= MAX_KERNEL_ROWS else "w4a16"


def int4_matmul_auto(x: torch.Tensor, packed: torch.Tensor,
                     scale: torch.Tensor) -> torch.Tensor:
    """Leading dims flattened into rows, then ``int4_matmul`` up to
    ``MAX_KERNEL_ROWS`` rows and ``int4_matmul_unpack`` (bf16 out) above,
    as ``seedx_tpu/ops/int4_matmul.py`` ``int4_matmul_auto`` dispatches
    under ``FORCE_KERNEL`` or on the TPU."""
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1])
    if int4_branch(x2.shape[0]) == "w4a8":
        y = int4_matmul(x2.contiguous(), packed, scale)
    else:
        y = int4_matmul_unpack(x2, packed, scale)
    return y.reshape(*lead, y.shape[-1])
