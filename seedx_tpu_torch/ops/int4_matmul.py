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
``int4_matmul_xla``: ``dequant_int4`` unpacks the weight to bf16 (for CUDA
tensors one pass of the kernel in ``csrc/int4_dequant.cu``, bit-equal to
the plain chain ``dequant_int4_plain`` that CPU tensors run), then a dense
dot.  ``int4_matmul_auto`` dispatches as the reference's does: W4A8 up to
``MAX_KERNEL_ROWS`` rows, W4A16 above, on every device.

``row_amax`` (fp32 [rows, 1]) gives the row quantization each row's absmax
from outside: a rank holding a row-parallel shard ``x[:, in/t]`` of a
projection passes the absmax of the whole row (an all-reduce MAX over the
tensor group), so every rank quantizes against the unsharded row's scale
and the partial products sum to the unsharded W4A8 result.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from seedx_tpu_torch.ops._build import (TicketPool, launch, load_library,
                                     register, sm_count)

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {"int4_w4a8_bf16": [_P] * 6 + [_I] * 6 + [_P, _P],
               "int4_w4a8_fragments_debug": [_P, _P, _P]}
_DQ_SIGNATURES = {"int4_dequant_bf16": [_P] * 3 + [_I] * 3 + [_P]}

BN = 128             # output columns a block of the kernel
ROW_TILES = (16, 32, 64)   # rows a block: the kernel's built m-tile counts
SPLIT_FILL = 2       # blocks an SM the split count aims for
SPLIT_GROUPS = 10    # groups a split walks at most on the 16- / 32-row tiles
MAX_SPLITS = 64      # the kernel's limit
BANDS = ("1", "2-16", "17-64", "65-2048")   # ``row_band``'s bands
_tickets = TicketPool()
# launch counters: every launch, by row tile, by row band
_TILE_COUNTS = {t: f"int4_w4a8 m{t}" for t in ROW_TILES}
_BAND_COUNTS = {b: f"int4_w4a8 rows {b}" for b in BANDS}
register("int4_w4a8", *_TILE_COUNTS.values(), *_BAND_COUNTS.values())
register("int4_dequant")


def library() -> ctypes.CDLL:
    return load_library("int4_w4a8", "int4_w4a8.cu", _SIGNATURES)


def dequant_library() -> ctypes.CDLL:
    return load_library("int4_dequant", "int4_dequant.cu", _DQ_SIGNATURES)


def unpack_int4(packed: torch.Tensor) -> torch.Tensor:
    """uint8 [..., in//2, out] -> int8 [..., in, out] (row-pair nibbles)."""
    b = packed.to(torch.int16)
    lo = ((b & 0xF) ^ 8) - 8
    hi = (((b >> 4) & 0xF) ^ 8) - 8
    *lead, half, n_out = packed.shape
    return torch.stack([lo, hi], dim=-2).reshape(*lead, 2 * half,
                                                 n_out).to(torch.int8)


def row_absmax(x: torch.Tensor) -> torch.Tensor:
    """fp32 [rows, 1]: each row's absmax (what ``quantize_rows`` scales by)."""
    return x.float().abs().amax(dim=-1, keepdim=True)


def quantize_rows(x: torch.Tensor, row_amax: Optional[torch.Tensor] = None):
    """Per-row int8 activation quantization: (x8 int8, xa fp32 [rows, 1]);
    ``row_amax`` [rows, 1] replaces the rows' own absmax."""
    xf = x.float()
    amax = row_absmax(x) if row_amax is None else row_amax.float()
    xa = torch.clamp(amax, min=1e-8) / 127.0
    return torch.round(xf / xa).to(torch.int8), xa


def plan(rows: int, n_in: int, n_out: int, group: int, sms: int,
         tile: int = 0, splits: int = 0):
    """(rows a block, splits) of a kernel launch.  The 16-row tile up to 16
    rows; above, of the 32- and 64-row tiles the one that pads the rows
    least, the 64-row tile on a tie (32 at 17-32 and 65-96 rows, 64 at
    33-64, 97-128 and every multiple of 64; ``int4_sweep.py``).  Then,
    where the row x column tiles number fewer than SPLIT_FILL blocks an
    SM, the group range split into that many more blocks; on the 16- and
    32-row tiles, which stream weights (more blocks keep more bytes in
    flight), also into splits of at most SPLIT_GROUPS groups (the 64-row
    tile is mostly tensor-core work, and each split adds its partials).
    At most one split a group and MAX_SPLITS, ceil(groups / splits) groups
    a split, none empty.  ``tile`` / ``splits`` > 0 force them."""
    if tile <= 0:
        pad32, pad64 = -(-rows // 32) * 32, -(-rows // 64) * 64
        tile = 16 if rows <= 16 else 32 if pad32 < pad64 else 64
    elif tile not in ROW_TILES:
        raise ValueError(f"int4_matmul: row tile {tile} not in {ROW_TILES}")
    n_groups = n_in // group
    if splits <= 0:
        tiles = -(-rows // tile) * -(-n_out // BN)
        splits = -(-SPLIT_FILL * sms // tiles)
        if tile < 64:
            splits = max(splits, -(-n_groups // SPLIT_GROUPS))
    splits = max(1, min(splits, n_groups, MAX_SPLITS))
    per = -(-n_groups // splits)
    return tile, -(-n_groups // per)


def split_ranges(n_groups: int, splits: int):
    """The group ranges [g0, g1) of the kernel's splits, in split order."""
    per = -(-n_groups // splits)
    return [(g0, min(g0 + per, n_groups)) for g0 in range(0, n_groups, per)]


def int4_matmul_split_plain(x: torch.Tensor, packed: torch.Tensor,
                            scale: torch.Tensor, splits: int,
                            row_amax: Optional[torch.Tensor] = None
                            ) -> torch.Tensor:
    """The kernel's arithmetic at ``splits`` splits in plain torch.  Group
    dots run as fp32 matmuls of integers: |dot| <= 127 * 8 * group < 2**24
    for the groups used here (<= 13824), so every group sum is exact; each
    split accumulates its groups' scaled dots in group order from zero, the
    partials are summed from zero in split order, then times the row scale,
    one rounding to x's dtype."""
    rows, n_in = x.shape
    n_groups, n_out = scale.shape
    group = n_in // n_groups
    x8, xa = quantize_rows(x, row_amax)
    w = unpack_int4(packed).float().reshape(n_groups, group, n_out)
    xg = x8.float().reshape(rows, n_groups, group).transpose(0, 1)
    dots = torch.bmm(xg, w)                          # [groups, rows, out]
    acc = torch.zeros((rows, n_out), dtype=torch.float32, device=x.device)
    for g0, g1 in split_ranges(n_groups, splits):
        part = torch.zeros_like(acc)
        for g in range(g0, g1):
            part = part + dots[g] * scale[g].float()
        acc = acc + part
    return (acc * xa).to(x.dtype)


def int4_matmul_plain(x: torch.Tensor, packed: torch.Tensor,
                      scale: torch.Tensor,
                      row_amax: Optional[torch.Tensor] = None
                      ) -> torch.Tensor:
    """The kernel's contract in plain torch: one split, the group scales
    accumulated in group order, as the TPU kernel does."""
    return int4_matmul_split_plain(x, packed, scale, 1, row_amax)


def workspace_bytes(rows: int, n_in: int, n_out: int, group: int,
                    splits: int) -> int:
    """Scratch of one kernel call (the layout ``int4_w4a8_bf16`` reads):
    x8 [rows][groups * gp] (gp: group rounded up to 32), xa [rows] and, for
    splits > 1, the fp32 partials [splits][rows][n_out], each on a 16-byte
    boundary."""
    gp = -(-group // 32) * 32
    x8 = -(-rows * (n_in // group) * gp // 16) * 16
    part = splits * rows * n_out * 4 if splits > 1 else 0
    return x8 + -(-rows * 4 // 16) * 16 + part


def row_band(rows: int) -> str:
    """The band of a call's row count in the launch histogram."""
    return ("1" if rows == 1 else "2-16" if rows <= 16 else "17-64"
            if rows <= 64 else "65-2048")


def int4_matmul(x: torch.Tensor, packed: torch.Tensor,
                scale: torch.Tensor, row_amax: Optional[torch.Tensor] = None,
                *, _tile: int = 0, _splits: int = 0) -> torch.Tensor:
    """x [rows, in] @ dequant(packed [in//2, out], scale [in/g, out]) ->
    [rows, out] in x's dtype.  Wrapper: kernel for CUDA tensors (two
    launches: the row quantization, the matmul; ``_tile`` / ``_splits``
    force ``plan``'s row tile and split count, for tests and sweeps),
    plain version for CPU tensors."""
    rows, n_in = x.shape
    n_groups, n_out = scale.shape
    if packed.shape != (n_in // 2, n_out) or n_in % n_groups:
        raise ValueError(f"int4_matmul: x {tuple(x.shape)} packed "
                         f"{tuple(packed.shape)} scale {tuple(scale.shape)}")
    if row_amax is not None and row_amax.shape != (rows, 1):
        raise ValueError(f"int4_matmul: row_amax {tuple(row_amax.shape)} "
                         f"!= ({rows}, 1)")
    if not x.is_cuda:
        return int4_matmul_plain(x, packed, scale, row_amax)
    group = n_in // n_groups
    if x.dtype != torch.bfloat16:
        raise ValueError(f"int4_matmul: x must be bf16 on CUDA, got {x.dtype}")
    if packed.dtype != torch.uint8 or scale.dtype != torch.float32:
        raise ValueError("int4_matmul: packed must be uint8, scale float32")
    if row_amax is not None:
        row_amax = row_amax.float().contiguous()
    for name, t in (("x", x), ("packed", packed), ("scale", scale),
                    ("row_amax", row_amax)):
        if t is None:
            continue
        if t.device != x.device or not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"int4_matmul: {name} must be contiguous, "
                             f"16-byte aligned and on {x.device}")
    if n_in % 4 or n_out % 16 or group % 4:
        raise ValueError("int4_matmul: in and group must be multiples of 4, "
                         "out of 16")
    tile, splits = plan(rows, n_in, n_out, group,
                        sm_count(x.device.index or 0), _tile, _splits)
    out = torch.empty((rows, n_out), dtype=x.dtype, device=x.device)
    work = torch.empty(workspace_bytes(rows, n_in, n_out, group, splits),
                       dtype=torch.uint8, device=x.device)
    tickets = (_tickets.get(x.device, -(-rows // tile) * -(-n_out // BN))
               if splits > 1 else None)
    launch(library(), "int4_w4a8_bf16", x.device,
           x.data_ptr(), packed.data_ptr(), scale.data_ptr(), out.data_ptr(),
           work.data_ptr(),
           tickets.data_ptr() if tickets is not None else None,
           rows, n_in, n_out, group, tile // 16, splits,
           row_amax.data_ptr() if row_amax is not None else None,
           counts=("int4_w4a8", _TILE_COUNTS[tile],
                   _BAND_COUNTS[row_band(rows)]))
    return out


def b_fragments(tile: torch.Tensor) -> torch.Tensor:
    """The B registers the kernel builds from one packed [64, 128] uint8
    tile on the card: int32 [warp 4][k-step 4][lane 32][n-tile 4][2]."""
    if tile.shape != (64, BN) or tile.dtype != torch.uint8 or not tile.is_cuda:
        raise ValueError("b_fragments: a uint8 [64, 128] CUDA tile")
    regs = torch.empty((4, 4, 32, 4, 2), dtype=torch.int32,
                       device=tile.device)
    launch(library(), "int4_w4a8_fragments_debug", tile.device,
           tile.contiguous().data_ptr(), regs.data_ptr())
    return regs


def dequant_int4_plain(packed: torch.Tensor,
                       scale: torch.Tensor) -> torch.Tensor:
    """The W4A16 weight in plain torch, as ``int4_matmul_xla`` unpacks it:
    the codes to bf16, times the group scale rounded to bf16, the product
    rounded to bf16.  bf16 [in, out]."""
    n_groups, n_out = scale.shape
    n_in = 2 * packed.shape[0]
    w = unpack_int4(packed).to(torch.bfloat16).reshape(
        n_groups, n_in // n_groups, n_out) * scale[:, None, :].to(
            torch.bfloat16)
    return w.reshape(n_in, n_out)


def dequant_int4(packed: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """packed uint8 [in//2, out], scale fp32 [in//group, out] -> the bf16
    weight [in, out] (``dequant_int4_plain``'s bits).  Either may be a
    view: the layer ``packed[li]`` of a stacked weight, a row slice of
    ``scale`` (a tensor-parallel rank's groups).  Wrapper: one launch of
    the kernel for CUDA tensors, the plain chain for CPU tensors."""
    if packed.dim() != 2 or scale.dim() != 2 or \
            scale.shape[1] != packed.shape[1] or not scale.shape[0] or \
            (2 * packed.shape[0]) % scale.shape[0]:
        raise ValueError(f"dequant_int4: packed {tuple(packed.shape)} scale "
                         f"{tuple(scale.shape)}")
    half, n_out = packed.shape
    group = 2 * half // scale.shape[0]
    if group % 2:
        raise ValueError(f"dequant_int4: group {group} is odd (a packed "
                         f"row's two weights must share a group)")
    if packed.dtype != torch.uint8 or scale.dtype != torch.float32:
        raise ValueError(f"dequant_int4: packed must be uint8, scale "
                         f"float32; got {packed.dtype}, {scale.dtype}")
    if scale.device != packed.device:
        raise ValueError(f"dequant_int4: scale on {scale.device}, packed on "
                         f"{packed.device}")
    if not packed.is_cuda:
        return dequant_int4_plain(packed, scale)
    # the kernel loads 8 bytes of packed and 16 of scale at a time
    for name, t, align in (("packed", packed, 8), ("scale", scale, 16)):
        if not t.is_contiguous() or t.data_ptr() % align:
            raise ValueError(f"dequant_int4: {name} must be contiguous and "
                             f"{align}-byte aligned")
    if n_out % 8:
        raise ValueError(f"dequant_int4: out {n_out} is not a multiple of 8")
    w = torch.empty((2 * half, n_out), dtype=torch.bfloat16,
                    device=packed.device)
    launch(dequant_library(), "int4_dequant_bf16", packed.device,
           packed.data_ptr(), scale.data_ptr(), w.data_ptr(), half,
           n_out // 8, group, counts=("int4_dequant",))
    return w


def int4_matmul_unpack(x: torch.Tensor, packed: torch.Tensor,
                       scale: torch.Tensor) -> torch.Tensor:
    """W4A16 reference (``int4_matmul_xla``): the weight unpacked to bf16
    (``dequant_int4``), one dense bf16 dot."""
    return x.to(torch.bfloat16) @ dequant_int4(packed, scale)


# rows above which the reference's int4_matmul_auto takes its W4A16 branch
MAX_KERNEL_ROWS = 2048


def int4_branch(rows: int) -> str:
    """"w4a8" (``int4_matmul``) or "w4a16" (``int4_matmul_unpack``)."""
    return "w4a8" if rows <= MAX_KERNEL_ROWS else "w4a16"


def int4_matmul_auto(x: torch.Tensor, packed: torch.Tensor,
                     scale: torch.Tensor,
                     row_amax: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Leading dims flattened into rows, then ``int4_matmul`` up to
    ``MAX_KERNEL_ROWS`` rows and ``int4_matmul_unpack`` (bf16 out) above,
    as ``seedx_tpu/ops/int4_matmul.py`` ``int4_matmul_auto`` dispatches
    under ``FORCE_KERNEL`` or on the TPU.  ``row_amax`` [..., 1] (the W4A8
    branch only: W4A16 does not quantize x) as ``int4_matmul``'s."""
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1])
    if int4_branch(x2.shape[0]) == "w4a8":
        y = int4_matmul(x2.contiguous(), packed, scale,
                        None if row_amax is None else row_amax.reshape(-1, 1))
    else:
        y = int4_matmul_unpack(x2, packed, scale)
    return y.reshape(*lead, y.shape[-1])
