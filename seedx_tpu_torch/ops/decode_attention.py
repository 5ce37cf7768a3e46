"""Ragged (and optionally paged) decode attention: CUDA kernel + its plain
PyTorch version (reference: seedx_tpu/ops/decode_attention.py, the Pallas
kernel ``_decode_kernel``, in both of its modes).

One query token per batch row attends only the valid window
``[starts[b], ends[b])`` of that row's KV cache, in the flat layout of
``models/llama.py``: ``[B, S, Hkv * D]`` (or, paged, a shared pool
``[P * page, Hkv * D]`` whose logical tile j of row b is pool tile
``block_tables[b, j]``).  The cache holds bf16 values, or int8 codes with
per-(position, head) scales ``[B, S, Hkv]`` (pool: ``[P * page, Hkv]``).
Query head h reads kv head ``h // G`` (G = Hq / Hkv).  The output is
``[B, Hq, D]`` in q's dtype; a row with an empty window gives zeros.

Multi-query "stair" mode (the continuous engine's fused prefill step): a
q of ``[B, w, Hq, D]`` holds w query slots per row; slot i sits at
position ``ends[b] - 1 + i`` and attends ``[starts[b], min(ends[b] + i,
s_limit))``, where ``s_limit`` is the logical cache length (S, or
``block_tables.shape[1] * page`` when paged).  The output is
``[B, w, Hq, D]``.  Slots past a row's real width compute over a finite
window and the caller discards them.  A 3-D q is the one-query mode; a
4-D q with w == 1 gives the same output.

The JAX function takes a ``layer`` scalar so its kernel can read one
layer of the stacked cache without a copy; here ``cache[li]`` is a view,
so there is no such argument.  Its scale operands are lane-padded to 128
(a Mosaic DMA rule); here they stay ``Hkv`` wide.

Kernel source and design note: ``seedx_tpu_torch/csrc/decode_attn.cu``.
``ragged_decode_attention`` launches it for CUDA tensors and runs
``ragged_decode_attention_plain`` for CPU tensors; there is no other
fallback.  The launch counter ``"decode_attn"`` (``ops/_build.py``)
counts every launch, ``"decode_attn one_query"`` (3-D q) and
``"decode_attn multi_query"`` (4-D q) split it by mode.  ``plan`` is the
launch's host-side shape (query slots per block, split count);
``split_ranges`` and
``ragged_decode_attention_split_plain`` are the kernel's window split and
partial merge in plain torch, for the tests.
"""

from __future__ import annotations

import ctypes

import torch

from seedx_tpu_torch.ops._build import (TicketPool, launch, load_library,
                                     register, sm_count)

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {"decode_attn": [_P] * 11 + [_I] * 11 + [ctypes.c_float, _P]}
HEAD_DIMS = (32, 64, 128)
MAX_GROUPS = 16      # q heads a kv head (Nemotron-H's GQA: 32 over 2)
TILE = 64            # window positions per ring stage of the kernel
MAX_ROWS = 64        # query vectors (slots x grouped heads) a block holds
SPLIT_TILES = 10     # tiles a split walks at most, for fewer than
SPLIT_ROWS = 8       # SPLIT_ROWS query vectors a block
MAX_SPLITS = 32      # the kernel's merge holds m, l of each in shared memory
_tickets = TicketPool()
# launch counters: every launch, by q's rank (one query a row, the stair)
_MODE_COUNTS = {3: "decode_attn one_query", 4: "decode_attn multi_query"}
register("decode_attn", *_MODE_COUNTS.values())


def library() -> ctypes.CDLL:
    return load_library("decode_attn", "decode_attn.cu", _SIGNATURES)


def plan(b: int, w: int, g: int, hkv: int, s: int, sms: int,
         splits: int = 0):
    """(query slots per block, slot groups, window splits) of a launch
    over B rows, w slots, G q heads per kv head, Hkv kv heads and a
    logical cache of S positions on ``sms`` SMs.  A block holds at most
    MAX_ROWS query vectors, so a row's w * G vectors take as few groups as
    that allows (each group reads the window once) with the slots spread
    evenly over them.  The split count comes from S alone (the windows
    stay on the device): enough blocks for every SM, and for a block of
    fewer than SPLIT_ROWS query vectors at most SPLIT_TILES tiles a split
    (each split's partials and their merge cost its rows' bytes, so a
    wider block splits only to fill the SMs); at most one split per
    64-position tile of S and MAX_SPLITS.  ``splits`` > 0 forces it."""
    per = MAX_ROWS // g
    groups = -(-w // per)
    ql = -(-w // groups)
    if splits <= 0:
        tiles = max(-(-s // TILE), 1)
        splits = -(-sms // (hkv * b * groups))
        if ql * g < SPLIT_ROWS:
            splits = max(splits, -(-tiles // SPLIT_TILES))
        splits = min(splits, tiles, MAX_SPLITS)
    elif splits > MAX_SPLITS:
        raise ValueError(f"ragged_decode_attention: at most {MAX_SPLITS} "
                         f"splits, got {splits}")
    return ql, groups, splits


def split_ranges(start: int, end: int, splits: int):
    """The live chunks [p0, p1) into which the kernel cuts a window
    [start, end) for ``splits`` splits: whole 64-position tiles counted
    from start, the same number in each but the last; splits past the
    window's tiles get none."""
    start = max(start, 0)
    tiles = -(-max(end - start, 0) // TILE)
    if not tiles:
        return []
    chunk = -(-tiles // splits)
    return [(start + i * chunk * TILE, min(start + (i + 1) * chunk * TILE,
                                           end))
            for i in range(-(-tiles // chunk))]


def _geometry(q, k_cache, block_tables, page):
    """(B, w, Hq, D, Hkv, G, logical cache length) with the contract
    checks shared by both versions; w is 1 for a 3-D q."""
    if q.dim() == 3:
        (b, hq, d), w = q.shape, 1
    elif q.dim() == 4:
        b, w, hq, d = q.shape
    else:
        raise ValueError(f"ragged_decode_attention: q is [B, Hq, D] or "
                         f"[B, w, Hq, D], got {tuple(q.shape)}")
    f = k_cache.shape[-1]
    if f % d or hq % (f // d):
        raise ValueError(f"ragged_decode_attention: q {tuple(q.shape)} does "
                         f"not fit a cache row of {f}")
    hkv = f // d
    if block_tables is not None:
        if page <= 0 or k_cache.dim() != 2 or k_cache.shape[0] % page:
            raise ValueError("ragged_decode_attention: a paged pool is "
                             "[P * page, Hkv * D] with page > 0")
        if block_tables.shape[0] != b:
            raise ValueError("ragged_decode_attention: block_tables rows "
                             "must match the batch")
        s = block_tables.shape[1] * page
    else:
        if k_cache.dim() != 3 or k_cache.shape[0] != b:
            raise ValueError("ragged_decode_attention: a dense cache is "
                             "[B, S, Hkv * D]")
        s = k_cache.shape[1]
    return b, w, hq, d, hkv, hq // hkv, s


def _logical_rows(x, block_tables, page, s):
    """Dense [B, S, ...] view of a cache or scale leaf (a gather through
    the block tables for a paged pool)."""
    if block_tables is None:
        return x
    pos = torch.arange(s, device=x.device)
    rows = (block_tables.long()[:, pos // page] * page + pos % page)
    return x[rows]


def ragged_decode_attention_plain(q, k_cache, v_cache, starts, ends, *,
                                  k_scale=None, v_scale=None,
                                  block_tables=None, page: int = 0
                                  ) -> torch.Tensor:
    """The kernel's contract in plain torch, in both modes, with the JAX
    kernel's arithmetic: q and k as bf16 values, fp32 dot products, the
    softmax scale and then the k scale applied after the dot, fp32 softmax
    over each query's window, ``p * v_scale`` rounded to bf16 before it
    weights v, and ``acc / max(l, 1e-30)`` in q's dtype.  The softmax
    scale is 1/sqrt(D), the only one the model uses."""
    b, w, hq, d, hkv, g, s = _geometry(q, k_cache, block_tables, page)
    k = _logical_rows(k_cache, block_tables, page, s).reshape(b, s, hkv, d)
    v = _logical_rows(v_cache, block_tables, page, s).reshape(b, s, hkv, d)
    qg = q.to(torch.bfloat16).float().reshape(b, w, hkv, g, d)
    sc = torch.einsum("bwkgd,bskd->bwkgs", qg,
                      k.to(torch.bfloat16).float()) * d ** -0.5
    if k_scale is not None:
        ks = _logical_rows(k_scale, block_tables, page, s)
        sc = sc * ks.to(torch.bfloat16).float().permute(0, 2, 1)[
            :, None, :, None]
    pos = torch.arange(s, device=q.device)
    slot = torch.arange(w, device=q.device)
    # the stair: slot i ends i positions after slot 0, at most at s
    q_end = torch.clamp(ends.to(q.device).long()[:, None] + slot, max=s)
    valid = ((pos >= starts.to(q.device).long()[:, None, None])
             & (pos < q_end[:, :, None]))               # [B, w, S]
    valid = valid[:, :, None, None, :]
    sc = torch.where(valid, sc, float("-inf"))
    m = sc.amax(dim=-1, keepdim=True)
    p = torch.where(valid, torch.exp(sc - torch.where(valid.any(-1, True),
                                                      m, 0.0)), 0.0)
    l_sum = p.sum(dim=-1)
    if v_scale is not None:
        vs = _logical_rows(v_scale, block_tables, page, s)
        p = p * vs.float().permute(0, 2, 1)[:, None, :, None]
    acc = torch.einsum("bwkgs,bskd->bwkgd", p.to(torch.bfloat16).float(),
                       v.float())
    out = acc / torch.clamp(l_sum, min=1e-30)[..., None]
    return out.reshape(q.shape).to(q.dtype)


def ragged_decode_attention_split_plain(q, k_cache, v_cache, starts, ends,
                                        *, splits: int, slots: int = 0,
                                        k_scale=None, v_scale=None,
                                        block_tables=None, page: int = 0
                                        ) -> torch.Tensor:
    """The kernel's split and merge in plain torch: each group of
    ``slots`` query slots (all of them by default) cuts its window
    [start, its last slot's stair end) as ``split_ranges`` does; each
    chunk gives fp32 partials (m, l, acc) with the plain version's
    arithmetic (p rounded to bf16 against the chunk's maximum), merged in
    chunk order as acc * w / (l * w) with w = exp(m - max m), 0 for a
    chunk with no position."""
    b, w, hq, d, hkv, g, s = _geometry(q, k_cache, block_tables, page)
    k = _logical_rows(k_cache, block_tables, page, s).reshape(b, s, hkv, d)
    v = _logical_rows(v_cache, block_tables, page, s).reshape(b, s, hkv, d)
    qg = q.to(torch.bfloat16).float().reshape(b, w, hkv, g, d)
    sc = torch.einsum("bwkgd,bskd->bwkgs", qg,
                      k.to(torch.bfloat16).float()) * d ** -0.5
    if k_scale is not None:
        ks = _logical_rows(k_scale, block_tables, page, s)
        sc = sc * ks.to(torch.bfloat16).float().permute(0, 2, 1)[
            :, None, :, None]
    dev = q.device
    pos = torch.arange(s, device=dev)
    slot = torch.arange(w, device=dev)
    st = torch.clamp(starts.to(dev).long(), min=0)[:, None]       # [B, 1]
    en = ends.to(dev).long()[:, None]
    valid = ((pos >= st[..., None])
             & (pos < torch.clamp(en + slot, max=s)[..., None]))  # [B, w, S]
    # each slot's group window and the kernel's chunk of each position
    per = slots or w
    last = torch.clamp((slot // per + 1) * per, max=w) - 1
    e_grp = torch.maximum(torch.clamp(en + last, max=s), st)      # [B, w]
    tiles = (e_grp - st + TILE - 1) // TILE
    chunk = torch.clamp((tiles + splits - 1) // splits, min=1) * TILE
    part = (pos - st[..., None]) // chunk[..., None]              # [B, w, S]
    vs = (None if v_scale is None else _logical_rows(
        v_scale, block_tables, page, s).float().permute(0, 2, 1)[
            :, None, :, None])
    ms, ls, accs = [], [], []
    for i in range(splits):
        ok = (valid & (part == i))[:, :, None, None, :]
        x = torch.where(ok, sc, float("-inf"))
        m = x.amax(dim=-1)
        p = torch.where(ok, torch.exp(x - torch.where(
            torch.isfinite(m), m, 0.0)[..., None]), 0.0)
        ls.append(p.sum(dim=-1))
        if vs is not None:
            p = p * vs
        accs.append(torch.einsum("bwkgs,bskd->bwkgd",
                                 p.to(torch.bfloat16).float(), v.float()))
        ms.append(m)
    m_all = torch.stack(ms).amax(dim=0)
    l_sum = torch.zeros_like(ls[0])
    acc = torch.zeros_like(accs[0])
    for m, l_i, a in zip(ms, ls, accs):
        wt = torch.where(torch.isfinite(m), torch.exp(m - m_all), 0.0)
        l_sum = l_sum + l_i * wt
        acc = acc + a * wt[..., None]
    out = acc / torch.clamp(l_sum, min=1e-30)[..., None]
    return out.reshape(q.shape).to(q.dtype)


def ragged_decode_attention(q, k_cache, v_cache, starts, ends, *,
                            k_scale=None, v_scale=None, block_tables=None,
                            page: int = 0, _splits: int = 0) -> torch.Tensor:
    """Attention reading only ``[starts, ends)`` of each row, for one query
    per row (q [B, Hq, D]) or a stair of w queries (q [B, w, Hq, D]).
    Wrapper: kernel for CUDA tensors, plain version for CPU tensors.
    ``_splits`` > 0 forces the kernel's split count (tests)."""
    if (k_scale is None) != (v_scale is None):
        raise ValueError("ragged_decode_attention: give both scales or "
                         "neither")
    if not q.is_cuda:
        return ragged_decode_attention_plain(
            q, k_cache, v_cache, starts, ends, k_scale=k_scale,
            v_scale=v_scale, block_tables=block_tables, page=page)
    b, w, hq, d, hkv, g, s = _geometry(q, k_cache, block_tables, page)
    int8 = k_scale is not None
    want = torch.int8 if int8 else torch.bfloat16
    if q.dtype != torch.bfloat16:
        raise ValueError(f"ragged_decode_attention: q must be bf16 on CUDA, "
                         f"got {q.dtype}")
    if d not in HEAD_DIMS:
        raise ValueError(f"ragged_decode_attention: head_dim must be one of "
                         f"{HEAD_DIMS}, got {d}")
    if g > MAX_GROUPS:
        raise ValueError(f"ragged_decode_attention: at most {MAX_GROUPS} q "
                         f"heads per kv head, got {g}")
    tensors = [("q", q, torch.bfloat16), ("k_cache", k_cache, want),
               ("v_cache", v_cache, want)]
    if int8:
        tensors += [("k_scale", k_scale, torch.bfloat16),
                    ("v_scale", v_scale, torch.bfloat16)]
    tensors += [("starts", starts, torch.int32), ("ends", ends, torch.int32)]
    if block_tables is not None:
        tensors.append(("block_tables", block_tables, torch.int32))
    for name, t, dt in tensors:
        # q is read in 8-byte vectors, the codes in 16-byte cp.async
        # chunks; scales, windows and tables one element at a time
        if (t.dtype != dt or t.device != q.device or not t.is_contiguous()
                or (name in ("q", "k_cache", "v_cache")
                    and t.data_ptr() % 16)):
            raise ValueError(f"ragged_decode_attention: {name} must be a "
                             f"contiguous {dt} tensor on {q.device} (q and "
                             f"caches 16-byte aligned), got {t.dtype} on "
                             f"{t.device}")
    if v_cache.shape != k_cache.shape:
        raise ValueError("ragged_decode_attention: k and v caches differ")
    if int8 and (k_scale.shape != k_cache.shape[:-1] + (hkv,)
                 or v_scale.shape != k_scale.shape):
        raise ValueError(f"ragged_decode_attention: scales must be "
                         f"{tuple(k_cache.shape[:-1]) + (hkv,)}")
    if starts.shape != (b,) or ends.shape != (b,):
        raise ValueError(f"ragged_decode_attention: starts/ends must be [{b}]")
    out = torch.empty_like(q)
    paged = block_tables is not None
    ql, groups, splits = plan(b, w, g, hkv, s, sm_count(q.device.index),
                              _splits)
    part = tickets = None
    if splits > 1:
        # fp32 partials (acc, then m and l) of every split; the tickets
        # are left at zero by each launch's merging blocks
        part = torch.empty(splits * b * hkv * groups * ql * g * (d + 2),
                           dtype=torch.float32, device=q.device)
        tickets = _tickets.get(q.device, b * hkv * groups)
    launch(library(), "decode_attn", q.device,
           q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
           k_scale.data_ptr() if int8 else None,
           v_scale.data_ptr() if int8 else None,
           starts.data_ptr(), ends.data_ptr(),
           block_tables.data_ptr() if paged else None, out.data_ptr(),
           part.data_ptr() if part is not None else None,
           tickets.data_ptr() if tickets is not None else None,
           b, w, hq, hkv, d, s, block_tables.shape[1] if paged else 0,
           page if paged else 0, int(int8), ql, splits, d ** -0.5,
           counts=("decode_attn", _MODE_COUNTS[q.dim()]))
    return out
