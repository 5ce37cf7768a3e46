"""The sparse-expert layer (DeepSeek-V2's ``DeepseekV2MoE``, Nemotron-H's
``NemotronHMOE``): routing in static shapes and K6, the grouped GEMM over
expert-sorted rows.

Routing (``route``): router logits in fp32 (``x.float() @ W.float()``).
DeepSeek-V2: a softmax over the experts, the top ``k`` scores as the
weights (greedy, no renormalisation, times ``routed_scaling_factor``).
Nemotron-H (``correction`` given): sigmoid scores, the top ``k`` of
``scores + correction`` (the score-correction bias picks, it does not
weigh), their scores renormalised to sum 1 (+ 1e-20) and times the
scaling.  Every step has static
shapes and never reads the device from the host, so a captured decode
step holds the layer whole: the T * k expert ids are argsorted (stable),
counted per expert by ``scatter_add_`` and turned into row offsets by a
cumsum, all on the device; the rows are gathered in that order.

K6 (``moe_gemm``; kernel and design note: ``seedx_tpu_torch/csrc/
moe_gemm.cu``) runs twice on the sorted rows: gate and up with the
``silu(gate) * up`` epilogue (or, for ungated experts, up alone with the
``relu(up)^2`` epilogue: ``act="relu2"``), bf16 [R, f]; then down, fp32
[R, d].  The
rows go back to their tokens by the inverse permutation (each destination
written once) and each token sums its k rows times their weights in
fp32, so a rerun gives the same bits: no float atomics anywhere.  No
capacity, no dropped tokens; the pad tokens of a right-padded prefill
route to no expert (``keep``).

``moe_gemm`` launches the kernel for CUDA tensors and runs
``moe_gemm_plain`` (a per-expert ``torch.matmul`` loop in fp32, which
reads the offsets on the host) for CPU tensors.  The launch counter
``"moe_gemm"`` (``ops/_build.py``) counts the kernel's launches, replays
of a captured step included; ``"moe_gemm relu2"`` the share with the
relu2 epilogue.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from seedx_tpu_torch.ops._build import launch, load_library, register

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {"moe_gemm_bf16": [_P] * 6 + [_I] * 7 + [_P]}

BN = {16: 64, 64: 128, 128: 128}   # the kernel's row tiles: column tiles
K_STEP = 64                 # K a pipeline stage: K must be a multiple
MAX_Z = 32                  # row-tile groups an expert, at most
ACTS = ("swiglu", "relu2")  # the epilogues of a bf16 output (kernel's 1, 2)
register("moe_gemm", "moe_gemm relu2")      # launch counters


def library() -> ctypes.CDLL:
    return load_library("moe_gemm", "moe_gemm.cu", _SIGNATURES)


def plan(rows: int, experts: int, n: int) -> Tuple[int, int]:
    """(row tile, row-tile groups an expert) of a launch over ``rows``
    sorted rows and ``n`` output columns.  From the mean rows an expert
    (the device holds the real counts): the 16-row tile up to 16 (decode:
    each active expert's weights streamed once), the 64-row tile up to 64,
    else 128 (an n that is no multiple of the tile's 128 columns ends in a
    64-column tile); then enough groups that an expert twice the mean
    still has one block a row tile (the rest return at once)."""
    mean = rows / max(experts, 1)
    tile = 16 if mean <= 16 else 64 if mean <= 64 else 128
    z = -(-2 * rows // (max(experts, 1) * tile))
    return tile, max(1, min(z, MAX_Z))


def _act(w2, act: Optional[str]) -> Optional[str]:
    """The epilogue: ``act``, else "swiglu" with ``w2`` and none without."""
    act = act or ("swiglu" if w2 is not None else None)
    if act is not None and act not in ACTS:
        raise ValueError(f"moe_gemm: act must be one of {ACTS}, got {act!r}")
    if (act == "swiglu") != (w2 is not None):
        raise ValueError("moe_gemm: the up weights w2 go with act='swiglu' "
                         "alone")
    return act


def moe_gemm_plain(x: torch.Tensor, w: torch.Tensor, offsets: torch.Tensor,
                   w2: Optional[torch.Tensor] = None,
                   active: Optional[torch.Tensor] = None,
                   act: Optional[str] = None) -> torch.Tensor:
    """K6's contract in plain torch: per expert e, rows [offsets[e],
    offsets[e + 1]) times ``w[e]`` in fp32; with ``w2`` the gated form
    ``silu(x w) * (x w2)``, with ``act="relu2"`` ``relu(x w)^2``, either
    rounded to x's dtype, else fp32.  ``active`` (int64 scalar) gains the
    number of experts with rows."""
    act = _act(w2, act)
    bounds = offsets.tolist()
    n = w.shape[-1]
    out = torch.zeros((x.shape[0], n), device=x.device,
                      dtype=x.dtype if act else torch.float32)
    for e in range(w.shape[0]):
        a, b = bounds[e], bounds[e + 1]
        if a == b:
            continue
        xe = x[a:b].float()
        y = torch.matmul(xe, w[e].float())
        if act == "swiglu":
            y = (F.silu(y) * torch.matmul(xe, w2[e].float())).to(x.dtype)
        elif act == "relu2":
            y = F.relu(y).square().to(x.dtype)
        out[a:b] = y
    if active is not None:
        active += (offsets[1:] > offsets[:-1]).sum()
    return out


def _check(x, w, offsets, w2, active) -> None:
    r, k = x.shape
    e, kw, n = w.shape
    if x.dtype != torch.bfloat16 or w.dtype != torch.bfloat16:
        raise ValueError("moe_gemm takes bf16 rows and weights")
    if kw != k or k % K_STEP or n % BN[16]:
        raise ValueError(f"moe_gemm: rows [{r}, {k}] and weights "
                         f"{tuple(w.shape)} do not fit (K a multiple of "
                         f"{K_STEP}, N of {BN[16]})")
    if offsets.dtype != torch.int32 or offsets.shape != (e + 1,):
        raise ValueError("moe_gemm: offsets must be int32 [experts + 1]")
    if w2 is not None and (w2.shape != w.shape or w2.dtype != w.dtype):
        raise ValueError("moe_gemm: the up weights must match the gate's")
    if active is not None and (active.dtype != torch.int64
                               or active.numel() != 1):
        raise ValueError("moe_gemm: active must be one int64")
    for name, t in (("x", x), ("w", w), ("offsets", offsets), ("w2", w2),
                    ("active", active)):
        if t is not None and (t.device != x.device or not t.is_contiguous()):
            raise ValueError(f"moe_gemm: {name} must be contiguous on "
                             f"{x.device}")


def moe_gemm(x: torch.Tensor, w: torch.Tensor, offsets: torch.Tensor,
             w2: Optional[torch.Tensor] = None,
             active: Optional[torch.Tensor] = None,
             act: Optional[str] = None) -> torch.Tensor:
    """Wrapper: K6 for CUDA tensors, ``moe_gemm_plain`` for CPU tensors.
    x bf16 [R, K] sorted by expert, w (w2) bf16 [E, K, N], offsets int32
    [E + 1] -> bf16 [R, N] (gated with w2, or ``act="relu2"``) or fp32
    [R, N]."""
    if not x.is_cuda:
        return moe_gemm_plain(x, w, offsets, w2, active, act)
    act = _act(w2, act)
    _check(x, w, offsets, w2, active)
    r, k = x.shape
    e, _, n = w.shape
    tile, z = plan(r, e, n)
    out = torch.empty((r, n), device=x.device,
                      dtype=torch.bfloat16 if act else torch.float32)
    launch(library(), "moe_gemm_bf16", x.device, x.data_ptr(), w.data_ptr(),
           w2.data_ptr() if w2 is not None else None,
           offsets.data_ptr(), out.data_ptr(),
           active.data_ptr() if active is not None else None,
           r, k, n, e, ACTS.index(act) + 1 if act else 0, tile, z,
           counts=(("moe_gemm", "moe_gemm relu2") if act == "relu2"
                   else ("moe_gemm",)))
    return out


def route(x: torch.Tensor, router: torch.Tensor, top_k: int,
          scaling: float = 1.0, correction: Optional[torch.Tensor] = None
          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x [T, d], router [d, E] -> (weights fp32 [T, k], expert ids [T, k]):
    the fp32 softmax's top k, greedy, not renormalised; with
    ``correction`` [E] the sigmoid router (see the module docstring)."""
    logits = x.float() @ router.float()
    if correction is None:
        weights, ids = torch.topk(torch.softmax(logits, dim=-1), top_k,
                                  dim=-1)
        return weights * scaling, ids
    scores = torch.sigmoid(logits)
    ids = torch.topk(scores + correction.float(), top_k, dim=-1).indices
    weights = scores.gather(1, ids)
    weights = weights / (weights.sum(dim=-1, keepdim=True) + 1e-20)
    return weights * scaling, ids


def sort_rows(ids: torch.Tensor, experts: int
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Expert ids [T, k] -> (order [T * k]: the flat (token, slot) rows
    sorted by expert, stable; offsets int32 [E + 1]), on the device with
    static shapes."""
    flat = ids.reshape(-1)
    order = torch.argsort(flat, stable=True)
    counts = torch.zeros((experts,), dtype=torch.int32, device=ids.device)
    counts.scatter_add_(0, flat, torch.ones_like(flat, dtype=torch.int32))
    offsets = F.pad(torch.cumsum(counts, 0, dtype=torch.int32), (1, 0))
    return order, offsets


def moe_experts(x: torch.Tensor, router: torch.Tensor,
                gate: Optional[torch.Tensor], up: torch.Tensor,
                down: torch.Tensor, top_k: int, scaling: float = 1.0,
                active: Optional[torch.Tensor] = None,
                keep: Optional[torch.Tensor] = None,
                correction: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The routed experts' sum for x [T, d] (bf16): router [d, E], gate /
    up [E, d, f], down [E, f, d] -> fp32 [T, d] (the shared experts are
    the caller's).  ``gate`` None: ungated relu2 experts (``relu(x up)^2``
    down).  ``correction`` [E]: the sigmoid router (``route``).
    ``active`` (int64 scalar) counts the experts that got
    rows.  ``keep`` [T] bool marks the real tokens of a padded batch: the
    others go to a sentinel expert E, sorted after every real row and past
    ``offsets[E]``, so K6 neither reads nor computes them (shapes stay
    static), and their sum is 0."""
    t, d = x.shape
    e = up.shape[0]
    weights, ids = route(x, router, top_k, scaling, correction)
    if keep is not None:
        ids = torch.where(keep[:, None], ids, e)
    order, offsets = sort_rows(ids, e + (keep is not None))
    offsets = offsets[:e + 1]
    rows = x[order // top_k]
    act = (moe_gemm(rows, up, offsets, None, active, "relu2") if gate is None
           else moe_gemm(rows, gate, offsets, up, active))  # [R, f] bf16
    out = moe_gemm(act, down, offsets)                       # [R, d] fp32
    back = torch.empty_like(out)
    back[order] = out
    y = (back.view(t, top_k, d) * weights[..., None]).sum(dim=1)
    # the sentinel's rows hold whatever K6 left there: where, not a product
    return y if keep is None else torch.where(keep[:, None], y, 0.0)
