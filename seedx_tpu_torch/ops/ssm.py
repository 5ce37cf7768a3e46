"""Mamba-2's selective state space (Nemotron-H's ``NemotronHMamba2Mixer``):
the chunked scan of a prefill and K7, the one-token state step of decode.

Per head h (of H, each reading group ``h // (H / G)`` of B and C), with
the state S [P, N] in fp32 and dt = softplus(dt_raw + dt_bias) already
taken (and 0 at a padded position, which then changes nothing: exp(0) = 1
and 0 * x B = 0):

    S_t = exp(dt_t * A) S_{t-1} + dt_t x_t B_t^T,   y_t = S_t C_t (+ D x_t)

``ssd_scan`` (prefill, plain torch) computes a whole sequence in chunks of
``chunk`` positions through batched matmuls (Mamba-2's SSD form): within
a chunk y = (C B^T * L) (dt x), L the causal decay matrix exp(cumsum(dt
A)_i - cumsum(dt A)_j), grouped so that the [T, T] C B^T is formed once a
group; across chunks each chunk's final state, carried in order from the
given initial state.  It returns y without the D term and the final
state.  A hand-written chunk-scan kernel is later work.

K7 (``ssm_step``; kernel and design note: ``seedx_tpu_torch/csrc/
ssm_step.cu``) is the captured decode step's recurrence for every slot:
it reads each slot's state once and writes it once, in place, and emits y
with the D term, fp32.  ``ssm_step_plain`` is its contract in plain torch
(the CPU path and the parity yardstick).  The launch counter
``"ssm_step"`` (``ops/_build.py``) counts the kernel's launches, replays
of a captured step included.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from seedx_tpu_torch.ops._build import launch, load_library, register

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_long
_SIGNATURES = {"ssm_step_f32": [_P] * 7 + [_I] * 5 + [_L, _L, _P]}
STATE_SIZE = 128        # the kernel's N: four floats a lane
ROWS_STEP = 16          # the kernel's P: a multiple of 4 warps x 4 rows
register("ssm_step")    # launch counter


def library() -> ctypes.CDLL:
    return load_library("ssm_step", "ssm_step.cu", _SIGNATURES)


def split_xbc(xbc: torch.Tensor, heads: int, head_dim: int, groups: int
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """[..., H * P + 2 * G * N] -> x [..., H, P], B and C [..., G, N]."""
    d_in = heads * head_dim
    n = (xbc.shape[-1] - d_in) // (2 * groups)
    lead = xbc.shape[:-1]
    return (xbc[..., :d_in].reshape(*lead, heads, head_dim),
            xbc[..., d_in:d_in + groups * n].reshape(*lead, groups, n),
            xbc[..., d_in + groups * n:].reshape(*lead, groups, n))


def step_dt(dt_raw: torch.Tensor, dt_bias: torch.Tensor) -> torch.Tensor:
    """softplus(dt_raw + dt_bias) in fp32 (no clamp)."""
    return F.softplus(dt_raw.float() + dt_bias.float())


def ssm_step_plain(state: torch.Tensor, xbc: torch.Tensor,
                   dt_raw: torch.Tensor, dt_bias: torch.Tensor,
                   a_log: torch.Tensor, d_skip: torch.Tensor, heads: int,
                   head_dim: int, groups: int) -> torch.Tensor:
    """K7's contract in plain torch: one step of every row's state
    [B, H, P, N] (fp32, updated in place) from the activated conv output
    ``xbc`` [B, H * P + 2 * G * N] and ``dt_raw`` [B, H]; returns y fp32
    [B, H, P] (with the D term)."""
    x, bm, cm = (t.float() for t in split_xbc(xbc, heads, head_dim, groups))
    rep = heads // groups
    bh = bm.repeat_interleave(rep, dim=1)                # [B, H, N]
    ch = cm.repeat_interleave(rep, dim=1)
    dt = step_dt(dt_raw, dt_bias)                        # [B, H]
    da = torch.exp(dt * -torch.exp(a_log.float()))
    state.mul_(da[..., None, None]).add_(
        (dt[..., None] * x)[..., None] * bh[:, :, None, :])
    return (state @ ch[..., None])[..., 0] + d_skip.float()[:, None] * x


def _check(state, xbc, dt_raw, heads, head_dim, groups) -> None:
    b = state.shape[0]
    n = state.shape[-1]
    if state.dtype != torch.float32 or not state.is_contiguous() \
            or state.shape != (b, heads, head_dim, n) \
            or state.data_ptr() % 16:
        raise ValueError(f"ssm_step: the state must be a contiguous 16-byte "
                         f"aligned fp32 [B, {heads}, {head_dim}, N], got "
                         f"{state.dtype} {tuple(state.shape)}")
    if n != STATE_SIZE or head_dim % ROWS_STEP or heads % groups:
        raise ValueError(f"ssm_step: the kernel takes N {STATE_SIZE}, P a "
                         f"multiple of {ROWS_STEP} and H a multiple of G, "
                         f"got N {n}, P {head_dim}, H {heads}, G {groups}")
    width = heads * head_dim + 2 * groups * n
    if xbc.dtype != torch.bfloat16 or xbc.shape != (b, width) \
            or xbc.stride(-1) != 1 or xbc.stride(0) % 4 \
            or xbc.data_ptr() % 8:
        raise ValueError(f"ssm_step: xbc must be bf16 [{b}, {width}] rows "
                         f"of unit stride, 8-byte aligned")
    if dt_raw.dtype != torch.bfloat16 or dt_raw.shape != (b, heads) \
            or dt_raw.stride(-1) != 1:
        raise ValueError(f"ssm_step: dt_raw must be bf16 [{b}, {heads}] "
                         f"of unit column stride")
    for name, t in (("state", state), ("xbc", xbc), ("dt_raw", dt_raw)):
        if t.device != state.device:
            raise ValueError(f"ssm_step: {name} is on {t.device}")


def ssm_step(state: torch.Tensor, xbc: torch.Tensor, dt_raw: torch.Tensor,
             dt_bias: torch.Tensor, a_log: torch.Tensor,
             d_skip: torch.Tensor, heads: int, head_dim: int,
             groups: int) -> torch.Tensor:
    """Wrapper: K7 for CUDA tensors, ``ssm_step_plain`` for CPU tensors
    (see ``ssm_step_plain`` for the contract)."""
    if not state.is_cuda:
        return ssm_step_plain(state, xbc, dt_raw, dt_bias, a_log, d_skip,
                              heads, head_dim, groups)
    _check(state, xbc, dt_raw, heads, head_dim, groups)
    b = state.shape[0]
    params = [t.float().contiguous() for t in (dt_bias, a_log, d_skip)]
    y = torch.empty((b, heads, head_dim), dtype=torch.float32,
                    device=state.device)
    launch(library(), "ssm_step_f32", state.device, state.data_ptr(),
           xbc.data_ptr(), dt_raw.data_ptr(),
           *(t.data_ptr() for t in params), y.data_ptr(), b, heads,
           head_dim, groups, state.shape[-1], xbc.stride(0),
           dt_raw.stride(0), counts=("ssm_step",))
    return y


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
             bm: torch.Tensor, cm: torch.Tensor, chunk: int,
             initial: Optional[torch.Tensor] = None
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The chunked scan (see the module docstring), fp32: x [b, l, H, P],
    dt [b, l, H] (softplus taken, 0 at pads), a [H] (= -exp(A_log)), B / C
    [b, l, G, N], ``initial`` [b, H, P, N] (None: zeros) -> (y [b, l, H,
    P] without the D term, the final state [b, H, P, N])."""
    b, l, h, p = x.shape
    g, n = bm.shape[2:]
    rep = h // g
    t = chunk
    c = -(-l // t)
    pad = c * t - l
    if pad:
        x, dt, bm, cm = (F.pad(v, (0,) * (2 * (v.dim() - 2)) + (0, pad))
                         for v in (x, dt, bm, cm))
    # [b, c, G, rep, T, ...]: head h = g * rep + r
    xdt = (x * dt[..., None]).reshape(b, c, t, g, rep, p).permute(
        0, 1, 3, 4, 2, 5)
    acs = torch.cumsum((dt * a.float()).reshape(b, c, t, g, rep), dim=2
                       ).permute(0, 1, 3, 4, 2)                 # [b,c,G,r,T]
    bg = bm.reshape(b, c, t, g, n).permute(0, 1, 3, 2, 4)       # [b,c,G,T,N]
    cg = cm.reshape(b, c, t, g, n).permute(0, 1, 3, 2, 4)
    causal = torch.ones(t, t, dtype=torch.bool, device=x.device).tril()
    seg = (acs[..., :, None] - acs[..., None, :]).masked_fill(~causal,
                                                              float("-inf"))
    scores = (cg @ bg.transpose(-1, -2))[:, :, :, None] * torch.exp(seg)
    y = scores @ xdt                                     # [b,c,G,r,T,P]
    del seg, scores
    # the states carried in order, each chunk's own contribution at the
    # same shapes whatever the chunk count (a row's state does not depend
    # on how many all-pad chunks follow its end)
    xdec = xdt * torch.exp(acs[..., -1:] - acs)[..., None]
    total = torch.exp(acs[..., -1])                      # [b,c,G,r]
    s = (initial.reshape(b, g, rep, p, n).float() if initial is not None
         else x.new_zeros((b, g, rep, p, n)))
    entering = []
    for i in range(c):
        entering.append(s)
        own = xdec[:, i].transpose(-1, -2) @ bg[:, i, :, None]
        s = total[:, i, ..., None, None] * s + own
    states = torch.stack(entering, dim=1)                # [b,c,G,r,P,N]
    y = y + (cg[:, :, :, None] @ states.transpose(-1, -2)) \
        * torch.exp(acs)[..., None]
    y = y.permute(0, 1, 4, 2, 3, 5).reshape(b, c * t, h, p)[:, :l]
    return y, s.reshape(b, h, p, n)
