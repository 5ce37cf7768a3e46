"""The Mamba-2 mixers of a Nemotron-H stack (reference: NVIDIA's public
``modeling_nemotron_h.py``, ``NemotronHMamba2Mixer``; the JAX package has
no state-space layer).

For the pre-normed input h of Mamba block m (weights stacked [M, ...]
over the stack's Mamba blocks), with d_in = H * P and the conv's width
C = d_in + 2 * G * N:

    [z | xBC | dt] = h W_in                    (W_in [hidden, d_in + C + H])
    xBC = silu(causal depthwise conv1d(xBC))   (kernel K, with bias)
    x [H, P], B [G, N], C [G, N] = split(xBC)   (head h reads group
                                               h // (H / G))
    dt = softplus(dt + dt_bias), A = -exp(A_log)
    S_t = exp(dt_t A) S_{t-1} + dt_t x_t B_t^T,  y_t = S_t C_t + D x_t
    y = RMSNorm_groups(y * silu(z)) * norm_scale   (G groups of d_in / G)
    out = y W_out

The block's state is the conv's last K - 1 inputs [K - 1, C] (the
cache's dtype) and S [H, P, N] (fp32), one of each a slot
(``llama.init_kv_cache``).  A multi-row step (a prefill, or a chunk at a
scalar offset) runs ``ops/ssm.ssd_scan`` from a zero state at offset 0
(a fresh request: whatever the slot held is ignored) or from the cached
state past it; positions the step's ``keep`` leaves out (a right-padded
prefill's pads) feed the conv zeros and get dt = 0, so the state after
them is the state at the row's last real token, exactly, and the conv
state is gathered from the K - 1 inputs ending there.  A one-token step
shifts the conv state in place and runs K7 (``ops/ssm.ssm_step``) on
every row's state; a row ``write_mask`` leaves out keeps both as they
were.  The conv runs in fp32 and rounds once, to the weights' dtype.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from seedx_tpu_torch.models.layers import PDense, RMSNorm
from seedx_tpu_torch.ops.ssm import split_xbc, ssd_scan, ssm_step, step_dt
from seedx_tpu_torch.utils import profiling


class Mamba2Mixers(nn.Module):
    """Every Mamba block's weights, stacked [M, ...]: ``in_proj``,
    ``conv_kernel`` [M, K, C] and ``conv_bias`` [M, C], ``dt_bias``,
    ``A_log`` and ``D`` [M, H], the gated norm's ``norm.scale`` [M, d_in],
    ``out_proj``."""

    def __init__(self, cfg, layers: int, device=None):
        super().__init__()
        self.cfg = cfg
        d, dt = cfg.hidden_size, cfg.dtype
        h, c = cfg.mamba_heads, cfg.conv_dim
        self.in_proj = PDense(d, cfg.mamba_inner + c + h, use_bias=False,
                              dtype=dt, layers=layers, device=device)
        for name, shape in (("conv_kernel", (cfg.conv_kernel, c)),
                            ("conv_bias", (c,)), ("dt_bias", (h,)),
                            ("A_log", (h,)), ("D", (h,))):
            self.register_buffer(name, torch.zeros(
                (layers,) + shape, dtype=dt, device=device))
        self.norm = RMSNorm(cfg.mamba_inner, cfg.rms_eps, dt, layers, device)
        self.out_proj = PDense(cfg.mamba_inner, d, use_bias=False, dtype=dt,
                               layers=layers, device=device)

    def _conv(self, m: int, full: torch.Tensor, s: int) -> torch.Tensor:
        """The causal conv's last ``s`` outputs over ``full`` [b, K - 1 + s,
        C] (the K - 1 earlier inputs first), silu, in the weights' dtype."""
        w = self.conv_kernel[m].float()
        k = w.shape[0]
        acc = self.conv_bias[m].float() + full[:, 0:s].float() * w[0]
        for j in range(1, k):
            acc = acc + full[:, j:j + s].float() * w[j]
        return F.silu(acc).to(self.cfg.dtype)

    def _gated_out(self, m: int, y: torch.Tensor, z: torch.Tensor
                   ) -> torch.Tensor:
        """y fp32 [b, s, d_in] gated by silu(z), RMS-normed over G groups,
        through W_out."""
        cfg = self.cfg
        b, s, _ = y.shape
        y = y * F.silu(z.float())
        yg = y.reshape(b, s, cfg.mamba_groups, -1)
        yg = yg * torch.rsqrt(yg.pow(2).mean(-1, keepdim=True) + cfg.rms_eps)
        y = self.norm.w("scale", m) * yg.reshape(b, s, -1).to(cfg.dtype)
        return self.out_proj(y, m)

    def forward(self, m: int, h: torch.Tensor,
                state: Optional[tuple] = None, cache_index=0,
                keep: Optional[torch.Tensor] = None,
                write_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Mamba block ``m`` over h [b, s, hidden]; ``state`` (conv [b, K -
        1, C], S [b, H, P, N]: this block's views of the cache, updated in
        place) or None; see the module docstring."""
        cfg = self.cfg
        b, s, _ = h.shape
        hh, p, g = cfg.mamba_heads, cfg.mamba_head_dim, cfg.mamba_groups
        d_in, c = cfg.mamba_inner, cfg.conv_dim
        proj = self.in_proj(h, m)
        z, xbc_in, dt_raw = proj[..., :d_in], proj[..., d_in:d_in + c], \
            proj[..., d_in + c:]
        if state is not None and s == 1:
            conv, ssm = state
            full = torch.cat([conv, xbc_in.to(conv.dtype)], dim=1)
            xbc = self._conv(m, full, 1)[:, 0]
            if write_mask is None:
                conv.copy_(full[:, 1:])
                y = ssm_step(ssm, xbc, dt_raw[:, 0], self.dt_bias[m],
                             self.A_log[m], self.D[m], hh, p, g)
            else:
                keep_row = write_mask[:, None, None]
                conv.copy_(torch.where(keep_row, full[:, 1:], conv))
                new = ssm.clone()
                y = ssm_step(new, xbc, dt_raw[:, 0], self.dt_bias[m],
                             self.A_log[m], self.D[m], hh, p, g)
                ssm.copy_(torch.where(keep_row[..., None], new, ssm))
            return self._gated_out(m, y.reshape(b, 1, d_in), z)
        with profiling.annotate("llm.ssm_scan", device=True) as span:
            if span:
                span["tokens"] = (keep.sum() if keep is not None
                                  else b * s)
                span["chunks"] = b * -(-s // cfg.ssm_chunk)
            y = self._scan(m, xbc_in, dt_raw, state, cache_index, keep)
        return self._gated_out(m, y, z)

    def _scan(self, m: int, xbc_in, dt_raw, state, cache_index,
              keep) -> torch.Tensor:
        """The multi-row step: y fp32 [b, s, d_in], the state written at
        each row's last kept position."""
        cfg = self.cfg
        b, s, _ = xbc_in.shape
        hh, p, g = cfg.mamba_heads, cfg.mamba_head_dim, cfg.mamba_groups
        k1 = cfg.conv_kernel - 1
        fresh = state is None or cache_index == 0
        if keep is not None:
            xbc_in = torch.where(keep[..., None], xbc_in, 0)
        prev = (xbc_in.new_zeros((b, k1, xbc_in.shape[-1])) if fresh
                else state[0].to(xbc_in.dtype))
        full = torch.cat([prev, xbc_in], dim=1)
        xbc = self._conv(m, full, s)
        x, bm, cm = split_xbc(xbc, hh, p, g)
        dt = step_dt(dt_raw, self.dt_bias[m])
        if keep is not None:
            dt = torch.where(keep[..., None], dt, 0.0)
        a = -torch.exp(self.A_log[m].float())
        y, final = ssd_scan(x.float(), dt, a, bm.float(), cm.float(),
                            cfg.ssm_chunk,
                            None if fresh else state[1])
        y = y + self.D[m].float()[:, None] * x.float()
        if state is not None:
            conv, ssm = state
            # the K - 1 inputs ending at each row's last kept position
            end = (s if keep is None else
                   s - torch.flip(keep, [1]).to(torch.int64).argmax(1))
            idx = (torch.as_tensor(end, device=full.device).reshape(-1, 1)
                   + torch.arange(k1, device=full.device))
            conv.copy_(torch.gather(full, 1, idx[..., None].expand(
                -1, -1, full.shape[-1]).expand(b, -1, -1)).to(conv.dtype))
            ssm.copy_(final)
        return y.reshape(b, s, -1)
