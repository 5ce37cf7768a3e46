"""De-tokenizer (adapter) training: diffusion MSE over ViT conditioning
(reference: seedx_tpu/train/train_adapter.py; the reference's adapter
training forward, src/models/detokenizer/adapter_modules.py:39-52, and
its trainable sets :21-33).

    batch latents (scaled VAE latents of the target image) + image_embeds
    (pooled ViT features) -> sample t and the noise -> Euler input
    scaling -> UNet eps prediction conditioned by ResamplerXL -> MSE ->
    update the resampler + the UNet's to_k / to_v + conv_in (or, with
    ``full_ft``, every leaf).

The trainable leaves become fp32 ``nn.Parameter`` masters in the modules
(``layers.set_trainable_``); the frozen UNet stays bf16 buffers.  The
optimizer is the SFT trainer's written-out clip + AdamW
(``trainer.apply_updates``) with the cosine schedule, at optax
``adamw``'s defaults, as the JAX step builds it.  On the card the UNet's
self-attention runs K1 forward and K4 / K5 backward
(``ops/flash_attention.FlashAttention``) at every one of its 70 calls.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, ClassVar, Dict, Mapping, Tuple

import numpy as np
import torch
from torch import nn

from seedx_tpu_torch.models.adapter import ADAPTER_TRAINABLE_PATTERNS
from seedx_tpu_torch.models.layers import set_trainable_
from seedx_tpu_torch.models.sdxl.scheduler import EulerScheduleConfig
from seedx_tpu_torch.train.partition import path_labels
from seedx_tpu_torch.train.schedule import get_schedule
from seedx_tpu_torch.train.trainer import (TrainState, apply_updates,
                                           sync_time)


@dataclasses.dataclass(frozen=True)
class AdapterTrainConfig:
    learning_rate: float = 1e-4
    weight_decay: float = 0.01
    max_grad_norm: float = 1.0
    warmup_steps: int = 500
    max_steps: int = 20000
    min_lr_ratio: float = 0.05
    full_ft: bool = False
    trainable_patterns: Tuple[str, ...] = ADAPTER_TRAINABLE_PATTERNS
    # optax.adamw's defaults, which the JAX step leaves in place (constants
    # that trainer.apply_updates reads, not options)
    adam_beta1: ClassVar[float] = 0.9
    adam_beta2: ClassVar[float] = 0.999
    adam_epsilon: ClassVar[float] = 1e-8


def make_sigma_tables(cfg: EulerScheduleConfig = EulerScheduleConfig()
                      ) -> torch.Tensor:
    """Per-train-timestep sigma table for noise sampling: fp64 numpy, then
    one cast to fp32 (a host tensor, [num_train_timesteps])."""
    betas = np.linspace(cfg.beta_start ** 0.5, cfg.beta_end ** 0.5,
                        cfg.num_train_timesteps, dtype=np.float64) ** 2
    ac = np.cumprod(1.0 - betas)
    sigmas = np.sqrt((1.0 - ac) / ac).astype(np.float32)
    return torch.from_numpy(sigmas)


def adapter_loss(unet: nn.Module, resampler: nn.Module,
                 batch: Mapping[str, torch.Tensor], t: torch.Tensor,
                 noise: torch.Tensor, sigmas: torch.Tensor,
                 time_ids: torch.Tensor) -> torch.Tensor:
    """The diffusion MSE at timesteps ``t`` [B] (int) with ``noise`` (the
    latents' shape): noisy = latents + noise * sigma_t, scaled by
    1 / sqrt(sigma_t^2 + 1) as the Euler sampler scales its input, eps
    predicted by the UNet conditioned by ResamplerXL on
    ``batch["image_embeds"]``, mean squared error against the noise in
    fp32 (reference seedx_tpu/train/train_adapter.py:74-96)."""
    latents = batch["latents"]
    b = latents.shape[0]
    sigma = sigmas.to(latents.device)[t][:, None, None, None]
    noisy = latents + noise * sigma
    scaled = noisy / torch.sqrt(sigma ** 2 + 1.0)
    prompt, pooled = resampler(batch["image_embeds"])
    eps = unet(scaled, t.to(torch.float32), prompt, pooled,
               time_ids.to(latents.device).expand(b, 6))
    return torch.mean((eps.float() - noise.float()) ** 2)


def make_adapter_train_step(unet: nn.Module, resampler: nn.Module,
                            cfg: AdapterTrainConfig, time_ids: torch.Tensor
                            ) -> Tuple[Callable[[], TrainState], Callable]:
    """-> (init_state, train_step).

    ``init_state()`` marks the leaves of ``{"unet": unet, "resampler":
    resampler}`` matching ``cfg.trainable_patterns`` (every leaf with
    ``full_ft``) trainable, fp32 masters in place, and gives each zero
    Adam moments.  ``train_step(state, batch, generator)`` draws t
    uniform in [0, 1000) and the noise from ``generator`` (on the
    modules' device), takes ``adapter_loss`` and its gradient and makes
    one optimizer update in place.  ``batch``: {"latents": [B, h, w, 4]
    scaled VAE latents, "image_embeds": [B, T, 4096] pooled ViT
    features}; ``time_ids`` [6] or [1, 6].  Metrics: ``total_loss``,
    ``grad_norm`` (before the clip), ``lr`` and the device-synchronised
    ms of forward + backward (``fwd_bwd_ms``) and of the update
    (``opt_ms``)."""
    schedule = get_schedule("cosine", cfg.learning_rate, cfg.warmup_steps,
                            cfg.max_steps, cfg.min_lr_ratio)
    sigmas = make_sigma_tables()
    n_train = sigmas.shape[0]
    modules = nn.ModuleDict({"unet": unet, "resampler": resampler})
    time_ids = time_ids.reshape(1, 6)

    def init_state() -> TrainState:
        patterns = (r".*",) if cfg.full_ft else cfg.trainable_patterns
        labels = path_labels(modules.state_dict().keys(), patterns)
        names = set_trainable_(modules, [n for n, lab in labels.items()
                                         if lab == "trainable"])
        params = {n: modules.get_parameter(n) for n in names}
        opt_state = {k: {n: torch.zeros_like(p) for n, p in params.items()}
                     for k in ("mu", "nu")}
        return TrainState(step=0, params=params, opt_state=opt_state)

    def train_step(state: TrainState, batch: Mapping[str, torch.Tensor],
                   generator: torch.Generator) -> Dict[str, float]:
        latents = batch["latents"]
        dev = latents.device
        t0 = sync_time(dev)
        t = torch.randint(0, n_train, (latents.shape[0],),
                          generator=generator, device=dev)
        noise = torch.randn(latents.shape, generator=generator, device=dev,
                            dtype=latents.dtype)
        for p in state.params.values():
            p.grad = None
        loss = adapter_loss(unet, resampler, batch, t, noise, sigmas,
                            time_ids)
        loss.backward()
        grads = {n: p.grad if p.grad is not None else torch.zeros_like(p)
                 for n, p in state.params.items()}
        t1 = sync_time(dev)
        lr = schedule(state.step)
        norm = apply_updates(state, grads, cfg, schedule)
        for p in state.params.values():
            p.grad = None
        t2 = sync_time(dev)
        return {"total_loss": float(loss.detach()),
                "grad_norm": float(norm), "lr": lr,
                "fwd_bwd_ms": (t1 - t0) * 1e3,
                "opt_ms": (t2 - t1) * 1e3}

    return init_state, train_step
