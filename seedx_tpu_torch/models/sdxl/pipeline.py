"""SDXL sampling: text-to-image and InstructPix2Pix-style editing
(reference: seedx_tpu/models/sdxl/pipeline.py; diffusers'
``StableDiffusionXLPipeline`` driven with embeddings only,
adapter_modules.py:78-86, and ``StableDiffusionXLText2ImageAndEditPipeline``,
pipeline_stable_diffusion_xl_t2i_edit.py:490-551, 905-941).

The denoise loop (the JAX package's ``lax.scan``) replays one CFG UNet
eval a step (``CFGEval``: a captured CUDA graph over static buffers on
the card, ``utils/graphs.py``); the solver update between evals stays
eager.  Dtypes follow the JAX package step by step: the latents
and the solver state in fp32, the UNet's eps and the CFG combination in
the UNet's compute dtype, ``decode_latents`` in fp32.  CFG combines in eps
space: the combination is affine with weights summing to 1, so it commutes
with the reference's eps -> x0 conversion (its "sigma-space hack").

On a row split (``unet.RowSplit``, ``SDXLAdapter.shard``) the eval also
splits its CFG batch over the split's ``batch`` axis (the rule
``("cfg_batch", "data")``): each rank runs the UNet on its block of the
branches (padded with zero rows to a multiple of the axis, as GSPMD
pads, the pad rows dropped after the gather), its rows split inside the
UNet, and the branches are gathered before the guidance combine, so
every rank holds the same eps and steps the same latents.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Tuple

import torch

from seedx_tpu_torch.models.sdxl.scheduler import (EulerSchedule,
                                                   dpmpp_2m_step,
                                                   dpmpp_3m_step, euler_step,
                                                   scale_model_input)
from seedx_tpu_torch.models.sdxl.unet import row_split
from seedx_tpu_torch.utils import profiling
from seedx_tpu_torch.utils.graphs import Graphs, Program


@dataclasses.dataclass(frozen=True)
class SamplerConfig:
    height: int = 1024
    width: int = 1024
    num_inference_steps: int = 30          # 50 in eval scripts
    guidance_scale: float = 7.5
    image_guidance_scale: float = 1.5
    guidance_rescale: float = 0.0
    latent_channels: int = 4
    vae_scale: int = 8
    vae_scaling_factor: float = 0.13025

    solver: str = "euler"          # "euler" (parity) | "dpmpp_2m" | "dpmpp_3m"

    @property
    def latent_hw(self) -> Tuple[int, int]:
        return self.height // self.vae_scale, self.width // self.vae_scale


def _solver_loop(schedule: EulerSchedule, latents: torch.Tensor,
                 eps_fn: Callable) -> torch.Tensor:
    """The denoise loop: ``eps_fn(lat, sigma, t)`` is the CFG-combined UNet
    eval, each call an ``sdxl.unet_eval`` span with its device time; the
    update around it follows ``schedule.solver`` (DPM-Solver++ carries the
    previous one or two x0 predictions)."""
    dev = latents.device

    def table(a):
        return None if a is None else torch.as_tensor(a, device=dev)

    sigmas, timesteps = table(schedule.sigmas), table(schedule.timesteps)
    r0s, second = table(schedule.r0), table(schedule.second_order)
    r1s, c1s, c2s = table(schedule.r1), table(schedule.c1), table(schedule.c2)
    orders = table(schedule.order)
    m1 = torch.zeros(latents.shape, dtype=torch.float32, device=dev)
    m2 = torch.zeros_like(m1)
    for i in range(schedule.num_steps):
        sigma, sigma_next = sigmas[i], sigmas[i + 1]
        with profiling.annotate("sdxl.unet_eval", device=True) as span:
            span["i"] = i
            eps_cfg = eps_fn(latents, sigma, timesteps[i])
        if schedule.solver == "dpmpp_3m":
            latents, m1, m2 = dpmpp_3m_step(latents, m1, m2, eps_cfg, sigma,
                                            sigma_next, r0s[i], r1s[i],
                                            c1s[i], c2s[i], orders[i])
        elif schedule.solver == "dpmpp_2m":
            latents, m1 = dpmpp_2m_step(latents, m1, eps_cfg, sigma,
                                        sigma_next, r0s[i], second[i])
        else:
            latents = euler_step(latents, eps_cfg, sigma, sigma_next)
    return latents


def default_time_ids(cfg: SamplerConfig, batch: int,
                     device=None) -> torch.Tensor:
    """[orig_h, orig_w, crop_top, crop_left, target_h, target_w]."""
    ids = torch.tensor([cfg.height, cfg.width, 0, 0, cfg.height, cfg.width],
                       dtype=torch.float32, device=device)
    return ids.expand(batch, 6)


def rescale_noise_cfg(noise_cfg: torch.Tensor, noise_pred_text: torch.Tensor,
                      guidance_rescale: float) -> torch.Tensor:
    """(reference: pipeline...py:90-102; arXiv:2305.08891 sec. 3.4).  The
    standard deviations are population ones (``jnp.std``'s ddof 0),
    computed in fp32 and rounded to the input dtype, as ``jnp.std`` does
    for bf16."""
    dims = tuple(range(1, noise_cfg.dim()))

    def std(t):
        return torch.std(t.float(), dim=dims, correction=0,
                         keepdim=True).to(t.dtype)

    rescaled = noise_cfg * (std(noise_pred_text) / (std(noise_cfg) + 1e-12))
    return guidance_rescale * rescaled + (1.0 - guidance_rescale) * noise_cfg


@torch.no_grad()
def cfg_eps(unet, lat: torch.Tensor, sigma, t, context: torch.Tensor,
            pooled: torch.Tensor, time_ids: torch.Tensor,
            cond: Optional[torch.Tensor], guidance_scale: float,
            image_guidance_scale: float, guidance_rescale: float
            ) -> torch.Tensor:
    """One CFG-combined UNet eval: the UNet over the n = len(context) /
    len(lat) branches of ``lat`` at once, then their combination (and
    ``rescale_noise_cfg``).  ``cond`` None: text to image, branches
    [uncond, text]; else the edit's, branches [text, image, uncond] (or
    [text, image] when n is 2, the gi = 1 collapse), ``cond`` [n * B, h,
    w, c] channel-concat to each branch's input."""
    n = context.shape[0] // lat.shape[0]
    scaled = scale_model_input(torch.cat([lat] * n), sigma)
    if cond is not None:
        scaled = torch.cat([scaled, cond.to(scaled.dtype)], dim=-1)
    split = row_split(unet)
    if split is None:
        eps = unet(scaled, t.expand(len(scaled)), context, pooled, time_ids)
    else:
        eps = _split_branches(unet, split, scaled, t, context, pooled,
                              time_ids)
    if cond is None:
        eps_uncond, eps_text = eps.chunk(2)
        eps_cfg = eps_uncond + guidance_scale * (eps_text - eps_uncond)
    elif n == 2:
        eps_text, eps_image = eps.chunk(2)
        eps_cfg = eps_image + guidance_scale * (eps_text - eps_image)
    else:
        eps_text, eps_image, eps_uncond = eps.chunk(3)
        eps_cfg = (eps_uncond
                   + guidance_scale * (eps_text - eps_image)
                   + image_guidance_scale * (eps_image - eps_uncond))
    if guidance_rescale > 0.0:
        eps_cfg = rescale_noise_cfg(eps_cfg, eps_text, guidance_rescale)
    return eps_cfg


def _split_branches(unet, split, scaled, t, context, pooled, time_ids):
    """The UNet over this rank's block of the CFG batch (zero-padded to a
    multiple of the batch axis), then every rank's eps, pad rows
    dropped."""
    groups, axis = split.groups, split.batch
    d, r, rows = groups.size[axis], groups.rank[axis], scaled.shape[0]
    per = -(-rows // d)

    def mine(x):
        if per * d != rows:
            x = torch.cat([x, x.new_zeros((per * d - rows,) + x.shape[1:])])
        return x[r * per:(r + 1) * per]

    eps = unet(mine(scaled), t.expand(per), mine(context), mine(pooled),
               mine(time_ids))
    return groups.all_gather(eps, 0, axis)[:rows]


class CFGEval:
    """``cfg_eps`` over static buffers, as one program (the body of the
    JAX package's ``_solver_scan``): the latents, sigma and timestep are
    copied in at every step, the conditioning once per image
    (``set_conditioning``); on the card the eval is a captured CUDA graph
    replayed once a step while ``graphs`` is on (None: always eager), its
    eps a static output the next step overwrites.  An owner keeps one per
    ``key`` (UNet, its row split, CFG batch, latent shape, dtypes,
    guidance)."""

    def __init__(self, unet, lat, context, pooled, time_ids, cond,
                 guidance_scale: float, image_guidance_scale: float,
                 guidance_rescale: float, graphs: Optional[Graphs]):
        dev = context.device
        self.unet = unet
        self.lat = torch.zeros_like(lat)
        self.sigma = torch.zeros((), dtype=torch.float32, device=dev)
        self.t = torch.zeros((), dtype=torch.float32, device=dev)
        self.context = torch.empty_like(context)
        self.pooled = torch.empty_like(pooled)
        self.time_ids = torch.empty_like(time_ids)
        self.cond = None if cond is None else torch.empty_like(cond)
        self.program = Program(
            lambda: cfg_eps(self.unet, self.lat, self.sigma, self.t,
                            self.context, self.pooled, self.time_ids,
                            self.cond, guidance_scale, image_guidance_scale,
                            guidance_rescale), dev, graphs)

    @staticmethod
    def key(unet, lat, context, pooled, time_ids, cond, guidance_scale,
            image_guidance_scale, guidance_rescale) -> tuple:
        shapes = tuple((tuple(x.shape), x.dtype) for x in
                       (lat, context, pooled, time_ids) + (
                           () if cond is None else (cond,)))
        split = row_split(unet)
        return ("cfg_eval", id(unet), None if split is None else split.key,
                shapes, float(guidance_scale), float(image_guidance_scale),
                float(guidance_rescale))

    def set_conditioning(self, context, pooled, time_ids, cond) -> None:
        self.context.copy_(context)
        self.pooled.copy_(pooled)
        self.time_ids.copy_(time_ids)
        if cond is not None:
            self.cond.copy_(cond)

    def __call__(self, lat, sigma, t) -> torch.Tensor:
        self.lat.copy_(lat)
        self.sigma.copy_(sigma)
        self.t.copy_(t)
        return self.program()


def _denoise(unet, schedule: EulerSchedule, latents, context, pooled,
             time_ids, cond, guidance_scale, image_guidance_scale,
             guidance_rescale, evals: Optional[Dict[tuple, CFGEval]],
             graphs: Optional[Graphs]):
    args = (unet, latents, context, pooled, time_ids, cond, guidance_scale,
            image_guidance_scale, guidance_rescale)
    key = CFGEval.key(*args)
    ev = None if evals is None else evals.get(key)
    if ev is None:
        ev = CFGEval(*args, graphs=graphs)
        if evals is not None:
            evals[key] = ev
    ev.set_conditioning(context, pooled, time_ids, cond)
    return _solver_loop(schedule, latents, ev)


def denoise_text2image(unet, schedule: EulerSchedule, latents: torch.Tensor,
                       prompt_embeds: torch.Tensor,
                       negative_prompt_embeds: torch.Tensor,
                       pooled: torch.Tensor, negative_pooled: torch.Tensor,
                       time_ids: torch.Tensor, guidance_scale: float = 7.5,
                       guidance_rescale: float = 0.0,
                       evals: Optional[Dict[tuple, CFGEval]] = None,
                       graphs: Optional[Graphs] = None) -> torch.Tensor:
    """2-way CFG sampling, branches [uncond, text]; returns the final
    latents (unscaled).  The eval is captured while ``graphs`` is on
    (None: eager) and kept in ``evals`` between calls (an adapter's), else
    built per call."""
    return _denoise(unet, schedule, latents,
                    torch.cat([negative_prompt_embeds, prompt_embeds]),
                    torch.cat([negative_pooled, pooled]),
                    torch.cat([time_ids, time_ids]), None, guidance_scale,
                    0.0, guidance_rescale, evals, graphs)


def denoise_edit(unet, schedule: EulerSchedule, latents: torch.Tensor,
                 image_latents: torch.Tensor, prompt_embeds: torch.Tensor,
                 negative_prompt_embeds: torch.Tensor, pooled: torch.Tensor,
                 negative_pooled: torch.Tensor, time_ids: torch.Tensor,
                 guidance_scale: float = 7.5,
                 image_guidance_scale: float = 1.5,
                 guidance_rescale: float = 0.0,
                 evals: Optional[Dict[tuple, CFGEval]] = None,
                 graphs: Optional[Graphs] = None) -> torch.Tensor:
    """3-way InstructPix2Pix CFG (reference: pipeline...py:905-937), branch
    order [text, image, uncond]: the text branch alone gets the prompt,
    the image branch pairs the negative prompt with the condition image
    (reference :883-885), and the condition latents are channel-concat,
    zeros on the uncond branch (reference :537-546).

    At ``image_guidance_scale == 1.0`` the combination ``u + g (t - i) +
    (i - u) = i + g (t - i)`` does not depend on the uncond branch, which
    is dropped: each step runs a batch of 2 in place of 3, with the same
    result up to rounding.  ``evals`` and ``graphs`` as in
    ``denoise_text2image``."""
    collapse = float(image_guidance_scale) == 1.0
    n = 2 if collapse else 3
    return _denoise(
        unet, schedule, latents,
        torch.cat([prompt_embeds] + [negative_prompt_embeds] * (n - 1)),
        torch.cat([pooled] + [negative_pooled] * (n - 1)),
        torch.cat([time_ids] * n),
        torch.cat([image_latents, image_latents]
                  + ([] if collapse else [torch.zeros_like(image_latents)])),
        guidance_scale, image_guidance_scale, guidance_rescale, evals, graphs)


def prepare_latents(generator: torch.Generator, batch: int,
                    cfg: SamplerConfig, schedule: EulerSchedule,
                    dtype=torch.float32) -> torch.Tensor:
    """Initial noise [B, h, w, latent] on the generator's device, scaled by
    the schedule's ``init_noise_sigma``."""
    h, w = cfg.latent_hw
    noise = torch.randn((batch, h, w, cfg.latent_channels),
                        generator=generator, dtype=dtype,
                        device=generator.device)
    return noise * schedule.init_noise_sigma


def decode_latents(vae_decoder, latents: torch.Tensor,
                   scaling_factor: float = 0.13025) -> torch.Tensor:
    """latents -> images in [0, 1], fp32 (the reference's upcast decode,
    pipeline...py:965-981)."""
    imgs = vae_decoder(latents.float() / scaling_factor)
    return torch.clamp(imgs / 2.0 + 0.5, 0.0, 1.0)
