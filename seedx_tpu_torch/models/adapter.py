"""SDXL adapter: generated visual embeddings -> images (reference:
seedx_tpu/models/adapter.py; the reference's ``SDXLAdapter`` /
``SDXLAdapterWithLatentImage``, src/models/detokenizer/adapter_modules.py).

It bundles the ``ResamplerXL`` detokenizer, the SDXL UNet and the VAE:
  * CFG negatives are a zeros image through the visual encoder (+ the 4x
    ``vit_downsample`` pooling for LLM-feature conditioning), not an empty
    text prompt (:96-130);
  * ``generate`` runs the text-to-image pipeline; the latent-image (edit)
    variant adds the VAE-encoded condition image and 3-way CFG
    (:132-169, 249-287);
  * ``diffusion_loss`` is the training forward, MSE on the predicted noise
    (:39-52), differentiable in the leaves ``layers.set_trainable_`` made
    parameters; ``train/train_adapter.py`` trains the de-tokenizer;
  * the trainable sets: the resampler + the UNet's to_k / to_v, or full
    FT, plus ``conv_in`` (:21-33, 183-209), as ``ADAPTER_TRAINABLE_PATTERNS``
    over the state names of ``{"unet": unet, "resampler": resampler}``.

``evals`` keeps the denoise loop's CFG UNet evals
(``models/sdxl/pipeline.CFGEval``, one per CFG batch, latent shape,
dtype, guidance and UNet), captured while ``graphs`` is on (a runtime
puts its own switch here), so ``text_to_image``, ``edit_image``,
``reconstruct`` and ``reconstruct_with_condition`` share them.  They are
inference only: training never runs under them.

``shard(mesh)`` places the adapter on a mesh as the JAX package does
(reference adapter.py:107-151): every rank holds the whole UNet, VAE and
resampler, broadcast from the mesh's first rank, and the denoise
activations split by the rules ``("cfg_batch", ...)`` and ``("height",
...)`` (default: CFG branches over ``data``, latent rows over ``tensor``
with conv halos; ``models/sdxl/unet.RowSplit``), as the JAX package's
``_spatial_constraint`` (unet.py:43-45, vae.py:25) inside ``_mesh_scope``.
The UNet and the VAE decoder run split; the conditioning and the VAE
encoder run whole on every rank, and every rank returns the whole image.
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from seedx_tpu_torch.models.detokenizer import DetokenizerConfig, ResamplerXL
from seedx_tpu_torch.models.generation import PhaseClock
from seedx_tpu_torch.models.layers import init_normal_
from seedx_tpu_torch.models.sdxl.pipeline import (CFGEval, SamplerConfig,
                                                  decode_latents,
                                                  default_time_ids,
                                                  denoise_edit,
                                                  denoise_text2image,
                                                  prepare_latents)
from seedx_tpu_torch.models.sdxl.scheduler import make_schedule
from seedx_tpu_torch.models.sdxl.unet import (UNet2DCondition, UNetConfig,
                                              row_split, split_rows)
from seedx_tpu_torch.models.sdxl.vae import (VAEConfig, VAEDecoder,
                                             VAEEncoder, sample_moments)
from seedx_tpu_torch.models.vit import vit_downsample
from seedx_tpu_torch.utils import profiling
from seedx_tpu_torch.utils.graphs import Graphs
from seedx_tpu_torch.utils.quantize import quantize_unet_params

# reference: adapter_modules.py:21-33 (to_k / to_v) + :204 (conv_in, edit);
# the JAX package's patterns (``unet/.*attn\d/to_k/.*``, ...) written on the
# port's state names
ADAPTER_TRAINABLE_PATTERNS: Tuple[str, ...] = (
    r"resampler\..*",
    r"unet\..*attn\d\.to_k\..*",
    r"unet\..*attn\d\.to_v\..*",
    r"unet\.conv_in\..*",
)


@dataclasses.dataclass(frozen=True)
class AdapterConfig:
    unet: UNetConfig
    resampler: DetokenizerConfig
    sampler: SamplerConfig = SamplerConfig()
    vit_down: bool = True
    with_latent_image: bool = False   # SEED-X-Edit variant


class SDXLAdapter:
    """The detokenizer, UNet and VAE modules of one adapter, with the
    visual encoder that makes its CFG negatives (shared with the
    runtime)."""

    def __init__(self, cfg: AdapterConfig, unet: UNet2DCondition,
                 resampler: ResamplerXL, vae_decoder: VAEDecoder,
                 vae_encoder: Optional[VAEEncoder] = None,
                 visual_encoder=None):
        self.cfg = cfg
        self.unet, self.resampler = unet, resampler
        self.vae_decoder, self.vae_encoder = vae_decoder, vae_encoder
        self.visual_encoder = visual_encoder
        self.graphs = Graphs()
        self.evals: Dict[tuple, CFGEval] = {}
        self.mesh, self.rules = None, None

    @classmethod
    def random(cls, cfg: AdapterConfig, vae_cfg: Optional[VAEConfig] = None,
               seed: int = 0, device="cuda",
               visual_encoder=None) -> "SDXLAdapter":
        """Random weights from ``seed``, drawn on ``device`` (the card
        unless the caller asks for ``"cpu"``); an int8 UNet config is drawn
        in full precision and quantized."""
        device = torch.device(device)
        gen = torch.Generator(device=device)
        gen.manual_seed(seed)
        vae_cfg = vae_cfg or VAEConfig()
        unet_cfg = dataclasses.replace(cfg.unet, quantize="none")

        def draw(module):
            return init_normal_(module.eval(), gen)

        adapter = cls(dataclasses.replace(cfg, unet=unet_cfg),
                      draw(UNet2DCondition(unet_cfg, device)),
                      draw(ResamplerXL(cfg.resampler, device)),
                      draw(VAEDecoder(vae_cfg, device)),
                      draw(VAEEncoder(vae_cfg, device)),
                      visual_encoder=visual_encoder)
        if cfg.unet.quantize == "int8":
            adapter.quantize_unet()
        return adapter

    @property
    def device(self) -> torch.device:
        module = next(m for m in (self.unet, self.resampler,
                                  self.vae_decoder) if m is not None)
        return next(itertools.chain(module.buffers(),
                                    module.parameters())).device

    # ---- serving quantization ----------------------------------------------

    def quantize_unet(self) -> "SDXLAdapter":
        """Switch the UNet to int8 weight-only serving (in place): half the
        weight bytes of the bf16 UNet; no reference counterpart (it serves
        fp16, eval_text2img_seed_x_i.py:59-64)."""
        if self.cfg.unet.quantize == "int8":
            return self
        ucfg = dataclasses.replace(self.cfg.unet, quantize="int8")
        unet = UNet2DCondition(ucfg, self.device).eval()
        with torch.no_grad():
            unet.load_state_dict(
                quantize_unet_params(self.unet.state_dict()), strict=True)
        self.cfg = dataclasses.replace(self.cfg, unet=ucfg)
        # the evals of the bf16 UNet hold it: let both go
        self.evals.clear()
        split_rows(unet, row_split(self.unet))
        self.unet = unet
        return self

    # ---- placement ---------------------------------------------------------

    def shard(self, mesh, rules=None) -> "SDXLAdapter":
        """Replicate the UNet, VAE and resampler over ``mesh``: each weight
        broadcast in place from the mesh's first rank (so every rank holds
        the same bytes and captured evals keep their addresses).  A visual
        encoder already placed on a mesh (the runtime's ViT, shared) keeps
        its placement; any other is replicated too.  Then the UNet and the
        VAE decoder split their activations as the rules map
        ``cfg_batch`` and ``height`` onto the mesh axes (a split over one
        rank runs its collectives too: the one-card path is the path of a
        larger mesh).  Each group runs one collective here (NCCL sets its
        communicators up then, never under a capture); under gloo the
        captured evals are off.  Sets ``mesh`` and ``rules``."""
        import torch.distributed as dist

        from seedx_tpu_torch.models.sdxl.unet import RowSplit
        from seedx_tpu_torch.parallel.distributed import MeshGroups
        from seedx_tpu_torch.parallel.mesh import (DEFAULT_RULES,
                                                   logical_to_mesh_axes)

        group = dist.new_group(mesh.mesh.flatten().tolist())
        src = int(mesh.mesh.flatten()[0])
        modules = [self.unet, self.resampler, self.vae_decoder,
                   self.vae_encoder]
        vit = self.visual_encoder
        if vit is not None and not any("_par" in vars(m)
                                       for m in vit.modules()):
            modules.append(vit)
        with torch.no_grad():
            for m in modules:
                if m is None:
                    continue
                for t in itertools.chain(m.buffers(), m.parameters()):
                    dist.broadcast(t.data, src=src, group=group)
        self.mesh = mesh
        self.rules = tuple(rules) if rules is not None else DEFAULT_RULES
        batch, rows = logical_to_mesh_axes(("cfg_batch", "height"),
                                           self.rules)
        if not (isinstance(batch, str) and isinstance(rows, str)):
            raise ValueError(f"the denoise splits its CFG batch and its "
                             f"rows over one mesh axis each, the rules give "
                             f"{batch!r} and {rows!r}")
        groups = MeshGroups(mesh)
        groups.warm_up(self.device)
        if groups.backend == "gloo":
            self.graphs.enabled = False
        split = RowSplit(groups, rows=rows, batch=batch)
        split_rows(self.unet, split)
        split_rows(self.vae_decoder, split)
        self.evals.clear()          # the evals of the unsplit UNet
        return self

    # ---- conditioning ------------------------------------------------------

    @torch.no_grad()
    def encode_image_embeds(self, image_embeds: torch.Tensor):
        """ViT / LLM features -> (prompt_embeds, pooled)
        (reference: adapter_modules.py:54-57)."""
        return self.resampler(image_embeds.to(self.device))

    @torch.no_grad()
    def negative_image_embeds(self, batch: int, image_size: int = 448,
                              pool: bool = True) -> torch.Tensor:
        """A zeros image through the visual encoder: the CFG negative.
        ``pool`` follows the reference (adapter_modules.py:96-116): LLM
        features (64 tokens) get the ``vit_down``-pooled negative, raw ViT
        features (the reconstruction path) the unpooled one."""
        if self.visual_encoder is None:
            raise ValueError("negative_image_embeds needs the adapter's "
                             "visual encoder")
        zeros = torch.zeros((1, image_size, image_size, 3),
                            dtype=torch.bfloat16, device=self.device)
        neg = self.visual_encoder(zeros)
        if pool and self.cfg.vit_down:
            neg = vit_downsample(neg)
        return neg.expand(batch, *neg.shape[1:])

    def get_conditioning(self, image_embeds: torch.Tensor,
                         negative_embeds: Optional[torch.Tensor] = None,
                         from_vit: bool = False):
        b = image_embeds.shape[0]
        if negative_embeds is None:
            negative_embeds = self.negative_image_embeds(b, pool=not from_vit)
        both = torch.cat([image_embeds.to(self.device),
                          negative_embeds.to(self.device)])
        prompt, pooled = self.encode_image_embeds(both)
        return prompt[:b], prompt[b:], pooled[:b], pooled[b:]

    # ---- training forward --------------------------------------------------

    def diffusion_loss(self, noisy_latents: torch.Tensor,
                       timesteps: torch.Tensor, image_embeds: torch.Tensor,
                       noise: torch.Tensor, time_ids: torch.Tensor
                       ) -> Dict[str, torch.Tensor]:
        """MSE on the eps prediction (reference: adapter_modules.py:39-52),
        differentiable in the trainable leaves; the training step's loss,
        with the noise, timesteps and Euler input scaling, is
        ``train/train_adapter.adapter_loss``."""
        prompt, pooled = self.resampler(image_embeds)
        eps = self.unet(noisy_latents, timesteps, prompt, pooled, time_ids)
        loss = torch.mean((eps.float() - noise.float()) ** 2)
        return {"total_loss": loss, "noise_pred": eps}

    # ---- generation --------------------------------------------------------

    @torch.no_grad()
    def generate(self, image_embeds: torch.Tensor, latent_image=None,
                 negative_embeds: Optional[torch.Tensor] = None,
                 from_vit: bool = False, seed: int = 42,
                 num_inference_steps: Optional[int] = None,
                 guidance_scale: Optional[float] = None,
                 image_guidance_scale: Optional[float] = None,
                 solver: Optional[str] = None,
                 timings: Optional[Dict[str, float]] = None) -> np.ndarray:
        """image_embeds [B, T, D] -> images [B, H, W, 3] float32 in [0, 1]
        (a host array).

        from_vit: the conditioning is raw ViT features (the detokenizer
        reconstruction path), which selects the unpooled CFG negative.
        latent_image: the condition image [B, H, W, 3] in [-1, 1] (edit
        variant), VAE-encoded with the mode.  The initial noise is drawn
        from a generator on the adapter's device seeded with ``seed``.
        ``timings``, when given, receives host seconds, each closed by a
        device synchronize: "conditioning" (negative ViT pass and
        ResamplerXL), "vae_encode" (edit variant with a condition image),
        "denoise" and "vae_decode".  The call is an ``sdxl.generate`` span
        over ``sdxl.conditioning``, ``sdxl.denoise`` (from the noise to the
        final latents, the edit variant's VAE encode included),
        ``sdxl.vae_decode`` and ``sdxl.to_host`` spans, each with ``b`` and
        ``steps``."""
        cfg = self.cfg.sampler
        steps = num_inference_steps or cfg.num_inference_steps
        g = guidance_scale if guidance_scale is not None else cfg.guidance_scale
        gi = (image_guidance_scale if image_guidance_scale is not None
              else cfg.image_guidance_scale)
        schedule = make_schedule(steps, solver=solver or cfg.solver)
        b, dev = image_embeds.shape[0], self.device
        clock = PhaseClock(dev, timings)

        def span(name):
            return profiling.annotate(name, b=b, steps=steps)

        with span("sdxl.generate"):
            with span("sdxl.conditioning"):
                prompt, neg_prompt, pooled, neg_pooled = \
                    self.get_conditioning(image_embeds, negative_embeds,
                                          from_vit=from_vit)
                clock.mark("conditioning")
            with span("sdxl.denoise"):
                gen = torch.Generator(device=dev)
                gen.manual_seed(seed)
                latents = prepare_latents(gen, b, cfg, schedule)
                time_ids = default_time_ids(cfg, b, dev)
                if self.cfg.with_latent_image:
                    # 8-channel UNet: without a condition image the
                    # reference concats zeros (pipeline...py:909-910), so
                    # t2i also runs the edit path
                    if latent_image is not None:
                        image_latents = sample_moments(self.vae_encoder(
                            torch.as_tensor(latent_image, device=dev)))
                        clock.mark("vae_encode")
                    else:
                        image_latents = torch.zeros_like(latents)
                    final = denoise_edit(
                        self.unet, schedule, latents, image_latents, prompt,
                        neg_prompt, pooled, neg_pooled, time_ids,
                        guidance_scale=g, image_guidance_scale=gi,
                        guidance_rescale=cfg.guidance_rescale,
                        evals=self.evals, graphs=self.graphs)
                else:
                    final = denoise_text2image(
                        self.unet, schedule, latents, prompt, neg_prompt,
                        pooled, neg_pooled, time_ids, guidance_scale=g,
                        guidance_rescale=cfg.guidance_rescale,
                        evals=self.evals, graphs=self.graphs)
                clock.mark("denoise")
            with span("sdxl.vae_decode"):
                images = decode_latents(self.vae_decoder, final,
                                        cfg.vae_scaling_factor)
                clock.mark("vae_decode")
            with span("sdxl.to_host"):
                return images.cpu().numpy()
