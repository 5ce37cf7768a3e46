"""SeedXRuntime: tokenizer, image transform, ViT, agent and the optional
SDXL adapter (image out) bundled once (reference:
seedx_tpu/inference/runtime.py).

``SeedXRuntime.debug()`` builds the tiny random stack (with
``with_adapter=True`` the JAX package's debug adapter too);
``SeedXRuntime.random()`` builds any configuration with random weights
made on the device from a seed, quantizing the int4 agent one layer at a
time so no full-precision 13B tree ever exists, and an adapter when given
its config.  Both build on the card (``cuda``) unless the caller passes
``device="cpu"``.  Decode and the denoise loop's UNet evals run as
captured CUDA graphs on the card (``utils/graphs.py``); ``graphs`` is the
runtime's one switch, put on its agent and on any adapter it is given,
and ``graphs.enabled = False`` turns the runtime to the eager path.  The
CPU is always eager.
Loading released checkpoints (``from_checkpoints`` /
``from_pretrained``) is not ported yet.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Sequence

import numpy as np
import torch

from seedx_tpu_torch.data.anyres import (grid_pinpoints_from_strings,
                                         process_anyres_image)
from seedx_tpu_torch.data.transforms import get_transform
from seedx_tpu_torch.models.adapter import AdapterConfig, SDXLAdapter
from seedx_tpu_torch.models.agent import AgentConfig, ContinuousLVLM
from seedx_tpu_torch.models.detokenizer import DetokenizerConfig
from seedx_tpu_torch.models.generation import (GenerationConfig, generate,
                                               generate_batch)
from seedx_tpu_torch.models.layers import init_normal_
from seedx_tpu_torch.models.llama import llama_debug
from seedx_tpu_torch.models.sdxl.pipeline import SamplerConfig
from seedx_tpu_torch.models.sdxl.unet import sdxl_debug_unet
from seedx_tpu_torch.models.sdxl.vae import VAEConfig, vae_debug
from seedx_tpu_torch.models.vit import (ViTConfig, VisionTransformer,
                                        vit_tiny_debug)
from seedx_tpu_torch.text.tokenizer import load_tokenizer
from seedx_tpu_torch.utils.graphs import Graphs
from seedx_tpu_torch.utils.quantize import random_quantized_llama_

DEFAULT_RESOLUTION_GRIDS = ("1x1", "1x2", "1x3", "2x1", "3x1", "1x4", "4x1",
                            "2x2")  # eval_img2text_seed_x_i.py:57


@dataclasses.dataclass
class SeedXRuntime:
    tokenizer: Any
    vit_cfg: ViTConfig
    vit: VisionTransformer
    agent_cfg: AgentConfig
    agent: ContinuousLVLM
    base_resolution: int = 448
    resolution_grids: Sequence[str] = DEFAULT_RESOLUTION_GRIDS
    vit_down: bool = True      # 4x-pooled ViT targets (image-out slice)
    # Pad every anyres tile stack up to the next bucket before the ViT
    # runs (fewer distinct shapes); callers see exact shapes either way.
    tile_buckets: Optional[Sequence[int]] = None
    adapter: Optional[SDXLAdapter] = None    # image out (SDXL)

    def __post_init__(self):
        self.graphs = Graphs()
        self.agent.graphs = self.graphs
        if self.adapter is not None:
            self.adapter.graphs = self.graphs

    def __setattr__(self, name, value):
        # an agent or adapter given later takes the runtime's switch
        super().__setattr__(name, value)
        if (name in ("agent", "adapter") and value is not None
                and "graphs" in vars(self)):
            value.graphs = self.graphs

    # ---- constructors ------------------------------------------------------

    @classmethod
    def random(cls, vit_cfg: ViTConfig, agent_cfg: AgentConfig,
               seed: int = 0, device="cuda",
               adapter_cfg: Optional[AdapterConfig] = None,
               vae_cfg: Optional[VAEConfig] = None,
               **kw) -> "SeedXRuntime":
        """Random weights from ``seed``, drawn on ``device`` (the card
        unless the caller asks for ``"cpu"``).  With ``adapter_cfg`` the
        SDXL adapter too (``SDXLAdapter.random``, same seed), sharing the
        runtime's ViT for its CFG negatives."""
        device = torch.device(device)
        gen = torch.Generator(device=device)
        gen.manual_seed(seed)
        vit = init_normal_(VisionTransformer(vit_cfg, device).eval(), gen)
        agent = init_normal_(ContinuousLVLM(agent_cfg, device).eval(), gen)
        if agent_cfg.llm.quantization != "none":
            random_quantized_llama_(agent.llm, gen)
        adapter = None
        if adapter_cfg is not None:
            adapter = SDXLAdapter.random(adapter_cfg, vae_cfg, seed=seed,
                                         device=device, visual_encoder=vit)
        return cls(tokenizer=load_tokenizer(), vit_cfg=vit_cfg, vit=vit,
                   agent_cfg=agent_cfg, agent=agent, adapter=adapter, **kw)

    @classmethod
    def debug(cls, seed: int = 0, image_size: int = 56,
              dtype: torch.dtype = torch.bfloat16, device="cuda",
              quantization: str = "none", kv_quantization: str = "none",
              decode_attention: str = "auto",
              with_adapter: bool = False) -> "SeedXRuntime":
        """Tiny random stack with the JAX package's ``debug()`` geometry,
        on the card unless ``device="cpu"``.  ``with_adapter``: the JAX
        package's debug adapter (the 8-channel debug UNet, a one-block
        detokenizer, ``vae_debug``; 64^2 images at ``vae_scale`` 2, 3
        steps), its UNet and detokenizer in ``dtype``, the VAE fp32."""
        vit_cfg = vit_tiny_debug(image_size=image_size, output_dim=64,
                                 dtype=dtype)
        llm_cfg = llama_debug(hidden_size=128, intermediate_size=256,
                              num_layers=2, num_heads=4, num_kv_heads=4,
                              dtype=dtype, quantization=quantization,
                              kv_quantization=kv_quantization,
                              decode_attention=decode_attention)
        agent_cfg = AgentConfig(llm=llm_cfg, vit_dim=64, resampler_heads=4,
                                num_img_in_tokens=64,
                                num_img_out_tokens=vit_cfg.n_queries,
                                vit_down=False, dtype=dtype)
        adapter_cfg = None
        if with_adapter:
            ucfg = sdxl_debug_unet(in_channels=8, dtype=dtype)
            out2 = (ucfg.projection_class_embeddings_input_dim
                    - 6 * ucfg.addition_time_embed_dim)
            rcfg = DetokenizerConfig(
                dim=64, depth=1, dim_head=16, heads=4, num_queries=8,
                embedding_dim=64, output1_dim=ucfg.cross_attention_dim - out2,
                output2_dim=out2, ff_mult=2, dtype=dtype)
            adapter_cfg = AdapterConfig(
                unet=ucfg, resampler=rcfg,
                sampler=SamplerConfig(height=64, width=64,
                                      num_inference_steps=3, vae_scale=2),
                vit_down=False, with_latent_image=True)
        return cls.random(vit_cfg, agent_cfg, seed=seed, device=device,
                          adapter_cfg=adapter_cfg, vae_cfg=vae_debug(),
                          base_resolution=image_size, vit_down=False)

    @property
    def device(self) -> torch.device:
        return self.vit.proj.device

    # ---- vision ------------------------------------------------------------

    def image_transform(self):
        return get_transform("clip", keep_ratio=False,
                             image_size=self.base_resolution)

    def grid_pinpoints(self):
        return grid_pinpoints_from_strings(self.resolution_grids,
                                           self.base_resolution)

    @torch.no_grad()
    def encode_image_anyres(self, image, tile_buckets=None):
        """PIL image -> (vit_embeds [n_tiles+1, T, D], patch_pos
        [n_tiles+1, 2]) (reference: eval_img2text_seed_x_i.py:132-141).
        With ``tile_buckets`` (the argument wins over the runtime default)
        the tile stack is zero-padded to the next bucket before the ViT and
        sliced back after."""
        tiles, patch_pos = process_anyres_image(
            image, self.image_transform(), self.grid_pinpoints(),
            self.base_resolution)
        n = tiles.shape[0]
        buckets = (tile_buckets if tile_buckets is not None
                   else self.tile_buckets)
        if buckets:
            nb = next((x for x in sorted(buckets) if x >= n), n)
            if nb > n:
                tiles = np.concatenate(
                    [tiles, np.zeros((nb - n, *tiles.shape[1:]),
                                     tiles.dtype)])
        embeds = self.vit(torch.from_numpy(tiles).to(self.device))
        return embeds[:n], torch.from_numpy(patch_pos).to(self.device)

    @torch.no_grad()
    def encode_image_single(self, image) -> torch.Tensor:
        """One crop at the base resolution -> [1, T, D]."""
        arr = self.image_transform()(image)
        return self.vit(torch.from_numpy(arr)[None].to(self.device))

    # ---- language ----------------------------------------------------------

    def generate(self, input_ids, image_embeds=None, embeds_cmp_mask=None,
                 ids_cmp_mask=None, patch_positions=None,
                 max_new_tokens: int = 512,
                 generator: Optional[torch.Generator] = None,
                 timings: Optional[Dict[str, float]] = None, **kw):
        gen_cfg = GenerationConfig(
            max_new_tokens=max_new_tokens,
            num_img_gen_tokens=self.agent_cfg.num_img_out_tokens,
            eos_token_id=self.tokenizer.eos_token_id,
            pad_token_id=self.tokenizer.pad_token_id, **kw)
        return generate(self.agent, self.tokenizer, input_ids,
                        image_embeds=image_embeds,
                        embeds_cmp_mask=embeds_cmp_mask,
                        ids_cmp_mask=ids_cmp_mask,
                        patch_positions=patch_positions, gen_cfg=gen_cfg,
                        generator=generator, timings=timings)

    def generate_batch(self, requests, max_new_tokens: int = 512,
                       generator: Optional[torch.Generator] = None,
                       timings: Optional[Dict[str, float]] = None, **kw):
        """Batched serving: one prefill + decode loop over many request
        dicts (schema: ``models/generation.generate_batch``)."""
        gen_cfg = GenerationConfig(
            max_new_tokens=max_new_tokens,
            num_img_gen_tokens=self.agent_cfg.num_img_out_tokens,
            eos_token_id=self.tokenizer.eos_token_id,
            pad_token_id=self.tokenizer.pad_token_id, **kw)
        return generate_batch(self.agent, self.tokenizer, requests,
                              gen_cfg=gen_cfg, generator=generator,
                              timings=timings)
