"""SeedXRuntime: tokenizer, image transform, ViT and agent bundled once
(reference: seedx_tpu/inference/runtime.py).

``SeedXRuntime.debug()`` builds the tiny random stack so the apps run
anywhere; ``SeedXRuntime.random()`` builds any configuration with random
weights made on the device from a seed, quantizing the int4 agent one
layer at a time so no full-precision 13B tree ever exists.  Loading
released checkpoints (``from_checkpoints`` / ``from_pretrained``) and the
SDXL adapter are not ported yet.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Sequence

import numpy as np
import torch

from seedx_tpu_torch.data.anyres import (grid_pinpoints_from_strings,
                                         process_anyres_image)
from seedx_tpu_torch.data.transforms import get_transform
from seedx_tpu_torch.models.agent import AgentConfig, ContinuousLVLM
from seedx_tpu_torch.models.generation import GenerationConfig, generate
from seedx_tpu_torch.models.layers import init_normal_
from seedx_tpu_torch.models.llama import llama_debug
from seedx_tpu_torch.models.vit import (ViTConfig, VisionTransformer,
                                        vit_tiny_debug)
from seedx_tpu_torch.text.tokenizer import load_tokenizer
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

    # ---- constructors ------------------------------------------------------

    @classmethod
    def random(cls, vit_cfg: ViTConfig, agent_cfg: AgentConfig,
               seed: int = 0, device=None, **kw) -> "SeedXRuntime":
        """Random weights from ``seed``, drawn on ``device``."""
        device = torch.device(device or "cpu")
        gen = torch.Generator(device=device)
        gen.manual_seed(seed)
        vit = init_normal_(VisionTransformer(vit_cfg, device).eval(), gen)
        agent = init_normal_(ContinuousLVLM(agent_cfg, device).eval(), gen)
        if agent_cfg.llm.quantization != "none":
            random_quantized_llama_(agent.llm, gen)
        return cls(tokenizer=load_tokenizer(), vit_cfg=vit_cfg, vit=vit,
                   agent_cfg=agent_cfg, agent=agent, **kw)

    @classmethod
    def debug(cls, seed: int = 0, image_size: int = 56,
              dtype: torch.dtype = torch.bfloat16, device=None,
              quantization: str = "none",
              kv_quantization: str = "none") -> "SeedXRuntime":
        """Tiny random stack with the JAX package's ``debug()`` geometry."""
        vit_cfg = vit_tiny_debug(image_size=image_size, output_dim=64,
                                 dtype=dtype)
        llm_cfg = llama_debug(hidden_size=128, intermediate_size=256,
                              num_layers=2, num_heads=4, num_kv_heads=4,
                              dtype=dtype, quantization=quantization,
                              kv_quantization=kv_quantization)
        agent_cfg = AgentConfig(llm=llm_cfg, vit_dim=64, resampler_heads=4,
                                num_img_in_tokens=64,
                                num_img_out_tokens=vit_cfg.n_queries,
                                vit_down=False, dtype=dtype)
        return cls.random(vit_cfg, agent_cfg, seed=seed, device=device,
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
