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

``shard(mesh)`` places the ViT and the agent on a device mesh (each rank
its shard of every weight, ``parallel/mesh.place_params``) and the
adapter replicated; the engines, chat and generation then run on every
rank, each over its own heads.

``SeedXRuntime.from_pretrained(root, model)`` builds the runtime from the
release checkpoint tree (``from_checkpoints`` from any set of the
artifacts) through the factories of ``models/factory.py``; with
``quantization="int4"`` the LLM's converted weights are quantized on the
device as they are copied in.
"""

from __future__ import annotations

import dataclasses
import os
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
                                        vit_downsample, vit_tiny_debug)
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
        self.mesh = None
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
    def from_checkpoints(
        cls,
        vit_path: Optional[str] = None,        # pretrained/QwenViT/qwen_vit_G.pt
        llm_path: Optional[str] = None,        # pretrained/seed_x*/llm/...
        agent_path: Optional[str] = None,      # pretrained/seed_x*/agent/...
        tokenizer_path: Optional[str] = None,
        detokenizer_path: Optional[str] = None,  # seed_detokenizer stage ckpt
        sdxl_unet_path: Optional[str] = None,    # SDXL base unet dir / file
        sdxl_vae_path: Optional[str] = None,
        lora_rank: int = 32,
        with_latent_image: bool = False,         # Edit variant
        quantization: str = "none",
        vit_quantization: str = "none",          # "int8": half the bytes
        unet_quantization: str = "none",         # "int8": half the bytes
        validate: bool = False,                  # manifest-check first
        device="cuda",
    ) -> "SeedXRuntime":
        """The runtime from release artifacts (reference README.md:74-158
        and the eval scripts' setup, eval_img2text_seed_x_i.py:66-117),
        built on ``device`` (the card unless the caller asks for
        ``"cpu"``).  ``validate=True`` checks every state dict against the
        release manifests (utils/manifest.py) and fails with the key /
        shape diff before anything is converted.  An int4 / int8
        ``quantization`` quantizes the loaded LLM weights as they are
        copied to the device."""
        from seedx_tpu_torch.models.factory import (build_agent,
                                                    build_llm_config,
                                                    build_sdxl_adapter,
                                                    build_visual_encoder)

        vit = build_visual_encoder(pretrained_model_path=vit_path,
                                   validate=validate, device=device)
        llm_cfg = build_llm_config(lora_rank=lora_rank,
                                   quantization=quantization)
        agent = build_agent(llm_cfg, pretrained_llm_path=llm_path,
                            pretrained_agent_path=agent_path,
                            validate=validate, device=device)
        adapter = None
        if sdxl_unet_path or detokenizer_path:
            adapter = build_sdxl_adapter(
                detokenizer_path=detokenizer_path,
                sdxl_unet_path=sdxl_unet_path, sdxl_vae_path=sdxl_vae_path,
                with_latent_image=with_latent_image, visual_encoder=vit,
                validate=validate, device=device)
        rt = cls(tokenizer=load_tokenizer(tokenizer_path), vit_cfg=vit.cfg,
                 vit=vit, agent_cfg=agent.cfg, agent=agent, adapter=adapter)
        if vit_quantization == "int8":
            rt.quantize_vit()
        if unet_quantization == "int8" and adapter is not None:
            adapter.quantize_unet()
        return rt

    # The released artifact layout under ``pretrained/`` (reference
    # README.md:74-87 + configs/clm_models/*_seed_x*.yaml paths).
    RELEASE_MODELS = ("seed_x", "seed_x_i", "seed_x_edit")

    @classmethod
    def from_pretrained(
        cls,
        root: str = "pretrained",
        model: str = "seed_x_i",
        with_adapter: bool = True,
        validate: bool = True,
        **kw,
    ) -> "SeedXRuntime":
        """One call over the release checkpoint layout the reference
        README tells users to create (README.md:74-87; config paths
        agent_seed_x_i.yaml:23, llm_seed_x_i.yaml:2, qwen_vitg_448.yaml:11,
        sdxl_qwen_vit_resampler_l4_q64*.yaml):

            <root>/QwenViT/qwen_vit_G.pt
            <root>/<model>/llm/                  (HF shards dir)
            <root>/<model>/agent/pytorch_model.bin
            <root>/seed_detokenizer/first_stage/pytorch_model.bin
                                   (second_stage for the edit variant)
            <root>/stable-diffusion-xl-base-1.0/{unet,vae}/

        ``model`` is ``seed_x`` (foundation), ``seed_x_i`` (instruct) or
        ``seed_x_edit`` (editing: the latent-image UNet and the
        second-stage detokenizer).  With ``with_adapter=False`` the
        detokenizer and SDXL are not needed; a missing required piece
        raises FileNotFoundError listing what the README says to
        download.  ``validate=True`` (the default here, unlike
        ``from_checkpoints``) manifest-checks every artifact first;
        ``kw`` goes to ``from_checkpoints`` (``quantization``,
        ``device``, ...)."""
        if model not in cls.RELEASE_MODELS:
            raise ValueError(f"model must be one of {cls.RELEASE_MODELS}, "
                             f"got {model!r}")
        edit = model == "seed_x_edit"
        vit_path = os.path.join(root, "QwenViT", "qwen_vit_G.pt")
        llm_path = os.path.join(root, model, "llm")
        agent_path = os.path.join(root, model, "agent", "pytorch_model.bin")
        stage = "second_stage" if edit else "first_stage"
        detok_path = os.path.join(root, "seed_detokenizer", stage,
                                  "pytorch_model.bin")
        sdxl = os.path.join(root, "stable-diffusion-xl-base-1.0")
        unet_path, vae_path = (os.path.join(sdxl, "unet"),
                               os.path.join(sdxl, "vae"))

        required = {"QwenViT visual encoder (run the reference's "
                    "src/tools/reload_qwen_vit.py)": vit_path,
                    f"{model} LLM shards": llm_path,
                    f"{model} agent checkpoint": agent_path}
        if with_adapter:
            required.update({
                f"seed_detokenizer {stage}": detok_path,
                "SDXL base UNet": unet_path, "SDXL base VAE": vae_path})
        missing = {what: p for what, p in required.items()
                   if not os.path.exists(p)}
        if missing:
            raise FileNotFoundError(
                "missing release artifacts under "
                f"{root!r} (download per reference README.md:74-87):\n"
                + "\n".join(f"  {p}  <- {what}"
                            for what, p in missing.items()))
        return cls.from_checkpoints(
            vit_path=vit_path, llm_path=llm_path, agent_path=agent_path,
            detokenizer_path=detok_path if with_adapter else None,
            sdxl_unet_path=unet_path if with_adapter else None,
            sdxl_vae_path=vae_path if with_adapter else None,
            with_latent_image=edit, validate=validate, **kw)

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

    def quantize_vit(self) -> "SeedXRuntime":
        """Switch the visual encoder to int8 trunk weights (in place; the
        JAX package's ``quantize_vit``, the same bytes): ViT-bigG's 3.8 GB
        of bf16 become 1.9 GB.  An adapter sharing the ViT for its CFG
        negatives gets the new one."""
        from seedx_tpu_torch.utils.quantize import quantize_vit_params

        if self.vit_cfg.quantization == "int8":
            return self
        cfg = dataclasses.replace(self.vit_cfg, quantization="int8")
        vit = VisionTransformer(cfg, self.device).eval()
        with torch.no_grad():
            vit.load_state_dict(quantize_vit_params(self.vit.state_dict()),
                                strict=True)
        if self.adapter is not None and \
                self.adapter.visual_encoder is self.vit:
            self.adapter.visual_encoder = vit
        self.vit_cfg, self.vit = cfg, vit
        return self

    # ---- placement ---------------------------------------------------------

    def shard(self, mesh: Optional[Any] = None,
              rules: Optional[Any] = None) -> "SeedXRuntime":
        """Place the runtime on a device mesh (reference runtime.py:306-346):
        the ViT's and the agent's weights split per the logical rules
        (embed over ``fsdp``; heads, MLP columns and the vocab over
        ``tensor``), each rank keeping only its shard; the adapter, if
        any, replicated (``SDXLAdapter.shard``).  Every rank then runs the
        same host code on its shards: the flash and decode attention
        kernels over its own heads, the W4A8 matmul on its columns or rows.
        ``mesh`` defaults to ``local_mesh()``.  Each group runs one
        collective here (NCCL sets its communicators up then, never under
        a capture); under gloo the captured programs are off.  Captured
        decode programs of the unsharded weights are dropped.  Call it on
        every rank, with the same weights (the same seed or checkpoint)."""
        from seedx_tpu_torch.parallel.mesh import (DEFAULT_RULES, local_mesh,
                                                   place_params)

        mesh = mesh if mesh is not None else local_mesh(self.device.type)
        rules = tuple(rules) if rules is not None else DEFAULT_RULES
        self.agent.__dict__.pop("decode_programs", None)
        place_params(self.vit, mesh, rules)
        place_params(self.agent, mesh, rules)
        groups = self.agent.llm.layers.q_proj._par
        groups.warm_up(self.device)
        if groups.backend == "gloo":
            self.graphs.enabled = False
        if self.adapter is not None:
            self.adapter.shard(mesh, rules)
        self.mesh = mesh
        return self

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

    def pool_vit(self, embeds: torch.Tensor) -> torch.Tensor:
        """The 4x-pooled ViT targets when ``vit_down`` (reference
        runtime.py:391)."""
        return vit_downsample(embeds) if self.vit_down else embeds

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
