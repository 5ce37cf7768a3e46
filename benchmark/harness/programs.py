"""The system under test, built from a configuration file and the seed:
``seedx_tpu_torch``'s runtime (ViT + agent) and its SDXL adapter, with
every weight drawn by ``weights.draw`` on the device and quantized by the
port's own quantizers where the configuration serves it quantized."""

from __future__ import annotations

import dataclasses
from typing import Dict

import torch

from benchmark.harness.weights import draw, fill_, float_leaves


def stated_dtypes(cfg: Dict) -> set:
    """Every ``torch_dtype`` the configuration states, nested groups
    included."""
    out = set()
    for key, value in cfg.items():
        if isinstance(value, dict):
            out |= stated_dtypes(value)
        elif key == "torch_dtype":
            out.add(value)
    return out


def set_precision(cfg: Dict) -> None:
    """The program computes in the precisions its configuration states:
    TF32 is not among them (the configurations state float32 and
    bfloat16), so matmuls and convolutions in float32 run in float32.
    Only a configuration that states ``tf32`` lets them use it."""
    tf32 = "tf32" in stated_dtypes(cfg)
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32


def vit_config(cfg: Dict):
    from seedx_tpu_torch.models.vit import ViTConfig

    v = cfg["vision"]
    return ViTConfig(image_size=v["image_size"], patch_size=v["patch_size"],
                     width=v["width"], layers=v["layers"], heads=v["heads"],
                     mlp_ratio=v["mlp_ratio"], n_queries=v["n_queries"],
                     output_dim=v["output_dim"])


def llama_config(cfg: Dict, quantization: str, kv: str):
    from seedx_tpu_torch.models.llama import LlamaConfig

    return LlamaConfig(
        vocab_size=cfg["vocab_size"], hidden_size=cfg["hidden_size"],
        intermediate_size=cfg["intermediate_size"],
        num_layers=cfg["num_hidden_layers"],
        num_heads=cfg["num_attention_heads"],
        num_kv_heads=cfg["num_key_value_heads"],
        rope_theta=float(cfg["rope_theta"]), rms_eps=cfg["rms_norm_eps"],
        max_position_embeddings=cfg["max_position_embeddings"],
        quantization=quantization, kv_quantization=kv)


def agent_config(cfg: Dict, quantization: str = "int4", kv: str = "int8"):
    from seedx_tpu_torch.models.agent import AgentConfig

    a = cfg["agent"]
    return AgentConfig(llm=llama_config(cfg, quantization, kv),
                       num_img_in_tokens=a["num_img_in_tokens"],
                       num_img_out_tokens=a["num_img_out_tokens"],
                       vit_dim=a["vit_dim"],
                       resampler_heads=a["resampler_heads"])


def wide_tokenizer():
    """The port's byte-level tokenizer, whose decode renders no text for
    ids past its multimodal vocabulary (the model's rows above 32330 have
    no entry in it; text is not judged here)."""
    from seedx_tpu_torch.text.tokenizer import ByteFallbackTokenizer

    class WideVocabTokenizer(ByteFallbackTokenizer):
        def decode(self, ids, skip_special_tokens=False):
            limit = self.vocab.vocab_size
            return super().decode([int(t) for t in ids if int(t) < limit],
                                  skip_special_tokens)

    return WideVocabTokenizer()


@torch.no_grad()
def build_vit(cfg: Dict, seed: int, device):
    from seedx_tpu_torch.models.vit import VisionTransformer

    vit = VisionTransformer(vit_config(cfg), device).eval()
    fill_(vit, seed, "vit.")
    return vit


@torch.no_grad()
def build_runtime(cfg: Dict, seed: int, device):
    """The SEED-X-I serving runtime: ViT-bigG (bf16), the agent with its
    LLM at the configuration's sizes, int4 g128 projections, int8
    embedding and LM head, int8 KV cache."""
    from seedx_tpu_torch.inference.runtime import SeedXRuntime
    from seedx_tpu_torch.models.agent import ContinuousLVLM
    from seedx_tpu_torch.models.llama import LlamaForCausalLM
    from seedx_tpu_torch.utils.quantize import quantize_llama_params

    serving = cfg["serving"]
    acfg = agent_config(cfg, serving["quantization"], serving["kv_cache"])
    vit = build_vit(cfg, seed, device)
    agent = ContinuousLVLM(acfg, device).eval()
    for name, t in float_leaves(agent):
        if not name.startswith("llm."):
            t.copy_(draw(seed, "agent." + name, t.shape, t.dtype, device))
    # the LLM's full-precision leaves one at a time, quantized by the port
    plain = dataclasses.replace(acfg.llm, quantization="none")
    meta = LlamaForCausalLM(plain, torch.device("meta"))
    state = agent.llm.state_dict()
    for name, t in float_leaves(meta):
        raw = draw(seed, "agent.llm." + name, t.shape, plain.dtype, device)
        for qname, q in quantize_llama_params(
                {name: raw}, serving["quantization"]).items():
            state[qname].copy_(q)
        del raw
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return SeedXRuntime(tokenizer=wide_tokenizer(),
                        vit_cfg=vit_config(cfg), vit=vit, agent_cfg=acfg,
                        agent=agent,
                        base_resolution=cfg["vision"]["image_size"],
                        resolution_grids=tuple(cfg["vision"]["grids"]))


def adapter_config(cfg: Dict):
    from seedx_tpu_torch.models.adapter import AdapterConfig
    from seedx_tpu_torch.models.detokenizer import DetokenizerConfig
    from seedx_tpu_torch.models.sdxl.pipeline import SamplerConfig
    from seedx_tpu_torch.models.sdxl.unet import UNetConfig

    u, r, s = cfg, cfg["resampler"], cfg["sampler"]
    unet = UNetConfig(
        in_channels=u["in_channels"], out_channels=u["out_channels"],
        block_out_channels=tuple(u["block_out_channels"]),
        layers_per_block=u["layers_per_block"],
        transformer_layers=tuple(
            d if kind.startswith("CrossAttn") else 0 for d, kind in
            zip(u["transformer_layers_per_block"], u["down_block_types"])),
        cross_attention_dim=u["cross_attention_dim"],
        attention_head_dim=u["block_out_channels"][-1]
        // u["attention_head_dim"][-1],
        addition_time_embed_dim=u["addition_time_embed_dim"],
        projection_class_embeddings_input_dim=u[
            "projection_class_embeddings_input_dim"],
        norm_num_groups=u["norm_num_groups"])
    res = DetokenizerConfig(
        dim=r["dim"], depth=r["depth"], dim_head=r["dim_head"],
        heads=r["heads"], num_queries=r["num_queries"],
        embedding_dim=r["embedding_dim"], output1_dim=r["output1_dim"],
        output2_dim=r["output2_dim"], ff_mult=r["ff_mult"],
        normalize=r["normalize"])
    sampler = SamplerConfig(height=s["height"], width=s["width"],
                            num_inference_steps=s["num_inference_steps"],
                            guidance_scale=s["guidance_scale"],
                            solver=s["solver"])
    return AdapterConfig(unet=unet, resampler=res, sampler=sampler)


def vae_config(cfg: Dict):
    from seedx_tpu_torch.models.sdxl.vae import VAEConfig

    v = cfg["vae"]
    return VAEConfig(channels=tuple(v["block_out_channels"]),
                     latent_channels=v["latent_channels"],
                     layers_per_block=v["layers_per_block"],
                     norm_num_groups=v["norm_num_groups"],
                     scaling_factor=v["scaling_factor"])


@torch.no_grad()
def build_adapter(cfg: Dict, seed: int, device):
    """The SEED-X-I de-tokenizer: ResamplerXL and the SDXL UNet in bf16,
    the VAE decoder in fp32, ViT-bigG (bf16) for the CFG negatives."""
    from seedx_tpu_torch.models.adapter import SDXLAdapter
    from seedx_tpu_torch.models.detokenizer import ResamplerXL
    from seedx_tpu_torch.models.sdxl.unet import UNet2DCondition
    from seedx_tpu_torch.models.sdxl.vae import VAEDecoder

    acfg = adapter_config(cfg)
    unet = UNet2DCondition(acfg.unet, device).eval()
    fill_(unet, seed, "unet.")
    res = ResamplerXL(acfg.resampler, device).eval()
    fill_(res, seed, "resampler.")
    vae = VAEDecoder(vae_config(cfg), device).eval()
    fill_(vae, seed, "vae_decoder.")
    vit = build_vit(cfg, seed, device)
    return SDXLAdapter(acfg, unet, res, vae, None, visual_encoder=vit)
