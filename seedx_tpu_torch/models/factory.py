"""Model factories, the ``_target_``s of the YAML config graph (reference:
seedx_tpu/models/factory.py; the reference's ``from_pretrained``
classmethods, qwen_visual.py:431-459, peft_models.py:27-106,
seed_x.py:225-234, adapter_modules.py:59-66).

Each builder makes its module on ``device`` (the card unless the caller
asks for ``"cpu"``) in the dtypes the port serves in (ViT, agent, UNet
and detokenizer bf16, VAE fp32) and either fills it from a release
checkpoint (``utils/weights.py``, ``utils/sdxl_weights.py``), one layer
at a time, or, given no checkpoint, with random weights from seed 0.
An int4 / int8 LLM config quantizes the converted weights as they are
copied in, through ``utils/quantize.quantize_llama_params`` (the JAX
package merges the converter's ``kernel`` leaves into a quantized init
tree, where the names do not match and the quantized leaves stay 0).

DEBUG mode: env ``SEEDX_DEBUG=1`` (or the reference's ``DEBUG_FLAG``)
gives tiny models whatever the config says, as the JAX package's.
"""

from __future__ import annotations

import functools
import logging
import os
from typing import Any, Callable, Mapping, Optional

import torch
from torch import nn

from seedx_tpu_torch.models.layers import init_normal_
from seedx_tpu_torch.utils.manifest import (ManifestReport,
                                            validate_state_dict)
from seedx_tpu_torch.utils.weights import LayerStack, load_checkpoint_auto

logger = logging.getLogger(__name__)


def _debug_mode() -> bool:
    return os.environ.get("SEEDX_DEBUG", os.environ.get("DEBUG_FLAG", "")) \
        in ("1", "True", "true")


def _generator(device) -> torch.Generator:
    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    return gen


@torch.no_grad()
def _merge_loaded(module: nn.Module, loaded: Mapping[str, Any], label: str,
                  prefix: str = "",
                  quantize: Optional[Callable] = None) -> ManifestReport:
    """Copy converted weights into ``module``'s state under ``prefix``
    (a ``LayerStack`` one layer at a time), each piece moved to the
    module's device and cast to its buffer's dtype; ``quantize`` (a state
    -> state function) lays each piece out for a quantized module, on the
    device.  Returns the missing / unexpected / shape-mismatched report
    (the reference prints the counts, adapter_modules.py:64-65) and logs
    it; a missing leaf keeps its value, a mismatched one is skipped."""
    targets = module.state_dict()
    dev = next(iter(targets.values())).device
    filled, unexpected, mismatched = set(), [], []
    for key, src in loaded.items():
        key = prefix + key
        parts = ([(i, src.get(i)) for i in range(src.n)]
                 if isinstance(src, LayerStack) else [(None, src)])
        for i, part in parts:
            piece = {key: part.to(dev)}
            if quantize is not None:
                piece = quantize(piece)
            for k, v in piece.items():
                dst = targets.get(k)
                if dst is None:
                    if i in (None, 0):
                        unexpected.append(k)
                    continue
                dst = dst if i is None else dst[i]
                if tuple(dst.shape) != tuple(v.shape):
                    if i in (None, 0):
                        mismatched.append((k, tuple(v.shape),
                                           tuple(dst.shape)))
                    continue
                dst.copy_(v)
                filled.add(k)
    rep = ManifestReport(
        name=label, missing=sorted(k for k in targets if k not in filled),
        unexpected=sorted(unexpected), mismatched=sorted(mismatched),
        n_checked=len(targets))
    if not rep.ok:
        logger.info("%s load: %d missing, %d unexpected, %d shape-mismatched",
                    label, len(rep.missing), len(rep.unexpected),
                    len(rep.mismatched))
    return rep


def _validate_sd(sd, manifest_name: str, strict: bool, extra_optional=(),
                 num_layers: Optional[int] = None) -> None:
    """Check a loaded state dict against the pinned release manifest
    (utils/manifest.py): log the diff; raise when ``strict``, so a wrong
    artifact fails before conversion."""
    rep = validate_state_dict(sd, manifest_name,
                              extra_optional=extra_optional,
                              num_layers=num_layers)
    if rep.ok:
        logger.info(rep.summary())
    elif strict:
        raise ValueError(rep.summary())
    else:
        logger.warning(rep.summary())


def build_visual_encoder(
    pretrained_model_path: Optional[str] = None,
    image_size: int = 448,
    patch_size: int = 14,
    width: int = 1664,
    layers: int = 48,
    heads: int = 16,
    mlp_ratio: float = 4.9231,
    output_dim: int = 4096,
    validate: bool = False,
    device="cuda",
    **unused,
):
    """-> VisionTransformer, bf16 (reference:
    VisionTransformerWithAttnPool.from_pretrained, qwen_visual.py:431-459);
    the JAX-only ``remat`` / ``param_dtype`` land in ``unused``."""
    from seedx_tpu_torch.models.vit import (ViTConfig, VisionTransformer,
                                            vit_tiny_debug)
    from seedx_tpu_torch.utils.weights import convert_qwen_vit

    if _debug_mode():
        cfg = vit_tiny_debug(image_size=image_size)
        pretrained_model_path = None
    else:
        cfg = ViTConfig(image_size=image_size, patch_size=patch_size,
                        width=width, layers=layers, heads=heads,
                        mlp_ratio=mlp_ratio, output_dim=output_dim)
    model = VisionTransformer(cfg, torch.device(device)).eval()
    if not pretrained_model_path:
        return init_normal_(model, _generator(device))
    sd = load_checkpoint_auto(pretrained_model_path)
    _validate_sd(sd, "qwen_vit", strict=validate, num_layers=cfg.layers)
    _merge_loaded(model, convert_qwen_vit(sd, num_layers=cfg.layers,
                                          num_heads=cfg.heads), "qwen_vit")
    return model


def build_llm_config(
    vocab_size: int = 32330,
    lora_rank: int = 0,
    lora_alpha: float = 32.0,
    lora_dropout: float = 0.05,
    **overrides,
):
    """-> LlamaConfig (reference: llm_seed_x_lora.yaml /
    get_peft_model_with_resize_embedding)."""
    from seedx_tpu_torch.models.llama import llama2_13b, llama_debug

    if _debug_mode():
        return llama_debug(lora_rank=lora_rank, lora_alpha=lora_alpha,
                           lora_dropout=lora_dropout)
    return llama2_13b(vocab_size=vocab_size, lora_rank=lora_rank,
                      lora_alpha=lora_alpha, lora_dropout=lora_dropout,
                      **overrides)


def build_agent(
    llm: Any,
    pretrained_llm_path: Optional[str] = None,
    pretrained_agent_path: Optional[str] = None,
    lm_loss_scale: float = 1.0,
    rec_loss_scale: float = 6.0,
    add_patch_pos: bool = True,
    vit_down: bool = True,
    vit_dim: int = 4096,
    num_img_in_tokens: int = 64,
    num_img_out_tokens: int = 64,
    validate: bool = False,
    device="cuda",
    **unused,
):
    """-> ContinuousLVLM (reference: ContinuousLVLM.from_pretrained,
    seed_x.py:225-234 + agent_seed_x.yaml).  The LLM weights come from
    ``pretrained_llm_path`` (an HF dir), then the agent checkpoint's
    ``llm.*`` keys over them; a quantized ``llm`` config quantizes each
    converted layer on the device as it is copied in."""
    from seedx_tpu_torch.models.agent import AgentConfig, ContinuousLVLM
    from seedx_tpu_torch.utils.quantize import (quantize_llama_params,
                                                random_quantized_llama_)
    from seedx_tpu_torch.utils.weights import (convert_agent_checkpoint,
                                               convert_llama_hf)

    if _debug_mode():
        # must match vit_tiny_debug's output_dim (128)
        vit_dim = 128 if vit_dim == 4096 else vit_dim
    cfg = AgentConfig(
        llm=llm, lm_loss_scale=lm_loss_scale, rec_loss_scale=rec_loss_scale,
        add_patch_pos=add_patch_pos, vit_down=vit_down, vit_dim=vit_dim,
        num_img_in_tokens=num_img_in_tokens,
        num_img_out_tokens=num_img_out_tokens,
        resampler_heads=32 if not _debug_mode() else 4)
    model = ContinuousLVLM(cfg, torch.device(device)).eval()
    if not (pretrained_llm_path or pretrained_agent_path):
        gen = _generator(device)
        init_normal_(model, gen)
        if llm.quantization != "none":
            random_quantized_llama_(model.llm, gen)
        return model

    quantize = None
    if llm.quantization != "none":
        quantize = functools.partial(quantize_llama_params,
                                     mode=llm.quantization)

    def load_llm(llm_sd, label):
        _merge_loaded(model, convert_llama_hf(
            llm_sd, num_layers=llm.num_layers, vocab_size=llm.vocab_size,
            pad_to=llm.padded_vocab_size),
            label, prefix="llm.", quantize=quantize)

    if pretrained_llm_path:
        sd = load_checkpoint_auto(pretrained_llm_path)
        _validate_sd(sd, "llm", strict=validate, num_layers=llm.num_layers)
        load_llm(sd, "llm")
    if pretrained_agent_path:
        sd = load_checkpoint_auto(pretrained_agent_path)
        _validate_sd(sd, "agent", strict=validate,
                     num_layers=llm.num_layers)
        parts = convert_agent_checkpoint(sd)
        llm_sd = parts.pop("llm_state_dict", None)
        _merge_loaded(model, parts, "agent")
        if llm_sd:
            load_llm(llm_sd, "agent-llm")
    return model


def build_sdxl_adapter(
    resampler: Any = None,
    detokenizer_path: Optional[str] = None,   # pretrained/seed_detokenizer/*
    sdxl_unet_path: Optional[str] = None,     # SDXL base unet dir / file
    sdxl_vae_path: Optional[str] = None,
    with_latent_image: bool = False,          # SEED-X-Edit variant
    vit_down: bool = True,
    visual_encoder: Any = None,
    validate: bool = False,
    device="cuda",
    **unused,                                 # full_ft etc. are train-time
):
    """-> SDXLAdapter over the modules whose checkpoints are given (the
    reference's ``SDXLAdapter[WithLatentImage].from_pretrained``,
    adapter_modules.py:11,172 + configs/sdxl_adapter/*.yaml): the UNet
    (bf16; the 8-channel edit UNet widens a base checkpoint's conv_in),
    the VAE encoder and decoder (fp32), the detokenizer's ResamplerXL
    (bf16) and the UNet weights a detokenizer checkpoint carries, a full
    fine-tuned UNet or the cross-attention to_k / to_v deltas, over the
    UNet.  A module without a checkpoint is None; ``full_ft`` /
    ``set_trainable_late`` (train-time switches) and the JAX-only
    ``visual_encoder_params`` land in ``unused``."""
    from seedx_tpu_torch.models.adapter import AdapterConfig, SDXLAdapter
    from seedx_tpu_torch.models.detokenizer import (DetokenizerConfig,
                                                    ResamplerXL)
    from seedx_tpu_torch.models.sdxl.unet import (UNet2DCondition,
                                                  sdxl_base_unet,
                                                  sdxl_edit_unet)
    from seedx_tpu_torch.models.sdxl.vae import (VAEConfig, VAEDecoder,
                                                 VAEEncoder)
    from seedx_tpu_torch.utils.sdxl_weights import (convert_sdxl_unet,
                                                    convert_sdxl_unet_deltas,
                                                    convert_sdxl_vae)
    from seedx_tpu_torch.utils.weights import convert_detokenizer_resampler

    if resampler is None:
        rcfg = DetokenizerConfig()
    elif isinstance(resampler, DetokenizerConfig):
        rcfg = resampler
    else:                                     # plain dict from YAML
        rcfg = DetokenizerConfig(**{k: v for k, v in dict(resampler).items()
                                    if k != "_target_"})
    ucfg = sdxl_edit_unet() if with_latent_image else sdxl_base_unet()
    device = torch.device(device)
    unet = res = dec = enc = None
    if sdxl_unet_path:
        sd = load_checkpoint_auto(sdxl_unet_path)
        _validate_sd(sd, "sdxl_unet", strict=validate)
        unet = UNet2DCondition(ucfg, device).eval()
        _merge_loaded(unet, convert_sdxl_unet(
            sd, widen_conv_in_to=8 if with_latent_image else None),
            "sdxl_unet")
    if sdxl_vae_path:
        sd = load_checkpoint_auto(sdxl_vae_path)
        _validate_sd(sd, "sdxl_vae", strict=validate)
        vae = convert_sdxl_vae(sd)
        vcfg = VAEConfig()
        enc = VAEEncoder(vcfg, device).eval()
        dec = VAEDecoder(vcfg, device).eval()
        _merge_loaded(enc, vae["encoder"], "sdxl_vae-encoder")
        _merge_loaded(dec, vae["decoder"], "sdxl_vae-decoder")
    if detokenizer_path:
        sd = load_checkpoint_auto(detokenizer_path)
        _validate_sd(sd, "detokenizer", strict=validate,
                     extra_optional=("unet.*",))
        res = ResamplerXL(rcfg, device).eval()
        _merge_loaded(res, convert_detokenizer_resampler(
            sd, depth=rcfg.depth), "detokenizer")
        # the UNet weights of a stage checkpoint: the full fine-tuned UNet
        # (Edit, full_ft; conv_in already 8-channel) or the trainable
        # cross-attention to_k / to_v (reference adapter_modules.py:21-33,
        # loaded strict=False :62-65)
        unet_sd = {k[len("unet."):]: v for k, v in sd.items()
                   if k.startswith("unet.")}
        if unet_sd and unet is not None:
            if any(k.startswith("conv_in") for k in unet_sd):
                deltas = convert_sdxl_unet(unet_sd)
            else:
                parted = convert_sdxl_unet_deltas(unet_sd)
                deltas = parted["deltas"]
                if parted["skipped"]:
                    logger.warning(
                        "detokenizer UNet deltas: %d keys not attention "
                        "linears, dropped: %s ...", len(parted["skipped"]),
                        parted["skipped"][:5])
            rep = _merge_loaded(unet, deltas, "detokenizer-unet")
            if rep.unexpected or rep.mismatched:
                logger.warning("detokenizer UNet deltas: %d keys not in the "
                               "UNet, dropped: %s ...",
                               len(rep.unexpected) + len(rep.mismatched),
                               (rep.unexpected + rep.mismatched)[:5])

    acfg = AdapterConfig(unet=ucfg, resampler=rcfg,
                         vit_down=vit_down,
                         with_latent_image=with_latent_image)
    return SDXLAdapter(acfg, unet, res, dec, enc,
                       visual_encoder=visual_encoder)
