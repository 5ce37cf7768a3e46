"""``serve``'s open-loop serving through ``ContinuousEngine`` (bucket
prefill on admission, captured decode chunks), with DeepSeek-V2 as the
SEED-X-I agent's LLM: the same loop, front threads, spans and profile as
``drivers/serve.py``, a runtime built from the DeepSeek-V2 configuration
(every weight bf16 as published, a bf16 latent KV cache, the router in
fp32) and the check against ``reference/deepseek_v2.served_gaps``.
"""

from __future__ import annotations

import contextlib
from typing import Dict, List

import torch

from benchmark.drivers import serve
from benchmark.harness import programs
from benchmark.harness.weights import fill_


def llm_config(cfg: Dict):
    """The port's LlamaConfig of a DeepSeek-V2 configuration file."""
    from seedx_tpu_torch.models.llama import LlamaConfig

    rs = cfg["rope_scaling"]
    return LlamaConfig(
        vocab_size=cfg["vocab_size"], hidden_size=cfg["hidden_size"],
        intermediate_size=cfg["intermediate_size"],
        num_layers=cfg["num_hidden_layers"],
        num_heads=cfg["num_attention_heads"],
        num_kv_heads=cfg["num_key_value_heads"],
        rope_theta=float(cfg["rope_theta"]), rms_eps=cfg["rms_norm_eps"],
        max_position_embeddings=cfg["max_position_embeddings"],
        kv_lora_rank=cfg["kv_lora_rank"],
        qk_nope_head_dim=cfg["qk_nope_head_dim"],
        qk_rope_head_dim=cfg["qk_rope_head_dim"],
        v_head_dim=cfg["v_head_dim"],
        n_routed_experts=cfg["n_routed_experts"],
        num_experts_per_tok=cfg["num_experts_per_tok"],
        moe_intermediate_size=cfg["moe_intermediate_size"],
        n_shared_experts=cfg["n_shared_experts"],
        first_k_dense_replace=cfg["first_k_dense_replace"],
        routed_scaling_factor=float(cfg["routed_scaling_factor"]),
        yarn_factor=float(rs["factor"]),
        yarn_original_max_position=rs["original_max_position_embeddings"],
        yarn_beta_fast=rs["beta_fast"], yarn_beta_slow=rs["beta_slow"],
        yarn_mscale=rs["mscale"], yarn_mscale_all_dim=rs["mscale_all_dim"])


@torch.no_grad()
def build_runtime(cfg: Dict, seed: int, device):
    """The SEED-X-I serving runtime: ViT-bigG (bf16) and the agent with
    DeepSeek-V2 as its LLM, every leaf drawn by name in bf16."""
    from seedx_tpu_torch.inference.runtime import SeedXRuntime
    from seedx_tpu_torch.models.agent import AgentConfig, ContinuousLVLM

    a = cfg["agent"]
    acfg = AgentConfig(llm=llm_config(cfg),
                       num_img_in_tokens=a["num_img_in_tokens"],
                       num_img_out_tokens=a["num_img_out_tokens"],
                       vit_dim=a["vit_dim"],
                       resampler_heads=a["resampler_heads"])
    vit = programs.build_vit(cfg, seed, device)
    agent = ContinuousLVLM(acfg, device).eval()
    fill_(agent, seed, "agent.")
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return SeedXRuntime(tokenizer=programs.wide_tokenizer(),
                        vit_cfg=programs.vit_config(cfg), vit=vit,
                        agent_cfg=acfg, agent=agent,
                        base_resolution=cfg["vision"]["image_size"],
                        resolution_grids=tuple(cfg["vision"]["grids"]))


@contextlib.contextmanager
def _this_runtime():
    """``serve.Driver.setup`` builds ``programs.build_runtime``'s
    runtime: for the block, this configuration's."""
    saved = programs.build_runtime
    programs.build_runtime = build_runtime
    try:
        yield
    finally:
        programs.build_runtime = saved


class Driver(serve.Driver):
    def setup(self) -> None:
        with _this_runtime():
            super().setup()

    def release(self) -> None:
        """Free the program before the reference runs: the engine probe
        holds the engine too (the model and its cache: ~40 GB here)."""
        self.probe = None
        super().release()

    def control(self) -> List[Dict]:
        """The control's reading on the same sample: the reference with
        its weights, activations and latent cache in fp8 e4m3 (one
        precision below the configuration's bf16), its own first choice at
        every position read in the fp32 reference's logits."""
        from benchmark.reference.deepseek_v2 import served_gaps

        gaps = served_gaps(self.seed, self.cfg, self._checked_requests(),
                           self.device, bits="fp8", pick="argmax")
        return [{"name": "token_gap", "value": max(gaps)}]

    def check(self) -> List[Dict]:
        """``serve.Driver.check`` against the DeepSeek-V2 reference."""
        from benchmark.reference.deepseek_v2 import served_gaps

        unfinished = {"name": "unfinished", "limit": 0,
                      "value": sum("t_done" not in r for r in self.queue)}
        pick = self.sample()
        if not pick:
            return [unfinished, {"name": "token_gap", "value": float("inf"),
                                 "limit": self.cell["check"]["token_gap"]}]
        gaps = served_gaps(self.seed, self.cfg, self._checked_requests(),
                           self.device)
        self.checked = {"requests": len(pick),
                        "tokens": sum(len(r["tokens"]) for r in pick),
                        "gaps": gaps}
        return [unfinished, {"name": "token_gap", "value": max(gaps),
                             "limit": self.cell["check"]["token_gap"]}]
