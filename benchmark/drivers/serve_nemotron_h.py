"""``serve``'s open-loop serving through ``ContinuousEngine`` (bucket
prefill on admission, captured decode chunks), with Nemotron-H as the
SEED-X-I agent's LLM: the same loop, front threads, spans and profile as
``drivers/serve.py``, a runtime built from the Nemotron-H configuration
(every weight bf16 as published, a bf16 KV cache for the attention
blocks, the Mamba blocks' SSM state in fp32 and conv state in bf16, the
router in fp32) and the check against ``reference/nemotron_h.served_gaps``.

The check reads two statistics of the sampled requests' free positions,
and not the widest single gap: with random weights the sigmoid router's
top-6 of 128 sits on near-ties, and a choice that bf16 rounding flips
moves the logits by ~1.5 (each chosen expert carries ~2.5 / 6 of the
block's output), so somewhere in a few hundred positions the program's
served token lies ~4-5 below the fp32 reference's best -- as far as the
fp8 control's does.  Per position the two part clearly:

* ``token_gap_mean``: each request's mean gap, the widest of them (the
  program ~0.6-1.0, the control ~2.1-2.5);
* ``argmax_miss_share``: the share of all the sampled free positions
  where the served token is not the fp32 reference's first choice (the
  program ~0.75-0.8, the control ~0.99); pooled, since a request of a
  few dozen positions reads it too coarsely alone.
"""

from __future__ import annotations

import contextlib
from typing import Dict, List

import torch

from benchmark.drivers import serve
from benchmark.harness import programs
from benchmark.harness.weights import fill_


def llm_config(cfg: Dict):
    """The port's LlamaConfig of a Nemotron-H configuration file."""
    from seedx_tpu_torch.models.llama import LlamaConfig

    pattern = cfg["hybrid_override_pattern"]
    return LlamaConfig(
        vocab_size=cfg["vocab_size"], hidden_size=cfg["hidden_size"],
        intermediate_size=cfg["intermediate_size"], num_layers=len(pattern),
        num_heads=cfg["num_attention_heads"],
        num_kv_heads=cfg["num_key_value_heads"],
        attn_head_dim=cfg["head_dim"], rope=False,
        rope_theta=float(cfg["rope_theta"]), rms_eps=cfg["norm_eps"],
        max_position_embeddings=cfg["max_position_embeddings"],
        block_pattern=pattern, mamba_heads=cfg["mamba_num_heads"],
        mamba_head_dim=cfg["mamba_head_dim"],
        ssm_state_size=cfg["ssm_state_size"], mamba_groups=cfg["n_groups"],
        conv_kernel=cfg["conv_kernel"], ssm_chunk=cfg["chunk_size"],
        n_routed_experts=cfg["n_routed_experts"],
        num_experts_per_tok=cfg["num_experts_per_tok"],
        moe_intermediate_size=cfg["moe_intermediate_size"],
        n_shared_experts=cfg["n_shared_experts"],
        shared_intermediate_size=cfg["moe_shared_expert_intermediate_size"],
        routed_scaling_factor=float(cfg["routed_scaling_factor"]),
        expert_act="relu2", router_scoring="sigmoid")


@torch.no_grad()
def build_runtime(cfg: Dict, seed: int, device):
    """The SEED-X-I serving runtime: ViT-bigG (bf16) and the agent with
    Nemotron-H as its LLM, every leaf drawn by name in the dtype it is
    served in."""
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
        holds the engine too (the model, its cache and state: ~70 GB)."""
        self.probe = None
        super().release()

    def control(self) -> List[Dict]:
        """The control's reading on the same sample: the reference one
        precision below the configuration's everywhere (weights,
        activations and KV rows in fp8 e4m3 for the bf16 it states; the
        SSM state and the router in bf16 for its fp32), its own first
        choice at every position read in the fp32 reference's logits."""
        from benchmark.reference.nemotron_h import served_gaps

        gaps = served_gaps(self.seed, self.cfg, self._checked_requests(),
                           self.device, bits="fp8", pick="argmax",
                           reduce=None)
        return [{"name": n, "value": v} for n, v in _readings(gaps).items()]

    def check(self) -> List[Dict]:
        """``serve.Driver.check`` against the Nemotron-H reference, by
        the widest of the sampled requests' mean gaps and their pooled
        argmax-miss share (see the module docstring; each request's
        share and widest single gap are kept as a note)."""
        from benchmark.reference.nemotron_h import served_gaps

        limits = self.cell["check"]
        unfinished = {"name": "unfinished", "limit": 0,
                      "value": sum("t_done" not in r for r in self.queue)}
        pick = self.sample()
        if not pick:
            return [unfinished] + [
                {"name": n, "value": float("inf"), "limit": limits[n]}
                for n in READINGS]
        gaps = served_gaps(self.seed, self.cfg, self._checked_requests(),
                           self.device, reduce=None)
        self.checked = {"requests": len(pick),
                        "tokens": sum(len(r["tokens"]) for r in pick),
                        "mean gaps": [float(g.mean()) for g in gaps],
                        "argmax miss shares": [
                            float((g > 0).float().mean()) for g in gaps],
                        "widest gaps": [float(g.max()) for g in gaps]}
        return [unfinished] + [
            {"name": n, "value": v, "limit": limits[n]}
            for n, v in _readings(gaps).items()]


READINGS = ("token_gap_mean", "argmax_miss_share")


def _readings(gaps: List[torch.Tensor]) -> Dict[str, float]:
    """The checked statistics of per-request gaps over the free
    positions: the widest of the requests' mean gaps, and the share of
    all their positions whose token is not the reference's first choice
    (gap > 0)."""
    return {"token_gap_mean": max(float(g.mean()) for g in gaps),
            "argmax_miss_share": float((torch.cat(gaps) > 0).float().mean())}
