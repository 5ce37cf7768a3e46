"""Operations and bytes of DeepSeek-V2's work, from the configuration's
shapes and the tokens processed (``counts``'s rules: each input byte read
once, each output byte written once, peaks from ``peaks.json``).

K6 (the routed experts' grouped GEMM, ``csrc/moe_gemm.cu``): per routed
row, gate and up (2 * 2 * d * f operations) and down (2 * f * d); per
(layer, step) expert with rows, its three [d, f] bf16 weights read once;
per row, x in and the SwiGLU product out (bf16), the product in again and
the fp32 output out.

The whole model's least time counts its operations over the parameters a
token activates (latent attention, the dense layer, the routed experts it
is sent to, the shared experts, the router) at the bf16 peak, the
attention over its positions, and one row of the LM head a prompt
(prefill) or a token (decode).
"""

from __future__ import annotations

from typing import Dict, Iterable

from benchmark.roofline.counts import bound_s, peaks


def dims(cfg: Dict) -> Dict[str, int]:
    return {"d": cfg["hidden_size"], "L": cfg["num_hidden_layers"],
            "kd": cfg["first_k_dense_replace"],
            "Lm": cfg["num_hidden_layers"] - cfg["first_k_dense_replace"],
            "H": cfg["num_attention_heads"], "r": cfg["kv_lora_rank"],
            "dn": cfg["qk_nope_head_dim"], "dr": cfg["qk_rope_head_dim"],
            "dv": cfg["v_head_dim"], "E": cfg["n_routed_experts"],
            "k": cfg["num_experts_per_tok"],
            "f": cfg["intermediate_size"],
            "fe": cfg["moe_intermediate_size"],
            "fs": cfg["moe_intermediate_size"] * cfg["n_shared_experts"],
            "V": cfg["vocab_size"]}


def expert_bytes(cfg: Dict) -> int:
    """One expert's gate, up and down weights in bf16."""
    m = dims(cfg)
    return 3 * m["d"] * m["fe"] * 2


def k6_row(cfg: Dict):
    """(operations, activation bytes) of one routed row through K6."""
    m = dims(cfg)
    return (2.0 * 3 * m["d"] * m["fe"],
            2 * m["d"] + 2 * m["fe"] + 2 * m["fe"] + 4 * m["d"])


def k6_decode_bound_s(cfg: Dict, activations: int, rows: int) -> float:
    """Least time of K6 over decode steps: ``activations`` (layer, step)
    experts with rows, each one's weights read once, and ``rows`` routed
    rows over all those layers and steps."""
    ops, per_row = k6_row(cfg)
    return bound_s(ops * rows, activations * expert_bytes(cfg)
                   + rows * per_row, "bf16_flops_per_s")


def k6_prefill_bound_s(cfg: Dict, p_lens: Iterable[int]) -> float:
    """Least time of K6 over one prefill of prompts ``p_lens`` (real
    tokens only): per MoE layer their k rows each, and the weights of at
    most every expert (of one a row, where fewer rows than experts)."""
    m = dims(cfg)
    rows = m["k"] * sum(p_lens)
    ops, per_row = k6_row(cfg)
    nbytes = min(m["E"], rows) * expert_bytes(cfg) + rows * per_row
    return m["Lm"] * bound_s(ops * rows, nbytes, "bf16_flops_per_s")


def active_params(cfg: Dict) -> int:
    """Parameters of the layers one token runs through (no embedding, no
    LM head)."""
    m = dims(cfg)
    d, H = m["d"], m["H"]
    attn = (d * H * (m["dn"] + m["dr"]) + d * (m["r"] + m["dr"])
            + m["r"] * H * (m["dn"] + m["dv"]) + H * m["dv"] * d)
    dense = 3 * d * m["f"]
    moe = (m["k"] * 3 * d * m["fe"] + 3 * d * m["fs"] + d * m["E"])
    return m["L"] * attn + m["kd"] * dense + m["Lm"] * moe


def decode_least_s(cfg: Dict, tokens: int, kv_positions: int) -> float:
    """Least time of decode steps that produced ``tokens`` tokens over
    ``kv_positions`` attended positions, at the bf16 peak: the active
    parameters and one LM-head row a token, the absorbed attention (q
    into the latent space and back, scores and the latent output over
    each position)."""
    m = dims(cfg)
    H, r = m["H"], m["r"]
    ops = 2.0 * tokens * (active_params(cfg) + m["d"] * m["V"])
    ops += m["L"] * tokens * 2.0 * H * r * (m["dn"] + m["dv"])
    ops += m["L"] * kv_positions * 2.0 * H * ((r + m["dr"]) + r)
    return ops / peaks()["bf16_flops_per_s"]


def prefill_least_s(cfg: Dict, p_lens: Iterable[int]) -> float:
    """Least time of a prefill of prompts ``p_lens`` (real tokens only)
    at the bf16 peak: the active parameters for every token, causal
    attention with q / k (nope + rope) and v wide, one LM-head row a
    prompt."""
    m = dims(cfg)
    p_lens = list(p_lens)
    ops = 2.0 * sum(p_lens) * active_params(cfg)
    ops += sum(m["L"] * 2.0 * m["H"] * (m["dn"] + m["dr"] + m["dv"])
               * p * (p + 1) / 2 for p in p_lens)
    ops += 2.0 * len(p_lens) * m["d"] * m["V"]
    return ops / peaks()["bf16_flops_per_s"]


def kernel_seconds_in(prof, patterns, ranges) -> float:
    """Device seconds of the kernels matching ``patterns`` that start
    inside one of ``ranges`` ((t0, t1) ns on the profiler's clock, not
    nesting)."""
    import bisect
    import re

    prof.busy_intervals()              # loads the profile's events
    rx = re.compile("|".join(patterns))
    ranges = sorted(ranges)
    starts = [a for a, _ in ranges]
    total = 0
    for t0, t1, name in prof.kernels:
        if not rx.search(name):
            continue
        i = bisect.bisect_right(starts, t0) - 1
        if i >= 0 and t0 < ranges[i][1]:
            total += t1 - t0
    return total * 1e-9
