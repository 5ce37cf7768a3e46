"""Operations and bytes of Nemotron-H's work, from the configuration's
shapes and the tokens processed (``counts``'s rules: each input byte read
once, each output byte written once, peaks from ``peaks.json``).

K6 over Nemotron-H's two-matrix relu2 experts (``csrc/moe_gemm.cu``): per
routed row, up (2 * d * f operations) and down (2 * f * d); per (block,
step) expert with rows, its two [d, f] bf16 weights read once; per row, x
in and the relu2 product out (bf16), the product in again and the fp32
output out.

K7 (the Mamba-2 state step, ``csrc/ssm_step.cu``): per slot and Mamba
block of a decode step, the fp32 state [H, P, N] read once and written
once, the slot's activated conv row (x, B, C) and dt in (bf16), y out
(fp32); ~5 operations a state element (the decay, the outer-product add,
S . C) in fp32, far below the bytes' time.

The whole model's least time counts its operations over the parameters a
token activates (the Mamba blocks' projections, the attention's, the
routed experts it is sent to, the shared expert, the router) at the bf16
peak, the attention over its positions, the recurrence's operations, and
one row of the LM head a prompt (prefill) or a token (decode).
"""

from __future__ import annotations

from typing import Dict, Iterable

from benchmark.roofline.counts import bound_s, peaks


def dims(cfg: Dict) -> Dict[str, int]:
    pattern = cfg["hybrid_override_pattern"]
    h, p, g, n = (cfg["mamba_num_heads"], cfg["mamba_head_dim"],
                  cfg["n_groups"], cfg["ssm_state_size"])
    return {"d": cfg["hidden_size"], "L": len(pattern),
            "Lm": pattern.count("M"), "Le": pattern.count("E"),
            "La": pattern.count("*"), "H": h, "P": p, "G": g, "N": n,
            "din": h * p, "C": h * p + 2 * g * n,
            "hq": cfg["num_attention_heads"],
            "hkv": cfg["num_key_value_heads"], "hd": cfg["head_dim"],
            "E": cfg["n_routed_experts"], "k": cfg["num_experts_per_tok"],
            "fe": cfg["moe_intermediate_size"],
            "fs": cfg["moe_shared_expert_intermediate_size"],
            "V": cfg["vocab_size"]}


def expert_bytes(cfg: Dict) -> int:
    """One expert's up and down weights in bf16."""
    m = dims(cfg)
    return 2 * m["d"] * m["fe"] * 2


def k6_row(cfg: Dict):
    """(operations, activation bytes) of one routed row through K6."""
    m = dims(cfg)
    return (2.0 * 2 * m["d"] * m["fe"],
            2 * m["d"] + 2 * m["fe"] + 2 * m["fe"] + 4 * m["d"])


def k6_decode_bound_s(cfg: Dict, activations: int, rows: int) -> float:
    """Least time of K6 over decode steps: ``activations`` (block, step)
    experts with rows, each one's weights read once, and ``rows`` routed
    rows over all those blocks and steps."""
    ops, per_row = k6_row(cfg)
    return bound_s(ops * rows, activations * expert_bytes(cfg)
                   + rows * per_row, "bf16_flops_per_s")


def k7_slot_bytes(cfg: Dict) -> int:
    """Bytes of one slot's state step in one Mamba block."""
    m = dims(cfg)
    state = m["H"] * m["P"] * m["N"] * 4
    return 2 * state + 2 * m["C"] + 2 * m["H"] + 4 * m["din"]


def k7_bound_s(cfg: Dict, slot_steps: int) -> float:
    """Least time of K7 over ``slot_steps`` (slot, step) pairs, every
    Mamba block of each."""
    m = dims(cfg)
    ops = 5.0 * m["H"] * m["P"] * m["N"]
    return m["Lm"] * bound_s(ops * slot_steps, k7_slot_bytes(cfg)
                             * slot_steps, "fp32_flops_per_s")


def active_params(cfg: Dict) -> int:
    """Parameters of the blocks one token runs through (no embedding, no
    LM head)."""
    m = dims(cfg)
    d = m["d"]
    mamba = (d * (m["din"] + m["C"] + m["H"]) + m["din"] * d
             + 4 * m["C"] + 4 * m["H"] + m["din"])
    attn = (d * (m["hq"] + 2 * m["hkv"]) * m["hd"]
            + m["hq"] * m["hd"] * d)
    moe = m["k"] * 2 * d * m["fe"] + 2 * d * m["fs"] + d * m["E"]
    return m["Lm"] * mamba + m["La"] * attn + m["Le"] * moe + m["L"] * d


def recurrence_ops(cfg: Dict) -> float:
    """Operations of one token's state update and read-out, every Mamba
    block."""
    m = dims(cfg)
    return m["Lm"] * 5.0 * m["H"] * m["P"] * m["N"]


def decode_least_s(cfg: Dict, tokens: int, kv_positions: int) -> float:
    """Least time of decode steps that produced ``tokens`` tokens over
    ``kv_positions`` attended positions (each attention block), at the
    bf16 peak: the active parameters, the recurrence and one LM-head row
    a token, scores and the weighted values over each position."""
    m = dims(cfg)
    ops = tokens * (2.0 * (active_params(cfg) + m["d"] * m["V"])
                    + recurrence_ops(cfg))
    ops += m["La"] * kv_positions * 2.0 * 2 * m["hq"] * m["hd"]
    return ops / peaks()["bf16_flops_per_s"]


def prefill_least_s(cfg: Dict, p_lens: Iterable[int]) -> float:
    """Least time of a prefill of prompts ``p_lens`` (real tokens only)
    at the bf16 peak: the active parameters and the recurrence for every
    token, causal attention in the attention blocks, one LM-head row a
    prompt."""
    m = dims(cfg)
    p_lens = list(p_lens)
    ops = sum(p_lens) * (2.0 * active_params(cfg) + recurrence_ops(cfg))
    ops += sum(m["La"] * 2.0 * 2 * m["hq"] * m["hd"] * p * (p + 1) / 2
               for p in p_lens)
    ops += 2.0 * len(p_lens) * m["d"] * m["V"]
    return ops / peaks()["bf16_flops_per_s"]
