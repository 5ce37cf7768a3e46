"""K1's share of its roofline in the UNet's self-attention: the least
time of the self-attention of the profiled UNet evals (every transformer
block's QK and PV over its level's tokens, both CFG branches), divided by
K1's device time inside those evals.  Layer: ops/flash_attention.py (K1).
Moves image_s."""

from benchmark.roofline import counts


def read(r):
    prof = r.profile
    if prof is None:
        return None
    ids = set(prof.span_ids(["unet_eval"]))
    ops, nbytes = counts.unet_self_attn(r.config, 2)
    bound = len(ids) * counts.bound_s(ops, nbytes, "bf16_flops_per_s")
    t = prof.kernel_seconds(counts.kernel_patterns("k1"), ids=ids)
    return 100.0 * bound / t if bound > 0 and t > 0 else None
