"""The decode step's share of the card's bf16 peak: the least time the
model operations of every decode chunk need (the parameters each token
activates, the recurrence, one LM-head row a token, the attention blocks
over each row's positions), divided by the time of the decode chunk
spans.  Layer: the whole step.  Moves tpot_p95_ms."""

from benchmark.roofline import nemotron_h as nh


def read(r):
    chunks = r.spans.of("decode_chunk")
    t = r.spans.seconds("decode_chunk")
    least = sum(nh.decode_least_s(r.config, c["tokens"], c["kv_positions"])
                for c in chunks)
    return 100.0 * least / t if least > 0 and t > 0 else None
