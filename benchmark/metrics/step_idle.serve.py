"""Share of the engine's own ``engine.step`` spans (admission, a decode
chunk, harvest) in the profiled sub-window in which no kernel, copy or
set ran on the card: the device waiting on the host inside the engine's
step.  The benchmark's own spans still close with a synchronize, so this
is an upper bound.  Layer: inference/continuous.py engine loop.  Moves
tpot_p95_ms."""

from benchmark.harness.program_spans import idle_share


def read(r):
    return idle_share(r, "engine.step")
