"""Share of the program's own ``sdxl.denoise`` spans (the noise and
every CFG UNet eval of an image) in the profiled sub-window in which no
kernel, copy or set ran on the card.  The benchmark's eval spans still
close with a synchronize, so this is an upper bound.  Layer:
models/sdxl/pipeline.py + unet.py.  Moves image_s."""

from benchmark.harness.program_spans import idle_share


def read(r):
    return idle_share(r, "sdxl.denoise")
