"""The image's share of the card's peak: the least time one image's
operations need (the UNet's CFG evals, ResamplerXL and the negative's
ViT pass at the bf16 peak, the VAE decoder at the fp32 peak), times the
images, divided by the time of the image spans.  Layer: the whole
image.  Moves image_s."""

from benchmark.roofline import counts


def read(r):
    images = r.spans.of("image")
    t = r.spans.seconds("image")
    if not images or t <= 0:
        return None
    return 100.0 * len(images) * counts.image_least_s(r.config) / t
