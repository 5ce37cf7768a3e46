"""ViT ms per tile: the serving driver's ``vit_encode`` spans around the
runtime's ViT call inside ``SeedXRuntime.encode_image_anyres`` (ViT-bigG
and its attention pool on the tiles and thumbnail, on the device's turn
between engine steps; closed by a synchronize), divided by the tiles
encoded.  The anyres transform before it runs on the front thread and is
not in it.  Layer: models/vit.py + models/resampler.py.  Moves
ttft_p95_ms."""


def read(r):
    tiles = sum(s["tiles"] for s in r.spans.of("vit_encode"))
    return r.spans.seconds("vit_encode") * 1e3 / tiles if tiles else None
