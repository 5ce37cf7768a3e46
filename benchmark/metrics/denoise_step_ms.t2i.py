"""Denoise ms per step: the port's own ``SDXLAdapter.generate(timings=)``
"denoise" phase (closed by a synchronize), divided by the steps.  Layer:
models/sdxl/pipeline.py + unet.py.  Moves image_s."""


def read(r):
    t = r.work.get("timings") or []
    if not t:
        return None
    return sum(x["denoise"] for x in t) * 1e3 / (len(t) * r.work["steps"])
