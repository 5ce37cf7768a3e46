"""VAE decode ms per image: the port's ``timings["vae_decode"]`` (the
fp32 decoder at 1024^2 and the copy to the host).  Layer:
models/sdxl/vae.py.  Moves image_s."""


def read(r):
    t = r.work.get("timings") or []
    return sum(x["vae_decode"] for x in t) * 1e3 / len(t) if t else None
