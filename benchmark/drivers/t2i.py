"""Closed-loop text to image through ``SDXLAdapter.generate``: one request
at a time, each the visual embeddings the agent would emit for an image
(made from the seed at set-up) and a noise seed, until the window's
length has passed; the last request runs to its end.

The adapter's CFG eval (a captured CUDA graph on the card) is wrapped by
a recorder that keeps each step's latents and noise prediction and the
conditioning of each image, two small device copies a step in every run,
so that ``check`` can judge what the timed path produced.  With ``trace``
each eval is also a span closed by a synchronize, each image a span, the
port's own ``timings`` are read, and a steady sub-window is profiled.
"""

from __future__ import annotations

import gc
import time
from typing import Dict, List

import torch

from benchmark.harness import traffic
from benchmark.harness.trace import Profile, Spans, sync

PROFILED_S = 8.0     # seconds of a traced run's profiled sub-window


class Recorder:
    """Stands in for the adapter's CFG eval: runs it and keeps copies of
    its inputs and outputs for the image in progress."""

    def __init__(self, ev, steps: int):
        self.ev, self.steps = ev, steps
        self.spans: Spans = Spans(False)
        self.images: List[Dict] = []

    def start(self) -> None:
        lat = self.ev.lat
        self.images.append({
            "lat": torch.empty((self.steps,) + tuple(lat.shape[1:]),
                               dtype=lat.dtype, device=lat.device),
            "eps": None, "i": 0})

    def set_conditioning(self, context, pooled, time_ids, cond) -> None:
        self.ev.set_conditioning(context, pooled, time_ids, cond)
        rec = self.images[-1]
        rec["context"], rec["pooled"] = context.clone(), pooled.clone()

    def __call__(self, lat, sigma, t):
        rec = self.images[-1]
        with self.spans.span("unet_eval"):
            eps = self.ev(lat, sigma, t)
        if rec["eps"] is None:
            rec["eps"] = torch.empty((self.steps,) + tuple(eps.shape[1:]),
                                     dtype=eps.dtype, device=eps.device)
        rec["lat"][rec["i"]].copy_(lat[0])
        rec["eps"][rec["i"]].copy_(eps[0])
        rec["i"] += 1
        return eps


class Driver:
    def __init__(self, files: Dict, seed: int, device, rate=None,
                 seconds: float = 10.0):
        self.cfg, self.cell, self.mix = (files["config"], files["cell"],
                                         files["mix"])
        self.seed, self.device = seed, device
        self.seconds = float(seconds)

    def setup(self) -> None:
        from benchmark.harness.programs import build_adapter

        self.ad = build_adapter(self.cfg, self.seed, self.device)
        n = self.mix["embeddings"]
        shape = (1, self.cfg["resampler"]["num_queries"],
                 self.cfg["resampler"]["embedding_dim"])
        self.embeds = []
        for i in range(n):
            gen = torch.Generator(device=self.device)
            gen.manual_seed(int(traffic.rng_for(self.seed, f"embeds{i}")
                                .integers(2**62)))
            self.embeds.append(torch.randn(shape, generator=gen,
                                           device=self.device).to(
                                               torch.bfloat16))
        self.noise_seeds = traffic.rng_for(self.seed, "noise").integers(
            2**62, size=64).tolist()
        steps = self.cfg["sampler"]["num_inference_steps"]
        self.ad.generate(self.embeds[0], seed=self.noise_seeds[0])
        (key, ev), = self.ad.evals.items()
        self.rec = Recorder(ev, steps)
        self.ad.evals[key] = self.rec
        sync()

    def window(self, seconds: float, trace: bool) -> Dict:
        spans = Spans(trace)
        self.rec.spans = spans
        prof, prof_end = None, None
        timings: List[Dict] = []
        n = 0
        t0 = time.perf_counter()
        t_done = t0
        try:
            while time.perf_counter() - t0 < seconds:
                now = time.perf_counter()
                if trace and prof is None and now - t0 >= seconds / 3.0:
                    prof = Profile()
                    prof.start()
                    prof_end = now + min(PROFILED_S, seconds / 3.0)
                tm = {} if trace else None
                self.rec.start()
                self.rec.images[-1]["index"] = n
                with spans.span("image"):
                    img = self.ad.generate(
                        self.embeds[n % len(self.embeds)],
                        seed=self.noise_seeds[n % len(self.noise_seeds)],
                        timings=tm)
                t_done = time.perf_counter()
                self.rec.images[-1]["image"] = img[0]
                if tm is not None:
                    timings.append(tm)
                n += 1
                if prof is not None and prof_end is not None \
                        and time.perf_counter() >= prof_end:
                    prof.stop()
                    prof_end = None
        finally:
            if prof is not None and prof_end is not None:
                prof.stop()
        steps = self.cfg["sampler"]["num_inference_steps"]
        return {"attempted": n, "failed": 0,
                "end_to_end": {"image_s": (t_done - t0) / n},
                "spans": spans, "profile": prof,
                "notes": {"images": f"{n} in {t_done - t0:.3f} s"},
                "work": {"timings": timings, "steps": steps}}

    def release(self) -> None:
        self.ad = None
        self.rec.ev = None
        gc.collect()
        if torch.cuda.is_available():
            torch.cuda.empty_cache()

    def _judge(self, control_bits=None) -> Dict[str, float]:
        from benchmark.reference.sdxl import judge

        done = [r for r in self.rec.images if "image" in r
                and r["i"] == self.rec.steps]
        rng = traffic.rng_for(self.seed, "check")
        r = done[int(rng.integers(len(done)))]
        steps = self.rec.steps
        picked = sorted({0, steps - 1} | set(
            int(x) for x in rng.choice(steps, self.cell["check"]["steps"] - 2,
                                       replace=False)))
        i = r["index"]
        rec = {"embeds": self.embeds[i % len(self.embeds)],
               "noise_seed": self.noise_seeds[i % len(self.noise_seeds)],
               "context": r["context"], "pooled": r["pooled"],
               "lat": r["lat"], "eps": r["eps"], "image": r["image"]}
        out = judge(self.seed, self.cfg, rec, picked, control_bits)
        self.checked = {"image checked": f"#{i}, steps {picked}",
                        "readings": {k: round(v, 8) for k, v in out.items()}}
        return out

    def check(self) -> List[Dict]:
        """Each stage of the sampled image against the reference: the
        conditioning, the noise predictions, the Euler steps, the image."""
        out = self._judge()
        lim = self.cell["check"]
        return [{"name": k, "value": out[k], "limit": lim[k]}
                for k in ("cond", "eps", "step", "image")]

    def control(self) -> List[Dict]:
        """The control's readings on the same image, each number's stage
        one precision below the configuration's: the ViT, ResamplerXL and
        the UNet computed in fp8 (e4m3: every layer's weights, inputs and
        outputs; they are served bf16), the Euler step and the VAE decoder
        in bf16 (they are fp32), each read against the fp32 reference."""
        out = self._judge(control_bits="fp8")
        return [{"name": k, "value": out[k + "_control"]}
                for k in ("cond", "eps", "step", "image")]
