"""Open-loop serving through ``ContinuousEngine`` (bucket prefill on
admission, captured decode chunks), at the cell's fixed rate.

Requests arrive on the generator's schedule whether or not earlier ones
are done.  A few front threads stand for the clients and the server's
front end: at each request's due time one of them prepares the request,
an image request through ``SeedXRuntime.encode_image_anyres`` (the port's
anyres transform on the host, then the ViT), and hands it to the
driver's loop, which submits it before the next engine step.  The loop
owns the device: the ViT takes its turn between two steps, never inside
one, so host transforms run beside the engine and the device work stays
in one order.
A request's first token is visible at the end of the ``step()`` that
admitted it (its prefill, then a decode chunk), and it is done at the end
of the step that harvested it.  Latencies count from when a request was
due, so a stall delays every request behind it.  After the window closes
no request comes due; those still running are waited for up to a minute.

With ``trace`` the driver also records spans around each admission, each
prefill group, each decode chunk and each ViT call (each closed by a
synchronize) and profiles a steady sub-window.  Once the program is
freed, ``check`` runs the plain reference over a sample of the served
requests (``reference/agent.served_gaps``).
"""

from __future__ import annotations

import bisect
import gc
import math
import queue
import threading
import time
from typing import Dict, List

import numpy as np
import torch

from benchmark.harness import traffic
from benchmark.harness.engine import EngineProbe
from benchmark.harness.trace import Profile, Spans, sync


# seconds of a traced run's profiled sub-window (a million events in a
# decode-heavy window take the profiler tens of seconds to stop)
PROFILED_S = 8.0
# seconds past the window's close that requests still running are awaited
DRAIN_S = 60.0
# threads preparing requests side by side (a server's front end)
FRONT_THREADS = 4


def percentile(values: List[float], q: float) -> float:
    return float(np.percentile(np.asarray(values, np.float64), q)) \
        if values else float("nan")


class Turn:
    """The device's turns: the driver's loop holds it for each engine
    step; a ViT call from a front thread waits for the step to end and
    goes first, and the loop waits until every such request has been
    handed over before it submits and steps again."""

    def __init__(self):
        self.lock = threading.Lock()
        self.fronts: set = set()        # idents of the running front threads
        self._asking = 0
        self._count = threading.Lock()
        self._mine = threading.local()

    def for_device_call(self):
        if threading.get_ident() in self.fronts and \
                not getattr(self._mine, "asking", False):
            self._mine.asking = True
            with self._count:
                self._asking += 1
        return self.lock

    def handed_over(self) -> None:
        if getattr(self._mine, "asking", False):
            self._mine.asking = False
            with self._count:
                self._asking -= 1

    def for_step(self):
        while self._asking:
            time.sleep(2e-4)
        return self.lock


class Front:
    """``FRONT_THREADS`` threads that each take the next request in due
    order, wait for its due time, prepare it and queue it for the loop
    (each thread queues ``None`` at its end; a failure is kept in
    ``error``)."""

    def __init__(self, driver, reqs: List[Dict], t0: float, spans: Spans):
        self.driver, self.t0, self.spans = driver, t0, spans
        self.ready: queue.Queue = queue.Queue()
        self.halt = threading.Event()
        self.error = None
        self._next, self._take = iter(reqs), threading.Lock()
        self.threads = [threading.Thread(target=self._run, daemon=True,
                                         name=f"benchmark-front-{k}")
                        for k in range(FRONT_THREADS)]

    def start(self) -> None:
        for t in self.threads:
            t.start()

    def join(self, timeout: float) -> None:
        for t in self.threads:
            t.join(timeout)

    def _run(self) -> None:
        turn, me = self.driver.turn, threading.get_ident()
        turn.fronts.add(me)
        try:
            while True:
                with self._take:
                    r = next(self._next, None)
                if r is None:
                    return
                delay = self.t0 + r["due"] - time.perf_counter()
                if (delay > 0 and self.halt.wait(delay)) or \
                        self.halt.is_set():
                    return
                self.ready.put((r, self.driver._request(r, self.spans)))
                turn.handed_over()
        except BaseException as e:      # re-raised by the loop
            self.error = e
        finally:
            turn.handed_over()
            turn.fronts.discard(me)
            self.ready.put(None)

    def take(self, timeout: float = 0.0) -> List:
        """What is ready (waiting up to ``timeout`` s for the first)."""
        out = []
        try:
            out.append(self.ready.get(timeout=timeout) if timeout > 0
                       else self.ready.get_nowait())
            while True:
                out.append(self.ready.get_nowait())
        except queue.Empty:
            pass
        if self.error is not None:
            raise RuntimeError("a front thread failed") from self.error
        return out


class Driver:
    def __init__(self, files: Dict, seed: int, device, rate=None,
                 seconds: float = 10.0):
        self.cfg, self.cell, self.mix = (files["config"], files["cell"],
                                         files["mix"])
        self.seed, self.device = seed, device
        self.rate = float(rate if rate is not None else self.cell["rate"])
        self.seconds = float(seconds)

    # ---- set-up -------------------------------------------------------------

    def _prompt(self, r: Dict) -> List[int]:
        """The request's prompt ids: the instruction template around its
        image string and question, or around its document."""
        from seedx_tpu_torch.text import prompts

        tok = self.rt.tokenizer
        pre, post = tok.encode("[INST] "), tok.encode(" [/INST]\n")
        text = self.mix["text"]
        if "grid" in r:
            gw, gh = (int(x) for x in r["grid"].split("x"))
            pre = pre + tok.encode(prompts.multi_patch_image_string(
                gw * gh + 1, self.cfg["agent"]["num_img_in_tokens"]))
            n = r[text["size"]]
        else:
            n = r[text["size"]] - 1 - len(pre) - len(post)
        lo, hi = text["ids"]
        body = traffic.token_ids(self.seed, r["index"], n, lo, hi)
        return [tok.bos_token_id] + pre + body + post

    def _bucket(self, n: int) -> int:
        return next(b for b in self.cell["engine"]["prompt_buckets"]
                    if b >= n)

    def setup(self) -> None:
        from PIL import Image

        from benchmark.harness.programs import build_runtime
        from seedx_tpu_torch.inference.continuous import ContinuousEngine

        self.rt = build_runtime(self.cfg, self.seed, self.device)
        e = self.cell["engine"]
        self.eng = ContinuousEngine(
            self.rt, slots=e["slots"], max_new_tokens=e["max_new_tokens"],
            chunk_steps=e["chunk_steps"],
            prompt_buckets=tuple(e["prompt_buckets"]))
        self.probe = EngineProbe(self.eng)
        self.turn = Turn()
        self.spans = Spans(False)
        self._vit_on_turn()
        self.reqs = traffic.generate(self.mix, self.seed, self.seconds,
                                     self.rate)
        pool: Dict[str, object] = {}
        per_grid = self.mix.get("image", {}).get("pool", 8)
        base = self.cfg["vision"]["image_size"]
        for r in self.reqs:
            if "grid" in r:
                key = f"{r['grid']}.{r['index'] % per_grid}"
                if key not in pool:
                    w, h = traffic.grid_size(r["grid"], base)
                    arr = traffic.make_image(self.seed, key, w, h)
                    pool[key] = (arr, Image.fromarray(arr))
                r["image"], r["pil"] = pool[key]
            r["ids"] = self._prompt(r)
        used = sorted({self._bucket(len(r["ids"])) for r in self.reqs})
        self.eng.warmup(buckets=used)
        # one real request of every image grid or prompt bucket the traffic
        # has, all admitted together: the ViT's tile counts, the splice.
        # They are prepared by front threads as in the window, so the
        # per-thread library handles the window's threads take over from
        # them exist already.
        warm, seen = [], set()
        for r in self.reqs:
            key = r.get("grid") or self._bucket(len(r["ids"]))
            if key not in seen:
                seen.add(key)
                warm.append(r)
        front = Front(self, warm[:self.cell["engine"]["slots"]], -math.inf,
                      self.spans)
        front.start()
        ended = 0
        while ended < len(front.threads):
            items = front.take(DRAIN_S)
            if not items:
                raise RuntimeError("warm-up requests not prepared in time")
            for item in items:
                if item is None:
                    ended += 1
                else:
                    self.eng.submit(item[1],
                                    max_new_tokens=self.mix["warm_tokens"])
        front.join(DRAIN_S)
        self.eng.run()
        sync()

    def _vit_on_turn(self) -> None:
        """The runtime's ViT, called by ``encode_image_anyres``, takes the
        device's turn (and, traced, a span closed by a synchronize)."""
        vit = self.rt.vit
        forward = vit.forward

        def forward_on_turn(x, *a, **kw):
            with self.turn.for_device_call():
                with self.spans.span("vit_encode", tiles=int(x.shape[0])):
                    return forward(x, *a, **kw)

        vit.forward = forward_on_turn

    def _request(self, r: Dict, spans: Spans) -> Dict:
        from seedx_tpu_torch.text import prompts

        if "pil" not in r:
            return {"input_ids": r["ids"]}
        with spans.span("encode", wait=False):
            emb, pp = self.rt.encode_image_anyres(r["pil"])
        return {"input_ids": r["ids"], "image_embeds": emb,
                "embeds_cmp_mask": np.ones((emb.shape[0],), bool),
                "ids_cmp_mask": prompts.cmp_mask_from_ids(r["ids"]),
                "patch_positions": pp}

    # ---- the window -----------------------------------------------------------

    def window(self, seconds: float, trace: bool) -> Dict:
        eng, probe, turn = self.eng, self.probe, self.turn
        spans = self.spans = Spans(trace)
        undo = probe.instrument(spans) if trace else None
        prof, prof_at, prof_end = None, seconds / 3.0, None
        by_rid: Dict[int, Dict] = {}
        queue_ = sorted(self.reqs, key=lambda r: r["due"])
        dues = [r["due"] for r in queue_]
        late: List[float] = []
        backlog: List[tuple] = []  # (s into the window, due, not admitted)
        submitted, ended, front_done = 0, 0, False
        t0 = time.perf_counter()
        close = t0 + seconds
        drain = close + DRAIN_S
        front = Front(self, queue_, t0, spans)
        front.start()
        try:
            while True:
                now = time.perf_counter()
                if trace and prof is None and now - t0 >= prof_at:
                    prof = Profile()
                    prof.start()
                    prof_end = now + min(PROFILED_S, seconds / 3.0)
                if prof is not None and prof_end is not None \
                        and now >= prof_end:
                    prof.stop()
                    prof_end = None
                    # the profiler's own stop is not the system's time
                    drain += time.perf_counter() - now
                stats = eng.stats()
                busy = stats["pending"] or stats["active_slots"]
                wait = 0.0 if busy or front_done else \
                    max(1e-3, drain - time.perf_counter())
                with turn.for_step():
                    pass
                for item in front.take(wait):
                    if item is None:
                        ended += 1
                        front_done = ended == len(front.threads)
                        continue
                    r, req = item
                    rid = eng.submit(req, max_new_tokens=r["output_tokens"])
                    r["rid"] = rid
                    by_rid[rid] = r
                    late.append(time.perf_counter() - t0 - r["due"])
                    submitted += 1
                now = time.perf_counter()
                stats = eng.stats()
                due = bisect.bisect_right(dues, now - t0)
                backlog.append((now - t0,
                                due - submitted + stats["pending"]))
                if stats["pending"] or stats["active_slots"]:
                    waiting = probe.waiting()
                    with turn.for_step():
                        eng.step()
                    t = time.perf_counter()
                    for rid in waiting - probe.waiting():
                        by_rid[rid]["t_first"] = t
                    for rid, res in probe.take_results().items():
                        by_rid[rid]["t_done"] = t
                        by_rid[rid]["tokens"] = [int(x)
                                                 for x in res["tokens"]]
                elif front_done:
                    break
                if time.perf_counter() > drain:
                    break
        finally:
            front.halt.set()
            front.join(timeout=DRAIN_S)
            if prof is not None and prof_end is not None:
                prof.stop()
            if undo is not None:
                undo()
        self.queue = queue_
        ttft, tpot = [], []
        for r in queue_:
            if "t_done" not in r:
                continue
            first = r["t_first"]
            ttft.append((first - t0 - r["due"]) * 1e3)
            n = len(r["tokens"])
            if n > 1:
                tpot.append((r["t_done"] - first) / (n - 1) * 1e3)
        done = [r for r in queue_ if "t_done" in r]
        stats = eng.stats()
        encode_ms = [(s["t1"] - s["t0"]) * 1e3 for s in spans.of("encode")]

        def mean_backlog(a, b):
            vals = [n for t, n in backlog if a <= t < b]
            return sum(vals) / len(vals) if vals else float("nan")

        notes = {
            "waiting (due, not admitted), mean over the window's thirds":
                " / ".join(f"{mean_backlog(k * seconds / 3, (k + 1) * seconds / 3):.2f}"
                           for k in range(3)),
            "window requests": f"{len(done)} of {len(queue_)} done, "
                        f"{sum(len(r['tokens']) for r in done)} tokens; "
                        f"rate {self.rate} req/s",
            "submitted after due, p95 / max ms":
                f"{percentile(late, 95) * 1e3:.3f} / "
                f"{max(late, default=0.0) * 1e3:.3f}",
            "engine": str(stats),
            "last done after close s": f"{max((r['t_done'] for r in done), default=close) - close:.3f}",
        }
        if encode_ms:
            notes["front encode (transform, turn, ViT) p50 / p95 ms"] = (
                f"{percentile(encode_ms, 50):.3f} / "
                f"{percentile(encode_ms, 95):.3f}")
        return {"attempted": len(queue_), "failed": len(queue_) - len(done),
                "end_to_end": {"ttft_p95_ms": percentile(ttft, 95),
                               "tpot_p95_ms": percentile(tpot, 95)},
                "spans": spans, "profile": prof, "notes": notes,
                "work": {}}

    # ---- after the window -----------------------------------------------------

    def release(self) -> None:
        self.eng = self.rt = None
        gc.collect()
        if torch.cuda.is_available():
            torch.cuda.empty_cache()

    def sample(self) -> List[Dict]:
        """The served requests the reference reads: the one with the most
        served tokens and ``check.requests - 1`` others drawn from the
        seed."""
        done = [r for r in self.queue if "t_done" in r]
        if not done:
            return []
        longest = max(done, key=lambda r: len(r["tokens"]))
        rest = [r for r in done if r is not longest]
        order = traffic.rng_for(self.seed, "check").permutation(len(rest))
        n = self.cell["check"]["requests"] - 1
        return [longest] + [rest[j] for j in order[:n]]

    def _checked_requests(self) -> List[Dict]:
        return [{"ids": r["ids"], "tokens": r["tokens"],
                 "image": r.get("image"), "grid": r.get("grid")}
                for r in self.sample()]

    def control(self) -> List[Dict]:
        """The control's reading on the same sample: the reference with
        its activations and KV cache one precision below the
        configuration's (int4 for int8), its own first choice at every
        position read in the fp32 reference's logits."""
        from benchmark.reference.agent import served_gaps

        gaps = served_gaps(self.seed, self.cfg, self._checked_requests(),
                           self.device, act_bits=4, kv_bits=4,
                           pick="argmax")
        return [{"name": "token_gap", "value": max(gaps)}]

    def check(self) -> List[Dict]:
        """Every request due in the window answered (one that never came
        is wrong, a late one only late), and the widest gap of a served
        token below the reference's best over the sample."""
        from benchmark.reference.agent import served_gaps

        unfinished = {"name": "unfinished", "limit": 0,
                      "value": sum("t_done" not in r for r in self.queue)}
        pick = self.sample()
        if not pick:
            return [unfinished, {"name": "token_gap", "value": float("inf"),
                                 "limit": self.cell["check"]["token_gap"]}]
        gaps = served_gaps(self.seed, self.cfg, self._checked_requests(),
                           self.device)
        self.checked = {"requests": len(pick),
                        "tokens": sum(len(r["tokens"]) for r in pick),
                        "gaps": gaps}
        return [unfinished, {"name": "token_gap", "value": max(gaps),
                             "limit": self.cell["check"]["token_gap"]}]
