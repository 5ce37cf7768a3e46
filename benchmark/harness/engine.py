"""Every look the benchmark takes inside ``ContinuousEngine``, in one place.

The engine has no public per-request events yet: nothing says when a
request was admitted or finished, and nothing hooks admission, prefill
groups or decode chunks.  The serving driver needs the first two to
define a request's first token and its end, and a traced run needs the
hooks for its spans.  So this adapter reads two private fields of the
engine and, in a traced run, wraps two private methods and the module's
chunk runner.  It checks at construction that each one is there and of
the expected kind, so a change to the engine that renames or reshapes
them stops every serving run here with a message, instead of silently
changing what the metrics measure.
"""

from __future__ import annotations

from typing import Callable, Dict, Set


class EngineChanged(RuntimeError):
    pass


class EngineProbe:
    # what is read, and what it has to be
    FIELDS = {"_pending": list,    # [(request id, request, budget)], FIFO
              "_results": dict}    # request id -> result, set on harvest
    METHODS = ("_admit_pending",   # admission inside step()
               "_prefill_group")   # (requests, bucket): one bucket prefill
    STATE = ("n", "pos")           # run_chunk's state: tokens out, KV length

    def __init__(self, eng):
        from seedx_tpu_torch.inference import continuous

        missing = [f"{name} ({kind.__name__})"
                   for name, kind in self.FIELDS.items()
                   if not isinstance(getattr(eng, name, None), kind)]
        missing += [f"{name}()" for name in self.METHODS
                    if not callable(getattr(eng, name, None))]
        if not callable(getattr(continuous, "run_chunk", None)):
            missing.append("continuous.run_chunk()")
        if missing:
            raise EngineChanged(
                "the serving benchmark reads ContinuousEngine's "
                + ", ".join(missing) + ", which the engine no longer has: "
                "per-request events have to come from elsewhere "
                "(benchmark/harness/engine.py)")
        self.eng, self.module = eng, continuous

    def waiting(self) -> Set[int]:
        """Ids of the requests submitted and not yet admitted."""
        return {item[0] for item in self.eng._pending}

    def take_results(self) -> Dict[int, Dict]:
        """The results harvested since the last call, removed from the
        engine (what ``run()`` returns at its end)."""
        done, self.eng._results = self.eng._results, {}
        return done

    def instrument(self, spans) -> Callable[[], None]:
        """Spans around each admission, each prefill group and each decode
        chunk (a traced run); returns the function that removes them."""
        eng, mod = self.eng, self.module
        admit, group = eng._admit_pending, eng._prefill_group
        chunk = mod.run_chunk
        state_keys = self.STATE

        def admit_spanned():
            before = len(eng._pending)
            with spans.span("admit") as s:
                admit()
            s["admitted"] = before - len(eng._pending)

        def group_spanned(requests, bucket):
            images = sum(int(r["image_embeds"].shape[0]) for r in requests
                         if r.get("image_embeds") is not None)
            with spans.span("prefill_group", b=len(requests), bucket=bucket,
                            p_lens=[len(r["input_ids"]) for r in requests],
                            images=images):
                return group(requests, bucket)

        def chunk_spanned(program, state, k, *a, **kw):
            if any(key not in state for key in state_keys):
                raise EngineChanged(
                    "run_chunk's state has no " + " / ".join(
                        key for key in state_keys if key not in state)
                    + " (benchmark/harness/engine.py)")
            n0, pos0 = state["n"].clone(), state["pos"].clone()
            with spans.span("decode_chunk") as s:
                ran = chunk(program, state, k, *a, **kw)
            steps = (state["n"] - n0).clamp(min=0)
            s["steps"] = int(ran)
            s["tokens"] = int(steps.sum())
            # each row's KV window grows by one a step it ran
            s["kv_positions"] = int((steps * pos0 + steps * (steps + 1)
                                     // 2).sum())
            return ran

        eng._admit_pending = admit_spanned
        eng._prefill_group = group_spanned
        mod.run_chunk = chunk_spanned

        def undo():
            del eng._admit_pending, eng._prefill_group
            mod.run_chunk = chunk
        return undo
