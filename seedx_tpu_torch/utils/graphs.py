"""Captured device programs: the port's counterpart of the JAX package's
jit cache (reference: the jitted ``generate_tokens`` while-loop,
``_solver_scan`` and ``ContinuousEngine.warmup``).

A ``Program`` wraps one step function that reads and writes only static
device buffers (its closure's tensors, updated in place).  On the card,
with its ``Graphs`` switch on, the first call runs the step eagerly on
a side stream (the warm run: it is a real step, and every kernel's
one-time set-up, such as ``cudaFuncSetAttribute`` or a library load,
happens there and not under capture), then captures it as a
``torch.cuda.CUDAGraph``; every later call replays the graph.  On the CPU,
or with the switch off, every call runs the step eagerly: the same
function on the same buffers, so the eager path stays the reference of
the captured one.  A capture or a replay that fails raises; nothing falls
back.

The kernels' launch counters (the registry ``ops/_build.launches``) are
Python integers, bumped when a wrapper launches.  Under capture the
wrappers run once without launching anything, so a capture takes back
what its wrappers counted, keeps it as the graph's launches per replay,
and every replay adds that much: the counters go on counting the kernels
that ran.  This module names no kernel: it reads whatever the registry
holds.

``Graphs`` is the one switch between the captured path and the eager one
(a runtime's ``graphs``, shared by its agent and adapter), and the one
private memory pool every program captured under it shares: programs
replay one at a time on one stream and read no pool tensor of another
program, so a pool that each capture reuses is safe, and what the pools
hold is one program's activations, not the sum over shapes.  The owner
of a program keeps it with the static buffers it points at (the agent's
``DecodePrograms``, a chat session's decode state, an engine's step
programs, an adapter's CFG evals), so nothing a graph reads is freed
while the graph lives.
"""

from __future__ import annotations

import contextlib
import gc
import time
import weakref
from typing import Any, Callable, Dict, Optional

import torch

from seedx_tpu_torch.ops._build import launches

# replays between two host reads of a decode loop's flags
CHECK_EVERY = 8


@contextlib.contextmanager
def _taken_back(into: Dict[str, int]):
    """Every launch counter set back, at the block's end, to what it held
    at its start; what each grew by meanwhile goes into ``into``."""
    before = dict(launches)
    try:
        yield
    finally:
        for name, n in launches.items():
            was = before.get(name, 0)
            if n != was:
                into[name] = n - was
                launches[name] = was


class Program:
    """One step function, replayed as a CUDA graph on the card while its
    ``graphs`` switch is on (see the module docstring); with ``graphs``
    None, or off the card, every call runs the step eagerly."""

    def __init__(self, fn: Callable[[], Any], device: torch.device,
                 graphs: Optional["Graphs"], kind: Optional[str] = None):
        """``kind`` names the step in the spans around its replays."""
        self.fn, self.device, self.graphs = fn, torch.device(device), graphs
        self.kind = kind
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.outputs: Any = None
        # launch counter -> what a replay adds to it
        self.per_replay: Dict[str, int] = {}
        self.replays = 0
        self.capture_s = 0.0
        self.pool_bytes = 0

    @property
    def graphed(self) -> bool:
        return (self.device.type == "cuda" and self.graphs is not None
                and self.graphs.active(self.device))

    def __call__(self) -> Any:
        """One step: eager, the warm run and capture, or a replay.  Returns
        the step's outputs (the captured ones on a replay: static tensors
        the next call overwrites)."""
        if not self.graphed:
            return self.fn()
        if self.graph is None:
            return self.capture()
        self.graph.replay()
        self.replays += 1
        for name, n in self.per_replay.items():
            launches[name] += n
        return self.outputs

    def capture(self) -> Any:
        """The warm eager run on a side stream (a real step), then the
        capture (which runs nothing) into the switch's shared pool.
        Returns the warm run's outputs."""
        if self.graph is not None or not self.graphed:
            raise RuntimeError("Program.capture: already captured, or not "
                               "on the card with graphs enabled")
        dev = self.device
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            out = self.fn()
        torch.cuda.current_stream(dev).wait_stream(side)
        torch.cuda.synchronize(dev)
        gc.collect()
        torch.cuda.empty_cache()
        reserved = torch.cuda.memory_reserved(dev)
        per_replay: Dict[str, int] = {}
        t0 = time.perf_counter()
        graph = torch.cuda.CUDAGraph()
        with _taken_back(per_replay):
            with torch.cuda.graph(graph, pool=self.graphs.pool(dev),
                                  capture_error_mode="thread_local"):
                self.outputs = self.fn()
            self.graphs.holds(self)
        torch.cuda.synchronize(dev)
        self.capture_s = time.perf_counter() - t0
        self.pool_bytes = torch.cuda.memory_reserved(dev) - reserved
        self.per_replay = per_replay
        self.graph = graph
        return out

    def stats(self) -> Dict[str, Any]:
        """Capture seconds, the bytes the shared pool grew by at this
        capture, replays and kernel launches a replay (the counters of
        whole kernels: names without a space)."""
        return {"captured": self.graph is not None,
                "capture_s": self.capture_s, "pool_bytes": self.pool_bytes,
                "replays": self.replays,
                "launches_per_replay": sum(
                    n for name, n in self.per_replay.items()
                    if " " not in name)}


class Graphs:
    """The switch between captured programs and the eager path on the card
    (``enabled``, default True; the CPU is always eager), and the private
    memory pool, one a device, that every program captured under it
    shares."""

    def __init__(self, enabled: bool = True):
        self.enabled = enabled
        # device -> (pool handle, the programs whose graphs hold it)
        self._pools: Dict[torch.device, tuple] = {}

    def active(self, device) -> bool:
        return self.enabled and torch.device(device).type == "cuda"

    def pool(self, device):
        """The pool of the next capture on ``device``: the one the live
        graphs share, or a new one once none is left (a pool whose graphs
        are all gone is released, and its handle cannot be used again)."""
        dev = torch.device(device)
        handle, holders = self._pools.get(dev, (None, ()))
        if not any(p.graph is not None for p in holders):
            handle = torch.cuda.graph_pool_handle()
            self._pools[dev] = (handle, weakref.WeakSet())
        return handle

    def holds(self, program: Program) -> None:
        """``program``'s graph was captured into its device's pool."""
        self._pools[program.device][1].add(program)

    def program(self, fn: Callable[[], Any], device) -> Program:
        return Program(fn, device, self)
