"""Build and load the port's CUDA kernels.

Each ``csrc/*.cu`` file exposes plain C entry points.  It is compiled with
``nvcc -gencode arch=compute_90a,code=sm_90a`` into a shared library under
``seedx_tpu_torch/_build/`` (listed in ``.gitignore``) at first use, named
by a hash of its source, every ``csrc/*.cuh`` header and the flags, so an
edit to either rebuilds, and loaded with ``ctypes``.  Nothing here runs at
import time; the CPU tests never build.
Different kernels may build at once from several threads (one ``nvcc``
each); a second caller of the same kernel waits for the first.

The kernel layer's launch bookkeeping lives here too, so that a kernel
added later needs no edit outside its own ``ops/`` module and ``csrc/``
file:

* ``launches``, the one registry of launch counters: {name: count}.  A
  name without a space counts every launch of one kernel (``"int4_w4a8"``,
  ``"flash_fwd"``); ``"<kernel> <split>"`` counts a share of them
  (``"int4_w4a8 m16"`` by row tile, ``"int4_w4a8 rows 2-16"`` by row band,
  ``"decode_attn multi_query"`` by mode).  Each kernel module registers
  its names where it is defined; ``utils/graphs.py`` takes back what a
  capture counted and adds it at every replay, so the counters go on
  counting the kernels that ran.
* ``launch``, the one call of a kernel's entry point: the current stream,
  the error check under the entry point's name, the counters.
* ``TicketPool``, the zeroed tickets a split-K merge depends on.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from typing import Dict, List, Sequence

import torch

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-lineinfo",
              "-Xptxas", "-v")

_lock = threading.Lock()                 # guards _name_locks
_name_locks: Dict[str, threading.Lock] = {}
_libs: Dict[str, ctypes.CDLL] = {}
# name -> (seconds spent building, ptxas report); empty for a cached library
build_log: Dict[str, tuple] = {}


def nvcc_path() -> str:
    for cand in (os.environ.get("CUDA_HOME") and
                 os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"),
                 shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")


def source_digest(path: str) -> str:
    """Hash of ``path``, every header under ``csrc/`` (the sources include
    them) and the nvcc flags: what a built library depends on."""
    h = hashlib.sha256()
    headers = sorted(f for f in os.listdir(CSRC) if f.endswith(".cuh"))
    for p in [path] + [os.path.join(CSRC, f) for f in headers]:
        with open(p, "rb") as f:
            h.update(f.read())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def load_library(name: str, source: str,
                 signatures: Dict[str, Sequence]) -> ctypes.CDLL:
    """Compile ``csrc/<source>`` (once per content) and bind ``signatures``:
    {function: [argtypes...]}, every function returning a C int error."""
    with _lock:
        lock = _name_locks.setdefault(name, threading.Lock())
    with lock:
        if name in _libs:
            return _libs[name]
        path = os.path.join(CSRC, source)
        digest = source_digest(path)
        os.makedirs(BUILD_DIR, exist_ok=True)
        so = os.path.join(BUILD_DIR, f"lib{name}-{digest}.so")
        if not os.path.exists(so):
            t0 = time.perf_counter()
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
            os.close(fd)
            cmd = [nvcc_path(), *NVCC_FLAGS, "-o", tmp, path]
            proc = subprocess.run(cmd, capture_output=True, text=True)
            if proc.returncode != 0:
                os.unlink(tmp)
                raise RuntimeError(f"nvcc failed for {source}:\n"
                                   f"{proc.stdout}\n{proc.stderr}")
            os.replace(tmp, so)
            build_log[name] = (time.perf_counter() - t0, proc.stderr)
        else:
            build_log[name] = (0.0, "")
        lib = ctypes.CDLL(so)
        for fn, argtypes in signatures.items():
            getattr(lib, fn).argtypes = list(argtypes)
            getattr(lib, fn).restype = ctypes.c_int
        _libs[name] = lib
        return lib


@functools.lru_cache(maxsize=8)
def sm_count(index: int) -> int:
    """Streaming multiprocessors of CUDA device ``index``."""
    return torch.cuda.get_device_properties(index).multi_processor_count


# every kernel's launch counters (see the module docstring)
launches: Dict[str, int] = {}


def register(*names: str) -> None:
    """Add launch counters at zero; a name already there keeps its count."""
    for name in names:
        launches.setdefault(name, 0)


def launch(lib: ctypes.CDLL, entry: str, device, *args,
           counts: Sequence[str] = ()) -> None:
    """Call ``lib``'s ``entry`` with ``args`` and ``device``'s current
    stream, raise under ``entry``'s name on a nonzero error (counting
    nothing), then add one to each registered counter of ``counts``."""
    stream = torch.cuda.current_stream(device).cuda_stream
    err = getattr(lib, entry)(*args, stream)
    if err != 0:
        raise RuntimeError(f"{entry}: CUDA error {err}")
    for name in counts:
        launches[name] += 1


class TicketPool:
    """One split-K kernel's int32 tickets, a buffer a device, left at zero
    by each launch's merging blocks.  The pool grows and never frees: an
    outgrown buffer is kept in ``retired``, since a captured graph's
    launches point at the buffer they were captured with.  Growth under
    stream capture raises (the zeros would not exist before the first
    replay); a warm eager launch of the same shape sizes it first."""

    def __init__(self):
        self.buffers: Dict[torch.device, torch.Tensor] = {}
        self.retired: List[torch.Tensor] = []

    def get(self, device, n: int) -> torch.Tensor:
        """The device's buffer, at least ``n`` long."""
        buf = self.buffers.get(device)
        if buf is None or buf.numel() < n:
            if torch.cuda.is_available() and \
                    torch.cuda.is_current_stream_capturing():
                raise RuntimeError("ticket buffer would grow under stream "
                                   "capture: run the call eagerly first")
            if buf is not None:
                self.retired.append(buf)
            buf = torch.zeros(max(n, 4096), dtype=torch.int32, device=device)
            self.buffers[device] = buf
        return buf
