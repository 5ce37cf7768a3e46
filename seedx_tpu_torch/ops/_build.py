"""Build and load the port's CUDA kernels.

Each ``csrc/*.cu`` file exposes plain C entry points.  It is compiled with
``nvcc -gencode arch=compute_90a,code=sm_90a`` into a shared library under
``seedx_tpu_torch/_build/`` (listed in ``.gitignore``) at first use, named
by a hash of its source and flags so an edit rebuilds, and loaded with
``ctypes``.  Nothing here runs at import time; the CPU tests never build.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from typing import Dict, Sequence

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-lineinfo",
              "-Xptxas", "-v")

_lock = threading.Lock()
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


def load_library(name: str, source: str,
                 signatures: Dict[str, Sequence]) -> ctypes.CDLL:
    """Compile ``csrc/<source>`` (once per content) and bind ``signatures``:
    {function: [argtypes...]}, every function returning a C int error."""
    with _lock:
        if name in _libs:
            return _libs[name]
        path = os.path.join(CSRC, source)
        with open(path, "rb") as f:
            digest = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode()
                                    ).hexdigest()[:16]
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


def check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err}")
