"""ctypes binding + on-demand build for the native shard reader (a copy of
seedx_tpu/data/native/__init__.py over the port's own copy of
``seedx_io.cc``; keep the two identical).

``read_tar_shards_native(paths)`` yields the same sample dicts as the pure
Python ``data.pipeline.read_tar_shards`` but parses/streams the tar bytes in
C++ worker threads and decodes the images in a thread pool (the
reference's torchdata readers are C++-backed).  On an H100 host's 8 cores
it reads webdataset shards at 1.7-3.6x ``tarfile``'s samples/s, but a
caption batch, bound by its transforms and tokenizer, takes 0.80-0.87x
the Python reader's time (PERF.md §6).  The library is built with ``g++`` at
first use into ``_build/`` beside this file.  This is host I/O, not a device kernel,
so it falls back gracefully: ``available()`` is False when no C++ toolchain
exists, and callers keep the Python reader.
"""

from __future__ import annotations

import ctypes
import io
import logging
import os
import subprocess
from typing import Any, Dict, Iterator, Optional, Sequence

logger = logging.getLogger(__name__)

_SRC = os.path.join(os.path.dirname(__file__), "seedx_io.cc")
_LIB = os.path.join(os.path.dirname(__file__), "_build", "libseedx_io.so")
_lib: Optional[ctypes.CDLL] = None
_build_failed = False


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _build_failed
    if _lib is not None:
        return _lib
    if _build_failed:
        return None
    if not os.path.exists(_LIB) or \
            os.path.getmtime(_LIB) < os.path.getmtime(_SRC):
        os.makedirs(os.path.dirname(_LIB), exist_ok=True)
        # Build to a per-process temp name and os.replace() it in: g++ -o
        # writes in place, and two processes building concurrently (e.g. a
        # CPU pytest run next to a TPU bench) let one dlopen a half-written
        # file ("file too short").  rename is atomic on POSIX, so loaders
        # only ever see a complete old or complete new library.
        # Sweep .tmp orphans from processes killed mid-build (e.g. by a
        # `timeout`): they are never reused, only leak.
        import glob
        for stale in glob.glob(f"{_LIB}.*.tmp"):
            try:
                os.unlink(stale)
            except OSError:
                pass
        tmp = f"{_LIB}.{os.getpid()}.tmp"
        cmd = ["g++", "-O3", "-shared", "-fPIC", "-pthread", "-std=c++17",
               _SRC, "-o", tmp]
        try:
            subprocess.run(cmd, check=True, capture_output=True, text=True)
            os.replace(tmp, _LIB)
        except (subprocess.CalledProcessError, FileNotFoundError,
                OSError) as e:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            if os.path.exists(_LIB):
                # A complete (merely stale) library already exists — a
                # failed rebuild/replace shouldn't discard a working
                # native path; dlopen the old one instead.
                logger.warning("native reader rebuild failed (%s); "
                               "loading the existing stale library",
                               getattr(e, "stderr", e))
            else:
                logger.warning("native reader build failed (%s); using "
                               "the python tar reader",
                               getattr(e, "stderr", e))
                _build_failed = True
                return None
    lib = ctypes.CDLL(_LIB)
    lib.sx_tar_open.restype = ctypes.c_void_p
    lib.sx_tar_open.argtypes = [ctypes.POINTER(ctypes.c_char_p),
                                ctypes.c_int, ctypes.c_int, ctypes.c_int]
    lib.sx_tar_next.restype = ctypes.c_int
    lib.sx_tar_next.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_int32), ctypes.c_char_p,
        ctypes.c_int, ctypes.POINTER(ctypes.POINTER(ctypes.c_uint8)),
        ctypes.POINTER(ctypes.c_uint64)]
    lib.sx_free.argtypes = [ctypes.POINTER(ctypes.c_uint8)]
    lib.sx_tar_close.argtypes = [ctypes.c_void_p]
    _lib = lib
    return lib


def available() -> bool:
    return _load() is not None


def _decode(name: str, data: bytes):
    """Field decode identical to data.pipeline.read_tar_shards."""
    from PIL import Image

    if name.endswith((".jpg", ".jpeg", ".png", ".webp")):
        return "images", Image.open(io.BytesIO(data)).convert("RGB")
    if name.endswith(".txt"):
        return "text", data.decode("utf-8", errors="replace")
    if name.endswith((".json", ".metadata")):
        return "metadata", data.decode("utf-8", errors="replace")
    return None, None


def _iter_raw_samples(paths: Sequence[str], num_threads: int,
                      queue_cap: int) -> Iterator[Dict[str, Any]]:
    """Yield RAW samples {key, members: [(name, bytes), ...]} from the C++
    reader.  Member records from different shards interleave; grouping into
    samples (members sharing a basename key) happens per shard here, so
    sample boundaries match the single-shard Python reader exactly."""
    lib = _load()
    assert lib is not None, "native reader unavailable (check available())"
    arr = (ctypes.c_char_p * len(paths))(*[p.encode() for p in paths])
    handle = lib.sx_tar_open(arr, len(paths), num_threads, queue_cap)
    name_buf = ctypes.create_string_buffer(4096)
    data_ptr = ctypes.POINTER(ctypes.c_uint8)()
    size = ctypes.c_uint64()
    shard = ctypes.c_int32()
    acc: Dict[int, Any] = {}   # shard_id -> (key, [(name, bytes)])

    try:
        while True:
            status = lib.sx_tar_next(handle, ctypes.byref(shard), name_buf,
                                     len(name_buf), ctypes.byref(data_ptr),
                                     ctypes.byref(size))
            if status == 0:
                break
            sid = shard.value
            if status == 2:  # end of one shard: flush its pending sample
                state = acc.pop(sid, None)
                if state is not None:
                    yield {"key": state[0], "members": state[1]}
                continue
            name = name_buf.value.decode("utf-8", errors="replace")
            data = ctypes.string_at(data_ptr, size.value)
            lib.sx_free(data_ptr)
            key, _, _ = name.partition(".")
            state = acc.get(sid)
            if state is not None and state[0] != key:
                yield {"key": state[0], "members": state[1]}
                del acc[sid]
                state = None
            if state is None:
                state = (key, [])
                acc[sid] = state
            state[1].append((name, data))
    finally:
        lib.sx_tar_close(handle)


def _decode_sample(raw: Dict[str, Any]) -> Optional[Dict[str, Any]]:
    sample: Dict[str, Any] = {}
    for name, data in raw["members"]:
        try:
            field, value = _decode(name, data)
        except Exception as e:  # corrupt image bytes etc.
            logger.warning("skipping corrupt member %s: %s", name, e)
            continue
        if field:
            sample[field] = value
    if sample.get("images") is not None or "text" in sample:
        sample.setdefault("metadata", "{}")
        sample["__key__"] = raw["key"]
        return sample
    return None


def read_tar_shards_native(paths: Sequence[str], num_threads: int = 4,
                           queue_cap: int = 256,
                           decode_workers: Optional[int] = None
                           ) -> Iterator[Dict[str, Any]]:
    """Stream webdataset samples from many shards: C++ reader threads for
    the tar/IO side, a Python thread pool for the (GIL-releasing) PIL image
    decode — the decode is the actual single-thread bottleneck."""
    from concurrent.futures import ThreadPoolExecutor

    import collections

    decode_workers = decode_workers or max(2, num_threads)
    window: collections.deque = collections.deque()
    with ThreadPoolExecutor(decode_workers) as ex:
        for raw in _iter_raw_samples(paths, num_threads, queue_cap):
            window.append(ex.submit(_decode_sample, raw))
            if len(window) >= decode_workers * 4:
                out = window.popleft().result()
                if out is not None:
                    yield out
        while window:
            out = window.popleft().result()
            if out is not None:
                yield out
