"""The port's native C++ shard reader (seedx_tpu_torch/data/native, its own
copy of seedx_io.cc, built with g++ at first use) against its Python
reader and the JAX package's: the same samples per shard (the native
reader interleaves shards by design, so order is compared within a
shard), a corrupt shard skipped, a truncated member, the dispatcher."""

import io
import json
import os
import tarfile

import numpy as np
import pytest
from PIL import Image

from seedx_tpu.data.pipeline import read_tar_shards as j_read_tar_shards
from seedx_tpu_torch.data import native as native_io
from seedx_tpu_torch.data.pipeline import (read_tar_shards,
                                           read_tar_shards_multi)


@pytest.fixture(scope="module")
def native():
    if not native_io.available():
        pytest.skip("no C++ toolchain (g++) to build the native reader")
    return native_io


def _make_shard(path, keys, long_name=False, seed=0):
    rng = np.random.default_rng(seed)
    with tarfile.open(path, "w") as tf:
        for k in keys:
            img = Image.fromarray(rng.integers(0, 255, (32, 24, 3),
                                               dtype=np.uint8))
            buf = io.BytesIO()
            img.save(buf, "PNG")
            name = k + ("x" * 120 if long_name else "")
            for ext, data in [(".png", buf.getvalue()),
                              (".txt", f"caption {k}".encode()),
                              (".json", json.dumps({"k": k}).encode())]:
                info = tarfile.TarInfo(name + ext)
                info.size = len(data)
                tf.addfile(info, io.BytesIO(data))


def _same(a, b):
    assert a["__key__"] == b["__key__"]
    assert a["text"] == b["text"]
    assert json.loads(a["metadata"]) == json.loads(b["metadata"])
    assert np.array_equal(np.asarray(a["images"]), np.asarray(b["images"]))


@pytest.mark.parametrize("threads", [1, 3])
def test_native_matches_python_reader_per_shard(native, tmp_path, threads):
    """Every shard's samples, in the shard's order, equal the port's and
    the JAX package's Python readers' (shard 1 with GNU / PAX long
    names)."""
    paths = []
    for s in range(3):
        p = str(tmp_path / f"shard{s}.tar")
        _make_shard(p, [f"s{s}k{i:03d}" for i in range(5)],
                    long_name=(s == 1), seed=s)
        paths.append(p)
    nat = list(native.read_tar_shards_native(paths, num_threads=threads))
    assert len(nat) == 15
    for s, p in enumerate(paths):
        mine = [r for r in nat if r["__key__"].startswith(f"s{s}k")]
        py, jax_py = list(read_tar_shards(p)), list(j_read_tar_shards(p))
        assert len(mine) == len(py) == len(jax_py) == 5
        for a, b, c in zip(mine, py, jax_py):
            _same(a, b)
            _same(a, c)


def test_native_skips_corrupt_shard(native, tmp_path):
    good = str(tmp_path / "good.tar")
    bad = str(tmp_path / "bad.tar")
    _make_shard(good, ["a", "b"])
    with open(bad, "wb") as f:
        f.write(b"this is not a tar file" * 40)
    out = list(native.read_tar_shards_native([bad, good], num_threads=2))
    assert sorted(r["__key__"] for r in out) == ["a", "b"]
    # the Python reader skips the same shard
    assert [r["__key__"] for r in read_tar_shards_multi(
        [bad, good], native=False)] == ["a", "b"]


def test_truncated_member(native, tmp_path):
    p = str(tmp_path / "trunc.tar")
    _make_shard(p, ["a", "b", "c"])
    sz = os.path.getsize(p)
    with open(p, "r+b") as f:
        f.truncate(sz - 700)   # cut into the tail member
    out = list(native.read_tar_shards_native([p], num_threads=1))
    # the complete leading samples still arrive, whole
    keys = [r["__key__"] for r in out]
    assert keys[:2] == ["a", "b"]
    full = {r["__key__"]: r for r in read_tar_shards(p)}
    _same(out[0], full["a"])


def test_multi_dispatcher(native, tmp_path):
    """``read_tar_shards_multi`` takes the native reader by default when it
    builds, and gives the Python reader's samples on one shard."""
    p = str(tmp_path / "one.tar")
    _make_shard(p, ["z1", "z2"])
    default = list(read_tar_shards_multi([p]))
    nat = list(read_tar_shards_multi([p], native=True))
    py = list(read_tar_shards_multi([p], native=False))
    assert [r["__key__"] for r in nat] == [r["__key__"] for r in py] == \
        [r["__key__"] for r in default] == ["z1", "z2"]
    for a, b in zip(nat, py):
        _same(a, b)
