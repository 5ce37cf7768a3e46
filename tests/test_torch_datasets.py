"""The port's SFT data path against the JAX package's, on the same files
and seeds: the four dataset builders' numpy batches bit for bit, the
stream helpers, ``ThreadPrefetcher``, ``encode_edit_sample`` and the
``clipa`` / ``clipb`` transforms (exact equality throughout).

The files come from ``tests/torch_data_fixtures.py``.  The builders read
the caption shards with the Python reader on both sides (the native
reader's cross-shard order depends on its threads), except in the
one-shard case, which each package's native reader reads.
"""

import itertools
import os

import numpy as np
import pytest
from PIL import Image

from seedx_tpu import config as jconfig
from seedx_tpu.data import datasets as jds
from seedx_tpu.data import encoding as jenc
from seedx_tpu.data import native as jnative
from seedx_tpu.data import pipeline as jpipe
from seedx_tpu.data import transforms as jtf
from seedx_tpu.text.tokenizer import load_tokenizer as j_load_tokenizer
from seedx_tpu_torch import config as tconfig
from seedx_tpu_torch.data import datasets as tds
from seedx_tpu_torch.data import encoding as tenc
from seedx_tpu_torch.data import native as tnative
from seedx_tpu_torch.data import pipeline as tpipe
from seedx_tpu_torch.data import transforms as ttf
from seedx_tpu_torch.text.tokenizer import load_tokenizer

from torch_data_fixtures import (REPO, data_yamls, write_caption_shards,
                                 write_edit, write_llava)

BASE = 448


@pytest.fixture
def python_reader(monkeypatch):
    """Both packages' ``read_tar_shards_multi`` on the Python reader."""
    monkeypatch.setattr(jnative, "available", lambda: False)
    monkeypatch.setattr(tnative, "available", lambda: False)


def _same_batches(got, want, n):
    got, want = list(itertools.islice(got, n)), list(itertools.islice(
        want, n))
    assert len(got) == len(want) == n
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for k in w:
            assert g[k].dtype == w[k].dtype, k
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)
    return got


def _kw(extra):
    tf_j = jtf.get_transform("clip", keep_ratio=False, image_size=BASE)
    tf_t = ttf.get_transform("clip", keep_ratio=False, image_size=BASE)
    return (dict(tokenizer=j_load_tokenizer(), image_transform=tf_j, **extra),
            dict(tokenizer=load_tokenizer(), image_transform=tf_t, **extra))


@pytest.mark.parametrize("grids", [("1x1",), ("1x1", "1x2", "2x1", "2x2")])
def test_caption_builder_matches_jax(python_reader, tmp_path, grids):
    """Similarity filter, resolution / aspect filter, anyres tiling,
    img-first / img-last coin flips, static-shape collation."""
    shards = write_caption_shards(str(tmp_path), shards=3)
    kj, kt = _kw(dict(data_dir=[shards], max_length=260, batch_size=3,
                      resolution_grids=grids, cycle_count=3,
                      img_first_ratio=0.5, seed=7))
    got = _same_batches(tds.build_caption_datapipes_with_pixels(**kt),
                        jds.build_caption_datapipes_with_pixels(**kj), 4)
    assert got[0]["images"].shape[0] == 3 * tds._max_tiles(grids)
    # both coin flips taken: generation and comprehension slots
    assert any(b["embeds_gen_mask"].any() for b in got)
    assert any(b["embeds_cmp_mask"].any() for b in got)


def test_caption_builder_native_one_shard(tmp_path):
    """One shard read once (one reader thread, so one order): each
    package's native reader (built with g++) gives the same batches."""
    if not (tnative.available() and jnative.available()):
        pytest.skip("no C++ toolchain (g++) for the native readers")
    shards = write_caption_shards(str(tmp_path), shards=1, per_shard=10)
    kj, kt = _kw(dict(data_dir=shards, max_length=260, batch_size=2,
                      cycle_count=1, seed=3))
    _same_batches(tds.build_caption_datapipes_with_pixels(**kt),
                  jds.build_caption_datapipes_with_pixels(**kj), 3)


def test_llava_builder_matches_jax(tmp_path):
    """Conversations with anyres images (1 / 3 / 3 tiles + thumbnail), a
    missing image and a bad json line dropped."""
    conv_dir, img_dir = write_llava(str(tmp_path))
    kj, kt = _kw(dict(data_dir=conv_dir, image_dir=img_dir, max_length=880,
                      batch_size=2, cycle_count=4, seed=5,
                      resolution_grids=["1x1", "1x2", "1x3", "2x1", "3x1",
                                        "1x4", "4x1", "2x2"]))
    got = _same_batches(tds.build_llava_jsonl_datapipes(**kt),
                        jds.build_llava_jsonl_datapipes(**kj), 5)
    assert got[0]["input_ids"].shape == (2, 880)
    assert got[0]["images"].shape == (10, BASE, BASE, 3)


def test_edit_builder_matches_jax(tmp_path):
    """Source / target pairs, the small source and the pair without an
    instruction dropped, polite responses drawn."""
    ann, img_dir = write_edit(str(tmp_path))
    kj, kt = _kw(dict(data_dir=[ann], image_dir=img_dir, max_length=320,
                      batch_size=3, cycle_count=3, seed=9))
    got = _same_batches(tds.build_single_turn_edit_datapipes(**kt),
                        jds.build_single_turn_edit_datapipes(**kj), 3)
    b = got[0]
    assert b["images"].shape == (12, BASE, BASE, 3)
    assert b["embeds_gen_mask"].sum() == 3 and b["ids_gen_mask"].any()


@pytest.mark.parametrize("name", ["comprehension_gen", "edit"])
def test_multi_builder_from_repo_yamls_matches_jax(python_reader, tmp_path,
                                                   name):
    """The repo's data YAMLs (only the paths rewritten), instantiated by
    each package's config system (``seedx_tpu.`` targets read as
    ``seedx_tpu_torch.`` by the port): the weighted mix of batches."""
    path = data_yamls(str(tmp_path))[name]
    cfg = tconfig.load_config(path)
    assert cfg == jconfig.load_config(path)
    transform = os.path.join(REPO, "configs/processer/"
                             "qwen_448_transform.yaml")
    tf_j = jconfig.instantiate_from_file(transform)
    tf_t = tconfig.instantiate_from_file(transform)
    want = jconfig.instantiate(cfg, tokenizer=j_load_tokenizer(),
                               image_transform=tf_j)
    got = tconfig.instantiate(cfg, tokenizer=load_tokenizer(),
                              image_transform=tf_t)
    batches = _same_batches(got, want, 6)
    if name == "comprehension_gen":   # both streams of the mix drawn
        assert {b["input_ids"].shape for b in batches} == {(2, 880),
                                                           (8, 260)}


# ---- stream helpers ---------------------------------------------------------

def test_readers_match_jax(tmp_path):
    shards = write_caption_shards(str(tmp_path), shards=1, per_shard=4)
    p = os.path.join(shards, "00000.tar")
    got, want = list(tpipe.read_tar_shards(p)), list(jpipe.read_tar_shards(p))
    assert len(got) == len(want) == 4
    for a, b in zip(got, want):
        assert a.keys() == b.keys()
        assert a["text"] == b["text"] and a["metadata"] == b["metadata"]
        assert np.array_equal(np.asarray(a["images"]),
                              np.asarray(b["images"]))
    bad = tmp_path / "bad.tar"
    bad.write_bytes(b"not a tar" * 50)
    assert list(tpipe.read_tar_shards(str(bad))) == []
    conv_dir, _ = write_llava(str(tmp_path))
    jl = os.path.join(conv_dir, "conv.jsonl")
    assert list(tpipe.read_jsonl(jl)) == list(jpipe.read_jsonl(jl))
    assert len(list(tpipe.read_jsonl(jl))) == 6
    assert list(tpipe.read_jsonl(str(tmp_path / "none.jsonl"))) == []


def test_stream_helpers_match_jax():
    files = [f"f{i}" for i in range(7)]
    for idx, cnt in ((0, 1), (1, 3), (2, 3)):
        assert tpipe.shard_files(files, idx, cnt) == \
            jpipe.shard_files(files, idx, cnt)
    assert tpipe.shard_files(files) == files          # no process group
    assert list(tpipe.cycle_files(files, 3, seed=4)) == \
        list(jpipe.cycle_files(files, 3, seed=4))
    for buf in (1, 5, 64):
        assert list(tpipe.shuffle_stream(range(40), buf, seed=2)) == \
            list(jpipe.shuffle_stream(range(40), buf, seed=2))
    streams = lambda: [iter(range(0, 10)), iter(range(100, 130)),
                       iter(range(200, 203))]
    got = list(tpipe.weighted_mix(streams(), [0.6, 0.2, 0.2], seed=42))
    assert got == list(jpipe.weighted_mix(streams(), [0.6, 0.2, 0.2],
                                          seed=42))
    assert sorted(got) == sorted(itertools.chain(*streams()))
    assert list(tpipe.batched(range(7), 3)) == list(jpipe.batched(range(7),
                                                                  3))
    assert list(tpipe.batched(range(7), 3, drop_last=False))[-1] == [6]


def test_thread_prefetcher_order_and_errors():
    assert list(tpipe.ThreadPrefetcher(iter(range(50)), buffer_size=3)) == \
        list(range(50))

    def boom():
        yield 1
        yield 2
        raise RuntimeError("decode failed")

    it = tpipe.ThreadPrefetcher(boom(), buffer_size=2)
    assert next(it) == 1 and next(it) == 2
    with pytest.raises(RuntimeError, match="decode failed"):
        next(it)


# ---- encoders and transforms ------------------------------------------------

@pytest.mark.parametrize("kw", [
    dict(response=None, use_polite_response=True, prompt_drop_ratio=0.0),
    dict(response="Done.", use_polite_response=True, prompt_drop_ratio=0.0),
    dict(response=None, use_polite_response=False, prompt_drop_ratio=1.0)])
def test_encode_edit_sample_matches_jax(kw):
    for seed in range(4):
        got = tenc.encode_edit_sample(
            "make it snow", load_tokenizer(), max_length=400,
            source_patch_length=3, target_patch_length=2,
            rng=np.random.default_rng(seed), **kw)
        want = jenc.encode_edit_sample(
            "make it snow", j_load_tokenizer(), max_length=400,
            source_patch_length=3, target_patch_length=2,
            rng=np.random.default_rng(seed), **kw)
        assert got.keys() == want.keys()
        for k in want:
            assert got[k].dtype == want[k].dtype, k
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        assert got["embeds_gen_mask"].tolist() == [False] * 4 + [True]


@pytest.mark.parametrize("type_", ["clip", "clipa", "clipb", "sd"])
@pytest.mark.parametrize("keep_ratio", [False, True])
@pytest.mark.parametrize("size", [(300, 200), (200, 300), (256, 256)])
def test_transforms_match_jax(type_, keep_ratio, size):
    rng = np.random.default_rng(size[0] + size[1])
    img = Image.fromarray((rng.random((size[1], size[0], 3)) * 255).astype(
        np.uint8))
    got = ttf.get_transform(type_, keep_ratio, 224)(img)
    want = jtf.get_transform(type_, keep_ratio, 224)(img)
    assert got.dtype == want.dtype == np.float32
    assert got.shape == (224, 224, 3)
    np.testing.assert_array_equal(got, want)


def test_unknown_transform_raises():
    img = Image.new("RGB", (8, 8))
    with pytest.raises(NotImplementedError):
        ttf.get_transform("nope")(img)
