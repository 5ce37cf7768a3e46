"""The one traffic generator: deterministic from the seed, the stated
distributions, and the same amount of work for every seed."""

import statistics

import numpy as np
import pytest

from benchmark.harness import core, traffic

VQA = core.cell_files("ds7b_vqa_serve")["mix"]
DOC = core.cell_files("ds7b_longdoc_serve")["mix"]
BIG = 2**31 + 987654321


def test_same_seed_same_requests():
    a = traffic.generate(VQA, BIG, 30.0, 3.0)
    b = traffic.generate(VQA, BIG, 30.0, 3.0)
    assert a == b
    c = traffic.generate(VQA, BIG + 1, 30.0, 3.0)
    assert a != c


@pytest.mark.parametrize("mix", [VQA, DOC])
def test_every_seed_gets_the_same_work(mix):
    runs = [traffic.generate(mix, s, 60.0, 4.0) for s in (1, 2**33 + 5, BIG)]
    for key in mix["sizes"]:
        sets = [sorted(r[key] for r in run) for run in runs]
        n = min(len(s) for s in sets)
        # requests due past the window's end may differ by a few
        assert all(abs(len(s) - len(sets[0])) <= 3 for s in sets)
        assert abs(np.mean(sets[0][:n]) - np.mean(sets[1][:n])) \
            <= 0.05 * np.mean(sets[0])


def test_stated_distributions():
    n = 4001
    q = traffic.quantiles(VQA["sizes"]["question_tokens"], n)
    assert q.min() >= 16 and q.max() <= 448
    assert statistics.median(q.tolist()) == 64
    o = traffic.quantiles(VQA["sizes"]["output_tokens"], n)
    assert o.min() >= 16 and o.max() <= 384 and np.median(o) == 96
    p = traffic.quantiles(DOC["sizes"]["prompt_tokens"], n)
    assert p.min() >= 1536 and p.max() <= 3072
    assert abs(np.mean(p) - 2304) < 2
    f = traffic.quantiles({"kind": "fixed", "value": 7}, 5)
    assert f.tolist() == [7] * 5


def test_poisson_arrivals_and_grids():
    reqs = traffic.generate(VQA, BIG, 100.0, 3.0)
    due = np.array([r["due"] for r in reqs])
    assert (np.diff(due) >= 0).all() and due[0] == 0.0 and due[-1] < 100.0
    assert abs(len(reqs) - 300) <= 3
    gaps = np.diff(due)
    assert abs(gaps.mean() - 1 / 3.0) < 0.03          # exponential mean
    assert abs(np.median(gaps) - np.log(2) / 3.0) < 0.03
    grids = [r["grid"] for r in reqs]
    counts = {g: grids.count(g) for g in VQA["image"]["grids"]}
    assert max(counts.values()) - min(counts.values()) <= 2


def test_closed_loop_and_images():
    reqs = traffic.generate({"closed_requests": 5}, 3, 10.0, 0.0)
    assert [r["due"] for r in reqs] == [None] * 5
    img = traffic.make_image(BIG, "2x1.3", 896, 448)
    assert img.shape == (448, 896, 3) and img.dtype == np.uint8
    assert (img == traffic.make_image(BIG, "2x1.3", 896, 448)).all()
    assert img.std() > 10
    ids = traffic.token_ids(BIG, 4, 50, 3, 32000)
    assert ids == traffic.token_ids(BIG, 4, 50, 3, 32000)
    assert min(ids) >= 3 and max(ids) < 32000


@pytest.mark.parametrize("mix", [VQA, DOC])
def test_every_block_holds_each_band(mix):
    reqs = traffic.generate(mix, BIG, 100.0, 3.0)
    b = mix["block"]
    key = "output_tokens"
    allv = sorted(r[key] for r in reqs)
    n = len(allv)
    edges = [allv[k * n // b] for k in range(b)]
    for j in range(0, n - b + 1, b):
        run = sorted(r[key] for r in reqs[j:j + b])
        assert all(lo >= e for lo, e in zip(run, edges))
    if "image" in mix:
        for j in range(0, n - b + 1, b):
            assert len({r["grid"] for r in reqs[j:j + b]}) == b
    dues = [r["due"] for r in reqs]
    span = dues[-1] - dues[0]
    assert 0.9 * n / 3.0 < span + 1 / 3.0 < 1.1 * n / 3.0
