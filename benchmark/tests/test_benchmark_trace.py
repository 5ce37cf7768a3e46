"""The span and profile reduction: kernels attributed to the spans they
start in, busy time as the union of device activity, idle gaps labelled
by the span the host was in.  The card's own trace: the ``cuda`` test."""

import pytest
import torch

from benchmark.harness.trace import Profile, Spans


def fake_profile():
    p = Profile()
    p.window = (0, 1000)
    p.kernels = [(100, 200, "w4a8_mma<16>"), (150, 250, "decode_attn_kernel"),
                 (400, 500, "w4a8_mma<16>"), (700, 800, "flash_fwd_kernel")]
    p.spans = [(50, 300, "decode_chunk", 0), (350, 650, "admit", 1),
               (360, 640, "prefill_group", 2)]
    return p


def test_busy_idle_and_attribution():
    p = fake_profile()
    assert p.busy_intervals() == [(100, 250), (400, 500), (700, 800)]
    assert p.busy_s == pytest.approx(350e-9)
    assert p.window_s == pytest.approx(1000e-9)
    assert p.kernel_seconds(["w4a8_mma"]) == pytest.approx(200e-9)
    assert p.kernel_seconds(["w4a8_mma"], inside=["decode_chunk"]) == \
        pytest.approx(100e-9)
    assert p.kernel_seconds(["w4a8"], ids={2}) == pytest.approx(100e-9)
    assert p.kernel_seconds(["flash_fwd"], ids={0, 1, 2}) == 0.0
    assert p.span_ids(["prefill_group", "admit"]) == [1, 2]
    b = p.breakdown()
    assert b["device_ops"][0] == ["w4a8_mma<16>", pytest.approx(200e-9)]
    # gaps: [0, 100) in the chunk (its midpoint), [250, 400) host, [500, 700) inside the prefill
    # group (the innermost span), [800, 1000) host
    assert sorted(b["idle_gaps"][:2]) == [
        ["host", pytest.approx(200e-9)], ["prefill_group",
                                          pytest.approx(200e-9)]]
    assert [g[0] for g in b["idle_gaps"][2:]] == ["host", "decode_chunk"]


def test_spans_untraced_add_no_annotation():
    s = Spans(False)
    with s.span("a", n=3) as item:
        pass
    assert item["id"] == 0 and item["n"] == 3 and item["t1"] >= item["t0"]
    assert s.seconds("a") == item["t1"] - item["t0"]


@pytest.mark.cuda
def test_profile_reads_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    x = torch.randn(2048, 2048, device="cuda")
    s = Spans(True)
    p = Profile()
    p.start()
    with s.span("mm"):
        for _ in range(10):
            x = x @ x / 2048
    p.stop()
    assert p.busy_s > 0 and 0 < p.busy_s <= p.window_s
    assert p.span_ids(["mm"]) == [0]
    assert p.kernel_seconds([""], ids={0}) > 0


def test_kernel_seconds_by_span():
    p = fake_profile()
    assert p.kernel_seconds_by_span(["w4a8"], {0, 2}) == {
        0: pytest.approx(100e-9), 2: pytest.approx(100e-9)}
    # a span where no matching kernel ran is left out
    assert p.kernel_seconds_by_span(["flash_fwd"], {0, 2}) == {}


def test_k2_prefill_counts_the_groups_k2_served():
    from benchmark.harness import core
    from benchmark.roofline import counts

    files = core.cell_files("ds7b_longdoc_serve")
    spans = Spans(False)
    for b, bucket, lens in ((1, 2048, [2000]), (2, 3072, [3000, 2900])):
        with spans.span("prefill_group", b=b, bucket=bucket, p_lens=lens):
            pass
    p = Profile()
    p.window = (0, 1000)
    p.spans = [(100, 400, "prefill_group", 0), (500, 900, "prefill_group", 1)]
    # K2 in the first group only; the second took the W4A16 branch
    p.kernels = [(150, 350, "w4a8_mma<4>"), (550, 850, "nvjet_tst_gemm")]
    reader = core.load_module("metrics", "k2_roofline.prefill")
    got = reader.read(core.Readings(spans, p, {}, files))
    want = 100.0 * counts.k2_bound_s(files["config"], [2000]) / 200e-9
    assert got == pytest.approx(want)


def test_spans_from_two_threads_keep_their_ids():
    import threading

    s = Spans(False)

    def open_many():
        for _ in range(200):
            with s.span("x"):
                pass

    threads = [threading.Thread(target=open_many) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert [item["id"] for item in s.items] == list(range(800))
