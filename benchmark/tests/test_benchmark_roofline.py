"""The roofline counts against hand-checked bounds (the PR 6-9 kernel
table's), and the whole-step shares bounded by 100% of the counted work."""

import pytest

from benchmark.harness import core
from benchmark.roofline import counts

AGENT = core.cell_files("ds7b_vqa_serve")["config"]
SDXL = core.cell_files("sdxl_t2i_1024")["config"]


def ms(x):
    return round(x * 1e3, 4)


def test_k2_rows_1_by_bytes():
    # 5120 -> 5120 at one row: codes, scales and the row read once
    ops, nbytes = counts.int4_call(1, 5120, 5120, 128)
    assert ms(counts.bound_s(ops, nbytes, "int8_ops_per_s")) == 0.0042
    assert nbytes / counts.peaks()["hbm_bytes_per_s"] > \
        ops / counts.peaks()["int8_ops_per_s"]
    ops, nbytes = counts.int4_call(1, 5120, 13824, 128)
    assert ms(counts.bound_s(ops, nbytes, "int8_ops_per_s")) == 0.0112


def test_k2_rows_512_by_ops():
    ops, nbytes = counts.int4_call(512, 5120, 5120, 128)
    assert ms(counts.bound_s(ops, nbytes, "int8_ops_per_s")) == 0.0136


def test_k1_unet_rows_by_ops():
    assert ms(counts.bound_s(*counts.self_attn(2, 4096, 640),
                             "bf16_flops_per_s")) == 0.0869
    assert ms(counts.bound_s(*counts.self_attn(2, 1024, 1280),
                             "bf16_flops_per_s")) == 0.0109


def test_unet_self_attention_calls():
    # 70 calls an eval at SDXL base: 2 x 5 + 10 x 5 + 10 (mid) blocks
    ops, _ = counts.unet_self_attn(SDXL, 2)
    per_level = (counts.self_attn(2, 4096, 640)[0] * 2 * 5
                 + counts.self_attn(2, 1024, 1280)[0] * 10 * 6)
    assert ops == pytest.approx(per_level)


def test_unet_ops_in_published_range():
    # SDXL's UNet at 1024^2 is ~6.7 TFLOP a forward of one image; its
    # VAE decoder ~10 TFLOP (three 3x3 convs a resnet pair at each of
    # 128^2 x 512, 256^2 x 512, 512^2 x 256, 1024^2 x 128, ~0.3 TFLOP each)
    assert 5.5e12 < counts.unet_ops(SDXL, 1) < 8e12
    assert 8e12 < counts.vae_decoder_ops(SDXL) < 12e12


def test_kernel_patterns_from_files():
    assert "w4a8_mma" in counts.kernel_patterns("k2")
    assert counts.kernel_patterns("k1") == ["flash_fwd_kernel"]
    assert counts.kernel_patterns("nothing") == []


@pytest.mark.parametrize("tokens,kv", [(1, 300), (16, 16 * 900),
                                       (16, 16 * 1400), (128, 128 * 4000)])
def test_decode_share_under_its_bounds(tokens, kv):
    """The step's least time counts only operations at their peaks, so it
    is no larger than the sum of the kernels' bounds (which also count
    bytes): no run can read mfu above 100%."""
    steps = 1
    k2 = counts.k2_bound_s(AGENT, [tokens / steps] * steps)
    k3 = counts.k3_bound_s(AGENT, tokens, kv)
    head = counts.bound_s(2.0 * tokens * 4096 * 102400, 4096 * 102400,
                          "bf16_flops_per_s")
    assert counts.decode_least_s(AGENT, tokens, kv) <= \
        (k2 + k3 + head) * (1 + 1e-12)


@pytest.mark.parametrize("p_lens", [[200], [900, 700, 1000], [3000]])
def test_prefill_share_under_its_bounds(p_lens):
    k2 = counts.k2_bound_s(AGENT, [sum(p_lens)])
    k1 = counts.k1_prefill_bound_s(AGENT, [p_lens])
    head = counts.bound_s(2.0 * len(p_lens) * 4096 * 102400, 0,
                          "bf16_flops_per_s")
    res = sum(counts.bound_s(counts.resampler_ops(256, 64, 4096, 4096), 0,
                             "bf16_flops_per_s") for _ in range(3))
    assert counts.prefill_least_s(AGENT, p_lens, 3) <= \
        (k2 + k1 + head + res) * (1 + 1e-12)


def test_mfu_readers_at_their_least_time():
    """A span that lasts exactly the least time reads 100%."""
    from benchmark.harness.trace import Spans

    spans = Spans(False)
    with spans.span("decode_chunk", steps=4, tokens=64,
                    kv_positions=64 * 500) as s:
        pass
    s["t1"] = s["t0"] + counts.decode_least_s(AGENT, 64, 64 * 500)
    files = core.cell_files("ds7b_vqa_serve")
    r = core.Readings(spans, None, {}, files)
    assert core.load_module("metrics", "mfu.decode").read(r) == \
        pytest.approx(100.0)
    spans = Spans(False)
    with spans.span("image") as s:
        pass
    s["t1"] = s["t0"] + counts.image_least_s(SDXL)
    r = core.Readings(spans, None, {}, core.cell_files("sdxl_t2i_1024"))
    assert core.load_module("metrics", "mfu.t2i").read(r) == \
        pytest.approx(100.0)
