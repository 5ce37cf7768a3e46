"""The control of each cell comes out not correct: the reference one
precision below the configuration (the serving cells: int4 activations
and KV cache for the stated int8; text to image: fp8 for the bf16 stages,
bf16 for the fp32 ones) reads past a limit that sound runs stay under, on
three seeds, at debug widths.  On the card at the cells' own sizes:
benchmark/tools/readings.py."""

import pytest
import torch

from benchmark.tests import tiny


@pytest.mark.parametrize("cell", ["ds7b_longdoc_serve", "ds7b_vqa_serve"])
@pytest.mark.parametrize("seed", [2**31 + 3, 2**31 + 40, 2**33 + 7])
def test_serving_control_fails_where_the_program_passes(seed, cell):
    f = tiny.agent_files(cell)
    from benchmark.harness import core

    d = core.load_module("drivers", "serve").Driver(
        f, seed=seed, device=torch.device("cpu"), rate=4.0, seconds=2.0)
    with tiny.few_threads():
        d.setup()
        d.window(2.0, False)
        d.release()
        checks = {c["name"]: c for c in d.check()}
        control = {c["name"]: c["value"] for c in d.control()}["token_gap"]
    program = checks["token_gap"]["value"]
    limit = checks["token_gap"]["limit"]
    assert checks["unfinished"]["value"] == 0
    assert program <= limit < control
    assert control >= 3 * program


@pytest.mark.parametrize("seed", [2**31 + 5, 2**32 + 1, 77])
def test_image_control_fails_where_the_program_passes(seed):
    """At these widths the control fails the Euler step and the image
    (each stage one precision below: the step and the VAE in bf16) and
    reads above the program on the conditioning and the noise
    prediction (the ViT, ResamplerXL and the UNet in fp8)."""
    from benchmark.harness import core

    f = tiny.sdxl_files()
    d = core.load_module("drivers", "t2i").Driver(
        f, seed=seed, device=torch.device("cpu"), seconds=1.0)
    with tiny.few_threads():
        d.setup()
        d.window(1.0, False)
        d.release()
        checks = {c["name"]: c for c in d.check()}
        control = {c["name"]: c["value"] for c in d.control()}
    for name, c in checks.items():
        assert c["value"] <= c["limit"], name
        assert control[name] > 2 * c["value"], name
    for name in ("step", "image"):
        assert control[name] > checks[name]["limit"]
