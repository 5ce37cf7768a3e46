"""``utils/image_metrics.py`` of the port against the JAX package's module
(numpy / scipy / PIL in both), within 1e-12, on float arrays, uint8 arrays
and PIL images, with and without the resize to the reference's size; and
``eval_cli ... --score_against``: the port's CLI prints the ``fidelity:``
line the JAX package's CLI prints for the same image."""

import json

import numpy as np
import pytest
import torch
from PIL import Image

from seedx_tpu.inference import apps as japps
from seedx_tpu.inference import eval_cli as jcli
from seedx_tpu.utils import image_metrics as jm
from seedx_tpu_torch.inference import apps as tapps
from seedx_tpu_torch.inference import eval_cli as tcli
from seedx_tpu_torch.utils import image_metrics as tm

torch.set_num_threads(1)


def _pair(kind, rng, resize):
    a = rng.random((48, 40, 3))
    b = np.clip(a + 0.1 * rng.standard_normal(a.shape), 0, 1)
    if resize:
        b = rng.random((32, 24, 3))
    if kind == "float":
        return a, b
    a8, b8 = ((x * 255).astype(np.uint8) for x in (a, b))
    if kind == "uint8":
        return a8, b8
    return Image.fromarray(a8), Image.fromarray(b8)


@pytest.mark.parametrize("resize", [False, True])
@pytest.mark.parametrize("kind", ["float", "uint8", "pil"])
def test_metrics_match_jax(kind, resize):
    a, b = _pair(kind, np.random.default_rng(3), resize)
    for name in ("mse", "psnr", "ssim"):
        got, want = getattr(tm, name)(a, b), getattr(jm, name)(a, b)
        assert abs(got - want) <= 1e-12 * max(1.0, abs(want)), name
    assert tm.score_images(a, b) == jm.score_images(a, b)
    assert tm.psnr(a, a) == jm.psnr(a, a) == float("inf")
    assert tm.lpips_available() == jm.lpips_available()
    assert tm.score_images(a, b)["lpips"] is None or tm.lpips_available()


def _fidelity(out: str) -> dict:
    lines = [ln for ln in out.splitlines() if ln.startswith("fidelity:")]
    assert len(lines) == 1, out
    return json.loads(lines[0][len("fidelity:"):])


def test_score_against_line_matches_jax_cli(tmp_path, monkeypatch, capsys):
    rng = np.random.default_rng(4)
    src, ref = tmp_path / "src.png", tmp_path / "ref.png"
    Image.fromarray((rng.random((60, 50, 3)) * 255).astype(np.uint8)).save(
        src)
    Image.fromarray((rng.random((80, 64, 3)) * 255).astype(np.uint8)).save(
        ref)
    argv = ["detokenize", "--debug", "--image", str(src), "--score_against",
            str(ref), "--num_inference_steps", "2"]

    # the port's debug stack on the CPU, its image kept as it is scored
    kept = []
    real = tapps.reconstruct

    def keep(*a, **kw):
        kept.append(real(*a, **kw))
        return kept[-1]

    monkeypatch.setattr(tapps, "reconstruct", keep)
    assert tcli.main(argv + ["--device", "cpu", "--out_dir",
                             str(tmp_path / "t")]) == 0
    got = _fidelity(capsys.readouterr().out)
    image = np.asarray(kept[0])[0]
    assert got == jm.score_images(Image.open(ref).convert("RGB"), image)

    # the JAX CLI given that image: the same line
    monkeypatch.setattr(jcli, "_load_runtime", lambda args: None)
    monkeypatch.setattr(japps, "reconstruct",
                        lambda *a, **kw: np.asarray(kept[0]))
    assert jcli.main(argv + ["--out_dir", str(tmp_path / "j")]) in (0, None)
    assert _fidelity(capsys.readouterr().out) == got
