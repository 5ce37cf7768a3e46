"""Speculative decoding through the port's entry points: ``comprehend``
and ``ground`` with ``spec_k`` against the JAX package's apps on the same
weights (the fp32 debug runtimes of ``tests/test_torch_slice.py``), and
``eval_cli --spec_k`` reaching the decode loop of every command the JAX
package's CLI passes it to (img2text, ground, text2img, edit, chat)."""

import io

import numpy as np
import pytest
import torch

from seedx_tpu.inference import apps as japps
from seedx_tpu_torch.inference import apps as tapps
from seedx_tpu_torch.inference import eval_cli
from seedx_tpu_torch.models import generation as tgen
from test_torch_slice import _image, runtimes  # noqa: F401

torch.set_num_threads(1)


@pytest.mark.parametrize("app", ["comprehend", "ground"])
def test_apps_with_spec_k_match_jax(runtimes, app):  # noqa: F811
    """The same reply as JAX's app with ``spec_k``, and as the port's
    greedy reply without it."""
    rt_j, rt_t = runtimes
    img = _image(120, 90, seed=120)
    q = "What is this? What is this?"
    want = getattr(japps, app)(rt_j, img, q, max_new_tokens=12, spec_k=4)
    got = getattr(tapps, app)(rt_t, img, q, max_new_tokens=12, spec_k=4)
    plain = getattr(tapps, app)(rt_t, img, q, max_new_tokens=12)
    assert got["text"] == want["text"] == plain["text"]
    assert [int(x) for x in got["tokens"]] == \
        [int(x) for x in want["tokens"]]
    assert got["spec_rounds"] > 0 and plain["spec_rounds"] == 0
    if app == "ground":
        assert got["boxes"] == want["boxes"]


def _spy_draft_lengths(monkeypatch):
    """The draft length of every decode loop run (its state's)."""
    seen = []
    base = tgen._decode_loop

    def loop(model, st, *a, **kw):
        seen.append(st.spec_k)
        return base(model, st, *a, **kw)

    monkeypatch.setattr(tgen, "_decode_loop", loop)
    return seen


@pytest.mark.parametrize("command", ["img2text", "ground", "text2img",
                                     "edit", "chat"])
def test_eval_cli_spec_k_reaches_decode(runtimes, monkeypatch,  # noqa: F811
                                        tmp_path, capsys, command):
    _, rt_t = runtimes
    monkeypatch.setattr(eval_cli, "_load_runtime", lambda a: rt_t)
    seen = _spy_draft_lengths(monkeypatch)
    img_path = tmp_path / "src.png"
    _image(60, 48, seed=4).save(img_path)
    argv = [command, "--debug", "--device", "cpu", "--max_new_tokens", "4",
            "--spec_k", "3", "--out_dir", str(tmp_path)]
    if command in ("img2text", "ground", "edit"):
        argv += ["--image", str(img_path)]
    if command == "chat":
        monkeypatch.setattr("sys.stdin", io.StringIO("hello there\nexit\n"))
    rc = eval_cli.main(argv)
    assert rc in (0, None)
    assert seen == [3], seen
    assert capsys.readouterr().out           # the reply was printed
