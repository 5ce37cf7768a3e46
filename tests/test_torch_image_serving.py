"""The port's image-out serving entry points on its debug runtime with
the debug adapter (random weights, CPU): a ``ServingEngine`` flush with a
t2i and an edit request, ``/v1/generate`` and ``/v1/chat`` over HTTP on
127.0.0.1, and ``eval_cli text2img / edit / detokenize``.  The random
debug agent emits no image span of its own, so the prompt templates are
patched to end in ``<img>``, which forces one (as ``chip_smoke.py`` does
with its ``<img>`` prompt).  Parity with the JAX package:
``tests/test_torch_image_out.py``.
"""

import ast
import base64
import io
import json
import threading
import urllib.request
from http.server import ThreadingHTTPServer

import numpy as np
import pytest
import torch
from PIL import Image

from seedx_tpu_torch.inference import apps as tapps
from seedx_tpu_torch.inference import eval_cli
from seedx_tpu_torch.inference.runtime import SeedXRuntime
from seedx_tpu_torch.inference.server import SeedXServer
from seedx_tpu_torch.inference.serving import ServingEngine
from seedx_tpu_torch.text import prompts as tprompts

torch.set_num_threads(1)

# new tokens that hold the debug agent's forced image span (its 256 output
# tokens and </img>)
SPAN_BUDGET = 260


def _image(h, w, seed):
    rng = np.random.default_rng(seed)
    return Image.fromarray((rng.random((h, w, 3)) * 255).astype(np.uint8))


@pytest.fixture(scope="module")
def rt():
    rt = SeedXRuntime.debug(dtype=torch.float32, device="cpu",
                            with_adapter=True)
    assert rt.agent_cfg.num_img_out_tokens + 1 <= SPAN_BUDGET
    return rt


@pytest.fixture
def forced_span(monkeypatch):
    """Prompt templates ending in ``<img>``: the agent then emits one
    image span (the forced 64-token chunk and ``</img>``)."""
    for name in ("GENERATION_PROMPT", "INSTRUCTION_PROMPT"):
        monkeypatch.setattr(tprompts, name,
                            getattr(tprompts, name) + "<img>")


def test_serving_flush_decodes_t2i_and_edit(rt, forced_span):
    """One flush, a t2i and an edit request (each forced to one span):
    each gets the image its own app call gives (the edit with its source
    image as the condition, gi 1.0's 2-branch CFG), and a comprehension
    request none.  The flush runs the batched agent loop, the apps the
    one-request loop, whose span features differ in summation order
    only."""
    src = _image(48, 64, 3)
    eng = ServingEngine(rt, max_new_tokens=SPAN_BUDGET, num_inference_steps=2,
                        seed=5, image_guidance_scale=1.0)
    eng.submit_text_to_image("a red bicycle")
    eng.submit_edit(src, "make it blue")
    eng.submit_raw({"input_ids": [rt.tokenizer.bos_token_id]
                    + rt.tokenizer.encode("hello")})
    t2i, edit, raw = eng.flush()
    assert raw["images"] is None
    want_t2i = tapps.text_to_image(rt, "a red bicycle", seed=5,
                                   num_inference_steps=2,
                                   max_new_tokens=SPAN_BUDGET)["images"]
    want_edit = tapps.edit_image(rt, src, "make it blue", seed=5,
                                 num_inference_steps=2, max_new_tokens=SPAN_BUDGET,
                                 image_guidance_scale=1.0)["images"]
    for got, want in ((t2i, want_t2i), (edit, want_edit)):
        assert got["has_img_output"] and got["images"].shape == (1, 64, 64, 3)
        np.testing.assert_allclose(got["images"], want, rtol=0, atol=1e-4)
    assert np.abs(t2i["images"] - edit["images"]).max() > 1e-3


def _post(url, path, payload):
    req = urllib.request.Request(url + path,
                                 data=json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=300) as r:
        return json.loads(r.read())


def test_http_generate_and_chat_return_images(rt, forced_span):
    server = SeedXServer(rt, max_new_tokens=SPAN_BUDGET, num_inference_steps=2)
    httpd = ThreadingHTTPServer(("127.0.0.1", 0), server.make_handler())
    t = threading.Thread(target=httpd.serve_forever, daemon=True)
    t.start()
    url = f"http://127.0.0.1:{httpd.server_address[1]}"
    try:
        gen = _post(url, "/v1/generate", {"caption": "a red bicycle"})
        chat = _post(url, "/v1/chat", {"session": "s", "message": "draw",
                                       "max_new_tokens": SPAN_BUDGET})
    finally:
        httpd.shutdown()
        httpd.server_close()
        server.shutdown()
        t.join(30)
    assert not t.is_alive()
    for reply in (gen, chat):
        assert len(reply["images"]) == 1
        png = Image.open(io.BytesIO(base64.b64decode(reply["images"][0])))
        assert png.size == (64, 64) and png.mode == "RGB"


@pytest.mark.parametrize("command", ["text2img", "edit", "detokenize"])
def test_eval_cli_image_commands(rt, forced_span, monkeypatch, tmp_path,
                                 capsys, command):
    monkeypatch.setattr(eval_cli, "_load_runtime", lambda a: rt)
    src = tmp_path / "src.png"
    _image(60, 48, 4).save(src)
    extra = {"text2img": [], "edit": ["--image", str(src)],
             "detokenize": ["--image", str(src), "--condition", str(src)]}
    assert eval_cli.main([command, "--debug", "--device", "cpu",
                          "--max_new_tokens", str(SPAN_BUDGET),
                          "--num_inference_steps", "2",
                          "--out_dir", str(tmp_path / "vis")]
                         + extra[command]) == 0
    saved = capsys.readouterr().out.splitlines()[-1]
    assert saved.startswith("saved: ")
    (path,) = ast.literal_eval(saved[len("saved: "):])
    assert Image.open(path).size == (64, 64)
