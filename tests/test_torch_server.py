"""The port's HTTP front-end (``seedx_tpu_torch/inference/server.py``)
over real HTTP on 127.0.0.1, ``eval_cli serve`` with both engines and
``eval_cli chat``, against the tiny debug runtime on the CPU."""

import base64
import io
import json
import threading
import urllib.error
import urllib.request
from http.server import ThreadingHTTPServer

import numpy as np
import pytest
import torch
from PIL import Image

from seedx_tpu_torch.inference import eval_cli
from seedx_tpu_torch.inference.runtime import SeedXRuntime
from seedx_tpu_torch.inference.server import SeedXServer

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def served():
    rt = SeedXRuntime.debug(device="cpu")
    server = SeedXServer(rt, max_new_tokens=4, request_timeout=300.0)
    httpd = ThreadingHTTPServer(("127.0.0.1", 0), server.make_handler())
    t = threading.Thread(target=httpd.serve_forever, daemon=True)
    t.start()
    yield server, f"http://127.0.0.1:{httpd.server_address[1]}"
    httpd.shutdown()
    httpd.server_close()
    server.shutdown()
    t.join(30)
    assert not t.is_alive() and not server._dispatcher.is_alive()


def _post(url, path, payload, raw=None):
    data = raw if raw is not None else json.dumps(payload).encode()
    req = urllib.request.Request(url + path, data=data,
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=300) as r:
        return json.loads(r.read())


def _get(url, path):
    with urllib.request.urlopen(url + path, timeout=30) as r:
        return json.loads(r.read())


def _image_b64(seed=0):
    rng = np.random.default_rng(seed)
    img = Image.fromarray((rng.random((72, 56, 3)) * 255).astype(np.uint8))
    buf = io.BytesIO()
    img.save(buf, format="PNG")
    return base64.b64encode(buf.getvalue()).decode("ascii")


def test_healthz_and_stats(served):
    _, url = served
    assert _get(url, "/healthz") == {"ok": True}
    assert {"served", "errors", "batches", "queued", "chat_sessions"} <= _get(
        url, "/v1/stats").keys()


def test_comprehend_raw_ground_generate(served):
    _, url = served
    out = _post(url, "/v1/comprehend",
                {"image": _image_b64(), "question": "What is this?"})
    assert isinstance(out["text"], str) and out["images"] is None
    assert isinstance(_post(url, "/v1/comprehend",
                            {"question": "Hello?"})["text"], str)
    assert isinstance(_post(url, "/v1/raw",
                            {"input_ids": [1, 2, 3]})["text"], str)
    ground = _post(url, "/v1/ground", {"image": _image_b64(1),
                                       "question": "Where is the cat?"})
    assert isinstance(ground["text"], str) and "boxes_pixels" in ground
    gen = _post(url, "/v1/generate", {"caption": "a red car"})
    assert gen["images"] is None and "has_img_output" in gen


def test_concurrent_requests_micro_batch(served, monkeypatch):
    """Requests that queue while the dispatcher is busy are flushed as one
    batch: hold the first flush until three more requests are queued."""
    server, url = served
    entered, gate = threading.Event(), threading.Event()
    flush = server.engine.flush

    def held_flush():
        entered.set()
        assert gate.wait(60)
        return flush()

    monkeypatch.setattr(server.engine, "flush", held_flush)
    before = server.stats()
    results = {}

    def hit(i):
        results[i] = _post(url, "/v1/comprehend",
                           {"question": f"Question {i}?"})

    threads = [threading.Thread(target=hit, args=(0,))]
    threads[0].start()
    assert entered.wait(60)     # the dispatcher holds the first job
    threads += [threading.Thread(target=hit, args=(i,)) for i in (1, 2, 3)]
    for t in threads[1:]:
        t.start()
    for _ in range(600):
        if server.stats()["queued"] == 3:
            break
        threading.Event().wait(0.05)
    assert server.stats()["queued"] == 3
    gate.set()
    for t in threads:
        t.join(300)
        assert not t.is_alive()
    assert sorted(results) == [0, 1, 2, 3]
    after = server.stats()
    assert after["served"] - before["served"] == 4
    assert after["batches"] - before["batches"] == 2    # 1 + the other 3


def test_bad_requests_fail_without_killing_server(served):
    _, url = served
    for path, payload, raw in (
            ("/v1/edit", {"instruction": "no image supplied"}, None),
            ("/v1/comprehend", None, b"{not json"),
            ("/v1/ground", {"question": "no image"}, None),
            ("/v1/raw", {"input_ids": []}, None),
            ("/v1/chat", {"session": "bad"}, None),
            ("/v1/chat", {"session": "bad", "message": "hi",
                          "image": "not base64!"}, None)):
        with pytest.raises(urllib.error.HTTPError) as e:
            _post(url, path, payload, raw)
        assert e.value.code == 400, path
    with pytest.raises(urllib.error.HTTPError) as e:
        _post(url, "/v1/nope", {"session": "s1", "message": "hi"})
    assert e.value.code == 404
    assert _get(url, "/healthz") == {"ok": True}
    assert isinstance(_post(url, "/v1/raw", {"input_ids": [1, 2]})["text"],
                      str)


def test_serve_cli_both_engines(tmp_path, monkeypatch, capsys):
    """`eval_cli serve`: JSONL requests in, JSONL results out, for the
    bucket-batched and the continuous engine, with the same texts."""
    shared = SeedXRuntime.debug(device="cpu", dtype=torch.float32)
    monkeypatch.setattr(eval_cli, "_load_runtime", lambda a: shared)
    img_path = tmp_path / "src.png"
    rng = np.random.default_rng(2)
    Image.fromarray((rng.random((60, 48, 3)) * 255).astype(np.uint8)).save(
        img_path)
    reqs = [{"kind": "raw", "text": "hello"},
            {"kind": "t2i", "caption": "a cat"},
            {"kind": "comprehend", "image": str(img_path),
             "question": "what?"},
            {"kind": "edit", "image": str(img_path),
             "instruction": "make it blue"}]
    f = tmp_path / "reqs.jsonl"
    f.write_text("\n".join(json.dumps(r) for r in reqs) + "\n")

    per_engine = {}
    for engine in ("batched", "continuous"):
        rc = eval_cli.main(["serve", "--requests", str(f), "--engine",
                            engine, "--debug", "--device", "cpu",
                            "--max_new_tokens", "6", "--slots", "2"])
        assert rc == 0
        rows = [json.loads(ln)
                for ln in capsys.readouterr().out.strip().splitlines()]
        assert [r["id"] for r in rows] == [0, 1, 2, 3]
        per_engine[engine] = rows
    for a, b in zip(per_engine["batched"], per_engine["continuous"]):
        assert a["text"] == b["text"]
        assert a["num_gen_imgs"] == b["num_gen_imgs"]
        assert a["images"] is None and b["images"] is None


def test_chat_session_persists(served):
    """Two POSTs on one session: the second turn extends the first's
    history and reuses its KV prefix; the session is counted in stats."""
    server, url = served
    before = _get(url, "/v1/stats")["chat_sessions"]
    first = _post(url, "/v1/chat", {"session": "persist", "message": "hi",
                                    "image": _image_b64(3),
                                    "max_new_tokens": 3})
    second = _post(url, "/v1/chat", {"session": "persist",
                                     "message": "and then?",
                                     "max_new_tokens": 3})
    for r in (first, second):
        assert r["session"] == "persist" and isinstance(r["text"], str)
        assert r["images"] is None
    sess = server._sessions["persist"]
    assert len(sess.turns) == 4 and sess.last_reused > 0
    assert _get(url, "/v1/stats")["chat_sessions"] == before + 1


def test_chat_spec_k(served):
    """``/v1/chat`` with ``spec_k``: the session decodes with speculation
    (its decode state drafts 4 ids a round) and replies as a session run
    directly with the same ``spec_k`` does, turn for turn."""
    from seedx_tpu_torch.inference.chat import ChatSession

    server, url = served
    direct = ChatSession(server.rt, prefix_cache=True)
    for text in ("hi hi hi hi", "and hi again"):
        got = _post(url, "/v1/chat", {"session": "spec", "message": text,
                                      "max_new_tokens": 4, "spec_k": 4})
        want = direct.send(text, max_new_tokens=4, spec_k=4)
        assert got["text"] == want["text"]
    sess = server._sessions["spec"]
    assert sess._decode.spec_k == 4 and int(sess._decode.sp[0]) > 0
    assert sess.last_reused > 0


def test_chat_sessions_evict_least_recently_used(served):
    rt = served[0].rt
    server = SeedXServer(rt, max_new_tokens=2, max_sessions=2)
    try:
        for sid in ("a", "b", "a", "c"):
            job = server.submit("chat", {"session": sid, "message": "hi",
                                         "max_new_tokens": 2})
            assert job.done.wait(300) and job.error is None, job.error
        # "b" was the least recently used when "c" arrived
        assert list(server._sessions) == ["a", "c"]
        assert server.stats()["chat_sessions"] == 2
    finally:
        server.shutdown()


def test_chat_cli(tmp_path, monkeypatch, capsys):
    """`eval_cli chat`: one reply per stdin turn, an image attached with
    ``img:PATH``, ``exit`` ends the session."""
    shared = SeedXRuntime.debug(device="cpu", dtype=torch.float32)
    monkeypatch.setattr(eval_cli, "_load_runtime", lambda a: shared)
    img_path = tmp_path / "src.png"
    rng = np.random.default_rng(4)
    Image.fromarray((rng.random((60, 48, 3)) * 255).astype(np.uint8)).save(
        img_path)
    monkeypatch.setattr("sys.stdin", io.StringIO(
        f"img:{img_path} what is this?\n\nand now?\nexit\nnever read\n"))
    assert eval_cli.main(["chat", "--debug", "--device", "cpu",
                          "--max_new_tokens", "3"]) == 0
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("chat ready")
    assert len(out) == 3                    # two replies, "exit" stopped it
