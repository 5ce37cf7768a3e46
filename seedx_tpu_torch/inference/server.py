"""HTTP serving front-end for the port (stdlib only; reference:
seedx_tpu/inference/server.py).

Endpoints (JSON bodies; images travel as base64 PNG/JPEG):

  GET  /healthz                   -> {"ok": true}
  GET  /v1/stats                  -> server counters
  POST /v1/comprehend  {"image"?, "question", "prompt_style"?}
  POST /v1/ground      {"image", "question", "max_new_tokens"?}
  POST /v1/generate    {"caption"}
  POST /v1/edit        {"image", "instruction"}
  POST /v1/raw         {"input_ids": [...]}           (pre-tokenized)
  POST /v1/chat        {"session", "message", "image"?, "max_new_tokens"?,
                        "num_inference_steps"?, "seed"?}

``/v1/generate``, ``/v1/edit`` and ``/v1/chat`` answer with their text and
``images``: a list of base64 PNGs when the reply holds image spans and the
runtime has an SDXL adapter, else null.  Chat replies carry ``session``
too.  Each chat session owns a KV prefix cache on the device
(``inference/chat.py``); at most ``max_sessions`` live at once, the least
recently used evicted first.

Threading model: one dispatcher thread owns every device call.  HTTP
handler threads enqueue jobs and wait on a per-job event.  Everything
queued at dispatch time that ``ServingEngine`` understands (comprehend /
generate / edit / raw) is flushed as one batch, so concurrent clients are
micro-batched; ground jobs run one at a time between batches.  A bad
request fails only its own job, with a 400.

    python -m seedx_tpu_torch.inference.server --debug --device cpu
"""

from __future__ import annotations

import base64
import io
import json
import queue
import threading
from collections import OrderedDict
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, List, Optional

import numpy as np

__all__ = ["SeedXServer", "main"]

_BATCHABLE = {"comprehend", "generate", "edit", "raw"}


def _decode_image(b64: str):
    from PIL import Image

    return Image.open(io.BytesIO(base64.b64decode(b64))).convert("RGB")


def _encode_images(images) -> Optional[List[str]]:
    """[N, H, W, 3] float array in [0, 1] -> base64 PNGs (None stays
    None)."""
    if images is None:
        return None
    from PIL import Image

    out = []
    for img in np.asarray(images):
        buf = io.BytesIO()
        Image.fromarray((np.clip(img, 0.0, 1.0) * 255).astype(np.uint8)
                        ).save(buf, format="PNG")
        out.append(base64.b64encode(buf.getvalue()).decode("ascii"))
    return out


class _Job:
    __slots__ = ("kind", "payload", "done", "result", "error", "status")

    def __init__(self, kind: str, payload: Dict[str, Any]):
        self.kind = kind
        self.payload = payload
        self.done = threading.Event()
        self.result: Optional[Dict[str, Any]] = None
        self.error: Optional[str] = None
        self.status = 200


class SeedXServer:
    """Dispatcher + HTTP plumbing around one ``SeedXRuntime``."""

    def __init__(self, rt, max_batch_size: int = 8,
                 max_new_tokens: int = 512, num_inference_steps: int = 30,
                 request_timeout: float = 600.0, max_sessions: int = 8):
        """``max_sessions`` bounds the live chat sessions (LRU eviction):
        each holds a preallocated KV cache on the device.
        ``num_inference_steps``: the SDXL steps of generated images."""
        from seedx_tpu_torch.inference.serving import ServingEngine

        self.rt = rt
        self.engine = ServingEngine(rt, max_batch_size=max_batch_size,
                                    max_new_tokens=max_new_tokens,
                                    num_inference_steps=num_inference_steps)
        self.request_timeout = request_timeout
        self._queue: "queue.Queue[Optional[_Job]]" = queue.Queue()
        self._sessions: "OrderedDict[str, Any]" = OrderedDict()
        self._max_sessions = max(1, max_sessions)
        self._served = 0
        self._errors = 0
        self._batches = 0
        self._lock = threading.Lock()
        self._dispatcher = threading.Thread(target=self._dispatch_loop,
                                            daemon=True)
        self._dispatcher.start()

    # ---- dispatcher (the only thread that touches the device) ----------

    def _dispatch_loop(self):
        while True:
            job = self._queue.get()
            if job is None:
                return
            batch = [job]
            while True:                      # opportunistic micro-batching
                try:
                    nxt = self._queue.get_nowait()
                except queue.Empty:
                    break
                if nxt is None:
                    self._queue.put(None)    # re-arm shutdown
                    break
                batch.append(nxt)
            batchable = [j for j in batch if j.kind in _BATCHABLE]
            singles = [j for j in batch if j.kind not in _BATCHABLE]
            if batchable:
                self._run_batch(batchable)
            for j in singles:
                self._run_single(j)

    def _finish(self, job: _Job, result=None, error=None, status=500):
        with self._lock:
            if error is not None:
                job.error, job.status = error, status
                self._errors += 1
            else:
                job.result = result
                self._served += 1
        job.done.set()

    def _submit_to_engine(self, job: _Job) -> None:
        eng, p = self.engine, job.payload
        if job.kind == "comprehend":
            if p.get("image"):
                eng.submit_comprehend(
                    _decode_image(p["image"]), p["question"],
                    prompt_style=p.get("prompt_style", "instruct"))
                return
            from seedx_tpu_torch.text import prompts

            if p.get("prompt_style") == "pretrain":
                text = prompts.PRETRAIN_QA_PROMPT.format(
                    question=p["question"])
            else:
                text = prompts.INSTRUCTION_PROMPT.format(
                    instruction=p["question"])
            tok = self.rt.tokenizer
            eng.submit_raw({"input_ids": [tok.bos_token_id]
                            + tok.encode(text)})
        elif job.kind == "generate":
            eng.submit_text_to_image(p["caption"])
        elif job.kind == "edit":
            eng.submit_edit(_decode_image(p["image"]), p["instruction"])
        else:                                # raw
            ids = [int(i) for i in p["input_ids"]]
            if not ids:
                raise ValueError("input_ids is empty")
            eng.submit_raw({"input_ids": ids})

    def _run_batch(self, jobs: List[_Job]):
        live: List[_Job] = []
        for j in jobs:
            try:
                self._submit_to_engine(j)
                live.append(j)
            except Exception as e:  # a bad request fails THIS job only
                self._finish(j, error=f"{type(e).__name__}: {e}", status=400)
        if not live:
            return
        try:
            results = self.engine.flush()
        except Exception as e:
            for j in live:
                self._finish(j, error=f"{type(e).__name__}: {e}")
            return
        with self._lock:
            self._batches += 1
        # flush returns submission order == live order (engine was drained)
        for j, out in zip(live, results[-len(live):]):
            self._finish(j, result={
                "text": out.get("clean_text", out.get("text", "")),
                "images": _encode_images(out.get("images")),
                "has_img_output": bool(out.get("has_img_output")),
            })

    def _run_chat(self, job: _Job):
        from seedx_tpu_torch.inference.chat import ChatSession

        p = job.payload
        try:
            sid, message = str(p["session"]), p["message"]
            image = _decode_image(p["image"]) if p.get("image") else None
        except KeyError as e:
            return self._finish(job, error=f"missing field {e}", status=400)
        except (ValueError, OSError) as e:   # not base64 / not an image
            return self._finish(job, error=f"bad image: {e}", status=400)
        try:
            sess = self._sessions.get(sid)
            if sess is None:
                # evict before allocating: a session's KV cache is device
                # memory, never freed implicitly
                while len(self._sessions) >= self._max_sessions:
                    self._sessions.popitem(last=False)
                sess = self._sessions[sid] = ChatSession(self.rt)
            else:
                self._sessions.move_to_end(sid)
            out = sess.send(message, image=image,
                            max_new_tokens=p.get("max_new_tokens", 512),
                            num_inference_steps=p.get(
                                "num_inference_steps",
                                self.engine.num_inference_steps),
                            seed=p.get("seed", 42),
                            spec_k=p.get("spec_k", 0))
        except Exception as e:
            return self._finish(job, error=f"{type(e).__name__}: {e}")
        self._finish(job, result={"session": sid, "text": out["text"],
                                  "images": _encode_images(out["images"])})

    def _run_single(self, job: _Job):
        from seedx_tpu_torch.inference import apps

        p = job.payload
        if job.kind == "chat":
            return self._run_chat(job)
        if job.kind != "ground":
            return self._finish(job, error=f"unknown kind {job.kind}",
                                status=400)
        try:
            image = _decode_image(p["image"])
            question = p["question"]
        except KeyError as e:
            return self._finish(job, error=f"missing field {e}", status=400)
        except (ValueError, OSError) as e:   # not base64 / not an image
            return self._finish(job, error=f"bad image: {e}", status=400)
        try:
            out = apps.ground(self.rt, image, question,
                              max_new_tokens=p.get("max_new_tokens", 512))
        except Exception as e:
            return self._finish(job, error=f"{type(e).__name__}: {e}")
        boxes_img = None
        if out.get("boxes_image") is not None:
            buf = io.BytesIO()
            out["boxes_image"].save(buf, format="PNG")
            boxes_img = base64.b64encode(buf.getvalue()).decode("ascii")
        self._finish(job, result={"text": out["clean_text"],
                                  "boxes_pixels": out.get("boxes_pixels"),
                                  "boxes_image": boxes_img})

    # ---- public API ----------------------------------------------------

    def submit(self, kind: str, payload: Dict[str, Any]) -> _Job:
        job = _Job(kind, payload)
        self._queue.put(job)
        return job

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            return {"served": self._served, "errors": self._errors,
                    "batches": self._batches,
                    "queued": self._queue.qsize(),
                    "chat_sessions": len(self._sessions)}

    def shutdown(self, timeout: float = 60.0):
        """Stop the dispatcher after the jobs already queued."""
        self._queue.put(None)
        self._dispatcher.join(timeout)

    # ---- HTTP ----------------------------------------------------------

    def make_handler(self):
        server = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, fmt, *args):  # quiet by default
                pass

            def _reply(self, status: int, obj: Dict[str, Any]):
                body = json.dumps(obj).encode()
                self.send_response(status)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                if self.path == "/healthz":
                    self._reply(200, {"ok": True})
                elif self.path == "/v1/stats":
                    self._reply(200, server.stats())
                else:
                    self._reply(404, {"error": "not found"})

            def do_POST(self):
                kinds = {"/v1/comprehend": "comprehend",
                         "/v1/ground": "ground",
                         "/v1/generate": "generate",
                         "/v1/edit": "edit",
                         "/v1/raw": "raw",
                         "/v1/chat": "chat"}
                kind = kinds.get(self.path)
                if kind is None:
                    return self._reply(404, {"error": "not found"})
                try:
                    n = int(self.headers.get("Content-Length", 0))
                    payload = json.loads(self.rfile.read(n) or b"{}")
                except ValueError as e:
                    return self._reply(400, {"error": f"bad json: {e}"})
                if not isinstance(payload, dict):
                    return self._reply(400, {"error": "body must be a JSON "
                                                      "object"})
                job = server.submit(kind, payload)
                if not job.done.wait(server.request_timeout):
                    return self._reply(504, {"error": "timeout"})
                if job.error is not None:
                    return self._reply(job.status, {"error": job.error})
                self._reply(200, job.result)

        return Handler

    def warmup(self) -> "SeedXServer":
        """The engine's decode programs built before the first request
        (``ServingEngine.warmup``).  Returns ``self``."""
        self.engine.warmup()
        return self

    def serve_forever(self, host: str = "127.0.0.1", port: int = 8000):
        self.warmup()
        httpd = ThreadingHTTPServer((host, port), self.make_handler())
        print(f"seedx_tpu_torch server on http://{host}:{port}", flush=True)
        try:
            httpd.serve_forever()
        finally:
            httpd.server_close()
            self.shutdown()


def main(argv=None):
    import argparse
    import os

    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8000)
    p.add_argument("--max_batch_size", type=int, default=8)
    p.add_argument("--max_new_tokens", type=int, default=512)
    p.add_argument("--num_inference_steps", type=int, default=30)
    p.add_argument("--debug", action="store_true",
                   help="tiny random debug stack with the debug SDXL "
                        "adapter (SEEDX_DEBUG)")
    p.add_argument("--device", default="cuda",
                   help="torch device of the runtime (default: the card)")
    args = p.parse_args(argv)

    from seedx_tpu_torch.inference.runtime import SeedXRuntime

    if not (args.debug or os.environ.get("SEEDX_DEBUG") in ("1", "True")):
        raise SystemExit(
            "non-debug runtime requires released checkpoints, which the "
            "port cannot load yet; pass --debug (or SEEDX_DEBUG=1), or "
            "embed SeedXServer around a runtime built with "
            "SeedXRuntime.random()")
    rt = SeedXRuntime.debug(device=args.device, with_adapter=True)
    SeedXServer(rt, max_batch_size=args.max_batch_size,
                max_new_tokens=args.max_new_tokens,
                num_inference_steps=args.num_inference_steps
                ).serve_forever(args.host, args.port)


if __name__ == "__main__":
    main()
