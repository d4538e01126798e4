"""Minimal HTTP serving front-end over the DynamicBatcher (stdlib only).

Counterpart of ``safe_denoiser_tpu/serving/server.py``. Endpoints:
  GET  /healthz              -> 200 {"status": "ok", "batch_size": B}
  POST /generate             -> JSON {"image_png_base64": ..., "seed": ...,
                                      "guidance_scale": ...}
     body: JSON {"prompt": str, "seed": int?, "guidance_scale": float?}

Images return as base64 PNG (the port's own encoder, ``data.images``) so
any client (curl, requests) can consume them without multipart handling.
The server threads only enqueue into the batcher -- the single batcher
worker owns the device, so concurrent HTTP requests batch onto the GPU
instead of serializing.
"""

from __future__ import annotations

import base64
import json
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

from ..data.images import encode_png
from .batcher import DynamicBatcher, GenRequest


def _png_bytes(img_uint8) -> bytes:
    return encode_png(np.asarray(img_uint8))


def make_server(batcher: DynamicBatcher, host: str = "127.0.0.1",
                port: int = 8000, request_timeout_s: float = 600.0,
                logger=None,
                default_guidance: float = 7.5) -> ThreadingHTTPServer:
    """Build (not start) the HTTP server; call ``serve_forever()`` on it.

    Kept separate from serve-loop startup so tests can drive it on an
    ephemeral port in a thread and shut it down deterministically.
    """

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *args):  # route through our logger
            if logger is not None:
                logger.log("http: " + fmt % args)

        def _send(self, code: int, payload: dict) -> None:
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/healthz":
                self._send(200, {"status": "ok",
                                 "batch_size": batcher.batch_size})
            else:
                self._send(404, {"error": "unknown path"})

        def do_POST(self):
            if self.path != "/generate":
                self._send(404, {"error": "unknown path"})
                return
            try:
                n = int(self.headers.get("Content-Length", "0"))
                req = json.loads(self.rfile.read(n) or b"{}")
                prompt = req["prompt"]
            except (KeyError, ValueError, json.JSONDecodeError) as e:
                self._send(400, {"error": f"bad request: {e}"})
                return
            gen = GenRequest(prompt=str(prompt),
                             seed=int(req.get("seed", 42)),
                             guidance_scale=float(
                                 req.get("guidance_scale",
                                         default_guidance)))
            try:
                img = batcher.submit(gen).result(timeout=request_timeout_s)
            except Exception as e:  # noqa: BLE001 -- report, keep serving
                self._send(500, {"error": str(e)})
                return
            self._send(200, {
                "image_png_base64": base64.b64encode(_png_bytes(img)).decode(),
                "seed": gen.seed, "guidance_scale": gen.guidance_scale})

    return ThreadingHTTPServer((host, port), Handler)
