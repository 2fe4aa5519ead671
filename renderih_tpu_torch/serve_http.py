"""HTTP front end for the serving engine, standard library only
(counterpart of `renderih_tpu/serve_http.py`).

A threaded HTTP server over `serve.InferenceEngine` and
`serve.BatchingServer`: concurrent single-image requests are coalesced
into padded device batches, so independent clients share the card's batch
efficiency. The reference ships no network serving (its only surface is
the in-process `core/test_utils.py:InterRender`).

  GET  /healthz  -> {"status": "ok", "buckets": [...], "encoder": "..."}
  POST /predict  -> the hand-mesh outputs of one image or of a batch:
    Content-Type application/x-npy: the body is `np.save` bytes of a uint8
      image (H, W, 3) or batch (N, H, W, 3); the response is `np.savez`
      bytes (application/x-npz) of the output arrays;
    Content-Type application/json: {"image": nested uint8 lists}; the
      response is JSON with the same keys, as lists.

A single image goes through the batcher; a batch goes straight to
`InferenceEngine.predict` (the caller has batched it). A malformed
request gets 400, an unknown path 404.

    python -m renderih_tpu_torch.serve_http [--port 8000] [--cfg YAML] \
        [--ckpt DIR] [--warmup] [--device cuda|cpu]
"""

from __future__ import annotations

import io
import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

from renderih_tpu_torch.serve import BatchingServer, InferenceEngine

_MAX_BODY = 512 * 1024 * 1024


class HandPoseHTTPServer:
    """Threaded HTTP server over an InferenceEngine + BatchingServer."""

    def __init__(self, engine: InferenceEngine, host: str = "0.0.0.0", port: int = 8000,
                 max_wait_ms: float = 2.0):
        self.engine = engine
        self.batcher = BatchingServer(engine, max_wait_ms=max_wait_ms)
        outer = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, fmt, *args):  # no per-request stderr line
                pass

            def _send(self, code: int, body: bytes, ctype: str):
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def _send_json(self, code: int, obj):
                self._send(code, json.dumps(obj).encode(), "application/json")

            def do_GET(self):
                if self.path == "/healthz":
                    self._send_json(200, {"status": "ok",
                                          "buckets": list(outer.engine.buckets),
                                          "encoder": outer.engine.cfg.model.encoder})
                else:
                    self._send_json(404, {"error": "unknown path"})

            def do_POST(self):
                if self.path != "/predict":
                    self._send_json(404, {"error": "unknown path"})
                    return
                ctype = (self.headers.get("Content-Type")
                         or "application/x-npy").split(";")[0].strip()
                try:
                    n = int(self.headers.get("Content-Length", 0))
                    if not 0 < n <= _MAX_BODY:
                        raise ValueError(f"bad Content-Length {n}")
                    body = self.rfile.read(n)
                    if ctype == "application/json":
                        img = np.asarray(json.loads(body)["image"], np.uint8)
                    else:
                        img = np.load(io.BytesIO(body), allow_pickle=False)
                    out = outer.run(img)
                except Exception as e:  # noqa: BLE001 — the client's error, reported to it
                    self._send_json(400, {"error": f"{type(e).__name__}: {e}"})
                    return
                if ctype == "application/json":
                    self._send_json(200, {k: v.tolist() for k, v in out.items()})
                else:
                    buf = io.BytesIO()
                    np.savez(buf, **out)
                    self._send(200, buf.getvalue(), "application/x-npz")

        self.httpd = ThreadingHTTPServer((host, port), Handler)
        self.port = self.httpd.server_address[1]  # the bound port when port=0
        self._thread: threading.Thread | None = None

    def run(self, img: np.ndarray) -> dict:
        """The outputs for one (S, S, 3) image, through the batcher, or for
        an (N, S, S, 3) batch, straight from the engine."""
        s = self.engine.cfg.model.img_size
        if img.ndim == 3:
            if img.shape != (s, s, 3):
                raise ValueError(f"expected ({s},{s},3), got {img.shape}")
            return self.batcher.submit(img).result()
        if img.ndim == 4:
            if img.shape[1:] != (s, s, 3):
                raise ValueError(f"expected (N,{s},{s},3), got {img.shape}")
            return self.engine.predict(img)
        raise ValueError(f"image must be 3-d or 4-d, got shape {img.shape}")

    def start(self) -> None:
        """Serve from a background thread (tests, embedding)."""
        self._thread = threading.Thread(target=self.httpd.serve_forever, daemon=True)
        self._thread.start()

    def serve_forever(self) -> None:
        self.httpd.serve_forever()

    def close(self) -> None:
        self.httpd.shutdown()
        self.httpd.server_close()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
        self.batcher.close()


def main(argv=None):
    import argparse

    from renderih_tpu_torch.config import load_config

    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--host", default="0.0.0.0")
    p.add_argument("--port", type=int, default=8000)
    p.add_argument("--cfg", default=None, help="YAML config (default: Config())")
    p.add_argument("--ckpt", default=None, help="checkpoint directory of the port's trainer")
    p.add_argument("--warmup", action="store_true",
                   help="run every bucket once before accepting traffic")
    p.add_argument("--device", default="cuda",
                   help="cuda (default; raises without a card) or cpu")
    args = p.parse_args(argv)

    engine = InferenceEngine(load_config(args.cfg), checkpoint=args.ckpt, device=args.device)
    if args.warmup:
        engine.warmup()
    server = HandPoseHTTPServer(engine, host=args.host, port=args.port)
    print(f"serving on {args.host}:{server.port} (buckets {engine.buckets})", flush=True)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        server.close()


if __name__ == "__main__":
    main()
