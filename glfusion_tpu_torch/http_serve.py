"""Online HTTP inference endpoint (standard library only).

The port of ``glfusion_tpu/http_serve.py``: a thread-per-connection HTTP
server over :class:`glfusion_tpu_torch.serve.ClipPipeline` that accepts
NIfTI volumes and returns thresholded masks, from the live weights or from
a saved export (``--from-export``), so the serving process needs no
checkpoint.

Protocol (JSON over HTTP; volumes are base64 .nii/.nii.gz bytes):

  * ``GET /healthz`` → ``{"status": "ok", "views": [...], "crop_hw": N,
    "num_classes": C, "clip_length": T}``
  * ``POST /predict`` with body
    ``{"views": {"1": "<base64 nii(.gz)>", ...}}`` → ``{"masks":
    {"1": "<base64 nii.gz uint8 (5, H, W, T)>", ...}, "frames": T}``.
    Uploaded volumes follow the ``Test_Seg_PAHDataset`` contract:
    (1, H, W, T) or (H, W, T), uint8 [0, 255]; missing views are
    zero-filled like the batch paths. Errors return 400 with
    ``{"error": ...}``.

Device dispatch is serialized with a lock (one clip on the card at a time,
the latency-optimal policy for one card); ``--mode serve`` without
``--http-port`` is the offline, pipelined path over a corpus.

Start from the CLI: ``--mode serve --http-port 8000 [--from-export DIR]``.
"""

from __future__ import annotations

import base64
import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

import numpy as np


def make_http_server(pipe, host: str = "127.0.0.1", port: int = 8000,
                     max_body: int = 1 << 30) -> ThreadingHTTPServer:
    """Build (not start) the server; ``port=0`` picks a free port.

    ``pipe`` is a :class:`glfusion_tpu_torch.serve.ClipPipeline` (live
    weights or an exported forward; both work unchanged).
    """
    cfg = pipe.cfg
    lock = threading.Lock()

    class Handler(BaseHTTPRequestHandler):
        # quiet by default; the CLI enables logging via server attribute
        def log_message(self, fmt, *args):
            if getattr(self.server, "verbose", False):
                super().log_message(fmt, *args)

        def _send(self, code: int, payload: dict) -> None:
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path != "/healthz":
                self._send(404, {"error": f"unknown path {self.path}"})
                return
            self._send(200, {
                "status": "ok",
                "views": list(cfg.model.views),
                "crop_hw": cfg.data.crop_hw,
                "num_classes": cfg.model.num_classes,
                "clip_length": cfg.data.clip_length,
            })

        def do_POST(self):
            if self.path != "/predict":
                self._send(404, {"error": f"unknown path {self.path}"})
                return
            try:
                length = int(self.headers.get("Content-Length", 0))
                if length <= 0 or length > max_body:
                    raise ValueError(f"bad Content-Length {length}")
                req = json.loads(self.rfile.read(length))
                views_b64 = req.get("views")
                if not isinstance(views_b64, dict) or not views_b64:
                    raise ValueError(
                        'body must be {"views": {"<view>": "<base64 '
                        'nii(.gz)>", ...}}')
                unknown = sorted(set(views_b64) - set(cfg.model.views))
                if unknown:
                    raise ValueError(
                        f"unknown view id(s) {unknown}; this model serves "
                        f"views {list(cfg.model.views)}")
                from glfusion_tpu_torch.data.nifti import (
                    nifti_bytes, parse_nifti_bytes)
                vols = {v: parse_nifti_bytes(base64.b64decode(b),
                                             name=f"view {v}")
                        for v, b in views_b64.items()}
                images = pipe.stack_raw_views(vols)
                if images is None:
                    raise ValueError("no requested view present")
            except Exception as e:  # malformed input → 400, not a crash
                self._send(400, {"error": str(e)})
                return
            try:
                with lock:  # one clip on device at a time
                    pred = pipe.predict_one(images)  # (V, T, H, W, C) uint8
            except Exception as e:
                self._send(500, {"error": str(e)})
                return
            masks = {}
            for vi, view in enumerate(cfg.model.views):
                if view not in views_b64:
                    continue  # don't return masks for zero-filled views
                # (T, H, W, C) → (C, H, W, T): the Test_Seg_PAHDataset
                # mask layout, same as --mode infer/serve outputs
                vol = np.transpose(pred[vi], (3, 1, 2, 0)).astype(np.uint8)
                masks[view] = base64.b64encode(nifti_bytes(vol)).decode()
            self._send(200, {"masks": masks, "frames": int(pred.shape[1])})

    server = ThreadingHTTPServer((host, port), Handler)
    server.daemon_threads = True
    return server


def serve_http(trainer, host: str = "127.0.0.1", port: int = 8000,
               from_export: Optional[str] = None,
               verbose: bool = True) -> None:
    """CLI entry: build the pipeline (live weights or a saved export) and
    serve until interrupted."""
    from glfusion_tpu_torch.serve import ClipPipeline, export_pipeline_kwargs

    cfg = trainer.cfg
    # the batch path's checks: a views or class-count mismatch is a
    # start-up error, not an opaque 500 on every request
    if from_export is None:
        pipe = ClipPipeline(cfg, trainer.model, device=trainer.device)
    else:
        pipe = ClipPipeline(cfg, device=trainer.device,
                            **export_pipeline_kwargs(from_export, cfg,
                                                     trainer.device))
    server = make_http_server(pipe, host=host, port=port)
    server.verbose = verbose
    addr = server.server_address
    print(f"[glfusion_torch] serving on http://{addr[0]}:{addr[1]} "
          f"(POST /predict, GET /healthz)", flush=True)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        server.server_close()
