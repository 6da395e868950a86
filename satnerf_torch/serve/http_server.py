"""Minimal HTTP front end for ``RenderService`` (port of
``satnerf_tpu/serve/http_server.py``; standard library only, PNGs through
``io/png.py``).

Endpoints:
  GET  /healthz            -> {"status": "ok", "step": N}
  GET  /metadata           -> run/model/view info
  GET  /stats              -> request counters + rays/s
  POST /render             -> body {"view": ..., "sun_elevation"?,
                              "sun_azimuth"?, "ts"?, "output"?}
       output "rgb" (default) | "depth" | "semantic" | "semantic_shaded"
       returns image/png; output "arrays" returns application/json with
       base64 float16 rgb + depth (compact transfer encoding).
  400 for a bad view or body, 404 for an unknown route, 500 otherwise.

CLI: python -m satnerf_torch.serve <run_dp> [--port 8642] [--chunk 16384]
     [--device cuda|cpu]
"""

from __future__ import annotations

import base64
import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

from satnerf_torch.io.png import encode_png
from satnerf_torch.logger import logger
from satnerf_torch.viz.colormaps import apply_colormap


def _render_png(result: dict, output: str) -> bytes:
    if output == "rgb":
        return encode_png((result["rgb"] * 255).astype(np.uint8))
    if output == "depth":
        return encode_png((apply_colormap(result["depth"], "jet") * 255).astype(np.uint8))
    if output == "semantic":
        return encode_png(result["semantic_rgb"])
    if output == "semantic_shaded":
        return encode_png(result["semantic_shaded_rgb"])
    raise KeyError(f"unknown output {output!r}")


def _make_handler(service):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *args):  # route to the package logger
            logger.info("Serve", fmt % args)

        def _send(self, code: int, body: bytes, ctype: str):
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _send_json(self, obj, code: int = 200):
            self._send(code, json.dumps(obj).encode(), "application/json")

        def do_GET(self):
            if self.path == "/healthz":
                self._send_json({"status": "ok", "step": service.step})
            elif self.path == "/metadata":
                self._send_json(service.metadata())
            elif self.path == "/stats":
                self._send_json(service.stats())
            else:
                self._send_json({"error": f"no route {self.path}"}, 404)

        def do_POST(self):
            if self.path != "/render":
                self._send_json({"error": f"no route {self.path}"}, 404)
                return
            try:
                n = int(self.headers.get("Content-Length", "0"))
                req = json.loads(self.rfile.read(n) or b"{}")
                result = service.render(
                    req["view"],
                    sun_elevation=req.get("sun_elevation"),
                    sun_azimuth=req.get("sun_azimuth"),
                    ts=int(req.get("ts") or 0),
                    allow_paths=False,  # no file system probing from remote clients
                )
                output = req.get("output", "rgb")
                if output == "arrays":
                    self._send_json({
                        "shape": list(result["rgb"].shape),
                        "rgb_f16_b64": base64.b64encode(
                            result["rgb"].astype(np.float16).tobytes()).decode(),
                        "depth_f16_b64": base64.b64encode(
                            result["depth"].astype(np.float16).tobytes()).decode(),
                        "sun_elevation": result["sun_elevation"],
                        "sun_azimuth": result["sun_azimuth"],
                    })
                else:
                    self._send(200, _render_png(result, output), "image/png")
            except (KeyError, ValueError, TypeError, json.JSONDecodeError) as exc:
                self._send_json({"error": str(exc)}, 400)
            except Exception as exc:  # every request gets a response
                logger.error("Serve", f"/render failed: {exc!r}")
                self._send_json({"error": f"internal error: {exc}"}, 500)

    return Handler


def make_server(service, host: str = "127.0.0.1", port: int = 8642):
    """Build (not start) a ThreadingHTTPServer bound to host:port; port 0
    picks a free one (``server.server_address[1]``)."""
    return ThreadingHTTPServer((host, port), _make_handler(service))


def serve(run_dp: str, host: str = "127.0.0.1", port: int = 8642, chunk: int = 16384,
          epoch: int | None = None, fast_sine: bool = False, device=None):
    """Load the run, render one view to warm up, serve until interrupted."""
    from satnerf_torch.device import resolve_device
    from satnerf_torch.serve.service import load_service

    dev = resolve_device(device)  # no GPU, no service: before any loading
    service = load_service(run_dp, epoch=epoch, chunk=chunk, fast_sine=fast_sine, device=dev)
    server = make_server(service, host, port)
    logger.info("Serve", f"serving {run_dp} (step {service.step}) on "
                         f"http://{host}:{server.server_address[1]}")
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        server.server_close()
    return server


def serve_in_thread(service, host: str = "127.0.0.1", port: int = 0):
    """Start the server on a daemon thread; returns (server, port). Stop it
    with ``server.shutdown()`` and ``server.server_close()``."""
    server = make_server(service, host, port)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    return server, server.server_address[1]
