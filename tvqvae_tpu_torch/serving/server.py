"""Dependency-free HTTP front end for GenerationService.

Port of ``tvqvae_tpu/serving/server.py``, verbatim but for the import.
Stdlib ``http.server`` only. Threaded accept loop; the device itself is
serialized inside GenerationService, so concurrent requests queue on the
sampler lock rather than interleaving device work.

Endpoints
---------
GET  /healthz          -> {"ok": true}
GET  /v1/info          -> model/service metadata (GenerationService.info)
POST /v1/generate      -> body {"n": int, "class_index": int|null,
                          "class_counts": {cls: count} (alternative to n),
                          "seed": int, "postprocess": bool,
                          "format": "json"|"npz"}
  format=json -> {"X": nested lists (n, C, L), "y": [labels], "shape", ...}
  format=npz  -> application/octet-stream, an .npz with arrays X and y
"""

import io
import json
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

from tvqvae_tpu_torch.serving.service import GenerationService


class _Handler(BaseHTTPRequestHandler):
    # the service is attached to the server instance by make_server()
    protocol_version = "HTTP/1.1"

    @property
    def service(self) -> GenerationService:
        return self.server.service

    # --- helpers -------------------------------------------------------

    def _send(self, code: int, body: bytes, ctype: str) -> None:
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _send_json(self, code: int, obj) -> None:
        self._send(
            code, json.dumps(obj).encode("utf-8"), "application/json"
        )

    def log_message(self, fmt, *args):  # quiet default request logging
        pass

    # --- routes --------------------------------------------------------

    def do_GET(self):
        if self.path == "/healthz":
            return self._send_json(200, {"ok": True})
        if self.path == "/v1/info":
            return self._send_json(200, self.service.info())
        return self._send_json(404, {"error": f"no route {self.path}"})

    def do_POST(self):
        if self.path != "/v1/generate":
            return self._send_json(404, {"error": f"no route {self.path}"})
        try:
            length = int(self.headers.get("Content-Length", 0))
            req = json.loads(self.rfile.read(length) or b"{}")
        except (ValueError, json.JSONDecodeError) as e:
            return self._send_json(400, {"error": f"bad JSON body: {e}"})
        try:
            resp = self._generate(req)
        except ValueError as e:
            return self._send_json(400, {"error": str(e)})
        except Exception as e:  # surface internal failures as 500s
            return self._send_json(500, {"error": f"{type(e).__name__}: {e}"})
        return resp

    def _generate(self, req: dict):
        seed = req.get("seed")  # absent -> fresh randomness (coalescable)
        if seed is not None:
            seed = int(seed)
        postprocess = bool(req.get("postprocess", True))
        fmt = req.get("format", "json")
        if fmt not in ("json", "npz"):
            raise ValueError(f"format must be 'json' or 'npz', got {fmt!r}")

        if "class_counts" in req and req["class_counts"] is not None:
            counts = {
                int(k): int(v) for k, v in dict(req["class_counts"]).items()
            }
            X, y = self.service.generate_mix(
                counts, seed=0 if seed is None else seed,
                postprocess=postprocess,
            )
        else:
            if "n" not in req:
                raise ValueError("body needs 'n' or 'class_counts'")
            ci = req.get("class_index")
            X, y = self.service.generate(
                int(req["n"]),
                class_index=None if ci is None else int(ci),
                seed=seed,
                postprocess=postprocess,
            )

        if fmt == "npz":
            buf = io.BytesIO()
            np.savez_compressed(buf, X=X.astype(np.float32), y=y)
            return self._send(
                200, buf.getvalue(), "application/octet-stream"
            )
        return self._send_json(200, {
            "X": X.astype(float).tolist(),
            "y": y.tolist(),
            "shape": list(X.shape),
            "features": self.service.features,
            "postprocessed": postprocess and self.service.scaler is not None,
        })


def make_server(
    service: GenerationService, host: str = "127.0.0.1", port: int = 0
) -> ThreadingHTTPServer:
    """Build (but don't start) the HTTP server; `.server_address` carries the
    bound (host, port) — port 0 binds an ephemeral port (used in tests)."""
    srv = ThreadingHTTPServer((host, port), _Handler)
    srv.service = service
    return srv


def serve_forever(service: GenerationService, host: str, port: int) -> None:
    srv = make_server(service, host, port)
    host_, port_ = srv.server_address[:2]
    print(f"[serve] listening on http://{host_}:{port_}", flush=True)
    try:
        srv.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        srv.server_close()
