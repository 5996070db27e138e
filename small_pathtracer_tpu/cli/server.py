"""Minimal render server: POST a JSON render request, get a PNG/PPM back.

The serving story for the framework (the reference is a batch binary; a
device-resident renderer wants to stay warm): compiled renderers are
cached per (scene, config) by the underlying jit/megakernel caches, so
repeated requests for the same configuration render with no
recompilation.

    python -m small_pathtracer_tpu.cli serve --port 8000
    curl -d '{"scene":"cornell_box","width":256,"height":256,"spp":32}' \
         -o out.png http://localhost:8000/render

Request fields (all optional): scene, width, height, spp, estimator, seed,
wavefront, use_pallas, sphere_table, denoise (a-trous passes, 0 = off —
utils/denoise.py runs on the linear image before tonemap, guided by an AOV
pre-pass), aov ("albedo"|"normal"|"depth"|"coverage" — return that feature
buffer instead of the beauty), format ("png"|"ppm"). GET /healthz returns
metrics.
"""

from __future__ import annotations

import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

# One device, one render at a time: ThreadingHTTPServer gives each request
# its own thread, but concurrent renders would contend for the single
# accelerator (and the jit caches are populated under this lock too).
# Requests queue on the lock; /healthz exposes the current queue depth
# (pending) so a load balancer can shed.
_RENDER_LOCK = threading.Lock()
_STATS_LOCK = threading.Lock()


def make_handler(stats: dict):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *args):  # quiet
            pass

        def do_GET(self):
            if self.path != "/healthz":
                self.send_error(404)
                return
            body = json.dumps(stats).encode()
            self.send_response(200)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_POST(self):
            if self.path != "/render":
                self.send_error(404)
                return
            try:
                n = int(self.headers.get("Content-Length", 0))
                req = json.loads(self.rfile.read(n) or b"{}")
                with _STATS_LOCK:
                    stats["pending"] = stats.get("pending", 0) + 1
                try:
                    with _RENDER_LOCK:
                        body, ctype = _render(req, stats)
                finally:
                    with _STATS_LOCK:
                        stats["pending"] = stats.get("pending", 1) - 1
            except Exception as e:  # noqa: BLE001 - report to client
                msg = json.dumps({"error": str(e)}).encode()
                self.send_response(400)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(msg)))
                self.end_headers()
                self.wfile.write(msg)
                return
            self.send_response(200)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

    return Handler


def _render(req: dict, stats: dict) -> tuple[bytes, str]:
    import numpy as np

    from .. import render
    from ..core import film
    from ..models import get_model

    # Resolve through the model registry: each named model carries its own
    # estimator default (e.g. smallpt_original -> cosine); explicit request
    # fields override.
    overrides = dict(
        width=int(req.get("width", 256)),
        height=int(req.get("height", 256)),
        spp=int(req.get("spp", 32)),
        seed=int(req.get("seed", 0)),
        wavefront=req.get("wavefront", "regen"),
        use_pallas=bool(req.get("use_pallas", False)),
    )
    if "estimator" in req:
        overrides["estimator"] = req["estimator"]
    if "pixel_filter" in req:
        overrides["pixel_filter"] = str(req["pixel_filter"])
    if "aperture" in req:
        overrides["aperture"] = float(req["aperture"])
    if "focus_dist" in req:
        overrides["focus_dist"] = float(req["focus_dist"])
    if "sphere_table" in req:
        overrides["sphere_table"] = str(req["sphere_table"])
    model = get_model(req.get("scene", "cornell_box"), **overrides)
    aov_kind = str(req.get("aov", ""))
    n_denoise = int(req.get("denoise", 0))
    if aov_kind not in ("", "albedo", "normal", "depth", "coverage"):
        raise ValueError(
            f"aov must be albedo/normal/depth/coverage, got {aov_kind!r}"
        )
    t0 = time.perf_counter()
    if aov_kind or n_denoise:
        from ..utils.aov import render_aovs

        aovs = render_aovs(model.scene, model.camera, model.config)
    if aov_kind:
        # Feature-buffer responses use the CLI's encodings (cli/main.py
        # _write_aovs): tonemapped albedo, [-1,1]->[0,1] normal, max-
        # normalized depth, direct coverage.
        # One primary trace per pixel per AOV sample — render_aovs
        # averages min(spp, 64) samples (utils/aov.py), so /healthz's
        # last_mrays_per_s reflects the actual trace count.
        traces = float(
            model.config.width * model.config.height
            * max(1, min(model.config.spp, 64))
        )
        a = np.asarray(aovs[aov_kind], np.float32)
        if aov_kind == "albedo":
            u8 = np.asarray(film.tonemap_u8(a))
        else:
            if aov_kind == "normal":
                a = (a + 1.0) * 0.5
            elif aov_kind == "depth":
                a = a / max(float(a.max()), 1e-9)
            if a.ndim == 2:
                a = np.repeat(a[..., None], 3, axis=-1)
            u8 = (np.clip(a, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)
        dt = time.perf_counter() - t0
    else:
        img, traces = render(model.scene, model.camera, model.config)
        if n_denoise:
            from ..utils.denoise import denoise

            img = film.finalize(denoise(img, aovs, iterations=n_denoise))
        dt = time.perf_counter() - t0
        u8 = np.asarray(film.tonemap_u8(img))
    stats["requests"] = stats.get("requests", 0) + 1
    stats["last_mrays_per_s"] = round(traces / dt / 1e6, 3)
    stats["last_wall_s"] = round(dt, 4)
    if req.get("format", "png") == "ppm":
        h, w = u8.shape[:2]
        from .. import native

        body = native.ppm_body(u8)
        if body is None:
            body = (" ".join(str(v) for v in u8.reshape(-1)) + " ").encode()
        return f"P3\n{w} {h}\n255\n".encode() + body, "image/x-portable-pixmap"
    from ..core.imageio import encode_png

    return encode_png(u8), "image/png"


def make_server(host: str = "127.0.0.1", port: int = 8000):
    """The render server, bound but not yet serving (port 0 = any free
    port; read it from ``server.server_address``)."""
    return ThreadingHTTPServer((host, port), make_handler({"requests": 0}))


def serve(host: str = "127.0.0.1", port: int = 8000) -> None:
    httpd = make_server(host, port)
    print(f"render server on http://{host}:{port}  (POST /render, GET /healthz)")
    httpd.serve_forever()
