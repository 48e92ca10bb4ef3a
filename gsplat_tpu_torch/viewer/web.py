"""Interactive web viewer for trained Gaussian PLYs. Counterpart of
gsplat_tpu/viewer/web.py: the same page, routes, orbit camera and server.
Frames render server-side through ``ops/rasterize.py:render`` on the
device the gaussians lie on; the browser is a thin orbit-controls client
fetching PNG frames over HTTP:

  GET /                 — the viewer page (vanilla JS, drag-orbit + wheel-zoom)
  GET /render?theta=&phi=&r=&fov=&w=&h=  — one rendered PNG frame
  GET /info             — scene metadata (gaussian count, center, extent)

``ThreadingHTTPServer`` answers each request on a thread of its own; the
renders, and so the kernels' launch counters, run one at a time behind
the server's lock. A frame that fails to render raises in its handler
thread: ``http.server`` logs it and closes the connection, so the client
gets no frame.

Usage: ``python view_torch.py -m <model_path> [--iteration N] [--port 8090]``.
"""
from __future__ import annotations

import io
import json
import math
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlparse

import numpy as np
import torch

from gsplat_tpu_torch.utils.general import resolve_device

_PAGE = """<!DOCTYPE html>
<html><head><title>gsplat_tpu viewer</title><style>
 body { margin:0; background:#111; color:#ddd; font-family:monospace; }
 #hud { position:fixed; top:8px; left:8px; }
 canvas { display:block; cursor:grab; }
</style></head><body>
<div id="hud">drag: orbit &middot; wheel: zoom &middot; <span id="s"></span></div>
<canvas id="c"></canvas>
<script>
const c = document.getElementById('c'), hud = document.getElementById('s');
const ctx = c.getContext('2d');
let theta = 0.0, phi = 0.0, r = 3.0, dragging = false, lx = 0, ly = 0;
let busy = false, dirty = true;
c.width = Math.min(window.innerWidth, 1024);
c.height = Math.min(window.innerHeight, 576);
fetch('/info').then(r_ => r_.json()).then(i => {
  r = i.extent * 2.0; hud.textContent = i.n + ' gaussians'; dirty = true; });
async function refresh() {
  if (!dirty || busy) { requestAnimationFrame(refresh); return; }
  busy = true; dirty = false;
  const q = `/render?theta=${theta}&phi=${phi}&r=${r}&w=${c.width}&h=${c.height}`;
  const t0 = performance.now();
  try {
    const blob = await (await fetch(q)).blob();
    const img = await createImageBitmap(blob);
    ctx.drawImage(img, 0, 0);
    hud.textContent = `${(performance.now()-t0).toFixed(0)} ms/frame`;
  } catch (e) {
    hud.textContent = `frame failed (${e}); retrying`;
    setTimeout(() => { dirty = true; }, 500);   // back off, then re-request
  } finally {
    busy = false; requestAnimationFrame(refresh);
  }
}
c.onmousedown = e => { dragging = true; lx = e.clientX; ly = e.clientY; };
window.onmouseup = () => dragging = false;
window.onmousemove = e => {
  if (!dragging) return;
  theta += (e.clientX - lx) * 0.01; phi += (e.clientY - ly) * 0.01;
  phi = Math.max(-1.5, Math.min(1.5, phi));
  lx = e.clientX; ly = e.clientY; dirty = true; };
c.onwheel = e => { r *= Math.exp(e.deltaY * 0.001); dirty = true;
                   e.preventDefault(); };
requestAnimationFrame(refresh);
</script></body></html>"""


def load_gaussians_from_ply(path: str, *, device="cuda"):
    """GaussianParams of a trained point_cloud.ply on ``device``: every row
    live, the highest SH degree the file holds active."""
    from gsplat_tpu_torch.models import gaussian_model as gm
    from gsplat_tpu_torch.scene import ply as ply_lib

    dev = resolve_device(device)
    return gm.from_numpy(ply_lib.load_gaussian_ply(path), device=dev)


def _orbit_camera(center, theta, phi, radius, fovx, fovy, *, device="cuda"):
    """COLMAP-convention (R, T) camera orbiting ``center``, on ``device``."""
    from gsplat_tpu_torch.core.camera import CameraView

    pos = center + radius * np.array([
        math.cos(phi) * math.sin(theta),
        math.sin(phi),
        -math.cos(phi) * math.cos(theta)])
    fwd = center - pos
    fwd = fwd / np.linalg.norm(fwd)
    up = np.array([0.0, -1.0, 0.0])   # COLMAP y-down convention
    right = np.cross(up, fwd)
    nr = np.linalg.norm(right)
    if nr < 1e-6:
        right = np.array([1.0, 0.0, 0.0])
    else:
        right = right / nr
    upv = np.cross(fwd, right)
    R_wc = np.stack([right, upv, fwd], axis=0)        # world→cam rows
    T = -R_wc @ pos
    return CameraView.create(R=R_wc.T, T=T, fovx=fovx, fovy=fovy,
                             device=device)


class ViewerServer:
    """HTTP server rendering a fixed Gaussian model on ``device`` (where
    the gaussians must lie). Thread-safe: renders are serialized behind a
    lock (one card, one frame at a time)."""

    def __init__(self, gaussians, host="127.0.0.1", port=8090,
                 rcfg=None, background=(0.0, 0.0, 0.0), *, device="cuda"):
        from gsplat_tpu_torch.config import RasterizerConfig

        self.device = resolve_device(device)
        # "cuda" names the current card, as the tensors' "cuda:0" does
        if gaussians.device != torch.empty(0, device=self.device).device:
            raise ValueError(f"the gaussians lie on {gaussians.device}, the "
                             f"server renders on {self.device}")
        self.gaussians = gaussians
        self.rcfg = rcfg or RasterizerConfig()
        self.bg = torch.tensor(background, dtype=torch.float32,
                               device=self.device)
        xyz = gaussians.xyz[gaussians.active].cpu().numpy()
        self.center = xyz.mean(axis=0) if len(xyz) else np.zeros(3)
        self.extent = float(np.abs(xyz - self.center).max()) if len(xyz) else 1.0
        self.n_active = int(len(xyz))
        self._lock = threading.Lock()

        viewer = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):   # quiet
                pass

            def _reply(self, code, ctype, body):
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                url = urlparse(self.path)
                if url.path == "/":
                    self._reply(200, "text/html", _PAGE.encode())
                elif url.path == "/info":
                    self._reply(200, "application/json", json.dumps({
                        "n": viewer.n_active,
                        "center": viewer.center.tolist(),
                        "extent": viewer.extent}).encode())
                elif url.path == "/render":
                    q = {k: v[0] for k, v in parse_qs(url.query).items()}
                    png = viewer.render_png(
                        theta=float(q.get("theta", 0)),
                        phi=float(q.get("phi", 0)),
                        radius=float(q.get("r", 3 * viewer.extent)),
                        W=int(q.get("w", 800)), H=int(q.get("h", 450)),
                        fov=float(q.get("fov", 1.0)))
                    self._reply(200, "image/png", png)
                else:
                    self._reply(404, "text/plain", b"not found")

        self.httpd = ThreadingHTTPServer((host, port), Handler)
        self.port = self.httpd.server_address[1]

    @torch.no_grad()
    def render_rgb(self, *, theta, phi, radius, W, H, fov=1.0) -> np.ndarray:
        """The orbit view's (H,W,3) uint8 frame, clamped to [0,1] and
        truncated as the JAX viewer does."""
        from gsplat_tpu_torch.ops.rasterize import render

        fovy = 2 * math.atan(math.tan(fov / 2) * H / W)
        cam = _orbit_camera(self.center, theta, phi, radius, fov, fovy,
                            device=self.device)
        with self._lock:
            out = render(self.gaussians, cam, W, H, self.bg, self.rcfg)
            img = out.image.cpu().numpy()
        return (np.clip(img, 0, 1).transpose(1, 2, 0) * 255).astype(np.uint8)

    def render_png(self, *, theta, phi, radius, W, H, fov=1.0) -> bytes:
        """The orbit view's frame, PNG-encoded."""
        from PIL import Image

        buf = io.BytesIO()
        Image.fromarray(self.render_rgb(
            theta=theta, phi=phi, radius=radius, W=W, H=H, fov=fov)).save(
                buf, format="PNG")
        return buf.getvalue()

    def serve_forever(self):
        print(f"viewer at http://{self.httpd.server_address[0]}:{self.port}/"
              f"  ({self.n_active} gaussians)")
        self.httpd.serve_forever()

    def shutdown(self):
        self.httpd.shutdown()
        self.httpd.server_close()
