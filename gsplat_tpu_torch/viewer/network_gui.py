"""SIBR remote-viewer TCP bridge. Counterpart of
gsplat_tpu/viewer/network_gui.py, with the same wire protocol, fixed by
the SIBR client: a 4-byte little-endian length and a JSON request in; raw
H·W·3 RGB bytes and a length-prefixed source-path string out; the client's
y/z column signs. The client's ``shs_python`` / ``rot_scale_python``
toggles go through the renderer's ``override_color`` / ``cov3d_precomp``,
as the render CLI's python paths do.

``poll`` drops the connection on socket and protocol errors only
(``OSError``, which covers ``ConnectionError``, ``json.JSONDecodeError``,
``KeyError``); an error of the render itself raises out of ``poll`` and
out of the training loop that calls it, where JAX's bridge drops the
client on any exception.
"""
from __future__ import annotations

import json
import socket
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from gsplat_tpu_torch.scene.cameras import MiniCam
from gsplat_tpu_torch.utils.general import resolve_device

# what a broken or misbehaving client can raise while a request is read or
# a frame is sent
_PROTOCOL_ERRORS = (OSError, json.JSONDecodeError, KeyError)


@dataclass(frozen=True)
class ViewerRequest:
    """One parsed client message. ``cam`` is None for empty-resolution
    keep-alive pings (the client sends those while idle)."""
    cam: Optional[MiniCam]
    training: bool = False
    sh_python: bool = False
    rot_scale_python: bool = False
    keep_alive: bool = False
    scaling_modifier: float = 1.0

    @classmethod
    def parse(cls, payload: dict) -> "ViewerRequest":
        w, h = payload["resolution_x"], payload["resolution_y"]
        if w == 0 or h == 0:
            return cls(cam=None)
        # The client streams column-major GL-convention matrices; flipping
        # the y/z basis columns converts to the renderer's camera frame.
        view = np.asarray(payload["view_matrix"],
                          np.float32).reshape(4, 4)
        view[:, 1:3] *= -1.0
        viewproj = np.asarray(payload["view_projection_matrix"],
                              np.float32).reshape(4, 4)
        viewproj[:, 1] *= -1.0
        cam = MiniCam(w, h, payload["fov_y"], payload["fov_x"],
                      payload["z_near"], payload["z_far"], view, viewproj)
        return cls(cam=cam,
                   training=bool(payload["train"]),
                   sh_python=bool(payload["shs_python"]),
                   rot_scale_python=bool(payload["rot_scale_python"]),
                   keep_alive=bool(payload["keep_alive"]),
                   scaling_modifier=float(payload["scaling_modifier"]))


class NetworkGUI:
    """Non-blocking listener polled once per training iteration; frames
    render on ``device``, where the state it is given lies."""

    def __init__(self, host="127.0.0.1", port=6009, *, device="cuda"):
        self.device = resolve_device(device)
        self.listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self.listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self.listener.bind((host, port))
        self.listener.listen()
        self.listener.settimeout(0)
        self.conn: Optional[socket.socket] = None

    # ---- framing ----

    def _recv_exact(self, n: int) -> bytes:
        chunks = []
        while n > 0:
            chunk = self.conn.recv(n)
            if not chunk:
                raise ConnectionError("viewer client closed the socket")
            chunks.append(chunk)
            n -= len(chunk)
        return b"".join(chunks)

    def read_request(self) -> ViewerRequest:
        length = int.from_bytes(self._recv_exact(4), "little")
        return ViewerRequest.parse(json.loads(self._recv_exact(length)))

    def send_frame(self, rgb_bytes: Optional[bytes], source_path: str):
        if rgb_bytes is not None:
            self.conn.sendall(rgb_bytes)
        self.conn.sendall(len(source_path).to_bytes(4, "little"))
        self.conn.sendall(source_path.encode("ascii"))

    def _try_connect(self):
        try:
            self.conn, addr = self.listener.accept()
            print(f"\nConnected by {addr}")
            self.conn.settimeout(None)
        except (BlockingIOError, OSError):
            pass

    def _drop_connection(self):
        if self.conn is not None:
            try:
                self.conn.close()
            except OSError:
                pass
            self.conn = None

    def close(self):
        """Close the client connection and the listener."""
        self._drop_connection()
        self.listener.close()

    # ---- per-iteration poll ----

    def poll(self, state, scene, pipe, rcfg, bg_color, iteration,
             max_iterations, train_test_exp=False):
        """Serve the connected client (accepting one if none is): frames
        until it asks to train on, one per iteration while training runs."""
        if self.conn is None:
            self._try_connect()
        while self.conn is not None:
            try:
                req = self.read_request()
            except _PROTOCOL_ERRORS:
                self._drop_connection()
                break
            frame = None
            if req.cam is not None:
                frame = self._render_frame(state, req, rcfg, pipe, bg_color)
            try:
                self.send_frame(frame, getattr(scene, "source_path", ""))
            except OSError:
                self._drop_connection()
                break
            if req.training and (iteration < max_iterations
                                 or not req.keep_alive):
                break

    @torch.no_grad()
    def _render_frame(self, state, req: ViewerRequest, rcfg, pipe,
                      bg_color) -> memoryview:
        """The request's frame as H·W·3 uint8 bytes, truncated from the
        clamped image as the JAX bridge does."""
        from gsplat_tpu_torch.core import sh as sh_lib
        from gsplat_tpu_torch.ops.rasterize import render

        g = state.gaussians
        cv = req.cam.view(self.device)

        override_color = None
        if req.sh_python:
            dirs = g.xyz - cv.camera_center[None, :]
            dirs = dirs / torch.clamp(
                torch.linalg.norm(dirs, dim=-1, keepdim=True), min=1e-8)
            override_color = torch.clamp(sh_lib.eval_sh(
                g.active_sh_degree, g.get_features().transpose(1, 2), dirs)
                + 0.5, min=0.0)
        cov3d = g.get_covariance(req.scaling_modifier) \
            if req.rot_scale_python else None

        out = render(g, cv, req.cam.image_width, req.cam.image_height,
                     torch.as_tensor(bg_color, dtype=torch.float32,
                                     device=self.device), rcfg,
                     scaling_modifier=req.scaling_modifier,
                     antialiasing=pipe.antialiasing,
                     override_color=override_color, cov3d_precomp=cov3d)
        img = torch.clamp(out.image, 0, 1).cpu().numpy()
        return memoryview((img * 255).astype(np.uint8)
                          .transpose(1, 2, 0).copy(order="C"))
