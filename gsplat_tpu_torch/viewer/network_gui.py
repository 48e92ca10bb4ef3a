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

Under rank-sharded storage (``train(..., shard_gaussians=True)`` over a
process group) each rank holds only its rows, so every rank renders the
client's frames (``RankFrames``): rank 0, which owns the socket, sends
each request to the ranks over the loop's ``Hold`` group (host side, its
7-day timeout, since a paused client may wait) before it renders, and a
last message, "train on", when its poll ends, also when the client
dropped; the other ranks render each request with ``make_sharded_render``
on their prim line's ``RankParts`` until that message. JAX renders the
client's frame from the global sharded state on every device.
"""
from __future__ import annotations

import json
import socket
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

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
             max_iterations, train_test_exp=False, ranks=None):
        """Serve the connected client (accepting one if none is): frames
        until it asks to train on, one per iteration while training runs.
        ``ranks``: the ``RankFrames`` of rank-sharded storage, which every
        request and the poll's end are sent to."""
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
                if ranks is not None:
                    ranks.announce(req)
                frame = self._render_frame(state, req, rcfg, pipe, bg_color,
                                           ranks)
            try:
                self.send_frame(frame, getattr(scene, "source_path", ""))
            except OSError:
                self._drop_connection()
                break
            if req.training and (iteration < max_iterations
                                 or not req.keep_alive):
                break
        if ranks is not None:
            ranks.announce(None)               # train on

    def _render_frame(self, state, req: ViewerRequest, rcfg, pipe, bg_color,
                      ranks=None) -> memoryview:
        """The request's frame as the client's bytes."""
        kw = {} if ranks is None else dict(parts=ranks.parts,
                                            transient=ranks.transient)
        return frame_bytes(render_request(state, req, rcfg, pipe, bg_color,
                                          self.device, **kw))


class RankFrames:
    """The bridge's frames under rank-sharded storage: one message per
    request from rank 0 over ``hold``'s group, every rank rendering it on
    its rows with ``make_sharded_render`` over ``parts`` (its prim line;
    under the data x prim layout each line renders, and rank 0 answers
    from its own)."""

    def __init__(self, hold, parts, *, transient: str = "replicated"):
        self.hold, self.parts, self.transient = hold, parts, transient

    def _message(self, req=None):
        msg = [req]
        dist.broadcast_object_list(msg, src=0, group=self.hold.group)
        return msg[0]

    def announce(self, req: Optional[ViewerRequest]):
        """Rank 0: the ranks render ``req`` next; None: train on."""
        self._message(req)

    def follow(self, state, rcfg, pipe, bg_color, device):
        """A rank other than 0: render rank 0's requests until it trains
        on."""
        while (req := self._message()) is not None:
            render_request(state, req, rcfg, pipe, bg_color, device,
                           parts=self.parts, transient=self.transient)


@torch.no_grad()
def render_request(state, req: ViewerRequest, rcfg, pipe, bg_color, device,
                   parts=None, transient: str = "replicated") -> torch.Tensor:
    """The request's clamped (3,H,W) image of ``state``'s gaussians:
    ``render``, or with ``parts`` (a ``RankParts``, or an int of local
    shards) the sharded render of ``transient``. The client's python
    toggles are per row (SH evaluated on the host's rows, covariances from
    their scales and rotations), so under ranks each rank computes them on
    its own rows; overflow is not checked, as in JAX's bridge."""
    from gsplat_tpu_torch.core import sh as sh_lib
    from gsplat_tpu_torch.ops.rasterize import render
    from gsplat_tpu_torch.parallel.sharded import make_sharded_render

    g = state.gaussians
    cv = req.cam.view(device)
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
    bg = torch.as_tensor(bg_color, dtype=torch.float32, device=device)
    W, H = req.cam.image_width, req.cam.image_height
    kw = dict(scaling_modifier=req.scaling_modifier,
              override_color=override_color, cov3d_precomp=cov3d)
    if parts is None:
        out = render(g, cv, W, H, bg, rcfg, antialiasing=pipe.antialiasing,
                     **kw)
    else:
        out = make_sharded_render(
            parts, image_width=W, image_height=H, cfg=rcfg,
            antialiasing=pipe.antialiasing, transient=transient)(
                g, cv, bg, **kw)
    return torch.clamp(out.image, 0, 1)


def frame_bytes(image: torch.Tensor) -> memoryview:
    """A (3,H,W) image in [0,1] as the client's H·W·3 uint8 bytes, truncated
    as the JAX bridge does."""
    img = image.cpu().numpy()
    return memoryview((img * 255).astype(np.uint8)
                      .transpose(1, 2, 0).copy(order="C"))
