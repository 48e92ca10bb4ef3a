"""Port parity of the viewers on the CPU, over localhost sockets only:
- the SIBR bridge (gsplat_tpu_torch/viewer/network_gui.py against
  gsplat_tpu/viewer/network_gui.py): the round trip of
  tests/test_viewer.py:58 with the port's and JAX's ``NetworkGUI`` serving
  the same requests from the same state (carried across with
  tests/torch_parity.py:port_scene). The frames agree within 1 in uint8,
  and the python-path frame is within 1 of the kernel-path frame. A render
  error raises out of ``poll``; a protocol error drops the client;
- the web viewer (viewer/web.py), the round trip of tests/test_viewer.py:97:
  ``_orbit_camera`` equals JAX's, ``/info`` agrees, and a ``/render``
  frame is within 1 of JAX's;
- the port's ``train`` with a bridge on the tiny COLMAP scene for 3
  iterations serves one frame per iteration.
"""
import io
import json
import socket
import sys
import threading
import time
import urllib.request

import numpy as np
import pytest
import torch

from gsplat_tpu.config import PipelineConfig as JaxPipelineConfig
from gsplat_tpu.scene import ply as jply
from gsplat_tpu.train import trainer as jtrainer
from gsplat_tpu.viewer import network_gui as jgui
from gsplat_tpu.viewer import web as jweb
from gsplat_tpu_torch.config import (ModelConfig, OptimizationConfig,
                                     PipelineConfig, RasterizerConfig)
from gsplat_tpu_torch.core.camera import CameraView
from gsplat_tpu_torch.train import loop as tloop
from gsplat_tpu_torch.train import trainer as ttrainer
from gsplat_tpu_torch.viewer import network_gui as tgui
from gsplat_tpu_torch.viewer import web as tweb

from torch_parity import (CAM_FIELDS, configs, make_colmap_scene, make_scene,
                          port_scene, t2n)

W, H = 64, 32
FOVX, FOVY = 0.9, 0.7
TIMEOUT = 240


@pytest.fixture(autouse=True)
def _no_tensorboard(monkeypatch):
    """The loop's telemetry mirrors its scalars to TensorBoard when it
    imports, which loads TensorFlow here (about 17 s a process); the loop
    under the bridge does not need it."""
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)


def _payload(R, T, w=W, h=H, **over):
    """A SIBR client request for the COLMAP-convention camera (R, T): the
    matrices in the client's row-vector layout with its y/z column signs."""
    cv = CameraView.create(R, np.asarray(T, np.float64), FOVX, FOVY,
                           device="cpu")
    view = t2n(cv.world_view).T.copy()
    view[:, 1:3] *= -1
    proj = t2n(cv.full_proj).T.copy()
    proj[:, 1] *= -1
    return {"resolution_x": w, "resolution_y": h, "train": False,
            "fov_y": FOVY, "fov_x": FOVX, "z_near": 0.01, "z_far": 100.0,
            "shs_python": False, "rot_scale_python": False,
            "keep_alive": False, "scaling_modifier": 1.0,
            "view_matrix": view.flatten().tolist(),
            "view_projection_matrix": proj.flatten().tolist(), **over}


def _recv_exact(s, n):
    buf = b""
    while len(buf) < n:
        chunk = s.recv(n - len(buf))
        if not chunk:
            raise ConnectionError("connection closed early")
        buf += chunk
    return buf


def _client(port, payloads, frames, connected=None):
    """Send each request after the previous frame arrived; keep the frames
    (H,W,3 uint8) in ``frames``; close."""
    with socket.create_connection(("127.0.0.1", port),
                                  timeout=TIMEOUT) as s:
        if connected is not None:
            connected.set()
        for p in payloads:
            data = json.dumps(p).encode()
            s.sendall(len(data).to_bytes(4, "little") + data)
            h, w = p["resolution_y"], p["resolution_x"]
            img = _recv_exact(s, w * h * 3)
            n = int.from_bytes(_recv_exact(s, 4), "little")
            _recv_exact(s, n)
            frames.append(np.frombuffer(img, np.uint8).reshape(h, w, 3))


def _serve(gui, payloads, poll):
    """Run a client for ``payloads`` against ``gui``, calling ``poll()``
    until it has every frame (or the client ended)."""
    frames = []
    port = gui.listener.getsockname()[1]
    t = threading.Thread(target=_client, args=(port, payloads, frames))
    t.start()
    deadline = time.time() + TIMEOUT
    while len(frames) < len(payloads) and t.is_alive() \
            and time.time() < deadline:
        poll()
        time.sleep(0.01)
    t.join(timeout=30)
    assert not t.is_alive()
    return frames


def test_bridge_frames_match_jax(rng):
    g, cam = make_scene(rng, n=100)
    jcfg, tcfg = configs(32, 32, 64)
    tg, _ = port_scene(g, cam)
    payloads = [_payload(np.eye(3), np.zeros(3)),
                _payload(np.eye(3), np.zeros(3), shs_python=True,
                         rot_scale_python=True)]
    bg = np.zeros(3, np.float32)

    jserver = jgui.NetworkGUI("127.0.0.1", 0)
    jstate = jtrainer.init_state(g, 1)
    want = _serve(jserver, payloads, lambda: jserver.poll(
        jstate, object(), JaxPipelineConfig(), jcfg, bg, iteration=1,
        max_iterations=10))
    jserver.listener.close()

    tserver = tgui.NetworkGUI("127.0.0.1", 0, device="cpu")
    tstate = ttrainer.init_state(tg, 1)
    try:
        got = _serve(tserver, payloads, lambda: tserver.poll(
            tstate, object(), PipelineConfig(), tcfg, bg, iteration=1,
            max_iterations=10))
    finally:
        tserver.close()
    assert len(want) == len(got) == 2
    for a, b in zip(got, want):
        assert a.shape == (H, W, 3) and a.std() > 0
        assert np.abs(a.astype(int) - b.astype(int)).max() <= 1
    assert np.abs(got[1].astype(int) - got[0].astype(int)).max() <= 1


def test_bridge_render_error_raises_and_protocol_error_drops(rng,
                                                            monkeypatch):
    g, cam = make_scene(rng, n=50)
    tg, _ = port_scene(g, cam)
    state = ttrainer.init_state(tg, 1)
    _, tcfg = configs(32, 32, 64)
    server = tgui.NetworkGUI("127.0.0.1", 0, device="cpu")
    port = server.listener.getsockname()[1]
    args = (state, object(), PipelineConfig(), tcfg, np.zeros(3, np.float32),
            1, 10)
    try:
        # a request that is not JSON: the client is dropped, poll returns
        with socket.create_connection(("127.0.0.1", port)) as s:
            s.sendall((5).to_bytes(4, "little") + b"{nope")
            server.poll(*args)
            assert server.conn is None
        # a render that fails: the error leaves poll
        def broken(*a, **kw):
            raise RuntimeError("kernel failure")
        monkeypatch.setattr(server, "_render_frame", broken)
        with socket.create_connection(("127.0.0.1", port)) as s:
            data = json.dumps(_payload(np.eye(3), np.zeros(3))).encode()
            s.sendall(len(data).to_bytes(4, "little") + data)
            with pytest.raises(RuntimeError, match="kernel failure"):
                server.poll(*args)
    finally:
        server.close()


def test_web_viewer_matches_jax(tmp_path, rng):
    g, _ = make_scene(rng, n=80)
    p = str(tmp_path / "point_cloud.ply")
    jply.save_gaussian_ply(
        p, np.asarray(g.xyz), np.asarray(g.f_dc), np.asarray(g.f_rest),
        np.asarray(g.opacity), np.asarray(g.scaling), np.asarray(g.rotation))
    center = np.array([0.1, -0.2, 5.0])
    jcam = jweb._orbit_camera(center, 0.3, 0.1, 6.0, 1.0, 0.8)
    tcam = tweb._orbit_camera(center, 0.3, 0.1, 6.0, 1.0, 0.8, device="cpu")
    for k in CAM_FIELDS:
        np.testing.assert_array_equal(np.asarray(getattr(jcam, k)),
                                      np.asarray(getattr(tcam, k)))

    from PIL import Image
    query = "/render?theta=0.3&phi=0.1&r=6&w=64&h=48"
    out = []
    for server in (jweb.ViewerServer(jweb.load_gaussians_from_ply(p),
                                     port=0),
                   tweb.ViewerServer(tweb.load_gaussians_from_ply(
                       p, device="cpu"), port=0, device="cpu")):
        t = threading.Thread(target=server.serve_forever, daemon=True)
        t.start()
        base = f"http://127.0.0.1:{server.port}"
        try:
            page = urllib.request.urlopen(base + "/", timeout=TIMEOUT).read()
            info = json.loads(urllib.request.urlopen(
                base + "/info", timeout=TIMEOUT).read())
            frame = urllib.request.urlopen(base + query,
                                           timeout=TIMEOUT).read()
        finally:
            server.shutdown()
        t.join(timeout=30)
        out.append((page, info, np.asarray(Image.open(io.BytesIO(frame)))))
    (jpage, jinfo, jimg), (tpage, tinfo, timg) = out
    assert tpage == jpage and b"canvas" in tpage
    assert tinfo["n"] == jinfo["n"] == 80
    np.testing.assert_allclose(tinfo["center"], jinfo["center"], rtol=1e-6)
    assert tinfo["extent"] == pytest.approx(jinfo["extent"], rel=1e-6)
    assert timg.shape == (48, 64, 3) and timg.std() > 0
    assert np.abs(timg.astype(int) - jimg.astype(int)).max() <= 1


def test_train_serves_one_bridge_frame_per_iteration(tmp_path, rng):
    src = make_colmap_scene(str(tmp_path / "scene"), rng=rng)
    iters = 3
    server = tgui.NetworkGUI("127.0.0.1", 0, device="cpu")
    port = server.listener.getsockname()[1]
    # camera 0 of the scene: at (0, 0, -3), looking at the cloud
    payloads = [_payload(np.eye(3), [0.0, 0.0, 3.0], train=True)] * iters
    frames, connected = [], threading.Event()
    t = threading.Thread(target=_client,
                         args=(port, payloads, frames, connected))
    t.start()
    assert connected.wait(TIMEOUT)
    try:
        tloop.train(ModelConfig(source_path=src,
                                model_path=str(tmp_path / "model"),
                                sh_degree=1),
                    OptimizationConfig(iterations=iters), PipelineConfig(),
                    RasterizerConfig(), [], [], [], quiet=True,
                    network_gui_server=server, device="cpu")
    finally:
        server.close()
    t.join(timeout=30)
    assert not t.is_alive()
    assert len(frames) == iters
    assert all(f.shape == (H, W, 3) and f.std() > 0 for f in frames)
