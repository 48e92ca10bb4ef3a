"""Port parity of the split renders and gaussian-sharded storage with one
part per rank (``gsplat_tpu_torch.parallel.RankParts``) over a real gloo
process group: 2 ranks on localhost, each a process of
tests/torch_dist_worker.py (which imports no JAX), spawned once for every
job of this file. The JAX references run here, once per case, on 2 of
conftest's virtual CPU devices: a mesh of as many parts as there are
ranks.

Gates, those of the JAX tests ported:
- the slab render (tests/test_parallel.py:163): image and invdepth within
  atol 1e-3 of JAX's 2-slab render, no overflow;
- the slab gradients (tests/test_parallel.py:190): d sum(image²) / d xyz
  within rtol 1e-3 / atol 5e-4 of JAX's;
- the band render: image and invdepth within the image gate (rtol 2e-4 /
  atol 2e-5) of JAX's 2-band render, the pairs equal; its gradient within
  the gradient gate (rtol 5e-3 / atol 1e-6) of the port's single render's;
- the trap: with the image gather's backward summing the parts'
  cotangents (where each part must take its own slice) the band gradient
  comes out 2x, which the gate above rejects;
- sharded storage, per transient: the render (tests/test_parallel.py:226)
  within rtol 1e-6 / atol 1e-7 of JAX's, radii equal, each rank holding
  160 of the 320 rows; one train step (tests/test_parallel.py:266): JAX's
  loss within rtol 1e-6, xyz rtol 1e-3 / atol 5e-4, denom equal,
  xyz_gradient_accum rtol 1e-4 / atol 1e-8, every per-gaussian tensor
  (parameters, Adam's moments, statistics) at 64 of 128 rows a rank;
- the ring across a process boundary (tests/test_multihost.py:134): both
  ranks agree on loss and xyz checksum and match JAX's one-process step
  within rtol 1e-5 (loss) and 1e-4 (checksum);
- images bit for bit the local-list form (the same parts one after another
  in one process), in every render above; the step's loss too;
- the loop, ``train(..., shard_gaussians=True)`` on 2 ranks with a densify
  event that outgrows the capacity: the ranks' rows, gathered, equal the
  one-process ``n_shards=2`` loop's state bit for bit; rank 0's checkpoint
  and PLY equal that loop's files, its log too (the evaluation rendered
  through the sharded render); rank 1 writes nothing;
- every point-to-point call (``parallel.exchange``: a ring step, a
  densify event, a capacity growth) posts its receives and sends as one
  batch, and each rank gets what its peers sent;
- the same renders, gradients and steps with the config's ``row_cull``
  (per-tile-row ellipse culling) against JAX's culled ones at the same
  gates, images bit for bit the local-list form;
- the SIBR bridge under rank-sharded storage: rank 0's client pauses
  training (a kernel-path frame and a python-path frame), trains on one
  frame per iteration and keeps the last iteration alive, or drops in the
  middle of a request; every rank renders each frame (on 2 ranks, and on 4
  in the data 2 x prim 2 layout), every frame the client got equals the
  sharded render of the gathered state over a local list in one process
  bit for bit and ``render``'s within 1 in uint8, and every rank reaches
  the end;
- ``n_shards > 1`` under a process group raises and names torchrun; a
  bridge handed to a rank other than 0 under rank-sharded storage raises.
"""
import functools
import json
import os
import random
import socket
import sys
import threading
import time

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec

from gsplat_tpu.config import OptimizationConfig as JaxOptimizationConfig
from gsplat_tpu.parallel import prim_shard as jprim
from gsplat_tpu.parallel import sharded as jsh
from gsplat_tpu.parallel import tile_shard as jtile
from gsplat_tpu.parallel.mesh import make_mesh as jmake_mesh
from gsplat_tpu.train import trainer as jtrainer
from gsplat_tpu_torch import config as tcfg
from gsplat_tpu_torch.ops import rasterize as tras
from gsplat_tpu_torch.parallel import mesh as tmesh
from gsplat_tpu_torch.train import checkpoint as tckpt
from gsplat_tpu_torch.train import loop as tloop

from test_torch_dp import gathered
from test_torch_viewer import H as VIEW_H, W as VIEW_W, _payload, _recv_exact
from torch_parity import (CAM_FIELDS, PARAM_FIELDS, SMALL, configs,
                          free_port, make_colmap_scene, make_scene,
                          port_scene, spawn, state_to_numpy, t2n, to_numpy)

TH, TW, CHUNK = SMALL[:3]
RCFG = dict(tile_h=TH, tile_w=TW, chunk=CHUNK, pairs_per_gaussian=24.0)
RCFG_CULL = dict(RCFG, row_cull=True)
N = 2                                   # ranks, and the JAX mesh's parts
IMG_TOL = dict(rtol=2e-4, atol=2e-5)
GRAD_TOL = dict(rtol=5e-3, atol=1e-6)
TRANSIENTS = ("replicated", "ring", "slab")
# a densify event at 6 that outgrows 1,024 slots (about 1,000 points, a
# threshold every visible gaussian passes), a save, a checkpoint and an
# evaluation at the end
LOOP_OPT = dict(iterations=7, densify_from_iter=2, densification_interval=6,
                opacity_reset_interval=3000, densify_grad_threshold=1e-9)
LOOP_END = LOOP_OPT["iterations"]
RESUME_OPT = dict(LOOP_OPT, iterations=LOOP_END + 2)


def _mesh(axis):
    return jmake_mesh(((axis, N),), devices=jax.devices()[:N])


def _jcfg(cull=False):
    return configs(TH, TW, CHUNK, row_cull=cull)[0]


def _g_np(g):
    return to_numpy(g, PARAM_FIELDS)


def _render_job(kind, g, cam, W, H, bg, cull=False, **kw):
    return dict(kind=kind, g=_g_np(g), cam=to_numpy(cam, CAM_FIELDS), W=W,
                H=H, bg=np.full(3, bg, np.float32),
                rcfg=RCFG_CULL if cull else RCFG, **kw)


def _step_job(kind, g, cam, W, H, bg, transient, imgs=None, cull=False):
    job = dict(kind=kind, state=state_to_numpy(jtrainer.init_state(g, 1)),
               cam=to_numpy(cam, CAM_FIELDS), W=W, H=H,
               bg=np.full(3, bg, np.float32),
               rcfg=RCFG_CULL if cull else RCFG, transient=transient)
    if imgs is not None:
        job["imgs"] = imgs
    return job


# ------------------------------------------------------------ the cases

@functools.lru_cache(maxsize=None)
def _slab_case():
    """tests/test_parallel.py:163."""
    g, cam = make_scene(np.random.default_rng(0), n=400)
    return g, cam, TW, 4 * TH


@functools.lru_cache(maxsize=None)
def _slab_grad_case():
    """tests/test_parallel.py:190: opacity 0.2, so no cut fires."""
    import dataclasses
    from gsplat_tpu.core import transforms as jtf
    g, cam = make_scene(np.random.default_rng(0), n=200)
    g = dataclasses.replace(g, opacity=jnp.full_like(
        g.opacity, float(jtf.inverse_sigmoid(jnp.asarray(0.2)))))
    return g, cam, TW, 2 * TH


@functools.lru_cache(maxsize=None)
def _band_case():
    g, cam = make_scene(np.random.default_rng(1), n=300)
    return g, cam, TW, 8 * TH


@functools.lru_cache(maxsize=None)
def _render_case():
    """tests/test_parallel.py:226: 320 rows, 160 a rank."""
    g, cam = make_scene(np.random.default_rng(0), n=300, cap=320)
    return g, cam, TW, 8 * TH


def _unit_imgs(gt):
    H, W = gt.shape[1:]
    return [gt, np.ones((1, H, W), np.float32),
            np.zeros((1, H, W), np.float32), np.zeros((1, H, W), np.float32)]


@functools.lru_cache(maxsize=None)
def _step_case():
    """tests/test_parallel.py:266: 128 rows, 64 a rank."""
    rng = np.random.default_rng(0)
    W, H = TW, 8 * TH
    g, cam = make_scene(rng, n=100, cap=128)
    gt = rng.uniform(0, 1, (3, H, W)).astype(np.float32)
    return g, cam, W, H, _unit_imgs(gt)


@functools.lru_cache(maxsize=None)
def _ring_case():
    """tests/multihost_worker.py's sharded scene: 200 gaussians of opacity
    logit 1, 128x64, the ring transient."""
    from tests import multihost_worker as mw
    from gsplat_tpu.core.camera import CameraView as JaxCameraView
    W, H = 128, 64
    g = mw.build_scene(W, H)
    cam = JaxCameraView.create(R=np.eye(3), T=np.zeros(3), fovx=0.9,
                               fovy=0.7)
    gt = np.random.default_rng(0).uniform(0, 1, (3, H, W)).astype(np.float32)
    return g, cam, W, H, _unit_imgs(gt)


@pytest.fixture(scope="module")
def loop_scene(tmp_path_factory):
    root = tmp_path_factory.mktemp("shard_loop")
    return root, make_colmap_scene(str(root / "scene_1000"), n_pts=1000,
                                   n_cams=3)


def _loop_args(model, src):
    return (tcfg.ModelConfig(model_path=model, source_path=src, sh_degree=1,
                             eval=True),
            tcfg.OptimizationConfig(**LOOP_OPT), tcfg.PipelineConfig(),
            tcfg.RasterizerConfig(), [LOOP_END], [LOOP_END], [LOOP_END])


BRIDGE_ITERS = 3


def _bridge_client(port, got, done, drop=False):
    """A SIBR client of rank 0's bridge: it pauses training for a frame of
    each path (kernel, then python with a scaling modifier), then trains
    on one frame per iteration and keeps the last iteration alive for two
    more frames, and closes; with ``drop`` it hangs up in the middle of its
    third request instead. ``got`` collects the frames' bytes; it gives up
    connecting once ``done`` is set (the ranks have ended)."""
    while True:
        try:
            s = socket.create_connection(("127.0.0.1", port), timeout=240)
            break
        except OSError:
            if done.is_set():
                return
            time.sleep(0.05)

    def frame(**over):
        # camera 0 of the scene: at (0, 0, -3), looking at the cloud
        data = json.dumps(_payload(np.eye(3), [0.0, 0.0, 3.0],
                                   keep_alive=True, **over)).encode()
        s.sendall(len(data).to_bytes(4, "little") + data)
        got.append(_recv_exact(s, VIEW_W * VIEW_H * 3))
        _recv_exact(s, int.from_bytes(_recv_exact(s, 4), "little"))

    with s:
        frame(train=False)
        frame(train=False, shs_python=True, rot_scale_python=True,
              scaling_modifier=0.8)
        if drop:
            s.sendall((200).to_bytes(4, "little") + b'{"resolution_x"')
            return
        for _ in range(BRIDGE_ITERS + 2):
            frame(train=True)


def _bridge_job(model, src, port, **train_kw):
    return dict(kind="loop", model=model,
                model_kw=dict(source_path=src, sh_degree=1),
                opt_kw=dict(iterations=BRIDGE_ITERS), rcfg_kw={},
                hooks=([], [], []), gui_port=port,
                train_kw=dict(dict(shard_gaussians=True, data_parallel=False),
                              **train_kw))


def _with_clients(clients, done, run):
    """Run ``run()`` while the client threads serve; every client ends."""
    for t in clients:
        t.start()
    try:
        out = run()
    finally:
        done.set()
        for t in clients:
            t.join(timeout=60)
    assert not any(t.is_alive() for t in clients)
    return out


@pytest.fixture(scope="module")
def ranks(loop_scene):
    """Every job of this file on one gloo group of 2 ranks, and the
    bridge's clients' frames by job."""
    root, src = loop_scene
    jobs, clients, frames, done = {}, [], {}, threading.Event()
    for name, drop, transient in (("bridge", False, "ring"),
                                  ("bridge_drop", True, "replicated")):
        port = free_port()
        frames[name] = []
        clients.append(threading.Thread(
            target=_bridge_client, args=(port, frames[name], done, drop)))
        jobs[name] = _bridge_job(str(root / name), src, port,
                                 shard_transient=transient)
    g, cam, W, H = _slab_case()
    jobs["slab"] = _render_job("slab", g, cam, W, H, 0.25,
                               m_cap=int(g.capacity * 24 / 2))
    g, cam, W, H = _slab_grad_case()
    jobs["slab_grad"] = _render_job("slab", g, cam, W, H, 0.25, grad=True)
    g, cam, W, H = _band_case()
    jobs["band"] = _render_job("band", g, cam, W, H, 0.3, grad=True,
                               trap=True)
    for tr in TRANSIENTS:
        g, cam, W, H = _render_case()
        jobs[f"render_{tr}"] = _step_job("sharded_render", g, cam, W, H, 0.3,
                                         tr)
        g, cam, W, H, imgs = _step_case()
        jobs[f"step_{tr}"] = _step_job("sharded_step", g, cam, W, H, 0.0, tr,
                                       imgs)
    g, cam, W, H, imgs = _ring_case()
    jobs["multihost_ring"] = _step_job("sharded_step", g, cam, W, H, 0.0,
                                       "ring", imgs)
    jobs["exchange"] = dict(kind="exchange")
    model_kw = dict(source_path=src, sh_degree=1, eval=True)
    ranked = dict(shard_gaussians=True, data_parallel=False)
    jobs["loop"] = dict(kind="loop", model=str(root / "ranks"),
                        model_kw=model_kw, opt_kw=LOOP_OPT, rcfg_kw={},
                        hooks=([LOOP_END], [LOOP_END], [LOOP_END]),
                        train_kw=dict(ranked, capacity_multiplier=1.0,
                                      checkpoint_interval=LOOP_END))
    # every rank reads the one-process loop's checkpoint and keeps its rows
    jobs["resume"] = dict(kind="loop", model=str(root / "ranks_resumed"),
                          model_kw=model_kw, opt_kw=RESUME_OPT, rcfg_kw={},
                          hooks=([], [], []),
                          train_kw=dict(ranked, start_checkpoint=str(
                              root / "ranks" / f"chkpnt{LOOP_END}.npz")))
    jobs["debug"] = dict(kind="loop", model=str(root / "debug"),
                         model_kw=model_kw, opt_kw=dict(iterations=3),
                         rcfg_kw={}, hooks=([], [], []), nan_at=2,
                         train_kw=ranked)
    # the same renders, gradients and steps with row culling
    g, cam, W, H = _slab_case()
    jobs["slab_cull"] = _render_job("slab", g, cam, W, H, 0.25, cull=True,
                                    m_cap=int(g.capacity * 24 / 2))
    g, cam, W, H = _slab_grad_case()
    jobs["slab_grad_cull"] = _render_job("slab", g, cam, W, H, 0.25,
                                         cull=True, grad=True)
    g, cam, W, H = _band_case()
    jobs["band_cull"] = _render_job("band", g, cam, W, H, 0.3, cull=True,
                                    grad=True)
    for tr in TRANSIENTS:
        g, cam, W, H = _render_case()
        jobs[f"render_cull_{tr}"] = _step_job("sharded_render", g, cam, W, H,
                                              0.3, tr, cull=True)
        g, cam, W, H, imgs = _step_case()
        jobs[f"step_cull_{tr}"] = _step_job("sharded_step", g, cam, W, H,
                                            0.0, tr, imgs, cull=True)
    results = _with_clients(clients, done, lambda: spawn(
        N, jobs, str(root / "group")))
    for r in results:
        r["clients"] = frames
    return results


@pytest.fixture(scope="module")
def ranks4(loop_scene):
    """The bridge on 4 ranks in JAX's 2-D layout, data 2 x prim 2."""
    root, src = loop_scene
    port, got, done = free_port(), [], threading.Event()
    client = threading.Thread(target=_bridge_client, args=(port, got, done))
    results = _with_clients([client], done, lambda: spawn(4, dict(
        bridge_2d=_bridge_job(str(root / "bridge_2d"), src, port,
                              data_parallel=True)), str(root / "group4")))
    return results, got


# --------------------------------------------------- the JAX references

@functools.lru_cache(maxsize=None)
def _jax_slab(cull=False):
    g, cam, W, H = _slab_case()
    img, inv, ovf = jax.jit(lambda g_, c_: jprim.render_prim_sharded(
        g_, c_, W, H, jnp.full(3, 0.25), _jcfg(cull), _mesh("prim"),
        m_cap=int(g.capacity * 24 / 2)))(g, cam)
    return np.asarray(img), np.asarray(inv), int(ovf)


@functools.lru_cache(maxsize=None)
def _jax_slab_grad(cull=False):
    import dataclasses
    g, cam, W, H = _slab_grad_case()

    def loss(xyz):
        img, _, _ = jprim.render_prim_sharded(
            dataclasses.replace(g, xyz=xyz), cam, W, H, jnp.full(3, 0.25),
            _jcfg(cull), _mesh("prim"))
        return jnp.sum(img ** 2)
    return np.asarray(jax.jit(jax.grad(loss))(g.xyz))


@functools.lru_cache(maxsize=None)
def _jax_band(cull=False):
    g, cam, W, H = _band_case()
    img, inv, pairs, ovf = jax.jit(lambda g_, c_: jtile.render_tile_sharded(
        g_, c_, W, H, jnp.full(3, 0.3), _jcfg(cull), _mesh("tile")))(g, cam)
    return np.asarray(img), np.asarray(inv), int(pairs), int(ovf)


@functools.lru_cache(maxsize=None)
def _jax_render(transient, cull=False):
    g, cam, W, H = _render_case()
    mesh = _mesh("prim")
    g_sh = jax.tree_util.tree_map(
        lambda x: jax.device_put(x, NamedSharding(
            mesh, PartitionSpec("prim") if hasattr(x, "shape") and x.ndim >= 1
            and x.shape[0] == g.capacity else PartitionSpec())), g)
    fn = jsh.make_sharded_render(mesh, image_width=W, image_height=H,
                                 cfg=_jcfg(cull), transient=transient)
    return jax.tree_util.tree_map(np.asarray, jax.jit(fn)(
        g_sh, cam, jnp.full(3, 0.3)))


def _jax_step_of(g, cam, W, H, imgs, transient, cull=False):
    mesh = _mesh("prim")
    step = jsh.make_sharded_train_step(
        mesh, image_width=W, image_height=H, opt=JaxOptimizationConfig(),
        rcfg=_jcfg(cull), spatial_lr_scale=1.0, transient=transient)
    s1, aux = step(jsh.shard_state(jtrainer.init_state(g, 1), mesh), cam,
                   *map(jnp.asarray, imgs), jnp.zeros(3))
    return state_to_numpy(s1), float(aux.loss)


@functools.lru_cache(maxsize=None)
def _jax_step(transient, cull=False):
    g, cam, W, H, imgs = _step_case()
    return _jax_step_of(g, cam, W, H, imgs, transient, cull)


# ------------------------------------------------------------ the tests

def _local_bits(ranks, job):
    """Every rank's image, invdepth and overflow equal the local-list
    form's bit for bit; returns rank 0's results."""
    for res in ranks:
        got, local = res[job]["ranks"], res[job]["local"]
        for k in ("image", "invdepth"):
            np.testing.assert_array_equal(got[k], local[k], err_msg=k)
        assert got["overflow"] == local["overflow"]
    return ranks[0][job]


def test_slab_render_over_ranks_matches_jax(ranks):
    res = _local_bits(ranks, "slab")["ranks"]
    img, inv, ovf = _jax_slab()
    assert res["overflow"] == ovf == 0
    np.testing.assert_allclose(res["image"], img, rtol=0, atol=1e-3)
    np.testing.assert_allclose(res["invdepth"], inv, rtol=0, atol=1e-3)
    assert float(res["image"].std()) > 0.01


def test_slab_gradients_over_ranks_match_jax(ranks):
    _local_bits(ranks, "slab_grad")
    want = _jax_slab_grad()
    for res in ranks:
        got = res["slab_grad"]
        np.testing.assert_allclose(got["ranks"]["grad"], want, rtol=1e-3,
                                   atol=5e-4)
        np.testing.assert_allclose(got["ranks"]["grad"],
                                   got["local"]["grad"], **GRAD_TOL)
    assert np.abs(want).max() > 1e-2


def _band_single_grad(cull=False):
    import dataclasses
    g, cam, W, H = _band_case()
    tg, tcam = port_scene(g, cam)
    xyz = tg.xyz.detach().requires_grad_()
    out = tras.render(dataclasses.replace(tg, xyz=xyz), tcam, W, H,
                      torch.full((3,), 0.3),
                      configs(TH, TW, CHUNK, row_cull=cull)[1])
    (torch.clamp(out.image, 0.0, 1.0) ** 2).sum().backward()
    return t2n(xyz.grad)


def test_band_render_over_ranks_matches_jax(ranks):
    res = _local_bits(ranks, "band")["ranks"]
    img, inv, _, ovf = _jax_band()
    assert res["overflow"] == ovf == 0
    np.testing.assert_allclose(res["image"], img, **IMG_TOL)
    np.testing.assert_allclose(res["invdepth"], inv, **IMG_TOL)
    want = _band_single_grad()
    for r in ranks:
        np.testing.assert_allclose(r["band"]["ranks"]["grad"], want,
                                   **GRAD_TOL)


def test_summing_image_gather_backward_doubles_the_gradient(ranks):
    """The trap: the bands' gather must hand each rank its own slice of the
    cotangent. Summed instead (the backward of an all-gather in
    torch.distributed.nn), every rank's identical loss counts D times."""
    want = _band_single_grad()
    for r in ranks:
        got = r["band"]["trap"]
        np.testing.assert_allclose(got, N * r["band"]["ranks"]["grad"],
                                   rtol=1e-5, atol=1e-7)
        with pytest.raises(AssertionError):
            np.testing.assert_allclose(got, want, **GRAD_TOL)


@pytest.mark.parametrize("transient", TRANSIENTS)
def test_sharded_render_over_ranks_matches_jax(ranks, transient):
    job = f"render_{transient}"
    want = _jax_render(transient)
    for res in ranks:
        assert res[job]["rows"] == 160
    _local_bits(ranks, job)
    got = ranks[0][job]["ranks"]
    assert got["overflow"] == 0 and got["num_pairs"] == int(want.num_pairs)
    np.testing.assert_allclose(got["image"], want.image, rtol=1e-6,
                               atol=1e-7)
    np.testing.assert_allclose(got["invdepth"], want.invdepth, rtol=1e-6,
                               atol=1e-7)
    radii = np.concatenate([r[job]["ranks"]["radii"] for r in ranks])
    np.testing.assert_array_equal(radii, want.radii)
    np.testing.assert_array_equal(radii, ranks[0][job]["local"]["radii"])


@pytest.mark.parametrize("transient", TRANSIENTS)
def test_sharded_step_over_ranks_matches_jax(ranks, transient):
    job = f"step_{transient}"
    want, loss = _jax_step(transient)
    for res in ranks:
        assert res[job]["rows"] == 64
        # the loss of a frame whose image is the local-list form's, bits
        assert res[job]["ranks"]["loss"] == res[job]["local"]["loss"]
        assert res[job]["ranks"]["overflow"] == 0
    items = _gathered_step(ranks, job)
    # every per-gaussian tensor of a rank's state: parameters, Adam's
    # moments, the densification statistics hold CAP/D rows
    for res in ranks:
        held = [(n, a) for n, a in res[job]["ranks"]["state"]
                if n.startswith((".gaussians.", ".adam.mu", ".adam.nu",
                                 ".stats."))
                and n != ".gaussians.active_sh_degree"]
        assert len(held) == 7 + 12 + 3
        assert all(a.shape[0] == 64 for _, a in held), held
    np.testing.assert_allclose(ranks[0][job]["ranks"]["loss"], loss,
                               rtol=1e-6)
    np.testing.assert_allclose(items[".gaussians.xyz"],
                               want["gaussians"]["xyz"], rtol=1e-3,
                               atol=5e-4)
    np.testing.assert_array_equal(items[".stats.denom"],
                                  want["stats"]["denom"])
    np.testing.assert_allclose(items[".stats.xyz_gradient_accum"],
                               want["stats"]["xyz_gradient_accum"],
                               rtol=1e-4, atol=1e-8)
    local = dict(ranks[0][job]["local"]["state"])
    np.testing.assert_allclose(items[".gaussians.xyz"],
                               local[".gaussians.xyz"], rtol=1e-3, atol=5e-4)


def _gathered_step(ranks, job):
    per = [{"x": {"state": r[job]["ranks"]["state"]}} for r in ranks]
    return gathered(per, "x", list(range(N)))


def test_ring_across_the_process_boundary_matches_one_process(ranks):
    """tests/test_multihost.py:134: the ring transient's slabs cross the
    boundary between the 2 rank processes; both agree, and match JAX's
    one-process step on a mesh of 2."""
    from tests import multihost_worker as mw
    got = [r["multihost_ring"]["ranks"] for r in ranks]
    assert got[0]["loss"] == got[1]["loss"]
    assert got[0]["checksum"] == got[1]["checksum"]
    loss_1, checksum_1 = mw.run_sharded_step(_mesh("prim"))
    np.testing.assert_allclose(got[0]["loss"], loss_1, rtol=1e-5)
    np.testing.assert_allclose(got[0]["checksum"], checksum_1, rtol=1e-4)


def test_exchange_posts_each_call_as_one_batch(ranks):
    """Each rank sends to and receives from its peer in one call (on NCCL,
    separate receives and sends between two ranks would wait on each
    other): every message arrives, the ring steps, and every call that
    moves anything hands all its receives and sends to one
    ``batch_isend_irecv``."""
    for r, res in enumerate(ranks):
        e = res["exchange"]
        peers = [j for j in range(N) if j != r]
        assert e["got"] == [[[10.0 * j + r] * 2] * (r + 1) for j in peers]
        assert e["ring"] == [[float(r)], [float((r - 1) % N)]]
        assert e["none"] == []
        one = sorted([("irecv", j) for j in peers]
                     + [("isend", j) for j in peers])
        assert e["batches"] == [one, one]     # the exchange, the ring step


def _log(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


def test_loop_over_ranks_is_the_one_process_sharded_loop(ranks, loop_scene,
                                                         monkeypatch):
    """The 2-rank loop with a densify event that grows the capacity: the
    gathered state is the one-process ``n_shards=2`` loop's bit for bit,
    and so are rank 0's files; rank 1 wrote nothing."""
    root, src = loop_scene
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    random.seed(0)
    _, want = tloop.train(*_loop_args(str(root / "one"), src), quiet=True,
                          shard_gaussians=True, n_shards=2, device="cpu",
                          capacity_multiplier=1.0,
                          checkpoint_interval=LOOP_END)
    got = gathered(ranks, "loop", [0, 1])
    want = dict(tckpt.state_items(want))
    assert want[".gaussians.xyz"].shape[0] > 1024       # it grew
    assert dict(ranks[0]["loop"]["state"])[".gaussians.xyz"].shape[0] == \
        want[".gaussians.xyz"].shape[0] // 2
    assert set(got) == set(want)
    for name, a in want.items():
        np.testing.assert_array_equal(got[name], a, err_msg=name)
    assert ranks[1]["loop"]["writes"] == []
    for ck in (f"chkpnt{LOOP_END}.npz",
               os.path.join("checkpoints", f"step_{LOOP_END}.npz")):
        with np.load(root / "one" / ck) as a, \
                np.load(root / "ranks" / ck) as b:
            assert set(a.files) == set(b.files)
            for k in a.files:
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    ply = os.path.join("point_cloud", f"iteration_{LOOP_END}",
                       "point_cloud.ply")
    with open(root / "one" / ply, "rb") as a, \
            open(root / "ranks" / ply, "rb") as b:
        assert a.read() == b.read()
    for a, b in zip(_log(root / "one" / "training_log.jsonl"),
                    _log(root / "ranks" / "training_log.jsonl")):
        assert {k: v for k, v in a.items() if k not in ("t", "iter_time")} \
            == {k: v for k, v in b.items() if k not in ("t", "iter_time")}


def test_resume_over_ranks_keeps_each_ranks_rows(ranks, loop_scene,
                                                 monkeypatch):
    """Every rank reads the checkpoint and keeps its rows: 2 iterations
    resumed over the ranks equal the one-process resume bit for bit."""
    root, src = loop_scene
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    random.seed(0)
    args = list(_loop_args(str(root / "one_resumed"), src))
    args[1] = tcfg.OptimizationConfig(**RESUME_OPT)
    _, want = tloop.train(*args[:4], [], [], [], quiet=True,
                          start_checkpoint=str(
                              root / "ranks" / f"chkpnt{LOOP_END}.npz"),
                          shard_gaussians=True, n_shards=2, device="cpu")
    got = gathered(ranks, "resume", [0, 1])
    for name, a in tckpt.state_items(want):
        np.testing.assert_array_equal(got[name], a, err_msg=name)
    assert got[".step"] == LOOP_END + 2
    assert ranks[1]["resume"]["writes"] == []


def test_debug_snapshot_over_ranks_holds_the_whole_state(ranks, loop_scene):
    """A non-finite loss under ``--debug``: both ranks raise, and rank 0
    alone writes the snapshot, with the rows of every rank gathered."""
    root, _ = loop_scene
    for res in ranks:
        assert "non-finite loss nan" in res["debug"]["raised"]
    assert ranks[1]["debug"]["writes"] == []
    snap = np.load(root / "debug" / "snapshot_iter2.npz")
    # 1,000 points at capacity x4: 4,096 rows, 2,048 a rank
    assert snap["state.gaussians.xyz"].shape[0] == 4096
    assert snap["state.adam.mu['xyz']"].shape[0] == 4096
    assert int(snap["state.step"]) == 1


def test_shards_under_a_process_group_raises(monkeypatch, tmp_path):
    """``--shards K > 1`` is the one-process form: under a group it raises
    before anything is read or written, and names torchrun."""
    monkeypatch.setattr(tmesh, "world", lambda: (0, 2))
    with pytest.raises(ValueError, match="torchrun --nproc_per_node"):
        tloop.train(*_loop_args(str(tmp_path / "m"), str(tmp_path)),
                    shard_gaussians=True, n_shards=2, device="cpu")
    assert not any(tmp_path.iterdir())


def test_bridge_under_rank_sharded_storage_raises(monkeypatch, tmp_path):
    """Rank 0 alone owns the bridge's socket, also under rank-sharded
    storage: a bridge handed to another rank raises before anything is
    read or written."""
    monkeypatch.setattr(tmesh, "world", lambda: (1, 2))
    with pytest.raises(ValueError, match="served by rank 0 alone"):
        tloop.train(*_loop_args(str(tmp_path / "m"), str(tmp_path)),
                    shard_gaussians=True, network_gui_server=object(),
                    device="cpu")
    assert not any(tmp_path.iterdir())


# ------------------------------------------------- row culling over ranks

def test_culled_slab_and_band_over_ranks_match_jax(ranks):
    res = _local_bits(ranks, "slab_cull")["ranks"]
    img, inv, ovf = _jax_slab(cull=True)
    assert res["overflow"] == ovf == 0
    np.testing.assert_allclose(res["image"], img, rtol=0, atol=1e-3)
    np.testing.assert_allclose(res["invdepth"], inv, rtol=0, atol=1e-3)
    _local_bits(ranks, "slab_grad_cull")
    want = _jax_slab_grad(cull=True)
    for r in ranks:
        got = r["slab_grad_cull"]
        np.testing.assert_allclose(got["ranks"]["grad"], want, rtol=1e-3,
                                   atol=5e-4)
        np.testing.assert_allclose(got["ranks"]["grad"],
                                   got["local"]["grad"], **GRAD_TOL)
    res = _local_bits(ranks, "band_cull")["ranks"]
    img, inv, _, ovf = _jax_band(cull=True)
    assert res["overflow"] == ovf == 0
    np.testing.assert_allclose(res["image"], img, **IMG_TOL)
    np.testing.assert_allclose(res["invdepth"], inv, **IMG_TOL)
    want = _band_single_grad(cull=True)
    for r in ranks:
        np.testing.assert_allclose(r["band_cull"]["ranks"]["grad"], want,
                                   **GRAD_TOL)


@pytest.mark.parametrize("transient", TRANSIENTS)
def test_culled_sharded_render_and_step_over_ranks_match_jax(ranks,
                                                             transient):
    job = f"render_cull_{transient}"
    want = _jax_render(transient, cull=True)
    _local_bits(ranks, job)
    got = ranks[0][job]["ranks"]
    assert got["overflow"] == 0 and got["num_pairs"] == int(want.num_pairs)
    assert got["num_pairs"] < ranks[0][f"render_{transient}"]["ranks"][
        "num_pairs"]
    np.testing.assert_allclose(got["image"], want.image, rtol=1e-6,
                               atol=1e-7)
    job = f"step_cull_{transient}"
    want, loss = _jax_step(transient, cull=True)
    for res in ranks:
        assert res[job]["ranks"]["loss"] == res[job]["local"]["loss"]
        assert res[job]["ranks"]["overflow"] == 0
    items = _gathered_step(ranks, job)
    np.testing.assert_allclose(ranks[0][job]["ranks"]["loss"], loss,
                               rtol=1e-6)
    np.testing.assert_allclose(items[".gaussians.xyz"],
                               want["gaussians"]["xyz"], rtol=1e-3,
                               atol=5e-4)
    np.testing.assert_array_equal(items[".stats.denom"],
                                  want["stats"]["denom"])
    np.testing.assert_allclose(items[".stats.xyz_gradient_accum"],
                               want["stats"]["xyz_gradient_accum"],
                               rtol=1e-4, atol=1e-8)


# ------------------------------------- the bridge under rank-sharded storage

def _assert_bridge_frames(results, job, client_frames, n_ranks):
    """Every frame the client got is the one rank 0 rendered with every
    rank, equal to the one-process sharded render of the gathered state bit
    for bit and to ``render``'s within 1 in uint8; every rank trained to
    the end."""
    frames = results[0][job]["frames"]
    assert len(frames) == len(client_frames)
    for f, raw in zip(frames, client_frames):
        np.testing.assert_array_equal(
            np.frombuffer(raw, np.uint8).reshape(f["client"].shape),
            f["client"])
        np.testing.assert_array_equal(f["client"], f["local"])
        assert np.abs(f["client"].astype(int)
                      - f["single"].astype(int)).max() <= 1
        assert f["client"].std() > 0
    assert [f["sh_python"] for f in frames[:2]] == [False, True]
    for r in range(n_ranks):
        if r:
            assert results[r][job]["frames"] is None
            assert results[r][job]["polls"] == []
        assert dict(results[r][job]["state"])[".step"] == BRIDGE_ITERS
    return frames


def test_bridge_over_ranks_serves_pause_and_keep_alive(ranks):
    frames = _assert_bridge_frames(ranks, "bridge",
                                   ranks[0]["clients"]["bridge"], N)
    # 2 paused, one a training iteration, 2 more keeping the last alive
    assert len(frames) == 2 + BRIDGE_ITERS + 2
    assert frames[0]["rows"] == [2048, 2048]
    assert [it for it, _ in ranks[0]["bridge"]["polls"]] == [1, 2, 3]


def test_bridge_over_ranks_survives_a_client_that_drops(ranks):
    frames = _assert_bridge_frames(ranks, "bridge_drop",
                                   ranks[0]["clients"]["bridge_drop"], N)
    assert len(frames) == 2
    assert [it for it, _ in ranks[0]["bridge_drop"]["polls"]] == [1, 2, 3]


def test_bridge_over_ranks_in_the_2d_layout(ranks4):
    results, got = ranks4
    frames = _assert_bridge_frames(results, "bridge_2d", got, 4)
    assert len(frames) == 2 + BRIDGE_ITERS + 2
    assert frames[0]["rows"] == [2048, 2048]

