"""Port parity of camera data parallelism (gsplat_tpu_torch/parallel/mesh.py,
parallel/dp.py, ``parallel/sharded.py:make_sharded_dp_train_step`` and the
loop's data-parallel branches) over real process groups: gloo on the CPU,
2 or 4 ranks on localhost, each a process of tests/torch_dist_worker.py
(which imports no JAX). The JAX references run here, on conftest's virtual
CPU devices, with the mesh sizes of tests/test_parallel.py; each is computed
once per case and shared. Every rank's process has a deadline of
``RANK_TIMEOUT`` seconds and its group a collective timeout of its own, so
a hung rank fails its test.

Gates:
- the mesh helpers and ``init_distributed`` without its environment
  (tests/test_parallel.py:27);
- the DP step over 4 identical cameras (tests/test_parallel.py:97): loss
  within rtol 1e-5 of the port's single ``train_step`` and of JAX's
  ``make_dp_train_step``, xyz within rtol 1e-4 / atol 1e-7 of the single
  step's, denom 4x the single view's; against JAX the step gate of
  tests/test_torch_train.py (Adam's first step moves a parameter by ±lr, so
  a gradient within rounding of 0 may flip it: 2·lr there);
- the DP step over 2 distinct cameras (tests/test_parallel.py:138, made a
  parity test): with 2 ranks the sum g0 + g1 is exact in either order, so
  every rank's state equals the in-process reference bit for bit; against
  JAX the gradients (from Adam's first moment) and statistics within rtol
  5e-3 / atol 1e-6, the parameters within the step gate;
- the ranks agree (tests/test_multihost.py:34): 4 ranks on the multihost
  batch agree bit for bit on loss, xyz checksum and state, and match the
  same batch's step in one process within rtol 1e-5 (gloo's ring sums 4
  values in its own order);
- the 2-D step on JAX's layout, 4 ranks as data 2 x prim 2, each rank
  holding its prim coordinate's rows (tests/test_parallel.py:316, 369):
  against JAX's (2, 2) mesh and the port's single step, loss rtol 1e-5, xyz
  rtol 1e-3 / atol 5e-4, denom 2x, xyz_gradient_accum 2x within rtol 1e-3 /
  atol 1e-6; after a capacity growth, 96 rows per rank and a finite loss;
- the loop, ``train(..., data_parallel=True)`` on 2 ranks (8 iterations,
  one densify at 6, JAX's densify draws handed in) against JAX's ``train``
  on 2 devices: each rank's cameras are JAX's batch rows bit for bit, the
  logs within rtol 1e-4 (losses, PSNR; the rest equal), the ranks' final
  states equal bit for bit, and rank 1 writes nothing; the 2-D loop (4
  ranks, data 2 x prim 2, ring) for 3 iterations, the ranks of a prim
  coordinate equal, ranks 1-3 writing nothing; forced retries
  (the ample-capacity run's state bit for bit) and a forced capacity
  growth with equal rank states; the ``--debug`` snapshot of a NaN loss
  holding the whole batch, written by rank 0 alone;
- ``psum`` / ``pmean`` / ``pmax`` over both axes of a 2 x 2 mesh of 4
  ranks, float32 and int64 packed in one buffer;
- the train CLI on 2 ranks under torchrun's environment: both join, and
  train into rank 0's one new model directory.
"""
import dataclasses
import functools
import json
import os
import random
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from gsplat_tpu import config as jcfg
from gsplat_tpu.config import OptimizationConfig as JaxOptimizationConfig
from gsplat_tpu.core.camera import CameraView as JaxCameraView
from gsplat_tpu.models import gaussian_model as jgm
from gsplat_tpu.parallel import dp as jdp
from gsplat_tpu.parallel import sharded as jsh
from gsplat_tpu.parallel.mesh import make_mesh as jmake_mesh
from gsplat_tpu.train import loop as jloop
from gsplat_tpu.train import trainer as jtrainer
from gsplat_tpu_torch import config as tcfg
from gsplat_tpu_torch.config import OptimizationConfig
from gsplat_tpu_torch.parallel import dp as tdp
from gsplat_tpu_torch.parallel import mesh as tmesh
from gsplat_tpu_torch.train import checkpoint as tckpt
from gsplat_tpu_torch.train import loop as tloop
from gsplat_tpu_torch.train import trainer as ttrainer
from gsplat_tpu_torch.utils import general as tgeneral

from torch_parity import (CAM_FIELDS, REPO, SMALL, configs, launch,
                          make_colmap_scene, make_scene, port_scene, spawn,
                          state_to_numpy, t2n, to_numpy)
TH, TW, CHUNK = SMALL[:3]
RCFG = dict(tile_h=TH, tile_w=TW, chunk=CHUNK, pairs_per_gaussian=24.0)
GRAD_TOL = dict(rtol=5e-3, atol=1e-6)
TRAINABLE = ("xyz", "f_dc", "f_rest", "scaling", "rotation", "opacity")
LOOP_ITERS = 8
# one densify event (iteration 6), no opacity reset; a pair capacity of 4
# per gaussian, which the loop does not shrink at iteration 1 (each shrink
# rebuilds JAX's jitted step); no eval (JAX's eval renders are most of its
# run): the suite's time
LOOP_OPT = dict(iterations=LOOP_ITERS, densify_from_iter=2,
                densification_interval=6, opacity_reset_interval=3000)
LOOP_RCFG = dict(pairs_per_gaussian=4.0)


# ------------------------------------------------------------ the helpers

def test_mesh_helpers():
    """The shape logic of tests/test_parallel.py:27 over a world of 8
    ranks, the innermost axis varying fastest; one line group per axis."""
    names, sizes, grid = tmesh.mesh_layout((("data", -1),), 8)
    assert dict(zip(names, sizes)) == {"data": 8}
    names, sizes, grid = tmesh.mesh_layout((("data", 2), ("tile", -1)), 8)
    assert dict(zip(names, sizes)) == {"data": 2, "tile": 4}
    np.testing.assert_array_equal(grid, [[0, 1, 2, 3], [4, 5, 6, 7]])
    m = tmesh.Mesh(names, sizes, 6, groups={})
    assert m.shape == {"data": 2, "tile": 4}
    assert m.coords == {"data": 1, "tile": 2}
    with pytest.raises(ValueError, match="does not cover"):
        tmesh.mesh_layout((("data", 3),), 8)
    # outside a process group the mesh is one rank
    one = tmesh.make_mesh()
    assert one.shape == {"data": 1} and one.coords == {"data": 0}
    assert one.groups == {"data": None}


def test_init_distributed_is_a_no_op_without_the_environment(monkeypatch):
    for k in ("WORLD_SIZE", "RANK", "LOCAL_RANK"):
        monkeypatch.delenv(k, raising=False)
    assert tmesh.init_distributed(device="cpu") is False
    assert not torch.distributed.is_initialized()
    assert tmesh.world() == (0, 1)
    # with the environment, a card that is not there raises before joining
    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tmesh.init_distributed()
    assert not torch.distributed.is_initialized()


def test_local_card_never_wraps(monkeypatch):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    monkeypatch.setenv("LOCAL_RANK", "1")
    assert tgeneral.local_card() == torch.device("cuda", 1)
    monkeypatch.setenv("LOCAL_RANK", "2")
    with pytest.raises(RuntimeError, match="LOCAL_RANK 2 has no card"):
        tgeneral.local_card()
    monkeypatch.delenv("LOCAL_RANK")
    with pytest.raises(RuntimeError, match="torchrun"):
        tgeneral.local_card()


def test_data_parallel_in_one_process_with_several_cards_raises(
        monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    cfgs = (tcfg.ModelConfig(model_path=str(tmp_path)),
            tcfg.OptimizationConfig(), tcfg.PipelineConfig(),
            tcfg.RasterizerConfig(), [], [], [])
    with pytest.raises(ValueError, match="torchrun --nproc_per_node"):
        tloop.train(*cfgs, data_parallel=True)
    assert not any(tmp_path.iterdir())


def test_dp_step_of_one_rank_is_train_step(rng):
    """A mesh of one rank (no process group): the DP step is
    ``train_step`` bit for bit, aux included."""
    W, H = TW, 2 * TH
    g, cam = make_scene(rng, n=100, cap=128)
    tg, tcam = port_scene(g, cam)
    imgs = (torch.tensor(rng.uniform(0, 1, (3, H, W)).astype(np.float32)),
            torch.ones((1, H, W)), torch.zeros((1, H, W)),
            torch.zeros((1, H, W)), torch.zeros(3))
    kw = dict(image_width=W, image_height=H, opt=OptimizationConfig(),
              rcfg=tcfg.RasterizerConfig(**RCFG), spatial_lr_scale=1.0)
    s0 = ttrainer.init_state(tg, 1)
    step = tdp.make_dp_train_step(tmesh.make_mesh(), **kw)
    s1, aux = step(s0, tcam, *imgs)
    s1_ref, aux_ref = ttrainer.train_step(
        s0, tcam, *imgs, antialiasing=False, use_sparse_adam=False,
        train_test_exp=False, use_depth=False, **kw)
    for (n1, a), (n2, b) in zip(tckpt.state_items(s1),
                                tckpt.state_items(s1_ref)):
        assert n1 == n2
        np.testing.assert_array_equal(a, b, err_msg=n1)
    for a, b in zip(aux, aux_ref):
        assert torch.equal(a, b)


# ------------------------------------------------------- the rank groups

def _cam_np(cam):
    return to_numpy(cam, CAM_FIELDS)


def _step_job(state, cams, imgs, W, H, **kw):
    return dict(kind="step", state=state_to_numpy(state),
                cams=[_cam_np(c) for c in cams], imgs=imgs,
                bg=np.zeros(3, np.float32), W=W, H=H, rcfg=RCFG, **kw)


def _unit_imgs(gts):
    H, W = gts[0].shape[1:]
    return [(gt, np.ones((1, H, W), np.float32),
             np.zeros((1, H, W), np.float32),
             np.zeros((1, H, W), np.float32)) for gt in gts]


@functools.lru_cache(maxsize=None)
def _identical_case():
    """tests/test_parallel.py:97's inputs: 4 identical cameras."""
    rng = np.random.default_rng(0)
    W, H = TW, 2 * TH
    g, cam = make_scene(rng, n=100, cap=128)
    gt = rng.uniform(0, 1, (3, H, W)).astype(np.float32)
    return g, cam, gt, W, H


def _multihost_batch(n_batch, W=128, H=64, n=200):
    """tests/multihost_worker.py's scene and batch (seeds 7 and 0)."""
    rng = np.random.default_rng(7)
    pts = rng.standard_normal((n, 3)).astype(np.float32)
    pts[:, 2] += 5.0
    colors = rng.uniform(0.05, 0.95, (n, 3)).astype(np.float32)
    g = jgm.create_from_pcd(pts, colors, max_sh_degree=1, capacity=n)
    g = dataclasses.replace(g, opacity=g.opacity.at[:].set(1.0),
                            active_sh_degree=jnp.asarray(1, jnp.int32))
    cams = []
    for i in range(n_batch):
        a = 0.1 * i
        R = np.array([[np.cos(a), 0, np.sin(a)], [0, 1, 0],
                      [-np.sin(a), 0, np.cos(a)]])
        cams.append(JaxCameraView.create(R=R, T=np.zeros(3), fovx=0.9,
                                         fovy=0.7))
    gts = np.random.default_rng(0).uniform(
        0, 1, (n_batch, 3, H, W)).astype(np.float32)
    return g, cams, gts, W, H


@functools.lru_cache(maxsize=None)
def _distinct_case():
    """tests/test_parallel.py:138's inputs on 2 devices: the camera centre
    moved by 0.01 per camera."""
    rng = np.random.default_rng(0)
    W, H = TW, TH
    g, cam = make_scene(rng, n=64, cap=64)
    cams = [dataclasses.replace(cam, camera_center=cam.camera_center
                                + 0.01 * i) for i in range(2)]
    gts = rng.uniform(0, 1, (2, 3, H, W)).astype(np.float32)
    return g, cams, gts, W, H


@functools.lru_cache(maxsize=None)
def _sharded_case(h_tiles):
    """tests/test_parallel.py:316 / 369's inputs."""
    rng = np.random.default_rng(0)
    W, H = TW, h_tiles * TH
    g, cam = make_scene(rng, n=100, cap=128)
    gt = rng.uniform(0, 1, (3, H, W)).astype(np.float32)
    return g, cam, gt, W, H


@pytest.fixture(scope="module")
def four_ranks(loop_scene):
    root, src = loop_scene
    g, cam, gt, W, H = _identical_case()
    jobs = dict(identical=_step_job(jtrainer.init_state(g, 4), [cam] * 4,
                                    _unit_imgs([gt] * 4), W, H))
    g, cams, gts, W, H = _multihost_batch(4)
    jobs["agree"] = _step_job(jtrainer.init_state(g, 4), cams,
                              _unit_imgs(list(gts)), W, H, reference=True)
    jobs["collectives"] = dict(kind="collectives")
    # JAX's 2-D layout: data 2 x prim 2, rank r at (r // 2, r % 2)
    g, cam, gt, W, H = _sharded_case(8)
    jobs["sharded"] = _step_job(jtrainer.init_state(g, 1), [cam] * 2,
                                _unit_imgs([gt] * 2), W, H, layout="2d")
    g, cam, _, W, H = _sharded_case(4)
    gts = np.random.default_rng(1).uniform(0, 1, (2, 3, H, W)).astype(
        np.float32)
    jobs["grown"] = _step_job(jtrainer.init_state(g, 1), [cam] * 2,
                              _unit_imgs(list(gts)), W, H, layout="2d",
                              grow_to=192)
    jobs["loop_2d"] = dict(kind="loop", model=str(root / "sharded"),
                           model_kw=dict(source_path=src, sh_degree=1,
                                         eval=True),
                           opt_kw=dict(iterations=3), rcfg_kw={},
                           hooks=([], [3], []),
                           train_kw=dict(shard_gaussians=True,
                                         shard_transient="ring"))
    return spawn(4, jobs, str(root / "four_ranks"))


def _jax_noise(key, cap):
    return (np.asarray(jax.random.normal(key, (cap, 3))),
            np.asarray(jax.random.normal(jax.random.fold_in(key, 1),
                                         (cap, 3))))


@pytest.fixture(scope="module")
def loop_scene(tmp_path_factory):
    root = tmp_path_factory.mktemp("dp_loop")
    return root, make_colmap_scene(str(root / "scene"))


# the forced cases of tests/test_torch_loop.py on 2 ranks: a pair list far
# too small for the frame (and an ample one), a capacity a densify event
# outgrows (about 1,000 points in 1,024 slots, a threshold every visible
# gaussian passes)
RETRY_OPT = dict(iterations=4, densify_from_iter=2, densification_interval=6,
                 opacity_reset_interval=3000)
GROWTH_OPT = dict(RETRY_OPT, iterations=7, densify_grad_threshold=1e-9)


@pytest.fixture(scope="module")
def two_ranks(loop_scene):
    root, src = loop_scene
    g, cams, gts, W, H = _distinct_case()
    jobs = dict(distinct=_step_job(jtrainer.init_state(g, 2), cams,
                                   _unit_imgs(list(gts)), W, H,
                                   reference=True))
    # the loop: 120 points in 1,024 slots; JAX splits PRNGKey(0) once per
    # densify event (no random background), and its draws are handed in
    _, sub = jax.random.split(jax.random.PRNGKey(0))
    model_kw = dict(source_path=src, sh_degree=1, eval=True)
    jobs["loop"] = dict(kind="loop", model=str(root / "port"),
                        model_kw=model_kw, opt_kw=LOOP_OPT,
                        rcfg_kw=LOOP_RCFG, hooks=([], [LOOP_ITERS], []),
                        noise=[_jax_noise(sub, 1024)])
    jobs["debug"] = dict(kind="loop", model=str(root / "debug"),
                         model_kw=model_kw, opt_kw=dict(iterations=3),
                         rcfg_kw={}, hooks=([], [], []), nan_at=2)
    for name, ppg in (("retry_small", 0.05), ("retry_ample", 40.0)):
        jobs[name] = dict(kind="loop", model=str(root / name),
                          model_kw=model_kw, opt_kw=RETRY_OPT,
                          rcfg_kw=dict(pairs_per_gaussian=ppg),
                          hooks=([], [], []))
    jobs["growth"] = dict(
        kind="loop", model=str(root / "growth"), opt_kw=GROWTH_OPT,
        model_kw=dict(model_kw, source_path=make_colmap_scene(
            str(root / "scene_1000"), n_pts=1000, n_cams=3)),
        rcfg_kw={}, hooks=([], [], []),
        train_kw=dict(capacity_multiplier=1.0))
    return spawn(2, jobs, str(root / "ranks"))


# --------------------------------------------------- the JAX references

def _jax_mesh(axes, n):
    return jmake_mesh(axes, devices=jax.devices()[:n])


def _jax_batch(cams, gts):
    H, W = gts[0].shape[1:]
    B = len(cams)
    return (jdp.stack_camera_batch(cams), jnp.asarray(np.stack(gts)),
            jnp.ones((B, 1, H, W)), jnp.zeros((B, 1, H, W)),
            jnp.zeros((B, 1, H, W)), jnp.zeros(3))


def _jax_dp(g, cams, gts, W, H):
    n = len(cams)
    step = jdp.make_dp_train_step(
        _jax_mesh((("data", n),), n), image_width=W, image_height=H,
        opt=JaxOptimizationConfig(), rcfg=configs(TH, TW, CHUNK)[0],
        spatial_lr_scale=1.0)
    s1, aux = step(jtrainer.init_state(g, n), *_jax_batch(cams, gts))
    return state_to_numpy(s1), float(aux.loss)


@functools.lru_cache(maxsize=None)
def _jax_identical():
    g, cam, gt, W, H = _identical_case()
    return _jax_dp(g, [cam] * 4, [gt] * 4, W, H)


@functools.lru_cache(maxsize=None)
def _jax_distinct():
    g, cams, gts, W, H = _distinct_case()
    return _jax_dp(g, cams, list(gts), W, H)


@functools.lru_cache(maxsize=None)
def _jax_sharded_dp():
    g, cam, gt, W, H = _sharded_case(8)
    mesh = _jax_mesh((("data", 2), ("prim", 2)), 4)
    step = jsh.make_sharded_dp_train_step(
        mesh, image_width=W, image_height=H, opt=JaxOptimizationConfig(),
        rcfg=configs(TH, TW, CHUNK)[0], spatial_lr_scale=1.0)
    s1, aux = step(jsh.shard_state(jtrainer.init_state(g, 1), mesh),
                   *_jax_batch([cam] * 2, [gt] * 2))
    return state_to_numpy(s1), float(aux.loss)


def _port_single(g, cam, gt, W, H, state=None):
    tg, tcam = port_scene(g, cam)
    s0 = state or ttrainer.init_state(tg, 1)
    return ttrainer.train_step(
        s0, tcam, torch.tensor(gt), torch.ones((1, H, W)),
        torch.zeros((1, H, W)), torch.zeros((1, H, W)), torch.zeros(3),
        image_width=W, image_height=H, opt=OptimizationConfig(),
        rcfg=tcfg.RasterizerConfig(**RCFG), spatial_lr_scale=1.0,
        antialiasing=False, use_sparse_adam=False, train_test_exp=False,
        use_depth=False)


def _items(res):
    return dict(res["state"])


def _assert_ranks_equal(results, job, ranks=None):
    """The states of ``ranks`` (all by default) equal bit for bit."""
    ranks = list(range(len(results))) if ranks is None else ranks
    first = results[ranks[0]][job]["state"]
    for r in ranks[1:]:
        for (n1, a), (n2, b) in zip(first, results[r][job]["state"]):
            assert n1 == n2
            np.testing.assert_array_equal(a, b, err_msg=f"rank {r}: {n1}")


_ROW_PREFIXES = (".gaussians.", ".adam.mu", ".adam.nu", ".stats.")


def gathered(results, job, ranks):
    """The whole state of a row-sharded run: the per-gaussian leaves of
    ``ranks`` (in prim order) concatenated, the rest rank ``ranks[0]``'s."""
    items = [dict(results[r][job]["state"]) for r in ranks]
    return {name: (np.concatenate([it[name] for it in items])
                   if name.startswith(_ROW_PREFIXES)
                   and name != ".gaussians.active_sh_degree" else a)
            for name, a in items[0].items()}


def _assert_2d_ranks(results, job):
    """A data x prim run of 4 ranks: the ranks of a prim coordinate hold
    the same rows, bit for bit."""
    _assert_ranks_equal(results, job, [0, 2])
    _assert_ranks_equal(results, job, [1, 3])


def _assert_step_gate(got, want, lr_scale=1.0):
    """The port's state after one step from the initial state against
    JAX's: the gradients (mu = 0.1 g) and statistics within the gradient
    gate, the parameters by ±lr with 2·lr where the gradient is within
    rounding of 0 (tests/test_torch_train.py)."""
    lrs = ttrainer._lr_dict(OptimizationConfig(), 1, lr_scale)
    for k in TRAINABLE:
        g_j = want["adam"]["mu"][k] / 0.1
        np.testing.assert_allclose(got[f".adam.mu['{k}']"] / 0.1, g_j,
                                   err_msg=k, **GRAD_TOL)
        flip = np.where(np.abs(g_j) < GRAD_TOL["atol"], 2 * lrs[k], 0.0)
        ref = want["gaussians"][k]
        err = np.abs(got[f".gaussians.{k}"] - ref)
        assert (err <= 1e-6 * np.abs(ref) + 1e-7 + flip).all(), k
    for k in ("xyz_gradient_accum", "denom", "max_radii2d"):
        np.testing.assert_allclose(got[f".stats.{k}"], want["stats"][k],
                                   err_msg=k, **GRAD_TOL)


# ------------------------------------------------------------ the steps

def test_dp_step_identical_cameras_matches_single_and_jax(four_ranks):
    g, cam, gt, W, H = _identical_case()
    single, aux_1 = _port_single(g, cam, gt, W, H)
    jax_state, jax_loss = _jax_identical()
    _assert_ranks_equal(four_ranks, "identical")
    got = four_ranks[0]["identical"]
    items = _items(got)
    for want in (float(aux_1.loss), jax_loss):
        np.testing.assert_allclose(got["loss"], want, rtol=1e-5)
    np.testing.assert_allclose(items[".gaussians.xyz"],
                               t2n(single.gaussians.xyz), rtol=1e-4,
                               atol=1e-7)
    # 4 views visited: denom 4x the single view's
    np.testing.assert_allclose(items[".stats.denom"],
                               4 * t2n(single.stats.denom))
    assert items[".stats.denom"].max() == 4
    _assert_step_gate(items, jax_state)


def test_dp_step_distinct_cameras_is_the_batch_reference(two_ranks):
    _assert_ranks_equal(two_ranks, "distinct")
    got = two_ranks[0]["distinct"]
    ref = got["reference"]
    for (n1, a), (n2, b) in zip(got["state"], ref["state"]):
        assert n1 == n2
        np.testing.assert_array_equal(a, b, err_msg=n1)
    assert got["loss"] == ref["loss"]
    jax_state, jax_loss = _jax_distinct()
    np.testing.assert_allclose(got["loss"], jax_loss, rtol=1e-5)
    _assert_step_gate(_items(got), jax_state)
    assert _items(got)[".stats.denom"].max() == 2


def test_collectives_over_the_axes_of_a_mesh(four_ranks):
    """psum / pmean / pmax over each axis of a 2 x 2 mesh of the 4 ranks,
    float32 and int64 in one buffer each: the lines are {0, 2}, {1, 3} on
    ``data`` and {0, 1}, {2, 3} on ``prim``."""
    for r, res in enumerate(four_ranks):
        got = res["collectives"]
        assert got["coords"] == {"data": r // 2, "prim": r % 2}
        for axis, line in (("data", [r % 2, r % 2 + 2]),
                           ("prim", [r - r % 2, r - r % 2 + 1])):
            total, mean, top = got[axis]
            assert total == [[float(sum(line)), 2.0], 10 * sum(line)]
            assert mean == [[sum(line) / 2, 1.0], 5.0 * sum(line)]
            assert top == [[float(max(line)), 1.0], 10 * max(line)]
            assert got[axis + "_dtypes"] == ["torch.float32", "torch.int64"]


def test_ranks_agree_and_match_one_process(four_ranks):
    """tests/test_multihost.py:34 with one rank per camera: the ranks agree
    bit for bit and match the batch's step run in one process."""
    res = [r["agree"] for r in four_ranks]
    assert len({(r["loss"], r["checksum"]) for r in res}) == 1
    _assert_ranks_equal(four_ranks, "agree")
    ref = res[0]["reference"]
    np.testing.assert_allclose(res[0]["loss"], ref["loss"], rtol=1e-5)
    checksum = np.abs(dict(ref["state"])[".gaussians.xyz"]).sum()
    np.testing.assert_allclose(res[0]["checksum"], checksum, rtol=1e-5)
    assert res[0]["num_pairs"] > 0 and res[0]["overflow"] == 0


def test_sharded_dp_step_matches_jax_and_single(four_ranks):
    """JAX's layout: data 2 x prim 2; each rank holds 64 of the 128 rows."""
    _assert_2d_ranks(four_ranks, "sharded")
    g, cam, gt, W, H = _sharded_case(8)
    single, aux_1 = _port_single(g, cam, gt, W, H)
    jax_state, jax_loss = _jax_sharded_dp()
    got = four_ranks[0]["sharded"]
    assert _items(got)[".adam.mu['xyz']"].shape == (64, 3)
    assert len({r["sharded"]["loss"] for r in four_ranks}) == 1
    items = gathered(four_ranks, "sharded", [0, 1])
    assert items[".adam.mu['xyz']"].shape == (128, 3)
    np.testing.assert_allclose(got["loss"], float(aux_1.loss), rtol=1e-5)
    np.testing.assert_allclose(got["loss"], jax_loss, rtol=1e-5)
    for xyz, denom, accum in (
            (t2n(single.gaussians.xyz), t2n(single.stats.denom),
             t2n(single.stats.xyz_gradient_accum)),
            (jax_state["gaussians"]["xyz"], jax_state["stats"]["denom"] / 2,
             jax_state["stats"]["xyz_gradient_accum"] / 2)):
        np.testing.assert_allclose(items[".gaussians.xyz"], xyz, rtol=1e-3,
                                   atol=5e-4)
        # camera-DP statistics: 2 views visited
        np.testing.assert_allclose(items[".stats.denom"], 2 * denom)
        np.testing.assert_allclose(items[".stats.xyz_gradient_accum"],
                                   2 * accum, rtol=1e-3, atol=1e-6)


def test_sharded_dp_step_after_capacity_growth(four_ranks):
    """tests/test_parallel.py:369: grown to 192 rows, the 2 prim ranks
    hold 96 each and the step runs; the batch's loss is the mean of the
    two views' single steps from the grown state."""
    _assert_2d_ranks(four_ranks, "grown")
    got = four_ranks[0]["grown"]
    assert _items(got)[".gaussians.xyz"].shape == (96, 3)
    items = gathered(four_ranks, "grown", [0, 1])
    assert items[".gaussians.xyz"].shape == (192, 3)
    assert items[".adam.mu['xyz']"].shape == (192, 3)
    assert np.isfinite(got["loss"]) and got["overflow"] == 0
    g, cam, _, W, H = _sharded_case(4)
    gts = np.random.default_rng(1).uniform(0, 1, (2, 3, H, W)).astype(
        np.float32)
    tg, _ = port_scene(g, cam)
    grown = tckpt.grow_capacity(ttrainer.init_state(tg, 1), 192)
    losses = [float(_port_single(g, cam, gt, W, H, state=grown)[1].loss)
              for gt in gts]
    np.testing.assert_allclose(got["loss"], np.mean(losses), rtol=1e-5)


# ------------------------------------------------------------- the loop

def _log(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


def test_loop_data_parallel_matches_jax_train(two_ranks, loop_scene,
                                              monkeypatch, capsys):
    root, src = loop_scene
    batches = []
    make = jdp.make_dp_train_step

    def recording(*a, **kw):
        step = make(*a, **kw)

        def wrapped(state, cam_b, *rest):
            batches.append(np.asarray(cam_b.world_view))
            return step(state, cam_b, *rest)
        return wrapped

    devices = jax.devices()
    monkeypatch.setattr(jax, "devices", lambda *a: devices[:2])
    # as in the ranks (tests/torch_dist_worker.py): no TensorFlow import
    # for the telemetry's TensorBoard mirror, which no test reads
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    monkeypatch.setattr(jdp, "make_dp_train_step", recording)
    random.seed(0)
    jloop.train(
        jcfg.ModelConfig(model_path=str(root / "jax"), source_path=src,
                         sh_degree=1, eval=True),
        jcfg.OptimizationConfig(**LOOP_OPT), jcfg.PipelineConfig(),
        jcfg.RasterizerConfig(**LOOP_RCFG), [], [LOOP_ITERS], [],
        quiet=True, data_parallel=True)
    out = capsys.readouterr().out
    assert "camera data-parallel training over 2 devices" in out
    assert "pairs_per_gaussian" not in out     # no shrink, no retry

    # every rank's camera of every step is its row of JAX's batch
    assert len(batches) == LOOP_ITERS
    for r, res in enumerate(two_ranks):
        got = res["loop"]["cams"]
        assert len(got) == LOOP_ITERS
        for step, (a, b) in enumerate(zip(got, batches)):
            np.testing.assert_array_equal(a, b[r], err_msg=f"step {step}")
    assert two_ranks[0]["loop"]["noise_left"] == 0      # one densify event

    # rank 0's log against JAX's, key by key but the clock
    tlog = _log(root / "port" / "training_log.jsonl")
    jlog = _log(root / "jax" / "training_log.jsonl")
    assert len(tlog) == len(jlog) == LOOP_ITERS
    for a, b in zip(tlog, jlog):
        assert set(a) == set(b), (a, b)
        for k in set(a) - {"t", "iter_time"}:
            if "loss" in k or "psnr" in k:
                np.testing.assert_allclose(a[k], b[k], rtol=1e-4, err_msg=k)
            else:
                assert a[k] == b[k], (k, a, b)

    # the ranks' final states bit for bit; rank 1 wrote nothing
    _assert_ranks_equal(two_ranks, "loop")
    assert two_ranks[1]["loop"]["writes"] == []
    assert {"cameras.json", "input.ply", "point_cloud",
            "training_log.jsonl"} <= set(os.listdir(root / "port"))


def test_loop_data_parallel_with_row_shards(four_ranks, loop_scene):
    """The loop's 2-D branch on JAX's layout: 4 ranks as data 2 x prim 2,
    ring; each rank holds half the rows, ranks 1-3 write nothing."""
    root, _ = loop_scene
    _assert_2d_ranks(four_ranks, "loop_2d")
    items = _items(four_ranks[0]["loop_2d"])
    assert items[".step"] == 3
    assert items[".gaussians.xyz"].shape[0] == 512     # 1,024 over 2 ranks
    for r in (1, 2, 3):
        assert four_ranks[r]["loop_2d"]["writes"] == []
    log = _log(root / "sharded" / "training_log.jsonl")
    assert [r["step"] for r in log] == [1, 2, 3]
    assert all(np.isfinite(r["train_loss_patches/total_loss"]) for r in log)


# the train CLI as torchrun starts it, without the TensorFlow import of the
# telemetry's TensorBoard mirror
_CLI = (f"import sys; sys.path.insert(0, {REPO!r}); "
        "sys.modules['torch.utils.tensorboard'] = None; "
        "from gsplat_tpu_torch.cli.train import main; main(sys.argv[1:])")


def test_train_cli_joins_the_group_and_rank_0_writes(loop_scene, tmp_path):
    """``train_torch.py --data_parallel`` on 2 ranks: each joins the group
    (``init_distributed`` from the environment), and without ``-m`` both
    train into rank 0's one new model directory, which rank 0 alone
    writes."""
    _, src = loop_scene
    outs = launch(2, ["-c", _CLI, "-s", src, "--device", "cpu",
                       "--data_parallel", "--iterations", "2",
                       "--disable_viewer", "--quiet"], cwd=str(tmp_path))
    for r, out in enumerate(outs):
        assert f"[dist] process {r}/2, gloo on cpu" in out
    (model,) = os.listdir(tmp_path / "output")
    assert all(f"Optimizing ./output/{model}" in out for out in outs)
    m = tmp_path / "output" / model
    assert {"cfg_args.json", "cameras.json", "input.ply",
            "point_cloud"} <= set(os.listdir(m))
    assert [r["step"] for r in _log(m / "training_log.jsonl")] == [1, 2]


def test_debug_snapshot_holds_the_batch(two_ranks, loop_scene):
    """A non-finite loss under ``--debug`` in a 2-rank loop: every rank
    raises; rank 0 alone writes the snapshot, which holds the whole batch
    (both ranks' cameras and images), as JAX's does."""
    root, _ = loop_scene
    for res in two_ranks:
        assert "non-finite loss nan" in res["debug"]["raised"]
    assert two_ranks[1]["debug"]["writes"] == []
    snap = np.load(root / "debug" / "snapshot_iter2.npz")
    assert snap["cam.world_view"].shape == (2, 4, 4)
    for r, res in enumerate(two_ranks):
        np.testing.assert_array_equal(snap["cam.world_view"][r],
                                      res["debug"]["cams"][-1])
    assert snap["gt"].shape == (2, 3, 48, 64)
    assert snap["alpha_mask"].shape == snap["depth_mask"].shape \
        == (2, 1, 48, 64)
    assert int(snap["iteration"]) == 2 and int(snap["state.step"]) == 1


def test_loop_data_parallel_overflow_retry_and_growth(two_ranks, loop_scene):
    """The loop's retry and growth on 2 ranks read only all-reduced values,
    so both ranks take every branch together: a pair list far too small
    commits, after its retries, what an ample one commits, bit for bit on
    both ranks; a densify event that runs out of slots grows the capacity
    on both (tests/test_torch_loop.py's forced cases)."""
    root, _ = loop_scene
    for job in ("retry_small", "retry_ample", "growth"):
        _assert_ranks_equal(two_ranks, job)
    # every retry calls the step again, on both ranks
    for res in two_ranks:
        assert len(res["retry_small"]["cams"]) > RETRY_OPT["iterations"]
        assert len(res["retry_ample"]["cams"]) == RETRY_OPT["iterations"]
    small = _items(two_ranks[0]["retry_small"])
    ample = _items(two_ranks[0]["retry_ample"])
    for name, a in small.items():
        np.testing.assert_array_equal(a, ample[name], err_msg=name)
    small_log = _log(root / "retry_small" / "training_log.jsonl")
    assert [r["train_loss_patches/total_loss"] for r in small_log] == \
        [r["train_loss_patches/total_loss"]
         for r in _log(root / "retry_ample" / "training_log.jsonl")]
    grown = _items(two_ranks[0]["growth"])
    cap = grown[".gaussians.xyz"].shape[0]
    assert cap > 1024 and cap % 1024 == 0
    assert grown[".adam.mu['xyz']"].shape[0] == cap
    log = _log(root / "growth" / "training_log.jsonl")
    assert log[5]["total_points"] > log[4]["total_points"]
