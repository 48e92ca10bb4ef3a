"""The port's throughput bench (``gsplat_tpu_torch/tools/bench.py``, the
root ``bench_torch.py``) against the root bench.py on the CPU at a small
size: bench.py's synthetic scene (``bench_scene``), its trained-model
workload (``trained_scene`` against ``bench._trained_scene``), the
right-sizing of the pair capacity from a first train step (grown where
it overflows) and the second step, and the CLI's one JSON line.

Tolerances: the scene's positions, colors and opacities equal; the 3-NN
log scales of each package within float32 rounding of the float64 truth
(the squared distances' expansion rounds by about 4·eps·max|p|²: at
bench.py's coordinates the two packages' scales differ by up to 2.4e-5);
the first step's counts and the right-sized capacities equal; the second
step's loss rtol 1e-5; its gradients (Adam's first moment over 0.1) the
gradient gate rtol 5e-3 / atol 1e-6, and the parameters after the Adam
step within rounding but for ±2·lr where the gradient is within rounding
of 0 (Adam's first step moves each by ±lr, the sign of its gradient).
"""
import dataclasses
import functools
import json
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gsplat_tpu.config import OptimizationConfig as JaxOptimizationConfig
from gsplat_tpu.config import RasterizerConfig as JaxRasterizerConfig
from gsplat_tpu.core.camera import CameraView as JaxCameraView
from gsplat_tpu.models import gaussian_model as jgm
from gsplat_tpu.train import trainer as jtrainer
from gsplat_tpu_torch.config import OptimizationConfig, RasterizerConfig
from gsplat_tpu_torch.scene import ply as ply_lib
from gsplat_tpu_torch.tools import bench
from gsplat_tpu_torch.train import trainer as ttrainer

from torch_parity import (CAM_FIELDS, PARAM_FIELDS, port_scene,
                          state_to_numpy, t2n, to_numpy)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N, W, H = 300, 96, 64
GRAD_TOL = dict(rtol=5e-3, atol=1e-6)
TRAINABLE = ("xyz", "f_dc", "f_rest", "scaling", "rotation", "opacity")
BENCH_KEYS = {"metric", "value", "unit", "vs_baseline"}


def jax_bench_scene(n, W, H):
    """bench.py:127-146 and its ground truth, as the JAX package builds
    them."""
    rng = np.random.default_rng(0)
    pts = rng.standard_normal((n, 3)).astype(np.float32) * 2.0
    pts[:, 2] = np.abs(pts[:, 2]) + 4.0
    colors = rng.uniform(0, 1, (n, 3)).astype(np.float32)
    g = jgm.create_from_pcd(pts, colors, max_sh_degree=3, capacity=n)
    g = dataclasses.replace(
        g, active_sh_degree=jnp.asarray(3, jnp.int32),
        scaling=g.scaling - 1.0, opacity=g.opacity.at[:].set(0.0))
    cam = JaxCameraView.create(R=np.eye(3), T=np.zeros(3), fovx=1.2,
                               fovy=0.9)
    gt = rng.uniform(0, 1, (3, H, W)).astype(np.float32)
    return g, cam, gt


def test_bench_scene_matches_jax():
    jg, jcam, jgt = jax_bench_scene(N, W, H)
    g, cam, gt = bench.bench_scene(N, W, H, "cpu")
    for k in ("xyz", "f_dc", "f_rest", "rotation", "opacity", "active"):
        np.testing.assert_array_equal(t2n(getattr(g, k)),
                                      np.asarray(getattr(jg, k)), err_msg=k)
    # the 3-NN log scales: each package's within float32 rounding of the
    # float64 truth. Both square distances as |a|² + |b|² - 2a·b, which
    # rounds by about 4·eps·max|p|² against the distance²; the log scale
    # (half the log of the mean distance²) moves by half that relatively
    p = t2n(g.xyz).astype(np.float64)
    d2 = ((p[:, None] - p[None]) ** 2).sum(-1)
    np.fill_diagonal(d2, np.inf)
    d2 = np.sort(d2, axis=1)[:, :3].mean(axis=1)
    truth = 0.5 * np.log(np.maximum(d2, 1e-7)) - 1.0
    tol = 0.5 * 8 * np.finfo(np.float32).eps * (p ** 2).sum(1).max() / d2 \
        + 1e-6
    for name, got in (("port", t2n(g.scaling)), ("jax", np.asarray(
            jg.scaling))):
        assert (np.abs(got - truth[:, None]) <= tol[:, None]).all(), name
    assert g.active_sh_degree == int(jg.active_sh_degree) == 3
    assert g.capacity == jg.xyz.shape[0] == N
    for k in CAM_FIELDS[:-1]:
        np.testing.assert_allclose(t2n(getattr(cam, k)),
                                   np.asarray(getattr(jcam, k)),
                                   rtol=1e-6, atol=1e-7, err_msg=k)
    np.testing.assert_array_equal(t2n(gt), jgt)


def _jax_step(state, cam, gt, rcfg):
    ones = jnp.ones((1, H, W), jnp.float32)
    zeros = jnp.zeros((1, H, W), jnp.float32)
    return jtrainer.train_step(
        state, cam, jnp.asarray(gt), ones, zeros, zeros,
        jnp.zeros(3, jnp.float32), image_width=W, image_height=H,
        opt=JaxOptimizationConfig(), rcfg=rcfg, spatial_lr_scale=1.0,
        antialiasing=False, use_sparse_adam=False, train_test_exp=False,
        use_depth=False)


@functools.lru_cache(maxsize=None)
def _jax_right_sized():
    """bench.py:159-196 at the small size on the XLA path: the first step
    at 10 pairs a gaussian, the right-sized capacities, and the step again
    from the saved state."""
    g, cam, gt = jax_bench_scene(N, W, H)
    rcfg = JaxRasterizerConfig(use_pallas=False, pairs_per_gaussian=10.0)
    state0 = jtrainer.init_state(g, 1)
    _, aux = _jax_step(state0, cam, gt, rcfg)
    first = dict(pairs=int(aux.num_pairs), padded=int(aux.num_padded),
                 overflow=int(aux.overflow))
    ppg = max(first["pairs"] * 1.3 / N, 2.0)
    pad_cap = max(rcfg.chunk, int((first["padded"] - first["pairs"]) * 1.5))
    rcfg = dataclasses.replace(rcfg, pairs_per_gaussian=ppg, pad_cap=pad_cap)
    state, aux = _jax_step(state0, cam, gt, rcfg)
    return (g, cam, gt), state0, first, (ppg, pad_cap), (state, aux)


def test_right_sizing_and_second_step_match_jax():
    (jg, jcam, gt), s0, first, (ppg, pad_cap), (s1, aux) = _jax_right_sized()
    assert first["overflow"] == 0
    # the same gaussians (JAX's, carried across: the knn rounds apart)
    g, cam = port_scene(jg, jcam)
    gt_t = torch.tensor(gt)
    cfg, state, pairs, padded, steps = bench.right_size(
        g, cam, gt_t, RasterizerConfig(pairs_per_gaussian=bench.FIRST_PPG))
    assert (pairs, padded, steps) == (first["pairs"], first["padded"], 2)
    assert cfg.pairs_per_gaussian == ppg and cfg.pad_cap == pad_cap
    # the second step from JAX's initial state, carried across
    t0 = ttrainer.state_from_numpy(state_to_numpy(s0), device="cpu")
    t1, taux = bench.step_fn(cam, gt_t, cfg)(t0)
    assert int(taux.overflow) == int(aux.overflow) == 0
    assert int(taux.num_pairs) == int(aux.num_pairs)
    np.testing.assert_allclose(float(taux.loss), float(aux.loss), rtol=1e-5)
    for k in TRAINABLE:
        np.testing.assert_allclose(t2n(getattr(state.gaussians, k)),
                                   t2n(getattr(t1.gaussians, k)), rtol=0,
                                   atol=0, err_msg=k)
    lrs = ttrainer._lr_dict(OptimizationConfig(), 1, 1.0)
    for k in TRAINABLE:
        g_j = np.asarray(s1.adam.mu[k]) / 0.1        # the step's gradient
        np.testing.assert_allclose(t2n(t1.adam.mu[k]) / 0.1, g_j,
                                   **GRAD_TOL, err_msg=k)
        flip = np.where(np.abs(g_j) < GRAD_TOL["atol"], 2 * lrs[k], 0.0)
        want = np.asarray(getattr(s1.gaussians, k))
        err = np.abs(t2n(getattr(t1.gaussians, k)) - want)
        assert (err <= 1e-6 * np.abs(want) + 1e-7 + flip).all(), k


def test_right_size_grows_an_overflowing_first_step(capsys):
    """Where bench.py stops (its first step overflows), the port doubles
    the first step's capacity until it fits: the right-sized config and
    step are those of an ample first capacity, bit for bit."""
    g, cam, gt = bench.bench_scene(N, W, H, "cpu")
    ample = bench.right_size(g, cam, gt, RasterizerConfig(
        pairs_per_gaussian=bench.FIRST_PPG))
    grown = bench.right_size(g, cam, gt, RasterizerConfig(
        pairs_per_gaussian=0.1))
    assert ample[4] == 2 and grown[4] > 2
    assert "doubling it" in capsys.readouterr().out
    assert grown[0] == ample[0] and grown[2:4] == ample[2:4]
    for k in TRAINABLE:
        assert torch.equal(getattr(grown[1].gaussians, k),
                           getattr(ample[1].gaussians, k)), k


@pytest.fixture(scope="module")
def small_ply(tmp_path_factory):
    """A small trained-looking PLY: 50 gaussians, SH degree 2."""
    rng = np.random.default_rng(3)
    n = 50
    arrays = dict(
        xyz=(rng.standard_normal((n, 3)) + [0.5, -0.2, 1.0]).astype(
            np.float32),
        f_dc=rng.standard_normal((n, 3)).astype(np.float32),
        f_rest=(0.1 * rng.standard_normal((n, 8, 3))).astype(np.float32),
        opacity=rng.uniform(-2, 2, n).astype(np.float32),
        scaling=rng.uniform(-4, -2, (n, 3)).astype(np.float32),
        rotation=rng.standard_normal((n, 4)).astype(np.float32))
    path = str(tmp_path_factory.mktemp("ply") / "point_cloud.ply")
    ply_lib.save_gaussian_ply(path, *(arrays[k] for k in (
        "xyz", "f_dc", "f_rest", "opacity", "scaling", "rotation")))
    return path


def test_trained_scene_matches_jax(small_ply):
    sys.path.insert(0, REPO)
    import bench as jax_bench

    jg, jcam, jn = jax_bench._trained_scene(small_ply)
    g, cam = bench.trained_scene(small_ply, "cpu")
    assert g.num_active() == g.capacity == jn == 50
    assert g.active_sh_degree == g.max_sh_degree \
        == int(jg.active_sh_degree) == 2
    want = to_numpy(jg, PARAM_FIELDS[:-1])
    for k, v in want.items():
        np.testing.assert_array_equal(t2n(getattr(g, k)), v, err_msg=k)
    for k in CAM_FIELDS[:-1]:
        np.testing.assert_allclose(t2n(getattr(cam, k)),
                                   np.asarray(getattr(jcam, k)),
                                   rtol=1e-6, atol=1e-7, err_msg=k)


def test_cli_prints_bench_line_last():
    out = subprocess.run(
        [sys.executable, "bench_torch.py", "--device", "cpu"], cwd=REPO,
        env=dict(os.environ, OMP_NUM_THREADS="2"), capture_output=True,
        text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    lines = out.stdout.strip().splitlines()
    line = json.loads(lines[-1])
    assert set(line) == BENCH_KEYS
    assert line["metric"] == "pixels_per_s_fwd_bwd_small"
    assert line["unit"] == "pixels/s/chip" and line["value"] > 0
    assert line["vs_baseline"] == round(line["value"] / 1.4e7, 4)
    assert sum(ln.startswith("{") for ln in lines) == 1
    assert "device busy not measured" in out.stdout


def test_trained_run_names_its_metric(small_ply, capsys):
    r = bench.main(["--ply", small_ply, "--device", "cpu"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert json.loads(lines[-1]) == r["line"]
    assert r["line"]["metric"] == "pixels_per_s_fwd_bwd_small_trained"
    assert sum(ln.startswith("{") for ln in lines) == 1
    assert r["launches"] == dict.fromkeys(r["launches"], 0)   # the CPU


def test_failure_exits_nonzero_without_a_json_line(tmp_path):
    out = subprocess.run(
        [sys.executable, "bench_torch.py", "--device", "cpu", "--ply",
         str(tmp_path / "missing.ply")], cwd=REPO, capture_output=True,
        text=True, timeout=300)
    assert out.returncode != 0
    assert "FileNotFoundError" in out.stderr
    assert not any(ln.lstrip().startswith("{")
                   for ln in out.stdout.splitlines())
