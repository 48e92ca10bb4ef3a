"""The port's training drive (gsplat_tpu_torch/tools/drive_train.py)
against tools/drive_train.py, at the CPU's sizes (128x64, 400 ground-truth
gaussians, 80 to start from, seed 0).

The JAX side is built from tools/drive_train.py's ``ring_camera`` and the
JAX API on its XLA oracle (``use_pallas=False``), step for step as that
tool's ``main`` runs. JAX's XLA compositor walks every slot of the pair
list on the CPU, so its step time follows the pair capacity (about 2 s a
step at the tool's 96 pairs a gaussian): the JAX side runs at 8 pairs a
gaussian, the most a gaussian can have on this frame's 4 x 2 grid of 32 x
32 tiles, so no frame can overflow (both sides assert overflow 0) and the
entry lists hold the same pairs. The port runs the tool's own ``run`` at
its 96.

Gates: the ground truth within the image gate (rtol 2e-4, atol 2e-5) on
the same gaussians (each package's own differ where a knn scale's rounding
moves an alpha across the 1/255 floor: see the test), the initial PSNRs within 1e-3 dB, each iteration's loss within rtol 1e-4
through iteration 55, across the first densify event at 50 (the port is
handed JAX's draws through ``densify_step(noise=)``, as
tests/test_torch_loop.py does), the final state within the step gate
(rtol 5e-3, atol 1e-6; where a gradient of JAX's lay within rounding of 0,
that gate carried through Adam, as tests/test_torch_loop.py carries it)
and the final PSNRs within 0.01 dB.

The alpha clamp does not bind on this drive: the ground truth's opacity
is sigmoid(1.5) = 0.82, and the trained model's stays below 0.99 (checked
below), so the gradient where alpha >= 0.99 (the port follows the TPU
kernel there, JAX's CPU oracle differentiates the clamp) never enters.

At its default 30 iterations on the CPU the drive fails its first assert
(train PSNR +2.85 dB, not +3) in both packages, with the same PSNRs: the
port's drive is held to the PSNRs tools/drive_train.py prints there.
"""
import dataclasses
import math
import os
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from gsplat_tpu.config import OptimizationConfig as JaxOpt
from gsplat_tpu.config import RasterizerConfig as JaxRcfg
from gsplat_tpu.models import gaussian_model as jgm
from gsplat_tpu.ops import losses as jlosses
from gsplat_tpu.ops.rasterize import render as jax_render
from gsplat_tpu.train import trainer as jtrainer
from gsplat_tpu_torch.config import RasterizerConfig
from gsplat_tpu_torch.models import gaussian_model as tgm
from gsplat_tpu_torch.ops.rasterize import render
from gsplat_tpu_torch.tools import drive_train
from gsplat_tpu_torch.train import trainer as ttrainer

from torch_parity import PARAM_FIELDS, state_to_numpy, t2n

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
(W, H), (N_GT, N_INIT), DEFAULT_ITERS = drive_train.SIZES["cpu"]
ITERS = 55
IMG_TOL = dict(rtol=2e-4, atol=2e-5)
STEP_TOL = dict(rtol=5e-3, atol=1e-6)
TRAINABLE = ("xyz", "f_dc", "f_rest", "scaling", "rotation", "opacity")
JAX_PAIRS = 8.0
# one compiled render (width, height and config static) in place of the
# op-by-op dispatch of an eager call, whose first call compiles each op
jrender = jax.jit(jax_render, static_argnums=(2, 3, 5))
# tools/drive_train.py's own line on a CPU (GSPLAT_PLATFORM=cpu, its default
# 30 iterations at 128x64, which hold no densify event): "train PSNR 11.00
# → 13.85 dB, HELD-OUT test PSNR 10.92 → 13.90 dB", then its first assert
# fails
JAX_CPU_DRIVE = (11.00, 13.85, 10.92, 13.90)


def _jax_noise(key, cap):
    return (jax.random.normal(key, (cap, 3)),
            jax.random.normal(jax.random.fold_in(key, 1), (cap, 3)))


@pytest.fixture(scope="module")
def jax_scene():
    """JAX's ground truth, cameras and initial PSNRs, and a runner of its
    training loop from the drive's initial model."""
    sys.path.insert(0, os.path.join(REPO, "tools"))
    import drive_train as jdrive

    rng = np.random.default_rng(0)
    pts = rng.standard_normal((N_GT, 3)).astype(np.float32)
    colors = rng.uniform(0.1, 0.9, (N_GT, 3)).astype(np.float32)
    g_gt = jgm.create_from_pcd(pts, colors, 0, capacity=N_GT)
    g_gt = dataclasses.replace(g_gt, opacity=g_gt.opacity.at[:].set(1.5))
    rcfg = JaxRcfg(use_pallas=False, pairs_per_gaussian=JAX_PAIRS)
    bg = jnp.zeros(3, jnp.float32)
    cams = [jdrive.ring_camera(a) for a in np.linspace(0, 2 * math.pi, 12,
                                                       endpoint=False)]
    gts = []
    for c in cams:
        out = jrender(g_gt, c, W, H, bg, rcfg)
        assert int(out.overflow) == 0
        gts.append(jnp.clip(out.image, 0, 1))
    test_ids = sorted(set(range(0, len(cams), 4)))
    train_ids = [i for i in range(len(cams)) if i not in test_ids]
    sel = rng.choice(N_GT, N_INIT, replace=False)
    init_pts = pts[sel] + 0.05 * rng.standard_normal(
        (N_INIT, 3)).astype(np.float32)
    g0 = jgm.create_from_pcd(init_pts, colors[sel], 1, capacity=4 * N_INIT)
    rng_state = rng.bit_generator.state

    def psnr_now(g, ids):
        return float(np.mean([float(jlosses.psnr(
            jrender(g, cams[i], W, H, bg, rcfg).image[None],
            gts[i][None]).mean()) for i in ids]))

    def run(iters):
        """tools/drive_train.py's loop for ``iters`` iterations: every
        loss, the final state and PSNRs."""
        rng.bit_generator.state = rng_state
        opt = JaxOpt(iterations=iters, densify_from_iter=20,
                     densification_interval=50,
                     opacity_reset_interval=10 * iters,
                     position_lr_max_steps=iters)
        state = jtrainer.init_state(g0, len(cams))
        ones = jnp.ones((1, H, W), jnp.float32)
        zeros = jnp.zeros((1, H, W), jnp.float32)
        key = jax.random.PRNGKey(0)
        losses, grads = [], []
        for it in range(1, iters + 1):
            i = train_ids[rng.integers(0, len(train_ids))]
            mu = state.adam.mu
            state, aux = jtrainer.train_step(
                state, cams[i], gts[i], ones, zeros, zeros, bg,
                image_width=W, image_height=H, opt=opt, rcfg=rcfg,
                spatial_lr_scale=2.0, antialiasing=False,
                use_sparse_adam=False, train_test_exp=False, use_depth=False)
            assert int(aux.overflow) == 0
            losses.append(float(aux.loss))
            # this step's gradient, from Adam's first moment (beta1 0.9)
            grads.append({k: (np.asarray(state.adam.mu[k])
                              - 0.9 * np.asarray(mu[k])) / 0.1
                          for k in TRAINABLE})
            if it > opt.densify_from_iter \
                    and it % opt.densification_interval == 0:
                key, sub = jax.random.split(key)
                state, _ = jtrainer.densify_step(
                    state, sub, 2.0, opt=opt, use_screen_size_prune=False)
        return dict(losses=losses, grads=grads, state=state,
                    p1_train=psnr_now(state.gaussians, train_ids),
                    p1_test=psnr_now(state.gaussians, test_ids))

    return dict(gts=[np.asarray(x) for x in gts],
                g_gt={k: np.asarray(getattr(g_gt, k)) for k in PARAM_FIELDS},
                p0_train=psnr_now(g0, train_ids),
                p0_test=psnr_now(g0, test_ids), run=run)


def _jax_draws(monkeypatch):
    """Hand the port's densify events JAX's draws (its key sequence:
    PRNGKey(0), split per event), and record the largest opacity of every
    state a step leaves."""
    key = [jax.random.PRNGKey(0)]
    densify, step = ttrainer.densify_step, ttrainer.train_step
    top = [0.0]

    def port_densify(state, gen, *a, **kw):
        key[0], sub = jax.random.split(key[0])
        noise = tuple(torch.tensor(np.asarray(x)) for x in _jax_noise(
            sub, state.gaussians.capacity))
        return densify(state, gen, *a, noise=noise, **kw)

    def port_step(*a, **kw):
        s, aux = step(*a, **kw)
        g = s.gaussians
        top[0] = max(top[0], float(g.get_opacity()[g.active].max()))
        return s, aux

    monkeypatch.setattr(ttrainer, "densify_step", port_densify)
    monkeypatch.setattr(ttrainer, "train_step", port_step)
    return top


def test_drive_matches_jax_through_the_first_densify(jax_scene,
                                                     monkeypatch):
    top = _jax_draws(monkeypatch)
    port = drive_train.run(torch.device("cpu"), ITERS, width=W, height=H,
                           n_gt=N_GT, n_init=N_INIT, log=lambda s: None)
    want = jax_scene["run"](ITERS)

    # the ground truth: both packages' create_from_pcd agree within the
    # gate of tests/test_torch_train.py (their knn distances round
    # differently, 2.3e-6 in log scale); the port's render of JAX's
    # gaussians is JAX's image within the image gate
    g_port = drive_train.ground_truth(np.random.default_rng(0), N_GT,
                                      "cpu")[2]
    g_jax = jax_scene["g_gt"]
    for k in TRAINABLE:
        np.testing.assert_allclose(t2n(getattr(g_port, k)), g_jax[k],
                                   rtol=1e-5, atol=1e-5, err_msg=k)
    g_same = tgm.from_numpy(g_jax, device="cpu")
    cams = drive_train.ring_cameras("cpu")
    rcfg = RasterizerConfig(pairs_per_gaussian=96.0)
    with torch.no_grad():
        for cam, want_gt in zip(cams, jax_scene["gts"]):
            img = render(g_same, cam, W, H, torch.zeros(3), rcfg).image
            np.testing.assert_allclose(t2n(img.clamp(0, 1)), want_gt,
                                       **IMG_TOL)
    # each package's own ground truth, which each drive trains on: where
    # that rounding moves a gaussian's alpha across the 1/255 floor at a
    # pixel the two differ by at most that alpha's share (3 of the 294,912
    # values here, by up to 3.5e-4)
    got = np.stack([t2n(x) for x in port["gts"]])
    want_gts = np.stack(jax_scene["gts"])
    off = ~np.isclose(got, want_gts, **IMG_TOL)
    assert off.mean() <= 1e-4
    assert np.abs(got - want_gts)[off].max(initial=0.0) <= 1.0 / 255.0
    for k in ("p0_train", "p0_test"):
        assert abs(port[k] - jax_scene[k]) < 1e-3, k
    assert port["overflow"] == 0
    np.testing.assert_allclose(port["losses"], want["losses"], rtol=1e-4)

    js = state_to_numpy(want["state"])
    state = port["state"]
    assert state.step == js["step"] == ITERS
    np.testing.assert_array_equal(t2n(state.gaussians.active),
                                  js["gaussians"]["active"])
    assert port["n"] > N_INIT           # the densify event at 50 grew it
    # the step gate; where JAX's gradient of some step lay within rounding
    # of 0 (|g| < its atol), Adam's normalised step lr·m/(sqrt(v)+eps) may
    # take the other sign there, and the value is held to the step gate
    # carried through Adam instead (tests/test_torch_loop.py's bound:
    # 1e-6·|p| + 1e-7 + the sum over steps of lr·(0.01 + 2·[|g| < 1e-6]))
    opt = drive_train.drive_opt(ITERS)
    for k in TRAINABLE:
        got, ref = t2n(getattr(state.gaussians, k)), js["gaussians"][k]
        flip = np.zeros(ref.shape, bool)
        allow = 0.0
        for step, g in enumerate(want["grads"], start=1):
            near0 = np.abs(g[k]) < STEP_TOL["atol"]
            flip |= near0
            allow = allow + ttrainer._lr_dict(opt, step, 2.0)[k] * (
                0.01 + 2.0 * near0)
        within = np.isclose(got, ref, **STEP_TOL)
        carried = np.abs(got - ref) <= 1e-6 * np.abs(ref) + 1e-7 + allow
        assert (within | (flip & carried)).all(), (
            k, np.argwhere(~within), got[~within], ref[~within])
    for k in ("p1_train", "p1_test"):
        assert abs(port[k] - want[k]) < 0.01, k
    # the alpha clamp (0.99) never binds: see the module's docstring
    assert top[0] < 0.99


def test_cpu_drive_fails_where_jax_fails(capsys):
    with pytest.raises(AssertionError, match="train PSNR did not improve"):
        drive_train.main(["--device", "cpu"])
    line = [x for x in capsys.readouterr().out.splitlines()
            if x.startswith("train PSNR")][0]
    got = [float(x) for x in line.replace("->", " ").replace("dB", " ")
           .replace(",", " ").split() if x.replace(".", "").isdigit()][:4]
    np.testing.assert_allclose(got, JAX_CPU_DRIVE, atol=0.01)
    # the JAX drive's asserts on its numbers: the first fails
    assert JAX_CPU_DRIVE[1] <= JAX_CPU_DRIVE[0] + 3.0
