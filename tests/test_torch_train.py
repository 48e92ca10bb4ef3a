"""Port parity of the training path on the CPU: schedules, Adam, the
densification stats and events, create_from_pcd with knn, and one
train_step from a JAX state carried across with ``state_from_numpy``.

Tolerances: learning rates and Adam on identical gradients rtol 1e-6
(float32 rounding); gradients of the loss rtol 5e-3 / atol 1e-6 (the JAX
suite's gradient gate); values of the loss rtol 1e-5. Adam's first step
moves each parameter by ±lr, the sign of its gradient, so a gradient within
rounding of 0 may flip it: there, and only there, the whole-step test
allows 2·lr. JAX renders with its XLA oracle on the CPU, whose gradient
stops at the alpha clamp (the port's passes through it), so the scenes keep
every opacity below 0.99."""
import dataclasses
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from gsplat_tpu.config import OptimizationConfig as JaxOptimizationConfig
from gsplat_tpu.core.schedules import expon_lr as jax_expon_lr
from gsplat_tpu.models import gaussian_model as jgm
from gsplat_tpu.ops import knn as jknn
from gsplat_tpu.train import densify as jdens
from gsplat_tpu.train import optim as joptim
from gsplat_tpu.train import trainer as jtrainer
from gsplat_tpu_torch.config import OptimizationConfig
from gsplat_tpu_torch.core.schedules import expon_lr
from gsplat_tpu_torch.models import gaussian_model as tgm
from gsplat_tpu_torch.ops import knn as tknn
from gsplat_tpu_torch.train import densify as tdens
from gsplat_tpu_torch.train import optim as toptim
from gsplat_tpu_torch.train import trainer as ttrainer

from torch_parity import (PARAM_FIELDS, SMALL, STATS_FIELDS, configs,
                          make_scene, port_scene, state_to_numpy, t2n,
                          to_numpy)

GRAD_TOL = dict(rtol=5e-3, atol=1e-6)
OPT_KW = dict(iterations=100, position_lr_max_steps=100)
TRAINABLE = ("xyz", "f_dc", "f_rest", "scaling", "rotation", "opacity")


def _jnp(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


@pytest.mark.parametrize("kw", [
    dict(lr_init=1.6e-4, lr_final=1.6e-6, lr_delay_mult=0.01,
         max_steps=30_000),
    dict(lr_init=0.01, lr_final=0.001, lr_delay_steps=100,
         lr_delay_mult=0.1, max_steps=1000),
    dict(lr_init=0.0, lr_final=0.0)], ids=["xyz", "delayed", "off"])
def test_expon_lr_matches_jax(kw):
    for step in (-1, 0, 1, 7, 50, 999, 1000, 15_000, 30_000, 40_000):
        np.testing.assert_allclose(expon_lr(step, **kw),
                                   float(jax_expon_lr(step, **kw)),
                                   rtol=1e-6, err_msg=str(step))


@pytest.mark.parametrize("masked", [False, True])
def test_apply_updates_matches_jax(rng, masked):
    params = {"w": rng.standard_normal((8, 3)).astype(np.float32),
              "v": rng.standard_normal(8).astype(np.float32)}
    lrs = {"w": 0.01, "v": 1.6e-4}
    mask = np.array([True, False] * 4) if masked else None
    jp, tp = _jnp(params), {k: torch.tensor(v) for k, v in params.items()}
    js, ts = joptim.init(jp), toptim.init(tp)
    for _ in range(3):
        g = {k: rng.standard_normal(v.shape).astype(np.float32)
             for k, v in params.items()}
        jp, js = joptim.apply_updates(
            jp, _jnp(g), js, {k: jnp.asarray(v, jnp.float32)
                              for k, v in lrs.items()},
            visibility_mask=None if mask is None else jnp.asarray(mask))
        tp, ts = toptim.apply_updates(
            tp, {k: torch.tensor(v) for k, v in g.items()}, ts, lrs,
            visibility_mask=None if mask is None else torch.tensor(mask))
        for k in params:
            for got, want in ((tp[k], jp[k]), (ts.mu[k], js.mu[k]),
                              (ts.nu[k], js.nu[k])):
                np.testing.assert_allclose(t2n(got), np.asarray(want),
                                           rtol=1e-6, err_msg=k)
    assert ts.count == int(js.count) == 3
    if masked:
        assert (t2n(tp["w"])[1::2] == params["w"][1::2]).all()
        assert (t2n(ts.mu["w"])[1::2] == 0).all()


def test_add_densification_stats_matches_jax(rng):
    cap = 32
    js, ts = jdens.init_stats(cap), tdens.init_stats(cap, "cpu")
    for _ in range(2):
        radii = rng.integers(0, 4, cap).astype(np.float32)
        grad = rng.standard_normal((cap, 2)).astype(np.float32)
        js = jdens.add_densification_stats(js, jnp.asarray(radii),
                                           jnp.asarray(grad))
        ts = tdens.add_densification_stats(ts, torch.tensor(radii),
                                           torch.tensor(grad))
    for k in STATS_FIELDS:
        np.testing.assert_allclose(t2n(getattr(ts, k)),
                                   np.asarray(getattr(js, k)), rtol=1e-6,
                                   err_msg=k)


def _mini(rng, n, cap, moments):
    """A JAX GaussianParams from create_from_pcd and an AdamState with
    random moments (so that zeroed rows show)."""
    pts = rng.standard_normal((n, 3)).astype(np.float32)
    colors = rng.uniform(0, 1, (n, 3)).astype(np.float32)
    g = jgm.create_from_pcd(pts, colors, 1, capacity=cap)
    adam = joptim.init(jgm.trainables(g))
    if moments:
        adam = joptim.AdamState(
            mu={k: jnp.asarray(rng.standard_normal(v.shape), jnp.float32)
                for k, v in adam.mu.items()},
            nu={k: jnp.asarray(rng.uniform(0, 1, v.shape), jnp.float32)
                for k, v in adam.nu.items()}, count=jnp.asarray(5))
    return g, adam


# name: (n, cap, rows with a high gradient, scaling overrides, opacity
#        overrides, max_grad, percent_dense, screen-size prune,
#        expected (overflow, rows born) or None)
DENSIFY_CASES = {
    "clone_split": (8, 16, [0, 1], {0: np.log(0.001), 1: np.log(10.0)}, {},
                    0.5, 0.01, False, (0, 2)),
    "prune": (8, 16, [], {}, {3: -10.0}, 1e9, 0.01, False, (0, -1)),
    # one clone and one split fit the three free slots; the other split is
    # not placed and its original stays
    "split_short_of_slots": (8, 11, [0, 1, 2], {0: np.log(0.001),
                                                1: np.log(10.0),
                                                2: np.log(10.0)}, {},
                             0.5, 0.01, False, (2, 2)),
    "screen_size_prune": (8, 16, [0, 1], {0: np.log(0.001),
                                          1: np.log(10.0)}, {}, 0.5, 0.01,
                          True, None),
    "overflow": (16, 16, list(range(16)), {}, {}, 0.5, 10.0, False, (16, 0)),
}


@pytest.mark.parametrize("case", list(DENSIFY_CASES))
def test_densify_and_prune_matches_jax(rng, case):
    n, cap, hot, scl, opa, max_grad, pdense, screen, expect = \
        DENSIFY_CASES[case]
    g, adam = _mini(rng, n, cap, moments=True)
    for i, v in scl.items():
        g = dataclasses.replace(g, scaling=g.scaling.at[i].set(v))
    for i, v in opa.items():
        g = dataclasses.replace(g, opacity=g.opacity.at[i].set(v))
    stats = jdens.init_stats(cap)
    stats = dataclasses.replace(
        stats, xyz_gradient_accum=stats.xyz_gradient_accum.at[
            np.array(hot, int)].set(1.0), denom=stats.denom.at[:n].set(1.0))
    key = jax.random.PRNGKey(0)
    noise = (jax.random.normal(key, (cap, 3)),
             jax.random.normal(jax.random.fold_in(key, 1), (cap, 3)))
    kw = dict(max_grad=max_grad, min_opacity=0.005, extent=1.0,
              percent_dense=pdense, use_screen_size_prune=screen)
    g2, adam2, stats2, ovf = jdens.densify_and_prune(g, adam, stats, key,
                                                     **kw)

    tg = tgm.from_numpy(to_numpy(g, PARAM_FIELDS), device="cpu")
    tadam = toptim.AdamState(
        mu={k: torch.tensor(np.asarray(v)) for k, v in adam.mu.items()},
        nu={k: torch.tensor(np.asarray(v)) for k, v in adam.nu.items()},
        count=5)
    tstats = tdens.DensifyStats(**{k: torch.tensor(np.asarray(getattr(
        stats, k))) for k in STATS_FIELDS})
    tg2, tadam2, tstats2, tovf = tdens.densify_and_prune(
        tg, tadam, tstats, noise=tuple(torch.tensor(np.asarray(x))
                                       for x in noise), **kw)

    assert tovf == int(ovf)
    np.testing.assert_array_equal(t2n(tg2.active), np.asarray(g2.active))
    for k in TRAINABLE:
        np.testing.assert_allclose(t2n(getattr(tg2, k)),
                                   np.asarray(getattr(g2, k)), rtol=1e-6,
                                   atol=1e-7, err_msg=k)
        np.testing.assert_array_equal(t2n(tadam2.mu[k]),
                                      np.asarray(adam2.mu[k]), err_msg=k)
        np.testing.assert_array_equal(t2n(tadam2.nu[k]),
                                      np.asarray(adam2.nu[k]), err_msg=k)
    for k in STATS_FIELDS:
        assert float(getattr(tstats2, k).abs().sum()) == 0.0
    if expect is not None:
        born = int(g2.active.sum()) - int(g.active.sum())
        assert (int(ovf), born) == expect


def test_reset_opacity_matches_jax(rng):
    g, adam = _mini(rng, 8, 12, moments=True)
    g = dataclasses.replace(g, opacity=g.opacity.at[:8].set(
        rng.uniform(-6, 4, 8).astype(np.float32)))
    g2, adam2 = jdens.reset_opacity(g, adam)
    tg = tgm.from_numpy(to_numpy(g, PARAM_FIELDS), device="cpu")
    tadam = toptim.AdamState(
        mu={k: torch.tensor(np.asarray(v)) for k, v in adam.mu.items()},
        nu={k: torch.tensor(np.asarray(v)) for k, v in adam.nu.items()},
        count=5)
    state = ttrainer.TrainState(gaussians=tg, adam=tadam, exposure=None,
                                exp_adam=None, stats=None, step=0)
    state = ttrainer.opacity_reset_step(state)
    np.testing.assert_allclose(t2n(state.gaussians.opacity),
                               np.asarray(g2.opacity), rtol=1e-6)
    assert float(state.adam.mu["opacity"].abs().sum()) == 0
    np.testing.assert_array_equal(t2n(state.adam.mu["xyz"]),
                                  np.asarray(adam2.mu["xyz"]))


def test_create_from_pcd_and_knn_match_jax(rng):
    pts = rng.standard_normal((50, 3)).astype(np.float32)
    colors = rng.uniform(0, 1, (50, 3)).astype(np.float32)
    for k, block in ((3, 16), (5, 1024)):
        np.testing.assert_allclose(
            t2n(tknn.mean_sq_dist_to_knn(torch.tensor(pts), k, block)),
            np.asarray(jknn.mean_sq_dist_to_knn(jnp.asarray(pts), k, block)),
            rtol=1e-4, atol=1e-6)
    g = jgm.create_from_pcd(pts, colors, 2, capacity=64)
    tg = tgm.create_from_pcd(pts, colors, 2, capacity=64, device="cpu")
    assert tg.active_sh_degree == 0 and tg.num_active() == 50
    for k in PARAM_FIELDS[:-1]:
        np.testing.assert_allclose(t2n(getattr(tg, k)),
                                   np.asarray(getattr(g, k)), rtol=1e-5,
                                   atol=1e-5, err_msg=k)


# ---------------------------------------------------------------- the step

_STATIC = ("image_width", "image_height", "opt", "rcfg", "antialiasing",
           "train_test_exp", "use_depth")


@functools.partial(jax.jit, static_argnames=_STATIC)
def _jax_loss_grads(g, exposure, cam, gt, am, idg, dm, bg, step, **kw):
    loss, l1, dl1, out, grads, exp_grads, tap = jtrainer.camera_loss_grads(
        g, exposure, cam, gt, am, idg, dm, bg, step, **kw)
    return loss, grads, exp_grads, tap


def _step_setup(rng):
    th, tw, chunk, _, _ = SMALL
    W, H = tw, 2 * th
    g, cam = make_scene(rng, n=100, cap=128)
    cj, ct = configs(th, tw, chunk)
    gt = rng.uniform(0.2, 0.8, (3, H, W)).astype(np.float32)
    imgs = (gt, np.ones((1, H, W), np.float32),
            np.zeros((1, H, W), np.float32), np.zeros((1, H, W), np.float32),
            np.zeros(3, np.float32))
    common = dict(image_width=W, image_height=H, antialiasing=False,
                  train_test_exp=False, use_depth=False)
    return g, cam, cj, ct, imgs, common


def _jax_step(state, cam, imgs, cj, common):
    return jtrainer.train_step(state, cam, *_jnp(imgs), rcfg=cj,
                               opt=JaxOptimizationConfig(**OPT_KW),
                               spatial_lr_scale=1.0, use_sparse_adam=False,
                               **common)


def _port_step(state, cam, imgs, ct, common):
    return ttrainer.train_step(state, cam, *map(torch.tensor, imgs), rcfg=ct,
                               opt=OptimizationConfig(**OPT_KW),
                               spatial_lr_scale=1.0, use_sparse_adam=False,
                               **common)


@functools.lru_cache(maxsize=None)
def _first_step():
    """The inputs of ``_step_setup`` from seed 0 and JAX's first step from
    the initial state, shared by the tests that start from them."""
    setup = _step_setup(np.random.default_rng(0))
    g, cam, cj, _, imgs, common = setup
    s0 = jtrainer.init_state(g, 1)
    return setup, s0, _jax_step(s0, cam, imgs, cj, common)


def test_train_step_matches_jax_from_carried_state():
    """Both packages take the first step from the same state: loss, Adam
    moments, parameters, densification stats."""
    (g, cam, cj, ct, imgs, common), s0, (s1, aux) = _first_step()
    t0 = ttrainer.state_from_numpy(state_to_numpy(s0), device="cpu")
    _, tcam = port_scene(g, cam)
    t1, taux = _port_step(t0, tcam, imgs, ct, common)

    np.testing.assert_allclose(float(taux.loss), float(aux.loss), rtol=1e-5)
    np.testing.assert_allclose(float(taux.l1), float(aux.l1), rtol=1e-5)
    assert t1.step == int(s1.step) == 1 and t1.adam.count == 1
    lrs = ttrainer._lr_dict(OptimizationConfig(**OPT_KW), 1, 1.0)
    for k in TRAINABLE:
        g_j = np.asarray(s1.adam.mu[k]) / 0.1        # the step's gradient
        # mu = 0.1 g and nu = 0.001 g²: the gradient gate, scaled
        np.testing.assert_allclose(t2n(t1.adam.mu[k]), 0.1 * g_j,
                                   rtol=5e-3, atol=1e-7, err_msg=k)
        np.testing.assert_allclose(t2n(t1.adam.nu[k]),
                                   np.asarray(s1.adam.nu[k]), rtol=1e-2,
                                   atol=5e-15, err_msg=k)
        # ±lr by the gradient's sign; 2·lr where the sign is rounding
        flip = np.where(np.abs(g_j) < GRAD_TOL["atol"], 2 * lrs[k], 0.0)
        err = np.abs(t2n(getattr(t1.gaussians, k))
                     - np.asarray(getattr(s1.gaussians, k)))
        assert (err <= 1e-6 * np.abs(np.asarray(getattr(s1.gaussians, k)))
                + 1e-7 + flip).all(), k
    for k in STATS_FIELDS:
        np.testing.assert_allclose(t2n(getattr(t1.stats, k)),
                                   np.asarray(getattr(s1.stats, k)),
                                   **GRAD_TOL, err_msg=k)
    np.testing.assert_allclose(t2n(t1.exposure), np.asarray(s1.exposure))


def test_loss_grads_and_update_match_jax_on_carried_state():
    """From a JAX state one step in (moments, stats and step carried
    across): camera_loss_grads within the gradient gate, and
    finish_train_step on JAX's own gradients within rtol 1e-6."""
    (g, cam, cj, ct, imgs, common), _, (s1, _) = _first_step()
    t1 = ttrainer.state_from_numpy(state_to_numpy(s1), device="cpu")
    _, tcam = port_scene(g, cam)
    jopt, topt = JaxOptimizationConfig(**OPT_KW), OptimizationConfig(**OPT_KW)

    loss, grads, exp_grads, tap = _jax_loss_grads(
        s1.gaussians, s1.exposure, cam, *_jnp(imgs), 2, opt=jopt, rcfg=cj,
        **common)
    tloss, _, _, _, tgrads, texp, ttap = ttrainer.camera_loss_grads(
        t1.gaussians, t1.exposure, tcam, *map(torch.tensor, imgs), 2,
        opt=topt, rcfg=ct, **common)
    np.testing.assert_allclose(float(tloss), float(loss), rtol=1e-5)
    for k in TRAINABLE:
        np.testing.assert_allclose(t2n(tgrads[k]), np.asarray(grads[k]),
                                   err_msg=k, **GRAD_TOL)
    np.testing.assert_allclose(t2n(ttap), np.asarray(tap), **GRAD_TOL)
    np.testing.assert_allclose(t2n(texp), np.asarray(exp_grads), **GRAD_TOL)
    assert np.abs(np.asarray(tap)).max() > 0

    s2 = jtrainer.finish_train_step(s1, grads, exp_grads, s1.stats, 2, None,
                                    opt=jopt, spatial_lr_scale=1.0)
    t2 = ttrainer.finish_train_step(
        t1, {k: torch.tensor(np.asarray(v)) for k, v in grads.items()},
        torch.tensor(np.asarray(exp_grads)), t1.stats, 2, None, opt=topt,
        spatial_lr_scale=1.0)
    for k in TRAINABLE:
        for got, want in ((getattr(t2.gaussians, k), getattr(s2.gaussians,
                                                              k)),
                          (t2.adam.mu[k], s2.adam.mu[k]),
                          (t2.adam.nu[k], s2.adam.nu[k])):
            np.testing.assert_allclose(t2n(got), np.asarray(want),
                                       rtol=1e-6, atol=1e-12, err_msg=k)
    assert t2.adam.count == int(s2.adam.count) == 2


def _port_scene_state(rng, n=100, cap=128, sh_degree=1):
    th, tw, chunk, _, _ = SMALL
    g, cam = make_scene(rng, n=n, cap=cap, sh_degree=sh_degree)
    tg, tcam = port_scene(g, cam)
    return tg, tcam, configs(th, tw, chunk)[1]


def _train(state, cam, rcfg, W, H, gt, opt, *, invdepth=None, dmask=None,
           use_depth=False):
    ones = torch.ones((1, H, W))
    zeros = torch.zeros((1, H, W))
    return ttrainer.train_step(
        state, cam, gt, ones, zeros if invdepth is None else invdepth,
        zeros if dmask is None else dmask, torch.zeros(3), image_width=W,
        image_height=H, opt=opt, rcfg=rcfg, spatial_lr_scale=1.0,
        antialiasing=False, use_sparse_adam=False, train_test_exp=False,
        use_depth=use_depth)


def test_train_step_improves_loss(rng):
    tg, tcam, rcfg = _port_scene_state(rng)
    W, H = SMALL[1], 2 * SMALL[0]
    gt = torch.tensor(rng.uniform(0.2, 0.8, (3, H, W)).astype(np.float32))
    state = ttrainer.init_state(tg, 1)
    losses = []
    for _ in range(8):
        state, aux = _train(state, tcam, rcfg, W, H, gt,
                            OptimizationConfig(**OPT_KW))
        losses.append(float(aux.loss))
    assert losses[-1] < losses[0], losses
    assert state.step == 8 and int(aux.overflow) == 0
    assert float(state.gaussians.xyz[100:].abs().sum()) == 0.0  # dead slots


def test_sh_degree_warmup(rng):
    tg, tcam, rcfg = _port_scene_state(rng, n=16, cap=16, sh_degree=2)
    W, H = SMALL[1], SMALL[0]
    state = ttrainer.init_state(dataclasses.replace(tg, active_sh_degree=0),
                                1)
    state = dataclasses.replace(state, step=999)
    state, _ = _train(state, tcam, rcfg, W, H, torch.zeros((3, H, W)),
                      OptimizationConfig())
    assert state.gaussians.active_sh_degree == 1
    state, _ = _train(state, tcam, rcfg, W, H, torch.zeros((3, H, W)),
                      OptimizationConfig())
    assert state.gaussians.active_sh_degree == 1


def test_depth_regularization_active(rng):
    """The scheduled inverse-depth L1: reported, in the loss, in the update,
    and nothing where the depth mask is 0."""
    from gsplat_tpu_torch.ops.rasterize import render
    tg, tcam, rcfg = _port_scene_state(rng)
    W, H = SMALL[1], 2 * SMALL[0]
    gt = torch.tensor(rng.uniform(0, 1, (3, H, W)).astype(np.float32))
    with torch.no_grad():
        inv_gt = render(tg, tcam, W, H, torch.zeros(3), rcfg).invdepth + 0.05
    dmask = torch.ones((1, H, W))
    state0 = ttrainer.init_state(tg, 1)
    opt = OptimizationConfig()
    kw = dict(invdepth=inv_gt, dmask=dmask)
    s_d, aux_d = _train(state0, tcam, rcfg, W, H, gt, opt, use_depth=True,
                        **kw)
    s_n, aux_n = _train(state0, tcam, rcfg, W, H, gt, opt, **kw)
    assert float(aux_d.depth_l1) > 0.01
    assert float(aux_d.loss) > float(aux_n.loss)
    assert not torch.allclose(s_d.gaussians.xyz, s_n.gaussians.xyz)
    _, aux_m = _train(state0, tcam, rcfg, W, H, gt, opt, use_depth=True,
                      invdepth=inv_gt, dmask=torch.zeros_like(dmask))
    assert float(aux_m.depth_l1) == 0.0
