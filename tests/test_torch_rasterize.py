"""Port parity of the whole render path: gsplat_tpu_torch ``render`` against
JAX ``render`` on its XLA oracle route (use_pallas=False), image and
invdepth within rtol 2e-4 / atol 2e-5 (tests/test_rasterize.py's gate),
radii as in preprocess, no overflow; plus the port's counterparts of the
JAX suite's background, padding, exposure and overflow checks, and
weights carried over through ``from_numpy`` and through a PLY file."""
import dataclasses
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from gsplat_tpu.models import gaussian_model as jgm
from gsplat_tpu.ops import rasterize as jras
from gsplat_tpu.scene import ply as jply
from gsplat_tpu_torch.models import gaussian_model as tgm
from gsplat_tpu_torch.ops import rasterize as tras
from gsplat_tpu_torch.scene import ply as tply

from torch_parity import (DEFAULT_TILES, SMALL, configs, make_scene,
                          port_scene, t2n)

IMG_TOL = dict(rtol=2e-4, atol=2e-5)
GRAD_TOL = dict(rtol=5e-3, atol=1e-6)     # the JAX suite's gradient gate


@functools.partial(jax.jit, static_argnames=(
    "W", "H", "cfg", "antialiasing", "clamp", "m_cap"))
def _jax_render(g, cam, bg, exposure=None, *, W, H, cfg, antialiasing=False,
                clamp=False, m_cap=None):
    return jras.render(g, cam, W, H, bg, cfg, antialiasing=antialiasing,
                       exposure=exposure, clamp=clamp, m_cap=m_cap)


def _assert_images_close(ot, oj):
    np.testing.assert_allclose(t2n(ot.image), np.asarray(oj.image),
                               **IMG_TOL)
    np.testing.assert_allclose(t2n(ot.invdepth), np.asarray(oj.invdepth),
                               **IMG_TOL)


@pytest.mark.parametrize("shape,antialiasing", [
    (SMALL, False), (SMALL, True), (DEFAULT_TILES, False)],
    ids=["8x128", "8x128-aa", "32x32"])
def test_render_matches_jax(rng, shape, antialiasing):
    th, tw, chunk, W, H = shape
    g, cam = make_scene(rng, n=400, cap=420)
    tg, tcam = port_scene(g, cam)
    cj, ct = configs(th, tw, chunk)
    oj = _jax_render(g, cam, jnp.full(3, 0.3), W=W, H=H, cfg=cj,
                     antialiasing=antialiasing)
    ot = tras.render(tg, tcam, W, H, torch.full((3,), 0.3), ct,
                     antialiasing=antialiasing, clamp=False)
    assert int(oj.overflow) == 0 and int(ot.overflow) == 0
    _assert_images_close(ot, oj)
    a, b = t2n(ot.radii), np.asarray(oj.radii)
    assert np.abs(a - b).max() <= 1 and (a == b).mean() >= 0.999
    assert (a > 0).sum() > 100


def test_background_blending(rng):
    th, tw, chunk, _, _ = SMALL
    g, cam = make_scene(rng, n=5)
    g = dataclasses.replace(g, xyz=g.xyz - jnp.array([0.0, 0.0, 100.0]))
    tg, tcam = port_scene(g, cam)
    bg = torch.tensor([0.2, 0.4, 0.6])
    out = tras.render(tg, tcam, tw, th, bg, configs(th, tw, chunk)[1])
    for ch in range(3):
        np.testing.assert_allclose(t2n(out.image[ch]), float(bg[ch]),
                                   atol=1e-6)
    assert int((out.radii > 0).sum()) == 0


def test_padding_slots_do_not_render(rng):
    th, tw, chunk, _, _ = SMALL
    g, cam = make_scene(rng, n=64, cap=128)
    tg, tcam = port_scene(g, cam)
    c = configs(th, tw, chunk)[1]
    out1 = tras.render(tg, tcam, tw, 2 * th, torch.zeros(3), c)
    junk = dataclasses.replace(tg, xyz=tg.xyz.clone(),
                               opacity=tg.opacity.clone())
    junk.xyz[64:] = torch.tensor(np.random.default_rng(1).standard_normal(
        (64, 3)) + [0, 0, 5], dtype=torch.float32)
    junk.opacity[64:] = 3.0
    out2 = tras.render(junk, tcam, tw, 2 * th, torch.zeros(3), c)
    np.testing.assert_array_equal(t2n(out1.image), t2n(out2.image))


def test_exposure_matches_jax(rng):
    th, tw, chunk, W, H = SMALL
    g, cam = make_scene(rng, n=200)
    tg, tcam = port_scene(g, cam)
    cj, ct = configs(th, tw, chunk)
    exposure = (np.eye(3, 4) + 0.1 * rng.standard_normal((3, 4))).astype(
        np.float32)
    oj = _jax_render(g, cam, jnp.full(3, 0.1), jnp.asarray(exposure), W=W,
                     H=H, cfg=cj, clamp=True)
    ot = tras.render(tg, tcam, W, H, torch.full((3,), 0.1), ct,
                     exposure=torch.tensor(exposure))
    _assert_images_close(ot, oj)


def test_overflow_reported_like_jax(rng):
    th, tw, chunk, _, _ = SMALL
    g, cam = make_scene(rng, n=200)
    tg, tcam = port_scene(g, cam)
    cj, ct = configs(th, tw, chunk)
    oj = _jax_render(g, cam, jnp.zeros(3), W=tw, H=th, cfg=cj, m_cap=16)
    ot = tras.render(tg, tcam, tw, th, torch.zeros(3), ct, m_cap=16)
    assert int(oj.overflow) > 0
    assert int(ot.overflow) == int(oj.overflow)
    assert int(ot.num_pairs) == int(oj.num_pairs)


def test_weights_through_jax_ply(rng, tmp_path):
    """A PLY written by the JAX package, read by the port, renders as JAX
    renders the same weights."""
    th, tw, chunk, W, H = DEFAULT_TILES
    g, cam = make_scene(rng, n=300, sh_degree=3)
    g = dataclasses.replace(g, f_rest=g.f_rest.at[:].set(
        0.1 * rng.standard_normal(g.f_rest.shape).astype(np.float32)))
    path = str(tmp_path / "point_cloud.ply")
    jply.save_gaussian_ply(path, *(np.asarray(getattr(g, k)) for k in (
        "xyz", "f_dc", "f_rest", "opacity", "scaling", "rotation")))
    data = tply.load_gaussian_ply(path)
    ref = jply.load_gaussian_ply(path)
    for k, v in ref.items():
        np.testing.assert_array_equal(data[k], v, err_msg=k)
    tg = tgm.from_numpy(data, device="cpu", capacity=320)
    assert tg.active_sh_degree == 3 and tg.num_active() == 300
    _, tcam = port_scene(g, cam)
    cj, ct = configs(th, tw, chunk)
    oj = _jax_render(g, cam, jnp.zeros(3), W=W, H=H, cfg=cj)
    ot = tras.render(tg, tcam, W, H, torch.zeros(3), ct, clamp=False)
    _assert_images_close(ot, oj)
    # compact() packs live rows first: same rows, same image
    shuffled = dataclasses.replace(tg, **{
        k: torch.flip(getattr(tg, k), [0]) for k in tgm.TENSOR_FIELDS})
    np.testing.assert_array_equal(
        t2n(tgm.compact(shuffled).xyz[:300]), t2n(torch.flip(tg.xyz[:300],
                                                            [0])))


def test_render_gradients_match_jax(rng):
    """The CPU route stays differentiable: gradients of an image loss
    through the whole path match JAX's (the oracle a backward kernel will
    be held to)."""
    th, tw, chunk, _, _ = SMALL
    W, H = tw, 2 * th
    g, cam = make_scene(rng, n=120)
    tg, tcam = port_scene(g, cam)
    cj, ct = configs(th, tw, chunk)
    target = np.linspace(0, 1, 3 * H * W, dtype=np.float32).reshape(3, H, W)
    fields = ("xyz", "f_dc", "f_rest", "scaling", "rotation", "opacity")

    def jloss(trains, tap):
        out = jras.render(jgm.with_trainables(g, trains), cam, W, H,
                          jnp.full(3, 0.25), cj, mean2d_tap=tap, clamp=False)
        return (jnp.abs(out.image - target).mean()
                + 0.1 * jnp.abs(out.invdepth).mean())

    tap_j = jnp.zeros((g.capacity, 2), jnp.float32)
    gj = jax.jit(jax.grad(jloss, argnums=(0, 1)))(jgm.trainables(g), tap_j)

    params = {k: getattr(tg, k).clone().requires_grad_() for k in fields}
    tap = torch.zeros((tg.capacity, 2), requires_grad=True)
    out = tras.render(dataclasses.replace(tg, **params), tcam, W, H,
                      torch.full((3,), 0.25), ct, mean2d_tap=tap, clamp=False)
    loss = ((out.image - torch.tensor(target)).abs().mean()
            + 0.1 * out.invdepth.abs().mean())
    loss.backward()
    for k in fields:
        np.testing.assert_allclose(t2n(params[k].grad), np.asarray(gj[0][k]),
                                   err_msg=k, **GRAD_TOL)
    np.testing.assert_allclose(t2n(tap.grad), np.asarray(gj[1]), **GRAD_TOL)
    assert tap.grad.abs().max() > 0
