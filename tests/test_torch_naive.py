"""The port's naive per-pixel oracle (ops/naive.py), which shares no code
with binning or the tile compositors beyond ``tile_rect``: it equals the JAX
package's naive oracle, the tiled render equals it (the port of
``test_tiled_xla_matches_naive``, rtol 1e-4 / atol 1e-5), and so do the
depth-slab and tile-band renders; and the render's gradient meets central
finite differences (the port of ``test_xla_gradients_finite_difference``)."""
import dataclasses

import numpy as np
import pytest
import torch

import jax

from gsplat_tpu.ops import naive as jnaive
from gsplat_tpu.ops import preprocess as jpre
from gsplat_tpu_torch.ops import naive as tnaive
from gsplat_tpu_torch.ops import preprocess as tpre
from gsplat_tpu_torch.ops import rasterize as tras
from gsplat_tpu_torch.parallel import prim_shard as tprim
from gsplat_tpu_torch.parallel import tile_shard as ttile

from torch_parity import SMALL, configs, make_scene, port_scene, t2n

NAIVE_TOL = dict(rtol=1e-4, atol=1e-5)     # tests/test_rasterize.py:71-76
TH, TW, CHUNK = SMALL[:3]


def _pre(tg, tcam, W, H, cfg, antialiasing=False):
    return tpre.preprocess(
        tg.xyz, tg.get_scaling(), tg.get_rotation(), tg.get_opacity(),
        tg.get_features(), tg.active_sh_degree, tcam, W, H,
        active_mask=tg.active, antialiasing=antialiasing,
        dilation=cfg.dilation, alpha_min=cfg.alpha_min)


@pytest.mark.parametrize("antialiasing", [False, True])
def test_tiled_matches_naive(rng, antialiasing):
    W, H = 2 * TW, 3 * TH
    g, cam = make_scene(rng, n=300)
    tg, tcam = port_scene(g, cam)
    ct = configs(TH, TW, CHUNK)[1]
    with torch.no_grad():
        accum, t = tnaive.composite_naive(
            _pre(tg, tcam, W, H, ct, antialiasing), image_width=W,
            image_height=H, tile_h=TH, tile_w=TW)
        out = tras.render(tg, tcam, W, H, torch.zeros(3), ct,
                          antialiasing=antialiasing, clamp=False)
    assert int(out.overflow) == 0 and float(accum[:3].std()) > 0.01
    np.testing.assert_allclose(t2n(out.image), t2n(accum[:3]), **NAIVE_TOL)
    np.testing.assert_allclose(t2n(out.invdepth[0]), t2n(accum[3]),
                               **NAIVE_TOL)
    assert (t2n(t) < 1e-3).any()                     # opaque pixels

    jp = jpre.preprocess(
        g.xyz, g.get_scaling(), g.get_rotation(), g.get_opacity(),
        g.get_features(), g.active_sh_degree, cam, W, H,
        active_mask=g.active, antialiasing=antialiasing)
    accum_j, t_j = jax.jit(lambda p: jnaive.composite_naive(
        p, image_width=W, image_height=H, tile_h=TH, tile_w=TW))(jp)
    np.testing.assert_allclose(t2n(accum), np.asarray(accum_j), **NAIVE_TOL)
    np.testing.assert_allclose(t2n(t), np.asarray(t_j), **NAIVE_TOL)


def test_slab_and_band_renders_match_naive(rng):
    """The oracle that shares nothing with the tiled path holds the two
    renders built on it: bands at the tiled render's gate, slabs at the
    cut's own magnitude (atol 1e-3)."""
    W, H = TW, 4 * TH
    g, cam = make_scene(rng, n=300)
    tg, tcam = port_scene(g, cam)
    ct = configs(TH, TW, CHUNK)[1]
    bg = torch.zeros(3)
    with torch.no_grad():
        accum, _ = tnaive.composite_naive(
            _pre(tg, tcam, W, H, ct), image_width=W, image_height=H,
            tile_h=TH, tile_w=TW)
        want = torch.clamp(accum[:3], 0.0, 1.0)
        img_b, inv_b, _, ovf_b = ttile.render_tile_sharded(
            tg, tcam, W, H, bg, ct, n_bands=2)
        img_s, inv_s, ovf_s = tprim.render_prim_sharded(
            tg, tcam, W, H, bg, ct, n_slabs=4, m_cap=300 * 12)
    assert int(ovf_b) == 0 and int(ovf_s) == 0
    np.testing.assert_allclose(t2n(img_b), t2n(want), **NAIVE_TOL)
    np.testing.assert_allclose(t2n(inv_b[0]), t2n(accum[3]), **NAIVE_TOL)
    np.testing.assert_allclose(t2n(img_s), t2n(want), rtol=0, atol=1e-3)
    np.testing.assert_allclose(t2n(inv_s[0]), t2n(accum[3]), rtol=0,
                               atol=1e-3)


def test_render_gradients_finite_difference(rng):
    """Spot central-difference check of the whole differentiable path."""
    W, H = TW, TH
    g, cam = make_scene(rng, n=20)
    tg, tcam = port_scene(g, cam)
    ct = configs(TH, TW, CHUNK)[1]

    def loss_of_xyz(xyz):
        out = tras.render(dataclasses.replace(tg, xyz=xyz), tcam, W, H,
                          torch.zeros(3), ct, clamp=False)
        return out.image.abs().mean()

    xyz = tg.xyz.clone().requires_grad_()
    loss_of_xyz(xyz).backward()
    eps = 1e-3
    rng2 = np.random.default_rng(3)
    with torch.no_grad():
        for _ in range(4):
            i, j = int(rng2.integers(0, 20)), int(rng2.integers(0, 3))
            e = torch.zeros_like(tg.xyz)
            e[i, j] = eps
            fd = (float(loss_of_xyz(tg.xyz + e))
                  - float(loss_of_xyz(tg.xyz - e))) / (2 * eps)
            an = float(xyz.grad[i, j])
            assert abs(fd - an) <= 1e-3 * max(1.0, abs(fd)) + 1e-5, \
                (i, j, fd, an)
    assert float(xyz.grad.abs().max()) > 0
