"""Port parity of the depth-slab and tile-band renders. The same state,
made with numpy and carried across with ``from_numpy``, goes through the JAX
package's ``render_prim_sharded`` / ``render_tile_sharded`` on a mesh of 4 of
the 8 virtual CPU devices (its XLA oracle route) and through the port's, which
run the 4 slabs or bands one after another on the CPU through the plain
compositor. Gates: the image gate rtol 2e-4 / atol 2e-5 against JAX; against
the port's own single render the JAX suite's gates for these paths: atol 1e-3
for slabs (the cut's own magnitude), rtol 1e-5 / atol 1e-6 for bands (tiles
are independent), rtol 1e-3 / atol 5e-4 for the slab gradient."""
import dataclasses
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from gsplat_tpu.core import transforms as jtf
from gsplat_tpu.parallel import prim_shard as jprim
from gsplat_tpu.parallel import tile_shard as jtile
from gsplat_tpu.parallel.mesh import make_mesh
from gsplat_tpu_torch.ops import rasterize as tras
from gsplat_tpu_torch.ops.composite_ref import slab_transmittance_plain
from gsplat_tpu_torch.parallel import gather_parts
from gsplat_tpu_torch.parallel import prim_shard as tprim
from gsplat_tpu_torch.parallel import tile_shard as ttile

from torch_parity import SMALL, configs, make_scene, port_scene, t2n

IMG_TOL = dict(rtol=2e-4, atol=2e-5)
GRAD_TOL = dict(rtol=5e-3, atol=1e-6)          # the JAX suite's gradient gate
SLAB_GRAD_TOL = dict(rtol=1e-3, atol=5e-4)     # tests/test_parallel.py:221
N_PARTS = 4
TH, TW, CHUNK = SMALL[:3]


def _mesh(axis):
    return make_mesh(((axis, N_PARTS),), devices=jax.devices()[:N_PARTS])


@functools.partial(jax.jit, static_argnames=("W", "H", "cfg", "m_cap",
                                             "exact_cut"))
def _jax_prim(g, cam, bg, *, W, H, cfg, m_cap=None, exact_cut=True):
    return jprim.render_prim_sharded(g, cam, W, H, bg, cfg, _mesh("prim"),
                                     m_cap=m_cap, exact_cut=exact_cut)


@functools.partial(jax.jit, static_argnames=("W", "H", "cfg"))
def _jax_tile(g, cam, bg, *, W, H, cfg):
    return jtile.render_tile_sharded(g, cam, W, H, bg, cfg, _mesh("tile"))


@pytest.mark.parametrize("n,n_slabs", [(3000, 4), (20_000, 4), (20_000, 3),
                                       (500, 8)])
def test_slab_bounds_equal_jax_exactly(n, n_slabs):
    """Also with more visible gaussians than the 4096 samples: the sample
    index is float32 arithmetic, and any other picks other samples."""
    rng = np.random.default_rng(n)
    depth = rng.uniform(0.3, 9.0, n).astype(np.float32)
    visible = rng.uniform(0, 1, n) < 0.9
    want = np.asarray(jprim._slab_bounds(jnp.asarray(depth),
                                         jnp.asarray(visible), n_slabs))
    got = t2n(tprim._slab_bounds(torch.tensor(depth), torch.tensor(visible),
                                 n_slabs))
    np.testing.assert_array_equal(got, want)
    assert got.shape == (n_slabs + 1,) and (np.diff(got) >= 0).all()
    frac = np.histogram(depth[visible], bins=got)[0] / visible.sum()
    if n >= 3000:                   # even quantiles of ALL visible depths
        assert np.abs(frac - 1.0 / n_slabs).max() < 0.05


def test_gather_parts_stacks_in_part_order():
    parts = [torch.full((2, 3), float(k)) for k in range(3)]
    out = gather_parts(parts)
    assert tuple(out.shape) == (3, 2, 3)
    np.testing.assert_array_equal(t2n(out[:, 0, 0]), [0.0, 1.0, 2.0])


def _slab_scene(rng):
    W, H = TW, 4 * TH
    g, cam = make_scene(rng, n=400)
    cj, ct = configs(TH, TW, CHUNK)
    # depth slabs are load-imbalanced: give each half the frame's capacity
    return g, cam, cj, ct, W, H, int(400 * 24 / 2)


def test_prim_sharded_matches_jax_and_single(rng):
    g, cam, cj, ct, W, H, m_cap = _slab_scene(rng)
    tg, tcam = port_scene(g, cam)
    img_j, inv_j, ovf_j = _jax_prim(g, cam, jnp.full(3, 0.25), W=W, H=H,
                                    cfg=cj, m_cap=m_cap)
    with torch.no_grad():
        img_t, inv_t, ovf_t = tprim.render_prim_sharded(
            tg, tcam, W, H, torch.full((3,), 0.25), ct, n_slabs=N_PARTS,
            m_cap=m_cap)
        single = tras.render(tg, tcam, W, H, torch.full((3,), 0.25), ct)
    assert int(ovf_j) == 0 and int(ovf_t) == 0
    assert tuple(img_t.shape) == (3, H, W) and tuple(inv_t.shape) == (1, H, W)
    np.testing.assert_allclose(t2n(img_t), np.asarray(img_j), **IMG_TOL)
    np.testing.assert_allclose(t2n(inv_t), np.asarray(inv_j), **IMG_TOL)
    np.testing.assert_allclose(t2n(img_t), t2n(single.image), rtol=0,
                               atol=1e-3)
    np.testing.assert_allclose(t2n(inv_t), t2n(single.invdepth), rtol=0,
                               atol=1e-3)
    assert float(single.image.std()) > 0.01          # not a blank frame


def test_prim_sharded_without_exact_cut(rng):
    """Each slab then stops as if nothing lay in front of it: the documented
    ~1e-2 from the single render on saturated pixels, the same as JAX's."""
    g, cam, cj, ct, W, H, m_cap = _slab_scene(rng)
    tg, tcam = port_scene(g, cam)
    bg = torch.full((3,), 0.25)
    img_j, _, _ = _jax_prim(g, cam, jnp.full(3, 0.25), W=W, H=H, cfg=cj,
                            m_cap=m_cap, exact_cut=False)
    with torch.no_grad():
        img_t, _, ovf = tprim.render_prim_sharded(
            tg, tcam, W, H, bg, ct, n_slabs=N_PARTS, m_cap=m_cap,
            exact_cut=False)
        single = tras.render(tg, tcam, W, H, bg, ct)
    assert int(ovf) == 0
    np.testing.assert_allclose(t2n(img_t), np.asarray(img_j), **IMG_TOL)
    assert float((img_t - single.image).abs().max()) <= 2.5e-2


def test_prim_sharded_one_slab_is_the_single_render(rng):
    g, cam, _, ct, W, H, _ = _slab_scene(rng)
    tg, tcam = port_scene(g, cam)
    bg = torch.full((3,), 0.25)
    with torch.no_grad():
        img, inv, ovf = tprim.render_prim_sharded(tg, tcam, W, H, bg, ct,
                                                  n_slabs=1)
        single = tras.render(tg, tcam, W, H, bg, ct)
    assert int(ovf) == 0
    np.testing.assert_array_equal(t2n(img), t2n(single.image))
    np.testing.assert_array_equal(t2n(inv), t2n(single.invdepth))


@pytest.mark.parametrize("n_slabs", [1, 4])
def test_arriving_transmittance_skips_the_farthest_slab(rng, monkeypatch,
                                                        n_slabs):
    """Pass 1 runs ``slab_transmittance`` on every slab but the farthest
    (none for one slab) and still returns, bit for bit, the exclusive
    product over all the slabs' plain transmittances."""
    g, cam, _, ct, W, H, m_cap = _slab_scene(rng)
    tg, tcam = port_scene(g, cam)
    with torch.no_grad():
        slabs = tprim.build_slab_entries(
            tg, tcam, W, H, ct, n_slabs=n_slabs,
            m_cap=m_cap if n_slabs > 1 else None)
    assert all(int(e.binning.overflow) == 0 for e in slabs)
    calls = []
    launch = tprim.slab_transmittance

    def counted(entries, *args, **kw):
        calls.append(entries.data_ptr())
        return launch(entries, *args, **kw)

    monkeypatch.setattr(tprim, "slab_transmittance", counted)
    with torch.no_grad():
        got = tprim.arriving_transmittance(slabs, ct)
    assert calls == [e.entries.data_ptr() for e in slabs[:-1]]
    kw = dict(n_tiles_x=slabs[0].n_tiles_x, n_tiles_y=slabs[0].n_tiles_y,
              tile_h=ct.tile_h, tile_w=ct.tile_w, chunk=ct.chunk,
              alpha_min=ct.alpha_min, alpha_max=ct.alpha_max)
    t = torch.stack([slab_transmittance_plain(
        e.entries, e.binning.tile_start, e.binning.tile_count, **kw)
        for e in slabs])
    want = torch.cumprod(torch.cat([torch.ones_like(t[:1]), t[:-1]]), dim=0)
    assert got.dtype == want.dtype and torch.equal(got, want)
    assert bool((got[0] == 1.0).all())
    if n_slabs > 1:
        assert float(got[-1].min()) < 0.5       # nearer slabs do occlude


def test_prim_sharded_reports_overflow(rng):
    g, cam, cj, ct, W, H, _ = _slab_scene(rng)
    tg, tcam = port_scene(g, cam)
    _, _, ovf_j = _jax_prim(g, cam, jnp.zeros(3), W=W, H=H, cfg=cj, m_cap=64)
    with torch.no_grad():
        _, _, ovf_t = tprim.render_prim_sharded(
            tg, tcam, W, H, torch.zeros(3), ct, n_slabs=N_PARTS, m_cap=64)
    assert int(ovf_t) > 0 and int(ovf_t) == int(ovf_j)


def test_prim_sharded_gradient_matches_jax_and_single(rng):
    """Opacity 0.2 everywhere, so that no pixel saturates and the cut never
    fires: the merge itself must then be exact. The slabs' cotangents sum
    into the one packed table (a factor of n_slabs would show here)."""
    W, H = TW, 2 * TH
    g, cam = make_scene(rng, n=200)
    g = dataclasses.replace(g, opacity=jnp.full_like(
        g.opacity, float(jtf.inverse_sigmoid(jnp.asarray(0.2)))))
    tg, tcam = port_scene(g, cam)
    cj, ct = configs(TH, TW, CHUNK)

    def jloss(xyz):
        img, _, _ = jprim.render_prim_sharded(
            dataclasses.replace(g, xyz=xyz), cam, W, H, jnp.full(3, 0.25),
            cj, _mesh("prim"))
        return jnp.sum(img ** 2)

    want = np.asarray(jax.jit(jax.grad(jloss))(g.xyz))

    def tgrad(render):
        xyz = tg.xyz.clone().requires_grad_()
        img = render(dataclasses.replace(tg, xyz=xyz))
        (img ** 2).sum().backward()
        return t2n(xyz.grad)

    bg = torch.full((3,), 0.25)
    got = tgrad(lambda p: tprim.render_prim_sharded(
        p, tcam, W, H, bg, ct, n_slabs=N_PARTS)[0])
    single = tgrad(lambda p: tras.render(p, tcam, W, H, bg, ct).image)
    assert np.abs(single).max() > 1.0
    np.testing.assert_allclose(got, want, **SLAB_GRAD_TOL)
    np.testing.assert_allclose(got, single, **SLAB_GRAD_TOL)


def _band_scene(rng):
    # 7 tile rows and a ragged last one: 4 bands of 2 rows, the grid padded
    # to 8 rows and the image cropped back to H
    W, H = TW, 7 * TH - 3
    g, cam = make_scene(rng, n=300)
    return (g, cam) + configs(TH, TW, CHUNK) + (W, H)


def test_tile_sharded_matches_jax_and_single(rng):
    g, cam, cj, ct, W, H = _band_scene(rng)
    tg, tcam = port_scene(g, cam)
    bg = torch.full((3,), 0.3)
    img_j, inv_j, pairs_j, ovf_j = _jax_tile(g, cam, jnp.full(3, 0.3), W=W,
                                             H=H, cfg=cj)
    with torch.no_grad():
        img_t, inv_t, pairs_t, ovf_t = ttile.render_tile_sharded(
            tg, tcam, W, H, bg, ct, n_bands=N_PARTS)
        single = tras.render(tg, tcam, W, H, bg, ct)
    assert int(ovf_j) == 0 and int(ovf_t) == 0
    # the padded eighth tile row bins pairs the single render has no tile for
    assert int(pairs_t) == int(pairs_j) >= int(single.num_pairs)
    assert tuple(img_t.shape) == (3, H, W) and tuple(inv_t.shape) == (1, H, W)
    np.testing.assert_allclose(t2n(img_t), np.asarray(img_j), **IMG_TOL)
    np.testing.assert_allclose(t2n(inv_t), np.asarray(inv_j), **IMG_TOL)
    np.testing.assert_allclose(t2n(img_t), t2n(single.image), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(t2n(inv_t), t2n(single.invdepth), rtol=1e-5,
                               atol=1e-6)
    assert float(single.image.std()) > 0.01


def test_tile_sharded_gradient_matches_single(rng):
    g, cam, _, ct, W, H = _band_scene(rng)
    tg, tcam = port_scene(g, cam)
    bg = torch.full((3,), 0.3)
    fields = ("xyz", "f_dc", "scaling", "rotation", "opacity")

    def grads(render):
        params = {k: getattr(tg, k).clone().requires_grad_() for k in fields}
        img, inv = render(dataclasses.replace(tg, **params))
        ((img ** 2).sum() + 0.1 * inv.abs().sum()).backward()
        return {k: t2n(v.grad) for k, v in params.items()}

    got = grads(lambda p: ttile.render_tile_sharded(
        p, tcam, W, H, bg, ct, n_bands=N_PARTS)[:2])
    want = grads(lambda p: tras.render(p, tcam, W, H, bg, ct)[:2])
    assert np.abs(want["xyz"]).max() > 0
    for k in fields:
        np.testing.assert_allclose(got[k], want[k], err_msg=k, **GRAD_TOL)


def test_tile_sharded_reports_overflow(rng):
    g, cam, _, ct, W, H = _band_scene(rng)
    tg, tcam = port_scene(g, cam)
    with torch.no_grad():
        out = ttile.render_tile_sharded(tg, tcam, W, H, torch.zeros(3), ct,
                                        n_bands=N_PARTS, m_cap=64)
    assert int(out[3]) > 0
