"""Port parity of per-tile-row ellipse culling (the config's ``row_cull``;
gsplat_tpu_torch/ops/binning.py ``_slot_x_interval`` / ``_expand_units``)
against the JAX package's, on the same numpy-seeded inputs.

- Binning: ``bin_gaussians`` and ``expand_slab`` + ``merge_slab_binning``
  with conics equal JAX's exactly (tile tables, ``num_pairs``, the per-tile
  entry order, the presort tables), also on synthetic conics with wild
  anisotropy, off-screen centres and ragged tiles; a frame far over its
  capacity makes no tensor sized by its pair count.
- Exactness (tests/test_rasterize.py:403, :494, :634): per tile the culled
  set is a subset of the rectangle's, every dropped pair has
  q(pixel) > t_cut at every pixel of its tile (alpha below ``alpha_min``),
  ``row_slots=2`` runs the tail block, and the per-entry depth keys of the
  slab form come out depth-ascending per tile.
- Renders and steps with ``row_cull`` against JAX's culled ones: the
  single render (image rtol 2e-4 / atol 2e-5, gradients rtol 5e-3 / atol
  1e-6), one train step, the slab and band renders, and sharded storage
  per transient (render and step), at the gates of their unculled parity
  tests; each against the port's own unculled path within the JAX
  suite's culled-against-rect gates (atol 2e-4 images, rtol 5e-3 / atol
  1e-5 gradients). The scenes keep opacity below 0.99 (``make_scene``),
  where the alpha clamp's gradient does not differ (ROADMAP C, PR 2).
- A JAX ``cfg_args.json`` with ``row_cull`` on loads with it on.
"""
import dataclasses
import functools
import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec

from gsplat_tpu.config import OptimizationConfig as JaxOptimizationConfig
from gsplat_tpu.models import gaussian_model as jgm
from gsplat_tpu.ops import binning as jbin
from gsplat_tpu.ops import preprocess as jpre
from gsplat_tpu.ops import rasterize as jras
from gsplat_tpu.parallel import prim_shard as jprim
from gsplat_tpu.parallel import sharded as jsh
from gsplat_tpu.parallel import tile_shard as jtile
from gsplat_tpu.parallel.mesh import make_mesh
from gsplat_tpu.train import trainer as jtrainer
from gsplat_tpu_torch import config as tcfg
from gsplat_tpu_torch.config import OptimizationConfig
from gsplat_tpu_torch.ops import binning as tbin
from gsplat_tpu_torch.ops import rasterize as tras
from gsplat_tpu_torch.parallel import prim_shard as tprim
from gsplat_tpu_torch.parallel import sharded as tsh
from gsplat_tpu_torch.parallel import tile_shard as ttile
from gsplat_tpu_torch.train import trainer as ttrainer

from torch_parity import (SMALL, configs, make_scene, port_scene,
                          state_to_numpy, t2n)

TH, TW, CHUNK = SMALL[:3]
IMG_TOL = dict(rtol=2e-4, atol=2e-5)
GRAD_TOL = dict(rtol=5e-3, atol=1e-6)
CULL_IMG_ATOL = 2e-4                     # culled against rect, JAX's gate
CULL_GRAD_TOL = dict(rtol=5e-3, atol=1e-5)
N_PARTS = 4
TRANSIENTS = ("replicated", "ring", "slab")
GEOM = ("mean2d", "depth", "radius", "rx", "ry")


def _stretched(rng, n, cap=None):
    """tests/test_rasterize.py:403's scene: elongated, rotated splats, the
    worst case of rect binning."""
    g, cam = make_scene(rng, n=n, cap=cap)
    return dataclasses.replace(
        g, scaling=g.scaling.at[:, 1].add(-1.5).at[:, 0].add(0.7)), cam


@functools.partial(jax.jit, static_argnames=("W", "H"))
def _jax_pre(g, cam, *, W, H):
    return jpre.preprocess(
        g.xyz, g.get_scaling(), g.get_rotation(), g.get_opacity(),
        g.get_features(), g.active_sh_degree, cam, W, H,
        active_mask=g.active)


def _arrays(pre):
    return {k: np.asarray(getattr(pre, k))
            for k in GEOM + ("conic", "t_cut")}


def _synthetic(seed, n, W, H, lo=0.5, hi=30.0, margin=30.0, op_lo=1e-3):
    """tests/test_rasterize.py:494's synthetic conics: random PSD pixel
    covariances, opacities some below 1/255, centres off screen."""
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((n, 2, 2)) * rng.uniform(lo, hi, (n, 1, 1))
    cov = A @ np.transpose(A, (0, 2, 1)) + 0.3 * np.eye(2)
    cm = np.linalg.inv(cov).astype(np.float32)
    op = rng.uniform(op_lo, 1.0, n).astype(np.float32)
    t_cut = np.maximum(2.0 * np.log(op * 255.0), 0.0).astype(np.float32)
    mean2d = np.stack([rng.uniform(-margin, W + margin, n),
                       rng.uniform(-margin, H + margin, n)],
                      -1).astype(np.float32)
    rx = np.ceil(np.sqrt(t_cut * cov[:, 0, 0])).astype(np.float32)
    ry = np.ceil(np.sqrt(t_cut * cov[:, 1, 1])).astype(np.float32)
    return dict(mean2d=mean2d, depth=rng.uniform(0.5, 10.0, n).astype(
        np.float32), radius=np.maximum(rx, ry).astype(np.float32), rx=rx,
        ry=ry, conic=np.stack([cm[:, 0, 0], cm[:, 0, 1], cm[:, 1, 1]], -1),
        t_cut=t_cut)


def _bin_both(arrs, cull=True, **kw):
    """(JAX binning, port binning) of the same arrays, sorted gaussians."""
    ckw = dict(conic=arrs["conic"], t_cut=arrs["t_cut"]) if cull else {}
    bj = jbin.bin_gaussians(
        *(jnp.asarray(arrs[k]) for k in GEOM[:3]), rx=jnp.asarray(arrs["rx"]),
        ry=jnp.asarray(arrs["ry"]), sort_gaussians=True,
        **{k: jnp.asarray(v) for k, v in ckw.items()}, **kw)
    bt = tbin.bin_gaussians(
        *(torch.tensor(arrs[k]) for k in GEOM[:3]),
        rx=torch.tensor(arrs["rx"]), ry=torch.tensor(arrs["ry"]),
        presort_tables=True, **{k: torch.tensor(v) for k, v in ckw.items()},
        **kw)
    return bj, bt


def _assert_binning_equal(bj, bt, n):
    for k in ("num_pairs", "overflow", "num_padded"):
        assert int(getattr(bt, k)) == int(getattr(bj, k)), k
    for k in ("gidx_sorted", "tile_start", "tile_count", "inv_src",
              "g_offsets", "g_counts"):
        np.testing.assert_array_equal(getattr(bt, k).numpy(),
                                      np.asarray(getattr(bj, k)), err_msg=k)
    # the per-tile order in storage rows (dead gaussians' order is free)
    live = bt.g_counts.numpy() > 0
    np.testing.assert_array_equal(bt.perm.numpy()[live],
                                  np.asarray(bj.perm)[live])


def _tile_sets(b, n):
    """Per tile, the set of storage rows its range holds."""
    ts, tc = b.tile_start.numpy(), b.tile_count.numpy()
    rows = b.gidx_sorted.numpy()
    if b.perm is not None:
        rows = np.append(b.perm.numpy(), n)[rows]
    return [set(rows[s:s + c].tolist()) for s, c in zip(ts, tc)]


def _check_subset_and_exact(b0, b1, arrs, W, H, n):
    """Every tile's culled set lies in its rect set, and every dropped pair
    has q > t_cut at every pixel of the tile. Returns the dropped pairs."""
    ntx = -(-W // TW)
    sets0, sets1 = _tile_sets(b0, n), _tile_sets(b1, n)
    n_drop = 0
    for t, (s0, s1) in enumerate(zip(sets0, sets1)):
        assert s1 <= s0, f"tile {t}: culling ADDED pairs {s1 - s0}"
        ox, oy = (t % ntx) * TW, (t // ntx) * TH
        xs, ys = np.meshgrid(np.arange(ox, min(ox + TW, W)),
                             np.arange(oy, min(oy + TH, H)))
        for gg in s0 - s1:
            dx = xs - arrs["mean2d"][gg, 0]
            dy = ys - arrs["mean2d"][gg, 1]
            ca, cb, cc = arrs["conic"][gg]
            q = ca * dx * dx + 2 * cb * dx * dy + cc * dy * dy
            assert q.min() > arrs["t_cut"][gg], \
                f"tile {t} wrongly dropped visible gaussian {gg}"
            n_drop += 1
    return n_drop


# ------------------------------------------------------------ binning

@pytest.mark.parametrize("row_slots", [2, 4])
def test_culled_binning_matches_jax_exactly(rng, row_slots):
    W, H = 2 * TW, 4 * TH
    g, cam = _stretched(rng, 300, cap=320)
    arrs = _arrays(_jax_pre(g, cam, W=W, H=H))
    kw = dict(image_width=W, image_height=H, tile_h=TH, tile_w=TW,
              m_cap=48 * 320, align=CHUNK, row_slots=row_slots)
    bj, bt = _bin_both(arrs, **kw)
    assert int(bt.overflow) == 0 and int(bt.num_pairs) > 0
    _assert_binning_equal(bj, bt, 320)


def test_row_cull_exact_and_tighter(rng):
    """tests/test_rasterize.py:403: fewer pairs, a subset of the rect set
    with every drop below the alpha floor; ``row_slots=2`` forces the tail
    block on every splat taller than one tile row."""
    n = 300
    W, H = 2 * TW, 4 * TH
    g, cam = _stretched(rng, n)
    arrs = _arrays(_jax_pre(g, cam, W=W, H=H))
    kw = dict(image_width=W, image_height=H, tile_h=TH, tile_w=TW,
              m_cap=48 * n, align=CHUNK)
    _, b0 = _bin_both(arrs, cull=False, **kw)
    _, b1 = _bin_both(arrs, **kw)
    _, b2 = _bin_both(arrs, row_slots=2, **kw)
    assert int(b1.num_pairs) < int(b0.num_pairs)
    assert int(b1.num_pairs) <= int(b2.num_pairs) <= int(b0.num_pairs)
    assert _check_subset_and_exact(b0, b1, arrs, W, H, n) > 0
    _check_subset_and_exact(b0, b2, arrs, W, H, n)


@pytest.mark.parametrize("seed,row_slots", [(1, 2), (2, 3), (3, 4), (4, 6)])
def test_row_cull_fuzz_subset_property(seed, row_slots):
    """tests/test_rasterize.py:494 on synthetic conics, ragged right and
    bottom tiles; the port's culled binning also equals JAX's exactly."""
    n = 160
    W, H = 3 * TW - 40, 5 * TH - 3
    arrs = _synthetic(seed, n, W, H)
    kw = dict(image_width=W, image_height=H, tile_h=TH, tile_w=TW,
              m_cap=64 * n, align=CHUNK)
    _, b0 = _bin_both(arrs, cull=False, **kw)
    bj, b1 = _bin_both(arrs, row_slots=row_slots, **kw)
    assert int(b0.overflow) == 0 and int(b1.overflow) == 0
    _assert_binning_equal(bj, b1, n)
    assert _check_subset_and_exact(b0, b1, arrs, W, H, n) > 0


def _slabs(arrs, n_slabs, m_slab, kw, cull):
    """expand_slab of each row range in owner order and the merge, through
    JAX and through the port."""
    n = arrs["depth"].shape[0]
    rows = n // n_slabs
    sj, st = [], []
    for o in range(n_slabs):
        sl = slice(o * rows, (o + 1) * rows)
        common = dict(row_base=o * rows, slab_base_entry=o * m_slab,
                      sentinel_row=n, m_slab=m_slab, row_slots=4, **kw)
        extra = ("conic", "t_cut") if cull else ()
        sj.append(jbin.expand_slab(
            *(jnp.asarray(arrs[k][sl]) for k in GEOM), **common,
            **{k: jnp.asarray(arrs[k][sl]) for k in extra}))
        st.append(tbin.expand_slab(
            *(torch.tensor(arrs[k][sl]) for k in GEOM), **common,
            **{k: torch.tensor(arrs[k][sl]) for k in extra}))
    bj = jbin.merge_slab_binning(sj, sentinel_row=n, align=CHUNK, **kw)
    bt = tbin.merge_slab_binning(st, sentinel_row=n, align=CHUNK, **kw)
    return sj, st, bj, bt


def test_row_cull_per_entry_depth_keys():
    """tests/test_rasterize.py:634 in the port's form with per-entry depth
    keys (expand_slab + merge_slab_binning, 2 slabs): every tile's entries
    depth-ascending and a subset of the rect set, every slab and the merge
    equal to JAX's."""
    n = 120
    W, H = 2 * TW, 4 * TH
    arrs = _synthetic(11, n, W, H, lo=1.0, hi=20.0, margin=0.0, op_lo=0.01)
    kw = dict(image_width=W, image_height=H, tile_h=TH, tile_w=TW)
    sj, st, bj, b1 = _slabs(arrs, 2, 32 * n, kw, cull=True)
    for a, b in zip(sj, st):
        for k in ("tile", "dkey", "gidx", "counts", "offsets", "count_grid",
                  "total", "overflow"):
            np.testing.assert_array_equal(getattr(b, k).numpy(),
                                          np.asarray(getattr(a, k)),
                                          err_msg=k)
    for k in ("gidx_sorted", "tile_start", "tile_count", "num_pairs",
              "num_padded", "inv_src", "g_offsets", "g_counts"):
        np.testing.assert_array_equal(getattr(b1, k).numpy(),
                                      np.asarray(getattr(bj, k)), err_msg=k)
    _, _, _, b0 = _slabs(arrs, 2, 32 * n, kw, cull=False)
    assert int(b1.num_pairs) < int(b0.num_pairs)
    ts, tc, gs = b1.tile_start.numpy(), b1.tile_count.numpy(), \
        b1.gidx_sorted.numpy()
    for t in range(len(ts)):
        seg = gs[ts[t]:ts[t] + tc[t]]
        assert (np.diff(arrs["depth"][seg]) >= 0).all(), \
            f"tile {t} not depth-ordered"
    assert _check_subset_and_exact(b0, b1, arrs, W, H, n) > 0


@pytest.mark.parametrize("form", ["bin_gaussians", "expand_slab"])
def test_culled_overflow_frame_allocates_within_capacity(rng, form):
    """tests/test_torch_binning.py's frame of huge splats, culled: no
    operation makes a tensor longer than the pair capacity plus pad_cap,
    the difference array or the 4N slots, and the counts (and the slab's
    slots and histogram) equal JAX's."""
    from test_torch_binning import SLAB_FIELDS, _Longest, _huge_splats
    W, H, th, tw = 1920, 1088, 32, 32
    arrs = _huge_splats(rng, 200, W, H)
    n = arrs["depth"].shape[0]
    inv = (1.0 / arrs["rx"] ** 2).astype(np.float32)
    arrs.update(conic=np.stack([inv, np.zeros_like(inv), inv], -1),
                t_cut=np.ones(n, np.float32))      # the ellipse of radius rx
    kw = dict(image_width=W, image_height=H, tile_h=th, tile_w=tw)
    m_cap, pad_cap = 64, 4 * 16
    limit = max(m_cap + pad_cap, (W // tw + 1) * (H // th + 1), 4 * n)
    ts = {k: torch.tensor(v) for k, v in arrs.items()}
    ja = {k: jnp.asarray(v) for k, v in arrs.items()}
    cull = ("conic", "t_cut")
    with _Longest() as seen:
        if form == "bin_gaussians":
            bt = tbin.bin_gaussians(
                *(ts[k] for k in GEOM[:3]), rx=ts["rx"], ry=ts["ry"],
                m_cap=m_cap, align=16, pad_cap=pad_cap, presort_tables=True,
                **{k: ts[k] for k in cull}, **kw)
        else:
            bt = tbin.expand_slab(
                *(ts[k] for k in GEOM), row_base=0, slab_base_entry=0,
                sentinel_row=n, m_slab=m_cap, **{k: ts[k] for k in cull},
                **kw)
    assert int(bt.overflow) > 0
    assert seen.longest <= limit, (seen.longest, limit)
    if form == "bin_gaussians":
        bj = jbin.bin_gaussians(
            *(ja[k] for k in GEOM[:3]), rx=ja["rx"], ry=ja["ry"],
            m_cap=m_cap, align=16, pad_cap=pad_cap, sort_gaussians=True,
            **{k: ja[k] for k in cull}, **kw)
        for k in ("num_pairs", "overflow", "num_padded"):
            assert int(getattr(bt, k)) == int(getattr(bj, k)), k
    else:
        sj = jbin.expand_slab(
            *(ja[k] for k in GEOM), row_base=0, slab_base_entry=0,
            sentinel_row=n, m_slab=m_cap, **{k: ja[k] for k in cull}, **kw)
        for k in SLAB_FIELDS:
            np.testing.assert_array_equal(getattr(bt, k).numpy(),
                                          np.asarray(getattr(sj, k)),
                                          err_msg=k)


@pytest.mark.parametrize("row_slots", [2, 4])
def test_culled_band_window_is_the_frames_cull(rng, row_slots):
    """On a window of tile rows (``tile_row_base``) the slots' rows are the
    frame's: a window of one tile row keeps, per tile, a subset of the
    frame's culled pairs with every drop below the alpha floor; where every
    row of the frame is a slot of its own (4 slots on 4 tile rows) exactly
    the frame's."""
    n = 300
    W, H = 2 * TW, 4 * TH
    g, cam = _stretched(rng, n)
    arrs = _arrays(_jax_pre(g, cam, W=W, H=H))
    kw = dict(image_width=W, tile_h=TH, tile_w=TW, m_cap=48 * n,
              align=CHUNK, row_slots=row_slots)
    _, frame = _bin_both(arrs, image_height=H, **kw)
    sets = _tile_sets(frame, n)
    ntx = -(-W // TW)
    t = {k: torch.tensor(v) for k, v in arrs.items()}
    n_drop = 0
    for row in range(H // TH):
        b = tbin.bin_gaussians(
            t["mean2d"], t["depth"], t["radius"], rx=t["rx"], ry=t["ry"],
            conic=t["conic"], t_cut=t["t_cut"], image_height=TH,
            tile_row_base=row, **kw)
        for i, got in enumerate(_tile_sets(b, n)):
            want = sets[row * ntx + i]
            assert got <= want
            if row_slots == 4:
                assert got == want
            ox, oy = i * TW, row * TH
            xs, ys = np.meshgrid(np.arange(ox, ox + TW),
                                 np.arange(oy, oy + TH))
            for gg in want - got:
                dx = xs - arrs["mean2d"][gg, 0]
                dy = ys - arrs["mean2d"][gg, 1]
                ca, cb, cc = arrs["conic"][gg]
                q = ca * dx * dx + 2 * cb * dx * dy + cc * dy * dy
                assert q.min() > arrs["t_cut"][gg]
                n_drop += 1
    if row_slots == 2:          # the frame's tail blocks span rows
        assert n_drop > 0


# ------------------------------------------------------------ renders

@functools.partial(jax.jit, static_argnames=("W", "H", "cfg"))
def _jax_render(g, cam, bg, *, W, H, cfg):
    return jras.render(g, cam, W, H, bg, cfg, clamp=False)


def test_culled_render_and_gradients_match_jax(rng):
    W, H = 2 * TW, 4 * TH
    g, cam = _stretched(rng, 200)
    tg, tcam = port_scene(g, cam)
    cj, ct = configs(TH, TW, CHUNK, row_cull=True)
    _, ct0 = configs(TH, TW, CHUNK)
    bg = torch.full((3,), 0.25)
    oj = _jax_render(g, cam, jnp.full(3, 0.25), W=W, H=H, cfg=cj)
    with torch.no_grad():
        ot = tras.render(tg, tcam, W, H, bg, ct, clamp=False)
        o0 = tras.render(tg, tcam, W, H, bg, ct0, clamp=False)
    assert int(ot.overflow) == 0 and int(ot.num_pairs) == int(oj.num_pairs)
    assert int(ot.num_pairs) < int(o0.num_pairs)
    np.testing.assert_allclose(t2n(ot.image), np.asarray(oj.image),
                               **IMG_TOL)
    np.testing.assert_allclose(t2n(ot.invdepth), np.asarray(oj.invdepth),
                               **IMG_TOL)
    np.testing.assert_allclose(t2n(ot.image), t2n(o0.image), rtol=0,
                               atol=CULL_IMG_ATOL)
    assert float(ot.image.std()) > 0.01

    target = np.linspace(0, 1, 3 * H * W, dtype=np.float32).reshape(3, H, W)
    fields = ("xyz", "f_dc", "scaling", "rotation", "opacity")

    def jloss(trains):
        out = jras.render(jgm.with_trainables(g, trains), cam, W, H,
                          jnp.full(3, 0.25), cj, clamp=False)
        return jnp.abs(out.image - target).mean()

    gj = jax.jit(jax.grad(jloss))(jgm.trainables(g))

    def grads(cfg):
        params = {k: getattr(tg, k).clone().requires_grad_() for k in fields}
        out = tras.render(dataclasses.replace(tg, **params), tcam, W, H, bg,
                          cfg, clamp=False)
        (out.image - torch.tensor(target)).abs().mean().backward()
        return {k: t2n(v.grad) for k, v in params.items()}
    gt, g0 = grads(ct), grads(ct0)
    for k in fields:
        np.testing.assert_allclose(gt[k], np.asarray(gj[k]), err_msg=k,
                                   **GRAD_TOL)
        np.testing.assert_allclose(gt[k], g0[k], err_msg=k, **CULL_GRAD_TOL)


def _step_inputs():
    rng = np.random.default_rng(0)
    W, H = TW, 8 * TH
    g, cam = make_scene(rng, n=100, cap=128)
    gt = rng.uniform(0, 1, (3, H, W)).astype(np.float32)
    imgs = (gt, np.ones((1, H, W), np.float32),
            np.zeros((1, H, W), np.float32), np.zeros((1, H, W), np.float32),
            np.zeros(3, np.float32))
    return g, cam, W, H, imgs


STEP_KW = dict(antialiasing=False, use_sparse_adam=False,
               train_test_exp=False, use_depth=False, spatial_lr_scale=1.0)


def _assert_step_close(t1, aux, s1, loss_j):
    np.testing.assert_allclose(float(aux.loss), loss_j, rtol=1e-6)
    np.testing.assert_allclose(t2n(t1.gaussians.xyz),
                               np.asarray(s1.gaussians.xyz), rtol=1e-3,
                               atol=5e-4)
    np.testing.assert_array_equal(t2n(t1.stats.denom),
                                  np.asarray(s1.stats.denom))
    np.testing.assert_allclose(t2n(t1.stats.xyz_gradient_accum),
                               np.asarray(s1.stats.xyz_gradient_accum),
                               rtol=1e-4, atol=1e-8)
    for k in ("xyz", "opacity", "scaling"):
        np.testing.assert_allclose(t2n(t1.adam.mu[k]),
                                   np.asarray(s1.adam.mu[k]), rtol=5e-3,
                                   atol=1e-7, err_msg=k)


def test_culled_train_step_matches_jax():
    g, cam, W, H, imgs = _step_inputs()
    cj, ct = configs(TH, TW, CHUNK, row_cull=True)
    s0 = jtrainer.init_state(g, 1)
    s1, aux_j = jtrainer.train_step(
        s0, cam, *map(jnp.asarray, imgs), rcfg=cj, opt=JaxOptimizationConfig(),
        image_width=W, image_height=H, **STEP_KW)
    _, tcam = port_scene(g, cam)
    t1, aux = ttrainer.train_step(
        ttrainer.state_from_numpy(state_to_numpy(s0), device="cpu"), tcam,
        *map(torch.tensor, imgs), rcfg=ct, opt=OptimizationConfig(),
        image_width=W, image_height=H, **STEP_KW)
    assert int(aux.num_pairs) == int(aux_j.num_pairs)
    _assert_step_close(t1, aux, s1, float(aux_j.loss))


def _mesh(axis):
    return make_mesh(((axis, N_PARTS),), devices=jax.devices()[:N_PARTS])


def test_culled_slab_and_band_renders_match_jax(rng):
    W, H = TW, 8 * TH
    g, cam = _stretched(rng, 400)
    tg, tcam = port_scene(g, cam)
    cj, ct = configs(TH, TW, CHUNK, row_cull=True)
    bg = torch.full((3,), 0.25)
    m_cap = int(400 * 24 / 2)
    img_j, inv_j, _ = jax.jit(lambda g_, c_: jprim.render_prim_sharded(
        g_, c_, W, H, jnp.full(3, 0.25), cj, _mesh("prim"),
        m_cap=m_cap))(g, cam)
    bimg_j, binv_j, bpairs_j, _ = jax.jit(
        lambda g_, c_: jtile.render_tile_sharded(
            g_, c_, W, H, jnp.full(3, 0.25), cj, _mesh("tile")))(g, cam)
    with torch.no_grad():
        img, inv, ovf = tprim.render_prim_sharded(
            tg, tcam, W, H, bg, ct, n_slabs=N_PARTS, m_cap=m_cap)
        bimg, binv, bpairs, bovf = ttile.render_tile_sharded(
            tg, tcam, W, H, bg, ct, n_bands=N_PARTS)
        single = tras.render(tg, tcam, W, H, bg, ct)
    assert int(ovf) == 0 and int(bovf) == 0
    assert int(bpairs) == int(bpairs_j)
    for got, want in ((img, img_j), (inv, inv_j), (bimg, bimg_j),
                      (binv, binv_j)):
        np.testing.assert_allclose(t2n(got), np.asarray(want), **IMG_TOL)
    np.testing.assert_allclose(t2n(img), t2n(single.image), rtol=0,
                               atol=1e-3)
    # bands are the single culled render's rows
    np.testing.assert_allclose(t2n(bimg), t2n(single.image), rtol=1e-5,
                               atol=1e-6)
    assert float(single.image.std()) > 0.01


def _sharded(g):
    mesh = _mesh("prim")
    return mesh, jax.tree_util.tree_map(
        lambda x: jax.device_put(x, NamedSharding(
            mesh, PartitionSpec("prim") if hasattr(x, "shape") and x.ndim >= 1
            and x.shape[0] == g.capacity else PartitionSpec())), g)


@pytest.mark.parametrize("transient", TRANSIENTS)
def test_culled_sharded_render_and_step_match_jax(transient):
    rng = np.random.default_rng(0)
    W, H = TW, 8 * TH
    g, cam = _stretched(rng, 300, cap=320)
    tg, tcam = port_scene(g, cam)
    cj, ct = configs(TH, TW, CHUNK, row_cull=True)
    mesh, g_sh = _sharded(g)
    want = jax.jit(jsh.make_sharded_render(
        mesh, image_width=W, image_height=H, cfg=cj,
        transient=transient))(g_sh, cam, jnp.full(3, 0.3))
    bg = torch.full((3,), 0.3)
    with torch.no_grad():
        out = tsh.make_sharded_render(N_PARTS, image_width=W, image_height=H,
                                      cfg=ct, transient=transient)(tg, tcam,
                                                                   bg)
        single = tras.render(tg, tcam, W, H, bg, ct)
    assert int(out.overflow) == 0
    assert int(out.num_pairs) == int(want.num_pairs)
    np.testing.assert_allclose(t2n(out.image), np.asarray(want.image),
                               **IMG_TOL)
    np.testing.assert_allclose(t2n(out.image), t2n(single.image), rtol=1e-6,
                               atol=1e-7)

    g, cam, W, H, imgs = _step_inputs()
    mesh = _mesh("prim")
    s0 = jtrainer.init_state(g, 1)
    s1, aux_j = jsh.make_sharded_train_step(
        mesh, image_width=W, image_height=H, opt=JaxOptimizationConfig(),
        rcfg=cj, spatial_lr_scale=1.0, transient=transient)(
        jsh.shard_state(s0, mesh), cam, *map(jnp.asarray, imgs[:4]),
        jnp.zeros(3))
    _, tcam = port_scene(g, cam)
    t1, aux = tsh.make_sharded_train_step(
        N_PARTS, image_width=W, image_height=H, opt=OptimizationConfig(),
        rcfg=ct, spatial_lr_scale=1.0, transient=transient)(
        ttrainer.state_from_numpy(state_to_numpy(s0), device="cpu"), tcam,
        *map(torch.tensor, imgs[:4]), torch.zeros(3))
    assert int(aux.overflow) == 0
    assert int(aux.num_pairs) == int(aux_j.num_pairs)
    _assert_step_close(t1, aux, s1, float(aux_j.loss))


def test_jax_cfg_args_with_row_cull_loads_with_it_on(tmp_path):
    from gsplat_tpu.config import RasterizerConfig as JaxRasterizerConfig
    from gsplat_tpu.config import save_cfg as jax_save_cfg
    jax_save_cfg(str(tmp_path), {"rasterizer": JaxRasterizerConfig(
        row_cull=True, row_slots=3)})
    with open(tmp_path / "cfg_args.json") as f:
        assert json.load(f)["rasterizer"]["row_cull"] is True
    r = tcfg.load_cfg(str(tmp_path))["rasterizer"]
    assert r.row_cull is True and r.row_slots == 3
    assert tcfg.RasterizerConfig().row_cull is False
    with pytest.raises(ValueError, match="row_slots"):
        tcfg.RasterizerConfig(row_slots=0)
