"""Port parity of gaussian-sharded storage: render and one train step for
the three transients (replicated, ring, slab). The same state, made with
numpy and carried across with ``from_numpy`` / ``state_from_numpy``, goes
through the JAX package's ``make_sharded_render`` /
``make_sharded_train_step`` on a mesh of 4 of the 8 virtual CPU devices
(its XLA oracle route) and through the port's, which run the 4 shards one
after another on the CPU (plain compositor, plain blocked scan).

Gates, the JAX suite's for these paths (tests/test_parallel.py:225-313):
against the port's own single render the image within rtol 1e-6 / atol 1e-7
and equal radii (tiles are independent, so a band is the single render's
rows); against JAX's sharded render the same gate; one train step gives
JAX's loss (rtol 1e-6), xyz (rtol 1e-3 / atol 5e-4: Adam's first step moves
a parameter by ±lr, so a gradient within rounding of 0 may flip it), denom
(equal) and xyz_gradient_accum (rtol 1e-4 / atol 1e-8). The ring gather's
gradient is held to ``index_select``'s at the gradient gate rtol 5e-3 /
atol 1e-6."""
import dataclasses
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec

from gsplat_tpu.config import OptimizationConfig as JaxOptimizationConfig
from gsplat_tpu.parallel import sharded as jsh
from gsplat_tpu.parallel.mesh import make_mesh
from gsplat_tpu.train import trainer as jtrainer
from gsplat_tpu_torch import parallel as tpar
from gsplat_tpu_torch.config import OptimizationConfig
from gsplat_tpu_torch.models import gaussian_model as tgm
from gsplat_tpu_torch.ops import rasterize as tras
from gsplat_tpu_torch.parallel import sharded as tsh
from gsplat_tpu_torch.train import trainer as ttrainer

from torch_parity import (SMALL, configs, make_scene, port_scene,
                          state_to_numpy, t2n)

N_SHARDS = 4
TH, TW, CHUNK = SMALL[:3]
W, H = TW, 8 * TH                       # 8 tile rows, 2 per shard
TRANSIENTS = ["replicated", "ring", "slab"]
IMG_TOL = dict(rtol=1e-6, atol=1e-7)
GRAD_TOL = dict(rtol=5e-3, atol=1e-6)


def _mesh():
    return make_mesh((("prim", N_SHARDS),), devices=jax.devices()[:N_SHARDS])


def _scene(n, cap):
    """The scenes of tests/test_parallel.py:234-235,272-273, from seed 0."""
    return make_scene(np.random.default_rng(0), n=n, cap=cap)


@functools.lru_cache(maxsize=None)
def _jax_render(transient, m_cap_total=None):
    """One JAX sharded render per transient, shared by the tests."""
    g, cam = _scene(300, 320)
    mesh = _mesh()
    g_sh = jax.tree_util.tree_map(
        lambda x: jax.device_put(x, NamedSharding(
            mesh, PartitionSpec("prim") if hasattr(x, "shape") and x.ndim >= 1
            and x.shape[0] == 320 else PartitionSpec())), g)
    fn = jsh.make_sharded_render(mesh, image_width=W, image_height=H,
                                 cfg=configs(TH, TW, CHUNK)[0],
                                 transient=transient,
                                 m_cap_total=m_cap_total)
    out = jax.jit(fn)(g_sh, cam, jnp.full(3, 0.3))
    return jax.tree_util.tree_map(np.asarray, out)


@pytest.mark.parametrize("transient", TRANSIENTS)
def test_sharded_render_matches_jax_and_single(transient):
    g, cam = _scene(300, 320)
    tg, tcam = port_scene(g, cam)
    ct = configs(TH, TW, CHUNK)[1]
    bg = torch.full((3,), 0.3)
    want = _jax_render(transient)
    fn = tsh.make_sharded_render(N_SHARDS, image_width=W, image_height=H,
                                 cfg=ct, transient=transient)
    with torch.no_grad():
        out = fn(tg, tcam, bg)
        single = tras.render(tg, tcam, W, H, bg, ct)
    assert int(want.overflow) == 0 and int(out.overflow) == 0
    assert int(out.num_pairs) == int(want.num_pairs) > 0
    assert tuple(out.image.shape) == (3, H, W)
    assert tuple(out.invdepth.shape) == (1, H, W)
    assert tuple(out.radii.shape) == (320,)
    np.testing.assert_allclose(t2n(out.image), t2n(single.image), **IMG_TOL)
    np.testing.assert_allclose(t2n(out.invdepth), t2n(single.invdepth),
                               **IMG_TOL)
    np.testing.assert_array_equal(t2n(out.radii), t2n(single.radii))
    np.testing.assert_allclose(t2n(out.image), want.image, **IMG_TOL)
    np.testing.assert_allclose(t2n(out.invdepth), want.invdepth, **IMG_TOL)
    np.testing.assert_array_equal(t2n(out.radii), want.radii)
    assert float(single.image.std()) > 0.01          # not a blank frame


@pytest.mark.parametrize("transient", TRANSIENTS)
def test_equal_depths_in_different_shards_render_as_single(transient):
    """Four overlapping gaussians of different colours at ONE depth, one in
    each shard: every transient must composite them in the single render's
    order (storage order, by its stable depth sort). The slab transient
    places each arriving slab at its owner's slot for this; by arrival
    order the bands would each order the tie their own way."""
    g, cam = _scene(300, 320)
    xyz = np.array(g.xyz)
    f_dc = np.array(g.f_dc)
    scaling, opacity = np.array(g.scaling), np.array(g.opacity)
    for i, row in enumerate((0, 80, 160, 240)):
        # one z, nearer than the rest of the scene: one depth, in view
        xyz[row] = [0.005 * i, 0.06 * (i - 1.5), 1.5]
        f_dc[row] = np.eye(3)[i % 3] * 2.0
        scaling[row], opacity[row] = np.log(0.06), 2.0
    g = dataclasses.replace(g, xyz=jnp.asarray(xyz), f_dc=jnp.asarray(f_dc),
                            scaling=jnp.asarray(scaling),
                            opacity=jnp.asarray(opacity))
    tg, tcam = port_scene(g, cam)
    ct = configs(TH, TW, CHUNK)[1]
    bg = torch.full((3,), 0.3)
    fn = tsh.make_sharded_render(N_SHARDS, image_width=W, image_height=H,
                                 cfg=ct, transient=transient)
    with torch.no_grad():
        out = fn(tg, tcam, bg)
        single = tras.render(tg, tcam, W, H, bg, ct)
        # the tie is real and visible: reversing the rows' order moves pixels
        rev = tras.render(tgm.from_numpy(
            {k: t2n(getattr(tg, k))[::-1].copy() for k in tgm.TENSOR_FIELDS}
            | {"active_sh_degree": tg.active_sh_degree}, device="cpu"),
            tcam, W, H, bg, ct)
    assert int(out.overflow) == 0
    assert float((rev.image - single.image).abs().max()) > 1e-3
    np.testing.assert_allclose(t2n(out.image), t2n(single.image), **IMG_TOL)
    np.testing.assert_allclose(t2n(out.invdepth), t2n(single.invdepth),
                               **IMG_TOL)


@pytest.mark.parametrize("transient", ["ring", "slab"])
def test_sharded_render_reports_overflow(transient):
    """A frame capacity below the pairs: the largest shard's dropped count,
    as JAX reports it."""
    g, cam = _scene(300, 320)
    tg, tcam = port_scene(g, cam)
    fn = tsh.make_sharded_render(N_SHARDS, image_width=W, image_height=H,
                                 cfg=configs(TH, TW, CHUNK)[1],
                                 transient=transient, m_cap_total=256)
    with torch.no_grad():
        out = fn(tg, tcam, torch.zeros(3))
    want = _jax_render(transient, 256)
    assert int(out.overflow) == int(want.overflow) > 0
    assert int(out.num_pairs) == int(want.num_pairs)


STEP_KW = dict(image_width=W, image_height=H, spatial_lr_scale=1.0)


def _step_inputs():
    rng = np.random.default_rng(0)
    g, cam = make_scene(rng, n=100, cap=128)
    gt = rng.uniform(0, 1, (3, H, W)).astype(np.float32)
    imgs = (gt, np.ones((1, H, W), np.float32),
            np.zeros((1, H, W), np.float32), np.zeros((1, H, W), np.float32),
            np.zeros(3, np.float32))
    return g, cam, imgs


@functools.lru_cache(maxsize=None)
def _jax_step(transient):
    """One JAX sharded step per transient from the initial state."""
    g, cam, imgs = _step_inputs()
    mesh = _mesh()
    s0 = jsh.shard_state(jtrainer.init_state(g, 1), mesh)
    step = jsh.make_sharded_train_step(
        mesh, opt=JaxOptimizationConfig(), rcfg=configs(TH, TW, CHUNK)[0],
        transient=transient, **STEP_KW)
    s1, aux = step(s0, cam, *map(jnp.asarray, imgs))
    return (float(aux.loss), int(aux.num_pairs), int(aux.overflow),
            np.asarray(s1.gaussians.xyz), np.asarray(s1.stats.denom),
            np.asarray(s1.stats.xyz_gradient_accum),
            np.asarray(s1.stats.max_radii2d))


@functools.lru_cache(maxsize=None)
def _port_single_step():
    g, cam, imgs = _step_inputs()
    t0 = ttrainer.state_from_numpy(
        state_to_numpy(jtrainer.init_state(g, 1)), device="cpu")
    _, tcam = port_scene(g, cam)
    return ttrainer.train_step(
        t0, tcam, *map(torch.tensor, imgs), opt=OptimizationConfig(),
        rcfg=configs(TH, TW, CHUNK)[1], antialiasing=False,
        use_sparse_adam=False, train_test_exp=False, use_depth=False,
        **STEP_KW)


@pytest.mark.parametrize("transient", TRANSIENTS)
def test_sharded_train_step_matches_jax_and_single(transient):
    g, cam, imgs = _step_inputs()
    loss_j, pairs_j, ovf_j, xyz_j, denom_j, accum_j, radii_j = \
        _jax_step(transient)
    t0 = tsh.shard_state(ttrainer.state_from_numpy(
        state_to_numpy(jtrainer.init_state(g, 1)), device="cpu"), N_SHARDS)
    _, tcam = port_scene(g, cam)
    step = tsh.make_sharded_train_step(
        N_SHARDS, opt=OptimizationConfig(), rcfg=configs(TH, TW, CHUNK)[1],
        transient=transient, **STEP_KW)
    t1, aux = step(t0, tcam, *map(torch.tensor, imgs))
    single, aux_1 = _port_single_step()

    assert ovf_j == 0 and int(aux.overflow) == 0
    assert int(aux.num_pairs) == pairs_j > 0
    assert t1.step == 1 and t1.adam.count == 1
    assert tuple(t1.adam.mu["xyz"].shape) == (128, 3)
    for loss_want in (loss_j, float(aux_1.loss)):
        np.testing.assert_allclose(float(aux.loss), loss_want, rtol=1e-6)
    for xyz, denom, accum in ((xyz_j, denom_j, accum_j),
                              (t2n(single.gaussians.xyz),
                               t2n(single.stats.denom),
                               t2n(single.stats.xyz_gradient_accum))):
        np.testing.assert_allclose(t2n(t1.gaussians.xyz), xyz, rtol=1e-3,
                                   atol=5e-4)
        np.testing.assert_array_equal(t2n(t1.stats.denom), denom)
        np.testing.assert_allclose(t2n(t1.stats.xyz_gradient_accum), accum,
                                   rtol=1e-4, atol=1e-8)
    np.testing.assert_array_equal(t2n(t1.stats.max_radii2d), radii_j)
    assert float(t1.stats.denom.sum()) > 0
    assert float((t1.gaussians.xyz - t0.gaussians.xyz).abs().max()) > 0


@pytest.mark.parametrize("transient", ["ring", "slab"])
def test_ring_gradients_match_replicated_and_single(transient):
    """The prefix-difference backward against the gradients autograd takes
    through ``index_select`` (the replicated transient and the single
    render), for every trainable field."""
    g, cam = _scene(300, 320)
    tg, tcam = port_scene(g, cam)
    ct = configs(TH, TW, CHUNK)[1]
    bg = torch.full((3,), 0.3)

    def grads(render):
        params = {k: getattr(tg, k).clone().requires_grad_()
                  for k in tgm.TRAINABLE_FIELDS}
        out = render(tgm.with_trainables(tg, params))
        (out.image.mean() + 0.1 * out.invdepth.mean()).backward()
        return {k: t2n(v.grad) for k, v in params.items()}

    def sharded(tr):
        fn = tsh.make_sharded_render(N_SHARDS, image_width=W, image_height=H,
                                     cfg=ct, transient=tr)
        return grads(lambda p: fn(p, tcam, bg))

    got = sharded(transient)
    replicated = sharded("replicated")
    single = grads(lambda p: tras.render(p, tcam, W, H, bg, ct))
    assert np.abs(single["xyz"]).max() > 0
    for k in tgm.TRAINABLE_FIELDS:
        np.testing.assert_allclose(got[k], replicated[k], err_msg=k,
                                   **GRAD_TOL)
        np.testing.assert_allclose(got[k], single[k], err_msg=k, **GRAD_TOL)


def test_ring_gather_function_gradient_matches_index_select(rng):
    """``_RingGatherEntries`` by itself on a real binning: the forward is
    ``packed[idx]`` exactly, and its backward under a random cotangent is
    ``index_select``'s gradient (``index_add_``) split by owner."""
    from gsplat_tpu_torch.ops import binning as tbin
    from gsplat_tpu_torch.ops import preprocess as tpre
    g, cam = _scene(300, 320)
    tg, tcam = port_scene(g, cam)
    ct = configs(TH, TW, CHUNK)[1]
    with torch.no_grad():
        pre = tpre.preprocess(
            tg.xyz, tg.get_scaling(), tg.get_rotation(), tg.get_opacity(),
            tg.get_features(), tg.active_sh_degree, tcam, W, H,
            active_mask=tg.active)
    m_cap = 320 * 24
    b = tbin.bin_gaussians(pre.mean2d, pre.depth, pre.radius, rx=pre.rx,
                           ry=pre.ry, image_width=W, image_height=H,
                           tile_h=TH, tile_w=TW, m_cap=m_cap, align=CHUNK,
                           presort_tables=True)
    perm_ext = torch.cat([b.perm, b.perm.new_full((1,), 320)])
    idx = perm_ext[b.gidx_sorted]
    rank_inv = torch.empty_like(b.perm)
    rank_inv[b.perm] = torch.arange(320)
    packed = torch.tensor(rng.standard_normal((320, 16)).astype(np.float32))
    cot = torch.tensor(rng.standard_normal(
        (idx.shape[0], 16)).astype(np.float32))
    # rows of the layout's dead tail hold whatever the compositor's backward
    # left there: the mask must keep it out
    cot[int(b.num_padded):] = float("nan")

    slabs = [s.clone().requires_grad_()
             for s in tsh.shard_rows(packed, N_SHARDS)]
    ent = tsh._RingGatherEntries.apply(idx, b.inv_src, b.g_offsets,
                                       b.g_counts, rank_inv, 1, m_cap, *slabs)
    ref_in = torch.cat([packed, packed.new_zeros((1, 16))]).requires_grad_()
    ref = ref_in.index_select(0, idx)
    np.testing.assert_array_equal(t2n(ent), t2n(ref))
    live = torch.nan_to_num(cot, nan=0.0)
    ent.backward(cot)
    ref.backward(live)
    got = torch.cat([s.grad for s in slabs])
    assert bool(torch.isfinite(got).all())
    np.testing.assert_allclose(t2n(got), t2n(ref_in.grad[:320]), rtol=1e-4,
                               atol=1e-4)
    assert float(got.abs().max()) > 1.0


def test_ring_helpers_follow_the_ring():
    parts = [torch.full((2,), float(k)) for k in range(4)]
    # after s steps shard k holds the slab of owner (k - s) mod D
    assert [int(tpar.ring_arrival(parts, 1, s)[0]) for s in range(4)] == \
        [1, 0, 3, 2]
    asked = []

    def partial_for(owner):
        asked.append(owner)
        return torch.full((2,), float(owner))

    out = tpar.reduce_scatter_parts(partial_for, 1, 4)
    assert asked == [2, 3, 0, 1]           # the reverse ring ends at itself
    assert [int(p[0]) for p in out] == [0, 1, 2, 3]     # in owner order


def test_sharded_rejects_what_it_cannot_split(rng):
    g, cam = make_scene(rng, n=30, cap=30)
    tg, tcam = port_scene(g, cam)
    ct = configs(TH, TW, CHUNK)[1]
    with pytest.raises(ValueError, match="not divisible"):
        tsh.shard_state(ttrainer.init_state(tg, 1), N_SHARDS)
    fn = tsh.make_sharded_render(N_SHARDS, image_width=W, image_height=H,
                                 cfg=ct)
    with pytest.raises(ValueError, match="not divisible"):
        fn(tg, tcam, torch.zeros(3))
    fn = tsh.make_sharded_render(3, image_width=W, image_height=H, cfg=ct,
                                 transient="ringed")
    with pytest.raises(ValueError, match="transient must be one of"):
        fn(tg, tcam, torch.zeros(3))
    assert [tuple(s.shape) for s in tsh.shard_rows(tg.xyz, 3)] == [(10, 3)] * 3
