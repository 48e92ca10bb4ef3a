"""Port parity of the tile compositor. On identical entries the plain
PyTorch version is held to the JAX XLA oracle (composite_tiles_xla) and to
the JAX stream kernel in interpret mode; on the card the CUDA kernel is
held to the plain version (tests/test_torch_cuda.py). accum and t_final
within rtol 2e-4 / atol 2e-5 (the JAX suite's image gate); n_contrib
equal on ≥ 99.9% of pixels — a pixel whose transmittance lands within
rounding of the cut can stop one entry earlier or later where the
products are associated differently (the stream kernel's prefix scan).

With ``t_init`` (the transmittance arriving from nearer depth slabs) and
with ``tile_id_base`` (tile bands) the plain version is held to the XLA
oracle and to the chunk-grid Pallas kernel (composite.py, interpret mode)
at the JAX suite's gate for that pair, rtol 1e-5 / atol 1e-6 with n_contrib
equal; ``slab_transmittance_plain`` to ``slab_transmittance_pallas`` and to
the port's own cut-free composite at the same gate."""
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from gsplat_tpu.ops import binning as jbin
from gsplat_tpu.ops import composite_ref as jref
from gsplat_tpu.ops import preprocess as jpre
from gsplat_tpu.ops import rasterize as jras
from gsplat_tpu.ops.pallas.composite import (composite_tiles_pallas,
                                             slab_transmittance_pallas)
from gsplat_tpu.ops.pallas.composite_stream import composite_tiles_stream
from gsplat_tpu_torch.config import RasterizerConfig
from gsplat_tpu_torch.ops.composite_ref import (composite_tiles_plain,
                                                slab_transmittance_plain)
from gsplat_tpu_torch.ops.kernels import composite as tcomp

from torch_parity import DEFAULT_TILES, SMALL, make_scene, t2n

IMG_TOL = dict(rtol=2e-4, atol=2e-5)
SLAB_TOL = dict(rtol=1e-5, atol=1e-6)     # tests/test_rasterize.py:333,399
# one column of 8x128 tiles, as the JAX suite's t_init test: 1x2 and 1x6
ONE_BY_TWO = (8, 128, 16, 128, 16)
ONE_BY_SIX = (8, 128, 16, 128, 48)
STRIP_CHUNKS = 4


@functools.partial(jax.jit, static_argnames=("shape", "m_cap"))
def _jax_entries(g, cam, *, shape, m_cap):
    th, tw, chunk, W, H = shape
    pre = jpre.preprocess(
        g.xyz, g.get_scaling(), g.get_rotation(), g.get_opacity(),
        g.get_features(), g.active_sh_degree, cam, W, H,
        active_mask=g.active)
    b = jbin.bin_gaussians(
        pre.mean2d, pre.depth, pre.radius, rx=pre.rx, ry=pre.ry,
        image_width=W, image_height=H, tile_h=th, tile_w=tw, m_cap=m_cap,
        align=chunk, sort_gaussians=True)
    perm_ext = jnp.concatenate([b.perm, jnp.full((1,), g.capacity,
                                                 jnp.int32)])
    entries = jras.pack_entries(pre)[perm_ext][b.gidx_sorted]
    return entries, b.tile_start, b.tile_count, b.overflow


def _frame(rng, shape, n=400):
    """Entries and tile tables of one JAX frame, as numpy."""
    th, tw, chunk, W, H = shape
    g, cam = make_scene(rng, n=n)
    entries, ts, tc, overflow = _jax_entries(
        g, cam, shape=shape, m_cap=-(-n * 24 // chunk) * chunk)
    assert int(overflow) == 0
    geo = dict(n_tiles_x=-(-W // tw), n_tiles_y=-(-H // th), tile_h=th,
               tile_w=tw, chunk=chunk)
    return np.asarray(entries), np.asarray(ts), np.asarray(tc), geo


def _consts():
    c = RasterizerConfig()
    return dict(alpha_min=c.alpha_min, alpha_max=c.alpha_max,
                t_eps=c.transmittance_eps)


def _assert_close(got, want):
    for k in ("accum", "t_final"):
        np.testing.assert_allclose(got[k], want[k], err_msg=k, **IMG_TOL)
    assert (got["n_contrib"] == want["n_contrib"]).mean() >= 0.999


def _np(out):
    return {k: t2n(getattr(out, k)) if isinstance(getattr(out, k),
                                                  torch.Tensor)
            else np.asarray(getattr(out, k))
            for k in ("accum", "t_final", "n_contrib")}


@pytest.mark.parametrize("shape", [SMALL, DEFAULT_TILES],
                         ids=["8x128", "32x32"])
def test_plain_matches_xla_oracle_and_stream_kernel(rng, shape):
    entries, ts, tc, geo = _frame(rng, shape)
    c = _consts()
    plain = _np(composite_tiles_plain(torch.tensor(entries), torch.tensor(ts),
                                      torch.tensor(tc), **geo, **c))
    assert (plain["n_contrib"] > 0).mean() > 0.2      # the frame has content
    assert (plain["t_final"] < 1e-3).any()           # and opaque pixels

    xla = _np(jref.composite_tiles_xla(
        jnp.asarray(entries), jnp.asarray(ts), jnp.asarray(tc), **geo, **c))
    _assert_close(plain, xla)

    # the stream kernel takes whole strips of chunk·STRIP_CHUNKS rows
    rows = geo["chunk"] * STRIP_CHUNKS
    padded = np.zeros((-(-entries.shape[0] // rows) * rows, 16), np.float32)
    padded[:entries.shape[0]] = entries
    stream = _np(composite_tiles_stream(
        jnp.asarray(padded), jnp.asarray(ts), jnp.asarray(tc),
        strip_chunks=STRIP_CHUNKS, interpret=True, **geo, **c))
    _assert_close(plain, stream)


def test_plain_is_differentiable(rng):
    entries, ts, tc, geo = _frame(rng, SMALL, n=100)
    e = torch.tensor(entries, requires_grad=True)
    out = composite_tiles_plain(e, torch.tensor(ts), torch.tensor(tc), **geo,
                                **_consts())
    (out.accum.sum() + out.t_final.sum()).backward()
    assert torch.isfinite(e.grad).all() and e.grad.abs().max() > 0


def test_dispatch_routes_by_device_without_fallback(rng):
    entries, ts, tc, geo = _frame(rng, SMALL, n=60)
    args = (torch.tensor(entries), torch.tensor(ts), torch.tensor(tc))
    c = _consts()
    got = tcomp.composite_tiles(*args, **geo, **c)
    want = composite_tiles_plain(*args, **geo, **c)
    np.testing.assert_array_equal(t2n(got.accum), t2n(want.accum))
    with pytest.raises(ValueError):
        tcomp.composite_tiles(*(a.to("meta") for a in args), **geo, **c)
    with pytest.raises(ValueError):
        tcomp.composite_fwd_cuda(*args, **geo, **c)   # CPU tensors: refused


def test_plain_t_init_matches_xla_oracle_and_pallas_kernel(rng):
    """A near-saturating arriving transmittance makes the cut fire early;
    all three apply it to the early-out test alike."""
    entries, ts, tc, geo = _frame(rng, ONE_BY_TWO, n=200)
    c = _consts()
    T, P = 2, geo["tile_h"] * geo["tile_w"]
    t_init = rng.uniform(1e-5, 0.3, (T, P)).astype(np.float32)
    targs = (torch.tensor(entries), torch.tensor(ts), torch.tensor(tc))
    jargs = (jnp.asarray(entries), jnp.asarray(ts), jnp.asarray(tc))
    plain = _np(composite_tiles_plain(*targs, **geo, **c,
                                      t_init=torch.tensor(t_init)))
    uncut = _np(composite_tiles_plain(*targs, **geo, **c))
    assert (plain["n_contrib"] <= uncut["n_contrib"]).all()
    assert (plain["n_contrib"] < uncut["n_contrib"]).mean() > 0.05  # it fired
    assert (plain["n_contrib"] > 0).mean() > 0.2
    for name, want in (
            ("xla", jref.composite_tiles_xla(
                *jargs, **geo, **c, t_init=jnp.asarray(t_init))),
            ("pallas", composite_tiles_pallas(
                *jargs, **geo, **c, t_init=jnp.asarray(t_init),
                interpret=True))):
        want = _np(want)
        for k in ("accum", "t_final"):
            np.testing.assert_allclose(plain[k], want[k],
                                       err_msg=f"{name} {k}", **SLAB_TOL)
        np.testing.assert_array_equal(plain["n_contrib"], want["n_contrib"],
                                      err_msg=name)
    # ones change nothing, bit for bit
    ones = _np(composite_tiles_plain(*targs, **geo, **c,
                                     t_init=torch.ones((T, P))))
    for k in ("accum", "t_final", "n_contrib"):
        np.testing.assert_array_equal(ones[k], uncut[k])
    with pytest.raises(ValueError):
        composite_tiles_plain(*targs, **geo, **c, t_init=torch.ones((T, 3)))


def test_plain_tile_id_base_matches_oracles(rng):
    """Rows 2-3 of a 1x6 tile column composited by themselves, with their
    first tile's id as the base, are rows 2-3 of the whole frame."""
    entries, ts, tc, geo = _frame(rng, ONE_BY_SIX, n=300)
    c = _consts()
    band = dict(geo, n_tiles_y=2)
    sl = slice(2, 4)
    whole = _np(composite_tiles_plain(torch.tensor(entries), torch.tensor(ts),
                                      torch.tensor(tc), **geo, **c))
    assert (whole["n_contrib"][sl] > 0).mean() > 0.2
    targs = (torch.tensor(entries), torch.tensor(ts[sl]), torch.tensor(tc[sl]))
    got = _np(composite_tiles_plain(*targs, **band, **c, tile_id_base=2))
    for k in ("accum", "t_final", "n_contrib"):
        np.testing.assert_array_equal(got[k], whole[k][sl], err_msg=k)
    wrong = _np(composite_tiles_plain(*targs, **band, **c))
    assert np.abs(wrong["accum"] - got["accum"]).max() > 1e-2
    jargs = (jnp.asarray(entries), jnp.asarray(ts[sl]), jnp.asarray(tc[sl]))
    for name, want in (
            ("xla", jref.composite_tiles_xla(*jargs, **band, **c,
                                             tile_id_base=2)),
            ("pallas", composite_tiles_pallas(*jargs, **band, **c,
                                              tile_id_base=2,
                                              interpret=True))):
        want = _np(want)
        for k in ("accum", "t_final"):
            np.testing.assert_allclose(got[k], want[k],
                                       err_msg=f"{name} {k}", **SLAB_TOL)
        np.testing.assert_array_equal(got["n_contrib"], want["n_contrib"],
                                      err_msg=name)


@pytest.mark.parametrize("shape", [SMALL, DEFAULT_TILES],
                         ids=["8x128", "32x32"])
def test_slab_transmittance_plain_matches_pallas_and_cutfree(rng, shape):
    entries, ts, tc, geo = _frame(rng, shape, n=300)
    c = {k: v for k, v in _consts().items() if k != "t_eps"}
    targs = (torch.tensor(entries), torch.tensor(ts), torch.tensor(tc))
    got = t2n(slab_transmittance_plain(*targs, **geo, **c))
    assert (got < 1e-3).any() and (got <= 1).all() and (got[1] < 1).any()
    # an empty tile gives 1 and leaves the others as they were
    tc0 = tc.copy()
    tc0[1] = 0
    emptied = t2n(slab_transmittance_plain(targs[0], targs[1],
                                           torch.tensor(tc0), **geo, **c))
    assert (emptied[1] == 1.0).all()
    np.testing.assert_array_equal(np.delete(emptied, 1, 0),
                                  np.delete(got, 1, 0))
    want = np.asarray(slab_transmittance_pallas(
        jnp.asarray(entries), jnp.asarray(ts), jnp.asarray(tc), **geo, **c,
        interpret=True))
    np.testing.assert_allclose(got, want, **SLAB_TOL)
    cutfree = composite_tiles_plain(*targs, **geo, **c, t_eps=0.0)
    np.testing.assert_allclose(got, t2n(cutfree.t_final), **SLAB_TOL)
    # the dispatch takes the plain version for CPU tensors, and only those
    np.testing.assert_array_equal(
        t2n(tcomp.slab_transmittance(*targs, **geo, **c)), got)
    with pytest.raises(ValueError):
        tcomp.slab_transmittance(*(a.to("meta") for a in targs), **geo, **c)
    with pytest.raises(ValueError):
        tcomp.slab_transmittance_cuda(*targs, **geo, **c)
