"""Port parity: binning from identical float inputs must equal the JAX
binning exactly — gidx_sorted, tile_start, tile_count, num_pairs,
overflow, num_padded, and perm on the visible gaussians (dead slots share
one depth, so their order among themselves is free). In an overflow frame
only the reported counts are compared: its content is garbage by
contract."""
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from gsplat_tpu.ops import binning as jbin
from gsplat_tpu.ops import preprocess as jpre
from gsplat_tpu_torch.ops import binning as tbin

from torch_parity import DEFAULT_TILES, SMALL, make_scene


@functools.partial(jax.jit, static_argnames=("W", "H"))
def _jax_pre(g, cam, *, W, H):
    return jpre.preprocess(
        g.xyz, g.get_scaling(), g.get_rotation(), g.get_opacity(),
        g.get_features(), g.active_sh_degree, cam, W, H,
        active_mask=g.active)


def _pre(rng, n, W, H, cap=None):
    return _jax_pre(*make_scene(rng, n=n, cap=cap), W=W, H=H)


def _both(pre, **kw):
    names = ("mean2d", "depth", "radius", "rx", "ry")
    arrs = {k: np.asarray(getattr(pre, k)) for k in names}
    fn = jax.jit(functools.partial(jbin.bin_gaussians, sort_gaussians=True,
                                   **kw))
    bj = fn(*(jnp.asarray(arrs[k]) for k in names[:3]),
            rx=jnp.asarray(arrs["rx"]), ry=jnp.asarray(arrs["ry"]))
    bt = tbin.bin_gaussians(*(torch.tensor(arrs[k]) for k in names[:3]),
                            rx=torch.tensor(arrs["rx"]),
                            ry=torch.tensor(arrs["ry"]), **kw)
    return bj, bt, arrs


def _counts(bj, bt):
    for k in ("num_pairs", "overflow", "num_padded"):
        assert int(getattr(bt, k)) == int(getattr(bj, k)), k


@pytest.mark.parametrize("shape", [SMALL, DEFAULT_TILES],
                         ids=["8x128", "32x32"])
def test_binning_matches_jax_exactly(rng, shape):
    th, tw, chunk, W, H = shape
    pre = _pre(rng, n=400, W=W, H=H, cap=450)
    n_tiles = -(-W // tw) * -(-H // th)
    kw = dict(image_width=W, image_height=H, tile_h=th, tile_w=tw,
              m_cap=-(-450 * 24 // chunk) * chunk, align=chunk)
    bj, bt, arrs = _both(pre, **kw)
    assert int(bj.overflow) == 0 and int(bj.num_pairs) > 0
    _counts(bj, bt)
    for k in ("gidx_sorted", "tile_start", "tile_count"):
        np.testing.assert_array_equal(getattr(bt, k).numpy(),
                                      np.asarray(getattr(bj, k)), err_msg=k)
    vis = arrs["radius"] > 0
    perm_j, perm_t = np.asarray(bj.perm), bt.perm.numpy()
    np.testing.assert_array_equal(perm_t[vis[perm_t]], perm_j[vis[perm_j]])

    # the chunk → (tile, rank0, count) tables of the plain compositor
    n_chunks = bt.gidx_sorted.shape[0] // chunk
    tj = jbin.chunk_tables(bj.tile_start, bj.tile_count, n_tiles=n_tiles,
                           chunk=chunk, n_chunks=n_chunks)
    tt = tbin.chunk_tables(bt.tile_start, bt.tile_count, n_tiles=n_tiles,
                           chunk=chunk, n_chunks=n_chunks)
    for a, b, name in zip(tt, tj, ("tile", "rank0", "count")):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=name)


def test_pair_overflow_counts_match_jax(rng):
    th, tw, chunk, W, H = SMALL
    pre = _pre(rng, n=200, W=W // 2, H=H)
    bj, bt, _ = _both(pre, image_width=W // 2, image_height=H, tile_h=th,
                      tile_w=tw, m_cap=16, align=chunk)
    assert int(bj.overflow) > 0
    _counts(bj, bt)


def test_pad_cap_overflow_counts_match_jax(rng):
    """m_cap has slack but the alignment padding outgrows pad_cap
    (cf. tests/test_rasterize.py test_pad_cap_overflow_detected)."""
    th, tw, _, W, _ = SMALL
    H = 8 * th
    pre = _pre(rng, n=200, W=W, H=H)
    kw = dict(image_width=W, image_height=H, tile_h=th, tile_w=tw,
              align=64, m_cap=64 * 200)
    bj, bt, _ = _both(pre, pad_cap=64 * 16 * 2, **kw)
    assert int(bj.overflow) == 0
    _counts(bj, bt)
    np.testing.assert_array_equal(bt.gidx_sorted.numpy(),
                                  np.asarray(bj.gidx_sorted))
    bj, bt, _ = _both(pre, pad_cap=64, **kw)
    assert int(bj.overflow) > 0
    _counts(bj, bt)
