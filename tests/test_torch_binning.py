"""Port parity: binning from identical float inputs must equal the JAX
binning exactly — gidx_sorted, tile_start, tile_count, num_pairs,
overflow, num_padded, and perm on the visible gaussians (dead slots share
one depth, so their order among themselves is free); with
``presort_tables`` also inv_src, g_offsets and g_counts; and every integer
output of the slab-streamed form (``expand_slab``, ``merge_slab_binning``).
In an overflow frame only the reported counts are compared: its content is
garbage by contract."""
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
    return bj, _port_binning(arrs, **kw), arrs


def _port_binning(arrs, **kw):
    return tbin.bin_gaussians(
        *(torch.tensor(arrs[k]) for k in ("mean2d", "depth", "radius")),
        rx=torch.tensor(arrs["rx"]), ry=torch.tensor(arrs["ry"]), **kw)


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


def test_presort_tables_match_jax_exactly(rng):
    """inv_src, g_offsets and g_counts, which only ``presort_tables=True``
    fills: every presort entry's slot in the aligned layout (the dead ones
    past num_pairs too), and each gaussian's range, in depth order."""
    th, tw, chunk, W, H = SMALL
    pre = _pre(rng, n=400, W=W, H=H, cap=450)
    kw = dict(image_width=W, image_height=H, tile_h=th, tile_w=tw,
              m_cap=-(-450 * 24 // chunk) * chunk, align=chunk)
    bj, bt, arrs = _both(pre, **kw)
    assert bt.inv_src is None and bt.g_offsets is None and bt.g_counts is None
    bt = _port_binning(arrs, presort_tables=True, **kw)
    assert int(bt.overflow) == 0
    for k in ("gidx_sorted", "tile_start", "tile_count", "inv_src"):
        np.testing.assert_array_equal(getattr(bt, k).numpy(),
                                      np.asarray(getattr(bj, k)), err_msg=k)
    # per-gaussian tables are in depth order; dead slots share one depth, so
    # compare through each side's own perm, on the visible gaussians
    vis = arrs["radius"] > 0
    for k in ("g_offsets", "g_counts"):
        by_row_j = np.zeros(450, np.int64)
        by_row_j[np.asarray(bj.perm)] = np.asarray(getattr(bj, k))
        by_row_t = np.zeros(450, np.int64)
        by_row_t[bt.perm.numpy()] = getattr(bt, k).numpy()
        np.testing.assert_array_equal(by_row_t[vis], by_row_j[vis], err_msg=k)
    assert int(bt.g_counts.sum()) == int(bt.num_pairs)
    # the map inverts the layout: a live presort entry finds its gaussian
    total = int(bt.num_pairs)
    g_of_entry = np.repeat(np.arange(450), bt.g_counts.numpy())
    np.testing.assert_array_equal(
        bt.gidx_sorted.numpy()[bt.inv_src.numpy()[:total]], g_of_entry)


def _slab_binning(arrs, n_slabs, m_slab, order, kw):
    """expand_slab on each of n_slabs row ranges, in the ring-arrival order
    ``order`` (owners), and the merge, through JAX and through the port."""
    n = arrs["depth"].shape[0]
    rows = n // n_slabs
    names = ("mean2d", "depth", "radius", "rx", "ry")
    sj, st = [], []
    for s, owner in enumerate(order):
        sl = slice(owner * rows, (owner + 1) * rows)
        common = dict(row_base=owner * rows, slab_base_entry=s * m_slab,
                      sentinel_row=n, m_slab=m_slab, **kw)
        sj.append(jbin.expand_slab(*(jnp.asarray(arrs[k][sl]) for k in names),
                                   **common))
        st.append(tbin.expand_slab(*(torch.tensor(arrs[k][sl]) for k in names),
                                   **common))
    bj = jbin.merge_slab_binning(sj, sentinel_row=n, align=16, **kw)
    bt = tbin.merge_slab_binning(st, sentinel_row=n, align=16, **kw)
    return sj, st, bj, bt


SLAB_FIELDS = ("tile", "dkey", "gidx", "counts", "offsets", "count_grid",
               "total", "overflow")
MERGED_FIELDS = ("gidx_sorted", "tile_start", "tile_count", "num_pairs",
                 "overflow", "num_padded", "inv_src", "g_offsets", "g_counts")


@pytest.mark.parametrize("ties", [False, True], ids=["random", "equal-depth"])
def test_slab_streamed_binning_matches_jax_exactly(rng, ties):
    """expand_slab and merge_slab_binning, every integer output equal. With
    ``ties`` gaussian 0 of each of the 4 slabs sits at one place and one
    depth: the merged sort must keep them in the order the slabs arrived,
    which is not the owners' order."""
    th, tw, chunk, W, H = SMALL
    pre = _pre(rng, n=380, W=W, H=H, cap=400)
    arrs = {k: np.array(getattr(pre, k)) for k in
            ("mean2d", "depth", "radius", "rx", "ry")}
    order = [2, 1, 0, 3]                   # ring arrival at shard 2 of 4
    if ties:
        src = int(np.argmax(arrs["radius"][:100]))
        for owner in range(4):
            for k in arrs:
                arrs[k][owner * 100] = arrs[k][src]
    kw = dict(image_width=W, image_height=H, tile_h=th, tile_w=tw)
    sj, st, bj, bt = _slab_binning(arrs, 4, 100 * 24, order, kw)
    for a, b in zip(st, sj):
        for k in SLAB_FIELDS:
            np.testing.assert_array_equal(getattr(a, k).numpy(),
                                          np.asarray(getattr(b, k)),
                                          err_msg=k)
    assert int(bt.overflow) == 0 and int(bt.num_pairs) > 0
    assert bt.perm is None and bj.perm is None
    for k in MERGED_FIELDS:
        np.testing.assert_array_equal(getattr(bt, k).numpy(),
                                      np.asarray(getattr(bj, k)), err_msg=k)
    if ties:
        # within one tile the four equal-depth rows come in arrival order
        rows = bt.gidx_sorted.numpy()
        tied = rows[np.isin(rows, [0, 100, 200, 300])]
        first = tied[:4].tolist()
        assert first == [200, 100, 0, 300], first


def test_slab_streamed_binning_reports_overflow(rng):
    """A slab capacity below one slab's pairs: the counts JAX reports."""
    th, tw, chunk, W, H = SMALL
    pre = _pre(rng, n=380, W=W, H=H, cap=400)
    arrs = {k: np.asarray(getattr(pre, k)) for k in
            ("mean2d", "depth", "radius", "rx", "ry")}
    kw = dict(image_width=W, image_height=H, tile_h=th, tile_w=tw)
    sj, st, bj, bt = _slab_binning(arrs, 4, 64, [0, 3, 2, 1], kw)
    assert int(bj.overflow) > 0
    _counts(bj, bt)
    for a, b in zip(st, sj):
        assert int(a.total) == int(b.total)
        assert int(a.overflow) == int(b.overflow)


def test_tile_row_base_windows_are_the_frames_rows(rng):
    """A window of tile rows binned with ``tile_row_base`` holds exactly the
    frame's tiles of those rows: the same counts, and the same gaussians in
    the same order (no JAX counterpart: the JAX package moves mean2d.y)."""
    th, tw, chunk, W, _ = SMALL
    H = 8 * th
    pre = _pre(rng, n=400, W=W, H=H, cap=450)
    arrs = {k: np.asarray(getattr(pre, k)) for k in
            ("mean2d", "depth", "radius", "rx", "ry")}
    kw = dict(image_width=W, tile_h=th, tile_w=tw, m_cap=450 * 24,
              align=chunk)
    full = _port_binning(arrs, image_height=H, **kw)
    n_tiles_x = -(-W // tw)
    rows = 3                              # 8 rows in windows of 3: 3, 3, 2+1
    for k in range(3):
        win = _port_binning(arrs, image_height=rows * th,
                            tile_row_base=k * rows, **kw)
        for t in range(rows * n_tiles_x):
            ft = k * rows * n_tiles_x + t
            if ft >= full.tile_count.shape[0]:
                continue                   # the padded ninth row
            assert int(win.tile_count[t]) == int(full.tile_count[ft])
            a = win.gidx_sorted[int(win.tile_start[t]):][:int(win.tile_count[t])]
            b = full.gidx_sorted[int(full.tile_start[ft]):][
                :int(full.tile_count[ft])]
            np.testing.assert_array_equal(a.numpy(), b.numpy())
