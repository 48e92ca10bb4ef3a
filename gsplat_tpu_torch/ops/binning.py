"""Tile binning: (tile, gaussian) pair expansion, depth-ordered per tile,
laid out chunk-aligned. Counterpart of the path gsplat_tpu/ops/binning.py
``bin_gaussians`` takes for ``render`` (``sort_gaussians=True``,
``align=chunk``, rect expansion, no row culling), plus ``chunk_tables``.

The JAX package builds the expansion from scatters and int32 cumsums that
wrap on purpose, because gathers are slow on the TPU. Here the plain
PyTorch idiom does the same job: one stable depth sort of the gaussians,
``repeat_interleave`` for the expansion, ``bincount`` for the per-tile
histogram and one stable sort of the packed (tile, depth-rank) key. Index
arithmetic runs in int64; the tile tables leave as int32, which is what the
compositor takes. The results equal the JAX ones exactly.

``expand_slab`` and ``merge_slab_binning`` are the slab-streamed form that
gaussian-sharded storage uses (parallel/sharded.py, the ``slab``
transient): each owner's slab of geometry is expanded by itself into
(tile, depth bits, storage row) entries at a per-slab capacity, and one
stable sort of the concatenated lists by (tile, depth bits) gives the
global order, so that no depth permutation of all the gaussians is ever
made. Rect expansion only, as in ``bin_gaussians``.

Overflow beyond ``m_cap`` (pairs) or ``pad_cap`` (alignment padding) is
counted in ``overflow``; such a frame's content is garbage by contract
(memory-safe, but not an image): the caller grows the capacity and renders
again.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch


class Binning(NamedTuple):
    gidx_sorted: torch.Tensor   # (m_cap + pad_cap,) int64 depth rank per
    #   entry; dead slots carry the sentinel n (the zero packed row)
    tile_start: torch.Tensor    # (T,) int32 first entry of each tile
    tile_count: torch.Tensor    # (T,) int32 real entries of each tile
    num_pairs: torch.Tensor     # () int64 real entries (pre-truncation)
    overflow: torch.Tensor      # () int64 dropped entries (0 if caps sufficed)
    num_padded: torch.Tensor    # () int64 extent of the chunk-padded layout
    perm: Optional[torch.Tensor]  # (N,) int64 depth order of the gaussians;
    #   gidx_sorted indexes THIS order (callers gather table[perm])
    # the presort tables of the prefix-difference gather gradient
    # (ops/rasterize.py masked_presort_prefix); None unless asked for
    inv_src: Optional[torch.Tensor] = None    # (m_cap,) int64 presort entry
    #   (gaussian-major, depth order) -> its slot in the aligned layout
    g_offsets: Optional[torch.Tensor] = None  # (N,) int64 first presort
    #   entry of each gaussian (in perm's order)
    g_counts: Optional[torch.Tensor] = None   # (N,) int64 entries of each


def tile_rect(mean2d: torch.Tensor, rx: torch.Tensor, ry: torch.Tensor,
              n_tiles_x: int, n_tiles_y: int, tile_h: int, tile_w: int,
              tile_row_base: int = 0):
    """Inclusive-exclusive tile rectangle [x0,x1)×[y0,y1) covered by each
    Gaussian's per-axis extents; floor handles negative coordinates. With
    ``tile_row_base`` the grid is a window of ``n_tiles_y`` tile rows that
    starts at that row of the frame's grid: the rows are found in the
    frame's coordinates and moved as integers, so a window's rectangles are
    exactly the frame's, cut to the window (moving ``mean2d`` instead rounds
    the sums below at another size, and an extent within rounding of a tile
    boundary can then change its row)."""
    def floordiv(a, b):
        return torch.div(a, b, rounding_mode="floor")
    x0 = torch.clamp(torch.floor((mean2d[:, 0] - rx) / tile_w), 0, n_tiles_x)
    x1 = torch.clamp(floordiv(mean2d[:, 0] + rx + tile_w - 1, tile_w),
                     0, n_tiles_x)
    y0 = torch.floor((mean2d[:, 1] - ry) / tile_h)
    y1 = floordiv(mean2d[:, 1] + ry + tile_h - 1, tile_h)
    if tile_row_base:
        y0, y1 = y0 - tile_row_base, y1 - tile_row_base
    y0 = torch.clamp(y0, 0, n_tiles_y)
    y1 = torch.clamp(y1, 0, n_tiles_y)
    return x0.long(), y0.long(), x1.long(), y1.long()


def bin_gaussians(mean2d: torch.Tensor, depth: torch.Tensor,
                  radius: torch.Tensor, *, rx: torch.Tensor, ry: torch.Tensor,
                  image_width: int, image_height: int, tile_h: int,
                  tile_w: int, m_cap: int, align: int,
                  pad_cap: Optional[int] = None,
                  presort_tables: bool = False,
                  tile_row_base: int = 0) -> Binning:
    """Build the chunk-aligned, per-tile depth-ordered entry list.

    Inputs carry no gradient (the ordering is not differentiated). Every
    tile's range starts at a multiple of ``align`` and is padded with
    sentinel entries to a multiple of it; the list has static length
    ``m_cap + pad_cap``, where ``pad_cap`` defaults to ``align`` × tiles.
    With ``presort_tables`` the result also carries ``inv_src``,
    ``g_offsets`` and ``g_counts``. With ``tile_row_base`` the image is a
    window of the frame that starts at that tile row (``tile_rect``); tile
    ids are the window's own.
    """
    dev = mean2d.device
    n = mean2d.shape[0]
    n_tiles_x = -(-image_width // tile_w)
    n_tiles_y = -(-image_height // tile_h)
    n_tiles = n_tiles_x * n_tiles_y

    # N-sized stable depth sort; every per-gaussian array below is in depth
    # order, so an entry's gaussian index doubles as its depth key.
    perm = torch.sort(depth, stable=True).indices
    mean2d, radius, rx, ry = mean2d[perm], radius[perm], rx[perm], ry[perm]

    x0, y0, x1, y1 = tile_rect(mean2d, rx, ry, n_tiles_x, n_tiles_y,
                               tile_h, tile_w, tile_row_base)
    valid_g = (radius > 0) & (rx > 0) & (ry > 0)
    w = torch.where(valid_g, torch.clamp(x1 - x0, min=0), 0)
    h = torch.where(valid_g, torch.clamp(y1 - y0, min=0), 0)
    counts = w * h
    total = counts.sum()
    offsets = torch.cumsum(counts, 0) - counts

    # --- expansion: entry e of gaussian g covers the k-th tile of its rect
    g_all = torch.repeat_interleave(torch.arange(n, device=dev), counts)
    k = torch.arange(g_all.shape[0], device=dev) - offsets[g_all]
    wg = w[g_all]
    tile_all = (y0[g_all] + k // wg) * n_tiles_x + x0[g_all] + k % wg
    # The histogram counts every pair, also past m_cap (the JAX package's
    # rect-indicator product does the same), then clamps to m_cap.
    tile_count = torch.clamp(torch.bincount(tile_all, minlength=n_tiles),
                             max=m_cap)
    tile_start = torch.cumsum(tile_count, 0) - tile_count
    gidx, tile = g_all[:m_cap], tile_all[:m_cap]   # pairs past m_cap drop
    overflow = torch.clamp(total - m_cap, min=0)

    # --- chunk-aligned layout
    if pad_cap is None:
        pad_cap = align * n_tiles
    pad_cap = min(-(-pad_cap // align) * align, align * n_tiles)
    padded_count = -(-tile_count // align) * align
    ends = torch.cumsum(padded_count, 0)
    padded_start = ends - padded_count
    m_out = m_cap + pad_cap
    num_padded = ends[-1]
    total_pad = num_padded - tile_count.sum()
    # every pad must fit or the per-tile starts shift
    overflow = torch.maximum(overflow, total_pad - pad_cap)

    # (tile, depth rank) is unique per pair, so one sort of the packed key
    # gives the per-tile depth order; entry r of tile t goes to
    # padded_start[t] + r. Dead slots keep the sentinel gaussian n.
    key, order = torch.sort(tile * (n + 1) + gidx, stable=True)
    tile_s, gidx_s = key // (n + 1), key % (n + 1)
    rank = torch.arange(key.shape[0], device=dev) - tile_start[tile_s]
    dest = padded_start[tile_s] + rank
    keep = dest < m_out                    # only an overflow frame drops any
    gidx_aligned = torch.full((m_out,), n, dtype=torch.long, device=dev)
    gidx_aligned[dest[keep]] = gidx_s[keep]

    extras = {}
    if presort_tables:
        # presort entry e is the e-th pair in gaussian-major depth order; a
        # dead one (e >= total) points into the layout's dead tail, where
        # the JAX package's sort leaves it
        e = torch.arange(m_cap, device=dev)
        inv_src = torch.clamp(num_padded + e - total, max=m_out - 1)
        inv_src[order[keep]] = dest[keep]
        extras = dict(inv_src=inv_src, g_offsets=offsets, g_counts=counts)

    # memory-safety clamp for overflow frames
    padded_start = torch.clamp(padded_start, max=m_out - align)
    tile_count = torch.minimum(tile_count, m_out - padded_start)
    return Binning(gidx_sorted=gidx_aligned,
                   tile_start=padded_start.to(torch.int32),
                   tile_count=tile_count.to(torch.int32),
                   num_pairs=total, overflow=overflow,
                   num_padded=num_padded, perm=perm, **extras)


class SlabExpansion(NamedTuple):
    """One geometry slab's expansion (``expand_slab``): the per-slab half of
    slab-streamed binning. ``merge_slab_binning`` joins D of them."""
    tile: torch.Tensor         # (m_slab,) int64; the sentinel n_tiles past total
    dkey: torch.Tensor         # (m_slab,) int64 f32-depth bits; sentinel 2^31-1
    gidx: torch.Tensor         # (m_slab,) int64 GLOBAL storage row; dead
    #   entries carry the caller's sentinel_row (the zero packed row)
    counts: torch.Tensor       # (n_loc,) int64 entries of each slab gaussian
    offsets: torch.Tensor      # (n_loc,) int64 ABSOLUTE presort starts
    #   (slab_base_entry + the slab's exclusive offsets)
    count_grid: torch.Tensor   # (n_tiles_y, n_tiles_x) int64 pairs per tile
    total: torch.Tensor        # () int64 real entries of this slab
    overflow: torch.Tensor     # () int64 entries dropped past m_slab


_DKEY_SENTINEL = 2 ** 31 - 1


def expand_slab(mean2d: torch.Tensor, depth: torch.Tensor,
                radius: torch.Tensor, rx: torch.Tensor, ry: torch.Tensor, *,
                row_base: int, slab_base_entry: int, sentinel_row: int,
                image_width: int, image_height: int, tile_h: int,
                tile_w: int, m_slab: int,
                tile_row_base: int = 0) -> SlabExpansion:
    """Expand ONE slab of (n_loc) gaussians, in storage order, into at most
    ``m_slab`` (tile, depth key, storage row) entries. ``row_base`` is the
    first global storage row of the slab's owner; ``slab_base_entry`` places
    the slab's presort range [slab_base_entry, slab_base_entry + m_slab) in
    the concatenated layout. The depth key is the f32 depth's bit pattern,
    which orders as the depth does for depth > 0. ``tile_row_base`` as in
    ``bin_gaussians``."""
    dev = mean2d.device
    n = mean2d.shape[0]
    n_tiles_x = -(-image_width // tile_w)
    n_tiles_y = -(-image_height // tile_h)
    n_tiles = n_tiles_x * n_tiles_y

    x0, y0, x1, y1 = tile_rect(mean2d, rx, ry, n_tiles_x, n_tiles_y,
                               tile_h, tile_w, tile_row_base)
    valid_g = (radius > 0) & (rx > 0) & (ry > 0)
    w = torch.where(valid_g, torch.clamp(x1 - x0, min=0), 0)
    h = torch.where(valid_g, torch.clamp(y1 - y0, min=0), 0)
    counts = w * h
    total = counts.sum()
    offsets = torch.cumsum(counts, 0) - counts

    g_all = torch.repeat_interleave(torch.arange(n, device=dev), counts)
    k = torch.arange(g_all.shape[0], device=dev) - offsets[g_all]
    wg = w[g_all]
    tile_all = (y0[g_all] + k // wg) * n_tiles_x + x0[g_all] + k % wg
    # every pair counts in the histogram, also those past m_slab
    count_grid = torch.bincount(tile_all, minlength=n_tiles).reshape(
        n_tiles_y, n_tiles_x)
    dbits = depth.contiguous().view(torch.int32).long()

    def padded(values, sentinel):
        out = torch.full((m_slab,), sentinel, dtype=torch.long, device=dev)
        live = values[:m_slab]
        out[:live.shape[0]] = live
        return out

    g_live = g_all[:m_slab]
    return SlabExpansion(
        tile=padded(tile_all, n_tiles), dkey=padded(dbits[g_live],
                                                    _DKEY_SENTINEL),
        gidx=padded(row_base + g_live, sentinel_row), counts=counts,
        offsets=slab_base_entry + offsets, count_grid=count_grid,
        total=total, overflow=torch.clamp(total - m_slab, min=0))


def merge_slab_binning(slabs, *, sentinel_row: int, image_width: int,
                       image_height: int, tile_h: int, tile_w: int,
                       align: int, pad_cap: Optional[int] = None) -> Binning:
    """One merged sort and the chunk-aligned layout over D concatenated slab
    expansions: the global half of slab-streamed binning. The sort is by
    (tile, depth bits) and stable, so entries of equal key keep the order of
    ``slabs``. ``gidx_sorted`` holds global storage rows (``perm`` is None);
    ``g_offsets`` / ``g_counts`` are the slabs' tables concatenated in the
    order of ``slabs``; ``inv_src`` maps the concatenated presort layout to
    the aligned one."""
    dev = slabs[0].tile.device
    n_tiles_x = -(-image_width // tile_w)
    n_tiles_y = -(-image_height // tile_h)
    n_tiles = n_tiles_x * n_tiles_y
    m_cap = slabs[0].tile.shape[0] * len(slabs)
    if align <= 1:
        raise ValueError("slab-streamed binning feeds the aligned layout "
                         "only (align > 1)")

    tile = torch.cat([s.tile for s in slabs])
    dkey = torch.cat([s.dkey for s in slabs])
    gidx = torch.cat([s.gidx for s in slabs])
    total = torch.stack([s.total for s in slabs]).sum()
    overflow = torch.stack([s.overflow for s in slabs]).sum()
    grid = torch.stack([s.count_grid for s in slabs]).sum(dim=0)

    tile_count = torch.clamp(grid.reshape(-1), max=m_cap)
    tile_start = torch.cumsum(tile_count, 0) - tile_count
    # one stable sort of the packed (tile, depth bits) key: both parts are
    # non-negative and the depth bits fit 31
    e_s = torch.sort(tile * 2 ** 32 + dkey, stable=True).indices
    gidx_s = gidx[e_s]

    if pad_cap is None:
        pad_cap = align * n_tiles
    pad_cap = min(-(-pad_cap // align) * align, align * n_tiles)
    padded_count = -(-tile_count // align) * align
    ends = torch.cumsum(padded_count, 0)
    padded_start = ends - padded_count
    m_out = m_cap + pad_cap
    num_padded = ends[-1]
    shift_raw = padded_start - tile_start
    overflow = torch.maximum(overflow, shift_raw.max() - pad_cap)
    shift = torch.clamp(shift_raw, max=pad_cap)
    # sorted position p lies in the last tile that starts at or before it;
    # the dead tail takes the last tile's shift
    p = torch.arange(m_cap, device=dev)
    dest = p + shift[torch.searchsorted(tile_start, p, right=True) - 1]
    keep = dest < m_out                    # only an overflow frame drops any
    gidx_aligned = torch.full((m_out,), sentinel_row, dtype=torch.long,
                              device=dev)
    gidx_aligned[dest[keep]] = gidx_s[keep]
    inv_src = torch.zeros((m_cap,), dtype=torch.long, device=dev)
    inv_src[e_s[keep]] = dest[keep]

    padded_start = torch.clamp(padded_start, max=m_out - align)
    tile_count = torch.minimum(tile_count, m_out - padded_start)
    return Binning(gidx_sorted=gidx_aligned,
                   tile_start=padded_start.to(torch.int32),
                   tile_count=tile_count.to(torch.int32),
                   num_pairs=total, overflow=overflow,
                   num_padded=num_padded, perm=None, inv_src=inv_src,
                   g_offsets=torch.cat([s.offsets for s in slabs]),
                   g_counts=torch.cat([s.counts for s in slabs]))


def chunk_tables(tile_start: torch.Tensor, tile_count: torch.Tensor, *,
                 n_tiles: int, chunk: int, n_chunks: int):
    """Per-chunk (tile, rank0, count) tables of the aligned layout: chunk i
    belongs to the last tile whose first chunk is ≤ i, starts at in-tile
    rank rank0, and that tile has ``count`` entries. Chunks outside the
    layout's real extent get the sentinel tile ``n_tiles`` and count 0."""
    dev = tile_start.device
    start_chunk = tile_start.long() // chunk
    tile_count = tile_count.long()
    ci = torch.arange(n_chunks, device=dev)
    ct = torch.searchsorted(start_chunk, ci, right=True) - 1
    ct_safe = torch.clamp(ct, 0, n_tiles - 1)
    rank0 = (ci - start_chunk[ct_safe]) * chunk
    cc = tile_count[ct_safe]
    used = -(-tile_count // chunk) * chunk
    begin = start_chunk[0]
    end = begin + used.sum() // chunk
    is_tail = (ci < begin) | (ci >= end)
    ct = torch.where(is_tail, n_tiles, ct_safe)
    cc = torch.where(is_tail, 0, cc)
    return ct, rank0, cc
