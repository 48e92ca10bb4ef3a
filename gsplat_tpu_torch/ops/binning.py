"""Tile binning: (tile, gaussian) pair expansion, depth-ordered per tile,
laid out chunk-aligned. Counterpart of the path gsplat_tpu/ops/binning.py
``bin_gaussians`` takes for ``render`` (``sort_gaussians=True``,
``align=chunk``, rect expansion or per-tile-row ellipse culling), plus
``chunk_tables``.

The JAX package builds the expansion from scatters and int32 cumsums that
wrap on purpose, because gathers are slow on the TPU. Here the plain
PyTorch idiom does the same job: one stable depth sort of the gaussians, a
``searchsorted`` of the slot index in the gaussians' pair offsets for the
expansion into the ``m_cap`` static slots (as JAX's ``_expand`` fills
them: slot s is the s-th pair in gaussian-major order, and slots at or past
the frame's pair count are dead), a 2-D difference array over the
rectangles for the per-tile histogram of every pair, also those past
``m_cap``, and one stable sort of the packed (tile, depth-rank) key. No
tensor is sized by the frame's pair count and the host reads no count.
Index arithmetic runs in int64; the tile tables leave as int32, which is
what the compositor takes. The results equal the JAX ones exactly.

``expand_slab`` and ``merge_slab_binning`` are the slab-streamed form that
gaussian-sharded storage uses (parallel/sharded.py, the ``slab``
transient): each owner's slab of geometry is expanded by itself into
(tile, depth bits, storage row) entries at a per-slab capacity, and one
stable sort of the concatenated lists by (tile, depth bits) gives the
global order, so that no depth permutation of all the gaussians is ever
made.

Row culling (``conic`` and ``t_cut``, the config's ``row_cull``): the
expansion units become R = ``row_slots`` static slots per gaussian, R−1
single tile rows at the level-set ellipse's exact x-interval for that row
(``_slot_x_interval``) and one tail block over the remaining rows at the
interval of their joint span. A gaussian's slots are contiguous in unit
order, so its pairs stay contiguous in presort order, which the
prefix-difference gather gradient reads (``g_offsets`` / ``g_counts``).
The culled pairs are a subset of the rectangle's, and every dropped pair
has alpha below ``alpha_min`` at every pixel of its tile, so the
compositor, which skips such pairs, renders the same image up to the
grouping of its per-chunk transmittance products. A slot's rows are found
in the frame's pixel rows also on a window (``tile_row_base``).

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
    # the entry gather's gradient table (ops/kernels/gather.py); None
    # unless asked for. With g_offsets / g_counts it lists each gaussian's
    # slots in the order of its pairs
    slot_of: Optional[torch.Tensor] = None    # (m_cap,) int64 presort entry
    #   -> the layout slot that holds it, -1 where none does


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


def _rect_counts(x0, y0, x1, y1, live, n_tiles_x: int, n_tiles_y: int):
    """(n_tiles_y, n_tiles_x) int64 pairs per tile over the rectangles
    [x0,x1)×[y0,y1) of the ``live`` gaussians, without expanding them: +1
    at (y0,x0) and (y1,x1), −1 at (y0,x1) and (y1,x0) of a difference
    array, then a cumsum along each axis. Exact integers."""
    stride = n_tiles_x + 1
    one = live.long()
    diff = torch.zeros((n_tiles_y + 1) * stride, dtype=torch.long,
                       device=x0.device)
    for yy, xx, sign in ((y0, x0, 1), (y0, x1, -1), (y1, x0, -1),
                         (y1, x1, 1)):
        diff.index_add_(0, yy * stride + xx, sign * one)
    grid = diff.view(n_tiles_y + 1, stride).cumsum(0).cumsum(1)
    return grid[:n_tiles_y, :n_tiles_x]


def _expand_slots(counts: torch.Tensor, x0, y0, w, n_tiles_x: int,
                  n_tiles: int, m: int):
    """The unit-major pair list in ``m`` static slots: slot s holds the
    k-th pair of unit u, offsets[u] <= s < offsets[u] + counts[u], which
    covers the k-th tile of u's rectangle row by row. Returns (u, tile,
    live); a dead slot (s >= the pair count) has live False, tile
    ``n_tiles`` and u clamped into range."""
    ends = torch.cumsum(counts, 0)
    s = torch.arange(m, device=counts.device)
    g = torch.searchsorted(ends, s, right=True)
    live = g < counts.shape[0]
    g = torch.clamp(g, max=counts.shape[0] - 1)
    k = s - (ends[g] - counts[g])
    wg = torch.clamp(w[g], min=1)
    tile = (y0[g] + k // wg) * n_tiles_x + x0[g] + k % wg
    return g, torch.where(live, tile, n_tiles), live


def _slot_x_interval(mu_x, mu_y, ca, cb, cc, t, y_top, n_px):
    """The x-interval [u_lo, u_hi] (relative to mu_x, in pixels) where the
    level-set ellipse {d : dᵀ·conic·d <= t} meets the pixel rows
    y ∈ [y_top, y_top + n_px − 1] (one tile row, or a whole tail block),
    in float32 and in the JAX package's order of operations.

    q(u,v) = ca·u² + 2cb·uv + cc·v² is convex, so the set of u with
    min over v in the span of q <= t is an interval: its right end is the
    ellipse's x-extreme u_g = sqrt(t·cc/Δ) (Δ = ca·cc − cb², reached at
    v = −cb·u_g/cc) when that v lies in the span, else the larger root of
    q(u, v_edge) = t over the two edges; the left end mirrors it. The
    span's continuous v-range and half a pixel on either side keep it
    conservative. Returns (u_lo, u_hi, nonempty); an empty edge gives
    ±3e38, which callers clip before any integer cast. Slots with
    n_px <= 0 are the caller's to mask."""
    v0 = y_top.to(torch.float32) - mu_y
    v1 = v0 + (n_px.to(torch.float32) - 1.0)
    det2 = torch.clamp(ca * cc - cb * cb, min=1e-12)
    safe_ca = torch.clamp(ca, min=1e-12)
    safe_cc = torch.clamp(cc, min=1e-12)
    u_g = torch.sqrt(torch.clamp(t * safe_cc / det2, min=0.0))
    v_at_right = -cb * u_g / safe_cc        # v of the +x extreme point
    disc0 = t * safe_ca - det2 * v0 * v0
    disc1 = t * safe_ca - det2 * v1 * v1
    s0 = torch.sqrt(torch.clamp(disc0, min=0.0))
    s1 = torch.sqrt(torch.clamp(disc1, min=0.0))
    big = 3.0e38
    hi0 = torch.where(disc0 >= 0, (-cb * v0 + s0) / safe_ca, -big)
    hi1 = torch.where(disc1 >= 0, (-cb * v1 + s1) / safe_ca, -big)
    lo0 = torch.where(disc0 >= 0, (-cb * v0 - s0) / safe_ca, big)
    lo1 = torch.where(disc1 >= 0, (-cb * v1 - s1) / safe_ca, big)
    right_interior = (v_at_right >= v0) & (v_at_right <= v1)
    left_interior = (-v_at_right >= v0) & (-v_at_right <= v1)
    u_hi = torch.where(right_interior, u_g, torch.maximum(hi0, hi1))
    u_lo = torch.where(left_interior, -u_g, torch.minimum(lo0, lo1))
    nonempty = (u_lo <= u_hi) & (t > 0.0)
    return u_lo - 0.5, u_hi + 0.5, nonempty


class UnitExpansion(NamedTuple):
    """One expansion pass into ``m`` static slots (``_expand_units``): the
    sort- and layout-independent half of binning, shared by
    ``bin_gaussians`` and ``expand_slab``."""
    g: torch.Tensor           # (m,) int64 gaussian of each slot (clamped)
    tile: torch.Tensor        # (m,) int64; the sentinel n_tiles when dead
    live: torch.Tensor        # (m,) bool: slot < total
    counts: torch.Tensor      # (N,) int64 pairs of each gaussian
    offsets: torch.Tensor     # (N,) int64 exclusive starts of each
    total: torch.Tensor       # () int64 pairs, also those past m
    count_grid: torch.Tensor  # (n_tiles_y, n_tiles_x) int64 pairs per tile


def _expand_units(mean2d, radius, rx, ry, *, n_tiles_x: int, n_tiles_y: int,
                  tile_h: int, tile_w: int, m: int, tile_row_base: int = 0,
                  conic=None, t_cut=None, row_slots: int = 4
                  ) -> UnitExpansion:
    """Rectangles, or with ``conic`` and ``t_cut`` the culled slots, into
    the gaussian-major pair list of ``m`` static slots and the per-tile
    histogram of every pair. Units are the gaussians (rect expansion) or
    their R = ``row_slots`` slots each: slots 0..R−2 one tile row each at
    the ellipse's x-interval for that row, slot R−1 the tail block over the
    rest, all cut to the rectangle's own tiles (the half-pixel margin must
    not add a pair that rect binning lacks)."""
    n = mean2d.shape[0]
    n_tiles = n_tiles_x * n_tiles_y
    x0, y0, x1, y1 = tile_rect(mean2d, rx, ry, n_tiles_x, n_tiles_y,
                               tile_h, tile_w, tile_row_base)
    valid_g = (radius > 0) & (rx > 0) & (ry > 0)
    rect_w = torch.clamp(x1 - x0, min=0)
    rect_h = torch.clamp(y1 - y0, min=0)
    if conic is None:
        R = 1
        u_x0, u_y0 = x0, y0
        u_w = torch.where(valid_g, rect_w, 0)
        u_h = torch.where(valid_g, rect_h, 0)
    else:
        R = row_slots
        rvec = torch.arange(R, device=mean2d.device)[None, :]     # (1,R)
        h_u = torch.where(rvec < R - 1, (rvec < rect_h[:, None]).long(),
                          torch.clamp(rect_h[:, None] - (R - 1), min=0))
        ty0_u = y0[:, None] + rvec
        # the slot's pixel rows in the frame, also on a window
        u_lo, u_hi, nonempty = _slot_x_interval(
            mean2d[:, 0:1], mean2d[:, 1:2], conic[:, 0:1], conic[:, 1:2],
            conic[:, 2:3], t_cut[:, None], (ty0_u + tile_row_base) * tile_h,
            h_u * tile_h)
        # clip before the cast (an empty edge's ±3e38 has no integer), then
        # cut to the rectangle's x tiles
        f0 = torch.clamp(torch.floor((mean2d[:, 0:1] + u_lo) / tile_w),
                         0.0, float(n_tiles_x))
        f1 = torch.clamp(torch.floor((mean2d[:, 0:1] + u_hi) / tile_w),
                         -1.0, float(n_tiles_x))
        tx0_u = torch.maximum(f0.long(), x0[:, None])
        tx1_u = torch.minimum(f1.long() + 1, x1[:, None])
        w_u = torch.where(valid_g[:, None] & nonempty & (h_u > 0),
                          torch.clamp(tx1_u - tx0_u, min=0), 0)
        h_u = torch.where(w_u > 0, h_u, 0)
        # a dead slot's row may lie past the grid: keep its index in range
        u_x0, u_y0 = tx0_u.reshape(-1), torch.clamp(ty0_u,
                                                    max=n_tiles_y).reshape(-1)
        u_w, u_h = w_u.reshape(-1), h_u.reshape(-1)

    ucounts = u_w * u_h
    unit, tile, live = _expand_slots(ucounts, u_x0, u_y0, u_w, n_tiles_x,
                                     n_tiles, m)
    counts = ucounts.reshape(n, R).sum(dim=1)
    # every pair counts in the histogram, also those past m
    count_grid = _rect_counts(u_x0, u_y0, u_x0 + u_w, u_y0 + u_h,
                              ucounts > 0, n_tiles_x, n_tiles_y)
    return UnitExpansion(g=unit // R, tile=tile, live=live, counts=counts,
                         offsets=torch.cumsum(counts, 0) - counts,
                         total=counts.sum(), count_grid=count_grid)


def bin_gaussians(mean2d: torch.Tensor, depth: torch.Tensor,
                  radius: torch.Tensor, *, rx: torch.Tensor, ry: torch.Tensor,
                  image_width: int, image_height: int, tile_h: int,
                  tile_w: int, m_cap: int, align: int,
                  pad_cap: Optional[int] = None,
                  presort_tables: bool = False,
                  slot_tables: bool = False,
                  tile_row_base: int = 0,
                  conic: Optional[torch.Tensor] = None,
                  t_cut: Optional[torch.Tensor] = None,
                  row_slots: int = 4) -> Binning:
    """Build the chunk-aligned, per-tile depth-ordered entry list.

    Inputs carry no gradient (the ordering is not differentiated). Every
    tile's range starts at a multiple of ``align`` and is padded with
    sentinel entries to a multiple of it; the list has static length
    ``m_cap + pad_cap``, where ``pad_cap`` defaults to ``align`` × tiles.
    With ``presort_tables`` the result also carries ``inv_src``,
    ``g_offsets`` and ``g_counts``; with ``slot_tables`` it carries
    ``slot_of``, ``g_offsets`` and ``g_counts``. With ``tile_row_base`` the
    image is a window of the frame that starts at that tile row
    (``tile_rect``); tile ids are the window's own. With ``conic`` (N,3)
    and ``t_cut`` (N,) the rectangles are culled per tile row into
    ``row_slots`` slots (module docstring).
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
    if conic is not None:
        conic, t_cut = conic[perm], t_cut[perm]

    # --- expansion into m_cap static slots; the histogram counts every
    # pair, also past m_cap (the JAX package's rect-indicator product does
    # the same), then clamps to m_cap
    ex = _expand_units(mean2d, radius, rx, ry, n_tiles_x=n_tiles_x,
                       n_tiles_y=n_tiles_y, tile_h=tile_h, tile_w=tile_w,
                       m=m_cap, tile_row_base=tile_row_base, conic=conic,
                       t_cut=t_cut, row_slots=row_slots)
    tile, total = ex.tile, ex.total
    gidx = torch.where(ex.live, ex.g, n)           # pairs past m_cap drop
    tile_count = torch.clamp(ex.count_grid.reshape(-1), max=m_cap)
    tile_start = torch.cumsum(tile_count, 0) - tile_count
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
    # gives the per-tile depth order (dead slots, keyed past every tile,
    # sort last); entry r of tile t lands at padded_start[t] + r. Dead slots
    # of the layout keep the sentinel gaussian n.
    key, order = torch.sort(tile * (n + 1) + gidx, stable=True)
    gidx_aligned = _aligned_layout(key % (n + 1), n, tile_start, tile_count,
                                   padded_start, m_out)

    extras = {}
    if slot_tables or presort_tables:
        extras = dict(g_offsets=ex.offsets, g_counts=ex.counts)
    if slot_tables:
        # sorted entry i lies in the tile whose sorted range holds it and
        # fills that tile's padded slot of the same rank, as _aligned_layout
        # reads it, also in an overflow frame; it is presort entry order[i]
        i = torch.arange(m_cap, device=dev)
        t = torch.searchsorted(tile_start + tile_count, i, right=True)
        tc = torch.clamp(t, max=n_tiles - 1)
        slot = padded_start[tc] + i - tile_start[tc]
        slot_of = torch.empty_like(i)
        slot_of[order] = torch.where((t < n_tiles) & (slot < m_out), slot, -1)
        extras["slot_of"] = slot_of
    if presort_tables:
        # presort entry e is the e-th pair in gaussian-major depth order; a
        # dead one (e >= total) points into the layout's dead tail, where
        # the JAX package's sort leaves it
        tile_s = key // (n + 1)
        live_s = tile_s < n_tiles
        tile_s = torch.clamp(tile_s, max=n_tiles - 1)
        dest = padded_start[tile_s] + torch.arange(m_cap, device=dev) \
            - tile_start[tile_s]
        keep = live_s & (dest < m_out)     # only an overflow frame drops any
        e = torch.arange(m_cap, device=dev)
        inv_src = torch.clamp(num_padded + e - total, max=m_out - 1)
        inv_src[order] = torch.where(keep, dest, inv_src[order])
        extras["inv_src"] = inv_src

    # memory-safety clamp for overflow frames
    padded_start = torch.clamp(padded_start, max=m_out - align)
    tile_count = torch.minimum(tile_count, m_out - padded_start)
    return Binning(gidx_sorted=gidx_aligned,
                   tile_start=padded_start.to(torch.int32),
                   tile_count=tile_count.to(torch.int32),
                   num_pairs=total, overflow=overflow,
                   num_padded=num_padded, perm=perm, **extras)


def _aligned_layout(values_s: torch.Tensor, sentinel: int,
                    tile_start: torch.Tensor, tile_count: torch.Tensor,
                    padded_start: torch.Tensor, m_out: int) -> torch.Tensor:
    """The chunk-aligned layout (m_out,) of the tile-sorted entries
    ``values_s``, as a gather: slot d in tile t's padded range holds sorted
    entry tile_start[t] + r, r = d − padded_start[t], when r <
    tile_count[t], else ``sentinel``. The same layout a scatter of each
    entry to padded_start[t] + its rank writes, with no scatter (whose
    dropped entries would need a target) and no host read."""
    d = torch.arange(m_out, device=values_s.device)
    t = torch.searchsorted(padded_start, d, right=True) - 1
    r = d - padded_start[t]
    src = tile_start[t] + r
    live = (r < tile_count[t]) & (src < values_s.shape[0])
    return torch.where(live, values_s[torch.clamp(src, max=values_s.shape[0]
                                                  - 1)], sentinel)


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
                tile_w: int, m_slab: int, tile_row_base: int = 0,
                conic: Optional[torch.Tensor] = None,
                t_cut: Optional[torch.Tensor] = None,
                row_slots: int = 4) -> SlabExpansion:
    """Expand ONE slab of (n_loc) gaussians, in storage order, into at most
    ``m_slab`` (tile, depth key, storage row) entries. ``row_base`` is the
    first global storage row of the slab's owner; ``slab_base_entry`` places
    the slab's presort range [slab_base_entry, slab_base_entry + m_slab) in
    the concatenated layout. The depth key is the f32 depth's bit pattern,
    which orders as the depth does for depth > 0; a culled slot repeats its
    gaussian's. ``tile_row_base``, ``conic``, ``t_cut`` and ``row_slots``
    as in ``bin_gaussians``."""
    ex = _expand_units(mean2d, radius, rx, ry,
                       n_tiles_x=-(-image_width // tile_w),
                       n_tiles_y=-(-image_height // tile_h), tile_h=tile_h,
                       tile_w=tile_w, m=m_slab, tile_row_base=tile_row_base,
                       conic=conic, t_cut=t_cut, row_slots=row_slots)
    dbits = depth.contiguous().view(torch.int32).long()
    return SlabExpansion(
        tile=ex.tile, dkey=torch.where(ex.live, dbits[ex.g], _DKEY_SENTINEL),
        gidx=torch.where(ex.live, row_base + ex.g, sentinel_row),
        counts=ex.counts, offsets=slab_base_entry + ex.offsets,
        count_grid=ex.count_grid, total=ex.total,
        overflow=torch.clamp(ex.total - m_slab, min=0))


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
    gidx_aligned = _aligned_layout(gidx_s, sentinel_row, tile_start,
                                   tile_count, padded_start, m_out)
    inv_src = torch.zeros((m_cap,), dtype=torch.long, device=dev)
    inv_src[e_s] = torch.where(keep, dest, 0)

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
