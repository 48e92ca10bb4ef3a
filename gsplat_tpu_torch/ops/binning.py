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


def tile_rect(mean2d: torch.Tensor, rx: torch.Tensor, ry: torch.Tensor,
              n_tiles_x: int, n_tiles_y: int, tile_h: int, tile_w: int):
    """Inclusive-exclusive tile rectangle [x0,x1)×[y0,y1) covered by each
    Gaussian's per-axis extents; floor handles negative coordinates."""
    def floordiv(a, b):
        return torch.div(a, b, rounding_mode="floor")
    x0 = torch.clamp(torch.floor((mean2d[:, 0] - rx) / tile_w), 0, n_tiles_x)
    y0 = torch.clamp(torch.floor((mean2d[:, 1] - ry) / tile_h), 0, n_tiles_y)
    x1 = torch.clamp(floordiv(mean2d[:, 0] + rx + tile_w - 1, tile_w),
                     0, n_tiles_x)
    y1 = torch.clamp(floordiv(mean2d[:, 1] + ry + tile_h - 1, tile_h),
                     0, n_tiles_y)
    return x0.long(), y0.long(), x1.long(), y1.long()


def bin_gaussians(mean2d: torch.Tensor, depth: torch.Tensor,
                  radius: torch.Tensor, *, rx: torch.Tensor, ry: torch.Tensor,
                  image_width: int, image_height: int, tile_h: int,
                  tile_w: int, m_cap: int, align: int,
                  pad_cap: Optional[int] = None) -> Binning:
    """Build the chunk-aligned, per-tile depth-ordered entry list.

    Inputs carry no gradient (the ordering is not differentiated). Every
    tile's range starts at a multiple of ``align`` and is padded with
    sentinel entries to a multiple of it; the list has static length
    ``m_cap + pad_cap``, where ``pad_cap`` defaults to ``align`` × tiles.
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
                               tile_h, tile_w)
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
    key = torch.sort(tile * (n + 1) + gidx, stable=True).values
    tile_s, gidx_s = key // (n + 1), key % (n + 1)
    rank = torch.arange(key.shape[0], device=dev) - tile_start[tile_s]
    dest = padded_start[tile_s] + rank
    keep = dest < m_out                    # only an overflow frame drops any
    gidx_aligned = torch.full((m_out,), n, dtype=torch.long, device=dev)
    gidx_aligned[dest[keep]] = gidx_s[keep]

    # memory-safety clamp for overflow frames
    padded_start = torch.clamp(padded_start, max=m_out - align)
    tile_count = torch.minimum(tile_count, m_out - padded_start)
    return Binning(gidx_sorted=gidx_aligned,
                   tile_start=padded_start.to(torch.int32),
                   tile_count=tile_count.to(torch.int32),
                   num_pairs=total, overflow=overflow,
                   num_padded=num_padded, perm=perm)


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
