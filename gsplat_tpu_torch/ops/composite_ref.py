"""Plain PyTorch tile compositor: the CPU route, the differentiable oracle,
and the version the CUDA kernels are held to (ops/kernels/csrc/
composite_fwd.cu, and composite_bwd.cu through autograd). Counterpart of gsplat_tpu/ops/composite_ref.py
(``composite_tiles_xla``), with the same semantics:

- alpha = min(alpha_max, op·exp(min(power, 0))), skipped unless
  alpha ≥ alpha_min and power ≤ 0; its gradient is that of op·exp(power)
  even where the clamp holds, as in JAX's TPU backward kernel and the CUDA
  one (autodiff through ``composite_tiles_xla`` gives 0 there instead);
- front to back, a pixel stops at the first entry with T·(1−α) < t_eps,
  tested *before* that entry is committed (it does not contribute);
- n_contrib = 1 + the in-tile rank of the last contributor;
- ``t_init`` (T,P), the transmittance arriving from everything nearer than
  this entry list (depth slabs), scales that stop test only, as
  t_init·(T·(1−α)) < t_eps: accum and t_final stay in unit-T space, so the
  slabs' ordered merge keeps its differentiable form;
- ``tile_id_base`` moves the tile origin: tile t lies where tile
  tile_id_base + t of the full grid lies (tile bands).

``slab_transmittance_plain`` is the cut-free Π(1−α) of each tile's whole
list, the plain version of csrc/slab_tmit.cu.

``cull_rect_plain`` is the plain version of the CUDA kernels' cull
rectangle (csrc/composite_alpha.cuh ``cull_rect``): per entry and tile, a
pixel rectangle outside which no pixel can pass the alpha test. The plain
versions here do not need it; ``cull=True`` masks the pairs outside it
away, which must change nothing, and is how the tests and the smoke run
hold the rectangle to the compositor and the slab transmittance.
``cull_rects_plain`` gives it for every row of an entry list, with the warp
mask the kernels stage beside it.

Pixel offsets are taken in tile-local coordinates (mean minus the tile's
origin), as the stream kernel and the CUDA kernel do: the tighter rounding.

All tiles advance together, one G-entry chunk of their range per step
(G = the layout's alignment); inside a chunk the transmittance is a cumprod.
Autograd differentiates through it; the early-termination masks act as
stop-gradients exactly like the reference backward's contributor cutoffs.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from gsplat_tpu_torch.utils.general import full_f32_matmul


class CompositeOut(NamedTuple):
    accum: torch.Tensor      # (T, 4, P) premultiplied rgb + invdepth (no bg)
    t_final: torch.Tensor    # (T, P) final transmittance
    n_contrib: torch.Tensor  # (T, P) int32 1 + rank of the last contributor


def cull_rect_plain(entries: torch.Tensor, alpha_min: float, *, ox=0.0,
                    oy=0.0, tile_h: int, tile_w: int):
    """(x0, x1, y0, y1): int64 tensors shaped as ``entries[..., 0]``, the
    inclusive tile-local pixel bounds outside which the entry's alpha is
    below ``alpha_min`` on a tile_h × tile_w tile whose origin is (ox, oy)
    (broadcast against the rows); empty where x0 > x1 or y0 > y1. The
    formula, margins and the no-culling cases (the whole tile) are those of
    csrc/composite_alpha.cuh ``cull_rect``, which says why they are
    conservative, in the same float32 operations."""
    e = entries.detach()
    mx, my = e[..., 0] - ox, e[..., 1] - oy
    ca, cb, cc, op = e[..., 2], e[..., 3], e[..., 4], e[..., 5]
    tau0 = torch.log(op / alpha_min)
    tau = tau0.abs() * (1.0 + 1e-5) + 1e-5
    ac, bb = ca * cc, cb * cb
    det = ac - bb - 4e-7 * (ac + bb)
    shrink = 1.0 - 2e-6 * (ac / det)
    s = 2.0 * tau / (det * shrink)
    hx = torch.sqrt(s * cc) * (1.0 + 1e-4) + 0.5
    hy = torch.sqrt(s * ca) * (1.0 + 1e-4) + 0.5
    xlo, xhi = torch.ceil(mx - hx), torch.floor(mx + hx)
    ylo, yhi = torch.ceil(my - hy), torch.floor(my + hy)
    culled = ((ca > 0) & (cc > 0) & (det > 0) & (shrink > 0.75)
              & (xlo.abs() + xhi.abs() + ylo.abs() + yhi.abs() < 1e30))
    none = tau0 < -1e-4
    if not alpha_min > 0:                    # no floor: nothing is culled
        culled, none = torch.zeros_like(culled), torch.zeros_like(none)
    w1, h1 = float(tile_w - 1), float(tile_h - 1)

    def pick(v, full, empty, lo, hi):
        v = torch.where(culled, v.clamp(lo, hi), torch.full_like(v, full))
        return torch.where(none, torch.full_like(v, empty), v).long()

    return (pick(xlo, 0.0, 0.0, 0.0, w1 + 1.0), pick(xhi, w1, -1.0, -1.0, w1),
            pick(ylo, 0.0, 0.0, 0.0, h1 + 1.0), pick(yhi, h1, -1.0, -1.0, h1))


def _tile_origins(n_tiles, n_tiles_x, tile_h, tile_w, tile_id_base, device):
    """Pixel origin (ox, oy) of each tile of a launch, as float (T,)."""
    tid = tile_id_base + torch.arange(n_tiles, device=device)
    return (((tid % n_tiles_x) * tile_w).float(),
            ((tid // n_tiles_x) * tile_h).float())


def cull_rects_plain(entries: torch.Tensor, tile_start: torch.Tensor,
                     tile_count: torch.Tensor, *, n_tiles_x: int,
                     n_tiles_y: int, tile_h: int, tile_w: int,
                     alpha_min: float, tile_id_base: int = 0) -> torch.Tensor:
    """(M, 5) int32, for every entry row inside a tile's range: the cull
    rectangle x0, x1, y0, y1 on that tile and the mask of the kernels' 8
    warps (128 consecutive pixels each) whose tile rows it meets; -2 on rows
    no tile owns. The plain version of csrc/composite_fwd.cu
    ``gsplat_composite_cull_rects``, which reports what the kernels stage
    (``stage_entry`` of composite_alpha.cuh)."""
    dev = entries.device
    T, P = n_tiles_x * n_tiles_y, tile_h * tile_w
    start = tile_start.long()
    count = torch.minimum(tile_count.long(),
                          (entries.shape[0] - start).clamp(min=0))
    tile = torch.repeat_interleave(torch.arange(T, device=dev), count)
    row = start[tile] + torch.arange(tile.shape[0], device=dev) \
        - (torch.cumsum(count, 0) - count)[tile]
    ox, oy = _tile_origins(T, n_tiles_x, tile_h, tile_w, tile_id_base, dev)
    x0, x1, y0, y1 = cull_rect_plain(entries[row], alpha_min, ox=ox[tile],
                                     oy=oy[tile], tile_h=tile_h,
                                     tile_w=tile_w)
    mask = torch.zeros_like(x0)
    for w in range(8):
        first, end = w * 128, min(w * 128 + 128, P)
        if first < P:
            meets = ((x0 <= x1) & (y0 <= y1) & (y0 <= (end - 1) // tile_w)
                     & (y1 >= first // tile_w))
            mask |= meets.long() << w
    out = torch.full((entries.shape[0], 5), -2, dtype=torch.int32, device=dev)
    out[row] = torch.stack([x0, x1, y0, y1, mask], 1).to(torch.int32)
    return out


class _TileWalk:
    """The chunk-by-chunk walk both plain versions share: all tiles advance
    together, and step j evaluates the alphas of every tile that has a j-th
    chunk."""

    def __init__(self, entries, tile_start, tile_count, *, n_tiles_x,
                 n_tiles_y, tile_h, tile_w, chunk, alpha_min, alpha_max,
                 tile_id_base=0, cull=False):
        dev = entries.device
        self.tile_h, self.tile_w, self.cull = tile_h, tile_w, cull
        T = n_tiles_x * n_tiles_y
        P = tile_h * tile_w
        if entries.shape[0] % chunk:
            raise ValueError(
                f"entries rows {entries.shape[0]} are not a whole number of "
                f"chunks of {chunk} (align=chunk layout)")
        self.entries, self.T, self.P, self.G = entries, T, P, chunk
        self.alpha_min, self.alpha_max = alpha_min, alpha_max
        self.start = tile_start.long()
        self.count = tile_count.long()
        self.n_chk = -(-self.count // chunk)
        self.n_steps = int(self.n_chk.max()) if T else 0
        p = torch.arange(P, device=dev)
        self.pxl = (p % tile_w).float()
        self.pyl = (p // tile_w).float()
        self.ox, self.oy = _tile_origins(T, n_tiles_x, tile_h, tile_w,
                                         tile_id_base, dev)
        self.g = torch.arange(chunk, device=dev)

    def inside(self, idx, data):
        """(L,G,P) bool: the pixels inside each row's cull rectangle on its
        tile, for the (L,G,16) rows ``data`` of the tiles ``idx``."""
        x0, x1, y0, y1 = (v[..., None] for v in cull_rect_plain(
            data, self.alpha_min, ox=self.ox[idx, None],
            oy=self.oy[idx, None], tile_h=self.tile_h, tile_w=self.tile_w))
        return ((self.pxl >= x0) & (self.pxl <= x1)
                & (self.pyl >= y0) & (self.pyl <= y1))

    def step(self, j):
        """(idx, rank, data, a1) of step j: the L tiles with a chunk j, its
        in-tile ranks (G,), its rows (L,G,16) and its alphas (L,G,P), 0
        where the entry is skipped."""
        idx = torch.nonzero(self.n_chk > j).squeeze(1)
        rank = j * self.G + self.g
        data = self.entries[self.start[idx, None] + rank[None, :]]
        valid = rank[None, :] < self.count[idx, None]            # (L,G)

        mxl = data[..., 0:1] - self.ox[idx, None, None]          # (L,G,1)
        myl = data[..., 1:2] - self.oy[idx, None, None]
        ca, cb, cc = data[..., 2:3], data[..., 3:4], data[..., 4:5]
        op = data[..., 5:6]
        dx = self.pxl - mxl                                      # (L,G,P)
        dy = self.pyl - myl
        power = -0.5 * (ca * dx * dx + cc * dy * dy) - cb * dx * dy
        alpha_raw = op * torch.exp(torch.clamp(power, max=0.0))
        # min(alpha_raw, alpha_max) in value; the gradient passes straight
        # through the clamp, as in the TPU and CUDA backward kernels
        alpha = alpha_raw - (alpha_raw - self.alpha_max).clamp(
            min=0.0).detach()
        live = valid[..., None] & (alpha >= self.alpha_min) & (power <= 0.0)
        if self.cull:
            live = live & self.inside(idx, data)
        a1 = torch.where(live, alpha, torch.zeros_like(alpha))
        return idx, rank, data, a1


def composite_tiles_plain(entries: torch.Tensor,     # (M, 16) packed rows
                          tile_start: torch.Tensor,  # (T,) aligned to chunk
                          tile_count: torch.Tensor,  # (T,)
                          *, n_tiles_x: int, n_tiles_y: int, tile_h: int,
                          tile_w: int, chunk: int, alpha_min: float,
                          alpha_max: float, t_eps: float,
                          t_init: Optional[torch.Tensor] = None,  # (T, P)
                          tile_id_base: int = 0,
                          cull: bool = False) -> CompositeOut:
    """``cull=True`` drops every (entry, pixel) pair outside the entry's
    cull rectangle before the alpha test; the result must not change."""
    full_f32_matmul()      # the per-chunk color sum below is a batched matmul
    dev = entries.device
    walk = _TileWalk(entries, tile_start, tile_count, n_tiles_x=n_tiles_x,
                     n_tiles_y=n_tiles_y, tile_h=tile_h, tile_w=tile_w,
                     chunk=chunk, alpha_min=alpha_min, alpha_max=alpha_max,
                     tile_id_base=tile_id_base, cull=cull)
    T, P = walk.T, walk.P
    if t_init is not None:
        if tuple(t_init.shape) != (T, P):
            raise ValueError(f"t_init must be ({T}, {P}), got "
                             f"{tuple(t_init.shape)}")
        t_init = t_init.detach()

    accum = torch.zeros((T, 4, P), dtype=entries.dtype, device=dev)
    t_run = torch.ones((T, P), dtype=entries.dtype, device=dev)
    done = torch.zeros((T, P), dtype=torch.bool, device=dev)
    nc = torch.zeros((T, P), dtype=torch.long, device=dev)

    for j in range(walk.n_steps):
        idx, rank, data, a1 = walk.step(j)

        t_in = t_run[idx][:, None, :]                        # (L,1,P)
        ones = torch.ones_like(t_in)
        one_m = 1.0 - a1
        cum = torch.cumprod(one_m, dim=1)
        t_excl = t_in * torch.cat([ones, cum[:, :-1]], dim=1)
        test_t = t_excl * one_m
        if t_init is not None:
            test_t = t_init[idx][:, None, :] * test_t
        cross = (a1 > 0) & (test_t < t_eps)
        done_incl = done[idx][:, None, :] | (torch.cumsum(cross.int(), 1) > 0)
        contrib = (a1 > 0) & ~done_incl

        a2 = torch.where(contrib, a1, torch.zeros_like(a1))
        cum2 = torch.cumprod(1.0 - a2, dim=1)
        wgt = t_in * torch.cat([ones, cum2[:, :-1]], dim=1) * a2
        new_accum = accum[idx] + torch.einsum("lgp,lgc->lcp", wgt,
                                              data[..., 6:10])
        new_t = t_in[:, 0] * cum2[:, -1]
        new_done = done[idx] | cross.any(dim=1)
        last = torch.where(contrib, (rank + 1)[None, :, None], 0).amax(dim=1)
        new_nc = torch.maximum(nc[idx], last)

        accum = accum.index_copy(0, idx, new_accum)
        t_run = t_run.index_copy(0, idx, new_t)
        done = done.index_copy(0, idx, new_done)
        nc = nc.index_copy(0, idx, new_nc)

    return CompositeOut(accum=accum, t_final=t_run,
                        n_contrib=nc.to(torch.int32))


def slab_transmittance_plain(entries: torch.Tensor, tile_start: torch.Tensor,
                             tile_count: torch.Tensor, *, n_tiles_x: int,
                             n_tiles_y: int, tile_h: int, tile_w: int,
                             chunk: int, alpha_min: float,
                             alpha_max: float,
                             cull: bool = False) -> torch.Tensor:
    """(T, P) cut-free transmittance Π(1−α) = exp Σ log1p(−α) over each
    tile's whole entry list, 1 on an empty tile: what
    ``composite_tiles_plain(t_eps=0).t_final`` is, without the compositing.
    Counterpart of gsplat_tpu/ops/pallas/composite.py
    ``slab_transmittance_pallas``. It carries no gradient. ``cull=True``
    drops the pairs outside the entry's cull rectangle, as the kernel does;
    the result must not change."""
    with torch.no_grad():
        walk = _TileWalk(entries, tile_start, tile_count, n_tiles_x=n_tiles_x,
                         n_tiles_y=n_tiles_y, tile_h=tile_h, tile_w=tile_w,
                         chunk=chunk, alpha_min=alpha_min,
                         alpha_max=alpha_max, cull=cull)
        lg = torch.zeros((walk.T, walk.P), dtype=entries.dtype,
                         device=entries.device)
        for j in range(walk.n_steps):
            idx, _, _, a1 = walk.step(j)
            lg.index_add_(0, idx, torch.log1p(-a1).sum(dim=1))
        return torch.where((walk.count == 0)[:, None], torch.ones_like(lg),
                           torch.exp(lg))
