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


class _TileWalk:
    """The chunk-by-chunk walk both plain versions share: all tiles advance
    together, and step j evaluates the alphas of every tile that has a j-th
    chunk."""

    def __init__(self, entries, tile_start, tile_count, *, n_tiles_x,
                 n_tiles_y, tile_h, tile_w, chunk, alpha_min, alpha_max,
                 tile_id_base=0):
        dev = entries.device
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
        tid = tile_id_base + torch.arange(T, device=dev)
        self.ox = ((tid % n_tiles_x) * tile_w).float()
        self.oy = ((tid // n_tiles_x) * tile_h).float()
        self.g = torch.arange(chunk, device=dev)

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
        a1 = torch.where(live, alpha, torch.zeros_like(alpha))
        return idx, rank, data, a1


def composite_tiles_plain(entries: torch.Tensor,     # (M, 16) packed rows
                          tile_start: torch.Tensor,  # (T,) aligned to chunk
                          tile_count: torch.Tensor,  # (T,)
                          *, n_tiles_x: int, n_tiles_y: int, tile_h: int,
                          tile_w: int, chunk: int, alpha_min: float,
                          alpha_max: float, t_eps: float,
                          t_init: Optional[torch.Tensor] = None,  # (T, P)
                          tile_id_base: int = 0) -> CompositeOut:
    full_f32_matmul()      # the per-chunk color sum below is a batched matmul
    dev = entries.device
    walk = _TileWalk(entries, tile_start, tile_count, n_tiles_x=n_tiles_x,
                     n_tiles_y=n_tiles_y, tile_h=tile_h, tile_w=tile_w,
                     chunk=chunk, alpha_min=alpha_min, alpha_max=alpha_max,
                     tile_id_base=tile_id_base)
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
                             alpha_max: float) -> torch.Tensor:
    """(T, P) cut-free transmittance Π(1−α) = exp Σ log1p(−α) over each
    tile's whole entry list, 1 on an empty tile: what
    ``composite_tiles_plain(t_eps=0).t_final`` is, without the compositing.
    Counterpart of gsplat_tpu/ops/pallas/composite.py
    ``slab_transmittance_pallas``. It carries no gradient."""
    with torch.no_grad():
        walk = _TileWalk(entries, tile_start, tile_count, n_tiles_x=n_tiles_x,
                         n_tiles_y=n_tiles_y, tile_h=tile_h, tile_w=tile_w,
                         chunk=chunk, alpha_min=alpha_min,
                         alpha_max=alpha_max)
        lg = torch.zeros((walk.T, walk.P), dtype=entries.dtype,
                         device=entries.device)
        for j in range(walk.n_steps):
            idx, _, _, a1 = walk.step(j)
            lg.index_add_(0, idx, torch.log1p(-a1).sum(dim=1))
        return torch.where((walk.count == 0)[:, None], torch.ones_like(lg),
                           torch.exp(lg))
