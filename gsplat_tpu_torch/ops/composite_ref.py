"""Plain PyTorch tile compositor: the CPU route, the differentiable oracle,
and the version the CUDA kernel (ops/kernels/csrc/composite_fwd.cu) is
held to. Counterpart of gsplat_tpu/ops/composite_ref.py
(``composite_tiles_xla``), with the same semantics:

- alpha = min(alpha_max, op·exp(min(power, 0))), skipped unless
  alpha ≥ alpha_min and power ≤ 0;
- front to back, a pixel stops at the first entry with T·(1−α) < t_eps,
  tested *before* that entry is committed (it does not contribute);
- n_contrib = 1 + the in-tile rank of the last contributor.

Pixel offsets are taken in tile-local coordinates (mean minus the tile's
origin), as the stream kernel and the CUDA kernel do: the tighter rounding.

All tiles advance together, one G-entry chunk of their range per step
(G = the layout's alignment); inside a chunk the transmittance is a cumprod.
Autograd differentiates through it; the early-termination masks act as
stop-gradients exactly like the reference backward's contributor cutoffs.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from gsplat_tpu_torch.utils.general import full_f32_matmul


class CompositeOut(NamedTuple):
    accum: torch.Tensor      # (T, 4, P) premultiplied rgb + invdepth (no bg)
    t_final: torch.Tensor    # (T, P) final transmittance
    n_contrib: torch.Tensor  # (T, P) int32 1 + rank of the last contributor


def composite_tiles_plain(entries: torch.Tensor,     # (M, 16) packed rows
                          tile_start: torch.Tensor,  # (T,) aligned to chunk
                          tile_count: torch.Tensor,  # (T,)
                          *, n_tiles_x: int, n_tiles_y: int, tile_h: int,
                          tile_w: int, chunk: int, alpha_min: float,
                          alpha_max: float, t_eps: float) -> CompositeOut:
    full_f32_matmul()      # the per-chunk color sum below is a batched matmul
    dev = entries.device
    T = n_tiles_x * n_tiles_y
    P = tile_h * tile_w
    G = chunk
    if entries.shape[0] % G:
        raise ValueError(f"entries rows {entries.shape[0]} are not a whole "
                         f"number of chunks of {G} (align=chunk layout)")
    start = tile_start.long()
    count = tile_count.long()
    n_chk = -(-count // G)

    p = torch.arange(P, device=dev)
    pxl = (p % tile_w).float()
    pyl = (p // tile_w).float()
    tid = torch.arange(T, device=dev)
    ox = ((tid % n_tiles_x) * tile_w).float()
    oy = ((tid // n_tiles_x) * tile_h).float()
    g = torch.arange(G, device=dev)

    accum = torch.zeros((T, 4, P), dtype=entries.dtype, device=dev)
    t_run = torch.ones((T, P), dtype=entries.dtype, device=dev)
    done = torch.zeros((T, P), dtype=torch.bool, device=dev)
    nc = torch.zeros((T, P), dtype=torch.long, device=dev)

    for j in range(int(n_chk.max()) if T else 0):
        idx = torch.nonzero(n_chk > j).squeeze(1)       # tiles with chunk j
        rank = j * G + g                                 # (G,) in-tile rank
        data = entries[start[idx, None] + rank[None, :]]     # (L,G,16)
        valid = rank[None, :] < count[idx, None]             # (L,G)

        mxl = data[..., 0:1] - ox[idx, None, None]           # (L,G,1)
        myl = data[..., 1:2] - oy[idx, None, None]
        ca, cb, cc = data[..., 2:3], data[..., 3:4], data[..., 4:5]
        op = data[..., 5:6]
        dx = pxl - mxl                                       # (L,G,P)
        dy = pyl - myl
        power = -0.5 * (ca * dx * dx + cc * dy * dy) - cb * dx * dy
        alpha = torch.clamp(op * torch.exp(torch.clamp(power, max=0.0)),
                            max=alpha_max)
        live = valid[..., None] & (alpha >= alpha_min) & (power <= 0.0)
        a1 = torch.where(live, alpha, torch.zeros_like(alpha))

        t_in = t_run[idx][:, None, :]                        # (L,1,P)
        ones = torch.ones_like(t_in)
        one_m = 1.0 - a1
        cum = torch.cumprod(one_m, dim=1)
        t_excl = t_in * torch.cat([ones, cum[:, :-1]], dim=1)
        cross = (a1 > 0) & (t_excl * one_m < t_eps)
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
