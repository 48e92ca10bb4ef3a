"""Adaptive density control: clone, split, prune and opacity reset in the
fixed-capacity buffers. Counterpart of gsplat_tpu/train/densify.py, with
the same slot allocation, so both packages put each new row in the same
slot:

- clones take the free (inactive) slots first, in slot order, then split
  pairs; new rows get zeroed Adam moments;
- a split is placed whole or not at all: if the free slots run out for
  either child, neither is written and the original stays;
- prune clears ``active``;
- the count of rows that found no free slot is returned as ``overflow``
  (the host grows the capacity and densifies again).

The reference zeroes max_radii2D before its screen-size prune reads it, so
that prune never fires; the stats are zeroed before pruning here too.
Split samples are N(0, scale) draws from a ``torch.Generator``; a caller
can hand in its own standard-normal draws as ``noise``.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Tuple

import torch

from gsplat_tpu_torch.core.transforms import inverse_sigmoid, quat_to_rotmat
from gsplat_tpu_torch.models.gaussian_model import (TRAINABLE_FIELDS,
                                                    GaussianParams)
from gsplat_tpu_torch.train.optim import AdamState


@dataclass
class DensifyStats:
    xyz_gradient_accum: torch.Tensor  # (CAP,)
    denom: torch.Tensor               # (CAP,)
    max_radii2d: torch.Tensor         # (CAP,)


def init_stats(capacity: int, device="cuda") -> DensifyStats:
    def z():
        return torch.zeros((capacity,), dtype=torch.float32, device=device)
    return DensifyStats(xyz_gradient_accum=z(), denom=z(), max_radii2d=z())


def add_densification_stats(stats: DensifyStats, radii: torch.Tensor,
                            mean2d_grad: torch.Tensor) -> DensifyStats:
    """Accumulate one view: the NDC-unit screen-space gradient norm and a
    count for every visible (radius > 0) gaussian, and the largest radius."""
    vis = radii > 0
    gnorm = torch.linalg.norm(mean2d_grad[:, :2], dim=-1)
    return DensifyStats(
        xyz_gradient_accum=stats.xyz_gradient_accum
        + torch.where(vis, gnorm, 0.0),
        denom=stats.denom + vis.float(),
        max_radii2d=torch.where(vis, torch.maximum(stats.max_radii2d, radii),
                                stats.max_radii2d))


def _scatter_rows(leaf: torch.Tensor, dest: torch.Tensor,
                  rows: torch.Tensor) -> torch.Tensor:
    """leaf with rows[i] written at dest[i]; dest == capacity drops it."""
    keep = dest < leaf.shape[0]
    out = leaf.clone()
    out[dest[keep]] = rows[keep]
    return out


def densify_and_prune(g: GaussianParams, adam: AdamState, stats: DensifyStats,
                      generator: Optional[torch.Generator] = None, *,
                      max_grad: float, min_opacity: float, extent: float,
                      percent_dense: float, use_screen_size_prune: bool,
                      max_screen_size: float = 20.0,
                      noise: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
                      ) -> Tuple[GaussianParams, AdamState, DensifyStats,
                                 int]:
    """One densify + prune event. ``noise`` = (eps1, eps2), each (CAP,3)
    standard-normal draws for the two children of a split; without it they
    are drawn from ``generator``. Returns (params, adam, stats, overflow)."""
    cap = g.capacity
    dev = g.device
    active = g.active
    grads = torch.where(stats.denom > 0, stats.xyz_gradient_accum
                        / torch.clamp(stats.denom, min=1.0), 0.0)
    scaling_act = g.get_scaling()
    max_scale = scaling_act.amax(dim=1)

    hit = active & (grads >= max_grad)
    mask_c = hit & (max_scale <= percent_dense * extent)       # clone
    mask_s = hit & (max_scale > percent_dense * extent)        # split

    # slot allocation: clones first, then split pairs
    free = ~active
    n_free = int(free.sum())
    free_slot = torch.full((cap,), cap, dtype=torch.long, device=dev)
    free_slot[:n_free] = torch.nonzero(free).squeeze(1)  # r-th free slot
    n_clone = int(mask_c.sum())
    clone_rank = torch.cumsum(mask_c.long(), 0) - 1
    split_rank = torch.cumsum(mask_s.long(), 0) - 1
    n_split = int(mask_s.sum())

    def take_free(r, m):
        ok = m & (r < n_free)
        return torch.where(ok, free_slot[torch.where(ok, r, cap - 1)], cap)

    dest_c = take_free(clone_rank, mask_c)
    dest_s1 = take_free(n_clone + 2 * split_rank, mask_s)
    dest_s2 = take_free(n_clone + 2 * split_rank + 1, mask_s)
    overflow = max(n_clone + 2 * n_split - n_free, 0)
    placed_s = mask_s & (dest_s1 < cap) & (dest_s2 < cap)
    dest_s1 = torch.where(placed_s, dest_s1, cap)
    dest_s2 = torch.where(placed_s, dest_s2, cap)

    # split samples: x_new = R eps + x, eps ~ N(0, scale)
    if noise is None:
        noise = tuple(torch.randn((cap, 3), generator=generator, device=dev)
                      for _ in range(2))
    R = quat_to_rotmat(g.get_rotation())                      # (CAP,3,3)
    xyz_s1 = g.xyz + torch.einsum("nij,nj->ni", R, noise[0] * scaling_act)
    xyz_s2 = g.xyz + torch.einsum("nij,nj->ni", R, noise[1] * scaling_act)
    scaling_new = torch.log(scaling_act / (0.8 * 2))

    new_g = {k: getattr(g, k) for k in TRAINABLE_FIELDS}
    mu, nu = dict(adam.mu), dict(adam.nu)
    for name in TRAINABLE_FIELDS:
        src = new_g[name]
        if name == "xyz":
            rows_s1, rows_s2 = xyz_s1, xyz_s2
        elif name == "scaling":
            rows_s1 = rows_s2 = scaling_new
        else:
            rows_s1 = rows_s2 = src
        leaf = _scatter_rows(src, dest_c, src)
        leaf = _scatter_rows(leaf, dest_s1, rows_s1)
        new_g[name] = _scatter_rows(leaf, dest_s2, rows_s2)
        zero = torch.zeros_like(mu[name])
        for d in (dest_c, dest_s1, dest_s2):
            mu[name] = _scatter_rows(mu[name], d, zero)
            nu[name] = _scatter_rows(nu[name], d, zero)

    # activate the new rows, retire the split originals
    true = torch.ones((cap,), dtype=torch.bool, device=dev)
    for d in (dest_c, dest_s1, dest_s2):
        active = _scatter_rows(active, d, true)
    active = torch.where(placed_s, False, active)

    stats = init_stats(cap, dev)
    prune = torch.sigmoid(new_g["opacity"]) < min_opacity
    if use_screen_size_prune:
        big_vs = stats.max_radii2d > max_screen_size   # zeroed: never fires
        big_ws = torch.exp(new_g["scaling"]).amax(dim=1) > 0.1 * extent
        prune = prune | big_vs | big_ws
    active = active & ~prune

    g2 = dataclasses.replace(g, active=active, **new_g)
    return g2, AdamState(mu=mu, nu=nu, count=adam.count), stats, overflow


def reset_opacity(g: GaussianParams, adam: AdamState):
    """Clamp opacity to at most 0.01 on live rows and zero its Adam
    moments."""
    new_op = inverse_sigmoid(torch.clamp(g.get_opacity(), max=0.01))
    g2 = dataclasses.replace(g, opacity=torch.where(g.active, new_op,
                                                    g.opacity))
    mu = dict(adam.mu)
    nu = dict(adam.nu)
    mu["opacity"] = torch.zeros_like(mu["opacity"])
    nu["opacity"] = torch.zeros_like(nu["opacity"])
    return g2, AdamState(mu=mu, nu=nu, count=adam.count)
