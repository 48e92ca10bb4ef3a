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

One body serves one process and a row-sharded state over ranks
(``parts``, a ``RankParts``: rank k holds global rows [k·R, (k+1)·R)); in
one process the state is one part. On ranks the event is the whole
state's, bit for bit, without gathering it: the ranks all-gather their
counts of free slots, clones and splits, and each adds the exclusive
offsets of the ranks before it to its local ranks. Only the selected
source rows travel, each to the rank that owns its slot, which writes it.
Every rank draws the split samples with the global shape from the same
generator and keeps its rows, so the draws are one process's; the draw is
two (CAP, 3) float32 tensors on every rank, CAP the global capacity.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch

from gsplat_tpu_torch.core.transforms import inverse_sigmoid, quat_to_rotmat
from gsplat_tpu_torch.models.gaussian_model import (TRAINABLE_FIELDS,
                                                    GaussianParams)
from gsplat_tpu_torch.parallel import LocalParts, exchange
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


def densify_and_prune(g: GaussianParams, adam: AdamState, stats: DensifyStats,
                      generator: Optional[torch.Generator] = None, *,
                      max_grad: float, min_opacity: float, extent: float,
                      percent_dense: float, use_screen_size_prune: bool,
                      max_screen_size: float = 20.0,
                      noise: Optional[Tuple[torch.Tensor,
                                            torch.Tensor]] = None,
                      parts=None) -> Tuple[GaussianParams, AdamState,
                                           DensifyStats, int]:
    """One densify + prune event. ``noise`` = (eps1, eps2), each (CAP,3)
    standard-normal draws for the two children of a split; without it they
    are drawn from ``generator``. ``g``, ``adam`` and ``stats`` are the
    rows of part ``k`` of ``parts`` (a ``RankParts``: this rank's rows of a
    row-sharded state; by default one part, the whole state) and CAP is the
    global capacity. Returns (params, adam, stats, overflow).

    A slot's destination order q is a clone's global rank, or
    n_clone + 2·(a split's global rank) + child; slot q is the q-th free
    slot of the whole state, on the part whose free-slot range holds q."""
    parts = LocalParts(1) if parts is None else parts
    (k,) = parts.mine
    n = parts.n
    rows = g.capacity
    dev = g.device
    active = g.active
    grads = torch.where(stats.denom > 0, stats.xyz_gradient_accum
                        / torch.clamp(stats.denom, min=1.0), 0.0)
    scaling_act = g.get_scaling()
    max_scale = scaling_act.amax(dim=1)
    hit = active & (grads >= max_grad)
    mask_c = hit & (max_scale <= percent_dense * extent)       # clone
    mask_s = hit & (max_scale > percent_dense * extent)        # split
    free = ~active

    counts = parts.gather([torch.stack([free.sum(), mask_c.sum(),
                                        mask_s.sum()])]).cpu()   # (n, 3)
    ends = torch.cumsum(counts, 0)                       # inclusive, per part
    starts = ends - counts
    n_free, n_clone, n_split = (int(x) for x in ends[-1])
    overflow = max(n_clone + 2 * n_split - n_free, 0)

    # split samples: x_new = R eps + x, eps ~ N(0, scale); the global draw,
    # this part's rows of it
    if noise is None:
        noise = tuple(torch.randn((rows * n, 3), generator=generator,
                                  device=dev) for _ in range(2))
    noise = tuple(x[k * rows:(k + 1) * rows] for x in noise)
    R = quat_to_rotmat(g.get_rotation())                      # (rows,3,3)
    xyz_s1 = g.xyz + torch.einsum("nij,nj->ni", R, noise[0] * scaling_act)
    xyz_s2 = g.xyz + torch.einsum("nij,nj->ni", R, noise[1] * scaling_act)
    scaling_new = torch.log(scaling_act / (0.8 * 2))

    # this part's sources, in destination order: the clones, then each
    # placed split's two children (a split is placed whole or not at all)
    src_c = torch.nonzero(mask_c).squeeze(1)
    src_s = torch.nonzero(mask_s).squeeze(1)
    q_c = int(starts[k, 1]) + torch.arange(src_c.numel(), device=dev)
    s_glob = int(starts[k, 2]) + torch.arange(src_s.numel(), device=dev)
    placed = n_clone + 2 * s_glob + 1 < n_free
    keep_c = q_c < n_free

    def child_rows(name):
        src = getattr(g, name)
        if name == "xyz":
            a, b = xyz_s1, xyz_s2
        elif name == "scaling":
            a = b = scaling_new
        else:
            a = b = src
        sel = src_s[placed]
        return torch.cat([src[src_c[keep_c]], torch.stack(
            [a[sel], b[sel]], dim=1).reshape((-1,) + src.shape[1:])])

    payload = torch.cat([child_rows(name).reshape(-1, int(np.prod(
        getattr(g, name).shape[1:], dtype=np.int64)))
        for name in TRAINABLE_FIELDS], dim=1)
    sp = n_clone + 2 * s_glob[placed]
    q = torch.cat([q_c[keep_c], torch.stack([sp, sp + 1], 1).reshape(-1)])
    free_ends = ends[:, 0].contiguous().to(dev)
    dest = torch.searchsorted(free_ends, q, right=True)      # owner part

    # this part's free slots and the part each one's source lies on
    slots = torch.nonzero(free).squeeze(1)
    q_mine = int(starts[k, 0]) + torch.arange(slots.numel(), device=dev)
    is_c = q_mine < n_clone
    s_of = torch.div(q_mine - n_clone, 2, rounding_mode="floor")
    is_s = (~is_c & (q_mine < n_clone + 2 * n_split)
            & (n_clone + 2 * s_of + 1 < n_free))
    src_part = torch.where(
        is_c, torch.searchsorted(ends[:, 1].contiguous().to(dev), q_mine,
                                 right=True),
        torch.searchsorted(ends[:, 2].contiguous().to(dev), s_of,
                           right=True))
    src_part = torch.where(is_c | is_s, src_part, -1)

    # only the selected rows travel, each to the part that owns its slot
    dest_h, src_h = dest.cpu(), src_part.cpu()
    sends = [(parts.line[j], payload[dest == j]) for j in range(n)
             if j != k and int((dest_h == j).sum())]
    recvs = [(j, payload.new_empty((int((src_h == j).sum()),
                                    payload.shape[1])))
             for j in range(n) if j != k and int((src_h == j).sum())]
    got = exchange(sends, [(parts.line[j], like) for j, like in recvs], dev)
    incoming = dict(zip([j for j, _ in recvs], got))
    incoming[k] = payload[dest == k]
    land = torch.empty((slots.numel(), payload.shape[1]), device=dev)
    for j, rows_j in incoming.items():
        land[src_part == j] = rows_j
    filled = src_part >= 0
    dst = slots[filled]
    land = land[filled]

    # write the new rows with zeroed Adam moments, activate them, retire
    # the split originals
    new_g, mu, nu = {}, dict(adam.mu), dict(adam.nu)
    at = 0
    for name in TRAINABLE_FIELDS:
        src = getattr(g, name)
        w = int(np.prod(src.shape[1:], dtype=np.int64))
        leaf = src.clone()
        leaf[dst] = land[:, at:at + w].reshape((-1,) + src.shape[1:])
        new_g[name] = leaf
        at += w
        for m in (mu, nu):
            m[name] = m[name].clone()
            m[name][dst] = 0.0
    active = active.clone()
    active[dst] = True
    active[src_s[placed]] = False

    stats = init_stats(rows, dev)
    prune = torch.sigmoid(new_g["opacity"]) < min_opacity
    if use_screen_size_prune:
        big_vs = stats.max_radii2d > max_screen_size   # zeroed: never fires
        big_ws = torch.exp(new_g["scaling"]).amax(dim=1) > 0.1 * extent
        prune = prune | big_vs | big_ws
    g2 = dataclasses.replace(g, active=active & ~prune, **new_g)
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
