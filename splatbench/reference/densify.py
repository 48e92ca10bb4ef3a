"""The plain reference of 3D Gaussian Splatting's adaptive density control
(the 3DGS code's ``densify_and_prune``), beside the default reference's
renderer, loss, Adam and densification statistics (``train``), for
configurations whose traffic densifies.

One event on a state held in buffers of a fixed capacity (live rows by
``active``): a splat whose mean screen-space gradient over the views that
saw it (accumulated norm over count) reaches the threshold is cloned when
its largest scale is at most ``percent_dense`` x the scene extent, and
split in two otherwise: each child at the mean plus its rotation times a
standard-normal draw scaled by its scales, with the scales over 1.6, the
original retired. New rows get zeroed Adam moments. Then every splat whose
opacity is under 0.005, and with the screen-size prune every splat whose
largest scale passes 0.1 x the extent, is pruned (the screen-space prune
reads radii the 3DGS code zeroed just before it, so it never fires), and
the statistics start again from zero.

Where the rows go is the system's documented rule (``train/densify.py``):
the free rows in row order, clones first in source order, then each split's
two children in source order; a split is placed whole or not at all, and
what finds no free row is the overflow. Nothing here imports the system
under test.
"""
from __future__ import annotations

import torch

from splatbench.reference.raster import quat_to_rotmat
from splatbench.reference.train import LEAVES, Products
# the rest of this reference's interface is the default reference's
from splatbench.reference.train import accept, render, train_steps  # noqa

MIN_OPACITY = 0.005
STATS = ("xyz_gradient_accum", "denom", "max_radii2d")


def select(rows: dict, extent: float, opt: dict):
    """(clone, split) masks of the live rows."""
    denom = rows["denom"]
    grads = rows["xyz_gradient_accum"] / denom
    grads = torch.where(denom > 0, grads, torch.zeros_like(grads))
    big = torch.exp(rows["scaling"]).max(dim=1).values > (
        opt["percent_dense"] * extent)
    hit = rows["active"] & (grads >= opt["densify_grad_threshold"])
    return hit & ~big, hit & big


def densify(rows: dict, noise, *, extent: float, opt: dict,
            screen_size_prune: bool, prod: Products):
    """One event on ``rows`` (the leaves, ``active``, ``mu.<leaf>``,
    ``nu.<leaf>`` and the statistics, each (capacity, ...)), ``noise`` the
    two (capacity, 3) standard-normal draws of a split's children by source
    row. Returns (rows after, counts: clones, splits, pruned, live,
    overflow)."""
    clone, split = select(rows, extent, opt)
    src_c = torch.nonzero(clone).squeeze(1)
    src_s = torch.nonzero(split).squeeze(1)
    free = torch.nonzero(~rows["active"]).squeeze(1)
    n_c, n_s, n_free = src_c.numel(), src_s.numel(), free.numel()
    # clone k takes free row k; split j's child c takes free row
    # n_c + 2j + c, where both of its children find one
    keep_c = torch.arange(n_c, device=free.device) < n_free
    j = torch.arange(n_s, device=free.device)
    placed = n_c + 2 * j + 1 < n_free
    src_s = src_s[placed]
    j = j[placed]
    out = {k: v.clone() for k, v in rows.items()}

    def put(dest, src, changed):
        for k in LEAVES:
            out[k][dest] = changed.get(k, rows[k][src])
            out[f"mu.{k}"][dest] = 0.0
            out[f"nu.{k}"][dest] = 0.0
        out["active"][dest] = True

    put(free[:n_c][keep_c], src_c[keep_c], {})
    scale = torch.exp(rows["scaling"][src_s])
    rot = quat_to_rotmat(rows["rotation"][src_s])
    for c in range(2):
        step = prod.mm(rot, (noise[c][src_s] * scale)[:, :, None])[:, :, 0]
        put(free[n_c + 2 * j + c], src_s,
            {"xyz": rows["xyz"][src_s] + step,
             "scaling": torch.log(scale / 1.6)})
    out["active"][src_s] = False

    prune = torch.sigmoid(out["opacity"]) < MIN_OPACITY
    if screen_size_prune:
        prune = prune | (torch.exp(out["scaling"]).max(dim=1).values
                         > 0.1 * extent)
    pruned = int((out["active"] & prune).sum())
    out["active"] = out["active"] & ~prune
    for k in STATS:
        out[k] = torch.zeros_like(rows[k])
    counts = dict(clones=int(keep_c.sum()), splits=int(placed.sum()),
                  pruned=pruned, live=int(out["active"].sum()),
                  overflow=max(n_c + 2 * n_s - n_free, 0))
    return out, counts
