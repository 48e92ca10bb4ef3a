"""Naive per-pixel whole-image compositor: an independent second oracle.
Counterpart of gsplat_tpu/ops/naive.py.

Composites every gaussian against every pixel (O(N·H·W)) with the alpha and
termination rules of the tile pipeline, including the tile-rect coverage cut
(a gaussian touches only pixels whose tile lies in its radius rect, the
support binning gives it). It shares no code with binning or the tile
compositors beyond ``tile_rect``, so it can hold them, and the slab and
band renders built on them, on tiny scenes. Never used in training.
"""
from __future__ import annotations

import torch

from gsplat_tpu_torch.ops.binning import tile_rect
from gsplat_tpu_torch.ops.preprocess import Preprocessed


def composite_naive(pre: Preprocessed, *, image_width: int, image_height: int,
                    tile_h: int, tile_w: int, alpha_min: float = 1.0 / 255.0,
                    alpha_max: float = 0.99, t_eps: float = 1e-4):
    """Returns (accum (4,H,W) before the background, t_final (H,W)).
    Differentiable by autograd; the termination masks act as
    stop-gradients."""
    H, W = image_height, image_width
    dev = pre.mean2d.device
    n_tiles_x = -(-W // tile_w)
    n_tiles_y = -(-H // tile_h)

    order = torch.sort(pre.depth.detach(), stable=True).indices
    mean2d = pre.mean2d[order]
    conic = pre.conic[order]
    color = torch.cat([pre.color, pre.invdepth[:, None]], dim=-1)[order]
    opacity = pre.opacity[order]
    radius = pre.radius[order].detach()
    x0, y0, x1, y1 = tile_rect(mean2d.detach(), radius, radius, n_tiles_x,
                               n_tiles_y, tile_h, tile_w)

    px = torch.arange(W, dtype=torch.float32, device=dev)[None, :].repeat(H, 1)
    py = torch.arange(H, dtype=torch.float32, device=dev)[:, None].repeat(1, W)
    ptx = (px / tile_w).long()
    pty = (py / tile_h).long()

    accum = torch.zeros((4, H, W), dtype=torch.float32, device=dev)
    t = torch.ones((H, W), dtype=torch.float32, device=dev)
    done = torch.zeros((H, W), dtype=torch.bool, device=dev)
    for g in torch.nonzero(radius > 0).squeeze(1).tolist():
        in_rect = ((ptx >= x0[g]) & (ptx < x1[g])
                   & (pty >= y0[g]) & (pty < y1[g]))
        dx = px - mean2d[g, 0]
        dy = py - mean2d[g, 1]
        power = (-0.5 * (conic[g, 0] * dx * dx + conic[g, 2] * dy * dy)
                 - conic[g, 1] * dx * dy)
        alpha = torch.clamp(
            opacity[g] * torch.exp(torch.clamp(power, max=0.0)),
            max=alpha_max)
        zero = torch.zeros_like(alpha)
        a = torch.where(in_rect & (alpha >= alpha_min) & (power <= 0.0),
                        alpha, zero)
        cross = (a > 0) & (t * (1.0 - a) < t_eps)
        a = torch.where((a > 0) & ~cross & ~done, a, zero)
        accum = accum + (t * a)[None] * color[g][:, None, None]
        t = t * (1.0 - a)
        done = done | cross
    return accum, t
