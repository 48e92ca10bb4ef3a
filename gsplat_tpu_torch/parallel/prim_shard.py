"""Depth-slab rendering: the gaussians split into contiguous depth slabs,
each composited over the full tile grid, and the slabs' per-pixel partials
merged in depth order. Counterpart of gsplat_tpu/parallel/prim_shard.py
``render_prim_sharded``.

Alpha compositing is associative over depth-ordered segments:

    merge((C_a, T_a) near, (C_b, T_b) far) = (C_a + T_a·C_b, T_a·T_b)

so the slabs' (accum, t_final) combine exactly. What a slab cannot know by
itself is where a pixel's early termination falls, since it starts at local
T = 1. With ``exact_cut`` a first cut-free pass gives the transmittance
Π(1−α) of every slab but the farthest (``slab_transmittance``:
csrc/slab_tmit.cu on the card), the exclusive product over nearer slabs is
the transmittance each pixel arrives with, and the real pass hands it to
the compositor's stop test as ``t_init``.

The slabs are the parts of ``gsplat_tpu_torch.parallel``: an int K runs
them one after another on the device the gaussians lie on
(``LocalParts``); a ``RankParts(mesh, "prim")`` runs one slab per rank,
every rank preprocessing the whole (replicated) set, as JAX's mesh does.
The slabs' segments are all-gathered and merged alike on every part; the
gather's backward hands each part its own segment's cotangent, and the
packed table, which every part computes alike and differentiates with its
own slab's cotangent, sums the parts' gradients once (``sum_grad``; locally
autograd's accumulation over the K slabs is that sum): JAX's
``shard_map`` transpose of the replicated input. One sum, not two: the JAX
package's note on this render records that an extra ``_psum_grad`` doubled
the gradient. Under the config's ``row_cull`` each slab's binning culls
per tile row; the slab mask rides on ``radius`` / ``rx`` / ``ry`` and the
intervals do not depend on the slab, so the slabs together drop exactly
the single render's culled pairs.
"""
from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from gsplat_tpu_torch.config import RasterizerConfig
from gsplat_tpu_torch.core.camera import CameraView
from gsplat_tpu_torch.models.gaussian_model import GaussianParams
from gsplat_tpu_torch.ops import binning as binning_lib
from gsplat_tpu_torch.ops import preprocess as preprocess_lib
from gsplat_tpu_torch.ops.kernels.composite import slab_transmittance
from gsplat_tpu_torch.ops.preprocess import pack_entries
from gsplat_tpu_torch.ops.rasterize import (Entries, _tiles_to_image,
                                            composite_dispatch, cull_kw)
from gsplat_tpu_torch.parallel import as_parts

_BIG = 3.0e38


def _slab_bounds(depth: torch.Tensor, visible: torch.Tensor, n_slabs: int,
                 n_samples: int = 4096) -> torch.Tensor:
    """Per-frame depth-slab boundaries (n_slabs+1,) from an evenly strided
    sample of the visible depths: the sample strides over ALL visible
    depths, and the boundaries are even quantiles of the sample. The sample
    index is computed in float32, as the JAX package computes it, so both
    pick the same samples."""
    big = torch.tensor(_BIG, dtype=torch.float32, device=depth.device)
    d = torch.sort(torch.where(visible, depth, big)).values
    n_vis = torch.clamp(visible.sum(), min=1)
    idx = (torch.arange(n_samples, dtype=torch.float32, device=depth.device)
           / n_samples * n_vis.to(torch.float32)).to(torch.int32).long()
    sample = d[torch.clamp(idx, 0, depth.shape[0] - 1)]          # sorted
    q = np.arange(1, n_slabs) * n_samples // n_slabs
    inner = sample[torch.as_tensor(np.clip(q, 0, n_samples - 1),
                                   device=depth.device)]
    return torch.cat([-big[None], inner, big[None]])


def _exclusive_cumprod(t: torch.Tensor) -> torch.Tensor:
    """Along dim 0: the product of everything before each part, 1 first."""
    return torch.cumprod(torch.cat([torch.ones_like(t[:1]), t[:-1]], dim=0),
                         dim=0)


def build_slab_entries(gaussians: GaussianParams, cam: CameraView,
                       image_width: int, image_height: int,
                       cfg: RasterizerConfig, *, n_slabs,
                       antialiasing: bool = False,
                       m_cap: Optional[int] = None) -> List[Entries]:
    """Preprocess once, then bin and gather each depth slab this process
    holds by itself: one ``Entries`` per slab of ``n_slabs`` (an int K: all
    K, near to far; a ``RankParts``: this rank's one), each over the full
    tile grid at the per-slab capacity ``m_cap`` (default: the frame's over
    K)."""
    parts = as_parts(n_slabs)
    W, H = image_width, image_height
    cap = gaussians.capacity
    if m_cap is None:
        m_cap = int(cap * cfg.pairs_per_gaussian / parts.n)
    m_cap = -(-m_cap // cfg.chunk) * cfg.chunk

    pre = preprocess_lib.preprocess(
        gaussians.xyz, gaussians.get_scaling(), gaussians.get_rotation(),
        gaussians.get_opacity(), gaussians.get_features(),
        gaussians.active_sh_degree, cam, W, H,
        active_mask=gaussians.active, antialiasing=antialiasing,
        dilation=cfg.dilation, alpha_min=cfg.alpha_min)
    mean2d, depth = pre.mean2d.detach(), pre.depth.detach()
    radius, rx, ry = pre.radius.detach(), pre.rx.detach(), pre.ry.detach()
    bounds = _slab_bounds(depth, radius > 0, parts.n)
    packed = parts.sum_grad(pack_entries(pre))                   # (N+1,16)
    zero = torch.zeros_like(radius)
    cull = cull_kw(pre, cfg)

    slabs = []
    for k in parts.mine:
        # half-open [lo, hi); the last slab is closed by the +big bound
        in_slab = (depth >= bounds[k]) & (depth < bounds[k + 1])
        b = binning_lib.bin_gaussians(
            mean2d, depth, torch.where(in_slab, radius, zero),
            rx=torch.where(in_slab, rx, zero),
            ry=torch.where(in_slab, ry, zero), image_width=W,
            image_height=H, tile_h=cfg.tile_h, tile_w=cfg.tile_w,
            m_cap=m_cap, align=cfg.chunk, **cull)
        perm_ext = torch.cat([b.perm, b.perm.new_full((1,), cap)])
        entries = packed.index_select(0, perm_ext).index_select(
            0, b.gidx_sorted)
        slabs.append(Entries(pre=pre, binning=b, entries=entries,
                             n_tiles_x=-(-W // cfg.tile_w),
                             n_tiles_y=-(-H // cfg.tile_h)))
    return slabs


def arriving_transmittance(slabs: List[Entries], cfg: RasterizerConfig,
                           parts=None) -> torch.Tensor:
    """(K,T,P): the transmittance each pixel arrives with at each slab, the
    exclusive product over nearer slabs of their cut-free transmittance
    Π(1−α) (pass 1 of the exact cut), all ones at slab 0. No gradient.
    ``slabs`` are the slabs this process holds (``parts``, default: all of
    them locally).

    No slab lies behind the farthest, so its own transmittance is in no
    product and is not computed: K−1 launches of ``slab_transmittance``
    locally, none for K = 1; on ranks every rank but the last runs its own,
    and the K−1 results are gathered (one broadcast from each). The JAX
    package computes it all the same, each device its own slab's under
    ``shard_map``, where the farthest device's pass runs beside the others'
    and costs no time; here it would be pure cost on one device, and on
    ranks a message nobody reads."""
    parts = as_parts(len(slabs) if parts is None else parts)
    e0 = slabs[0]
    ones = torch.ones(
        (1, e0.n_tiles_x * e0.n_tiles_y, cfg.tile_h * cfg.tile_w),
        dtype=e0.entries.dtype, device=e0.entries.device)
    t_nocut = [
        slab_transmittance(
            e.entries.detach(), e.binning.tile_start, e.binning.tile_count,
            n_tiles_x=e.n_tiles_x, n_tiles_y=e.n_tiles_y, tile_h=cfg.tile_h,
            tile_w=cfg.tile_w, chunk=cfg.chunk, alpha_min=cfg.alpha_min,
            alpha_max=cfg.alpha_max)[None] if k < parts.n - 1 else None
        for k, e in zip(parts.mine, slabs)]
    t_nocut = parts.gather_first(t_nocut, parts.n - 1, like=ones)
    return torch.cumprod(torch.cat([ones] + t_nocut), dim=0)


def render_prim_sharded(gaussians: GaussianParams, cam: CameraView,
                        image_width: int, image_height: int,
                        bg_color: torch.Tensor, cfg: RasterizerConfig, *,
                        n_slabs, antialiasing: bool = False,
                        m_cap: Optional[int] = None,
                        exact_cut: bool = True):
    """Render with the gaussians split into ``n_slabs`` depth slabs (an int
    K: all K in this process; a ``RankParts``: one per rank, every rank
    holding the whole set and returning the whole frame).

    Returns (image (3,H,W) clamped, invdepth (1,H,W), overflow ()).
    ``overflow`` is the largest number of pairs any slab dropped: slabs can
    be load-imbalanced against the per-slab ``m_cap``, and a truncated
    slab's image is garbage by the binning contract, so callers check it and
    grow the capacity as on the single-render path. ``m_cap`` is the
    capacity of ONE slab's pair list (default: the frame's over n_slabs).

    With ``exact_cut`` the early termination matches the single render to
    the cut's own magnitude, at the price of one cut-free transmittance pass
    per slab; without it each slab stops as if nothing lay in front of it,
    which differs by up to ~1e-2 on nearly saturated pixels. The merge is
    exact either way.
    """
    parts = as_parts(n_slabs)
    W, H = image_width, image_height
    th, tw = cfg.tile_h, cfg.tile_w
    slabs = build_slab_entries(gaussians, cam, W, H, cfg, n_slabs=parts,
                               antialiasing=antialiasing, m_cap=m_cap)
    n_tiles_x, n_tiles_y = slabs[0].n_tiles_x, slabs[0].n_tiles_y
    # pass 1: what each pixel arrives with; pass 2: the real composite, its
    # stop test scaled by it
    t_arrive = (arriving_transmittance(slabs, cfg, parts) if exact_cut
                else [None] * parts.n)
    outs = [composite_dispatch(e.entries, e.binning.tile_start,
                               e.binning.tile_count, cfg,
                               n_tiles_x=n_tiles_x, n_tiles_y=n_tiles_y,
                               t_init=t_arrive[k])
            for k, e in zip(parts.mine, slabs)]
    # ordered segment merge, near to far
    seg_a = parts.gather([o.accum for o in outs])                # (K,T,4,P)
    seg_t = parts.gather([o.t_final for o in outs])              # (K,T,P)
    t_excl = _exclusive_cumprod(seg_t)
    accum = torch.sum(seg_a * t_excl[:, :, None, :], dim=0)      # (T,4,P)
    t_final = t_excl[-1] * seg_t[-1]                             # (T,P)
    overflow = parts.pmax_value([e.binning.overflow for e in slabs])

    accum_img = _tiles_to_image(accum, n_tiles_y, n_tiles_x, th, tw, H, W)
    t_img = _tiles_to_image(t_final[:, None, :], n_tiles_y, n_tiles_x, th,
                            tw, H, W)[0]
    image = accum_img[:3] + t_img[None] * bg_color[:, None, None]
    return torch.clamp(image, 0.0, 1.0), accum_img[3:4], overflow
