"""Tile-band rendering: the image's tile rows split into bands, each binned
and composited by itself at a fraction of the frame's pair capacity.
Counterpart of gsplat_tpu/parallel/tile_shard.py ``render_tile_sharded``.

The gaussians are shared by all bands (this axis scales pixels, not
primitives). Each band runs the standard binning on its own window of the
frame's tile rows (``tile_row_base``; the JAX package shifts the projected
means' y instead, which rounds differently within one ulp of a tile
boundary), gathers its entries (which keep their global means) and
composites them with ``tile_id_base`` set to its first tile's id in the
full grid, so that the pixel coordinates are the frame's. Tiles are
independent, so the bands' images are exactly the single render's rows.

The bands run one after another on the device the gaussians lie on; where
the JAX package all-gathers the bands' rows, ``gather_parts`` stacks the
local list. Autograd sums the bands' cotangents into the shared parameters.
The compositor needs no whole number of strips, so the JAX package's strip
rounding of the per-band capacity has no counterpart, and its ``row_cull``
branch is not ported: the port's config has no ``row_cull``.
"""
from __future__ import annotations

from typing import Optional

import torch

from gsplat_tpu_torch.config import RasterizerConfig
from gsplat_tpu_torch.core.camera import CameraView
from gsplat_tpu_torch.models.gaussian_model import GaussianParams
from gsplat_tpu_torch.ops import binning as binning_lib
from gsplat_tpu_torch.ops import preprocess as preprocess_lib
from gsplat_tpu_torch.ops.rasterize import (_tiles_to_image,
                                            composite_dispatch, pack_entries)
from gsplat_tpu_torch.parallel import gather_parts


def render_tile_sharded(gaussians: GaussianParams, cam: CameraView,
                        image_width: int, image_height: int,
                        bg_color: torch.Tensor, cfg: RasterizerConfig, *,
                        n_bands: int, antialiasing: bool = False,
                        m_cap: Optional[int] = None):
    """Render with the tile rows split into ``n_bands`` bands. Returns
    (image (3,H,W) clamped, invdepth (1,H,W), num_pairs (), overflow ()):
    the pairs summed over the bands, and the largest number any band
    dropped. ``m_cap`` is the whole frame's pair capacity; a band gets 1.5×
    its share. A scene with its pairs crowded into one band can overflow it
    while the frame's count fits: treat ``overflow > 0`` frames as garbage
    and render again with more, as on the single-render path."""
    W, H = image_width, image_height
    th, tw = cfg.tile_h, cfg.tile_w
    n_tiles_x = -(-W // tw)
    n_tiles_y = -(-H // th)
    # pad the tile grid so that its rows divide evenly over the bands
    rows_loc = -(-n_tiles_y // n_bands)
    cap = gaussians.capacity
    if m_cap is None:
        m_cap = int(cap * cfg.pairs_per_gaussian)
    m_loc = -(-int(m_cap * 1.5 / n_bands) // cfg.chunk) * cfg.chunk

    pre = preprocess_lib.preprocess(
        gaussians.xyz, gaussians.get_scaling(), gaussians.get_rotation(),
        gaussians.get_opacity(), gaussians.get_features(),
        gaussians.active_sh_degree, cam, W, H,
        active_mask=gaussians.active, antialiasing=antialiasing,
        dilation=cfg.dilation, alpha_min=cfg.alpha_min)
    packed = pack_entries(pre)                                   # (N+1,16)
    mean2d = pre.mean2d.detach()

    rows, pairs, overflow = [], [], []
    for k in range(n_bands):
        # the band's window of tile rows, at the band's capacity
        b = binning_lib.bin_gaussians(
            mean2d, pre.depth.detach(), pre.radius.detach(),
            rx=pre.rx.detach(), ry=pre.ry.detach(), image_width=W,
            image_height=rows_loc * th, tile_h=th, tile_w=tw, m_cap=m_loc,
            align=cfg.chunk, tile_row_base=k * rows_loc)
        perm_ext = torch.cat([b.perm, b.perm.new_full((1,), cap)])
        entries = packed.index_select(0, perm_ext).index_select(
            0, b.gidx_sorted)
        # the entries carry GLOBAL means: the band's first tile id puts the
        # compositor's pixels where the unshifted frame has them
        out = composite_dispatch(
            entries, b.tile_start, b.tile_count, cfg, n_tiles_x=n_tiles_x,
            n_tiles_y=rows_loc, tile_id_base=k * rows_loc * n_tiles_x)
        band = torch.cat([out.accum, out.t_final[:, None, :]], dim=1)
        rows.append(_tiles_to_image(band, rows_loc, n_tiles_x, th, tw,
                                    rows_loc * th, W))           # (5,h,W)
        pairs.append(b.num_pairs)
        overflow.append(b.overflow)

    full = gather_parts(rows)                                    # (K,5,h,W)
    full = full.permute(1, 0, 2, 3).reshape(5, n_bands * rows_loc * th, W)
    full = full[:, :H, :]
    image = torch.clamp(full[:3] + full[4:5] * bg_color[:, None, None],
                        0.0, 1.0)
    return (image, full[3:4], gather_parts(pairs).sum(),
            gather_parts(overflow).amax())
