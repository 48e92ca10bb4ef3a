"""The render pipeline: preprocess → bin → entry gather → tile compositor →
tiles to image, background, exposure, clamp. Counterpart of
gsplat_tpu/ops/rasterize.py ``render``.

Everything runs on the device the gaussians lie on, and the whole path is
differentiable on either: on the CPU the compositor is the plain PyTorch
version under autograd; on the card it is the hand-written CUDA forward
kernel, whose gradient is the CUDA backward kernel. The entry gather
(``build_entries``) is the plain ``index_select`` chain on the CPU, whose
gradient is ``index_add_``, and on the card the kernel pair of
ops/kernels/gather.py, whose backward sums each gaussian's entry rows into
its packed row without atomics, in the order of its pairs that the
binning's slot tables give, the same on every run. The other form of
that gradient, which gaussian-sharded storage uses (parallel/sharded.py),
is the difference of two blocked prefix sums of the entry gradients in
presort order (``masked_presort_prefix``, ``_prefix_between``;
csrc/scan.cu on the card).
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from gsplat_tpu_torch.config import RasterizerConfig
from gsplat_tpu_torch.core.camera import CameraView
from gsplat_tpu_torch.models.gaussian_model import GaussianParams
from gsplat_tpu_torch.ops import binning as binning_lib
from gsplat_tpu_torch.ops import preprocess as preprocess_lib
from gsplat_tpu_torch.ops.composite_ref import CompositeOut
from gsplat_tpu_torch.ops.kernels.composite import composite_tiles
from gsplat_tpu_torch.ops.kernels.gather import (gather_entries_cuda,
                                                 gather_entries_plain)
from gsplat_tpu_torch.ops.kernels.scan import blocked_cumsum_16
from gsplat_tpu_torch.utils.general import full_f32_matmul


class RenderOutput(NamedTuple):
    image: torch.Tensor       # (3, H, W) clamped to [0,1]
    invdepth: torch.Tensor    # (1, H, W)
    radii: torch.Tensor       # (N,) float; 0 = invisible
    num_pairs: torch.Tensor   # () binning load
    overflow: torch.Tensor    # () dropped pairs (must be 0)
    num_padded: torch.Tensor  # () extent of the chunk-padded layout


class Entries(NamedTuple):
    """What the compositor consumes for one frame, and how it was made."""
    pre: preprocess_lib.Preprocessed
    binning: binning_lib.Binning
    entries: torch.Tensor     # (m_cap + pad_cap, 16) packed rows
    n_tiles_x: int
    n_tiles_y: int


PREFIX_BLOCK = 4096   # rows per block of the two-level prefix sums


def _blocked_prefix(d_presort: torch.Tensor, m_cap: int):
    """Two-level (blocked) prefix sums of the presort-ordered (m_cap,16)
    gradient rows: inclusive sums restarting every 4096 rows (csrc/scan.cu
    on the card) and the exclusive sums of the blocks' totals. A gaussian's
    gradient is the difference of two prefix values (``_prefix_at``), so it
    carries f32 error that grows with one block and the chain of blocks, not
    with a running sum over millions of rows, whose size would swamp a
    gaussian with few entries. Returns (intra, block_pre, L)."""
    L = PREFIX_BLOCK
    pad_rows = -(-m_cap // L) * L - m_cap
    d_pad = torch.cat([d_presort, d_presort.new_zeros((pad_rows, 16))])
    intra, block_tot = blocked_cumsum_16(d_pad, L)
    block_pre = torch.cumsum(block_tot, dim=0) - block_tot
    return intra, block_pre, L


def _prefix_levels(intra: torch.Tensor, block_pre: torch.Tensor, L: int,
                   bnd: torch.Tensor):
    """The two levels of cs(j), the sum of the first j presort rows, at the
    positions ``bnd`` (any int64 tensor): (the sum within j's block, the sum
    of the blocks before it), each (..., 16) and 0 at j = 0."""
    jm1 = torch.clamp(bnd - 1, min=0)
    live = (bnd > 0)[..., None]
    return (torch.where(live, intra[jm1], 0.0),
            torch.where(live, block_pre[jm1 // L], 0.0))


def _prefix_at(intra: torch.Tensor, block_pre: torch.Tensor, L: int,
               bnd: torch.Tensor) -> torch.Tensor:
    """cs(j) at the positions ``bnd``, from the blocked representation."""
    within, before = _prefix_levels(intra, block_pre, L, bnd)
    return within + before


def _prefix_between(intra: torch.Tensor, block_pre: torch.Tensor, L: int,
                    lo: torch.Tensor, hi: torch.Tensor) -> torch.Tensor:
    """cs(hi) − cs(lo), the sum of the presort rows [lo, hi), with the two
    levels differenced apart. The JAX package subtracts two ``_prefix_at``
    values, each rounded at the size of the running sum over all earlier
    blocks; here a range that lies in one block (nearly all do) takes its
    block term as an exact 0 and carries the rounding of one block only."""
    within_hi, before_hi = _prefix_levels(intra, block_pre, L, hi)
    within_lo, before_lo = _prefix_levels(intra, block_pre, L, lo)
    return (within_hi - within_lo) + (before_hi - before_lo)


def masked_presort_prefix(d_aligned: torch.Tensor, inv_src: torch.Tensor,
                          total: torch.Tensor, m_cap: int):
    """``_blocked_prefix`` of the gradient rows brought into presort order,
    with the rows at and past ``total`` zeroed first. Those rows come from
    dead ``inv_src`` slots, which point at rows of ``d_aligned`` no tile
    owns; whatever lies there must reach neither a prefix nor the totals of
    the block that holds ``total``."""
    d_presort = d_aligned.index_select(0, inv_src)               # (m_cap,16)
    live = torch.arange(m_cap, device=d_aligned.device) < total
    return _blocked_prefix(torch.where(live[:, None], d_presort, 0.0), m_cap)


def masked_presort_prefix_slabs(d_aligned: torch.Tensor,
                                inv_src: torch.Tensor,
                                slab_totals: torch.Tensor, m_slab: int,
                                m_cap: int):
    """``masked_presort_prefix`` for the slab-streamed presort layout
    (ops/binning.py ``merge_slab_binning``): slab s owns presort rows
    [s·m_slab, (s+1)·m_slab), of which only the first ``slab_totals[s]``
    are real; every slab's dead tail is zeroed."""
    d_presort = d_aligned.index_select(0, inv_src)               # (m_cap,16)
    pos = torch.arange(m_cap, device=d_aligned.device)
    s = pos // m_slab
    live = (pos - s * m_slab) < slab_totals[s]
    return _blocked_prefix(torch.where(live[:, None], d_presort, 0.0), m_cap)


def composite_dispatch(entries, tile_start, tile_count,
                       cfg: RasterizerConfig, *, n_tiles_x: int,
                       n_tiles_y: int, tile_id_base: int = 0,
                       t_init: Optional[torch.Tensor] = None) -> CompositeOut:
    """The compositor for the device the entries lie on (see
    ops/kernels/composite.py), with the constants from ``cfg``. ``t_init``
    (T,P): transmittance arriving from nearer depth slabs, scaling the
    early-out test only (parallel/prim_shard.py); ``tile_id_base``: the
    full-grid id of tile 0 (parallel/tile_shard.py)."""
    return composite_tiles(
        entries, tile_start, tile_count, n_tiles_x=n_tiles_x,
        n_tiles_y=n_tiles_y, tile_h=cfg.tile_h, tile_w=cfg.tile_w,
        chunk=cfg.chunk, alpha_min=cfg.alpha_min, alpha_max=cfg.alpha_max,
        t_eps=cfg.transmittance_eps, t_init=t_init,
        tile_id_base=tile_id_base)


def _tiles_to_image(tiles: torch.Tensor, n_tiles_y: int, n_tiles_x: int,
                    tile_h: int, tile_w: int, H: int, W: int) -> torch.Tensor:
    """(T, C, P) tile-flat → (C, H, W) cropped image."""
    C = tiles.shape[1]
    img = tiles.reshape(n_tiles_y, n_tiles_x, C, tile_h, tile_w)
    img = img.permute(2, 0, 3, 1, 4).reshape(C, n_tiles_y * tile_h,
                                             n_tiles_x * tile_w)
    return img[:, :H, :W]


def cull_kw(pre: preprocess_lib.Preprocessed,
            cfg: RasterizerConfig) -> dict:
    """The binning's row-cull arguments under ``cfg.row_cull``: the
    conics and level-set thresholds (no gradient), else none."""
    if not cfg.row_cull:
        return {}
    return dict(conic=pre.conic.detach(), t_cut=pre.t_cut.detach(),
                row_slots=cfg.row_slots)


def build_entries(gaussians: GaussianParams, cam: CameraView,
                  image_width: int, image_height: int,
                  cfg: RasterizerConfig = RasterizerConfig(), *,
                  scaling_modifier: float = 1.0, antialiasing: bool = False,
                  mean2d_tap: Optional[torch.Tensor] = None,
                  override_color: Optional[torch.Tensor] = None,
                  cov3d_precomp: Optional[torch.Tensor] = None,
                  m_cap: Optional[int] = None) -> Entries:
    """Preprocess, bin and gather: the compositor's input for one frame."""
    W, H = image_width, image_height
    n_tiles_x = -(-W // cfg.tile_w)
    n_tiles_y = -(-H // cfg.tile_h)
    cap = gaussians.capacity
    if m_cap is None:
        m_cap = int(cap * cfg.pairs_per_gaussian)
    m_cap = -(-m_cap // cfg.chunk) * cfg.chunk

    # the tap's screen-space gradient, scaled like the reference's mean2D
    # gradients, feeds densification
    pre, packed = preprocess_lib.preprocess_packed(
        gaussians, cam, W, H, scaling_modifier=scaling_modifier,
        antialiasing=antialiasing, dilation=cfg.dilation,
        alpha_min=cfg.alpha_min, mean2d_tap=mean2d_tap,
        cov3d_precomp=cov3d_precomp, colors_precomp=override_color)

    # the card's gather kernel pair takes the packed rows' gradient from
    # the binning's slot tables
    on_card = packed.device.type == "cuda"
    b = binning_lib.bin_gaussians(
        pre.mean2d.detach(), pre.depth.detach(), pre.radius.detach(),
        rx=pre.rx.detach(), ry=pre.ry.detach(), image_width=W,
        image_height=H, tile_h=cfg.tile_h, tile_w=cfg.tile_w, m_cap=m_cap,
        align=cfg.chunk, pad_cap=None if cfg.pad_cap < 0 else cfg.pad_cap,
        slot_tables=on_card and packed.requires_grad, **cull_kw(pre, cfg))
    # the packed rows in the binning's depth order, slot by slot; a dead
    # slot takes the zero row N
    if on_card:
        entries = gather_entries_cuda(packed, b)
    else:
        entries = gather_entries_plain(packed, b.perm, b.gidx_sorted)
    return Entries(pre=pre, binning=b, entries=entries,
                   n_tiles_x=n_tiles_x, n_tiles_y=n_tiles_y)


def render(gaussians: GaussianParams,
           cam: CameraView,
           image_width: int,
           image_height: int,
           bg_color: torch.Tensor,                     # (3,)
           cfg: RasterizerConfig = RasterizerConfig(),
           *,
           scaling_modifier: float = 1.0,
           antialiasing: bool = False,
           mean2d_tap: Optional[torch.Tensor] = None,  # (CAP,2) zeros tap
           exposure: Optional[torch.Tensor] = None,    # (3,4) affine
           override_color: Optional[torch.Tensor] = None,
           cov3d_precomp: Optional[torch.Tensor] = None,
           m_cap: Optional[int] = None,
           clamp: bool = True) -> RenderOutput:
    """Render one camera view on the device the gaussians lie on: clamped
    image, invdepth image, radii, binning diagnostics. The exposure affine
    is applied before the clamp."""
    full_f32_matmul()      # the exposure product is held to JAX's HIGHEST
    W, H = image_width, image_height
    th, tw = cfg.tile_h, cfg.tile_w
    e = build_entries(gaussians, cam, W, H, cfg,
                      scaling_modifier=scaling_modifier,
                      antialiasing=antialiasing, mean2d_tap=mean2d_tap,
                      override_color=override_color,
                      cov3d_precomp=cov3d_precomp, m_cap=m_cap)
    b = e.binning
    out = composite_dispatch(e.entries, b.tile_start, b.tile_count, cfg,
                             n_tiles_x=e.n_tiles_x, n_tiles_y=e.n_tiles_y)

    accum_img = _tiles_to_image(out.accum, e.n_tiles_y, e.n_tiles_x, th, tw,
                                H, W)
    t_img = _tiles_to_image(out.t_final[:, None, :], e.n_tiles_y,
                            e.n_tiles_x, th, tw, H, W)[0]
    image = accum_img[:3] + t_img[None] * bg_color[:, None, None]
    invdepth = accum_img[3:4]
    if exposure is not None:
        image = torch.einsum("chw,ck->khw", image, exposure[:3, :3]) \
            + exposure[:3, 3, None, None]
    if clamp:
        image = torch.clamp(image, 0.0, 1.0)
    return RenderOutput(image=image, invdepth=invdepth, radii=e.pre.radius,
                        num_pairs=b.num_pairs, overflow=b.overflow,
                        num_padded=b.num_padded)
