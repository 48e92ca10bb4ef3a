"""Gaussian-sharded storage with tile-row-sharded rendering and training.
Counterpart of gsplat_tpu/parallel/sharded.py (``make_sharded_render``,
``make_sharded_train_step``, ``shard_state``).

- **Storage shards.** Every per-gaussian tensor (parameters, Adam moments,
  densification statistics, the preprocess outputs) is split into D row
  shards of CAP/D rows; shard k owns rows [k·CAP/D, (k+1)·CAP/D).
- **Compute shards.** The image's tile rows are split over the same D
  shards. Each shard preprocesses its OWN rows, then bins and composites
  ONLY its band of tile rows, so the stages that scale with the pair count
  run at about 1/D size. The standard binning runs on the band's window
  of the frame's tile grid (``tile_row_base``; the JAX package shifts
  ``mean2d.y`` by the band's origin instead, which rounds differently
  within one ulp of a tile boundary); the entries keep their global means
  and the compositor gets the band's first tile id.
- **What a shard gathers** is the ``transient``: ``"replicated"`` gathers
  the (N,6) binning geometry and the (N,16) packed rows of all shards;
  ``"ring"`` gathers the geometry but streams the packed rows slab by slab
  around the ring, taking from each owner's (N/D,16) slab the rows its
  entries name, and never holds an (N,16) table; ``"slab"`` streams the
  geometry too: each arriving slab is expanded by itself and one merged
  sort gives the global order (ops/binning.py ``merge_slab_binning``), so
  nothing N-sized is made but the per-slab offset and count tables.
- **Exactness.** Tiles are independent in the compositor, so every tile's
  result, its early stop included, is the single render's.
- **Backward.** The gradient of the ring gather is the prefix-difference
  form: the entry gradients are brought into presort (gaussian-major)
  order, scanned once per shard (``masked_presort_prefix``: csrc/scan.cu on
  the card), and an owner's rows are the differences of the prefix at its
  gaussians' boundaries, which compose with a ring where a duplicate-index
  scatter would not. The D partial gradients of a shard travel to their
  owners; the owners' sums are the reduce-scatter.

The D shards run one after another on the device the gaussians lie on,
each with the arithmetic of one chip of the JAX mesh. Where the mesh runs a
collective stands a helper of ``gsplat_tpu_torch.parallel``:
``gather_parts`` (all-gather), ``ring_arrival`` (the slab a shard holds at
ring step s) and ``reduce_scatter_parts`` (the partial gradients sent to
their owners, which autograd sums over the shards). Not ported: the camera
data-parallel form of the step and the ``row_cull`` branches (the port's
config has no ``row_cull``).
"""
from __future__ import annotations

from typing import Dict, List, NamedTuple, Optional

import torch

from gsplat_tpu_torch.config import OptimizationConfig, RasterizerConfig
from gsplat_tpu_torch.core.camera import CameraView
from gsplat_tpu_torch.core.schedules import expon_lr
from gsplat_tpu_torch.models import gaussian_model as gm
from gsplat_tpu_torch.ops import binning as binning_lib
from gsplat_tpu_torch.ops import losses
from gsplat_tpu_torch.ops import preprocess as preprocess_lib
from gsplat_tpu_torch.ops.rasterize import (_prefix_between, _tiles_to_image,
                                            composite_dispatch,
                                            masked_presort_prefix,
                                            masked_presort_prefix_slabs,
                                            pack_rows)
from gsplat_tpu_torch.parallel import (gather_parts, reduce_scatter_parts,
                                       ring_arrival)
from gsplat_tpu_torch.train import densify as densify_lib
from gsplat_tpu_torch.train import trainer
from gsplat_tpu_torch.utils.general import full_f32_matmul

TRANSIENTS = ("replicated", "ring", "slab")


def shard_rows(x: torch.Tensor, n_shards: int) -> List[torch.Tensor]:
    """The D row shards of a per-gaussian tensor, as views."""
    return list(torch.chunk(x, n_shards, dim=0))


def shard_state(state: "trainer.TrainState", n_shards: int
                ) -> "trainer.TrainState":
    """Check that a TrainState splits into ``n_shards`` row shards (the
    capacity must divide evenly). On one device the shards are the row
    ranges of the whole tensors, so the state itself is returned; exposure,
    schedules and scalars belong to every shard."""
    cap = state.gaussians.capacity
    if cap % n_shards:
        raise ValueError(f"capacity {cap} not divisible by {n_shards} shards")
    return state


def _ring_gather(slabs, idx: torch.Tensor, k: int) -> torch.Tensor:
    """entries[e] = packed_global[idx[e]] for shard k, from the D owners'
    (N/D,16) slabs as they arrive around the ring; ids outside every slab
    (the sentinel) give the zero row."""
    rows = slabs[0].shape[0]
    ent = slabs[0].new_zeros((idx.shape[0], slabs[0].shape[1]))
    for s in range(len(slabs)):
        owner = (k - s) % len(slabs)
        slab = ring_arrival(slabs, k, s)
        rel = idx - owner * rows
        inb = (rel >= 0) & (rel < rows)
        ent = ent + torch.where(
            inb[:, None], slab.index_select(0, torch.where(inb, rel, 0)), 0.0)
    return ent


class _RingGatherEntries(torch.autograd.Function):
    """The ring gather of shard ``k`` with the prefix-difference backward.

    idx (m_out,): global STORAGE row of every aligned entry (the binning's
    depth permutation composed in); rank_inv (N,): storage row -> depth
    position; inv_src, g_offsets, g_counts: the binning's presort tables,
    in depth order. The D slabs are D inputs, and the backward returns D
    partial gradients, one per owner."""

    @staticmethod
    def forward(ctx, idx, inv_src, g_offsets, g_counts, rank_inv, k, m_cap,
                *slabs):
        ctx.save_for_backward(inv_src, g_offsets, g_counts, rank_inv)
        ctx.k, ctx.m_cap, ctx.n = k, m_cap, len(slabs)
        ctx.rows = slabs[0].shape[0]
        return _ring_gather(slabs, idx, k)

    @staticmethod
    def backward(ctx, d_aligned):
        inv_src, g_offsets, g_counts, rank_inv = ctx.saved_tensors
        m_cap, rows = ctx.m_cap, ctx.rows
        total = torch.clamp(g_offsets[-1] + g_counts[-1], 0, m_cap)
        intra, block_pre, L = masked_presort_prefix(d_aligned, inv_src,
                                                    total, m_cap)
        bnd = torch.clamp(torch.cat([g_offsets, total[None]]), 0, m_cap)

        def partial_for(owner):
            # this shard's gradient contribution to the owner's rows
            dpos = rank_inv[owner * rows:(owner + 1) * rows]
            return _prefix_between(intra, block_pre, L, bnd[dpos],
                                   bnd[dpos + 1])            # (rows, 16)

        return (None,) * 7 + tuple(
            reduce_scatter_parts(partial_for, ctx.k, ctx.n))


class _RingGatherEntriesSlab(torch.autograd.Function):
    """``_RingGatherEntries`` for the slab-streamed binning layout: there is
    no depth permutation, so the per-gaussian tables come as per-slab
    stacks, in OWNER order: g_offsets / g_counts are (D·rows,) with owner
    o's slab at rows [o·rows, (o+1)·rows), which are its storage rows;
    offsets are absolute into the concatenated presort layout, and
    ``slab_totals`` (D,) marks each slab's dead tail."""

    @staticmethod
    def forward(ctx, idx, inv_src, g_offsets, g_counts, slab_totals, k,
                m_slab, *slabs):
        ctx.save_for_backward(inv_src, g_offsets, g_counts, slab_totals)
        ctx.k, ctx.m_slab, ctx.n = k, m_slab, len(slabs)
        ctx.rows = slabs[0].shape[0]
        return _ring_gather(slabs, idx, k)

    @staticmethod
    def backward(ctx, d_aligned):
        inv_src, g_offsets, g_counts, slab_totals = ctx.saved_tensors
        n, rows = ctx.n, ctx.rows
        m_cap = n * ctx.m_slab
        intra, block_pre, L = masked_presort_prefix_slabs(
            d_aligned, inv_src, slab_totals, ctx.m_slab, m_cap)
        off2 = g_offsets.reshape(n, rows)
        cnt2 = g_counts.reshape(n, rows)

        def partial_for(owner):
            start, cnt = off2[owner], cnt2[owner]
            return _prefix_between(
                intra, block_pre, L, torch.clamp(start, 0, m_cap),
                torch.clamp(start + cnt, 0, m_cap))          # (rows, 16)

        return (None,) * 7 + tuple(
            reduce_scatter_parts(partial_for, ctx.k, n))


def _render_shard_slab(k: int, packed, geom, *, W: int, rows_loc: int,
                       cfg: RasterizerConfig, m_cap_loc: int):
    """Shard k's entries with BOTH streams (transient="slab"): each owner's
    geometry slab, as it arrives around the ring, is expanded into (tile,
    depth bits) entries at m_cap_loc/D; one merged sort reproduces the
    global order, and the packed rows stream through a second ring
    (``_RingGatherEntriesSlab``). Per-slab capacities overflow
    independently (reported in the binning's ``overflow``).

    An arriving slab is placed at its OWNER's slot of the concatenated
    presort layout, not at its arrival step's: the merged sort keeps
    entries of equal (tile, depth) in the layout's order, so equal depths
    then fall in storage-row order on every shard, which is the order the
    single render's stable depth sort gives them (the JAX package places by
    arrival, and its bands order such ties each their own way)."""
    th, tw = cfg.tile_h, cfg.tile_w
    n_dev = len(packed)
    rows = packed[0].shape[0]
    cap_total = n_dev * rows
    m_slab = max(-(-(m_cap_loc // n_dev) // cfg.chunk) * cfg.chunk, cfg.chunk)
    kw = dict(image_width=W, image_height=rows_loc * th, tile_h=th,
              tile_w=tw)

    slabs = [None] * n_dev
    for s in range(n_dev):
        owner = (k - s) % n_dev
        g = ring_arrival(geom, k, s)
        slabs[owner] = binning_lib.expand_slab(
            g[:, :2], g[:, 2], g[:, 3], g[:, 4], g[:, 5],
            row_base=owner * rows, slab_base_entry=owner * m_slab,
            sentinel_row=cap_total, m_slab=m_slab,
            tile_row_base=k * rows_loc, **kw)
    b = binning_lib.merge_slab_binning(slabs, sentinel_row=cap_total,
                                       align=cfg.chunk, **kw)
    slab_totals = torch.stack([torch.clamp(sl.total, max=m_slab)
                               for sl in slabs])
    entries = _RingGatherEntriesSlab.apply(
        b.gidx_sorted, b.inv_src, b.g_offsets, b.g_counts, slab_totals, k,
        m_slab, *packed)
    return b, entries


def _render_shard(k: int, packed, geom_all: torch.Tensor,
                  packed_ext: Optional[torch.Tensor], *, W: int,
                  rows_loc: int, cfg: RasterizerConfig, m_cap_loc: int):
    """Shard k's entries from the gathered (N,6) geometry: the standard
    binning on the band's window, then the entry gather from the gathered
    packed table (transient="replicated": ``packed_ext`` (N+1,16), the zero
    row last) or around the ring (transient="ring")."""
    th, tw = cfg.tile_h, cfg.tile_w
    cap_total = geom_all.shape[0]
    ring = packed_ext is None
    b = binning_lib.bin_gaussians(
        geom_all[:, :2], geom_all[:, 2], geom_all[:, 3], rx=geom_all[:, 4],
        ry=geom_all[:, 5], image_width=W, image_height=rows_loc * th,
        tile_h=th, tile_w=tw, m_cap=m_cap_loc, align=cfg.chunk,
        presort_tables=ring, tile_row_base=k * rows_loc)
    perm_ext = torch.cat([b.perm, b.perm.new_full((1,), cap_total)])
    if not ring:
        entries = packed_ext.index_select(0, perm_ext).index_select(
            0, b.gidx_sorted)
        return b, entries
    # the depth permutation folds into the global row ids; the sentinel id
    # cap_total lies outside every slab and gives the zero row
    rank_inv = torch.empty_like(b.perm)
    rank_inv[b.perm] = torch.arange(cap_total, device=b.perm.device)
    idx = perm_ext[b.gidx_sorted]
    entries = _RingGatherEntries.apply(
        idx, b.inv_src, b.g_offsets, b.g_counts, rank_inv, k, m_cap_loc,
        *packed)
    return b, entries


class _Bands(NamedTuple):
    full: torch.Tensor        # (5, H, W): rgb and invdepth accum, t_final
    radii: torch.Tensor       # (CAP,)
    num_pairs: torch.Tensor   # () summed over the shards
    overflow: torch.Tensor    # () the largest of any shard
    num_padded: torch.Tensor  # () the largest of any shard


def _render_bands(shards: List[Dict[str, torch.Tensor]],
                  active: List[torch.Tensor], sh_degree: int,
                  taps: Optional[List[torch.Tensor]], cam: CameraView, *,
                  W: int, H: int, cfg: RasterizerConfig, m_cap_loc: int,
                  antialiasing: bool, transient: str,
                  scaling_modifier: float = 1.0) -> _Bands:
    """Every shard's part of one frame: preprocess of its own rows, the
    gathers of the ``transient``, binning and compositing of its band of
    tile rows; then the bands gathered into the frame."""
    if transient not in TRANSIENTS:
        raise ValueError(f"transient must be one of {TRANSIENTS}, got "
                         f"{transient!r}")
    n_dev = len(shards)
    th, tw = cfg.tile_h, cfg.tile_w
    n_tiles_x = -(-W // tw)
    n_tiles_y = -(-H // th)
    rows_loc = -(-n_tiles_y // n_dev)       # the grid padded to D x rows_loc

    pres, packed, geom = [], [], []
    for o in range(n_dev):
        g_loc = gm.GaussianParams(active_sh_degree=sh_degree,
                                  active=active[o], **shards[o])
        pre = preprocess_lib.preprocess(
            g_loc.xyz, g_loc.get_scaling(), g_loc.get_rotation(),
            g_loc.get_opacity(), g_loc.get_features(), sh_degree, cam, W, H,
            active_mask=active[o], scaling_modifier=scaling_modifier,
            antialiasing=antialiasing, dilation=cfg.dilation,
            alpha_min=cfg.alpha_min)
        if taps is not None:
            scale = torch.tensor([[0.5 * W, 0.5 * H]], dtype=torch.float32,
                                 device=taps[o].device)
            pre = pre._replace(mean2d=pre.mean2d + taps[o] * scale)
        pres.append(pre)
        packed.append(pack_rows(pre))                        # (cap/D, 16)
        geom.append(torch.stack(
            [pre.mean2d[:, 0], pre.mean2d[:, 1], pre.depth, pre.radius,
             pre.rx, pre.ry], dim=-1).detach())              # (cap/D, 6)

    kw = dict(W=W, rows_loc=rows_loc, cfg=cfg, m_cap_loc=m_cap_loc)
    geom_all = packed_ext = None
    if transient != "slab":
        geom_all = gather_parts(geom).reshape(-1, 6)         # (N, 6)
    if transient == "replicated":
        packed_all = gather_parts(packed).reshape(-1, 16)    # (N, 16)
        packed_ext = torch.cat([packed_all, packed_all.new_zeros((1, 16))])

    bands, pairs, overflow, padded = [], [], [], []
    for k in range(n_dev):
        if transient == "slab":
            b, entries = _render_shard_slab(k, packed, geom, **kw)
        else:
            b, entries = _render_shard(k, packed, geom_all, packed_ext, **kw)
        # the entries carry GLOBAL means: the band's first tile id puts the
        # compositor's pixels where the frame has them
        out = composite_dispatch(
            entries, b.tile_start, b.tile_count, cfg, n_tiles_x=n_tiles_x,
            n_tiles_y=rows_loc, tile_id_base=k * rows_loc * n_tiles_x)
        band = torch.cat([out.accum, out.t_final[:, None, :]], dim=1)
        bands.append(_tiles_to_image(band, rows_loc, n_tiles_x, th, tw,
                                     rows_loc * th, W))      # (5, h_loc, W)
        pairs.append(b.num_pairs)
        overflow.append(b.overflow)
        padded.append(b.num_padded)

    full = gather_parts(bands)                               # (D,5,h_loc,W)
    full = full.permute(1, 0, 2, 3).reshape(5, n_dev * rows_loc * th, W)
    return _Bands(full=full[:, :H, :],
                  radii=gather_parts([p.radius for p in pres]).reshape(-1),
                  num_pairs=gather_parts(pairs).sum(),
                  overflow=gather_parts(overflow).amax(),
                  num_padded=gather_parts(padded).amax())


def shard_capacity(capacity: int, cfg: RasterizerConfig, n_shards: int,
                   m_cap_total: Optional[int] = None) -> int:
    """A shard's pair capacity: 1/D of the frame's with a 1.5x margin for
    imbalance between the bands, rounded up to whole chunks."""
    if m_cap_total is None:
        m_cap_total = int(capacity * cfg.pairs_per_gaussian)
    return -(-int(m_cap_total * 1.5 / n_shards) // cfg.chunk) * cfg.chunk


class ShardedRenderOut(NamedTuple):
    image: torch.Tensor       # (3,H,W)
    invdepth: torch.Tensor    # (1,H,W)
    radii: torch.Tensor       # (CAP,), shard k's rows at [k·CAP/D, ...)
    num_pairs: torch.Tensor   # () total over the shards
    overflow: torch.Tensor    # () the largest of any shard


def make_sharded_render(n_shards: int, *, image_width: int,
                        image_height: int, cfg: RasterizerConfig,
                        antialiasing: bool = False,
                        m_cap_total: Optional[int] = None,
                        transient: str = "replicated"):
    """Build fn(gaussians, cam, bg) -> ShardedRenderOut, on the device the
    gaussians lie on. The capacity must divide by ``n_shards``. A frame
    with ``overflow > 0`` is garbage by the binning contract: grow
    ``m_cap_total`` and render again."""
    W, H = image_width, image_height

    def fn(gaussians: gm.GaussianParams, cam: CameraView,
           bg: torch.Tensor) -> ShardedRenderOut:
        cap = gaussians.capacity
        if cap % n_shards:
            raise ValueError(f"capacity {cap} not divisible by {n_shards} "
                             f"shards")
        t = {k: shard_rows(v, n_shards)
             for k, v in gm.trainables(gaussians).items()}
        out = _render_bands(
            [{k: v[o] for k, v in t.items()} for o in range(n_shards)],
            shard_rows(gaussians.active, n_shards),
            gaussians.active_sh_degree, None, cam, W=W, H=H, cfg=cfg,
            m_cap_loc=shard_capacity(cap, cfg, n_shards, m_cap_total),
            antialiasing=antialiasing, transient=transient)
        image = torch.clamp(
            out.full[:3] + out.full[4:5] * bg[:, None, None], 0.0, 1.0)
        return ShardedRenderOut(image=image, invdepth=out.full[3:4],
                                radii=out.radii, num_pairs=out.num_pairs,
                                overflow=out.overflow)

    return fn


def sharded_loss_grads(g: gm.GaussianParams, exposure_all: torch.Tensor,
                       cam: CameraView, gt_image, alpha_mask, invdepth_gt,
                       depth_mask, bg, step: int, *, n_shards: int,
                       image_width: int, image_height: int,
                       opt: OptimizationConfig, rcfg: RasterizerConfig,
                       antialiasing: bool, train_test_exp: bool,
                       use_depth: bool, transient: str):
    """Loss and gradients for one camera through the sharded render: every
    shard's parameters and screen-space tap are leaves of their own, so
    each owner receives the gradient of exactly its rows. Returns (loss,
    l1, depth_l1, _Bands, grads by trainable field (CAP rows, the shards'
    in order), exposure grads, tap grad (CAP,2))."""
    full_f32_matmul()      # the exposure product is held to JAX's HIGHEST
    W, H = image_width, image_height
    cap = g.capacity
    depth_w = expon_lr(step, opt.depth_l1_weight_init,
                       opt.depth_l1_weight_final, max_steps=opt.iterations)
    fields = gm.TRAINABLE_FIELDS
    params = [{k: v.detach().requires_grad_() for k, v in zip(
        fields, vs)} for vs in zip(*(shard_rows(getattr(g, k), n_shards)
                                     for k in fields))]
    taps = [torch.zeros((cap // n_shards, 2), device=g.device,
                        requires_grad=True) for _ in range(n_shards)]
    exposure_all = exposure_all.detach().requires_grad_()

    out = _render_bands(
        params, shard_rows(g.active, n_shards), g.active_sh_degree, taps,
        cam, W=W, H=H, cfg=rcfg,
        m_cap_loc=shard_capacity(cap, rcfg, n_shards),
        antialiasing=antialiasing, transient=transient)
    image = out.full[:3] + out.full[4:5] * bg[:, None, None]
    if train_test_exp:
        # cameras without an exposure mapping get the identity affine
        exposure = exposure_all[cam.exposure_idx] if cam.exposure_idx >= 0 \
            else torch.eye(3, 4, device=g.device)
        image = torch.einsum("chw,ck->khw", image, exposure[:3, :3]) \
            + exposure[:3, 3, None, None]
    image = torch.clamp(image, 0.0, 1.0) * alpha_mask
    l1 = losses.l1_loss(image, gt_image)
    ssim_v = losses.ssim(image, gt_image)
    loss = (1.0 - opt.lambda_dssim) * l1 + opt.lambda_dssim * (1.0 - ssim_v)
    dl1 = ((out.full[3:4] - invdepth_gt) * depth_mask).abs().mean()
    if use_depth and depth_w > 0:
        loss = loss + depth_w * dl1

    inputs = [p[k] for p in params for k in fields] + taps + [exposure_all]
    got = torch.autograd.grad(loss, inputs, allow_unused=True)
    got = [torch.zeros_like(x) if d is None else d
           for x, d in zip(inputs, got)]
    nf = len(fields)
    grads = {k: torch.cat([got[o * nf + i] for o in range(n_shards)])
             for i, k in enumerate(fields)}
    tap_grad = torch.cat(got[n_shards * nf:n_shards * (nf + 1)])
    out = out._replace(full=out.full.detach(), radii=out.radii.detach())
    return (loss.detach(), l1.detach(), dl1.detach(), out, grads, got[-1],
            tap_grad)


def make_sharded_train_step(n_shards: int, *, image_width: int,
                            image_height: int, opt: OptimizationConfig,
                            rcfg: RasterizerConfig, spatial_lr_scale: float,
                            antialiasing: bool = False,
                            use_sparse_adam: bool = False,
                            train_test_exp: bool = False,
                            use_depth: bool = False,
                            transient: str = "replicated"):
    """Build the sharded train step: (state, cam, gt, alpha_mask,
    invdepth_gt, depth_mask, bg) -> (state, StepAux), with the semantics of
    ``trainer.train_step`` and every per-gaussian quantity in row shards.
    The loss takes ``losses.ssim``, as the JAX package's sharded step does.
    Adam and the statistics are elementwise, so they update every shard's
    rows where they lie."""

    def step(state: "trainer.TrainState", cam: CameraView, gt_image,
             alpha_mask, invdepth_gt, depth_mask, bg):
        shard_state(state, n_shards)
        stepc = state.step + 1
        loss, l1, dl1, out, grads, exp_grads, tap_grad = sharded_loss_grads(
            state.gaussians, state.exposure, cam, gt_image, alpha_mask,
            invdepth_gt, depth_mask, bg, stepc, n_shards=n_shards,
            image_width=image_width, image_height=image_height, opt=opt,
            rcfg=rcfg, antialiasing=antialiasing,
            train_test_exp=train_test_exp, use_depth=use_depth,
            transient=transient)
        stats = state.stats
        if stepc < opt.densify_until_iter:
            stats = densify_lib.add_densification_stats(stats, out.radii,
                                                        tap_grad)
        vis = (out.radii > 0) if use_sparse_adam else None
        new_state = trainer.finish_train_step(
            state, grads, exp_grads, stats, stepc, vis, opt=opt,
            spatial_lr_scale=spatial_lr_scale)
        aux = trainer.StepAux(loss=loss, l1=l1, depth_l1=dl1,
                              num_pairs=out.num_pairs, overflow=out.overflow,
                              radii=out.radii, num_padded=out.num_padded)
        return new_state, aux

    return step
