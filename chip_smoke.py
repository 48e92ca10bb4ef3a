#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (gsplat_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing its own line:
1. device: the card's name and power limit;
2. build: every CUDA kernel of the render and training paths, with nvcc,
   from this checkout, one nvcc per source, all started together;
3. kernel vs plain: the compositor kernel against its plain PyTorch version
   on the card, on the entries of the phase-4 frame, with the tiles' entry
   counts, the gate that the rectangle and warp mask the kernels stage for
   every entry row equal the plain formula's and, in one plain walk of
   every tile (``pair_walk``), the gate that no pair passing the alpha test
   lies outside its cull rectangle (the device's and the plain one), the
   shares of evaluations, rows and warps the rectangle keeps, and the
   contributing (entry, pixel) pairs the kernel's bound charges operations
   to; then a small render on the card against the same render on the
   CPU, and the kernels' path for tiles whose width is not 32 (8x128 and
   16x16 tiles on the small frame: compositor forward and backward, slab
   transmittance, the rectangle walk);
3b. the training kernels against their plain versions on the card: the
   compositor backward (on 16 tiles of the phase-5 frame) against autograd
   through the plain compositor, with the same rectangle walk of every
   tile of the training frame, the SSIM map (the same bits with and without
   the partial maps its launch writes for the backward), the partial maps
   and the one-launch backward at 3x1920x1080 against the plain SSIM,
   with the pair's time and bound per step; the fused preprocess pair on
   the training scene against the plain path (preprocess_ab.py's gates and
   timings); the entry gather's pair against the plain chain on the
   training frame (the forward bit for bit, the backward bit for bit the
   chain's on the CPU and the same bits twice, row N 0); each kernel timed
   by CUDA events;
3c. the depth-slab and tile-band forms of the kernels against their plain
   versions, on the phase-5 frame's entries split into 4 depth slabs, with
   the rectangle walk of every tile of each slab: the slab transmittance
   against its plain version and the compositor's cut-free t_final (bit
   for bit), with the share of pixels whose T is exactly 0 and its bound
   on the 3 slabs pass 1 runs on, charged to the pairs that pass the alpha
   test; the compositor with a random ``t_init``, with each slab's real
   arriving transmittance, and with the ``tile_id_base`` of band 1 of 2;
   the compositor backward on 16 tiles of slab 1 from its ``t_init``
   forward under non-zero cotangents of accum and t_final, and again with
   a ``tile_id_base``;
3d. the blocked prefix sum against a float64 cumsum at the number of rows
   one shard's backward of phase 7 gives it (held to twice the error of
   ``torch.cumsum`` in f32), against its plain version bit for bit on
   integers, through ``masked_presort_prefix`` with NaN rows past the live
   ones, and twice on one input; timed beside its plain version, which is
   also the one library call that computes it (``torch.cumsum``);
4. the render path at full width: bench.py's workload — 200,000 gaussians,
   SH degree 3, 1920x1080 — written to a PLY, loaded back through the port's
   loader, and rendered from 5 camera poses under torch.no_grad(), with the
   kernel's launch count read around exactly those renders;
5. the training path at full width: bench.py's train step on its scene
   (create_from_pcd, 200,000 gaussians, SH 3, 1920x1080, default
   OptimizationConfig, dense Adam): one warm-up step, then 5 timed steps
   with every kernel's launch count read around exactly those steps, and
   one profiled step;
5b. per-tile-row ellipse culling (``row_cull``) off and on, on phase 5's
   scene: the pairs, every culled tile's set a subset of its rectangle
   set and every dropped pair below the alpha floor at every pixel of its
   tile (on the device), the compositor pair against its plain versions
   on the culled list and timed on both lists in turns with their bounds,
   the image and the step's gradients (whether bit for bit), frame and
   step medians in turns with device busy, exact launches of the culled
   calls;
6. the depth-slab and tile-band paths at full width, on the phase-5 scene:
   ``render_prim_sharded`` with 4 slabs from the 5 poses under
   torch.no_grad() and one forward plus backward of an L1 loss, held to
   the single render and its gradient, with the launch counts read around
   exactly those; ``render_tile_sharded`` with 2 bands, held to the single
   render; one profiled slab render;
7. gaussian-sharded storage at full width, on the phase-5 scene with 4 row
   shards, for each transient (replicated, ring, slab): 5 renders under
   torch.no_grad() held to the single render, one warm-up and 3 timed
   sharded train steps, and the step's gradients held to the replicated
   transient's and to the single render's under the same loss, with the
   launch counts read around exactly those; one ring step profiled with
   the loss's SSIM on the fused kernels and with the plain SSIM, in turns;
7b. one culled frame of the slab, band and three sharded paths against
   the single culled render at phases 6-7's gates, one culled ring step,
   ``slab_tmit`` and the scan on culled inputs against their plain
   versions;
8. the training loop at full width: a COLMAP scene of bench.py's cloud
   with 8 cameras at 1920x1080, trained 60 iterations (run A), resumed
   from its checkpoint (run B), then 6 iterations of the sharded loop;
   whether the native image loader built, Scene init with it and with
   PIL (the same images), and the depth-scale CLI on the scene with
   synthetic 16-bit inverse depths against their known scales;
9. evaluation and viewing on run A's model: the render CLI on its test
   view and the metrics CLI with random LPIPS weights written from the
   seed (``results.json``, ``per_view.json``; SSIM on the card against
   the plain SSIM, LPIPS on the card against the CPU's on a crop); the web
   viewer in a server thread over HTTP (``/``, ``/info``, 5 orbit frames
   at 1920x1080); the SIBR bridge on run A's final state (a kernel-path
   and a python-path frame) and inside a loop resumed from run A's
   checkpoint, one frame per iteration; exact launch counts on each;
10. camera data parallelism on the one card: (a) a world of one rank over
   NCCL, from an environment the script sets, on phase 5's scene: 1 + 5 DP
   steps with exact launches, the DP step bit for bit ``train_step``'s from
   the same state (both under torch's deterministic algorithms), one
   profiled DP step with the all-reduce's device time; (b) two ranks in two
   processes of this script (``--dp-rank``) sharing the card over gloo,
   each with one of phase 8's 1080p cameras: one DP step bit for bit the
   two-camera step in one process, the ranks' states equal, then
   ``train(..., data_parallel=True)`` on phase 8's scene for 20 iterations
   with a densify event, the ranks' final states and batches equal, only
   rank 0's files there, the all-reduces' share of an iteration; exact
   launches on each;
11. one rank per part (``RankParts``), the ranks processes of this script
   sharing the card over gloo: (a) gaussian-sharded storage over 2 ranks
   on phase 5's scene, each holding 100,000 rows: per transient 5 renders
   bit for bit this process's 2-shard local form, 1 + 3 steps and one
   gradient call held to the single render's rows, the collectives' host
   ms, one profiled step, peak memory per rank beside the one-process
   form's; (b) the slab and band renders over 2 ranks at phase 6's gates,
   bit for bit the local forms; (c) JAX's 2-D layout, 4 ranks as data 2 x
   prim 2, one ring step from 10b's state against the two-camera step at
   phase 7's gates; (d) ``train(..., shard_gaussians=True)`` on 2 ranks on
   phase 8's scene, 10 iterations with a densify event that outgrows the
   capacity, the rows gathered bit for bit this process's ``n_shards=2``
   loop (both under torch's deterministic algorithms), rank 0's
   checkpoint its file, rank 1 writing nothing; exact launches per rank;
   (e) the same loop over 2 ranks (ring) under rank 0's SIBR bridge, every
   rank rendering each frame, each bit for bit the one-process sharded
   render of the gathered rows;
12. the synthetic-scene validation path (``gsplat_tpu_torch/tools``): (a)
   the scene generator at the soak's size (12,000 gaussians, 24 cameras,
   512x384, seed 7), timed; (b) the training drive on the card, 512x256,
   300 iterations, its +3 dB asserts on the train and held-out views
   failing the run, with exact launches; (c) a 1,000-iteration soak
   through the train, render and metrics CLIs (each its own process) on
   (a)'s scene, 5 densify events and a held-out evaluation at 1,000,
   failing unless every stage exits 0, the live count changes at exactly
   the densify iterations and the train views gain 3 dB over the initial
   model (the held-out views are reported: on this scene they lose PSNR
   over the reference regime's first 1,000 iterations, as (d) shows);
   (d) the same regime on the generator's scene at 128x96 (3,000
   gaussians) through the train CLI for 1,000 iterations, its held-out
   PSNR at 100, 200, 500 and 1,000 held to what the JAX package's
   train.py prints on that scene on a CPU.
13. the measurement entry points (``bench_torch.py``,
   ``gsplat_tpu_torch/tools``): (a) bench.py's train-step pixels/s at
   1920x1080 on its 200k scene in this process, with ``--row_cull`` through
   ``bench_torch.py`` as a process, and with ``--ply`` on 12 (c)'s trained
   model, each line's metric checked and the step kernels' launches exact
   (2 right-sizing steps + 3 windows of 7); (b) the stage profiler, host,
   event and busy ms of every stage, the compositor stages' launches
   exact; (c) the tile sweep: 32x32, 16x16, 8x32, 16x32, 16x64 at chunk
   64 and 32x32 at chunk 32 and 256, each right-sized, its compositor pair
   timed on the whole frame and (but the default) held to its plain
   versions (the forward on the frame, the backward on 16 tiles), the
   steps timed in turns, one profiled; 32x64 refused by the kernels'
   1,024-pixel limit; (d) the reductions, gather and sorts of
   bench_scatter (the reductions agreeing, s1's order s2's on uncolliding
   keys) and bench_binning's stages at the JAX tools' sizes; (e) the
   port's bin_gaussians taken apart, plain and culled.
Then a ``kernels`` JSON line with one object per kernel of the KERNELS
table, the nvidia-smi line, and a final JSON line.

``python3 chip_smoke.py --nccl`` (4 cards) runs 11d and 11c with one rank
per card over NCCL instead of sharing one card over gloo.
Any failure raises and exits non-zero; without CUDA it exits non-zero
before printing any result.
"""
import contextlib
import dataclasses
import functools
import json
import os
import re
import subprocess
import time

import numpy as np
import torch

from gsplat_tpu_torch.config import OptimizationConfig, RasterizerConfig
from gsplat_tpu_torch.core import sh as sh_lib
from gsplat_tpu_torch.core.camera import CameraView
from gsplat_tpu_torch.models import gaussian_model as gm
from gsplat_tpu_torch.ops import binning as binning_lib
from gsplat_tpu_torch.ops import knn, losses, rasterize
from gsplat_tpu_torch.ops import ssim as ssim_lib
from gsplat_tpu_torch.ops.composite_ref import (_TileWalk,
                                                composite_tiles_plain,
                                                cull_rects_plain,
                                                slab_transmittance_plain)
from gsplat_tpu_torch.ops.kernels import build
from gsplat_tpu_torch.ops.kernels.composite import (composite_bwd_cuda,
                                                    composite_fwd_cuda,
                                                    cull_rects_cuda,
                                                    slab_transmittance_cuda)
from gsplat_tpu_torch.ops.kernels.gather import (gather_entries_bwd_cuda,
                                                 gather_entries_fwd_cuda,
                                                 gather_entries_plain)
from gsplat_tpu_torch.ops.kernels.preprocess import (preprocess_bwd_cuda,
                                                     preprocess_fwd_cuda)
from gsplat_tpu_torch.ops.kernels.scan import (blocked_cumsum_16_cuda,
                                               blocked_cumsum_16_plain)
from gsplat_tpu_torch.ops.kernels.ssim import (ssim_bwd_cuda, ssim_fwd_cuda,
                                               ssim_partials_plain)
from gsplat_tpu_torch.parallel import prim_shard, sharded, tile_shard
from gsplat_tpu_torch.scene import ply as ply_lib
from gsplat_tpu_torch.tools import bench
from gsplat_tpu_torch.train import checkpoint as ckpt_lib
from gsplat_tpu_torch.train import trainer

SEED = 0
N_GAUSS = 200_000          # bench.py's workload
W, H = 1920, 1080
N_POSES = 5
N_STEPS = 5
IMG_TOL = dict(rtol=2e-4, atol=2e-5)   # the JAX suite's image gate
GRAD_TOL = dict(rtol=5e-3, atol=1e-6)  # the JAX suite's gradient gate
SSIM_TOL = dict(rtol=1e-5, atol=1e-6)
SSIM_GRAD_TOL = dict(rtol=2e-4, atol=1e-6)   # tests/test_train.py:225
SLAB_TOL = dict(rtol=1e-5, atol=1e-6)        # tests/test_rasterize.py:399
# the slab render's gradient against the single render's, element by
# element; and, since the mean-L1 loss of a 1080p frame leaves most
# gradients below that atol, the largest error of a field over its largest
# gradient
SLAB_GRAD_TOL = dict(rtol=1e-2, atol=1e-5)
SLAB_GRAD_REL_MAX = 1e-4
N_SLABS = 4
N_BANDS = 2
N_SHARDS = 4
N_SHARD_STEPS = 3
# the sharded render against the single render: tiles are independent, so a
# band is the single render's rows (tests/test_parallel.py:255-259)
SHARD_IMG_TOL = dict(rtol=1e-6, atol=1e-7)
SCAN_BLOCK = rasterize.PREFIX_BLOCK   # rows per block of the prefix sums
# published H100 SXM peaks (NVIDIA data sheet), for the bound
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
# per contributing (entry, pixel) pair; the compositor's bounds charge
# nothing for a pair that does not contribute
OPS_PER_EVAL = 21          # ~20 f32 operations + 1 exp
OPS_PER_EVAL_BWD = 60      # the backward's ~59 f32 operations + 1 exp
OPS_PER_EVAL_TMIT = 18     # the alpha alone (16 + 1 exp) and one product
# f32 operations per pixel: SSIM map = 3 products + 5 blurs x 2 passes x
# 21 + ~20 for the map; backward = the same fields again + ~20 for the t
# maps + 3 blurs x 42 + 4 to combine (the counts of the two-launch
# backward, kept so that the rows compare across PRs); the pair a training
# step runs, forward with partial maps plus backward, at its least: the map
# and the t maps once (233 + ~24), 3 blurs x 42 + 4, and 28 bytes (x, y
# into the forward, the map out; x, y, g into the backward, d img1 out)
OPS_SSIM_FWD = 233
OPS_SSIM_BWD = 233 + 20 + 130
OPS_SSIM_PAIR = 387
BYTES_SSIM_PAIR = 28
N_CHECK_TILES = 16         # tiles the compositor backward is checked on
SMALL_W, SMALL_H, SMALL_N = 256, 128, 3000   # the small frame of phase 3
REPO = os.path.dirname(os.path.abspath(__file__))


def check(cond, msg):
    if not cond:
        raise RuntimeError(msg)


def median_ms(fn, reps):
    """Median device time of fn() over reps calls, by CUDA events."""
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def make_ply(path, rng, device):
    """bench.py's synthetic scene: a 200k-point cloud in front of the
    camera, 3-NN init scales (the port's knn on the card) shrunk by e^-1,
    opacity 0.5; higher SH coefficients small and random so the degree-3
    colors vary."""
    pts, colors = bench.bench_points(rng, N_GAUSS)
    dist2 = knn.mean_sq_dist_to_3nn(torch.tensor(pts, device=device))
    dist2 = torch.clamp(dist2, min=1e-7).cpu().numpy()
    scale = np.log(np.sqrt(dist2))[:, None].repeat(3, axis=1) - 1.0
    rot = np.zeros((N_GAUSS, 4), np.float32)
    rot[:, 0] = 1.0
    arrays = dict(
        xyz=pts, f_dc=((colors - 0.5) / sh_lib.C0).astype(np.float32),
        f_rest=(0.05 * rng.standard_normal((N_GAUSS, 15, 3))).astype(
            np.float32),
        opacity=np.zeros(N_GAUSS, np.float32),
        scaling=scale.astype(np.float32), rotation=rot)
    ply_lib.save_gaussian_ply(path, *(arrays[k] for k in (
        "xyz", "f_dc", "f_rest", "opacity", "scaling", "rotation")))
    return arrays


def poses(device):
    """bench.py's camera and four small departures from it."""
    out = []
    for i in range(N_POSES):
        a = 0.04 * i
        R = np.array([[np.cos(a), 0, np.sin(a)], [0, 1, 0],
                      [-np.sin(a), 0, np.cos(a)]])
        T = np.array([0.1 * i, -0.05 * i, 0.0])
        out.append(CameraView.create(R, T, fovx=1.2, fovy=0.9,
                                     device=device))
    return out


def profile_call(label, fn, n_top=12):
    """Where one call's device time goes: torch.profiler's device time by
    kernel (device-side events only, so nothing counts twice), against the
    call's host-clock time under the profiler."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t) * 1e3
    return print_profile(label, prof, wall_ms, n_top)


def print_profile(label, prof, wall_ms, n_top):
    """Print a profile's device busy time, op count and top kernels beside
    the host-clock time it covered. Returns the busy ms."""
    from torch.autograd import DeviceType
    rows = sorted(((e.self_device_time_total / 1e3, e.count, e.key)
                   for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA
                   and e.self_device_time_total > 0), reverse=True)
    busy_ms = sum(r[0] for r in rows)
    n_ops = sum(r[1] for r in rows)
    top = "; ".join(f"{key[:70]} x{n} {ms:.3f} ms"
                    for ms, n, key in rows[:n_top])
    print(f"profile {label}: wall {wall_ms:.3f} ms under the profiler, "
          f"device busy {busy_ms:.3f} ms in {n_ops} device ops; top: {top}",
          flush=True)
    return busy_ms


def kernel_device_ms(fn, reps):
    """Mean device time per call of fn() over reps calls, summed over the
    device kernels it launches, from torch.profiler
    (``tools/bench.py:device_busy``): what CUDA events around one call
    cannot resolve when the call's host time exceeds its kernel's."""
    return bench.device_busy(fn, reps)[0]


def bound(n_bytes, ops):
    """The least time the card could take: the larger of the bytes over
    its memory rate and the f32 operations over its peak rate."""
    b_ms = n_bytes / HBM_BYTES_PER_S * 1e3
    o_ms = ops / F32_OPS_PER_S * 1e3
    return dict(bound_ms=max(b_ms, o_ms),
                bound_by="operations" if o_ms >= b_ms else "bytes")


def fwd_work(tile_count, n_contrib, has_t_init=False):
    """What one compositor forward launch moves and walks, as (rows, evals,
    bytes): bytes = the entry rows in tile ranges (columns 0-9) + tile
    tables + outputs (+ t_init); evals = the (entry, pixel) pairs up to each
    pixel's last contributor, which a kernel that culls nothing evaluates.
    The bound charges operations to the contributing pairs among them only
    (``pair_walk``'s ``hits``)."""
    T, P = n_contrib.shape
    rows = int(tile_count.long().sum())
    return (rows, int(n_contrib.long().sum()),
            rows * 40 + T * 8 + T * P * (24 + 4 * has_t_init))


def bwd_work(n_rows, tile_count, n_contrib):
    """What one compositor backward launch moves and walks, as (rows, evals,
    bytes): 40 B in for each entry row up to its tile's largest n_contrib +
    64 B out for every row of d_entries + tables + 28 B per pixel
    (cotangents, t_final, n_contrib); evals as the forward's."""
    T, P = n_contrib.shape
    rows = int(torch.minimum(tile_count.long(),
                             n_contrib.long().amax(dim=1)).sum())
    return (rows, int(n_contrib.long().sum()),
            rows * 40 + n_rows * 64 + T * 8 + T * P * (16 + 4 + 4 + 4))


def bench_train_setup(dev):
    """bench.py's training workload (``tools/bench.py:bench_scene``: its
    scene, camera and uniform ground truth) and its pair capacities
    right-sized from a probe frame (``right_sized``: 1.3x the pairs, 1.5x
    the alignment padding)."""
    g, cam, gt = bench.bench_scene(N_GAUSS, W, H, dev)
    cfg = RasterizerConfig(pairs_per_gaussian=bench.FIRST_PPG)
    with torch.no_grad():
        b = rasterize.build_entries(g, cam, W, H, cfg).binning
    check(int(b.overflow) == 0, f"probe overflow {int(b.overflow)}")
    return g, cam, gt, bench.right_sized(cfg, int(b.num_pairs),
                                         int(b.num_padded), N_GAUSS)


def cotangents(rng, T, P, dev):
    """N(0,1) cotangents of accum (T,4,P) and of t_final (T,P)."""
    return (torch.tensor(rng.standard_normal((T, 4, P)).astype(np.float32),
                         device=dev),
            torch.tensor(rng.standard_normal((T, P)).astype(np.float32),
                         device=dev))


def pick_tiles(tile_count, rng):
    """tile_count with all but N_CHECK_TILES tiles zeroed: the 8 tiles with
    the most entries and 8 more chosen from the seed, so that the plain
    version walks only those."""
    counts = tile_count.long()
    top = torch.topk(counts, N_CHECK_TILES // 2).indices.cpu().numpy()
    rest = np.setdiff1d(np.nonzero(counts.cpu().numpy())[0], top)
    pick = np.concatenate([top, rng.choice(rest, N_CHECK_TILES // 2,
                                           replace=False)])
    tc = torch.zeros_like(tile_count)
    tc[pick] = tile_count[pick]
    return tc


def tile_lengths(label, tile_count):
    """The tiles' entry counts: what one block per tile has to balance. The
    264 longest are two blocks on each of an H100's 132 SMs."""
    c = tile_count.long()
    top = torch.topk(c, min(264, c.numel())).values
    print(f"tile lengths ({label}): {c.numel()} tiles, {int((c > 0).sum())} "
          f"non-empty, mean {float(c.float().mean()):.1f} entries, largest "
          f"{int(c.max())}, the 264 longest hold {int(top.sum())} of "
          f"{int(c.sum())} ({float(top.sum()) / max(int(c.sum()), 1):.3f})",
          flush=True)


def device_cull_rects(label, entries, tile_start, tile_count, geo):
    """The rectangle and warp mask the kernels stage for every entry row of
    the launch (``cull_rects_cuda``, the device's ``cull_rect``), held to the
    plain formula (``cull_rects_plain``): equal on every row."""
    kw = {k: v for k, v in geo.items()
          if k not in ("chunk", "t_eps", "alpha_max")}
    with torch.no_grad():
        got = cull_rects_cuda(entries, tile_start, tile_count, **kw)
        want = cull_rects_plain(entries, tile_start, tile_count, **kw)
    differ = int((got != want).any(dim=1).sum())
    owned = int((want[:, 0] != -2).sum())
    check(owned == int(tile_count.long().sum()), "rows owned by a tile")
    check(differ == 0, f"cull rectangle ({label}): the device's differs from "
          f"the plain formula's on {differ} of {owned} rows")
    print(f"cull rectangle ({label}): the device's rectangle and warp mask "
          f"equal the plain formula's on all {owned} rows", flush=True)
    return got


def pair_walk(label, entries, tile_start, tile_count, geo, rects,
              n_contrib=None):
    """One plain walk of every tile of a launch's tables, with the plain
    alpha (``_TileWalk``): the gate that no pair passing the alpha test lies
    outside its cull rectangle, by the device's own rectangles ``rects``
    (``device_cull_rects``) and by the plain formula, and the counts the
    bounds and the kernels' design read. ``live``: the (entry, pixel) pairs
    that pass the alpha test, what slab_tmit cannot skip. With
    ``n_contrib``: ``evals``, the pairs below the pixel's n_contrib (what a
    compositor that culls nothing evaluates), ``hits``, the live ones among
    them (what no compositor can skip), ``inside``, those inside the
    rectangle. On 32x32 tiles: ``rows``, the (entry, row) pairs the
    rectangle keeps (a row is 32 pixels of one tile row), ``rows_live``
    those with a pixel below n_contrib, ``lanes`` the pixels of the kept
    rows inside it, ``warps`` the (entry, warp) pairs it keeps with a warp
    on 4 consecutive rows (the kernels' layout), ``warps_spread`` with a
    warp's rows 8 apart (pixel = thread + 256 k)."""
    walk = _TileWalk(entries, tile_start, tile_count,
                     **{k: v for k, v in geo.items() if k != "t_eps"})
    n = dict.fromkeys(("entries", "live", "outside_live", "evals", "hits",
                       "inside", "rows", "rows_live", "lanes", "warps",
                       "warps_spread"), 0)
    rows32 = walk.tile_w == 32 and walk.tile_h == 32
    with torch.no_grad():
        for j in range(walk.n_steps):
            idx, rank, data, a1 = walk.step(j)
            live = a1 > 0
            inside = walk.inside(idx, data)
            valid = (rank[None, :] < walk.count[idx, None])[..., None]
            r = rects[(walk.start[idx, None] + rank[None, :]).clamp(
                max=rects.shape[0] - 1)].long()[..., None]    # (L,G,5,1)
            on_device = ((walk.pxl >= r[:, :, 0]) & (walk.pxl <= r[:, :, 1])
                         & (walk.pyl >= r[:, :, 2]) & (walk.pyl <= r[:, :, 3]))
            n["outside_live"] += int((live & ~inside).sum())
            n["outside_live"] += int((live & ~on_device).sum())
            n["live"] += int(live.sum())
            n["entries"] += int(valid.sum())
            if n_contrib is not None:
                below = rank[None, :, None] < n_contrib[idx][:, None, :]
                n["evals"] += int(below.sum())
                n["hits"] += int((live & below).sum())
                n["inside"] += int((inside & below).sum())
            if rows32:
                L, G = inside.shape[:2]
                kept = inside & valid
                rows = kept.view(L, G, 32, 32).any(-1)
                n["rows"] += int(rows.sum())
                n["lanes"] += int(kept.sum())
                if n_contrib is not None:
                    n["rows_live"] += int(
                        (inside & below).view(L, G, 32, 32).any(-1).sum())
                n["warps"] += int(rows.view(L, G, 8, 4).any(-1).sum())
                n["warps_spread"] += int(rows.view(L, G, 4, 8).any(-2).sum())
    check(n["outside_live"] == 0, f"cull rectangle ({label}): "
          f"{n['outside_live']} pairs that pass the alpha test lie outside it")
    return n


def walk_line(label, n):
    """The line of one ``pair_walk`` (or of several summed): the gate held
    and the shares that size the kernels' design."""
    ent = max(n["entries"], 1)
    line = (f"cull rectangle ({label}) on every tile, {n['entries']} entries: "
            f"conservative (0 of {n['live']} pairs that pass the alpha test "
            f"outside the device's or the plain rectangle)")
    if n["evals"]:
        line += (f"; of {n['evals']} evaluations below n_contrib "
                 f"{n['hits'] / n['evals']:.3f} contribute and "
                 f"{n['inside'] / n['evals']:.3f} lie inside")
    if n["rows"]:
        line += (f"; the rectangle keeps {n['rows'] / (ent * 32):.3f} of "
                 f"(entry, row) pairs ({n['rows_live'] / (ent * 32):.3f} "
                 f"with a pixel below n_contrib), "
                 f"{n['lanes'] / (n['rows'] * 32):.3f} of a kept row's lanes, "
                 f"{n['warps'] / (ent * 8):.3f} of (entry, warp) pairs with a "
                 f"warp on 4 consecutive rows, {n['warps_spread'] / (ent * 8):.3f} "
                 f"with its rows 8 apart")
    return line


def bwd_vs_plain(label, entries, tile_start, tc, ga, gt, geo, fwd_kw,
                 t_init=None, tile_id_base=0):
    """composite_bwd (from composite_fwd's outputs on the same tables)
    against autograd through the plain compositor, on the tiles ``tc``
    keeps. Returns (max abs error, kernel ms, plain forward+backward ms)."""
    kw = dict(geo, tile_id_base=tile_id_base)
    with torch.no_grad():
        sub = composite_fwd_cuda(entries, tile_start, tc, **kw, **fwd_kw,
                                 t_init=t_init)
        args = (entries, tile_start, tc, sub.t_final, sub.n_contrib, ga, gt)
        kern = composite_bwd_cuda(*args, **kw)
        torch.cuda.synchronize()
        sub_ms = median_ms(lambda: composite_bwd_cuda(*args, **kw), 20)

    def plain():
        x = entries.detach().requires_grad_()
        out = composite_tiles_plain(x, tile_start, tc, **kw, **fwd_kw,
                                    t_init=t_init)
        ((out.accum * ga).sum() + (out.t_final * gt).sum()).backward()
        return x.grad

    want = plain()
    torch.cuda.synchronize()
    plain_ms = median_ms(plain, 3)
    err = float((kern[:, :10] - want[:, :10]).abs().max())
    check(torch.allclose(kern[:, :10], want[:, :10], **GRAD_TOL),
          f"composite_bwd ({label}) disagrees with autograd through the "
          f"plain version (max {err})")
    check(float(kern[:, 10:].abs().max()) == 0.0, "columns 10-15 not 0")
    check(float(kern[:, :10].abs().max()) > 0.0, f"{label}: zero gradient")
    print(f"kernel vs plain: composite_bwd ({label}) on {N_CHECK_TILES} "
          f"tiles ({int(tc.sum())} entries, largest tile {int(tc.max())}) "
          f"max_abs_err {err:.3e}, kernel {sub_ms:.3f} ms, plain fwd+bwd "
          f"{plain_ms:.1f} ms", flush=True)
    return err, sub_ms, plain_ms


def check_general_tiles(g, cam, rng):
    """The kernels' path for tiles whose width is not 32 (the rectangle
    tested per pixel), on the card: a small frame on 8x128 and 16x16 tiles,
    the forward against the plain compositor, the backward on 16 tiles
    against autograd through it, the slab transmittance against its plain
    version and the cut-free forward's t_final, and the rectangle walk of
    every tile."""
    for th, tw, chunk in ((8, 128, 16), (16, 16, 16)):
        cfg = RasterizerConfig(tile_h=th, tile_w=tw, chunk=chunk,
                               pairs_per_gaussian=24.0)
        with torch.no_grad():
            e = rasterize.build_entries(g, cam, SMALL_W, SMALL_H, cfg)
        b = e.binning
        check(int(b.overflow) == 0, f"overflow {int(b.overflow)}")
        geo = dict(n_tiles_x=e.n_tiles_x, n_tiles_y=e.n_tiles_y, tile_h=th,
                   tile_w=tw, alpha_min=cfg.alpha_min,
                   alpha_max=cfg.alpha_max)
        fwd_kw = dict(chunk=chunk, t_eps=cfg.transmittance_eps)
        args = (e.entries, b.tile_start, b.tile_count)
        kern, err, mismatch, _ = fwd_vs_plain(f"{th}x{tw} tiles", args,
                                              dict(geo, **fwd_kw))
        check(float((kern.n_contrib > 0).float().mean()) > 0.05,
              f"{th}x{tw} tiles: a blank frame")
        print(f"kernel vs plain: composite_fwd on {th}x{tw} tiles, "
              f"{SMALL_W}x{SMALL_H}, {int(b.num_pairs)} pairs: max_abs_err "
              f"{err:.3e}, n_contrib mismatch {mismatch:.2e}", flush=True)
        T, P = e.n_tiles_x * e.n_tiles_y, th * tw
        ga, gt = cotangents(rng, T, P, e.entries.device)
        tc = pick_tiles(b.tile_count, rng)
        bwd_vs_plain(f"{th}x{tw} tiles", e.entries, b.tile_start, tc, ga, gt,
                     geo, fwd_kw)
        tmit_kw = dict(geo, chunk=chunk)
        with torch.no_grad():
            tmit = slab_transmittance_cuda(*args, **tmit_kw)
            torch.cuda.synchronize()
            want = slab_transmittance_plain(*args, **tmit_kw)
            cutfree = composite_fwd_cuda(*args, **tmit_kw, t_eps=0.0).t_final
        tmit_err = float((tmit - want).abs().max())
        check(torch.allclose(tmit, want, **SLAB_TOL), f"slab_tmit on {th}x{tw} "
              f"tiles disagrees with its plain version (max {tmit_err})")
        check(torch.equal(tmit, cutfree), f"slab_tmit on {th}x{tw} tiles is "
              f"not the cut-free composite's t_final bit for bit")
        print(f"kernel vs plain: slab_tmit on {th}x{tw} tiles: max_abs_err "
              f"{tmit_err:.3e}, composite_fwd(t_eps=0).t_final bit for bit",
              flush=True)
        rects = device_cull_rects(f"{th}x{tw} tiles", e.entries,
                                  b.tile_start, b.tile_count, geo)
        print(walk_line(f"{th}x{tw} tiles", pair_walk(
            f"{th}x{tw} tiles", *args, tmit_kw, rects, kern.n_contrib)),
            flush=True)


def check_composite_bwd(g, cam, cfg, rng):
    """The compositor backward kernel against autograd through the plain
    compositor on the card, on 16 tiles of the training frame under
    numpy-seeded random cotangents. Kernel time, the rectangle walk and
    the bound on the full frame."""
    with torch.no_grad():
        e = rasterize.build_entries(g, cam, W, H, cfg)
    b = e.binning
    check(int(b.overflow) == 0, f"overflow {int(b.overflow)}")
    geo = dict(n_tiles_x=e.n_tiles_x, n_tiles_y=e.n_tiles_y,
               tile_h=cfg.tile_h, tile_w=cfg.tile_w,
               alpha_min=cfg.alpha_min, alpha_max=cfg.alpha_max)
    fwd_kw = dict(chunk=cfg.chunk, t_eps=cfg.transmittance_eps)
    T, P = e.n_tiles_x * e.n_tiles_y, cfg.tile_h * cfg.tile_w
    ga, gt = cotangents(rng, T, P, e.entries.device)

    # full frame: the main path's shapes, for the time and the bound
    with torch.no_grad():
        full = composite_fwd_cuda(e.entries, b.tile_start, b.tile_count,
                                  **geo, **fwd_kw)
        args = (e.entries, b.tile_start, b.tile_count, full.t_final,
                full.n_contrib, ga, gt)
        composite_bwd_cuda(*args, **geo)
        torch.cuda.synchronize()
        kern_ms = median_ms(lambda: composite_bwd_cuda(*args, **geo), 20)
    rows, evals, n_bytes = bwd_work(e.entries.shape[0], b.tile_count,
                                    full.n_contrib)
    tc = pick_tiles(b.tile_count, rng)
    err, _, plain_ms = bwd_vs_plain("training frame", e.entries, b.tile_start,
                                    tc, ga, gt, geo, fwd_kw)
    tile_lengths("training frame", b.tile_count)
    # the walk of every tile of the training frame: the compositor's bound
    # and, for the slab paths of phase 3c, the whole frame's rectangle gate
    rects = device_cull_rects("training frame", e.entries, b.tile_start,
                              b.tile_count, geo)
    walk = pair_walk("training frame", e.entries, b.tile_start, b.tile_count,
                     dict(geo, chunk=cfg.chunk), rects, full.n_contrib)
    print(walk_line("training frame", walk), flush=True)
    hits = walk["hits"]
    bnd = bound(n_bytes, hits * OPS_PER_EVAL_BWD)
    print(f"composite_bwd on the full frame: kernel {kern_ms:.3f} ms, entry "
          f"buffer {e.entries.shape[0]} rows, {int(b.num_pairs)} pairs, rows "
          f"read {rows}, contributing pairs {hits} of {evals} below "
          f"n_contrib, bound {bnd['bound_ms']:.4f} ms ({bnd['bound_by']}; "
          f"{evals * OPS_PER_EVAL_BWD / F32_OPS_PER_S * 1e3:.4f} ms if every "
          f"pair below n_contrib were charged)", flush=True)
    return dict(max_abs_err=err, ms=kern_ms, plain_ms=plain_ms, **bnd)


def check_preprocess(g, cam, rng):
    """Phase 3b: the fused preprocess pair (csrc/preprocess_fwd.cu,
    preprocess_bwd.cu) against the plain path on the training step's scene,
    at preprocess_ab.py's gates (``hold``: the packed rows, the integer
    columns, every raw field's gradient and the tap's under a N(0,1)
    cotangent of the packed rows) and timed as it times them
    (``measure``). Returns the two kernels' numbers; ``max_abs_err`` is
    the largest gap over its column's largest entry."""
    import preprocess_ab
    ct = torch.tensor(rng.standard_normal((g.capacity + 1, 16)).astype(
        np.float32), device=g.device)
    agree = preprocess_ab.hold(g, cam, W, H, ct)
    m = preprocess_ab.measure(g, cam, W, H, ct)
    med = {k: float(np.median(v)) for k, v in m["ms"].items()}
    gaps = agree["gaps"]
    bwd_err = max(v[0] for k, v in gaps.items() if k.startswith("d_"))
    print(f"kernel vs plain: preprocess pair at {g.capacity} gaussians, "
          f"{W}x{H}: gaps over the column's largest (and entries past the "
          f"gate) {gaps}, radius/rx/ry differing {agree['ceil_edge']}; "
          f"forward {med['fused_fwd']:.4f} ms (bound "
          f"{m['bound_ms']['fused_fwd']:.4f}, bytes), plain "
          f"{med['plain_fwd']:.3f}; backward {med['fused_bwd']:.4f} ms "
          f"(bound {m['bound_ms']['fused_bwd']:.4f}, bytes); forward plus "
          f"backward {med['fused_fwd_bwd']:.4f} ms against the plain path's "
          f"{med['plain_fwd_bwd']:.3f}; device ops {m['device_ops']}",
          flush=True)
    return (dict(max_abs_err=gaps["packed"][0], ms=med["fused_fwd"],
                 plain_ms=med["plain_fwd"],
                 bound_ms=m["bound_ms"]["fused_fwd"], bound_by="bytes",
                 ceil_edge=agree["ceil_edge"]),
            dict(max_abs_err=bwd_err, ms=med["fused_bwd"],
                 plain_ms=med["plain_fwd_bwd"] - med["plain_fwd"],
                 bound_ms=m["bound_ms"]["fused_bwd"], bound_by="bytes"))


def check_gather(g, cam, cfg, rng):
    """Phase 3b: the entry gather's pair (csrc/gather_entries_fwd.cu,
    csrc/gather_entries_bwd.cu) against the plain chain on the training
    step's frame: the forward bit for bit; the backward under a N(0,1)
    cotangent bit for bit the chain's two index_add_s on the CPU (both add
    each row's slots in slot order from 0), the same bits on a second
    launch, and row N exactly 0. Both timed by CUDA events beside the plain
    chain on the card (its two index_selects; its two index_add_s), the
    bound counting each byte the pair needs once: the slots' indices, the
    depth order and packed rows of the gaussians a live slot reaches and
    the zero row in, the entry rows out (forward); every gaussian's depth
    order entry and slot range, the live slots' slot_of entries and
    gradient rows in, the packed rows' gradient out (backward); and the
    host-clock ms that the slot tables add to the frame's binning. Returns
    the two kernels' numbers."""
    with torch.no_grad():
        e = rasterize.build_entries(g, cam, W, H, cfg)
        pre, packed = rasterize.preprocess_lib.preprocess_packed(g, cam, W,
                                                                 H)
        m_cap = -(-int(g.capacity * cfg.pairs_per_gaussian) // cfg.chunk) \
            * cfg.chunk
        b = rasterize.binning_lib.bin_gaussians(
            pre.mean2d, pre.depth, pre.radius, rx=pre.rx, ry=pre.ry,
            image_width=W, image_height=H, tile_h=cfg.tile_h,
            tile_w=cfg.tile_w, m_cap=m_cap, align=cfg.chunk,
            pad_cap=None if cfg.pad_cap < 0 else cfg.pad_cap,
            slot_tables=True, **rasterize.cull_kw(pre, cfg))
    check(torch.equal(b.gidx_sorted, e.binning.gidx_sorted),
          "the slot-table binning is not build_entries' layout")
    perm, gidx = b.perm, b.gidx_sorted
    n, m = perm.numel(), gidx.numel()
    live = gidx < n
    n_live = int(live.sum())
    want = gather_entries_plain(packed, perm, gidx)
    got = gather_entries_fwd_cuda(packed, perm, gidx)
    check(torch.equal(got.view(torch.int32), want.view(torch.int32))
          and torch.equal(e.entries.view(torch.int32),
                          want.view(torch.int32)),
          "gather_entries_fwd is not the plain chain bit for bit")
    d = torch.tensor(rng.standard_normal((m, 16)).astype(np.float32),
                     device=g.device)
    kern = gather_entries_bwd_cuda(d, b)
    again = gather_entries_bwd_cuda(d, b)
    check(not kern[n].any(), "gather_entries_bwd: row N is not 0")
    check(torch.equal(kern.view(torch.int32), again.view(torch.int32)),
          "gather_entries_bwd differs between two launches")
    x_cpu = packed.cpu().requires_grad_()
    cpu = torch.autograd.grad(gather_entries_plain(
        x_cpu, perm.cpu(), gidx.cpu()), x_cpu, d.cpu())[0]
    check(torch.equal(kern[:n].cpu().view(torch.int32),
                      cpu[:n].view(torch.int32)),
          "gather_entries_bwd is not the CPU chain bit for bit")
    x = packed.clone().requires_grad_()
    plain_out = gather_entries_plain(x, perm, gidx)
    fwd_ms = median_ms(lambda: gather_entries_fwd_cuda(packed, perm, gidx),
                       20)
    bwd_ms = median_ms(lambda: gather_entries_bwd_cuda(d, b), 20)
    plain_fwd_ms = median_ms(lambda: gather_entries_plain(packed, perm, gidx),
                             20)
    plain_bwd_ms = median_ms(lambda: torch.autograd.grad(
        plain_out, x, d, retain_graph=True), 20)
    fwd_dev = kernel_device_ms(
        lambda: gather_entries_fwd_cuda(packed, perm, gidx), 5)
    bwd_dev = kernel_device_ms(lambda: gather_entries_bwd_cuda(d, b), 5)

    def bin_frame(slot_tables):
        return rasterize.binning_lib.bin_gaussians(
            pre.mean2d, pre.depth, pre.radius, rx=pre.rx, ry=pre.ry,
            image_width=W, image_height=H, tile_h=cfg.tile_h,
            tile_w=cfg.tile_w, m_cap=m_cap, align=cfg.chunk,
            pad_cap=None if cfg.pad_cap < 0 else cfg.pad_cap,
            slot_tables=slot_tables, **rasterize.cull_kw(pre, cfg))
    # what the slot tables add to a training frame's binning
    tables_ms = median_ms(lambda: bin_frame(True), 10) \
        - median_ms(lambda: bin_frame(False), 10)
    # the gaussians some live slot reaches: their perm entries and rows
    reached = int(torch.unique(perm[gidx[live]]).numel())
    fwd_bnd = bound(m * 8 + reached * 8 + (reached + 1) * 64 + m * 64, 0)
    bwd_bnd = bound(n * 24 + n_live * (8 + 64) + (n + 1) * 64, 0)
    longest = int(b.g_counts.max())
    print(f"kernel vs plain: gather pair at {n} gaussians, {W}x{H}: {m} "
          f"slots, {n_live} live ({1 - n_live / m:.3f} dead), the longest "
          f"gaussian {longest} slots; forward bit for bit the plain chain; "
          f"backward bit for bit the CPU chain and the same bits twice, row "
          f"N 0; forward {fwd_ms:.4f} ms (device {fwd_dev:.4f}, bound "
          f"{fwd_bnd['bound_ms']:.4f}, bytes) against the chain's "
          f"{plain_fwd_ms:.4f}; backward {bwd_ms:.4f} ms (device "
          f"{bwd_dev:.4f}, bound {bwd_bnd['bound_ms']:.4f}, bytes) against "
          f"the chain's {plain_bwd_ms:.4f}; the slot tables add "
          f"{tables_ms:.4f} ms to the frame's binning", flush=True)
    return (dict(max_abs_err=0.0, ms=fwd_ms, device_ms=fwd_dev,
                 plain_ms=plain_fwd_ms, **fwd_bnd),
            dict(max_abs_err=0.0, ms=bwd_ms, device_ms=bwd_dev,
                 plain_ms=plain_bwd_ms, **bwd_bnd))


def check_ssim(dev, rng):
    """The SSIM map, its partial maps and its backward against the plain
    SSIM on the card at 3x1080x1920, under the mean's uniform cotangent and
    a numpy-seeded non-uniform one; the map with and without the partial
    maps and the backward twice, bit for bit. Returns the two kernels'
    numbers (the backward's with the pair's)."""
    a = rng.uniform(0, 1, (3, H, W)).astype(np.float32)
    b = np.clip(a + 0.1 * rng.standard_normal(a.shape), 0, 1)
    # the non-uniform cotangent is 1e-2 of unit size: d img1 sums terms
    # that cancel, and their float32 rounding (~1e-7 of their size, in
    # autograd as in the kernel) at unit size alone exceeds the gate's atol
    x, y, w = (torch.tensor(v, dtype=torch.float32, device=dev)
               for v in (a, b, 1e-2 * rng.uniform(0, 1, a.shape)))
    n = x.numel()
    got = ssim_fwd_cuda(x, y)
    got_p, p = ssim_fwd_cuda(x, y, partials=True)
    check(torch.equal(got, got_p), "ssim_fwd: the map differs with and "
          "without the partial maps")
    with torch.no_grad():
        want = ssim_lib.ssim_map(x, y)
        want_p = ssim_partials_plain(x, y)
    fwd_err = float((got - want).abs().max())
    p_err = float((p - want_p).abs().max())
    check(torch.allclose(got, want, **SSIM_TOL),
          f"ssim_fwd disagrees with the plain map (max {fwd_err})")
    check(torch.allclose(p, want_p, **SSIM_TOL),
          f"ssim_fwd's partial maps disagree with ssim_partials_plain (max "
          f"{p_err})")
    fwd_ms = median_ms(lambda: ssim_fwd_cuda(x, y), 20)
    fwd_p_ms = median_ms(lambda: ssim_fwd_cuda(x, y, partials=True), 20)
    fwd_dev = kernel_device_ms(lambda: ssim_fwd_cuda(x, y), 5)
    fwd_p_dev = kernel_device_ms(lambda: ssim_fwd_cuda(x, y, partials=True),
                                 5)
    with torch.no_grad():
        fwd_plain_ms = median_ms(lambda: ssim_lib.ssim_map(x, y), 5)

    xg = x.clone().requires_grad_()
    m = ssim_lib.ssim_map(xg, y)
    bwd_err = 0.0
    for cot in (torch.full_like(x, 1.0 / n), w):
        want = torch.autograd.grad(m, xg, cot, retain_graph=True)[0]
        got = ssim_bwd_cuda(x, y, cot, p)
        bwd_err = max(bwd_err, float((got - want).abs().max()))
        check(torch.allclose(got, want, **SSIM_GRAD_TOL),
              f"ssim_bwd disagrees with autograd through the plain map "
              f"(max {bwd_err})")
        check(torch.equal(got, ssim_bwd_cuda(x, y, cot, p)),
              "ssim_bwd: two launches on one input differ")
    bwd_ms = median_ms(lambda: ssim_bwd_cuda(x, y, w, p), 20)
    bwd_dev = kernel_device_ms(lambda: ssim_bwd_cuda(x, y, w, p), 5)
    bwd_plain_ms = median_ms(lambda: torch.autograd.grad(
        m, xg, w, retain_graph=True), 5)
    del m, xg

    def pair():
        ssim_bwd_cuda(x, y, w, ssim_fwd_cuda(x, y, partials=True)[1])
    pair_ms = median_ms(pair, 20)
    pair_dev = kernel_device_ms(pair, 5)
    pair_bnd = bound(BYTES_SSIM_PAIR * n, OPS_SSIM_PAIR * n)

    fwd = dict(max_abs_err=fwd_err, ms=fwd_ms, plain_ms=fwd_plain_ms,
               device_ms=fwd_dev, partials_ms=fwd_p_ms,
               partials_device_ms=fwd_p_dev, partials_max_abs_err=p_err,
               **bound(12 * n, OPS_SSIM_FWD * n))
    bwd = dict(max_abs_err=bwd_err, ms=bwd_ms, plain_ms=bwd_plain_ms,
               device_ms=bwd_dev, pair_ms=pair_ms, pair_device_ms=pair_dev,
               pair_bound_ms=pair_bnd["bound_ms"],
               pair_bound_by=pair_bnd["bound_by"],
               **bound(16 * n, OPS_SSIM_BWD * n))
    print(f"kernel vs plain: ssim_fwd at 3x{H}x{W} max_abs_err "
          f"{fwd_err:.3e} (the same bits with the partial maps, which are "
          f"{p_err:.3e} from ssim_partials_plain), kernel {fwd_ms:.3f} ms, "
          f"{fwd_p_ms:.3f} with the partial maps (device {fwd_dev:.4f} / "
          f"{fwd_p_dev:.4f}), plain {fwd_plain_ms:.3f} ms, bound "
          f"{fwd['bound_ms']:.4f} ms ({fwd['bound_by']}); ssim_bwd (1 "
          f"launch) max_abs_err {bwd_err:.3e}, the same bits twice, kernel "
          f"{bwd_ms:.3f} ms (device {bwd_dev:.4f}), plain backward "
          f"{bwd_plain_ms:.3f} ms, bound {bwd['bound_ms']:.4f} ms "
          f"({bwd['bound_by']})", flush=True)
    print(f"ssim pair per training step (forward with the partial maps, "
          f"then the backward): {pair_ms:.3f} ms by events, {pair_dev:.4f} "
          f"ms on the device, bound {pair_bnd['bound_ms']:.4f} ms "
          f"({pair_bnd['bound_by']}: {BYTES_SSIM_PAIR} B and "
          f"{OPS_SSIM_PAIR} operations per pixel)", flush=True)
    return fwd, bwd


def fwd_vs_plain(label, args, kw):
    """composite_fwd against the plain compositor on the same tables and
    keywords: accum and t_final at IMG_TOL, n_contrib equal on >= 99.9% of
    pixels. Returns (kernel output, max abs error, n_contrib mismatch,
    plain ms)."""
    with torch.no_grad():
        kern = composite_fwd_cuda(*args, **kw)
        torch.cuda.synchronize()
        plain = composite_tiles_plain(*args, **kw)
        torch.cuda.synchronize()
        plain_ms = median_ms(lambda: composite_tiles_plain(*args, **kw), 3)
    err = max(float((kern.accum - plain.accum).abs().max()),
              float((kern.t_final - plain.t_final).abs().max()))
    for k in ("accum", "t_final"):
        check(torch.allclose(getattr(kern, k), getattr(plain, k), **IMG_TOL),
              f"composite_fwd ({label}): {k} disagrees with the plain "
              f"version (max {err})")
    mismatch = float((kern.n_contrib != plain.n_contrib).float().mean())
    check(mismatch <= 1e-3, f"composite_fwd ({label}): n_contrib mismatch "
          f"{mismatch}")
    return kern, err, mismatch, plain_ms


def slab_m_cap(g, cam, cfg, n_slabs=N_SLABS):
    """The per-slab pair capacity, right-sized from a probe: 1.3x the
    fullest slab's pairs. Returns (m_cap, pairs per slab)."""
    with torch.no_grad():
        probe = prim_shard.build_slab_entries(
            g, cam, W, H, cfg, n_slabs=n_slabs,
            m_cap=int(N_GAUSS * cfg.pairs_per_gaussian))
    pairs = [int(e.binning.num_pairs) for e in probe]
    check(max(int(e.binning.overflow) for e in probe) == 0, "probe overflow")
    return int(max(pairs) * 1.3), pairs


def check_slab_kernels(g, cam, cfg, rng):
    """Phase 3c: the kernels as the depth-slab and tile-band paths call
    them, each against its plain version on the card, on the training
    frame's entries. Returns {kernel: numbers of the slab path}."""
    dev = g.xyz.device
    fwd_kw = dict(chunk=cfg.chunk, t_eps=cfg.transmittance_eps)
    with torch.no_grad():
        e = rasterize.build_entries(g, cam, W, H, cfg)
        m_cap, pairs = slab_m_cap(g, cam, cfg)
        slabs = prim_shard.build_slab_entries(g, cam, W, H, cfg,
                                              n_slabs=N_SLABS, m_cap=m_cap)
    geo = dict(n_tiles_x=e.n_tiles_x, n_tiles_y=e.n_tiles_y,
               tile_h=cfg.tile_h, tile_w=cfg.tile_w,
               alpha_min=cfg.alpha_min, alpha_max=cfg.alpha_max)
    T, P = e.n_tiles_x * e.n_tiles_y, cfg.tile_h * cfg.tile_w
    tabs = [(s.entries, s.binning.tile_start, s.binning.tile_count)
            for s in slabs]
    full = (e.entries, e.binning.tile_start, e.binning.tile_count)

    # ---- slab_tmit: each slab and the whole frame's (longest) lists
    tmit_kw = dict(geo, chunk=cfg.chunk)
    tmit_err = cut_err = 0.0
    tmit_ms, tmit_plain_ms, t_nocut = [], [], []
    with torch.no_grad():
        for args in tabs + [full]:
            got = slab_transmittance_cuda(*args, **tmit_kw)
            torch.cuda.synchronize()
            want = slab_transmittance_plain(*args, **tmit_kw)
            cutfree = composite_fwd_cuda(*args, **tmit_kw, t_eps=0.0).t_final
            tmit_err = max(tmit_err, float((got - want).abs().max()))
            cut_err = max(cut_err, float((got - cutfree).abs().max()))
            check(torch.allclose(got, want, **SLAB_TOL),
                  f"slab_tmit disagrees with its plain version (max "
                  f"{tmit_err})")
            # both kernels cull with one rectangle: equal bits show that
            # they multiply the same products in the same order; that the
            # rectangle drops no pair passing the alpha test is the walk's
            # gate (every tile of the frame in phase 3b, of each slab below)
            check(torch.equal(got, cutfree),
                  f"slab_tmit is not the cut-free composite's t_final bit "
                  f"for bit (max {cut_err})")
            check(torch.equal(got, slab_transmittance_cuda(*args, **tmit_kw)),
                  "slab_tmit: two launches on one input differ")
            tmit_ms.append(median_ms(
                lambda: slab_transmittance_cuda(*args, **tmit_kw), 20))
            tmit_plain_ms.append(median_ms(
                lambda: slab_transmittance_plain(*args, **tmit_kw), 3))
            t_nocut.append(got)
        for t, (_, _, tc) in zip(t_nocut, tabs + [full]):
            check(bool((t[tc == 0] == 1).all()),
                  "slab_tmit: an empty tile is not 1")
    # the shares of pixels and of whole tiles whose cut-free T is exactly 0:
    # what a block exit once all its pixels reach 0 could skip
    zero = [float((t == 0).float().mean()) for t in t_nocut]
    zero_tiles = [float((t == 0).all(dim=1).float().mean()) for t in t_nocut]
    print(f"kernel vs plain: slab_tmit on {N_SLABS} slabs (pairs {pairs}, "
          f"m_cap {m_cap}) and the whole frame: max_abs_err {tmit_err:.3e}, "
          f"vs composite_fwd(t_eps=0).t_final {cut_err:.3e}, the same bits "
          f"twice; kernel ms per slab {[round(x, 4) for x in tmit_ms[:-1]]} "
          f"(sum over the {N_SLABS - 1} slabs pass 1 runs on "
          f"{sum(tmit_ms[:N_SLABS - 1]):.4f}), whole frame {tmit_ms[-1]:.4f}; "
          f"plain ms per slab {[round(x, 1) for x in tmit_plain_ms[:-1]]}; "
          f"share of the tile grid's pixels whose T is exactly 0, per slab "
          f"{[round(z, 6) for z in zero[:-1]]}, whole frame {zero[-1]:.6f}; "
          f"of its tiles with every pixel 0 {[round(z, 6) for z in zero_tiles]}",
          flush=True)

    # ---- composite_fwd with t_init: a random one on the whole frame, then
    # every slab with the transmittance that really arrives at it
    t_rand = torch.tensor(rng.uniform(1e-5, 0.3, (T, P)).astype(np.float32),
                          device=dev)
    uncut = composite_fwd_cuda(*full, **geo, **fwd_kw)
    kern, err, mismatch, _ = fwd_vs_plain(
        "random t_init", full, dict(geo, **fwd_kw, t_init=t_rand))
    fired = float((kern.n_contrib < uncut.n_contrib).float().mean())
    check(fired > 0, "the random t_init moved the cut nowhere")
    print(f"kernel vs plain: composite_fwd with a random t_init in "
          f"[1e-5, 0.3]: max_abs_err {err:.3e}, n_contrib mismatch "
          f"{mismatch:.2e}, cut earlier on {fired:.3f} of the pixels",
          flush=True)
    with torch.no_grad():
        t_arrive = prim_shard.arriving_transmittance(slabs, cfg)
    check(torch.equal(t_arrive[1], t_nocut[0]), "arriving transmittance of "
          "slab 1 is not slab 0's transmittance")
    fwd_err, fwd_mis, fwd_ms, fwd_plain_ms = err, mismatch, [], []
    rows = evals = n_bytes = 0
    slab_outs, walks = [], []
    for k, args in enumerate(tabs):
        kw = dict(geo, **fwd_kw, t_init=t_arrive[k])
        kern, err, mismatch, plain_ms = fwd_vs_plain(f"slab {k}", args, kw)
        fwd_err, fwd_mis = max(fwd_err, err), max(fwd_mis, mismatch)
        with torch.no_grad():
            fwd_ms.append(median_ms(
                lambda: composite_fwd_cuda(*args, **kw), 20))
        fwd_plain_ms.append(plain_ms)
        work = fwd_work(args[2], kern.n_contrib, has_t_init=True)
        rows, evals, n_bytes = (a + b for a, b in zip((rows, evals, n_bytes),
                                                      work))
        slab_outs.append(kern)
        walks.append(pair_walk(f"slab {k}", *args, tmit_kw,
                               device_cull_rects(f"slab {k}", *args, geo),
                               kern.n_contrib))
    hits = sum(w["hits"] for w in walks)
    fwd_bnd = bound(n_bytes, hits * OPS_PER_EVAL)
    print(f"kernel vs plain: composite_fwd with each slab's arriving "
          f"transmittance: max_abs_err {fwd_err:.3e}, n_contrib mismatch "
          f"{fwd_mis:.2e}; kernel ms per slab "
          f"{[round(x, 3) for x in fwd_ms]} (sum {sum(fwd_ms):.3f}), plain "
          f"ms per slab {[round(x, 1) for x in fwd_plain_ms]}; rows {rows}, "
          f"contributing pairs {hits} of {evals} below n_contrib (the single "
          f"frame: {int(uncut.n_contrib.long().sum())}), bound of the "
          f"{N_SLABS} launches {fwd_bnd['bound_ms']:.4f} ms "
          f"({fwd_bnd['bound_by']}; "
          f"{evals * OPS_PER_EVAL / F32_OPS_PER_S * 1e3:.4f} ms if every pair "
          f"below n_contrib were charged)", flush=True)
    # slab_tmit's bound, on the slabs pass 1 runs on: 24 B per entry row,
    # tables, 4 B per pixel, and the operations of the (entry, pixel) pairs
    # that pass the alpha test, the evaluations a kernel that culls cannot
    # skip
    run = walks[:N_SLABS - 1]
    tot = {key: sum(w[key] for w in run) for key in run[0]}
    print(walk_line(f"slabs 0-{N_SLABS - 2}", tot) + f"; slab {N_SLABS - 1}: "
          f"{walks[-1]['entries']} entries, {walks[-1]['live']} pairs pass",
          flush=True)
    tmit_bound = bound(
        tot["entries"] * 24 + len(run) * (T * 8 + T * P * 4),
        tot["live"] * OPS_PER_EVAL_TMIT)
    all_pairs_ms = (tot["entries"] * P * OPS_PER_EVAL_TMIT / F32_OPS_PER_S
                    * 1e3)
    print(f"slab_tmit on the {len(run)} slabs pass 1 runs on: kernel "
          f"{sum(tmit_ms[:len(run)]):.4f} ms, {tot['entries']} entry rows, "
          f"{tot['live']} (entry, pixel) pairs pass the alpha test, bound "
          f"{tmit_bound['bound_ms']:.4f} ms ({tmit_bound['bound_by']}; "
          f"{all_pairs_ms:.4f} ms if every (entry, pixel) pair were charged)",
          flush=True)
    numbers = {"slab_tmit": dict(
        max_abs_err=tmit_err, ms=sum(tmit_ms[:len(run)]),
        plain_ms=sum(tmit_plain_ms[:len(run)]),
        all_slabs_ms=sum(tmit_ms[:-1]), frame_ms=tmit_ms[-1],
        all_pairs_bound_ms=all_pairs_ms, zero_share=zero,
        zero_tile_share=zero_tiles, **tmit_bound)}
    numbers["composite_fwd"] = dict(
        t_init_max_abs_err=fwd_err, t_init_ms=sum(fwd_ms),
        t_init_plain_ms=sum(fwd_plain_ms),
        t_init_bound_ms=fwd_bnd["bound_ms"],
        t_init_bound_by=fwd_bnd["bound_by"])

    # ---- composite_fwd with tile_id_base: band 1 of 2 of the whole frame
    # is its lower half of tile rows, composited by itself
    rows_loc = -(-e.n_tiles_y // N_BANDS)
    base = rows_loc * e.n_tiles_x
    band_args = (full[0], full[1][base:], full[2][base:])
    band_kw = dict(geo, **fwd_kw, n_tiles_y=e.n_tiles_y - rows_loc,
                   tile_id_base=base)
    kern, err, mismatch, _ = fwd_vs_plain("band 1 of 2", band_args, band_kw)
    for k in ("accum", "t_final", "n_contrib"):
        check(torch.equal(getattr(kern, k), getattr(uncut, k)[base:]),
              f"band 1 of 2: {k} is not the whole frame's lower half")
    print(f"kernel vs plain: composite_fwd with tile_id_base {base} (band 1 "
          f"of {N_BANDS}): max_abs_err {err:.3e}, n_contrib mismatch "
          f"{mismatch:.2e}, equal to the whole frame's rows bit for bit",
          flush=True)

    # ---- composite_bwd: the slabs' full backward for the time, then 16
    # tiles of slab 1 from its t_init forward against autograd, with and
    # without a tile_id_base
    ga, gt = cotangents(rng, T, P, dev)
    bwd_ms = []
    rows = evals = n_bytes = 0
    with torch.no_grad():
        for args, out in zip(tabs, slab_outs):
            a = args + (out.t_final, out.n_contrib, ga, gt)
            composite_bwd_cuda(*a, **geo)
            bwd_ms.append(median_ms(lambda: composite_bwd_cuda(*a, **geo),
                                    20))
            work = bwd_work(args[0].shape[0], args[2], out.n_contrib)
            rows, evals, n_bytes = (a + b for a, b in zip(
                (rows, evals, n_bytes), work))
    bwd_bnd = bound(n_bytes, hits * OPS_PER_EVAL_BWD)
    ent, ts, tc = tabs[1]
    err, _, plain_ms = bwd_vs_plain(
        "slab 1, its t_init forward, non-zero g_t", ent, ts,
        pick_tiles(tc, rng), ga, gt, geo, fwd_kw, t_init=t_arrive[1])
    band_geo = dict(geo, n_tiles_y=e.n_tiles_y - rows_loc)
    err2, _, _ = bwd_vs_plain(
        f"slab 1, t_init, tile_id_base {base}", ent, ts[base:],
        pick_tiles(tc[base:], rng), ga[base:], gt[base:], band_geo, fwd_kw,
        t_init=t_arrive[1][base:], tile_id_base=base)
    print(f"composite_bwd on the {N_SLABS} slabs: kernel ms per slab "
          f"{[round(x, 3) for x in bwd_ms]} (sum {sum(bwd_ms):.3f}), rows "
          f"read {rows}, contributing pairs {hits} of {evals} below "
          f"n_contrib, bound of the {N_SLABS} launches "
          f"{bwd_bnd['bound_ms']:.4f} ms ({bwd_bnd['bound_by']}; "
          f"{evals * OPS_PER_EVAL_BWD / F32_OPS_PER_S * 1e3:.4f} ms if every "
          f"pair below n_contrib were charged)", flush=True)
    numbers["composite_bwd"] = dict(
        t_init_max_abs_err=max(err, err2), t_init_ms=sum(bwd_ms),
        t_init_plain_ms=plain_ms, t_init_bound_ms=bwd_bnd["bound_ms"],
        t_init_bound_by=bwd_bnd["bound_by"])
    return numbers, m_cap, pairs


def train(state, cam, gt, cfg, opt):
    """One bench.py train step on the card."""
    ones = torch.ones((1, H, W), device=gt.device)
    zeros = torch.zeros((1, H, W), device=gt.device)
    return trainer.train_step(
        state, cam, gt, ones, zeros, zeros, torch.zeros(3, device=gt.device),
        image_width=W, image_height=H, opt=opt, rcfg=cfg,
        spatial_lr_scale=1.0, antialiasing=False, use_sparse_adam=False,
        train_test_exp=False, use_depth=False)


PALLAS = "gsplat_tpu/ops/pallas/"
# Every kernel of the port: its wrapper (which counts its launches), the TPU
# kernel bodies it replaces, and its launches per training step, per slab
# render (forward; the backward kernel in the backward; the slab
# transmittance on every slab but the farthest), per band render, per
# sharded step (the scan in the backward of the ring and slab transients
# only; one SSIM pair for the step's whole frame, whose loss takes
# ``losses.ssim`` as the JAX package's does), per scored test view (the
# render CLI's forward, the metrics CLI's SSIM map) and per viewer frame.
# The build, the launch checks and the ``kernels`` line all read this one
# table.
KERNELS = {
    "composite_fwd": dict(
        wrapper=composite_fwd_cuda, per_step=1, per_slab_render=N_SLABS,
        per_band_render=N_BANDS, per_sharded_step=N_SHARDS, per_eval_view=1,
        per_view_frame=1,
        replaces=["composite_stream.py:82", "composite.py:167"]),
    "composite_bwd": dict(
        wrapper=composite_bwd_cuda, per_step=1, per_slab_render=N_SLABS,
        per_band_render=N_BANDS, per_sharded_step=N_SHARDS, per_eval_view=0,
        per_view_frame=0,
        replaces=["composite_stream.py:230", "composite.py:406"]),
    "slab_tmit": dict(
        wrapper=slab_transmittance_cuda, per_step=0,
        per_slab_render=N_SLABS - 1, per_band_render=0, per_sharded_step=0,
        per_eval_view=0, per_view_frame=0, replaces=["composite.py:326"]),
    "scan": dict(wrapper=blocked_cumsum_16_cuda, per_step=0,
                 per_slab_render=0, per_band_render=0,
                 per_sharded_step=N_SHARDS, per_eval_view=0,
                 per_view_frame=0, replaces=["scan.py:49"]),
    "ssim_fwd": dict(wrapper=ssim_fwd_cuda, per_step=1, per_slab_render=0,
                     per_band_render=0, per_sharded_step=1, per_eval_view=1,
                     per_view_frame=0, replaces=["ssim_kernel.py:90"]),
    "ssim_bwd": dict(wrapper=ssim_bwd_cuda, per_step=1, per_slab_render=0,
                     per_band_render=0, per_sharded_step=1, per_eval_view=0,
                     per_view_frame=0, replaces=["ssim_kernel.py:98"]),
    # the port's own pair (no TPU kernel): once per single render and its
    # backward; the split and sharded paths preprocess on the plain path
    "preprocess_fwd": dict(wrapper=preprocess_fwd_cuda, per_step=1,
                           per_slab_render=0, per_band_render=0,
                           per_sharded_step=0, per_eval_view=1,
                           per_view_frame=1, replaces=[]),
    "preprocess_bwd": dict(wrapper=preprocess_bwd_cuda, per_step=1,
                           per_slab_render=0, per_band_render=0,
                           per_sharded_step=0, per_eval_view=0,
                           per_view_frame=0, replaces=[]),
    # the port's own pair (no TPU kernel): the entry gather of every single
    # render and its backward, also where the preprocess is plain; the
    # split and sharded paths gather on their own
    "gather_entries_fwd": dict(wrapper=gather_entries_fwd_cuda, per_step=1,
                               per_slab_render=0, per_band_render=0,
                               per_sharded_step=0, per_eval_view=1,
                               per_view_frame=1, replaces=[]),
    "gather_entries_bwd": dict(wrapper=gather_entries_bwd_cuda, per_step=1,
                               per_slab_render=0, per_band_render=0,
                               per_sharded_step=0, per_eval_view=0,
                               per_view_frame=0, replaces=[]),
}
# the kernels only a backward launches
BACKWARD_ONLY = ("composite_bwd", "scan", "preprocess_bwd",
                 "gather_entries_bwd")
# the kernels only a loss launches
LOSS_ONLY = ("ssim_fwd", "ssim_bwd")


def reset_launches():
    for k in KERNELS.values():
        k["wrapper"].launches = 0


def read_launches():
    return {name: k["wrapper"].launches for name, k in KERNELS.items()}


def check_launches(got, key, times, what, backward=True, never=()):
    """Every kernel launched exactly its ``key`` count times ``times``; a
    run without a backward launched the backward's kernels no time, and the
    kernels named in ``never`` no time either."""
    for name, k in KERNELS.items():
        idle = name in never or (not backward and name in BACKWARD_ONLY)
        want = 0 if idle else k[key] * times
        check(got[name] == want, f"{name} launched {got[name]} times in "
              f"{what}, expected {want}")


def train_phase(g, cam, gt, cfg):
    """bench.py's train step at full width: a warm-up step, then N_STEPS
    timed steps with every kernel's launch count read around exactly
    those; then the checks on the gradients and the update."""
    opt = OptimizationConfig()
    state = trainer.init_state(g, 1)
    state, aux = train(state, cam, gt, cfg, opt)             # warm-up
    torch.cuda.synchronize()
    check(int(aux.overflow) == 0, f"overflow {int(aux.overflow)}")
    xyz0 = state.gaussians.xyz.clone()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    step_ms, losses, overflow = [], [], []
    for _ in range(N_STEPS):
        t = time.perf_counter()
        state, aux = train(state, cam, gt, cfg, opt)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t) * 1e3)
        losses.append(float(aux.loss))
        overflow.append(int(aux.overflow))
    launches = read_launches()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    check_launches(launches, "per_step", N_STEPS, f"{N_STEPS} steps")
    check(all(np.isfinite(losses)), f"non-finite loss {losses}")
    check(max(overflow) == 0, f"overflow {overflow}")
    moved = float((state.gaussians.xyz - xyz0).abs().max())
    check(moved > 0, "the parameters did not change")

    # the gradients of one more step's loss: finite everywhere, zero on
    # gaussians no pixel sees, non-zero on most of those it sees
    loss, _, _, out, grads, _, tap = trainer.camera_loss_grads(
        state.gaussians, state.exposure, cam, gt,
        torch.ones((1, H, W), device=gt.device),
        torch.zeros((1, H, W), device=gt.device),
        torch.zeros((1, H, W), device=gt.device),
        torch.zeros(3, device=gt.device), state.step + 1, image_width=W,
        image_height=H, opt=opt, rcfg=cfg, antialiasing=False,
        train_test_exp=False, use_depth=False)
    vis = out.radii > 0
    for k, v in list(grads.items()) + [("mean2d tap", tap)]:
        check(bool(torch.isfinite(v).all()), f"non-finite gradient of {k}")
        check(float(v[~vis].abs().sum()) == 0.0,
              f"gradient of {k} on invisible gaussians")
    nonzero = float((grads["xyz"][vis].abs().amax(dim=1) > 0).float().mean())
    check(nonzero > 0.5, f"only {nonzero:.3f} of visible gaussians have a "
          f"non-zero xyz gradient")
    print(f"train {W}x{H}, {N_GAUSS} gaussians, SH 3: step ms "
          f"{[round(x, 3) for x in step_ms]} (median "
          f"{np.median(step_ms):.3f}), losses "
          f"{[round(x, 6) for x in losses]}, "
          f"launches {launches}, peak memory {peak_gb:.2f} GB, visible "
          f"{int(vis.sum())}, non-zero xyz grad on {nonzero:.4f} of them, "
          f"max |xyz change| {moved:.3e}", flush=True)
    return state, launches, float(np.median(step_ms))


def l1_grads(render, g, gt):
    """Gradients of mean |image - gt| with respect to the trainables, for
    ``render(gaussians) -> image``. Returns (loss, {field: gradient})."""
    params = {k: getattr(g, k).detach().clone().requires_grad_()
              for k in gm.TRAINABLE_FIELDS}
    loss = (render(gm.with_trainables(g, params)) - gt).abs().mean()
    loss.backward()
    return float(loss.detach()), {k: v.grad for k, v in params.items()}


def hold_grads(label, against, grads, want, vis):
    """Hold the gradients ``grads`` of a split render to ``want``: finite,
    zero on gaussians no pixel sees, every element within SLAB_GRAD_TOL,
    and each field's largest error within SLAB_GRAD_REL_MAX of its largest
    gradient. Returns the worst ratio of the two."""
    grad_err = {}
    for k, v in grads.items():
        check(bool(torch.isfinite(v).all()),
              f"{label}: non-finite gradient of {k}")
        check(float(v[~vis].abs().sum()) == 0.0,
              f"{label}: gradient of {k} on invisible gaussians")
        d = (v - want[k]).abs()
        out = d > SLAB_GRAD_TOL["atol"] + SLAB_GRAD_TOL["rtol"] * want[k].abs()
        grad_err[k] = (float(d.max()), float(want[k].abs().max()),
                       float(out.float().mean()))
    print(f"{label} gradients vs {against} (max abs err, max |grad|, "
          f"share outside rtol {SLAB_GRAD_TOL['rtol']} / atol "
          f"{SLAB_GRAD_TOL['atol']}; also held: max abs err <= "
          f"{SLAB_GRAD_REL_MAX} x max |grad|): "
          + "; ".join(f"{k} {a:.3e} {b:.3e} {c:.2e}"
                      for k, (a, b, c) in grad_err.items()), flush=True)
    for k, (err, size, share) in grad_err.items():
        check(share == 0.0, f"{label} gradient of {k} outside the gate on "
              f"{share} of its elements")
        check(size > 0 and err <= SLAB_GRAD_REL_MAX * size,
              f"{label} gradient of {k}: max error {err} against a largest "
              f"gradient of {size}")
    return max(err / size for err, size, _ in grad_err.values())


def slab_phase(g, cams, cam, gt, cfg, m_cap, pairs):
    """Phase 6: the depth-slab and tile-band renders at full width on the
    training scene, held to the single render and its gradient. Returns the
    launch counts of the slab path (forward renders plus one backward) and
    of the band path."""
    bg = torch.zeros(3, device=gt.device)

    def slab(p, c):
        return prim_shard.render_prim_sharded(p, c, W, H, bg, cfg,
                                              n_slabs=N_SLABS, m_cap=m_cap)

    def band(p, c):
        return tile_shard.render_tile_sharded(p, c, W, H, bg, cfg,
                                              n_bands=N_BANDS)

    with torch.no_grad():
        singles = [rasterize.render(g, c, W, H, bg, cfg) for c in cams]
        slab(g, cams[0])                                     # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        frame_ms, img_err = [], []
        for c, single in zip(cams, singles):
            t = time.perf_counter()
            img, inv, overflow = slab(g, c)
            torch.cuda.synchronize()
            frame_ms.append((time.perf_counter() - t) * 1e3)
            check(int(overflow) == 0, f"slab overflow {int(overflow)}")
            check(int(single.overflow) == 0, "single render overflow")
            check(tuple(img.shape) == (3, H, W), f"image shape {img.shape}")
            check(bool(torch.isfinite(img).all())
                  and bool(torch.isfinite(inv).all()), "non-finite image")
            check(float(img.std()) > 0.01 and float(img.max()) > 0.1,
                  "blank image")
            img_err.append(max(float((img - single.image).abs().max()),
                               float((inv - single.invdepth).abs().max())))
            check(img_err[-1] <= 1e-3, f"slab render is {img_err[-1]} from "
                  f"the single render")
        fwd_launches = read_launches()
        check_launches(fwd_launches, "per_slab_render", N_POSES,
                       f"{N_POSES} slab renders", backward=False)
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
    del singles

    # one forward plus backward of an L1 loss against the training frame's
    # ground truth, held to the single render's gradient
    reset_launches()
    torch.cuda.synchronize()
    t = time.perf_counter()
    loss, grads = l1_grads(lambda p: slab(p, cam)[0], g, gt)
    torch.cuda.synchronize()
    fb_ms = (time.perf_counter() - t) * 1e3
    fb_launches = read_launches()
    check_launches(fb_launches, "per_slab_render", 1,
                   "one slab forward plus backward")
    loss1, want = l1_grads(
        lambda p: rasterize.render(p, cam, W, H, bg, cfg).image, g, gt)
    with torch.no_grad():
        vis = rasterize.render(g, cam, W, H, bg, cfg).radii > 0
    check(np.isfinite(loss) and abs(loss - loss1) <= 1e-4,
          f"slab loss {loss} vs single {loss1}")
    hold_grads("slab", "the single render's", grads, want, vis)
    slab_launches = {k: fwd_launches[k] + fb_launches[k] for k in KERNELS}
    print(f"slab render {W}x{H}, {N_GAUSS} gaussians, SH 3, {N_SLABS} slabs, "
          f"{N_POSES} poses: frame ms {[round(x, 3) for x in frame_ms]} "
          f"(median {np.median(frame_ms):.3f}), max |image - single| "
          f"{max(img_err):.3e}, pairs per slab {pairs}, per-slab m_cap "
          f"{m_cap}, launches {fwd_launches}, peak memory {peak_gb:.2f} GB; "
          f"forward plus backward of an L1 loss {fb_ms:.3f} ms, loss "
          f"{loss:.6f} (single {loss1:.6f}), launches {fb_launches}",
          flush=True)

    # the tile-band render: tiles are independent, so it is the single
    # render's image
    with torch.no_grad():
        single = rasterize.render(g, cam, W, H, bg, cfg)
        band(g, cam)                                         # warm-up
        torch.cuda.synchronize()
        reset_launches()
        band_ms = []
        for _ in range(N_POSES):
            t = time.perf_counter()
            img, inv, num_pairs, overflow = band(g, cam)
            torch.cuda.synchronize()
            band_ms.append((time.perf_counter() - t) * 1e3)
        check(int(overflow) == 0, f"band overflow {int(overflow)}")
        check(int(num_pairs) == int(single.num_pairs), "band pair count")
        for a, b in ((img, single.image), (inv, single.invdepth)):
            check(torch.allclose(a, b, **SLAB_TOL), "band render differs "
                  f"from the single render by {float((a - b).abs().max())}")
        band_err = float((img - single.image).abs().max())
    check_launches(read_launches(), "per_band_render", N_POSES,
                   f"{N_POSES} band renders", backward=False)
    reset_launches()
    t = time.perf_counter()
    _, band_grads = l1_grads(lambda p: band(p, cam)[0], g, gt)
    torch.cuda.synchronize()
    band_fb_ms = (time.perf_counter() - t) * 1e3
    band_launches = read_launches()
    check_launches(band_launches, "per_band_render", 1,
                   "one band forward plus backward")
    for k, v in band_grads.items():
        check(torch.allclose(v, want[k], **GRAD_TOL), f"band gradient of "
              f"{k} differs by {float((v - want[k]).abs().max())}")
    print(f"band render, {N_BANDS} bands: frame ms "
          f"{[round(x, 3) for x in band_ms]} (median "
          f"{np.median(band_ms):.3f}), max |image - single| {band_err:.3e}, "
          f"forward plus backward {band_fb_ms:.3f} ms, launches "
          f"{band_launches}, gradients within rtol {GRAD_TOL['rtol']} / "
          f"atol {GRAD_TOL['atol']} of the single render's", flush=True)

    def one_slab_render():
        with torch.no_grad():
            slab(g, cam)
    profile_call("one slab render", one_slab_render)
    return slab_launches, band_launches


def band_pairs(g, cam, cfg, n=N_SHARDS):
    """pairs[k][o]: the (tile, gaussian) pairs that owner o's rows put into
    shard k's band of tile rows, for n row shards and bands."""
    with torch.no_grad():
        pre = rasterize.build_entries(g, cam, W, H, cfg).pre
    th, tw = cfg.tile_h, cfg.tile_w
    rows_loc = -(-(-(-H // th)) // n)
    valid = (pre.radius > 0) & (pre.rx > 0) & (pre.ry > 0)
    table = []
    for k in range(n):
        x0, y0, x1, y1 = binning_lib.tile_rect(
            pre.mean2d, pre.rx, pre.ry, -(-W // tw), rows_loc, th, tw,
            tile_row_base=k * rows_loc)
        counts = torch.where(valid, torch.clamp(x1 - x0, min=0)
                             * torch.clamp(y1 - y0, min=0), 0)
        table.append(counts.reshape(n, -1).sum(dim=1).tolist())
    return table


def sharded_setup(g, cams, cfg, n=N_SHARDS):
    """The sharded paths' config for n shards, its pair capacity
    right-sized from a probe of every camera of phase 7: a shard's list
    must hold 1.3x the fullest band's pairs, and in the slab transient
    every arriving slab gets 1/n of that list to itself, so 1/n must hold
    1.3x the most any one owner puts into any band. Returns (config,
    per-shard capacity, the first camera's pairs[k][o])."""
    tables = [band_pairs(g, cam, cfg, n) for cam in cams]
    per_band = max(sum(row) for t in tables for row in t)
    per_slab = max(max(row) for t in tables for row in t)
    need = int(1.3 * max(per_band, n * per_slab))
    scfg = dataclasses.replace(
        cfg, pairs_per_gaussian=(need + cfg.chunk) * n / (1.5 * N_GAUSS))
    m_loc = sharded.shard_capacity(N_GAUSS, scfg, n)
    check(need <= m_loc <= need + 2 * cfg.chunk,
          f"per-shard capacity {m_loc}, wanted {need}")
    return scfg, m_loc, tables[0]


def check_scan(dev, rng, m_rows):
    """Phase 3d: the blocked prefix sum at (m_rows, 16), the rows one
    shard's backward of phase 7 scans, against a float64 cumsum and against
    its plain version. The plain version is ``torch.cumsum`` over the
    (B, L, 16) view, which is also the one library call that computes this
    function, so ``library_ms`` times the same call."""
    L = SCAN_BLOCK
    B = m_rows // L
    x = torch.tensor(rng.standard_normal((m_rows, 16)).astype(np.float32),
                     device=dev)
    intra, tot = blocked_cumsum_16_cuda(x, L)
    torch.cuda.synchronize()
    plain, plain_tot = blocked_cumsum_16_plain(x, L)
    ref = torch.cumsum(x.double().reshape(B, L, 16), dim=1).reshape(m_rows, 16)
    err = float((intra.double() - ref).abs().max())
    lib_err = float((plain.double() - ref).abs().max())
    vs_plain = float((intra - plain).abs().max())
    # (a) the gate: no more than twice as far from float64 as torch.cumsum
    check(err <= 2 * lib_err, f"scan is {err} from the float64 cumsum, "
          f"torch.cumsum in f32 {lib_err}")
    check(torch.equal(tot, intra[L - 1::L]),
          "scan: block_tot is not intra's last rows")
    check(torch.allclose(tot, plain_tot, rtol=1e-5, atol=1e-3),
          "scan: block_tot disagrees with the plain version")
    # (b) integers below 2^24 in every partial sum: exact in any order
    xi = torch.tensor(rng.integers(0, 2048, (m_rows, 16)).astype(np.float32),
                      device=dev)
    ki, kt = blocked_cumsum_16_cuda(xi, L)
    pi, pt = blocked_cumsum_16_plain(xi, L)
    check(torch.equal(ki, pi) and torch.equal(kt, pt),
          "scan: not exact on integers")
    # (c) NaN in every row no live presort entry points at: the mask of
    # masked_presort_prefix must keep them out of every prefix and total
    m_cap, total = m_rows - 100, m_rows - 5000
    m_out = m_cap + 3000
    inv_src = torch.tensor(rng.permutation(m_out)[:m_cap], device=dev)
    d_aligned = torch.tensor(
        rng.standard_normal((m_out, 16)).astype(np.float32), device=dev)
    d_aligned[inv_src[total:]] = float("nan")
    mi, mb, _ = rasterize.masked_presort_prefix(
        d_aligned, inv_src, torch.tensor(total, device=dev), m_cap)
    check(bool(torch.isfinite(mi).all()) and bool(torch.isfinite(mb).all()),
          "scan: a NaN past the live rows reached a prefix")
    want = d_aligned[inv_src[:total]].double().sum(dim=0)
    got = rasterize._prefix_at(mi, mb, L, torch.tensor([m_cap], device=dev))[0]
    check(torch.allclose(got.double(), want, rtol=1e-4, atol=1e-2),
          "scan: the prefix at the end is not the sum of the live rows")
    # (d) a fixed order of additions: the same bits on a second launch
    again, tot2 = blocked_cumsum_16_cuda(x, L)
    check(torch.equal(again, intra) and torch.equal(tot2, tot),
          "scan: two launches on one input differ")

    ms = median_ms(lambda: blocked_cumsum_16_cuda(x, L), 20)
    plain_ms = median_ms(lambda: blocked_cumsum_16_plain(x, L), 20)
    view = x.view(B, L, 16)
    library_ms = median_ms(lambda: torch.cumsum(view, dim=1), 20)
    # by CUDA events a call this short is as long as its wrapper's host
    # time; the profiler reads the kernels' own time on the device
    dev_ms = kernel_device_ms(lambda: blocked_cumsum_16_cuda(x, L), 20)
    lib_dev_ms = kernel_device_ms(lambda: torch.cumsum(view, dim=1), 20)
    bnd = bound(m_rows * 128 + B * 64, m_rows * 16)
    print(f"kernel vs plain: scan at ({m_rows}, 16), {B} blocks of {L}: "
          f"max_abs_err against the float64 cumsum {err:.3e} (torch.cumsum "
          f"in f32: {lib_err:.3e}; gate: at most twice that), against the "
          f"plain version {vs_plain:.3e}; exact on integers; finite with a "
          f"NaN tail; two launches equal; kernel {ms:.4f} ms, plain "
          f"{plain_ms:.4f} ms, torch.cumsum {library_ms:.4f} ms (CUDA "
          f"events around one call); on the device alone, by the profiler: "
          f"kernel {dev_ms:.4f} ms, torch.cumsum {lib_dev_ms:.4f} ms; bound "
          f"{bnd['bound_ms']:.4f} ms ({bnd['bound_by']})", flush=True)
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                library_ms=library_ms, device_ms=dev_ms,
                library_device_ms=lib_dev_ms, **bnd)


@contextlib.contextmanager
def plain_preprocess():
    """Inside the block the single render preprocesses on the plain path
    (``preprocess_packed_plain``), as the gaussian-sharded paths still do:
    their oracle, like for like, at their gates of a few ulps. The fused
    pair against the plain path is phase 3b's."""
    from gsplat_tpu_torch.ops import preprocess as pre_lib
    fused = pre_lib.preprocess_packed
    pre_lib.preprocess_packed = pre_lib.preprocess_packed_plain
    try:
        yield
    finally:
        pre_lib.preprocess_packed = fused


def single_loss_grads(g, exposure, cam, gt, bg, cfg, opt):
    """The sharded step's loss, (1 - l)·L1 + l·(1 - SSIM) with the plain
    SSIM, through the single render: (loss, gradients by field, tap
    gradient, radii)."""
    params = {k: v.detach().clone().requires_grad_()
              for k, v in gm.trainables(g).items()}
    tap = torch.zeros((g.capacity, 2), device=g.device, requires_grad=True)
    out = rasterize.render(gm.with_trainables(g, params), cam, W, H, bg, cfg,
                           mean2d_tap=tap)
    loss = (1.0 - opt.lambda_dssim) * losses.l1_loss(out.image, gt) \
        + opt.lambda_dssim * (1.0 - losses.ssim(out.image, gt))
    got = torch.autograd.grad(loss, [*params.values(), tap])
    check(int(out.overflow) == 0, "single render overflow")
    return (float(loss.detach()), dict(zip(params, got[:-1])), got[-1],
            out.radii.detach())


def sharded_phase(state, cams, cam, gt, cfg, scfg, m_loc, pairs):
    """Phase 7: gaussian-sharded storage at full width on the training
    scene, N_SHARDS row shards and bands, each transient held to the single
    render and its gradient. Returns the launch counts summed over the
    three transients' counted renders, steps and gradient calls."""
    dev = gt.device
    g = state.gaussians
    opt = OptimizationConfig()
    bg = torch.zeros(3, device=dev)
    ones = torch.ones((1, H, W), device=dev)
    zeros = torch.zeros((1, H, W), device=dev)
    kw = dict(image_width=W, image_height=H)
    step_kw = dict(opt=opt, rcfg=scfg, antialiasing=False,
                   train_test_exp=False, use_depth=False, **kw)
    print(f"sharded storage: {N_SHARDS} shards of {N_GAUSS // N_SHARDS} rows "
          f"and {-(-(-(-H // cfg.tile_h)) // N_SHARDS)} tile rows; pairs of "
          f"owner o in band k, k by o: {pairs}; per-shard capacity {m_loc} "
          f"(pairs_per_gaussian {scfg.pairs_per_gaussian:.3f})", flush=True)

    with torch.no_grad(), plain_preprocess():
        singles = [rasterize.render(g, c, W, H, bg, cfg) for c in cams]
    with plain_preprocess():
        loss1, want, want_tap, radii1 = single_loss_grads(
            g, state.exposure, cam, gt, bg, cfg, opt)
    vis = radii1 > 0
    total = {name: 0 for name in KERNELS}
    replicated = None
    steps = {}
    for transient in sharded.TRANSIENTS:
        never = ("scan",) if transient == "replicated" else ()
        render = sharded.make_sharded_render(N_SHARDS, cfg=scfg,
                                             transient=transient, **kw)
        step = sharded.make_sharded_train_step(
            N_SHARDS, opt=opt, rcfg=scfg, spatial_lr_scale=1.0,
            transient=transient, **kw)
        steps[transient] = step
        with torch.no_grad():
            render(g, cams[0], bg)                           # warm-up
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            reset_launches()
            frame_ms, img_err = [], []
            for c, single in zip(cams, singles):
                t = time.perf_counter()
                out = render(g, c, bg)
                torch.cuda.synchronize()
                frame_ms.append((time.perf_counter() - t) * 1e3)
                check(int(out.overflow) == 0,
                      f"{transient} overflow {int(out.overflow)}")
                check(int(out.num_pairs) >= int(single.num_pairs),
                      f"{transient} pair count")
                for a, b in ((out.image, single.image),
                             (out.invdepth, single.invdepth)):
                    check(tuple(a.shape) == tuple(b.shape)
                          and bool(torch.isfinite(a).all()),
                          f"{transient}: shape or non-finite image")
                    img_err.append(float((a - b).abs().max()))
                    check(torch.allclose(a, b, **SHARD_IMG_TOL),
                          f"{transient} render is {img_err[-1]} from the "
                          f"single render")
                check(torch.equal(out.radii, single.radii),
                      f"{transient}: radii differ from the single render's")
            got = read_launches()
            check_launches(got, "per_sharded_step", N_POSES,
                           f"{N_POSES} {transient} renders", backward=False,
                           never=LOSS_ONLY)
            total = {k: total[k] + got[k] for k in total}

        # one warm-up and N_SHARD_STEPS timed steps from the phase-5 state
        s, aux = step(state, cam, gt, ones, zeros, zeros, bg)
        torch.cuda.synchronize()
        reset_launches()
        step_ms, step_losses = [], []
        for _ in range(N_SHARD_STEPS):
            t = time.perf_counter()
            s, aux = step(s, cam, gt, ones, zeros, zeros, bg)
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t) * 1e3)
            step_losses.append(float(aux.loss))
            check(int(aux.overflow) == 0, f"{transient} step overflow")
        check(all(np.isfinite(step_losses)), f"non-finite loss {step_losses}")
        check(float((s.gaussians.xyz - g.xyz).abs().max()) > 0,
              f"{transient}: the parameters did not change")
        # the step's loss and gradients on the phase-5 state
        loss, _, _, bands, grads, _, tap = sharded.sharded_loss_grads(
            g, state.exposure, cam, gt, ones, zeros, zeros, bg,
            state.step + 1, n_shards=N_SHARDS, transient=transient,
            **step_kw)
        torch.cuda.synchronize()
        got = read_launches()
        check_launches(got, "per_sharded_step", N_SHARD_STEPS + 1,
                       f"{N_SHARD_STEPS} {transient} steps and one gradient "
                       f"call", never=never)
        total = {k: total[k] + got[k] for k in total}
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        check(abs(float(loss) - loss1) <= 1e-6 * abs(loss1) + 1e-7,
              f"{transient} loss {float(loss)} vs single {loss1}")
        check(torch.equal(bands.radii, radii1), f"{transient}: radii")
        grads = dict(grads, tap=tap)
        worst = hold_grads(transient, "the single render's", grads,
                           dict(want, tap=want_tap), vis)
        if replicated is None:
            replicated = grads
        else:
            worst = max(worst, hold_grads(
                transient, "the replicated transient's", grads, replicated,
                vis))
        print(f"sharded {transient}, {N_SHARDS} shards: frame ms "
              f"{[round(x, 3) for x in frame_ms]} (median "
              f"{np.median(frame_ms):.3f}), max |image - single| "
              f"{max(img_err):.3e}; step ms {[round(x, 3) for x in step_ms]} "
              f"(median {np.median(step_ms):.3f}), losses "
              f"{[round(x, 6) for x in step_losses]}, loss on the phase-5 "
              f"state {float(loss):.6f} (single {loss1:.6f}), worst "
              f"gradient error {worst:.3e} of a field's largest gradient, "
              f"launches in {N_SHARD_STEPS} steps and one gradient call "
              f"{got}, peak memory {peak_gb:.2f} GB", flush=True)

    # one ring step profiled with the loss's SSIM on the fused kernels, and
    # with the plain SSIM the sharded loss took before (``losses.ssim`` on
    # CUDA tensors ran the plain blur), in turns: new, old, old, new, new,
    # old
    def ring_step():
        steps["ring"](state, cam, gt, ones, zeros, zeros, bg)

    def plain_ssim(a, b):
        return ssim_lib.ssim_map(a, b).mean()
    busy = {"fused": [], "plain": []}
    for form in ("fused", "plain", "plain", "fused", "fused", "plain"):
        fused = losses.ssim
        if form == "plain":
            losses.ssim = plain_ssim
        try:
            busy[form].append(profile_call(
                f"one sharded ring step, {form} SSIM", ring_step, n_top=15))
        finally:
            losses.ssim = fused
    print(f"sharded ring step device busy ms: fused SSIM "
          f"{[round(x, 3) for x in busy['fused']]}, plain SSIM "
          f"{[round(x, 3) for x in busy['plain']]}", flush=True)
    return total


# --------------------------------------------------------- phases 5b, 7b
# Per-tile-row ellipse culling (the config's ``row_cull``) off and on in
# this one process, on phase 5's scene: the culled pairs against the
# rectangles' (a subset per tile, every dropped pair below the alpha floor
# at every pixel of its tile), the kernels on the culled list against their
# plain versions and timed beside the rectangle list, the image and the
# step's gradients, frame and step medians in turns with device busy; then
# (7b) one culled frame of each split and sharded path against the single
# culled render, and one culled ring step.
CULL_ROUNDS = 3            # rounds of (off, on, on, off) frames and steps
CULL_CHUNK = 1 << 15       # dropped pairs checked per pass


def culled(cfg):
    return dataclasses.replace(cfg, row_cull=True)


class LaunchDelta:
    """Launch counts summed over the calls made inside ``with`` blocks
    only: the culled calls of turns that interleave both forms."""

    def __init__(self):
        self.total = {name: 0 for name in KERNELS}

    def __enter__(self):
        self._before = read_launches()

    def __exit__(self, *exc):
        after = read_launches()
        for k in self.total:
            self.total[k] += after[k] - self._before[k]
        return False


def pair_keys(e):
    """tile · (N+1) + storage row of every entry in a tile's range, and N."""
    b = e.binning
    n = b.perm.shape[0]
    tc = b.tile_count.long()
    tiles = torch.repeat_interleave(
        torch.arange(tc.numel(), device=tc.device), tc)
    first = torch.cumsum(tc, 0) - tc
    pos = (b.tile_start.long()[tiles] - first[tiles]
           + torch.arange(tiles.numel(), device=tc.device))
    perm_ext = torch.cat([b.perm, b.perm.new_full((1,), n)])
    return tiles * (n + 1) + perm_ext[b.gidx_sorted[pos]], n


def check_cull_exact(label, e_rect, e_cull, cfg):
    """On the device: every tile's culled set is a subset of its rectangle
    set, and every dropped pair has q > t_cut at every pixel of its whole
    tile (alpha below alpha_min: what the compositor skips). Returns
    (rect pairs, culled pairs, dropped pairs, the smallest margin)."""
    k0, n = pair_keys(e_rect)
    k1, _ = pair_keys(e_cull)
    extra = int((~torch.isin(k1, k0)).sum())
    check(extra == 0, f"{label}: row culling ADDED {extra} pairs")
    drop = k0[~torch.isin(k0, k1)]
    pre = e_rect.pre
    th, tw, ntx = cfg.tile_h, cfg.tile_w, e_rect.n_tiles_x
    dev = drop.device
    py, px = torch.meshgrid(torch.arange(th, device=dev),
                            torch.arange(tw, device=dev), indexing="ij")
    py, px = py.reshape(1, -1), px.reshape(1, -1)
    bad, margin = 0, float("inf")
    for s in range(0, drop.numel(), CULL_CHUNK):
        t, g = drop[s:s + CULL_CHUNK] // (n + 1), drop[s:s + CULL_CHUNK] % (
            n + 1)
        dx = ((t % ntx)[:, None] * tw + px).float() - pre.mean2d[g, 0:1]
        dy = ((t // ntx)[:, None] * th + py).float() - pre.mean2d[g, 1:2]
        c = pre.conic[g]
        q = (c[:, 0:1] * dx * dx + 2 * c[:, 1:2] * dx * dy
             + c[:, 2:3] * dy * dy)
        m = q.amin(dim=1) - pre.t_cut[g]
        bad += int((m <= 0).sum())
        if m.numel():
            margin = min(margin, float(m.min()))
    check(bad == 0, f"{label}: {bad} dropped pairs pass the alpha test at a "
          f"pixel of their tile")
    return k0.numel(), k1.numel(), drop.numel(), margin


def cull_kernels(e0, e1, cfg, rng):
    """composite_fwd and composite_bwd on the culled list against their
    plain versions (the forward on the whole frame, the backward on 16
    tiles), then both kernels timed on both lists in turns (off, on, on,
    off), with their bounds on each. The contributing pairs the bounds
    charge are the same on both lists (culling drops only pairs that pass
    no alpha test), counted by the walk of the culled list."""
    geo = dict(n_tiles_x=e1.n_tiles_x, n_tiles_y=e1.n_tiles_y,
               tile_h=cfg.tile_h, tile_w=cfg.tile_w,
               alpha_min=cfg.alpha_min, alpha_max=cfg.alpha_max)
    fwd_kw = dict(chunk=cfg.chunk, t_eps=cfg.transmittance_eps)
    full = dict(geo, **fwd_kw)
    lists = [(e.entries, e.binning.tile_start, e.binning.tile_count)
             for e in (e0, e1)]
    label = "training frame, row_cull"
    kern1, f_err, mismatch, f_plain_ms = fwd_vs_plain(label, lists[1], full)
    with torch.no_grad():
        kern0 = composite_fwd_cuda(*lists[0], **full)
    fwd_bits = all(torch.equal(getattr(kern0, k), getattr(kern1, k))
                   for k in ("accum", "t_final"))
    walk = pair_walk(label, *lists[1], full,
                     device_cull_rects(label, *lists[1], full),
                     kern1.n_contrib)
    print(walk_line(label, walk), flush=True)
    T, P = e1.n_tiles_x * e1.n_tiles_y, cfg.tile_h * cfg.tile_w
    ga, gt = cotangents(rng, T, P, e1.entries.device)
    tc = pick_tiles(e1.binning.tile_count, rng)
    b_err, _, b_plain_ms = bwd_vs_plain(label, lists[1][0], lists[1][1], tc,
                                        ga, gt, geo, fwd_kw)
    bwd_args = [(*a, k.t_final, k.n_contrib, ga, gt)
                for a, k in zip(lists, (kern0, kern1))]
    ms = {"fwd": ([], []), "bwd": ([], [])}
    with torch.no_grad():
        for i in (0, 1, 1, 0):
            ms["fwd"][i].append(median_ms(
                lambda: composite_fwd_cuda(*lists[i], **full), 20))
            ms["bwd"][i].append(median_ms(
                lambda: composite_bwd_cuda(*bwd_args[i], **geo), 20))
    hits = walk["hits"]
    out = {}
    for name, ops, work in (
            ("composite_fwd", OPS_PER_EVAL,
             lambda a, k: fwd_work(a[2], k.n_contrib)),
            ("composite_bwd", OPS_PER_EVAL_BWD,
             lambda a, k: bwd_work(a[0].shape[0], a[2], k.n_contrib))):
        key = "fwd" if name == "composite_fwd" else "bwd"
        bnds = [bound(work(a, k)[2], hits * ops)
                for a, k in zip(lists, (kern0, kern1))]
        rows = [work(a, k)[0] for a, k in zip(lists, (kern0, kern1))]
        out[name] = dict(
            max_abs_err=f_err if key == "fwd" else b_err,
            plain_ms=f_plain_ms if key == "fwd" else b_plain_ms,
            ms=float(np.median(ms[key][1])),
            rect_ms=float(np.median(ms[key][0])), rows=rows[1],
            rect_rows=rows[0], rect_bound_ms=bnds[0]["bound_ms"], **bnds[1])
        print(f"row_cull kernels: {name} on the culled list "
              f"{out[name]['ms']:.3f} ms ({rows[1]} rows read, bound "
              f"{bnds[1]['bound_ms']:.4f} ms, {bnds[1]['bound_by']}) against "
              f"the rectangle list {out[name]['rect_ms']:.3f} ms ({rows[0]} "
              f"rows, bound {bnds[0]['bound_ms']:.4f} ms), turns "
              f"{[round(x, 3) for x in ms[key][0] + ms[key][1]]} "
              f"(off, off, on, on); vs plain max_abs_err "
              f"{out[name]['max_abs_err']:.3e}", flush=True)
    out["composite_fwd"]["bits_equal_rect"] = fwd_bits
    out["composite_fwd"]["n_contrib_mismatch"] = mismatch
    return out


def cull_turns(g, cam, gt, W, H, cfg, state):
    """Frames and train steps of ``g`` from ``cam`` (W x H, target ``gt``)
    with ``cfg`` and its culled form, in turns (off, on, on, off, times
    CULL_ROUNDS; host clock, synchronised), then one profiled frame and
    step of each. Returns (host median ms {"frame": [off, on], "step":
    [off, on]}, device busy ms by "frame off" ... "step on", the culled
    calls' launches)."""
    dev = gt.device
    ccfg = culled(cfg)
    opt = OptimizationConfig()
    bg = torch.zeros(3, device=dev)
    ones = torch.ones((1, H, W), device=dev)
    zeros = torch.zeros((1, H, W), device=dev)

    def frame(c):
        with torch.no_grad():
            return rasterize.render(g, cam, W, H, bg, c)

    def step(c):
        return trainer.train_step(
            state, cam, gt, ones, zeros, zeros, bg, image_width=W,
            image_height=H, opt=opt, rcfg=c, spatial_lr_scale=1.0,
            antialiasing=False, use_sparse_adam=False, train_test_exp=False,
            use_depth=False)

    culled_calls = LaunchDelta()
    ms = {"frame": ([], []), "step": ([], [])}
    for i in (0, 1, 1, 0) * CULL_ROUNDS:
        c = (cfg, ccfg)[i]
        with contextlib.ExitStack() as stack:
            if i:
                stack.enter_context(culled_calls)
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = frame(c)
            torch.cuda.synchronize()
            ms["frame"][i].append((time.perf_counter() - t) * 1e3)
            check(int(out.overflow) == 0, "row_cull frame overflow")
            t = time.perf_counter()
            _, aux = step(c)
            torch.cuda.synchronize()
            ms["step"][i].append((time.perf_counter() - t) * 1e3)
            check(int(aux.overflow) == 0 and np.isfinite(float(aux.loss)),
                  "row_cull step")
    busy = {}
    for i, c in ((0, cfg), (1, ccfg)):
        tag = ("off", "on")[i]
        busy[f"frame {tag}"] = profile_call(f"one frame, row_cull {tag}",
                                            lambda: frame(c))
        busy[f"step {tag}"] = profile_call(
            f"one train step, row_cull {tag}", lambda: step(c), n_top=15)
    med = {k: [float(np.median(v[0])), float(np.median(v[1]))]
           for k, v in ms.items()}
    return med, busy, culled_calls.total


def row_cull_phase(g, cam, gt, cfg, rng):
    """Phase 5b. Returns (the culled calls' launches, the kernels' numbers
    on the culled list)."""
    dev = gt.device
    ccfg = culled(cfg)
    opt = OptimizationConfig()
    bg = torch.zeros(3, device=dev)
    with torch.no_grad():
        e0 = rasterize.build_entries(g, cam, W, H, cfg)
        e1 = rasterize.build_entries(g, cam, W, H, ccfg)
    for e in (e0, e1):
        check(int(e.binning.overflow) == 0, "row_cull phase overflow")
    n_rect, n_cull, n_drop, margin = check_cull_exact(
        "training frame", e0, e1, cfg)
    check(int(e0.binning.num_pairs) == n_rect
          and int(e1.binning.num_pairs) == n_cull, "row_cull pair counts")
    numbers = cull_kernels(e0, e1, cfg, rng)
    del e0, e1

    # the image and the step's gradients, off against on
    with torch.no_grad():
        r0 = rasterize.render(g, cam, W, H, bg, cfg)
        r1 = rasterize.render(g, cam, W, H, bg, ccfg)
    img_bits = (torch.equal(r0.image, r1.image)
                and torch.equal(r0.invdepth, r1.invdepth))
    img_err = max(float((r0.image - r1.image).abs().max()),
                  float((r0.invdepth - r1.invdepth).abs().max()))
    check(torch.allclose(r1.image, r0.image, **IMG_TOL)
          and torch.allclose(r1.invdepth, r0.invdepth, **IMG_TOL),
          f"row_cull image {img_err} from the rectangle render's")
    state = trainer.init_state(g, 1)
    with deterministic():
        _, want, want_tap, _ = single_loss_grads(
            g, state.exposure, cam, gt, bg, cfg, opt)
        _, got, got_tap, _ = single_loss_grads(
            g, state.exposure, cam, gt, bg, ccfg, opt)
    got, want = dict(got, tap=got_tap), dict(want, tap=want_tap)
    grad_bits = all(torch.equal(got[k], want[k]) for k in want)
    grad_err = {k: float((got[k] - want[k]).abs().max()) for k in want}
    for k in want:
        check(torch.allclose(got[k], want[k], **GRAD_TOL),
              f"row_cull gradient of {k} differs by {grad_err[k]}")

    # frames and steps in turns, the culled ones' launches counted
    med, busy, culled_total = cull_turns(g, cam, gt, W, H, cfg, state)
    n = 2 * CULL_ROUNDS
    want = {name: k["per_step"] * n for name, k in KERNELS.items()}
    want["composite_fwd"] += n                  # the frames
    want["preprocess_fwd"] += n
    want["gather_entries_fwd"] += n
    check(culled_total == want, f"{n} culled frames and {n} culled "
          f"steps launched {culled_total}, expected {want}")
    print(f"row_cull {W}x{H}, {N_GAUSS} gaussians, SH 3 (phase 5's scene): "
          f"pairs {n_rect} -> {n_cull} ({n_cull / n_rect:.4f}; {n_drop} "
          f"dropped, every one a subset pair below the alpha floor at every "
          f"pixel of its tile, smallest margin q - t_cut {margin:.3e}); "
          f"image {'bit for bit' if img_bits else 'not bit for bit'} the "
          f"rectangle render's (max {img_err:.3e}); the forward kernel's "
          f"outputs {'bit for bit' if numbers['composite_fwd']['bits_equal_rect'] else 'not bit for bit'} "
          f"on the two lists; step gradients (deterministic algorithms) "
          f"{'bit for bit' if grad_bits else 'within rtol 5e-3 / atol 1e-6'}"
          f" (max {max(grad_err.values()):.3e}); host-clock median frame ms "
          f"off / on {med['frame'][0]:.3f} / {med['frame'][1]:.3f}, step ms "
          f"{med['step'][0]:.3f} / {med['step'][1]:.3f} (turns off, on, on, "
          f"off x {CULL_ROUNDS}); device busy ms frame "
          f"{busy['frame off']:.3f} / {busy['frame on']:.3f}, step "
          f"{busy['step off']:.3f} / {busy['step on']:.3f}; launches of the "
          f"culled calls {culled_total}", flush=True)
    return culled_total, numbers


def row_cull_split_phase(state, cam, gt, cfg, scfg, m_cap):
    """Phase 7b: one culled frame of the slab, band and three sharded
    paths against the single culled render at phases 6-7's gates, and one
    culled ring step; ``slab_tmit`` on a culled slab and the scan on the
    culled step's presort rows against their plain versions. Returns the
    counted calls' launches."""
    dev = gt.device
    g = state.gaussians
    ccfg, cscfg = culled(cfg), culled(scfg)
    bg = torch.zeros(3, device=dev)
    ones = torch.ones((1, H, W), device=dev)
    zeros = torch.zeros((1, H, W), device=dev)
    kw = dict(image_width=W, image_height=H)
    with torch.no_grad(), plain_preprocess():
        single = rasterize.render(g, cam, W, H, bg, ccfg)
    with torch.no_grad():
        slabs = prim_shard.build_slab_entries(g, cam, W, H, ccfg,
                                              n_slabs=N_SLABS, m_cap=m_cap)
        e = slabs[0]
        tkw = dict(n_tiles_x=e.n_tiles_x, n_tiles_y=e.n_tiles_y,
                   tile_h=ccfg.tile_h, tile_w=ccfg.tile_w, chunk=ccfg.chunk,
                   alpha_min=ccfg.alpha_min, alpha_max=ccfg.alpha_max)
        args = (e.entries, e.binning.tile_start, e.binning.tile_count)
        t_k = slab_transmittance_cuda(*args, **tkw)
        t_p = slab_transmittance_plain(*args, **tkw)
    tmit_err = float((t_k - t_p).abs().max())
    check(torch.allclose(t_k, t_p, **SLAB_TOL),
          f"slab_tmit on a culled slab is {tmit_err} from its plain version")
    del slabs, e, args, t_k, t_p

    scans = []
    cumsum = rasterize.blocked_cumsum_16

    def captured(x, L):
        scans.append(x.clone())
        return cumsum(x, L)

    reset_launches()
    errs = {}
    with torch.no_grad():
        img, inv, ovf = prim_shard.render_prim_sharded(
            g, cam, W, H, bg, ccfg, n_slabs=N_SLABS, m_cap=m_cap)
        check(int(ovf) == 0, "culled slab overflow")
        errs["slab"] = max(float((img - single.image).abs().max()),
                           float((inv - single.invdepth).abs().max()))
        check(errs["slab"] <= 1e-3, f"culled slab render {errs['slab']} from "
              f"the single culled render")
        img, inv, _, ovf = tile_shard.render_tile_sharded(
            g, cam, W, H, bg, ccfg, n_bands=N_BANDS)
        check(int(ovf) == 0, "culled band overflow")
        for a, b in ((img, single.image), (inv, single.invdepth)):
            check(torch.allclose(a, b, **SLAB_TOL), "culled band render "
                  f"{float((a - b).abs().max())} from the single culled one")
        errs["band"] = float((img - single.image).abs().max())
        for tr in sharded.TRANSIENTS:
            out = sharded.make_sharded_render(N_SHARDS, cfg=cscfg,
                                              transient=tr, **kw)(g, cam, bg)
            check(int(out.overflow) == 0, f"culled {tr} overflow")
            for a, b in ((out.image, single.image),
                         (out.invdepth, single.invdepth)):
                check(torch.allclose(a, b, **SHARD_IMG_TOL),
                      f"culled {tr} render {float((a - b).abs().max())} "
                      f"from the single culled render")
            errs[tr] = float((out.image - single.image).abs().max())
    step = sharded.make_sharded_train_step(
        N_SHARDS, opt=OptimizationConfig(), rcfg=cscfg, spatial_lr_scale=1.0,
        transient="ring", **kw)
    rasterize.blocked_cumsum_16 = captured
    try:
        _, aux = step(state, cam, gt, ones, zeros, zeros, bg)
        torch.cuda.synchronize()
    finally:
        rasterize.blocked_cumsum_16 = cumsum
    check(int(aux.overflow) == 0 and np.isfinite(float(aux.loss)),
          "culled ring step")
    launches = read_launches()
    want = {name: k["per_slab_render"] + k["per_band_render"]
            + 3 * k["per_sharded_step"] for name, k in KERNELS.items()}
    for name in BACKWARD_ONLY + LOSS_ONLY:
        want[name] = 0
    want = {name: want[name] + KERNELS[name]["per_sharded_step"]
            for name in KERNELS}
    check(launches == want, f"culled split paths launched {launches}, "
          f"expected {want}")
    # the scan kernel on the culled step's presort rows of shard 0
    x = scans[0]
    L = SCAN_BLOCK
    intra, _ = blocked_cumsum_16_cuda(x, L)
    plain, _ = blocked_cumsum_16_plain(x, L)
    ref = torch.cumsum(x.double().reshape(-1, L, 16), dim=1).reshape(-1, 16)
    scan_err = float((intra.double() - ref).abs().max())
    lib_err = float((plain.double() - ref).abs().max())
    check(scan_err <= 2 * lib_err, f"scan on the culled step's rows is "
          f"{scan_err} from float64, torch.cumsum {lib_err}")
    print(f"row_cull split paths on phase 5's scene: max |image - single "
          f"culled render| slab {errs['slab']:.3e}, band {errs['band']:.3e}, "
          f"sharded " + ", ".join(f"{tr} {errs[tr]:.3e}"
                                  for tr in sharded.TRANSIENTS)
          + f"; one culled ring step, loss {float(aux.loss):.6f}; slab_tmit "
          f"on culled slab 0 vs plain {tmit_err:.3e}; scan on the step's "
          f"{x.shape[0]} presort rows of shard 0: {scan_err:.3e} from "
          f"float64 (torch.cumsum {lib_err:.3e}); launches {launches}",
          flush=True)
    return launches, dict(slab_tmit=dict(row_cull_max_abs_err=tmit_err),
                          scan=dict(row_cull_max_abs_err=scan_err))


# ---------------------------------------------------------------- phase 8
# The training loop (train/loop.py) on a COLMAP scene of bench.py's cloud:
# run A trains LOOP_ITERS iterations through LOOP_DENSIFY events, an opacity
# reset, an eval, a save and a checkpoint at LOOP_CKPT; run B resumes from
# that checkpoint to LOOP_ITERS. The schedule keeps the screen-size prune
# out (the reset comes at the last densify event): the cameras' extent
# is small, so its world-space rule would drop most of the cloud. Random
# ground truth gives gradient statistics far below the default threshold
# (at 2e-4 no gaussian of this scene densifies), so it is 1e-6; the loop
# line prints the statistic's quantiles at each densify event.
LOOP_CAMS = 8
LOOP_ITERS = 60
LOOP_CKPT = 30
LOOP_THRESHOLD = 1e-6
LOOP_OPT = dict(iterations=LOOP_ITERS, densify_from_iter=5,
                densification_interval=15, densify_until_iter=50,
                opacity_reset_interval=45,
                densify_grad_threshold=LOOP_THRESHOLD)
LOOP_DENSIFY = [15, 30, 45]
LOOP_RESET = [45]
LOOP_PROFILE_STEP = 20     # the iteration profiled whole (no event in it)
# the sharded loop: 4 row shards, ring transient, a densify event at 4
LOOP_SHARD_OPT = dict(iterations=6, densify_from_iter=1,
                      densification_interval=4, opacity_reset_interval=3000,
                      densify_grad_threshold=LOOP_THRESHOLD)


class Tee:
    """stdout that also keeps what it was given (the loop's own lines)."""

    def __init__(self, out):
        self.out, self.lines = out, []

    def write(self, s):
        self.out.write(s)
        self.lines.append(s)

    def flush(self):
        self.out.flush()

    def count(self, text):
        return "".join(self.lines).count(text)


class LoopProbe:
    """Wraps what the loop looks up at call time: ``trainer.train_step``
    and the steps ``sharded.make_sharded_train_step`` makes (counts the
    steps, times the first from ``t0``, profiles the iteration that runs
    step ``profile_step``: from its step's call to the next), ``Scene``
    (synchronised ms of its construction), ``trainer.densify_step`` (synchronised ms and live gaussians before
    and after each event) and ``checkpoint.save_checkpoint`` (ms, bytes,
    the state it was given)."""

    def __init__(self, profile_step=None):
        self.t0 = time.perf_counter()
        self.profile_step = profile_step
        self.first_step_ms = None
        self.scene_ms = None
        self.steps = 0
        self.densify = []           # (iteration, ms, live before, after,
        #                              overflow, statistic's 10/50/90%)
        self.saved = []             # (path, iteration, state, ms, bytes)
        self.busy_ms = None
        self._prof = None

    def __enter__(self):
        from gsplat_tpu_torch.train import loop
        self._orig = (trainer.train_step, trainer.densify_step,
                      ckpt_lib.save_checkpoint,
                      sharded.make_sharded_train_step, loop.Scene)
        step, densify, save, make_sharded, scene_cls = self._orig

        def probe_step(step_fn, state, *a, **kw):
            if self.first_step_ms is None:
                self.first_step_ms = (time.perf_counter() - self.t0) * 1e3
            self._profile_edge(state.step + 1)
            self.steps += 1
            return step_fn(state, *a, **kw)

        def probe_make_sharded(*a, **kw):
            return functools.partial(probe_step, make_sharded(*a, **kw))

        def probe_scene(*a, **kw):
            t = time.perf_counter()
            scene = scene_cls(*a, **kw)
            torch.cuda.synchronize()
            self.scene_ms = (time.perf_counter() - t) * 1e3
            return scene

        def probe_densify(state, *a, **kw):
            st = state.stats
            seen = st.denom > 0
            stat = (st.xyz_gradient_accum[seen] / st.denom[seen]).float()
            q = torch.quantile(stat[:2 ** 24], torch.tensor(
                [0.1, 0.5, 0.9], device=stat.device)).tolist()
            torch.cuda.synchronize()
            before = state.gaussians.num_active()
            t = time.perf_counter()
            out = densify(state, *a, **kw)
            torch.cuda.synchronize()
            self.densify.append((state.step, (time.perf_counter() - t) * 1e3,
                                 before, out[0].gaussians.num_active(),
                                 int(out[1]), [float(f"{x:.3e}") for x in q]))
            return out

        def probe_save(path, state, iteration):
            t = time.perf_counter()
            save(path, state, iteration)
            ms = (time.perf_counter() - t) * 1e3
            self.saved.append((path, iteration, state, ms,
                               os.path.getsize(path)))

        trainer.train_step = functools.partial(probe_step, step)
        trainer.densify_step = probe_densify
        ckpt_lib.save_checkpoint = probe_save
        sharded.make_sharded_train_step = probe_make_sharded
        loop.Scene = probe_scene
        return self

    def _profile_edge(self, step_no):
        from torch.profiler import ProfilerActivity, profile
        if self._prof is not None and step_no != self.profile_step:
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - self._t_prof) * 1e3
            self._prof.__exit__(None, None, None)
            self.busy_ms = print_profile(
                f"one loop iteration (iteration {self.profile_step}: its "
                "step, host reads, telemetry and the next frame's upload)",
                self._prof, wall_ms, 15)
            self._prof = None
        elif step_no == self.profile_step and self._prof is None \
                and self.busy_ms is None:
            torch.cuda.synchronize()
            self._prof = profile(activities=[ProfilerActivity.CPU,
                                             ProfilerActivity.CUDA])
            self._prof.__enter__()
            self._t_prof = time.perf_counter()

    def __exit__(self, *exc):
        from gsplat_tpu_torch.train import loop
        (trainer.train_step, trainer.densify_step, ckpt_lib.save_checkpoint,
         sharded.make_sharded_train_step, loop.Scene) = self._orig
        if self._prof is not None:
            self._prof.__exit__(None, None, None)
        return False


def write_loop_scene(root, rng, w, h, n_cams):
    """A COLMAP scene written with the port's writers: bench.py's cloud
    (``tools/bench.py:bench_points``) as the points, n_cams PINHOLE
    cameras at w x h with fovx 1.2 at the poses of ``poses()`` continued,
    random 8-bit images.
    Returns the scene's directory."""
    from PIL import Image

    from gsplat_tpu_torch.scene import colmap
    images = os.path.join(root, "images")
    os.makedirs(images, exist_ok=True)
    f = w / (2 * np.tan(0.6))
    cams = {1: colmap.ColmapCamera(1, "PINHOLE", w, h,
                                   np.array([f, f, w / 2, h / 2]))}
    imgs = {}
    for i in range(n_cams):
        a = 0.04 * i
        R = np.array([[np.cos(a), 0, np.sin(a)], [0, 1, 0],
                      [-np.sin(a), 0, np.cos(a)]])    # camera to world
        name = f"im_{i:03d}.png"
        imgs[i + 1] = colmap.ColmapImage(
            i + 1, colmap.rotmat2qvec(R.T),
            np.array([0.1 * i, -0.05 * i, 0.0]), 1, name)
        Image.fromarray(rng.integers(0, 256, (h, w, 3), dtype=np.uint8)) \
            .save(os.path.join(images, name), compress_level=1)
    pts, colors = bench.bench_points(rng, N_GAUSS)
    colmap.write_model(cams, imgs, (
        np.arange(len(pts), dtype=np.int64), pts.astype(np.float64),
        (colors * 255).astype(np.uint8), np.zeros(len(pts))),
        os.path.join(root, "sparse", "0"))
    return root


def loop_log(model):
    with open(os.path.join(model, "training_log.jsonl")) as f:
        return [json.loads(line) for line in f]


def run_loop(src, model, dev, opt_kw, *, tests=(), saves=(), ckpts=(),
             start=None, profile_step=None, **kw):
    """train(...) of the port on ``dev`` under a LoopProbe and a Tee.
    Returns (scene, state, probe, tee, seconds)."""
    import contextlib
    import random
    import sys

    from gsplat_tpu_torch.config import ModelConfig, PipelineConfig
    from gsplat_tpu_torch.train import loop
    random.seed(0)
    tee = Tee(sys.stdout)
    t = time.perf_counter()
    with LoopProbe(profile_step) as probe, contextlib.redirect_stdout(tee):
        scene, state = loop.train(
            ModelConfig(source_path=src, model_path=model, sh_degree=3,
                        resolution=1, eval=True),
            OptimizationConfig(**opt_kw), PipelineConfig(),
            RasterizerConfig(), list(tests), list(saves), list(ckpts),
            start_checkpoint=start, quiet=True, device=dev, **kw)
        torch.cuda.synchronize()
    return scene, state, probe, tee, time.perf_counter() - t


def expected_loop_launches(steps, renders, sharded_shards=0):
    """What a loop run launches: per step the compositor pair, the SSIM
    pair and the preprocess pair (single), or the compositor pair and the
    scan once per shard and the SSIM pair once (sharded, whose preprocess
    is plain); one compositor forward per eval render or bridge frame, and
    one preprocess forward with it where single."""
    if sharded_shards:
        d = sharded_shards * steps
        want = dict(composite_fwd=d + renders, composite_bwd=d, scan=d,
                    ssim_fwd=steps, ssim_bwd=steps)
    else:
        want = dict(composite_fwd=steps + renders, composite_bwd=steps,
                    ssim_fwd=steps, ssim_bwd=steps,
                    preprocess_fwd=steps + renders, preprocess_bwd=steps,
                    gather_entries_fwd=steps + renders,
                    gather_entries_bwd=steps)
    return {name: want.get(name, 0) for name in KERNELS}


def states_equal(a, b):
    from gsplat_tpu_torch.train.checkpoint import state_items
    return all(n1 == n2 and x.dtype == y.dtype and np.array_equal(x, y)
               for (n1, x), (n2, y) in zip(state_items(a), state_items(b)))


DEPTH_IMAGES = 4           # cameras of phase 8's scene given inverse depths
DEPTH_TRACK = 20_000       # points in each of their tracks
DEPTH_SCALE_TOL = 1e-3     # the fit against the truth: scale relative,
#                            offset absolute (16-bit quantisation ~1e-5)


def native_loader_phase(dev, src):
    """Phase 8's scene read twice into a Scene: through the native loader
    (when it builds) and with ``GSPLAT_NATIVE_LOADER=0`` (PIL); the decoded
    images held to PIL's within 1e-6 (tests/test_scene.py:283, the source
    size). Returns the line's numbers."""
    from gsplat_tpu_torch import native
    from gsplat_tpu_torch.config import ModelConfig
    from gsplat_tpu_torch.scene import Scene
    cfg = ModelConfig(source_path=src, model_path="", sh_degree=3,
                      resolution=1, eval=True)

    def init():
        t = time.perf_counter()
        scene = Scene(cfg, 3, capacity=0, device=dev)
        torch.cuda.synchronize()
        cams = scene.getTrainCameras() + scene.getTestCameras()
        return ({c.image_name: c.image for c in cams},
                (time.perf_counter() - t) * 1e3)

    built = native.available()
    if built:
        how = "built"
    elif native.build_error:
        how = ("did not build: "
               + native.build_error.strip().splitlines()[0][:200])
    else:
        how = ("not used (GSPLAT_NATIVE_LOADER="
               f"{os.environ.get('GSPLAT_NATIVE_LOADER')!r}, library "
               f"{native.library_path()} "
               f"{'present' if native.library_path().exists() else 'absent'})")
    imgs_native, ms_native = init()
    os.environ["GSPLAT_NATIVE_LOADER"] = "0"
    try:
        imgs_pil, ms_pil = init()
    finally:
        del os.environ["GSPLAT_NATIVE_LOADER"]
    check(set(imgs_native) == set(imgs_pil), "the scenes' images")
    err = max(float(np.abs(imgs_native[k] - imgs_pil[k]).max())
              for k in imgs_pil)
    if built:
        check(err <= 1e-6, f"the native loader's images are {err} from PIL's")
    print(f"native loader: {how}; Scene init of phase 8's scene "
          f"({len(imgs_pil)} images {W}x{H}, {N_GAUSS} points) "
          f"{ms_native:.1f} ms with it, {ms_pil:.1f} ms with "
          f"GSPLAT_NATIVE_LOADER=0 (PIL); images max |native - PIL| "
          f"{err:.3e}", flush=True)
    return dict(built=built, ms=ms_native, pil_ms=ms_pil, err=err)


def depth_scale_phase(src, root):
    """make_depth_scale_torch.py on phase 8's scene: DEPTH_IMAGES of its
    cameras get a track of up to DEPTH_TRACK of the points they see, one a
    pixel, each keypoint on its pixel's corner (where the tool's bilinear
    sample is that pixel), and a 16-bit inverse-depth PNG of s / z + o (per
    image s, o from the seed) filled by nearest neighbour; the fitted scale
    and offset against the truth, 1 / s and -o / s."""
    import subprocess as sp
    import sys

    from PIL import Image
    from scipy.spatial import cKDTree

    from gsplat_tpu_torch.scene import colmap
    sparse = os.path.join(src, "sparse", "0")
    cams, imgs, _ = colmap.read_model(sparse)
    ids, xyz, rgb, err = colmap.read_points3d_full(
        os.path.join(sparse, "points3D.bin"),
        os.path.join(sparse, "points3D.txt"))
    base = os.path.join(root, "depth_scene")
    maps = os.path.join(root, "depth_maps")
    os.makedirs(maps, exist_ok=True)
    rng = np.random.default_rng(SEED + 12)
    truth, t0 = {}, time.perf_counter()
    gy, gx = np.mgrid[0:H, 0:W]
    pix = np.stack([gx.ravel(), gy.ravel()], axis=1) + 0.0
    for key in sorted(imgs)[:DEPTH_IMAGES]:
        im = imgs[key]
        fx, fy, cx, cy = cams[im.camera_id].params
        pc = xyz @ colmap.qvec2rotmat(im.qvec).T + im.tvec
        z = pc[:, 2]
        u, v = fx * pc[:, 0] / z + cx, fy * pc[:, 1] / z + cy
        seen = np.nonzero((z > 0.1) & (u >= 0) & (u < W - 0.5) & (v >= 0)
                          & (v < H - 0.5))[0]
        px = np.rint(u[seen]) + W * np.rint(v[seen])
        seen = seen[np.unique(px, return_index=True)[1]]     # one a pixel
        sel = np.sort(rng.choice(seen, min(DEPTH_TRACK, len(seen)),
                                 replace=False))
        s, o = rng.uniform(1.5, 3.0), rng.uniform(0.02, 0.1)
        xys = np.stack([np.rint(u[sel]), np.rint(v[sel])], axis=1)
        _, j = cKDTree(xys).query(pix, workers=-1)
        dense = (s / z[sel] + o)[j].reshape(H, W)
        Image.fromarray(np.clip(dense * 2 ** 16, 0, 2 ** 16 - 1).astype(
            np.uint16)).save(os.path.join(
                maps, os.path.splitext(im.name)[0] + ".png"))
        imgs[key] = dataclasses.replace(im, xys=xys, point3D_ids=ids[sel])
        truth[os.path.splitext(im.name)[0]] = (1.0 / s, -o / s)
    colmap.write_model(cams, imgs, (ids, xyz, rgb, err),
                       os.path.join(base, "sparse", "0"))
    made_s = time.perf_counter() - t0
    t = time.perf_counter()
    sp.run([sys.executable, os.path.join(REPO, "make_depth_scale_torch.py"),
            "--base_dir", base, "--depths_dir", maps], check=True,
           capture_output=True, text=True, timeout=600)
    tool_s = time.perf_counter() - t
    with open(os.path.join(base, "sparse", "0", "depth_params.json")) as f:
        got = json.load(f)
    check(set(got) == set(truth), f"depth_params.json holds {sorted(got)}, "
          f"expected {sorted(truth)}")
    rel = {k: abs(got[k]["scale"] / truth[k][0] - 1) for k in truth}
    off = {k: abs(got[k]["offset"] - truth[k][1]) for k in truth}
    check(max(rel.values()) <= DEPTH_SCALE_TOL
          and max(off.values()) <= DEPTH_SCALE_TOL, f"depth scales {got} "
          f"against the truth {truth}: scale errors {rel}, offset {off}")
    print(f"depth-scale CLI (make_depth_scale_torch.py) on phase 8's scene, "
          f"{DEPTH_IMAGES} images with {DEPTH_TRACK}-point tracks and 16-bit "
          f"inverse depths (made in {made_s:.2f} s): {tool_s:.2f} s; scale "
          f"relative error max {max(rel.values()):.3e}, offset absolute "
          f"error max {max(off.values()):.3e} (gate {DEPTH_SCALE_TOL} each)",
          flush=True)
    return dict(rel=max(rel.values()), off=max(off.values()))


def loop_phase(dev, root):
    """Phase 8: the training loop at full width (run A, then run B resumed
    from run A's checkpoint), with its gates; then the sharded loop.
    Returns the launch counts of the loop (A and B) and of the sharded
    loop, and run A's scene, model directory, final state and checkpoint
    for phase 9."""
    from gsplat_tpu_torch.models.gaussian_model import compact
    from gsplat_tpu_torch.scene import Scene
    from gsplat_tpu_torch.train.checkpoint import load_checkpoint

    t = time.perf_counter()
    src = write_loop_scene(os.path.join(root, "loop_scene"),
                           np.random.default_rng(SEED + 8), W, H, LOOP_CAMS)
    write_s = time.perf_counter() - t
    model_a, model_b = (os.path.join(root, n) for n in ("loop_a", "loop_b"))
    peak = []
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    _, state_a, pa, tee_a, sec_a = run_loop(
        src, model_a, dev, LOOP_OPT, tests=[LOOP_ITERS], saves=[LOOP_ITERS],
        ckpts=[LOOP_CKPT], profile_step=LOOP_PROFILE_STEP)
    ckpt_path = os.path.join(model_a, f"chkpnt{LOOP_CKPT}.npz")
    scene_b, state_b, pb, tee_b, sec_b = run_loop(
        src, model_b, dev, LOOP_OPT, tests=[LOOP_ITERS], saves=[LOOP_ITERS],
        start=ckpt_path)
    launches = read_launches()
    peak.append(torch.cuda.max_memory_allocated() / 1e9)

    log_a, log_b = loop_log(model_a), loop_log(model_b)
    steps_a = [r for r in log_a if "train_loss_patches/total_loss" in r]
    steps_b = [r for r in log_b if "train_loss_patches/total_loss" in r]
    check([r["step"] for r in steps_a] == list(range(1, LOOP_ITERS + 1))
          and [r["step"] for r in steps_b]
          == list(range(LOOP_CKPT + 1, LOOP_ITERS + 1)),
          "the loop's logged steps")
    losses_all = [r["train_loss_patches/total_loss"] for r in steps_a + steps_b]
    check(all(np.isfinite(losses_all)), f"non-finite loss {losses_all}")
    retries = tee_a.count("retrying frame") + tee_b.count("retrying frame")
    n_steps = LOOP_ITERS + (LOOP_ITERS - LOOP_CKPT) + retries
    check(pa.steps + pb.steps == n_steps,
          f"{pa.steps + pb.steps} steps, expected {n_steps}")
    densify_its = [d[0] for d in pa.densify]
    check(densify_its == LOOP_DENSIFY and [d[0] for d in pb.densify]
          == [i for i in LOOP_DENSIFY if i > LOOP_CKPT],
          f"densify events at {densify_its}, {[d[0] for d in pb.densify]}")
    by_step = {r["step"]: r["total_points"] for r in steps_a}
    check(by_step[LOOP_DENSIFY[0]] > by_step[LOOP_DENSIFY[0] - 1],
          "total_points did not grow at the first densify event")

    # the checkpoint reloaded, bit for bit
    (path, it, saved, save_ms, save_bytes), = pa.saved
    check(path == ckpt_path and it == LOOP_CKPT, f"checkpoint {path} {it}")
    t = time.perf_counter()
    back, it = load_checkpoint(ckpt_path, device=dev)
    load_ms = (time.perf_counter() - t) * 1e3
    check(it == LOOP_CKPT and states_equal(back, saved),
          "the checkpoint reloaded differs from the state saved")
    del back, saved
    # the PLY re-read by a load-iteration Scene equals the final state
    from gsplat_tpu_torch.config import ModelConfig
    live = compact(state_b.gaussians)
    n = live.num_active()
    reread = Scene(ModelConfig(source_path=src, model_path=model_b,
                               sh_degree=3, resolution=1, eval=True), 3,
                   load_iteration=LOOP_ITERS, device=dev).gaussians
    check(reread.capacity == n and all(
        torch.equal(getattr(reread, k), getattr(live, k)[:n])
        for k in ("xyz", "f_dc", "f_rest", "scaling", "rotation",
                  "opacity")), "the saved PLY differs from the final state")
    del live, reread

    n_eval = 2 * (len(scene_b.getTestCameras()) + 5)
    want = expected_loop_launches(n_steps, n_eval)
    for name in KERNELS:
        check(launches[name] == want[name], f"{name} launched "
              f"{launches[name]} times in the loop, expected {want[name]}")
    iter_ms = [r["iter_time"] * 1e3 for r in steps_a]
    evals = [(k, round(v, 4)) for r in log_b for k, v in r.items()
             if "psnr" in k]
    print(f"loop {W}x{H}, {N_GAUSS} points, {LOOP_CAMS} cameras "
          f"(scene written in {write_s:.2f} s): run A {LOOP_ITERS} "
          f"iterations in {sec_a:.2f} s, run B (resumed at {LOOP_CKPT}) in "
          f"{sec_b:.2f} s; time to the first step {pa.first_step_ms:.1f} ms "
          f"(A), {pb.first_step_ms:.1f} ms (B, with the checkpoint load), "
          f"of which Scene init (images, PLY, create_from_pcd and its kNN) "
          f"{pa.scene_ms:.1f} ms, {pb.scene_ms:.1f} ms; iteration ms median {np.median(iter_ms):.3f} (A, host "
          f"clock, iter_time; min {min(iter_ms):.3f}, max "
          f"{max(iter_ms):.3f}); densify events (iteration, ms, live before, "
          f"after, overflow, the gradient statistic's 10/50/90% quantiles "
          f"on seen gaussians; threshold {LOOP_THRESHOLD}): "
          f"{[(d[0], round(d[1], 3), *d[2:]) for d in pa.densify + pb.densify]}; "
          f"capacity {state_a.gaussians.capacity} (A), "
          f"{state_b.gaussians.capacity} (B); retries {retries}; "
          f"pairs_per_gaussian lines "
          f"{tee_a.count('pairs_per_gaussian')}; checkpoint save "
          f"{save_ms:.1f} ms ({save_bytes / 1e6:.1f} MB, savez_compressed), "
          f"load {load_ms:.1f} ms, bit for bit; final PLY re-read equal "
          f"({n} gaussians); eval {evals}; steps {n_steps}; launches "
          f"{launches}; peak memory {peak[0]:.2f} GB", flush=True)
    del state_b, scene_b

    # the sharded loop: 4 shards, ring
    model_s = os.path.join(root, "loop_sharded")
    reset_launches()
    _, state_s, ps, tee_s, sec_s = run_loop(
        src, model_s, dev, LOOP_SHARD_OPT, saves=[LOOP_SHARD_OPT["iterations"]],
        shard_gaussians=True, n_shards=N_SHARDS, shard_transient="ring")
    shard_launches = read_launches()
    log_s = [r for r in loop_log(model_s)
             if "train_loss_patches/total_loss" in r]
    losses_s = [r["train_loss_patches/total_loss"] for r in log_s]
    check(all(np.isfinite(losses_s)), f"sharded loop loss {losses_s}")
    s_retries = tee_s.count("retrying frame")
    s_steps = LOOP_SHARD_OPT["iterations"] + s_retries
    check(ps.steps == s_steps and len(ps.densify) == 1,
          f"sharded loop: {ps.steps} steps, {len(ps.densify)} densify events")
    cap = state_s.gaussians.capacity
    check(cap % N_SHARDS == 0 and all(
        [t.shape[0] for t in sharded.shard_rows(x, N_SHARDS)]
        == [cap // N_SHARDS] * N_SHARDS
        for x in (state_s.gaussians.xyz, state_s.adam.mu["xyz"],
                  state_s.stats.denom)), "sharded loop: shards")
    check(os.path.exists(os.path.join(
        model_s, f"point_cloud/iteration_{LOOP_SHARD_OPT['iterations']}",
        "point_cloud.ply")), "sharded loop: no PLY")
    want = expected_loop_launches(s_steps, 0, sharded_shards=N_SHARDS)
    for name in KERNELS:
        check(shard_launches[name] == want[name],
              f"{name} launched {shard_launches[name]} times in the sharded "
              f"loop, expected {want[name]}")
    iter_s = [r["iter_time"] * 1e3 for r in log_s]
    print(f"sharded loop, {N_SHARDS} shards, ring: "
          f"{LOOP_SHARD_OPT['iterations']} iterations in {sec_s:.2f} s, "
          f"iteration ms {[round(x, 3) for x in iter_s]}, densify "
          f"{[(d[0], round(d[1], 3), *d[2:]) for d in ps.densify]}, "
          f"capacity {cap} ({cap // N_SHARDS} rows/shard), retries "
          f"{s_retries}, losses {[round(x, 6) for x in losses_s]}, "
          f"launches {shard_launches}", flush=True)
    return launches, shard_launches, dict(
        src=src, model=model_a, state=state_a, ckpt=ckpt_path,
        n_eval=n_eval // 2)


# ---------------------------------------------------------------- phase 9
# Evaluation and viewing on run A's model of phase 8 (the 1080p COLMAP
# scene, --eval: 1 test camera, im_000, at R = I, T = 0): the render CLI on
# the test split, then the metrics CLI with random LPIPS weights written
# from the seed; the web viewer over HTTP, VIEW_FRAMES orbit frames at
# 1920x1080; the SIBR bridge on run A's final state (a kernel-path and a
# python-path frame), then inside a loop resumed from run A's checkpoint
# for BRIDGE_ITERS iterations, one frame served per iteration.
VIEW_FRAMES = 5
BRIDGE_ITERS = 3
LPIPS_CROP = (192, 256)              # the crop the CPU's LPIPS runs on
LPIPS_TOL = dict(rtol=1e-4, atol=0)
BRIDGE_TIMEOUT = 600


class CallTimer:
    """Replaces functions that a CLI looks up at call time with wrappers
    that synchronise the card around each call and keep its host-clock ms
    under a label; a factory's functions (``lpips_vgg``) are wrapped the
    same way. ``timed`` wraps one function by itself."""

    def __init__(self, **targets):
        import collections
        self.targets = targets        # label: (module, name, is_factory)
        self.ms = collections.defaultdict(list)

    def timed(self, label, fn):
        def call(*a, **kw):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = fn(*a, **kw)
            torch.cuda.synchronize()
            self.ms[label].append((time.perf_counter() - t) * 1e3)
            return out
        return call

    def _factory(self, label, make):
        def call(*a, **kw):
            return self.timed(label, make(*a, **kw))
        return call

    def __enter__(self):
        self._orig = []
        for label, (mod, name, factory) in self.targets.items():
            fn = getattr(mod, name)
            self._orig.append((mod, name, fn))
            setattr(mod, name, self._factory(label, fn) if factory
                    else self.timed(label, fn))
        return self

    def __exit__(self, *exc):
        for mod, name, fn in self._orig:
            setattr(mod, name, fn)
        return False


def run_cli(main_fn, argv):
    """A CLI's main(argv), with sys.stdout kept (the CLIs replace it)."""
    import sys
    out = sys.stdout
    try:
        main_fn(argv)
    finally:
        sys.stdout = out


def loop_test_view(dev):
    """(CameraView, fovx, fovy) of the loop scene's test camera, im_000."""
    fovx = 1.2
    fovy = 2 * np.arctan(H / (2 * W / (2 * np.tan(fovx / 2))))
    return (CameraView.create(np.eye(3), np.zeros(3), fovx, fovy,
                              device=dev), fovx, fovy)


def bridge_payload(cv, fovx, fovy, **over):
    """A SIBR client request for ``cv`` at W x H: the matrices in the
    client's row-vector layout, with its y/z column signs."""
    view = cv.world_view.cpu().numpy().T.copy()
    view[:, 1:3] *= -1
    proj = cv.full_proj.cpu().numpy().T.copy()
    proj[:, 1] *= -1
    return {"resolution_x": W, "resolution_y": H, "train": False,
            "fov_y": fovy, "fov_x": fovx, "z_near": 0.01, "z_far": 100.0,
            "shs_python": False, "rot_scale_python": False,
            "keep_alive": False, "scaling_modifier": 1.0,
            "view_matrix": view.flatten().tolist(),
            "view_projection_matrix": proj.flatten().tolist(), **over}


def bridge_client(port, payloads, frames, connected):
    """A SIBR client: each request after the previous frame, the frames
    (H,W,3 uint8) kept in ``frames``."""
    import socket

    def recv_exact(s, n):
        buf = bytearray()
        while len(buf) < n:
            chunk = s.recv(n - len(buf))
            if not chunk:
                raise ConnectionError("the bridge closed the connection")
            buf += chunk
        return bytes(buf)

    with socket.create_connection(("127.0.0.1", port),
                                  timeout=BRIDGE_TIMEOUT) as s:
        connected.set()
        for p in payloads:
            data = json.dumps(p).encode()
            s.sendall(len(data).to_bytes(4, "little") + data)
            img = recv_exact(s, W * H * 3)
            recv_exact(s, int.from_bytes(recv_exact(s, 4), "little"))
            frames.append(np.frombuffer(img, np.uint8).reshape(H, W, 3))


def start_client(gui, payloads):
    """A bridge client thread for ``payloads``, connected before it
    returns. Returns (thread, frames, errors)."""
    import threading
    frames, errors, connected = [], [], threading.Event()

    def run():
        try:
            bridge_client(gui.listener.getsockname()[1], payloads, frames,
                          connected)
        except Exception as e:   # handed to the main thread, which raises
            errors.append(e)
            connected.set()
    t = threading.Thread(target=run, daemon=True)
    t.start()
    check(connected.wait(BRIDGE_TIMEOUT) and not errors,
          f"bridge client did not connect: {errors}")
    return t, frames, errors


def eval_view_phase(dev, root, src, model, gauss):
    """The render CLI on the test split and the metrics CLI with random
    LPIPS weights; per-view host ms of the render, SSIM, PSNR and LPIPS;
    the gates; one whole view profiled on ``gauss``, run A's saved model.
    Returns the launches."""
    import shutil

    from PIL import Image

    from gsplat_tpu_torch.cli import metrics as metrics_cli
    from gsplat_tpu_torch.cli import render as render_cli
    from gsplat_tpu_torch.ops import lpips as lpips_lib

    weights = os.path.join(root, "lpips_random.npz")
    np.savez(weights, **lpips_lib.random_weights(
        np.random.default_rng(SEED + 9)))
    os.environ["GSPLAT_LPIPS_WEIGHTS"] = weights
    shutil.rmtree(os.path.join(model, "test"), ignore_errors=True)
    for name in ("results.json", "per_view.json"):
        if os.path.exists(os.path.join(model, name)):
            os.remove(os.path.join(model, name))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    with CallTimer(render=(rasterize, "render", False),
                   ssim=(losses, "ssim", False),
                   psnr=(losses, "psnr", False),
                   lpips=(lpips_lib, "lpips_vgg", True)) as timer:
        t = time.perf_counter()
        run_cli(render_cli.main, ["-s", src, "-m", model, "-r", "1",
                                  "--eval", "--skip_train", "--quiet",
                                  "--iteration", str(LOOP_ITERS),
                                  "--device", str(dev)])
        render_s = time.perf_counter() - t
        t = time.perf_counter()
        run_cli(metrics_cli.main, ["-m", model, "--device", str(dev)])
        metrics_s = time.perf_counter() - t
    launches = read_launches()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    method = f"ours_{LOOP_ITERS}"
    renders = sorted(os.listdir(os.path.join(model, "test", method,
                                             "renders")))
    n_views = len(renders)
    check(n_views == 1, f"{n_views} test views, expected 1")
    with open(os.path.join(model, "results.json")) as f:
        results = json.load(f)
    with open(os.path.join(model, "per_view.json")) as f:
        per_view = json.load(f)
    check(list(results) == [method] and list(per_view) == [method],
          f"results for {list(results)}, {list(per_view)}")
    for k in ("SSIM", "PSNR", "LPIPS"):
        check(np.isfinite(results[method][k]),
              f"{k} {results[method][k]} is not finite")
        check(sorted(per_view[method][k]) == renders, f"per-view {k}")
    check_launches(launches, "per_eval_view", n_views,
                   f"the eval of {n_views} view(s)")
    check(len(timer.ms["render"]) == n_views and
          all(len(timer.ms[k]) == n_views for k in ("ssim", "psnr", "lpips")),
          f"timed calls {[(k, len(v)) for k, v in timer.ms.items()]}")

    # the gates, on the view's images as the metrics CLI read them
    def png(d):
        with Image.open(os.path.join(model, "test", method, d,
                                     renders[0])) as im:
            return torch.tensor(np.asarray(im, np.float32)[..., :3] / 255.0,
                                device=dev).permute(2, 0, 1)[None]
    r, g = png("renders"), png("gt")
    with torch.no_grad():
        s_card = ssim_lib.ssim(r, g)
        s_plain = ssim_lib.ssim_map(r, g).mean()
        check(torch.allclose(s_card, s_plain, **SSIM_TOL),
              f"ssim on the card {float(s_card)} vs plain {float(s_plain)}")
        check(abs(float(s_card) - results[method]["SSIM"]) <= 1e-6,
              "results.json's SSIM is not the card's")
        fn = lpips_lib.lpips_vgg(device=dev)
        torch.cuda.reset_peak_memory_stats()
        lp = fn(r, g)
        torch.cuda.synchronize()
        lpips_peak_gb = torch.cuda.max_memory_allocated() / 1e9
        lpips_dev_ms = profile_call("one LPIPS at 1920x1080 (VGG16, f32)",
                                    lambda: fn(r, g), n_top=8)
        ch, cw = LPIPS_CROP
        crop = [x[..., :ch, :cw].contiguous() for x in (r, g)]
        lp_card = float(fn(*crop))
        lp_cpu = float(lpips_lib.lpips_vgg(device="cpu")(
            *(x.cpu() for x in crop)))

        # one whole view on the card: render, SSIM, PSNR and LPIPS
        cv = loop_test_view(dev)[0]
        bg = torch.zeros(3, device=dev)

        def one_view():
            img = rasterize.render(gauss, cv, W, H, bg,
                                   RasterizerConfig()).image[None]
            return (float(ssim_lib.ssim(img, g)),
                    float(losses.psnr(img, g).mean()), float(fn(img, g)))
        one_view()
        torch.cuda.reset_peak_memory_stats()
        view_dev_ms = profile_call("one eval view (render, SSIM, PSNR, "
                                   "LPIPS)", one_view, n_top=8)
        view_peak_gb = torch.cuda.max_memory_allocated() / 1e9
    check(np.isclose(lp_card, lp_cpu, **LPIPS_TOL),
          f"LPIPS on the card {lp_card} vs the CPU {lp_cpu}")
    check(abs(float(lp) - results[method]["LPIPS"]) <=
          1e-5 * abs(float(lp)), "results.json's LPIPS")
    ms = {k: [round(x, 3) for x in v] for k, v in timer.ms.items()}
    print(f"eval {W}x{H}, run A's model ({n_views} test view): render CLI "
          f"{render_s:.2f} s, metrics CLI {metrics_s:.2f} s; per view ms "
          f"(host clock, synchronised) {ms}; results {results[method]}; "
          f"ssim card vs plain {abs(float(s_card) - float(s_plain)):.3e}; "
          f"LPIPS {LPIPS_CROP[1]}x{LPIPS_CROP[0]} crop card {lp_card:.7f} "
          f"vs CPU {lp_cpu:.7f}; LPIPS peak memory {lpips_peak_gb:.2f} GB, "
          f"device {lpips_dev_ms:.3f} ms; one whole view device busy "
          f"{view_dev_ms:.3f} ms, peak memory {view_peak_gb:.2f} GB; eval "
          f"CLIs' peak memory {peak_gb:.2f} GB; launches {launches}",
          flush=True)
    return launches


def web_phase(dev, g, n_live):
    """The web viewer on ``g``, run A's saved model, in a server thread: /,
    /info, one warm-up frame, then VIEW_FRAMES orbit frames at W x H over
    HTTP, with the render and PNG encode ms of each. Returns the
    launches."""
    import io
    import threading
    import urllib.request

    from PIL import Image

    from gsplat_tpu_torch.viewer import web
    server = web.ViewerServer(g, port=0, device=dev)
    orig = server.render_rgb
    timer = CallTimer()
    server.render_rgb = timer.timed("render", orig)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{server.port}"
    r = 2 * server.extent             # the page's starting radius

    def get(path):
        with urllib.request.urlopen(base + path, timeout=600) as resp:
            check(resp.status == 200, f"GET {path}: HTTP {resp.status}")
            return resp.read()
    try:
        check(b"canvas" in get("/"), "the viewer page")
        info = json.loads(get("/info"))
        check(info["n"] == n_live, f"/info n {info['n']}, live {n_live}")
        get(f"/render?theta=-0.5&phi=0.2&r={r}&w={W}&h={H}")   # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        timer.ms.clear()
        total_ms, encode_ms = [], []
        for i in range(VIEW_FRAMES):
            t = time.perf_counter()
            body = get(f"/render?theta={0.3 * i}&phi=0.1&r={r}&w={W}&h={H}")
            total_ms.append((time.perf_counter() - t) * 1e3)
            img = np.asarray(Image.open(io.BytesIO(body)))
            check(img.shape == (H, W, 3) and img.dtype == np.uint8,
                  f"web frame {i}: {img.shape} {img.dtype}")
            check(float(img.std()) > 0, f"web frame {i} is blank")
            t = time.perf_counter()          # the same encode, host only
            Image.fromarray(img).save(io.BytesIO(), format="PNG")
            encode_ms.append((time.perf_counter() - t) * 1e3)
        launches = read_launches()
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
    finally:
        server.shutdown()
        thread.join(timeout=60)
    check(not thread.is_alive(), "the web server did not stop")
    check_launches(launches, "per_view_frame", VIEW_FRAMES,
                   f"{VIEW_FRAMES} web frames")
    cam = web._orbit_camera(server.center, 0.0, 0.1, r, 1.0,
                            2 * np.arctan(np.tan(0.5) * H / W), device=dev)
    with torch.no_grad():
        out = rasterize.render(g, cam, W, H, server.bg, server.rcfg)
        check(int(out.overflow) == 0, f"web frame overflow {int(out.overflow)}")
    dev_ms = profile_call("one web frame's render (render_rgb)",
                          lambda: orig(theta=0.0, phi=0.1, radius=r, W=W,
                                       H=H), n_top=8)
    print(f"web viewer {W}x{H}, {n_live} gaussians, radius {r:.3f}: frame ms "
          f"over HTTP {[round(x, 3) for x in total_ms]} (median "
          f"{np.median(total_ms):.3f}), of which render (host clock, to the "
          f"uint8 frame on the host) "
          f"{[round(x, 3) for x in timer.ms['render']]} and "
          f"PNG encode (host) {[round(x, 3) for x in encode_ms]}; one "
          f"frame's render device busy {dev_ms:.3f} ms; pairs of frame 0 "
          f"{int(out.num_pairs)}; peak memory {peak_gb:.2f} GB; launches "
          f"{launches}", flush=True)
    return launches


def bridge_phase(dev, root, src, state, ckpt):
    """The SIBR bridge: (a) two W x H requests with train false (kernel
    path, then both python paths) on run A's final state, the frames within
    1 in uint8; (b) the loop resumed from run A's checkpoint for
    BRIDGE_ITERS iterations with one train-true request per iteration, every
    frame served. Returns the launches of (a) and of (b)."""
    from gsplat_tpu_torch.config import PipelineConfig
    from gsplat_tpu_torch.viewer.network_gui import NetworkGUI, ViewerRequest

    cv, fovx, fovy = loop_test_view(dev)
    bg = torch.zeros(3, device=dev)
    rcfg = RasterizerConfig()
    payloads = [bridge_payload(cv, fovx, fovy),
                bridge_payload(cv, fovx, fovy, shs_python=True,
                               rot_scale_python=True)]
    gui = NetworkGUI("127.0.0.1", 0, device=dev)
    orig = gui._render_frame
    timer = CallTimer()
    gui._render_frame = timer.timed("frame", orig)
    try:
        # (a) outside training: poll serves until the client hangs up
        torch.cuda.synchronize()
        reset_launches()
        t, frames, errors = start_client(gui, payloads)
        deadline = time.time() + BRIDGE_TIMEOUT
        while t.is_alive() and time.time() < deadline:
            gui.poll(state, None, PipelineConfig(), rcfg, bg, LOOP_ITERS,
                     LOOP_ITERS)
            time.sleep(0.001)
        t.join(timeout=60)
        check(not errors and len(frames) == 2,
              f"bridge: {len(frames)} frames, errors {errors}")
        view_launches = read_launches()
        # the python paths' frame brings its colours and covariances: the
        # plain preprocess, and the gather kernel
        want = {n: 2 if n in ("composite_fwd", "gather_entries_fwd") else 0
                for n in KERNELS}
        want["preprocess_fwd"] = 1
        check(view_launches == want,
              f"bridge launches {view_launches}, expected {want}")
        diff = int(np.abs(frames[0].astype(int)
                          - frames[1].astype(int)).max())
        check(diff <= 1, f"python-path frame {diff} from the kernel path")
        check(all(float(f.std()) > 0 for f in frames), "blank bridge frame")
        req = ViewerRequest.parse(payloads[0])
        with torch.no_grad():
            out = rasterize.render(state.gaussians, cv, W, H, bg, rcfg)
            check(int(out.overflow) == 0, "bridge frame overflow")
        dev_ms = profile_call("one bridge frame's render (_render_frame)",
                              lambda: orig(state, req, rcfg,
                                           PipelineConfig(), bg), n_top=8)
        a_ms = timer.ms.pop("frame")

        # (b) inside training, from run A's checkpoint at LOOP_CKPT
        reset_launches()
        t, frames, errors = start_client(
            gui, [dict(payloads[0], train=True)] * BRIDGE_ITERS)
        model_c = os.path.join(root, "loop_bridge")
        _, _, probe, tee, sec = run_loop(
            src, model_c, dev,
            dict(LOOP_OPT, iterations=LOOP_CKPT + BRIDGE_ITERS), start=ckpt,
            network_gui_server=gui)
        t.join(timeout=60)
        loop_launches = read_launches()
    finally:
        gui.close()
    check(not errors and len(frames) == BRIDGE_ITERS,
          f"bridge in the loop: {len(frames)} frames of {BRIDGE_ITERS}, "
          f"errors {errors}")
    check(all(float(f.std()) > 0 for f in frames), "blank bridge frame")
    steps = BRIDGE_ITERS + tee.count("retrying frame")
    check(probe.steps == steps, f"{probe.steps} steps, expected {steps}")
    want = expected_loop_launches(steps, BRIDGE_ITERS)
    check(loop_launches == want,
          f"bridge loop launches {loop_launches}, expected {want}")
    iter_ms = [r["iter_time"] * 1e3 for r in loop_log(model_c)
               if "iter_time" in r]
    print(f"SIBR bridge {W}x{H}: outside training, frame ms (host clock, "
          f"to the bytes on the host) {[round(x, 3) for x in a_ms]} "
          f"(kernel path, python paths; max |diff| {diff} in uint8), one "
          f"frame's device busy {dev_ms:.3f} ms, launches {view_launches}; "
          f"in the loop from iteration {LOOP_CKPT}: {BRIDGE_ITERS} "
          f"iterations in {sec:.2f} s (iteration ms, iter_time: "
          f"{[round(x, 3) for x in iter_ms]}), frame ms "
          f"{[round(x, 3) for x in timer.ms['frame']]}, {len(frames)} "
          f"frames served, "
          f"launches {loop_launches}", flush=True)
    return view_launches, loop_launches


def view_phase(dev, root, src, model, state, ckpt):
    """Phase 9: evaluation, the web viewer and the SIBR bridge on run A.
    Returns the launch counts of the eval, of the viewers' frames outside
    training and of the loop under the bridge."""
    from gsplat_tpu_torch.viewer.web import load_gaussians_from_ply
    g = load_gaussians_from_ply(os.path.join(
        model, "point_cloud", f"iteration_{LOOP_ITERS}", "point_cloud.ply"),
        device=dev)
    eval_launches = eval_view_phase(dev, root, src, model, g)
    web_launches = web_phase(dev, g, state.gaussians.num_active())
    bridge_launches, loop_launches = bridge_phase(dev, root, src, state, ckpt)
    view_launches = {k: web_launches[k] + bridge_launches[k]
                     for k in KERNELS}
    return eval_launches, view_launches, loop_launches


# ---------------------------------------------------------------- phase 10
# Camera data parallelism (parallel/mesh.py, parallel/dp.py, the 2-D step of
# parallel/sharded.py, the loop's data-parallel branch) on the one card:
# 10a a world of one rank over NCCL in this process, on phase 5's scene;
# 10b two ranks in two processes that share the card over gloo (NCCL
# refuses two ranks on one card), each with one of phase 8's 1080p cameras:
# one DP step against the two-camera step in one process, then the loop.
# A rank is this script started again with ``--dp-rank <spec>``. (The 2-D
# step that was 10c runs on JAX's layout in phase 11c.)
DP_STEPS = 5
DP_RANKS = 2
DP_LOOP_ITERS = 20
DP_LOOP_OPT = dict(LOOP_OPT, iterations=DP_LOOP_ITERS)   # densify at 15
DP_TIMEOUT = 600           # seconds for both ranks of 10b together
DP_GROUP_TIMEOUT = 120     # a collective waits no longer for a rank
DP_SUM_FLOATS = 59 + 2     # per row: the gradients, accum and denom
DP_MAX_BYTES = 8           # per row of the max buffer (float64 radii)


def free_port():
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@contextlib.contextmanager
def deterministic():
    """torch's deterministic algorithms around the calls held bit for
    bit."""
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(False)


def aux_equal(a, b):
    return all(torch.equal(x, y) for x, y in zip(a, b))


def state_digest(state):
    import hashlib
    from gsplat_tpu_torch.train.checkpoint import state_items
    h = hashlib.sha256()
    for name, x in state_items(state):
        h.update(name.encode())
        h.update(np.ascontiguousarray(x).tobytes())
    return h.hexdigest()[:16]


def collective_ms(prof):
    """Device ms of the collective's own ops in a profile: NCCL's kernels,
    and the device-to-device copies a world of one may make instead."""
    from torch.autograd import DeviceType
    rows = [(e.key, e.self_device_time_total / 1e3, e.count)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA
            and ("nccl" in e.key.lower() or "dtod" in e.key.lower())]
    return sum(r[1] for r in rows), rows


def dp_nccl_phase(g, cam, gt, cfg, train_median_ms):
    """10a: a world of one rank over NCCL, from an environment set here: 1 +
    DP_STEPS DP steps with exact launches, each beside a ``train_step`` in
    turns for the host clock, the DP step against
    ``train_step`` bit for bit from the same state (both under torch's
    deterministic algorithms, train_step twice first to show they make it
    reproducible), one profiled DP step with the all-reduce's device time.
    Returns the launch counts of the timed steps."""
    import torch.distributed as dist

    from gsplat_tpu_torch.parallel import dp as dp_lib
    from gsplat_tpu_torch.parallel import mesh as mesh_lib
    from gsplat_tpu_torch.utils.general import resolve_device
    from torch.profiler import ProfilerActivity, profile
    env = dict(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(free_port()),
               WORLD_SIZE="1", RANK="0", LOCAL_RANK="0", LOCAL_WORLD_SIZE="1")
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    dev = gt.device
    opt = OptimizationConfig()
    ones = torch.ones((1, H, W), device=dev)
    zeros = torch.zeros((1, H, W), device=dev)
    inputs = (cam, gt, ones, zeros, zeros, torch.zeros(3, device=dev))
    try:
        check(mesh_lib.init_distributed(), "init_distributed did not join")
        check(dist.get_backend() == "nccl" and dist.get_world_size() == 1,
              f"backend {dist.get_backend()}, {dist.get_world_size()} ranks")
        check(resolve_device("cuda") == torch.device("cuda", 0),
              "the rank's card")
        mesh = mesh_lib.make_mesh((("data", -1),))
        step = dp_lib.make_dp_train_step(
            mesh, image_width=W, image_height=H, opt=opt, rcfg=cfg,
            spatial_lr_scale=1.0)
        state, aux = step(trainer.init_state(g, 1), *inputs)     # warm-up
        train(state, cam, gt, cfg, opt)
        torch.cuda.synchronize()
        # DP_STEPS DP steps, each beside a train_step from the same state
        # in turns (train, DP, DP, train, ...): the host-clock ms to the
        # synchronise and to the call's return (the enqueue); the launches
        # of the DP steps alone
        ms = {"dp": [], "train": []}
        queued = {"dp": [], "train": []}
        launches = {name: 0 for name in KERNELS}
        step_losses = []
        for i in range(DP_STEPS):
            for form in ("train", "dp")[::1 - 2 * (i % 2)]:
                before = read_launches()
                t = time.perf_counter()
                if form == "dp":
                    state, aux = step(state, *inputs)
                else:
                    train(state, cam, gt, cfg, opt)
                queued[form].append((time.perf_counter() - t) * 1e3)
                torch.cuda.synchronize()
                ms[form].append((time.perf_counter() - t) * 1e3)
                if form == "dp":
                    launches = {k: v + read_launches()[k] - before[k]
                                for k, v in launches.items()}
            step_losses.append(float(aux.loss))
            check(int(aux.overflow) == 0, f"DP step overflow {int(aux.overflow)}")
        step_ms = ms["dp"]
        check_launches(launches, "per_step", DP_STEPS,
                       f"{DP_STEPS} DP steps over NCCL")
        check(all(np.isfinite(step_losses)), f"DP losses {step_losses}")

        with deterministic():
            s1, a1 = train(state, cam, gt, cfg, opt)
            s2, a2 = train(state, cam, gt, cfg, opt)
            sd, ad = step(state, *inputs)
            torch.cuda.synchronize()
        check(states_equal(s1, s2) and aux_equal(a1, a2),
              "train_step is not reproducible under deterministic "
              "algorithms: the bit-for-bit gate cannot hold")
        check(states_equal(sd, s1) and aux_equal(ad, a1),
              "the DP step over NCCL differs from train_step")
        del s1, s2, sd

        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t = time.perf_counter()
            step(state, *inputs)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t) * 1e3
        busy = print_profile("one DP step over NCCL, world of one", prof,
                             wall_ms, 15)
        coll_ms, coll_rows = collective_ms(prof)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    sum_mb = g.capacity * DP_SUM_FLOATS * 4 / 1e6
    print(f"dp nccl, world of one, {W}x{H}, {N_GAUSS} gaussians: step ms "
          f"{[round(x, 3) for x in step_ms]} (median "
          f"{np.median(step_ms):.3f}; train_step in turns "
          f"{[round(x, 3) for x in ms['train']]}, median "
          f"{np.median(ms['train']):.3f}; phase 5's train step median "
          f"{train_median_ms:.3f} in this run), ms to the call's return "
          f"(enqueue) median {np.median(queued['dp']):.3f} DP, "
          f"{np.median(queued['train']):.3f} train_step, losses "
          f"{[round(x, 6) for x in step_losses]}, state and aux bit for bit "
          f"train_step's (train_step twice the same bits), all-reduce "
          f"{sum_mb:.1f} MB summed + {g.capacity * DP_MAX_BYTES / 1e6:.1f} "
          f"MB maxed per step, its device time {coll_ms:.3f} ms of "
          f"{busy:.3f} busy ({[(k[:60], round(ms, 3), n) for k, ms, n in coll_rows]}), "
          f"launches {launches}", flush=True)
    return launches


def two_camera_reference(state, views, opt, cfg):
    """The batch's step in one process: each view's ``camera_loss_grads``
    from ``state``, summed in rank order and divided by the batch, the
    statistics summed and maxed, ``finish_train_step``. Returns (state,
    loss, the batch's gradients by field, accum increment, visible)."""
    from gsplat_tpu_torch.train import densify as densify_lib
    n = len(views)
    stepc = state.step + 1
    outs = [trainer.camera_loss_grads(
        state.gaussians, state.exposure, *v, stepc, image_width=W,
        image_height=H, opt=opt, rcfg=cfg, antialiasing=False,
        train_test_exp=False, use_depth=False) for v in views]
    check(all(int(o[3].overflow) == 0 for o in outs), "reference overflow")

    def total(fn):
        acc = fn(outs[0])
        for o in outs[1:]:
            acc = acc + fn(o)
        return acc

    grads = {k: total(lambda o: o[4][k]) / n for k in outs[0][4]}
    accum = total(lambda o: torch.where(
        o[3].radii > 0, torch.linalg.norm(o[6][:, :2], dim=-1), 0.0))
    radii = outs[0][3].radii
    for o in outs[1:]:
        radii = torch.maximum(radii, o[3].radii)
    st = state.stats
    stats = densify_lib.DensifyStats(
        xyz_gradient_accum=st.xyz_gradient_accum + accum,
        denom=st.denom + total(lambda o: (o[3].radii > 0).float()),
        max_radii2d=torch.maximum(st.max_radii2d, radii))
    new = trainer.finish_train_step(
        state, grads, total(lambda o: o[5]) / n, stats, stepc, None,
        opt=opt, spatial_lr_scale=1.0)
    return new, total(lambda o: o[0]) / n, grads, accum, radii > 0


def dp_scene_state(spec, dev):
    """Phase 8's scene (Scene from its point cloud, the loop's capacity) on
    ``dev``: (initial state, the first DP_RANKS cameras' step inputs)."""
    import random

    from gsplat_tpu_torch.config import ModelConfig
    from gsplat_tpu_torch.parallel import dp as dp_lib
    from gsplat_tpu_torch.scene import Scene
    random.seed(0)
    scene = Scene(ModelConfig(source_path=spec["src"], model_path="",
                              sh_degree=3, resolution=1, eval=True), 3,
                  device=dev)
    n0 = scene.gaussians.num_active()
    cap = -(-max(n0 * 4, 1024) // 1024) * 1024          # the loop's
    state = trainer.init_state(gm.pad_to_capacity(scene.gaussians, cap),
                               len(scene.getTrainCameras()))
    bg = torch.zeros(3, device=dev)
    views = [(*dp_lib.camera_inputs(c, dev), bg)
             for c in scene.getTrainCameras()[:DP_RANKS]]
    return state, views


def dp_rank_step(spec, rank, dev):
    """10b's step on this rank: this rank's camera of phase 8's scene; rank
    0 also computes the two-camera step in one process."""
    from gsplat_tpu_torch.parallel import dp as dp_lib
    from gsplat_tpu_torch.parallel import mesh as mesh_lib
    state, views = dp_scene_state(spec, dev)
    opt, cfg = OptimizationConfig(), RasterizerConfig()
    mesh = mesh_lib.make_mesh((("data", -1),))
    step = dp_lib.make_dp_train_step(mesh, image_width=W, image_height=H,
                                     opt=opt, rcfg=cfg, spatial_lr_scale=1.0)
    out = {}
    with deterministic():
        reset_launches()
        s_dp, a_dp = step(state, *views[rank])
        torch.cuda.synchronize()
        out["step_launches"] = read_launches()
        check(int(a_dp.overflow) == 0, "DP step overflow")
        out["step_digest"] = state_digest(s_dp)
        out["step_loss"] = float(a_dp.loss)
        if rank == 0:
            ref, ref_loss, _, _, _ = two_camera_reference(state, views, opt,
                                                          cfg)
            check(states_equal(s_dp, ref) and torch.equal(a_dp.loss,
                                                          ref_loss),
                  "the DP step differs from the two-camera step")
            out["reference_digest"] = state_digest(ref)
    return out


def dp_rank_loop(spec, rank, dev):
    """10b's loop on this rank: ``train(..., data_parallel=True)`` on phase
    8's scene, recording the batches drawn, the densify events, the
    host-clock ms of every all-reduce and, on rank 1, every file opened for
    writing or directory made under the model directory."""
    import contextlib
    import random
    import sys

    import gsplat_tpu_torch.parallel as par
    from gsplat_tpu_torch.config import ModelConfig, PipelineConfig
    from gsplat_tpu_torch.train import loop
    model = spec["model"]
    writes, picks, densify, reduce_ms = [], [], [], []

    def audit(event, args):
        if event == "open":
            path, mode, flags = args
            writing = ((isinstance(mode, str) and any(c in mode
                                                      for c in "wax+"))
                       or (isinstance(flags, int) and flags
                           & (os.O_WRONLY | os.O_RDWR | os.O_CREAT)))
            if writing and str(path).startswith(model):
                writes.append(str(path))
        elif event in ("os.mkdir", "shutil.copyfile") and \
                str(args[0]).startswith(model):
            writes.append(str(args[0]))

    fill, dens, reduce = loop.fill_batch, trainer.densify_step, \
        par._all_reduce

    def fill_rec(*a, **kw):
        b = fill(*a, **kw)
        picks.append([c.image_name for c in b])
        return b

    def dens_rec(state, *a, **kw):
        densify.append(state.step)
        return dens(state, *a, **kw)

    def reduce_rec(*a, **kw):
        torch.cuda.synchronize()
        t = time.perf_counter()
        r = reduce(*a, **kw)
        torch.cuda.synchronize()
        reduce_ms.append((time.perf_counter() - t) * 1e3)
        return r

    if rank > 0:
        sys.addaudithook(audit)
    loop.fill_batch, trainer.densify_step, par._all_reduce = \
        fill_rec, dens_rec, reduce_rec
    tee = Tee(sys.stdout)
    try:
        reset_launches()
        random.seed(0)
        t = time.perf_counter()
        with contextlib.redirect_stdout(tee):
            _, state = loop.train(
                ModelConfig(source_path=spec["src"], model_path=model,
                            sh_degree=3, resolution=1, eval=True),
                OptimizationConfig(**DP_LOOP_OPT), PipelineConfig(),
                RasterizerConfig(), [], [DP_LOOP_ITERS], [], quiet=True,
                data_parallel=True, device=dev)
            torch.cuda.synchronize()
        loop_s = time.perf_counter() - t
    finally:
        loop.fill_batch, trainer.densify_step, par._all_reduce = \
            fill, dens, reduce
    retries = tee.count("retrying frame")
    steps = DP_LOOP_ITERS + retries
    launches = read_launches()
    want = expected_loop_launches(steps, 0)
    check(launches == want, f"rank {rank}: the DP loop launched {launches}, "
          f"expected {want}")
    check(densify == [15], f"rank {rank}: densify events {densify}")
    check(state.step == DP_LOOP_ITERS, f"rank {rank}: step {state.step}")
    return dict(loop_digest=state_digest(state), picks=picks,
                writes=writes, loop_launches=launches, loop_s=loop_s,
                retries=retries, reduce_ms=reduce_ms,
                live=state.gaussians.num_active(),
                capacity=state.gaussians.capacity)


def dp_rank_main(spec_path):
    """One rank of 10b: joins the gloo group on the shared card, runs the
    step and the loop, prints one ``DPRESULT`` JSON line."""
    from datetime import timedelta

    import torch.distributed as dist

    from gsplat_tpu_torch.parallel import mesh as mesh_lib
    with open(spec_path) as f:
        spec = json.load(f)
    dev = torch.device(spec["device"])
    check(mesh_lib.init_distributed(
        device=dev, backend="gloo",
        timeout=timedelta(seconds=DP_GROUP_TIMEOUT)), "did not join")
    rank, n = mesh_lib.world()
    check(n == DP_RANKS and dist.get_backend() == "gloo", "the group")
    try:
        out = dp_rank_step(spec, rank, dev)
        torch.cuda.empty_cache()
        out.update(dp_rank_loop(spec, rank, dev))
    finally:
        dist.destroy_process_group()
    print("DPRESULT " + json.dumps(dict(out, rank=rank)), flush=True)


def run_ranks(n, flag, spec, timeout, label, tag):
    """This script started ``n`` times as ranks (``flag <spec path>``)
    that share the card over gloo, all within ``timeout`` seconds; their
    output echoed, each rank's exit code held to 0. Returns (every rank's
    ``tag`` JSON result, by rank; the seconds all took)."""
    import sys
    spec_path = os.path.join(spec["root"], f"{flag.strip('-')}.json")
    with open(spec_path, "w") as f:
        json.dump(spec, f)
    env = dict(os.environ, MASTER_ADDR="127.0.0.1",
               MASTER_PORT=str(free_port()), WORLD_SIZE=str(n),
               LOCAL_WORLD_SIZE=str(n))
    t = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), flag, spec_path],
        env=dict(env, RANK=str(r), LOCAL_RANK=str(r)),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(n)]
    outs = []
    try:
        for p in procs:
            left = timeout - (time.perf_counter() - t)
            try:
                outs.append(p.communicate(timeout=max(left, 1.0))[0])
            except subprocess.TimeoutExpired:
                raise RuntimeError(f"a rank of {label} passed {timeout} s")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    wall_s = time.perf_counter() - t
    results = []
    for r, (p, out) in enumerate(zip(procs, outs)):
        for line in out.splitlines():
            if not line.startswith(tag):
                print(f"[rank {r}] {line}", flush=True)
        check(p.returncode == 0, f"rank {r} of {label} exited with "
              f"{p.returncode}")
        got = [ln for ln in out.splitlines() if ln.startswith(tag + " ")]
        check(len(got) == 1, f"rank {r} of {label}: no result")
        results.append(json.loads(got[0][len(tag) + 1:]))
    return results, wall_s


def dp_gloo_phase(src, root):
    """10b: DP_RANKS processes of this script sharing the card over gloo,
    each within DP_TIMEOUT; every rank's exit code, their agreement and
    rank 0's gates. Returns rank 0's launch counts of the loop."""
    model = os.path.join(root, "loop_dp")
    results, wall_s = run_ranks(
        DP_RANKS, "--dp-rank", dict(src=src, model=model, device=RANK_DEVICE,
                                    root=root), DP_TIMEOUT, "10b",
        "DPRESULT")
    r0, r1 = results
    for key in ("step_digest", "step_loss", "loop_digest", "picks", "live",
                "capacity"):
        check(r0[key] == r1[key], f"the ranks differ in {key}: {r0[key]} / "
              f"{r1[key]}")
    check(r0["step_digest"] == r0["reference_digest"],
          "the DP step differs from the two-camera step")
    check(r1["writes"] == [], f"rank 1 wrote {r1['writes']}")
    for name in ("cameras.json", "input.ply", "training_log.jsonl",
                 f"point_cloud/iteration_{DP_LOOP_ITERS}/point_cloud.ply"):
        check(os.path.exists(os.path.join(model, name)), f"no {name}")
    for r in results:
        check_launches(r["step_launches"], "per_step", 1,
                       f"rank {r['rank']}'s DP step")
    log = [x for x in loop_log(model) if "train_loss_patches/total_loss" in x]
    check([x["step"] for x in log] == list(range(1, DP_LOOP_ITERS + 1))
          and all(np.isfinite(x["train_loss_patches/total_loss"])
                  for x in log), "the DP loop's log")
    iter_ms = [x["iter_time"] * 1e3 for x in log]
    sum_mb = r0["capacity"] * DP_SUM_FLOATS * 4 / 1e6
    reduce_ms = r0["reduce_ms"]
    per_iter = np.sum(reduce_ms) / (DP_LOOP_ITERS + r0["retries"])
    print(f"dp gloo, {DP_RANKS} ranks sharing the card, {W}x{H}, phase 8's "
          f"scene: one DP step equal to the two-camera step bit for bit, "
          f"the ranks' states equal; loop "
          f"{DP_LOOP_ITERS} iterations in {r0['loop_s']:.2f} s, iteration "
          f"ms median {np.median(iter_ms):.3f} (rank 0, iter_time; min "
          f"{min(iter_ms):.3f}, max {max(iter_ms):.3f}), all-reduces "
          f"{len(reduce_ms)} taking {per_iter:.3f} ms per iteration "
          f"({per_iter / np.median(iter_ms):.1%} of the median; "
          f"{sum_mb:.1f} MB summed per step, staged through the host by "
          f"gloo), retries {r0['retries']}, final capacity "
          f"{r0['capacity']}, live {r0['live']}, batches equal on both "
          f"ranks ({len(r0['picks'])}), rank 1 wrote nothing; launches "
          f"{r0['loop_launches']}; both ranks in {wall_s:.1f} s",
          flush=True)
    return r0["loop_launches"]


# ---------------------------------------------------------------- phase 11
# One rank per part (parallel/__init__.py RankParts): the ranks are this
# script started again, sharing the card over gloo (NCCL refuses two ranks
# on one card), gloo's point-to-point messages staged through pinned host
# memory. 11a gaussian-sharded storage over SR_RANKS ranks on phase 5's
# scene (each rank holding N_GAUSS / SR_RANKS rows): per transient
# N_POSES renders, the images bit for bit this process's 2-shard local
# form, 1 + SR_STEPS steps and one gradient call held to the single
# render's; 11b the slab and band renders over SR_RANKS ranks at phase 6's
# gates, the images bit for bit the local forms; 11d train(...,
# shard_gaussians=True) on phase 8's scene for SR_LOOP_ITERS iterations
# with a densify event that outgrows the capacity, the rows gathered equal
# to this process's n_shards=2 loop bit for bit (both under torch's
# deterministic algorithms), rank 0's checkpoint its file; 11c JAX's 2-D
# layout, TWO_D_RANKS ranks as data 2 x prim 2, ring, one step from 10b's
# state against the two-camera step at phase 7's gates. Exact launches on
# every rank.
SR_RANKS = 2
SR_STEPS = 3
SR_TIMEOUT = 600
SR_LOOP_ITERS = 10
SR_LOOP_OPT = dict(iterations=SR_LOOP_ITERS, densify_from_iter=1,
                   densification_interval=6, opacity_reset_interval=3000,
                   densify_grad_threshold=LOOP_THRESHOLD)    # densify at 6
TWO_D_RANKS = 4
RANK_DEVICE = "cuda:0"      # the card the ranks share
# per part and call on a rank: one band or slab each
PER_PART = dict(composite_fwd=1, composite_bwd=1, scan=1, ssim_fwd=1,
                ssim_bwd=1, slab_tmit=0)


def drop_zero_fields(label, got, want):
    """Take out of both the fields the reference has no gradient in (a
    fresh scene's isotropic scales give none of rotation), holding that the
    split form has none there either."""
    got, want = dict(got), dict(want)
    for k in [k for k, v in want.items() if not bool(v.any())]:
        check(not bool(got.pop(k).any()), f"{label}: a gradient of {k} "
              f"where the reference has none")
        del want[k]
    return got, want


def launches_of(**counts):
    return {name: counts.get(name, 0) for name in KERNELS}


def digest(t):
    import hashlib
    return hashlib.sha256(t.detach().contiguous().cpu().numpy().tobytes()
                          ).hexdigest()[:16]


@contextlib.contextmanager
def timed_collectives(sink):
    """The host ms of every all-gather, all-reduce, broadcast and
    point-to-point exchange of the parts' helpers, each between two
    synchronisations, into ``sink``."""
    import torch.distributed as dist

    import gsplat_tpu_torch.parallel as par
    orig = dict(all_gather=dist.all_gather, all_reduce=dist.all_reduce,
                broadcast=dist.broadcast, p2p=par.exchange)

    def timed(name, fn):
        def call(*a, **kw):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = fn(*a, **kw)
            torch.cuda.synchronize()
            sink.setdefault(name, []).append((time.perf_counter() - t) * 1e3)
            return out
        return call
    for name in ("all_gather", "all_reduce", "broadcast"):
        setattr(dist, name, timed(name, orig[name]))
    par.exchange = timed("p2p", orig["p2p"])
    try:
        yield sink
    finally:
        for name in ("all_gather", "all_reduce", "broadcast"):
            setattr(dist, name, orig[name])
        par.exchange = orig["p2p"]


def collective_line(sink):
    return ", ".join(f"{k} {len(v)} x, {sum(v):.2f} ms"
                     for k, v in sorted(sink.items()))


def step_transient_gb(fn):
    """GB that ``fn()`` allocates above what was allocated before it, at
    its peak: a step's transients, the state it steps from not counted."""
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    fn()
    torch.cuda.synchronize()
    return (torch.cuda.max_memory_allocated() - before) / 1e9


def held_rows(state):
    return state.gaussians.capacity, sum(
        t.numel() * t.element_size() for t in trainer.row_tensors(state))


def shard_ranks_prep(tg, tcam, tgt, tcfg, cams, root):
    """What 11a holds the ranks to, from this process on phase 5's scene:
    the config of SR_RANKS shards, the single render's loss and gradients
    under the sharded loss (to a file), and per transient the digests of
    the SR_RANKS-shard local form's frames and the peak memory of its
    step. Returns the ranks' spec."""
    dev = tgt.device
    scene_path = os.path.join(root, "phase5_scene.pt")
    torch.save({k: getattr(tg, k).cpu() for k in gm.TENSOR_FIELDS},
               scene_path)
    scfg, m_loc, pairs = sharded_setup(tg, [tcam] + cams, tcfg, SR_RANKS)
    bg = torch.zeros(3, device=dev)
    opt = OptimizationConfig()
    state = trainer.init_state(tg, 1)
    with plain_preprocess():
        loss1, want, want_tap, radii1 = single_loss_grads(
            tg, state.exposure, tcam, tgt, bg, tcfg, opt)
    want_path = os.path.join(root, "shard_want.pt")
    torch.save(dict(loss=loss1, radii=radii1.cpu(), tap=want_tap.cpu(),
                    **{k: v.cpu() for k, v in want.items()}), want_path)
    ones = torch.ones((1, H, W), device=dev)
    zeros = torch.zeros((1, H, W), device=dev)
    kw = dict(image_width=W, image_height=H)
    frames, local_peak, local_ms = {}, {}, {}
    for tr in sharded.TRANSIENTS:
        render = sharded.make_sharded_render(SR_RANKS, cfg=scfg,
                                             transient=tr, **kw)
        with torch.no_grad():
            outs = [render(tg, c, bg) for c in cams]
        check(all(int(o.overflow) == 0 for o in outs), f"{tr} overflow")
        frames[tr] = [(digest(o.image), digest(o.invdepth)) for o in outs]
        del outs
        step = sharded.make_sharded_train_step(
            SR_RANKS, opt=opt, rcfg=scfg, spatial_lr_scale=1.0,
            transient=tr, **kw)
        step(state, tcam, tgt, ones, zeros, zeros, bg)      # warm-up
        torch.cuda.synchronize()
        t = time.perf_counter()
        local_peak[tr] = step_transient_gb(
            lambda: step(state, tcam, tgt, ones, zeros, zeros, bg))
        local_ms[tr] = (time.perf_counter() - t) * 1e3
    m_slab, slab_pairs = slab_m_cap(tg, tcam, tcfg, SR_RANKS)
    state_gb = held_rows(state)[1] / 1e9
    print(f"11 prep: {SR_RANKS} shards, per-shard capacity {m_loc} "
          f"(pairs_per_gaussian {scfg.pairs_per_gaussian:.3f}), pairs of "
          f"owner o in band k {pairs}; one step of the one-process "
          f"{SR_RANKS}-shard local form: ms {local_ms}, its transients at "
          f"their peak (GB above the {state_gb:.3f} GB of per-gaussian "
          f"state it holds) {local_peak}; per-slab m_cap of {SR_RANKS} "
          f"slabs {m_slab} (pairs {slab_pairs})", flush=True)
    return dict(ppg=scfg.pairs_per_gaussian, want=want_path, frames=frames,
                local_peak=local_peak, local_ms=local_ms, m_slab=m_slab,
                local_state_gb=state_gb,
                scene=scene_path, cfg=dict(
                    pairs_per_gaussian=tcfg.pairs_per_gaussian,
                    pad_cap=tcfg.pad_cap))


def phase5_scene(spec, dev):
    """Phase 5's scene as this process made it (its gaussians from the
    file the parent wrote, its camera, ground truth and config)."""
    g = torch.load(spec["scene"])
    g = gm.GaussianParams(active_sh_degree=3,
                          **{k: v.to(dev) for k, v in g.items()})
    rng = np.random.default_rng(SEED)
    bench.bench_points(rng, N_GAUSS)      # bench_scene's draws
    gt = bench.ground_truth(rng, W, H, dev)
    cam = CameraView.create(np.eye(3), np.zeros(3), fovx=1.2, fovy=0.9,
                            device=dev)
    return g, cam, gt, RasterizerConfig(**spec["cfg"])


def sr_split(spec, rank, dev):
    """11b on this rank: the slab and band renders with one part per rank
    on phase 5's scene (every rank holds it whole), at phase 6's gates;
    the images bit for bit the local forms'."""
    from gsplat_tpu_torch.parallel import RankParts
    from gsplat_tpu_torch.parallel import mesh as mesh_lib
    tg, tcam, tgt, tcfg = phase5_scene(spec, dev)
    cams = poses(dev)
    bg = torch.zeros(3, device=dev)
    slabs = RankParts(mesh_lib.make_mesh((("prim", -1),)), "prim")
    bands = RankParts(mesh_lib.make_mesh((("tile", -1),)), "tile")

    def slab(p, c, parts=slabs):
        return prim_shard.render_prim_sharded(
            p, c, W, H, bg, tcfg, n_slabs=parts, m_cap=spec["m_slab"])

    def band(p, c, parts=bands):
        return tile_shard.render_tile_sharded(p, c, W, H, bg, tcfg,
                                              n_bands=parts)
    out = {}
    with torch.no_grad(), plain_preprocess():
        singles = [rasterize.render(tg, c, W, H, bg, tcfg) for c in cams]
    with torch.no_grad():
        local = [(slab(tg, c, SR_RANKS)[0], band(tg, c, SR_RANKS)[0])
                 for c in cams]
        slab(tg, cams[0])                                   # warm-ups
        band(tg, cams[0])
        for name, fn, li, tol in (("slab", slab, 0, 1e-3),
                                  ("band", band, 1, None)):
            torch.cuda.synchronize()
            reset_launches()
            ms = []
            for c, single, loc in zip(cams, singles, local):
                t = time.perf_counter()
                got = fn(tg, c)
                torch.cuda.synchronize()
                ms.append((time.perf_counter() - t) * 1e3)
                img, ovf = got[0], got[-1]
                check(int(ovf) == 0, f"{name} overflow {int(ovf)}")
                check(torch.equal(img, loc[li]), f"rank {rank}: the {name} "
                      f"render over ranks differs from the local form")
                err = float((img - single.image).abs().max())
                check(err <= tol if tol else torch.allclose(
                    img, single.image, **SLAB_TOL), f"rank {rank}: {name} "
                    f"render is {err} from the single render")
            got = read_launches()
            tmit = N_POSES if (name == "slab" and rank < SR_RANKS - 1) else 0
            want = launches_of(composite_fwd=N_POSES, slab_tmit=tmit)
            check(got == want, f"rank {rank}: {name} renders launched {got},"
                  f" expected {want}")
            out[f"{name}_ms"] = ms
            out[f"{name}_fwd_launches"] = got
    del singles, local
    loss1, want = l1_grads(
        lambda p: rasterize.render(p, tcam, W, H, bg, tcfg).image, tg, tgt)
    with torch.no_grad():
        vis = rasterize.render(tg, tcam, W, H, bg, tcfg).radii > 0
    for name, fn in (("slab", slab), ("band", band)):
        reset_launches()
        t = time.perf_counter()
        loss, grads = l1_grads(lambda p: fn(p, tcam)[0], tg, tgt)
        torch.cuda.synchronize()
        out[f"{name}_fb_ms"] = (time.perf_counter() - t) * 1e3
        got = read_launches()
        tmit = 1 if (name == "slab" and rank < SR_RANKS - 1) else 0
        want_l = launches_of(composite_fwd=1, composite_bwd=1, slab_tmit=tmit)
        check(got == want_l, f"rank {rank}: {name} forward plus backward "
              f"launched {got}, expected {want_l}")
        out[f"{name}_fb_launches"] = got
        check(abs(loss - loss1) <= 1e-4, f"{name} loss {loss} vs {loss1}")
        if name == "slab":
            label = f"rank {rank}: slab over ranks"
            out["slab_worst"] = hold_grads(
                label, "the single render's",
                *drop_zero_fields(label, grads, want), vis)
        else:
            for k, v in grads.items():
                check(torch.allclose(v, want[k], **GRAD_TOL),
                      f"rank {rank}: band gradient of {k} differs by "
                      f"{float((v - want[k]).abs().max())}")
    print(f"11b rank {rank}: slab render over {SR_RANKS} ranks, frame ms "
          f"median {np.median(out['slab_ms']):.3f}, forward plus backward "
          f"{out['slab_fb_ms']:.3f} ms; band render frame ms median "
          f"{np.median(out['band_ms']):.3f}, forward plus backward "
          f"{out['band_fb_ms']:.3f} ms; images bit for bit the local "
          f"forms'", flush=True)
    return out


def sr_storage(spec, rank, dev):
    """11a on this rank: its N_GAUSS / SR_RANKS rows of phase 5's scene,
    per transient N_POSES renders (their digests), 1 + SR_STEPS steps, one
    gradient call held to the single render's rows, the collectives' host
    ms of one more step, one profiled step."""
    from gsplat_tpu_torch.parallel import RankParts
    from gsplat_tpu_torch.parallel import mesh as mesh_lib
    parts = RankParts(mesh_lib.make_mesh((("prim", -1),)), "prim")
    tg, tcam, tgt, tcfg = phase5_scene(spec, dev)
    rows = sharded.own_rows(parts, N_GAUSS)
    g = dataclasses.replace(tg, **{k: getattr(tg, k)[rows].clone()
                                   for k in gm.TENSOR_FIELDS})
    del tg
    torch.cuda.empty_cache()
    cams = poses(dev)
    scfg = dataclasses.replace(tcfg, pairs_per_gaussian=spec["ppg"])
    state = trainer.init_state(g, 1)
    n_rows, n_bytes = held_rows(state)
    check(n_rows == N_GAUSS // SR_RANKS, f"rank {rank} holds {n_rows} rows")
    ref = torch.load(spec["want"])
    want = {k: ref[k][rows].to(dev) for k in gm.TRAINABLE_FIELDS}
    want["tap"] = ref["tap"][rows].to(dev)
    vis = ref["radii"][rows].to(dev) > 0
    bg = torch.zeros(3, device=dev)
    ones = torch.ones((1, H, W), device=dev)
    zeros = torch.zeros((1, H, W), device=dev)
    opt = OptimizationConfig()
    kw = dict(image_width=W, image_height=H)
    out = dict(rows=n_rows, bytes=n_bytes, frames={}, peak={}, launches={},
               transient={})
    total = launches_of()
    for tr in sharded.TRANSIENTS:
        render = sharded.make_sharded_render(parts, cfg=scfg, transient=tr,
                                             **kw)
        step = sharded.make_sharded_train_step(
            parts, opt=opt, rcfg=scfg, spatial_lr_scale=1.0, transient=tr,
            **kw)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        with torch.no_grad():
            render(g, cams[0], bg)                           # warm-up
            torch.cuda.synchronize()
            reset_launches()
            frame_ms, frames = [], []
            for c in cams:
                t = time.perf_counter()
                o = render(g, c, bg)
                torch.cuda.synchronize()
                frame_ms.append((time.perf_counter() - t) * 1e3)
                check(int(o.overflow) == 0, f"{tr} overflow")
                check(o.radii.shape[0] == n_rows, f"{tr}: radii rows")
                frames.append((digest(o.image), digest(o.invdepth)))
            got = read_launches()
            check(got == launches_of(composite_fwd=N_POSES),
                  f"rank {rank}: {N_POSES} {tr} renders launched {got}")
            total = {k: total[k] + got[k] for k in total}
        s, aux = step(state, tcam, tgt, ones, zeros, zeros, bg)  # warm-up
        peak_all = torch.cuda.max_memory_allocated() / 1e9
        got_step = []
        out["transient"][tr] = step_transient_gb(
            lambda: got_step.append(step(state, tcam, tgt, ones, zeros,
                                         zeros, bg)))
        del got_step
        torch.cuda.synchronize()
        reset_launches()
        step_ms, step_losses = [], []
        for _ in range(SR_STEPS):
            t = time.perf_counter()
            s, aux = step(s, tcam, tgt, ones, zeros, zeros, bg)
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t) * 1e3)
            step_losses.append(float(aux.loss))
            check(int(aux.overflow) == 0, f"{tr} step overflow")
        check(all(np.isfinite(step_losses)), f"loss {step_losses}")
        check(s.gaussians.capacity == n_rows
              and s.adam.mu["xyz"].shape[0] == n_rows
              and s.stats.denom.shape[0] == n_rows, f"{tr}: rows held")
        loss, _, _, bands, grads, _, tap = sharded.sharded_loss_grads(
            g, state.exposure, tcam, tgt, ones, zeros, zeros, bg,
            state.step + 1, n_shards=parts, transient=tr, opt=opt,
            rcfg=scfg, antialiasing=False, train_test_exp=False,
            use_depth=False, **kw)
        torch.cuda.synchronize()
        got = read_launches()
        calls = SR_STEPS + 1
        want_l = {k: v * calls for k, v in launches_of(**PER_PART).items()}
        if tr == "replicated":
            want_l["scan"] = 0
        check(got == want_l, f"rank {rank}: {SR_STEPS} {tr} steps and one "
              f"gradient call launched {got}, expected {want_l}")
        total = {k: total[k] + got[k] for k in total}
        out["peak"][tr] = max(peak_all,
                              torch.cuda.max_memory_allocated() / 1e9)
        check(abs(float(loss) - ref["loss"]) <= 1e-6 * abs(ref["loss"])
              + 1e-7, f"{tr} loss {float(loss)} vs single {ref['loss']}")
        label = f"rank {rank}: {tr} over ranks"
        worst = hold_grads(label, "the single render's rows",
                           *drop_zero_fields(label, dict(grads, tap=tap),
                                             want), vis)
        sink = {}
        with timed_collectives(sink):
            step(s, tcam, tgt, ones, zeros, zeros, bg)
        busy = profile_call(f"rank {rank}: one {tr} step over ranks",
                            lambda: step(s, tcam, tgt, ones, zeros, zeros,
                                         bg))
        out["frames"][tr] = frames
        print(f"11a rank {rank}, {tr}: {n_rows} rows held ({n_bytes / 1e6:.1f}"
              f" MB of per-gaussian state), frame ms median "
              f"{np.median(frame_ms):.3f} "
              f"({[round(x, 3) for x in frame_ms]}), "
              f"step ms median {np.median(step_ms):.3f} "
              f"({[round(x, 3) for x in step_ms]}), device busy ms of one "
              f"step {busy:.3f}, collectives of one step (host ms, between "
              f"synchronisations): {collective_line(sink)}; worst gradient "
              f"error {worst:.3e} of a field's largest; a step's transients "
              f"at their peak {out['transient'][tr]:.3f} GB above its "
              f"{n_bytes / 1e9:.3f} GB of state (one-process {SR_RANKS}-"
              f"shard local form: {spec['local_peak'][tr]:.3f} GB above "
              f"{spec['local_state_gb']:.3f}); this process's peak "
              f"{out['peak'][tr]:.3f} GB; launches {got}", flush=True)
        del s, aux, bands, grads, tap
        torch.cuda.empty_cache()
    out["launches"] = total
    return out


def sr_loop(spec, rank, dev):
    """11d on this rank: train(..., shard_gaussians=True) on phase 8's
    scene under torch's deterministic algorithms, its rows gathered to rank
    0 afterwards and digested there."""
    import contextlib as ctx
    import random
    import sys

    from gsplat_tpu_torch.config import ModelConfig, PipelineConfig
    from gsplat_tpu_torch.parallel import RankParts
    from gsplat_tpu_torch.parallel import mesh as mesh_lib
    from gsplat_tpu_torch.parallel import rows as rows_lib
    from gsplat_tpu_torch.train import loop
    model = spec["loop_model"]
    writes, densify = [], []

    def audit(event, args):
        if event == "open":
            path, mode, flags = args
            writing = ((isinstance(mode, str) and any(c in mode
                                                      for c in "wax+"))
                       or (isinstance(flags, int) and flags
                           & (os.O_WRONLY | os.O_RDWR | os.O_CREAT)))
            if writing and str(path).startswith(model):
                writes.append(str(path))
        elif event in ("os.mkdir", "shutil.copyfile") and \
                str(args[0]).startswith(model):
            writes.append(str(args[0]))

    dens = trainer.densify_step

    peaks = []

    def dens_rec(state, *a, **kw):
        torch.cuda.synchronize()
        peaks.append(torch.cuda.max_memory_allocated())
        before = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t = time.perf_counter()
        out = dens(state, *a, **kw)
        torch.cuda.synchronize()
        # (iteration, ms, overflow, MB held before, MB the event added at
        # its peak)
        densify.append((state.step, (time.perf_counter() - t) * 1e3,
                        int(out[1]), before / 1e6,
                        (torch.cuda.max_memory_allocated() - before) / 1e6))
        return out

    if rank > 0:
        sys.addaudithook(audit)
    trainer.densify_step = dens_rec
    tee = Tee(sys.stdout)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    try:
        reset_launches()
        random.seed(0)
        t = time.perf_counter()
        with deterministic(), ctx.redirect_stdout(tee):
            _, state = loop.train(
                ModelConfig(source_path=spec["src"], model_path=model,
                            sh_degree=3, resolution=1, eval=True),
                OptimizationConfig(**SR_LOOP_OPT), PipelineConfig(),
                RasterizerConfig(), [SR_LOOP_ITERS], [SR_LOOP_ITERS],
                [SR_LOOP_ITERS], quiet=True, shard_gaussians=True,
                capacity_multiplier=1.0, device=dev)
            torch.cuda.synchronize()
        loop_s = time.perf_counter() - t
    finally:
        trainer.densify_step = dens
    peak = max(peaks + [torch.cuda.max_memory_allocated()]) / 1e9
    launches = read_launches()
    retries = tee.count("retrying frame")
    steps = SR_LOOP_ITERS + retries
    # the loop's default transient, replicated: no scan
    want = dict(expected_loop_launches(steps, spec["n_eval"],
                                       sharded_shards=1), scan=0)
    check(launches == want, f"rank {rank}: the loop over ranks launched "
          f"{launches}, expected {want}")
    check([d[0] for d in densify] == [6] and densify[0][2] > 0,
          f"rank {rank}: densify events {densify} (one, outgrowing the "
          f"capacity)")
    n_rows, n_bytes = held_rows(state)
    parts = RankParts(mesh_lib.make_mesh((("prim", -1),)), "prim")
    whole = rows_lib.gather_to_host(state, parts, mesh_lib.Hold().group)
    out = dict(loop_launches=launches, loop_s=loop_s, retries=retries,
               writes=writes, densify=densify, loop_rows=n_rows,
               loop_bytes=n_bytes, loop_peak=peak)
    if whole is not None:
        out["loop_digest"] = state_digest(whole)
        out["loop_capacity"] = whole.gaussians.capacity
    print(f"11d rank {rank}: {SR_LOOP_ITERS} iterations in {loop_s:.2f} s "
          f"({loop_s / SR_LOOP_ITERS * 1e3:.1f} ms an iteration with the "
          f"scene's set-up), densify (iteration, ms, overflow, MB allocated "
          f"before it, MB it added at its peak) "
          f"{[(d[0], round(d[1], 3), d[2], *(round(x, 1) for x in d[3:]))
              for d in densify]}"
          f", {n_rows} rows held at the end "
          f"({n_bytes / 1e6:.1f} MB), peak memory {peak:.2f} GB, retries "
          f"{retries}, launches {launches}", flush=True)
    return out


SR_BRIDGE_ITERS = 3


def sr_bridge(spec, rank, dev):
    """11e on this rank: train(..., shard_gaussians=True, ring) on phase
    8's scene for SR_BRIDGE_ITERS iterations with rank 0's SIBR bridge,
    under torch's deterministic algorithms. Rank 0's client pauses training
    for a kernel-path and a python-path frame, then trains on one frame an
    iteration. Every rank renders every frame (``network_gui.RankFrames``);
    after each, the rows are gathered to rank 0's host, and rank 0 renders
    the frame again from the whole state in this process: the sharded
    render over a local list of the shards (held bit for bit) and
    ``render`` (within 1 in uint8). Those renders' launches are not
    counted."""
    import contextlib as ctx
    import random
    import sys

    from gsplat_tpu_torch.config import ModelConfig, PipelineConfig
    from gsplat_tpu_torch.parallel import RankParts
    from gsplat_tpu_torch.parallel import mesh as mesh_lib
    from gsplat_tpu_torch.parallel import rows as rows_lib
    from gsplat_tpu_torch.train import loop
    from gsplat_tpu_torch.viewer import network_gui
    parts = RankParts(mesh_lib.make_mesh((("prim", -1),)), "prim")
    hold = mesh_lib.Hold()
    render_request = network_gui.render_request
    served, frame_ms = [], []

    def recorded(state, req, rcfg, pipe, bg, device, **kw):
        torch.cuda.synchronize()
        t = time.perf_counter()
        img = render_request(state, req, rcfg, pipe, bg, device, **kw)
        torch.cuda.synchronize()
        frame_ms.append((time.perf_counter() - t) * 1e3)
        counts = read_launches()
        whole = rows_lib.gather_to_host(state, parts, hold.group)
        if whole is not None:
            whole = trainer.to_device(whole, device)
            local = render_request(whole, req, rcfg, pipe, bg, device,
                                   parts=parts.n,
                                   transient=kw["transient"])
            single = render_request(whole, req, rcfg, pipe, bg, device)
            a, b, c = (np.asarray(network_gui.frame_bytes(x))
                       for x in (img, local, single))
            served.append(dict(frame=a, local=bool(np.array_equal(a, b)),
                               single=int(np.abs(a.astype(int)
                                                 - c.astype(int)).max()),
                               sh_python=req.sh_python))
        for name, k in KERNELS.items():
            k["wrapper"].launches = counts[name]
        return img

    gui = client = None
    if rank == 0:
        gui = network_gui.NetworkGUI("127.0.0.1", 0, device=dev)
        cv, fovx, fovy = loop_test_view(dev)
        p = bridge_payload(cv, fovx, fovy)
        client = start_client(gui, [
            p, dict(p, shs_python=True, rot_scale_python=True,
                    scaling_modifier=0.9)]
            + [dict(p, train=True)] * SR_BRIDGE_ITERS)
    network_gui.render_request = recorded
    tee = Tee(sys.stdout)
    reset_launches()
    try:
        random.seed(0)
        t = time.perf_counter()
        with deterministic(), ctx.redirect_stdout(tee):
            loop.train(
                ModelConfig(source_path=spec["src"],
                            model_path=spec["bridge_model"], sh_degree=3,
                            resolution=1, eval=True),
                OptimizationConfig(iterations=SR_BRIDGE_ITERS),
                PipelineConfig(), RasterizerConfig(), [], [], [],
                quiet=True, shard_gaussians=True, shard_transient="ring",
                capacity_multiplier=1.0, device=dev, network_gui_server=gui)
            torch.cuda.synchronize()
        loop_s = time.perf_counter() - t
    finally:
        network_gui.render_request = render_request
        if gui is not None:
            client[0].join(timeout=60)
            gui.close()
    launches = read_launches()
    n_frames = 2 + SR_BRIDGE_ITERS
    steps = SR_BRIDGE_ITERS + tee.count("retrying frame")
    want = expected_loop_launches(steps, n_frames, sharded_shards=1)
    check(launches == want, f"rank {rank}: the loop under the bridge "
          f"launched {launches}, expected {want}")
    check(len(frame_ms) == n_frames, f"rank {rank} rendered {len(frame_ms)} "
          f"bridge frames, expected {n_frames}")
    out = dict(bridge_launches=launches, bridge_ms=frame_ms,
               bridge_s=loop_s)
    if rank == 0:
        _, frames, errors = client
        check(not errors and len(frames) == n_frames,
              f"11e: the client got {len(frames)} frames, errors {errors}")
        check(all(np.array_equal(f, s["frame"])
                  for f, s in zip(frames, served)),
              "11e: the client's frames are not the ones rendered")
        check(all(s["local"] for s in served), "11e: a bridge frame over "
              "ranks differs from the one-process sharded render's")
        check(max(s["single"] for s in served) <= 1, "11e: a bridge frame "
              "over ranks is more than 1 from render's")
        check(all(float(f.std()) > 0 for f in frames), "11e: blank frame")
        check([s["sh_python"] for s in served[:2]] == [False, True],
              "11e: the python-path frame")
        out["bridge_single_max"] = max(s["single"] for s in served)
    print(f"11e rank {rank}: {SR_BRIDGE_ITERS} iterations under the bridge "
          f"in {loop_s:.2f} s, bridge frame ms "
          f"{[round(x, 1) for x in frame_ms]}, launches {launches}",
          flush=True)
    return out


def join_ranks(spec_path, n_ranks):
    """A rank of phase 11 joins its group: gloo on the card the ranks
    share (``device`` cuda:0), or, under ``--nccl``, NCCL on its own card
    (``device`` cuda: the card of its LOCAL_RANK). Returns (spec, rank,
    device)."""
    from datetime import timedelta

    import torch.distributed as dist

    from gsplat_tpu_torch.parallel import mesh as mesh_lib
    with open(spec_path) as f:
        spec = json.load(f)
    backend = spec.get("backend", "gloo")
    check(mesh_lib.init_distributed(
        device=torch.device(spec["device"]), backend=backend,
        timeout=timedelta(seconds=DP_GROUP_TIMEOUT)), "did not join")
    rank, n = mesh_lib.world()
    check(n == n_ranks and dist.get_backend() == backend, "the group")
    return spec, rank, torch.device("cuda", torch.cuda.current_device())


def shard_rank_main(spec_path):
    """One rank of 11a, 11b, 11d and 11e (or of the spec's ``jobs`` of
    them), prints one ``SRRESULT`` JSON line."""
    import torch.distributed as dist
    spec, rank, dev = join_ranks(spec_path, SR_RANKS)
    jobs = dict(split=sr_split, storage=sr_storage, loop=sr_loop,
                bridge=sr_bridge)
    out = {}
    try:
        for name in spec.get("jobs", list(jobs)):
            out.update(jobs[name](spec, rank, dev))
            torch.cuda.empty_cache()
    finally:
        dist.destroy_process_group()
    print("SRRESULT " + json.dumps(dict(out, rank=rank)), flush=True)


def two_d_rank_main(spec_path):
    """One rank of 11c: JAX's data 2 x prim 2 mesh of the ranks on the
    shared card; one ring step of 10b's state from this rank's rows and
    its data coordinate's camera; rank 0 holds it to the two-camera step.
    Prints one ``TDRESULT`` JSON line."""
    import torch.distributed as dist

    from gsplat_tpu_torch.parallel import RankParts
    from gsplat_tpu_torch.parallel import mesh as mesh_lib
    spec, rank, dev = join_ranks(spec_path, TWO_D_RANKS)
    try:
        mesh = mesh_lib.make_mesh((("data", 2), ("prim", -1)))
        parts = RankParts(mesh, "prim")
        state, views = dp_scene_state(spec, dev)
        opt, cfg = OptimizationConfig(), RasterizerConfig()
        ref = None
        if rank == 0:
            ref = two_camera_reference(state, views, opt, cfg)
        rows = sharded.own_rows(parts, state.gaussians.capacity)
        state = sharded.shard_state(state, parts)
        torch.cuda.empty_cache()
        step = sharded.make_sharded_dp_train_step(
            mesh, transient="ring", image_width=W, image_height=H, opt=opt,
            rcfg=cfg, spatial_lr_scale=1.0)
        dist.barrier()                  # rank 0's reference is done
        reset_launches()
        t = time.perf_counter()
        s2, a2 = step(state, *views[mesh.coords["data"]])
        torch.cuda.synchronize()
        out = dict(ms=(time.perf_counter() - t) * 1e3,
                   launches=read_launches(), loss=float(a2.loss),
                   digest=state_digest(s2), rows=s2.gaussians.capacity,
                   coords=mesh.coords)
        check(int(a2.overflow) == 0, "2-D step overflow")
        if ref is not None:
            _, ref_loss, ref_grads, ref_accum, vis = ref
            loss, want = float(a2.loss), float(ref_loss)
            check(abs(loss - want) <= 1e-6 * abs(want) + 1e-7,
                  f"2-D step loss {loss} vs the two-camera step's {want}")
            # the step's gradients from Adam's first moment (mu = 0.1 g
            # from zero moments) and its accum increment, on this rank's
            # rows (a fresh scene has SH degree 0 active and isotropic
            # scales: no gradient of f_rest or rotation, here as there)
            want = {k: v[rows] for k, v in ref_grads.items()}
            want["accum"] = ref_accum[rows]
            got = {k: s2.adam.mu[k] / 0.1 for k in ref_grads}
            got["accum"] = s2.stats.xyz_gradient_accum
            label = "2-D step over data 2 x prim 2 ranks, ring"
            out["worst"] = hold_grads(
                label, "the two-camera step's rows",
                *drop_zero_fields(label, got, want), vis[rows])
    finally:
        dist.destroy_process_group()
    print("TDRESULT " + json.dumps(dict(out, rank=rank)), flush=True)


def one_process_shard_loop(src, root):
    """The one-process n_shards=2 loop the loop over ranks is held to, on
    cuda:0 under torch's deterministic algorithms. Returns its model
    directory, state digest, capacity, seconds and iteration ms."""
    import contextlib as ctx
    import random
    import sys

    from gsplat_tpu_torch.train import loop
    model_one = os.path.join(root, "loop_one_2shards")
    random.seed(0)
    tee = Tee(sys.stdout)
    t = time.perf_counter()
    with deterministic(), ctx.redirect_stdout(tee):
        from gsplat_tpu_torch.config import ModelConfig, PipelineConfig
        _, one = loop.train(
            ModelConfig(source_path=src, model_path=model_one, sh_degree=3,
                        resolution=1, eval=True),
            OptimizationConfig(**SR_LOOP_OPT), PipelineConfig(),
            RasterizerConfig(), [SR_LOOP_ITERS], [SR_LOOP_ITERS],
            [SR_LOOP_ITERS], quiet=True, shard_gaussians=True, n_shards=2,
            capacity_multiplier=1.0, device=torch.device(RANK_DEVICE))
        torch.cuda.synchronize()
    one_s = time.perf_counter() - t
    one_digest, one_cap = state_digest(one), one.gaussians.capacity
    del one
    torch.cuda.empty_cache()
    one_ms = [x["iter_time"] * 1e3 for x in loop_log(model_one)
              if "iter_time" in x]
    return dict(model=model_one, digest=one_digest, cap=one_cap, s=one_s,
                ms=one_ms)


def hold_loop_ranks(results, one, model_ranks, label):
    """11d's gates: the rows gathered on rank 0 equal the one-process
    loop's bit for bit, rank 0's checkpoint its file, rank 1 writing
    nothing. Returns the ranks' iteration ms (rank 0's log)."""
    r0 = results[0]
    check(r0["loop_digest"] == one["digest"]
          and r0["loop_capacity"] == one["cap"],
          f"{label}: the loop over ranks, its rows gathered, differs from "
          f"the one-process {SR_RANKS}-shard loop's (capacity "
          f"{r0['loop_capacity']} / {one['cap']})")
    check(all(r["writes"] == [] for r in results[1:]),
          f"{label}: rank 1 wrote {results[1]['writes']}")
    ck = f"chkpnt{SR_LOOP_ITERS}.npz"
    with np.load(os.path.join(one["model"], ck)) as a, \
            np.load(os.path.join(model_ranks, ck)) as b:
        check(set(a.files) == set(b.files) and all(
            np.array_equal(a[k], b[k]) for k in a.files),
            f"{label}: rank 0's checkpoint differs from the one-process "
            f"loop's")
    return [x["iter_time"] * 1e3 for x in loop_log(model_ranks)
            if "train_loss_patches/total_loss" in x]


def shard_ranks_phase(prep, src, root, n_eval):
    """11a, 11b, 11d, 11e: SR_RANKS processes of this script sharing the
    card over gloo; their gates against this process's forms. Returns rank
    0's launch counts of 11a, 11b, 11d and 11e."""
    model_ranks = os.path.join(root, "loop_ranks")
    one = one_process_shard_loop(src, root)
    one_s, one_cap, one_ms = one["s"], one["cap"], one["ms"]
    spec = dict(prep, src=src, root=root, loop_model=model_ranks,
                bridge_model=os.path.join(root, "loop_ranks_bridge"),
                device=RANK_DEVICE, n_eval=n_eval)
    results, wall_s = run_ranks(SR_RANKS, "--shard-rank", spec, SR_TIMEOUT,
                                "11a/11b/11d", "SRRESULT")
    for r in results:
        for tr in sharded.TRANSIENTS:
            check([tuple(x) for x in r["frames"][tr]]
                  == [tuple(x) for x in prep["frames"][tr]],
                  f"rank {r['rank']}: the {tr} frames over ranks differ "
                  f"from the one-process {SR_RANKS}-shard form's")
    r0 = results[0]
    iter_ms = hold_loop_ranks(results, one, model_ranks, "11d")
    print(f"shard ranks, {SR_RANKS} ranks sharing the card over gloo, "
          f"{W}x{H}: 11a every transient's frames bit for bit the "
          f"one-process {SR_RANKS}-shard form's, rows per rank "
          f"{[r['rows'] for r in results]} "
          f"({[round(r['bytes'] / 1e6, 1) for r in results]} MB), a step's transients at their peak per rank (GB) "
          f"{[r['transient'] for r in results]} against the one-process "
          f"form's {prep['local_peak']}; 11b slab and band "
          f"images bit for bit the local forms'; 11d the loop's gathered "
          f"state equal to the one-process {SR_RANKS}-shard loop's bit for "
          f"bit (capacity {one_cap}), rank 0's checkpoint its file, rank 1 "
          f"wrote nothing; iteration ms median over ranks "
          f"{np.median(iter_ms):.3f} (one process {np.median(one_ms):.3f}; "
          f"{SR_LOOP_ITERS} iterations in {r0['loop_s']:.2f} s, one process "
          f"{one_s:.2f} s), rows at the end "
          f"{[r['loop_rows'] for r in results]}"
          f", loop peak GB {[round(r['loop_peak'], 2) for r in results]}; "
          f"all ranks in {wall_s:.1f} s", flush=True)
    print(f"bridge under rank-sharded storage (11e), {SR_RANKS} ranks "
          f"sharing the card over gloo, ring, {W}x{H}: every rank rendered "
          f"each of the client's {2 + SR_BRIDGE_ITERS} frames, each bit for "
          f"bit the one-process {SR_RANKS}-shard sharded render of the "
          f"gathered state and within {r0['bridge_single_max']} in uint8 of "
          f"render's; bridge frame ms by rank "
          f"{[[round(x, 1) for x in r['bridge_ms']] for r in results]} "
          f"(median {np.median(r0['bridge_ms']):.3f} on rank 0), "
          f"{SR_BRIDGE_ITERS} iterations in {r0['bridge_s']:.2f} s, launches "
          f"{r0['bridge_launches']}", flush=True)
    split = {k: r0["slab_fwd_launches"][k] + r0["slab_fb_launches"][k]
             + r0["band_fwd_launches"][k] + r0["band_fb_launches"][k]
             for k in KERNELS}
    return (r0["launches"], split, r0["loop_launches"],
            r0["bridge_launches"])


def two_d_phase(src, root, backend="gloo"):
    """11c: TWO_D_RANKS processes of this script as data 2 x prim 2,
    sharing the card over gloo or (``backend`` nccl) one card each.
    Returns rank 0's launch counts."""
    where = "sharing the card" if backend == "gloo" else "one card each"
    results, wall_s = run_ranks(
        TWO_D_RANKS, "--two-d-rank", dict(
            src=src, root=root, backend=backend,
            device=RANK_DEVICE if backend == "gloo" else "cuda"),
        SR_TIMEOUT, f"11c over {backend}", "TDRESULT")
    want = expected_loop_launches(1, 0, sharded_shards=1)
    for r in results:
        check(r["launches"] == want, f"rank {r['rank']}'s 2-D step launched "
              f"{r['launches']}, expected {want}")
        check(r["coords"] == {"data": r["rank"] // 2, "prim": r["rank"] % 2},
              f"rank {r['rank']}: coordinates {r['coords']}")
    check(len({r["loss"] for r in results}) == 1, "the ranks' losses differ")
    check(results[0]["digest"] == results[2]["digest"]
          and results[1]["digest"] == results[3]["digest"],
          "the ranks of a prim coordinate hold different rows")
    r0 = results[0]
    print(f"2-D step over {TWO_D_RANKS} ranks (data 2 x prim 2, ring) "
          f"{where} over {backend}: {r0['rows']} rows a rank, step ms "
          f"{[round(r['ms'], 1) for r in results]}, worst gradient error "
          f"{r0['worst']:.3e} of a field's largest against the two-camera "
          f"step, launches {r0['launches']}; all ranks in {wall_s:.1f} s",
          flush=True)
    return r0["launches"]


# ``--nccl``: 11d and 11c with one rank per card over NCCL, which moves
# the ring's messages card to card (the run with no arguments shares one
# card over gloo, which NCCL refuses). It needs TWO_D_RANKS cards.
# evaluation renders of the loop on phase 8's scene: its test cameras (every
# 8th) and 5 training views
NCCL_N_EVAL = -(-LOOP_CAMS // 8) + 5


def nccl_main():
    """The ring, the densify event's and the growth's messages over NCCL
    between cards: 11d (the loop on SR_RANKS ranks, a densify event that
    outgrows the capacity, its rows gathered bit for bit the one-process
    n_shards=2 loop's) and 11c (the 2-D step on TWO_D_RANKS ranks at phase
    7's gates). Prints a ``nccl`` JSON line last."""
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; nothing run")
    n_cards = torch.cuda.device_count()
    check(n_cards >= TWO_D_RANKS, f"--nccl needs {TWO_D_RANKS} cards, "
          f"{n_cards} visible")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True, timeout=60).stdout.strip()
    print(f"device: {smi.splitlines()} | torch {torch.__version__} cuda "
          f"{torch.version.cuda} nccl {torch.cuda.nccl.version()}",
          flush=True)
    t0 = time.perf_counter()
    build.build(tuple(KERNELS))
    print(f"build: {time.perf_counter() - t0:.2f} s", flush=True)
    root = os.path.join(REPO, "build", "chip_smoke_nccl")
    src = write_loop_scene(os.path.join(root, "loop_scene"),
                           np.random.default_rng(SEED + 8), W, H, LOOP_CAMS)
    one = one_process_shard_loop(src, root)
    model_ranks = os.path.join(root, "loop_ranks")
    spec = dict(src=src, root=root, loop_model=model_ranks, device="cuda",
                backend="nccl", n_eval=NCCL_N_EVAL, jobs=["loop"])
    results, wall_s = run_ranks(SR_RANKS, "--shard-rank", spec, SR_TIMEOUT,
                                "11d over nccl", "SRRESULT")
    iter_ms = hold_loop_ranks(results, one, model_ranks, "11d over nccl")
    r0 = results[0]
    print(f"11d over nccl, {SR_RANKS} ranks one card each, {W}x{H}: the "
          f"loop's gathered state equal to the one-process {SR_RANKS}-shard "
          f"loop's bit for bit (capacity {one['cap']}), rank 0's checkpoint "
          f"its file, rank 1 wrote nothing; iteration ms median "
          f"{np.median(iter_ms):.3f} (one process {np.median(one['ms']):.3f})"
          f", densify {[r['densify'] for r in results]}, launches "
          f"{r0['loop_launches']}; all ranks in {wall_s:.1f} s", flush=True)
    two_d = two_d_phase(src, root, backend="nccl")
    print(smi, flush=True)
    print(json.dumps({"nccl": dict(
        ok=True, cards=n_cards, loop_iter_ms=float(np.median(iter_ms)),
        one_process_iter_ms=float(np.median(one["ms"])),
        loop_launches=r0["loop_launches"], two_d_launches=two_d)}),
        flush=True)


# --------------------------------------------------------------- phase 12
# The synthetic-scene validation path: the scene generator at the soak's
# size, the training drive at its card sizes and a short soak through the
# CLIs. The drive's launches: one step a train iteration, and one forward
# for each of its 12 ground-truth renders and each of its 2 x 12 PSNR
# renders.
SYNTH_SCENE = dict(n_gaussians=12_000, n_cams=24, width=512, height=384)
SYNTH_SOAK_ITERS = 1000
SYNTH_DENSIFY = [600, 700, 800, 900, 1000]   # from 500, every 100
SYNTH_DRIVE_ITERS = 300
SYNTH_TRAIN_GAIN_DB = 3.0    # the soak's train views, as the drive's bar
SYNTH_DRIVE_RENDERS = 12 + 2 * 12
# (d) the reference regime's first 1,000 iterations on the generator's
# scene at 128x96 (3,000 gaussians, 24 cameras, seed 7) through the train
# CLI, held to the held-out PSNR the JAX package's train.py prints on the
# same scene on a CPU (GSPLAT_PLATFORM=cpu; `python
# tools/make_synthetic_scene.py --out <d> --scene soak --n_gaussians 3000
# --n_cams 24 --width 128 --height 96 --seed 7 --device cpu`, then `python
# train.py -s <d>/soak -m <model> --eval --disable_viewer --iterations 1000
# --test_iterations 100 200 500 1000`), within SYNTH_REF_TOL_DB: 0.05 dB
# before the first densify event (600), where only rounding parts the card
# from the CPU (there the port's train_torch.py prints JAX's figures to the
# last digit), and 2 dB after five, whose split draws differ between the
# packages: on a CPU the port ends at 14.093 with its own draws and at
# 15.289 with JAX's (tests/train_with_jax_draws.py). The initial model
# scores 16.174 (soak_30k.model_psnr): the reference regime loses held-out
# PSNR on this scene.
SYNTH_REF_SCENE = dict(n_gaussians=3000, n_cams=24, width=128, height=96)
SYNTH_REF_JAX_PSNR = {100: 17.864, 200: 17.663, 500: 16.016, 1000: 15.276}
SYNTH_REF_TOL_DB = {100: 0.05, 200: 0.05, 500: 0.05, 1000: 2.0}


def synthetic_phase(dev, root):
    """Phase 12: (a) the generator, (b) the drive with exact launches, (c)
    the soak of SYNTH_SOAK_ITERS iterations. Returns (b)'s launches."""
    import contextlib
    import shutil

    from gsplat_tpu_torch.tools import (drive_train, make_synthetic_scene,
                                        soak_30k)

    out = os.path.join(root, "soak")
    shutil.rmtree(out, ignore_errors=True)
    device = ["--device", dev.type]
    scene_args = [x for k, v in SYNTH_SCENE.items() for x in (f"--{k}",
                                                               str(v))]
    t = time.perf_counter()
    run_cli(make_synthetic_scene.main, [
        "--out", os.path.join(out, "scene"), "--scene", "soak", "--seed",
        "7", *scene_args, *device])
    gen_s = time.perf_counter() - t
    pngs = sorted(os.listdir(os.path.join(out, "scene", "soak", "images")))
    check(len(pngs) == SYNTH_SCENE["n_cams"], f"generator wrote {pngs}")
    from PIL import Image
    img = np.asarray(Image.open(os.path.join(out, "scene", "soak", "images",
                                             pngs[0])), np.float32)
    check(img.shape == (SYNTH_SCENE["height"], SYNTH_SCENE["width"], 3)
          and img.std() > 5.0, f"generator image {img.shape} blank")
    print(f"synthetic scene: {SYNTH_SCENE['n_gaussians']} gaussians, "
          f"{SYNTH_SCENE['n_cams']} cameras at {SYNTH_SCENE['width']}x"
          f"{SYNTH_SCENE['height']} in {gen_s:.2f} s (generator, one "
          f"process, the card)", flush=True)

    reset_launches()
    r = drive_train.main([str(SYNTH_DRIVE_ITERS), *device])  # asserts +3 dB
    launches = read_launches()
    for name in KERNELS:
        want = {"composite_fwd": SYNTH_DRIVE_ITERS + SYNTH_DRIVE_RENDERS,
                "composite_bwd": SYNTH_DRIVE_ITERS,
                "ssim_fwd": SYNTH_DRIVE_ITERS,
                "ssim_bwd": SYNTH_DRIVE_ITERS,
                "preprocess_fwd": SYNTH_DRIVE_ITERS + SYNTH_DRIVE_RENDERS,
                "preprocess_bwd": SYNTH_DRIVE_ITERS,
                "gather_entries_fwd": SYNTH_DRIVE_ITERS + SYNTH_DRIVE_RENDERS,
                "gather_entries_bwd": SYNTH_DRIVE_ITERS}.get(name, 0)
        check(launches[name] == want, f"{name} launched {launches[name]} "
              f"times in the drive, expected {want}")
    check(r["overflow"] == 0, f"drive overflow {r['overflow']}")
    print(f"drive_train on the card, 512x256, {SYNTH_DRIVE_ITERS} iters: "
          f"train PSNR {r['p0_train']:.3f} -> {r['p1_train']:.3f} dB, "
          f"held-out {r['p0_test']:.3f} -> {r['p1_test']:.3f} dB, "
          f"{r['it_s']:.2f} it/s, N {r['n']}, launches {launches}",
          flush=True)

    # the soak's stages are processes of their own; their lines go to a
    # log, the summary here. LPIPS without published weights: NaN
    weights = os.environ.pop("GSPLAT_LPIPS_WEIGHTS", None)
    try:
        with open(os.path.join(root, "soak_stdout.log"), "w") as f, \
                contextlib.redirect_stdout(f):
            soak = soak_30k.main([str(SYNTH_SOAK_ITERS), out, *device])
    finally:
        if weights is not None:
            os.environ["GSPLAT_LPIPS_WEIGHTS"] = weights
    with open(os.path.join(out, "model", "training_log.jsonl")) as f:
        log = [json.loads(x) for x in f]
    evals = [e for e in log if soak_30k.TEST_PSNR in e]
    check([e["step"] for e in evals] == [SYNTH_SOAK_ITERS],
          f"soak evaluations at {[e['step'] for e in evals]}")
    # the live count changes only in a densify event: at each of the five
    n_at = {e["step"]: e["total_points"] for e in log if "total_points" in e}
    changed = [i for i in range(2, SYNTH_SOAK_ITERS + 1)
               if n_at[i] != n_at[i - 1]]
    check(changed == SYNTH_DENSIFY, f"the live count changed at {changed}, "
          f"the densify events are at {SYNTH_DENSIFY}")
    # the views it trains on gain SYNTH_TRAIN_GAIN_DB; the held-out views
    # lose PSNR over the reference regime's first 1,000 iterations on the
    # generator's scene (at 128x96 the JAX package's train.py does: (d)
    # holds the port to it there), so here they are reported and held
    # finite
    p_init, p_final = soak["p_init"], soak["p_final"]
    p_1000 = evals[0][soak_30k.TEST_PSNR]
    check(p_final["train"] > p_init["train"] + SYNTH_TRAIN_GAIN_DB,
          f"soak train-view PSNR {p_init['train']} -> {p_final['train']}")
    check(all(np.isfinite([p_1000, p_final["test"]])),
          f"soak held-out PSNR {p_1000}, {p_final['test']}")
    for line in soak["lines"]:
        print(f"soak {SYNTH_SOAK_ITERS}: {line}", flush=True)

    return launches


def synthetic_reference_phase(dev, root):
    """Phase 12 (d): the 128x96 soak's held-out PSNR against the JAX
    package's at each of SYNTH_REF_JAX_PSNR's iterations."""
    import shutil

    from gsplat_tpu_torch.cli import train as train_cli
    from gsplat_tpu_torch.tools import make_synthetic_scene, soak_30k

    device = ["--device", dev.type]
    ref = os.path.join(root, "soak_ref")
    shutil.rmtree(ref, ignore_errors=True)
    run_cli(make_synthetic_scene.main, [
        "--out", os.path.join(ref, "scene"), "--scene", "soak", "--seed",
        "7", *[x for k, v in SYNTH_REF_SCENE.items()
               for x in (f"--{k}", str(v))], *device])
    t = time.perf_counter()
    run_cli(train_cli.main, [
        "-s", os.path.join(ref, "scene", "soak"), "-m",
        os.path.join(ref, "model"), "--eval", "--quiet", "--disable_viewer",
        "--iterations", str(max(SYNTH_REF_JAX_PSNR)), "--test_iterations",
        *map(str, SYNTH_REF_JAX_PSNR), *device])
    ref_s = time.perf_counter() - t
    with open(os.path.join(ref, "model", "training_log.jsonl")) as f:
        got = {e["step"]: e[soak_30k.TEST_PSNR] for e in map(json.loads, f)
               if soak_30k.TEST_PSNR in e}
    check(sorted(got) == sorted(SYNTH_REF_JAX_PSNR),
          f"reference soak evaluations at {sorted(got)}")
    size = (f"{SYNTH_REF_SCENE['width']}x{SYNTH_REF_SCENE['height']} "
            f"({SYNTH_REF_SCENE['n_gaussians']} gaussians)")
    for it, want in SYNTH_REF_JAX_PSNR.items():
        tol = SYNTH_REF_TOL_DB[it]
        check(abs(got[it] - want) <= tol, f"held-out PSNR {got[it]} at "
              f"{it} on the {size} scene, the JAX package's {want} "
              f"(within {tol} dB)")
    print(f"soak {size}, {max(got)} iterations through "
          f"the train CLI in {ref_s:.1f} s: held-out PSNR "
          + ", ".join(f"{it}: {got[it]:.3f} (JAX on a CPU "
                      f"{SYNTH_REF_JAX_PSNR[it]:.3f})" for it in sorted(got)),
          flush=True)


# --------------------------------------------------------------- phase 13
# The measurement entry points (gsplat_tpu_torch/tools, bench_torch.py) on
# the card: (a) bench.py's train-step pixels/s at 1080p, with row culling,
# and on (c)'s trained model of phase 12; (b) the stage profiler; (c) the
# tile sweep in turns, each shape's compositor pair held to its plain
# versions, and 32x64 refused by the kernels; (d) the scatter / sort and
# binning micro-benchmarks at the JAX tools' sizes; (e) the binning taken
# apart.
SWEEP_SHAPES = ((32, 32, 64), (16, 16, 64), (8, 32, 64), (16, 32, 64),
                (16, 64, 64), (32, 32, 32), (32, 32, 256))
SWEEP_ROUNDS = 3           # rounds of one 7-step window per shape, in turns
BENCH_KEYS = {"metric", "value", "unit", "vs_baseline"}
STEP_KERNELS = ("composite_fwd", "composite_bwd", "ssim_fwd", "ssim_bwd",
                "preprocess_fwd", "preprocess_bwd", "gather_entries_fwd",
                "gather_entries_bwd")
REDUCE_TOL = 1e-3          # the reductions, relative to the largest sum
# calls timed per variant of bench_scatter (the tool's default is the JAX
# tool's 20): torch.cumsum along the rows of (4.8M, 16) takes 1.7 s a call
SCATTER_ITERS = 3
# the sweep's backward check: an element outside the gradient gate of the
# exact sums (float32 cancellation) stays within this many times the
# float32 plain version's largest error on the same tiles (the scan's gate
# is twice torch.cumsum's; at 1080p on an NVIDIA H100 80GB HBM3 the
# kernel's largest error is 1.4-3.5x the float32 plain version's on the
# six shapes the sweep checks)
BWD_ROUNDING = 4.0


def bench_line(text, metric):
    """bench.py's last JSON line of ``text``, checked: its keys, its
    metric's name and a positive value."""
    line = json.loads(text.strip().splitlines()[-1])
    check(set(line) == BENCH_KEYS, f"bench line keys {sorted(line)}")
    check(line["metric"] == metric, f"bench metric {line['metric']}, "
          f"expected {metric}")
    check(line["value"] > 0, f"bench value {line['value']}")
    return line


def check_bench_launches(got, sizing_steps, what):
    """The right-sizing's steps (2 unless the first overflowed) and the
    3 x 7 timed ones: one launch of each of the step's kernels a step, none
    of the others."""
    for name in KERNELS:
        want = sizing_steps + 21 if name in STEP_KERNELS else 0
        check(got[name] == want, f"{name} launched {got[name]} times in "
              f"{what}, expected {want}")


def bench_phase(dev, soak_ply):
    """13a: the bench at 1080p in this process (its launches counted by
    the wrappers), with --row_cull through bench_torch.py as a process
    (counted by its own ``launches`` line), and with --ply on phase 12
    (c)'s model. Returns the 1080p run's launches, the profiler's three
    steps included."""
    import io

    lines = {}
    reset_launches()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        r = bench.main(["--device", dev.type])
    launches = read_launches()
    print(buf.getvalue(), end="", flush=True)
    lines["1080p"] = bench_line(buf.getvalue(), "pixels_per_s_fwd_bwd_1080p")
    check(r["sizing_steps"] == 2, "the bench's first step overflowed")
    check_bench_launches(r["launches"], 2, "the bench")
    for name in STEP_KERNELS:       # and the profiler's three steps
        check(launches[name] == 2 + 21 + 3, f"{name}: {launches[name]}")
    del r

    proc = subprocess.run(["python3", "bench_torch.py", "--row_cull",
                           "--device", dev.type],
                          cwd=REPO, capture_output=True, text=True,
                          timeout=600)
    print(proc.stdout, end="", flush=True)
    check(proc.returncode == 0, f"bench_torch.py --row_cull exited "
          f"{proc.returncode}: {proc.stderr[-2000:]}")
    lines["row_cull"] = bench_line(proc.stdout, "pixels_per_s_fwd_bwd_1080p")
    got = json.loads([ln for ln in proc.stdout.splitlines()
                      if ln.startswith("launches ")][-1][len("launches "):])
    steps = int(re.search(r"right-sized in (\d+) steps", proc.stdout)[1])
    check_bench_launches(got, steps, "bench_torch.py --row_cull")

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        r = bench.main(["--ply", soak_ply, "--device", dev.type])
    print(buf.getvalue(), end="", flush=True)
    lines["trained"] = bench_line(buf.getvalue(),
                                  "pixels_per_s_fwd_bwd_1080p_trained")
    check_bench_launches(r["launches"], r["sizing_steps"],
                         "the bench on the trained model")
    del r
    print("bench lines: " + json.dumps(lines), flush=True)
    return launches


def profile_stages_phase(dev):
    """13b: every stage's host, event and busy ms at 1080p; the gather and
    compositor stages' launches exact (a warm-up and profile_stages.ITERS
    calls)."""
    from gsplat_tpu_torch.tools import profile_stages

    reset_launches()
    out = profile_stages.run(dev)
    launches = read_launches()
    check(out["overflow"] == 0, f"profile_stages overflow {out['overflow']}")
    calls = 1 + profile_stages.ITERS
    gather, vjp, fwd, both = (
        profile_stages.STAGES[i].format(compositor="stream")
        for i in (2, 3, 4, 5))
    for stage, want in ((gather, dict(gather_entries_fwd=calls)),
                        (vjp, dict(gather_entries_bwd=calls)),
                        (fwd, dict(composite_fwd=calls)),
                        (both, dict(composite_fwd=calls,
                                    composite_bwd=calls))):
        for name in KERNELS:
            got = out[stage]["launches"][name]
            check(got == want.get(name, 0), f"{name} launched {got} times "
                  f"in the stage {stage!r}, expected {want.get(name, 0)}")
    print("profile stages: " + json.dumps(
        {k: {f: v[f] for f in ("host_ms", "event_ms", "busy_ms", "n_ops")}
         for k, v in out.items() if isinstance(v, dict)}), flush=True)
    return launches


def bwd_vs_exact(label, entries, tile_start, tc, ga, gt, geo, fwd_kw):
    """composite_bwd on the tiles ``tc`` keeps against autograd through the
    plain compositor in float64 (the exact sums) and in float32. A gradient
    element sums its row's terms over the tile's pixels; where they cancel,
    float32 cannot reach the gradient gate's atol, whatever the order of
    summation: the gate holds each element to the exact sums at GRAD_TOL,
    or to BWD_ROUNDING times the float32 plain version's largest error on
    these tiles. Returns (max error against float64, the float32 plain's,
    elements outside GRAD_TOL for the kernel and the float32 plain)."""
    with torch.no_grad():
        sub = composite_fwd_cuda(entries, tile_start, tc, **geo, **fwd_kw)
        kern = composite_bwd_cuda(entries, tile_start, tc, sub.t_final,
                                  sub.n_contrib, ga, gt, **geo)[:, :10]

    def plain(dtype):
        x = entries.detach().to(dtype).requires_grad_()
        out = composite_tiles_plain(x, tile_start, tc, **geo, **fwd_kw)
        ((out.accum * ga.to(dtype)).sum()
         + (out.t_final * gt.to(dtype)).sum()).backward()
        return x.grad[:, :10]

    exact, p32 = plain(torch.float64), plain(torch.float32).double()
    err, err32 = (kern.double() - exact).abs(), (p32 - exact).abs()
    gate = GRAD_TOL["rtol"] * exact.abs() + GRAD_TOL["atol"]
    out_k, out_32 = int((err > gate).sum()), int((err32 > gate).sum())
    slack = BWD_ROUNDING * float(err32.max())
    worst = float(err[err > gate].max()) if out_k else 0.0
    check(worst <= slack, f"composite_bwd ({label}): {out_k} elements "
          f"outside the gradient gate of the exact sums, the worst {worst} "
          f"over {BWD_ROUNDING}x the float32 plain version's largest error "
          f"{float(err32.max())}")
    check(float(kern.abs().max()) > 0.0, f"{label}: zero gradient")
    print(f"kernel vs plain: composite_bwd ({label}) on {N_CHECK_TILES} "
          f"tiles ({int(tc.sum())} entries): max |kernel - exact| "
          f"{float(err.max()):.3e}, float32 plain {float(err32.max()):.3e}; "
          f"outside the gradient gate: kernel {out_k}, float32 plain "
          f"{out_32}", flush=True)
    return float(err.max()), float(err32.max()), out_k, out_32


def sweep_kernels(s, g, cam, rng):
    """One frame of the shape: its compositor pair's kernel ms on the whole
    frame (CUDA events, median of 10), and for every shape but the default
    the forward against the plain compositor on the whole frame
    (``fwd_vs_plain``) and the backward against the exact sums on tiles
    picked as phase 3 picks them (``bwd_vs_exact``)."""
    cfg = s.cfg
    with torch.no_grad():
        e = rasterize.build_entries(g, cam, W, H, cfg)
    b = e.binning
    check(int(b.overflow) == 0, f"{s.label}: overflow {int(b.overflow)}")
    geo = dict(n_tiles_x=e.n_tiles_x, n_tiles_y=e.n_tiles_y,
               tile_h=cfg.tile_h, tile_w=cfg.tile_w,
               alpha_min=cfg.alpha_min, alpha_max=cfg.alpha_max)
    fwd_kw = dict(chunk=cfg.chunk, t_eps=cfg.transmittance_eps)
    args = (e.entries, b.tile_start, b.tile_count)
    T, P = e.n_tiles_x * e.n_tiles_y, cfg.tile_h * cfg.tile_w
    ga, gt = cotangents(rng, T, P, e.entries.device)
    with torch.no_grad():
        f = composite_fwd_cuda(*args, **geo, **fwd_kw)
        fwd_ms = median_ms(lambda: composite_fwd_cuda(*args, **geo,
                                                      **fwd_kw), 10)
        bargs = args + (f.t_final, f.n_contrib, ga, gt)
        bwd_ms = median_ms(lambda: composite_bwd_cuda(*bargs, **geo), 10)
    out = dict(fwd_ms=fwd_ms, bwd_ms=bwd_ms)
    if (cfg.tile_h, cfg.tile_w, cfg.chunk) != (32, 32, 64):
        _, err, mismatch, _ = fwd_vs_plain(s.label, args, dict(geo,
                                                               **fwd_kw))
        berr, berr32, out_k, out_32 = bwd_vs_exact(
            s.label, e.entries, b.tile_start, pick_tiles(b.tile_count, rng),
            ga, gt, geo, fwd_kw)
        out.update(fwd_err=err, n_contrib_mismatch=mismatch, bwd_err=berr,
                   bwd_err_plain32=berr32, bwd_outside=out_k,
                   bwd_outside_plain32=out_32)
    return out


def sweep_phase(g, cam, gt):
    """13c: each shape right-sized as sweep_tiles does, its compositor pair
    checked and timed, then the step timed in turns (SWEEP_ROUNDS rounds of
    one 7-step window each, the best kept) and one step profiled; 32x64
    must raise the kernels' pixel error. Returns the timed turns'
    launches."""
    from gsplat_tpu_torch.tools import sweep_tiles

    dev = gt.device
    rng = np.random.default_rng(SEED + 13)
    shapes = [sweep_tiles.setup(th, tw, c, "stream", g, cam, gt,
                                bench.FIRST_PPG)
              for th, tw, c in SWEEP_SHAPES]
    kern = [sweep_kernels(s, g, cam, rng) for s in shapes]
    states = [s.state for s in shapes]
    best = [float("inf")] * len(shapes)
    reset_launches()
    for _ in range(SWEEP_ROUNDS):
        for i, s in enumerate(shapes):
            ms, states[i], ovf = bench.time_windows(s.step, states[i], dev,
                                                    7, 1)
            check(ovf == 0, f"{s.label}: overflow {ovf} while timed")
            best[i] = min(best[i], ms[0] / 7)
    launches = read_launches()
    want = SWEEP_ROUNDS * 7 * len(shapes)
    for name in KERNELS:
        check(launches[name] == (want if name in STEP_KERNELS else 0),
              f"{name} launched {launches[name]} times in the sweep")
    rows = []
    for s, k, step_ms, st in zip(shapes, kern, best, states):
        busy, n_ops = bench.device_busy(lambda: s.step(st))
        rows.append(dict(shape=s.label, pairs=s.pairs, m_cap=s.m_cap,
                         m_out=s.m_out, tiles=s.tiles, step_ms=step_ms,
                         busy_ms=busy, n_ops=n_ops, **k))
        print(f"sweep {s.label}: pairs={s.pairs} m_cap={s.m_cap} "
              f"m_out={s.m_out} tiles={s.tiles}; step {step_ms:.3f} ms "
              f"(best of {SWEEP_ROUNDS} windows in turns), device busy "
              f"{busy:.3f} ms in {n_ops:.1f} ops; compositor fwd "
              f"{k['fwd_ms']:.3f} + bwd {k['bwd_ms']:.3f} ms"
              + (f"; kernels vs plain: fwd {k['fwd_err']:.3e}, bwd vs exact "
                 f"{k['bwd_err']:.3e} (float32 plain "
                 f"{k['bwd_err_plain32']:.3e})" if "fwd_err" in k else ""),
              flush=True)
    del shapes, states
    # the sweep's entry point once, and the tile the kernels refuse
    sweep_tiles.main(["32", "32", "64", "--device", dev.type])
    try:
        sweep_tiles.main(["32", "64", "64", "--device", dev.type])
    except ValueError as e:
        check("2048 pixels exceeds composite_fwd's 1024" in str(e),
              f"32x64: {e}")
        print(f"sweep 32x64/64: refused by the kernels: {e}", flush=True)
    else:
        check(False, "32x64 tiles ran: the kernels take 1,024 pixels")
    print("sweep: " + json.dumps(rows), flush=True)
    return launches


def micro_phase(dev):
    """13d and 13e: bench_scatter and bench_binning at the JAX tools' card
    sizes, the reductions within REDUCE_TOL of the largest sum of each
    other and s1's order s2's wherever s1's key is its own; then the
    binning taken apart at 1080p (the tool raises unless its stages
    compose to bin_gaussians)."""
    from gsplat_tpu_torch.tools import (bench_binning, bench_scatter,
                                        bisect_binning)

    sc = bench_scatter.run(dev, iters=SCATTER_ITERS)
    for k, v in sc["max_diff"].items():
        check(v <= REDUCE_TOL * sc["scale"], f"reduction {k} differs from "
              f"a) by {v} (largest sum {sc['scale']})")
    u = sc["unique"]
    check(torch.equal(sc["order1"][u], sc["order2"][u]),
          "s1 and s2 order some uncolliding keys differently")
    print(f"scatter: reductions agree (max |x - a)| "
          f"{max(sc['max_diff'].values()):.3e} of largest sum "
          f"{sc['scale']:.3f}); s1 = s2 on the {float(u.float().mean()):.4%}"
          f" of rows whose key is their own; segment_reduce "
          f"{sc['segment_reduce'] or 'ran'}", flush=True)
    del sc
    bb = bench_binning.run(dev)
    n, m_cap = bench_binning.SIZES[dev.type]
    counts = bench_binning.inputs(n, m_cap, bench_binning.N_TILES,
                                  "cpu")["counts"]
    check(torch.equal(bb["repeat_interleave"]["result"].cpu(),
                      bench_binning.repeat(counts, m_cap)),
          "repeat_interleave on the card differs from the CPU's")
    del bb
    bisect_binning.run(dev)


def measure_phase(dev, g, cam, gt, soak_ply):
    """Phase 13. Returns the launches of the bench, the stage profiler and
    the sweep's timed turns."""
    t = [time.perf_counter()]

    def lap():
        t.append(time.perf_counter())
        torch.cuda.empty_cache()
        return round(t[-1] - t[-2], 1)

    launches = dict(bench=bench_phase(dev, soak_ply))
    secs = dict(bench=lap())
    launches["profile_stages"] = profile_stages_phase(dev)
    secs["profile_stages"] = lap()
    launches["sweep"] = sweep_phase(g, cam, gt)
    secs["sweep"] = lap()
    micro_phase(dev)
    secs["micro"] = lap()
    print(f"phase 13 (measurement entry points): {t[-1] - t[0]:.1f} s "
          f"({secs})", flush=True)
    return launches


def main():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; nothing run")
    dev = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True, timeout=60).stdout.strip()
    print(f"device: {kind} | {smi} | torch {torch.__version__} "
          f"cuda {torch.version.cuda}", flush=True)

    t0 = time.perf_counter()
    check(set(KERNELS) == set(build.KERNELS),
          f"the KERNELS table {sorted(KERNELS)} is not what the package "
          f"builds {sorted(build.KERNELS)}")
    report = build.build(tuple(KERNELS))
    regs = "; ".join(ln.strip() for _, _, log in report.values()
                     for ln in log.splitlines() if "registers" in ln)
    print(f"build: {list(report)} in {time.perf_counter() - t0:.2f} s "
          f"(ptxas: {regs})", flush=True)

    rng = np.random.default_rng(SEED)
    cfg = RasterizerConfig()
    ply_path = os.path.join(REPO, "build", "chip_smoke", "point_cloud.ply")
    written = make_ply(ply_path, rng, dev)
    loaded = ply_lib.load_gaussian_ply(ply_path)
    for k, v in written.items():
        check(np.array_equal(loaded[k], v), f"PLY round trip changed {k}")
    g = gm.from_numpy(loaded, device=dev)
    check(g.active_sh_degree == 3 and g.capacity == N_GAUSS, "scene load")
    cams = poses(dev)
    bg = torch.zeros(3, device=dev)

    # ---- phase 3: the kernel against its plain version, on the card
    with torch.no_grad():
        e = rasterize.build_entries(g, cams[0], W, H, cfg)
        b = e.binning
        check(int(b.overflow) == 0, f"overflow {int(b.overflow)}")
        geo = dict(n_tiles_x=e.n_tiles_x, n_tiles_y=e.n_tiles_y,
                   tile_h=cfg.tile_h, tile_w=cfg.tile_w, chunk=cfg.chunk,
                   alpha_min=cfg.alpha_min, alpha_max=cfg.alpha_max,
                   t_eps=cfg.transmittance_eps)
        args = (e.entries, b.tile_start, b.tile_count)
        kern, err, mismatch, plain_ms = fwd_vs_plain("render frame", args,
                                                     geo)
        kern_ms = median_ms(lambda: composite_fwd_cuda(*args, **geo), 20)
    n_rows, evals, n_bytes = fwd_work(b.tile_count, kern.n_contrib)
    walk = pair_walk("render frame", *args, geo,
                     device_cull_rects("render frame", *args, geo),
                     kern.n_contrib)
    hits = walk["hits"]
    bnd = bound(n_bytes, hits * OPS_PER_EVAL)
    print(f"kernel vs plain: composite_fwd max_abs_err {err:.3e}, "
          f"n_contrib mismatch {mismatch:.2e}, kernel {kern_ms:.3f} ms, "
          f"plain {plain_ms:.1f} ms, rows {n_rows}, contributing pairs "
          f"{hits} of {evals} below n_contrib, bound {bnd['bound_ms']:.4f} "
          f"ms ({bnd['bound_by']}; "
          f"{evals * OPS_PER_EVAL / F32_OPS_PER_S * 1e3:.4f} ms if every pair "
          f"below n_contrib were charged)", flush=True)
    tile_lengths("render frame", b.tile_count)
    print(walk_line("render frame", walk), flush=True)
    del kern, e, args

    small = {k: v[:SMALL_N] for k, v in loaded.items()}
    with torch.no_grad():
        ref = rasterize.render(gm.from_numpy(small, device="cpu"),
                               poses("cpu")[0], SMALL_W, SMALL_H,
                               torch.zeros(3), cfg)
        got = rasterize.render(gm.from_numpy(small, device=dev), cams[0],
                               SMALL_W, SMALL_H, bg, cfg)
    small_err = float((got.image.cpu() - ref.image).abs().max())
    check(torch.allclose(got.image.cpu(), ref.image, **IMG_TOL),
          f"small render on the card vs the CPU: max {small_err}")
    print(f"small render {SMALL_W}x{SMALL_H}, {SMALL_N} gaussians: card vs "
          f"CPU max_abs_err {small_err:.3e}", flush=True)
    check_general_tiles(gm.from_numpy(small, device=dev), cams[0],
                        np.random.default_rng(SEED + 3))
    numbers = {"composite_fwd": dict(max_abs_err=err, ms=kern_ms,
                                     plain_ms=plain_ms, **bnd)}

    # ---- phase 3b: the training kernels against their plain versions
    tg, tcam, tgt, tcfg = bench_train_setup(dev)
    check_rng = np.random.default_rng(SEED + 1)
    numbers["composite_bwd"] = check_composite_bwd(tg, tcam, tcfg, check_rng)
    numbers["ssim_fwd"], numbers["ssim_bwd"] = check_ssim(dev, check_rng)
    numbers["preprocess_fwd"], numbers["preprocess_bwd"] = check_preprocess(
        tg, tcam, check_rng)
    numbers["gather_entries_fwd"], numbers["gather_entries_bwd"] = \
        check_gather(tg, tcam, tcfg, check_rng)

    # ---- phase 3c: the kernels as the slab and band paths call them
    slab_numbers, m_cap, pairs = check_slab_kernels(tg, tcam, tcfg, check_rng)
    for name, extra in slab_numbers.items():
        numbers.setdefault(name, {}).update(extra)

    # ---- phase 3d: the blocked prefix sum, at one shard's rows of phase 7
    scfg, m_loc, shard_pairs = sharded_setup(tg, [tcam] + cams, tcfg)
    numbers["scan"] = check_scan(dev, check_rng,
                                 -(-m_loc // SCAN_BLOCK) * SCAN_BLOCK)

    # ---- phase 4: the render path at full width, 5 poses
    with torch.no_grad():
        rasterize.render(g, cams[0], W, H, bg, cfg)       # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        frame_ms, pairs4, padded = [], [], []
        for cam in cams:
            t = time.perf_counter()
            out = rasterize.render(g, cam, W, H, bg, cfg)
            torch.cuda.synchronize()
            frame_ms.append((time.perf_counter() - t) * 1e3)
            check(int(out.overflow) == 0, f"overflow {int(out.overflow)}")
            img = out.image
            check(tuple(img.shape) == (3, H, W), f"image shape {img.shape}")
            check(bool(torch.isfinite(img).all())
                  and bool(torch.isfinite(out.invdepth).all()),
                  "non-finite image")
            check(float(img.std()) > 0.01 and float(img.max()) > 0.1,
                  "blank image")
            pairs4.append(int(out.num_pairs))
            padded.append(int(out.num_padded))
        render_launches = read_launches()
    launches = render_launches["composite_fwd"]
    check(launches == N_POSES,
          f"compositor kernel launched {launches} times for {N_POSES} frames")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    print(f"render {W}x{H}, {N_GAUSS} gaussians, SH 3, {N_POSES} poses: "
          f"frame ms {[round(x, 3) for x in frame_ms]} (median "
          f"{np.median(frame_ms):.3f}), num_pairs {pairs4}, num_padded "
          f"{padded}, launches {launches}, peak memory {peak_gb:.2f} GB",
          flush=True)

    def one_frame():
        with torch.no_grad():
            rasterize.render(g, cams[0], W, H, bg, cfg)
    profile_call("one frame", one_frame)

    # ---- phase 5: the training path at full width
    state, train_launches, train_ms = train_phase(tg, tcam, tgt, tcfg)
    profile_call("one train step",
                 lambda: train(state, tcam, tgt, tcfg, OptimizationConfig()),
                 n_top=15)

    # ---- phase 5b: row culling off and on, on phase 5's scene
    cull_launches, cull_numbers = row_cull_phase(
        tg, tcam, tgt, tcfg, np.random.default_rng(SEED + 11))
    for name, extra in cull_numbers.items():
        numbers[name]["row_cull"] = extra

    # ---- phase 6: the slab and band paths at full width
    slab_launches, band_launches = slab_phase(state.gaussians, cams, tcam,
                                              tgt, tcfg, m_cap, pairs)

    # ---- phase 7: gaussian-sharded storage at full width
    sharded_launches = sharded_phase(state, cams, tcam, tgt, tcfg, scfg,
                                     m_loc, shard_pairs)

    # ---- phase 7b: the culled split and sharded paths, one frame each
    split_cull_launches, split_cull_numbers = row_cull_split_phase(
        state, tcam, tgt, tcfg, scfg, m_cap)
    for name, extra in split_cull_numbers.items():
        numbers[name]["row_cull"] = extra

    # ---- phase 8: the training loop at full width, then sharded
    del state
    loop_counts, loop_sharded_launches, run_a = loop_phase(
        dev, os.path.join(REPO, "build", "chip_smoke"))
    native_loader_phase(dev, run_a["src"])
    depth_scale_phase(run_a["src"], os.path.join(REPO, "build", "chip_smoke"))

    # ---- phase 9: evaluation and viewing on run A's model
    n_eval = run_a.pop("n_eval")      # renders of one evaluation
    eval_launches, view_launches, bridge_launches = view_phase(
        dev, os.path.join(REPO, "build", "chip_smoke"), **run_a)

    # ---- phase 10: camera data parallelism on the one card
    torch.cuda.empty_cache()
    dp_nccl_launches = dp_nccl_phase(tg, tcam, tgt, tcfg, train_ms)
    torch.cuda.empty_cache()
    dp_gloo_launches = dp_gloo_phase(
        run_a["src"], os.path.join(REPO, "build", "chip_smoke"))

    # ---- phase 11: one rank per part, the ranks sharing the card
    torch.cuda.empty_cache()
    root = os.path.join(REPO, "build", "chip_smoke")
    prep = shard_ranks_prep(tg, tcam, tgt, tcfg, cams, root)
    torch.cuda.empty_cache()
    (shard_launches, split_launches, loop_rank_launches,
     bridge_rank_launches) = shard_ranks_phase(prep, run_a["src"], root,
                                               n_eval=n_eval)
    dp_2d_launches = two_d_phase(run_a["src"], root)

    # ---- phase 12: the synthetic-scene validation path
    torch.cuda.empty_cache()
    synth_launches = synthetic_phase(dev, root)
    synthetic_reference_phase(dev, root)

    # ---- phase 13: the measurement entry points
    torch.cuda.empty_cache()
    measure_launches = measure_phase(dev, tg, tcam, tgt, os.path.join(
        root, "soak", "model", "point_cloud",
        f"iteration_{SYNTH_SOAK_ITERS}", "point_cloud.ply"))

    kernels = []
    for name, k in KERNELS.items():
        by_path = {"render": render_launches[name],
                   "train": train_launches[name],
                   "slab": slab_launches[name], "band": band_launches[name],
                   "sharded": sharded_launches[name],
                   "loop": loop_counts[name],
                   "loop_sharded": loop_sharded_launches[name],
                   "eval": eval_launches[name], "view": view_launches[name],
                   "loop_bridge": bridge_launches[name],
                   "dp_nccl": dp_nccl_launches[name],
                   "dp_gloo_loop": dp_gloo_launches[name],
                   "dp_2d": dp_2d_launches[name],
                   "shard_ranks": shard_launches[name],
                   "split_ranks": split_launches[name],
                   "loop_ranks": loop_rank_launches[name],
                   "row_cull": cull_launches[name],
                   "split_cull": split_cull_launches[name],
                   "bridge_ranks": bridge_rank_launches[name],
                   "synthetic": synth_launches[name],
                   **{path: n[name] for path, n in measure_launches.items()}}
        check(any(by_path.values()), f"{name} was launched on no path")
        n = numbers[name]
        for key in ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by"):
            check(key in n, f"{name} has no {key}")
        kernels.append(dict(
            name=name, route="cuda",
            source=f"gsplat_tpu_torch/ops/kernels/csrc/{name}.cu",
            replaces=" + ".join(PALLAS + r for r in k["replaces"])
            or "none: the port's own",
            launches=(by_path["loop"] or by_path["loop_sharded"]
                      or by_path["slab"]),
            launches_by_path=by_path, **{"library_ms": None, **n}))
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    import sys
    if sys.argv[1:2] == ["--dp-rank"]:
        dp_rank_main(sys.argv[2])
    elif sys.argv[1:2] == ["--shard-rank"]:
        shard_rank_main(sys.argv[2])
    elif sys.argv[1:2] == ["--two-d-rank"]:
        two_d_rank_main(sys.argv[2])
    elif sys.argv[1:2] == ["--nccl"]:
        nccl_main()
    else:
        main()
