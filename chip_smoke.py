#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (gsplat_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing its own line:
1. device: the card's name and power limit;
2. build: every CUDA kernel of the render and training paths, with nvcc,
   from this checkout, one nvcc per source, all started together;
3. kernel vs plain: the compositor kernel against its plain PyTorch version
   on the card, on the entries of the phase-4 frame; then a small render on
   the card against the same render on the CPU;
3b. the training kernels against their plain versions on the card: the
   compositor backward (on 16 tiles of the phase-5 frame) against autograd
   through the plain compositor, the SSIM map and its backward at
   3x1920x1080 against the plain SSIM; each kernel timed by CUDA events;
3c. the depth-slab and tile-band forms of the kernels against their plain
   versions, on the phase-5 frame's entries split into 4 depth slabs: the
   compositor with a random ``t_init``, with slab 2's real arriving
   transmittance, and with the ``tile_id_base`` of band 1 of 2; the slab
   transmittance against its plain version and against the compositor's
   cut-free t_final; the compositor backward on 16 tiles of slab 1 from
   its ``t_init`` forward under non-zero cotangents of accum and t_final,
   and again with a ``tile_id_base``;
4. the render path at full width: bench.py's workload — 200,000 gaussians,
   SH degree 3, 1920x1080 — written to a PLY, loaded back through the port's
   loader, and rendered from 5 camera poses under torch.no_grad(), with the
   kernel's launch count read around exactly those renders;
5. the training path at full width: bench.py's train step on its scene
   (create_from_pcd, 200,000 gaussians, SH 3, 1920x1080, default
   OptimizationConfig, dense Adam): one warm-up step, then 5 timed steps
   with every kernel's launch count read around exactly those steps, and
   one profiled step;
6. the depth-slab and tile-band paths at full width, on the phase-5 scene:
   ``render_prim_sharded`` with 4 slabs from the 5 poses under
   torch.no_grad() and one forward plus backward of an L1 loss, held to
   the single render and its gradient, with the launch counts read around
   exactly those; ``render_tile_sharded`` with 2 bands, held to the single
   render; one profiled slab render.
Then a ``kernels`` JSON line with one object per kernel of the KERNELS
table, the nvidia-smi line, and a final JSON line.
Any failure raises and exits non-zero; without CUDA it exits non-zero
before printing any result.
"""
import dataclasses
import json
import os
import subprocess
import time

import numpy as np
import torch

from gsplat_tpu_torch.config import OptimizationConfig, RasterizerConfig
from gsplat_tpu_torch.core import sh as sh_lib
from gsplat_tpu_torch.core.camera import CameraView
from gsplat_tpu_torch.models import gaussian_model as gm
from gsplat_tpu_torch.ops import knn, rasterize
from gsplat_tpu_torch.ops import ssim as ssim_lib
from gsplat_tpu_torch.ops.composite_ref import (composite_tiles_plain,
                                                slab_transmittance_plain)
from gsplat_tpu_torch.ops.kernels import build
from gsplat_tpu_torch.ops.kernels.composite import (composite_bwd_cuda,
                                                    composite_fwd_cuda,
                                                    slab_transmittance_cuda)
from gsplat_tpu_torch.ops.kernels.ssim import ssim_bwd_cuda, ssim_fwd_cuda
from gsplat_tpu_torch.parallel import prim_shard, tile_shard
from gsplat_tpu_torch.scene import ply as ply_lib
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
# published H100 SXM peaks (NVIDIA data sheet), for the bound
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
OPS_PER_EVAL = 21          # ~20 f32 operations + 1 exp per (pair, pixel)
OPS_PER_EVAL_BWD = 60      # the backward's ~59 f32 operations + 1 exp
OPS_PER_EVAL_TMIT = 18     # the alpha alone (16 + 1 exp) and one product
# f32 operations per pixel: SSIM map = 3 products + 5 blurs x 2 passes x
# 21 + ~20 for the map; backward = the same fields again + ~20 for the t
# maps + 3 blurs x 42 + 4 to combine
OPS_SSIM_FWD = 233
OPS_SSIM_BWD = 233 + 20 + 130
N_CHECK_TILES = 16         # tiles the compositor backward is checked on
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


def bench_points(rng):
    """bench.py's synthetic cloud: 200k points in front of the camera (kept
    off the near plane) and their colors."""
    pts = rng.standard_normal((N_GAUSS, 3)).astype(np.float32) * 2.0
    pts[:, 2] = np.abs(pts[:, 2]) + 4.0
    colors = rng.uniform(0, 1, (N_GAUSS, 3)).astype(np.float32)
    return pts, colors


def make_ply(path, rng, device):
    """bench.py's synthetic scene: a 200k-point cloud in front of the
    camera, 3-NN init scales (the port's knn on the card) shrunk by e^-1,
    opacity 0.5; higher SH coefficients small and random so the degree-3
    colors vary."""
    pts, colors = bench_points(rng)
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
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t) * 1e3
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


def bound(n_bytes, ops):
    """The least time the card could take: the larger of the bytes over
    its memory rate and the f32 operations over its peak rate."""
    b_ms = n_bytes / HBM_BYTES_PER_S * 1e3
    o_ms = ops / F32_OPS_PER_S * 1e3
    return dict(bound_ms=max(b_ms, o_ms),
                bound_by="operations" if o_ms >= b_ms else "bytes")


def fwd_work(tile_count, n_contrib, has_t_init=False):
    """What one compositor forward launch must do, as (rows, evals, bytes):
    bytes = the entry rows in tile ranges (columns 0-9) + tile tables +
    outputs (+ t_init); evals = the (pair, pixel) evaluations up to each
    pixel's last contributor (a lower bound), OPS_PER_EVAL operations
    each."""
    T, P = n_contrib.shape
    rows = int(tile_count.long().sum())
    return (rows, int(n_contrib.long().sum()),
            rows * 40 + T * 8 + T * P * (24 + 4 * has_t_init))


def bwd_work(n_rows, tile_count, n_contrib):
    """What one compositor backward launch must do, as (rows, evals,
    bytes): 40 B in for each entry row up to its tile's largest n_contrib +
    64 B out for every row of d_entries + tables + 28 B per pixel
    (cotangents, t_final, n_contrib); evals as the forward's,
    OPS_PER_EVAL_BWD operations each."""
    T, P = n_contrib.shape
    rows = int(torch.minimum(tile_count.long(),
                             n_contrib.long().amax(dim=1)).sum())
    return (rows, int(n_contrib.long().sum()),
            rows * 40 + n_rows * 64 + T * 8 + T * P * (16 + 4 + 4 + 4))


def bench_train_setup(dev):
    """bench.py's training workload: its scene from create_from_pcd (3-NN
    scales minus 1, opacity logit 0, SH 3 active), its camera, its uniform
    ground truth, and its pair capacities right-sized from a probe frame
    (1.3x the pairs, 1.5x the alignment padding)."""
    rng = np.random.default_rng(SEED)
    pts, colors = bench_points(rng)
    g = gm.create_from_pcd(pts, colors, 3, capacity=N_GAUSS, device=dev)
    g = dataclasses.replace(g, scaling=g.scaling - 1.0,
                            opacity=torch.zeros_like(g.opacity),
                            active_sh_degree=3)
    cam = CameraView.create(np.eye(3), np.zeros(3), fovx=1.2, fovy=0.9,
                            device=dev)
    gt = torch.tensor(rng.uniform(0, 1, (3, H, W)).astype(np.float32),
                      device=dev)
    cfg = RasterizerConfig(pairs_per_gaussian=10.0)
    with torch.no_grad():
        b = rasterize.build_entries(g, cam, W, H, cfg).binning
    check(int(b.overflow) == 0, f"probe overflow {int(b.overflow)}")
    pairs, padded = int(b.num_pairs), int(b.num_padded)
    cfg = dataclasses.replace(
        cfg, pairs_per_gaussian=max(pairs * 1.3 / N_GAUSS, 2.0),
        pad_cap=max(cfg.chunk, int((padded - pairs) * 1.5)))
    return g, cam, gt, cfg


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


def check_composite_bwd(g, cam, cfg, rng):
    """The compositor backward kernel against autograd through the plain
    compositor on the card, on 16 tiles of the training frame under
    numpy-seeded random cotangents. Kernel time on the full frame."""
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
    bnd = bound(n_bytes, evals * OPS_PER_EVAL_BWD)
    err, _, plain_ms = bwd_vs_plain(
        "training frame", e.entries, b.tile_start,
        pick_tiles(b.tile_count, rng), ga, gt, geo, fwd_kw)
    print(f"composite_bwd on the full frame: kernel {kern_ms:.3f} ms, entry "
          f"buffer {e.entries.shape[0]} rows, {int(b.num_pairs)} pairs, rows "
          f"read {rows}, evals {evals}, bound {bnd['bound_ms']:.4f} ms "
          f"({bnd['bound_by']})", flush=True)
    return dict(max_abs_err=err, ms=kern_ms, plain_ms=plain_ms, **bnd)


def check_ssim(dev, rng):
    """The SSIM map and its backward against the plain SSIM on the card at
    3x1080x1920, under the mean's uniform cotangent and a numpy-seeded
    non-uniform one. Returns the two kernels' numbers."""
    a = rng.uniform(0, 1, (3, H, W)).astype(np.float32)
    b = np.clip(a + 0.1 * rng.standard_normal(a.shape), 0, 1)
    # the non-uniform cotangent is 1e-2 of unit size: d img1 sums terms
    # that cancel, and their float32 rounding (~1e-7 of their size, in
    # autograd as in the kernel) at unit size alone exceeds the gate's atol
    x, y, w = (torch.tensor(v, dtype=torch.float32, device=dev)
               for v in (a, b, 1e-2 * rng.uniform(0, 1, a.shape)))
    n = x.numel()
    got = ssim_fwd_cuda(x, y)
    with torch.no_grad():
        want = ssim_lib.ssim_map(x, y)
    fwd_err = float((got - want).abs().max())
    check(torch.allclose(got, want, **SSIM_TOL),
          f"ssim_fwd disagrees with the plain map (max {fwd_err})")
    fwd_ms = median_ms(lambda: ssim_fwd_cuda(x, y), 20)
    with torch.no_grad():
        fwd_plain_ms = median_ms(lambda: ssim_lib.ssim_map(x, y), 5)

    xg = x.clone().requires_grad_()
    m = ssim_lib.ssim_map(xg, y)
    bwd_err = 0.0
    for cot in (torch.full_like(x, 1.0 / n), w):
        want = torch.autograd.grad(m, xg, cot, retain_graph=True)[0]
        got = ssim_bwd_cuda(x, y, cot)
        bwd_err = max(bwd_err, float((got - want).abs().max()))
        check(torch.allclose(got, want, **SSIM_GRAD_TOL),
              f"ssim_bwd disagrees with autograd through the plain map "
              f"(max {bwd_err})")
    bwd_ms = median_ms(lambda: ssim_bwd_cuda(x, y, w), 20)
    bwd_plain_ms = median_ms(lambda: torch.autograd.grad(
        m, xg, w, retain_graph=True), 5)
    del m, xg

    fwd = dict(max_abs_err=fwd_err, ms=fwd_ms, plain_ms=fwd_plain_ms,
               **bound(12 * n, OPS_SSIM_FWD * n))
    bwd = dict(max_abs_err=bwd_err, ms=bwd_ms, plain_ms=bwd_plain_ms,
               **bound(16 * n, OPS_SSIM_BWD * n))
    print(f"kernel vs plain: ssim_fwd at 3x{H}x{W} max_abs_err "
          f"{fwd_err:.3e}, kernel {fwd_ms:.3f} ms, plain {fwd_plain_ms:.3f} "
          f"ms, bound {fwd['bound_ms']:.4f} ms ({fwd['bound_by']}); "
          f"ssim_bwd (2 launches) max_abs_err {bwd_err:.3e}, kernel "
          f"{bwd_ms:.3f} ms, plain backward {bwd_plain_ms:.3f} ms, bound "
          f"{bwd['bound_ms']:.4f} ms ({bwd['bound_by']})", flush=True)
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


def slab_m_cap(g, cam, cfg):
    """The per-slab pair capacity, right-sized from a probe: 1.3x the
    fullest slab's pairs. Returns (m_cap, pairs per slab)."""
    with torch.no_grad():
        probe = prim_shard.build_slab_entries(
            g, cam, W, H, cfg, n_slabs=N_SLABS,
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
            check(torch.allclose(got, cutfree, **SLAB_TOL),
                  f"slab_tmit disagrees with the cut-free composite (max "
                  f"{cut_err})")
            tmit_ms.append(median_ms(
                lambda: slab_transmittance_cuda(*args, **tmit_kw), 20))
            tmit_plain_ms.append(median_ms(
                lambda: slab_transmittance_plain(*args, **tmit_kw), 3))
            t_nocut.append(got)
        check(bool((t_nocut[0][slabs[0].binning.tile_count == 0] == 1).all()),
              "slab_tmit: an empty tile is not 1")
    # every (pair, pixel) is evaluated: nothing ends early
    tmit_rows = sum(pairs)
    tmit_bound = bound(tmit_rows * 24 + N_SLABS * (T * 8 + T * P * 4),
                       tmit_rows * P * OPS_PER_EVAL_TMIT)
    print(f"kernel vs plain: slab_tmit on {N_SLABS} slabs (pairs {pairs}, "
          f"m_cap {m_cap}) and the whole frame: max_abs_err {tmit_err:.3e}, "
          f"vs composite_fwd(t_eps=0).t_final {cut_err:.3e}; kernel ms per "
          f"slab {[round(x, 3) for x in tmit_ms[:-1]]} (sum "
          f"{sum(tmit_ms[:-1]):.3f}), whole frame {tmit_ms[-1]:.3f}; plain "
          f"ms per slab {[round(x, 1) for x in tmit_plain_ms[:-1]]}; bound "
          f"of the {N_SLABS} launches {tmit_bound['bound_ms']:.4f} ms "
          f"({tmit_bound['bound_by']})", flush=True)
    numbers = {"slab_tmit": dict(
        max_abs_err=tmit_err, ms=sum(tmit_ms[:-1]),
        plain_ms=sum(tmit_plain_ms[:-1]), **tmit_bound)}

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
    slab_outs = []
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
    fwd_bnd = bound(n_bytes, evals * OPS_PER_EVAL)
    print(f"kernel vs plain: composite_fwd with each slab's arriving "
          f"transmittance: max_abs_err {fwd_err:.3e}, n_contrib mismatch "
          f"{fwd_mis:.2e}; kernel ms per slab "
          f"{[round(x, 3) for x in fwd_ms]} (sum {sum(fwd_ms):.3f}), plain "
          f"ms per slab {[round(x, 1) for x in fwd_plain_ms]}; rows {rows}, "
          f"evals {evals} (the single frame: "
          f"{int(uncut.n_contrib.long().sum())}), bound of the {N_SLABS} "
          f"launches {fwd_bnd['bound_ms']:.4f} ms ({fwd_bnd['bound_by']})",
          flush=True)
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
    bwd_bnd = bound(n_bytes, evals * OPS_PER_EVAL_BWD)
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
          f"read {rows}, evals {evals}, bound of the {N_SLABS} launches "
          f"{bwd_bnd['bound_ms']:.4f} ms ({bwd_bnd['bound_by']})", flush=True)
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
# kernel bodies it replaces, and its launches per training step (the SSIM
# backward is two kernels), per slab render (forward; the backward kernel in
# the backward) and per band render. The build, the launch checks and the
# ``kernels`` line all read this one table.
KERNELS = {
    "composite_fwd": dict(
        wrapper=composite_fwd_cuda, per_step=1, per_slab_render=N_SLABS,
        per_band_render=N_BANDS,
        replaces=["composite_stream.py:82", "composite.py:167"]),
    "composite_bwd": dict(
        wrapper=composite_bwd_cuda, per_step=1, per_slab_render=N_SLABS,
        per_band_render=N_BANDS,
        replaces=["composite_stream.py:230", "composite.py:406"]),
    "slab_tmit": dict(
        wrapper=slab_transmittance_cuda, per_step=0,
        per_slab_render=N_SLABS, per_band_render=0,
        replaces=["composite.py:326"]),
    "ssim_fwd": dict(wrapper=ssim_fwd_cuda, per_step=1, per_slab_render=0,
                     per_band_render=0, replaces=["ssim_kernel.py:90"]),
    "ssim_bwd": dict(wrapper=ssim_bwd_cuda, per_step=2, per_slab_render=0,
                     per_band_render=0, replaces=["ssim_kernel.py:98"]),
}


def reset_launches():
    for k in KERNELS.values():
        k["wrapper"].launches = 0


def read_launches():
    return {name: k["wrapper"].launches for name, k in KERNELS.items()}


def check_launches(got, key, times, what, backward=True):
    """Every kernel launched exactly its ``key`` count times ``times``; a
    run without a backward launched composite_bwd no time."""
    for name, k in KERNELS.items():
        want = k[key] * times * (backward or name != "composite_bwd")
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
    return state, launches


def l1_grads(render, g, gt):
    """Gradients of mean |image - gt| with respect to the trainables, for
    ``render(gaussians) -> image``. Returns (loss, {field: gradient})."""
    params = {k: getattr(g, k).detach().clone().requires_grad_()
              for k in gm.TRAINABLE_FIELDS}
    loss = (render(gm.with_trainables(g, params)) - gt).abs().mean()
    loss.backward()
    return float(loss.detach()), {k: v.grad for k, v in params.items()}


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
    grad_err = {}
    for k, v in grads.items():
        check(bool(torch.isfinite(v).all()), f"non-finite gradient of {k}")
        check(float(v[~vis].abs().sum()) == 0.0,
              f"gradient of {k} on invisible gaussians")
        d = (v - want[k]).abs()
        out = d > SLAB_GRAD_TOL["atol"] + SLAB_GRAD_TOL["rtol"] * want[k].abs()
        grad_err[k] = (float(d.max()), float(want[k].abs().max()),
                       float(out.float().mean()))
    print(f"slab gradients vs the single render's (max abs err, max |grad|, "
          f"share outside rtol {SLAB_GRAD_TOL['rtol']} / atol "
          f"{SLAB_GRAD_TOL['atol']}; also held: max abs err <= "
          f"{SLAB_GRAD_REL_MAX} x max |grad|): "
          + "; ".join(f"{k} {a:.3e} {b:.3e} {c:.2e}"
                      for k, (a, b, c) in grad_err.items()), flush=True)
    for k, (err, size, share) in grad_err.items():
        check(share == 0.0, f"slab gradient of {k} outside the gate on "
              f"{share} of its elements")
        check(size > 0 and err <= SLAB_GRAD_REL_MAX * size,
              f"slab gradient of {k}: max error {err} against a largest "
              f"gradient of {size}")
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
    bnd = bound(n_bytes, evals * OPS_PER_EVAL)
    print(f"kernel vs plain: composite_fwd max_abs_err {err:.3e}, "
          f"n_contrib mismatch {mismatch:.2e}, kernel {kern_ms:.3f} ms, "
          f"plain {plain_ms:.1f} ms, rows {n_rows}, evals {evals}, "
          f"bound {bnd['bound_ms']:.4f} ms ({bnd['bound_by']})", flush=True)
    del kern, e, args

    small = {k: v[:3000] for k, v in loaded.items()}
    with torch.no_grad():
        ref = rasterize.render(gm.from_numpy(small, device="cpu"),
                               poses("cpu")[0], 256, 128, torch.zeros(3), cfg)
        got = rasterize.render(gm.from_numpy(small, device=dev), cams[0],
                               256, 128, bg, cfg)
    small_err = float((got.image.cpu() - ref.image).abs().max())
    check(torch.allclose(got.image.cpu(), ref.image, **IMG_TOL),
          f"small render on the card vs the CPU: max {small_err}")
    print(f"small render 256x128, 3000 gaussians: card vs CPU max_abs_err "
          f"{small_err:.3e}", flush=True)
    numbers = {"composite_fwd": dict(max_abs_err=err, ms=kern_ms,
                                     plain_ms=plain_ms, **bnd)}

    # ---- phase 3b: the training kernels against their plain versions
    tg, tcam, tgt, tcfg = bench_train_setup(dev)
    check_rng = np.random.default_rng(SEED + 1)
    numbers["composite_bwd"] = check_composite_bwd(tg, tcam, tcfg, check_rng)
    numbers["ssim_fwd"], numbers["ssim_bwd"] = check_ssim(dev, check_rng)

    # ---- phase 3c: the kernels as the slab and band paths call them
    slab_numbers, m_cap, pairs = check_slab_kernels(tg, tcam, tcfg, check_rng)
    for name, extra in slab_numbers.items():
        numbers.setdefault(name, {}).update(extra)

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
    state, train_launches = train_phase(tg, tcam, tgt, tcfg)
    profile_call("one train step",
                 lambda: train(state, tcam, tgt, tcfg, OptimizationConfig()),
                 n_top=15)

    # ---- phase 6: the slab and band paths at full width
    slab_launches, band_launches = slab_phase(state.gaussians, cams, tcam,
                                              tgt, tcfg, m_cap, pairs)

    kernels = []
    for name, k in KERNELS.items():
        by_path = {"render": render_launches[name],
                   "train": train_launches[name],
                   "slab": slab_launches[name], "band": band_launches[name]}
        check(any(by_path.values()), f"{name} was launched on no path")
        n = numbers[name]
        for key in ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by"):
            check(key in n, f"{name} has no {key}")
        kernels.append(dict(
            name=name, route="cuda",
            source=f"gsplat_tpu_torch/ops/kernels/csrc/{name}.cu",
            replaces=" + ".join(PALLAS + r for r in k["replaces"]),
            launches=by_path["train"] or by_path["slab"],
            launches_by_path=by_path, **n, library_ms=None))
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
