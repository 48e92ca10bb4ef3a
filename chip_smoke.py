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
4. the render path at full width: bench.py's workload — 200,000 gaussians,
   SH degree 3, 1920x1080 — written to a PLY, loaded back through the port's
   loader, and rendered from 5 camera poses under torch.no_grad(), with the
   kernel's launch count read around exactly those renders;
5. the training path at full width: bench.py's train step on its scene
   (create_from_pcd, 200,000 gaussians, SH 3, 1920x1080, default
   OptimizationConfig, dense Adam): one warm-up step, then 5 timed steps
   with every kernel's launch count read around exactly those steps, and
   one profiled step.
Then a ``kernels`` JSON line, the nvidia-smi line, and a final JSON line.
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
from gsplat_tpu_torch.ops.composite_ref import composite_tiles_plain
from gsplat_tpu_torch.ops.kernels import build
from gsplat_tpu_torch.ops.kernels.composite import (composite_bwd_cuda,
                                                    composite_fwd_cuda)
from gsplat_tpu_torch.ops.kernels.ssim import ssim_bwd_cuda, ssim_fwd_cuda
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
# published H100 SXM peaks (NVIDIA data sheet), for the bound
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
OPS_PER_EVAL = 21          # ~20 f32 operations + 1 exp per (pair, pixel)
OPS_PER_EVAL_BWD = 60      # the backward's ~59 f32 operations + 1 exp
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


def profile_frame(g, cam, bg, cfg):
    """Where one frame's device time goes: torch.profiler's device time by
    kernel (device-side events only, so nothing counts twice), against the
    frame's host-clock time under the profiler."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with torch.no_grad(), profile(activities=[ProfilerActivity.CPU,
                                              ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        rasterize.render(g, cam, W, H, bg, cfg)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t) * 1e3
    rows = sorted(((e.self_device_time_total / 1e3, e.count, e.key)
                   for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA
                   and e.self_device_time_total > 0), reverse=True)
    busy_ms = sum(r[0] for r in rows)
    top = "; ".join(f"{key[:70]} x{n} {ms:.3f} ms"
                    for ms, n, key in rows[:12])
    print(f"profile one frame: wall {wall_ms:.3f} ms under the profiler, "
          f"device busy {busy_ms:.3f} ms; top: {top}", flush=True)


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


def check_composite_bwd(g, cam, cfg, rng):
    """The compositor backward kernel against autograd through the plain
    compositor on the card: d_entries of the training frame's 8 tiles with
    the most entries and 8 more chosen from the seed (the other tiles'
    counts zeroed, so the plain version walks only those), under a
    numpy-seeded random cotangent. Kernel time on the full frame."""
    with torch.no_grad():
        e = rasterize.build_entries(g, cam, W, H, cfg)
    b = e.binning
    check(int(b.overflow) == 0, f"overflow {int(b.overflow)}")
    geo = dict(n_tiles_x=e.n_tiles_x, n_tiles_y=e.n_tiles_y,
               tile_h=cfg.tile_h, tile_w=cfg.tile_w,
               alpha_min=cfg.alpha_min, alpha_max=cfg.alpha_max)
    fwd_kw = dict(chunk=cfg.chunk, t_eps=cfg.transmittance_eps)
    T, P = e.n_tiles_x * e.n_tiles_y, cfg.tile_h * cfg.tile_w
    ga = torch.tensor(rng.standard_normal((T, 4, P)).astype(np.float32),
                      device=e.entries.device)
    gt = torch.tensor(rng.standard_normal((T, P)).astype(np.float32),
                      device=e.entries.device)

    # full frame: the main path's shapes, for the time and the bound
    with torch.no_grad():
        full = composite_fwd_cuda(e.entries, b.tile_start, b.tile_count,
                                  **geo, **fwd_kw)
        args = (e.entries, b.tile_start, b.tile_count, full.t_final,
                full.n_contrib, ga, gt)
        composite_bwd_cuda(*args, **geo)
        torch.cuda.synchronize()
        kern_ms = median_ms(lambda: composite_bwd_cuda(*args, **geo), 20)
    counts = b.tile_count.long()
    max_nc = full.n_contrib.long().amax(dim=1)
    rows = int(torch.minimum(counts, max_nc).sum())
    n_bytes = (rows * 40 + e.entries.shape[0] * 64 + T * 8
               + T * P * (16 + 4 + 4 + 4))
    evals = int(full.n_contrib.long().sum())
    bytes_ms = n_bytes / HBM_BYTES_PER_S * 1e3
    ops_ms = evals * OPS_PER_EVAL_BWD / F32_OPS_PER_S * 1e3

    # 16 tiles: kernel against autograd through the plain version
    top = torch.topk(counts, N_CHECK_TILES // 2).indices.cpu().numpy()
    rest = np.setdiff1d(np.nonzero(counts.cpu().numpy())[0], top)
    pick = np.concatenate([top, rng.choice(rest, N_CHECK_TILES // 2,
                                           replace=False)])
    tc = torch.zeros_like(b.tile_count)
    tc[pick] = b.tile_count[pick]
    with torch.no_grad():
        sub = composite_fwd_cuda(e.entries, b.tile_start, tc, **geo,
                                 **fwd_kw)
        kern = composite_bwd_cuda(e.entries, b.tile_start, tc, sub.t_final,
                                  sub.n_contrib, ga, gt, **geo)
        torch.cuda.synchronize()
        sub_ms = median_ms(lambda: composite_bwd_cuda(
            e.entries, b.tile_start, tc, sub.t_final, sub.n_contrib, ga, gt,
            **geo), 20)

    def plain():
        x = e.entries.detach().requires_grad_()
        out = composite_tiles_plain(x, b.tile_start, tc, **geo, **fwd_kw)
        ((out.accum * ga).sum() + (out.t_final * gt).sum()).backward()
        return x.grad

    want = plain()
    torch.cuda.synchronize()
    plain_ms = median_ms(plain, 3)
    err = float((kern[:, :10] - want[:, :10]).abs().max())
    check(torch.allclose(kern[:, :10], want[:, :10], **GRAD_TOL),
          f"composite_bwd disagrees with autograd through the plain version "
          f"(max {err})")
    check(float(kern[:, 10:].abs().max()) == 0.0, "columns 10-15 not 0")
    print(f"kernel vs plain: composite_bwd on {N_CHECK_TILES} tiles "
          f"({int(tc.sum())} entries, largest tile {int(tc.max())}) "
          f"max_abs_err {err:.3e}, kernel {sub_ms:.3f} ms, plain fwd+bwd "
          f"{plain_ms:.1f} ms; full frame: kernel {kern_ms:.3f} ms, entry "
          f"buffer {e.entries.shape[0]} rows, {int(b.num_pairs)} pairs, rows "
          f"read {rows}, evals {evals}, bound bytes {bytes_ms:.4f} ms / ops "
          f"{ops_ms:.4f} ms", flush=True)
    return dict(max_abs_err=err, ms=kern_ms, plain_ms=plain_ms,
                bound_ms=max(bytes_ms, ops_ms),
                bound_by="operations" if ops_ms >= bytes_ms else "bytes")


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

    def bound(n_bytes, ops):
        b_ms = n_bytes / HBM_BYTES_PER_S * 1e3
        o_ms = ops / F32_OPS_PER_S * 1e3
        return dict(bound_ms=max(b_ms, o_ms),
                    bound_by="operations" if o_ms >= b_ms else "bytes")

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


def train(state, cam, gt, cfg, opt):
    """One bench.py train step on the card."""
    ones = torch.ones((1, H, W), device=gt.device)
    zeros = torch.zeros((1, H, W), device=gt.device)
    return trainer.train_step(
        state, cam, gt, ones, zeros, zeros, torch.zeros(3, device=gt.device),
        image_width=W, image_height=H, opt=opt, rcfg=cfg,
        spatial_lr_scale=1.0, antialiasing=False, use_sparse_adam=False,
        train_test_exp=False, use_depth=False)


KERNEL_WRAPPERS = {"composite_fwd": composite_fwd_cuda,
                   "composite_bwd": composite_bwd_cuda,
                   "ssim_fwd": ssim_fwd_cuda, "ssim_bwd": ssim_bwd_cuda}
# launches per training step: the SSIM backward is two kernels
PER_STEP = {"composite_fwd": 1, "composite_bwd": 1, "ssim_fwd": 1,
            "ssim_bwd": 2}


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
    for fn in KERNEL_WRAPPERS.values():
        fn.launches = 0
    step_ms, losses, overflow = [], [], []
    for _ in range(N_STEPS):
        t = time.perf_counter()
        state, aux = train(state, cam, gt, cfg, opt)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t) * 1e3)
        losses.append(float(aux.loss))
        overflow.append(int(aux.overflow))
    launches = {k: fn.launches for k, fn in KERNEL_WRAPPERS.items()}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    for k, n in launches.items():
        check(n == PER_STEP[k] * N_STEPS,
              f"{k} launched {n} times in {N_STEPS} steps")
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


def profile_step(state, cam, gt, cfg):
    """Where one training step's device time goes, as profile_frame."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        train(state, cam, gt, cfg, OptimizationConfig())
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t) * 1e3
    rows = sorted(((e.self_device_time_total / 1e3, e.count, e.key)
                   for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA
                   and e.self_device_time_total > 0), reverse=True)
    busy_ms = sum(r[0] for r in rows)
    n_ops = sum(r[1] for r in rows)
    top = "; ".join(f"{key[:70]} x{n} {ms:.3f} ms"
                    for ms, n, key in rows[:15])
    print(f"profile one train step: wall {wall_ms:.3f} ms under the "
          f"profiler, device busy {busy_ms:.3f} ms in {n_ops} device ops; "
          f"top: {top}", flush=True)


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
    report = build.build()
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
        kern = composite_fwd_cuda(*args, **geo)
        torch.cuda.synchronize()
        plain = composite_tiles_plain(*args, **geo)
        torch.cuda.synchronize()
        kern_ms = median_ms(lambda: composite_fwd_cuda(*args, **geo), 20)
        plain_ms = median_ms(
            lambda: composite_tiles_plain(*args, **geo), 3)
    err = max(float((kern.accum - plain.accum).abs().max()),
              float((kern.t_final - plain.t_final).abs().max()))
    for k in ("accum", "t_final"):
        check(torch.allclose(getattr(kern, k), getattr(plain, k), **IMG_TOL),
              f"kernel {k} disagrees with the plain version (max {err})")
    mismatch = float((kern.n_contrib != plain.n_contrib).float().mean())
    check(mismatch <= 1e-3, f"n_contrib mismatch {mismatch}")
    # least time for this frame: bytes = entry rows in tile ranges (cols
    # 0-9) + tile tables + outputs; operations = the (pair, pixel)
    # evaluations up to each pixel's last contributor (a lower bound)
    T, P = kern.t_final.shape
    n_rows = int(b.tile_count.long().sum())
    n_bytes = n_rows * 40 + T * 8 + T * P * 24
    evals = int(plain.n_contrib.long().sum())
    bytes_ms = n_bytes / HBM_BYTES_PER_S * 1e3
    ops_ms = evals * OPS_PER_EVAL / F32_OPS_PER_S * 1e3
    print(f"kernel vs plain: composite_fwd max_abs_err {err:.3e}, "
          f"n_contrib mismatch {mismatch:.2e}, kernel {kern_ms:.3f} ms, "
          f"plain {plain_ms:.1f} ms, rows {n_rows}, evals {evals}, "
          f"bound bytes {bytes_ms:.4f} ms / ops {ops_ms:.4f} ms", flush=True)
    del kern, plain, e, args

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
    numbers = {"composite_fwd": dict(
        max_abs_err=err, ms=kern_ms, plain_ms=plain_ms,
        bound_ms=max(bytes_ms, ops_ms),
        bound_by="operations" if ops_ms >= bytes_ms else "bytes")}

    # ---- phase 3b: the training kernels against their plain versions
    tg, tcam, tgt, tcfg = bench_train_setup(dev)
    check_rng = np.random.default_rng(SEED + 1)
    numbers["composite_bwd"] = check_composite_bwd(tg, tcam, tcfg, check_rng)
    numbers["ssim_fwd"], numbers["ssim_bwd"] = check_ssim(dev, check_rng)

    # ---- phase 4: the render path at full width, 5 poses
    with torch.no_grad():
        rasterize.render(g, cams[0], W, H, bg, cfg)       # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        composite_fwd_cuda.launches = 0
        frame_ms, pairs, padded = [], [], []
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
            pairs.append(int(out.num_pairs))
            padded.append(int(out.num_padded))
        launches = composite_fwd_cuda.launches
    check(launches == N_POSES,
          f"compositor kernel launched {launches} times for {N_POSES} frames")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    print(f"render {W}x{H}, {N_GAUSS} gaussians, SH 3, {N_POSES} poses: "
          f"frame ms {[round(x, 3) for x in frame_ms]} (median "
          f"{np.median(frame_ms):.3f}), num_pairs {pairs}, num_padded "
          f"{padded}, launches {launches}, peak memory {peak_gb:.2f} GB",
          flush=True)

    profile_frame(g, cams[0], bg, cfg)

    # ---- phase 5: the training path at full width
    state, train_launches = train_phase(tg, tcam, tgt, tcfg)
    profile_step(state, tcam, tgt, tcfg)

    replaces = {"composite_fwd": "composite_stream.py:82",
                "composite_bwd": "composite_stream.py:230",
                "ssim_fwd": "ssim_kernel.py:90",
                "ssim_bwd": "ssim_kernel.py:98"}
    print(json.dumps({"kernels": [dict(
        name=name, route="cuda",
        source=f"gsplat_tpu_torch/ops/kernels/csrc/{name}.cu",
        replaces=f"gsplat_tpu/ops/pallas/{replaces[name]}",
        launches=train_launches[name], **numbers[name], library_ms=None)
        for name in KERNEL_WRAPPERS]}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
