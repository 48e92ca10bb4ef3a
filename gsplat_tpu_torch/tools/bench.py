"""The throughput benchmark of the root bench.py on the port: pixels per
second of the whole training step (render forward and backward, L1 + SSIM
loss, Adam) on bench.py's synthetic scene, or on a trained model's PLY.

    python bench_torch.py [--ply <point_cloud.ply>] [--row_cull]
                          [--moments vpu|mxu] [--device cpu]

On the card: 1920x1080, 200,000 gaussians (SH 3), the best of 3 windows of
7 chained steps. ``--device cpu`` runs bench.py's CPU size: 256x128, 2,000
gaussians, one window of 3 steps. The pair capacity is right-sized as
bench.py does: a first step at 10 pairs a gaussian (doubled until it does
not overflow, where bench.py stops), then 1.3x its pairs and 1.5x its
alignment padding, and the step again from the saved state. The overflow of every timed step stays on the device, as
a running maximum read once after the windows.

Prints lines about the run (the card and its power limit, each window's
ms, the step's median ms over the windows, the device busy ms and op
count of a step from the profiler over 3 more, the peak allocated
memory, the kernels' launch counts over the right-sizing and timed steps)
and, last, bench.py's one JSON line:
``{"metric", "value", "unit", "vs_baseline"}``, the baseline being the
reference CUDA rasterizer's 1.4e7 pixels/s on an A6000 (BASELINE.md). Any
failure raises and exits non-zero; no error becomes a JSON line.

The module also holds what the other measurement tools share: bench.py's
scene (``bench_scene``, ``trained_scene``), its right-sizing
(``right_sized``) and the timers (``timed``, ``device_busy``).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import time

import numpy as np

BASELINE_PIX_PER_S = 1.4e7
# (width, height, gaussians, steps a window, windows) by device type
SIZES = {"cuda": (1920, 1080, 200_000, 7, 3), "cpu": (256, 128, 2_000, 3, 1)}
FIRST_PPG = 10.0           # the first step's pair capacity per gaussian
FOV = (1.2, 0.9)


def bench_points(rng, n):
    """bench.py's cloud: n points N(0, 2²) kept off the near plane
    (|z| + 4) and their colors, drawn in that order from ``rng``."""
    pts = rng.standard_normal((n, 3)).astype(np.float32) * 2.0
    pts[:, 2] = np.abs(pts[:, 2]) + 4.0
    colors = rng.uniform(0, 1, (n, 3)).astype(np.float32)
    return pts, colors


def ground_truth(rng, W, H, device):
    """bench.py's target image: uniform noise (3, H, W)."""
    import torch
    return torch.tensor(rng.uniform(0, 1, (3, H, W)).astype(np.float32),
                        device=device)


def bench_scene(n, W, H, device):
    """bench.py's synthetic workload from seed 0: ``create_from_pcd`` of
    ``bench_points`` (3-NN scales) with the scales shrunk by e^-1, opacity
    logit 0 and SH 3 active, the identity camera, and the ground truth
    drawn next. Returns (gaussians, camera, ground truth)."""
    import torch

    from gsplat_tpu_torch.core.camera import CameraView
    from gsplat_tpu_torch.models import gaussian_model as gm

    rng = np.random.default_rng(0)
    pts, colors = bench_points(rng, n)
    g = gm.create_from_pcd(pts, colors, 3, capacity=n, device=device)
    g = dataclasses.replace(g, scaling=g.scaling - 1.0,
                            opacity=torch.zeros_like(g.opacity),
                            active_sh_degree=3)
    cam = CameraView.create(np.eye(3), np.zeros(3), *FOV, device=device)
    return g, cam, ground_truth(rng, W, H, device)


def trained_scene(ply_path, device):
    """bench.py ``--ply``'s workload: the trained PLY's gaussians at a
    capacity of their count, every SH degree of the file active, and a
    camera on +z of the centroid at 2.5x the 90th-percentile radius,
    looking down -z at it. Returns (gaussians, camera)."""
    from gsplat_tpu_torch.core.camera import CameraView
    from gsplat_tpu_torch.models import gaussian_model as gm
    from gsplat_tpu_torch.scene import ply as ply_lib

    data = ply_lib.load_gaussian_ply(ply_path)
    g = gm.from_numpy(data, device=device)
    center = data["xyz"].mean(axis=0)
    radius = float(np.percentile(
        np.linalg.norm(data["xyz"] - center, axis=1), 90)) * 2.5
    T = -center.astype(np.float32)
    T[2] += radius
    return g, CameraView.create(np.eye(3), T, *FOV, device=device)


def right_sized(cfg, pairs, padded, n):
    """bench.py's steady-state capacities from one frame's pair count and
    padded extent over ``n`` live gaussians: 1.3x the pairs (at least 2 a
    gaussian) and 1.5x the alignment padding (at least one chunk)."""
    return dataclasses.replace(
        cfg, pairs_per_gaussian=max(pairs * 1.3 / n, 2.0),
        pad_cap=max(cfg.chunk, int((padded - pairs) * 1.5)))


def step_fn(cam, gt, cfg):
    """bench.py's train step: ``state -> (state, aux)``, default
    optimisation settings, no depth, no exposure, black background."""
    import torch

    from gsplat_tpu_torch.config import OptimizationConfig
    from gsplat_tpu_torch.train import trainer

    H, W = gt.shape[1:]
    dev = gt.device
    opt = OptimizationConfig()
    ones = torch.ones((1, H, W), device=dev)
    zeros = torch.zeros((1, H, W), device=dev)
    bg = torch.zeros(3, device=dev)

    def step(state):
        return trainer.train_step(
            state, cam, gt, ones, zeros, zeros, bg, image_width=W,
            image_height=H, opt=opt, rcfg=cfg, spatial_lr_scale=1.0,
            antialiasing=False, use_sparse_adam=False, train_test_exp=False,
            use_depth=False)
    return step


def right_size(g, cam, gt, cfg):
    """A first step at ``cfg``, then the step again from the same initial
    state at the right-sized capacities. bench.py stops when its first step
    overflows; here the first step's capacity doubles until it fits, as
    the training loop grows on overflow (at 1920x1080 a trained model can
    take more than 10 pairs a gaussian). Returns (right-sized config, state
    after its step, the first step's pairs and padded extent, the steps
    taken)."""
    from gsplat_tpu_torch.train import trainer

    n = g.num_active()
    state0 = trainer.init_state(g, 1)
    steps = 1
    _, aux = step_fn(cam, gt, cfg)(state0)
    while int(aux.overflow):
        print(f"first step at {cfg.pairs_per_gaussian:g} pairs a gaussian "
              f"dropped {int(aux.overflow)} of {int(aux.num_pairs)} pairs: "
              f"doubling it", flush=True)
        cfg = dataclasses.replace(
            cfg, pairs_per_gaussian=2 * cfg.pairs_per_gaussian)
        _, aux = step_fn(cam, gt, cfg)(state0)
        steps += 1
    pairs, padded = int(aux.num_pairs), int(aux.num_padded)
    cfg = right_sized(cfg, pairs, padded, n)
    state, aux = step_fn(cam, gt, cfg)(state0)
    if int(aux.overflow):
        raise RuntimeError(f"right-sized step overflowed by "
                           f"{int(aux.overflow)}")
    return cfg, state, pairs, padded, steps + 1


def synchronize(dev):
    import torch
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def timed(fn, dev, iters, warmup=1):
    """(host ms, device ms) per call of ``fn()`` over ``iters`` calls after
    ``warmup``: the host clock to ``torch.cuda.synchronize``, and CUDA
    events around the same calls (None on the CPU)."""
    import torch

    for _ in range(warmup):
        fn()
    synchronize(dev)
    ev = None
    if dev.type == "cuda":
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
    t = time.perf_counter()
    for _ in range(iters):
        fn()
    if ev:
        ev[1].record()
    synchronize(dev)
    host = (time.perf_counter() - t) * 1e3 / iters
    return host, (ev[0].elapsed_time(ev[1]) / iters if ev else None)


def device_busy(fn, calls=10):
    """(device busy ms, device ops) per call of ``fn()`` on the card: the
    device-side events of torch.profiler over ``calls`` calls, summed and
    divided by ``calls``. The device's tracing can start late: a profile of
    a lone compositor launch has shown no event, and one over 10 calls of
    it 6, so the calls start after the device is idle and the host has
    waited 50 ms inside the profile. A fractional op count shows events
    still lost."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        time.sleep(0.05)
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    rows = [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA
            and e.self_device_time_total > 0]
    return (sum(e.self_device_time_total for e in rows) / 1e3 / calls,
            sum(e.count for e in rows) / calls)


def launch_counts():
    """Every CUDA kernel wrapper's launch count since its last reset."""
    from gsplat_tpu_torch.ops.kernels.composite import (
        composite_bwd_cuda, composite_fwd_cuda, slab_transmittance_cuda)
    from gsplat_tpu_torch.ops.kernels.gather import (gather_entries_bwd_cuda,
                                                     gather_entries_fwd_cuda)
    from gsplat_tpu_torch.ops.kernels.preprocess import (preprocess_bwd_cuda,
                                                         preprocess_fwd_cuda)
    from gsplat_tpu_torch.ops.kernels.scan import blocked_cumsum_16_cuda
    from gsplat_tpu_torch.ops.kernels.ssim import ssim_bwd_cuda, ssim_fwd_cuda
    return {"composite_fwd": composite_fwd_cuda.launches,
            "composite_bwd": composite_bwd_cuda.launches,
            "slab_tmit": slab_transmittance_cuda.launches,
            "scan": blocked_cumsum_16_cuda.launches,
            "ssim_fwd": ssim_fwd_cuda.launches,
            "ssim_bwd": ssim_bwd_cuda.launches,
            "preprocess_fwd": preprocess_fwd_cuda.launches,
            "preprocess_bwd": preprocess_bwd_cuda.launches,
            "gather_entries_fwd": gather_entries_fwd_cuda.launches,
            "gather_entries_bwd": gather_entries_bwd_cuda.launches}


def launches_since(before):
    return {k: v - before[k] for k, v in launch_counts().items()}


def card_line(dev):
    """What to print about the device: on the card its name and power limit
    as nvidia-smi gives them."""
    import torch
    if dev.type != "cuda":
        return "device: cpu"
    idx = dev.index if dev.index is not None else torch.cuda.current_device()
    smi = subprocess.run(
        ["nvidia-smi", "-i", str(idx), "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True, timeout=60).stdout.strip()
    return f"device: {torch.cuda.get_device_name(idx)} | {smi}"


def time_windows(step, state, dev, iters, windows):
    """Best of ``windows`` host-clock windows of ``iters`` chained steps,
    the overflow's maximum kept on the device and read once after them.
    Returns (each window's ms, final state, overflow max)."""
    import torch

    ovf = torch.zeros((), dtype=torch.long, device=dev)
    window_ms = []
    for _ in range(windows):
        synchronize(dev)
        t = time.perf_counter()
        for _ in range(iters):
            state, aux = step(state)
            ovf = torch.maximum(ovf, aux.overflow)
        synchronize(dev)
        window_ms.append((time.perf_counter() - t) * 1e3)
    return window_ms, state, int(ovf)


def run(dev, *, ply=None, row_cull=False, moments=None, size=None):
    """bench.py's measurement on ``dev``; ``size`` = (W, H, n, steps a
    window, windows) overrides the device's. Prints the lines about the
    run and returns a dict: ``line`` (bench.py's JSON object), ``launches``
    over the right-sizing and timed steps, ``sizing_steps``, ``pairs``, ``window_ms``,
    ``busy_ms``, ``n_ops``, ``peak_gb``, ``cfg``."""
    import torch

    from gsplat_tpu_torch.config import RasterizerConfig

    W, H, n, iters, windows = size or SIZES[dev.type]
    print(card_line(dev), flush=True)
    before = launch_counts()
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    if ply:
        g, cam = trained_scene(ply, dev)
        gt = ground_truth(np.random.default_rng(0), W, H, dev)
    else:
        g, cam, gt = bench_scene(n, W, H, dev)
    cfg = RasterizerConfig(
        pairs_per_gaussian=FIRST_PPG, row_cull=row_cull,
        moments=moments or RasterizerConfig.moments)
    cfg, state, pairs, padded, sizing_steps = right_size(g, cam, gt, cfg)
    step = step_fn(cam, gt, cfg)
    window_ms, state, ovf = time_windows(step, state, dev, iters, windows)
    if ovf:
        raise RuntimeError(f"pair list truncated during timing ({ovf} "
                           f"dropped max)")
    launches = launches_since(before)
    peak_gb = (torch.cuda.max_memory_allocated(dev) / 1e9
               if dev.type == "cuda" else None)
    busy_ms = n_ops = None
    if dev.type == "cuda":
        busy_ms, n_ops = device_busy(lambda: step(state), calls=3)
    step_ms = [w / iters for w in window_ms]
    print(f"bench {W}x{H}, {g.num_active()} gaussians, SH "
          f"{g.active_sh_degree}, row_cull {row_cull}: pairs {pairs}, "
          f"padded {padded}, pairs_per_gaussian "
          f"{cfg.pairs_per_gaussian:.6f}, pad_cap {cfg.pad_cap}, right-sized "
          f"in {sizing_steps} steps; windows of "
          f"{iters} steps ms {[round(w, 3) for w in window_ms]}, step median "
          f"{float(np.median(step_ms)):.3f} ms", flush=True)
    print("profile of 3 steps, per step: " + (
        f"device busy {busy_ms:.3f} ms in {n_ops:.1f} device ops, peak memory "
        f"{peak_gb:.3f} GB" if busy_ms is not None else
        "device busy not measured (no card)"), flush=True)
    print(f"launches {json.dumps(launches)}", flush=True)

    pix_per_s = W * H * iters / (min(window_ms) / 1e3)
    metric = ("pixels_per_s_fwd_bwd_1080p" if dev.type == "cuda"
              else "pixels_per_s_fwd_bwd_small")
    if ply:
        metric += "_trained"
    line = {"metric": metric, "value": round(pix_per_s, 1),
            "unit": "pixels/s/chip",
            "vs_baseline": round(pix_per_s / BASELINE_PIX_PER_S, 4)}
    return dict(line=line, launches=launches, sizing_steps=sizing_steps,
                pairs=pairs, padded=padded,
                window_ms=window_ms, busy_ms=busy_ms, n_ops=n_ops,
                peak_gb=peak_gb, cfg=cfg)


def main(argv=None):
    from gsplat_tpu_torch.config import MOMENTS, RasterizerConfig

    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--ply", default=None,
                   help="a trained point_cloud.ply instead of the synthetic "
                        "scene")
    p.add_argument("--row_cull", action="store_true")
    p.add_argument("--no_row_cull", action="store_true",
                   help="accepted and ignored (culling is off by default), "
                        "as bench.py does")
    p.add_argument("--moments", default=RasterizerConfig.moments,
                   choices=MOMENTS)
    p.add_argument("--device", default="cuda", choices=["cpu", "cuda"])
    args = p.parse_args(argv)

    from gsplat_tpu_torch.utils.general import resolve_device

    r = run(resolve_device(args.device), ply=args.ply,
            row_cull=args.row_cull, moments=args.moments)
    print(json.dumps(r["line"]), flush=True)
    return r


if __name__ == "__main__":
    main()
