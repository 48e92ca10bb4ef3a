#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (gsplat_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing its own line:
1. device: the card's name and power limit;
2. build: every CUDA kernel of the render path, with nvcc, from this checkout;
3. kernel vs plain: the compositor kernel against its plain PyTorch version
   on the card, on the entries of the phase-4 frame; then a small render on
   the card against the same render on the CPU;
4. the render path at full width: bench.py's workload — 200,000 gaussians,
   SH degree 3, 1920x1080 — written to a PLY, loaded back through the port's
   loader, and rendered from 5 camera poses under torch.no_grad(), with the
   kernel's launch count read around exactly those renders.
Then a ``kernels`` JSON line, the nvidia-smi line, and a final JSON line.
Any failure raises and exits non-zero; without CUDA it exits non-zero
before printing any result.
"""
import json
import os
import subprocess
import time

import numpy as np
import torch

from gsplat_tpu_torch.config import RasterizerConfig
from gsplat_tpu_torch.core import sh as sh_lib
from gsplat_tpu_torch.core.camera import CameraView
from gsplat_tpu_torch.models import gaussian_model as gm
from gsplat_tpu_torch.ops import rasterize
from gsplat_tpu_torch.ops.composite_ref import composite_tiles_plain
from gsplat_tpu_torch.ops.kernels import build
from gsplat_tpu_torch.ops.kernels.composite import composite_fwd_cuda
from gsplat_tpu_torch.scene import ply as ply_lib

SEED = 0
N_GAUSS = 200_000          # bench.py's workload
W, H = 1920, 1080
N_POSES = 5
IMG_TOL = dict(rtol=2e-4, atol=2e-5)   # the JAX suite's image gate
# published H100 SXM peaks (NVIDIA data sheet), for the bound
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
OPS_PER_EVAL = 21          # ~20 f32 operations + 1 exp per (pair, pixel)
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


def make_ply(path, rng):
    """bench.py's synthetic scene: a 200k-point cloud in front of the
    camera, 3-NN init scales shrunk by e^-1, opacity 0.5; higher SH
    coefficients small and random so the degree-3 colors vary."""
    from scipy.spatial import cKDTree
    pts = rng.standard_normal((N_GAUSS, 3)).astype(np.float32) * 2.0
    pts[:, 2] = np.abs(pts[:, 2]) + 4.0
    colors = rng.uniform(0, 1, (N_GAUSS, 3)).astype(np.float32)
    d, _ = cKDTree(pts).query(pts, k=4)
    dist2 = np.maximum((d[:, 1:] ** 2).mean(axis=1), 1e-7)
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
    written = make_ply(ply_path, rng)
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

    print(json.dumps({"kernels": [{
        "name": "composite_fwd", "route": "cuda",
        "source": "gsplat_tpu_torch/ops/kernels/csrc/composite_fwd.cu",
        "replaces": "gsplat_tpu/ops/pallas/composite_stream.py:82",
        "launches": launches, "max_abs_err": err, "ms": kern_ms,
        "plain_ms": plain_ms, "bound_ms": max(bytes_ms, ops_ms),
        "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
        "library_ms": None}]}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
