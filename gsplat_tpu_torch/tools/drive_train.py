"""End-to-end training drive on a synthetic scene (no dataset needed).
Counterpart of tools/drive_train.py.

Builds a ground-truth scene from a random Gaussian model, renders the
ground truth from a ring of 12 cameras, then trains a fresh model (with
densification) to fit it. Every 4th camera is held out of training
(llffhold-style): the test PSNR is novel-view generalization, not
self-fit. Both train and test PSNR must climb by more than 3 dB. It runs
the whole step: render forward and backward, SSIM, Adam, densify (clone,
split, prune).

    python -m gsplat_tpu_torch.tools.drive_train [iters] [--device cpu]

On the card: 512x256, 3000 ground-truth gaussians, 400 to start from, 300
iterations by default. With ``--device cpu`` (the plain compositor and
SSIM): 128x64, 400 / 80, 30 iterations.
"""
from __future__ import annotations

import argparse
import math
import time

import numpy as np

# (width, height), (ground-truth gaussians, initial gaussians), iterations
SIZES = {"cuda": ((512, 256), (3000, 400), 300),
         "cpu": ((128, 64), (400, 80), 30)}
N_CAMS = 12
HOLDOUT = 4                 # every 4th camera is held out


def ring_camera(angle, radius=8.0, fovx=0.9, fovy=0.7, *, device="cuda"):
    """A camera on a ring in the xz plane looking at the origin."""
    from gsplat_tpu_torch.core.camera import CameraView

    c, s = math.cos(angle), math.sin(angle)
    pos = np.array([radius * s, 0.0, -radius * c])
    fwd = -pos / np.linalg.norm(pos)
    up = np.array([0.0, 1.0, 0.0])
    right = np.cross(up, fwd)
    right /= np.linalg.norm(right)
    upv = np.cross(fwd, right)
    Rcw = np.stack([right, upv, fwd], axis=1)  # cam->world (columns)
    t = -Rcw.T @ pos
    return CameraView.create(R=Rcw, T=t, fovx=fovx, fovy=fovy, device=device)


def ring_cameras(device):
    return [ring_camera(a, device=device)
            for a in np.linspace(0, 2 * math.pi, N_CAMS, endpoint=False)]


def ground_truth(rng, n_gt, device):
    """(points, colors, ground-truth gaussians): ``n_gt`` points N(0, 1) at
    opacity logit 1.5, SH degree 0."""
    from gsplat_tpu_torch.models import gaussian_model as gm

    pts = rng.standard_normal((n_gt, 3)).astype(np.float32)
    colors = rng.uniform(0.1, 0.9, (n_gt, 3)).astype(np.float32)
    g_gt = gm.create_from_pcd(pts, colors, 0, capacity=n_gt, device=device)
    g_gt.opacity.fill_(1.5)
    return pts, colors, g_gt


def initial_model(rng, pts, colors, n_init, device):
    """A noisy subsample of the ground truth's points, SH degree 1, at
    capacity 4 x ``n_init``."""
    from gsplat_tpu_torch.models import gaussian_model as gm

    sel = rng.choice(len(pts), n_init, replace=False)
    init_pts = pts[sel] + 0.05 * rng.standard_normal(
        (n_init, 3)).astype(np.float32)
    return gm.create_from_pcd(init_pts, colors[sel], 1,
                              capacity=4 * n_init, device=device)


def drive_opt(iters):
    from gsplat_tpu_torch.config import OptimizationConfig

    return OptimizationConfig(
        iterations=iters, densify_from_iter=20, densification_interval=50,
        opacity_reset_interval=10 * iters, position_lr_max_steps=iters)


def run(device, iters, *, width, height, n_gt, n_init, log=print):
    """The drive: returns the ground truth, the PSNRs before and after on
    both splits, every iteration's loss, the final state, the loop's it/s
    and live count. ``trainer.train_step`` and ``trainer.densify_step``
    are looked up at call time."""
    import torch

    from gsplat_tpu_torch.config import RasterizerConfig
    from gsplat_tpu_torch.ops import losses
    from gsplat_tpu_torch.ops.rasterize import render
    from gsplat_tpu_torch.train import trainer

    W, H = width, height
    sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: 0)
    rng = np.random.default_rng(0)
    pts, colors, g_gt = ground_truth(rng, n_gt, device)
    rcfg = RasterizerConfig(pairs_per_gaussian=96.0)
    bg = torch.zeros(3, device=device)
    cams = ring_cameras(device)
    t_wall = time.perf_counter()

    def mark(what):
        log(f"[{time.perf_counter() - t_wall:6.0f}s] {what}")

    with torch.no_grad():
        gts = [torch.clamp(render(g_gt, c, W, H, bg, rcfg).image, 0, 1)
               for c in cams]
    mark("GT done")
    test_ids = list(range(0, N_CAMS, HOLDOUT))
    train_ids = [i for i in range(N_CAMS) if i not in test_ids]

    g0 = initial_model(rng, pts, colors, n_init, device)
    opt = drive_opt(iters)
    state = trainer.init_state(g0, N_CAMS)
    ones = torch.ones((1, H, W), device=device)
    zeros = torch.zeros((1, H, W), device=device)

    def psnr_now(state, ids):
        vals = []
        with torch.no_grad():
            for i in ids:
                img = render(state.gaussians, cams[i], W, H, bg, rcfg).image
                vals.append(float(losses.psnr(img[None], gts[i][None])
                                  .mean()))
        return float(np.mean(vals))

    p0_train, p0_test = psnr_now(state, train_ids), psnr_now(state, test_ids)
    mark("initial PSNR done; entering the train loop")
    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    loss_t, overflow = [], []
    sync()
    t0 = time.perf_counter()
    for it in range(1, iters + 1):
        i = train_ids[rng.integers(0, len(train_ids))]
        state, aux = trainer.train_step(
            state, cams[i], gts[i], ones, zeros, zeros, bg,
            image_width=W, image_height=H, opt=opt, rcfg=rcfg,
            spatial_lr_scale=2.0, antialiasing=False, use_sparse_adam=False,
            train_test_exp=False, use_depth=False)
        loss_t.append(aux.loss)
        overflow.append(aux.overflow)
        if it > opt.densify_from_iter and it % opt.densification_interval == 0:
            state, _ = trainer.densify_step(
                state, gen, 2.0, opt=opt, use_screen_size_prune=False)
        if it % 50 == 0:
            log(f"iter {it}: loss={float(aux.loss):.4f} "
                f"n={state.gaussians.num_active()} "
                f"({time.perf_counter() - t0:.0f}s)")
    sync()
    dt = time.perf_counter() - t0
    p1_train, p1_test = psnr_now(state, train_ids), psnr_now(state, test_ids)
    return dict(gts=gts, p0_train=p0_train, p0_test=p0_test,
                p1_train=p1_train, p1_test=p1_test,
                losses=[float(x) for x in loss_t],
                overflow=max((int(x) for x in overflow), default=0),
                state=state, it_s=iters / dt, n=state.gaussians.num_active())


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("iters", nargs="?", type=int, default=None)
    p.add_argument("--device", default="cuda", choices=["cpu", "cuda"])
    args = p.parse_args(argv)

    from gsplat_tpu_torch.utils.general import resolve_device

    device = resolve_device(args.device)
    (W, H), (n_gt, n_init), default_iters = SIZES[device.type]
    iters = args.iters if args.iters is not None else default_iters
    r = run(device, iters, width=W, height=H, n_gt=n_gt, n_init=n_init,
            log=lambda s: print(s, flush=True))
    print(f"train PSNR {r['p0_train']:.2f} -> {r['p1_train']:.2f} dB, "
          f"HELD-OUT test PSNR {r['p0_test']:.2f} -> {r['p1_test']:.2f} dB "
          f"over {iters} iters ({r['it_s']:.2f} it/s on {device.type}, "
          f"n={r['n']}, max overflow {r['overflow']})", flush=True)
    assert r["p1_train"] > r["p0_train"] + 3.0, \
        "train PSNR did not improve by >3dB"
    assert r["p1_test"] > r["p0_test"] + 3.0, \
        "held-out PSNR did not improve by >3dB"
    print("OK")
    return r


if __name__ == "__main__":
    main()
