"""Generate a synthetic COLMAP-layout dataset from a known Gaussian scene,
so the train -> render -> metrics chain runs end to end without a real
dataset. Counterpart of tools/make_synthetic_scene.py: the same flags, the
same numpy draws in the same order from ``--seed``, so the ``sparse/0``
files equal that tool's byte for byte.

Layout produced (what the scene readers expect):
    <out>/<scene>/images/IMG_####.png      renders of the known scene
    <out>/<scene>/sparse/0/cameras.bin     one PINHOLE camera
    <out>/<scene>/sparse/0/images.bin      orbit extrinsics
    <out>/<scene>/sparse/0/points3D.bin    noisy subsample of the means

The ground truth is rendered through the reader's own convention: the
extrinsics are written first, re-derived as the reader does (R =
qvec2rotmat(q).T, T = tvec), and those (R, T) drive the renderer, so the
generator and the trainer agree by construction.

Usage:
  python -m gsplat_tpu_torch.tools.make_synthetic_scene --out <dir> \
      --scene truck --n_gaussians 3000 --n_cams 12 --width 160 --height 120
  (``--device cpu`` renders through the plain compositor)
"""
from __future__ import annotations

import argparse
import math
import os

import numpy as np


def look_at_wc(cam_pos: np.ndarray, target: np.ndarray,
               up: np.ndarray) -> np.ndarray:
    """World->camera rotation, COLMAP convention (x right, y down, z fwd)."""
    fwd = target - cam_pos
    fwd = fwd / np.linalg.norm(fwd)
    right = np.cross(fwd, up)
    right = right / np.linalg.norm(right)
    down = np.cross(fwd, right)
    return np.stack([right, down, fwd], axis=0)


def make_gaussians(n: int, rng, extent: float = 2.0, *, device="cuda"):
    """A colorful blob cloud with an opaque backdrop shell, so views have
    full coverage. Returns (gaussians on ``device``, points, colors)."""
    import torch

    from gsplat_tpu_torch.models import gaussian_model as gm

    n_shell = max(n // 4, 1)
    n_core = n - n_shell
    core = rng.standard_normal((n_core, 3)).astype(np.float32) * extent * 0.45
    u = rng.standard_normal((n_shell, 3)).astype(np.float32)
    u /= np.linalg.norm(u, axis=1, keepdims=True) + 1e-9
    shell = u * extent * 2.2
    pts = np.concatenate([core, shell], axis=0)
    col = rng.uniform(0.05, 0.95, (n, 3)).astype(np.float32)
    # a smooth color field for the core, so neighboring splats correlate
    col[:n_core] = 0.5 + 0.45 * np.stack([
        np.sin(core[:, 0] * 2.1), np.sin(core[:, 1] * 2.3),
        np.sin(core[:, 2] * 1.7)], axis=1).astype(np.float32)
    g = gm.create_from_pcd(pts, np.clip(col, 0, 1), max_sh_degree=3,
                           capacity=n, device=device)
    # moderate, view-coverable splats; high opacity
    scale = np.full((n, 3), math.log(extent * 0.035), np.float32)
    scale[n_core:] = math.log(extent * 0.30)
    g.scaling.copy_(torch.from_numpy(scale))
    g.opacity.fill_(3.0)
    return g, pts, np.clip(col, 0, 1)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--out", required=True)
    p.add_argument("--scene", default="truck")
    p.add_argument("--n_gaussians", type=int, default=3000)
    p.add_argument("--n_cams", type=int, default=12)
    p.add_argument("--width", type=int, default=160)
    p.add_argument("--height", type=int, default=120)
    p.add_argument("--n_points", type=int, default=0,
                   help="init cloud size (0: one per gaussian)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda", choices=["cpu", "cuda"])
    args = p.parse_args(argv)

    import torch
    from PIL import Image

    from gsplat_tpu_torch.config import RasterizerConfig
    from gsplat_tpu_torch.core.camera import CameraView
    from gsplat_tpu_torch.ops.rasterize import render
    from gsplat_tpu_torch.scene import colmap as colmap_lib
    from gsplat_tpu_torch.utils.general import resolve_device

    dev = resolve_device(args.device)
    rng = np.random.default_rng(args.seed)
    W, H = args.width, args.height
    extent = 2.0
    g, pts, col = make_gaussians(args.n_gaussians, rng, extent, device=dev)

    fovx = math.radians(60.0)
    focal = W / (2.0 * math.tan(fovx / 2.0))
    fovy = 2.0 * math.atan(H / (2.0 * focal))

    scene_dir = os.path.join(args.out, args.scene)
    img_dir = os.path.join(scene_dir, "images")
    os.makedirs(img_dir, exist_ok=True)

    cams = {1: colmap_lib.ColmapCamera(
        id=1, model="PINHOLE", width=W, height=H,
        params=np.array([focal, focal, W / 2.0, H / 2.0]))}

    images = {}
    radius = extent * 3.2
    rcfg = RasterizerConfig(pairs_per_gaussian=64.0)
    bg = torch.zeros(3, device=dev)
    for i in range(args.n_cams):
        theta = 2.0 * math.pi * i / args.n_cams
        phi = 0.35 + 0.25 * math.sin(3.0 * theta)   # vary the elevation
        cam_pos = radius * np.array([
            math.cos(theta) * math.cos(phi),
            math.sin(phi),
            math.sin(theta) * math.cos(phi)], dtype=np.float64)
        R_wc = look_at_wc(cam_pos, np.zeros(3), np.array([0.0, 1.0, 0.0]))
        qvec = colmap_lib.rotmat2qvec(R_wc)
        tvec = -R_wc @ cam_pos
        name = f"IMG_{i:04d}.png"
        images[i + 1] = colmap_lib.ColmapImage(
            id=i + 1, qvec=qvec, tvec=tvec, camera_id=1, name=name,
            xys=np.zeros((0, 2)), point3D_ids=np.zeros((0,), np.int64))

        # the ground truth through the reader's own convention
        R_reader = colmap_lib.qvec2rotmat(qvec).T
        view = CameraView.create(R=R_reader, T=np.asarray(tvec), fovx=fovx,
                                 fovy=fovy, device=dev)
        with torch.no_grad():
            out = render(g, view, W, H, bg, rcfg)
        assert int(out.overflow) == 0, "generator pair capacity too small"
        img = out.image.cpu().numpy()
        arr = (np.clip(img, 0, 1).transpose(1, 2, 0) * 255).round()
        Image.fromarray(arr.astype(np.uint8)).save(
            os.path.join(img_dir, name))

    n_pts = args.n_points or args.n_gaussians
    sel = rng.permutation(len(pts))[:n_pts]
    noisy = pts[sel] + rng.standard_normal((n_pts, 3)).astype(np.float32) \
        * extent * 0.01
    ids = np.arange(1, n_pts + 1)
    rgb = (col[sel] * 255).round().astype(np.uint8)
    err = np.full((n_pts,), 0.5)
    colmap_lib.write_model(cams, images, (ids, noisy, rgb, err),
                           os.path.join(scene_dir, "sparse", "0"))
    print(f"wrote {args.n_cams} views + {n_pts} init points to {scene_dir}")


if __name__ == "__main__":
    main()
