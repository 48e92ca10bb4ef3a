"""Metrics CLI: SSIM, PSNR and LPIPS per test view of each model directory,
written to ``results.json`` and ``per_view.json`` in the schema of
gsplat_tpu/cli/metrics.py. Same flags plus ``--device`` (default ``cuda``).

Failures are narrower than JAX's: a missing LPIPS weights file gives NaN
(``FileNotFoundError`` only), a scene whose ``test/`` directory or images
cannot be read (``OSError``) is reported and skipped, and anything else,
a kernel's or cuDNN's error among them, raises.
"""
from __future__ import annotations

import json
import os
import sys
from argparse import ArgumentParser
from pathlib import Path

import numpy as np
import torch


def _read_images(renders_dir, gt_dir):
    """Stream (name, render, gt) image pairs from disk as (3,H,W) float32
    arrays in [0,1], one pair at a time."""
    from PIL import Image
    names = sorted(os.listdir(renders_dir))
    for fname in names:
        r = np.asarray(Image.open(os.path.join(renders_dir, fname)),
                       dtype=np.float32)[..., :3] / 255.0
        g = np.asarray(Image.open(os.path.join(gt_dir, fname)),
                       dtype=np.float32)[..., :3] / 255.0
        yield fname, r.transpose(2, 0, 1), g.transpose(2, 0, 1)


@torch.no_grad()
def evaluate(model_paths, use_lpips=True, *, device="cuda"):
    """Score every method under ``<scene>/test`` of each model path on
    ``device``."""
    from gsplat_tpu_torch.ops.losses import psnr, ssim
    from gsplat_tpu_torch.utils.general import resolve_device

    dev = resolve_device(device)
    lpips_fn = None
    if use_lpips:
        from gsplat_tpu_torch.ops.lpips import lpips_vgg
        try:
            lpips_fn = lpips_vgg(device=dev)
        except FileNotFoundError as e:   # no weights file here
            print(f"LPIPS unavailable ({e}); reporting NaN")

    for scene_dir in model_paths:
        try:
            print("Scene:", scene_dir)
            full_dict = {}
            per_view_dict = {}
            test_dir = Path(scene_dir) / "test"
            for method in sorted(os.listdir(test_dir)):
                print("Method:", method)
                full_dict[method] = {}
                per_view_dict[method] = {}
                method_dir = test_dir / method
                ssims, psnrs, lpipss, names = [], [], [], []
                for fname, render, gt in _read_images(method_dir / "renders",
                                                      method_dir / "gt"):
                    r = torch.tensor(render, device=dev)[None]
                    g = torch.tensor(gt, device=dev)[None]
                    ssims.append(float(ssim(r, g)))
                    psnrs.append(float(psnr(r, g).mean()))
                    lpipss.append(float(lpips_fn(r, g)) if lpips_fn
                                  else float("nan"))
                    names.append(fname)
                print(f"  SSIM : {np.mean(ssims):>12.7f}")
                print(f"  PSNR : {np.mean(psnrs):>12.7f}")
                print(f"  LPIPS: {np.mean(lpipss):>12.7f}")
                full_dict[method].update({
                    "SSIM": float(np.mean(ssims)),
                    "PSNR": float(np.mean(psnrs)),
                    "LPIPS": float(np.mean(lpipss))})
                per_view_dict[method].update({
                    "SSIM": dict(zip(names, map(float, ssims))),
                    "PSNR": dict(zip(names, map(float, psnrs))),
                    "LPIPS": dict(zip(names, map(float, lpipss)))})
            with open(os.path.join(scene_dir, "results.json"), "w") as f:
                json.dump(full_dict, f, indent=True)
            with open(os.path.join(scene_dir, "per_view.json"), "w") as f:
                json.dump(per_view_dict, f, indent=True)
        except OSError as e:    # no test/ directory, an unreadable image
            print(f"Unable to compute metrics for model {scene_dir}: {e}")


def main(argv=None):
    parser = ArgumentParser(description="Training script parameters")
    parser.add_argument("--model_paths", "-m", required=True, nargs="+",
                        type=str, default=[])
    parser.add_argument("--no_lpips", action="store_true")
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv if argv is not None else sys.argv[1:])
    evaluate(args.model_paths, use_lpips=not args.no_lpips,
             device=args.device)


if __name__ == "__main__":
    main()
