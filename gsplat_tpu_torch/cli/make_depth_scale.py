"""Depth-scale CLI: a robust per-image scale and offset that align a
monocular inverse-depth map to the COLMAP model's sparse inverse depths,
written to ``sparse/0/depth_params.json``, which the scene readers consume
(scene/dataset_readers.py) to scale 16-bit inverse depths. Counterpart of
tools/make_depth_scale.py, on the port's own COLMAP readers.

For each image the 3D points of its track are projected to view space,
the inverse-depth PNG is sampled at the 2D keypoints (bilinear,
border-replicate), and the medians and mean absolute deviations of the two
give the scale and offset. Host numpy throughout; cv2 reads the PNG where
it is installed, PIL otherwise.

Usage: python make_depth_scale_torch.py --base_dir <scene> --depths_dir <dir>
"""
from __future__ import annotations

import argparse
import json
import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from gsplat_tpu_torch.scene import colmap


def _load_invdepth_png(path: str):
    """16-bit (or 8-bit) inverse-depth PNG -> float32 in [0,1), or None."""
    if not os.path.exists(path):
        return None
    try:
        import cv2
    except ImportError:
        from PIL import Image
        with Image.open(path) as im:
            arr = np.array(im).astype(np.float32)
    else:
        m = cv2.imread(path, cv2.IMREAD_UNCHANGED)
        if m is None:
            return None
        arr = m.astype(np.float32)
    if arr.ndim != 2:
        arr = arr[..., 0]
    return arr / float(2 ** 16)


def _bilinear_sample(img: np.ndarray, xy: np.ndarray) -> np.ndarray:
    """Sample img (H,W) at xy (N,2) float pixel coordinates, the border
    replicated (cv2.remap's INTER_LINEAR + BORDER_REPLICATE)."""
    H, W = img.shape
    x = np.clip(xy[:, 0], 0, W - 1)
    y = np.clip(xy[:, 1], 0, H - 1)
    x0 = np.floor(x).astype(np.int64)
    y0 = np.floor(y).astype(np.int64)
    x1 = np.minimum(x0 + 1, W - 1)
    y1 = np.minimum(y0 + 1, H - 1)
    fx = x - x0
    fy = y - y0
    return (img[y0, x0] * (1 - fx) * (1 - fy) + img[y0, x1] * fx * (1 - fy)
            + img[y1, x0] * (1 - fx) * fy + img[y1, x1] * fx * fy)


def get_scale(image_meta: colmap.ColmapImage, cam: colmap.ColmapCamera,
              points3d_ordered: np.ndarray, depths_dir: str):
    """One image's {image_name, scale, offset}, or None without its map."""
    pts_idx = image_meta.point3D_ids
    mask = (pts_idx >= 0) & (pts_idx < len(points3d_ordered))
    pts_idx = pts_idx[mask]
    valid_xys = image_meta.xys[mask]
    pts = points3d_ordered[pts_idx] if len(pts_idx) else np.zeros((1, 3))

    R = colmap.qvec2rotmat(image_meta.qvec)
    cam_pts = pts @ R.T + image_meta.tvec
    invcolmapdepth = 1.0 / cam_pts[..., 2]

    stem = os.path.splitext(image_meta.name)[0]
    invmono = _load_invdepth_png(os.path.join(depths_dir, stem + ".png"))
    if invmono is None:
        return None

    s = invmono.shape[0] / cam.height
    maps = (valid_xys * s).astype(np.float32)
    valid = ((maps[..., 0] >= 0) & (maps[..., 1] >= 0)
             & (maps[..., 0] < cam.width * s)
             & (maps[..., 1] < cam.height * s) & (invcolmapdepth > 0))

    scale, offset = 0.0, 0.0
    if valid.sum() > 10 and (invcolmapdepth.max()
                             - invcolmapdepth.min()) > 1e-3:
        icd = invcolmapdepth[valid]
        imd = _bilinear_sample(invmono, maps[valid])
        t_colmap = np.median(icd)
        s_colmap = np.mean(np.abs(icd - t_colmap))
        t_mono = np.median(imd)
        s_mono = np.mean(np.abs(imd - t_mono))
        if s_mono > 0:
            scale = float(s_colmap / s_mono)
            offset = float(t_colmap - t_mono * scale)
    return {"image_name": stem, "scale": scale, "offset": offset}


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--base_dir", required=True)
    parser.add_argument("--depths_dir", required=True)
    parser.add_argument("--model_type", default="bin", choices=["bin", "txt"])
    args = parser.parse_args(argv)

    sparse = os.path.join(args.base_dir, "sparse", "0")
    cameras, images, _ = colmap.read_model(sparse)
    ids, xyz, _, _ = colmap.read_points3d_full(
        os.path.join(sparse, "points3D.bin"),
        os.path.join(sparse, "points3D.txt"))
    points3d_ordered = np.zeros((ids.max() + 1 if len(ids) else 1, 3))
    points3d_ordered[ids] = xyz

    with ThreadPoolExecutor() as pool:
        results = list(pool.map(
            lambda im: get_scale(im, cameras[im.camera_id], points3d_ordered,
                                 args.depths_dir), images.values()))

    depth_params = {r["image_name"]: {"scale": r["scale"],
                                      "offset": r["offset"]}
                    for r in results if r is not None}
    out = os.path.join(sparse, "depth_params.json")
    with open(out, "w") as f:
        json.dump(depth_params, f, indent=2)
    print(f"Wrote {out} ({len(depth_params)} images)")


if __name__ == "__main__":
    main()
