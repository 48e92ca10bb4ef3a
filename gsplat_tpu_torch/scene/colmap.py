"""COLMAP model readers (binary + text), pure numpy (own copy of the
readers in gsplat_tpu/scene/colmap.py that the dataset readers use)."""
from __future__ import annotations

import os
import struct
from dataclasses import dataclass
from typing import Dict

import numpy as np

# COLMAP camera model ids → (name, num_params)
CAMERA_MODELS = {
    0: ("SIMPLE_PINHOLE", 3),
    1: ("PINHOLE", 4),
    2: ("SIMPLE_RADIAL", 4),
    3: ("RADIAL", 5),
    4: ("OPENCV", 8),
    5: ("OPENCV_FISHEYE", 8),
    6: ("FULL_OPENCV", 12),
    7: ("FOV", 5),
    8: ("SIMPLE_RADIAL_FISHEYE", 4),
    9: ("RADIAL_FISHEYE", 5),
    10: ("THIN_PRISM_FISHEYE", 12),
}


@dataclass
class ColmapCamera:
    id: int
    model: str
    width: int
    height: int
    params: np.ndarray


@dataclass
class ColmapImage:
    id: int
    qvec: np.ndarray          # (4,) w x y z
    tvec: np.ndarray          # (3,)
    camera_id: int
    name: str


def qvec2rotmat(qvec: np.ndarray) -> np.ndarray:
    """Quaternion (w,x,y,z) → rotation matrix (COLMAP convention)."""
    w, x, y, z = qvec
    return np.array([
        [1 - 2 * y * y - 2 * z * z, 2 * x * y - 2 * w * z, 2 * x * z + 2 * w * y],
        [2 * x * y + 2 * w * z, 1 - 2 * x * x - 2 * z * z, 2 * y * z - 2 * w * x],
        [2 * x * z - 2 * w * y, 2 * y * z + 2 * w * x, 1 - 2 * x * x - 2 * y * y]])


def _read(f, n, fmt):
    return struct.unpack("<" + fmt, f.read(n))


def read_cameras_binary(path: str) -> Dict[int, ColmapCamera]:
    cams = {}
    with open(path, "rb") as f:
        (n,) = _read(f, 8, "Q")
        for _ in range(n):
            cid, model_id, w, h = _read(f, 24, "iiQQ")
            name, n_params = CAMERA_MODELS[model_id]
            params = np.array(_read(f, 8 * n_params, "d" * n_params))
            cams[cid] = ColmapCamera(cid, name, w, h, params)
    return cams


def read_cameras_text(path: str) -> Dict[int, ColmapCamera]:
    cams = {}
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            parts = line.split()
            cid, model = int(parts[0]), parts[1]
            w, h = int(parts[2]), int(parts[3])
            params = np.array([float(p) for p in parts[4:]])
            cams[cid] = ColmapCamera(cid, model, w, h, params)
    return cams


def read_images_binary(path: str) -> Dict[int, ColmapImage]:
    images = {}
    with open(path, "rb") as f:
        (n,) = _read(f, 8, "Q")
        for _ in range(n):
            iid = _read(f, 4, "i")[0]
            qvec = np.array(_read(f, 32, "dddd"))
            tvec = np.array(_read(f, 24, "ddd"))
            (camera_id,) = _read(f, 4, "i")
            name = b""
            c = f.read(1)
            while c != b"\x00":
                name += c
                c = f.read(1)
            (n_pts,) = _read(f, 8, "Q")
            f.seek(24 * n_pts, os.SEEK_CUR)      # 2D points: not used
            images[iid] = ColmapImage(iid, qvec, tvec, camera_id,
                                      name.decode("utf-8"))
    return images


def read_images_text(path: str) -> Dict[int, ColmapImage]:
    images = {}
    with open(path) as f:
        lines = [ln.strip() for ln in f if not ln.startswith("#")]
    # two lines per image: the pose line, then its 2D points (possibly an
    # empty line), which the renderer does not use
    for i in range(0, len(lines), 2):
        parts = lines[i].split()
        if not parts:
            continue
        iid = int(parts[0])
        images[iid] = ColmapImage(
            iid, np.array([float(x) for x in parts[1:5]]),
            np.array([float(x) for x in parts[5:8]]), int(parts[8]), parts[9])
    return images


def read_points3d_binary(path: str):
    """Returns (xyz (N,3) f64, rgb (N,3) u8, errors (N,))."""
    with open(path, "rb") as f:
        (n,) = _read(f, 8, "Q")
        xyz = np.empty((n, 3))
        rgb = np.empty((n, 3), np.uint8)
        err = np.empty(n)
        for i in range(n):
            _pid, x, y, z, r, g, b, e = _read(f, 43, "qdddBBBd")
            xyz[i] = (x, y, z)
            rgb[i] = (r, g, b)
            err[i] = e
            (track_len,) = _read(f, 8, "Q")
            f.seek(8 * track_len, os.SEEK_CUR)
    return xyz, rgb, err


def read_points3d_text(path: str):
    xyz, rgb, err = [], [], []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            p = line.split()
            xyz.append([float(p[1]), float(p[2]), float(p[3])])
            rgb.append([int(p[4]), int(p[5]), int(p[6])])
            err.append(float(p[7]))
    return (np.array(xyz), np.array(rgb, np.uint8), np.array(err))


def read_model(sparse_dir: str):
    """Binary-first with text fallback → (cameras, images,
    (xyz, rgb, err) or None)."""
    def pick(name):
        b = os.path.join(sparse_dir, name + ".bin")
        t = os.path.join(sparse_dir, name + ".txt")
        return (b, True) if os.path.exists(b) else (t, False)

    cam_path, cam_bin = pick("cameras")
    img_path, img_bin = pick("images")
    pts_path, pts_bin = pick("points3D")
    cameras = (read_cameras_binary(cam_path) if cam_bin
               else read_cameras_text(cam_path))
    images = (read_images_binary(img_path) if img_bin
              else read_images_text(img_path))
    points = None
    if os.path.exists(pts_path):
        points = (read_points3d_binary(pts_path) if pts_bin
                  else read_points3d_text(pts_path))
    return cameras, images, points
