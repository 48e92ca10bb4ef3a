"""COLMAP model readers and writers (binary + text), pure numpy (own copy
of gsplat_tpu/scene/colmap.py): cameras, images with their 2D points, and
points3D in the documented COLMAP struct layout, plus quaternion <->
rotation helpers. Either package reads the models the other writes."""
from __future__ import annotations

import os
import struct
from dataclasses import dataclass, field
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
CAMERA_MODEL_IDS = {name: mid for mid, (name, _) in CAMERA_MODELS.items()}


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
    xys: np.ndarray = field(default_factory=lambda: np.zeros((0, 2)))
    point3D_ids: np.ndarray = field(
        default_factory=lambda: np.zeros((0,), np.int64))


def qvec2rotmat(qvec: np.ndarray) -> np.ndarray:
    """Quaternion (w,x,y,z) → rotation matrix (COLMAP convention)."""
    w, x, y, z = qvec
    return np.array([
        [1 - 2 * y * y - 2 * z * z, 2 * x * y - 2 * w * z, 2 * x * z + 2 * w * y],
        [2 * x * y + 2 * w * z, 1 - 2 * x * x - 2 * z * z, 2 * y * z - 2 * w * x],
        [2 * x * z - 2 * w * y, 2 * y * z + 2 * w * x, 1 - 2 * x * x - 2 * y * y]])


def rotmat2qvec(R: np.ndarray) -> np.ndarray:
    """Rotation matrix → quaternion (w,x,y,z), w >= 0: the eigenvector of
    the largest eigenvalue of the symmetric 4x4 matrix K of R."""
    Rxx, Ryx, Rzx, Rxy, Ryy, Rzy, Rxz, Ryz, Rzz = R.flat
    K = np.array([
        [Rxx - Ryy - Rzz, 0, 0, 0],
        [Ryx + Rxy, Ryy - Rxx - Rzz, 0, 0],
        [Rzx + Rxz, Rzy + Ryz, Rzz - Rxx - Ryy, 0],
        [Ryz - Rzy, Rzx - Rxz, Rxy - Ryx, Rxx + Ryy + Rzz]]) / 3.0
    eigvals, eigvecs = np.linalg.eigh(K)
    qvec = eigvecs[[3, 0, 1, 2], np.argmax(eigvals)]
    if qvec[0] < 0:
        qvec *= -1
    return qvec


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
            data = np.frombuffer(f.read(24 * n_pts),
                                 dtype=np.dtype("<f8, <f8, <i8"))
            xys = np.stack([data["f0"], data["f1"]], -1).reshape(-1, 2)
            images[iid] = ColmapImage(iid, qvec, tvec, camera_id,
                                      name.decode("utf-8"), xys,
                                      data["f2"].astype(np.int64))
    return images


def read_images_text(path: str) -> Dict[int, ColmapImage]:
    images = {}
    with open(path) as f:
        lines = [ln.strip() for ln in f if not ln.startswith("#")]
    # two lines per image: the pose line, then its 2D points as (X, Y,
    # POINT3D_ID) triples, an empty line where it has none
    for i in range(0, len(lines), 2):
        parts = lines[i].split()
        if not parts:
            continue
        iid = int(parts[0])
        pts = lines[i + 1].split() if i + 1 < len(lines) else []
        xys = np.array([[float(pts[j]), float(pts[j + 1])]
                        for j in range(0, len(pts), 3)]).reshape(-1, 2)
        pids = np.array([int(pts[j + 2]) for j in range(0, len(pts), 3)],
                        np.int64)
        images[iid] = ColmapImage(
            iid, np.array([float(x) for x in parts[1:5]]),
            np.array([float(x) for x in parts[5:8]]), int(parts[8]), parts[9],
            xys, pids)
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


def read_points3d_full(path_bin: str = "", path_txt: str = ""):
    """Every points3D record with its id, from the binary file where it
    exists, else the text file. Returns (ids (N,) i64, xyz (N,3) f64, rgb
    (N,3) u8, err (N,) f64)."""
    if path_bin and os.path.exists(path_bin):
        with open(path_bin, "rb") as f:
            (n,) = _read(f, 8, "Q")
            ids = np.empty(n, np.int64)
            xyz = np.empty((n, 3))
            rgb = np.empty((n, 3), np.uint8)
            err = np.empty(n)
            for i in range(n):
                pid, x, y, z, r, g, b, e = _read(f, 43, "qdddBBBd")
                ids[i] = pid
                xyz[i] = (x, y, z)
                rgb[i] = (r, g, b)
                err[i] = e
                (track_len,) = _read(f, 8, "Q")
                f.seek(8 * track_len, os.SEEK_CUR)
        return ids, xyz, rgb, err
    ids, xyz, rgb, err = [], [], [], []
    with open(path_txt) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            p = line.split()
            ids.append(int(p[0]))
            xyz.append([float(p[1]), float(p[2]), float(p[3])])
            rgb.append([int(p[4]), int(p[5]), int(p[6])])
            err.append(float(p[7]))
    return (np.array(ids, np.int64), np.array(xyz).reshape(-1, 3),
            np.array(rgb, np.uint8).reshape(-1, 3), np.array(err))


# ------------------------------------------------------------------ writers

def write_cameras_binary(cams: Dict[int, ColmapCamera], path: str) -> None:
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(cams)))
        for cam in cams.values():
            mid = CAMERA_MODEL_IDS[cam.model]
            f.write(struct.pack("<iiQQ", cam.id, mid, cam.width, cam.height))
            f.write(struct.pack("<" + "d" * len(cam.params), *cam.params))


def write_cameras_text(cams: Dict[int, ColmapCamera], path: str) -> None:
    with open(path, "w") as f:
        f.write("# Camera list with one line of data per camera:\n"
                "#   CAMERA_ID, MODEL, WIDTH, HEIGHT, PARAMS[]\n"
                f"# Number of cameras: {len(cams)}\n")
        for cam in cams.values():
            params = " ".join(repr(float(p)) for p in cam.params)
            f.write(f"{cam.id} {cam.model} {cam.width} {cam.height} "
                    f"{params}\n")


def write_images_binary(images: Dict[int, ColmapImage], path: str) -> None:
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(images)))
        for im in images.values():
            f.write(struct.pack("<i", im.id))
            f.write(struct.pack("<dddd", *im.qvec))
            f.write(struct.pack("<ddd", *im.tvec))
            f.write(struct.pack("<i", im.camera_id))
            f.write(im.name.encode("utf-8") + b"\x00")
            f.write(struct.pack("<Q", len(im.point3D_ids)))
            for (x, y), pid in zip(im.xys, im.point3D_ids):
                f.write(struct.pack("<ddq", x, y, pid))


def write_images_text(images: Dict[int, ColmapImage], path: str) -> None:
    with open(path, "w") as f:
        f.write("# Image list with two lines of data per image:\n"
                "#   IMAGE_ID, QW, QX, QY, QZ, TX, TY, TZ, CAMERA_ID, NAME\n"
                "#   POINTS2D[] as (X, Y, POINT3D_ID)\n"
                f"# Number of images: {len(images)}\n")
        for im in images.values():
            q = " ".join(repr(float(v)) for v in im.qvec)
            t = " ".join(repr(float(v)) for v in im.tvec)
            f.write(f"{im.id} {q} {t} {im.camera_id} {im.name}\n")
            f.write(" ".join(f"{float(x)!r} {float(y)!r} {int(pid)}"
                             for (x, y), pid in zip(im.xys, im.point3D_ids))
                    + "\n")


def write_points3d_binary(ids, xyz, rgb, err, path: str) -> None:
    """Points with empty tracks (the readers keep no track)."""
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(ids)))
        for pid, p, c, e in zip(ids, xyz, rgb, err):
            f.write(struct.pack("<qdddBBBd", int(pid), *map(float, p),
                                *map(int, c), float(e)))
            f.write(struct.pack("<Q", 0))


def write_points3d_text(ids, xyz, rgb, err, path: str) -> None:
    with open(path, "w") as f:
        f.write("# 3D point list with one line of data per point:\n"
                "#   POINT3D_ID, X, Y, Z, R, G, B, ERROR, "
                "TRACK[] as (IMAGE_ID, POINT2D_IDX)\n"
                f"# Number of points: {len(ids)}\n")
        for pid, p, c, e in zip(ids, xyz, rgb, err):
            f.write(f"{int(pid)} {float(p[0])!r} {float(p[1])!r} "
                    f"{float(p[2])!r} {int(c[0])} {int(c[1])} {int(c[2])} "
                    f"{float(e)!r}\n")


def write_model(cameras, images, points, sparse_dir: str,
                binary: bool = True) -> None:
    """cameras.*, images.* and points3D.* under sparse_dir; points = (ids,
    xyz, rgb, err)."""
    os.makedirs(sparse_dir, exist_ok=True)
    ext = ".bin" if binary else ".txt"
    writers = ((write_cameras_binary, write_images_binary,
                write_points3d_binary) if binary else
               (write_cameras_text, write_images_text, write_points3d_text))
    writers[0](cameras, os.path.join(sparse_dir, "cameras" + ext))
    writers[1](images, os.path.join(sparse_dir, "images" + ext))
    writers[2](*points, os.path.join(sparse_dir, "points3D" + ext))


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
