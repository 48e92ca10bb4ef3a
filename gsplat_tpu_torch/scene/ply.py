"""PLY io in numpy, byte-compatible with the reference's Gaussian snapshots
(own copy of gsplat_tpu/scene/ply.py).

Gaussian field order: x,y,z, nx,ny,nz, f_dc_0..2, f_rest_0..(3(K-1)-1)
channel-major, opacity, scale_0..2, rot_0..3; all f32 pre-activation values.
"""
from __future__ import annotations

import os
import threading
from typing import Tuple

import numpy as np


def _field_names(n_rest: int) -> list:
    names = ["x", "y", "z", "nx", "ny", "nz"]
    names += [f"f_dc_{i}" for i in range(3)]
    names += [f"f_rest_{i}" for i in range(n_rest)]
    names += ["opacity"]
    names += [f"scale_{i}" for i in range(3)]
    names += [f"rot_{i}" for i in range(4)]
    return names


def _read_header(f):
    header = []
    while True:
        raw = f.readline()
        if not raw:
            raise ValueError(f"{f.name}: the PLY header ends before "
                             f"end_header")
        line = raw.decode("ascii").strip()
        header.append(line)
        if line == "end_header":
            return header


def _read_rows(f, dtype: np.dtype, n: int) -> np.ndarray:
    data = np.frombuffer(f.read(dtype.itemsize * n), dtype=dtype)
    if len(data) != n:
        raise ValueError(f"{f.name}: {len(data)} of the header's {n} rows")
    return data


def _write_whole(path: str, header: list, payload: bytes) -> None:
    """Write the file under a temporary name beside ``path`` and rename it
    into place, so that a reader (another rank reading the scene) finds no
    file or the whole one."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = f"{path}.{os.getpid()}.{threading.get_ident()}.tmp"
    try:
        with open(tmp, "wb") as f:
            f.write(("\n".join(header) + "\n").encode("ascii"))
            f.write(payload)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def save_gaussian_ply(path: str, xyz: np.ndarray, f_dc: np.ndarray,
                      f_rest: np.ndarray, opacity: np.ndarray,
                      scaling: np.ndarray, rotation: np.ndarray) -> None:
    """Write pre-activation Gaussian params; f_rest (N,K-1,3) is stored
    channel-major, (N, 3·(K−1)) ordered rgb-major over coefficients."""
    n = xyz.shape[0]
    n_rest = f_rest.shape[1] * 3
    f_rest_flat = np.transpose(f_rest, (0, 2, 1)).reshape(n, -1)
    cols = np.concatenate([
        xyz.astype(np.float32),
        np.zeros((n, 3), np.float32),          # normals (zeros)
        f_dc.astype(np.float32),
        f_rest_flat.astype(np.float32),
        opacity.reshape(n, 1).astype(np.float32),
        scaling.astype(np.float32),
        rotation.astype(np.float32),
    ], axis=1)
    names = _field_names(n_rest)
    header = ["ply", "format binary_little_endian 1.0", f"element vertex {n}"]
    header += [f"property float {nm}" for nm in names]
    header += ["end_header"]
    _write_whole(path, header,
                 np.ascontiguousarray(cols, dtype="<f4").tobytes())


def load_gaussian_ply(path: str) -> dict:
    """Read a reference-format Gaussian PLY (binary or ascii) → dict of
    xyz, f_dc (N,3), f_rest (N,K-1,3), opacity (N,), scaling (N,3),
    rotation (N,4), all pre-activation."""
    with open(path, "rb") as f:
        header = _read_header(f)
        fmt = [ln for ln in header if ln.startswith("format")][0].split()[1]
        n = int([ln for ln in header
                 if ln.startswith("element vertex")][0].split()[-1])
        props = [ln.split() for ln in header if ln.startswith("property")]
        names = [p[2] for p in props]
        np_types = {"float": "<f4", "float32": "<f4", "double": "<f8",
                    "uchar": "u1", "uint8": "u1", "int": "<i4"}
        dtype = np.dtype([(p[2], np_types[p[1]]) for p in props])
        if fmt == "binary_little_endian":
            data = _read_rows(f, dtype, n)
        elif fmt == "ascii":
            data = np.loadtxt(f, dtype=np.float32, max_rows=n, ndmin=2)
            data = np.rec.fromarrays(data.T, dtype=np.dtype(
                [(nm, "<f4") for nm in names]))
        else:
            raise ValueError(f"unsupported PLY format {fmt}")

    def stack(prefix, count):
        return np.stack([np.asarray(data[f"{prefix}{i}"], np.float32)
                         for i in range(count)], axis=1)

    xyz = np.stack([np.asarray(data[c], np.float32) for c in "xyz"], axis=1)
    rest_names = sorted([nm for nm in names if nm.startswith("f_rest_")],
                        key=lambda s: int(s.split("_")[-1]))
    n_rest = len(rest_names)
    if n_rest:
        rest = np.stack([np.asarray(data[nm], np.float32)
                         for nm in rest_names], axis=1)
        f_rest = rest.reshape(n, 3, n_rest // 3).transpose(0, 2, 1)
    else:
        f_rest = np.zeros((n, 0, 3), np.float32)
    return dict(xyz=xyz, f_dc=stack("f_dc_", 3), f_rest=f_rest,
                opacity=np.asarray(data["opacity"], np.float32),
                scaling=stack("scale_", 3), rotation=stack("rot_", 4))


def save_point_ply(path: str, xyz: np.ndarray, rgb: np.ndarray) -> None:
    """Write an input point cloud PLY (x,y,z,nx,ny,nz,red,green,blue)."""
    n = xyz.shape[0]
    dtype = np.dtype([("x", "<f4"), ("y", "<f4"), ("z", "<f4"),
                      ("nx", "<f4"), ("ny", "<f4"), ("nz", "<f4"),
                      ("red", "u1"), ("green", "u1"), ("blue", "u1")])
    rec = np.zeros(n, dtype=dtype)
    rec["x"], rec["y"], rec["z"] = xyz.T.astype(np.float32)
    rec["red"], rec["green"], rec["blue"] = rgb.T.astype(np.uint8)
    header = ["ply", "format binary_little_endian 1.0", f"element vertex {n}",
              "property float x", "property float y", "property float z",
              "property float nx", "property float ny", "property float nz",
              "property uchar red", "property uchar green",
              "property uchar blue", "end_header"]
    _write_whole(path, header, rec.tobytes())


def load_point_ply(path: str) -> Tuple[np.ndarray, np.ndarray]:
    """Read an input point cloud PLY → (xyz (N,3) f32, rgb (N,3) f32 in
    [0,1])."""
    with open(path, "rb") as f:
        header = _read_header(f)
        n = int([ln for ln in header
                 if ln.startswith("element vertex")][0].split()[-1])
        props = [ln.split() for ln in header if ln.startswith("property")]
        np_types = {"float": "<f4", "double": "<f8", "uchar": "u1",
                    "int": "<i4", "uint": "<u4", "short": "<i2",
                    "ushort": "<u2", "char": "i1"}
        dtype = np.dtype([(p[2], np_types[p[1]]) for p in props])
        data = _read_rows(f, dtype, n)
    xyz = np.stack([np.asarray(data[c], np.float32) for c in "xyz"], axis=1)
    if "red" in dtype.names:
        rgb = np.stack([np.asarray(data[c], np.float32)
                        for c in ("red", "green", "blue")], axis=1) / 255.0
    else:
        rgb = np.full_like(xyz, 0.5)
    return xyz, rgb
