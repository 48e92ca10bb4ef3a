"""Camera & covariance math (own copy of gsplat_tpu/core/transforms.py).

Matrices use the column-vector convention (``x_view = W2V @ x_world``). The
camera-matrix builders are numpy (host-side, float64 then cast); the
per-gaussian functions are torch and differentiable.
"""
from __future__ import annotations

import math

import numpy as np
import torch


def world_to_view(R: np.ndarray, t: np.ndarray,
                  translate=np.array([0.0, 0.0, 0.0]),
                  scale: float = 1.0) -> np.ndarray:
    """4x4 world→view matrix from COLMAP-convention R (cam→world rotation)
    and t (world→cam translation); the camera center is optionally
    shifted/scaled through the cam→world round trip."""
    Rt = np.zeros((4, 4), dtype=np.float64)
    Rt[:3, :3] = np.asarray(R).T
    Rt[:3, 3] = np.asarray(t)
    Rt[3, 3] = 1.0
    C2W = np.linalg.inv(Rt)
    cam_center = (C2W[:3, 3] + np.asarray(translate)) * scale
    C2W[:3, 3] = cam_center
    return np.linalg.inv(C2W).astype(np.float32)


def projection_matrix(znear: float, zfar: float, fovx: float,
                      fovy: float) -> np.ndarray:
    """OpenGL-style perspective projection with z mapped to [0,1]."""
    tan_half_fovy = math.tan(fovy / 2)
    tan_half_fovx = math.tan(fovx / 2)
    top = tan_half_fovy * znear
    right = tan_half_fovx * znear
    P = np.zeros((4, 4), dtype=np.float32)
    P[0, 0] = znear / right
    P[1, 1] = znear / top
    P[3, 2] = 1.0
    P[2, 2] = zfar / (zfar - znear)
    P[2, 3] = -(zfar * znear) / (zfar - znear)
    return P


def fov2focal(fov: float, pixels: float) -> float:
    return pixels / (2 * math.tan(fov / 2))


def focal2fov(focal: float, pixels: float) -> float:
    return 2 * math.atan(pixels / (2 * focal))


def quat_to_rotmat(q: torch.Tensor) -> torch.Tensor:
    """Quaternion (w,x,y,z, unnormalized) → rotation matrices [...,4]→[...,3,3]."""
    q = q / torch.linalg.norm(q, dim=-1, keepdim=True)
    r, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    R = torch.stack([
        1 - 2 * (y * y + z * z), 2 * (x * y - r * z), 2 * (x * z + r * y),
        2 * (x * y + r * z), 1 - 2 * (x * x + z * z), 2 * (y * z - r * x),
        2 * (x * z - r * y), 2 * (y * z + r * x), 1 - 2 * (x * x + y * y),
    ], dim=-1)
    return R.reshape(q.shape[:-1] + (3, 3))


def build_scaling_rotation(s: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """L = R · diag(s), batched: [...,3], [...,4] → [...,3,3]."""
    return quat_to_rotmat(q) * s[..., None, :]


def covariance_from_scaling_rotation(scaling: torch.Tensor, scaling_modifier,
                                     rotation: torch.Tensor) -> torch.Tensor:
    """3D covariance Σ = L Lᵀ with L = R·diag(s), packed as symmetric-6
    (xx,xy,xz,yy,yz,zz). Component arithmetic (C_ij = Σ_k s_k² R_ik R_jk)
    keeps it exact f32 with no batched 3x3 product."""
    R = quat_to_rotmat(rotation)
    s2 = torch.square(scaling_modifier * scaling)            # (...,3)

    def c(i, j):
        return (s2[..., 0] * R[..., i, 0] * R[..., j, 0]
                + s2[..., 1] * R[..., i, 1] * R[..., j, 1]
                + s2[..., 2] * R[..., i, 2] * R[..., j, 2])

    return torch.stack([c(0, 0), c(0, 1), c(0, 2),
                        c(1, 1), c(1, 2), c(2, 2)], dim=-1)


def cov6_to_mat(cov6: torch.Tensor) -> torch.Tensor:
    """Unpack symmetric-6 (xx,xy,xz,yy,yz,zz) → full 3x3."""
    xx, xy, xz, yy, yz, zz = (cov6[..., i] for i in range(6))
    return torch.stack([
        torch.stack([xx, xy, xz], -1),
        torch.stack([xy, yy, yz], -1),
        torch.stack([xz, yz, zz], -1),
    ], dim=-2)


def inverse_sigmoid(x):
    return torch.log(x / (1 - x))
