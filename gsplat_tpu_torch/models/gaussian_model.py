"""The Gaussian scene as a dataclass of tensors in padded-capacity buffers.
Counterpart of gsplat_tpu/models/gaussian_model.py.

Every per-primitive tensor has leading dim = capacity; slots with
``active == False`` are dead padding. Parameters are stored pre-activation
(log-scale, logit-opacity, unnormalized quaternion), as in the PLY format.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import numpy as np
import torch

from gsplat_tpu_torch.core import sh as sh_lib
from gsplat_tpu_torch.core import transforms
from gsplat_tpu_torch.utils.general import resolve_device

TENSOR_FIELDS = ("xyz", "f_dc", "f_rest", "scaling", "rotation", "opacity",
                 "active")
# the float fields that receive gradients (the reference's param groups)
TRAINABLE_FIELDS = ("xyz", "f_dc", "f_rest", "scaling", "rotation", "opacity")


@dataclass
class GaussianParams:
    xyz: torch.Tensor        # (CAP, 3)
    f_dc: torch.Tensor       # (CAP, 3)        SH DC coefficients
    f_rest: torch.Tensor     # (CAP, K-1, 3)   higher SH coefficients
    scaling: torch.Tensor    # (CAP, 3)        log-scale
    rotation: torch.Tensor   # (CAP, 4)        unnormalized quaternion wxyz
    opacity: torch.Tensor    # (CAP,)          logit-opacity
    active: torch.Tensor     # (CAP,) bool
    active_sh_degree: int    # SH warm-up state

    @property
    def capacity(self) -> int:
        return self.xyz.shape[0]

    @property
    def max_sh_degree(self) -> int:
        return int(round((self.f_rest.shape[1] + 1) ** 0.5)) - 1

    @property
    def device(self) -> torch.device:
        return self.xyz.device

    def get_scaling(self) -> torch.Tensor:
        return torch.exp(self.scaling)

    def get_rotation(self) -> torch.Tensor:
        return self.rotation / torch.linalg.norm(self.rotation, dim=-1,
                                                 keepdim=True)

    def get_opacity(self) -> torch.Tensor:
        return torch.sigmoid(self.opacity)

    def get_features(self) -> torch.Tensor:
        """(CAP, K, 3): DC + rest, coefficient-major."""
        return torch.cat([self.f_dc[:, None, :], self.f_rest], dim=1)

    def get_covariance(self, scaling_modifier=1.0) -> torch.Tensor:
        """Symmetric-6 3D covariance."""
        return transforms.covariance_from_scaling_rotation(
            self.get_scaling(), scaling_modifier, self.get_rotation())

    def num_active(self) -> int:
        return int(self.active.sum())

    def one_up_sh_degree(self) -> "GaussianParams":
        return dataclasses.replace(
            self, active_sh_degree=min(self.active_sh_degree + 1,
                                       self.max_sh_degree))


def trainables(g: GaussianParams) -> dict:
    return {k: getattr(g, k) for k in TRAINABLE_FIELDS}


def with_trainables(g: GaussianParams, t: dict) -> GaussianParams:
    return dataclasses.replace(g, **t)


def empty(capacity: int, max_sh_degree: int, *, device="cuda") -> GaussianParams:
    """All-dead buffers: tiny, transparent, at the origin."""
    dev = resolve_device(device)
    K = (max_sh_degree + 1) ** 2
    f32 = dict(dtype=torch.float32, device=dev)
    rotation = torch.zeros((capacity, 4), **f32)
    rotation[:, 0] = 1.0
    return GaussianParams(
        xyz=torch.zeros((capacity, 3), **f32),
        f_dc=torch.zeros((capacity, 3), **f32),
        f_rest=torch.zeros((capacity, K - 1, 3), **f32),
        scaling=torch.full((capacity, 3), -10.0, **f32),
        rotation=rotation,
        opacity=torch.full((capacity,), -10.0, **f32),
        active=torch.zeros((capacity,), dtype=torch.bool, device=dev),
        active_sh_degree=0)


def create_from_pcd(points: np.ndarray, colors: np.ndarray,
                    max_sh_degree: int, capacity: int | None = None, *,
                    device="cuda") -> GaussianParams:
    """Initialise from a point cloud: colors to the SH DC term (higher
    coefficients zero), log-scale = log sqrt(mean squared distance to the 3
    nearest neighbours) on every axis (floored at 1e-7), identity
    quaternion, opacity 0.1. Rows past the points are dead slots."""
    from gsplat_tpu_torch.ops.knn import mean_sq_dist_to_3nn

    n = points.shape[0]
    cap = capacity or n
    if cap < n:
        raise ValueError(f"capacity {cap} < {n} points")
    g = empty(cap, max_sh_degree, device=device)
    pts = torch.tensor(np.asarray(points, np.float32), device=g.device)
    dist2 = torch.clamp(mean_sq_dist_to_3nn(pts), min=1e-7)
    g.xyz[:n] = pts
    g.f_dc[:n] = sh_lib.rgb2sh(torch.tensor(np.asarray(colors, np.float32),
                                            device=g.device))
    g.scaling[:n] = torch.log(torch.sqrt(dist2))[:, None]
    g.opacity[:n] = transforms.inverse_sigmoid(torch.tensor(0.1))
    g.active[:n] = True
    return g


def from_numpy(arrays: dict, *, device="cuda",
               capacity: int | None = None) -> GaussianParams:
    """From a dict of numpy arrays keyed by field name: a JAX
    ``GaussianParams`` turned into numpy field by field, or the dict that
    ``scene.ply.load_gaussian_ply`` returns. Without ``active`` every row
    is live; without ``active_sh_degree`` the degree is the maximum.
    ``capacity`` pads the buffers with dead slots."""
    dev = resolve_device(device)
    n = np.asarray(arrays["xyz"]).shape[0]
    kw = {}
    for k in TENSOR_FIELDS:
        if k == "active":
            a = np.asarray(arrays.get("active", np.ones(n, bool)), bool)
            kw[k] = torch.tensor(a, device=dev)
        else:
            kw[k] = torch.tensor(np.asarray(arrays[k], np.float32),
                                 device=dev)
    max_deg = int(round((kw["f_rest"].shape[1] + 1) ** 0.5)) - 1
    deg = int(arrays.get("active_sh_degree", max_deg))
    g = GaussianParams(active_sh_degree=deg, **kw)
    if capacity is not None:
        g = pad_to_capacity(g, capacity)
    return g


def pad_to_capacity(g: GaussianParams, new_capacity: int) -> GaussianParams:
    """Grow the padded buffers with dead slots."""
    if new_capacity < g.capacity:
        raise ValueError(f"new_capacity {new_capacity} < {g.capacity}")
    extra = new_capacity - g.capacity
    if extra == 0:
        return g
    tail = empty(extra, g.max_sh_degree, device=g.device)
    return dataclasses.replace(g, **{
        k: torch.cat([getattr(g, k), getattr(tail, k)], dim=0)
        for k in TENSOR_FIELDS})


def compact(g: GaussianParams) -> GaussianParams:
    """Pack active gaussians to the front, keeping their order."""
    order = torch.argsort((~g.active).to(torch.int8), stable=True)
    return dataclasses.replace(g, **{k: getattr(g, k)[order]
                                     for k in TENSOR_FIELDS})
