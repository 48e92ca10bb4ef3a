"""The camera view the renderer consumes: a few small tensors on one device.
Counterpart of gsplat_tpu/core/camera.py."""
from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from gsplat_tpu_torch.core import transforms
from gsplat_tpu_torch.utils.general import resolve_device

FIELDS = ("world_view", "full_proj", "camera_center", "tanfovx", "tanfovy",
          "exposure_idx")


@dataclass
class CameraView:
    world_view: torch.Tensor     # (4,4) x_view = W2V @ x_world
    full_proj: torch.Tensor      # (4,4) = P @ W2V
    camera_center: torch.Tensor  # (3,)
    tanfovx: torch.Tensor        # () f32
    tanfovy: torch.Tensor        # () f32
    exposure_idx: int = -1       # -1 = no per-image exposure

    @staticmethod
    def create(R: np.ndarray, T: np.ndarray, fovx: float, fovy: float,
               znear: float = 0.01, zfar: float = 100.0,
               trans=np.array([0.0, 0.0, 0.0]), scale: float = 1.0,
               exposure_idx: int = -1, *, device="cuda") -> "CameraView":
        """From COLMAP-convention R (cam→world rotation) and T (world→cam
        translation); zfar=100, znear=0.01 as in the reference."""
        w2v = transforms.world_to_view(R, T, trans, scale)
        proj = transforms.projection_matrix(znear, zfar, fovx, fovy)
        return CameraView.from_numpy(dict(
            world_view=w2v,
            full_proj=(proj @ w2v).astype(np.float32),
            camera_center=np.linalg.inv(w2v)[:3, 3].astype(np.float32),
            tanfovx=np.float32(math.tan(fovx * 0.5)),
            tanfovy=np.float32(math.tan(fovy * 0.5)),
            exposure_idx=exposure_idx), device=device)

    @staticmethod
    def from_numpy(arrays: dict, *, device="cuda") -> "CameraView":
        """From a dict of numpy arrays keyed by field name (for instance a
        JAX ``CameraView`` turned into numpy field by field)."""
        dev = resolve_device(device)
        kw = {k: torch.tensor(np.asarray(arrays[k], np.float32), device=dev)
              for k in FIELDS if k != "exposure_idx"}
        return CameraView(exposure_idx=int(arrays.get("exposure_idx", -1)),
                          **kw)
