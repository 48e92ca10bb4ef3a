"""The benchmark's inputs, made from ``--seed``: the splats' parameters on
the device (a ``torch.Generator`` on the device, a few large calls), the
cameras, the ground-truth images and, where the scene kind makes them, the
inverse-depth maps and the alpha masks on the host. The system under test
and the reference take the same inputs; neither makes any of them.

The splats come from the module of ``splatbench/scenes/`` that the
configuration's ``scene.kind`` names (the ground truth too, where that
module makes it), the poses from the module of
``splatbench/cameras/`` that its ``camera.kind`` names; the modules are
loaded from the checkout the run reads (``root``; this one by default).
"""
from __future__ import annotations

import math

import numpy as np
import torch

from splatbench.reference.raster import View

def _module(folder: str, kind: str, root):
    from splatbench import spec
    return spec.module(folder, kind, spec.ROOT if root is None else root)


def generator(seed: int, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    return g


def look_at(center: np.ndarray, target: np.ndarray, up: np.ndarray):
    """(R, T) in COLMAP's convention (R camera-to-world, T world-to-camera;
    camera x right, y down, z forward) of a camera at ``center`` looking at
    ``target``."""
    z = target - center
    z = z / np.linalg.norm(z)
    x = np.cross(z, up)
    x = x / np.linalg.norm(x)
    y = np.cross(z, x)
    R = np.stack([x, y, z], 1)
    return R, -R.T @ center


def poses(cfg: dict, count: int, root=None):
    """``count`` (R, T) poses of the configuration's camera path, made by
    the module its ``camera.kind`` names."""
    return _module("cameras", cfg["camera"]["kind"], root).poses(cfg, count)


def fov(cfg: dict):
    """(fovx, fovy) in radians."""
    fx = cfg["camera"]["focal_px"]
    return (2 * math.atan(cfg["width"] / (2 * fx)),
            2 * math.atan(cfg["height"] / (2 * fx)))


def extent(cfg: dict, count: int, root=None) -> float:
    """The scene extent the position rate is scaled by: 1.1 x the largest
    distance of a camera centre from their mean (the 3DGS code's
    ``getNerfppNorm``)."""
    cs = np.stack([-R @ T for R, T in poses(cfg, count, root)])
    return 1.1 * float(np.linalg.norm(cs - cs.mean(0), axis=1).max())


def view(R, T, fovx, fovy, device, znear=0.01, zfar=100.0) -> View:
    """The reference's view of a pose."""
    w2c = np.eye(4)
    w2c[:3, :3] = R.T
    w2c[:3, 3] = T
    tx, ty = math.tan(fovx / 2), math.tan(fovy / 2)
    P = np.zeros((4, 4))
    P[0, 0], P[1, 1] = 1 / tx, 1 / ty
    P[3, 2] = 1.0
    P[2, 2] = zfar / (zfar - znear)
    P[2, 3] = -(zfar * znear) / (zfar - znear)
    t = dict(dtype=torch.float32, device=device)
    return View(torch.tensor(w2c, **t), torch.tensor(P @ w2c, **t),
                torch.tensor(np.linalg.inv(w2c)[:3, 3], **t), tx, ty)


def images(cfg: dict, count: int, seed: int) -> np.ndarray:
    """(count, 3, H, W) float32 ground truth in [0, 1] on the host: a
    colour field constant over 16 x 16 pixel blocks, 0.9 of the value, and
    fine noise, 0.1, one image per pose."""
    W, H = cfg["width"], cfg["height"]
    rng = np.random.default_rng(seed ^ 0x5EED)
    coarse = rng.random((count, 3, -(-H // 16), -(-W // 16)),
                        dtype=np.float32) * np.float32(0.9)
    img = rng.random((count, 3, H, W), dtype=np.float32)
    img *= np.float32(0.1)
    img += coarse.repeat(16, axis=2)[:, :, :H].repeat(16, axis=3)[..., :W]
    return img


def make(cfg: dict, seed: int, device, n_poses: int, root=None):
    """(parameters, views' (R, T) poses, ground truth (n_poses, 3, H, W) on
    the host) of a configuration, the parameters made by the module its
    ``scene.kind`` names, and the ground truth too where that module has
    an ``images``; else ``images`` here."""
    mod = _module("scenes", cfg["scene"]["kind"], root)
    poses_ = poses(cfg, n_poses, root)
    gt = (mod.images(cfg, poses_, seed, device) if hasattr(mod, "images")
          else images(cfg, n_poses, seed))
    return mod.params(cfg, seed, device), poses_, gt


def depths(cfg: dict, poses_: list, seed: int, root=None):
    """Each pose's (inverse depth, mask), (n, 1, H, W) host arrays, where
    the configuration's scene kind makes them; else None."""
    mod = _module("scenes", cfg["scene"]["kind"], root)
    return mod.depths(cfg, poses_, seed) if hasattr(mod, "depths") else None


def masks(cfg: dict, poses_: list, seed: int, root=None):
    """Each pose's alpha mask, a (n, 1, H, W) host array in [0, 1], where
    the configuration's scene kind makes them; else None (all ones)."""
    mod = _module("scenes", cfg["scene"]["kind"], root)
    return mod.masks(cfg, poses_, seed) if hasattr(mod, "masks") else None
