"""The benchmark's inputs, made from ``--seed``: the splats' parameters on
the device (a ``torch.Generator`` on the device, a few large calls), the
cameras, and the ground-truth images on the host. The system under test and
the reference take the same inputs; neither makes any of them.

The scene kind a configuration's ``scene.kind`` names, ``capture360``: a
trained capture of a 360° scene at its trained size: a dense central object
(points on a sphere's surface with a little depth), a ground disk and a
distant background shell, each splat sized from its part's analytic point
spacing (sqrt(area / points)) with anisotropy, random rotations, high
opacity, SH colours up to the configuration's degree. No nearest-neighbour
search.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from splatbench.reference.raster import SH_C0, View

LEAVES = ("xyz", "f_dc", "f_rest", "scaling", "rotation", "opacity")


def _generator(seed: int, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    return g


def capture360(cfg: dict, seed: int, device) -> dict:
    """Parameters of a ``capture360`` scene (``cfg['scene']`` gives the
    parts' shares and sizes)."""
    sc = cfg["scene"]
    n = cfg["gaussians"]
    gen = _generator(seed, device)
    f32 = dict(dtype=torch.float32, device=device)

    def rand(*shape):
        return torch.rand(shape, generator=gen, **f32)

    def randn(*shape):
        return torch.randn(shape, generator=gen, **f32)

    n_obj = int(n * sc["object_share"])
    n_ground = int(n * sc["ground_share"])
    n_shell = n - n_obj - n_ground
    # object: a sphere's surface, a little depth
    d = randn(n_obj, 3)
    d = d / torch.linalg.norm(d, dim=1, keepdim=True)
    r_obj = sc["object_radius"]
    obj = d * (r_obj * (1.0 + sc["object_depth"] * randn(n_obj, 1)))
    obj_sp = math.sqrt(4 * math.pi * r_obj ** 2 / n_obj)
    # ground: a disk under the object, uniform over its area
    rg = sc["ground_radius"] * torch.sqrt(rand(n_ground))
    th = 2 * math.pi * rand(n_ground)
    ground = torch.stack([rg * torch.cos(th), rg * torch.sin(th),
                          torch.full_like(rg, sc["ground_z"])], 1)
    ground_sp = math.sqrt(math.pi * sc["ground_radius"] ** 2 / n_ground)
    # background: a shell between two radii
    d = randn(n_shell, 3)
    d = d / torch.linalg.norm(d, dim=1, keepdim=True)
    r0, r1 = sc["shell_radii"]
    rs = r0 + (r1 - r0) * rand(n_shell, 1)
    shell = d * rs
    shell_sp = torch.sqrt(4 * math.pi * rs[:, 0] ** 2 / n_shell)

    xyz = torch.cat([obj, ground, shell])
    spacing = torch.cat([torch.full((n_obj,), obj_sp, **f32),
                         torch.full((n_ground,), ground_sp, **f32), shell_sp])
    aniso = torch.tensor(sc["anisotropy"], **f32)
    scaling = (torch.log(spacing * sc["scale_per_spacing"])[:, None]
               + torch.log(aniso)[None, :] + sc["scale_jitter"] * randn(n, 3))
    rotation = randn(n, 4)
    lo, hi = sc["opacity_range"]
    op = lo + (hi - lo) * rand(n)
    k = (cfg["sh_degree"] + 1) ** 2
    return {"xyz": xyz,
            "f_dc": (rand(n, 3) - 0.5) / SH_C0,
            "f_rest": sc["sh_rest_std"] * randn(n, k - 1, 3),
            "scaling": scaling, "rotation": rotation,
            "opacity": torch.log(op / (1 - op))}


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


def poses(cfg: dict, count: int):
    """``count`` (R, T) poses of the configuration's camera path, an
    ``orbit``: evenly around the vertical axis at a radius and height,
    looking at a point."""
    cam = cfg["camera"]
    if cam["kind"] != "orbit":
        raise ValueError(f"unknown camera path {cam['kind']!r}")
    out = []
    for i in range(count):
        a = 2 * math.pi * i / count
        c = np.array([cam["radius"] * math.cos(a), cam["radius"] * math.sin(a),
                      cam["height"]])
        out.append(look_at(c, np.asarray(cam["target"], np.float64),
                           np.array([0.0, 0.0, 1.0])))
    return out


def fov(cfg: dict):
    """(fovx, fovy) in radians."""
    fx = cfg["camera"]["focal_px"]
    return (2 * math.atan(cfg["width"] / (2 * fx)),
            2 * math.atan(cfg["height"] / (2 * fx)))


def extent(cfg: dict, count: int) -> float:
    """The scene extent the position rate is scaled by: 1.1 x the largest
    distance of a camera centre from their mean (the 3DGS code's
    ``getNerfppNorm``)."""
    cs = np.stack([-R @ T for R, T in poses(cfg, count)])
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


def make(cfg: dict, seed: int, device, n_poses: int):
    """(parameters, views' (R, T) poses, ground truth (n_poses, 3, H, W) on
    the host) of a configuration."""
    kind = cfg["scene"]["kind"]
    if kind != "capture360":
        raise ValueError(f"unknown scene kind {kind!r}")
    return (capture360(cfg, seed, device), poses(cfg, n_poses),
            images(cfg, n_poses, seed))
