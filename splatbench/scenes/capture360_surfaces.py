"""The ``capture360_surfaces`` scene kind: a model that has not yet
resolved its scene. The ground truth is one scene seen from every pose:
the surfaces that ``capture360``'s splats sit on (the object's sphere,
the ground disk, the background shell's middle sphere), each textured with
colour cells fixed in the world, ray-cast at every pixel's centre. A
cell's side is the scene's ``truth_cells_per_spacing`` x its part's splat
spacing; its colour is uniform in [0, 1]^3, drawn from the seed. The
splats are ``capture360``'s, each with the colour of the cell under it
(its point on its part's surface): inside a cell a splat matches the
truth, and a splat across a cell's edge meets the same edge in every view,
so that the densification statistics single out the splats at edges, as
they do in training.
"""
from __future__ import annotations

import math
from pathlib import Path

import numpy as np
import torch

from splatbench import spec
from splatbench.reference.raster import SH_C0
from splatbench.scene import generator

TABLE = 1 << 22      # colours, indexed by a hash of a cell and its part


def _capture360():
    return spec.module("scenes", "capture360",
                       Path(__file__).resolve().parents[2])


def params(cfg: dict, seed: int, device) -> dict:
    """``capture360``'s parameters, each splat's colour (SH DC) that of the
    truth's cell under it."""
    p = _capture360().params(cfg, seed, device)
    (r_obj, _, _, r_shell), _ = parts(cfg)
    n, sc = cfg["gaussians"], cfg["scene"]
    n_obj = int(n * sc["object_share"])
    n_ground = int(n * sc["ground_share"])
    xyz = p["xyz"]
    part = torch.cat([torch.full((n_obj,), 0), torch.full((n_ground,), 1),
                      torch.full((n - n_obj - n_ground,), 2)]).to(device)
    radius = torch.tensor([r_obj, 0.0, r_shell], device=device)[part]
    on = xyz / torch.linalg.norm(xyz, dim=1, keepdim=True) * radius[:, None]
    on = torch.where((part == 1)[:, None], xyz, on)
    p["f_dc"] = (texture(palette(cfg, seed, device), on, part) - 0.5) / SH_C0
    return p


def palette(cfg: dict, seed: int, device):
    """(each part's cell side, the colour table) of the truth."""
    cell = torch.tensor([s * cfg["scene"]["truth_cells_per_spacing"]
                         for s in parts(cfg)[1]], device=device)
    return cell, torch.rand((TABLE, 3), generator=generator(seed ^ 0x7E47,
                                                             device),
                            device=device)


def texture(pal, points, part):
    """The truth's colour (n, 3) at ``points`` (n, 3) on parts ``part``
    (n,: 0 object, 1 ground, 2 shell)."""
    cell, colours = pal
    ijk = torch.floor(points / cell[part][:, None]).long()
    h = ((ijk[:, 0] * 73856093) ^ (ijk[:, 1] * 19349663)
         ^ (ijk[:, 2] * 83492791) ^ (part * 2654435761))
    return colours[h & (TABLE - 1)]


def parts(cfg: dict):
    """(object radius, ground height, ground radius, shell radius) and
    each part's analytic splat spacing, as ``capture360`` places them."""
    sc, n = cfg["scene"], cfg["gaussians"]
    n_obj = int(n * sc["object_share"])
    n_ground = int(n * sc["ground_share"])
    n_shell = n - n_obj - n_ground
    r_obj, r_ground = sc["object_radius"], sc["ground_radius"]
    r_shell = sum(sc["shell_radii"]) / 2
    spacing = (math.sqrt(4 * math.pi * r_obj ** 2 / n_obj),
               math.sqrt(math.pi * r_ground ** 2 / n_ground),
               math.sqrt(4 * math.pi * r_shell ** 2 / n_shell))
    return (r_obj, sc["ground_z"], r_ground, r_shell), spacing


def images(cfg: dict, poses: list, seed: int, device) -> np.ndarray:
    """(n, 3, H, W) float32 ground truth in [0, 1] on the host, one image
    per pose, ray-cast on ``device``."""
    W, H, f = cfg["width"], cfg["height"], cfg["camera"]["focal_px"]
    (r_obj, gz, r_ground, r_shell), _ = parts(cfg)
    pal = palette(cfg, seed, device)
    f32 = dict(dtype=torch.float32, device=device)
    v, u = torch.meshgrid(torch.arange(H, **f32), torch.arange(W, **f32),
                          indexing="ij")
    cam = torch.stack([(u - (W - 1) / 2) / f, (v - (H - 1) / 2) / f,
                       torch.ones_like(u)], -1).reshape(-1, 3)
    cam = cam / torch.linalg.norm(cam, dim=1, keepdim=True)
    out = np.empty((len(poses), 3, H, W), np.float32)
    for k, (R, T) in enumerate(poses):
        Rw = torch.tensor(R, **f32)
        c = -(Rw @ torch.tensor(T, **f32))
        d = cam @ Rw.T
        b = d @ c
        cc = float(c @ c)
        inf = torch.full_like(b, math.inf)
        # the object's sphere from outside: the nearer root
        disc = b * b - (cc - r_obj ** 2)
        t_obj = -b - torch.sqrt(torch.clamp(disc, min=0.0))
        t_obj = torch.where((disc >= 0) & (t_obj > 0), t_obj, inf)
        # the ground disk
        t_gr = (gz - c[2]) / d[:, 2]
        hit = c[None, :2] + t_gr[:, None] * d[:, :2]
        t_gr = torch.where((t_gr > 0) & ((hit * hit).sum(1)
                                         <= r_ground ** 2), t_gr, inf)
        # the background shell from inside: the farther root
        t_sh = -b + torch.sqrt(b * b - (cc - r_shell ** 2))
        t, part = torch.stack([t_obj, t_gr, t_sh], 1).min(1)
        img = texture(pal, c[None] + t[:, None] * d, part)
        out[k] = img.T.reshape(3, H, W).cpu().numpy()
    return out
