"""The ``capture360`` scene kind: a trained capture of a 360° scene at its
trained size: a dense central object (points on a sphere's surface with a
little depth), a ground disk and a distant background shell, each splat
sized from its part's analytic point spacing (sqrt(area / points)) with
anisotropy, random rotations, opacities uniform in a range, SH colours up
to the configuration's degree. No nearest-neighbour search, no depth maps.
"""
from __future__ import annotations

import math

import torch

from splatbench.reference.raster import SH_C0
from splatbench.scene import generator


def params(cfg: dict, seed: int, device) -> dict:
    """Parameters of a ``capture360`` scene (``cfg['scene']`` gives the
    parts' shares and sizes)."""
    sc = cfg["scene"]
    n = cfg["gaussians"]
    gen = generator(seed, device)
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
