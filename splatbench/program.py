"""The system under test, ``gsplat_tpu_torch``, as the benchmark drives it:
the one module of the benchmark that imports it. Everything here calls the
system's own entry points with the benchmark's inputs, as its training loop
and renderer call them: ``train/trainer.py:train_step``,
``parallel/dp.py:make_dp_train_step`` and ``camera_inputs``,
``ops/rasterize.py:render``, ``scene/cameras.py:Camera``, and the loop's
events, ``trainer.densify_step`` and ``opacity_reset_step``.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from gsplat_tpu_torch.config import OptimizationConfig, RasterizerConfig
from gsplat_tpu_torch.core.camera import CameraView
from gsplat_tpu_torch.models import gaussian_model as gm
from gsplat_tpu_torch.ops.rasterize import render
from gsplat_tpu_torch.parallel import dp as dp_lib
from gsplat_tpu_torch.parallel import mesh as mesh_lib
from gsplat_tpu_torch.scene.cameras import Camera
from gsplat_tpu_torch.train import trainer

LEAVES = gm.TRAINABLE_FIELDS


def gaussians(p: dict, sh_degree: int, capacity: int = 0
              ) -> gm.GaussianParams:
    """The system's splats from the benchmark's parameters, all live, in
    buffers padded with dead rows to ``capacity`` where it is larger."""
    n = p["xyz"].shape[0]
    g = gm.GaussianParams(
        **{k: p[k] for k in LEAVES},
        active=torch.ones(n, dtype=torch.bool, device=p["xyz"].device),
        active_sh_degree=sh_degree)
    return gm.pad_to_capacity(g, capacity) if capacity > n else g


def init_state(p: dict, sh_degree: int, first_step: int, capacity: int = 0,
               n_images: int = 1):
    """A training state at iteration ``first_step`` with fresh moments and
    ``n_images`` exposures."""
    return dataclasses.replace(
        trainer.init_state(gaussians(p, sh_degree, capacity), n_images),
        step=first_step)


def camera(i: int, pose, fov, image: np.ndarray, depth=None,
           exposure: bool = False, alpha=None) -> Camera:
    """A scene camera as the system's loader makes one: the host image
    (3,H,W) in [0,1]; ``alpha`` its alpha mask (1,H,W) where the scene
    gives one, else all ones; ``depth`` (inverse depth, mask), each
    (1,H,W), where the scene gives one, else none; with ``exposure`` its
    own exposure, number ``i``."""
    (R, T), (fovx, fovy) = pose, fov
    H, W = image.shape[1:]
    inv, mask = depth if depth is not None else (None, None)
    extra = dict(exposure_idx=i) if exposure else {}
    if alpha is None:
        alpha = np.ones((1, H, W), np.float32)
    return Camera(uid=i, colmap_id=i, R=R, T=T, FoVx=fovx, FoVy=fovy,
                  image=image, alpha_mask=alpha,
                  invdepthmap=inv, depth_mask=mask,
                  depth_reliable=depth is not None,
                  image_name=f"{i:05d}", width=W, height=H, **extra)


def view(cam: Camera, device) -> CameraView:
    return cam.view(device)


def upload(cam: Camera, device):
    """The per-iteration upload of the loop: (view, gt, alpha mask,
    inverse depth, depth mask) on the device, from pageable host memory."""
    return dp_lib.camera_inputs(cam, device)


def rasterizer(pairs_per_gaussian: float, chunk: int = 64, pad_cap: int = -1
               ) -> RasterizerConfig:
    return RasterizerConfig(pairs_per_gaussian=pairs_per_gaussian,
                            chunk=chunk, pad_cap=pad_cap)


def frame(g, cam_view, W, H, bg, rcfg, antialiasing: bool = False):
    """One viewer frame: ``render`` without gradients, with the EWA filter
    where ``antialiasing`` is on."""
    with torch.no_grad():
        return render(g, cam_view, W, H, bg, rcfg, antialiasing=antialiasing)


def right_size(g, views, W, H, bg, first_ppg: float,
               antialiasing: bool = False):
    """bench.py's arithmetic over every view: the frames at ``first_ppg``
    pairs a gaussian, doubled until none overflows, then 1.3x the largest
    pair count (at least 2 a gaussian) and 1.5x the largest alignment
    padding (at least one chunk). Returns (config, largest pairs)."""
    rcfg = rasterizer(first_ppg)
    while True:
        outs = [frame(g, v, W, H, bg, rcfg, antialiasing) for v in views]
        if not any(int(o.overflow) for o in outs):
            break
        rcfg = rasterizer(2 * rcfg.pairs_per_gaussian)
    pairs = max(int(o.num_pairs) for o in outs)
    pad = max(int(o.num_padded) - int(o.num_pairs) for o in outs)
    n = g.capacity
    return (dataclasses.replace(
        rcfg, pairs_per_gaussian=max(pairs * 1.3 / n, 2.0),
        pad_cap=max(rcfg.chunk, int(pad * 1.5))), pairs)


def step_kw(W, H, rcfg, extent, options: dict, optimization: dict):
    """The loop's step arguments: the configuration's step options
    (``spec.options``) and an ``OptimizationConfig`` with the fields its
    ``optimization`` block gives, every other field at its default."""
    return dict(image_width=W, image_height=H,
                opt=dataclasses.replace(OptimizationConfig(), **optimization),
                rcfg=rcfg, spatial_lr_scale=extent,
                antialiasing=options["antialiasing"],
                use_sparse_adam=options["sparse_adam"],
                train_test_exp=options["train_test_exp"],
                use_depth=options["use_depth"])


def events(kw, iteration: int):
    """The loop's events after the step of ``iteration``
    (``train/loop.py``, on a black background): (densify, with the
    screen-size prune, opacity reset)."""
    opt = kw["opt"]
    before = iteration < opt.densify_until_iter
    densify = (before and iteration > opt.densify_from_iter
               and iteration % opt.densification_interval == 0)
    reset = before and iteration % opt.opacity_reset_interval == 0
    return densify, iteration > opt.opacity_reset_interval, reset


def densify(state, noise, extent: float, kw, screen_size_prune: bool):
    """``trainer.densify_step`` as the loop calls it, with the split
    samples ``noise`` handed in: (state, overflow)."""
    return trainer.densify_step(state, None, extent, opt=kw["opt"],
                                use_screen_size_prune=screen_size_prune,
                                noise=noise)


def opacity_reset(state):
    return trainer.opacity_reset_step(state)


def train_step(state, inputs, bg, kw):
    """``trainer.train_step`` on one view's uploaded inputs."""
    v, gt, amask, inv_gt, dmask = inputs
    return trainer.train_step(state, v, gt, amask, inv_gt, dmask, bg, **kw)


def dp_step(kw):
    """The camera data-parallel step over every rank of the process group
    (``make_dp_train_step`` on a ``data`` axis of the whole world):
    ``(state, inputs, bg) -> (state, aux)``."""
    step = dp_lib.make_dp_train_step(mesh_lib.make_mesh((("data", -1),)),
                                     **kw)

    def run(state, inputs, bg):
        v, gt, amask, inv_gt, dmask = inputs
        return step(state, v, gt, amask, inv_gt, dmask, bg)
    return run


def adam_first_grad_norms(state, exposure: bool = False) -> dict:
    """The norm of each leaf's first gradient, as Adam took it: its first
    moment after one step is (1 - b1) x the gradient; with ``exposure``
    also that of the exposures, as the exposure Adam took it."""
    out = {k: float(torch.linalg.norm(state.adam.mu[k] / 0.1))
           for k in LEAVES}
    if exposure:
        out["exposure"] = float(torch.linalg.norm(
            state.exp_adam.mu["exposure"] / 0.1))
    return out


def params(state) -> dict:
    return gm.trainables(state.gaussians)


def exposures(state) -> torch.Tensor:
    """Every image's exposure affine, (n_images, 3, 4)."""
    return state.exposure


def iteration(state) -> int:
    return state.step


def rows(state) -> dict:
    """Every per-row tensor of a state that a densify event writes, by
    name: the leaves, ``active``, Adam's moments (``mu.<leaf>``,
    ``nu.<leaf>``) and the densification statistics (``xyz_gradient_accum``,
    ``denom``, ``max_radii2d``)."""
    g, a, st = state.gaussians, state.adam, state.stats
    out = {k: getattr(g, k) for k in LEAVES}
    out["active"] = g.active
    out.update({f"mu.{k}": a.mu[k] for k in LEAVES})
    out.update({f"nu.{k}": a.nu[k] for k in LEAVES})
    out.update(xyz_gradient_accum=st.xyz_gradient_accum, denom=st.denom,
               max_radii2d=st.max_radii2d)
    return out
