"""The system under test, ``gsplat_tpu_torch``, as the benchmark drives it:
the one module of the benchmark that imports it. Everything here calls the
system's own entry points with the benchmark's inputs, as its training loop
and renderer call them: ``train/trainer.py:train_step``,
``parallel/dp.py:make_dp_train_step`` and ``camera_inputs``,
``ops/rasterize.py:render``, ``scene/cameras.py:Camera``.
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


def gaussians(p: dict, sh_degree: int) -> gm.GaussianParams:
    """The system's splats from the benchmark's parameters, all live."""
    n = p["xyz"].shape[0]
    return gm.GaussianParams(
        **{k: p[k] for k in LEAVES},
        active=torch.ones(n, dtype=torch.bool, device=p["xyz"].device),
        active_sh_degree=sh_degree)


def init_state(p: dict, sh_degree: int, first_step: int):
    """A training state at iteration ``first_step`` with fresh moments."""
    return dataclasses.replace(
        trainer.init_state(gaussians(p, sh_degree), 1), step=first_step)


def camera(i: int, pose, fov, image: np.ndarray) -> Camera:
    """A scene camera as the system's loader makes one: the host image
    (3,H,W) in [0,1], an all-ones alpha mask, no depth."""
    (R, T), (fovx, fovy) = pose, fov
    H, W = image.shape[1:]
    return Camera(uid=i, colmap_id=i, R=R, T=T, FoVx=fovx, FoVy=fovy,
                  image=image, alpha_mask=np.ones((1, H, W), np.float32),
                  invdepthmap=None, depth_mask=None, depth_reliable=False,
                  image_name=f"{i:05d}", width=W, height=H)


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


def frame(g, cam_view, W, H, bg, rcfg):
    """One viewer frame: ``render`` without gradients."""
    with torch.no_grad():
        return render(g, cam_view, W, H, bg, rcfg)


def right_size(g, views, W, H, bg, first_ppg: float):
    """bench.py's arithmetic over every view: the frames at ``first_ppg``
    pairs a gaussian, doubled until none overflows, then 1.3x the largest
    pair count (at least 2 a gaussian) and 1.5x the largest alignment
    padding (at least one chunk). Returns (config, largest pairs)."""
    rcfg = rasterizer(first_ppg)
    while True:
        outs = [frame(g, v, W, H, bg, rcfg) for v in views]
        if not any(int(o.overflow) for o in outs):
            break
        rcfg = rasterizer(2 * rcfg.pairs_per_gaussian)
    pairs = max(int(o.num_pairs) for o in outs)
    pad = max(int(o.num_padded) - int(o.num_pairs) for o in outs)
    n = g.capacity
    return (dataclasses.replace(
        rcfg, pairs_per_gaussian=max(pairs * 1.3 / n, 2.0),
        pad_cap=max(rcfg.chunk, int(pad * 1.5))), pairs)


def step_kw(W, H, rcfg, extent):
    """The loop's step arguments: default optimisation, no depth, no
    exposure, dense Adam, no antialiasing."""
    return dict(image_width=W, image_height=H, opt=OptimizationConfig(),
                rcfg=rcfg, spatial_lr_scale=extent, antialiasing=False,
                use_sparse_adam=False, train_test_exp=False, use_depth=False)


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


def adam_first_grad_norms(state) -> dict:
    """The norm of each leaf's first gradient, as Adam took it: its first
    moment after one step is (1 - b1) x the gradient."""
    return {k: float(torch.linalg.norm(state.adam.mu[k] / 0.1))
            for k in LEAVES}


def params(state) -> dict:
    return gm.trainables(state.gaussians)
