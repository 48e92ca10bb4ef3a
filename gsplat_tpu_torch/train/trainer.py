"""One training iteration, and the densify and opacity-reset events.
Counterpart of gsplat_tpu/train/trainer.py.

A step renders one camera, takes the loss (1 − λ)·L1 + λ·(1 − SSIM), plus
the scheduled inverse-depth L1 when asked, differentiates it with
``torch.autograd.grad`` with respect to the trainable fields, the exposure
affines and a zero screen-space tap (whose gradient feeds densification),
accumulates the densification stats, and steps Adam per parameter group
with the scheduled position rate, then the exposure Adam, then the SH
degree warm-up. The step count and the active SH degree are host ints.
Nothing is updated in place: a step returns a new ``TrainState``.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import NamedTuple, Optional

import numpy as np
import torch

from gsplat_tpu_torch.config import OptimizationConfig, RasterizerConfig
from gsplat_tpu_torch.core.camera import CameraView
from gsplat_tpu_torch.core.schedules import expon_lr
from gsplat_tpu_torch.models import gaussian_model as gm
from gsplat_tpu_torch.ops import losses
from gsplat_tpu_torch.ops.rasterize import render
from gsplat_tpu_torch.train import densify as densify_lib
from gsplat_tpu_torch.train import optim


@dataclass
class TrainState:
    gaussians: gm.GaussianParams
    adam: optim.AdamState
    exposure: torch.Tensor          # (n_images, 3, 4)
    exp_adam: optim.AdamState
    stats: densify_lib.DensifyStats
    step: int


class StepAux(NamedTuple):
    loss: torch.Tensor
    l1: torch.Tensor
    depth_l1: torch.Tensor
    num_pairs: torch.Tensor
    overflow: torch.Tensor
    radii: torch.Tensor
    num_padded: torch.Tensor


def init_state(gaussians: gm.GaussianParams, n_images: int) -> TrainState:
    dev = gaussians.device
    exposure = torch.eye(3, 4, device=dev)[None].repeat(max(n_images, 1),
                                                         1, 1)
    return TrainState(
        gaussians=gaussians, adam=optim.init(gm.trainables(gaussians)),
        exposure=exposure, exp_adam=optim.init({"exposure": exposure}),
        stats=densify_lib.init_stats(gaussians.capacity, dev), step=0)


def state_from_numpy(arrays: dict, *, device="cuda") -> TrainState:
    """A training state from numpy arrays, so that the port can take a step
    from the same state as the JAX package: ``arrays`` has the keys of a
    JAX ``TrainState`` (``gaussians``: its fields; ``adam`` and
    ``exp_adam``: ``mu`` and ``nu`` dicts and ``count``; ``exposure``;
    ``stats``: the three ``DensifyStats`` fields; ``step``)."""
    g = gm.from_numpy(arrays["gaussians"], device=device)
    dev = g.device

    def t(a):
        return torch.tensor(np.asarray(a, np.float32), device=dev)

    def adam(a):
        return optim.AdamState(mu={k: t(v) for k, v in a["mu"].items()},
                               nu={k: t(v) for k, v in a["nu"].items()},
                               count=int(a["count"]))

    st = arrays["stats"]
    return TrainState(
        gaussians=g, adam=adam(arrays["adam"]), exposure=t(arrays["exposure"]),
        exp_adam=adam(arrays["exp_adam"]),
        stats=densify_lib.DensifyStats(**{
            k: t(st[k]) for k in ("xyz_gradient_accum", "denom",
                                  "max_radii2d")}),
        step=int(arrays["step"]))


def _lr_dict(opt: OptimizationConfig, step: int,
             spatial_lr_scale: float) -> dict:
    """Per-group rates: xyz follows the exponential schedule, the rest are
    constant."""
    return {
        "xyz": expon_lr(step, opt.position_lr_init * spatial_lr_scale,
                        opt.position_lr_final * spatial_lr_scale,
                        lr_delay_mult=opt.position_lr_delay_mult,
                        max_steps=opt.position_lr_max_steps),
        "f_dc": opt.feature_lr,
        "f_rest": opt.feature_lr / 20.0,
        "opacity": opt.opacity_lr,
        "scaling": opt.scaling_lr,
        "rotation": opt.rotation_lr,
    }


def camera_loss_grads(g: gm.GaussianParams, exposure_all: torch.Tensor,
                      cam: CameraView, gt_image, alpha_mask, invdepth_gt,
                      depth_mask, bg_color, step: int, *, image_width: int,
                      image_height: int, opt: OptimizationConfig,
                      rcfg: RasterizerConfig, antialiasing: bool,
                      train_test_exp: bool, use_depth: bool):
    """Loss and gradients for one camera. Returns (loss, l1, depth_l1,
    render output, grads by trainable field, exposure grads, tap grad)."""
    depth_w = expon_lr(step, opt.depth_l1_weight_init,
                       opt.depth_l1_weight_final, max_steps=opt.iterations)
    params = {k: v.detach().requires_grad_()
              for k, v in gm.trainables(g).items()}
    exposure_all = exposure_all.detach().requires_grad_()
    tap = torch.zeros((g.capacity, 2), device=g.device, requires_grad=True)
    exposure = None
    if train_test_exp:
        # cameras without an exposure mapping get the identity affine
        exposure = exposure_all[cam.exposure_idx] if cam.exposure_idx >= 0 \
            else torch.eye(3, 4, device=g.device)
    out = render(gm.with_trainables(g, params), cam, image_width,
                 image_height, bg_color, rcfg, antialiasing=antialiasing,
                 mean2d_tap=tap, exposure=exposure)
    image = out.image * alpha_mask
    l1 = losses.l1_loss(image, gt_image)
    ssim_v = losses.fast_ssim(image, gt_image)
    loss = (1.0 - opt.lambda_dssim) * l1 + opt.lambda_dssim * (1.0 - ssim_v)
    dl1 = ((out.invdepth - invdepth_gt) * depth_mask).abs().mean()
    if use_depth and depth_w > 0:
        loss = loss + depth_w * dl1
    inputs = [*params.values(), exposure_all, tap]
    got = torch.autograd.grad(loss, inputs, allow_unused=True)
    got = [torch.zeros_like(x) if d is None else d
           for x, d in zip(inputs, got)]
    grads = dict(zip(params, got[:len(params)]))
    return (loss.detach(), l1.detach(), dl1.detach(), out, grads, got[-2],
            got[-1])


def finish_train_step(state: TrainState, grads: dict, exp_grads, stats,
                      stepc: int, vis: Optional[torch.Tensor], *,
                      opt: OptimizationConfig,
                      spatial_lr_scale: float) -> TrainState:
    """The post-render half of an iteration: mask the gradients of dead
    slots, per-group scheduled Adam (visibility-masked if ``vis``), the
    exposure Adam, the SH degree warm-up every 1000 steps."""
    g = state.gaussians
    act = g.active.to(torch.float32)
    grads = {k: v * act.reshape((-1,) + (1,) * (v.dim() - 1))
             for k, v in grads.items()}
    new_trainables, adam = optim.apply_updates(
        gm.trainables(g), grads, state.adam,
        _lr_dict(opt, stepc, spatial_lr_scale), visibility_mask=vis)
    exp_lr = expon_lr(stepc, opt.exposure_lr_init, opt.exposure_lr_final,
                      lr_delay_steps=opt.exposure_lr_delay_steps,
                      lr_delay_mult=opt.exposure_lr_delay_mult,
                      max_steps=opt.iterations)
    new_exp, exp_adam = optim.apply_updates(
        {"exposure": state.exposure}, {"exposure": exp_grads},
        state.exp_adam, {"exposure": exp_lr})
    g2 = gm.with_trainables(g, new_trainables)
    if stepc % 1000 == 0 and g2.active_sh_degree < g.max_sh_degree:
        g2 = g2.one_up_sh_degree()
    return TrainState(gaussians=g2, adam=adam, exposure=new_exp["exposure"],
                      exp_adam=exp_adam, stats=stats, step=stepc)


def train_step(state: TrainState, cam: CameraView, gt_image: torch.Tensor,
               alpha_mask: torch.Tensor, invdepth_gt: torch.Tensor,
               depth_mask: torch.Tensor, bg_color: torch.Tensor, *,
               image_width: int, image_height: int, opt: OptimizationConfig,
               rcfg: RasterizerConfig, spatial_lr_scale: float,
               antialiasing: bool, use_sparse_adam: bool,
               train_test_exp: bool, use_depth: bool):
    """One optimization iteration. gt_image (3,H,W); alpha_mask,
    invdepth_gt, depth_mask (1,H,W); bg_color (3,). Returns (new state,
    StepAux)."""
    step = state.step + 1          # the reference's iterations are 1-based
    loss, l1, dl1, out, grads, exp_grads, tap_grad = camera_loss_grads(
        state.gaussians, state.exposure, cam, gt_image, alpha_mask,
        invdepth_gt, depth_mask, bg_color, step, image_width=image_width,
        image_height=image_height, opt=opt, rcfg=rcfg,
        antialiasing=antialiasing, train_test_exp=train_test_exp,
        use_depth=use_depth)
    stats = state.stats
    if step < opt.densify_until_iter:
        stats = densify_lib.add_densification_stats(
            stats, out.radii.detach(), tap_grad)
    vis = (out.radii > 0) if use_sparse_adam else None
    new_state = finish_train_step(state, grads, exp_grads, stats, step, vis,
                                  opt=opt, spatial_lr_scale=spatial_lr_scale)
    aux = StepAux(loss=loss, l1=l1, depth_l1=dl1, num_pairs=out.num_pairs,
                  overflow=out.overflow, radii=out.radii.detach(),
                  num_padded=out.num_padded)
    return new_state, aux


def densify_step(state: TrainState, generator: Optional[torch.Generator],
                 extent: float, *, opt: OptimizationConfig,
                 use_screen_size_prune: bool, noise=None):
    """One densify + prune event. Returns (new state, overflow)."""
    g, adam, stats, overflow = densify_lib.densify_and_prune(
        state.gaussians, state.adam, state.stats, generator,
        max_grad=opt.densify_grad_threshold, min_opacity=0.005,
        extent=extent, percent_dense=opt.percent_dense,
        use_screen_size_prune=use_screen_size_prune, noise=noise)
    return dataclasses.replace(state, gaussians=g, adam=adam,
                               stats=stats), overflow


def opacity_reset_step(state: TrainState) -> TrainState:
    g, adam = densify_lib.reset_opacity(state.gaussians, state.adam)
    return dataclasses.replace(state, gaussians=g, adam=adam)
