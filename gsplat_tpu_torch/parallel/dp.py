"""Camera data-parallel training step over the ranks of a mesh axis.
Counterpart of gsplat_tpu/parallel/dp.py.

Each rank renders ONE camera of a per-step batch against the whole gaussian
set, which every rank holds alike. The gradients, the exposure gradients,
loss, l1, depth l1 and the densification increments of the rank's view are
packed into one flat buffer and summed over the ``data`` axis in ONE
all-reduce; the gradients and scalars are divided by the batch after the
sum, as JAX's ``psum(v) / n``. Radii, pair count, overflow and padded
extent take their maximum in one more all-reduce. Then every rank runs the
same Adam update on the same values, so the states stay equal bit for bit.
Densification statistics accumulate across the batch: grad-norm sums and
visit counts sum, the max radius takes the max, the reference's "averaged
over the views where the gaussian was visible" at batch size = axis size.
"""
from __future__ import annotations

import types
from typing import NamedTuple, Sequence

import numpy as np
import torch

from gsplat_tpu_torch.config import OptimizationConfig, RasterizerConfig
from gsplat_tpu_torch.core.camera import FIELDS as CAM_FIELDS
from gsplat_tpu_torch.core.camera import CameraView
from gsplat_tpu_torch.parallel import pmax, psum
from gsplat_tpu_torch.train import densify as densify_lib
from gsplat_tpu_torch.train import trainer


def camera_inputs(cam, device):
    """(view, gt, alpha_mask, invdepth_gt, depth_mask) of a scene camera,
    on ``device``: what one step takes. Zero depth maps where the camera
    has no reliable one."""
    H, W = cam.height, cam.width
    if cam.invdepthmap is not None and cam.depth_reliable:
        inv_gt, dmask = cam.invdepthmap, cam.depth_mask
    else:
        inv_gt = np.zeros((1, H, W), np.float32)
        dmask = np.zeros((1, H, W), np.float32)
    return (cam.view(device),
            *(torch.tensor(a, dtype=torch.float32, device=device)
              for a in (cam.image, cam.alpha_mask, inv_gt, dmask)))


def stack_camera_batch(cams: Sequence, device):
    """A batch of scene cameras stacked on a leading axis, as JAX's
    ``stack_camera_batch`` stacks views, in host arrays: (the views'
    fields, made on ``device``, as a namespace of (B, ...) arrays; (gt,
    alpha_mask, invdepth_gt, depth_mask), each (B, C, H, W)). What a
    ``--debug`` snapshot of a batch holds; a step takes one rank's camera
    from :func:`camera_inputs`."""
    rows = [camera_inputs(c, device) for c in cams]
    view = types.SimpleNamespace(**{
        k: np.stack([np.asarray(getattr(r[0], k)) if k == "exposure_idx"
                     else getattr(r[0], k).cpu().numpy() for r in rows])
        for k in CAM_FIELDS})
    images = tuple(np.stack([r[i].cpu().numpy() for r in rows])
                   for i in range(1, 5))
    return view, images


class BatchSums(NamedTuple):
    """A view's step values reduced over the batch."""
    loss: torch.Tensor
    l1: torch.Tensor
    depth_l1: torch.Tensor
    grads: dict
    exp_grads: torch.Tensor
    accum_inc: torch.Tensor     # Σ over views of the visible grad norms
    denom_inc: torch.Tensor     # Σ over views of the visits
    radii: torch.Tensor         # max over views
    num_pairs: torch.Tensor     # max over views
    overflow: torch.Tensor
    num_padded: torch.Tensor


def reduce_views(mesh, axis: str, loss, l1, dl1, grads: dict, exp_grads,
                 tap_grad, radii, num_pairs, overflow, num_padded
                 ) -> BatchSums:
    """One view's step values reduced over ``axis``: two all-reduces, one
    flat sum and one flat max. The means divide after the sum. The view's
    screen-space tap gradient is its own, unscaled by the batch."""
    n = mesh.shape[axis]
    vis = radii > 0
    gnorm = torch.linalg.norm(tap_grad[:, :2], dim=-1)
    names = list(grads)
    summed = psum([*(grads[k] for k in names), exp_grads, loss, l1, dl1,
                   torch.where(vis, gnorm, 0.0), vis.float()], mesh, axis)
    radii_max, pairs, ovf, padded = pmax([radii, num_pairs, overflow,
                                          num_padded], mesh, axis)
    k = len(names)
    return BatchSums(
        loss=summed[k + 1] / n, l1=summed[k + 2] / n,
        depth_l1=summed[k + 3] / n,
        grads={name: g / n for name, g in zip(names, summed[:k])},
        exp_grads=summed[k] / n, accum_inc=summed[k + 4],
        denom_inc=summed[k + 5], radii=radii_max, num_pairs=pairs,
        overflow=ovf, num_padded=padded)


def finish_batch_step(state: "trainer.TrainState", r: BatchSums, stepc: int,
                      *, opt: OptimizationConfig, spatial_lr_scale: float,
                      use_sparse_adam: bool):
    """The post-render half of a DP step on every rank alike: the batch's
    densification statistics (only before ``densify_until_iter``), the
    visibility of any view for sparse Adam, ``trainer.finish_train_step``.
    Returns (new state, StepAux)."""
    stats = state.stats
    if stepc < opt.densify_until_iter:
        stats = densify_lib.DensifyStats(
            xyz_gradient_accum=stats.xyz_gradient_accum + r.accum_inc,
            denom=stats.denom + r.denom_inc,
            max_radii2d=torch.maximum(stats.max_radii2d, r.radii))
    vis_any = (r.denom_inc > 0) if use_sparse_adam else None
    new_state = trainer.finish_train_step(
        state, r.grads, r.exp_grads, stats, stepc, vis_any, opt=opt,
        spatial_lr_scale=spatial_lr_scale)
    aux = trainer.StepAux(loss=r.loss, l1=r.l1, depth_l1=r.depth_l1,
                          num_pairs=r.num_pairs, overflow=r.overflow,
                          radii=r.radii, num_padded=r.num_padded)
    return new_state, aux


def make_dp_train_step(mesh, *, image_width: int, image_height: int,
                       opt: OptimizationConfig, rcfg: RasterizerConfig,
                       spatial_lr_scale: float, antialiasing: bool = False,
                       use_sparse_adam: bool = False,
                       train_test_exp: bool = False, use_depth: bool = False,
                       axis: str = "data", loss_grads=None):
    """Build the DP step: (state, cam, gt, alpha_mask, invdepth_gt,
    depth_mask, bg) -> (state, StepAux), where ``cam`` and the images are
    THIS rank's row of the batch and the state is the same on every rank.
    ``loss_grads`` computes the rank's view, with the signature and results
    of ``trainer.camera_loss_grads`` (the default); the 2-D step passes the
    sharded render's (``parallel/sharded.py``). On a mesh of one rank the
    default step is ``trainer.train_step`` bit for bit."""
    loss_grads = loss_grads or trainer.camera_loss_grads

    def step(state: "trainer.TrainState", cam: CameraView, gt_image,
             alpha_mask, invdepth_gt, depth_mask, bg):
        stepc = state.step + 1
        loss, l1, dl1, out, grads, exp_grads, tap_grad = loss_grads(
            state.gaussians, state.exposure, cam, gt_image, alpha_mask,
            invdepth_gt, depth_mask, bg, stepc, image_width=image_width,
            image_height=image_height, opt=opt, rcfg=rcfg,
            antialiasing=antialiasing, train_test_exp=train_test_exp,
            use_depth=use_depth)
        r = reduce_views(mesh, axis, loss, l1, dl1, grads, exp_grads,
                         tap_grad, out.radii.detach(), out.num_pairs,
                         out.overflow, out.num_padded)
        return finish_batch_step(state, r, stepc, opt=opt,
                                 spatial_lr_scale=spatial_lr_scale,
                                 use_sparse_adam=use_sparse_adam)

    return step
