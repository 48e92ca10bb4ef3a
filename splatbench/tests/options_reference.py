"""A plain reference that follows every step option of the system's
training step, for a configuration that turns them on (its
``reference``): the EWA filter (``antialiasing``); the inverse-depth L1
of the frame against the view's inverse depth under its depth mask, at a
weight log-linear from ``depth_l1_weight_init`` to
``depth_l1_weight_final`` over ``iterations`` (``use_depth``); one 3 x 4
exposure affine a pose, applied to the raw image before the clamp, with an
Adam of its own at a rate log-linear from ``exposure_lr_init`` to
``exposure_lr_final`` over ``iterations`` (``train_test_exp``); and Adam
that moves a splat's parameters and moments only where the step's view
gave it a radius (``sparse_adam``, under the system's rule: every splat
past the near plane with a positive determinant). The image is multiplied
by the view's alpha mask before the loss. Where the configuration's
``optimization`` block gives no value, the 3DGS code's default stands.

It is the default reference's renderer, loss and Adam (``raster``,
``train``) with these added, and imports nothing of the system under
test. The benchmark's tests copy it into a checkout's
``splatbench/reference/`` and name it in a configuration.
"""
from __future__ import annotations

from typing import Callable, Sequence

import numpy as np
import torch

from splatbench.reference import raster, train
from splatbench.reference.train import LEAVES, Products, render  # noqa: F401

OPTIONS = frozenset({"antialiasing", "sparse_adam", "train_test_exp",
                     "use_depth"})
DEFAULTS = dict(depth_l1_weight_init=1.0, depth_l1_weight_final=0.01,
                exposure_lr_init=0.01, exposure_lr_final=0.001,
                iterations=30_000)


def accept(options: dict):
    train.accept(options, OPTIONS)


def log_linear(step: int, init: float, final: float, steps: int) -> float:
    t = min(max(step / steps, 0.0), 1.0)
    return float(np.exp(np.log(init) * (1 - t) + np.log(final) * t))


def depth_weight(step: int, opt: dict) -> float:
    o = dict(DEFAULTS, **opt)
    return log_linear(step, o["depth_l1_weight_init"],
                      o["depth_l1_weight_final"], o["iterations"])


def exposure_lr(step: int, opt: dict) -> float:
    o = dict(DEFAULTS, **opt)
    return log_linear(step, o["exposure_lr_init"], o["exposure_lr_final"],
                      o["iterations"])


def masked(image, rec: raster.ViewRecord):
    """The image as the loss sees it: times the view's alpha mask."""
    return image * rec.alpha_mask


def loss_fn(rec: raster.ViewRecord, prod, depth_w: float):
    """``d_image_fn`` for ``raster.render``: (the loss, its gradient at the
    image, its gradient at the inverse depth or None)."""
    def fn(image, invdepth):
        image = image.detach().requires_grad_()
        inv = invdepth.detach().requires_grad_()
        with torch.enable_grad():
            shown = masked(image, rec)
            l1 = (shown - rec.gt).abs().mean()
            loss = (1 - train.LAMBDA_DSSIM) * l1 + train.LAMBDA_DSSIM * (
                1 - train.ssim(shown, rec.gt, prod))
            if depth_w > 0 and rec.invdepth is not None:
                loss = loss + depth_w * (
                    (inv - rec.invdepth) * rec.depth_mask).abs().mean()
            d_img, d_inv = torch.autograd.grad(loss, (image, inv),
                                               allow_unused=True)
        return loss.detach(), d_img, d_inv
    return fn


def keep_hidden(new: dict, old: dict, vis: torch.Tensor) -> dict:
    """``new`` on the rows ``vis``, ``old`` elsewhere."""
    return {k: torch.where(vis.reshape((-1,) + (1,) * (v.dim() - 1)), v,
                           old[k]) for k, v in new.items()}


@raster.full_f32()
def train_steps(p0: dict, batches: Sequence[Sequence[tuple]], *, W: int,
                H: int, bg, sh_degree: int, extent: float, opt: dict,
                first_step: int, prod: raster.Products,
                reduce: Callable = train.identity, batch: int = 1,
                stats: bool = False, options: dict = None) -> train.Steps:
    """``train.train_steps`` under the step options: the readings also
    hold ``exposure`` (the first gradient of every pose's exposure, and
    their change) where ``train_test_exp`` is on, and the state after the
    steps (``params``, ``mu``, ``nu``). No densification statistics."""
    if stats:
        raise ValueError("this reference gathers no densification "
                         "statistics")
    options = options or {}
    use_exp = options.get("train_test_exp", False)
    out = train.Steps()
    params = {k: p0[k].detach().clone() for k in LEAVES}
    mu = {k: torch.zeros_like(v) for k, v in params.items()}
    nu = {k: torch.zeros_like(v) for k, v in params.items()}
    # the exposures of the poses the steps visit: every other pose's stays
    # the identity under its Adam, with zero moments and gradients
    slot = {i: j for j, i in enumerate(sorted(
        {raster.ViewRecord(*r).pose for views in batches for r in views}))}
    exp0 = torch.eye(3, 4, device=bg.device).repeat(len(slot), 1, 1)
    exp = {"exposure": exp0.clone()}
    emu = {"exposure": torch.zeros_like(exp0)}
    enu = {"exposure": torch.zeros_like(exp0)}
    n = params["opacity"].shape[0]
    for s, views in enumerate(batches):
        step = first_step + s + 1
        depth_w = depth_weight(step, opt) if options.get("use_depth") else 0.0
        leaf = {k: v.requires_grad_() for k, v in params.items()}
        loss = torch.zeros((), device=bg.device)
        grads = {k: torch.zeros_like(v) for k, v in params.items()}
        exp_grad = torch.zeros_like(exp0)
        seen = torch.zeros(n, device=bg.device)
        for rec in views:
            rec = raster.ViewRecord(*rec)
            kw = dict(exposure=exp["exposure"][slot[rec.pose]]) \
                if use_exp else {}
            frame, value, g = render(
                leaf, rec.view, W, H, bg, sh_degree, prod, options=options,
                with_grad=True, d_image_fn=loss_fn(rec, prod, depth_w), **kw)
            out.frames.append(frame._replace(image=None, invdepth=None,
                                             radius=None, t_final=None))
            loss = loss + value
            for k in grads:
                grads[k] += g[k]
            if use_exp:
                exp_grad[slot[rec.pose]] += g["exposure"]
            seen += (frame.radius > 0).float()
        keys = list(grads)
        summed = reduce([loss[None]] + [grads[k] for k in keys]
                        + [exp_grad, seen])
        loss = summed[0][0] / batch
        grads = {k: v / batch for k, v in zip(keys, summed[1:-2])}
        exp_grad = summed[-2] / batch
        out.loss.append(float(loss))
        if s == 0:
            out.grad_norm = {k: float(torch.linalg.norm(v))
                             for k, v in grads.items()}
            if use_exp:
                out.grad_norm["exposure"] = float(torch.linalg.norm(exp_grad))
        old = ({k: v.detach() for k, v in params.items()}, mu, nu)
        new = train.adam(old[0], grads, mu, nu, s + 1,
                         train.lr_groups(step, extent, opt))
        if options.get("sparse_adam"):
            new = tuple(keep_hidden(a, b, summed[-1] > 0)
                        for a, b in zip(new, old))
        params, mu, nu = new
        if use_exp:
            exp, emu, enu = train.adam(exp, {"exposure": exp_grad}, emu, enu,
                                       s + 1,
                                       {"exposure": exposure_lr(step, opt)})
    out.change_norm = {k: float(torch.linalg.norm(params[k] - p0[k]))
                       for k in LEAVES}
    if use_exp:
        out.change_norm["exposure"] = float(torch.linalg.norm(
            exp["exposure"] - exp0))
    out.params, out.mu, out.nu = params, mu, nu
    return out
