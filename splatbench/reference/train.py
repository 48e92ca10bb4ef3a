"""The plain reference of a training step of 3D Gaussian Splatting: render
(``raster.render``), the loss (1 - 0.2)·L1 + 0.2·(1 - SSIM) of the 3DGS
code (11-tap Gaussian window, sigma 1.5, zero padding, C1 = 0.01²,
C2 = 0.03², variances clamped at 0), and Adam as the 3DGS code steps it:
per-group rates, the position rate on its exponential schedule scaled by
the scene extent, b1 0.9, b2 0.999, eps 1e-15, bias corrections in float32.

Each view is a ``raster.ViewRecord``; the image is multiplied by its alpha
mask before the loss, as the 3DGS code and the system do (an all-ones mask
changes nothing). A batch of views sums each view's loss and gradients
through ``reduce`` (the identity on one process; an all-reduce over ranks
for camera data parallelism) and divides by the batch. Nothing here
imports the system under test.

The default reference of a configuration (``reference`` absent): its
interface is ``accept``, ``render``, ``Products`` and ``train_steps``, the
last two taking the configuration's step options (``spec.options``). It
implements none of them, and refuses a configuration that turns one on.
"""
from __future__ import annotations

from typing import Callable, List, Sequence

import numpy as np
import torch

from splatbench.reference import raster
from splatbench.reference.raster import Products  # noqa: F401

LAMBDA_DSSIM = 0.2
B1, B2, EPS = 0.9, 0.999, 1e-15
LEAVES = ("xyz", "f_dc", "f_rest", "scaling", "rotation", "opacity")
OPTIONS = frozenset()   # the step options this reference implements


def accept(options: dict, implemented=OPTIONS):
    """Raises where ``options`` (``spec.options``) turns on an option that
    is not ``implemented``: the check never holds the system to
    mathematics the reference does not follow."""
    missing = sorted(k for k, on in options.items()
                     if on and k not in implemented)
    if missing:
        raise ValueError(f"the reference does not implement the step "
                         f"options {missing}")


def render(p: dict, view, W: int, H: int, bg, sh_degree: int,
           prod: raster.Products, *, options: dict = None, **kw):
    """``raster.render`` under the step options ``options`` (all off where
    None): the EWA filter where ``antialiasing`` is on."""
    aa = bool(options and options.get("antialiasing"))
    return raster.render(p, view, W, H, bg, sh_degree, prod,
                         antialiasing=aa, **kw)


def lr_groups(step: int, extent: float, opt: dict) -> dict:
    """Each group's rate at ``step`` (1-based): the position rate
    log-linear from init to final over ``position_lr_max_steps``, scaled by
    the extent; the rest constant, f_rest at feature_lr / 20."""
    t = min(max(step / opt["position_lr_max_steps"], 0.0), 1.0)
    lo, hi = (opt["position_lr_init"] * extent,
              opt["position_lr_final"] * extent)
    return {"xyz": float(np.exp(np.log(lo) * (1 - t) + np.log(hi) * t)),
            "f_dc": opt["feature_lr"], "f_rest": opt["feature_lr"] / 20.0,
            "opacity": opt["opacity_lr"], "scaling": opt["scaling_lr"],
            "rotation": opt["rotation_lr"]}


def ssim(img, gt, prod: raster.Products):
    """Mean SSIM of two (3, H, W) images."""
    xs = np.arange(11, dtype=np.float64)
    g = np.exp(-((xs - 5) ** 2) / (2 * 1.5 ** 2))
    g = torch.tensor(g / g.sum(), dtype=torch.float32, device=img.device)
    w = (g[:, None] * g[None, :]).expand(3, 1, 11, 11).contiguous()

    def blur(x):
        return prod.conv(x[None], w, padding=5, groups=3)[0]

    mu1, mu2 = blur(img), blur(gt)
    s1 = torch.clamp(blur(img * img) - mu1 * mu1, min=0.0)
    s2 = torch.clamp(blur(gt * gt) - mu2 * mu2, min=0.0)
    s12 = blur(img * gt) - mu1 * mu2
    c1, c2 = 0.01 ** 2, 0.03 ** 2
    return (((2 * mu1 * mu2 + c1) * (2 * s12 + c2))
            / ((mu1 * mu1 + mu2 * mu2 + c1) * (s1 + s2 + c2))).mean()


def loss_fn(rec: raster.ViewRecord, prod):
    """``d_image_fn`` for ``raster.render``: (loss of the image times the
    record's alpha mask against its ground truth, its gradient at the
    image, none at the inverse depth)."""
    gt, mask = rec.gt, rec.alpha_mask

    def fn(image, invdepth):
        image = image.detach().requires_grad_()
        with torch.enable_grad():
            shown = image if mask is None else image * mask
            l1 = (shown - gt).abs().mean()
            loss = (1 - LAMBDA_DSSIM) * l1 + LAMBDA_DSSIM * (
                1 - ssim(shown, gt, prod))
            (d,) = torch.autograd.grad(loss, image)
        return loss.detach(), d, None
    return fn


def adam(params: dict, grads: dict, mu: dict, nu: dict, count: int,
         lrs: dict):
    """One Adam step; returns (params, mu, nu)."""
    f32 = np.float32
    b1c = float(f32(1.0) - f32(B1) ** f32(count))
    b2c = float(f32(1.0) - f32(B2) ** f32(count))
    out_p, out_m, out_v = {}, {}, {}
    for k in params:
        g = grads[k]
        m = mu[k] * B1 + g * (1 - B1)
        v = nu[k] * B2 + (g * g) * (1 - B2)
        out_p[k] = params[k] - float(f32(lrs[k])) * (m / b1c) / (
            torch.sqrt(v / b2c) + EPS)
        out_m[k], out_v[k] = m, v
    return out_p, out_m, out_v


def identity(ts: List[torch.Tensor]) -> List[torch.Tensor]:
    return ts


class Steps:
    """What ``train_steps`` read: each step's loss, the first step's
    gradient norm by leaf, the norm of each leaf's change after all
    steps, and the frames' counts (pairs, contributions); with ``stats``
    the densification statistics over the steps' views and the state
    after the steps (``params``, ``mu``, ``nu``)."""

    def __init__(self):
        self.loss: List[float] = []
        self.grad_norm: dict = {}
        self.change_norm: dict = {}
        self.frames: list = []
        self.stats: dict = {}
        self.params: dict = {}
        self.mu: dict = {}
        self.nu: dict = {}


def add_stats(stats: dict, radius, mean2d_grad, W: int, H: int) -> dict:
    """One view's densification statistics added (the 3DGS code's
    ``add_densification_stats``): for every splat with a radius, the norm
    of its screen-space mean's gradient in NDC units (pixels x W/2, H/2),
    a count, and the largest radius."""
    vis = radius > 0
    scale = torch.tensor([0.5 * W, 0.5 * H], device=radius.device)
    g = torch.linalg.norm(mean2d_grad * scale, dim=-1)
    return {"xyz_gradient_accum": stats["xyz_gradient_accum"]
            + torch.where(vis, g, torch.zeros_like(g)),
            "denom": stats["denom"] + vis.float(),
            "max_radii2d": torch.where(
                vis, torch.maximum(stats["max_radii2d"], radius),
                stats["max_radii2d"])}


@raster.full_f32()
def train_steps(p0: dict, batches: Sequence[Sequence[tuple]], *, W: int,
                H: int, bg, sh_degree: int, extent: float, opt: dict,
                first_step: int, prod: raster.Products,
                reduce: Callable = identity, batch: int = 1,
                stats: bool = False, options: dict = None) -> Steps:
    """Train ``len(batches)`` steps from the parameters ``p0`` (left
    unchanged). ``batches[s]`` holds this process's records
    (``raster.ViewRecord``) of step s; with ``reduce`` summing over ranks,
    ``batch`` is the whole batch. Step s is number ``first_step + s + 1``.
    With ``stats`` (one process) it also gathers the densification
    statistics of every view and keeps the state after the steps.
    ``options``: the step options, which ``accept`` has let through."""
    out = Steps()
    params = {k: p0[k].detach().clone() for k in LEAVES}
    mu = {k: torch.zeros_like(v) for k, v in params.items()}
    nu = {k: torch.zeros_like(v) for k, v in params.items()}
    if stats:
        if batch != 1:
            raise ValueError("densification statistics on one process only")
        z = torch.zeros_like(params["opacity"])
        out.stats = {"xyz_gradient_accum": z, "denom": z, "max_radii2d": z}
    for s, views in enumerate(batches):
        leaf = {k: v.requires_grad_() for k, v in params.items()}
        loss = torch.zeros((), device=bg.device)
        grads = {k: torch.zeros_like(v) for k, v in params.items()}
        for rec in views:
            rec = raster.ViewRecord(*rec)
            frame, value, g = render(
                leaf, rec.view, W, H, bg, sh_degree, prod, options=options,
                with_grad=True, d_image_fn=loss_fn(rec, prod),
                mean2d_grad=stats)
            if stats:
                out.stats = add_stats(out.stats, frame.radius, g["mean2d"],
                                      W, H)
            out.frames.append(frame._replace(image=None, invdepth=None,
                                             radius=None, t_final=None))
            loss = loss + value
            for k in grads:
                grads[k] += g[k]
        keys = list(grads)
        summed = reduce([loss[None]] + [grads[k] for k in keys])
        loss = summed[0][0] / batch
        grads = {k: v / batch for k, v in zip(keys, summed[1:])}
        out.loss.append(float(loss))
        if s == 0:
            out.grad_norm = {k: float(torch.linalg.norm(v))
                             for k, v in grads.items()}
        params = {k: v.detach() for k, v in params.items()}
        params, mu, nu = adam(params, grads, mu, nu, s + 1,
                              lr_groups(first_step + s + 1, extent, opt))
    out.change_norm = {k: float(torch.linalg.norm(params[k] - p0[k]))
                       for k in LEAVES}
    if stats:
        out.params, out.mu, out.nu = params, mu, nu
    return out
