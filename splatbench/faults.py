"""Faults planted in the system under test, to show that the check fails
them (``splatbench/tests``) and to read the numbers they give on the card
when the limits are set (``splatbench.calibrate``). A benchmark run never
plants one. Each ``plant_<name>()`` patches the system in this process; a
fault that a configuration brings is a module of its own,
``splatbench/plants/<name>.py``, with a ``plant()``.
"""
from __future__ import annotations

from pathlib import Path

import torch


def plant_unchanged():
    """A training step that returns its state unchanged."""
    from splatbench import program
    real_train, real_dp = program.train_step, program.dp_step

    def train_step(state, inputs, bg, kw):
        return state, real_train(state, inputs, bg, kw)[1]

    def dp_step(kw):
        step = real_dp(kw)
        return lambda state, inputs, bg: (state, step(state, inputs, bg)[1])
    program.train_step, program.dp_step = train_step, dp_step


def plant_half_batch():
    """Half of the batch left out, the mean taken over the rest: on one
    view the loss over the top half of the image's rows; over ranks, the
    views of the upper half of the ranks left out of the sums."""
    import torch.distributed as dist

    from gsplat_tpu_torch.ops import losses
    from gsplat_tpu_torch.parallel import dp
    if dist.is_available() and dist.is_initialized():
        real = dp.psum
        n = dist.get_world_size()
        keep = 2.0 if dist.get_rank() < n // 2 else 0.0

        def psum(tensors, mesh, axis):
            return real([t * keep if t.is_floating_point() else t
                         for t in tensors], mesh, axis)
        dp.psum = psum
        return
    l1, ssim = losses.l1_loss, losses.fast_ssim

    def top(x):
        return x[..., :x.shape[-2] // 2, :]
    losses.l1_loss = lambda a, b: l1(top(a), top(b))
    losses.fast_ssim = lambda a, b, *k: ssim(top(a), top(b), *k)


def plant_no_exchange():
    """The exchange between cards left out: each rank keeps its own view's
    sums and maxima."""
    from gsplat_tpu_torch.parallel import dp
    dp.psum = lambda tensors, mesh, axis: list(tensors)
    dp.pmax = lambda tensors, mesh, axis: list(tensors)


def plant_frame_altered():
    """A frame altered where it is produced: one 32 x 32 block of its
    colours raised by 0.05."""
    from splatbench import program
    real = program.frame

    def frame(*a, **k):
        out = real(*a, **k)
        img = out.image.clone()
        img[:, :32, :32] = torch.clamp(img[:, :32, :32] + 0.05, 0.0, 1.0)
        return out._replace(image=img)
    program.frame = frame


def plant_half_frame():
    """Half of a frame left out: its lower half of rows black."""
    from splatbench import program
    real = program.frame

    def frame(*a, **k):
        out = real(*a, **k)
        img = out.image.clone()
        img[:, img.shape[1] // 2:] = 0.0
        return out._replace(image=img)
    program.frame = frame


def plant_no_prune():
    """A densify event that prunes nothing."""
    from gsplat_tpu_torch.train import densify
    real = densify.densify_and_prune

    def densify_and_prune(*a, **k):
        return real(*a, **dict(k, min_opacity=0.0,
                               use_screen_size_prune=False))
    densify.densify_and_prune = densify_and_prune


def plant_split_unscaled():
    """A split whose children keep their parent's scales (no 1/1.6)."""
    from gsplat_tpu_torch.train import densify

    class Torch:
        def __getattr__(self, name):
            return getattr(torch, name)

        @staticmethod
        def log(x):
            return torch.log(x * 1.6)
    densify.torch = Torch()


def plant_stats_shifted():
    """A view's densification statistics added to the wrong rows: each
    row's to the next row's."""
    from gsplat_tpu_torch.train import densify
    real = densify.add_densification_stats

    def add_densification_stats(stats, radii, mean2d_grad):
        return real(stats, radii.roll(1, 0), mean2d_grad.roll(1, 0))
    densify.add_densification_stats = add_densification_stats


def plant(name: str, root: Path = None):
    """Plants the fault ``name``: ``plant_<name>`` here, else the module
    ``splatbench/plants/<name>.py`` of the checkout at ``root``."""
    fn = globals().get(f"plant_{name}")
    if fn is None:
        from splatbench import spec
        fn = spec.module("plants", name,
                         spec.ROOT if root is None else root).plant
    fn()
