"""Learning-rate schedules. Counterpart of gsplat_tpu/core/schedules.py.

The port keeps the step on the host, so a schedule is a function of a
Python int that returns a Python float. It is evaluated in float32, in the
JAX package's order of operations, so both packages give the same rate.
"""
from __future__ import annotations

import numpy as np


def expon_lr(step, lr_init: float, lr_final: float, lr_delay_steps: int = 0,
             lr_delay_mult: float = 1.0, max_steps: int = 1_000_000) -> float:
    """Log-linear interpolation from lr_init to lr_final with a sine-eased
    delay. Returns 0 for step < 0, or when both endpoints are 0."""
    f32 = np.float32
    if lr_init == 0.0 and lr_final == 0.0:
        return 0.0
    s = f32(step)
    if lr_delay_steps > 0:
        delay_rate = f32(lr_delay_mult) + f32(1 - lr_delay_mult) * np.sin(
            f32(0.5 * np.pi) * np.clip(s / f32(lr_delay_steps), f32(0),
                                       f32(1)))
    else:
        delay_rate = f32(1.0)
    t = np.clip(s / f32(max_steps), f32(0), f32(1))
    log_lerp = np.exp(np.log(f32(lr_init)) * (f32(1) - t)
                      + np.log(f32(lr_final)) * t)
    return 0.0 if s < 0 else float(f32(delay_rate * log_lerp))
