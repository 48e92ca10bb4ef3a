"""Adam with per-group learning rates and an optional visibility mask.
Counterpart of gsplat_tpu/train/optim.py, in its formula exactly:

    mu = b1 mu + (1 - b1) g,   nu = b2 nu + (1 - b2) g²,
    p -= lr (mu / b1c) / (sqrt(nu / b2c) + eps),  b{1,2}c = 1 - b{1,2}^count

with eps = 1e-15 (the reference's) and the bias corrections in float32.
``torch.optim.Adam`` groups these terms differently, so it is not used.
With a visibility mask, masked-out rows keep their parameters and moments
(the reference's sparse Adam); the step count stays global.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional

import numpy as np
import torch


@dataclass
class AdamState:
    mu: dict     # first moments, keyed like the parameters
    nu: dict     # second moments
    count: int   # steps taken


def init(params: dict) -> AdamState:
    return AdamState(mu={k: torch.zeros_like(v) for k, v in params.items()},
                     nu={k: torch.zeros_like(v) for k, v in params.items()},
                     count=0)


def apply_updates(params: dict, grads: dict, state: AdamState,
                  lrs: Dict[str, float], *, b1: float = 0.9,
                  b2: float = 0.999, eps: float = 1e-15,
                  visibility_mask: Optional[torch.Tensor] = None):
    """One Adam step. Returns (new params, new state); nothing is updated
    in place."""
    count = state.count + 1
    f32 = np.float32
    b1c = float(f32(1.0) - f32(b1) ** f32(count))
    b2c = float(f32(1.0) - f32(b2) ** f32(count))

    new_params, new_mu, new_nu = {}, {}, {}
    for k in params:
        g = grads[k]
        mu = state.mu[k] * b1 + g * (1 - b1)
        nu = state.nu[k] * b2 + (g * g) * (1 - b2)
        lr = float(f32(lrs[k]))
        update = lr * (mu / b1c) / (torch.sqrt(nu / b2c) + eps)
        if visibility_mask is not None:
            vis = visibility_mask.reshape((-1,) + (1,) * (g.dim() - 1)).to(
                g.dtype)
            mu = state.mu[k] * (1 - vis) + mu * vis
            nu = state.nu[k] * (1 - vis) + nu * vis
            update = update * vis
        new_params[k] = params[k] - update
        new_mu[k] = mu
        new_nu[k] = nu
    return new_params, AdamState(mu=new_mu, nu=new_nu, count=count)
