"""Rendering split over depth slabs (``prim_shard``) or bands of tile rows
(``tile_shard``). Counterpart of gsplat_tpu/parallel/, where each slab or
band is one chip of a mesh. Here the parts run one after another on the one
device the gaussians lie on, with the arithmetic of each part, the
exclusive transmittance product and the ordered merge exactly as there.
"""
from __future__ import annotations

from typing import Sequence

import torch


def gather_parts(parts: Sequence[torch.Tensor]) -> torch.Tensor:
    """(K, ...) from the K parts' equal-shaped results, in part order: what
    an all-gather over the parts' axis returns to every part. The parts of
    one device are a local list, so this stacks it; one rank per card
    (``torch.distributed``) would change this function and nothing else."""
    return torch.stack(list(parts), dim=0)
