"""Rendering split over depth slabs (``prim_shard``), bands of tile rows
(``tile_shard``) or row shards of the gaussians' storage (``sharded``).
Counterpart of gsplat_tpu/parallel/, where each slab, band or shard is one
chip of a mesh. Here the parts run one after another on the one device the
gaussians lie on, with the arithmetic of each part, the exclusive
transmittance product, the ordered merge and the ring's order exactly as
there. What a mesh does with a collective stands in the three helpers
below; one rank per card (``torch.distributed``) would change them and
nothing else.
"""
from __future__ import annotations

from typing import Callable, List, Sequence

import torch


def gather_parts(parts: Sequence[torch.Tensor]) -> torch.Tensor:
    """(K, ...) from the K parts' equal-shaped results, in part order: what
    an all-gather over the parts' axis returns to every part. The parts of
    one device are a local list, so this stacks it."""
    return torch.stack(list(parts), dim=0)


def ring_arrival(parts: Sequence[torch.Tensor], k: int, s: int
                 ) -> torch.Tensor:
    """What part ``k`` holds after ``s`` steps of the forward ring, in which
    every part starts with its own tensor and each step hands what it holds
    to the next part: the tensor owned by part (k - s) mod K. With the parts
    a local list no copy is made."""
    return parts[(k - s) % len(parts)]


def reduce_scatter_parts(partial_for: Callable[[int], torch.Tensor], k: int,
                         n_parts: int) -> List[torch.Tensor]:
    """Part ``k``'s contribution to every owner's sum, in owner order,
    evaluated in the order in which the reverse ring asks for them
    (owner k+1 first, k itself last). On a mesh each contribution is added
    to a buffer that travels the ring and ends at its owner; with the parts
    a local list the caller returns them as the gradients of the K owners'
    tensors, and autograd's accumulation over the K parts' calls is that
    sum."""
    out: List[torch.Tensor] = [None] * n_parts
    for s in range(n_parts):
        owner = (k + 1 + s) % n_parts
        out[owner] = partial_for(owner)
    return out
