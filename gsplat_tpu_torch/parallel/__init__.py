"""Rendering split over depth slabs (``prim_shard``), bands of tile rows
(``tile_shard``) or row shards of the gaussians' storage (``sharded``), and
camera data parallelism over ranks (``dp``, on the mesh of ``mesh``).
Counterpart of gsplat_tpu/parallel/, where each slab, band or shard is one
chip of a mesh. Here the parts run one after another on the one device the
gaussians lie on, with the arithmetic of each part, the exclusive
transmittance product, the ordered merge and the ring's order exactly as
there. What a mesh does with a collective over the parts stands in the
three helpers ``gather_parts``, ``ring_arrival`` and
``reduce_scatter_parts``. The ``data`` axis runs over the ranks of a
process group (one per card): ``psum``, ``pmean`` and ``pmax`` reduce over
a mesh axis's group with one all-reduce each.
"""
from __future__ import annotations

from typing import Callable, List, Sequence

import torch
import torch.distributed as dist


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


def _all_reduce(tensors: Sequence[torch.Tensor], mesh, axis: str,
                op) -> List[torch.Tensor]:
    """``op`` over ``axis`` of every tensor, in ONE all-reduce: the tensors
    are packed into one flat buffer of their common dtype (float64 where
    they mix dtypes, which holds float32 and int64 values below 2^53
    exactly) and unpacked into their own shapes and dtypes. Outside a
    process group the mesh is one rank and the values are returned as they
    are.

    Gloo takes CUDA tensors for ``all_reduce`` and stages them through
    pinned host memory itself; NCCL reduces on the cards."""
    dtypes = {t.dtype for t in tensors}
    dtype = dtypes.pop() if len(dtypes) == 1 else torch.float64
    flat = torch.cat([t.reshape(-1).to(dtype) for t in tensors])
    if dist.is_available() and dist.is_initialized():
        dist.all_reduce(flat, op=op, group=mesh.groups[axis])
    out, at = [], 0
    for t in tensors:
        out.append(flat[at:at + t.numel()].reshape(t.shape).to(t.dtype))
        at += t.numel()
    return out


def psum(tensors: Sequence[torch.Tensor], mesh, axis: str
         ) -> List[torch.Tensor]:
    """The sum of each tensor over the ranks of ``axis``, one all-reduce for
    all of them."""
    return _all_reduce(tensors, mesh, axis, dist.ReduceOp.SUM)


def pmean(tensors: Sequence[torch.Tensor], mesh, axis: str
          ) -> List[torch.Tensor]:
    """``psum`` divided by the axis's size after the sum, as JAX's
    ``psum(v) / n``."""
    n = mesh.shape[axis]
    return [t / n for t in psum(tensors, mesh, axis)]


def pmax(tensors: Sequence[torch.Tensor], mesh, axis: str
         ) -> List[torch.Tensor]:
    """The largest value of each element over the ranks of ``axis``, one
    all-reduce for all of them."""
    return _all_reduce(tensors, mesh, axis, dist.ReduceOp.MAX)
