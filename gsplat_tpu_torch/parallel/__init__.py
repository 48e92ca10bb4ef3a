"""Rendering split over depth slabs (``prim_shard``), bands of tile rows
(``tile_shard``) or row shards of the gaussians' storage (``sharded``), and
camera data parallelism over ranks (``dp``, on the mesh of ``mesh``).
Counterpart of gsplat_tpu/parallel/, where each slab, band or shard is one
chip of a mesh under ``shard_map``.

The K parts of a split come in two forms, behind one small object that
tells a caller which part indices it owns (``mine``):

- :class:`LocalParts` ``(K)``: all K parts in this process, one after
  another on the one device the gaussians lie on (``--shards K`` on one
  card, and the CPU parity tests against JAX);
- :class:`RankParts` ``(mesh, axis)``: one part per rank of a mesh axis
  (``parallel/mesh.py``), this rank's coordinate on the axis, as JAX runs
  one part per device.

Per-part values travel as lists aligned with ``mine`` (K entries locally,
one on a rank). Each form provides what a mesh does with a collective over
the parts, with the arithmetic and the order of JAX's:

- ``gather``: the all-gather, (K, ...) in part order on every part. Its
  backward is ``"slice"`` (each part gets its own slice of the cotangent:
  the image's bands and slabs, fed to a loss every rank computes alike) or
  ``"sum"`` (the cotangents of all parts summed and scattered to the
  owners, JAX's all_gather -> psum_scatter transpose: the ``replicated``
  transient's packed table, which each rank's band consumes differently);
- ``ring``: the forward ring, JAX's ``ppermute`` with ``fwd_perm``: at step
  s part k holds the tensor of part (k - s) mod K;
- ``reduce_scatter``: the reverse ring of running sums, one buffer that
  travels to its owner adding each part's ``partial_for(owner)``;
- ``sum_grad``: identity forward, the sum over the parts backward, JAX's
  ``_psum_grad``, for a value every part computes alike and differentiates
  with its own part's cotangent (the packed table of the slab and band
  renders). Locally autograd's accumulation over the K parts' calls is
  that sum, so it is the identity;
- ``psum_value`` / ``pmax_value``: a per-part scalar summed / maxed over
  the parts.

The ``data`` axis runs over the ranks of a process group (one per card):
``psum``, ``pmean`` and ``pmax`` reduce over a mesh axis's group with one
all-reduce each.

Transport: NCCL moves device tensors card to card. Gloo stages
``all_reduce``, ``all_gather`` and ``broadcast`` of CUDA tensors through
the host itself; its point-to-point ``isend`` / ``irecv`` take host memory
only, so on gloo the ring's messages go through a pinned host copy (on the
CPU, the tensor itself). The point-to-point messages of a ring step, a
densify event or a capacity growth go out as one batch (``exchange``).
"""
from __future__ import annotations

from typing import Callable, Iterator, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist


def gather_parts(parts: Sequence[torch.Tensor]) -> torch.Tensor:
    """(K, ...) from the K parts' equal-shaped results, in part order: what
    an all-gather over the parts' axis returns to every part. The parts of
    one process are a local list, so this stacks it."""
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
    (owner k+1 first, k itself last). On ranks each contribution is added
    to a buffer that travels the ring and ends at its owner
    (``RankParts.reduce_scatter``); with the parts a local list the caller
    returns them as the gradients of the K owners' tensors, and autograd's
    accumulation over the K parts' calls is that sum."""
    out: List[torch.Tensor] = [None] * n_parts
    for s in range(n_parts):
        owner = (k + 1 + s) % n_parts
        out[owner] = partial_for(owner)
    return out


class LocalParts:
    """All ``n`` parts in this process, one after another."""
    ranked = False

    def __init__(self, n: int):
        self.n = int(n)
        self.mine = list(range(self.n))

    def split(self, x: torch.Tensor) -> List[torch.Tensor]:
        """A per-row tensor of ALL rows -> its ``n`` row shards (views)."""
        return list(torch.chunk(x, self.n, dim=0))

    def join(self, xs: Sequence[torch.Tensor]) -> torch.Tensor:
        """The row shards of ``mine`` -> the rows this process holds."""
        return torch.cat(list(xs))

    def total_rows(self, held: int) -> int:
        """The rows of all parts, from the rows this process holds."""
        return held

    def gather(self, xs: Sequence[torch.Tensor], grad: str = "slice"
               ) -> torch.Tensor:
        return gather_parts(xs)

    def ring(self, held: Sequence[torch.Tensor], k: int
             ) -> Iterator[Tuple[int, torch.Tensor]]:
        for s in range(self.n):
            yield (k - s) % self.n, ring_arrival(held, k, s)

    def reduce_scatter(self, partial_for, k: int) -> List[torch.Tensor]:
        return reduce_scatter_parts(partial_for, k, self.n)

    def sum_grad(self, x: torch.Tensor) -> torch.Tensor:
        return x

    def psum_value(self, vals: Sequence[torch.Tensor]) -> torch.Tensor:
        return gather_parts(vals).sum()

    def pmax_value(self, vals: Sequence[torch.Tensor]) -> torch.Tensor:
        return gather_parts(vals).amax()

    def gather_first(self, xs: Sequence[Optional[torch.Tensor]], m: int,
                     like: Optional[torch.Tensor] = None
                     ) -> List[torch.Tensor]:
        """The tensors of parts 0 .. m-1 (each part < m has one)."""
        return [xs[j] for j in range(m)]


def as_parts(parts) -> "LocalParts | RankParts":
    """An int K is K local parts; a parts object is itself."""
    return LocalParts(parts) if isinstance(parts, int) else parts


def _staged(x: torch.Tensor, backend: str) -> torch.Tensor:
    """What goes on the wire: a CUDA tensor through a pinned host copy on
    gloo, whose point-to-point transport reads host memory only."""
    if backend == "gloo" and x.is_cuda:
        host = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
        host.copy_(x)
        return host
    return x.contiguous()


def _landing(like: torch.Tensor, backend: str) -> torch.Tensor:
    if backend == "gloo" and like.is_cuda:
        return torch.empty(like.shape, dtype=like.dtype, pin_memory=True)
    return torch.empty_like(like, memory_format=torch.contiguous_format)


def exchange(sends: Sequence[Tuple[int, torch.Tensor]],
             recvs: Sequence[Tuple[int, torch.Tensor]], device
             ) -> List[torch.Tensor]:
    """Point-to-point messages over the world's group: every (global rank,
    tensor) of ``sends`` is sent, a tensor shaped like each template of
    ``recvs`` is received from its rank. All are posted as ONE batch
    (``dist.batch_isend_irecv``), then awaited. At most one message per
    direction between two ranks. Returns the received tensors on
    ``device``.

    The batch matters on NCCL, which runs the messages between two ranks
    in order on one stream: two ranks that each posted a receive from the
    other before their send would each wait for a send queued behind the
    other's receive (the two-rank ring, where the next rank is the
    previous one). Batched, NCCL posts them together. Gloo takes each
    message on the host, in any order. ``chip_smoke.py --nccl`` runs the
    NCCL form on 4 cards."""
    if not sends and not recvs:
        return []
    backend = dist.get_backend()
    landed = [_landing(like, backend) for _, like in recvs]
    ops = [dist.P2POp(dist.irecv, buf, src)
           for (src, _), buf in zip(recvs, landed)]
    ops += [dist.P2POp(dist.isend, _staged(t, backend), dst)
            for dst, t in sends]
    for w in dist.batch_isend_irecv(ops):
        w.wait()
    return [b.to(device, non_blocking=True) for b in landed]


class _GatherSlice(torch.autograd.Function):
    """All-gather over the parts' group (the list form, which gloo and NCCL
    both take), whose backward hands each part its own slice."""

    @staticmethod
    def forward(ctx, parts, x):
        ctx.parts = parts
        out = [torch.empty_like(x) for _ in range(parts.n)]
        dist.all_gather(out, x.contiguous(), group=parts.group)
        return torch.stack(out)

    @staticmethod
    def backward(ctx, g):
        return None, g[ctx.parts.k].contiguous()


class _GatherSum(_GatherSlice):
    """The all-gather whose backward sums the parts' cotangents and
    scatters the sums to their owners around the reverse ring."""

    @staticmethod
    def backward(ctx, g):
        parts = ctx.parts
        (buf,) = parts.reduce_scatter(lambda owner: g[owner], parts.k)
        return None, buf


class _SumGrad(torch.autograd.Function):
    """Identity whose backward sums the cotangent over the parts."""

    @staticmethod
    def forward(ctx, parts, x):
        ctx.parts = parts
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous()
        dist.all_reduce(g, group=ctx.parts.group)
        return None, g


class RankParts:
    """One part per rank of ``mesh``'s ``axis``: this rank owns part
    ``k = mesh.coords[axis]`` of ``n = mesh.shape[axis]``. The ring's
    neighbours are the global ranks ``line[k ± 1]`` of the axis's line."""
    ranked = True

    def __init__(self, mesh, axis: str):
        self.n = mesh.shape[axis]
        self.k = mesh.coords[axis]
        self.mine = [self.k]
        self.group = mesh.groups[axis]
        self.line = list(mesh.lines[axis])
        self.next = self.line[(self.k + 1) % self.n]
        self.prev = self.line[(self.k - 1) % self.n]

    def split(self, x: torch.Tensor) -> List[torch.Tensor]:
        """This rank's rows ARE its shard."""
        return [x]

    def join(self, xs: Sequence[torch.Tensor]) -> torch.Tensor:
        (x,) = xs
        return x

    def total_rows(self, held: int) -> int:
        return held * self.n

    def gather(self, xs: Sequence[torch.Tensor], grad: str = "slice"
               ) -> torch.Tensor:
        (x,) = xs
        fn = {"slice": _GatherSlice, "sum": _GatherSum}[grad]
        return fn.apply(self, x)

    def _step(self, x: torch.Tensor, to: int, frm: int) -> torch.Tensor:
        (got,) = exchange([(to, x)], [(frm, x)], x.device)
        return got

    def ring(self, held: Sequence[torch.Tensor], k: int
             ) -> Iterator[Tuple[int, torch.Tensor]]:
        (x,) = held
        for s in range(self.n):
            if s:
                x = self._step(x, self.next, self.prev)
            yield (k - s) % self.n, x

    def reduce_scatter(self, partial_for, k: int) -> List[torch.Tensor]:
        """JAX's ``_ring_reduce_scatter``: the buffer started here holds
        owner k+1's partial; at each step it goes to part k-1 and the one
        that arrives from k+1 takes this part's partial for the next owner,
        so after K-1 steps the buffer here is owner k's sum."""
        buf = partial_for((k + 1) % self.n)
        for s in range(1, self.n):
            buf = self._step(buf, self.prev, self.next) \
                + partial_for((k + 1 + s) % self.n)
        return [buf]

    def sum_grad(self, x: torch.Tensor) -> torch.Tensor:
        return _SumGrad.apply(self, x)

    def psum_value(self, vals: Sequence[torch.Tensor]) -> torch.Tensor:
        (v,) = vals
        v = v.clone()
        dist.all_reduce(v, group=self.group)
        return v

    def pmax_value(self, vals: Sequence[torch.Tensor]) -> torch.Tensor:
        (v,) = vals
        v = v.clone()
        dist.all_reduce(v, op=dist.ReduceOp.MAX, group=self.group)
        return v

    def gather_first(self, xs: Sequence[Optional[torch.Tensor]], m: int,
                     like: Optional[torch.Tensor] = None
                     ) -> List[torch.Tensor]:
        """The tensors of parts 0 .. m-1 on every part: one broadcast from
        each of those parts (part m and after send nothing). ``like``
        shapes the buffers of the parts that receive."""
        (x,) = xs
        out = []
        for j in range(m):
            buf = x if j == self.k else torch.empty_like(like)
            dist.broadcast(buf, src=self.line[j], group=self.group)
            out.append(buf)
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
