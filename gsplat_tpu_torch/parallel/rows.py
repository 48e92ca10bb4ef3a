"""The rows of a rank-sharded train state (``RankParts``: rank k of the
``prim`` axis holds global rows [k·CAP/D, (k+1)·CAP/D) of every
per-gaussian tensor): capacity growth in the JAX package's global row
layout, and the gather to rank 0's host for its writes. The densify event
on these rows is ``train/densify.py:densify_and_prune(parts=)``.

Every per-gaussian tensor of a state travels in one message per peer: the
rows packed side by side into one float32 buffer (``pack_rows``; ``active``
as 0/1), which holds float32 values bit for bit.
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import torch
import torch.distributed as dist

from gsplat_tpu_torch.parallel import exchange
from gsplat_tpu_torch.train import checkpoint as ckpt_lib
from gsplat_tpu_torch.train import trainer


def pack_rows(tensors: List[torch.Tensor]) -> Tuple[torch.Tensor, list]:
    """(rows, F) float32 from per-row tensors, and what unpacks it."""
    spec = [(t.shape[1:], t.dtype) for t in tensors]
    buf = torch.cat([t.reshape(t.shape[0], -1).to(torch.float32)
                     for t in tensors], dim=1)
    return buf, spec


def unpack_rows(buf: torch.Tensor, spec: list) -> List[torch.Tensor]:
    out, at = [], 0
    for shape, dtype in spec:
        w = int(torch.Size(shape).numel())
        col = buf[:, at:at + w].reshape((buf.shape[0],) + tuple(shape))
        out.append(col.to(dtype) if dtype != torch.float32 else col.clone())
        at += w
    return out


def _overlap(a0, a1, b0, b1):
    return max(a0, b0), min(a1, b1)


def grow_rows(state: "trainer.TrainState", parts, new_cap: int
              ) -> "trainer.TrainState":
    """This rank's rows of the state grown to ``new_cap`` global rows, as
    ``checkpoint.grow_capacity`` grows the whole state (new rows dead, zero
    moments) with JAX's layout kept: global row i lies on rank
    i // (new_cap / D). Rows that change owner move point to point; each
    rank sends only what leaves it and receives only what lands on it."""
    n, k = parts.n, parts.k
    old = state.gaussians.capacity
    new = new_cap // n
    if new_cap % n:
        raise ValueError(f"capacity {new_cap} not divisible by {n} shards")
    if new <= old:
        return state
    buf, spec = pack_rows(trainer.row_tensors(state))
    sends, recvs, pieces = [], [], {}
    for j in range(n):
        # what rank k's old rows give rank j's new range, and what k's new
        # range takes from j's old rows
        lo, hi = _overlap(k * old, (k + 1) * old, j * new, (j + 1) * new)
        if hi > lo and j != k:
            sends.append((parts.line[j], buf[lo - k * old:hi - k * old]))
        elif hi > lo:
            pieces[j] = buf[lo - k * old:hi - k * old]
        lo, hi = _overlap(j * old, (j + 1) * old, k * new, (k + 1) * new)
        if hi > lo and j != k:
            recvs.append((j, parts.line[j], buf.new_empty((hi - lo,
                                                           buf.shape[1]))))
    got = exchange(sends, [(src, like) for _, src, like in recvs],
                   buf.device)
    for (j, _, _), t in zip(recvs, got):
        pieces[j] = t
    rows = torch.cat([pieces[j] for j in sorted(pieces)]) if pieces \
        else buf[:0]
    held = trainer.with_row_tensors(state, unpack_rows(rows, spec))
    return ckpt_lib.grow_capacity(held, new)


def gather_to_host(state: "trainer.TrainState", parts, group=None
                   ) -> Optional["trainer.TrainState"]:
    """The whole state on part 0's host, its rows received shard by shard
    from the other parts of the axis (each sends its rows once, through
    host memory: ``group`` is a gloo group, e.g. ``mesh.Hold``'s); None on
    the other parts. Exposure, schedules and scalars are part 0's own."""
    buf, spec = pack_rows(trainer.row_tensors(state))
    buf = buf.cpu()
    root = parts.line[0]
    if parts.k:
        dist.send(buf, dst=root, group=group)
        return None
    bufs = [buf]
    for j in range(1, parts.n):
        got = torch.empty_like(buf)
        dist.recv(got, src=parts.line[j], group=group)
        bufs.append(got)
    host = trainer.to_device(state, "cpu")
    return trainer.with_row_tensors(host, unpack_rows(torch.cat(bufs), spec))
