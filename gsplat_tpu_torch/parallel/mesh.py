"""Process-group bring-up and the mesh of ranks. Counterpart of
gsplat_tpu/parallel/mesh.py.

One process per card, the same program on every rank, started by
``torchrun`` (or anything that sets PyTorch's ``env://`` contract:
``MASTER_ADDR``, ``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``,
``LOCAL_RANK``)::

    torchrun --nproc_per_node=4 train_torch.py -s <scene> --data_parallel

:func:`init_distributed` joins the process group; :func:`make_mesh` lays
the world's ranks out on named axes. The ``data`` axis (camera data
parallelism, ``parallel/dp.py``) and the ``prim`` and ``tile`` axes (the
row shards of gaussian-sharded storage, the depth slabs and the tile bands:
``parallel/sharded.py``, ``prim_shard.py``, ``tile_shard.py`` with
``RankParts(mesh, axis)``) all run over ranks, one part per rank. As in
JAX the outer axis runs across hosts and the innermost within a host:
``torchrun`` numbers a host's ranks consecutively, and the innermost axis
varies fastest over the rank number. JAX's 2-D loop lays out ``data`` 2 x
``prim`` world // 2 (``train/loop.py``).

Host-side control flow must agree on every rank: the loop's camera picks
come from Python's ``random`` seeded alike on every rank, its random draws
from one ``torch.Generator`` seeded 0 on each, and its grow / shrink /
retry decisions from all-reduced values. JAX's ``replicated`` and
``data_sharded`` (``NamedSharding`` placements) have no counterpart: a
rank's tensors lie on its own card.
"""
from __future__ import annotations

import os
from datetime import timedelta
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from gsplat_tpu_torch.utils.general import local_card, resolve_device

# a rank that dies leaves the others waiting this long in a collective, not
# forever. It bounds the collectives of the steps, where every rank works
# alike; where rank 0 works alone the others wait in a Hold instead.
DEFAULT_TIMEOUT = timedelta(seconds=300)
# how long a Hold waits for rank 0: past any work it does alone (a viewer
# client keeping the run paused, evaluation, saves, synchronous checkpoints)
HOLD_TIMEOUT = timedelta(days=7)


def init_distributed(*, device="cuda", backend: Optional[str] = None,
                     timeout: timedelta = DEFAULT_TIMEOUT) -> bool:
    """Join the process group from the ``env://`` variables; a no-op
    without ``WORLD_SIZE`` in the environment. Returns True when running
    distributed.

    The rank's device is ``device``; a ``cuda`` without an index is
    ``cuda:LOCAL_RANK`` (:func:`~gsplat_tpu_torch.utils.general.local_card`).
    The backend follows the device: ``nccl`` for a card, ``gloo`` for the
    CPU; ``backend`` overrides it (gloo on a card lets several ranks share
    one, which NCCL refuses)."""
    if dist.is_initialized():
        return True
    if "WORLD_SIZE" not in os.environ:
        return False
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = local_card()
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    world = int(os.environ["WORLD_SIZE"])
    rank = int(os.environ["RANK"])
    dist.init_process_group(backend, init_method="env://", world_size=world,
                            rank=rank, timeout=timeout)
    print(f"[dist] process {rank}/{world}, {backend} on {dev}, "
          f"{os.environ.get('LOCAL_WORLD_SIZE', '?')} local of {world} "
          f"global ranks", flush=True)
    return True


def world() -> Tuple[int, int]:
    """(rank, world size); (0, 1) outside a process group."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def mesh_layout(axes: Sequence[tuple], n_ranks: int
                ) -> Tuple[List[str], List[int], np.ndarray]:
    """(names, sizes, grid) of a mesh of ``n_ranks`` from (name, size)
    pairs, a size of -1 taking all remaining ranks: the rank numbers
    reshaped to the sizes, the innermost axis varying fastest."""
    names = [a for a, _ in axes]
    sizes = [s for _, s in axes]
    n_fixed = int(np.prod([s for s in sizes if s > 0])) or 1
    sizes = [s if s > 0 else n_ranks // n_fixed for s in sizes]
    if int(np.prod(sizes)) != n_ranks:
        raise ValueError(f"mesh {dict(zip(names, sizes))} does not cover "
                         f"{n_ranks} ranks")
    return names, sizes, np.arange(n_ranks).reshape(sizes)


class Mesh:
    """The world's ranks on named axes, seen from one rank: ``shape[name]``,
    this rank's coordinate on each axis (``coords[name]``), the process
    group of the line of ranks it shares along each axis (``groups[name]``;
    None for the default group, and outside a process group, where the
    mesh is one rank and a collective has nothing to combine) and that
    line's global rank numbers in axis order (``lines[name]``: the peers of
    point-to-point messages along the axis)."""

    def __init__(self, names, sizes, rank, groups, lines=None):
        self.shape: Dict[str, int] = dict(zip(names, sizes))
        self.coords: Dict[str, int] = dict(zip(
            names, (int(c) for c in np.unravel_index(rank, sizes))))
        self.groups = groups
        self.lines: Dict[str, List[int]] = lines or {}


def make_mesh(axes: Sequence[tuple] = (("data", -1),)) -> Mesh:
    """A mesh over the world's ranks from (name, size) pairs; -1 = all
    remaining ranks. Every rank makes every line's group, in one order, as
    ``dist.new_group`` asks; an axis over the whole world takes the
    default group."""
    rank, n_ranks = world()
    names, sizes, grid = mesh_layout(axes, n_ranks)
    groups, own = {}, {}
    for i, name in enumerate(names):
        lines = np.moveaxis(grid, i, -1).reshape(-1, sizes[i])
        for line in lines:
            group = None
            if sizes[i] < n_ranks:
                group = dist.new_group([int(r) for r in line])
            if rank in line:
                groups[name] = group
                own[name] = [int(r) for r in line]
    return Mesh(names, sizes, rank, groups, own)


class Hold:
    """Where rank 0 works alone and the other ranks wait for it: a gloo
    group of the whole world whose collectives wait ``HOLD_TIMEOUT``, on
    the host, so the wait holds no collective of the steps' group open
    past ``DEFAULT_TIMEOUT``. Every rank makes it at the same point, as
    ``dist.new_group`` asks."""

    def __init__(self):
        self.group = dist.new_group(backend="gloo", timeout=HOLD_TIMEOUT)

    def wait(self):
        """Every rank returns once every rank, rank 0 last, has come."""
        dist.barrier(group=self.group)

    def from_rank0(self, flag: bool) -> bool:
        """Rank 0's ``flag`` on every rank."""
        t = torch.tensor([int(flag)])
        dist.broadcast(t, src=0, group=self.group)
        return bool(t)
