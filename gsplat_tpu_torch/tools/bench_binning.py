"""Micro-benchmarks of the binning's expansion and layout passes on
synthetic tables. Counterpart of tools/bench_binning.py, at its sizes:
N 200,000 gaussians into m_cap 4,800,000 slots over 2,040 tiles on the
card; N 4,000, m_cap 100,000 with ``--device cpu``.

    python -m gsplat_tpu_torch.tools.bench_binning [--device cpu]

Stages: the expansion of the gaussians' indices by their pair counts into
m_cap static slots (``repeat_interleave`` with ``output_size``, padded
with the last index and cut at m_cap as ``jnp.repeat``'s
``total_repeat_length`` does), the offset gathers, ``searchsorted`` of the
T tile ids and of the m_out slot ids, and the whole align stage. Each is
timed over 10 calls after a warm-up: the host clock to
``torch.cuda.synchronize`` and CUDA events on the card.
"""
from __future__ import annotations

import argparse

import numpy as np

from gsplat_tpu_torch.tools.bench import timed

SIZES = {"cuda": (200_000, 4_800_000), "cpu": (4_000, 100_000)}
N_TILES = 2040
ALIGN = 128
ITERS = 10


def inputs(N, m_cap, n_tiles, device):
    """The JAX tool's tables from seed 0, in its order: counts (N,) in
    [0, 40), depth (N,), tile_sorted (m_cap,) sorted below n_tiles,
    tile_count (n_tiles,) in [0, 4000); all int32 but depth."""
    import torch

    rng = np.random.default_rng(0)
    counts = rng.integers(0, 40, N).astype(np.int32)
    depth = rng.uniform(0.2, 50.0, N).astype(np.float32)
    tile_sorted = np.sort(rng.integers(0, n_tiles, m_cap)).astype(np.int32)
    tile_count = rng.integers(0, 4000, n_tiles).astype(np.int32)
    return {k: torch.tensor(v, device=device) for k, v in dict(
        counts=counts, depth=depth, tile_sorted=tile_sorted,
        tile_count=tile_count).items()}


def repeat(counts, m_cap):
    """0..N-1 each repeated by its count into exactly m_cap slots, with no
    host read: a tail past the counts' sum holds N-1 and a sum past m_cap
    is cut (``jnp.repeat(..., total_repeat_length=m_cap)``)."""
    import torch

    N = counts.shape[0]
    ends = torch.clamp(torch.cumsum(counts.long(), 0), max=m_cap)
    reps = torch.cat([torch.diff(ends, prepend=ends.new_zeros(1)),
                      (m_cap - ends[-1:])])
    values = torch.cat([torch.arange(N, device=counts.device),
                        torch.full((1,), N - 1, device=counts.device)])
    return torch.repeat_interleave(values, reps, output_size=m_cap)


def offset_gathers(gidx, counts, depth):
    """Each slot's rank in its gaussian and its gaussian's depth."""
    import torch
    counts = counts.long()
    offsets = torch.cumsum(counts, 0) - counts
    k = torch.arange(gidx.shape[0], device=gidx.device) - offsets[gidx]
    return k, depth[gidx]


def tile_starts(tile_sorted, n_tiles):
    """The first slot of each tile: ``searchsorted`` of the T ids."""
    import torch
    ids = torch.arange(n_tiles, device=tile_sorted.device,
                       dtype=tile_sorted.dtype)
    return torch.searchsorted(tile_sorted, ids)


def slot_tiles(tile_count, m_out, align=ALIGN):
    """The tile of each of m_out aligned slots: ``searchsorted`` of the
    slot ids in the aligned ranges' ends (n_tiles past the last)."""
    import torch
    padded = -(-tile_count.long() // align) * align
    ends = torch.cumsum(padded, 0)
    return torch.searchsorted(ends, torch.arange(m_out, device=ends.device),
                              right=True), ends - padded


def align_full(tile_count, gidx, m_out, N, align=ALIGN):
    """The whole align stage: each aligned slot's source slot, its gaussian
    or the sentinel N."""
    import torch
    n_tiles = tile_count.shape[0]
    t_of, starts = slot_tiles(tile_count, m_out, align)
    t_c = torch.clamp(t_of, max=n_tiles - 1)
    rank = torch.arange(m_out, device=gidx.device) - starts[t_c]
    src = torch.clamp(rank, 0, gidx.shape[0] - 1)
    return torch.where(t_of < n_tiles, gidx[src], N)


def run(dev, *, size=None, iters=ITERS):
    """Time every stage on ``dev``; ``size`` = (N, m_cap) overrides the
    device's. Returns each stage's (host ms, device ms or None) and its
    result."""
    N, m_cap = size or SIZES[dev.type]
    m_out = m_cap + ALIGN * N_TILES
    print(f"device={dev.type} N={N} m_cap={m_cap}", flush=True)
    x = inputs(N, m_cap, N_TILES, dev)
    gidx = repeat(x["counts"], m_cap)
    stages = {
        "repeat_interleave": lambda: repeat(x["counts"], m_cap),
        "offset gathers": lambda: offset_gathers(gidx, x["counts"],
                                                 x["depth"]),
        "searchsorted T queries": lambda: tile_starts(x["tile_sorted"],
                                                      N_TILES),
        "searchsorted M queries": lambda: slot_tiles(x["tile_count"],
                                                     m_out)[0],
        "align full": lambda: align_full(x["tile_count"], gidx, m_out, N),
    }
    out = {}
    for name, fn in stages.items():
        host, event = timed(fn, dev, iters)
        ev = f" {event:9.3f} ms events" if event is not None else ""
        print(f"{name:30s} {host:9.3f} ms host{ev}", flush=True)
        out[name] = dict(host_ms=host, event_ms=event, result=fn())
    return out


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--device", default="cuda", choices=["cpu", "cuda"])
    args = p.parse_args(argv)

    from gsplat_tpu_torch.utils.general import resolve_device

    return run(resolve_device(args.device))


if __name__ == "__main__":
    main()
