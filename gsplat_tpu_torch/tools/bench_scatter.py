"""Micro-benchmarks of the entry gradient's reduction (the backward of the
entry gather, rows of d_entries summed into their gaussians' rows) and of
the binning's sorts. Counterpart of tools/bench_scatter.py, at its sizes:
M 4,800,000 rows, N 200,000 segments and T 2,048 tiles on the card;
M 100,000, N 4,000 with ``--device cpu``.

    python -m gsplat_tpu_torch.tools.bench_scatter [--device cpu]

The (M,16) -> (N+1,16) reductions:
  a) ``index_add_`` over the rows in a shuffled order;
  b) ``index_add_`` over the rows sorted by segment (the layout the
     binning's gidx has);
  c) ``cumsum`` and a difference at the ``searchsorted`` segment offsets;
  d) ``torch.segment_reduce(..., "sum", lengths=...)``;
then the gather (N+1,16)[gidx], the int32 sort with its payload, the sorts
by (tile, depth): s2) two stable sorts (depth, then tile), s1) one sort of
the JAX tool's packed key (tile << 20) | ((depth bits >> 12) & 0xFFFFF),
and the (M,16) cumsum. Each is timed over 20 calls after a warm-up: the
host clock to ``torch.cuda.synchronize`` and CUDA events on the card. The
reductions' largest difference from a), and the share of s1's keys that
collide, are printed with them.
"""
from __future__ import annotations

import argparse

import numpy as np

from gsplat_tpu_torch.tools.bench import timed

SIZES = {"cuda": (4_800_000, 200_000, 2048), "cpu": (100_000, 4_000, 2048)}
ITERS = 20


def inputs(M, N, T, device):
    """The JAX tool's inputs from seed 0, in its order: sorted gidx (M,)
    int32 below N, d_entries (M,16), tile (M,) int32 below T, depth (M,)
    uniform in [0.2, 50), then packed (N+1,16)."""
    import torch

    rng = np.random.default_rng(0)
    gidx = np.sort(rng.integers(0, N, M)).astype(np.int32)
    d = rng.standard_normal((M, 16)).astype(np.float32)
    tile = rng.integers(0, T, M).astype(np.int32)
    depth = rng.uniform(0.2, 50.0, M).astype(np.float32)
    packed = rng.standard_normal((N + 1, 16)).astype(np.float32)
    return {k: torch.tensor(v, device=device) for k, v in dict(
        gidx=gidx, d=d, tile=tile, depth=depth, packed=packed).items()}


def index_add(d, gidx, N):
    """a), b): ``index_add_`` of every row into its segment."""
    import torch
    return torch.zeros((N + 1, 16), device=d.device).index_add_(0, gidx, d)


def segment_offsets(gidx, N):
    """(N+2,) offsets of the sorted gidx's N+1 segments, the last repeated
    (the JAX tool's ``searchsorted`` of 0..N and its last)."""
    import torch
    offs = torch.searchsorted(gidx, torch.arange(N + 1, device=gidx.device,
                                                 dtype=gidx.dtype))
    return torch.cat([offs, offs[-1:]])


def cumsum_diff(d, offs):
    """c): the inclusive cumsum with a zero row in front, differenced at
    the segment offsets."""
    import torch
    cs = torch.cat([d.new_zeros((1, 16)), torch.cumsum(d, 0)])
    return cs[offs[1:]] - cs[offs[:-1]]


def segment_sum(d, lengths):
    """d): ``torch.segment_reduce``'s sum over int64 segment lengths."""
    import torch
    return torch.segment_reduce(d, "sum", lengths=lengths)


def sort_payload(tile):
    """The int32 sort with its payload (the rows' indices), stable."""
    import torch
    return torch.sort(tile, stable=True).indices


def sort2(tile, depth):
    """s2): the order by (tile, depth), stable: a stable sort by depth and
    then a stable sort of that order by tile."""
    import torch
    o = torch.sort(depth, stable=True).indices
    return o[torch.sort(tile[o], stable=True).indices]


def packed_key(tile, depth):
    """s1)'s int32 key, bit for bit the JAX tool's: the tile above the top
    20 bits of the depth's float32 pattern below bit 12."""
    import torch
    dq = (depth.contiguous().view(torch.int32) >> 12) & 0xFFFFF
    return (tile << 20) | dq


def sort1(tile, depth):
    """s1): the order of one stable sort of ``packed_key``."""
    import torch
    return torch.sort(packed_key(tile, depth), stable=True).indices


def run(dev, *, size=None, iters=ITERS):
    """Time every variant on ``dev``; ``size`` = (M, N, T) overrides the
    device's. Returns a dict: each variant's (host ms, device ms or None)
    under ``times``, the reductions' results under ``sums``, the two sort
    orders, ``max_diff`` of each reduction from a) and the largest sum
    ``scale``, ``collide`` (the share of rows whose packed key another row
    shares) and ``segment_reduce`` (None, or the error it raised)."""
    import torch

    M, N, T = size or SIZES[dev.type]
    print(f"device={dev.type} M={M} N={N} T={T}", flush=True)
    x = inputs(M, N, T, dev)
    gidx = x["gidx"].long()
    d = x["d"]
    shuffle = torch.randperm(M, generator=torch.Generator().manual_seed(0)
                             ).to(dev)
    g_shuf, d_shuf = gidx[shuffle], d[shuffle]
    offs = segment_offsets(x["gidx"], N).long()
    lengths = offs[1:] - offs[:-1]
    times, sums = {}, {}
    refused = None

    def bench(name, fn):
        times[name] = timed(fn, dev, iters)
        host, event = times[name]
        ev = f" {event:9.3f} ms events" if event is not None else ""
        print(f"{name:28s} {host:9.3f} ms host{ev}", flush=True)

    variants = {"a) index_add_": lambda: index_add(d_shuf, g_shuf, N),
                "b) index_add_ sorted": lambda: index_add(d, gidx, N),
                "c) cumsum+diff": lambda: cumsum_diff(d, offs),
                "d) segment_reduce": lambda: segment_sum(d, lengths)}
    for name, fn in variants.items():
        try:
            sums[name] = fn()
        except RuntimeError as e:       # segment_reduce's refusal
            if not name.startswith("d)"):
                raise
            refused = str(e).splitlines()[0]
            print(f"{name}: refused on {dev.type}: {refused}", flush=True)
            continue
        bench(name, fn)
    ref = sums["a) index_add_"]
    scale = float(ref.abs().max())
    max_diff = {k: float((v - ref).abs().max()) for k, v in sums.items()}
    print(f"reductions: largest |sum| {scale:.4f}; max |x - a)| " + ", ".join(
        f"{k.split(')')[0]}) {v:.3e}" for k, v in max_diff.items()),
        flush=True)

    bench("gather (M,16)", lambda: x["packed"].index_select(0, gidx))
    bench("i32 sort+payload", lambda: sort_payload(x["tile"]))
    bench("s2) 2-key sort", lambda: sort2(x["tile"], x["depth"]))
    bench("s1) packed-key sort", lambda: sort1(x["tile"], x["depth"]))
    bench("cumsum (M,16)", lambda: torch.cumsum(d, 0))
    o1, o2 = sort1(x["tile"], x["depth"]), sort2(x["tile"], x["depth"])
    key = packed_key(x["tile"], x["depth"])
    ks = key[o1]
    dup = torch.zeros(M, dtype=torch.bool, device=dev)
    same = ks[1:] == ks[:-1]
    dup[1:] |= same
    dup[:-1] |= same
    collide = float(dup.float().mean())
    print(f"s1 keys: {collide:.4%} of rows share their key with another "
          f"row", flush=True)
    return dict(times=times, sums=sums, order1=o1, order2=o2, unique=~dup,
                max_diff=max_diff, scale=scale, collide=collide,
                segment_reduce=refused)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--device", default="cuda", choices=["cpu", "cuda"])
    args = p.parse_args(argv)

    from gsplat_tpu_torch.utils.general import resolve_device

    return run(resolve_device(args.device))


if __name__ == "__main__":
    main()
