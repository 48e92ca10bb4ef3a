"""Whole-train-step timing for one (tile_h, tile_w, chunk) shape on
bench.py's scene: the tile-shape lever. Larger tiles cut the (tile, depth)
pair count, which every pair-sized pass of binning, the gather and its
backward scales with, at the price of more pixels walked per pair in the
compositor. Counterpart of tools/sweep_tiles.py.

    python -m gsplat_tpu_torch.tools.sweep_tiles <tile_h> <tile_w> <chunk>
        [compositor] [--device cpu]

The first step's capacity is ``SWEEP_PPG`` pairs a gaussian (default 10,
doubled until the step does not overflow); then bench.py's right-sizing, and the best of 3 windows of 7 chained steps
on the card (one window of 2 on the CPU, at 256x128 with 2,000 gaussians).
Prints the ``pairs= m_cap= m_out= tiles=`` line and the ``RESULT`` line
with the JAX tool's fields, and on the card a step's device busy time
from the profiler. The port's compositor has no strips, so the JAX tool's
fifth argument (``strip_chunks``) is a usage error here. The CUDA kernels
take at most 1,024 pixels a tile: a larger tile raises their
``ValueError`` on the card.
"""
from __future__ import annotations

import argparse
import os
from typing import NamedTuple

from gsplat_tpu_torch.tools.bench import (BASELINE_PIX_PER_S, SIZES,
                                          bench_scene, device_busy,
                                          right_size, step_fn, time_windows)

WINDOWS = {"cuda": (7, 3), "cpu": (2, 1)}     # (steps a window, windows)


class Shape(NamedTuple):
    """One right-sized tile shape on a scene: its config, its step and the
    state after the right-sized step."""
    label: str
    cfg: object
    step: object
    state: object
    pairs: int
    m_cap: int
    m_out: int
    tiles: int


def setup(tile_h, tile_w, chunk, compositor, g, cam, gt, ppg0):
    """Right-size ``(tile_h, tile_w, chunk)`` on the scene as bench.py
    does, from a first step at ``ppg0`` pairs a gaussian."""
    from gsplat_tpu_torch.config import RasterizerConfig

    W, H = gt.shape[2], gt.shape[1]
    cfg = RasterizerConfig(pairs_per_gaussian=ppg0, tile_h=tile_h,
                           tile_w=tile_w, chunk=chunk, compositor=compositor)
    cfg, state, pairs, _, _ = right_size(g, cam, gt, cfg)
    n = g.num_active()
    m_cap = -(-int(n * cfg.pairs_per_gaussian) // chunk) * chunk
    return Shape(label=f"{tile_h}x{tile_w}/{chunk}", cfg=cfg,
                 step=step_fn(cam, gt, cfg), state=state, pairs=pairs,
                 m_cap=m_cap, m_out=m_cap + -(-cfg.pad_cap // chunk) * chunk,
                 tiles=(-(-W // tile_w)) * (-(-H // tile_h)))


def run(tile_h, tile_w, chunk, compositor, dev, *, size=None, ppg0=None):
    """One shape on ``dev``; ``size`` = (W, H, n) overrides the device's.
    Prints the JAX tool's lines and returns a dict: ``pairs``, ``m_cap``,
    ``m_out``, ``tiles``, ``step_ms`` (best window, per step), ``busy_ms``
    (None on the CPU)."""
    W, H, n = size or SIZES[dev.type][:3]
    iters, windows = WINDOWS[dev.type]
    ppg0 = ppg0 or float(os.environ.get("SWEEP_PPG", "10.0"))
    print(f"device={dev.type} {W}x{H} n={n} tile={tile_h}x{tile_w} "
          f"chunk={chunk} comp={compositor}", flush=True)
    g, cam, gt = bench_scene(n, W, H, dev)
    s = setup(tile_h, tile_w, chunk, compositor, g, cam, gt, ppg0)
    print(f"pairs={s.pairs} m_cap={s.m_cap} m_out={s.m_out} "
          f"tiles={s.tiles}", flush=True)
    window_ms, state, ovf = time_windows(s.step, s.state, dev, iters,
                                         windows)
    if ovf:
        raise RuntimeError(f"overflow {ovf} during timing")
    dt = min(window_ms) / iters / 1e3
    busy = device_busy(lambda: s.step(state))[0] \
        if dev.type == "cuda" else None
    extra = f" busy={busy:.3f} ms" if busy is not None else ""
    print(f"RESULT tile={tile_h}x{tile_w} chunk={chunk} comp={compositor} "
          f"step={dt * 1e3:.2f} ms px/s={W * H / dt:.3e} "
          f"vs_baseline={W * H / dt / BASELINE_PIX_PER_S:.3f}{extra}",
          flush=True)
    return dict(pairs=s.pairs, m_cap=s.m_cap, m_out=s.m_out, tiles=s.tiles,
                step_ms=dt * 1e3, busy_ms=busy)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("tile_h", type=int)
    p.add_argument("tile_w", type=int)
    p.add_argument("chunk", type=int)
    p.add_argument("compositor", nargs="?", default="chunk")
    p.add_argument("strip_chunks", nargs="?", default=None)
    p.add_argument("--device", default="cuda", choices=["cpu", "cuda"])
    args = p.parse_args(argv)
    if args.strip_chunks is not None:
        p.error("the port's compositor has no strips: it takes no "
                "strip_chunks (the JAX tool's fifth argument)")

    from gsplat_tpu_torch.utils.general import resolve_device

    return run(args.tile_h, args.tile_w, args.chunk, args.compositor,
               resolve_device(args.device))


if __name__ == "__main__":
    main()
