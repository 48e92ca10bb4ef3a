"""The port's ``bin_gaussians`` (ops/binning.py) taken apart stage by
stage and timed, at the render path's configuration (32x32 tiles, chunk
64, right-sized capacity ceil(1.3 x pairs)) and with per-tile-row culling.
Counterpart of tools/bisect_binning.py; the port's binning has other
stages than the JAX package's (a ``searchsorted`` expansion and a
difference-array histogram where JAX scatters), so these are its own:

- the whole ``bin_gaussians``, rectangles and culled (each at its own
  right-sized capacity);
- the gaussians' stable depth sort (N);
- ``_expand_slots``: the ``searchsorted`` of every slot in the gaussians'
  pair offsets (m_cap);
- ``_rect_counts``: the per-tile histogram as a 2-D difference array (N);
- the packed (tile, depth rank) key and its stable entry sort (m_cap);
- ``_aligned_layout``: the chunk-aligned gather (m_out);
- with culling, ``_expand_units`` over the 4 slots of every gaussian.

The stages run in sequence on the same inputs and their result must
equal ``bin_gaussians``'s entry list, or the tool raises.

    python -m gsplat_tpu_torch.tools.bisect_binning [--device cpu]

On the card bench.py's 1920x1080 scene of 200,000 gaussians; ``--device
cpu`` its CPU size. Each stage is timed over 12 calls after a warm-up:
the host clock to ``torch.cuda.synchronize`` and CUDA events on the card.
"""
from __future__ import annotations

import argparse

from gsplat_tpu_torch.tools.bench import FIRST_PPG, SIZES, bench_scene, timed

ITERS = 12


def right_m_cap(pairs, chunk):
    return -(-int(pairs * 1.3) // chunk) * chunk


def run(dev, *, size=None, iters=ITERS):
    """Bisect on ``dev``; ``size`` = (W, H, n) overrides the device's.
    Returns a dict: ``pairs``, ``m_cap``, ``pairs_culled``,
    ``m_cap_culled``, each stage's (host ms, device ms or None) under
    ``times``, and the composed stages' ``gidx_sorted``."""
    import torch

    from gsplat_tpu_torch.config import RasterizerConfig
    from gsplat_tpu_torch.ops import binning as B
    from gsplat_tpu_torch.ops import preprocess as preprocess_lib

    W, H, n = size or SIZES[dev.type][:3]
    cfg = RasterizerConfig()
    th, tw, G = cfg.tile_h, cfg.tile_w, cfg.chunk
    ntx, nty = -(-W // tw), -(-H // th)
    n_tiles = ntx * nty
    print(f"device={dev.type} {W}x{H} n={n} tile={th}x{tw} chunk={G}",
          flush=True)
    g, cam, _ = bench_scene(n, W, H, dev)
    times = {}

    def bench(name, fn):
        times[name] = timed(fn, dev, iters)
        host, event = times[name]
        ev = f" {event:8.3f} ms events" if event is not None else ""
        print(f"{name:46s} {host:8.3f} ms host{ev}", flush=True)

    with torch.no_grad():
        pre = preprocess_lib.preprocess(
            g.xyz, g.get_scaling(), g.get_rotation(), g.get_opacity(),
            g.get_features(), g.active_sh_degree, cam, W, H,
            active_mask=g.active, dilation=cfg.dilation,
            alpha_min=cfg.alpha_min)
        geo = dict(rx=pre.rx, ry=pre.ry, image_width=W, image_height=H,
                   tile_h=th, tile_w=tw, align=G)
        cull = dict(conic=pre.conic, t_cut=pre.t_cut,
                    row_slots=cfg.row_slots)
        probe_m = -(-int(n * FIRST_PPG) // G) * G

        def full(m_cap, **kw):
            return B.bin_gaussians(pre.mean2d, pre.depth, pre.radius,
                                   m_cap=m_cap, **geo, **kw)

        pairs = int(full(probe_m).num_pairs)
        m_cap = right_m_cap(pairs, G)
        print(f"pairs={pairs} m_cap={m_cap}", flush=True)
        ref = full(m_cap)
        bench("full bin_gaussians", lambda: full(m_cap))
        pairs_c = int(full(probe_m, **cull).num_pairs)
        m_cap_c = right_m_cap(pairs_c, G)
        print(f"culled pairs={pairs_c} ({pairs_c / max(pairs, 1):.2f}x) "
              f"m_cap={m_cap_c}", flush=True)
        bench("full bin_gaussians (row-culled)",
              lambda: full(m_cap_c, **cull))

        # the stages of the rectangle path, in bin_gaussians' order
        depth = pre.depth
        bench("  gaussian depth sort (N)",
              lambda: torch.sort(depth, stable=True).indices)
        perm = torch.sort(depth, stable=True).indices
        m2, rad = pre.mean2d[perm], pre.radius[perm]
        rxp, ryp = pre.rx[perm], pre.ry[perm]
        x0, y0, x1, y1 = B.tile_rect(m2, rxp, ryp, ntx, nty, th, tw)
        valid = (rad > 0) & (rxp > 0) & (ryp > 0)
        w = torch.where(valid, torch.clamp(x1 - x0, min=0), 0)
        h = torch.where(valid, torch.clamp(y1 - y0, min=0), 0)
        counts = w * h
        bench("  _expand_slots (searchsorted, m_cap)",
              lambda: B._expand_slots(counts, x0, y0, w, ntx, n_tiles,
                                      m_cap))
        unit, tile, live = B._expand_slots(counts, x0, y0, w, ntx, n_tiles,
                                           m_cap)
        bench("  _rect_counts (difference array, N)",
              lambda: B._rect_counts(x0, y0, x0 + w, y0 + h, counts > 0,
                                     ntx, nty))
        grid = B._rect_counts(x0, y0, x0 + w, y0 + h, counts > 0, ntx, nty)
        gidx = torch.where(live, unit, n)
        bench("  key build + entry sort (m_cap)",
              lambda: torch.sort(tile * (n + 1) + gidx, stable=True))
        key, _ = torch.sort(tile * (n + 1) + gidx, stable=True)
        tile_count = torch.clamp(grid.reshape(-1), max=m_cap)
        tile_start = torch.cumsum(tile_count, 0) - tile_count
        padded_count = -(-tile_count // G) * G
        padded_start = torch.cumsum(padded_count, 0) - padded_count
        m_out = m_cap + G * n_tiles
        values = key % (n + 1)
        bench("  _aligned_layout (m_out)",
              lambda: B._aligned_layout(values, n, tile_start, tile_count,
                                        padded_start, m_out))
        gidx_sorted = B._aligned_layout(values, n, tile_start, tile_count,
                                        padded_start, m_out)
        if not torch.equal(gidx_sorted, ref.gidx_sorted):
            raise RuntimeError("the stages do not compose to bin_gaussians' "
                               "entry list")
        c = {k: v[perm] for k, v in (("conic", pre.conic),
                                     ("t_cut", pre.t_cut))}
        bench("  _expand_units, row-culled (4 slots a gaussian)",
              lambda: B._expand_units(m2, rad, rxp, ryp, n_tiles_x=ntx,
                                      n_tiles_y=nty, tile_h=th, tile_w=tw,
                                      m=m_cap_c, row_slots=cfg.row_slots,
                                      **c))
    return dict(pairs=pairs, m_cap=m_cap, pairs_culled=pairs_c,
                m_cap_culled=m_cap_c, times=times, gidx_sorted=gidx_sorted)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--device", default="cuda", choices=["cpu", "cuda"])
    args = p.parse_args(argv)

    from gsplat_tpu_torch.utils.general import resolve_device

    return run(resolve_device(args.device))


if __name__ == "__main__":
    main()
