"""Stage-by-stage timing of the training step on bench.py's scene:
preprocess, binning, the entry gather and its backward, the compositor
forward and forward+backward, the render forward and forward+backward,
SSIM, the whole step. Counterpart of tools/profile_stages.py, its stages
in its order and under its names.

    python -m gsplat_tpu_torch.tools.profile_stages [--device cpu]

On the card: 1920x1080, 200,000 gaussians; ``--device cpu``: 256x128,
2,000. Each stage is called once to warm up and then ``iters`` times; the
card prints the host clock to ``torch.cuda.synchronize``, CUDA events
around the same calls, and the device busy time and op count of a call
from the profiler over 10 more; the CPU prints the host clock alone. The
binning runs at the right-sized capacity ceil(1.3 x pairs), as the JAX
tool's does. The gather and its backward run on the card as the render
path runs them, through the pair csrc/gather_entries_fwd.cu and
csrc/gather_entries_bwd.cu (its slot tables built outside the timed
calls), and on the CPU as the plain chain (two ``index_select``s; two
``index_add_``s); the rows are packed outside their timed calls, since on
the render path the preprocess kernel packs them. The compositor stages run on both devices, on the card
through the CUDA kernels (the JAX tool times them on the TPU only, after
re-binning into its stream kernel's strips, which the CUDA compositor does
not have).
"""
from __future__ import annotations

import argparse
import dataclasses

from gsplat_tpu_torch.tools.bench import (FIRST_PPG, SIZES, bench_scene,
                                          device_busy, launch_counts,
                                          launches_since, step_fn, timed)

ITERS = 10
STAGES = ("preprocess", "binning(sort)", "pack+gather",
          "gather VJP (scatter-add)", "composite fwd ({compositor})",
          "composite fwd+bwd ({compositor})", "render fwd",
          "render fwd+bwd (L1)", "ssim fwd+bwd", "full train step",
          "pixels/s")


def round_up(x, m):
    return -(-x // m) * m


def run(dev, *, n=None, W=None, H=None, iters=ITERS):
    """Time every stage on ``dev`` (the device's size unless ``n``, ``W``,
    ``H`` are given). Prints one line per stage and returns a dict: for
    each stage name its ``host_ms``, ``event_ms``, ``busy_ms``, ``n_ops``
    and kernel ``launches`` (over its warm-up and timed calls), and the
    binning's ``num_pairs``, ``overflow``, ``m_cap``, ``m_out``."""
    import torch

    from gsplat_tpu_torch.config import RasterizerConfig
    from gsplat_tpu_torch.models import gaussian_model as gm
    from gsplat_tpu_torch.ops import binning as binning_lib
    from gsplat_tpu_torch.ops import losses
    from gsplat_tpu_torch.ops import preprocess as preprocess_lib
    from gsplat_tpu_torch.ops.kernels.gather import (gather_entries_bwd_cuda,
                                                     gather_entries_fwd_cuda,
                                                     gather_entries_plain)
    from gsplat_tpu_torch.ops.preprocess import pack_entries
    from gsplat_tpu_torch.ops.rasterize import composite_dispatch, render
    from gsplat_tpu_torch.train import trainer

    W0, H0, n0 = SIZES[dev.type][:3]
    W, H, n = W or W0, H or H0, n or n0
    print(f"device={dev.type} {W}x{H} n={n}", flush=True)
    g, cam, gt = bench_scene(n, W, H, dev)
    cfg = RasterizerConfig(pairs_per_gaussian=FIRST_PPG)
    th, tw, G = cfg.tile_h, cfg.tile_w, cfg.chunk
    n_tiles_x, n_tiles_y = -(-W // tw), -(-H // th)
    bg = torch.zeros(3, device=dev)
    out = {}

    def stage(name, fn):
        before = launch_counts()
        host, event = timed(fn, dev, iters)
        launches = launches_since(before)
        busy = n_ops = None
        if dev.type == "cuda":
            busy, n_ops = device_busy(fn)
        out[name] = dict(host_ms=host, event_ms=event, busy_ms=busy,
                         n_ops=n_ops, launches=launches)
        dev_txt = (f" events {event:9.3f} ms, busy {busy:9.3f} ms in "
                   f"{n_ops:.1f} ops" if busy is not None
                   else " (device not measured)")
        print(f"{name:34s} {host:9.3f} ms host{dev_txt}", flush=True)
        return host

    def pre_fn():
        return preprocess_lib.preprocess(
            g.xyz, g.get_scaling(), g.get_rotation(), g.get_opacity(),
            g.get_features(), g.active_sh_degree, cam, W, H,
            active_mask=g.active, dilation=cfg.dilation,
            alpha_min=cfg.alpha_min)

    with torch.no_grad():
        pre = pre_fn()
        stage(STAGES[0], pre_fn)

        def bin_fn(m_cap, slot_tables=False):
            return binning_lib.bin_gaussians(
                pre.mean2d, pre.depth, pre.radius, rx=pre.rx, ry=pre.ry,
                image_width=W, image_height=H, tile_h=th, tile_w=tw,
                m_cap=m_cap, align=G, slot_tables=slot_tables)

        probe = bin_fn(round_up(int(n * cfg.pairs_per_gaussian), G))
        m_cap = round_up(int(int(probe.num_pairs) * 1.3), G)
        cfg = dataclasses.replace(cfg, pairs_per_gaussian=m_cap / n)
        b = bin_fn(m_cap)
        out.update(num_pairs=int(b.num_pairs), overflow=int(b.overflow),
                   m_cap=m_cap, m_out=b.gidx_sorted.shape[0])
        print(f"  num_pairs={out['num_pairs']} overflow={out['overflow']} "
              f"m_cap={m_cap} M_out={out['m_out']}", flush=True)
        stage(STAGES[1], lambda: bin_fn(m_cap))

        # the rows are packed outside the timed calls: on the render path
        # the preprocess kernel writes them
        packed = pack_entries(pre)
        on_card = dev.type == "cuda"

        def gather():
            if on_card:
                return gather_entries_fwd_cuda(packed, b.perm, b.gidx_sorted)
            return gather_entries_plain(packed, b.perm, b.gidx_sorted)
        entries = gather()
        stage(STAGES[2], gather)

        # the gather's backward as build_entries' gradient runs it: the
        # backward kernel on the card, over the slot tables that a
        # training frame's binning adds, the plain chain's two index_add_s
        # (into the depth-ordered rows, then into the packed rows) on the CPU
        b_tables = bin_fn(m_cap, slot_tables=True) if on_card else None

        def gather_vjp():
            if on_card:
                return gather_entries_bwd_cuda(entries, b_tables)
            perm_ext = torch.cat([b.perm, b.perm.new_full((1,), g.capacity)])
            rows = torch.zeros((g.capacity + 1, 16), device=dev)
            return torch.zeros_like(rows).index_add_(
                0, perm_ext, rows.index_add_(0, b.gidx_sorted, entries))
        stage(STAGES[3], gather_vjp)

        def comp(e):
            return composite_dispatch(e, b.tile_start, b.tile_count, cfg,
                                      n_tiles_x=n_tiles_x,
                                      n_tiles_y=n_tiles_y)
        stage(STAGES[4].format(compositor=cfg.compositor),
              lambda: comp(entries))

    def comp_grad():
        e = entries.detach().requires_grad_()
        o = comp(e)
        return torch.autograd.grad(o.accum.sum() + o.t_final.sum(), e)[0]
    stage(STAGES[5].format(compositor=cfg.compositor), comp_grad)

    def render_fwd():
        with torch.no_grad():
            return render(g, cam, W, H, bg, cfg).image
    img = render_fwd()
    stage(STAGES[6], render_fwd)

    def render_grad():
        t = {k: v.detach().requires_grad_()
             for k, v in gm.trainables(g).items()}
        o = render(gm.with_trainables(g, t), cam, W, H, bg, cfg)
        return torch.autograd.grad(losses.l1_loss(o.image, gt),
                                   list(t.values()))
    stage(STAGES[7], render_grad)

    def ssim_grad():
        x = img.detach().requires_grad_()
        return torch.autograd.grad(losses.ssim(x, gt), x)[0]
    stage(STAGES[8], ssim_grad)

    state = trainer.init_state(g, 1)
    step = step_fn(cam, gt, cfg)
    dt = stage(STAGES[9], lambda: step(state))
    out[STAGES[10]] = W * H / (dt / 1e3)
    print(f"{STAGES[10]}: {out[STAGES[10]]:.3e} (host clock)", flush=True)
    return out


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--device", default="cuda", choices=["cpu", "cuda"])
    args = p.parse_args(argv)

    from gsplat_tpu_torch.utils.general import resolve_device

    return run(resolve_device(args.device))


if __name__ == "__main__":
    main()
