#!/usr/bin/env python3
"""A/B of the tile compositor's CUDA kernels and the slab transmittance
built from several source directories, in one process on one NVIDIA GPU.

    python3 compositor_ab.py name=DIR [name=DIR ...] [--profile]

Each DIR holds a full copy of ``gsplat_tpu_torch/ops/kernels/csrc`` (for an
older commit: ``git archive REV gsplat_tpu_torch/ops/kernels/csrc | tar -x
-C build/REV``); the checkout's own sources are always the variant ``tree``.
On chip_smoke.py's training frame (1920x1080, 200,000 gaussians) and on that
frame split into 4 depth slabs with each slab's arriving transmittance, it
times ``composite_fwd``, ``composite_bwd`` and ``slab_tmit`` of every
variant by CUDA events around one call (median of 20; on an idle device
that interval also holds the wrapper's host time before the launch, which
weighs on the short slab launches) and by the profiler's device time of the
call's kernels (``*_dev``, mean of 5; the backward's includes zeroing
d_entries), the variants in turns and again in reverse order, and holds
every variant to the first one named: the forward's accum, t_final and
n_contrib and the slab transmittance bit for bit, the backward zero exactly
where the first one's is zero and elsewhere within 1e-4 of the largest
gradient (both re-associate sums that cancel, so the element-wise gradient
gate is held against autograd in chip_smoke.py, not here; the share of
elements outside it is printed), and the backward and the slab
transmittance the same bits on a second launch. ``tmit_slabs`` sums the
slabs the slab render runs the slab transmittance on (all but the
farthest), ``tmit_farthest`` is the last. With ``--profile`` it also prints
the profiler's device busy time of one training step, one frame and one
4-slab frame under each variant. Prints one line per measurement and a last
JSON line; any disagreement raises.

A variant of the tree's slab transmittance is a copy of ``csrc/`` with one
constant edited, e.g. its blocks per SM:
``sed -i 's/kMinBlocks = 6;/kMinBlocks = 4;/' build/b4/csrc/slab_tmit.cu``.
"""
import argparse
import json
import pathlib
import subprocess

import numpy as np
import torch

import chip_smoke as cs
from gsplat_tpu_torch.config import OptimizationConfig
from gsplat_tpu_torch.ops import rasterize
from gsplat_tpu_torch.ops.kernels import build
from gsplat_tpu_torch.ops.kernels import composite as kcomp
from gsplat_tpu_torch.parallel import prim_shard
from gsplat_tpu_torch.train import trainer

REPS = 20


def frames(dev):
    """The launches to time: (label, forward args, forward keywords), the
    training frame first, then its 4 slabs with their arriving
    transmittance; the training scene; the per-slab pair capacity."""
    g, cam, gt, cfg = cs.bench_train_setup(dev)
    with torch.no_grad():
        e = rasterize.build_entries(g, cam, cs.W, cs.H, cfg)
        m_cap, _ = cs.slab_m_cap(g, cam, cfg)
        slabs = prim_shard.build_slab_entries(g, cam, cs.W, cs.H, cfg,
                                              n_slabs=cs.N_SLABS, m_cap=m_cap)
        t_arrive = prim_shard.arriving_transmittance(slabs, cfg)
    geo = dict(n_tiles_x=e.n_tiles_x, n_tiles_y=e.n_tiles_y,
               tile_h=cfg.tile_h, tile_w=cfg.tile_w, chunk=cfg.chunk,
               alpha_min=cfg.alpha_min, alpha_max=cfg.alpha_max,
               t_eps=cfg.transmittance_eps)
    out = [("frame", (e.entries, e.binning.tile_start, e.binning.tile_count),
            geo)]
    for k, s in enumerate(slabs):
        out.append((f"slab{k}", (s.entries, s.binning.tile_start,
                                 s.binning.tile_count),
                    dict(geo, t_init=t_arrive[k])))
    return out, (g, cam, gt, cfg), m_cap


def bwd_kw(kw):
    return {k: v for k, v in kw.items() if k not in ("chunk", "t_eps",
                                                     "t_init")}


def tmit_kw(kw):
    return {k: v for k, v in kw.items() if k not in ("t_eps", "t_init")}


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("variants", nargs="*", metavar="name=DIR")
    ap.add_argument("--profile", action="store_true")
    ns = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("compositor_ab: no CUDA device; nothing run")
    dev = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True, timeout=60).stdout.strip()
    print(f"device: {smi}", flush=True)
    variants = dict(v.split("=", 1) for v in ns.variants)
    variants["tree"] = str(build.CSRC)
    names = list(variants)

    work, (g, cam, gt, cfg), m_cap = frames(dev)
    rng = np.random.default_rng(cs.SEED + 1)
    T, P = work[0][2]["n_tiles_x"] * work[0][2]["n_tiles_y"], \
        cfg.tile_h * cfg.tile_w
    ga, g_t = cs.cotangents(rng, T, P, dev)

    # ---- build, ptxas report, outputs of every variant
    outs = {}
    for name, path in variants.items():
        with build.kernels_from(path):
            report = build.build(("composite_fwd", "composite_bwd",
                                  "slab_tmit"), pathlib.Path(path).resolve())
            regs = "; ".join(
                ln.split(":", 1)[-1].strip() for _, _, log in report.values()
                for ln in log.splitlines()
                if any(w in ln for w in ("entry function", "registers",
                                         "spill")))
            print(f"build {name}: {regs}", flush=True)
            outs[name] = []
            with torch.no_grad():
                for label, args, kw in work:
                    fwd = kcomp.composite_fwd_cuda(*args, **kw)
                    bargs = args + (fwd.t_final, fwd.n_contrib, ga, g_t)
                    d = kcomp.composite_bwd_cuda(*bargs, **bwd_kw(kw))
                    d2 = kcomp.composite_bwd_cuda(*bargs, **bwd_kw(kw))
                    tm = kcomp.slab_transmittance_cuda(*args, **tmit_kw(kw))
                    tm2 = kcomp.slab_transmittance_cuda(*args, **tmit_kw(kw))
                    torch.cuda.synchronize()
                    cs.check(torch.equal(d, d2),
                             f"{name} {label}: two backward launches differ")
                    cs.check(torch.equal(tm, tm2), f"{name} {label}: two "
                             f"slab_tmit launches differ")
                    outs[name].append((fwd, d, tm))
    base = names[0]
    for name in names[1:]:
        for (label, _, _), (f0, d0, m0), (f1, d1, m1) in zip(
                work, outs[base], outs[name]):
            for k in ("accum", "t_final", "n_contrib"):
                cs.check(torch.equal(getattr(f0, k), getattr(f1, k)),
                         f"{name} {label}: forward {k} differs from {base}")
            cs.check(torch.equal(m0, m1),
                     f"{name} {label}: slab_tmit differs from {base}")
            cs.check(torch.equal(d0 == 0, d1 == 0),
                     f"{name} {label}: backward zero pattern differs")
            err = float((d0 - d1).abs().max())
            size = float(d0.abs().max())
            out = (d0 - d1).abs() > cs.GRAD_TOL["atol"] \
                + cs.GRAD_TOL["rtol"] * d0.abs()
            cs.check(err <= cs.SLAB_GRAD_REL_MAX * size,
                     f"{name} {label}: backward differs by {err} of {size}")
            print(f"{name} vs {base} on {label}: forward and slab_tmit "
                  f"bit-equal, backward "
                  f"zero where it was zero, max abs difference {err:.3e} "
                  f"(largest gradient {size:.3e}), share of elements outside "
                  f"rtol {cs.GRAD_TOL['rtol']} / atol {cs.GRAD_TOL['atol']} "
                  f"{float(out.float().mean()):.3e}", flush=True)

    # ---- times, the variants in turns, then in reverse
    times = {n: {k: [] for k in ("fwd", "bwd", "tmit", "fwd_dev", "bwd_dev",
                                 "tmit_dev")}
             for n in names}
    for order in (names, names[::-1]):
        for name in order:
            with build.kernels_from(variants[name]), torch.no_grad():
                ms = {k: [] for k in times[name]}
                for (label, args, kw), (fwd, _, _) in zip(work, outs[name]):
                    bargs = args + (fwd.t_final, fwd.n_contrib, ga, g_t)

                    def run_fwd():
                        kcomp.composite_fwd_cuda(*args, **kw)

                    def run_bwd():
                        kcomp.composite_bwd_cuda(*bargs, **bwd_kw(kw))

                    def run_tmit():
                        kcomp.slab_transmittance_cuda(*args, **tmit_kw(kw))

                    run_fwd()
                    for which, fn in (("fwd", run_fwd), ("bwd", run_bwd),
                                      ("tmit", run_tmit)):
                        ms[which].append(cs.median_ms(fn, REPS))
                        ms[f"{which}_dev"].append(cs.kernel_device_ms(fn, 5))
                for k, v in ms.items():
                    times[name][k].append(v)
    result = {}
    for name in names:
        row = {}
        for which in times[name]:
            a = np.array(times[name][which])          # (2 turns, 1 + slabs)
            row[f"{which}_frame_ms"] = a[:, 0].tolist()
            if which.startswith("tmit"):
                row[f"{which}_slabs_ms"] = a[:, 1:-1].sum(axis=1).tolist()
                row[f"{which}_farthest_ms"] = a[:, -1].tolist()
            else:
                row[f"{which}_slabs_ms"] = a[:, 1:].sum(axis=1).tolist()
        result[name] = row
        print(f"times {name}: " + ", ".join(
            f"{k} {[round(x, 4) for x in v]}" for k, v in row.items()),
            flush=True)

    if ns.profile:
        opt = OptimizationConfig()
        bg = torch.zeros(3, device=dev)
        for name in names + names[::-1]:
            with build.kernels_from(variants[name]):
                state = trainer.init_state(g, 1)
                state, _ = cs.train(state, cam, gt, cfg, opt)     # warm-up
                torch.cuda.synchronize()
                cs.profile_call(f"{name}: one train step",
                                lambda: cs.train(state, cam, gt, cfg, opt),
                                n_top=4)

                def one_frame():
                    with torch.no_grad():
                        rasterize.render(g, cam, cs.W, cs.H, bg, cfg)
                one_frame()
                cs.profile_call(f"{name}: one frame", one_frame, n_top=4)

                def one_slab_frame():
                    with torch.no_grad():
                        prim_shard.render_prim_sharded(
                            g, cam, cs.W, cs.H, bg, cfg, n_slabs=cs.N_SLABS,
                            m_cap=m_cap)
                one_slab_frame()
                cs.profile_call(f"{name}: one slab frame", one_slab_frame,
                                n_top=6)
    print(json.dumps({"device": smi, "base": base, "times": result}),
          flush=True)


if __name__ == "__main__":
    main()
