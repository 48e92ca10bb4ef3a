#!/usr/bin/env python3
"""The fused per-gaussian preprocess (csrc/preprocess_fwd.cu,
csrc/preprocess_bwd.cu) against the plain path it replaces, on one NVIDIA
GPU, at a trained scene's size.

    python3 preprocess_ab.py [--n 3000000] [--sh 3] [--width 1297 --height 840]
                             [--csrc DIR]

N gaussians of SH degree ``--sh`` (all live, the active degree the
maximum) in front of a camera of focal 1,150 px, made on the card from a
fixed seed. It holds the fused pair to the plain path
(``preprocess_packed_plain`` under autograd) on the same inputs: the
packed rows at rtol 1e-5 / atol 1e-6 of each column's largest entry,
radius / rx / ry equal, each raw field's gradient under one random
cotangent of the packed rows at rtol 5e-3 / atol 1e-6 of its largest
entry, each on all but max(10, N / 100,000) entries at a rounding edge
(their count and the first five printed). Then it
times, the two paths in turns and again in reverse order: the forward
(one launch, or the plain path's ops) and the forward plus backward (as a
training step runs it, under autograd), by CUDA events around one call
(median of 20), and counts the device operations of one call of each in
the profiler. The bounds are the bytes each kernel must move at 3.35 TB/s
(every input read once, every output written once). Prints one line per
measurement and a last JSON line; a disagreement raises. ``--csrc`` builds
and launches the kernels from another copy of
``gsplat_tpu_torch/ops/kernels/csrc`` (an older commit's, or a variant).
"""
import argparse
import json
import subprocess

import numpy as np
import torch

from gsplat_tpu_torch.core.camera import CameraView
from gsplat_tpu_torch.models import gaussian_model as gm
from gsplat_tpu_torch.ops import preprocess as tpre
from gsplat_tpu_torch.ops.kernels import build
from gsplat_tpu_torch.ops.kernels import preprocess as kpre

REPS = 20
HBM_BYTES_PER_S = 3.35e12


def scene(n: int, deg: int, dev):
    """A 3M-row state like a trained Mip-NeRF 360 model's, on the card."""
    gen = torch.Generator(device=dev).manual_seed(0)
    K = (deg + 1) ** 2

    def randn(*shape, scale=1.0):
        return scale * torch.randn(shape, generator=gen, device=dev)
    xyz = randn(n, 3, scale=2.0)
    xyz[:, 2] += 6.0
    g = gm.GaussianParams(
        xyz=xyz, f_dc=randn(n, 3), f_rest=randn(n, K - 1, 3, scale=0.2),
        scaling=randn(n, 3, scale=0.5) - 4.0, rotation=randn(n, 4),
        opacity=randn(n, scale=2.0),
        active=torch.ones(n, dtype=torch.bool, device=dev),
        active_sh_degree=deg)
    return g


def camera(W, H, dev):
    focal = 1150.0
    fovx = 2 * np.arctan(W / (2 * focal))
    fovy = 2 * np.arctan(H / (2 * focal))
    return CameraView.create(np.eye(3), np.zeros(3), fovx, fovy, device=dev)


def leaves_of(g):
    leaves = {k: getattr(g, k).detach().clone().requires_grad_()
              for k in gm.TRAINABLE_FIELDS}
    return gm.with_trainables(g, leaves), leaves


def median_ms(fn):
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(REPS):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def device_ops(fn):
    """Device operations (kernels, copies, sets) of one call."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(e.count for e in prof.key_averages()
               if e.device_type.name == "CUDA")


def close(name, got, want, rtol, atol_frac, allowed):
    """Within rtol / atol of the largest entry, column by column, on all but
    ``allowed`` entries; returns the largest gap over the column's largest
    and the entries past the gate, at most 5 printed."""
    got, want = got.reshape(got.shape[0], -1), want.reshape(want.shape[0], -1)
    scale = want.abs().amax(dim=0).clamp(min=1.0)
    bad = (got - want).abs() > atol_frac * scale + rtol * want.abs()
    both_nan = torch.isnan(got) & torch.isnan(want)
    bad = bad & ~both_nan | (torch.isnan(got) ^ torch.isnan(want))
    where = torch.nonzero(bad)
    for r, c in where[:5].tolist():
        print(f"  {name}[{r}, {c}]: {float(got[r, c])!r} against "
              f"{float(want[r, c])!r}", flush=True)
    if len(where) > allowed:
        raise AssertionError(f"{name}: {len(where)} entries off")
    gap = ((got - want).abs() / scale).nan_to_num(0.0)
    return float(gap.max()), len(where)


KW = dict(scaling_modifier=1.0, antialiasing=False, dilation=0.3,
          alpha_min=1.0 / 255.0)


def hold(g, cam, W: int, H: int, ct, kw=KW) -> dict:
    """The fused pair against the plain path on ``g`` under the cotangent
    ``ct`` (N+1, 16) of the packed rows: the gates of the module docstring;
    returns the largest gaps, the entries past the gate and the integer
    columns' differing rows."""
    n = g.capacity
    tap = torch.zeros((n, 2), device=ct.device)
    res = {}
    for fused in (False, True):
        gg, leaves = leaves_of(g)
        t = tap.clone().requires_grad_()
        run = tpre.preprocess_packed if fused else \
            tpre.preprocess_packed_plain
        pre, packed = run(gg, cam, W, H, mean2d_tap=t, **kw)
        (packed * ct).sum().backward()
        res[fused] = (packed.detach(), pre,
                      {k: v.grad for k, v in leaves.items()}, t.grad)
    (p0, r0, g0, t0), (p1, r1, g1, t1) = res[False], res[True]
    allowed = max(10, n // 100_000)     # rows at a rounding edge
    gaps = {"packed": close("packed", p1, p0, 1e-5, 1e-6, allowed)}
    ceil_edge = {k: int((getattr(r1, k) != getattr(r0, k).detach()).sum())
                 for k in ("radius", "rx", "ry")}
    if max(ceil_edge.values()) > allowed:
        raise AssertionError(f"integer columns differ: {ceil_edge}")
    for k in gm.TRAINABLE_FIELDS:
        gaps["d_" + k] = close("d_" + k, g1[k], g0[k], 5e-3, 1e-6, allowed)
    gaps["d_tap"] = close("d_tap", t1, t0, 5e-3, 1e-6, allowed)
    return dict(gaps=gaps, ceil_edge=ceil_edge,
                visible=float((r0.radius > 0).float().mean()))


def measure(g, cam, W: int, H: int, d_packed, kw=KW) -> dict:
    """The two paths' times (each call's median of 20 by CUDA events, in
    turns and again in reverse order), device operations of one call and
    the fused kernels' byte bounds."""
    n = g.capacity
    tap = torch.zeros((n, 2), device=d_packed.device)
    fields = (g.xyz, g.scaling, g.rotation, g.opacity, g.f_dc, g.f_rest,
              g.active)
    s = kpre.Settings(W, H, g.active_sh_degree, **kw)

    def plain_fwd():
        with torch.no_grad():
            tpre.preprocess_packed_plain(g, cam, W, H, mean2d_tap=tap, **kw)

    def fused_fwd():
        kpre.preprocess_fwd_cuda(fields, tap, cam, s)

    def fused_bwd():
        kpre.preprocess_bwd_cuda(fields, cam, s, d_packed, True)

    def step(run):
        gg, leaves = leaves_of(g)
        t = tap.clone().requires_grad_()

        def call():
            for x in (*leaves.values(), t):
                x.grad = None
            _, packed = run(gg, cam, W, H, mean2d_tap=t, **kw)
            packed.backward(d_packed)
        return call

    calls = {"plain_fwd": plain_fwd, "fused_fwd": fused_fwd,
             "fused_bwd": fused_bwd,
             "plain_fwd_bwd": step(tpre.preprocess_packed_plain),
             "fused_fwd_bwd": step(tpre.preprocess_packed)}
    ms = {k: [] for k in calls}
    order = list(calls)
    for turn in order + order[::-1]:
        ms[turn].append(median_ms(calls[turn]))
    ops = {k: device_ops(fn) for k, fn in calls.items()}
    K = g.f_rest.shape[1] + 1
    in_b = n * (4 * (3 + 3 + 4 + 1 + 3 * K) + 1)
    fwd_b = in_b + n * 8 + n * 64 + n * 20     # + the tap in, rows out
    # the backward reads columns 0-9 of d packed and writes 61 floats
    bwd_b = in_b + n * 40 + n * 4 * (3 + 3 + 4 + 1 + 3 * K + 2)
    bound = {"fused_fwd": fwd_b / HBM_BYTES_PER_S * 1e3,
             "fused_bwd": bwd_b / HBM_BYTES_PER_S * 1e3}
    return dict(ms=ms, device_ops=ops, bound_ms=bound)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=3_000_000)
    ap.add_argument("--sh", type=int, default=3)
    ap.add_argument("--width", type=int, default=1297)
    ap.add_argument("--height", type=int, default=840)
    ap.add_argument("--csrc", default=str(build.CSRC))
    args = ap.parse_args()
    with build.kernels_from(args.csrc):
        run(args)


def run(args):
    dev = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    print(f"device: {torch.cuda.get_device_name(0)} | {smi}", flush=True)
    W, H = args.width, args.height
    g = scene(args.n, args.sh, dev)
    cam = camera(W, H, dev)
    ct = torch.randn((args.n + 1, 16), device=dev,
                     generator=torch.Generator(device=dev).manual_seed(1))
    agree = hold(g, cam, W, H, ct)
    print(f"agreement at N={args.n}: largest gap over the column's largest "
          f"and entries past the gate {agree['gaps']}; radius/rx/ry "
          f"differing {agree['ceil_edge']}; visible "
          f"{agree['visible']:.3f}", flush=True)
    m = measure(g, cam, W, H, ct)
    for k, ms in m["ms"].items():
        print(f"{k}: {ms[0]:.4f} / {ms[1]:.4f} ms (turns), "
              f"{m['device_ops'][k]} device ops"
              + (f", bound {m['bound_ms'][k]:.4f} ms"
                 if k in m["bound_ms"] else ""), flush=True)
    print(json.dumps({"device": smi, "csrc": args.csrc, "n": args.n,
                      "sh": args.sh, **m,
                      **agree,
                      "launches": {"fwd": kpre.preprocess_fwd_cuda.launches,
                                   "bwd": kpre.preprocess_bwd_cuda.launches}
                      }))


if __name__ == "__main__":
    main()
