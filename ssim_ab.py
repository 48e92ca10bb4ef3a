#!/usr/bin/env python3
"""A/B of the fused SSIM's CUDA kernels built from several source
directories, in one process on one NVIDIA GPU.

    python3 ssim_ab.py name=DIR [name=DIR ...]

Each DIR holds a full copy of ``gsplat_tpu_torch/ops/kernels/csrc`` (for an
older commit: ``git archive REV gsplat_tpu_torch/ops/kernels/csrc | tar -x
-C build/REV``); the checkout's own sources are always the variant ``tree``.
Two C interfaces are known: the one-launch backward from the forward's
partial maps (``gsplat_ssim_bwd``, this tree's), and the two-launch backward
that recomputes the forward's fields (``gsplat_ssim_bwd_tmaps`` then
``gsplat_ssim_bwd_combine``, before it). On chip_smoke.py's SSIM inputs
(3x1080x1920, the training loss's shapes) it prints each variant's ptxas
report, holds every variant's map to the first one named bit for bit and
its gradient within rtol 2e-4 / atol 1e-6 under the mean's uniform
cotangent and a non-uniform one, checks that two launches give the same
bits, holds the tree to the plain versions (map and partial maps at rtol
1e-5 / atol 1e-6, gradient at the gate above against autograd through the
plain map), and times, the variants in turns and again in reverse order:
the forward alone, the forward as a training step runs it (with the
partial maps where the interface has them), the backward, and the pair (a
step's forward plus backward), by CUDA events around one call (median of
20) and by the profiler's device time of the call's kernels (``*_dev``,
mean of 5). Prints one line per measurement and a last JSON line; any
disagreement raises.
"""
import argparse
import ctypes
import json
import pathlib
import subprocess

import numpy as np
import torch

import chip_smoke as cs
from gsplat_tpu_torch.ops import ssim as ssim_lib
from gsplat_tpu_torch.ops.kernels import build
from gsplat_tpu_torch.ops.kernels import ssim as kssim

REPS = 20
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


class TwoLaunch:
    """The SSIM kernels' interface before the partial maps: the map alone;
    the backward's launch 1 recomputes the five fields and writes the t maps
    to scratch, launch 2 blurs and combines them."""

    def __init__(self, csrc):
        csrc = pathlib.Path(csrc).resolve()
        self.fwd_fn = build.load("ssim_fwd", csrc).gsplat_ssim_fwd
        self.fwd_fn.argtypes = [_P, _P, _P, _I, _I, _I, _P, _F, _F, _P]
        lib = build.load("ssim_bwd", csrc)
        self.tmaps = lib.gsplat_ssim_bwd_tmaps
        self.tmaps.argtypes = [_P, _P, _P, _P, _I, _I, _I, _P, _F, _F, _P]
        self.combine = lib.gsplat_ssim_bwd_combine
        self.combine.argtypes = [_P, _P, _P, _P, _I, _I, _I, _P, _P]

    def fwd(self, x, y, partials=False):
        out = torch.empty_like(x)
        check(self.fwd_fn(x.data_ptr(), y.data_ptr(), out.data_ptr(),
                          *x.shape, kssim._WINDOW.ctypes.data, ssim_lib.C1,
                          ssim_lib.C2, kssim._stream()), "ssim_fwd")
        return (out, None) if partials else out

    def bwd(self, x, y, g, p):
        tm = torch.empty((3,) + tuple(x.shape), device=x.device)
        dx = torch.empty_like(x)
        win = kssim._WINDOW.ctypes.data
        check(self.tmaps(x.data_ptr(), y.data_ptr(), g.data_ptr(),
                         tm.data_ptr(), *x.shape, win, ssim_lib.C1,
                         ssim_lib.C2, kssim._stream()), "ssim_bwd (t maps)")
        check(self.combine(x.data_ptr(), y.data_ptr(), tm.data_ptr(),
                           dx.data_ptr(), *x.shape, win, kssim._stream()),
              "ssim_bwd (combine)")
        return dx


class OneLaunch:
    """This tree's interface, through the wrappers, from ``csrc``."""

    def __init__(self, csrc):
        self.csrc = csrc

    def fwd(self, x, y, partials=False):
        with build.kernels_from(self.csrc):
            return kssim.ssim_fwd_cuda(x, y, partials=partials)

    def bwd(self, x, y, g, p):
        with build.kernels_from(self.csrc):
            return kssim.ssim_bwd_cuda(x, y, g, p)


def check(err, what):
    if err:
        raise RuntimeError(f"{what} launch failed: cudaError_t {err}")


def variant(csrc):
    src = (pathlib.Path(csrc) / "ssim_bwd.cu").read_text()
    return OneLaunch(csrc) if "gsplat_ssim_bwd(" in src else TwoLaunch(csrc)


def inputs(dev):
    """chip_smoke.py's SSIM inputs: images and the two cotangents."""
    rng = np.random.default_rng(cs.SEED + 1)
    a = rng.uniform(0, 1, (3, cs.H, cs.W)).astype(np.float32)
    b = np.clip(a + 0.1 * rng.standard_normal(a.shape), 0, 1)
    w = 1e-2 * rng.uniform(0, 1, a.shape)
    x, y, w = (torch.tensor(v, dtype=torch.float32, device=dev)
               for v in (a, b, w))
    return x, y, (torch.full_like(x, 1.0 / x.numel()), w)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("variants", nargs="*", metavar="name=DIR")
    ns = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("ssim_ab: no CUDA device; nothing run")
    dev = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True, timeout=60).stdout.strip()
    print(f"device: {smi}", flush=True)
    dirs = dict(v.split("=", 1) for v in ns.variants)
    dirs["tree"] = str(build.CSRC)
    names = list(dirs)
    x, y, cots = inputs(dev)

    # ---- build, ptxas report, outputs of every variant
    kern, outs = {}, {}
    for name, path in dirs.items():
        report = build.build(("ssim_fwd", "ssim_bwd"),
                             pathlib.Path(path).resolve())
        regs = "; ".join(ln.strip() for _, _, log in report.values()
                         for ln in log.splitlines()
                         if "registers" in ln or "spill" in ln
                         or "Compiling entry" in ln)
        print(f"build {name}: {regs}", flush=True)
        k = kern[name] = variant(path)
        m = k.fwd(x, y)
        m2, p = k.fwd(x, y, partials=True)
        cs.check(torch.equal(m, m2), f"{name}: the map differs with and "
                 f"without the partial maps")
        grads = []
        for g in cots:
            d1, d2 = k.bwd(x, y, g, p), k.bwd(x, y, g, p)
            torch.cuda.synchronize()
            cs.check(torch.equal(d1, d2), f"{name}: two backward launches "
                     f"differ")
            grads.append(d1)
        outs[name] = (m, p, grads)

    # ---- the tree against the plain versions
    m, p, grads = outs["tree"]
    with torch.no_grad():
        want_m = ssim_lib.ssim_map(x, y)
        want_p = kssim.ssim_partials_plain(x, y)
    errs = dict(map=float((m - want_m).abs().max()),
                p=float((p - want_p).abs().max()))
    cs.check(torch.allclose(m, want_m, **cs.SSIM_TOL), f"map vs plain "
             f"{errs['map']}")
    cs.check(torch.allclose(p, want_p, **cs.SSIM_TOL), f"partial maps vs "
             f"plain {errs['p']}")
    xg = x.clone().requires_grad_()
    mg = ssim_lib.ssim_map(xg, y)
    for i, g in enumerate(cots):
        want = torch.autograd.grad(mg, xg, g, retain_graph=True)[0]
        errs[f"grad{i}"] = float((grads[i] - want).abs().max())
        cs.check(torch.allclose(grads[i], want, **cs.SSIM_GRAD_TOL),
                 f"gradient {i} vs autograd {errs[f'grad{i}']}")
    del xg, mg
    print(f"tree vs plain: map {errs['map']:.3e}, partial maps "
          f"{errs['p']:.3e}, gradient vs autograd (uniform, non-uniform) "
          f"{errs['grad0']:.3e} {errs['grad1']:.3e}; map bit-equal to the "
          f"plain map: {bool(torch.equal(m, want_m))}, partial maps: "
          f"{bool(torch.equal(p, want_p))}", flush=True)

    base = names[0]
    for name in names[1:]:
        m0, _, g0 = outs[base]
        m1, _, g1 = outs[name]
        cs.check(torch.equal(m0, m1), f"{name}: the map differs from "
                 f"{base}'s by {float((m0 - m1).abs().max())}")
        gerr = []
        for a, b in zip(g0, g1):
            gerr.append(float((a - b).abs().max()))
            cs.check(torch.allclose(b, a, **cs.SSIM_GRAD_TOL),
                     f"{name}: gradient differs from {base}'s by {gerr[-1]}")
        print(f"{name} vs {base}: map bit-equal, gradients within rtol "
              f"{cs.SSIM_GRAD_TOL['rtol']} / atol {cs.SSIM_GRAD_TOL['atol']} "
              f"(max abs difference {gerr[0]:.3e}, {gerr[1]:.3e}; bit-equal "
              f"{[bool(torch.equal(a, b)) for a, b in zip(g0, g1)]})",
              flush=True)

    # ---- times, the variants in turns, then in reverse
    keys = ("fwd", "fwd_step", "bwd", "pair")
    times = {n: {k: [] for k in keys + tuple(f"{k}_dev" for k in keys)}
             for n in names}
    g = cots[1]
    for order in (names, names[::-1]):
        for name in order:
            k = kern[name]
            p = outs[name][1]
            calls = {
                "fwd": lambda: k.fwd(x, y),
                "fwd_step": lambda: k.fwd(x, y, partials=True),
                "bwd": lambda: k.bwd(x, y, g, p),
                "pair": lambda: k.bwd(x, y, g,
                                      k.fwd(x, y, partials=True)[1]),
            }
            for key, fn in calls.items():
                fn()
                times[name][key].append(cs.median_ms(fn, REPS))
                times[name][f"{key}_dev"].append(cs.kernel_device_ms(fn, 5))
    for name in names:
        print(f"times {name} (ms, two turns): " + ", ".join(
            f"{k} {[round(v, 4) for v in t]}" for k, t in times[name].items()),
            flush=True)
    print(json.dumps({"device": smi, "base": base, "errors": errs,
                      "times": times}), flush=True)


if __name__ == "__main__":
    main()
