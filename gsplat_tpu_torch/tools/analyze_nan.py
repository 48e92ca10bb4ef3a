"""Bisect a captured non-finite step (the repro npz ``debug_nan`` writes):
check the parameters, the preprocess intermediates, the entry list, the
compositor and the loss's gradients, in turn. Counterpart of
tools/analyze_nan.py, which compares the Pallas compositor with the XLA
one: on the card this compares the CUDA kernel with its plain version on
the same entries; on the CPU (``--device cpu``) the plain version runs
alone.

    python -m gsplat_tpu_torch.tools.analyze_nan [--repro nan_repro.npz]
        [--device cpu]
"""
from __future__ import annotations

import argparse

import numpy as np


def chk(name, x) -> int:
    """Print the count (and first rows) of non-finite values of ``x``."""
    x = np.asarray(x.detach().cpu().numpy() if hasattr(x, "detach") else x)
    finite = np.isfinite(x)
    n_bad = int((~finite).sum())
    rows = (f" badrows={np.unique(np.argwhere(~finite)[:, 0])[:10]}"
            if n_bad and x.ndim else "")
    print(f"{name:16s} shape={x.shape} bad={n_bad}{rows}")
    return n_bad


def load(path, device):
    """(gaussians, camera, ground truth, width, height, pair capacity)."""
    import torch

    from gsplat_tpu_torch.core.camera import FIELDS as CAM_FIELDS
    from gsplat_tpu_torch.core.camera import CameraView
    from gsplat_tpu_torch.models import gaussian_model as gm

    with np.load(path) as d:
        g = gm.from_numpy({k: d[k] for k in (*gm.TENSOR_FIELDS,
                                             "active_sh_degree")},
                          device=device)
        cam = CameraView.from_numpy({k: d["cam." + k] for k in CAM_FIELDS},
                                    device=device)
        gt = torch.tensor(d["gt"], device=device)
        return (g, cam, gt, int(d["width"]), int(d["height"]),
                float(d["pairs_per_gaussian"]),
                f"iteration {int(d['iteration'])}: {d['fields']}")


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--repro", default="nan_repro.npz")
    p.add_argument("--device", default="cuda", choices=["cpu", "cuda"])
    args = p.parse_args(argv)

    import torch

    from gsplat_tpu_torch.config import OptimizationConfig, RasterizerConfig
    from gsplat_tpu_torch.models import gaussian_model as gm
    from gsplat_tpu_torch.ops import rasterize
    from gsplat_tpu_torch.ops.composite_ref import composite_tiles_plain
    from gsplat_tpu_torch.train import trainer
    from gsplat_tpu_torch.utils.general import resolve_device

    dev = resolve_device(args.device)
    g, cam, gt, W, H, ppg, what = load(args.repro, dev)
    rcfg = RasterizerConfig(pairs_per_gaussian=ppg)
    bg = torch.zeros(3, device=dev)
    act = g.active
    print(f"{args.repro}: {what}; {int(act.sum())} live gaussians, {W}x{H}")
    bad = {}

    print("params finite?")
    bad["params"] = sum(chk(k, getattr(g, k)[act])
                        for k in gm.TRAINABLE_FIELDS)
    if int(act.sum()):
        print("scaling max:", float(g.scaling[act].max()),
              "rot |q| min:", float(g.rotation[act].norm(dim=1).min()))

    with torch.no_grad():
        e = rasterize.build_entries(g, cam, W, H, rcfg)
    pre, b = e.pre, e.binning
    print("\npreprocess intermediates (visible rows):")
    vis = pre.radius > 0
    bad["preprocess"] = sum(chk(f + "[vis]", getattr(pre, f)[vis])
                            for f in pre._fields)
    print(f"num_pairs {int(b.num_pairs)} overflow {int(b.overflow)}")
    real = b.gidx_sorted < g.capacity
    bad["entries"] = chk("entries[real]", e.entries[real])

    kw = dict(n_tiles_x=e.n_tiles_x, n_tiles_y=e.n_tiles_y,
              tile_h=rcfg.tile_h, tile_w=rcfg.tile_w, chunk=rcfg.chunk,
              alpha_min=rcfg.alpha_min, alpha_max=rcfg.alpha_max,
              t_eps=rcfg.transmittance_eps)
    args_c = (e.entries, b.tile_start, b.tile_count)
    with torch.no_grad():
        outs = {"plain": composite_tiles_plain(*args_c, **kw)}
        if dev.type == "cuda":
            outs["kernel"] = rasterize.composite_dispatch(
                *args_c, rcfg, n_tiles_x=e.n_tiles_x, n_tiles_y=e.n_tiles_y)
    bad["compositor"] = 0
    for impl, o in outs.items():
        bad["compositor"] += chk(f"{impl} accum", o.accum)
        bad["compositor"] += chk(f"{impl} t_final", o.t_final)
    if "kernel" in outs:
        diff = float((outs["kernel"].accum - outs["plain"].accum)
                     .abs().nan_to_num(float("inf")).max())
        print(f"kernel vs plain: max |accum difference| {diff:.3e}")
    with torch.no_grad():
        out = rasterize.render(g, cam, W, H, bg, rcfg)
    img = out.image
    n_img = chk("image", img)
    if not n_img:
        print(f"image range [{float(img.min()):.4f},{float(img.max()):.4f}]")
    bad["render"] = n_img + chk("invdepth", out.invdepth)

    # the train step's loss and gradients
    opt = OptimizationConfig()
    ones = torch.ones((1, H, W), device=dev)
    zeros = torch.zeros((1, H, W), device=dev)
    exposure = torch.eye(3, 4, device=dev)[None]
    loss, l1, dl1, _, grads, _, tap = trainer.camera_loss_grads(
        g, exposure, cam, gt, ones, zeros, zeros, bg, 1, image_width=W,
        image_height=H, opt=opt, rcfg=rcfg, antialiasing=False,
        train_test_exp=False, use_depth=False)
    print(f"\nloss={float(loss)} l1={float(l1)} dl1={float(dl1)}")
    bad["grads"] = sum(chk("grad." + k, v) for k, v in grads.items()) \
        + chk("tap_grad", tap)
    print("non-finite values by stage:", bad)
    return bad


if __name__ == "__main__":
    main()
