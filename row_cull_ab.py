#!/usr/bin/env python3
"""Per-tile-row ellipse culling (``RasterizerConfig.row_cull``) off against
on, on a trained model, in one process on one NVIDIA GPU.

    python3 row_cull_ab.py -m <model_dir>

Loads the model's latest ``point_cloud`` and its scene's cameras (from
``cfg_args.json``), and prints: the live gaussians and the distribution of
their scales (the largest axis in world units and the ratio of the largest
to the smallest, percentiles), the pairs of every held-out camera with
culling off and on, and, on the first held-out camera, the images of both
(held within the image gate), a step's peak device memory
(``max_memory_allocated``), then frames and train steps timed in turns and
profiled by ``chip_smoke.cull_turns``, as phase 5b of chip_smoke.py does on
an isotropic synthetic scene. A pair capacity of 1.5x the largest probe's
pairs a gaussian serves both. The last line is a JSON object of the
numbers.
"""
import argparse
import dataclasses
import json

import torch

import chip_smoke as cs
from gsplat_tpu_torch import config as cfg_lib
from gsplat_tpu_torch.config import OptimizationConfig, RasterizerConfig
from gsplat_tpu_torch.ops import rasterize
from gsplat_tpu_torch.scene import Scene
from gsplat_tpu_torch.train import trainer

PERCENTILES = (50, 90, 99, 100)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("-m", "--model_path", required=True)
    args = p.parse_args(argv)

    dev = torch.device("cuda")
    saved = cfg_lib.load_cfg(args.model_path)["model"]
    dataset = dataclasses.replace(saved, model_path=args.model_path)
    scene = Scene(dataset, dataset.sh_degree, load_iteration=-1,
                  shuffle=False, device=dev)
    g = scene.gaussians
    n = g.num_active()
    s = g.get_scaling()[g.active]
    top, low = s.max(dim=1).values, s.min(dim=1).values
    scales = {"max_axis": [float(torch.quantile(top, q / 100))
                           for q in PERCENTILES],
              "max_over_min": [float(torch.quantile(top / low, q / 100))
                               for q in PERCENTILES]}
    cams = scene.getTestCameras() or scene.getTrainCameras()[:1]
    bg = torch.zeros(3, device=dev)

    probe = RasterizerConfig(pairs_per_gaussian=256.0)
    most = 0
    with torch.no_grad():
        for cam in cams:
            e = rasterize.build_entries(g, cam.view(dev), cam.width,
                                        cam.height, probe)
            cs.check(int(e.binning.overflow) == 0, "probe overflow")
            most = max(most, int(e.binning.num_pairs))
    cfg = RasterizerConfig(pairs_per_gaussian=1.5 * most / g.capacity)
    ccfg = dataclasses.replace(cfg, row_cull=True)
    pairs = {"off": [], "on": []}
    with torch.no_grad():
        for cam in cams:
            for tag, c in (("off", cfg), ("on", ccfg)):
                e = rasterize.build_entries(g, cam.view(dev), cam.width,
                                            cam.height, c)
                cs.check(int(e.binning.overflow) == 0, "pair overflow")
                pairs[tag].append(int(e.binning.num_pairs))

    cam = cams[0]
    view, W, H = cam.view(dev), cam.width, cam.height
    gt = torch.clamp(torch.tensor(cam.image, device=dev), 0.0, 1.0)
    with torch.no_grad():
        r0 = rasterize.render(g, view, W, H, bg, cfg)
        r1 = rasterize.render(g, view, W, H, bg, ccfg)
    img_err = float((r0.image - r1.image).abs().max())
    cs.check(torch.allclose(r1.image, r0.image, **cs.IMG_TOL),
             f"row_cull image {img_err} from the rectangle render's")

    opt = OptimizationConfig()
    state = trainer.init_state(g, 1)
    ones = torch.ones((1, H, W), device=dev)
    zeros = torch.zeros((1, H, W), device=dev)
    peak_gb = []
    for c in (cfg, ccfg):            # warm-up, and each step's peak memory
        with torch.no_grad():
            rasterize.render(g, view, W, H, bg, c)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        trainer.train_step(
            state, view, gt, ones, zeros, zeros, bg, image_width=W,
            image_height=H, opt=opt, rcfg=c, spatial_lr_scale=1.0,
            antialiasing=False, use_sparse_adam=False, train_test_exp=False,
            use_depth=False)
        torch.cuda.synchronize()
        peak_gb.append(torch.cuda.max_memory_allocated() / 1e9)
    med, busy, _ = cs.cull_turns(g, view, gt, W, H, cfg, state)
    res = dict(model=args.model_path, iteration=scene.loaded_iter,
               n_live=n, capacity=g.capacity, width=W, height=H,
               scale_percentiles=list(PERCENTILES), **scales,
               pairs_off=pairs["off"], pairs_on=pairs["on"],
               pair_share_on=sum(pairs["on"]) / max(sum(pairs["off"]), 1),
               image_max_abs_err=img_err, frame_ms=med["frame"],
               step_ms=med["step"], busy_ms=busy, step_peak_gb=peak_gb)
    print(f"row_cull A/B on {args.model_path} (iteration "
          f"{scene.loaded_iter}): {n} live gaussians of {g.capacity}; "
          f"largest axis p{PERCENTILES} {scales['max_axis']}, largest / "
          f"smallest {scales['max_over_min']}; pairs off {pairs['off']} on "
          f"{pairs['on']} ({res['pair_share_on']:.4f}); image max |off - "
          f"on| {img_err:.3e}; host median frame ms off / on "
          f"{med['frame'][0]:.3f} / {med['frame'][1]:.3f}, step "
          f"{med['step'][0]:.3f} / {med['step'][1]:.3f} (turns off, on, on, "
          f"off x {cs.CULL_ROUNDS}); device busy frame {busy['frame off']:.3f} "
          f"/ {busy['frame on']:.3f}, step {busy['step off']:.3f} / "
          f"{busy['step on']:.3f}; a step's peak memory off / on "
          f"{peak_gb[0]:.3f} / {peak_gb[1]:.3f} GB", flush=True)
    print(json.dumps(res), flush=True)
    return res


if __name__ == "__main__":
    main()
