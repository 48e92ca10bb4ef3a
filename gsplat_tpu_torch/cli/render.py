"""Offline rendering CLI: renders every train/test camera of a trained
model directory to ``<model>/<split>/ours_<iter>/{renders,gt}/NNNNN.png``.
Same flags and output layout as gsplat_tpu/cli/render.py, plus
``--device`` (default ``cuda``)."""
from __future__ import annotations

import json
import os
from argparse import ArgumentParser

import numpy as np
import torch


def _save_png(path: str, img_chw: np.ndarray):
    from PIL import Image
    arr = (np.clip(img_chw, 0, 1).transpose(1, 2, 0) * 255 + 0.5).astype(np.uint8)
    Image.fromarray(arr).save(path)


@torch.no_grad()
def render_set(model_path, name, iteration, views, gaussians, rcfg, pipe,
               background, train_test_exp, exposures=None, exposure_map=None):
    """Write renders/ and gt/ PNGs for ``views``."""
    from gsplat_tpu_torch.core import sh as sh_lib
    from gsplat_tpu_torch.ops.rasterize import render

    dev = gaussians.device
    render_path = os.path.join(model_path, name, f"ours_{iteration}", "renders")
    gts_path = os.path.join(model_path, name, f"ours_{iteration}", "gt")
    os.makedirs(render_path, exist_ok=True)
    os.makedirs(gts_path, exist_ok=True)

    # --compute_cov3D_python / --convert_SHs_python feed the same quantities
    # through the precomputed-input arguments, exercising that plumbing.
    cov3d = gaussians.get_covariance() if pipe.compute_cov3D_python else None
    for idx, view in enumerate(views):
        cv = view.view(dev)
        exposure = None
        if train_test_exp and exposures is not None and exposure_map:
            ei = exposure_map.get(view.image_name, -1)
            if ei >= 0:
                exposure = torch.tensor(exposures[ei], device=dev)
        override_color = None
        if pipe.convert_SHs_python:
            dirs = gaussians.xyz - cv.camera_center[None, :]
            dirs = dirs / torch.clamp(
                torch.linalg.norm(dirs, dim=-1, keepdim=True), min=1e-8)
            override_color = torch.clamp(sh_lib.eval_sh(
                gaussians.active_sh_degree,
                gaussians.get_features().transpose(1, 2), dirs) + 0.5, min=0.0)
        out = render(gaussians, cv, view.width, view.height, background, rcfg,
                     antialiasing=pipe.antialiasing, exposure=exposure,
                     override_color=override_color, cov3d_precomp=cov3d)
        if int(out.overflow):
            raise RuntimeError(
                f"pair list overflowed by {int(out.overflow)} entries on view "
                f"{idx}; raise --pairs_per_gaussian or --pad_cap")
        img = out.image.cpu().numpy()
        gt = np.asarray(view.image)[:3]
        if train_test_exp:
            img = img[..., img.shape[-1] // 2:]
            gt = gt[..., gt.shape[-1] // 2:]
        _save_png(os.path.join(render_path, f"{idx:05d}.png"), img)
        _save_png(os.path.join(gts_path, f"{idx:05d}.png"), gt)


def main(argv=None):
    from gsplat_tpu_torch import config as cfg_lib
    from gsplat_tpu_torch.scene import Scene
    from gsplat_tpu_torch.utils.general import resolve_device, safe_state

    parser = ArgumentParser(description="Testing script parameters")
    cfg_lib.add_model_args(parser)
    cfg_lib.add_pipeline_args(parser)
    cfg_lib.add_rasterizer_args(parser)
    parser.add_argument("--iteration", default=-1, type=int)
    parser.add_argument("--skip_train", action="store_true")
    parser.add_argument("--skip_test", action="store_true")
    parser.add_argument("--quiet", action="store_true")
    parser.add_argument("--device", default="cuda")
    args = cfg_lib.get_combined_args(parser, argv)
    device = resolve_device(args.device)
    print("Rendering " + args.model_path)

    dataset = cfg_lib.extract(cfg_lib.ModelConfig, args)
    pipe = cfg_lib.extract(cfg_lib.PipelineConfig, args)
    rcfg = cfg_lib.extract(cfg_lib.RasterizerConfig, args)
    safe_state(args.quiet)

    scene = Scene(dataset, dataset.sh_degree, load_iteration=args.iteration,
                  shuffle=False, device=device)
    bg = torch.tensor([1.0, 1.0, 1.0] if dataset.white_background
                      else [0.0, 0.0, 0.0], dtype=torch.float32, device=device)

    exposures, exp_map = None, None
    exp_path = os.path.join(dataset.model_path, "exposure.json")
    if dataset.train_test_exp and os.path.exists(exp_path):
        with open(exp_path) as f:
            exp_json = json.load(f)
        exp_map = {k: i for i, k in enumerate(exp_json)}
        exposures = np.asarray([exp_json[k] for k in exp_json], np.float32)

    for split, skip, views in (("train", args.skip_train,
                                scene.getTrainCameras()),
                               ("test", args.skip_test,
                                scene.getTestCameras())):
        if not skip:
            render_set(dataset.model_path, split, scene.loaded_iter, views,
                       scene.gaussians, rcfg, pipe, bg,
                       dataset.train_test_exp, exposures, exp_map)


if __name__ == "__main__":
    main()
