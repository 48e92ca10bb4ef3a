"""Hunt the first non-finite value in training. Counterpart of
tools/debug_nan.py.

    python -m gsplat_tpu_torch.tools.debug_nan [iters] [--device cpu]
        [--repro nan_repro.npz]
    python -m gsplat_tpu_torch.tools.debug_nan --snapshot <model>/snapshot_iterN.npz

Without ``--snapshot`` it trains the scene of ``drive_train`` (the card's
sizes, or the CPU's with ``--device cpu``; 32 pairs a gaussian, every camera
drawn) and checks, after each iteration, the loss, every gradient, every
parameter and every Adam moment of the live rows, and after each densify
event the parameters again. ``--snapshot`` replays the one step a ``--debug``
snapshot of the training loop holds (the state the failing step started
from, its camera and images; default configs, black background) with the
same checks. At the first non-finite value it prints the iteration and the
fields, and writes the step's inputs to the repro npz that
``analyze_nan`` reads.
"""
from __future__ import annotations

import argparse
import time

import numpy as np

PAIRS_PER_GAUSSIAN = 32.0


def nonfinite(named) -> list:
    """``name(rows)`` for each (name, tensor) with a non-finite value, the
    rows counted along the first axis."""
    import torch

    named = list(named)
    counts = torch.stack([(~torch.isfinite(t)).reshape(t.shape[0], -1)
                          .any(dim=1).sum() if t.dim() else
                          (~torch.isfinite(t)).sum() for _, t in named])
    return [f"{name}({n} rows)" for (name, _), n in
            zip(named, counts.tolist()) if n]


def check_step(state, cam, gt, bg, *, width, height, opt, rcfg):
    """``trainer.train_step``, with the loss and every gradient checked
    before the update and every parameter and moment after it. Returns
    (new state, aux-like dict, the non-finite fields)."""
    import torch

    from gsplat_tpu_torch.models import gaussian_model as gm
    from gsplat_tpu_torch.train import densify as densify_lib
    from gsplat_tpu_torch.train import trainer

    dev = gt.device
    ones = torch.ones((1, height, width), device=dev)
    zeros = torch.zeros((1, height, width), device=dev)
    step = state.step + 1
    loss, _, _, out, grads, exp_grads, tap = trainer.camera_loss_grads(
        state.gaussians, state.exposure, cam, gt, ones, zeros, zeros, bg,
        step, image_width=width, image_height=height, opt=opt, rcfg=rcfg,
        antialiasing=False, train_test_exp=False, use_depth=False)
    act = state.gaussians.active
    bad = nonfinite([("loss", loss)]
                    + [(f"grad.{k}", grads[k][act])
                       for k in gm.TRAINABLE_FIELDS]
                    + [("grad.mean2d", tap[act])])
    stats = state.stats
    if step < opt.densify_until_iter:
        stats = densify_lib.add_densification_stats(stats, out.radii.detach(),
                                                     tap)
    new = trainer.finish_train_step(state, grads, exp_grads, stats, step,
                                    None, opt=opt, spatial_lr_scale=2.0)
    bad += check_state(new)
    return new, dict(loss=loss, overflow=out.overflow,
                     num_pairs=out.num_pairs), bad


def check_state(state) -> list:
    from gsplat_tpu_torch.models import gaussian_model as gm

    g, act = state.gaussians, state.gaussians.active
    return nonfinite([(k, getattr(g, k)[act]) for k in gm.TRAINABLE_FIELDS]
                     + [(f"mu.{k}", state.adam.mu[k][act])
                        for k in gm.TRAINABLE_FIELDS]
                     + [(f"nu.{k}", state.adam.nu[k][act])
                        for k in gm.TRAINABLE_FIELDS])


def write_repro(path, g, cam, gt, *, iteration, fields, rcfg):
    """The failing step's inputs: the gaussians' fields, the camera's, the
    ground truth, the frame size and pair capacity."""
    from gsplat_tpu_torch.core.camera import FIELDS as CAM_FIELDS
    from gsplat_tpu_torch.models import gaussian_model as gm

    payload = {k: getattr(g, k).detach().cpu().numpy()
               for k in gm.TENSOR_FIELDS}
    payload["active_sh_degree"] = np.asarray(g.active_sh_degree)
    for k in CAM_FIELDS:
        v = getattr(cam, k)
        payload["cam." + k] = (np.asarray(v) if k == "exposure_idx"
                               else v.detach().cpu().numpy())
    payload.update(gt=gt.detach().cpu().numpy(),
                   width=np.asarray(gt.shape[-1]),
                   height=np.asarray(gt.shape[-2]),
                   iteration=np.asarray(iteration),
                   fields=np.asarray(", ".join(fields)),
                   pairs_per_gaussian=np.asarray(rcfg.pairs_per_gaussian))
    np.savez_compressed(path, **payload)
    return path


def report(state, it, tag, fields):
    """The fields, then the finite ranges of the live scales and opacities
    and the smallest quaternion norm."""
    import torch

    g, act = state.gaussians, state.gaussians.active
    print(f"[{tag} iter {it}] NON-FINITE: {', '.join(fields)}")
    for name, x in (("scaling", g.scaling[act]),
                    ("opacity", g.opacity[act])):
        x = x[torch.isfinite(x)]
        if x.numel():
            print(f"{name} range: {float(x.min())} {float(x.max())}")
    rot = g.rotation[act]
    print("rot norm min:", float(rot.norm(dim=1).min()) if len(rot) else "-")


def replay(path, device, repro):
    """One step from a ``--debug`` snapshot of the training loop."""
    import torch

    from gsplat_tpu_torch.config import OptimizationConfig, RasterizerConfig
    from gsplat_tpu_torch.core.camera import FIELDS as CAM_FIELDS
    from gsplat_tpu_torch.core.camera import CameraView
    from gsplat_tpu_torch.train.checkpoint import _state_from_leaves

    with np.load(path) as d:
        # the state's leaves in the order the loop wrote them
        leaves = [d[k] for k in d.files if k.startswith("state.")]
        cam_np = {k: d["cam." + k] for k in CAM_FIELDS}
        gt_np, iteration = d["gt"], int(d["iteration"])
        reason = str(d["reason"])
    state = _state_from_leaves(leaves, device)
    cam = CameraView.from_numpy(cam_np, device=device)
    gt = torch.tensor(gt_np, device=device)
    H, W = gt.shape[-2:]
    rcfg = RasterizerConfig()
    print(f"replaying iteration {iteration} of {path} ({reason}), "
          f"{state.gaussians.num_active()} live gaussians, {W}x{H}")
    _, aux, bad = check_step(state, cam, gt, torch.zeros(3, device=device),
                             width=W, height=H, opt=OptimizationConfig(),
                             rcfg=rcfg)
    print(f"loss={float(aux['loss'])} overflow={int(aux['overflow'])}")
    if bad:
        report(state, iteration, "replay", bad)
    else:
        print("no non-finite value in the replayed step")
    write_repro(repro, state.gaussians, cam, gt, iteration=iteration,
                fields=bad, rcfg=rcfg)
    print(f"saved {repro}")
    return dict(iteration=iteration, fields=bad, repro=repro)


def hunt(device, iters, repro):
    import torch

    from gsplat_tpu_torch.config import RasterizerConfig
    from gsplat_tpu_torch.ops.rasterize import render
    from gsplat_tpu_torch.tools import drive_train as drive
    from gsplat_tpu_torch.train import trainer

    (W, H), (n_gt, n_init), _ = drive.SIZES[device.type]
    rng = np.random.default_rng(0)
    pts, colors, g_gt = drive.ground_truth(rng, n_gt, device)
    rcfg = RasterizerConfig(pairs_per_gaussian=PAIRS_PER_GAUSSIAN)
    bg = torch.zeros(3, device=device)
    cams = drive.ring_cameras(device)
    with torch.no_grad():
        gts = [torch.clamp(render(g_gt, c, W, H, bg, rcfg).image, 0, 1)
               for c in cams]
    for ci, gt in enumerate(gts):
        nb = int((~torch.isfinite(gt)).sum())
        if nb:
            print(f"gt[{ci}] has {nb} non-finite pixels!")
    state = trainer.init_state(
        drive.initial_model(rng, pts, colors, n_init, device), len(cams))
    opt = drive.drive_opt(iters)
    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    t0 = time.perf_counter()
    for it in range(1, iters + 1):
        i = int(rng.integers(0, len(cams)))
        prev = state
        state, aux, bad = check_step(state, cams[i], gts[i], bg, width=W,
                                     height=H, opt=opt, rcfg=rcfg)
        if not bad and it > opt.densify_from_iter \
                and it % opt.densification_interval == 0:
            state, _ = trainer.densify_step(state, gen, 2.0, opt=opt,
                                            use_screen_size_prune=False)
            bad = [f"densify: {b}" for b in check_state(state)]
        if bad:
            report(state, it, device.type, bad)
            write_repro(repro, prev.gaussians, cams[i], gts[i],
                        iteration=it, fields=bad, rcfg=rcfg)
            print(f"saved {repro} (the state iteration {it} started from, "
                  f"camera {i})")
            return dict(iteration=it, fields=bad, repro=repro)
        if it % 50 == 0:
            print(f"iter {it}: loss={float(aux['loss']):.4f} "
                  f"n={state.gaussians.num_active()} "
                  f"overflow={int(aux['overflow'])} "
                  f"pairs={int(aux['num_pairs'])} "
                  f"({time.perf_counter() - t0:.0f}s)", flush=True)
    print("no NaN found")
    return dict(iteration=None, fields=[], repro=None)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("iters", nargs="?", type=int, default=None)
    p.add_argument("--device", default="cuda", choices=["cpu", "cuda"])
    p.add_argument("--repro", default="nan_repro.npz",
                   help="where the failing step's inputs are written")
    p.add_argument("--snapshot", default=None,
                   help="replay the step of a --debug snapshot of the "
                        "training loop instead of hunting")
    args = p.parse_args(argv)

    from gsplat_tpu_torch.tools.drive_train import SIZES
    from gsplat_tpu_torch.utils.general import resolve_device

    device = resolve_device(args.device)
    if args.snapshot:
        return replay(args.snapshot, device, args.repro)
    iters = args.iters if args.iters is not None else SIZES[device.type][2]
    return hunt(device, iters, args.repro)


if __name__ == "__main__":
    main()
