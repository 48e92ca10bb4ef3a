"""Full-evaluation orchestrator: trains, renders and scores the 13 standard
scenes (MipNeRF360 at images_4 / images_2, Tanks&Temples truck and train,
DeepBlending drjohnson and playroom) and writes ``timing.txt``, through
the port's train, render and metrics CLIs. Same scene lists, flags and
argument lists as gsplat_tpu/cli/full_eval.py, plus ``--device`` (default
``cuda``), which it passes to each CLI."""
from __future__ import annotations

import os
import sys
import time
from argparse import ArgumentParser

mipnerf360_outdoor_scenes = ["bicycle", "flowers", "garden", "stump",
                             "treehill"]
mipnerf360_indoor_scenes = ["room", "counter", "kitchen", "bonsai"]
tanks_and_temples_scenes = ["truck", "train"]
deep_blending_scenes = ["drjohnson", "playroom"]


def main(argv=None):
    from gsplat_tpu_torch.utils.general import resolve_device

    parser = ArgumentParser(description="Full evaluation script parameters")
    parser.add_argument("--skip_training", action="store_true")
    parser.add_argument("--skip_rendering", action="store_true")
    parser.add_argument("--skip_metrics", action="store_true")
    parser.add_argument("--output_path", default="./eval")
    parser.add_argument("--use_depth", action="store_true")
    parser.add_argument("--use_expcomp", action="store_true")
    parser.add_argument("--aa", action="store_true")
    parser.add_argument("--fast", action="store_true")
    parser.add_argument("--mipnerf360", "-m360", type=str,
                        default=os.environ.get("MIPNERF360_DIR", ""))
    parser.add_argument("--tanksandtemples", "-tat", type=str,
                        default=os.environ.get("TANDT_DIR", ""))
    parser.add_argument("--deepblending", "-db", type=str,
                        default=os.environ.get("DB_DIR", ""))
    parser.add_argument("--scene_subset", nargs="+", default=None,
                        help="run only these scene names (e.g. garden truck)")
    parser.add_argument("--iterations", type=int, default=None,
                        help="override the 30k training schedule; renders "
                             "and metrics then evaluate only this iteration")
    parser.add_argument("--device", default="cuda")
    args, _ = parser.parse_known_args(argv if argv is not None
                                      else sys.argv[1:])
    resolve_device(args.device)
    if args.scene_subset is not None:
        known = set(mipnerf360_outdoor_scenes + mipnerf360_indoor_scenes
                    + tanks_and_temples_scenes + deep_blending_scenes)
        bad = [s for s in args.scene_subset if s not in known]
        if bad:
            parser.error(f"unknown scene(s) {bad}; choose from "
                         f"{sorted(known)}")

    def scenes():
        def keep(s):
            return args.scene_subset is None or s in args.scene_subset
        for s in mipnerf360_outdoor_scenes:
            if args.mipnerf360 and keep(s):
                yield os.path.join(args.mipnerf360, s), s, ["-i", "images_4"]
        for s in mipnerf360_indoor_scenes:
            if args.mipnerf360 and keep(s):
                yield os.path.join(args.mipnerf360, s), s, ["-i", "images_2"]
        for s in tanks_and_temples_scenes:
            if args.tanksandtemples and keep(s):
                yield os.path.join(args.tanksandtemples, s), s, []
        for s in deep_blending_scenes:
            if args.deepblending and keep(s):
                yield os.path.join(args.deepblending, s), s, []

    extra = []
    if args.use_depth:
        extra += ["-d", "depths"]
    if args.use_expcomp:
        extra += ["--train_test_exp"]
    if args.aa:
        extra += ["--antialiasing"]
    if args.fast:
        extra += ["--optimizer_type", "sparse_adam"]
    device = ["--device", args.device]

    timings = {}
    if args.iterations is not None:
        extra += ["--iterations", str(args.iterations),
                  "--save_iterations", str(args.iterations)]
        eval_iters = [str(args.iterations)]
    else:
        eval_iters = ["7000", "30000"]

    if not args.skip_training:
        from gsplat_tpu_torch.cli import train as train_cli
        for src, name, img_args in scenes():
            t0 = time.time()
            train_cli.main(["-s", src, "-m", os.path.join(args.output_path, name),
                            "--quiet", "--eval", "--test_iterations", "-1",
                            "--disable_viewer"] + img_args + extra + device)
            timings[name] = time.time() - t0
        with open(os.path.join(args.output_path, "timing.txt"), "w") as f:
            for name, t in timings.items():
                f.write(f"{name}: {t:.1f}s\n")

    if not args.skip_rendering:
        from gsplat_tpu_torch.cli import render as render_cli
        for src, name, _ in scenes():
            for it in eval_iters:
                render_cli.main(["-s", src, "-m",
                                 os.path.join(args.output_path, name),
                                 "--iteration", it, "--quiet", "--eval",
                                 "--skip_train"] + device)

    if not args.skip_metrics:
        from gsplat_tpu_torch.cli import metrics as metrics_cli
        paths = [os.path.join(args.output_path, name)
                 for _, name, _ in scenes()]
        if paths:
            metrics_cli.main(["-m"] + paths + device)


if __name__ == "__main__":
    main()
