"""The reference's 30,000-iteration training regime (30k iterations,
densify until 15k, an opacity reset every 3k, SH warm-up every 1k), run
end to end through the port's CLIs on a synthetic COLMAP scene with
held-out views. Counterpart of tools/soak_30k.sh.

    python -m gsplat_tpu_torch.tools.soak_30k [iters] [outdir]
        [--n_gaussians 12000] [--n_cams 24] [--width 512] [--height 384]
        [--test_iterations 1000 7000 15000 22000 30000] [--device cpu]

Stages, each its own process; the first that fails ends the soak with a
non-zero exit:
1. ``make_synthetic_scene`` (seed 7) into ``<outdir>/scene/soak``, unless
   it is there;
2. ``train_torch.py --eval`` into ``<outdir>/model``, its stdout kept in
   ``<outdir>/train_stdout.log``;
3. ``render_torch.py --skip_train`` at each test iteration and the last
   (the trainer saves at each, beside the script's 7,000 and 30,000);
4. ``metrics_torch.py`` (LPIPS from ``GSPLAT_LPIPS_WEIGHTS``, else NaN),
   which scores every rendered iteration.

Two flags differ from the shell script's: the trainer runs without
``--quiet``, which silences every line of its stdout, the capacity, retry
and shrink events this summary counts among them, and with
``--disable_viewer``, so that no bridge polls a socket in the timed loop.

Evidence under ``<outdir>``: the scene; the model (``point_cloud/``,
``cfg_args.json``, ``training_log.jsonl``: per-iteration loss, N and pairs,
the held-out L1 and PSNR at each test iteration; ``results.json``: the
held-out SSIM, PSNR and LPIPS at each rendered iteration); ``summary.txt``:
iterations and wall time, final N, the capacity events, the final
held-out metrics, the held-out PSNR from the initial model through each
test iteration (the loop's evaluation), the held-out SSIM, PSNR and LPIPS
at each (the CLIs'), the PSNR of the initial and the final model on every
train and held-out view, and on the card the trainer process's peak device
memory (its allocator's, from ``training_log.jsonl``).
"""
from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
TEST_ITERATIONS = [1000, 7000, 15000, 22000, 30000]
EVENTS = {"grow": re.compile(r"^\[iter (\d+)\] capacity (\d+) \S+ (\d+)"),
          "retry": re.compile(r"^\[iter (\d+)\] pair overflow"),
          "shrink": re.compile(r"^\[iter (\d+)\] shrinking pairs_per_gaussian")}
TEST_PSNR = "test/loss_viewpoint - psnr"
TEST_L1 = "test/loss_viewpoint - l1_loss"


def stage_command(argv):
    """The command line of one stage: this Python on ``argv``."""
    return [sys.executable, *argv]


def run_stage(name, argv, log_path=None):
    """Run one stage from the repo's root, its output echoed (and, with
    ``log_path``, kept there). Raises ``SystemExit`` when it fails."""
    print(f"=== {name} ===", flush=True)
    proc = subprocess.Popen(stage_command(argv), cwd=REPO, text=True,
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
    log = open(log_path, "w") if log_path else None
    try:
        for line in proc.stdout:
            sys.stdout.write(line)
            if log:
                log.write(line)
    finally:
        rc = proc.wait()
        if log:
            log.close()
    if rc != 0:
        raise SystemExit(f"soak: stage '{name}' failed with exit code {rc}")


def views_psnr(scene, gaussians, dev):
    """Mean PSNR of ``gaussians`` over the scene's train and held-out
    cameras, each view computed as the training loop's evaluation does:
    {"train": ..., "test": ...}."""
    import torch

    from gsplat_tpu_torch.config import RasterizerConfig
    from gsplat_tpu_torch.ops import losses
    from gsplat_tpu_torch.ops.rasterize import render

    bg = torch.zeros(3, device=dev)
    out = {}
    with torch.no_grad():
        for name, cams in (("train", scene.getTrainCameras()),
                           ("test", scene.getTestCameras())):
            vals = []
            for cam in cams:
                ppg = RasterizerConfig().pairs_per_gaussian
                while True:       # the loop's retry: a frame never truncates
                    r = render(gaussians, cam.view(dev), cam.width,
                               cam.height, bg,
                               RasterizerConfig(pairs_per_gaussian=ppg))
                    if not int(r.overflow):
                        break
                    ppg *= 2
                gt = torch.clamp(torch.tensor(cam.image, device=dev), 0.0,
                                 1.0)
                img = torch.clamp(r.image, 0.0, 1.0)
                vals.append(float(losses.psnr(img[None], gt[None]).mean()))
            out[name] = sum(vals) / len(vals)
    return out


def model_psnr(scene_dir, device, model_dir=None):
    """``views_psnr`` of the model training starts from (the point cloud's
    gaussians) or, with ``model_dir``, of its latest saved point cloud."""
    from gsplat_tpu_torch.config import ModelConfig
    from gsplat_tpu_torch.scene import Scene
    from gsplat_tpu_torch.utils.general import resolve_device

    dev = resolve_device(device)
    scene = Scene(ModelConfig(source_path=scene_dir,
                              model_path=model_dir or "", eval=True), 3,
                  shuffle=False, load_iteration=-1 if model_dir else None,
                  device=dev)
    return views_psnr(scene, scene.gaussians, dev)


def events(stdout_text):
    """{kind: [(iteration, ...), ...]} of the trainer's event lines."""
    # the train CLI stamps each line with the time: match its start
    found = {k: [] for k in EVENTS}
    for line in stdout_text.splitlines():
        for kind, pat in EVENTS.items():
            m = pat.match(line.strip())
            if m:
                found[kind].append(tuple(int(x) for x in m.groups()))
    return found


def summarize(out, iters, wall, p_init, p_final):
    """summary.txt's lines: the shell script's four, then the held-out
    PSNR and L1 by test iteration, the PSNR of the initial and the final
    model on every view, and the trainer's peak device memory."""
    model = os.path.join(out, "model")
    with open(os.path.join(model, "results.json")) as f:
        res = json.load(f)
    with open(os.path.join(model, "training_log.jsonl")) as f:
        log = [json.loads(line) for line in f]
    with open(os.path.join(out, "train_stdout.log")) as f:
        ev = events(f.read())
    final = res[f"ours_{iters}"]
    by_iter = sorted((int(k.split("_")[1]), v) for k, v in res.items())
    ns = [e["total_points"] for e in log if "total_points" in e]
    peak = [e for e in log if "peak_allocated_mib" in e]
    n_ev = sum(len(v) for v in ev.values())
    grows = ", ".join(f"{a} -> {b} at {it}" for it, a, b in ev["grow"])
    tests = [(e["step"], e[TEST_PSNR], e[TEST_L1]) for e in log
             if TEST_PSNR in e]
    lines = [
        f"soak: {iters} iters in {wall:.0f}s ({iters / max(wall, 1):.1f} "
        f"it/s incl. start-up/eval)",
        f"final N: {int(ns[-1]) if ns else '?'} "
        f"(start {int(ns[0]) if ns else '?'})",
        f"capacity grow/retry events: {n_ev} (grow {len(ev['grow'])}"
        + (f": {grows}" if grows else "")
        + f"; retry {len(ev['retry'])}; shrink {len(ev['shrink'])})",
        "held-out metrics: " + json.dumps(final),
        f"held-out PSNR by iteration: initial model {p_init['test']:.3f}"
        + "".join(f"; {it}: {p:.3f} (L1 {l1:.5f})" for it, p, l1 in tests),
        "held-out SSIM / PSNR / LPIPS by iteration (render and metrics "
        "CLIs): " + "; ".join(
            f"{it}: {m['SSIM']:.4f} / {m['PSNR']:.3f} / {m['LPIPS']:.4f}"
            for it, m in by_iter),
        f"PSNR of the initial -> the final model, every view: train "
        f"{p_init['train']:.3f} -> {p_final['train']:.3f}, held-out "
        f"{p_init['test']:.3f} -> {p_final['test']:.3f}",
        "peak device memory of the trainer: "
        + (f"{peak[-1]['peak_allocated_mib']:.0f} MiB allocated, "
           f"{peak[-1]['peak_reserved_mib']:.0f} MiB reserved "
           "(torch.cuda.max_memory_allocated / max_memory_reserved)"
           if peak else "not measured"),
    ]
    with open(os.path.join(out, "summary.txt"), "w") as f:
        f.write("\n".join(lines) + "\n")
    print("\n".join(lines), flush=True)
    return lines


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("iters", nargs="?", type=int, default=30000)
    p.add_argument("outdir", nargs="?",
                   default=os.path.join(REPO, "build", "soak"))
    p.add_argument("--n_gaussians", type=int, default=12000)
    p.add_argument("--n_cams", type=int, default=24)
    p.add_argument("--width", type=int, default=512)
    p.add_argument("--height", type=int, default=384)
    p.add_argument("--test_iterations", nargs="+", type=int,
                   default=TEST_ITERATIONS)
    p.add_argument("--device", default="cuda", choices=["cpu", "cuda"])
    args = p.parse_args(argv)

    from gsplat_tpu_torch.utils.general import resolve_device

    resolve_device(args.device)       # no CUDA: raise before any stage
    out = os.path.abspath(args.outdir)
    scene = os.path.join(out, "scene", "soak")
    model = os.path.join(out, "model")
    dev = ["--device", args.device]
    os.makedirs(out, exist_ok=True)
    if not os.path.exists(os.path.join(scene, "sparse", "0", "cameras.bin")):
        run_stage("generating synthetic COLMAP scene", [
            "-m", "gsplat_tpu_torch.tools.make_synthetic_scene",
            "--out", os.path.join(out, "scene"), "--scene", "soak",
            "--n_gaussians", str(args.n_gaussians), "--n_cams",
            str(args.n_cams), "--width", str(args.width), "--height",
            str(args.height), "--seed", "7", *dev])
    p_init = model_psnr(scene, args.device)
    print(f"PSNR of the initial model: {p_init}", flush=True)

    tests = sorted(t for t in set(args.test_iterations) if t <= args.iters)
    # the script's saves, and one at each test iteration for the metrics
    saves = sorted({7000, 30000, args.iters, *tests})
    t0 = time.perf_counter()
    run_stage(f"training {args.iters} iters (full production loop)", [
        "train_torch.py", "-s", scene, "-m", model, "--iterations",
        str(args.iters), "--eval", "--disable_viewer",
        "--test_iterations", *map(str, args.test_iterations),
        "--save_iterations", *map(str, saves), *dev],
        log_path=os.path.join(out, "train_stdout.log"))
    wall = time.perf_counter() - t0
    print(f"train wall: {wall:.0f} s ({args.iters / wall:.1f} it/s incl. "
          "start-up)", flush=True)

    for it in sorted({*tests, args.iters}):
        run_stage(f"render held-out views at {it}",
                  ["render_torch.py", "-m", model, "--skip_train",
                   "--iteration", str(it), *dev])
    run_stage("metrics on held-out views",
              ["metrics_torch.py", "-m", model, *dev])
    p_final = model_psnr(scene, args.device, model)
    lines = summarize(out, args.iters, wall, p_init, p_final)
    print("OK")
    return dict(lines=lines, p_init=p_init, p_final=p_final)


if __name__ == "__main__":
    main()
