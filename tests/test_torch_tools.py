"""The port's validation tools (gsplat_tpu_torch/tools) on the CPU.

- The scene generator against tools/make_synthetic_scene.py on the same
  seed (400 gaussians, 4 cameras, 64x48, seed 3): the three ``.bin`` files
  equal byte for byte, both packages' readers give the same cameras, the
  PNGs are within 1 level in uint8 with at most 1% of pixels differing, and
  the float images the two renders give are within the image gate (rtol
  2e-4, atol 2e-5).
- A tiny soak end to end (64x48, 300 gaussians, 6 cameras, 20 iterations,
  tests at 10 and 20): the stages run as processes of their own (each with
  the TensorBoard import blocked, as in this file), ``summary.txt``'s lines,
  finite SSIM and PSNR in ``results.json`` and NaN LPIPS without weights,
  and a failing stage ends the soak non-zero.
- ``drive_render``: overflow 0 and a finite, non-zero gradient.
- ``debug_nan`` on an injected NaN reports the iteration and the field and
  writes a repro that ``analyze_nan`` reads; a ``--debug`` snapshot of the
  training loop replays through ``debug_nan --snapshot``.
The training drive against tools/drive_train.py is in
test_torch_tools_drive.py.
"""
import json
import os
import sys

import numpy as np
import pytest
import torch

from torch_parity import make_colmap_scene, t2n

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
IMG_TOL = dict(rtol=2e-4, atol=2e-5)

# runs one stage of the soak as its own process with the TensorBoard
# import blocked (it loads TensorFlow here, about 17 s a process) and torch
# at 2 threads, as the suite's processes run
LAUNCHER = """\
import os, runpy, sys
sys.path.insert(0, os.getcwd())
sys.modules["torch.utils.tensorboard"] = None
import torch
torch.set_num_threads(2)
args = sys.argv[1:]
if args[0] == "-m":
    sys.argv = [args[1]] + args[2:]
    runpy.run_module(args[1], run_name="__main__", alter_sys=True)
else:
    sys.argv = args
    runpy.run_path(args[0], run_name="__main__")
"""


@pytest.fixture(autouse=True)
def _no_tensorboard(monkeypatch):
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)


def _png(path):
    from PIL import Image
    return np.asarray(Image.open(path), dtype=np.int16)


def _recording(monkeypatch, module, sink, jit=None):
    """Wrap ``module.render`` (compiled through ``jit``, if given) so that
    each image it returns is kept."""
    orig = jit(module.render) if jit else module.render

    def render(*a, **kw):
        out = orig(*a, **kw)
        sink.append(np.asarray(t2n(out.image) if isinstance(
            out.image, torch.Tensor) else out.image))
        return out
    monkeypatch.setattr(module, "render", render)


def test_generator_matches_jax(tmp_path, monkeypatch):
    sys.path.insert(0, os.path.join(REPO, "tools"))
    import make_synthetic_scene as jax_gen

    from gsplat_tpu.ops import rasterize as jrasterize
    from gsplat_tpu.scene import dataset_readers as jreaders
    from gsplat_tpu_torch.ops import rasterize as trasterize
    from gsplat_tpu_torch.scene import dataset_readers as treaders
    from gsplat_tpu_torch.tools import make_synthetic_scene as port_gen

    argv = ["--scene", "s", "--n_gaussians", "400", "--n_cams", "4",
            "--width", "64", "--height", "48", "--seed", "3",
            "--device", "cpu"]
    images = {"jax": [], "port": []}
    # JAX's render as one compiled call, in place of its op-by-op dispatch
    import jax
    _recording(monkeypatch, jrasterize, images["jax"],
               lambda f: jax.jit(f, static_argnums=(2, 3, 5)))
    _recording(monkeypatch, trasterize, images["port"])
    jax_gen.main(["--out", str(tmp_path / "jax"), *argv])
    port_gen.main(["--out", str(tmp_path / "port"), *argv])

    for name in ("cameras.bin", "images.bin", "points3D.bin"):
        want = (tmp_path / "jax" / "s" / "sparse" / "0" / name).read_bytes()
        got = (tmp_path / "port" / "s" / "sparse" / "0" / name).read_bytes()
        assert got == want, name

    jinfo = jreaders.read_colmap_scene(str(tmp_path / "jax" / "s"))
    tinfo = treaders.read_colmap_scene(str(tmp_path / "port" / "s"))
    assert len(tinfo.train_cameras) == len(jinfo.train_cameras) == 4
    for a, b in zip(tinfo.train_cameras, jinfo.train_cameras):
        np.testing.assert_array_equal(a.R, b.R)
        np.testing.assert_array_equal(a.T, b.T)
        assert (a.FovX, a.FovY, a.width, a.height, a.image_name) == \
            (b.FovX, b.FovY, b.width, b.height, b.image_name)
    for a, b in zip(tinfo.point_cloud, jinfo.point_cloud):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))

    assert len(images["port"]) == len(images["jax"]) == 4
    for got, want in zip(images["port"], images["jax"]):
        np.testing.assert_allclose(got, want, **IMG_TOL)
    for i in range(4):
        name = f"IMG_{i:04d}.png"
        d = np.abs(_png(tmp_path / "port" / "s" / "images" / name)
                   - _png(tmp_path / "jax" / "s" / "images" / name))
        assert d.max() <= 1, name
        assert (d > 0).mean() <= 0.01, name


TINY = ["--n_gaussians", "300", "--n_cams", "6", "--width", "64",
        "--height", "48", "--test_iterations", "10", "20",
        "--device", "cpu"]


def test_tiny_soak_end_to_end(tmp_path, monkeypatch, capsys):
    from gsplat_tpu_torch.tools import soak_30k

    launcher = tmp_path / "launch.py"
    launcher.write_text(LAUNCHER)
    monkeypatch.setattr(soak_30k, "stage_command",
                        lambda argv: [sys.executable, str(launcher), *argv])
    monkeypatch.delenv("GSPLAT_LPIPS_WEIGHTS", raising=False)
    out = tmp_path / "soak"
    soak = soak_30k.main(["20", str(out), *TINY])
    lines = soak["lines"]
    printed = capsys.readouterr().out
    assert printed.rstrip().endswith("OK")

    summary = (out / "summary.txt").read_text().splitlines()
    assert summary == lines and len(lines) == 8
    assert lines[0].startswith("soak: 20 iters in ")
    assert lines[1] == "final N: 300 (start 300)"
    # iteration 1 shrinks the default pair capacity, as the loop always
    # does on a scene this small: the count reads the trainer's stdout
    assert lines[2].startswith("capacity grow/retry events: 1 (grow 0; "
                               "retry 0; shrink 1)")
    res = json.loads((out / "model" / "results.json").read_text())
    assert sorted(res) == ["ours_10", "ours_20"]   # each test iteration
    for m in res.values():
        assert np.isfinite(m["SSIM"]) and np.isfinite(m["PSNR"])
        assert np.isnan(m["LPIPS"])
    metrics = res["ours_20"]
    assert lines[3] == "held-out metrics: " + json.dumps(metrics)
    p_init, p_final = soak["p_init"], soak["p_final"]
    assert lines[4].startswith("held-out PSNR by iteration: initial model "
                               f"{p_init['test']:.3f}; 10: ")
    assert "; 10: " in lines[4] and "; 20: " in lines[4]
    log = [json.loads(x) for x in
           (out / "model" / "training_log.jsonl").read_text().splitlines()]
    evals = [e for e in log if "test/loss_viewpoint - psnr" in e]
    assert [e["step"] for e in evals] == [10, 20]
    assert all(np.isfinite(e["test/loss_viewpoint - psnr"]) for e in evals)
    assert abs(evals[-1]["test/loss_viewpoint - psnr"]
               - metrics["PSNR"]) < 0.1     # the PNGs round the renders
    # the final model, read back from its PLY, scores the held-out views
    # as the metrics CLI does up to the PNGs' rounding
    assert abs(p_final["test"] - metrics["PSNR"]) < 0.1
    assert lines[5] == ("held-out SSIM / PSNR / LPIPS by iteration (render "
                        "and metrics CLIs): " + "; ".join(
                            f"{it}: {m['SSIM']:.4f} / {m['PSNR']:.3f} / nan"
                            for it, m in ((10, res["ours_10"]),
                                          (20, res["ours_20"]))))
    assert lines[6] == (f"PSNR of the initial -> the final model, every "
                        f"view: train {p_init['train']:.3f} -> "
                        f"{p_final['train']:.3f}, held-out "
                        f"{p_init['test']:.3f} -> {p_final['test']:.3f}")
    assert p_final["train"] > p_init["train"]
    assert lines[7] == "peak device memory of the trainer: not measured"
    assert os.path.exists(out / "model" / "point_cloud" / "iteration_20")

    # a stage that fails ends the soak with a non-zero exit, and no
    # summary is written
    (out / "summary.txt").unlink()

    def failing(argv):
        if argv[0] == "train_torch.py":
            return [sys.executable, "-c", "raise SystemExit(3)"]
        return [sys.executable, str(launcher), *argv]
    monkeypatch.setattr(soak_30k, "stage_command", failing)
    with pytest.raises(SystemExit) as err:
        soak_30k.main(["2", str(out), *TINY])
    assert err.value.code not in (0, None)
    assert "stage 'training 2 iters" in str(err.value)
    assert not (out / "summary.txt").exists()


def test_soak_summary_reads_the_trainers_peak_memory(tmp_path):
    """On the card the trainer logs its allocator's peaks last; the
    summary reports them (a soak on the CPU logs none: the test above)."""
    from gsplat_tpu_torch.tools import soak_30k

    model = tmp_path / "model"
    model.mkdir()
    metrics = {"SSIM": 0.9, "PSNR": 20.0, "LPIPS": float("nan")}
    (model / "results.json").write_text(json.dumps({"ours_4": metrics}))
    log = [{"step": 1, "total_points": 10.0},
           {"step": 2, "total_points": 12.0},
           {"step": 2, soak_30k.TEST_PSNR: 19.5, soak_30k.TEST_L1: 0.05},
           {"step": 4, "peak_allocated_mib": 1234.4,
            "peak_reserved_mib": 2048.0}]
    (model / "training_log.jsonl").write_text(
        "".join(json.dumps(e) + "\n" for e in log))
    (tmp_path / "train_stdout.log").write_text(
        "[iter 3] pair overflow 5 — pairs_per_gaussian → 4.0; retrying "
        "frame from pre-step state\n")
    p = {"train": 15.0, "test": 14.0}
    lines = soak_30k.summarize(str(tmp_path), 4, 2.0, p, p)
    assert lines[1] == "final N: 12 (start 10)"
    assert lines[2] == ("capacity grow/retry events: 1 (grow 0; retry 1; "
                        "shrink 0)")
    assert lines[4] == ("held-out PSNR by iteration: initial model 14.000; "
                        "2: 19.500 (L1 0.05000)")
    assert lines[7] == ("peak device memory of the trainer: 1234 MiB "
                        "allocated, 2048 MiB reserved "
                        "(torch.cuda.max_memory_allocated / "
                        "max_memory_reserved)")


def test_drive_render_on_the_cpu(capsys):
    from gsplat_tpu_torch.tools import drive_render

    r = drive_render.main(["--device", "cpu"])
    assert r["overflow"] == 0 and r["visible"] > 0
    assert r["image"].shape == (3, drive_render.H, drive_render.W)
    g = r["grad_xyz"]
    assert np.isfinite(g).all() and np.abs(g).max() > 0
    assert capsys.readouterr().out.rstrip().endswith("OK")


def test_debug_nan_finds_an_injected_nan(tmp_path, monkeypatch, capsys):
    from gsplat_tpu_torch.tools import analyze_nan, debug_nan
    from gsplat_tpu_torch.train import trainer

    orig = trainer.camera_loss_grads

    def poisoned(g, exposure, cam, gt, *a, **kw):
        out = list(orig(g, exposure, cam, gt, *a, **kw))
        if a[4] == 3:           # the step number: poison iteration 3
            grads = dict(out[4])
            grads["opacity"] = grads["opacity"].clone()
            grads["opacity"][5] = float("nan")
            out[4] = grads
        return tuple(out)

    monkeypatch.setattr(trainer, "camera_loss_grads", poisoned)
    repro = str(tmp_path / "repro.npz")
    r = debug_nan.main(["10", "--device", "cpu", "--repro", repro])
    printed = capsys.readouterr().out
    assert r["iteration"] == 3
    assert r["fields"][0] == "grad.opacity(1 rows)"
    assert "opacity(1 rows)" in r["fields"]
    assert "[cpu iter 3] NON-FINITE: grad.opacity(1 rows)" in printed
    with np.load(repro) as d:
        assert int(d["iteration"]) == 3
        assert str(d["fields"]).startswith("grad.opacity(1 rows)")
        # the state the failing iteration started from: finite
        assert np.isfinite(d["opacity"]).all()

    monkeypatch.setattr(trainer, "camera_loss_grads", orig)
    bad = analyze_nan.main(["--repro", repro, "--device", "cpu"])
    # the poison was in the gradient alone: the captured step is clean
    assert bad == dict(params=0, preprocess=0, entries=0, compositor=0,
                       render=0, grads=0)
    assert "iteration 3: grad.opacity(1 rows)" in capsys.readouterr().out


def test_debug_nan_replays_a_loop_snapshot(tmp_path, monkeypatch, capsys):
    from gsplat_tpu_torch.cli import train as train_cli
    from gsplat_tpu_torch.tools import debug_nan
    from gsplat_tpu_torch.train import trainer

    src = make_colmap_scene(str(tmp_path / "scene"), n_pts=60, n_cams=4,
                            W=32, H=32, rng=np.random.default_rng(0))
    step = trainer.train_step

    def poisoned_step(state, *a, **kw):
        s, aux = step(state, *a, **kw)
        return s, aux._replace(loss=torch.tensor(float("nan")))

    monkeypatch.setattr(trainer, "train_step", poisoned_step)
    stdout = sys.stdout        # the CLI replaces it
    try:
        with pytest.raises(FloatingPointError) as err:
            train_cli.main(["-s", src, "-m", str(tmp_path / "model"),
                            "--iterations", "2", "--debug",
                            "--test_iterations", "-1", "--save_iterations",
                            "-1", "--disable_viewer", "--device", "cpu"])
    finally:
        sys.stdout = stdout
    snap = str(tmp_path / "model" / "snapshot_iter1.npz")
    assert f"debug_nan --snapshot {snap}" in str(err.value)
    monkeypatch.setattr(trainer, "train_step", step)
    repro = str(tmp_path / "repro.npz")
    r = debug_nan.main(["--snapshot", snap, "--device", "cpu",
                        "--repro", repro])
    # the loss was poisoned after the step: the replayed step is finite
    assert r == dict(iteration=1, fields=[], repro=repro)
    assert "no non-finite value in the replayed step" in \
        capsys.readouterr().out
    with np.load(repro) as d, np.load(snap) as s:
        np.testing.assert_array_equal(d["xyz"], s["state.gaussians.xyz"])
        np.testing.assert_array_equal(d["gt"], s["gt"])
