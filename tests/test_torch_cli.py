"""The port's training CLI end to end on the CPU, on the scene of
tests/test_cli.py (written with the port's COLMAP writers): train_torch →
render_torch, the model directory read by the JAX package's render CLI and
``load_cfg``; the ``--debug`` snapshot on a non-finite loss; the sharded
loop (``--shard_gaussians --shards 4``, ``ring``); resuming from a
checkpoint file and from the manager's directory. Ports of
tests/test_cli.py:57 (as far as the renders), :124 and :158."""
import glob
import json
import os
import sys

import numpy as np
import pytest
import torch

import jax

from gsplat_tpu import config as jcfg
from gsplat_tpu.cli import render as jax_render_cli
from gsplat_tpu.core.camera import CameraView as JaxCameraView
from gsplat_tpu.train import checkpoint as jckpt
from gsplat_tpu.utils import debug as jdebug
from gsplat_tpu_torch.cli import render as render_cli
from gsplat_tpu_torch.cli import train as train_cli
from gsplat_tpu_torch.parallel import sharded
from gsplat_tpu_torch.train import loop as tloop
from gsplat_tpu_torch.train import trainer as ttrainer

from torch_parity import CAM_FIELDS, make_colmap_scene

BASE = ["--device", "cpu", "--disable_viewer", "--quiet", "--sh_degree", "1"]


def _log(model):
    with open(os.path.join(model, "training_log.jsonl")) as f:
        return [json.loads(line) for line in f]


def _png(path):
    from PIL import Image
    with Image.open(path) as im:
        return np.asarray(im).astype(int)


@pytest.fixture(autouse=True)
def _keep_stdout(monkeypatch):
    monkeypatch.setattr(sys, "stdout", sys.stdout)   # the CLIs swap stdout


def test_train_then_render_cli_on_the_cpu(tmp_path, rng):
    src = make_colmap_scene(str(tmp_path / "scene"), rng=rng)
    model = str(tmp_path / "model")
    iters = 12
    train_cli.main(["-s", src, "-m", model, "--eval", "--iterations",
                    str(iters), "--test_iterations", str(iters),
                    "--save_iterations", str(iters), *BASE])

    for name in ("cfg_args.json", "cameras.json", "input.ply"):
        assert os.path.exists(os.path.join(model, name)), name
    recs = _log(model)
    assert [r["step"] for r in recs[:iters]] == list(range(1, iters + 1))
    assert {"step", "train_loss_patches/total_loss", "total_points",
            "num_pairs"} <= set(recs[0])
    assert all(np.isfinite(r["train_loss_patches/total_loss"])
               for r in recs[:iters])
    assert any("test/loss_viewpoint - psnr" in r for r in recs)
    assert os.path.exists(os.path.join(
        model, f"point_cloud/iteration_{iters}", "point_cloud.ply"))

    # JAX's load_cfg builds each group from the keys present; the port's
    # RasterizerConfig has no use_pallas, strip_chunks, row_cull or
    # row_slots, which therefore take JAX's defaults
    cfg = jcfg.load_cfg(model)
    assert cfg["optimization"].iterations == iters
    assert cfg["model"].sh_degree == 1 and cfg["model"].eval
    r = cfg["rasterizer"]
    default = jcfg.RasterizerConfig()
    assert (r.use_pallas, r.strip_chunks, r.row_cull, r.row_slots) == (
        default.use_pallas, default.strip_chunks, default.row_cull,
        default.row_slots)

    out = os.path.join(model, "test", f"ours_{iters}", "renders")
    render_cli.main(["-m", model, "--skip_train", "--quiet", "--device",
                     "cpu"])
    port_pngs = {n: _png(os.path.join(out, n)) for n in os.listdir(out)}
    assert len(port_pngs) == len(os.listdir(out.replace("renders", "gt"))) \
        == 1
    jax_render_cli.main(["-m", model, "--skip_train", "--quiet"])
    for name, got in port_pngs.items():
        assert np.abs(_png(os.path.join(out, name)) - got).max() <= 1, name


def test_debug_snapshot_on_nonfinite_loss(tmp_path, rng, monkeypatch):
    """``--debug``: a non-finite loss dumps the state the failing step
    started from, its camera and images, and aborts. The snapshot's state
    rebuilt in JAX and dumped by JAX's ``dump_snapshot`` gives the same
    keys and arrays."""
    src = make_colmap_scene(str(tmp_path / "scene"), n_pts=60, n_cams=4,
                            W=32, H=32, rng=rng)
    model = str(tmp_path / "model")
    step = ttrainer.train_step

    def poisoned_step(state, *a, **kw):
        s, aux = step(state, *a, **kw)
        return s, aux._replace(loss=torch.tensor(float("nan")))

    monkeypatch.setattr(ttrainer, "train_step", poisoned_step)
    with pytest.raises(FloatingPointError, match="non-finite loss"):
        train_cli.main(["-s", src, "-m", model, "--iterations", "2",
                        "--debug", "--test_iterations", "-1",
                        "--save_iterations", "-1", *BASE])
    snaps = glob.glob(os.path.join(model, "snapshot_iter*.npz"))
    assert [os.path.basename(p) for p in snaps] == ["snapshot_iter1.npz"]
    with np.load(snaps[0]) as data:
        port = dict(data)
    assert str(port["reason"]) == "non-finite loss nan"
    assert int(port["state.step"]) == 0            # the pre-step state

    names = sorted(k for k in port if k.startswith("state"))
    template = jckpt._template_state([port[n] for n in (
        "state.gaussians.xyz", "state.gaussians.f_dc",
        "state.gaussians.f_rest")])
    paths = [jax.tree_util.keystr(kp) for kp, _ in
             jax.tree_util.tree_flatten_with_path(template)[0]]
    assert sorted("state" + p for p in paths) == names
    jstate = jax.tree_util.tree_unflatten(
        jax.tree_util.tree_structure(template),
        [port["state" + p] for p in paths])
    jcam = JaxCameraView(**{k: port["cam." + k] for k in CAM_FIELDS})
    jpath = jdebug.dump_snapshot(
        str(tmp_path / "jax.npz"), jstate, jcam,
        tuple(port[k] for k in ("gt", "alpha_mask", "invdepth_gt",
                                "depth_mask")), 1, "non-finite loss nan")
    with np.load(jpath) as want:
        assert set(want.keys()) == set(port)
        for k in want.keys():
            assert want[k].dtype == port[k].dtype, k
            np.testing.assert_array_equal(want[k], port[k], err_msg=k)


def test_sharded_loop_cli(tmp_path, rng, monkeypatch):
    """``--shard_gaussians --shards 4 --shard_transient ring``: every step
    runs the sharded step, and after a densify event the state still
    splits into 4 shards of capacity / 4 rows; the PLY is saved."""
    src = make_colmap_scene(str(tmp_path / "scene"), n_pts=60, n_cams=4,
                            W=32, H=32, rng=rng)
    model = str(tmp_path / "model")
    seen = {"steps": 0, "densify": 0}
    orig_train, orig_make = tloop.train, sharded.make_sharded_train_step
    densify = ttrainer.densify_step

    def capture_train(*a, **kw):
        scene, state = orig_train(*a, **kw)
        seen["state"] = state
        return scene, state

    def counting_make(n, **kw):
        assert n == 4 and kw["transient"] == "ring"
        seen["steps"] += 1
        return orig_make(n, **kw)

    def counting_densify(*a, **kw):
        seen["densify"] += 1
        return densify(*a, **kw)

    monkeypatch.setattr(tloop, "train", capture_train)
    monkeypatch.setattr(sharded, "make_sharded_train_step", counting_make)
    monkeypatch.setattr(ttrainer, "densify_step", counting_densify)
    train_cli.main(["-s", src, "-m", model, "--eval", "--iterations", "3",
                    "--densify_from_iter", "1", "--densification_interval",
                    "2", "--test_iterations", "3", "--save_iterations", "3",
                    "--shard_gaussians", "--shards", "4",
                    "--shard_transient", "ring", *BASE])
    assert seen["steps"] >= 3 and seen["densify"] == 1
    state = seen["state"]
    cap = state.gaussians.capacity
    assert cap % 4 == 0
    for x in (state.gaussians.xyz, state.adam.mu["xyz"], state.stats.denom):
        assert [t.shape[0] for t in sharded.shard_rows(x, 4)] == [cap // 4] * 4
    assert os.path.exists(
        os.path.join(model, "point_cloud/iteration_3/point_cloud.ply"))
    assert all(np.isfinite(r["train_loss_patches/total_loss"])
               for r in _log(model) if "train_loss_patches/total_loss" in r)
    with pytest.raises(ValueError, match="needs shard_gaussians"):
        train_cli.main(["-s", src, "-m", model, "--shards", "4", *BASE])


def test_resume_from_checkpoint_file_and_manager_dir(tmp_path, rng):
    src = make_colmap_scene(str(tmp_path / "scene"), n_pts=60, n_cams=4,
                            W=32, H=32, rng=rng)
    first = str(tmp_path / "first")
    train_cli.main(["-s", src, "-m", first, "--iterations", "6",
                    "--checkpoint_iterations", "4", "--checkpoint_interval",
                    "2", "--test_iterations", "-1", *BASE])
    assert sorted(os.listdir(os.path.join(first, "checkpoints"))) == [
        "step_2.npz", "step_4.npz", "step_6.npz"]
    state4, it = jckpt.load_checkpoint(os.path.join(first, "chkpnt4.npz"))
    assert it == 4 and int(state4.step) == 4

    for start, name, iters, steps in (
            (os.path.join(first, "chkpnt4.npz"), "from_file", 6, [5, 6]),
            (os.path.join(first, "checkpoints"), "from_dir", 8, [7, 8])):
        model = str(tmp_path / name)
        train_cli.main(["-s", src, "-m", model, "--iterations", str(iters),
                        "--start_checkpoint", start, "--test_iterations",
                        "-1", *BASE])
        assert [r["step"] for r in _log(model)] == steps
        assert os.path.exists(os.path.join(
            model, f"point_cloud/iteration_{iters}", "point_cloud.ply"))
