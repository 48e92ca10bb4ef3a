"""BENCHMARK.json against the contract's shape, every cell and metric
resolving to its files; a cell, a traffic mix, a per-layer metric, a scene
kind, a camera path, step options, a reference and a fault added as files
alone, the check of the options it turns on holding each term; the check
views' records; the default reference refusing options; the step
arguments of a configuration without options."""
from __future__ import annotations

import json
import re

import pytest

import torch

from splatbench import drive, program, run, spec
from splatbench.tests import options_cell, tiny

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
BENCH = spec.benchmark()


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["splatbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert not any(w.startswith("/") or ".." in w for w in BENCH["command"])


@pytest.mark.parametrize("entry", BENCH["configs"], ids=lambda c: c["name"])
def test_config_resolves(entry):
    assert set(entry) == {"name", "source", "file", "reduced", "why"}
    assert NAME.match(entry["name"])
    cfg = json.loads((spec.ROOT / entry["file"]).read_text())
    assert cfg["name"] == entry["name"]
    assert cfg["reduced"] == entry["reduced"]
    assert "assumed" in cfg


@pytest.mark.parametrize("cell", BENCH["workloads"], ids=lambda c: c["name"])
def test_cell_resolves(cell):
    assert set(cell) == {"name", "config", "traffic", "chips", "why"}
    assert cell["chips"] in (1, 4) and len(cell["why"]) <= 200
    c = spec.cell(cell["name"])
    assert c.limits, "every cell has the limits of its check"
    assert any(m["name"] == "setup_s" for m in c.end_to_end)
    assert len(c.end_to_end) >= 2 and c.per_layer
    for m in c.end_to_end:
        assert spec.statistic(m["name"])
    for m in c.per_layer:
        assert callable(spec.reader(m["name"]).read)


@pytest.mark.parametrize("metric", BENCH["end_to_end"] + BENCH["per_layer"],
                         ids=lambda m: m["name"])
def test_metric_shape(metric):
    assert NAME.match(metric["name"]) and UNIT.match(metric["unit"])
    assert metric["better"] in ("lower", "higher")
    if "bound" in metric:
        assert 0.01 <= metric["bound"] <= 0.25
        assert metric["source"] in ("host_clock", "device_trace")
    else:
        ends = {m["name"] for m in BENCH["end_to_end"]}
        assert metric["moves"] in ends


CAMERA_PATH = '''
"""An orbit twice as high, looking at the same point."""
from splatbench.cameras import orbit


def poses(cfg, count):
    cam = dict(cfg["camera"], height=2 * cfg["camera"]["height"])
    return orbit.poses(dict(cfg, camera=cam), count)
'''

OPTIONS_ON = {"train_test_exp": True, "use_depth": True}


def test_added_as_files_alone(tmp_path):
    """A configuration, a traffic mix, a per-layer metric and a cell added
    as new files and entries run, with no existing file edited; and a
    configuration with step options on, its own scene kind (depths under
    non-empty masks, alpha masks that zero the right half), camera path,
    reference module and fault, added as new files, trains, passes its
    check, and fails it with its fault planted."""
    root = tiny.make_root(tmp_path)
    before = {p: p.read_bytes() for p in root.rglob("*") if p.is_file()
              and p.name != "BENCHMARK.json"}
    cfg = json.loads((root / "splatbench/configs/m360_3m.json").read_text())
    cfg.update(name="small_orbit", gaussians=1500, capacity=1500)
    (root / "splatbench/configs/small_orbit.json").write_text(json.dumps(cfg))
    mix = json.loads((root / "splatbench/traffic/render_orbit.json")
                     .read_text())
    mix.update(poses=8, check_frames=2, trace_steps=2)
    (root / "splatbench/traffic/render_short.json").write_text(
        json.dumps(mix))
    (root / "splatbench/metrics/frames_traced.render.py").write_text(
        "def read(ctx):\n    return float(len(ctx.views)) or None\n")
    (root / "splatbench/limits/small_orbit.render_short.json").write_text(
        (root / "splatbench/limits/m360_3m.render_orbit.json").read_text())
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append(dict(name="small_orbit", source="a test",
                                 file="splatbench/configs/small_orbit.json",
                                 reduced=[], why="a test"))
    bench["workloads"].append(dict(name="small_orbit.render_short",
                                   config="small_orbit",
                                   traffic="render_short", chips=1,
                                   why="a test"))
    for m in bench["end_to_end"]:
        if m["name"] in ("frame_ms", "frame_p95_ms"):
            m["workloads"].append("small_orbit.render_short")
    bench["per_layer"].append(dict(
        name="frames_traced.render", unit="frames", better="higher",
        source="device_trace", layer="host", moves="frame_ms",
        workloads=["small_orbit.render_short"]))
    (root / "BENCHMARK.json").write_text(json.dumps(bench))

    # a configuration with options on, of its own scene kind, camera path,
    # reference and fault, under the training mix
    cell = options_cell.add(root, "depth_orbit", OPTIONS_ON,
                            gaussians=1500, capacity=2000)
    (root / "splatbench/cameras/orbit_high.py").write_text(CAMERA_PATH)
    path = root / "splatbench/configs/depth_orbit.json"
    cfg = json.loads(path.read_text())
    cfg["camera"]["kind"] = "orbit_high"
    path.write_text(json.dumps(cfg))
    res = run.run("small_orbit.render_short", 7, 0.5, True, device="cpu",
                  root=root)
    assert res["correct"], res["checks"]
    assert res["metrics"]["frames_traced.render"]["value"] == 2.0

    seen = {}
    real_step = program.train_step

    def step(state, inputs, bg, kw):
        half = inputs[2].shape[-1] // 2
        seen.update(kw=kw, n_exposures=state.exposure.shape[0],
                    capacity=state.gaussians.capacity,
                    live=int(state.gaussians.active.sum()),
                    alpha=(float(inputs[2][..., :half].min()),
                           float(inputs[2][..., half:].max())),
                    depth_mask=float(inputs[4].mean()))
        return real_step(state, inputs, bg, kw)
    mp = pytest.MonkeyPatch()
    mp.setattr(program, "train_step", step)
    try:
        res = run.run(cell, 9, 0.3, False, device="cpu", root=root)
    finally:
        mp.undo()
    assert res["correct"], res["checks"]
    assert seen["kw"]["train_test_exp"] and seen["kw"]["use_depth"]
    assert not seen["kw"]["antialiasing"]
    assert not seen["kw"]["use_sparse_adam"]
    assert seen["n_exposures"] == 32
    assert (seen["capacity"], seen["live"]) == (2000, 1500)
    assert seen["alpha"] == (1.0, 0.0)
    assert 0.4 < seen["depth_mask"] < 0.6
    res = run.run(cell, 9, 0.3, False, device="cpu", root=root,
                  fault="exposure_grad_x2")
    worst = res["checks"]["grad_worst_gap"]
    assert not res["correct"] and worst["value"] > worst["limit"], worst
    for p, data in before.items():
        assert p.read_bytes() == data, f"{p} was edited"


ALL_ON = dict.fromkeys(spec.OPTIONS, True)


@pytest.mark.parametrize("options,drop", [
    (OPTIONS_ON, "depth"), (OPTIONS_ON, "mask"), (ALL_ON, ""),
    (ALL_ON, "sparse_adam"), (ALL_ON, "antialiasing")])
def test_options_reference_needs_each_term(tmp_path, options, drop):
    """The check of a configuration with options on passes against the
    reference that follows them (all four, through the port's plain path),
    and fails against the same reference with one term left out: the
    inverse-depth L1, the alpha mask, sparse Adam's mask or the EWA
    filter."""
    root = tiny.make_root(tmp_path)
    cell = options_cell.add(root, "options_orbit", options,
                            gaussians=1500, capacity=2000)
    ref = spec.module("reference", "all_options", root)
    real_render = ref.render
    mp = pytest.MonkeyPatch()
    if drop == "depth":
        mp.setattr(ref, "depth_weight", lambda step, opt: 0.0)
    elif drop == "mask":
        mp.setattr(ref, "masked", lambda image, rec: image)
    elif drop == "sparse_adam":
        mp.setattr(ref, "keep_hidden", lambda new, old, vis: new)
    elif drop == "antialiasing":
        mp.setattr(ref, "render", lambda *a, options, **k: real_render(
            *a, options=dict(options, antialiasing=False), **k))
    try:
        res = run.run(cell, 2 ** 31 + 53, 0.3, False, device="cpu",
                      root=root)
    finally:
        mp.undo()
    assert res["correct"] == (drop == ""), res["checks"]


def test_record_is_what_the_program_was_fed(tmp_path):
    """Each check view's record holds, on the device, the ground truth,
    alpha mask, inverse depth and depth mask that the program's upload fed
    the step, and the pose's index."""
    root = tiny.make_root(tmp_path)
    cell = spec.cell(options_cell.add(root, "depth_orbit", OPTIONS_ON,
                                      gaussians=1500, capacity=2000), root)
    r = drive.Run(cell, 2 ** 31 + 29, 0.0, False, torch.device("cpu"))
    r.program_module()
    r.inputs()
    record = r.reference_inputs()[1]
    for i in range(r.n_poses):
        fed = program.upload(r.cams[i], r.dev)
        rec = record(i)
        assert rec.pose == i
        for got, want in zip((rec.gt, rec.alpha_mask, rec.invdepth,
                              rec.depth_mask), fed[1:]):
            assert got.device == want.device
            assert torch.equal(got, want)
    assert float(record(0).depth_mask.sum()) > 0


def test_default_reference_refuses_options(tmp_path):
    """The default reference refuses a configuration that turns on an
    option it does not implement, at set-up; the configuration's key
    ``sparse_adam`` reads as that option."""
    root = tiny.make_root(tmp_path)
    path = root / "splatbench/configs/m360_3m.json"
    cfg = json.loads(path.read_text())
    assert spec.options(cfg) == dict.fromkeys(spec.OPTIONS, False)
    for given in ({"options": {"antialiasing": True}}, {"sparse_adam": True},
                  {"options": {"use_depth": True}}):
        path.write_text(json.dumps(dict(cfg, **given)))
        with pytest.raises(ValueError, match="does not implement"):
            run.run("m360_3m.train_orbit", 3, 0.1, False, device="cpu",
                    root=root)


def test_step_kw_of_m360_3m_is_unchanged():
    """The configuration without options drives the step with exactly the
    arguments the harness passed before configurations could set them."""
    from gsplat_tpu_torch.config import OptimizationConfig

    cfg = spec.cell("m360_3m.train_orbit").config
    rcfg = program.rasterizer(2.0, pad_cap=640)
    kw = program.step_kw(1297, 840, rcfg, 3.52, spec.options(cfg),
                         cfg["optimization"])
    assert kw == dict(image_width=1297, image_height=840,
                      opt=OptimizationConfig(), rcfg=rcfg,
                      spatial_lr_scale=3.52, antialiasing=False,
                      use_sparse_adam=False, train_test_exp=False,
                      use_depth=False)
