"""BENCHMARK.json against the contract's shape, every cell and metric
resolving to its files, and a cell, a traffic mix and a per-layer metric
added as files alone."""
from __future__ import annotations

import json
import re

import pytest

from splatbench import run, spec
from splatbench.tests import tiny

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


def test_added_as_files_alone(tmp_path):
    """A configuration, a traffic mix, a per-layer metric and a cell added
    as new files and entries run, with no existing file edited."""
    root = tiny.make_root(tmp_path)
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
    res = run.run("small_orbit.render_short", 7, 0.5, True, device="cpu",
                  root=root)
    assert res["correct"], res["checks"]
    assert res["metrics"]["frames_traced.render"]["value"] == 2.0
