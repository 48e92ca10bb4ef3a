"""Whole runs of the tiny checkout on the CPU: the result line's keys, the
check passing on the system and failing on each planted fault, and no
module of JAX or the JAX package loaded."""
from __future__ import annotations

import json
import os
import subprocess
import sys

import pytest

import torch

from splatbench import drive, run, spec
from splatbench.tests import tiny

KEYS = ["correct", "attempted", "failed", "metrics", "device"]


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny.make_root(tmp_path_factory.mktemp("bench"))


@pytest.mark.parametrize("cell,trace", [
    ("m360_3m.train_orbit", False), ("m360_3m.render_orbit", True),
    ("m360_densify.train_densify", True)])
def test_result_line(root, cell, trace):
    res = run.run(cell, 2 ** 31 + 11, 0.5, trace, device="cpu", root=root)
    want = KEYS + (["breakdown"] if "breakdown" in res else []) + ["checks"]
    assert list(res) == want
    assert res["correct"], res["checks"]
    assert res["attempted"] > 0 and res["failed"] == 0
    if not trace:
        assert "setup_s" in res["metrics"]
        assert all(m["value"] > 0 for m in res["metrics"].values())
    assert set(res["device"]) >= {"platform", "kind", "count",
                                  "memory_peak_bytes"}
    for c in res["checks"].values():
        assert c["value"] <= c["limit"]


@pytest.mark.parametrize("cell,fault", [
    ("m360_3m.train_orbit", "unchanged"),
    ("m360_3m.train_orbit", "half_batch"),
    ("m360_3m.render_orbit", "frame_altered"),
    ("m360_3m.render_orbit", "half_frame"),
    ("m360_densify.train_densify", "unchanged"),
    ("m360_densify.train_densify", "half_batch"),
    ("m360_densify.train_densify", "no_prune"),
    ("m360_densify.train_densify", "split_unscaled"),
    ("m360_densify.train_densify", "stats_shifted")])
def test_fault_fails_the_check(root, cell, fault):
    res = run.run(cell, 2 ** 31 + 13, 0.3, False, device="cpu", root=root,
                  fault=fault)
    assert not res["correct"], res["checks"]


def test_densify_agrees_with_the_reference(root):
    """The tiny densification mix: the check steps' event clones, splits
    and prunes, and the program's event agrees with the reference's on
    the program's state before it, row for row; the window's events are
    timed and read as densify spans, and its first is made again and
    counted after the close."""
    cell = spec.cell("m360_densify.train_densify", root)
    r = drive.Run(cell, 2 ** 31 + 19, 3.0, False, torch.device("cpu")).run()
    assert r.ok, r.checks
    assert r.checks["live_rows_gap"]["value"] == 0
    assert min(r.check_event[k] for k in ("clones", "splits", "pruned")) > 0
    assert r.check_event["overflow"] == 0
    assert len(r.densify_s) == r.events > 0
    assert len(r.event_counts) == 3
    assert r.failed == 0
    ctx = drive.layer_context(cell, r, 1)
    assert spec.reader("densify_ms.train", root).read(ctx) > 0


@pytest.mark.parametrize("fault", ["", "no_exchange", "half_batch",
                                   "unchanged"])
def test_data_parallel_over_four_ranks(root, fault):
    """The four-card cell's path in four CPU processes over gloo: correct
    as it is, not correct without the exchange, with half the batch, or
    with the state unchanged."""
    res = run.run("m360_3m.train_orbit_dp4", 2 ** 31 + 17, 0.3, False,
                  device="cpu", root=root, fault=fault)
    assert res["device"]["count"] == 4
    assert res["correct"] == (fault == ""), res["checks"]


def test_no_card_no_result():
    """Without a CUDA card the command prints no result and fails."""
    p = subprocess.run([sys.executable, "-m", "splatbench.run", "--workload",
                        "m360_3m.train_orbit", "--seed", "1", "--seconds",
                        "1", "--trace", "0"], cwd=tiny.REPO,
                       env=dict(os.environ, CUDA_VISIBLE_DEVICES=""),
                       capture_output=True, text=True, timeout=300)
    assert p.returncode != 0
    assert "{" not in p.stdout


def test_no_jax_in_a_run(root):
    """No module whose top-level name is jax, jaxlib, flax or gsplat_tpu
    (compared whole: gsplat_tpu_torch is the system) after a run, and the
    reference loads nothing of the system."""
    code = (
        "import sys, json\n"
        "from splatbench import run, drive\n"
        f"run.run('m360_3m.train_orbit', 5, 0.2, False, device='cpu', "
        f"root={str(root)!r})\n"
        "print(json.dumps(drive.banned_modules()))\n")
    p = subprocess.run([sys.executable, "-c", code], cwd=tiny.REPO,
                       capture_output=True, text=True, timeout=600)
    assert p.returncode == 0, p.stderr[-2000:]
    assert json.loads(p.stdout.strip().splitlines()[-1]) == []
    code = ("import sys\n"
            "import splatbench.reference.train, splatbench.scene, "
            "splatbench.check, splatbench.counts\n"
            "print(sorted({m.split('.')[0] for m in sys.modules}))\n")
    p = subprocess.run([sys.executable, "-c", code], cwd=tiny.REPO,
                       capture_output=True, text=True, timeout=300)
    top = p.stdout.strip().splitlines()[-1]
    for name in ("gsplat_tpu_torch", "gsplat_tpu", "jax", "jaxlib"):
        assert f"'{name}'" not in top
