"""The tiny cells on a card: the system's CUDA kernels against the
reference, and the lower-precision control failing the same limits; and
a training cell with all four step options on, 200,000 splats at
1297x840, against the reference that follows them, under m360_3m's
training limits. (At 20,000 splats one splat whose gradient lies within
rounding of 0 moves under Adam by its rate with either sign, and that
one row moves ``change_gap`` by some 5e-05, with the options on or off.)
Marked ``cuda``; they skip without a card."""
from __future__ import annotations

import json

import pytest
import torch

from splatbench import calibrate, run, spec
from splatbench.tests import options_cell, tiny

CELLS = ["m360_3m.train_orbit", "m360_3m.render_orbit"]
ALL_OPTIONS = dict.fromkeys(spec.OPTIONS, True)


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return tiny.make_root(tmp_path_factory.mktemp("bench"))


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_cell_on_the_card(root, cell):
    res = run.run(cell, 2 ** 31 + 101, 0.5, True, device="cuda", root=root)
    assert res["device"]["platform"] == "gpu"
    assert res["correct"], res["checks"]
    assert res["device"]["busy_s"] > 0


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_control_on_the_card(root, cell):
    limits = spec.cell(cell, root).limits
    rows = run.spawn(calibrate.calib_rank, 1, dict(
        workload=cell, seeds=[11, 12, 13], control=True, fault="", out="",
        device="cuda", root=str(root)))
    for row in rows:
        assert all(v <= limits[k] for k, v in row["program"].items()), row
        assert any(v > limits[k] for k, v in row["control"].items()), row


@pytest.fixture(scope="module")
def options_root(tmp_path_factory):
    """A checkout with the cell ``all_options.train_orbit``: every step
    option on, 200,000 splats at 1297x840 on m360_3m's orbit, depths under
    half-pixel masks and alpha masks that zero the right half."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    root = tiny.make_root(tmp_path_factory.mktemp("options"))
    cfg = json.loads((tiny.REPO / "splatbench/configs/m360_3m.json")
                     .read_text())
    cell = options_cell.add(root, "all_options", ALL_OPTIONS,
                            gaussians=200_000, capacity=200_000, width=1297,
                            height=840, camera=cfg["camera"])
    return root, cell


@pytest.mark.cuda
@pytest.mark.parametrize("seed", [2 ** 31 + 211, 2 ** 31 + 212,
                                  2 ** 31 + 213])
def test_all_options_on_the_card(options_root, seed):
    """The EWA filter, the inverse-depth gradient, the exposures and sparse
    Adam through the CUDA kernels, inside the training limits."""
    root, cell = options_root
    res = run.run(cell, seed, 0.5, False, device="cuda", root=root)
    print(cell, seed, json.dumps(res["checks"]))
    assert res["device"]["platform"] == "gpu"
    assert res["correct"], res["checks"]


@pytest.mark.cuda
def test_all_options_control_and_fault_on_the_card(options_root):
    """The control (the reference in TF32) fails the limits the system
    passes; the exposures' gradient doubled fails ``grad_worst_gap``."""
    root, cell = options_root
    limits = spec.cell(cell, root).limits
    rows = run.spawn(calibrate.calib_rank, 1, dict(
        workload=cell, seeds=[31, 32, 33], control=True, fault="", out="",
        device="cuda", root=str(root)))
    for row in rows:
        print(cell, row["seed"], json.dumps(row["program"]),
              json.dumps(row["control"]))
        assert all(v <= limits[k] for k, v in row["program"].items()), row
        assert any(v > limits[k] for k, v in row["control"].items()), row
    res = run.run(cell, 2 ** 31 + 214, 0.5, False, device="cuda", root=root,
                  fault="exposure_grad_x2")
    print(cell, "exposure_grad_x2", json.dumps(res["checks"]))
    worst = res["checks"]["grad_worst_gap"]
    assert not res["correct"] and worst["value"] > worst["limit"], worst
