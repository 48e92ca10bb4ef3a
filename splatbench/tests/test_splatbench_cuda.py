"""The tiny cells on a card: the system's CUDA kernels against the
reference, and the lower-precision control failing the same limits.
Marked ``cuda``; they skip without a card."""
from __future__ import annotations

import pytest
import torch

from splatbench import calibrate, run, spec
from splatbench.tests import tiny

CELLS = ["m360_3m.train_orbit", "m360_3m.render_orbit"]


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
