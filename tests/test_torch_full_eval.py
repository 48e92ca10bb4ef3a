"""The port's full-evaluation orchestrator (gsplat_tpu_torch/cli/
full_eval.py) end to end on the CPU: train → render → metrics through the
port's CLIs on a ``truck`` scene of tests/torch_parity.py:make_colmap_scene
(120 points, 6 cameras, 64x48) for 12 iterations, as
tests/test_full_eval.py drives the JAX orchestrator on a larger scene.
Checks ``timing.txt``, ``results.json``, ``per_view.json`` and the test
renders, and that an unknown scene name is refused."""
import json
import math
import sys

import pytest

from gsplat_tpu_torch.cli import full_eval

from torch_parity import make_colmap_scene

ITERS = 12


@pytest.fixture(autouse=True)
def _keep_stdout(monkeypatch):
    monkeypatch.setattr(sys, "stdout", sys.stdout)   # the CLIs swap stdout
    # the loop's telemetry mirrors its scalars to TensorBoard when it
    # imports, which loads TensorFlow here (about 17 s a process); the
    # files this test reads do not need it
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)


def test_full_eval_on_a_tiny_scene(tmp_path, rng, monkeypatch):
    monkeypatch.delenv("GSPLAT_LPIPS_WEIGHTS", raising=False)
    data = tmp_path / "data"
    make_colmap_scene(str(data / "truck"), rng=rng)
    out = tmp_path / "eval"
    full_eval.main(["-tat", str(data), "--scene_subset", "truck",
                    "--output_path", str(out), "--iterations", str(ITERS),
                    "--device", "cpu"])

    timing = (out / "timing.txt").read_text().splitlines()
    assert len(timing) == 1 and timing[0].startswith("truck: ")
    model = out / "truck"
    with open(model / "results.json") as f:
        results = json.load(f)
    with open(model / "per_view.json") as f:
        per_view = json.load(f)
    method = f"ours_{ITERS}"
    assert list(results) == [method] and list(per_view) == [method]
    m = results[method]
    assert math.isfinite(m["SSIM"]) and math.isfinite(m["PSNR"])
    assert math.isnan(m["LPIPS"])          # no weights file here
    renders = sorted(p.name for p in (model / "test" / method
                                      / "renders").iterdir())
    gts = sorted(p.name for p in (model / "test" / method / "gt").iterdir())
    assert renders == gts and len(renders) >= 1
    assert sorted(per_view[method]["PSNR"]) == renders
    assert not (model / "train").exists()  # --skip_train


def test_unknown_scene_is_refused(tmp_path):
    with pytest.raises(SystemExit):
        full_eval.main(["--scene_subset", "nowhere", "--output_path",
                        str(tmp_path), "--device", "cpu"])
