"""A configuration that turns step options on, added to a checkout as new
files alone: a scene kind with depths and alpha masks
(``capture360_depth``), the reference that follows every option
(``options_reference.py``, as ``all_options``), a fault that doubles the
exposures' gradient (``exposure_grad_x2``), the configuration (m360_3m's
with its options and sizes) and its training cell, under m360_3m's
training mix, limits and end-to-end metrics."""
from __future__ import annotations

import json
from pathlib import Path

SCENE = '''
"""capture360's splats; each pose's inverse depth, uniform in 0.1 to 0.5,
under a depth mask that keeps half of the pixels, both drawn from the
seed; and an alpha mask that zeroes the right half of every image, as the
3DGS loader masks a view trained under ``train_test_exp``."""
import numpy as np

from splatbench.scenes import capture360


def params(cfg, seed, device):
    return capture360.params(cfg, seed, device)


def depths(cfg, poses, seed):
    rng = np.random.default_rng(seed ^ 0xDE9)
    shape = (len(poses), 1, cfg["height"], cfg["width"])
    inv = rng.uniform(0.1, 0.5, shape).astype(np.float32)
    return inv, (rng.random(shape) < 0.5).astype(np.float32)


def masks(cfg, poses, seed):
    m = np.ones((len(poses), 1, cfg["height"], cfg["width"]), np.float32)
    m[..., cfg["width"] // 2:] = 0.0
    return m
'''

FAULT = '''
"""The exposures' gradient doubled where the step takes it."""


def plant():
    from gsplat_tpu_torch.train import trainer
    real = trainer.camera_loss_grads

    def camera_loss_grads(*a, **k):
        out = real(*a, **k)
        return out[:5] + (2 * out[5],) + out[6:]
    trainer.camera_loss_grads = camera_loss_grads
'''

REFERENCE = Path(__file__).with_name("options_reference.py")


def add(root: Path, name: str, options: dict, **changes) -> str:
    """Adds the files above and the configuration ``name`` (m360_3m's as
    the checkout at ``root`` has it, with ``options``, the reference
    ``all_options``, the scene kind ``capture360_depth`` and ``changes``)
    with its cell ``<name>.train_orbit``, whose name it returns."""
    sb = root / "splatbench"
    (sb / "scenes/capture360_depth.py").write_text(SCENE)
    (sb / "reference/all_options.py").write_text(REFERENCE.read_text())
    (sb / "plants/exposure_grad_x2.py").write_text(FAULT)
    cfg = json.loads((sb / "configs/m360_3m.json").read_text())
    cfg.update(name=name, reference="all_options", options=options,
               **changes)
    cfg["scene"]["kind"] = "capture360_depth"
    (sb / f"configs/{name}.json").write_text(json.dumps(cfg))
    cell = f"{name}.train_orbit"
    (sb / f"limits/{cell}.json").write_text(
        (sb / "limits/m360_3m.train_orbit.json").read_text())
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append(dict(name=name, source="a test",
                                 file=f"splatbench/configs/{name}.json",
                                 reduced=[], why="a test"))
    bench["workloads"].append(dict(name=cell, config=name,
                                   traffic="train_orbit", chips=1,
                                   why="a test"))
    for m in bench["end_to_end"]:
        if m["name"] == "train_pixels_per_s":
            m["workloads"].append(cell)
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return cell
