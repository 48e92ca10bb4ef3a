"""A checkout of the benchmark at a size a CPU test run can hold: the data
files and the modules found by name of ``splatbench/`` copied under a
temporary root, every configuration cut to a few thousand splats and a
small frame, and ``BENCHMARK.json`` beside them. Runs of it take the same
code paths as the benchmark's own runs on the card."""
from __future__ import annotations

import json
import shutil
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]
DATA = ("configs", "traffic", "e2e", "metrics", "limits", "scenes", "cameras",
        "reference", "plants")
SIZES = {"m360_3m": dict(gaussians=3000, capacity=3000, width=96, height=64),
         "m360_densify": dict(gaussians=1500, capacity=6000, width=96,
                              height=64)}
# scene parameters of the tiny checkout: splats small enough that a densify
# event clones as well as splits; and a densify event every 5 steps over
# passes of 5 poses, so that a short window holds events
SCENES = {"m360_densify": dict(scale_per_spacing=0.1)}
OPTIMIZATION = {"m360_densify": dict(densification_interval=5)}
TRAFFIC = {"train_densify": dict(poses=5)}


def make_root(tmp: Path) -> Path:
    root = Path(tmp) / "checkout"
    (root / "splatbench").mkdir(parents=True)
    for d in DATA:
        shutil.copytree(REPO / "splatbench" / d, root / "splatbench" / d)
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    for conf in bench["configs"]:
        path = root / conf["file"]
        cfg = json.loads(path.read_text())
        cfg.update(SIZES.get(conf["name"], {}))
        cfg["scene"].update(SCENES.get(conf["name"], {}))
        cfg["optimization"].update(OPTIMIZATION.get(conf["name"], {}))
        cfg["camera"]["focal_px"] = 85.0
        path.write_text(json.dumps(cfg))
    for name, change in TRAFFIC.items():
        path = root / "splatbench" / "traffic" / f"{name}.json"
        path.write_text(json.dumps(dict(json.loads(path.read_text()),
                                        **change)))
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return root
