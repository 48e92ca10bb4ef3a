"""The benchmark as data: ``BENCHMARK.json`` at the checkout's root names
the cells, the metrics and the configurations, and everything that belongs
to one of them sits in a file of its own that is found by its name:

- ``splatbench/configs/<config>.json``: a configuration (the file
  ``BENCHMARK.json`` names for it);
- ``splatbench/traffic/<traffic>.json``: a traffic mix, the parameters
  that ``splatbench.drive`` reads;
- ``splatbench/e2e/<metric>.json``: which statistic of a run an end-to-end
  metric is;
- ``splatbench/metrics/<metric>.py``: the reader of a per-layer metric, a
  ``read(ctx)`` that returns a number or None;
- ``splatbench/limits/<cell>.json``: the limit of each number the cell's
  check compares;
- ``splatbench/scenes/<kind>.py`` and ``splatbench/cameras/<kind>.py``: the
  scene and the camera path a configuration's ``scene.kind`` and
  ``camera.kind`` name;
- ``splatbench/reference/<name>.py``: the plain reference a configuration's
  ``reference`` names (``train`` where it names none);
- ``splatbench/plants/<name>.py``: a fault planted in the system under
  test by name (``splatbench.faults.plant``), where ``faults.py`` has
  none of that name.

A configuration's optional ``options`` block holds the step options
(``OPTIONS``), each off where it is not given.
"""
from __future__ import annotations

import importlib.util
import json
from pathlib import Path
from typing import List, NamedTuple

ROOT = Path(__file__).resolve().parents[1]
OPTIONS = ("antialiasing", "sparse_adam", "train_test_exp", "use_depth")
_MODULES: dict = {}


class Cell(NamedTuple):
    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: List[dict]   # the cell's entries of ``end_to_end``
    per_layer: List[dict]    # the cell's entries of ``per_layer``
    limits: dict
    root: Path


def benchmark(root: Path = ROOT) -> dict:
    with open(Path(root) / "BENCHMARK.json") as f:
        return json.load(f)


def _read(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def cell(name: str, root: Path = ROOT) -> Cell:
    root = Path(root)
    b = benchmark(root)
    w = {c["name"]: c for c in b["workloads"]}.get(name)
    if w is None:
        raise KeyError(f"no cell {name!r} in BENCHMARK.json")
    conf = {c["name"]: c for c in b["configs"]}[w["config"]]
    e2e = [m for m in b["end_to_end"]
           if "workloads" not in m or name in m["workloads"]]
    e2e_names = {m["name"] for m in e2e}
    layer = [m for m in b["per_layer"]
             if (name in m["workloads"] if "workloads" in m
                 else m["moves"] in e2e_names)]
    limits_path = root / "splatbench" / "limits" / f"{name}.json"
    return Cell(name=name, chips=int(w["chips"]),
                config=_read(root / conf["file"]),
                traffic=_read(root / "splatbench" / "traffic"
                              / f"{w['traffic']}.json"),
                end_to_end=e2e, per_layer=layer,
                limits=_read(limits_path) if limits_path.exists() else {},
                root=root)


def statistic(metric: str, root: Path = ROOT) -> str:
    """The run statistic an end-to-end metric reports."""
    return _read(Path(root) / "splatbench" / "e2e"
                 / f"{metric}.json")["statistic"]


def module(folder: str, name: str, root: Path = ROOT):
    """The module ``splatbench/<folder>/<name>.py`` of the checkout at
    ``root``, loaded from its file once."""
    path = (Path(root) / "splatbench" / folder / f"{name}.py").resolve()
    if path not in _MODULES:
        if not path.exists():
            raise KeyError(f"no {folder} module {name!r} ({path})")
        spec = importlib.util.spec_from_file_location(
            "splatbench_" + "_".join((folder, name)).replace(
                ".", "_").replace("-", "_"), path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        _MODULES[path] = mod
    return _MODULES[path]


def reader(metric: str, root: Path = ROOT):
    """The module of a per-layer metric's reader, loaded from its file:
    ``read(ctx)``, and ``AGGREGATE`` (``max``; the mean over ranks where it
    is absent)."""
    return module("metrics", metric, root)


def options(cfg: dict) -> dict:
    """The step options of a configuration: its ``options`` block, each
    option off where it is not given (``sparse_adam`` also read from a
    top-level key)."""
    given = dict(cfg.get("options", {}))
    unknown = set(given) - set(OPTIONS)
    if unknown:
        raise ValueError(f"unknown step options {sorted(unknown)}")
    given.setdefault("sparse_adam", cfg.get("sparse_adam", False))
    return {k: bool(given.get(k, False)) for k in OPTIONS}
