"""The numbers that decide ``correct``, each held to its limit.

Training (the first steps of set-up, which the reference follows):

- ``loss_gap``: the largest |loss - reference| / |reference| over the
  steps;
- ``grad_worst_gap``: over the leaves, the largest gap between the norm
  of the first gradient as Adam took it and the reference's norm, over
  the larger of the reference's norm of that leaf and of the median leaf.
  It sees a gradient off by a factor in one leaf, which Adam's first
  steps (lr times the gradient's sign) hide from ``change_gap``;
- ``grad_median_gap``: the median of the same gaps over the leaves, which
  one leaf's largest splats at a rounding edge do not move;
- ``change_gap``: the same of the norm of each leaf's change over the
  steps. A leaf whose reference gradient is under a thousandth of the
  median leaf's moves by round-off alone under Adam, and is left out of
  both (none is, in the configurations here).

Frames (a sample of the window's frames, rendered again by the
reference): ``frame_mean_gap``, the mean absolute difference over the
three colours and the inverse depth (over the reference's largest). The
largest difference of one pixel is no fit number: two splats whose depths
lie within rounding of each other are composited in either order, which
changes that pixel by up to their colours' difference on sound runs.
"""
from __future__ import annotations

import math
import statistics


def _gap(got: dict, ref: dict, keys, over) -> float:
    """``over`` (max or median) of the leaves' norm gaps."""
    keys = list(keys)
    if not keys:
        return 0.0
    if not all(math.isfinite(got[k]) for k in keys):
        return math.inf
    med = statistics.median(ref[k] for k in keys)
    return over([abs(got[k] - ref[k]) / max(ref[k], med, 1e-30)
                 for k in keys])


def train_numbers(prog: dict, ref) -> dict:
    """The training check's numbers from the system's readings (``loss``
    list, ``grad_norm`` and ``change_norm`` by leaf) and the reference's
    (``reference.train.Steps``)."""
    loss = 0.0
    for a, b in zip(prog["loss"], ref.loss):
        loss = max(loss, abs(a - b) / abs(b) if math.isfinite(a)
                   else math.inf)
    med = statistics.median(ref.grad_norm.values())
    keep = [k for k, v in ref.grad_norm.items() if v >= 1e-3 * med]
    return {"loss_gap": loss,
            "grad_worst_gap": _gap(prog["grad_norm"], ref.grad_norm, keep,
                                   max),
            "grad_median_gap": _gap(prog["grad_norm"], ref.grad_norm, keep,
                                    statistics.median),
            "change_gap": _gap(prog["change_norm"], ref.change_norm, keep,
                               max)}


def frame_numbers(got: dict, ref: dict) -> dict:
    """The frames' number: ``got`` and ``ref`` map a pose to (image,
    inverse depth, radii)."""
    mean = 0.0
    for i, (img, inv, _) in got.items():
        rimg, rinv, _ = ref[i]
        scale = float(rinv.abs().max()) or 1.0
        gap = (3 * float((img - rimg).abs().mean())
               + float((inv - rinv).abs().mean()) / scale) / 4
        mean += gap / len(got) if math.isfinite(gap) else math.inf
    return {"frame_mean_gap": mean}


def judge(numbers: dict, limits: dict) -> dict:
    """{name: {"value", "limit"}}; a number without a limit has the limit
    0, which only an exact comparison passes."""
    return {k: {"value": v, "limit": limits.get(k, 0.0)}
            for k, v in numbers.items()}
