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

Densification (a mix whose check steps end in a densify event):

- ``count_rows_gap``: the rows whose count of views (the statistics'
  denominator) differs from the reference's over the same views, before
  the event (exact: the limit is 0);
- ``radii_gap``: the norm of the row-by-row difference of the largest
  screen radius from the reference's, over the reference's norm;
- ``accum_gap``: the gap between the norm of the accumulated
  screen-space gradient norm and the reference's, over the reference's
  (a gap of norms: the norm of their difference, a reading beside it,
  ``stats_diff.accum``, swings by a factor 3 from seed to seed with a few
  splats at a rounding edge of the compositor's alpha or transmittance
  tests; the two numbers before it hold the statistics to their rows);
- ``live_rows_gap``: the rows whose live flag after the event differs
  from the reference's event on the program's state before it, with the
  same split draws (exact: the limit is 0);
- ``densify_gap``: over every per-row field of the state after the event
  (the leaves, Adam's moments, the statistics), the largest difference
  from the reference's over the reference's largest magnitude of that
  field.

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

import torch


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


def pad(t, rows: int):
    """``t`` with zero rows appended up to ``rows``."""
    if t.shape[0] >= rows:
        return t
    return torch.cat([t, t.new_zeros((rows - t.shape[0],) + t.shape[1:])])


def stats_numbers(prog: dict, ref: dict) -> dict:
    """The statistics' numbers of the program's statistics (capacity
    rows) against the reference's (its live rows first, the rest zero):
    ``count_rows_gap``, ``radii_gap`` and ``accum_gap``; the norm of the
    accumulated norm's difference is a reading, ``stats_diff.accum``."""
    def rows(k):
        got = prog[k].float()
        return got, pad(ref[k].float(), got.shape[0])

    def over(v, want):
        return v / max(float(torch.linalg.norm(want)), 1e-30)

    got, want = rows("denom")
    count = float((got != want).sum())
    got, want = rows("max_radii2d")
    radii = over(float(torch.linalg.norm(got - want)), want)
    got, want = rows("xyz_gradient_accum")
    accum = over(abs(float(torch.linalg.norm(got))
                     - float(torch.linalg.norm(want))), want)
    diff = over(float(torch.linalg.norm(got - want)), want)
    return {k: v if math.isfinite(v) else math.inf for k, v in (
        ("count_rows_gap", count), ("radii_gap", radii),
        ("accum_gap", accum), ("stats_diff.accum", diff))}


def densify_numbers(prog: dict, ref: dict) -> dict:
    """``live_rows_gap`` and ``densify_gap`` of the program's rows after
    an event against the reference's (``program.rows``' names)."""
    gap = 0.0
    for k, want in ref.items():
        if k == "active":
            continue
        d = float((prog[k] - want).abs().max())
        top = max(float(want.abs().max()), 1e-30)
        gap = max(gap, d / top if math.isfinite(d) else math.inf)
    return {"live_rows_gap": float((prog["active"] != ref["active"]).sum()),
            "densify_gap": gap}


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
    0, which only an exact comparison passes. A field's part of a number
    (``<number>.<field>``) is a reading, not judged."""
    return {k: {"value": v, "limit": limits.get(k, 0.0)}
            for k, v in numbers.items() if "." not in k}
