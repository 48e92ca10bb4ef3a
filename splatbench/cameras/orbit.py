"""The ``orbit`` camera path: poses evenly around the vertical axis."""
from __future__ import annotations

import math

import numpy as np

from splatbench.scene import look_at


def poses(cfg: dict, count: int):
    """``count`` (R, T) poses evenly around the vertical axis at the
    camera's radius and height, looking at its target."""
    cam = cfg["camera"]
    out = []
    for i in range(count):
        a = 2 * math.pi * i / count
        c = np.array([cam["radius"] * math.cos(a), cam["radius"] * math.sin(a),
                      cam["height"]])
        out.append(look_at(c, np.asarray(cam["target"], np.float64),
                           np.array([0.0, 0.0, 1.0])))
    return out
