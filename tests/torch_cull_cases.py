"""Entry rows that try the compositor's cull rectangle, made with numpy
from a seed: random and adversarial gaussians (tiny and tile-filling
splats, long thin ones, b near ±sqrt(ac), det <= 0, NaN and infinite rows,
opacity below, at and just above alpha_min, opacity above the alpha_max
clamp) laid out as a chunk-aligned entry list over a 2x2 grid of tiles.
Shared by tests/test_torch_cull.py (CPU) and tests/test_torch_cuda.py (the
card); imports neither JAX nor the JAX package."""
import numpy as np
import torch

from gsplat_tpu_torch.config import RasterizerConfig

CFG = RasterizerConfig()
CONSTS = dict(alpha_min=CFG.alpha_min, alpha_max=CFG.alpha_max)
# (tile_h, tile_w, chunk): the default tile, a small one, a wide one, and
# one whose width is no power of two with a chunk that is none either
SHAPES = [(32, 32, 64), (16, 16, 16), (8, 128, 16), (8, 24, 12)]
SHAPE_IDS = ["32x32", "16x16", "8x128", "8x24"]
NTX, NTY = 2, 2
N = 48                                   # rows per tile
KINDS = ["random", "tiny", "tile_filling", "anisotropic", "near_degenerate",
         "det_nonpositive", "nonfinite", "opacity_edge", "clamped"]


def conic(s1, s2, theta):
    """Conic (a, b, c) of a gaussian with axes s1, s2 (pixels) turned by
    theta."""
    co, si = np.cos(theta), np.sin(theta)
    i1, i2 = 1.0 / s1 ** 2, 1.0 / s2 ** 2
    return (co * co * i1 + si * si * i2, co * si * (i1 - i2),
            si * si * i1 + co * co * i2)


def rows(kind, rng, n, w, h):
    """(n, 16) float32 entry rows of the named kind on a w × h frame."""
    mean = np.stack([rng.uniform(-0.1 * w, 1.1 * w, n),
                     rng.uniform(-0.1 * h, 1.1 * h, n)], 1)
    s1 = rng.uniform(1.0, 0.3 * max(w, h), n)
    s2 = rng.uniform(1.0, 0.3 * max(w, h), n)
    theta = rng.uniform(0, np.pi, n)
    op = rng.uniform(0.02, 0.95, n)
    if kind == "tiny":
        s1, s2 = rng.uniform(0.05, 0.6, n), rng.uniform(0.05, 0.6, n)
        mean[::3] = np.round(mean[::3])          # exactly on a pixel
    elif kind == "tile_filling":
        s1, s2 = rng.uniform(50, 5000, n), rng.uniform(50, 5000, n)
        mean[::4] *= 40.0                        # far outside the frame
    elif kind == "anisotropic":
        s1, s2 = rng.uniform(20, 2000, n), rng.uniform(0.05, 0.5, n)
    a, b, c = conic(s1, s2, theta)
    if kind in ("near_degenerate", "det_nonpositive"):
        a, c = rng.uniform(1e-4, 2.0, n), rng.uniform(1e-4, 2.0, n)
        eps = np.resize([1e-2, 1e-4, 1e-6, 1e-7, 1e-8], n)
        if kind == "det_nonpositive":
            eps = np.resize([0.0, -1e-7, -1e-3, -0.5], n)
        b = np.sqrt(a * c) * (1.0 - eps) * rng.choice([-1.0, 1.0], n)
        if kind == "det_nonpositive":
            a[::5] *= -1.0                       # a < 0
            c[1::5] = 0.0                        # c = 0
    elif kind == "opacity_edge":
        lo = np.float32(CFG.alpha_min)
        op = np.resize([0.0, 0.5 * lo, np.nextafter(lo, np.float32(0)), lo,
                        np.nextafter(lo, np.float32(1)), 1.001 * lo,
                        2.0 * lo, -0.2], n).astype(np.float64)
        mean[::2] = np.round(mean[::2])          # power == 0 on a pixel
    elif kind == "clamped":
        op = np.resize([0.99, 0.995, 1.0, 1.5, 30.0], n)
    e = np.zeros((n, 16), np.float32)
    e[:, 0:2] = mean
    e[:, 2], e[:, 3], e[:, 4], e[:, 5] = a, b, c, op
    e[:, 6:10] = rng.uniform(0, 1, (n, 4))
    if kind == "nonfinite":
        bad = [np.nan, np.inf, -np.inf]
        for i in range(0, n, 2):                 # every other row, one field
            e[i, (i // 2) % 6] = bad[(i // 2) % 3]
    return e


def frame(kind, shape, seed=0, device="cpu"):
    """((entries, tile_start, tile_count), compositor keywords without
    t_eps) of one frame of the named kind."""
    th, tw, chunk = shape
    rng = np.random.default_rng([seed, KINDS.index(kind), th, tw])
    per = -(-N // chunk) * chunk
    T = NTX * NTY
    entries = np.zeros((T * per, 16), np.float32)
    for t in range(T):
        entries[t * per:t * per + N] = rows(kind, rng, N, NTX * tw, NTY * th)
    geo = dict(n_tiles_x=NTX, n_tiles_y=NTY, tile_h=th, tile_w=tw,
               chunk=chunk, **CONSTS)
    return (torch.tensor(entries, device=device),
            torch.arange(T, dtype=torch.int32, device=device) * per,
            torch.full((T,), N, dtype=torch.int32, device=device)), geo
