"""The reference against the system on the tiny checkout: the system's
numbers inside the cells' limits, the lower-precision control's (the
reference with TF32 products in the system's place) outside them; and
the counting functions against hand counts; TF32 off while the reference
runs."""
from __future__ import annotations

import pytest
import torch

from splatbench import calibrate, check, counts, program, run, scene, spec
from splatbench.reference import raster
from splatbench.tests import tiny


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny.make_root(tmp_path_factory.mktemp("bench"))


@pytest.mark.parametrize("cell", ["m360_3m.train_orbit",
                                  "m360_3m.render_orbit",
                                  "m360_densify.train_densify"])
def test_system_passes_control_fails(root, cell):
    limits = spec.cell(cell, root).limits
    args = dict(workload=cell, seeds=[3, 4], control=True, fault="",
                out="", device="cpu", root=str(root))
    rows = run.spawn(calibrate.calib_rank, 1, args)
    for row in rows:
        judged = {k: v for k, v in row["program"].items() if k in limits}
        assert len(judged) == len(limits), row
        assert all(v <= limits[k] for k, v in judged.items()), row
        assert any(v > limits[k] for k, v in row["control"].items()
                   if k in limits), row


def test_antialiased_frame_matches_the_port(root):
    """The reference's frames with the EWA filter against the port's plain
    path with ``antialiasing`` on, under render_orbit's limit; the
    reference's frames without the filter lie outside it."""
    cell = spec.cell("m360_3m.render_orbit", root)
    cfg, dev = cell.config, torch.device("cpu")
    W, H, sh = cfg["width"], cfg["height"], cfg["sh_degree"]
    p, poses, gt = scene.make(cfg, 2 ** 31 + 41, dev, 4, root)
    fov = scene.fov(cfg)
    bg = torch.tensor(cfg["background"], dtype=torch.float32)
    g = program.gaussians(p, sh, cfg["capacity"])
    views = [program.view(program.camera(i, poses[i], fov, gt[i]), dev)
             for i in range(len(poses))]
    rcfg, _ = program.right_size(g, views, W, H, bg,
                                 cfg["first_pairs_per_gaussian"], True)
    got, ref, plain = {}, {}, {}
    for i, v in enumerate(views):
        o = program.frame(g, v, W, H, bg, rcfg, True)
        got[i] = (o.image, o.invdepth, o.radii)
        for out, aa in ((ref, True), (plain, False)):
            f = raster.render(p, scene.view(*poses[i], *fov, dev), W, H, bg,
                              sh, raster.Products(), antialiasing=aa)
            out[i] = (f.image, f.invdepth, f.radius)
    limit = cell.limits["frame_mean_gap"]
    assert check.frame_numbers(got, ref)["frame_mean_gap"] <= limit
    assert check.frame_numbers(got, plain)["frame_mean_gap"] > limit


class _Spy(raster.Products):
    """Float32 products that record the library's TF32 flags at each."""

    def __init__(self):
        super().__init__(False)
        self.flags = set()

    def _seen(self):
        self.flags.add((torch.backends.cuda.matmul.allow_tf32,
                        torch.backends.cudnn.allow_tf32))

    def mm(self, a, b):
        self._seen()
        return super().mm(a, b)

    def conv(self, x, w, **kw):
        self._seen()
        return super().conv(x, w, **kw)


def test_reference_runs_with_tf32_off(root, monkeypatch):
    """The reference's products and SSIM convolutions run with TF32 off
    even where the process turned it on, and the flags are as they were
    after."""
    from splatbench import scene
    from splatbench.reference import train as ref_train

    cfg = spec.cell("m360_3m.train_orbit", root).config
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    dev = torch.device("cpu")
    p, poses, gt = scene.make(cfg, 5, dev, 2)
    fov = scene.fov(cfg)
    views = [(scene.view(R, T, *fov, dev), torch.tensor(gt[i]))
             for i, (R, T) in enumerate(poses)]
    bg = torch.zeros(3)
    spy = _Spy()
    raster.render(p, views[0][0], cfg["width"], cfg["height"], bg,
                  cfg["sh_degree"], spy)
    ref_train.train_steps(
        p, [[v] for v in views], W=cfg["width"], H=cfg["height"], bg=bg,
        sh_degree=cfg["sh_degree"], extent=scene.extent(cfg, 2),
        opt=cfg["optimization"], first_step=cfg["first_step"], prod=spy)
    assert spy.flags == {(False, False)}
    assert torch.backends.cuda.matmul.allow_tf32
    assert torch.backends.cudnn.allow_tf32


def _frame(splats, W=64, H=32):
    """A W x H frame (two 32 x 32 tiles) of the given splats: (mean x,
    mean y, depth, sigma, opacity), isotropic, radius 3 sigma."""
    n = len(splats)
    sig = torch.tensor([s[3] for s in splats])
    rad = torch.ceil(3 * sig)
    pr = raster.Projected(
        mean2d=torch.tensor([[s[0], s[1]] for s in splats]),
        depth=torch.tensor([s[2] for s in splats]),
        conic=torch.stack([1 / sig ** 2, torch.zeros(n), 1 / sig ** 2], 1),
        opacity=torch.tensor([s[4] for s in splats]),
        color=torch.ones(n, 3), invdepth=torch.ones(n), radius=rad,
        rx=rad, ry=rad)
    bins = raster.bin_splats(pr, W, H)
    walk = raster.Walk(raster.pack(pr)[bins.splat], bins, raster.Products())
    return bins, walk.forward()


def _by_hand(splats, W=64, H=32):
    """Pairs, contributions and rows up to each tile's last contributor,
    one pixel at a time in plain Python."""
    import math
    order = sorted(range(len(splats)), key=lambda k: splats[k][2])
    pairs, hits, last = 0, 0, {}
    tiles = {}
    for k in order:
        mx, my, _, s, _ = splats[k]
        r = math.ceil(3 * s)
        for ty in range(max(0, math.floor((my - r) / 32)),
                        min(H // 32, math.floor((my + r + 31) / 32))):
            for tx in range(max(0, math.floor((mx - r) / 32)),
                            min(W // 32, math.floor((mx + r + 31) / 32))):
                tiles.setdefault((tx, ty), []).append(k)
                pairs += 1
    for (tx, ty), ks in tiles.items():
        for py in range(ty * 32, ty * 32 + 32):
            for px in range(tx * 32, tx * 32 + 32):
                T, n = 1.0, 0
                for rank, k in enumerate(ks):
                    mx, my, _, s, op = splats[k]
                    power = -0.5 * ((px - mx) ** 2 + (py - my) ** 2) / s ** 2
                    a = min(0.99, op * math.exp(power))
                    if a < 1 / 255:
                        continue
                    if T * (1 - a) < 1e-4:
                        break
                    T *= 1 - a
                    hits += 1
                    n = rank + 1
                last[(tx, ty)] = max(last.get((tx, ty), 0), n)
    return pairs, hits, sum(min(len(tiles[t]), last[t]) for t in tiles)


SCENES = {
    "one": [(15.0, 15.0, 2.0, 1.0, 0.5)],
    "stack": [(20.0, 12.0, 2.0, 2.5, 0.99), (22.0, 13.0, 3.0, 3.0, 0.99),
              (21.0, 14.0, 4.0, 2.0, 0.99), (40.0, 20.0, 1.5, 4.0, 0.3)],
}


@pytest.mark.parametrize("name", SCENES)
def test_counts_by_hand(name):
    splats = SCENES[name]
    bins, (_, _, nc, hits, nc_max) = _frame(splats)
    pairs, want_hits, bwd_rows = _by_hand(splats)
    assert int(bins.tile_count.sum()) == pairs
    assert hits == want_hits
    assert int(torch.minimum(bins.tile_count, nc_max).sum()) == bwd_rows
    if name == "one":   # the lattice points within sqrt(2 ln 127.5) px
        assert hits == 29
    f = counts.FrameCount(pairs=pairs, bwd_rows=bwd_rows,
                          contributing=hits, tiles=2, pixels=W_H)
    assert counts.composite_fwd(f) == (40 * pairs + 16 + 24 * W_H,
                                       21 * hits)
    assert counts.composite_bwd(f) == (40 * bwd_rows + 64 * pairs + 16
                                       + 28 * W_H, 60 * hits)
    assert counts.ssim_pair(f) == (28 * 3 * W_H, 387 * 3 * W_H)
    assert counts.bound_s(3.35e12, 0) == pytest.approx(1.0)
    assert counts.bound_s(0, 67e12) == pytest.approx(1.0)


W_H = 64 * 32


def test_surfaces_truth_matches_its_splats(root):
    """``capture360_surfaces``: one truth seen from every pose, and each
    object splat the colour of the truth where its centre is seen, except
    at a cell's edge."""
    cfg = spec.cell("m360_densify.train_densify", root).config
    assert cfg["scene"]["kind"] == "capture360_surfaces"
    p, poses, gt = scene.make(cfg, 2 ** 31 + 23, torch.device("cpu"), 3,
                              root)
    n_obj = int(cfg["gaussians"] * cfg["scene"]["object_share"])
    colour = p["f_dc"][:n_obj] * raster.SH_C0 + 0.5
    W, H, f = cfg["width"], cfg["height"], cfg["camera"]["focal_px"]
    for k, (R, T) in enumerate(poses):
        R = torch.tensor(R, dtype=torch.float32)
        c = -(R @ torch.tensor(T, dtype=torch.float32))
        xyz = p["xyz"][:n_obj]
        cam = (xyz - c) @ R
        u = torch.round(f * cam[:, 0] / cam[:, 2] + (W - 1) / 2).long()
        v = torch.round(f * cam[:, 1] / cam[:, 2] + (H - 1) / 2).long()
        # the near side of the object, inside the frame
        seen = ((xyz * (c - xyz)).sum(1) > 0.3 * torch.linalg.norm(
            xyz, dim=1) * torch.linalg.norm(c - xyz, dim=1))
        seen &= (u >= 0) & (u < W) & (v >= 0) & (v < H)
        truth = torch.from_numpy(gt[k])[:, v[seen], u[seen]].T
        same = ((truth - colour[seen]).abs().amax(1) < 1e-6).float()
        assert seen.sum() > 50 and same.mean() > 0.6, (k, same.mean())
