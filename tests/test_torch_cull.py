"""The compositor's cull rectangle (``cull_rect_plain``, the plain version
of csrc/composite_alpha.cuh ``cull_rect``) held to the plain compositor on
numpy-seeded random and adversarial entry rows: no pixel that passes the
compositor's alpha test lies outside its entry's rectangle, and the
compositor with the pairs outside the rectangles masked away
(``cull=True``) gives accum, t_final, n_contrib and the gradient bit for
bit, and the slab transmittance so masked (the plain model of
csrc/slab_tmit.cu, which culls too) gives its bits. The rectangle is the port's own (the JAX package has none), so the
oracle here is the port's plain compositor, itself held to JAX in
tests/test_torch_composite.py."""
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from gsplat_tpu_torch.ops.composite_ref import (_TileWalk, composite_tiles_plain,
                                                cull_rect_plain,
                                                cull_rects_plain,
                                                slab_transmittance_plain)

from torch_cull_cases import (CFG, CONSTS, KINDS, N, SHAPE_IDS, SHAPES, conic,
                              frame)

# two torch threads per test worker, as tests/torch_parity.py sets them
torch.set_num_threads(2)


def _live_and_inside(args, geo):
    """Over the whole frame: (pairs passing the alpha test, pairs inside
    the rectangle), each (steps, T, G, P) bool."""
    walk = _TileWalk(*args, **geo)
    live, inside = [], []
    for j in range(walk.n_steps):
        idx, _, data, a1 = walk.step(j)
        assert idx.numel() == walk.T
        live.append(a1 > 0)
        inside.append(walk.inside(idx, data))
    return torch.stack(live), torch.stack(inside)


@pytest.mark.parametrize("shape", SHAPES, ids=SHAPE_IDS)
@pytest.mark.parametrize("kind", KINDS)
def test_no_live_pixel_outside_the_rectangle(kind, shape):
    args, geo = frame(kind, shape)
    live, inside = _live_and_inside(args, geo)
    assert not bool((live & ~inside).any())
    if kind in ("random", "tiny", "anisotropic", "clamped"):
        assert bool(live.any())                  # the case is not vacuous
    if kind in ("random", "tiny", "clamped"):
        # something is culled (the bounding box of a long thin splat on a
        # diagonal may be the whole of a small tile)
        assert float(inside.float().mean()) < 0.9
    if kind == "tiny":
        # a splat under a pixel wide keeps a rectangle of a few pixels
        assert float(inside[:, :, :N].float().sum(-1).max()) <= 36


@pytest.mark.parametrize("shape", SHAPES, ids=SHAPE_IDS)
@pytest.mark.parametrize("kind", KINDS)
def test_masking_outside_the_rectangle_changes_nothing(kind, shape):
    args, geo = frame(kind, shape, seed=1)
    outs = []
    for cull in (False, True):
        x = args[0].clone().requires_grad_()
        out = composite_tiles_plain(x, *args[1:], **geo, cull=cull,
                                    t_eps=CFG.transmittance_eps)
        cot = torch.linspace(0.5, 1.5, out.accum.numel()).reshape(
            out.accum.shape)
        ((out.accum * cot).sum() + 0.3 * out.t_final.sum()).backward()
        outs.append((out, x.grad))
    (plain, g_plain), (culled, g_culled) = outs
    for k in ("accum", "t_final", "n_contrib"):
        assert torch.equal(getattr(plain, k), getattr(culled, k)), k
    torch.testing.assert_close(g_culled, g_plain, rtol=0, atol=0,
                               equal_nan=True)
    if kind in ("random", "tiny", "anisotropic", "clamped"):
        assert int(plain.n_contrib.max()) > 0


@pytest.mark.parametrize("shape", SHAPES, ids=SHAPE_IDS)
@pytest.mark.parametrize("kind", KINDS)
def test_masking_outside_the_rectangle_keeps_the_slab_transmittance(kind,
                                                                    shape):
    args, geo = frame(kind, shape, seed=1)
    plain = slab_transmittance_plain(*args, **geo)
    culled = slab_transmittance_plain(*args, **geo, cull=True)
    torch.testing.assert_close(culled, plain, rtol=0, atol=0, equal_nan=True)
    if kind in ("random", "tiny", "anisotropic", "clamped"):
        assert float(plain.min()) < 1.0          # the case is not vacuous


def test_rectangle_cases_by_hand():
    """The documented cases of one row on a 32x32 tile at the origin."""
    lo = CFG.alpha_min

    def rect(mx, my, a, b, c, op):
        e = torch.zeros((1, 16))
        e[0, :6] = torch.tensor([mx, my, a, b, c, op])
        return tuple(int(v) for v in cull_rect_plain(e, lo, tile_h=32,
                                                     tile_w=32))

    full, r = (0, 31, 0, 31), rect(16.0, 16.0, 1.0, 0.0, 1.0, 0.5)
    # radius sqrt(2 log(0.5 * 255)) = 3.11 px, plus the half pixel
    assert r == (13, 19, 13, 19)
    x0, x1, y0, y1 = rect(16.0, 16.0, 1.0, 0.0, 1.0, 0.5 * lo)
    assert x0 > x1 and y0 > y1                    # below the floor: dropped
    assert rect(16.0, 16.0, 1.0, 0.0, 1.0, lo) == (16, 16, 16, 16)
    assert rect(16.0, 16.0, 1.0, 1.0, 1.0, 0.5) == full        # det = 0
    assert rect(16.0, 16.0, 1.0, 2.0, 1.0, 0.5) == full        # det < 0
    assert rect(16.0, 16.0, -1.0, 0.0, 1.0, 0.5) == full       # a < 0
    assert rect(float("nan"), 16.0, 1.0, 0.0, 1.0, 0.5) == full
    assert rect(16.0, 16.0, 1.0, 0.0, 1.0, float("inf")) == full
    assert rect(16.0, 16.0, 1.0, 0.0, 1.0, float("nan")) == full
    x0, x1, _, _ = rect(200.0, 16.0, 1.0, 0.0, 1.0, 0.5)       # off the tile
    assert x0 > x1
    assert rect(-3.0, 16.0, 1.0, 0.0, 1.0, 0.5)[:2] == (0, 0)
    # a tile origin moves the rectangle
    e = torch.zeros((1, 16))
    e[0, :6] = torch.tensor([48.0, 80.0, 1.0, 0.0, 1.0, 0.5])
    got = cull_rect_plain(e, lo, ox=32.0, oy=64.0, tile_h=32, tile_w=32)
    assert tuple(int(v) for v in got) == (13, 19, 13, 19)


def test_no_floor_means_no_culling():
    """alpha_min <= 0 keeps every pair eval_alpha keeps, a negative opacity
    under a negative floor included: the whole tile, whatever the row."""
    e = torch.zeros((3, 16))
    e[:, :6] = torch.tensor([[16.0, 16.0, 1.0, 0.0, 1.0, 0.5],
                             [16.0, 16.0, 1.0, 0.0, 1.0, -0.5],
                             [16.0, 16.0, 1.0, 0.0, 1.0, 0.0]])
    for floor in (0.0, -1.0):
        got = cull_rect_plain(e, floor, tile_h=32, tile_w=32)
        assert [v.tolist() for v in got] == [[0] * 3, [31] * 3, [0] * 3,
                                             [31] * 3]


@pytest.mark.parametrize("shape", SHAPES, ids=SHAPE_IDS)
@pytest.mark.parametrize("kind", ["random", "nonfinite", "opacity_edge"])
def test_rectangles_of_an_entry_list(kind, shape):
    """``cull_rects_plain``: each row's rectangle on the tile that owns it
    (the walk's ``inside``), its warp mask (a warp is 128 consecutive pixels;
    bit w set where a pixel of warp w lies in the rectangle's rows and the
    rectangle is not empty), -2 on rows no tile owns; on the lower tile row
    alone with its tile_id_base the same rows."""
    args, geo = frame(kind, shape)
    kw = {k: v for k, v in geo.items() if k not in ("chunk", "alpha_max")}
    rects = cull_rects_plain(*args, **kw).long()
    walk = _TileWalk(*args, **geo)
    idx, rank, data, _ = walk.step(0)
    per = data.shape[1]
    r = rects.view(walk.T, -1, 5)[:, :per]
    owned = rank[None, :] < walk.count[:, None]
    assert bool((r[~owned] == -2).all()) and bool((r[owned] >= -1).all())
    x0, x1, y0, y1, mask = (r[..., k, None] for k in range(5))
    inside = ((walk.pxl >= x0) & (walk.pxl <= x1) & (walk.pyl >= y0)
              & (walk.pyl <= y1))
    assert torch.equal(inside[owned], walk.inside(idx, data)[owned])
    P = walk.P
    rows_in = ((walk.pyl >= y0) & (walk.pyl <= y1) & (x0 <= x1))  # (T,G,P)
    for w in range(8):
        want = rows_in[..., w * 128:min(w * 128 + 128, P)].any(-1) \
            if w * 128 < P else torch.zeros_like(owned)
        assert torch.equal(((mask[..., 0] >> w) & 1).bool()[owned],
                           want[owned]), w
    base = geo["n_tiles_x"]
    low = cull_rects_plain(args[0], args[1][base:], args[2][base:],
                           **dict(kw, n_tiles_y=1, tile_id_base=base))
    first = int(args[1][base])
    assert torch.equal(low[first:].long(), rects[first:])
    assert bool((low[:first] == -2).all())


_pos = dict(allow_nan=False, allow_infinity=False)


@settings(max_examples=300, deadline=None, derandomize=True, database=None)
@given(mx=st.floats(-40, 72, **_pos), my=st.floats(-40, 72, **_pos),
       s1=st.floats(0.03125, 3000, **_pos), s2=st.floats(0.03125, 3000, **_pos),
       theta=st.floats(0, 3.1416, **_pos), op=st.floats(0, 1.5, **_pos))
def test_rectangle_is_conservative_property(mx, my, s1, s2, theta, op):
    """Any gaussian on a 32x32 tile: every pixel the alpha test keeps lies
    inside the rectangle."""
    a, b, c = conic(s1, s2, theta)
    e = torch.zeros((64, 16))
    e[0, :6] = torch.tensor([mx, my, a, b, c, op], dtype=torch.float64).float()
    walk = _TileWalk(e, torch.zeros(1, dtype=torch.int32),
                     torch.ones(1, dtype=torch.int32), n_tiles_x=1,
                     n_tiles_y=1, tile_h=32, tile_w=32, chunk=64, **CONSTS)
    idx, _, data, a1 = walk.step(0)
    assert not bool(((a1 > 0) & ~walk.inside(idx, data)).any())
