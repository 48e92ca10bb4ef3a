"""The compositor's gradient. Autograd through the port's plain compositor
(composite_tiles_plain, the oracle of the CUDA backward kernel) is held to
the JAX stream kernel's hand-written backward (composite_tiles_stream in
interpret mode) on the same entries and cotangents, d_entries columns 0-9
within rtol 5e-3 / atol 1e-6 (the JAX suite's gradient gate).

Both pass the gradient straight through the alpha_max = 0.99 clamp. JAX's
XLA oracle (composite_tiles_xla) differentiates the clamp instead, so it
agrees below the clamp and not at opacity 0.999.

The CUDA kernel's replay order is also checked here, written out in torch:
back to front from t_final meets the gate on a deep tile, where the TPU
kernel's front-to-back suffix-by-subtraction does not."""
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from gsplat_tpu.ops import composite_ref as jref
from gsplat_tpu.ops.pallas.composite_stream import composite_tiles_stream
from gsplat_tpu_torch.config import RasterizerConfig
from gsplat_tpu_torch.ops.composite_ref import composite_tiles_plain

from torch_parity import t2n

GRAD_TOL = dict(rtol=5e-3, atol=1e-6)
_C = RasterizerConfig()
CONSTS = dict(alpha_min=_C.alpha_min, alpha_max=_C.alpha_max,
              t_eps=_C.transmittance_eps)
# two 8x8 tiles side by side, 40 entries each, chunk 8
GEO = dict(n_tiles_x=2, n_tiles_y=1, tile_h=8, tile_w=8, chunk=8)
STRIP_CHUNKS = 4


def _entries(rng, n_per_tile, opacity, tile_w, tile_h, n_tiles, rows):
    """Depth-ordered entry rows for consecutive tiles: splats of 1-3 px
    (1-4 px for big tiles) around each tile, the given opacity."""
    e = np.zeros((rows, 16), np.float32)
    big = tile_w >= 32
    for t in range(n_tiles):
        sl = slice(t * n_per_tile, (t + 1) * n_per_tile)
        e[sl, 0] = t * tile_w + rng.uniform(-2, tile_w + 2, n_per_tile)
        e[sl, 1] = rng.uniform(-2, tile_h + 2, n_per_tile)
        sig = rng.uniform(1.0, 4.0 if big else 3.0, n_per_tile)
        e[sl, 2] = 1 / sig ** 2
        e[sl, 3] = rng.uniform(-0.2, 0.2, n_per_tile) / sig ** 2
        e[sl, 4] = 1 / sig ** 2
        e[sl, 5] = opacity
        e[sl, 6:9] = rng.uniform(0, 1, (n_per_tile, 3))
        e[sl, 9] = rng.uniform(0.1, 0.3, n_per_tile)
    return e


def _cotangents(rng, T, P):
    return (rng.standard_normal((T, 4, P)).astype(np.float32),
            rng.standard_normal((T, P)).astype(np.float32))


@functools.partial(jax.jit, static_argnames=("stream",))
def _jax_d_entries(entries, ts, tc, ga, gt, *, stream):
    def loss(e):
        if stream:
            out = composite_tiles_stream(e, ts, tc, strip_chunks=STRIP_CHUNKS,
                                         interpret=True, **GEO, **CONSTS)
        else:
            out = jref.composite_tiles_xla(e, ts, tc, **GEO, **CONSTS)
        return (out.accum * ga).sum() + (out.t_final * gt).sum()
    return jax.grad(loss)(entries)


def _plain_d_entries(entries, ts, tc, ga, gt, geo):
    e = torch.tensor(entries, requires_grad=True)
    out = composite_tiles_plain(e, torch.tensor(ts), torch.tensor(tc), **geo,
                                **CONSTS)
    ((out.accum * torch.tensor(ga)).sum()
     + (out.t_final * torch.tensor(gt)).sum()).backward()
    return t2n(e.grad), out


@pytest.mark.parametrize("opacity", [0.9, 0.999])
def test_plain_backward_matches_stream_kernel(rng, opacity):
    n = 40
    rows = STRIP_CHUNKS * GEO["chunk"] * 3        # whole strips: 96 rows
    entries = _entries(rng, n, opacity, 8, 8, 2, rows)
    ts = np.array([0, n], np.int32)
    tc = np.array([n, n], np.int32)
    ga, gt = _cotangents(rng, 2, 64)
    got, out = _plain_d_entries(entries, ts, tc, ga, gt, GEO)
    assert (t2n(out.t_final) < 0.05).any()          # opaque pixels
    want = np.asarray(_jax_d_entries(*map(jnp.asarray, (entries, ts, tc, ga,
                                                        gt)), stream=True))
    np.testing.assert_allclose(got[:, :10], want[:, :10], **GRAD_TOL)
    assert np.abs(got[:, 10:]).max() == 0 and np.abs(got[2 * n:]).max() == 0

    xla = np.asarray(_jax_d_entries(*map(jnp.asarray, (entries, ts, tc, ga,
                                                       gt)), stream=False))
    if opacity < _C.alpha_max:        # below the clamp the oracles agree
        np.testing.assert_allclose(got[:, :10], xla[:, :10], **GRAD_TOL)
    else:                             # the XLA oracle zeroes the clamp
        assert np.abs(got[:, 5] - xla[:, 5]).max() > 1e-2


def _replay(e, nc, t_final, accum, ga, gt, tile_w, alpha_min, alpha_max,
            back_to_front):
    """d_entries columns 0-9 of one tile at origin (0, 0), replayed entry by
    entry over all pixels: the CUDA kernel's back-to-front order, or the
    TPU kernel's front to back with S = g_accum·accum − cum + g_t·T."""
    P = nc.shape[0]
    p = torch.arange(P)
    px, py = (p % tile_w).float(), (p // tile_w).float()
    gc_all = e[:, 6:10] @ ga                                  # (L, P)
    d = torch.zeros((e.shape[0], 10))
    L = int(nc.max())
    if back_to_front:
        T, S, order = t_final.clone(), gt * t_final, range(L - 1, -1, -1)
    else:
        T, S, order = torch.ones(P), None, range(L)
        p0 = (ga * accum).sum(0)
        cum = torch.zeros(P)
    for j in order:
        mx, my, ca, cb, cc, op = e[j, :6]
        dx, dy = px - mx, py - my
        power = -0.5 * (ca * dx * dx + cc * dy * dy) - cb * dx * dy
        ex = torch.exp(torch.clamp(power, max=0.0))
        a_raw = op * ex
        alpha = torch.clamp(a_raw, max=alpha_max)
        keep = (j < nc) & (alpha >= alpha_min) & (power <= 0)
        one_m = torch.where(keep, 1 - alpha, 1.0)
        gc = gc_all[j]
        if back_to_front:
            tj = T / one_m
            w = torch.where(keep, alpha * tj, 0.0)
            dl = gc * tj - S / one_m
            S = S + w * gc
            T = tj
        else:
            w = torch.where(keep, alpha * T, 0.0)
            cum = cum + w * gc
            dl = gc * T - ((p0 - cum) + gt * t_final) / one_m
            T = T * one_m
        dl = torch.where(keep, dl, 0.0)
        dp = dl * a_raw
        d[j, :6] = torch.stack([
            (dp * (ca * dx + cb * dy)).sum(), (dp * (cc * dy + cb * dx)).sum(),
            (dp * (-0.5 * dx * dx)).sum(), (dp * (-dx * dy)).sum(),
            (dp * (-0.5 * dy * dy)).sum(), (dl * ex).sum()])
        d[j, 6:] = (w * ga).sum(-1)
    return d


@pytest.mark.parametrize("opacity", [0.5, 0.999])
def test_back_to_front_replay_meets_the_gate_on_a_deep_tile(rng, opacity):
    """One 32x32 tile with 768 entries, hundreds of contributors per pixel
    (as at 1080p), O(1) cotangents: the replay order of
    csrc/composite_bwd.cu against autograd through the plain compositor.
    Front to back, S cancels where T is small and misses the gate by more
    than 2x; back to front stays within a tenth of it."""
    n = 768
    geo = dict(n_tiles_x=1, n_tiles_y=1, tile_h=32, tile_w=32, chunk=64)
    e = _entries(rng, n, opacity, 32, 32, 1, n)
    ts, tc = np.array([0], np.int32), np.array([n], np.int32)
    ga, gt = _cotangents(rng, 1, 1024)
    want, out = _plain_d_entries(e, ts, tc, ga, gt, geo)
    want = want[:, :10]
    nc = out.n_contrib[0].long()
    assert float(nc.float().mean()) > 150              # deep pixels
    ratios = []
    for back_to_front in (True, False):
        got = _replay(torch.tensor(e), nc, out.t_final[0].detach(),
                      out.accum[0].detach(), torch.tensor(ga[0]),
                      torch.tensor(gt[0]), 32,
                      CONSTS["alpha_min"], CONSTS["alpha_max"],
                      back_to_front).numpy()
        tol = GRAD_TOL["atol"] + GRAD_TOL["rtol"] * np.abs(want)
        ratios.append(float((np.abs(got - want) / tol).max()))
    assert ratios[0] < 0.1 and ratios[1] > 2.0, ratios
