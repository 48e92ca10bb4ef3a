"""Port parity of the blocked (M,16) prefix sum and of the prefix-difference
helpers built on it. The same numpy-seeded arrays go through the JAX
package (its Pallas scan kernel in interpret mode; its ``_prefix_at`` and
``masked_presort_prefix*`` on the CPU route, a blocked ``jnp.cumsum``) and
through the port on the CPU, where the dispatch takes the plain version.
Gates: rtol 1e-6 / atol 1e-5 at blocks of 64 rows, the JAX suite's for this
kernel (tests/test_rasterize.py:354-366); rtol 1e-6 / atol 1e-4 at blocks of
4096 rows. Sums of the same f32 rows in another order differ by rounding
only, and that rounding is of the running sum's size: over 4096 N(0,1) rows
it reaches about 200, whose f32 spacing is 1.5e-5, also where the sum has
come back near 0."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from gsplat_tpu.ops import rasterize as jras
from gsplat_tpu.ops.pallas.scan import blocked_cumsum_16 as jax_scan
from gsplat_tpu_torch.ops import rasterize as tras
from gsplat_tpu_torch.ops.kernels import scan as tscan

from torch_parity import t2n

TOL_64 = dict(rtol=1e-6, atol=1e-5)
TOL = dict(rtol=1e-6, atol=1e-4)        # blocks of 4096 rows


@pytest.mark.parametrize("M,L", [(512, 64), (8192, 4096)])
def test_plain_scan_matches_jax_kernel(rng, M, L):
    x = rng.standard_normal((M, 16)).astype(np.float32)
    intra_j, tot_j = jax_scan(jnp.asarray(x), L=L, interpret=True)
    intra_t, tot_t = tscan.blocked_cumsum_16(torch.tensor(x), L)
    assert tuple(intra_t.shape) == (M, 16)
    assert tuple(tot_t.shape) == (M // L, 16)
    tol = TOL_64 if L == 64 else TOL
    np.testing.assert_allclose(t2n(intra_t), np.asarray(intra_j), **tol)
    np.testing.assert_allclose(t2n(tot_t), np.asarray(tot_j), **tol)
    # against float64: the restart every L rows, and the totals
    ref = np.cumsum(x.astype(np.float64).reshape(M // L, L, 16), axis=1)
    np.testing.assert_allclose(t2n(intra_t), ref.reshape(M, 16), **tol)
    np.testing.assert_array_equal(t2n(tot_t), t2n(intra_t)[L - 1::L])


def test_plain_scan_is_exact_on_integers(rng):
    """Partial sums that are integers below 2^24 are exact in f32 whatever
    the order of the additions: 4096 x 2047 < 2^24."""
    L = 4096
    x = rng.integers(0, 2048, (2 * L, 16)).astype(np.float32)
    intra, tot = tscan.blocked_cumsum_16_plain(torch.tensor(x), L)
    ref = np.cumsum(x.astype(np.int64).reshape(2, L, 16), axis=1)
    np.testing.assert_array_equal(t2n(intra).astype(np.int64),
                                  ref.reshape(2 * L, 16))
    np.testing.assert_array_equal(t2n(tot).astype(np.int64), ref[:, -1])


def test_scan_dispatch_follows_the_tensor():
    x = torch.zeros((128, 16))
    before = tscan.blocked_cumsum_16_cuda.launches
    intra, _ = tscan.blocked_cumsum_16(x, 64)       # CPU: the plain version
    assert tscan.blocked_cumsum_16_cuda.launches == before
    assert float(intra.abs().max()) == 0.0
    with pytest.raises(ValueError, match="needs a CUDA tensor"):
        tscan.blocked_cumsum_16_cuda(x, 64)
    with pytest.raises(ValueError, match="no whole number of blocks"):
        tscan.blocked_cumsum_16(x, 100)
    with pytest.raises(ValueError, match=r"\(M,16\) float32"):
        tscan.blocked_cumsum_16(torch.zeros((128, 8)), 64)
    with pytest.raises(ValueError, match="no blocked prefix sum"):
        tscan.blocked_cumsum_16(torch.zeros((128, 16), device="meta"), 64)


def _presort_case(rng, m_cap, m_out):
    """Gradient rows in an aligned layout of m_out rows, a presort map into
    it, and NaN wherever no live presort row points."""
    inv_src = rng.permutation(m_out)[:m_cap].astype(np.int64)
    d_aligned = rng.standard_normal((m_out, 16)).astype(np.float32)
    return inv_src, d_aligned


def test_prefix_at_matches_jax(rng):
    m_cap = 10_000                       # three blocks of 4096, the last ragged
    d = rng.standard_normal((m_cap, 16)).astype(np.float32)
    bnd = np.concatenate([[0, 1, 4095, 4096, 4097, 8192, m_cap],
                          rng.integers(0, m_cap + 1, 200)]).astype(np.int64)
    ij, bj, Lj = jras._blocked_prefix(jnp.asarray(d), m_cap)
    it, bt, Lt = tras._blocked_prefix(torch.tensor(d), m_cap)
    assert Lj == Lt == 4096 and tuple(it.shape) == (3 * 4096, 16)
    np.testing.assert_allclose(t2n(it), np.asarray(ij), **TOL)
    np.testing.assert_allclose(t2n(bt), np.asarray(bj), **TOL)
    want = np.asarray(jras._prefix_at(ij, bj, Lj,
                                      jnp.asarray(bnd, jnp.int32)))
    got = t2n(tras._prefix_at(it, bt, Lt, torch.tensor(bnd)))
    # a prefix over up to 10,000 N(0,1) rows: |cs| ~ 100, so rtol carries
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-4)
    ref = np.concatenate([np.zeros((1, 16)),
                          np.cumsum(d.astype(np.float64), axis=0)])[bnd]
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-4)
    assert float(np.abs(got[0]).max()) == 0.0          # cs(0) = 0


def test_masked_presort_prefix_matches_jax_with_nan_tail(rng):
    m_cap, m_out, total = 6000, 7000, 5003
    inv_src, d_aligned = _presort_case(rng, m_cap, m_out)
    d_aligned[inv_src[total:]] = np.nan          # rows no tile owns
    ij, bj, _ = jras.masked_presort_prefix(
        jnp.asarray(d_aligned), jnp.asarray(inv_src, jnp.int32),
        jnp.asarray(total, jnp.int32), m_cap)
    it, bt, L = tras.masked_presort_prefix(
        torch.tensor(d_aligned), torch.tensor(inv_src), torch.tensor(total),
        m_cap)
    assert bool(torch.isfinite(it).all()) and bool(torch.isfinite(bt).all())
    np.testing.assert_allclose(t2n(it), np.asarray(ij), **TOL)
    np.testing.assert_allclose(t2n(bt), np.asarray(bj), **TOL)
    # the prefix at the end is the sum of the live rows only
    ref = d_aligned[inv_src[:total]].astype(np.float64).sum(axis=0)
    got = t2n(tras._prefix_at(it, bt, L, torch.tensor([m_cap])))[0]
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-4)


def test_masked_presort_prefix_slabs_matches_jax_with_nan_tails(rng):
    m_slab, n_slabs = 1500, 4
    m_cap, m_out = m_slab * n_slabs, 7000
    totals = np.array([1500, 0, 733, 1499], np.int64)
    inv_src, d_aligned = _presort_case(rng, m_cap, m_out)
    pos = np.arange(m_cap)
    dead = (pos % m_slab) >= totals[pos // m_slab]
    d_aligned[inv_src[dead]] = np.nan
    ij, bj, _ = jras.masked_presort_prefix_slabs(
        jnp.asarray(d_aligned), jnp.asarray(inv_src, jnp.int32),
        jnp.asarray(totals, jnp.int32), m_slab, m_cap)
    it, bt, L = tras.masked_presort_prefix_slabs(
        torch.tensor(d_aligned), torch.tensor(inv_src), torch.tensor(totals),
        m_slab, m_cap)
    assert bool(torch.isfinite(it).all()) and bool(torch.isfinite(bt).all())
    np.testing.assert_allclose(t2n(it), np.asarray(ij), **TOL)
    np.testing.assert_allclose(t2n(bt), np.asarray(bj), **TOL)
    # slab 2's rows: the difference of the prefix at its ends
    lo, hi = 2 * m_slab, 2 * m_slab + int(totals[2])
    got = t2n(tras._prefix_at(it, bt, L, torch.tensor([lo, 3 * m_slab])))
    ref = d_aligned[inv_src[lo:hi]].astype(np.float64).sum(axis=0)
    np.testing.assert_allclose(got[1] - got[0], ref, rtol=1e-4, atol=1e-4)


def test_prefix_between_is_the_prefix_difference(rng):
    """The separated two-level difference the ring backward takes: equal to
    JAX's ``_prefix_at(hi) − _prefix_at(lo)`` within rounding, exactly 0 on
    an empty range, and closer to float64 than the plain difference is on
    short ranges late in the list (whose block chain is large)."""
    m_cap = 40_000
    d = (rng.standard_normal((m_cap, 16)) + 0.5).astype(np.float32)
    lo = np.sort(rng.integers(0, m_cap - 8, 400)).astype(np.int64)
    hi = lo + rng.integers(0, 8, 400)
    lo[:3], hi[:3] = [0, 4090, m_cap - 5], [3, 4100, m_cap]   # ends, a seam
    ij, bj, L = jras._blocked_prefix(jnp.asarray(d), m_cap)
    want = np.asarray(
        jras._prefix_at(ij, bj, L, jnp.asarray(hi, jnp.int32))
        - jras._prefix_at(ij, bj, L, jnp.asarray(lo, jnp.int32)))
    it, bt, _ = tras._blocked_prefix(torch.tensor(d), m_cap)
    got = t2n(tras._prefix_between(it, bt, L, torch.tensor(lo),
                                   torch.tensor(hi)))
    # JAX's difference carries the rounding of the running sum, ~2e4 here
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=5e-3)
    cs = np.concatenate([np.zeros((1, 16)),
                         np.cumsum(d.astype(np.float64), axis=0)])
    ref = cs[hi] - cs[lo]
    # its own rounding is of one block's running sum, ~2e3 here
    assert np.abs(got - ref).max() < 0.5 * np.abs(want - ref).max()
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-3)
    assert float(np.abs(got[hi == lo]).max()) == 0.0
