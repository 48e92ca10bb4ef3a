"""The port's measurement tools (``gsplat_tpu_torch/tools``:
profile_stages, sweep_tiles, bench_scatter, bench_binning, bisect_binning)
against the repo's ``tools/`` counterparts and the JAX package on the CPU
at a small size, on the same numpy-seeded inputs: the stages in the JAX
tool's order and under its names, the binning counts each tool prints, the
reductions, sorts and keys of the scatter benchmark, the binning
micro-benchmark's helpers, and the port's binning taken apart.

Tolerances: counts, keys, orders and tables equal. The reductions against
np.add.at in float64: rtol 1e-5 over float32's accumulation bound (the
segment's length x eps x the sum of its |terms|), and for the cumsum and
difference also 2 x eps x the two prefix sums' magnitude, which the
difference cancels.
"""
import dataclasses
import functools
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gsplat_tpu.core.camera import CameraView as JaxCameraView
from gsplat_tpu.models import gaussian_model as jgm
from gsplat_tpu.ops import binning as jbin
from gsplat_tpu.ops import preprocess as jpre
from gsplat_tpu_torch.tools import (bench, bench_binning, bench_scatter,
                                    bisect_binning, profile_stages,
                                    sweep_tiles)

import torch_parity  # noqa: F401  (keeps torch at 2 threads)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")
N, W, H = 300, 96, 64
EPS = np.finfo(np.float32).eps


def round_up(x, m):
    return -(-x // m) * m


@functools.lru_cache(maxsize=None)
def port_scene():
    return bench.bench_scene(N, W, H, "cpu")


@functools.lru_cache(maxsize=None)
def jax_pre():
    """The port's bench scene carried into the JAX package (the two knn
    round apart), preprocessed there as the JAX tools do."""
    g, _, _ = port_scene()
    jg = dataclasses.replace(
        jgm.empty(N, 3), **{k: jnp.asarray(getattr(g, k).numpy()) for k in (
            "xyz", "f_dc", "f_rest", "scaling", "rotation", "opacity",
            "active")}, active_sh_degree=jnp.asarray(3, jnp.int32))
    cam = JaxCameraView.create(R=np.eye(3), T=np.zeros(3), fovx=1.2,
                               fovy=0.9)
    return jpre.preprocess(
        jg.xyz, jg.get_scaling(), jg.get_rotation(), jg.get_opacity(),
        jg.get_features(), jg.active_sh_degree, cam, W, H,
        active_mask=jg.active)


def jax_bin(m_cap, tile_h=32, tile_w=32, chunk=64, cull=False):
    pre = jax_pre()
    kw = dict(conic=pre.conic, t_cut=pre.t_cut) if cull else {}
    return jbin.bin_gaussians(
        pre.mean2d, pre.depth, pre.radius, rx=pre.rx, ry=pre.ry,
        image_width=W, image_height=H, tile_h=tile_h, tile_w=tile_w,
        m_cap=m_cap, align=chunk, sort_gaussians=True, **kw)


def jax_stage_names():
    """The stage labels of tools/profile_stages.py, in its order."""
    with open(os.path.join(REPO, "tools", "profile_stages.py")) as f:
        src = f.read()
    names = [n.replace("{rcfg.compositor}", "{compositor}")
             for n in re.findall(r'timeit\(f?"([^"]+)"', src)]
    return names + re.findall(r'print\(f"(pixels/s):', src)


@functools.lru_cache(maxsize=None)
def profile_run():
    import contextlib
    import io
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = profile_stages.run(CPU, n=N, W=W, H=H, iters=1)
    return out, buf.getvalue()


def test_profile_stages_in_jax_order():
    assert list(profile_stages.STAGES) == jax_stage_names()
    out, text = profile_run()
    printed = [ln.split("  ")[0].strip() for ln in text.splitlines()[1:]
               if not ln.startswith("  ")]
    names = [s.format(compositor="stream") for s in profile_stages.STAGES]
    assert [p.split(":")[0] for p in printed] == names
    assert all(k in out for k in names)


def test_profile_binning_line_matches_jax():
    out, text = profile_run()
    probe = jax_bin(round_up(int(N * 10.0), 64))
    m_cap = round_up(int(int(probe.num_pairs) * 1.3), 64)
    b = jax_bin(m_cap)
    want = (f"  num_pairs={int(b.num_pairs)} overflow={int(b.overflow)} "
            f"m_cap={m_cap} M_out={b.gidx_sorted.shape[0]}")
    assert want in text.splitlines()
    assert (out["num_pairs"], out["m_cap"], out["m_out"]) == (
        int(b.num_pairs), m_cap, b.gidx_sorted.shape[0])


@pytest.mark.parametrize("tile", [(16, 16), (32, 32)], ids=["16x16", "32x32"])
def test_sweep_counts_match_jax(tile, capsys):
    th, tw = tile
    chunk = 64
    got = sweep_tiles.run(th, tw, chunk, "chunk", CPU, size=(W, H, N),
                          ppg0=10.0)
    text = capsys.readouterr().out
    # what tools/sweep_tiles.py computes from its first step's binning
    b = jax_bin(round_up(int(N * 10.0), chunk), th, tw, chunk)
    pairs, padded = int(b.num_pairs), int(b.num_padded)
    assert int(b.overflow) == 0
    ppg = max(pairs * 1.3 / N, 2.0)
    pad_cap = max(chunk, int((padded - pairs) * 1.5))
    m_cap = round_up(int(N * ppg), chunk)
    m_out = m_cap + round_up(pad_cap, chunk)
    tiles = round_up(W, tw) // tw * (round_up(H, th) // th)
    line = f"pairs={pairs} m_cap={m_cap} m_out={m_out} tiles={tiles}"
    assert line in text.splitlines()
    assert (got["pairs"], got["m_cap"], got["m_out"], got["tiles"]) == (
        pairs, m_cap, m_out, tiles)
    result = [ln for ln in text.splitlines() if ln.startswith("RESULT ")]
    assert len(result) == 1 and result[0].startswith(
        f"RESULT tile={th}x{tw} chunk={chunk} comp=chunk step=")
    assert "px/s=" in result[0] and "vs_baseline=" in result[0]


def test_sweep_fifth_argument_is_a_usage_error(capsys):
    with pytest.raises(SystemExit) as e:
        sweep_tiles.main(["32", "32", "64", "stream", "64", "--device",
                          "cpu"])
    assert e.value.code == 2
    assert "strip_chunks" in capsys.readouterr().err


SCATTER = (2000, 100, 64)        # M rows, N segments, T tiles


def jax_scatter_inputs(M, N, T):
    """tools/bench_scatter.py's draws, in its order."""
    rng = np.random.default_rng(0)
    gidx = np.sort(rng.integers(0, N, M)).astype(np.int32)
    d = rng.standard_normal((M, 16)).astype(np.float32)
    tile = rng.integers(0, T, M).astype(np.int32)
    depth = rng.uniform(0.2, 50.0, M).astype(np.float32)
    packed = rng.standard_normal((N + 1, 16)).astype(np.float32)
    return dict(gidx=gidx, d=d, tile=tile, depth=depth, packed=packed)


@functools.lru_cache(maxsize=None)
def scatter_run():
    return bench_scatter.run(CPU, size=SCATTER, iters=1)


def test_scatter_reductions_match_add_at():
    M, N, T = SCATTER
    x = jax_scatter_inputs(M, N, T)
    for k, v in bench_scatter.inputs(M, N, T, "cpu").items():
        np.testing.assert_array_equal(v.numpy(), x[k], err_msg=k)
    r = scatter_run()
    assert r["segment_reduce"] is None
    d64 = x["d"].astype(np.float64)
    want = np.zeros((N + 1, 16))
    np.add.at(want, x["gidx"], d64)
    abs_sum = np.zeros((N + 1, 16))
    np.add.at(abs_sum, x["gidx"], np.abs(d64))
    length = np.bincount(x["gidx"], minlength=N + 1)[:, None]
    acc = length * EPS * abs_sum
    cs = np.concatenate([np.zeros((1, 16)), np.cumsum(d64, axis=0)])
    offs = np.searchsorted(x["gidx"], np.arange(N + 2))
    prefix = 2 * EPS * (np.abs(cs[offs[1:]]) + np.abs(cs[offs[:-1]]))
    assert set(r["sums"]) == {"a) index_add_", "b) index_add_ sorted",
                              "c) cumsum+diff", "d) segment_reduce"}
    for k, v in r["sums"].items():
        bound = 1e-5 * np.abs(want) + acc + (prefix if k.startswith("c)")
                                             else 0)
        err = np.abs(v.numpy() - want)
        assert v.shape == (N + 1, 16) and (err <= bound).all(), k


def test_scatter_keys_and_orders_match_jax():
    M, N, T = SCATTER
    x = jax_scatter_inputs(M, N, T)
    tile, depth = jnp.asarray(x["tile"]), jnp.asarray(x["depth"])
    payload = jnp.arange(M, dtype=jnp.int32)
    dq = (jnp.float32(depth).view(jnp.int32) >> 12) & 0xFFFFF
    key = (tile << 20) | dq
    tt, td = torch.tensor(x["tile"]), torch.tensor(x["depth"])
    got = bench_scatter.packed_key(tt, td)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(key))
    s1 = jax.lax.sort((key, payload), num_keys=1)[1]
    s2 = jax.lax.sort((tile, depth, payload), num_keys=2)[2]
    s0 = jax.lax.sort((tile, payload), num_keys=1)[1]
    r = scatter_run()
    np.testing.assert_array_equal(r["order1"].numpy(), np.asarray(s1))
    np.testing.assert_array_equal(r["order2"].numpy(), np.asarray(s2))
    np.testing.assert_array_equal(bench_scatter.sort_payload(tt).numpy(),
                                  np.asarray(s0))
    # where a key is its own, s1 orders as s2 (chip_smoke's gate)
    u = r["unique"].numpy()
    assert 0.5 < u.mean() < 1.0
    np.testing.assert_array_equal(np.asarray(s1)[u], np.asarray(s2)[u])


@pytest.mark.parametrize("m_cap", [12_000, 8_000],
                         ids=["padded", "truncated"])
def test_binning_helpers_match_jax(m_cap):
    """tools/bench_binning.py's stages at N 500 over 64 tiles: the counts
    sum to about 9,750, so one capacity pads the expansion and the other
    cuts it."""
    n, n_tiles, align = 500, 64, bench_binning.ALIGN
    m_out = m_cap + align * n_tiles
    x = bench_binning.inputs(n, m_cap, n_tiles, "cpu")
    rng = np.random.default_rng(0)
    counts = jnp.asarray(rng.integers(0, 40, n).astype(np.int32))
    depth = jnp.asarray(rng.uniform(0.2, 50.0, n).astype(np.float32))
    tile_sorted = jnp.asarray(np.sort(
        rng.integers(0, n_tiles, m_cap)).astype(np.int32))
    tile_count = jnp.asarray(rng.integers(0, 4000, n_tiles).astype(np.int32))
    for k, v in dict(counts=counts, depth=depth, tile_sorted=tile_sorted,
                     tile_count=tile_count).items():
        np.testing.assert_array_equal(x[k].numpy(), np.asarray(v), err_msg=k)

    # the JAX tool's functions
    gidx_j = jnp.repeat(jnp.arange(n, dtype=jnp.int32), counts,
                        total_repeat_length=m_cap)
    offsets = jnp.cumsum(counts) - counts
    k_j = jnp.arange(m_cap, dtype=jnp.int32) - offsets[gidx_j]
    ts_j = jnp.searchsorted(tile_sorted, jnp.arange(n_tiles, dtype=jnp.int32),
                            side="left")
    padded = -(-tile_count // align) * align
    ends = jnp.cumsum(padded).astype(jnp.int32)
    nn = jnp.arange(m_out, dtype=jnp.int32)
    t_of = jnp.searchsorted(ends, nn, side="right").astype(jnp.int32)
    t_c = jnp.minimum(t_of, n_tiles - 1)
    src = jnp.clip(nn - (ends - padded)[t_c], 0, m_cap - 1)
    align_j = jnp.where(t_of < n_tiles, gidx_j[src], n)

    gidx = bench_binning.repeat(x["counts"], m_cap)
    np.testing.assert_array_equal(gidx.numpy(), np.asarray(gidx_j))
    k, dg = bench_binning.offset_gathers(gidx, x["counts"], x["depth"])
    np.testing.assert_array_equal(k.numpy(), np.asarray(k_j))
    np.testing.assert_array_equal(dg.numpy(), np.asarray(depth[gidx_j]))
    np.testing.assert_array_equal(
        bench_binning.tile_starts(x["tile_sorted"], n_tiles).numpy(),
        np.asarray(ts_j))
    np.testing.assert_array_equal(
        bench_binning.slot_tiles(x["tile_count"], m_out)[0].numpy(),
        np.asarray(t_of))
    np.testing.assert_array_equal(
        bench_binning.align_full(x["tile_count"], gidx, m_out, n).numpy(),
        np.asarray(align_j))


def test_bisect_matches_bin_gaussians_and_jax(capsys):
    r = bisect_binning.run(CPU, size=(W, H, N), iters=1)
    text = capsys.readouterr().out
    probe_m = round_up(int(N * 10.0), 64)
    pairs = int(jax_bin(probe_m).num_pairs)
    m_cap = round_up(int(pairs * 1.3), 64)
    pairs_c = int(jax_bin(probe_m, cull=True).num_pairs)
    m_cap_c = round_up(int(pairs_c * 1.3), 64)
    assert (r["pairs"], r["m_cap"], r["pairs_culled"],
            r["m_cap_culled"]) == (pairs, m_cap, pairs_c, m_cap_c)
    assert f"pairs={pairs} m_cap={m_cap}" in text.splitlines()
    assert pairs_c < pairs
    # the composed stages (equal to the port's bin_gaussians, or the tool
    # raises) are JAX's entry list
    np.testing.assert_array_equal(r["gidx_sorted"].numpy(),
                                  np.asarray(jax_bin(m_cap).gidx_sorted))
    assert len(r["times"]) == 8
