"""The entry gather of ``build_entries`` (ops/kernels/gather.py):

- on the CPU ``build_entries`` takes the plain chain and gives what the
  inline ``index_select`` chain gave before the kernel pair, bit for bit,
  gradients of every raw field included; without CUDA no kernel is built
  or launched, and the wrappers refuse CPU tensors;
- the binning's slot tables (``bin_gaussians(slot_tables=True)``), which
  the backward walks: every live slot of the layout is listed once, under
  the gaussian it holds, overflow frames included;
- the kernels' own sources (csrc/gather_entries_fwd.cu,
  csrc/gather_entries_bwd.cu), compiled by the host's g++ as plain C++ (a
  shim runs each block's threads in turn), run through the port's wrappers
  and autograd Function on CPU tensors, on the layouts of
  ``bin_gaussians``: chunk padding and a dead tail, a mostly dead buffer,
  an overflow frame and the row-cull layout. The forward equals the plain
  chain bit for bit (NaN and -0.0 rows included). The backward equals the
  chain's two ``index_add_``s on the CPU bit for bit where the binning did
  not overflow (both add a row's slots in slot order, from 0), and within
  float32's sum-order rounding in the overflow frame: each row's gap to
  the float64 sum of its slots is at most (k - 1) u / (1 - (k - 1) u)
  times the sum of their magnitudes for a row of k slots (u = 2^-24); row
  N is exactly 0 where the chain's holds the dead slots' rows. Skips where
  no g++ is installed. The card runs the pair against the chain in
  tests/test_torch_cuda.py.
"""
import contextlib
import ctypes
import shutil
import subprocess
import types

import numpy as np
import pytest
import torch

from gsplat_tpu_torch.models import gaussian_model as gm
from gsplat_tpu_torch.ops import binning as binning_lib
from gsplat_tpu_torch.ops import preprocess as tpre
from gsplat_tpu_torch.ops import rasterize
from gsplat_tpu_torch.ops.kernels import build
from gsplat_tpu_torch.ops.kernels import gather as kgather

from torch_gather_cases import bits, sum_order_gap
from torch_host_kernels import host_source
from torch_preprocess_cases import H, W, scene, with_leaves

# (tile_h, tile_w, chunk, pairs_per_gaussian, row_cull)
LAYOUTS = {
    "padded": (32, 32, 64, 24.0, False),      # chunk padding, a dead tail
    "mostly_dead": (16, 16, 16, 60.0, False),
    "overflow": (16, 16, 16, 0.5, False),     # pairs dropped past m_cap
    "row_cull": (16, 16, 16, 24.0, True),
}


def layout(name, seed=0):
    """(packed, perm, gidx_sorted, binning) of ``scene``'s gaussians under
    the layout ``name``: the real packed rows, some rows replaced by NaN,
    -0.0 and large values so that a copy is seen to keep every bit."""
    th, tw, chunk, ppg, cull = LAYOUTS[name]
    g, cam = scene(deg=1, seed=seed)
    cfg = rasterize.RasterizerConfig(tile_h=th, tile_w=tw, chunk=chunk,
                                     pairs_per_gaussian=ppg, row_cull=cull)
    with torch.no_grad():
        pre, packed = tpre.preprocess_packed(g, cam, W, H)
        b = binning_lib.bin_gaussians(
            pre.mean2d, pre.depth, pre.radius, rx=pre.rx, ry=pre.ry,
            image_width=W, image_height=H, tile_h=th, tile_w=tw,
            m_cap=-(-int(g.capacity * ppg) // chunk) * chunk, align=chunk,
            slot_tables=True, **rasterize.cull_kw(pre, cfg))
    packed = packed.clone()
    n = g.capacity
    packed[7, :10] = float("nan")
    packed[8, :10] = -0.0
    packed[9, :10] = 3.0e38
    gidx = b.gidx_sorted
    live = gidx < n
    assert 0 < int(live.sum()) < gidx.numel()
    if name == "overflow":
        assert int(b.overflow) > 0
    if name == "mostly_dead":
        assert float(live.float().mean()) < 0.25
    return packed, b.perm, gidx, b


# --- the CPU route -----------------------------------------------------------

@pytest.mark.parametrize("row_cull", [False, True], ids=["rect", "row_cull"])
def test_cpu_route_is_the_inline_chain_bit_for_bit(row_cull):
    g, cam = scene(deg=2, active_deg=1)
    cfg = rasterize.RasterizerConfig(tile_h=16, tile_w=16, chunk=16,
                                     pairs_per_gaussian=24.0,
                                     row_cull=row_cull)
    outs = []
    for route in ("inline", "build_entries"):
        gg, leaves = with_leaves(g)
        e = rasterize.build_entries(gg, cam, W, H, cfg)
        entries = e.entries
        if route == "inline":
            # what build_entries computed before the kernel pair
            packed = tpre.pack_entries(e.pre)
            perm_ext = torch.cat([e.binning.perm,
                                  e.binning.perm.new_full((1,), g.capacity)])
            entries = packed.index_select(0, perm_ext).index_select(
                0, e.binning.gidx_sorted)
        ct = torch.tensor(np.random.default_rng(5).standard_normal(
            tuple(entries.shape)), dtype=torch.float32)
        (entries * ct).sum().backward()
        outs.append((entries.detach(), {k: v.grad for k, v in leaves.items()}))
    (e0, g0), (e1, g1) = outs
    assert torch.equal(bits(e1), bits(e0))
    for k in gm.TRAINABLE_FIELDS:
        assert torch.equal(bits(g1[k]), bits(g0[k])), k


def test_no_kernel_is_built_or_launched_without_cuda(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("a kernel build on the CPU")
    monkeypatch.setattr(build, "build", refuse)
    monkeypatch.setattr(build, "load", refuse)
    monkeypatch.setattr(kgather, "_bound", refuse)
    before = (kgather.gather_entries_fwd_cuda.launches,
              kgather.gather_entries_bwd_cuda.launches)
    g, cam = scene(deg=1)
    gg, leaves = with_leaves(g)
    out = rasterize.render(gg, cam, W, H, torch.zeros(3),
                           rasterize.RasterizerConfig(pairs_per_gaussian=24))
    out.image.sum().backward()
    assert float(leaves["xyz"].grad[7:].abs().sum()) > 0
    assert (kgather.gather_entries_fwd_cuda.launches,
            kgather.gather_entries_bwd_cuda.launches) == before
    packed, perm, gidx, b = layout("padded")
    with pytest.raises(ValueError, match="needs CUDA"):
        kgather.gather_entries_fwd_cuda(packed, perm, gidx)
    with pytest.raises(ValueError, match="needs CUDA"):
        kgather.gather_entries_bwd_cuda(torch.zeros((gidx.numel(), 16)), b)


# --- the kernels' source as host C++ -----------------------------------------

SHIM = """
#pragma once
#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(...)
struct dim3 { unsigned x, y, z; };
static dim3 threadIdx, blockIdx;
struct float4 { float x, y, z, w; };
typedef struct CUstream_st* cudaStream_t;
enum cudaError_t { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
inline cudaError_t cudaGetLastError() { return cudaSuccess; }
// a grid: every block's threads in turn, in one host thread (the kernels
// share nothing within a block)
template <class F>
void host_launch(unsigned blocks, unsigned threads, int, F f) {
  for (unsigned b = 0; b < blocks; ++b)
    for (unsigned t = 0; t < threads; ++t) {
      blockIdx = {b, 0, 0};
      threadIdx = {t, 0, 0};
      f();
    }
}
"""


@pytest.fixture(scope="module")
def host_kernels(tmp_path_factory):
    """The port's wrappers, with their two C functions built from the CUDA
    sources by g++ for the host and the device plumbing stood in for."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("no g++ to build the kernels' source for the host")
    tmp = tmp_path_factory.mktemp("hostg")
    (tmp / "cuda_runtime.h").write_text(SHIM)
    fns = {}
    for name in kgather._ARGTYPES:
        src = host_source((build.CSRC / f"{name}.cu").read_text())
        assert src.count("host_launch(") == 1
        (tmp / f"{name}.cpp").write_text(src)
        lib = tmp / f"lib{name}.so"
        subprocess.run([gxx, "-std=c++17", "-O1", "-fPIC", "-shared", "-I",
                        str(tmp), "-o", str(lib), str(tmp / f"{name}.cpp")],
                       check=True, timeout=300)
        fn = getattr(ctypes.CDLL(str(lib)), f"gsplat_{name}")
        fn.argtypes = kgather._ARGTYPES[name]
        fn.restype = ctypes.c_int
        fns[name] = fn
    mp = pytest.MonkeyPatch()
    mp.setattr(kgather, "_bound", lambda name, csrc: fns[name])
    mp.setattr(kgather, "_require_cuda", lambda name, dev: None)
    mp.setattr(torch.cuda, "device", lambda d: contextlib.nullcontext())
    mp.setattr(torch.cuda, "current_stream",
               lambda d=None: types.SimpleNamespace(cuda_stream=None))
    yield kgather
    mp.undo()


@pytest.mark.parametrize("name", list(LAYOUTS))
def test_forward_source_on_the_host_is_the_chain_bit_for_bit(host_kernels,
                                                             name):
    packed, perm, gidx, _ = layout(name)
    before = host_kernels.gather_entries_fwd_cuda.launches
    got = host_kernels.gather_entries_fwd_cuda(packed, perm, gidx)
    assert host_kernels.gather_entries_fwd_cuda.launches == before + 1
    want = kgather.gather_entries_plain(packed, perm, gidx)
    assert torch.equal(bits(got), bits(want))
    dead = gidx >= perm.numel()
    assert torch.equal(bits(got[dead]), torch.zeros((int(dead.sum()), 16),
                                                    dtype=torch.int32))


@pytest.mark.parametrize("name", list(LAYOUTS))
def test_backward_source_on_the_host_is_the_chain(host_kernels, name):
    packed, perm, gidx, b = layout(name)
    n = perm.numel()
    # rows summed in float32 carry rounding: a cotangent with the scale
    # spread of a gradient, and row N of the chain's input non-zero
    rng = np.random.default_rng(11)
    d = torch.tensor(rng.standard_normal((gidx.numel(), 16))
                     * 10.0 ** rng.uniform(-3, 3, (gidx.numel(), 1)),
                     dtype=torch.float32)
    before = host_kernels.gather_entries_bwd_cuda.launches
    got = host_kernels.gather_entries_bwd_cuda(d, b)
    assert host_kernels.gather_entries_bwd_cuda.launches == before + 1
    x = packed.detach().clone().requires_grad_()
    want = torch.autograd.grad(kgather.gather_entries_plain(x, perm, gidx), x,
                               d)[0]
    assert torch.equal(bits(got[n]), bits(torch.zeros(16)))
    assert float(want[n].abs().sum()) > 0         # the dead slots' rows
    if name != "overflow":
        assert torch.equal(bits(got[:n]), bits(want[:n]))
    for r in (got, want):
        over, _ = sum_order_gap(r, d, perm, gidx)
        assert over == 0, f"{over} entries past the sum-order bound"
    # rows that no live slot reaches are exactly 0 in both
    reached = torch.zeros(n, dtype=torch.bool)
    reached[perm[gidx[gidx < n]]] = True
    assert not got[:n][~reached].any() and not want[:n][~reached].any()


@pytest.mark.parametrize("name", list(LAYOUTS))
def test_slot_tables_list_every_live_slot_once(name):
    """``slot_of`` with ``g_offsets`` / ``g_counts``: the slots listed for
    gaussian g hold g, every live slot of the layout is listed once, and
    each gaussian's slots come in the layout's order."""
    _, perm, gidx, b = layout(name)
    n, m_cap = perm.numel(), b.slot_of.numel()
    listed = b.slot_of >= 0
    # presort entry e belongs to the gaussian whose range holds it
    owner = torch.searchsorted(b.g_offsets + b.g_counts,
                               torch.arange(m_cap), right=True)
    assert bool((owner[listed] < n).all())
    assert torch.equal(gidx[b.slot_of[listed]], owner[listed])
    assert torch.equal(torch.sort(b.slot_of[listed]).values,
                       torch.nonzero(gidx < n).flatten())
    if name != "overflow":
        same = owner[1:] == owner[:-1]
        pair = listed[1:] & listed[:-1] & same
        assert bool((b.slot_of[1:][pair] > b.slot_of[:-1][pair]).all())


@pytest.mark.parametrize("name", ["padded", "row_cull"])
def test_autograd_through_the_host_sources_is_the_chain(host_kernels, name):
    """``gather_entries_cuda`` (the autograd Function over the two
    launches) against autograd through the plain chain, on the layout's
    entries weighted by a fixed cotangent."""
    packed, perm, gidx, b = layout(name)
    packed = torch.nan_to_num(packed, nan=0.0, posinf=0.0)
    ct = torch.tensor(np.random.default_rng(3).standard_normal(
        (gidx.numel(), 16)), dtype=torch.float32)
    outs = []
    for run in (lambda x: kgather.gather_entries_plain(x, perm, gidx),
                lambda x: host_kernels.gather_entries_cuda(x, b)):
        x = packed.clone().requires_grad_()
        e = run(x)
        (e * ct).sum().backward()
        outs.append((e.detach(), x.grad))
    (e0, g0), (e1, g1) = outs
    n = perm.numel()
    assert torch.equal(bits(e1), bits(e0))
    assert torch.equal(bits(g1[:n]), bits(g0[:n]))
    assert torch.equal(bits(g1[n]), bits(torch.zeros(16)))


def test_gradient_without_slot_tables_is_refused(host_kernels):
    packed, perm, gidx, b = layout("padded")
    x = packed.clone().requires_grad_()
    with pytest.raises(ValueError, match="slot_tables=True"):
        host_kernels.gather_entries_cuda(x, b._replace(slot_of=None))
    with torch.no_grad():          # no gradient, no tables needed
        e = host_kernels.gather_entries_cuda(x, b._replace(slot_of=None))
    assert torch.equal(bits(e), bits(kgather.gather_entries_plain(
        packed, perm, gidx)))
