"""``preprocess_packed``, the render path's preprocess (ops/preprocess.py):

- on the CPU, and with precomputed covariances or colours, it is the plain
  path and returns what ``preprocess`` + the tap + ``pack_entries`` return,
  bit for bit, gradients of every raw field and of the tap included;
- without CUDA it builds and launches no kernel (the build is made to
  raise), and the kernel wrappers refuse CPU tensors;
- the fused kernels' own arithmetic (csrc/preprocess_fwd.cu,
  csrc/preprocess_bwd.cu): their sources compiled by the host's g++ as
  plain C++ (a shim defines CUDA's round-to-nearest intrinsics as single
  float operations, and a launch runs each block as one host thread a CUDA
  thread, with a barrier for ``__syncthreads``), run through the port's wrapper on CPU tensors and held to the
  plain path: the packed rows and depth, t_cut within rtol 1e-5 / atol
  1e-6, radius / rx / ry equal, the gradients within the card tests'
  gradient gate (rtol 5e-3 / atol 1e-6), over SH degrees 0-3 with the
  active degree below the maximum, antialiasing on and off, a scaling
  modifier, dead rows, and gaussians at the camera centre, before the near
  plane, behind the camera, past the tanfov clamp, with a 2-D covariance
  that overflows (its determinant NaN, so culled) and with colours clamped
  at 0. Skips where no g++ is installed. The card runs the same cases
  through nvcc's build (tests/test_torch_cuda.py).
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
from gsplat_tpu_torch.ops import preprocess as tpre
from gsplat_tpu_torch.ops import rasterize
from gsplat_tpu_torch.ops.kernels import build
from gsplat_tpu_torch.ops.kernels import preprocess as kpre

from torch_host_kernels import host_source
from torch_preprocess_cases import CASES, CASE_IDS, H, W, same, scene, \
    with_leaves

GRAD_TOL = dict(rtol=5e-3, atol=1e-6)
FIELD_TOL = dict(rtol=1e-5, atol=1e-6)


def old_build_entries_preprocess(g, cam, tap, **kw):
    """What ``build_entries`` computed before ``preprocess_packed``:
    ``preprocess`` of the activated fields, the tap, ``pack_entries``."""
    pre = tpre.preprocess(
        g.xyz, g.get_scaling(), g.get_rotation(), g.get_opacity(),
        g.get_features(), g.active_sh_degree, cam, W, H,
        active_mask=g.active, **kw)
    if tap is not None:
        scale = torch.tensor([[0.5 * W, 0.5 * H]], dtype=torch.float32)
        pre = pre._replace(mean2d=pre.mean2d + tap * scale)
    return pre, tpre.pack_entries(pre)


VARIANTS = ["plain", "antialiasing", "modifier", "cov3d_precomp",
            "colors_precomp", "no_tap"]


@pytest.mark.parametrize("variant", VARIANTS)
def test_cpu_route_is_the_plain_path_bit_for_bit(variant):
    g, cam = scene(deg=2, active_deg=1)
    rng = np.random.default_rng(1)
    kw = dict(antialiasing=variant == "antialiasing",
              scaling_modifier=0.6 if variant == "modifier" else 1.0,
              dilation=0.3, alpha_min=1.0 / 255.0)
    extra = {}
    if variant == "cov3d_precomp":
        extra["cov3d_precomp"] = g.get_covariance().detach() \
            .requires_grad_()
    if variant == "colors_precomp":
        extra["colors_precomp"] = torch.tensor(
            rng.uniform(0, 1, (g.capacity, 3)), dtype=torch.float32,
            requires_grad=True)
    ct = torch.tensor(rng.standard_normal((g.capacity + 1, 16)),
                      dtype=torch.float32)
    outs = []
    for route in ("old", "new"):
        gg, leaves = with_leaves(g)
        tap = None if variant == "no_tap" else \
            torch.zeros((g.capacity, 2), requires_grad=True)
        ex = {k: v.detach().clone().requires_grad_()
              for k, v in extra.items()}
        if route == "old":
            pre, packed = old_build_entries_preprocess(gg, cam, tap, **kw,
                                                       **ex)
        else:
            pre, packed = tpre.preprocess_packed(gg, cam, W, H,
                                                 mean2d_tap=tap, **kw, **ex)
        (packed * ct).sum().backward()
        outs.append((pre, packed, {k: v.grad for k, v in leaves.items()},
                     None if tap is None else tap.grad,
                     {k: v.grad for k, v in ex.items()}))
    (p0, k0, g0, t0, e0), (p1, k1, g1, t1, e1) = outs
    same(k1, k0)
    for f in tpre.Preprocessed._fields:
        same(getattr(p1, f), getattr(p0, f))
    for k in gm.TRAINABLE_FIELDS:
        if g0[k] is None:
            assert g1[k] is None, k
        else:
            same(g1[k], g0[k])
    if t0 is None:
        assert t1 is None
    else:
        same(t1, t0)
    for k in e0:
        same(e1[k], e0[k])


def test_no_kernel_is_built_or_launched_without_cuda(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("a kernel build on the CPU")
    monkeypatch.setattr(build, "build", refuse)
    monkeypatch.setattr(build, "load", refuse)
    monkeypatch.setattr(kpre, "_bound", refuse)
    before = (kpre.preprocess_fwd_cuda.launches,
              kpre.preprocess_bwd_cuda.launches,
              tpre.preprocess_packed.plain_cuda)
    g, cam = scene(deg=1)
    gg, leaves = with_leaves(g)
    out = rasterize.render(gg, cam, W, H, torch.zeros(3),
                           rasterize.RasterizerConfig(pairs_per_gaussian=24),
                           mean2d_tap=torch.zeros((g.capacity, 2),
                                                  requires_grad=True))
    out.image.sum().backward()
    grad = leaves["xyz"].grad[7:]           # past the edge rows
    assert bool(torch.isfinite(grad).all()) and float(grad.abs().sum()) > 0
    assert (kpre.preprocess_fwd_cuda.launches,
            kpre.preprocess_bwd_cuda.launches,
            tpre.preprocess_packed.plain_cuda) == before
    fields = (g.xyz, g.scaling, g.rotation, g.opacity, g.f_dc, g.f_rest,
              g.active)
    s = kpre.Settings(W, H, 1, 1.0, False, 0.3, 1.0 / 255.0)
    with pytest.raises(ValueError, match="needs CUDA"):
        kpre.preprocess_fwd_cuda(fields, None, cam, s)
    with pytest.raises(ValueError, match="needs CUDA"):
        kpre.preprocess_bwd_cuda(fields, cam, s,
                                 torch.zeros((g.capacity + 1, 16)), False)


# --- the kernels' sources as host C++ ---------------------------------------

SHIM = """
#pragma once
#include <algorithm>
#include <cmath>
#include <condition_variable>
#include <mutex>
#include <thread>
#include <vector>
using std::max;
using std::min;
#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(...)
struct dim3 { unsigned x, y, z; };
static thread_local dim3 threadIdx, blockIdx;
static dim3 blockDim;
struct float4 { float x, y, z, w; };
typedef struct CUstream_st* cudaStream_t;
enum cudaError_t { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
inline cudaError_t cudaGetLastError() { return cudaSuccess; }
// one rounding each, as the device's round-to-nearest intrinsics
inline float __fmul_rn(float a, float b) { volatile float r = a * b; return r; }
inline float __fadd_rn(float a, float b) { volatile float r = a + b; return r; }
inline float __fsub_rn(float a, float b) { volatile float r = a - b; return r; }
inline float __fdiv_rn(float a, float b) { volatile float r = a / b; return r; }
inline float4 make_float4(float a, float b, float c, float d) {
  return {a, b, c, d};
}
// a block: one host thread a CUDA thread, __syncthreads a barrier, the
// dynamic shared memory one buffer; blocks one after another
struct Barrier {
  std::mutex m;
  std::condition_variable cv;
  unsigned n, count = 0, gen = 0;
  void wait() {
    std::unique_lock<std::mutex> l(m);
    const unsigned g = gen;
    if (++count == n) { count = 0; ++gen; cv.notify_all(); }
    else cv.wait(l, [&] { return g != gen; });
  }
};
static Barrier* g_barrier;
static std::vector<float> g_smem;
inline void __syncthreads() { g_barrier->wait(); }
template <class F>
void host_launch(unsigned blocks, unsigned threads, int smem, F f) {
  blockDim = {threads, 1, 1};
  g_smem.assign(smem / sizeof(float) + 1, 0.f);
  for (unsigned b = 0; b < blocks; ++b) {
    Barrier bar;
    bar.n = threads;
    g_barrier = &bar;
    std::vector<std::thread> ts;
    for (unsigned t = 0; t < threads; ++t)
      ts.emplace_back([&, b, t] {
        blockIdx = {b, 0, 0};
        threadIdx = {t, 0, 0};
        f();
      });
    for (auto& th : ts) th.join();
  }
}
"""


@pytest.fixture(scope="module")
def host_kernels(tmp_path_factory):
    """The port's wrapper, with its two C functions built from the CUDA
    sources by g++ for the host and the device plumbing stood in for."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("no g++ to build the kernels' sources for the host")
    tmp = tmp_path_factory.mktemp("hostk")
    (tmp / "cuda_runtime.h").write_text(SHIM)
    fns = {}
    for name in ("preprocess_fwd", "preprocess_bwd"):
        src = host_source((build.CSRC / f"{name}.cu").read_text())
        assert "host_launch(" in src and "extern __shared__" not in src
        (tmp / f"{name}.cpp").write_text(src)
        lib = tmp / f"lib{name}.so"
        subprocess.run([gxx, "-std=c++17", "-O1", "-ffp-contract=off",
                        "-fPIC", "-shared", "-pthread", "-I", str(tmp), "-I",
                        str(build.CSRC), "-o", str(lib),
                        str(tmp / f"{name}.cpp")], check=True, timeout=300)
        fn = getattr(ctypes.CDLL(str(lib)), f"gsplat_{name}")
        fn.argtypes = kpre._ARGTYPES[name]
        fn.restype = ctypes.c_int
        fns[name] = fn

    def check(name, fields, cam):
        return ([x.detach().contiguous() for x in fields],
                [x.detach().contiguous() for x in (
                    cam.world_view, cam.full_proj, cam.camera_center,
                    cam.tanfovx, cam.tanfovy)])
    mp = pytest.MonkeyPatch()
    mp.setattr(kpre, "_bound", lambda name, csrc: fns[name])
    mp.setattr(kpre, "_check", check)
    mp.setattr(torch.cuda, "device", lambda d: contextlib.nullcontext())
    mp.setattr(torch.cuda, "current_stream",
               lambda d=None: types.SimpleNamespace(cuda_stream=None))
    yield kpre
    mp.undo()


@pytest.mark.parametrize("deg,active_deg,aa", CASES, ids=CASE_IDS)
def test_kernel_sources_on_the_host_match_the_plain_path(host_kernels, deg,
                                                         active_deg, aa):
    g, cam = scene(deg=deg, active_deg=active_deg)
    kw = dict(scaling_modifier=0.7 if aa else 1.0, antialiasing=aa,
              dilation=0.3, alpha_min=1.0 / 255.0)
    ct = torch.tensor(np.random.default_rng(9).standard_normal(
        (g.capacity + 1, 16)), dtype=torch.float32)
    outs = []
    for fused in (False, True):
        gg, leaves = with_leaves(g)
        tap = torch.zeros((g.capacity, 2), requires_grad=True)
        if fused:
            fields = (gg.xyz, gg.scaling, gg.rotation, gg.opacity, gg.f_dc,
                      gg.f_rest, gg.active)
            packed, *cols = host_kernels.preprocess_packed_cuda(
                fields, tap, cam,
                host_kernels.Settings(W, H, active_deg, **kw))
            cols = dict(zip(("depth", "radius", "rx", "ry", "t_cut"), cols))
        else:
            pre, packed = tpre.preprocess_packed_plain(
                gg, cam, W, H, mean2d_tap=tap, **kw)
            cols = {k: getattr(pre, k).detach()
                    for k in ("depth", "radius", "rx", "ry", "t_cut")}
        (packed * ct).sum().backward()
        outs.append((packed.detach(), cols,
                     {k: v.grad for k, v in leaves.items()}, tap.grad))
    (p0, c0, g0, t0), (p1, c1, g1, t1) = outs
    torch.testing.assert_close(p1, p0, equal_nan=True, **FIELD_TOL)
    assert torch.equal(p1[-1], torch.zeros(16)) and not p1[:, 10:].any()
    for k in ("depth", "t_cut"):
        torch.testing.assert_close(c1[k], c0[k], **FIELD_TOL)
    for k in ("radius", "rx", "ry"):
        assert torch.equal(c1[k], c0[k]), k
    for k in gm.TRAINABLE_FIELDS:
        torch.testing.assert_close(g1[k], g0[k], equal_nan=True, **GRAD_TOL)
    torch.testing.assert_close(t1, t0, **GRAD_TOL)
    # the edge rows are what they claim to be
    assert float(c0["radius"][:3].abs().sum()) == 0       # z <= 0.2
    assert bool(torch.isnan(p0[6, 2:5]).all())            # det NaN
    assert float(p0[5, 6:9].abs().sum()) == 0             # clamped at 0
    assert float(g0["xyz"][3].abs().sum()) > 0


def test_kernel_sources_on_the_host_give_the_same_bits_twice(host_kernels):
    g, cam = scene(deg=3, active_deg=3)
    fields = (g.xyz, g.scaling, g.rotation, g.opacity, g.f_dc, g.f_rest,
              g.active)
    s = host_kernels.Settings(W, H, 3, 1.0, True, 0.3, 1.0 / 255.0)
    d = torch.tensor(np.random.default_rng(2).standard_normal(
        (g.capacity + 1, 16)), dtype=torch.float32)
    a = host_kernels.preprocess_bwd_cuda(fields, cam, s, d, True)
    b = host_kernels.preprocess_bwd_cuda(fields, cam, s, d, True)
    for x, y in zip(a, b):
        same(x, y)
