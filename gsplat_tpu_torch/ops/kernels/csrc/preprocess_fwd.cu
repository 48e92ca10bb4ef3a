// Fused per-gaussian preprocess and row packing for Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package leaves this stage to XLA, which
// fuses its elementwise passes into a few loops. In PyTorch the same stage,
// written as the plain path does it (GaussianParams.get_*, ops/preprocess.py
// `preprocess`, `pack_entries`), is about 300 elementwise kernels over (N,)
// columns, the SH products over (N, 16, 3) and six `torch.cat` copies,
// each of which reads and writes device memory. This kernel is one pass:
// one thread a gaussian, from the raw trainable fields (log scale,
// unnormalised quaternion, logit opacity, f_dc, f_rest) to the (N+1, 16)
// packed rows the entry gather reads (columns 0 mx, 1 my, 2..4 conic,
// 5 opacity, 6..8 rgb, 9 invdepth, 10..15 zero; row N zero) and the (N,)
// depth, radius, rx, ry and t_cut that binning reads, with the formulas of
// csrc/preprocess.cuh. A screen-space tap (N, 2), where given, is added
// into columns 0-1 scaled by (W/2, H/2), as ops/rasterize.py
// `build_entries` adds it.
//
// What bounds it on this card: bytes. Per gaussian it reads 237 B (SH
// degree 3) and writes 84 B, against about 450 float32 operations: at
// N = 3M, 0.96 GB is 0.29 ms at 3.35 TB/s and 1.35 GFLOP is 0.02 ms at
// 67 TFLOP/s.
//
// What the design does about it: every input byte is read once and every
// output byte written once; nothing in between goes to device memory. The
// packed row goes out as four 16-byte stores. A thread reads its own f_rest
// row (180 B at SH degree 3) from device memory, and the L1 serves a warp's
// 32 rows from whole lines: staging the block's rows in shared memory first,
// as the backward does for its gradient, took this kernel from 0.48 to
// 0.66 ms at N = 3M on the H100. The camera (35 floats) is read by every
// thread from the same addresses, which the L1 serves.

#include <cuda_runtime.h>

#include "preprocess.cuh"

namespace {

using namespace pre;

constexpr int kThreads = 128;

__global__ void __launch_bounds__(kThreads)
preprocess_fwd_kernel(Setup st, const float* __restrict__ xyz,
                      const float* __restrict__ scaling,
                      const float* __restrict__ rotation,
                      const float* __restrict__ opacity,
                      const float* __restrict__ f_dc,
                      const float* __restrict__ f_rest,
                      const unsigned char* __restrict__ active,
                      const float* __restrict__ tap,
                      float* __restrict__ packed, float* __restrict__ depth,
                      float* __restrict__ radius, float* __restrict__ rx,
                      float* __restrict__ ry, float* __restrict__ t_cut) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i > st.n) return;
  float4* row = reinterpret_cast<float4*>(packed + static_cast<long long>(i) *
                                                       kRow);
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
  if (i == st.n) {               // the sentinel row that dead entries address
#pragma unroll
    for (int k = 0; k < kRow / 4; ++k) row[k] = zero;
    return;
  }
  const Cam cam = load_cam(st);
  Fwd f;
  forward(st, cam, i, xyz, scaling, rotation, opacity, f_dc,
          f_rest + 3LL * (st.n_coeffs - 1) * i, active, f);
  float mx = f.mx, my = f.my;
  if (tap) {
    mx = add(mx, mul(tap[2LL * i], static_cast<float>(0.5 * st.width)));
    my = add(my, mul(tap[2LL * i + 1], static_cast<float>(0.5 * st.height)));
  }
  row[0] = make_float4(mx, my, mul(f.c11, f.inv_det),
                       mul(-f.c01, f.inv_det));
  row[1] = make_float4(mul(f.c00, f.inv_det), f.op_eff,
                       clamp_min(f.col[0], 0.f), clamp_min(f.col[1], 0.f));
  row[2] = make_float4(clamp_min(f.col[2], 0.f), f.inv_depth, 0.f, 0.f);
  row[3] = zero;
  depth[i] = f.pv[2];
  radius[i] = f.radius;
  rx[i] = f.rx;
  ry[i] = f.ry;
  t_cut[i] = f.t_cut;
}

}  // namespace

extern "C" {

// Raw fields of N gaussians, float32 and contiguous: xyz, scaling (log),
// rotation (N, 4) unnormalised, opacity (N,) logit, f_dc (N, 3), f_rest
// (N, K-1, 3); active (N,) bool; tap (N, 2) or null. The camera: world_view
// and full_proj (4, 4), cam_center (3,), tanfovx and tanfovy (), all on the
// device. Out: packed (N+1, 16), depth, radius, rx, ry, t_cut (N,).
// Launches on `stream`; returns the launch's cudaError_t (0 on success).
int gsplat_preprocess_fwd(
    const float* xyz, const float* scaling, const float* rotation,
    const float* opacity, const float* f_dc, const float* f_rest,
    const unsigned char* active, const float* tap, const float* world_view,
    const float* full_proj, const float* cam_center, const float* tanfovx,
    const float* tanfovy, int n, int n_coeffs, int active_sh_degree,
    int width, int height, float scaling_modifier, int antialiasing,
    float dilation, float alpha_min, float* packed, float* depth,
    float* radius, float* rx, float* ry, float* t_cut, void* stream) {
  if (n < 0 || n_coeffs < 1 || n_coeffs > kMaxCoeffs)
    return cudaErrorInvalidValue;
  const Setup st = make_setup(world_view, full_proj, cam_center, tanfovx,
                              tanfovy, n, n_coeffs, active_sh_degree, width,
                              height, scaling_modifier, antialiasing,
                              dilation, alpha_min);
  const int blocks = (n + 1 + kThreads - 1) / kThreads;
  preprocess_fwd_kernel<<<blocks, kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      st, xyz, scaling, rotation, opacity, f_dc, f_rest, active, tap, packed,
      depth, radius, rx, ry, t_cut);
  return cudaGetLastError();
}

}  // extern "C"
