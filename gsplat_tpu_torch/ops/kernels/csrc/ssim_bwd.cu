// Fused SSIM backward for Hopper (sm_90a): d img1 of the SSIM map.
//
// Replaces the TPU kernel gsplat_tpu/ops/pallas/ssim_kernel.py `_bwd_kernel`
// (reached through `_fused_bwd`) and computes what autograd through the
// plain version gsplat_tpu_torch/ops/ssim.py `ssim_map` gives for img1,
// with img2 a constant, from the map's cotangent g (C, H, W):
//   d img1 = blur(t_mu) + 2 x blur(t_x2) + y blur(t_xy)
// (the window is symmetric, so the transposed blur is the blur), where the
// t maps are the cotangents of the blurred fields mu1, blur x^2, blur xy
// (ssim_kernel.py:103-120; m1 = [blur x^2 - mu1^2 > 0] is the variance
// clamp's mask).
//
// Two launches, because the t maps are needed on a 5-pixel halo around
// each output tile: (1) `ssim_tmaps_kernel` recomputes the five blurred
// fields of its tile, as ssim_fwd.cu does, and writes t_mu, t_x2, t_xy to
// device memory; (2) `ssim_combine_kernel` blurs the three t maps of its
// tile and halo and combines them with x and y.
//
// What bounds it on this card: 16 bytes of inputs and outputs per pixel
// against 8 blurs x 44 and ~50 more f32 operations: about equal bounds,
// ~0.03 ms each at 3x1080x1920. The design adds 24 bytes per pixel of t
// maps written and read back (mostly through the 50 MB L2) in exchange
// for a simple halo: a one-launch form would recompute the fields on a
// 26 x 42 halo per tile, 2.1x the blur work.

#include "ssim_tile.cuh"

namespace {

using namespace ssim;

__global__ void __launch_bounds__(kThreads)
ssim_tmaps_kernel(const float* __restrict__ x, const float* __restrict__ y,
                  const float* __restrict__ g, float* __restrict__ tmaps,
                  int C, int H, int W, Window win, float c1, float c2) {
  __shared__ float src[5][kSH][kSW];
  __shared__ float mid[5][kTH][kSW];
  const long long n = static_cast<long long>(C) * H * W;
  const long long plane = static_cast<long long>(blockIdx.z) * H * W;
  const int ox = blockIdx.x * kTW, oy = blockIdx.y * kTH;
  five_fields(x + plane, y + plane, H, W, ox, oy, src, mid, win);
  const int gx = ox + threadIdx.x;
  for (int r = threadIdx.y; r < kTH; r += kBY) {
    const int gy = oy + r;
    if (gy >= H || gx >= W) continue;
    float m[5];
    horizontal<5>(mid, win, r, threadIdx.x, m);
    const Terms s = terms(m, c1, c2);
    const long long o = plane + static_cast<long long>(gy) * W + gx;
    const float gv = g[o];
    const float inv_cd = 1.f / (s.c * s.d);
    const float dA = gv * s.b * inv_cd;
    const float dB = gv * s.a * inv_cd;
    const float ab_cd = s.a * s.b * inv_cd;
    const float dC = -gv * ab_cd / s.c;
    const float dD = -gv * ab_cd / s.d;
    const float m1 = s.v1 > 0.f ? 1.f : 0.f;
    tmaps[o] = 2.f * (m[1] * (dA - dB) + m[0] * (dC - dD * m1));   // t_mu
    tmaps[n + o] = dD * m1;                                        // t_x2
    tmaps[2 * n + o] = 2.f * dB;                                   // t_xy
  }
}

__global__ void __launch_bounds__(kThreads)
ssim_combine_kernel(const float* __restrict__ x, const float* __restrict__ y,
                    const float* __restrict__ tmaps, float* __restrict__ dx,
                    int C, int H, int W, Window win) {
  __shared__ float src[3][kSH][kSW];
  __shared__ float mid[3][kTH][kSW];
  const long long n = static_cast<long long>(C) * H * W;
  const long long plane = static_cast<long long>(blockIdx.z) * H * W;
  const int ox = blockIdx.x * kTW, oy = blockIdx.y * kTH;
#pragma unroll
  for (int f = 0; f < 3; ++f)
    load_halo(tmaps + f * n + plane, H, W, ox, oy, src[f]);
  __syncthreads();
  vertical<3>(src, mid, win);
  __syncthreads();
  const int gx = ox + threadIdx.x;
  for (int r = threadIdx.y; r < kTH; r += kBY) {
    const int gy = oy + r;
    if (gy >= H || gx >= W) continue;
    float bl[3];
    horizontal<3>(mid, win, r, threadIdx.x, bl);
    const long long o = plane + static_cast<long long>(gy) * W + gx;
    dx[o] = bl[0] + 2.f * x[o] * bl[1] + y[o] * bl[2];
  }
}

Window make_window(const float* window) {
  Window win;
  for (int t = 0; t < kTaps; ++t) win.w[t] = window[t];
  return win;
}

dim3 grid_of(int C, int H, int W) {
  return dim3((W + kTW - 1) / kTW, (H + kTH - 1) / kTH, C);
}

}  // namespace

extern "C" {

// x, y, g: (C, H, W) float32 contiguous; tmaps: (3, C, H, W) float32
// scratch; window: 11 host floats. Launch (1) of 2. Returns cudaError_t.
int gsplat_ssim_bwd_tmaps(const float* x, const float* y, const float* g,
                          float* tmaps, int C, int H, int W,
                          const float* window, float c1, float c2,
                          void* stream) {
  if (C <= 0 || H <= 0 || W <= 0) return 0;
  ssim_tmaps_kernel<<<grid_of(C, H, W), dim3(kBX, kBY), 0,
                      static_cast<cudaStream_t>(stream)>>>(
      x, y, g, tmaps, C, H, W, make_window(window), c1, c2);
  return static_cast<int>(cudaGetLastError());
}

// tmaps from launch (1); dx: (C, H, W) float32 output. Launch (2) of 2.
int gsplat_ssim_bwd_combine(const float* x, const float* y,
                            const float* tmaps, float* dx, int C, int H,
                            int W, const float* window, void* stream) {
  if (C <= 0 || H <= 0 || W <= 0) return 0;
  ssim_combine_kernel<<<grid_of(C, H, W), dim3(kBX, kBY), 0,
                        static_cast<cudaStream_t>(stream)>>>(
      x, y, tmaps, dx, C, H, W, make_window(window));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
