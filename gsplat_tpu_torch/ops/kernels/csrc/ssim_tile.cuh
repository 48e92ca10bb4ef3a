// Shared tile machinery of the fused SSIM kernels (ssim_fwd.cu, ssim_bwd.cu).
//
// A block of 32 x 8 threads owns a 16 x 32 tile of one channel's output.
// It stages its fields on the tile plus a 5-pixel halo (26 x 42, zero
// outside the image, which is the reference's zero padding) in shared
// memory, runs the vertical 11-tap pass into a 16 x 42 middle buffer, and
// each thread then runs the horizontal pass for its pixels. Every product
// and sum is rounded on its own (__fmul_rn / __fadd_rn, no FMA), in the
// plain version's order (gsplat_tpu_torch/ops/ssim.py `_blur`: tap 0 to
// 10, vertical then horizontal), so a blur here equals the plain blur.
#pragma once

#include <cuda_runtime.h>

namespace ssim {

constexpr int kR = 5;                    // halo: window 11, same padding
constexpr int kTaps = 2 * kR + 1;
constexpr int kTW = 32, kTH = 16;        // output tile
constexpr int kBX = 32, kBY = 8;         // threads
constexpr int kThreads = kBX * kBY;
constexpr int kSW = kTW + 2 * kR, kSH = kTH + 2 * kR;

struct Window {
  float w[kTaps];
};

// dst (kSH, kSW) <- plane (H, W) around the tile at (ox, oy), 0 outside.
__device__ __forceinline__ void load_halo(const float* __restrict__ plane,
                                          int H, int W, int ox, int oy,
                                          float (*dst)[kSW]) {
  const int tid = threadIdx.y * kBX + threadIdx.x;
  for (int i = tid; i < kSH * kSW; i += kThreads) {
    const int r = i / kSW, q = i % kSW;
    const int gy = oy + r - kR, gx = ox + q - kR;
    dst[r][q] = (gy >= 0 && gy < H && gx >= 0 && gx < W)
                    ? plane[static_cast<long long>(gy) * W + gx]
                    : 0.f;
  }
}

// mid[f] (kTH, kSW) <- vertical pass of src[f] (kSH, kSW), f < NF.
template <int NF>
__device__ __forceinline__ void vertical(const float (*src)[kSH][kSW],
                                         float (*mid)[kTH][kSW],
                                         const Window& win) {
  const int tid = threadIdx.y * kBX + threadIdx.x;
  for (int i = tid; i < kTH * kSW; i += kThreads) {
    const int r = i / kSW, q = i % kSW;
#pragma unroll
    for (int f = 0; f < NF; ++f) {
      float acc = __fmul_rn(win.w[0], src[f][r][q]);
#pragma unroll
      for (int t = 1; t < kTaps; ++t)
        acc = __fadd_rn(acc, __fmul_rn(win.w[t], src[f][r + t][q]));
      mid[f][r][q] = acc;
    }
  }
}

// out[f] <- horizontal pass of mid[f] at tile pixel (r, c), f < NF.
template <int NF>
__device__ __forceinline__ void horizontal(const float (*mid)[kTH][kSW],
                                           const Window& win, int r, int c,
                                           float* out) {
#pragma unroll
  for (int f = 0; f < NF; ++f) {
    float acc = __fmul_rn(win.w[0], mid[f][r][c]);
#pragma unroll
    for (int t = 1; t < kTaps; ++t)
      acc = __fadd_rn(acc, __fmul_rn(win.w[t], mid[f][r][c + t]));
    out[f] = acc;
  }
}

// Stage x, y, x*x, y*y, x*y on the tile and halo and blur them: after the
// barrier at the end, mid holds the vertical pass of the five fields.
__device__ __forceinline__ void five_fields(const float* __restrict__ x,
                                            const float* __restrict__ y,
                                            int H, int W, int ox, int oy,
                                            float (*src)[kSH][kSW],
                                            float (*mid)[kTH][kSW],
                                            const Window& win) {
  load_halo(x, H, W, ox, oy, src[0]);
  load_halo(y, H, W, ox, oy, src[1]);
  __syncthreads();
  const int tid = threadIdx.y * kBX + threadIdx.x;
  for (int i = tid; i < kSH * kSW; i += kThreads) {
    const int r = i / kSW, q = i % kSW;
    const float a = src[0][r][q], b = src[1][r][q];
    src[2][r][q] = __fmul_rn(a, a);
    src[3][r][q] = __fmul_rn(b, b);
    src[4][r][q] = __fmul_rn(a, b);
  }
  __syncthreads();
  vertical<5>(src, mid, win);
  __syncthreads();
}

// The SSIM terms from the five blurred fields m = (mu1, mu2, blur x^2,
// blur y^2, blur xy): map = (a b) / (c d), in the plain version's order.
// v1 = blur x^2 - mu1^2 before the variance clamp.
struct Terms {
  float a, b, c, d, v1;
};

__device__ __forceinline__ Terms terms(const float* m, float c1, float c2) {
  const float mu1_sq = __fmul_rn(m[0], m[0]);
  const float mu2_sq = __fmul_rn(m[1], m[1]);
  const float mu1_mu2 = __fmul_rn(m[0], m[1]);
  const float v1 = __fsub_rn(m[2], mu1_sq);
  const float v2 = __fsub_rn(m[3], mu2_sq);
  const float s1 = v1 > 0.f ? v1 : 0.f;
  const float s2 = v2 > 0.f ? v2 : 0.f;
  const float s12 = __fsub_rn(m[4], mu1_mu2);
  Terms o;
  o.a = __fadd_rn(__fmul_rn(2.f, mu1_mu2), c1);
  o.b = __fadd_rn(__fmul_rn(2.f, s12), c2);
  o.c = __fadd_rn(__fadd_rn(mu1_sq, mu2_sq), c1);
  o.d = __fadd_rn(__fadd_rn(s1, s2), c2);
  o.v1 = v1;
  return o;
}

}  // namespace ssim
