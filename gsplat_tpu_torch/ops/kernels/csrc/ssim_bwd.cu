// Fused SSIM backward for Hopper (sm_90a): d img1 of the SSIM map, in one
// launch, from the partial maps the forward wrote.
//
// Replaces the TPU kernel gsplat_tpu/ops/pallas/ssim_kernel.py `_bwd_kernel`
// (reached through `_fused_bwd`) and computes what autograd through the
// plain version gsplat_tpu_torch/ops/ssim.py `ssim_map` gives for img1,
// with img2 a constant, from the map's cotangent g (C, H, W):
//   d img1 = blur(t_mu) + 2 x blur(t_x2) + y blur(t_xy)
// (the window is symmetric, so the transposed blur is the blur), where the
// t maps are the cotangents of the blurred fields mu1, blur x^2 and blur xy
// (ssim_kernel.py:103-120). Each is linear in g: t = g * p, with
// p = (p_mu, p_x2, p_xy) written by ssim_fwd.cu beside the map
// (ops/kernels/ssim.py `ssim_partials_plain`), so nothing of the forward
// is recomputed here. The plain version is `ssim_bwd_plain`, operation for
// operation.
//
// What bounds it on this card: per pixel it reads g, the three p maps, x and
// y (24 bytes) and writes 4, and does 3 blurs x 42 + 3 products + 4 rounded
// f32 operations: ~0.05 ms of memory against ~0.03 ms of f32 issue at
// 3x1080x1920, so memory.
//
// What the design does about it (ssim_tile.cuh): a block stages g and the
// three p maps on its tile and halo asynchronously (the halo's mostly from
// L2), forms t = g * p in registers as the forward forms its products, blurs
// the three t fields with the forward's register passes, and combines them
// with x and y read in whole row segments. No scratch map goes to device
// memory, and each input is read from device memory once.

#include "ssim_tile.cuh"

namespace {

using namespace ssim;

// (g, p_mu, p_x2, p_xy) -> (t_mu, t_x2, t_xy) = g * p
struct TMaps {
  __device__ __forceinline__ void operator()(const float (&in)[4],
                                             float (&v)[3]) const {
#pragma unroll
    for (int k = 0; k < 3; ++k) v[k] = __fmul_rn(in[0], in[k + 1]);
  }
};

__global__ void __launch_bounds__(kThreads, 2)
ssim_bwd_kernel(const float* __restrict__ x, const float* __restrict__ y,
                const float* __restrict__ g, const float* __restrict__ p,
                float* __restrict__ dx, int C, int H, int W, bool vec,
                Window win) {
  extern __shared__ __align__(16) float smem[];
  float* src = smem;                      // (4, kSH, kSW), then
  float* res = smem;                      // (3, kTH, kOP)
  float* mid = smem + smem_floats(4, 0, 3);                 // (3, kTH, kMP)
  const long long n = static_cast<long long>(C) * H * W;
  const long long plane = static_cast<long long>(blockIdx.z) * H * W;
  const int ox = blockIdx.x * kTW, oy = blockIdx.y * kTH;

  const float* const in[4] = {g + plane, p + plane, p + n + plane,
                              p + 2 * n + plane};
  const float* xp = x + plane;
  const float* yp = y + plane;
  // x and y of this thread's pixels, loaded while the tile is staged and
  // blurred
  float xv[kPix], yv[kPix];
#pragma unroll
  for (int k = 0; k < kPix; ++k) {
    int at;
    const long long o = tile_pixel(k, H, W, ox, oy, &at);
    xv[k] = o >= 0 ? xp[o] : 0.f;
    yv[k] = o >= 0 ? yp[o] : 0.f;
  }
  stage<4>(in, H, W, ox, oy, vec, src);
  vertical<4, 3>(src, mid, win, TMaps());

  float bl[3][kRows];
  horizontal<3>(mid, bl, win);
  const int at = seg_row() * kOP + seg_col();
#pragma unroll
  for (int k = 0; k < 3; ++k)
#pragma unroll
    for (int j = 0; j < kRows; ++j) res[k * kTH * kOP + at + j] = bl[k][j];
  __syncthreads();
  float* dxp = dx + plane;
  for_tile(H, W, ox, oy, [&](int k, int i, long long o) {
    const float two_x = __fmul_rn(2.f, xv[k]);
    dxp[o] = __fadd_rn(
        __fadd_rn(res[i], __fmul_rn(two_x, res[kTH * kOP + i])),
        __fmul_rn(yv[k], res[2 * kTH * kOP + i]));
  });
}

}  // namespace

extern "C" {

// x, y, g, dx: (C, H, W) float32, contiguous; p: (3, C, H, W) float32, the
// forward's partial maps; window: 11 host floats. One launch on `stream`;
// returns its cudaError_t (0 on success).
int gsplat_ssim_bwd(const float* x, const float* y, const float* g,
                    const float* p, float* dx, int C, int H, int W,
                    const float* window, void* stream) {
  if (C <= 0 || H <= 0 || W <= 0) return 0;
  const int bytes = smem_floats(4, 3, 3) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      ssim_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const bool vec = aligned16(W, {g, p});
  ssim_bwd_kernel<<<grid_of(C, H, W), kThreads, bytes,
                    static_cast<cudaStream_t>(stream)>>>(
      x, y, g, p, dx, C, H, W, vec, make_window(window));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
