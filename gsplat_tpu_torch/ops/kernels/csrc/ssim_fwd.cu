// Fused SSIM forward for Hopper (sm_90a): the per-pixel SSIM map.
//
// Replaces the TPU kernel gsplat_tpu/ops/pallas/ssim_kernel.py `_fwd_kernel`
// (reached through `ssim_map_fused`) and computes the plain version
// gsplat_tpu_torch/ops/ssim.py `ssim_map` for (C, H, W) float32 images:
// five separable 11-tap Gaussian blurs (sigma 1.5, zero padding) of x, y,
// x^2, y^2 and xy, variances clamped at 0, C1 = 0.01^2, C2 = 0.03^2.
//
// What bounds it on this card: per pixel it reads 8 bytes and writes 4, and
// does 5 blurs x 2 passes x 11 taps x 2 = 220 f32 operations plus ~20 for
// the map: at 3.35 TB/s and 67 TFLOP/s the two bounds are about equal
// (~0.02 ms each at 3x1080x1920).
//
// What the design does about it: the TPU kernel holds a whole channel in
// VMEM; here a block holds a 16 x 32 tile and its 5-pixel halo of the five
// fields in shared memory (ssim_tile.cuh), so each input is read from
// device memory once per tile (2.1x with the halo, mostly from L2) and no
// blurred field ever goes to device memory. Rounded like the plain version
// op for op, so the two agree to the last bit barring the division.

#include "ssim_tile.cuh"

namespace {

using namespace ssim;

__global__ void __launch_bounds__(kThreads)
ssim_fwd_kernel(const float* __restrict__ x, const float* __restrict__ y,
                float* __restrict__ out, int H, int W, Window win, float c1,
                float c2) {
  __shared__ float src[5][kSH][kSW];
  __shared__ float mid[5][kTH][kSW];
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
    out[plane + static_cast<long long>(gy) * W + gx] =
        __fdiv_rn(__fmul_rn(s.a, s.b), __fmul_rn(s.c, s.d));
  }
}

}  // namespace

extern "C" {

// x, y, out: (C, H, W) float32, contiguous; window: 11 host floats.
// Launches on `stream`; returns the launch's cudaError_t (0 on success).
int gsplat_ssim_fwd(const float* x, const float* y, float* out, int C, int H,
                    int W, const float* window, float c1, float c2,
                    void* stream) {
  if (C <= 0 || H <= 0 || W <= 0) return 0;
  Window win;
  for (int t = 0; t < kTaps; ++t) win.w[t] = window[t];
  const dim3 grid((W + kTW - 1) / kTW, (H + kTH - 1) / kTH, C);
  ssim_fwd_kernel<<<grid, dim3(kBX, kBY), 0,
                    static_cast<cudaStream_t>(stream)>>>(x, y, out, H, W, win,
                                                         c1, c2);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
