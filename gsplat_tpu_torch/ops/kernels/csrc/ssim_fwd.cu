// Fused SSIM forward for Hopper (sm_90a): the per-pixel SSIM map and, when
// a gradient is wanted, the three partial maps its backward needs.
//
// Replaces the TPU kernel gsplat_tpu/ops/pallas/ssim_kernel.py `_fwd_kernel`
// (reached through `ssim_map_fused`) and computes the plain version
// gsplat_tpu_torch/ops/ssim.py `ssim_map` for (C, H, W) float32 images:
// five separable 11-tap Gaussian blurs (sigma 1.5, zero padding) of x, y,
// x^2, y^2 and xy, variances clamped at 0, C1 = 0.01^2, C2 = 0.03^2. With
// PARTIALS it also writes p = (p_mu, p_x2, p_xy), the cotangents of mu1,
// blur x^2 and blur xy under a unit cotangent of the map
// (ops/kernels/ssim.py `ssim_partials_plain`; ssim_kernel.py:103-120 with
// g = 1). Every one of them is linear in the map's cotangent g, so the
// backward (ssim_bwd.cu) needs only g * p and recomputes no blur.
//
// What bounds it on this card: per pixel it reads 8 bytes and writes 4 (16
// more with PARTIALS), and does 5 blurs x 2 passes x 21 = 210 rounded f32
// operations, 3 products and ~20 for the map: ~0.02 ms of memory and, at
// one rounded operation per lane and clock (no FMA), ~0.05 ms of f32 issue
// at 3x1080x1920. So it is bound by the f32 pipes once shared memory stops
// being the limit.
//
// What the design does about it (ssim_tile.cuh): a 256-thread block owns a
// 32 x 64 tile and stages only x and y on its 42 x 74 halo (1.52x the tile;
// 42 x 80 staged, so that rows are whole 16-byte chunks); x^2, y^2 and xy
// are formed in registers, and both passes take their taps from registers
// over sliding windows of 8 outputs, so a pixel costs about 28 shared-memory
// accesses against 149 with taps read from shared memory. No blurred field
// goes to device memory. Rounded like the plain version op for op, so the
// map equals it barring the division.

#include "ssim_tile.cuh"

namespace {

using namespace ssim;

// (x, y) -> (x, y, x^2, y^2, xy), the five blurred fields
struct FiveFields {
  __device__ __forceinline__ void operator()(const float (&in)[2],
                                             float (&v)[5]) const {
    v[0] = in[0];
    v[1] = in[1];
    v[2] = __fmul_rn(in[0], in[0]);
    v[3] = __fmul_rn(in[1], in[1]);
    v[4] = __fmul_rn(in[0], in[1]);
  }
};

template <bool PARTIALS>
__global__ void __launch_bounds__(kThreads, 3)
ssim_fwd_kernel(const float* __restrict__ x, const float* __restrict__ y,
                float* __restrict__ out, float* __restrict__ p, int C, int H,
                int W, bool vec, Window win, float c1, float c2) {
  extern __shared__ __align__(16) float smem[];
  float* src = smem;                                // (2, kSH, kSW)
  float* mid = smem + smem_floats(2, 0, 1);         // (5, kTH, kMP)
  // the results: the map alone in the staged fields' space, which the
  // vertical pass has freed; with the partial maps, 4 fields in the
  // blurred fields' space, once the horizontal pass is done with it
  float* res = PARTIALS ? mid : smem;               // (1 or 4, kTH, kOP)
  const long long n = static_cast<long long>(C) * H * W;
  const long long plane = static_cast<long long>(blockIdx.z) * H * W;
  const int ox = blockIdx.x * kTW, oy = blockIdx.y * kTH;

  const float* const in[2] = {x + plane, y + plane};
  stage<2>(in, H, W, ox, oy, vec, src);
  vertical<2, 5>(src, mid, win, FiveFields());

  float m[5][kRows];
  horizontal<5>(mid, m, win);
  float o[PARTIALS ? 4 : 1][kRows];
#pragma unroll
  for (int j = 0; j < kRows; ++j) {
    const float mj[5] = {m[0][j], m[1][j], m[2][j], m[3][j], m[4][j]};
    const Terms s = terms(mj, c1, c2);
    const float ab = __fmul_rn(s.a, s.b), cd = __fmul_rn(s.c, s.d);
    const float map = __fdiv_rn(ab, cd);
    o[0][j] = map;
    if (PARTIALS) {
      // ssim_partials_plain, operation for operation
      const float inv_cd = __frcp_rn(cd);
      const float d_a = __fmul_rn(s.b, inv_cd);
      const float d_b = __fmul_rn(s.a, inv_cd);
      const float d_c = -__fmul_rn(map, __frcp_rn(s.c));
      const float d_d = -__fmul_rn(map, __frcp_rn(s.d));
      const float d_dm = s.v1 > 0.f ? d_d : 0.f;      // the clamp's mask
      o[PARTIALS ? 1 : 0][j] = __fmul_rn(
          2.f, __fadd_rn(__fmul_rn(mj[1], __fsub_rn(d_a, d_b)),
                         __fmul_rn(mj[0], __fsub_rn(d_c, d_dm))));
      o[PARTIALS ? 2 : 0][j] = d_dm;
      o[PARTIALS ? 3 : 0][j] = __fmul_rn(2.f, d_b);
    }
  }
  if (PARTIALS) __syncthreads();                    // mid is read no more
  const int at = seg_row() * kOP + seg_col();
#pragma unroll
  for (int k = 0; k < (PARTIALS ? 4 : 1); ++k)
#pragma unroll
    for (int j = 0; j < kRows; ++j) res[k * kTH * kOP + at + j] = o[k][j];
  __syncthreads();
  float* outp = out + plane;
  for_tile(H, W, ox, oy, [&](int, int i, long long q) {
    outp[q] = res[i];
    if (PARTIALS) {
#pragma unroll
      for (int k = 0; k < 3; ++k)
        p[k * n + plane + q] = res[(k + 1) * kTH * kOP + i];
    }
  });
}

template <bool PARTIALS>
int launch(const float* x, const float* y, float* out, float* p, int C,
           int H, int W, const float* window, float c1, float c2,
           cudaStream_t stream) {
  const int bytes = (PARTIALS ? smem_floats(2, 5, 0, 4)
                              : smem_floats(2, 5, 1)) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      ssim_fwd_kernel<PARTIALS>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const bool vec = aligned16(W, {x, y, p});
  ssim_fwd_kernel<PARTIALS><<<grid_of(C, H, W), kThreads, bytes, stream>>>(
      x, y, out, p, C, H, W, vec, make_window(window), c1, c2);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// x, y, out: (C, H, W) float32, contiguous; p: (3, C, H, W) float32 for the
// partial maps, or null for the map alone; window: 11 host floats. Launches
// on `stream`; returns the launch's cudaError_t (0 on success).
int gsplat_ssim_fwd(const float* x, const float* y, float* out, float* p,
                    int C, int H, int W, const float* window, float c1,
                    float c2, void* stream) {
  if (C <= 0 || H <= 0 || W <= 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return p ? launch<true>(x, y, out, p, C, H, W, window, c1, c2, s)
           : launch<false>(x, y, out, p, C, H, W, window, c1, c2, s);
}

}  // extern "C"
