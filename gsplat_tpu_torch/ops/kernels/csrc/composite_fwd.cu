// Tile compositor forward for Hopper (sm_90a).
//
// Replaces two TPU kernels of the same semantics: gsplat_tpu/ops/pallas/
// composite_stream.py `_fwd_strip_kernel` (reached through
// `composite_fwd_stream`) and composite.py `_fwd_kernel` (reached through
// `_composite_fwd_call`), which differ on the TPU in their grid and in that
// the second takes `t_init` and `tile_id_base`. It computes the same as the
// plain version gsplat_tpu_torch/ops/composite_ref.py
// `composite_tiles_plain`: for each tile, walk its depth-sorted entry range
// front to back; per pixel
//   power = -1/2 (a dx^2 + c dy^2) - b dx dy          (tile-local dx, dy)
//   alpha = min(alpha_max, op * exp(min(power, 0)))
//   skip unless alpha >= alpha_min and power <= 0
//   stop (without contributing) once t_init (T (1 - alpha)) < t_eps
//   accum += T alpha (rgb, invdepth);  T *= 1 - alpha
//   n_contrib = 1 + in-tile rank of the last contributor.
// An empty tile gives accum 0, T 1, n_contrib 0. `t_init` (n_tiles, P) is
// the transmittance arriving from nearer depth slabs; it scales the stop
// test only, associated as the plain version does, t_init * (T * (1 -
// alpha)), and is 1 where the pointer is null. Tile t of the launch lies
// where tile `tile_id_base + t` of the full grid lies (tile bands).
//
// What bounds it on this card: each (pair, pixel) evaluation is about 20
// f32 operations and one exp. At 67 TFLOP/s f32 that is ~0.3 ns per
// thousand evaluations, against ~64 B per entry row read once at 3.35 TB/s:
// with 1024 pixels per 32x32 tile the operations outweigh the bytes ~17x,
// so the kernel is bound by operations, and by how many evaluations it does
// past the point where every pixel of a tile has terminated.
//
// What the design does about it: one block per tile, 256 threads, each
// thread owning 4 pixels whose state (T, accum, last) lives in registers.
// The tile's entries are staged through shared memory in batches of 256
// (one row per thread, only columns 0-9, with the tile origin subtracted
// once per entry), and every thread reads each staged entry as a broadcast.
// Before each batch the block counts its finished threads
// (__syncthreads_count) and leaves as soon as all pixels are done, which is
// the CUDA form of the TPU kernel's whole-tile early out. Transmittance is
// kept as (T at the start of the G-entry chunk) x (product within the
// chunk), with round-to-nearest intrinsics and exact f32 `expf` (no
// fast-math, no FMA contraction), so it rounds as the plain version's
// per-chunk cumprod does and the early-termination test stops every pixel
// at the same entry. `t_init` is read once per pixel into a register, and
// whether there is one is a template parameter, so the kernel without it is
// the code it was before it took one. Tensor cores, TMA and warp
// specialisation are later work.

#include <cuda_runtime.h>

#include "composite_alpha.cuh"

namespace {

constexpr int kThreads = 256;   // threads per block (one block per tile)
constexpr int kPix = 4;         // pixels per thread: tiles up to 1024 px
constexpr int kBatch = 256;     // entries staged in shared memory at once

template <bool kHasTInit>
__global__ void __launch_bounds__(kThreads)
composite_fwd_kernel(const float* __restrict__ entries, long long n_rows,
                     const int* __restrict__ tile_start,
                     const int* __restrict__ tile_count, int n_tiles_x,
                     int tile_h, int tile_w, int chunk, float alpha_min,
                     float alpha_max, float t_eps,
                     const float* __restrict__ t_init, int tile_id_base,
                     float* __restrict__ accum,
                     float* __restrict__ t_final, int* __restrict__ n_contrib) {
  __shared__ float s_geo[6][kBatch];   // mx-ox, my-oy, conic a, b, c, opacity
  __shared__ float s_col[4][kBatch];   // rgb, invdepth

  const int t = blockIdx.x;
  const int P = tile_h * tile_w;
  const long long start = tile_start[t];
  const long long count = gsplat::clamp_count(start, tile_count[t], n_rows);
  float ox, oy;
  gsplat::tile_origin(t, tile_id_base, n_tiles_x, tile_h, tile_w, &ox, &oy);

  // Per pixel: t0 = transmittance at the start of the current G-entry
  // chunk, tp = product of (1 - alpha) of this chunk's contributors so far.
  // T = t0 * tp, associated as the plain version's per-chunk cumprod.
  float px[kPix], py[kPix], t0[kPix], tp[kPix], acc[kPix][4];
  float ti[kPix];                       // t_init of the pixel; unused without
  int last[kPix];
  bool done[kPix];
#pragma unroll
  for (int k = 0; k < kPix; ++k) {
    const int p = threadIdx.x + k * kThreads;
    done[k] = p >= P;
    px[k] = static_cast<float>(p % tile_w);
    py[k] = static_cast<float>(p / tile_w);
    t0[k] = 1.f;
    tp[k] = 1.f;
    acc[k][0] = acc[k][1] = acc[k][2] = acc[k][3] = 0.f;
    last[k] = 0;
    ti[k] = 1.f;
    if (kHasTInit && p < P) ti[k] = t_init[static_cast<long long>(t) * P + p];
  }

  for (long long b0 = 0; b0 < count; b0 += kBatch) {
    bool mine_done = true;
#pragma unroll
    for (int k = 0; k < kPix; ++k) mine_done = mine_done && done[k];
    // also the barrier that keeps the previous batch's readers ahead of
    // this batch's writers
    if (__syncthreads_count(mine_done) == kThreads) break;

    const int n = static_cast<int>(count - b0 < kBatch ? count - b0 : kBatch);
    if (threadIdx.x < n) {
      const float4* row = reinterpret_cast<const float4*>(
          entries + (start + b0 + threadIdx.x) * 16);
      const float4 r0 = row[0];
      const float4 r1 = row[1];
      const float2 r2 = *reinterpret_cast<const float2*>(row + 2);
      const int i = threadIdx.x;
      s_geo[0][i] = r0.x - ox;
      s_geo[1][i] = r0.y - oy;
      s_geo[2][i] = r0.z;
      s_geo[3][i] = r0.w;
      s_geo[4][i] = r1.x;
      s_geo[5][i] = r1.y;
      s_col[0][i] = r1.z;
      s_col[1][i] = r1.w;
      s_col[2][i] = r2.x;
      s_col[3][i] = r2.y;
    }
    __syncthreads();

    for (int j = 0; j < n; ++j) {
      if ((b0 + j) % chunk == 0) {      // a new chunk: fold its product in
#pragma unroll
        for (int k = 0; k < kPix; ++k) {
          t0[k] = __fmul_rn(t0[k], tp[k]);
          tp[k] = 1.f;
        }
      }
      const float mx = s_geo[0][j], my = s_geo[1][j];
      const float ca = s_geo[2][j], cb = s_geo[3][j], cc = s_geo[4][j];
      const float op = s_geo[5][j];
#pragma unroll
      for (int k = 0; k < kPix; ++k) {
        if (done[k]) continue;
        gsplat::Alpha a;
        if (!gsplat::eval_alpha(px[k], py[k], mx, my, ca, cb, cc, op,
                                alpha_min, alpha_max, &a))
          continue;
        // round-to-nearest products, so the early-termination test sees the
        // transmittance the plain version's sees
        const float one_m = __fsub_rn(1.f, a.alpha);
        const float t_excl = __fmul_rn(t0[k], tp[k]);
        float test_t = __fmul_rn(t_excl, one_m);
        if (kHasTInit) test_t = __fmul_rn(ti[k], test_t);
        if (test_t < t_eps) {        // tested before committing:
          done[k] = true;            // no contribution
          continue;
        }
        const float w = __fmul_rn(t_excl, a.alpha);
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[k][c] += w * s_col[c][j];
        tp[k] = __fmul_rn(tp[k], one_m);
        last[k] = static_cast<int>(b0) + j + 1;
      }
    }
  }

#pragma unroll
  for (int k = 0; k < kPix; ++k) {
    const int p = threadIdx.x + k * kThreads;
    if (p >= P) continue;
    const long long o = static_cast<long long>(t) * P + p;
#pragma unroll
    for (int c = 0; c < 4; ++c)
      accum[(static_cast<long long>(t) * 4 + c) * P + p] = acc[k][c];
    t_final[o] = __fmul_rn(t0[k], tp[k]);
    n_contrib[o] = last[k];
  }
}

}  // namespace

extern "C" {

// Pixels per tile the kernel takes (kThreads * kPix).
int gsplat_composite_fwd_max_pixels() { return kThreads * kPix; }

// entries (n_rows, 16) f32; tile_start / tile_count (n_tiles,) i32, each
// tile's range starting on a multiple of `chunk` (the binning alignment);
// accum (n_tiles, 4, P) f32, t_final (n_tiles, P) f32, n_contrib
// (n_tiles, P) i32 with P = tile_h * tile_w <= kThreads * kPix; t_init
// (n_tiles, P) f32 or null (= ones); tile_id_base the full-grid id of the
// launch's tile 0. Launches on `stream` and returns the launch's
// cudaError_t (0 on success).
int gsplat_composite_fwd(const float* entries, long long n_rows,
                         const int* tile_start, const int* tile_count,
                         int n_tiles, int n_tiles_x, int tile_h, int tile_w,
                         int chunk, float alpha_min, float alpha_max,
                         float t_eps, const float* t_init, int tile_id_base,
                         float* accum, float* t_final, int* n_contrib,
                         void* stream) {
  if (n_tiles <= 0) return 0;
  if (tile_h * tile_w > kThreads * kPix || chunk <= 0 || n_tiles_x <= 0 ||
      tile_id_base < 0)
    return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (t_init != nullptr) {
    composite_fwd_kernel<true><<<n_tiles, kThreads, 0, s>>>(
        entries, n_rows, tile_start, tile_count, n_tiles_x, tile_h, tile_w,
        chunk, alpha_min, alpha_max, t_eps, t_init, tile_id_base, accum,
        t_final, n_contrib);
  } else {
    composite_fwd_kernel<false><<<n_tiles, kThreads, 0, s>>>(
        entries, n_rows, tile_start, tile_count, n_tiles_x, tile_h, tile_w,
        chunk, alpha_min, alpha_max, t_eps, nullptr, tile_id_base, accum,
        t_final, n_contrib);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
