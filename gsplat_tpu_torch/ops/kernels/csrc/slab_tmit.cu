// Slab transmittance for Hopper (sm_90a): the cut-free per-pixel product
// of (1 - alpha) over each tile's whole entry list.
//
// Replaces the TPU kernel gsplat_tpu/ops/pallas/composite.py `_tmit_kernel`
// (reached through `slab_transmittance_pallas`), and computes the same as
// the plain version gsplat_tpu_torch/ops/composite_ref.py
// `slab_transmittance_plain`: for each tile and pixel, over ALL of the
// tile's entries (no early out, no contributor bookkeeping, no colour),
//   alpha as the compositor evaluates it (composite_alpha.cuh)
//   T = prod (1 - alpha)  over the entries not skipped
// and T = 1 on an empty tile. It is what the compositor's t_final is with
// t_eps = 0. Depth-slab rendering runs it once per slab before the real
// pass: the exclusive product of the nearer slabs' T is the transmittance a
// pixel arrives with, which the compositor's stop test then takes as
// `t_init`. It has no gradient.
//
// The TPU kernel keeps the per-pixel state as a sum of log1p(-alpha) and
// exponentiates at the end; this one keeps the product itself, as (T at the
// start of the G-entry chunk) x (product within the chunk), with
// round-to-nearest products, exactly as composite_fwd.cu keeps its
// transmittance. That drops a log1pf per evaluation, and makes the result
// equal composite_fwd's t_final at t_eps = 0 bit for bit, so the cut the
// next pass applies is the one a single pass over all slabs would apply to
// the same products. Against the plain version's sum of logs it differs by
// rounding only (a few 1e-7 relative per hundred contributors).
//
// What bounds it on this card: each (entry, pixel) evaluation is about 18
// f32 operations and one exp, against 24 B per entry row read once (columns
// 0-5) and 4 B per pixel written: with 1024 pixels per tile the operations
// outweigh the bytes by two orders, so it is bound by operations, and since
// nothing ends early, by every (entry, pixel) pair of the slab.
//
// What the design does about it: one block per tile, 256 threads, 4 pixels
// per thread with their two products in registers; the tile's entries are
// staged through shared memory in batches of 256 (one row per thread,
// columns 0-5 only, the tile origin subtracted once per entry) and read by
// every thread as a broadcast.

#include <cuda_runtime.h>

#include "composite_alpha.cuh"

namespace {

constexpr int kThreads = 256;   // threads per block (one block per tile)
constexpr int kPix = 4;         // pixels per thread: tiles up to 1024 px
constexpr int kBatch = 256;     // entries staged in shared memory at once

__global__ void __launch_bounds__(kThreads)
slab_tmit_kernel(const float* __restrict__ entries, long long n_rows,
                 const int* __restrict__ tile_start,
                 const int* __restrict__ tile_count, int n_tiles_x, int tile_h,
                 int tile_w, int chunk, float alpha_min, float alpha_max,
                 float* __restrict__ t_out) {
  __shared__ float s_geo[6][kBatch];   // mx-ox, my-oy, conic a, b, c, opacity

  const int t = blockIdx.x;
  const int P = tile_h * tile_w;
  const long long start = tile_start[t];
  const long long count = gsplat::clamp_count(start, tile_count[t], n_rows);
  float ox, oy;
  gsplat::tile_origin(t, 0, n_tiles_x, tile_h, tile_w, &ox, &oy);

  // T = t0 * tp: t0 at the start of the current chunk, tp within it
  float px[kPix], py[kPix], t0[kPix], tp[kPix];
#pragma unroll
  for (int k = 0; k < kPix; ++k) {
    const int p = threadIdx.x + k * kThreads;
    px[k] = static_cast<float>(p % tile_w);
    py[k] = static_cast<float>(p / tile_w);
    t0[k] = 1.f;
    tp[k] = 1.f;
  }

  for (long long b0 = 0; b0 < count; b0 += kBatch) {
    __syncthreads();   // the previous batch's readers before these writers
    const int n = static_cast<int>(count - b0 < kBatch ? count - b0 : kBatch);
    if (threadIdx.x < n) {
      const float4* row = reinterpret_cast<const float4*>(
          entries + (start + b0 + threadIdx.x) * 16);
      const float4 r0 = row[0];
      const float2 r1 = *reinterpret_cast<const float2*>(row + 1);
      const int i = threadIdx.x;
      s_geo[0][i] = r0.x - ox;
      s_geo[1][i] = r0.y - oy;
      s_geo[2][i] = r0.z;
      s_geo[3][i] = r0.w;
      s_geo[4][i] = r1.x;
      s_geo[5][i] = r1.y;
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
        gsplat::Alpha a;
        if (!gsplat::eval_alpha(px[k], py[k], mx, my, ca, cb, cc, op,
                                alpha_min, alpha_max, &a))
          continue;
        tp[k] = __fmul_rn(tp[k], __fsub_rn(1.f, a.alpha));
      }
    }
  }

#pragma unroll
  for (int k = 0; k < kPix; ++k) {
    const int p = threadIdx.x + k * kThreads;
    if (p < P)
      t_out[static_cast<long long>(t) * P + p] = __fmul_rn(t0[k], tp[k]);
  }
}

}  // namespace

extern "C" {

// Pixels per tile the kernel takes (kThreads * kPix).
int gsplat_slab_tmit_max_pixels() { return kThreads * kPix; }

// entries (n_rows, 16) f32; tile_start / tile_count (n_tiles,) i32, each
// tile's range starting on a multiple of `chunk`; t_out (n_tiles, P) f32
// with P = tile_h * tile_w <= kThreads * kPix. Launches on `stream` and
// returns the launch's cudaError_t (0 on success).
int gsplat_slab_tmit(const float* entries, long long n_rows,
                     const int* tile_start, const int* tile_count, int n_tiles,
                     int n_tiles_x, int tile_h, int tile_w, int chunk,
                     float alpha_min, float alpha_max, float* t_out,
                     void* stream) {
  if (n_tiles <= 0) return 0;
  if (tile_h * tile_w > kThreads * kPix || chunk <= 0 || n_tiles_x <= 0)
    return cudaErrorInvalidValue;
  slab_tmit_kernel<<<n_tiles, kThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      entries, n_rows, tile_start, tile_count, n_tiles_x, tile_h, tile_w,
      chunk, alpha_min, alpha_max, t_out);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
