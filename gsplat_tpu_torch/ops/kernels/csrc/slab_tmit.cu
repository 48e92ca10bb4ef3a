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
// t_eps = 0. Depth-slab rendering runs it on every slab but the farthest
// before the real pass: the exclusive product of the nearer slabs' T is the
// transmittance a pixel arrives with, which the compositor's stop test then
// takes as `t_init`. It has no gradient.
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
// What bounds it on this card: operations. An entry row is 24 B read once
// per tile (columns 0-5) against up to 1024 (entry, pixel) evaluations of
// ~18 f32 operations and an exp, and nothing ends early: the kernel walks
// every entry of every tile. Most of those evaluations are misses (a splat
// a few pixels wide touches a minority of a 32x32 tile), so the time goes
// with the evaluations it cannot avoid and with what it spends per (warp,
// entry) to find that there are none.
//
// What the design does about it: the compositor forward's (composite_fwd.cu)
// culling, without its colour and its stop test. One block per tile, 8
// warps, 4 pixels a thread with their two products in registers, in the
// layout of composite_alpha.cuh (with tile_w == 32 a warp owns 4 whole tile
// rows). Entries are staged through shared memory in batches of 256, one
// row per thread, by `stage_geo`: columns 0-5 (one 32-byte sector of the
// 64-byte row; `stage_entry` would read the colour's sector too), the cull
// rectangle and the mask of warps whose rows it meets, through the same
// `stage_geometry` the compositor's kernels stage with, so there is one
// rectangle and `cull_rects_cuda` / `cull_rects_plain` gate this kernel's
// too. The staging thread also stages the entry's chunk index, once per
// row in 32-bit arithmetic. A warp turns 32 masks into one ballot and visits
// only the entries that meet its rows, in order; with tile_w == 32 it skips
// each of its 4 rows outside the rectangle's y range, and lanes outside the
// x range idle; other tile shapes test the rectangle per pixel (kRows32).
// Nothing skipped could have been kept by eval_alpha, so the products that
// happen are those of a kernel without culling. The chunk fold
// t0 *= tp, tp = 1 is exact where tp == 1, so a warp folds when the first
// entry it visits lies in a new chunk (no division per thread, no 64-bit
// `%` per entry and thread as before), and the products happen in the same
// order: the output keeps its bits. Every product is `_rn`, `expf` exact, no
// fast-math. Its state is two floats a pixel, so __launch_bounds__ holds it
// to 40 registers for 6 blocks (48 warps) an SM, at the price of 8-16 B of
// spills.
//
// Measured (NVIDIA H100 80GB HBM3, 700 W; compositor_ab.py, the profiler's
// device time on the 1080p training frame split into 4 depth slabs): the
// kernel that culled nothing (pixels of a warp 8 rows apart, a 64-bit `%`
// per entry and thread) took 0.774 ms on slabs 0-2 and 0.432 on slab 3;
// this one 0.509 and 0.306, with the same bits. Tried and dropped:
//  - other occupancy: 4 blocks an SM (58-60 registers, no spills) 0.514 ms,
//    5 (48) 0.513, 8 (32 registers, 72-104 B of spills) 0.517 and 5% slower
//    on the whole frame: from 4 to 6 blocks within 1%, so latency between
//    warps is not what bounds it; 6 was the fastest by a hair and stays;
//  - a block exit once every pixel's product is exactly 0 (as
//    composite_fwd leaves at t_eps): chip_smoke.py prints the share of
//    pixels whose cut-free T is exactly 0, and it is 0 on every slab and on
//    the whole frame (T reaches 0 only when the product underflows past
//    the f32 denormals, 1.4e-45), so the exit would never fire.

#include <cuda_runtime.h>

#include "composite_alpha.cuh"

namespace {

using gsplat::kPix;
using gsplat::kWarps;
constexpr int kThreads = 32 * kWarps;   // one block per tile
constexpr int kBatch = 256;             // entries staged in shared memory
constexpr unsigned kFull = 0xffffffffu;
// Blocks an SM that __launch_bounds__ holds the registers to (4 to 6 time
// the same; 8 spills and is slower: see above).
constexpr int kMinBlocks = 6;

template <bool kRows32>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
slab_tmit_kernel(const float* __restrict__ entries, long long n_rows,
                 const int* __restrict__ tile_start,
                 const int* __restrict__ tile_count, int n_tiles_x, int tile_h,
                 int tile_w, int chunk, float alpha_min, float alpha_max,
                 float* __restrict__ t_out) {
  __shared__ float4 s_geo[kBatch];   // mx-ox, my-oy, conic a, b
  __shared__ float4 s_cut[kBatch];   // conic c, opacity, packed rectangle
  __shared__ int s_mask[kBatch];     // warps whose rows the rectangle meets
  __shared__ int s_cid[kBatch];      // chunk index of the entry
  __shared__ int s_wy0[kWarps], s_wy1[kWarps];

  const int t = blockIdx.x;
  const int P = tile_h * tile_w;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const long long start = tile_start[t];
  // at most tile_count[t], an int
  const int count =
      static_cast<int>(gsplat::clamp_count(start, tile_count[t], n_rows));
  float ox, oy;
  gsplat::tile_origin(t, 0, n_tiles_x, tile_h, tile_w, &ox, &oy);
  if (threadIdx.x < kWarps)
    gsplat::warp_rows(threadIdx.x, P, tile_w, &s_wy0[threadIdx.x],
                      &s_wy1[threadIdx.x]);

  // T = t0 * tp: t0 at the start of the current chunk, tp within it
  float px[kPix], py[kPix], t0[kPix], tp[kPix];
  int ix[kPix], iy[kPix];
#pragma unroll
  for (int k = 0; k < kPix; ++k) {
    const int p = warp * gsplat::kWarpPix + k * 32 + lane;
    ix[k] = p % tile_w;
    iy[k] = p / tile_w;
    px[k] = static_cast<float>(ix[k]);
    py[k] = static_cast<float>(iy[k]);
    t0[k] = 1.f;
    tp[k] = 1.f;
  }
  int cur = -1;                         // chunk the products in tp belong to

  for (int b0 = 0; b0 < count; b0 += kBatch) {
    // the previous batch's readers before these writers (and s_wy0 / s_wy1
    // before their first reader)
    __syncthreads();
    const int n = count - b0 < kBatch ? count - b0 : kBatch;
    if (threadIdx.x < n) {
      const int i = threadIdx.x;
      const gsplat::StagedGeo e = gsplat::stage_geo(
          entries + (start + b0 + i) * 16, ox, oy, alpha_min, tile_h, tile_w,
          s_wy0, s_wy1);
      s_geo[i] = e.geo;
      s_cut[i] = e.cut;
      s_mask[i] = e.mask;
      s_cid[i] = (b0 + i) / chunk;
    }
    __syncthreads();

    for (int g0 = 0; g0 < n; g0 += 32) {
      const int m = g0 + lane < n ? s_mask[g0 + lane] : 0;
      unsigned todo = __ballot_sync(kFull, (m >> warp) & 1);
      while (todo) {
        const int j = g0 + __ffs(todo) - 1;
        todo &= todo - 1;
        const int cid = s_cid[j];
        if (cid != cur) {               // a new chunk: fold its product in
          cur = cid;
#pragma unroll
          for (int k = 0; k < kPix; ++k) {
            t0[k] = __fmul_rn(t0[k], tp[k]);
            tp[k] = 1.f;
          }
        }
        const float4 geo = s_geo[j];
        const float4 cut = s_cut[j];
        const gsplat::Rect r = gsplat::staged_rect(cut);
#pragma unroll
        for (int k = 0; k < kPix; ++k) {
          if (kRows32) {                // slot k is tile row 4 * warp + k
            const int row = warp * kPix + k;
            if (row < r.y0 || row > r.y1) continue;
            if (lane < r.x0 || lane > r.x1) continue;
          } else if (ix[k] < r.x0 || ix[k] > r.x1 || iy[k] < r.y0 ||
                     iy[k] > r.y1) {
            continue;
          }
          gsplat::Alpha a;
          if (!gsplat::eval_alpha(px[k], py[k], geo.x, geo.y, geo.z, geo.w,
                                  cut.x, cut.y, alpha_min, alpha_max, &a))
            continue;
          tp[k] = __fmul_rn(tp[k], __fsub_rn(1.f, a.alpha));
        }
      }
    }
  }

#pragma unroll
  for (int k = 0; k < kPix; ++k) {
    const int p = warp * gsplat::kWarpPix + k * 32 + lane;
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
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (tile_w == 32) {
    slab_tmit_kernel<true><<<n_tiles, kThreads, 0, s>>>(
        entries, n_rows, tile_start, tile_count, n_tiles_x, tile_h, tile_w,
        chunk, alpha_min, alpha_max, t_out);
  } else {
    slab_tmit_kernel<false><<<n_tiles, kThreads, 0, s>>>(
        entries, n_rows, tile_start, tile_count, n_tiles_x, tile_h, tile_w,
        chunk, alpha_min, alpha_max, t_out);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
