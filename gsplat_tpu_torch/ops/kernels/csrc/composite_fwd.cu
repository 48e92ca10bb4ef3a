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
// What bounds it on this card: operations. An entry row is 40 B read once
// per tile against up to 1024 (entry, pixel) evaluations of ~30
// operations and an exp each, and most of those evaluations are misses:
// a splat a few pixels wide touches a minority of a 32x32 tile's pixels.
// So the time goes with the evaluations the kernel cannot avoid and with
// what it spends per (warp, entry) to find that there are none.
//
// What the design does about it: one block per tile, 8 warps, 4 pixels a
// thread with T, accum and the last contributor in registers (layout in
// composite_alpha.cuh: with tile_w == 32 a warp owns 4 whole tile rows).
// Entries are staged through shared memory in batches of 256, one row per
// thread; the staging thread also computes the entry's cull rectangle
// (`cull_rect`: outside it eval_alpha rejects every pixel), the mask of
// warps whose rows it meets, and the entry's chunk index. A warp turns 32
// masks into one ballot and visits only the entries that meet its rows, in
// order; with tile_w == 32 it then skips each of its 4 rows that lies
// outside the rectangle's y range, and lanes outside the x range idle (a
// row whose 32 pixels are all done falls through on its `done` flags alike:
// a vote to skip it sooner bought nothing); other tile shapes test the
// rectangle per pixel. Nothing that is skipped could have
// contributed, so the result has the bits of a kernel without culling.
// Before each batch the block counts its finished threads
// (__syncthreads_count) and leaves once all pixels are done. Transmittance
// is kept as (T at the start of the G-entry chunk) x (product within the
// chunk), with round-to-nearest intrinsics and exact f32 `expf` (no
// fast-math, no FMA contraction), so it rounds as the plain version's
// per-chunk cumprod does and the early-termination test stops every pixel
// at the same entry. The fold t0 *= tp, tp = 1 at a chunk's start is exact
// where tp == 1, so a warp folds when the first entry it visits lies in a
// new chunk (a staged index, no division per thread) and the products that
// happen are the same in the same order. `t_init` is read once per pixel
// into a register, and whether there is one is a template parameter.
// The kernel is bound by instruction rate and latency (exp, shared-memory
// broadcasts), so warps in flight count: __launch_bounds__(256, 4) holds it
// to 64 registers, 4 blocks (32 warps) an SM, at the price of a few spilled
// words. Tiles are handed out in index order: longest first (an order
// array from a device-side rank of tile_count in the same call) took 3% off
// this kernel on the 1080p frame and gave it back on shorter launches.
// Not used, and why: the entry rows are 32 MB per 1080p frame, 0.01 ms of
// memory time, behind one barrier per 256 entries, so TMA or cp.async
// rings have nothing to hide; the evaluation is a 6-column quadratic form
// per pixel in f32 whose shift to the mean cancels, which rules out TF32
// and leaves a bf16 split on the tensor cores slower than plain FFMA.

#include <cuda_runtime.h>

#include "composite_alpha.cuh"

namespace {

using gsplat::kPix;
using gsplat::kWarps;
constexpr int kThreads = 32 * kWarps;   // one block per tile
constexpr int kBatch = 256;             // entries staged in shared memory
constexpr unsigned kFull = 0xffffffffu;

template <bool kHasTInit, bool kRows32>
__global__ void __launch_bounds__(kThreads, 4)
composite_fwd_kernel(const float* __restrict__ entries, long long n_rows,
                     const int* __restrict__ tile_start,
                     const int* __restrict__ tile_count, int n_tiles_x,
                     int tile_h, int tile_w, int chunk, float alpha_min,
                     float alpha_max, float t_eps,
                     const float* __restrict__ t_init, int tile_id_base,
                     float* __restrict__ accum,
                     float* __restrict__ t_final, int* __restrict__ n_contrib) {
  __shared__ float4 s_geo[kBatch];   // mx-ox, my-oy, conic a, b
  __shared__ float4 s_cut[kBatch];   // conic c, opacity, x0 | x1<<16, y0 | y1<<16
  __shared__ float4 s_col[kBatch];   // rgb, invdepth
  __shared__ int s_mask[kBatch];     // warps whose rows the rectangle meets
  __shared__ int s_cid[kBatch];      // chunk index of the entry
  __shared__ int s_wy0[kWarps], s_wy1[kWarps];

  const int t = blockIdx.x;
  const int P = tile_h * tile_w;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const long long start = tile_start[t];
  const long long count = gsplat::clamp_count(start, tile_count[t], n_rows);
  float ox, oy;
  gsplat::tile_origin(t, tile_id_base, n_tiles_x, tile_h, tile_w, &ox, &oy);
  if (threadIdx.x < kWarps)
    gsplat::warp_rows(threadIdx.x, P, tile_w, &s_wy0[threadIdx.x],
                      &s_wy1[threadIdx.x]);

  // Per pixel: t0 = transmittance at the start of the current G-entry
  // chunk, tp = product of (1 - alpha) of this chunk's contributors so far.
  // T = t0 * tp, associated as the plain version's per-chunk cumprod.
  float px[kPix], py[kPix], t0[kPix], tp[kPix], acc[kPix][4];
  float ti[kPix];                       // t_init of the pixel; unused without
  int ix[kPix], iy[kPix];
  int last[kPix];
  bool done[kPix];
#pragma unroll
  for (int k = 0; k < kPix; ++k) {
    const int p = warp * gsplat::kWarpPix + k * 32 + lane;
    done[k] = p >= P;
    ix[k] = p % tile_w;
    iy[k] = p / tile_w;
    px[k] = static_cast<float>(ix[k]);
    py[k] = static_cast<float>(iy[k]);
    t0[k] = 1.f;
    tp[k] = 1.f;
    acc[k][0] = acc[k][1] = acc[k][2] = acc[k][3] = 0.f;
    last[k] = 0;
    ti[k] = 1.f;
    if (kHasTInit && p < P) ti[k] = t_init[static_cast<long long>(t) * P + p];
  }
  int cur = -1;                         // chunk the products in tp belong to

  for (long long b0 = 0; b0 < count; b0 += kBatch) {
    bool mine_done = true;
#pragma unroll
    for (int k = 0; k < kPix; ++k) mine_done = mine_done && done[k];
    // also the barrier that keeps the previous batch's readers ahead of
    // this batch's writers (and s_wy0 / s_wy1 ahead of their first reader)
    if (__syncthreads_count(mine_done) == kThreads) break;

    const int n = static_cast<int>(count - b0 < kBatch ? count - b0 : kBatch);
    if (threadIdx.x < n) {
      const int i = threadIdx.x;
      const gsplat::Staged e = gsplat::stage_entry(
          entries + (start + b0 + i) * 16, ox, oy, alpha_min, tile_h, tile_w,
          s_wy0, s_wy1);
      s_geo[i] = e.geo;
      s_cut[i] = e.cut;
      s_col[i] = e.col;
      s_mask[i] = e.mask;
      s_cid[i] = static_cast<int>((b0 + i) / chunk);
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
          if (done[k]) continue;
          gsplat::Alpha a;
          if (!gsplat::eval_alpha(px[k], py[k], geo.x, geo.y, geo.z, geo.w,
                                  cut.x, cut.y, alpha_min, alpha_max, &a))
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
          const float4 col = s_col[j];
          acc[k][0] += w * col.x;
          acc[k][1] += w * col.y;
          acc[k][2] += w * col.z;
          acc[k][3] += w * col.w;
          tp[k] = __fmul_rn(tp[k], one_m);
          last[k] = static_cast<int>(b0) + j + 1;
        }
      }
    }
  }

#pragma unroll
  for (int k = 0; k < kPix; ++k) {
    const int p = warp * gsplat::kWarpPix + k * 32 + lane;
    if (p >= P) continue;
    const long long o = static_cast<long long>(t) * P + p;
#pragma unroll
    for (int c = 0; c < 4; ++c)
      accum[(static_cast<long long>(t) * 4 + c) * P + p] = acc[k][c];
    t_final[o] = __fmul_rn(t0[k], tp[k]);
    n_contrib[o] = last[k];
  }
}

// What the compositor's kernels stage for every entry row of every tile:
// the cull rectangle as they unpack it and the warp mask, for the tests.
// One block per tile; rects is (n_rows, 5) int: x0, x1, y0, y1, mask.
__global__ void cull_rects_kernel(const float* __restrict__ entries,
                                  long long n_rows,
                                  const int* __restrict__ tile_start,
                                  const int* __restrict__ tile_count,
                                  int n_tiles_x, int tile_h, int tile_w,
                                  float alpha_min, int tile_id_base,
                                  int* __restrict__ rects) {
  __shared__ int s_wy0[kWarps], s_wy1[kWarps];
  const int t = blockIdx.x;
  const long long start = tile_start[t];
  const long long count = gsplat::clamp_count(start, tile_count[t], n_rows);
  float ox, oy;
  gsplat::tile_origin(t, tile_id_base, n_tiles_x, tile_h, tile_w, &ox, &oy);
  if (threadIdx.x < kWarps)
    gsplat::warp_rows(threadIdx.x, tile_h * tile_w, tile_w,
                      &s_wy0[threadIdx.x], &s_wy1[threadIdx.x]);
  __syncthreads();
  for (long long i = threadIdx.x; i < count; i += kThreads) {
    const gsplat::Staged e = gsplat::stage_entry(
        entries + (start + i) * 16, ox, oy, alpha_min, tile_h, tile_w, s_wy0,
        s_wy1);
    const gsplat::Rect r = gsplat::staged_rect(e.cut);
    int* out = rects + (start + i) * 5;
    out[0] = r.x0;
    out[1] = r.x1;
    out[2] = r.y0;
    out[3] = r.y1;
    out[4] = e.mask;
  }
}

template <bool kHasTInit>
void launch(bool rows32, int n_tiles, cudaStream_t s,
            const float* entries, long long n_rows, const int* tile_start,
            const int* tile_count, int n_tiles_x, int tile_h, int tile_w,
            int chunk, float alpha_min, float alpha_max, float t_eps,
            const float* t_init, int tile_id_base, float* accum,
            float* t_final, int* n_contrib) {
  if (rows32) {
    composite_fwd_kernel<kHasTInit, true><<<n_tiles, kThreads, 0, s>>>(
        entries, n_rows, tile_start, tile_count, n_tiles_x, tile_h, tile_w,
        chunk, alpha_min, alpha_max, t_eps, t_init, tile_id_base, accum,
        t_final, n_contrib);
  } else {
    composite_fwd_kernel<kHasTInit, false><<<n_tiles, kThreads, 0, s>>>(
        entries, n_rows, tile_start, tile_count, n_tiles_x, tile_h, tile_w,
        chunk, alpha_min, alpha_max, t_eps, t_init, tile_id_base, accum,
        t_final, n_contrib);
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
  const bool rows32 = tile_w == 32;
  if (t_init != nullptr) {
    launch<true>(rows32, n_tiles, s, entries, n_rows, tile_start, tile_count,
                 n_tiles_x, tile_h, tile_w, chunk, alpha_min, alpha_max,
                 t_eps, t_init, tile_id_base, accum, t_final, n_contrib);
  } else {
    launch<false>(rows32, n_tiles, s, entries, n_rows, tile_start, tile_count,
                  n_tiles_x, tile_h, tile_w, chunk, alpha_min, alpha_max,
                  t_eps, nullptr, tile_id_base, accum, t_final, n_contrib);
  }
  return static_cast<int>(cudaGetLastError());
}

// The staged cull rectangle and warp mask of every entry row in a tile's
// range, into rects (n_rows, 5) i32 (rows no tile owns are left as they
// are): what the tests hold to the plain rectangle. Not on any render path.
int gsplat_composite_cull_rects(const float* entries, long long n_rows,
                                const int* tile_start, const int* tile_count,
                                int n_tiles, int n_tiles_x, int tile_h,
                                int tile_w, float alpha_min, int tile_id_base,
                                int* rects, void* stream) {
  if (n_tiles <= 0) return 0;
  if (tile_h * tile_w > kThreads * kPix || n_tiles_x <= 0 || tile_id_base < 0)
    return cudaErrorInvalidValue;
  cull_rects_kernel<<<n_tiles, kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      entries, n_rows, tile_start, tile_count, n_tiles_x, tile_h, tile_w,
      alpha_min, tile_id_base, rects);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
