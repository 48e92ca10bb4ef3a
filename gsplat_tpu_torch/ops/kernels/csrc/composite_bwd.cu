// Tile compositor backward for Hopper (sm_90a).
//
// Replaces two TPU kernels of the same semantics: gsplat_tpu/ops/pallas/
// composite_stream.py `_bwd_strip_kernel` (reached through
// `composite_bwd_stream`), "vpu" form, and composite.py `_bwd_kernel`
// (reached through `_composite_bwd_call`), the gradient of the forward that
// takes `t_init` and `tile_id_base`. It needs no `t_init`: n_contrib
// already encodes where each pixel stopped, and the replay starts from the
// forward's own t_final, in the unit-T space the forward accumulates in.
// Tile t lies where tile `tile_id_base + t` of the full grid lies. It
// computes what autograd through the plain version
// gsplat_tpu_torch/ops/composite_ref.py `composite_tiles_plain` computes:
// from the forward's t_final and n_contrib and the cotangents g_accum
// (T,4,P) and g_t (T,P), the per-entry gradient rows d_entries (M,16),
// columns 0-9 = d_mx, d_my, d_conic a, b, c, d_opacity, d_rgb, d_invdepth.
// An entry counts for a pixel only if its in-tile rank < n_contrib of the
// pixel, power <= 0 and alpha >= alpha_min; the gradient passes straight
// through the alpha_max clamp (d alpha / d power = op exp(power) and
// d alpha / d op = exp(power) even where alpha = alpha_max). Rows past the
// tile's largest n_contrib, padding and tail rows are left as the caller
// zeroed them.
//
// Per pixel, with S_j = sum_{k>j} w_k gc_k + g_t T_final (gc = g_accum .
// color, w = T alpha), dL/dalpha_j = gc_j T_j - S_j / (1 - alpha_j). The
// TPU kernel replays front to back and forms S_j as p0 - cum_incl + g_t T
// (p0 = g_accum . accum): a difference of two sums of O(1) that cancels
// where T is small. Deep pixels (hundreds of contributors, as at 1080p)
// then lose ~1e-6 absolutely, which fails the gradient gate (rtol 5e-3,
// atol 1e-6) against autograd (tests/test_torch_composite_bwd.py measures
// both orders). This kernel replays back to front instead, as the
// reference CUDA rasterizer does: T starts at t_final, T_j = T_{j+1} /
// (1 - alpha_j) recovers each entry's transmittance to a few ulps, and S
// is summed from the back, so no sum cancels.
//
// What bounds it on this card: each (entry, pixel) evaluation is about 60
// f32 operations and one exp, and every entry's 10 sums over the tile's
// pixels are a block-wide reduction. At 1080p the evaluations outweigh the
// bytes (40 B in and 64 B out per entry row) ~30x: bound by operations.
//
// What the design does about it: one block per tile (tiles own disjoint
// entry rows, so no atomics), 256 threads, 4 pixels each with T, S, n_contrib
// and g_accum in registers; a warp's pixels are 4 rows of 32 (compact, so a
// small splat touches few warps). Entries are staged through shared memory
// in batches of 32, walked from the last to the first; per entry each
// thread sums its 4 pixels, a warp with a live pixel reduces its 10 sums by
// shuffles (a warp without one writes zeros), and after the batch the 8
// warp partials are summed in a fixed order, so the result is
// deterministic. power, exp and alpha use the forward's round-to-nearest
// arithmetic, so every pixel keeps exactly the entries the forward kept.

#include <cuda_runtime.h>

#include "composite_alpha.cuh"

namespace {

constexpr int kThreads = 256;              // one block per tile
constexpr int kWarps = kThreads / 32;
constexpr int kPix = 4;                    // pixels per thread: P <= 1024
constexpr int kBatch = 32;                 // entries staged at once
constexpr int kCols = 10;                  // gradient columns written

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__global__ void __launch_bounds__(kThreads)
composite_bwd_kernel(const float* __restrict__ entries, long long n_rows,
                     const int* __restrict__ tile_start,
                     const int* __restrict__ tile_count, int n_tiles_x,
                     int tile_h, int tile_w, float alpha_min, float alpha_max,
                     const float* __restrict__ t_final,
                     const int* __restrict__ n_contrib,
                     const float* __restrict__ g_accum,
                     const float* __restrict__ g_t, int tile_id_base,
                     float* __restrict__ d_entries) {
  __shared__ float s_ent[kCols][kBatch];          // tile-local rows
  __shared__ float s_part[kWarps][kBatch][kCols]; // per-warp sums
  __shared__ int s_max[kWarps];

  const int t = blockIdx.x;
  const int P = tile_h * tile_w;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const long long start = tile_start[t];
  const long long count = gsplat::clamp_count(start, tile_count[t], n_rows);
  float ox, oy;
  gsplat::tile_origin(t, tile_id_base, n_tiles_x, tile_h, tile_w, &ox, &oy);

  float px[kPix], py[kPix], T[kPix], S[kPix], ga[kPix][4];
  int nc[kPix];
  int my_max = 0;
#pragma unroll
  for (int k = 0; k < kPix; ++k) {
    const int p = warp * (32 * kPix) + k * 32 + lane;
    const long long o = static_cast<long long>(t) * P + p;
    px[k] = static_cast<float>(p % tile_w);
    py[k] = static_cast<float>(p / tile_w);
    nc[k] = 0;
    T[k] = 1.f;
    S[k] = 0.f;
#pragma unroll
    for (int c = 0; c < 4; ++c) ga[k][c] = 0.f;
    if (p < P) {
      nc[k] = n_contrib[o];
      T[k] = t_final[o];
      S[k] = g_t[o] * T[k];
#pragma unroll
      for (int c = 0; c < 4; ++c)
        ga[k][c] = g_accum[(static_cast<long long>(t) * 4 + c) * P + p];
    }
    my_max = max(my_max, nc[k]);
  }
  my_max = __reduce_max_sync(0xffffffffu, my_max);
  if (lane == 0) s_max[warp] = my_max;
  __syncthreads();
  int tile_max = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) tile_max = max(tile_max, s_max[w]);
  const long long last = tile_max < count ? tile_max : count;

  for (long long j1 = last; j1 > 0; j1 -= kBatch) {
    const long long j0 = j1 > kBatch ? j1 - kBatch : 0;
    const int n = static_cast<int>(j1 - j0);
    if (threadIdx.x < n) {
      const float* row = entries + (start + j0 + threadIdx.x) * 16;
      const int i = threadIdx.x;
      s_ent[0][i] = row[0] - ox;
      s_ent[1][i] = row[1] - oy;
#pragma unroll
      for (int c = 2; c < kCols; ++c) s_ent[c][i] = row[c];
    }
    __syncthreads();

    for (int jj = n - 1; jj >= 0; --jj) {
      const int rank = static_cast<int>(j0) + jj;
      const float mx = s_ent[0][jj], my = s_ent[1][jj];
      const float ca = s_ent[2][jj], cb = s_ent[3][jj], cc = s_ent[4][jj];
      const float op = s_ent[5][jj];
      float sum[kCols];
#pragma unroll
      for (int c = 0; c < kCols; ++c) sum[c] = 0.f;
      bool live = false;
#pragma unroll
      for (int k = 0; k < kPix; ++k) {
        if (rank >= nc[k]) continue;
        // the forward's alpha, rounded the same way (composite_alpha.cuh)
        gsplat::Alpha a;
        if (!gsplat::eval_alpha(px[k], py[k], mx, my, ca, cb, cc, op,
                                alpha_min, alpha_max, &a))
          continue;
        const float dx = a.dx, dy = a.dy, ex = a.ex, a_raw = a.a_raw;
        const float alpha = a.alpha;
        live = true;
        const float one_m = __fsub_rn(1.f, alpha);
        const float tj = __fdiv_rn(T[k], one_m);     // T before this entry
        const float w = alpha * tj;
        const float gc = s_ent[6][jj] * ga[k][0] + s_ent[7][jj] * ga[k][1]
                         + s_ent[8][jj] * ga[k][2] + s_ent[9][jj] * ga[k][3];
        const float dl_da = gc * tj - S[k] / one_m;
        S[k] += w * gc;
        T[k] = tj;
        const float dp = dl_da * a_raw;               // straight through
        sum[0] += dp * (ca * dx + cb * dy);
        sum[1] += dp * (cc * dy + cb * dx);
        sum[2] += -0.5f * dp * dx * dx;
        sum[3] += -dp * dx * dy;
        sum[4] += -0.5f * dp * dy * dy;
        sum[5] += dl_da * ex;
#pragma unroll
        for (int c = 0; c < 4; ++c) sum[6 + c] += w * ga[k][c];
      }
      if (__any_sync(0xffffffffu, live)) {
#pragma unroll
        for (int c = 0; c < kCols; ++c) sum[c] = warp_sum(sum[c]);
      }
      if (lane == 0) {
#pragma unroll
        for (int c = 0; c < kCols; ++c) s_part[warp][jj][c] = sum[c];
      }
    }
    __syncthreads();

    for (int i = threadIdx.x; i < n * kCols; i += kThreads) {
      const int jj = i / kCols, c = i % kCols;
      float v = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) v += s_part[w][jj][c];
      d_entries[(start + j0 + jj) * 16 + c] = v;
    }
    // the next batch's staging overwrites s_ent only; its compute phase
    // writes s_part after the barrier that follows the staging
  }
}

}  // namespace

extern "C" {

// Pixels per tile the kernel takes.
int gsplat_composite_bwd_max_pixels() { return kThreads * kPix; }

// entries (n_rows, 16) f32; tile_start / tile_count (n_tiles,) i32;
// t_final (n_tiles, P) f32 and n_contrib (n_tiles, P) i32 from the forward;
// g_accum (n_tiles, 4, P) and g_t (n_tiles, P) f32 cotangents; d_entries
// (n_rows, 16) f32, zeroed by the caller. P = tile_h * tile_w <= 1024;
// tile_id_base the full-grid id of the launch's tile 0. Launches on
// `stream` and returns the launch's cudaError_t (0 on success).
int gsplat_composite_bwd(const float* entries, long long n_rows,
                         const int* tile_start, const int* tile_count,
                         int n_tiles, int n_tiles_x, int tile_h, int tile_w,
                         float alpha_min, float alpha_max,
                         const float* t_final, const int* n_contrib,
                         const float* g_accum, const float* g_t,
                         int tile_id_base, float* d_entries, void* stream) {
  if (n_tiles <= 0) return 0;
  if (tile_h * tile_w > kThreads * kPix || n_tiles_x <= 0 || tile_id_base < 0)
    return cudaErrorInvalidValue;
  composite_bwd_kernel<<<n_tiles, kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      entries, n_rows, tile_start, tile_count, n_tiles_x, tile_h, tile_w,
      alpha_min, alpha_max, t_final, n_contrib, g_accum, g_t, tile_id_base,
      d_entries);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
