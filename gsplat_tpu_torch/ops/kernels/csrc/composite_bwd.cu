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
// What bounds it on this card: operations. Each kept (entry, pixel) pair is
// ~60 f32 operations and an exp, every entry's sums over the tile's pixels
// are a block-wide reduction, and as in the forward most pairs of a small
// splat are misses: the time goes with the pairs evaluated, with what a
// warp spends to learn that an entry has none for it, and with the
// reduction per (warp, entry), not with the 40 B in and 64 B out per row.
//
// What the design does about it: one block per tile (tiles own disjoint
// entry rows, so no atomics), 8 warps, 4 pixels a thread with T, S,
// n_contrib and g_accum in registers (layout in composite_alpha.cuh: with
// tile_w == 32 a warp owns 4 whole tile rows, so a small splat meets few
// warps). Entries are staged in batches of 64 with vector loads, walked
// from the last to the first; the staging thread computes the entry's cull
// rectangle (`cull_rect`) and the mask of warps whose rows it meets. A warp
// turns 32 masks into one ballot and visits only entries that meet its rows
// and rank below its largest n_contrib; with tile_w == 32 it skips a row
// outside the rectangle's y range or past the row's largest n_contrib, and
// lanes outside the x range idle. A hit costs one reciprocal of 1 - alpha
// (for T_j and for S / (1 - alpha)) and adds to 11 per-thread moments:
// sum dp {1, dx, dy, dx^2, dx dy, dy^2}, sum dL/dalpha ex, and the four
// sum w g_accum[c]. Only a warp with a hit reduces: a halving exchange
// (each step a lane keeps half of its values and adds its partner's: 8 + 4
// + 2 + 1 + 1 = 16 shuffles for the 11 padded to 16) leaves each sum on one
// lane pair, which stores it. After the batch one thread per entry adds the
// partials of the warps that had a hit, in warp order, forms d_mean and
// d_conic from the moments and writes the row with vector stores; the
// result is deterministic. The entry rows are double-buffered so that this
// runs beside the next batch's staging: two barriers per 64 entries.
// Like the forward it is bound by instruction rate and latency, so
// __launch_bounds__(256, 3) holds it to 80 registers, 3 blocks (24 warps)
// an SM; 4 blocks at 64 registers spill and are no faster.
// power, exp and alpha are the forward's (`eval_alpha`), and nothing that
// is skipped could pass it, so every pixel keeps exactly the entries the
// forward kept. Tensor cores are not used for the moments: their f32
// accuracy gate (rtol 5e-3 / atol 1e-6 after the shift to the mean
// cancels) rules out TF32, and a bf16 split of a 6-column product does not
// beat plain FFMA.

#include <cuda_runtime.h>

#include "composite_alpha.cuh"

namespace {

using gsplat::kPix;
using gsplat::kWarps;
constexpr int kThreads = 32 * kWarps;      // one block per tile
constexpr int kBatch = 64;                 // entries staged at once
constexpr int kSums = 11;                  // moments reduced per entry
constexpr int kStride = 17;                // s_part row: 16 slots + 1 pad
constexpr unsigned kFull = 0xffffffffu;

// One step of the halving exchange: of 2 * kHalf values a lane keeps the
// half its bit `2 * kHalf` of the lane index selects and adds its
// partner's copy of the same half.
template <int kHalf>
__device__ __forceinline__ void halve(float (&v)[16], int lane) {
  const bool up = lane & (2 * kHalf);
#pragma unroll
  for (int i = 0; i < kHalf; ++i) {
    const float keep = up ? v[i + kHalf] : v[i];
    const float give = up ? v[i] : v[i + kHalf];
    v[i] = keep + __shfl_xor_sync(kFull, give, 2 * kHalf);
  }
}

// Sum each of 16 per-lane values over the warp's 32 lanes with 8 + 4 + 2 +
// 1 + 1 = 16 shuffles. Afterwards v[0] of lane l holds the total of slot
// (l >> 1) & 15, on both lanes of the pair.
__device__ __forceinline__ void warp_sum16(float (&v)[16], int lane) {
  halve<8>(v, lane);
  halve<4>(v, lane);
  halve<2>(v, lane);
  halve<1>(v, lane);
  v[0] += __shfl_xor_sync(kFull, v[0], 1);
}

template <bool kRows32>
__global__ void __launch_bounds__(kThreads, 3)
composite_bwd_kernel(const float* __restrict__ entries, long long n_rows,
                     const int* __restrict__ tile_start,
                     const int* __restrict__ tile_count, int n_tiles_x,
                     int tile_h, int tile_w, float alpha_min, float alpha_max,
                     const float* __restrict__ t_final,
                     const int* __restrict__ n_contrib,
                     const float* __restrict__ g_accum,
                     const float* __restrict__ g_t, int tile_id_base,
                     float* __restrict__ d_entries) {
  // entry rows, double-buffered by batch parity
  __shared__ float4 s_geo[2][kBatch];   // mx-ox, my-oy, conic a, b
  __shared__ float4 s_cut[2][kBatch];   // conic c, opacity, x0|x1<<16, y0|y1<<16
  __shared__ float4 s_col[2][kBatch];   // rgb, invdepth
  __shared__ int s_mask[kBatch];        // warps whose rows the rectangle meets
  __shared__ float s_part[kWarps][kBatch][kStride];   // per-warp sums
  __shared__ unsigned s_hit[kWarps][kBatch / 32];     // entries a warp hit
  __shared__ int s_max[kWarps];
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

  float px[kPix], py[kPix], T[kPix], S[kPix], ga[kPix][4];
  int ix[kPix], iy[kPix], nc[kPix];
  int slot_max[kPix];                   // largest n_contrib of the warp's slot
  int warp_max = 0;
#pragma unroll
  for (int k = 0; k < kPix; ++k) {
    const int p = warp * gsplat::kWarpPix + k * 32 + lane;
    const long long o = static_cast<long long>(t) * P + p;
    ix[k] = p % tile_w;
    iy[k] = p / tile_w;
    px[k] = static_cast<float>(ix[k]);
    py[k] = static_cast<float>(iy[k]);
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
    slot_max[k] = __reduce_max_sync(kFull, nc[k]);
    warp_max = max(warp_max, slot_max[k]);
  }
  if (lane == 0) s_max[warp] = warp_max;
  __syncthreads();
  int tile_max = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) tile_max = max(tile_max, s_max[w]);
  const long long last = tile_max < count ? tile_max : count;

  int buf = 0;
  for (long long j1 = last; j1 > 0; j1 -= kBatch, buf ^= 1) {
    const long long j0 = j1 > kBatch ? j1 - kBatch : 0;
    const int n = static_cast<int>(j1 - j0);
    if (threadIdx.x < n) {
      const int i = threadIdx.x;
      const gsplat::Staged e = gsplat::stage_entry(
          entries + (start + j0 + i) * 16, ox, oy, alpha_min, tile_h, tile_w,
          s_wy0, s_wy1);
      s_geo[buf][i] = e.geo;
      s_cut[buf][i] = e.cut;
      s_col[buf][i] = e.col;
      s_mask[i] = e.mask;
    }
    // also keeps the previous batch's readers of s_part, s_hit and s_mask
    // ahead of this batch's writers
    __syncthreads();

    for (int g = (n - 1) / 32; g >= 0; --g) {
      const int g0 = g * 32;
      const int jl = g0 + lane;
      const int m = jl < n && static_cast<int>(j0) + jl < warp_max
                        ? s_mask[jl] : 0;
      unsigned todo = __ballot_sync(kFull, (m >> warp) & 1);
      unsigned hits = 0;
      while (todo) {
        const int b = 31 - __clz(todo);           // back to front
        todo &= ~(1u << b);
        const int jj = g0 + b;
        const int rank = static_cast<int>(j0) + jj;
        const float4 geo = s_geo[buf][jj];
        const float4 cut = s_cut[buf][jj];
        const float ca = geo.z, cb = geo.w, cc = cut.x, op = cut.y;
        const gsplat::Rect r = gsplat::staged_rect(cut);
        float v[16];
#pragma unroll
        for (int c = 0; c < 16; ++c) v[c] = 0.f;
        bool live = false;
#pragma unroll
        for (int k = 0; k < kPix; ++k) {
          if (kRows32) {                // slot k is tile row 4 * warp + k
            const int row = warp * kPix + k;
            if (rank >= slot_max[k] || row < r.y0 || row > r.y1) continue;
            if (lane < r.x0 || lane > r.x1) continue;
          } else if (ix[k] < r.x0 || ix[k] > r.x1 || iy[k] < r.y0 ||
                     iy[k] > r.y1) {
            continue;
          }
          if (rank >= nc[k]) continue;
          // the forward's alpha, rounded the same way (composite_alpha.cuh)
          gsplat::Alpha a;
          if (!gsplat::eval_alpha(px[k], py[k], geo.x, geo.y, ca, cb, cc, op,
                                  alpha_min, alpha_max, &a))
            continue;
          live = true;
          const float4 col = s_col[buf][jj];
          const float inv = __frcp_rn(__fsub_rn(1.f, a.alpha));
          const float tj = T[k] * inv;                // T before this entry
          const float w = a.alpha * tj;
          const float gc = col.x * ga[k][0] + col.y * ga[k][1]
                           + col.z * ga[k][2] + col.w * ga[k][3];
          const float dl_da = gc * tj - S[k] * inv;
          S[k] += w * gc;
          T[k] = tj;
          const float dp = dl_da * a.a_raw;           // straight through
          const float dpx = dp * a.dx, dpy = dp * a.dy;
          v[0] += dp;
          v[1] += dpx;
          v[2] += dpy;
          v[3] += dpx * a.dx;
          v[4] += dpx * a.dy;
          v[5] += dpy * a.dy;
          v[6] += dl_da * a.ex;
#pragma unroll
          for (int c = 0; c < 4; ++c) v[7 + c] += w * ga[k][c];
        }
        if (!__any_sync(kFull, live)) continue;
        hits |= 1u << b;
        warp_sum16(v, lane);
        const int slot = (lane >> 1) & 15;
        if (!(lane & 1) && slot < kSums) s_part[warp][jj][slot] = v[0];
      }
      if (lane == 0) s_hit[warp][g] = hits;
    }
    __syncthreads();

    if (threadIdx.x < n) {
      const int jj = threadIdx.x;
      const unsigned bit = 1u << (jj % 32);
      float m[kSums];
#pragma unroll
      for (int c = 0; c < kSums; ++c) m[c] = 0.f;
      bool any = false;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) {
        if (!(s_hit[w][jj / 32] & bit)) continue;
        any = true;
#pragma unroll
        for (int c = 0; c < kSums; ++c) m[c] += s_part[w][jj][c];
      }
      if (any) {                        // other rows stay as the caller's 0
        const float4 geo = s_geo[buf][jj];
        const float ca = geo.z, cb = geo.w, cc = s_cut[buf][jj].x;
        float4* out = reinterpret_cast<float4*>(
            d_entries + (start + j0 + jj) * 16);
        out[0] = make_float4(ca * m[1] + cb * m[2], cc * m[2] + cb * m[1],
                             -0.5f * m[3], -m[4]);
        out[1] = make_float4(-0.5f * m[5], m[6], m[7], m[8]);
        *reinterpret_cast<float2*>(out + 2) = make_float2(m[9], m[10]);
      }
    }
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
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (tile_w == 32) {
    composite_bwd_kernel<true><<<n_tiles, kThreads, 0, s>>>(
        entries, n_rows, tile_start, tile_count, n_tiles_x, tile_h, tile_w,
        alpha_min, alpha_max, t_final, n_contrib, g_accum, g_t, tile_id_base,
        d_entries);
  } else {
    composite_bwd_kernel<false><<<n_tiles, kThreads, 0, s>>>(
        entries, n_rows, tile_start, tile_count, n_tiles_x, tile_h, tile_w,
        alpha_min, alpha_max, t_final, n_contrib, g_accum, g_t, tile_id_base,
        d_entries);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
