// What the tile compositor's kernels share (composite_fwd.cu,
// composite_bwd.cu, slab_tmit.cu): where a tile lies, which entry rows it
// owns, and the alpha of one (entry, pixel) pair. Kept in one place so that
// every kernel sees bit-identical alphas: the backward keeps exactly the
// entries the forward kept, and the slab transmittance multiplies exactly
// the (1 - alpha) the compositor multiplies.
//
// The arithmetic is the plain version's
// (gsplat_tpu_torch/ops/composite_ref.py), in tile-local coordinates:
//   power = -1/2 (a dx^2 + c dy^2) - b dx dy
//   alpha = min(alpha_max, op * exp(power)), skipped unless power <= 0 and
//   alpha >= alpha_min.
// The _rn intrinsics keep nvcc from contracting products and sums into
// FMAs, so each rounds as the plain version's does; `expf` is the exact f32
// one (the sources build without fast-math).
//
// `cull_rect` bounds, per entry and tile, the pixels `eval_alpha` can keep:
// a rectangle every kernel here tests before it evaluates a pair. It
// only ever drops pairs that `eval_alpha` would reject, so a kernel that
// uses it gives the bits of one that does not. Why it is conservative is
// written at the function. The kernels' pixel layout and the entry row as
// they stage it in shared memory (with its rectangle) follow it: the whole
// row for the compositor (`stage_entry`), its geometry alone for the slab
// transmittance (`stage_geo`), both through one `stage_geometry`.
#pragma once

#include <cuda_runtime.h>

namespace gsplat {

// Pixel origin of tile `t` of a launch whose first tile is tile
// `tile_id_base` of the full grid (a band of tile rows starts past 0).
__device__ __forceinline__ void tile_origin(int t, int tile_id_base,
                                            int n_tiles_x, int tile_h,
                                            int tile_w, float* ox, float* oy) {
  const int gid = tile_id_base + t;
  *ox = static_cast<float>((gid % n_tiles_x) * tile_w);
  *oy = static_cast<float>((gid / n_tiles_x) * tile_h);
}

// The tile's entry count, cut so that no row past the buffer is read,
// whatever the tables say.
__device__ __forceinline__ long long clamp_count(long long start,
                                                 long long count,
                                                 long long n_rows) {
  if (start >= n_rows) return 0;
  return count < n_rows - start ? count : n_rows - start;
}

struct Alpha {
  float dx, dy;   // pixel minus mean, tile-local
  float ex;       // exp(power)
  float a_raw;    // op * exp(power), before the alpha_max clamp
  float alpha;    // min(alpha_max, a_raw)
};

// Evaluate one (entry, pixel) pair. Returns false where the entry is
// skipped for this pixel (power > 0 or alpha < alpha_min); `out` is then
// not to be read. (mx, my) are the entry's mean minus the tile origin.
__device__ __forceinline__ bool eval_alpha(float px, float py, float mx,
                                           float my, float ca, float cb,
                                           float cc, float op, float alpha_min,
                                           float alpha_max, Alpha* out) {
  const float dx = __fsub_rn(px, mx);
  const float dy = __fsub_rn(py, my);
  const float q = __fadd_rn(__fmul_rn(__fmul_rn(ca, dx), dx),
                            __fmul_rn(__fmul_rn(cc, dy), dy));
  const float power = __fsub_rn(__fmul_rn(-0.5f, q),
                                __fmul_rn(__fmul_rn(cb, dx), dy));
  if (!(power <= 0.f)) return false;
  const float ex = expf(power);
  const float a_raw = __fmul_rn(op, ex);
  const float alpha = a_raw > alpha_max ? alpha_max : a_raw;
  if (!(alpha >= alpha_min)) return false;
  out->dx = dx;
  out->dy = dy;
  out->ex = ex;
  out->a_raw = a_raw;
  out->alpha = alpha;
  return true;
}

// Inclusive tile-local pixel bounds; empty where x0 > x1 or y0 > y1.
struct Rect {
  int x0, x1, y0, y1;
};

// The pixels of a tile_h x tile_w tile that `eval_alpha` can keep for the
// entry (mx, my, ca, cb, cc, op), (mx, my) being its mean minus the tile
// origin. A kept pair has a_raw = op * exp(power) >= alpha_min (the
// alpha_max clamp only lowers alpha, and alpha_max >= alpha_min), that is
// q = a dx^2 + 2 b dx dy + c dy^2 <= 2 tau with tau = log(op / alpha_min);
// on that ellipse |dx| <= sqrt(2 tau c / det), |dy| <= sqrt(2 tau a / det),
// det = a c - b^2. What keeps the bound on the safe side of f32 rounding:
//  - tau is raised by 1e-5 relative and absolute, far above the few ulps
//    by which logf, expf and the product op * ex are off; an entry is
//    dropped for the whole tile only where tau < -1e-4 (exp(power) <= 1,
//    so nothing with op < alpha_min is ever kept; padding rows have op 0);
//  - det is lowered by 4e-7 (a c + b^2), more than the rounding of its two
//    products and their difference, so the extents only grow;
//  - eval_alpha's power is off from -q/2 by at most ~6 ulps of
//    a dx^2 + c dy^2 <= 2 kappa q, kappa = a c / det, so q may reach
//    2 tau / (1 - 2e-6 kappa): the extents are scaled by that, and an entry
//    with kappa > 1.25e5 (b within 4e-6 of sqrt(a c)) is not culled;
//  - the half-extents are widened by 1e-4 relative and half a pixel before
//    they are rounded inwards to whole pixels.
// det <= 0, a or c <= 0, alpha_min <= 0 or any non-finite value (NaN and
// infinite rows) give the whole tile: no culling, eval_alpha decides.
// Every product, sum and difference is a round-to-nearest intrinsic, so
// nvcc contracts none into an FMA and the plain version
// (composite_ref.py `cull_rect_plain`) computes the same floats in the same
// order: the rectangle the tests hold to the compositor is this one.
__device__ __forceinline__ Rect cull_rect(float mx, float my, float ca,
                                          float cb, float cc, float op,
                                          float alpha_min, int tile_h,
                                          int tile_w) {
  const Rect full = {0, tile_w - 1, 0, tile_h - 1};
  const Rect none = {0, -1, 0, -1};
  if (!(alpha_min > 0.f)) return full;
  const float tau0 = logf(__fdiv_rn(op, alpha_min));
  if (tau0 < -1e-4f) return none;        // false for NaN: falls through
  const float tau = __fadd_rn(__fmul_rn(fabsf(tau0), 1.f + 1e-5f), 1e-5f);
  const float ac = __fmul_rn(ca, cc), bb = __fmul_rn(cb, cb);
  const float det = __fsub_rn(__fsub_rn(ac, bb),
                              __fmul_rn(4e-7f, __fadd_rn(ac, bb)));
  if (!(ca > 0.f && cc > 0.f && det > 0.f)) return full;
  const float shrink = __fsub_rn(1.f, __fmul_rn(2e-6f, __fdiv_rn(ac, det)));
  if (!(shrink > 0.75f)) return full;
  const float s = __fdiv_rn(__fmul_rn(2.f, tau), __fmul_rn(det, shrink));
  const float hx =
      __fadd_rn(__fmul_rn(sqrtf(__fmul_rn(s, cc)), 1.f + 1e-4f), 0.5f);
  const float hy =
      __fadd_rn(__fmul_rn(sqrtf(__fmul_rn(s, ca)), 1.f + 1e-4f), 0.5f);
  const float xlo = ceilf(__fsub_rn(mx, hx)), xhi = floorf(__fadd_rn(mx, hx));
  const float ylo = ceilf(__fsub_rn(my, hy)), yhi = floorf(__fadd_rn(my, hy));
  // one test for all four: a NaN or an infinity in any makes the sum
  // non-finite (opposite infinities give NaN)
  if (!(fabsf(xlo) + fabsf(xhi) + fabsf(ylo) + fabsf(yhi) < 1e30f))
    return full;
  // clamped on both sides before the conversion: a bound past the far edge
  // of the tile leaves x0 > x1 (or y0 > y1), an empty rectangle
  const float w1 = static_cast<float>(tile_w - 1);
  const float h1 = static_cast<float>(tile_h - 1);
  Rect r;
  r.x0 = static_cast<int>(fminf(fmaxf(xlo, 0.f), w1 + 1.f));
  r.x1 = static_cast<int>(fmaxf(fminf(xhi, w1), -1.f));
  r.y0 = static_cast<int>(fminf(fmaxf(ylo, 0.f), h1 + 1.f));
  r.y1 = static_cast<int>(fmaxf(fminf(yhi, h1), -1.f));
  return r;
}

// The kernels' pixel layout: a block of 8 warps, 4 pixels a thread;
// pixel slot k of lane `lane` of warp `warp` is tile pixel
// warp * 128 + k * 32 + lane. With tile_w == 32 slot k is the 32 pixels of
// tile row 4 * warp + k, so a test on y is one the whole warp takes
// together; for any tile_w a warp owns the tile rows wy0..wy1 below.
constexpr int kWarps = 8;
constexpr int kPix = 4;
constexpr int kWarpPix = 32 * kPix;

// First and last tile row of warp `w`'s pixels (wy0 > wy1: it has none).
__device__ __forceinline__ void warp_rows(int w, int P, int tile_w, int* wy0,
                                          int* wy1) {
  const int first = w * kWarpPix;
  const int end = first + kWarpPix < P ? first + kWarpPix : P;
  *wy0 = first < P ? first / tile_w : 1;
  *wy1 = first < P ? (end - 1) / tile_w : 0;
}

// Bit w set where the rectangle meets a row of warp w (s_wy0 / s_wy1: the
// kWarps row spans, in shared memory). 0 for an empty rectangle; a warp
// that owns no pixel (a tile of fewer than 8 x 128) has no bit.
__device__ __forceinline__ int warp_mask(const Rect& r, const int* s_wy0,
                                         const int* s_wy1) {
  if (r.x0 > r.x1 || r.y0 > r.y1) return 0;
  int m = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w)
    m |= static_cast<int>(s_wy0[w] <= s_wy1[w] && r.y0 <= s_wy1[w] &&
                          r.y1 >= s_wy0[w])
         << w;
  return m;
}

// An entry row's geometry as the kernels stage it in shared memory.
struct StagedGeo {
  float4 geo;   // mean minus tile origin (x, y), conic a, b
  float4 cut;   // conic c, opacity, the cull rectangle as x0 | x1 << 16 and
                // y0 | y1 << 16 (integer bits)
  int mask;     // warp_mask of the rectangle
};

// The staged geometry of the row whose columns 0-3 are r0 and 4-5 are
// (cc, op), with its cull rectangle on the tile at (ox, oy): the one place
// the kernels turn a row into what they test.
__device__ __forceinline__ StagedGeo stage_geometry(
    float4 r0, float cc, float op, float ox, float oy, float alpha_min,
    int tile_h, int tile_w, const int* s_wy0, const int* s_wy1) {
  const float mx = r0.x - ox, my = r0.y - oy;
  const Rect r = cull_rect(mx, my, r0.z, r0.w, cc, op, alpha_min, tile_h,
                           tile_w);
  StagedGeo e;
  e.geo = make_float4(mx, my, r0.z, r0.w);
  e.cut = make_float4(cc, op, __int_as_float(r.x0 | (r.x1 << 16)),
                      __int_as_float(r.y0 | (r.y1 << 16)));
  e.mask = warp_mask(r, s_wy0, s_wy1);
  return e;
}

// Read columns 0-5 of one (16-float, 64-byte aligned) entry row, the first
// 24 bytes (one 32-byte sector), and stage its geometry: what a kernel that
// needs no colour reads.
__device__ __forceinline__ StagedGeo stage_geo(const float* row16, float ox,
                                               float oy, float alpha_min,
                                               int tile_h, int tile_w,
                                               const int* s_wy0,
                                               const int* s_wy1) {
  const float4* row = reinterpret_cast<const float4*>(row16);
  const float4 r0 = row[0];
  const float2 r1 = *reinterpret_cast<const float2*>(row + 1);
  return stage_geometry(r0, r1.x, r1.y, ox, oy, alpha_min, tile_h, tile_w,
                        s_wy0, s_wy1);
}

// An entry row as the compositor's kernels stage it in shared memory.
struct Staged {
  float4 geo;   // as StagedGeo
  float4 cut;
  float4 col;   // rgb, invdepth
  int mask;
};

// Read columns 0-9 of one (16-float, 64-byte aligned) entry row and work
// out its cull rectangle on the tile at (ox, oy).
__device__ __forceinline__ Staged stage_entry(const float* row16, float ox,
                                              float oy, float alpha_min,
                                              int tile_h, int tile_w,
                                              const int* s_wy0,
                                              const int* s_wy1) {
  const float4* row = reinterpret_cast<const float4*>(row16);
  const float4 r0 = row[0];
  const float4 r1 = row[1];
  const float2 r2 = *reinterpret_cast<const float2*>(row + 2);
  const StagedGeo g = stage_geometry(r0, r1.x, r1.y, ox, oy, alpha_min,
                                     tile_h, tile_w, s_wy0, s_wy1);
  Staged e;
  e.geo = g.geo;
  e.cut = g.cut;
  e.col = make_float4(r1.z, r1.w, r2.x, r2.y);
  e.mask = g.mask;
  return e;
}

// The rectangle packed into Staged::cut (bounds are -1..1024: x1 and y1
// come back through the arithmetic shift with their sign).
__device__ __forceinline__ Rect staged_rect(const float4& cut) {
  const int xs = __float_as_int(cut.z), ys = __float_as_int(cut.w);
  const Rect r = {xs & 0xffff, xs >> 16, ys & 0xffff, ys >> 16};
  return r;
}

}  // namespace gsplat
