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

}  // namespace gsplat
