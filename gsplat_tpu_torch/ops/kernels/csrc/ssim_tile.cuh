// Shared tile machinery of the fused SSIM kernels (ssim_fwd.cu, ssim_bwd.cu).
//
// A block owns a kTH x kTW tile of one channel's output. It stages its input
// fields on the tile plus a 5-pixel halo (zero outside the image, which is
// the reference's zero padding) in shared memory, then runs the separable
// 11-tap blur in two passes whose taps come from registers:
//   - vertical: a thread owns one halo column and kRows consecutive output
//     rows, and streams the kRows + 10 input rows of its window from shared
//     memory once, each input feeding the accumulators of the (up to 11)
//     outputs whose window holds it; the fields that are products of the
//     inputs (x^2, y^2, xy) are formed in registers as the inputs arrive;
//   - horizontal: a thread owns kRows consecutive outputs of one row and
//     streams the kRows + 10 values of its window from the vertical pass's
//     buffer once, in the same way.
// The staging is asynchronous (cp.async in 16-byte chunks where rows and
// planes are aligned, zero-filled outside the image), so all of a thread's
// copies are in flight at once. Lane i of a warp owns row i in the
// horizontal pass, and every buffer read along a row has an odd pitch, so no
// pass has bank conflicts. The results go through shared memory once more
// so that every device-memory access outside the staging is a whole row
// segment.
//
// Every product and sum is rounded on its own (__fmul_rn / __fadd_rn, no
// FMA, no tensor cores: TF32 makes blur(x^2) - mu^2 go negative and
// split-TF32 gives up the bits), in the plain version's order
// (gsplat_tpu_torch/ops/ssim.py `_blur`: tap 0 to 10, vertical then
// horizontal). Streaming the inputs in order hands each output its taps in
// the order 0 to 10, so a blur here equals the plain blur bit for bit.
#pragma once

#include <cuda_runtime.h>

#include <initializer_list>

namespace ssim {

constexpr int kR = 5;                    // halo: window 11, same padding
constexpr int kTaps = 2 * kR + 1;
constexpr int kTH = 32;                  // output tile rows: a warp's lanes
constexpr int kTW = 64;                  // output tile columns
constexpr int kRows = 8;                 // outputs per thread and pass
constexpr int kThreads = kTH * kTW / kRows;      // one row segment each
constexpr int kSH = kTH + 2 * kR;        // staged rows
constexpr int kSX = 8;                   // staged columns left of the tile:
                                         // >= kR, and 16-byte chunks
constexpr int kSW = kTW + 2 * kSX;       // staged columns (row pitch)
constexpr int kHW = kTW + 2 * kR;        // halo columns the passes read
constexpr int kMP = kHW | 1;             // vertical-pass buffer pitch (odd)
constexpr int kOP = kTW + 1;             // result buffer pitch (odd)
constexpr int kVItems = kHW * (kTH / kRows);     // vertical-pass segments
constexpr int kPix = kTH * kTW / kThreads;       // tile pixels per thread
static_assert(kTH == 32, "the horizontal pass maps lanes to tile rows");
static_assert(kTW % kRows == 0 && kTH % kRows == 0, "whole segments");
static_assert(kSX >= kR && kSX % 4 == 0 && kTW % 4 == 0, "16-byte chunks");

struct Window {
  float w[kTaps];
};

// Floats of shared memory for NIN staged fields and NF blurred fields, with
// NOUT result fields in the space of the staged ones (NOUT_MID: in the
// space of the blurred ones).
__host__ __device__ constexpr int smem_floats(int nin, int nf, int nout,
                                              int nout_mid = 0) {
  return (nin * kSH * kSW > nout * kTH * kOP ? nin * kSH * kSW
                                             : nout * kTH * kOP) +
         (nf * kTH * kMP > nout_mid * kTH * kOP ? nf * kTH * kMP
                                                : nout_mid * kTH * kOP);
}

// shared[dst] <- BYTES (4 or 16) at src, or zeros where !in,
// asynchronously: the copy goes from device memory to shared memory without
// passing through registers, so a thread keeps all its copies in flight.
template <int BYTES>
__device__ __forceinline__ void copy_async(float* dst, const float* src,
                                           bool in) {
#if defined(__CUDA_ARCH__)
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if (BYTES == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
                 "l"(src), "r"(in ? 16 : 0)
                 : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
                 "l"(src), "r"(in ? 4 : 0)
                 : "memory");
#endif
}

// Wait for this thread's asynchronous copies, then for the block's.
__device__ __forceinline__ void copies_done() {
#if defined(__CUDA_ARCH__)
  asm volatile("cp.async.wait_all;\n" ::: "memory");
#endif
  __syncthreads();
}

// Stage the NIN (H, W) planes on the tile at (ox, oy) and its halo into dst
// (NIN, kSH, kSW), staged column j at image column ox - kSX + j, 0 outside
// the image: all copies in flight together, then a barrier. With `vec`
// (W a multiple of 4 and every plane 16-byte aligned) in 16-byte chunks,
// each wholly inside or outside the image; else float by float.
template <int NIN>
__device__ __forceinline__ void stage(const float* const (&planes)[NIN],
                                      int H, int W, int ox, int oy, bool vec,
                                      float* __restrict__ dst) {
  if (vec) {
    constexpr int kChunks = kSW / 4;
    for (int i = threadIdx.x; i < kSH * kChunks; i += kThreads) {
      const int r = i / kChunks, c = (i - r * kChunks) * 4;
      const int gy = oy + r - kR, gx = ox + c - kSX;
      const bool in = gy >= 0 && gy < H && gx >= 0 && gx < W;
      const long long o = in ? static_cast<long long>(gy) * W + gx : 0;
#pragma unroll
      for (int k = 0; k < NIN; ++k)
        copy_async<16>(dst + k * kSH * kSW + r * kSW + c, planes[k] + o, in);
    }
  } else {
    for (int i = threadIdx.x; i < kSH * kSW; i += kThreads) {
      const int r = i / kSW, c = i - r * kSW;
      const int gy = oy + r - kR, gx = ox + c - kSX;
      const bool in = gy >= 0 && gy < H && gx >= 0 && gx < W;
      const long long o = in ? static_cast<long long>(gy) * W + gx : 0;
#pragma unroll
      for (int k = 0; k < NIN; ++k)
        copy_async<4>(dst + k * kSH * kSW + i, planes[k] + o, in);
    }
  }
  copies_done();
}

// acc[j] accumulates output j of a window of kRows outputs; input i of the
// window (i < kRows + 10) is v. Taps arrive in order 0 to 10 per output.
template <int I>
__device__ __forceinline__ void feed(float (&acc)[kRows], float v,
                                     const Window& win) {
#pragma unroll
  for (int j = 0; j < kRows; ++j) {
    constexpr int lo = I - kTaps + 1;
    if (j < lo || j > I) continue;
    const float p = __fmul_rn(win.w[I - j], v);
    acc[j] = (I == j) ? p : __fadd_rn(acc[j], p);
  }
}

template <int I, int NIN, int NF, class Fields>
struct VStep {
  __device__ __forceinline__ static void run(const float* __restrict__ col,
                                             float (&acc)[NF][kRows],
                                             const Window& win,
                                             Fields fields) {
    float in[NIN];
#pragma unroll
    for (int k = 0; k < NIN; ++k) in[k] = col[(k * kSH + I) * kSW];
    float v[NF];
    fields(in, v);
#pragma unroll
    for (int f = 0; f < NF; ++f) feed<I>(acc[f], v[f], win);
    VStep<I + 1, NIN, NF, Fields>::run(col, acc, win, fields);
  }
};
template <int NIN, int NF, class Fields>
struct VStep<kRows + 2 * kR, NIN, NF, Fields> {
  __device__ __forceinline__ static void run(const float* __restrict__,
                                             float (&)[NF][kRows],
                                             const Window&, Fields) {}
};

// mid[f] (kTH, kMP) <- vertical pass of the NF fields that `fields` forms
// from the NIN staged fields src (NIN, kSH, kSW), over the kHW halo columns
// (mid column q: image column ox - kR + q). Ends with a barrier.
template <int NIN, int NF, class Fields>
__device__ __forceinline__ void vertical(const float* __restrict__ src,
                                         float* __restrict__ mid,
                                         const Window& win, Fields fields) {
  for (int it = threadIdx.x; it < kVItems; it += kThreads) {
    const int g = it / kHW, q = it - g * kHW;
    const int r0 = g * kRows;
    float acc[NF][kRows];
    VStep<0, NIN, NF, Fields>::run(src + r0 * kSW + kSX - kR + q, acc, win,
                                   fields);
#pragma unroll
    for (int f = 0; f < NF; ++f)
#pragma unroll
      for (int j = 0; j < kRows; ++j)
        mid[(f * kTH + r0 + j) * kMP + q] = acc[f][j];
  }
  __syncthreads();
}

template <int I, int NF>
struct HStep {
  __device__ __forceinline__ static void run(const float* __restrict__ row,
                                             float (&acc)[NF][kRows],
                                             const Window& win) {
#pragma unroll
    for (int f = 0; f < NF; ++f) feed<I>(acc[f], row[f * kTH * kMP + I], win);
    HStep<I + 1, NF>::run(row, acc, win);
  }
};
template <int NF>
struct HStep<kRows + 2 * kR, NF> {
  __device__ __forceinline__ static void run(const float* __restrict__,
                                             float (&)[NF][kRows],
                                             const Window&) {}
};

// This thread's horizontal segment: tile row r = its lane, columns c0 to
// c0 + kRows - 1.
__device__ __forceinline__ int seg_row() { return threadIdx.x % kTH; }
__device__ __forceinline__ int seg_col() {
  return (threadIdx.x / kTH) * kRows;
}

// acc[f][j] <- horizontal pass of mid[f] at (seg_row, seg_col + j).
template <int NF>
__device__ __forceinline__ void horizontal(const float* __restrict__ mid,
                                           float (&acc)[NF][kRows],
                                           const Window& win) {
  HStep<0, NF>::run(mid + seg_row() * kMP + seg_col(), acc, win);
}

// Pixel k (< kPix) of this thread in the tile: consecutive threads take
// consecutive columns, so every device access is a row segment. Returns its
// device offset, or -1 outside the image; *res_at is its index in a (kTH,
// kOP) result field.
__device__ __forceinline__ long long tile_pixel(int k, int H, int W, int ox,
                                                int oy, int* res_at) {
  const int i = threadIdx.x + k * kThreads;
  const int r = i / kTW, c = i - r * kTW;
  const int gy = oy + r, gx = ox + c;
  *res_at = r * kOP + c;
  return gy < H && gx < W ? static_cast<long long>(gy) * W + gx : -1LL;
}

// fn(k, result index, device offset) for this thread's pixels in the image.
template <class Fn>
__device__ __forceinline__ void for_tile(int H, int W, int ox, int oy,
                                         Fn fn) {
#pragma unroll
  for (int k = 0; k < kPix; ++k) {
    int at;
    const long long o = tile_pixel(k, H, W, ox, oy, &at);
    if (o >= 0) fn(k, at, o);
  }
}

// The SSIM terms from the five blurred fields m = (mu1, mu2, blur x^2,
// blur y^2, blur xy): map = (a b) / (c d), in the plain version's order.
// v1 = blur x^2 - mu1^2 before the variance clamp.
struct Terms {
  float a, b, c, d, v1;
};

__device__ __forceinline__ Terms terms(const float* m, float c1, float c2) {
  const float mu1_sq = __fmul_rn(m[0], m[0]);
  const float mu2_sq = __fmul_rn(m[1], m[1]);
  const float mu1_mu2 = __fmul_rn(m[0], m[1]);
  const float v1 = __fsub_rn(m[2], mu1_sq);
  const float v2 = __fsub_rn(m[3], mu2_sq);
  const float s1 = v1 > 0.f ? v1 : 0.f;
  const float s2 = v2 > 0.f ? v2 : 0.f;
  const float s12 = __fsub_rn(m[4], mu1_mu2);
  Terms o;
  o.a = __fadd_rn(__fmul_rn(2.f, mu1_mu2), c1);
  o.b = __fadd_rn(__fmul_rn(2.f, s12), c2);
  o.c = __fadd_rn(__fadd_rn(mu1_sq, mu2_sq), c1);
  o.d = __fadd_rn(__fadd_rn(s1, s2), c2);
  o.v1 = v1;
  return o;
}

inline Window make_window(const float* window) {
  Window win;
  for (int t = 0; t < kTaps; ++t) win.w[t] = window[t];
  return win;
}

// Whether `stage` may copy 16-byte chunks: rows of a multiple of 4 floats
// (so every plane and row starts on 16 bytes if the tensor does) and
// 16-byte aligned tensors (null ones pass).
inline bool aligned16(int W, std::initializer_list<const float*> ptrs) {
  bool ok = W % 4 == 0;
  for (const float* q : ptrs)
    ok = ok && reinterpret_cast<unsigned long long>(q) % 16 == 0;
  return ok;
}

inline dim3 grid_of(int C, int H, int W) {
  return dim3((W + kTW - 1) / kTW, (H + kTH - 1) / kTH, C);
}

}  // namespace ssim
