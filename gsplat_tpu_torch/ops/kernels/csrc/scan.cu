// Blocked (M,16) prefix sums for Hopper (sm_90a): inclusive sums down the
// rows of a row-major (M,16) f32 array, restarting every L rows, and each
// L-block's column totals.
//
// Replaces the TPU kernel gsplat_tpu/ops/pallas/scan.py `_scan_kernel`
// (reached through `blocked_cumsum_16`), and computes the same as the plain
// version gsplat_tpu_torch/ops/kernels/scan.py `blocked_cumsum_16_plain`:
//   intra[b*L + r, c]  = sum of x[b*L .. b*L + r, c]      (r < L)
//   block_tot[b, c]    = intra[b*L + L - 1, c]
// The sharded ring backward (parallel/sharded.py) takes a gaussian's
// gradient as the difference of two prefix values of the presort-ordered
// entry gradients, so the scan's rounding lands directly on gradients; the
// restart every L rows keeps the running sums small (the chain over blocks
// is added outside, ops/rasterize.py `_blocked_prefix`).
//
// The TPU kernel folds 8 rows into the 128 lanes of a vector register and
// multiplies by 0/1 matrices, because a 16-wide scan wastes 7/8 of that
// register. None of that carries over: here 16 columns are half a warp and
// a row is 64 contiguous bytes.
//
// What bounds it on this card: bytes. Every row is read once and written
// once (128 B) against 16 additions, so the least time is the array's bytes
// twice over the memory rate.
//
// What the design does about it: one block of 256 threads per L-block,
// walking it in tiles of 256 rows. Thread (s, c) = (tid / 16, tid % 16)
// owns the 16 consecutive rows of segment s in column c: it reads them
// straight from device memory (the 16 threads of a segment read the 64
// contiguous bytes of one row, so every 32-byte sector that moves is used
// whole), scans them in registers, and hands its total to shared memory.
// The 16 segment totals of a column are then scanned with warp shuffles of
// width 16 by the thread group (c, 0..15), which also carries the column's
// running sum from tile to tile in a register. The next tile's rows are
// loaded before the current one is scanned, so the loads overlap the two
// barriers of a tile. No atomics; the order of the additions is fixed:
//   out = (carry + sum of earlier segments' totals) + sum within the segment
// so two launches on one input give the same bits, and an input whose
// partial sums are integers below 2^24 comes out exact.
// The grid is M / L blocks: at a few hundred thousand rows that is less
// than one block per SM; a later redesign splits the L-blocks further.

#include <cuda_runtime.h>

namespace {

constexpr int kCols = 16;                 // columns of the array
constexpr int kSegs = 16;                 // segments per tile
constexpr int kSegRows = 16;              // consecutive rows per thread
constexpr int kThreads = kCols * kSegs;   // 256
constexpr int kTileRows = kSegs * kSegRows;
constexpr int kPad = kSegs + 1;           // shared-memory stride per column
constexpr unsigned kFull = 0xffffffffu;

// The thread's 16 rows of the tile starting at block row r0; rows at or
// past L read as 0.
__device__ __forceinline__ void load_rows(const float* __restrict__ xb, int r0,
                                          int L, int c, float (&v)[kSegRows]) {
#pragma unroll
  for (int i = 0; i < kSegRows; ++i) {
    const int r = r0 + i;
    v[i] = r < L ? xb[static_cast<long long>(r) * kCols + c] : 0.f;
  }
}

__global__ void __launch_bounds__(kThreads)
scan_kernel(const float* __restrict__ x, int L, float* __restrict__ intra,
            float* __restrict__ block_tot) {
  __shared__ float s_tot[kCols * kPad];   // [column][segment] totals
  __shared__ float s_off[kCols * kPad];   // [column][segment] offsets

  const int tid = threadIdx.x;
  const int s = tid / kCols, c = tid % kCols;      // row role
  const int sc = tid / kSegs, ss = tid % kSegs;    // scan role: column, seg
  const long long base = static_cast<long long>(blockIdx.x) * L * kCols;
  const float* xb = x + base;
  float* ob = intra + base;
  const int n_tiles = (L + kTileRows - 1) / kTileRows;

  float carry = 0.f;   // scan role: column sc's sum over the earlier tiles
  float cur[kSegRows], nxt[kSegRows];
  load_rows(xb, s * kSegRows, L, c, cur);

  for (int t = 0; t < n_tiles; ++t) {
    const int r0 = t * kTileRows + s * kSegRows;
    if (t + 1 < n_tiles) load_rows(xb, r0 + kTileRows, L, c, nxt);

#pragma unroll
    for (int i = 1; i < kSegRows; ++i) cur[i] += cur[i - 1];
    s_tot[c * kPad + s] = cur[kSegRows - 1];
    __syncthreads();

    // inclusive scan of column sc's 16 segment totals, over lanes ss
    float incl = s_tot[sc * kPad + ss];
#pragma unroll
    for (int d = 1; d < kSegs; d *= 2) {
      const float up = __shfl_up_sync(kFull, incl, d, kSegs);
      if (ss >= d) incl += up;
    }
    const float excl = __shfl_up_sync(kFull, incl, 1, kSegs);
    const float tile_total = __shfl_sync(kFull, incl, kSegs - 1, kSegs);
    s_off[sc * kPad + ss] = ss == 0 ? carry : carry + excl;
    carry += tile_total;
    __syncthreads();

    const float off = s_off[c * kPad + s];
#pragma unroll
    for (int i = 0; i < kSegRows; ++i) {
      const int r = r0 + i;
      if (r < L) {
        const float out = off + cur[i];
        ob[static_cast<long long>(r) * kCols + c] = out;
        if (r == L - 1)
          block_tot[static_cast<long long>(blockIdx.x) * kCols + c] = out;
      }
    }
    if (t + 1 < n_tiles) {
#pragma unroll
      for (int i = 0; i < kSegRows; ++i) cur[i] = nxt[i];
    }
  }
}

}  // namespace

extern "C" {

// x, intra (m, 16) f32 row-major; block_tot (m / L, 16) f32; m a multiple of
// L. Launches on `stream` and returns the launch's cudaError_t (0 on
// success).
int gsplat_scan(const float* x, long long m, int L, float* intra,
                float* block_tot, void* stream) {
  if (m == 0) return 0;
  if (L <= 0 || m < 0 || m % L != 0 || m / L > 2147483647LL)
    return cudaErrorInvalidValue;
  scan_kernel<<<static_cast<unsigned>(m / L), kThreads, 0,
                static_cast<cudaStream_t>(stream)>>>(x, L, intra, block_tot);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
