// The entry gather's gradient for Hopper (sm_90a): d packed (N+1, 16) from
// d entries (M, 16), the backward of csrc/gather_entries_fwd.cu.
//
// Replaces no TPU kernel: the JAX package leaves the gradient to XLA's
// scatter-add. In PyTorch the plain chain's gradient (ops/kernels/gather.py
// `gather_entries_plain`) is two `index_add_`s, and the first adds every
// dead slot's row into the one sentinel row N with atomics. This source
// computes, for every gaussian of depth rank g < N,
//   d_packed[perm[g]] = the sum of d_entries[j] over the slots j that hold
//                       g, in the order of its pairs (slot_of below)
// and d_packed[N] = 0, without atomics: each row is one thread's sum, taken
// in an order fixed by the binning, so the result is the same on every run
// and under torch's deterministic algorithms too. Where the binning has
// not overflowed, that order is the slots' own, ascending, which is the
// order the chain's `index_add_` takes on the CPU: the rows then equal the
// CPU chain's bit for bit.
//
// The binning (ops/binning.py `bin_gaussians(slot_tables=True)`) lays a
// gaussian's pairs out contiguously in presort order: g_offsets[g] is its
// first, g_counts[g] how many, and slot_of[e] the layout slot that holds
// presort entry e, or -1 where none does (a pair dropped past the
// capacity). Entries past slot_of's length were dropped. An index outside
// the layout is read as none, so an overflow frame reads no memory out of
// bounds.
//
// What bounds it on this card: bytes, and the longest gaussian. At
// m360_3m's shapes (N = 3M, about 2.8M live of 6M slots) it reads the
// tables (24 B a gaussian), slot_of (8 B a live slot) and the live slots'
// rows (64 B), and writes 64 B a gaussian: about 0.47 GB, 0.14 ms at 3.35
// TB/s. A thread walks its gaussian's slots alone, so a gaussian that
// covers thousands of tiles walks them in turn. Measured there on the
// H100: 0.294 ms, against 6.46 ms for the chain's two index_add_s; the
// longest gaussian had 12 slots.
//
// What the design does about it: four neighbouring threads own the four
// 16-byte quarters of one gaussian's row, so each gradient row is read as
// one 64-byte piece and each result row written whole; a warp's eight
// gaussians read neighbouring stretches of slot_of. A thread fetches
// kBatch slot indices and then their kBatch rows before it adds any of
// them, so that many loads are in flight on the longest walks; it adds
// them in order.

#include <cuda_runtime.h>

namespace {

constexpr int kQuads = 4;                    // 16-byte quarters of a row
constexpr int kThreads = 256;                // 64 gaussians a block
constexpr int kBatch = 8;                    // slots in flight a thread

__global__ void __launch_bounds__(kThreads)
gather_entries_bwd_kernel(const float4* __restrict__ d_entries,
                          const long long* __restrict__ perm,
                          const long long* __restrict__ slot_of,
                          const long long* __restrict__ g_offsets,
                          const long long* __restrict__ g_counts,
                          long long n, long long m_cap, long long m_out,
                          float4* __restrict__ d_packed) {
  const long long t = static_cast<long long>(blockIdx.x) * kThreads +
                      threadIdx.x;
  if (t >= (n + 1) * kQuads) return;
  const long long g = t / kQuads;
  const int q = static_cast<int>(t % kQuads);
  float4 acc = {0.f, 0.f, 0.f, 0.f};
  if (g == n) {                               // the zero row's gradient
    d_packed[t] = acc;
    return;
  }
  const long long lo = g_offsets[g];
  const long long end = lo + g_counts[g];
  const long long hi = end < m_cap ? end : m_cap;
  for (long long e = lo; e < hi; e += kBatch) {
    long long s[kBatch];
    float4 v[kBatch];
#pragma unroll
    for (int k = 0; k < kBatch; ++k) {
      s[k] = e + k < hi ? slot_of[e + k] : -1;
      if (s[k] >= m_out) s[k] = -1;
    }
#pragma unroll
    for (int k = 0; k < kBatch; ++k)
      if (s[k] >= 0) v[k] = d_entries[s[k] * kQuads + q];
#pragma unroll
    for (int k = 0; k < kBatch; ++k)
      if (s[k] >= 0) {
        acc.x += v[k].x;
        acc.y += v[k].y;
        acc.z += v[k].z;
        acc.w += v[k].w;
      }
  }
  d_packed[perm[g] * kQuads + q] = acc;
}

}  // namespace

extern "C" {

// d_entries (M, 16) float32; perm (N,) int64 as the forward's; slot_of
// (m_cap,) int64; g_offsets, g_counts (N,) int64 in perm's order. Out:
// d_packed (N+1, 16) float32, every row written. All contiguous on the
// device. Launches on `stream`; returns the launch's cudaError_t.
int gsplat_gather_entries_bwd(const float* d_entries, const long long* perm,
                              const long long* slot_of,
                              const long long* g_offsets,
                              const long long* g_counts, long long n,
                              long long m_cap, long long m,
                              float* d_packed, void* stream) {
  if (n < 0 || m_cap < 0 || m < 0) return cudaErrorInvalidValue;
  const int blocks = static_cast<int>(((n + 1) * kQuads + kThreads - 1) /
                                      kThreads);
  gather_entries_bwd_kernel<<<blocks, kThreads, 0,
                              static_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const float4*>(d_entries), perm, slot_of, g_offsets,
      g_counts, n, m_cap, m, reinterpret_cast<float4*>(d_packed));
  return cudaGetLastError();
}

}  // extern "C"
