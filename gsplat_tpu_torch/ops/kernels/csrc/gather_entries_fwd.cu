// The entry gather for Hopper (sm_90a): the compositor's (M, 16) entry rows
// from the (N+1, 16) packed rows. Its gradient is csrc/gather_entries_bwd.cu.
//
// Replaces no TPU kernel: the JAX package leaves the gather to XLA
// (`packed[perm_ext][gidx_sorted]`). In PyTorch the same chain
// (ops/kernels/gather.py `gather_entries_plain`) is two `index_select`s
// through an (N+1, 16) depth-ordered intermediate, launched as one block a
// row. This source computes, for every slot j of the layout, with
// g = gidx_sorted[j]:
//   entries[j] = packed[perm[g]]   where g < N (a live slot)
//   entries[j] = packed[N]         where g = N (a dead slot; row N is zero,
//                                  csrc/preprocess_fwd.cu)
// It is a copy, so it equals the chain bit for bit. A slot index outside
// [0, N] is not checked: the kernel reads it as dead.
//
// What bounds it on this card: bytes. At m360_3m's shapes (N = 3M, about
// 6M slots) it reads gidx_sorted (8 B a slot), perm (8 B a gaussian) and
// the packed rows (64 B) and writes 64 B a slot: about 0.65 GB, 0.19 ms at
// 3.35 TB/s. There is no arithmetic to speak of. Measured there on the
// H100: 0.25 ms, against 5.45 ms for the chain's two index_selects.
//
// What the design does about it: four neighbouring threads own the four
// 16-byte quarters of one slot, so a warp moves eight whole slots with one
// 16-byte load and one 16-byte store a thread, every 32-byte sector used
// whole; a block of 256 threads covers 64 slots, and the grid (about
// 94,000 blocks at 6M slots) fills the 132 SMs many times over. The four
// threads of a slot read its index and perm entry from one address each,
// which the warp serves with one request. The composed index skips
// `perm_ext`'s `torch.cat` and the (N+1, 16) intermediate.

#include <cuda_runtime.h>

namespace {

constexpr int kQuads = 4;                    // 16-byte quarters of a row
constexpr int kThreads = 256;                // 64 slots a block

__global__ void __launch_bounds__(kThreads)
gather_entries_fwd_kernel(const float4* __restrict__ packed,
                          const long long* __restrict__ perm,
                          const long long* __restrict__ gidx, long long n,
                          long long m, float4* __restrict__ entries) {
  const long long t = static_cast<long long>(blockIdx.x) * kThreads +
                      threadIdx.x;
  if (t >= m * kQuads) return;
  const long long g = gidx[t / kQuads];
  const long long src = (g >= 0 && g < n) ? perm[g] : n;
  entries[t] = packed[src * kQuads + t % kQuads];
}

}  // namespace

extern "C" {

// packed (N+1, 16) float32, row N zero; perm (N,) int64, the gaussians in
// depth order; gidx (M,) int64, each slot's depth rank, N for a dead slot.
// Out: entries (M, 16) float32. All contiguous on the device. Launches on
// `stream`; returns the launch's cudaError_t (0 on success).
int gsplat_gather_entries_fwd(const float* packed, const long long* perm,
                              const long long* gidx, long long n,
                              long long m, float* entries, void* stream) {
  if (n < 0 || m < 0) return cudaErrorInvalidValue;
  if (m == 0) return cudaSuccess;
  const int blocks = static_cast<int>((m * kQuads + kThreads - 1) /
                                      kThreads);
  gather_entries_fwd_kernel<<<blocks, kThreads, 0,
                              static_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const float4*>(packed), perm, gidx, n, m,
      reinterpret_cast<float4*>(entries));
  return cudaGetLastError();
}

}  // extern "C"
