// FLAC residual bit-pack scatter for NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel audiotools_tpu/ops/pallas_bitpack.py:195
// (scatter_words_pallas).  Each of S subframe rows holds M word
// contributions (idx, val) from tokenize + split_contributions; the
// kernel ORs every val into out[row, idx].  Payload bit ranges are
// disjoint by construction, so OR equals the reference's add, and
// because OR is commutative the result does not depend on the order
// in which threads land: it is deterministic.
//
// The TPU has no per-lane scatter, so the Pallas kernel builds a
// one-hot (idx == word_id) matrix per tile and contracts it against
// the byte lanes of val on the MXU.  A GPU thread can address memory
// directly, so no one-hot is needed: one atomicOr per nonzero
// contribution.
//
// Bound: memory.  The kernel reads 2 * S * M * 4 bytes (idx and val)
// and writes S * n_words * 4 bytes; at the FLAC -8 bench shape
// (S = 2048, M = 8322, n_words = 2445) that is 136 MB read and 20 MB
// written, with no arithmetic to speak of.  Design: one block per row,
// 256 threads striding over the row's contributions so that
// neighbouring threads read neighbouring words (coalesced loads); the
// atomics of one row hit a 10 KB span that stays in L2.
//
// Contributions with val == 0 are skipped, and those whose idx falls
// outside [0, n_words) are dropped: the Pallas kernel drops them by
// slicing its padded output, and pack_chosen_residuals relies on that
// when a row overflows its capacity (it then reports ok = False).
//
// The output must be zeroed by the caller (the wrapper allocates it
// with torch.zeros).  Later work: a shared-memory word tile per row,
// or fusing tokenize's prefix sum and split_contributions into this
// kernel so the [S, 2T] intermediates never reach device memory.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
scatter_words_kernel(const int32_t* __restrict__ idx,
                     const uint32_t* __restrict__ val,
                     uint32_t* __restrict__ out,
                     int m, int n_words) {
  const size_t row = blockIdx.x;
  const int32_t* row_idx = idx + row * static_cast<size_t>(m);
  const uint32_t* row_val = val + row * static_cast<size_t>(m);
  uint32_t* row_out = out + row * static_cast<size_t>(n_words);
  for (int k = threadIdx.x; k < m; k += kThreads) {
    const uint32_t v = row_val[k];
    const int32_t q = row_idx[k];
    if (v != 0u && q >= 0 && q < n_words) {
      atomicOr(row_out + q, v);
    }
  }
}

}  // namespace

// idx: int32 [s, m]; val: u32 bit patterns [s, m]; out: u32 [s, n_words],
// zero-filled.  All device pointers, contiguous.  Launches on `stream`
// without synchronising and returns cudaGetLastError().
extern "C" int atpu_scatter_words(const void* idx, const void* val,
                                  void* out, int s, int m, int n_words,
                                  void* stream) {
  if (s <= 0 || m <= 0 || n_words <= 0) {
    return 0;
  }
  scatter_words_kernel<<<s, kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(idx), static_cast<const uint32_t*>(val),
      static_cast<uint32_t*>(out), m, n_words);
  return static_cast<int>(cudaGetLastError());
}
