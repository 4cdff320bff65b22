// FLAC subframe predictor synthesis for NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel audiotools_tpu/ops/flac_synth.py:96
// (_synthesize_i32_pallas), and with it the reference's int32 safety
// guard (i32_synthesis_safe) and its float64 scan fallback.
//
// Row s of S subframe rows inverts its predictor:
//   out[i] = warmup[i] (0 past kw)                         for i < order
//   out[i] = wrap32(res[i] + ((sum_j q[j] * out[i-1-j]) >> shift))
// with the sum over all kw coefficient columns and out[<0] = 0.  The
// sum of at most 32 products of 15-bit coefficients and 31-bit samples
// is exact in int64, so the arithmetic shift equals the reference's
// exact float64 floor form, and the int32 wrap is numpy's
// astype(int64).astype(int32).  shift is at least 0 (the host scan
// clamps negative shifts to 0).
//
// The TPU kernel splits each sample into 11-bit planes so that int32
// multiply-accumulates cannot wrap, and carries the history in VMEM
// across a sequential grid.  Here one thread owns one row: the last
// KMAX samples stay in registers (KMAX = 8, 16 or 32, the smallest
// that holds kw, chosen at launch), products are 32x32->64-bit
// multiply-adds.
//
// Bound: memory.  The kernel reads S * n residuals and writes S * n
// samples (S = 2048, n = 4096 at the FLAC -8 stereo batch: 33.5 MB
// each way).  Design: the recurrence is serial along a row, so the
// parallelism is S threads; 32 threads a block spreads 2048 rows over
// 64 SMs.  That leaves most of the card idle and each thread's loads
// and stores strided by n * 4 bytes across its warp (L1 keeps each
// 128-byte line for the next 31 samples).  Later work: more than one
// thread per row (a blocked parallel-prefix form of the linear
// recurrence), or a [n, S] layout for coalesced access.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 32;

template <int KMAX>
__global__ void __launch_bounds__(kThreads)
flac_synth_kernel(const int32_t* __restrict__ residuals,
                  const int32_t* __restrict__ warmup,
                  const int32_t* __restrict__ qlp,
                  const int32_t* __restrict__ shift,
                  const int32_t* __restrict__ order,
                  int s_count, int n, int kw,
                  int32_t* __restrict__ out) {
  const int s = blockIdx.x * kThreads + threadIdx.x;
  if (s >= s_count) return;
  const int32_t* res = residuals + static_cast<int64_t>(s) * n;
  const int32_t* warm = warmup + static_cast<int64_t>(s) * kw;
  int32_t* row = out + static_cast<int64_t>(s) * n;

  int32_t q[KMAX];
  int32_t hist[KMAX];   // hist[j] = out[i - 1 - j]
#pragma unroll
  for (int j = 0; j < KMAX; ++j) {
    q[j] = j < kw ? qlp[static_cast<int64_t>(s) * kw + j] : 0;
    hist[j] = 0;
  }
  const int sh = min(max(shift[s], 0), 63);
  const int ord = order[s];

  for (int i = 0; i < n; ++i) {
    int64_t acc = 0;
#pragma unroll
    for (int j = 0; j < KMAX; ++j) {
      acc += static_cast<int64_t>(q[j]) * hist[j];
    }
    int32_t v;
    if (i < ord) {
      v = i < kw ? warm[i] : 0;
    } else {
      v = static_cast<int32_t>(static_cast<int64_t>(res[i]) + (acc >> sh));
    }
    row[i] = v;
#pragma unroll
    for (int j = KMAX - 1; j > 0; --j) {
      hist[j] = hist[j - 1];
    }
    hist[0] = v;
  }
}

}  // namespace

// residuals: int32 [s_count, n]; warmup, qlp: int32 [s_count, kw] with
// 1 <= kw <= 32; shift, order: int32 [s_count]; out: int32
// [s_count, n].  All device pointers, contiguous.  Launches on
// `stream` without synchronising and returns cudaGetLastError().
extern "C" int atpu_flac_synth(const void* residuals, const void* warmup,
                               const void* qlp, const void* shift,
                               const void* order, int s_count, int n,
                               int kw, void* out, void* stream) {
  if (s_count <= 0 || n <= 0) {
    return 0;
  }
  if (kw < 1 || kw > 32) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int blocks = (s_count + kThreads - 1) / kThreads;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* r = static_cast<const int32_t*>(residuals);
  const auto* w = static_cast<const int32_t*>(warmup);
  const auto* q = static_cast<const int32_t*>(qlp);
  const auto* sh = static_cast<const int32_t*>(shift);
  const auto* o = static_cast<const int32_t*>(order);
  auto* dst = static_cast<int32_t*>(out);
  if (kw <= 8) {
    flac_synth_kernel<8><<<blocks, kThreads, 0, st>>>(r, w, q, sh, o,
                                                     s_count, n, kw, dst);
  } else if (kw <= 16) {
    flac_synth_kernel<16><<<blocks, kThreads, 0, st>>>(r, w, q, sh, o,
                                                      s_count, n, kw, dst);
  } else {
    flac_synth_kernel<32><<<blocks, kThreads, 0, st>>>(r, w, q, sh, o,
                                                      s_count, n, kw, dst);
  }
  return static_cast<int>(cudaGetLastError());
}
