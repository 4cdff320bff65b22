// TTA inverse hybrid filter and inverse fixed predictor for NVIDIA
// Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel audiotools_tpu/ops/tta_synth.py:107
// (_inverse_pallas).  Lane l of L (one frame's channel) follows the
// reference's numpy form (tta_synth.inverse_filter_predict(np, ...)):
//   i == 0: p = res[0] - (round >> fshift)             (qm unchanged)
//   i > 0:  qm[j] += sign(res[i-1]) * dx[j]
//           p = res[i] + ((round + sum_j dl[j] * qm[j]) >> fshift)
//   then    dx <- (dx[1..4], dl[4] >= 0 ? 1 : -1, dl[5] >= 0 ? 2 : -2,
//                  dl[6] >= 0 ? 2 : -2, dl[7] >= 0 ? 4 : -4)
//           d7 = p - dl[7], d6 = d7 - dl[6], d5 = d6 - dl[5]
//           dl <- (dl[1..4], d5, d6, d7, p)     (the signs read the old dl)
//           x = p (i == 0), else p + prev + ((-prev) >> shift), prev = x
// with round = 1 << (fshift - 1).  The filter is defined mod 2^32:
// every add, subtract, multiply and negation runs in uint32 and is
// read back as int32 (numpy's wrapping int32); the shifts are
// arithmetic shifts of int32 values.
//
// The TPU kernel keeps the qm/dx/dl planes and the previous residual
// and output in VMEM across a sequential grid, 128 lanes a block.
// Here one thread owns one lane and keeps the whole state (26 words)
// in registers.
//
// Bound: memory.  The kernel reads L * n residuals and writes L * n
// samples (L = 512, n = 46080 at a 256-frame stereo 44.1 kHz group:
// 94 MB each way), with ~60 integer operations a sample.  Design: the
// recurrence is serial along a lane, so the parallelism is L threads;
// 32 threads a block spreads 512 lanes over 16 SMs.  Each thread's
// loads and stores are strided by n * 4 bytes across its warp (L1
// keeps each 128-byte line for the next 31 samples).  Later work: more
// lanes per group, a [n, L] layout for coalesced access.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 32;

__device__ __forceinline__ uint32_t u(int32_t v) {
  return static_cast<uint32_t>(v);
}

__device__ __forceinline__ int32_t s(uint32_t v) {
  return static_cast<int32_t>(v);
}

__global__ void __launch_bounds__(kThreads)
tta_synth_kernel(const int32_t* __restrict__ residuals, int lanes, int n,
                 int fshift, int shift, int32_t* __restrict__ out) {
  const int l = blockIdx.x * kThreads + threadIdx.x;
  if (l >= lanes) return;
  const int32_t* res = residuals + static_cast<int64_t>(l) * n;
  int32_t* row = out + static_cast<int64_t>(l) * n;

  const int32_t round_v = 1 << (fshift - 1);
  int32_t qm[8], dx[8], dl[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    qm[j] = 0;
    dx[j] = 0;
    dl[j] = 0;
  }
  int32_t prev_res = 0;
  int32_t prev_out = 0;

  for (int i = 0; i < n; ++i) {
    const int32_t r = res[i];
    int32_t p;
    if (i == 0) {
      p = s(u(r) - u(round_v >> fshift));
    } else {
      const int32_t sgn = (prev_res > 0) - (prev_res < 0);
      uint32_t acc = u(round_v);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        qm[j] = s(u(qm[j]) + u(sgn) * u(dx[j]));
        acc += u(dl[j]) * u(qm[j]);
      }
      p = s(u(r) + u(s(acc) >> fshift));
    }
    prev_res = r;

    const int32_t dx4 = dl[4] >= 0 ? 1 : -1;
    const int32_t dx5 = dl[5] >= 0 ? 2 : -2;
    const int32_t dx6 = dl[6] >= 0 ? 2 : -2;
    const int32_t dx7 = dl[7] >= 0 ? 4 : -4;
    const int32_t d7 = s(u(p) - u(dl[7]));
    const int32_t d6 = s(u(d7) - u(dl[6]));
    const int32_t d5 = s(u(d6) - u(dl[5]));
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      dx[j] = dx[j + 1];
      dl[j] = dl[j + 1];
    }
    dx[4] = dx4;
    dx[5] = dx5;
    dx[6] = dx6;
    dx[7] = dx7;
    dl[4] = d5;
    dl[5] = d6;
    dl[6] = d7;
    dl[7] = p;

    int32_t x;
    if (i == 0) {
      x = p;
    } else {
      const int32_t neg = s(0u - u(prev_out));
      x = s(u(p) + u(s(u(prev_out) + u(neg >> shift))));
    }
    prev_out = x;
    row[i] = x;
  }
}

}  // namespace

// residuals: int32 [lanes, n]; out: int32 [lanes, n]; fshift (9 or
// 10) and shift (4 or 5) from the stream's bits per sample.  Device
// pointers, contiguous.  Launches on `stream` without synchronising
// and returns cudaGetLastError().
extern "C" int atpu_tta_synth(const void* residuals, int lanes, int n,
                              int fshift, int shift, void* out,
                              void* stream) {
  if (lanes <= 0 || n <= 0) {
    return 0;
  }
  if (fshift < 1 || fshift > 30 || shift < 0 || shift > 31) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int blocks = (lanes + kThreads - 1) / kThreads;
  tta_synth_kernel<<<blocks, kThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(residuals), lanes, n, fshift, shift,
      static_cast<int32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}
