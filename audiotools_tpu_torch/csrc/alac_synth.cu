// ALAC sign-adaptive predictor synthesis for NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel audiotools_tpu/ops/alac_synth.py:233
// (_synthesize_pallas), and with it the reference's host guard
// (pallas_synthesis_safe): the prediction sum accumulates in int64, so
// 24-bit rows and drifting coefficients stay exact.
//
// Row s of S subframe rows follows the reference's numpy form
// (alac_synth.synthesize(np, ...)), with w[j] = out[i-1-j] (0 before
// the row starts), ord_eff = n for order >= 31 (the pure difference
// chain), else order:
//   i == 0:            out[0] = res[0]
//   1 <= i <= ord_eff: out[i] = trunc(out[i-1] + res[i])
//   later:             base = w[order]
//                      out[i] = trunc(((half + sum_j q[j] * (w[j] - base))
//                                      >> shift) + res[i] + base)
//                      then the adaptation walk, over the window read
//                      before out[i] is pushed: for t = 0 .. max_order-1,
//                      j = order-1-t >= 0, while residual * s0 > 0
//                      (s0 = sign(res[i]), residual starts at res[i]):
//                        val = base - w[j], sgn = s0 * sign(val)
//                        q[j] -= sgn
//                        residual -= ((val * sgn) >> shift) * (t + 1)
// with half = 1 << min(shift - 1, 30) for shift > 0 (else 0), and
// trunc the two's-complement truncation to clip(sample_size, 1, 30)
// bits.  The sum over j < order is exact in int64 (the reference's is
// exact in float64 for every stream ALAC can hold), so the arithmetic
// shift equals its floor.  Everything else is int32 with numpy's
// wrapping: those adds, subtracts and multiplies run in uint32.
//
// The TPU kernel carries the window and the coefficients in VMEM
// across a sequential grid and turns every per-row index (base at
// w[order], the walk's w[order-1-t] and q[order-1-t]) into one-hot
// masks.  Here one thread owns one row, and the window (KMAX + 1
// samples) and the coefficients (KMAX) stay in registers: the walk
// runs over j from KMAX-1 down to 0 with static indices, live where
// order - max_order <= j < order, and base is a select over the
// window.  KMAX = 8 serves orders up to 8 (and the difference chain);
// KMAX = 32 serves orders 9 to 30.
//
// Bound: memory.  The kernel reads S * n residuals and writes S * n
// samples (S = 2048, n = 4096 at a 1024-frameset stereo batch: 33.5 MB
// each way), with ~150 integer operations a sample on the main path.
// Design: the recurrence is serial along a row, so the parallelism is
// S threads; 32 threads a block spreads 2048 rows over 64 SMs, which
// leaves most of the card idle, and each thread's loads and stores
// are strided by n * 4 bytes across its warp (L1 keeps each 128-byte
// line for the next 31 samples).  Later work: a [n, S] layout for
// coalesced access, and more rows in flight per SM.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 32;

__device__ __forceinline__ int32_t wrap_add(int32_t a, int32_t b) {
  return static_cast<int32_t>(static_cast<uint32_t>(a) +
                              static_cast<uint32_t>(b));
}

__device__ __forceinline__ int32_t wrap_sub(int32_t a, int32_t b) {
  return static_cast<int32_t>(static_cast<uint32_t>(a) -
                              static_cast<uint32_t>(b));
}

__device__ __forceinline__ int32_t wrap_mul(int32_t a, int32_t b) {
  return static_cast<int32_t>(static_cast<uint32_t>(a) *
                              static_cast<uint32_t>(b));
}

__device__ __forceinline__ int32_t sign_of(int32_t v) {
  return (v > 0) - (v < 0);
}

template <int KMAX>
__global__ void __launch_bounds__(kThreads)
alac_synth_kernel(const int32_t* __restrict__ residuals,
                  const int32_t* __restrict__ qlp,
                  const int32_t* __restrict__ order,
                  const int32_t* __restrict__ shift,
                  const int32_t* __restrict__ sample_size,
                  int s_count, int n, int kw, int max_order,
                  int32_t* __restrict__ out) {
  const int s = blockIdx.x * kThreads + threadIdx.x;
  if (s >= s_count) return;
  const int32_t* res = residuals + static_cast<int64_t>(s) * n;
  int32_t* row = out + static_cast<int64_t>(s) * n;

  const int ord = order[s];
  const int ord_eff = ord >= 31 ? n : ord;
  const int sh = shift[s];
  const int ss = min(max(sample_size[s], 1), 30);
  const int32_t nmask = static_cast<int32_t>((1u << ss) - 1u);
  const int32_t sbit = static_cast<int32_t>(1u << (ss - 1));
  const int64_t half = sh > 0 ? (int64_t{1} << min(sh - 1, 30)) : 0;
  const int walk_lo = ord - max_order;

  int32_t q[KMAX];
  int32_t w[KMAX + 1];   // w[j] = out[i - 1 - j]
#pragma unroll
  for (int j = 0; j < KMAX; ++j) {
    q[j] = (j < ord && j < kw) ? qlp[static_cast<int64_t>(s) * kw + j] : 0;
    w[j] = 0;
  }
  w[KMAX] = 0;

  for (int i = 0; i < n; ++i) {
    const int32_t r = res[i];
    int32_t v;
    if (i == 0) {
      v = r;
    } else if (i <= ord_eff) {
      v = ((wrap_add(w[0], r) & nmask) ^ sbit) - sbit;
    } else {
      int32_t base = 0;
#pragma unroll
      for (int j = 0; j <= KMAX; ++j) {
        base = j == ord ? w[j] : base;
      }
      int64_t acc = 0;
#pragma unroll
      for (int j = 0; j < KMAX; ++j) {
        acc += static_cast<int64_t>(q[j]) * wrap_sub(w[j], base);
      }
      const int64_t pred = ((half + acc) >> sh) + r + base;
      v = ((static_cast<int32_t>(pred) & nmask) ^ sbit) - sbit;

      const int32_t s0 = sign_of(r);
      int32_t residual = r;
#pragma unroll
      for (int j = KMAX - 1; j >= 0; --j) {
        if (j < ord && j >= walk_lo && wrap_mul(residual, s0) > 0) {
          const int32_t val = wrap_sub(base, w[j]);
          const int32_t sgn = s0 * sign_of(val);
          q[j] = wrap_sub(q[j], sgn);
          const int32_t delta = wrap_mul(wrap_mul(val, sgn) >> sh, ord - j);
          residual = wrap_sub(residual, delta);
        }
      }
    }
    row[i] = v;
#pragma unroll
    for (int j = KMAX; j > 0; --j) {
      w[j] = w[j - 1];
    }
    w[0] = v;
  }
}

}  // namespace

// residuals: int32 [s_count, n]; qlp: int32 [s_count, kw], 1 <= kw <=
// 32, holding every coefficient of a row with order < 31; order,
// shift (0..31), sample_size: int32 [s_count]; out: int32
// [s_count, n]; max_order: walk steps (1..32); kmax: 8 when every row
// has order <= 8 or >= 31, else 32.  All device pointers, contiguous.
// Launches on `stream` without synchronising and returns
// cudaGetLastError().
extern "C" int atpu_alac_synth(const void* residuals, const void* qlp,
                               const void* order, const void* shift,
                               const void* sample_size, int s_count,
                               int n, int kw, int max_order, int kmax,
                               void* out, void* stream) {
  if (s_count <= 0 || n <= 0) {
    return 0;
  }
  if (kw < 1 || kw > 32 || max_order < 1 || max_order > 32 ||
      (kmax != 8 && kmax != 32)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int blocks = (s_count + kThreads - 1) / kThreads;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* r = static_cast<const int32_t*>(residuals);
  const auto* q = static_cast<const int32_t*>(qlp);
  const auto* o = static_cast<const int32_t*>(order);
  const auto* sh = static_cast<const int32_t*>(shift);
  const auto* ss = static_cast<const int32_t*>(sample_size);
  auto* dst = static_cast<int32_t*>(out);
  if (kmax == 8) {
    alac_synth_kernel<8><<<blocks, kThreads, 0, st>>>(
        r, q, o, sh, ss, s_count, n, kw, max_order, dst);
  } else {
    alac_synth_kernel<32><<<blocks, kThreads, 0, st>>>(
        r, q, o, sh, ss, s_count, n, kw, max_order, dst);
  }
  return static_cast<int>(cudaGetLastError());
}
