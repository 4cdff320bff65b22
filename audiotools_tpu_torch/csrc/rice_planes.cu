// Bit-plane counts of the FLAC encoder's exact Rice ladder for NVIDIA
// Hopper (sm_90a).
//
// Replaces the stacked reduction of the reference's "exact" Rice
// search, audiotools_tpu/ops/flac_frames.py:508 (w_fin), which XLA
// fuses into its device program.  For each finest partition of each
// candidate residual row (S subframes x C candidates x parts
// partitions of psize samples, one "row" here) it writes J0 + 1 int32:
//   out[row, r] = #{ i : bit r of u_i is set }   for r < J0
//   out[row, J0] = sum_i (u_i >> J0)
// where u = (x << 1) ^ (x >> 31) is the zigzag of the int32 residual
// x, read as uint32.  The Rice search descends from these
// (sum(u >> r) = 2 * sum(u >> (r + 1)) + count_r) in torch on the
// small [S, C, parts, J0 + 1] result; the reference's stacked form
// materialises [S, C, parts, J0 + 1, psize] first.
//
// What bounds it.  Each residual is read once and each count written
// once: at the FLAC -8 bench batch (S = 4096 variants, C = 13, n =
// 4096, parts = 64, J0 = 14) that is 872 MB in and 204 MB out, 0.32 ms
// at 3.35 TB/s.  The integer work is about 2 * J0 + 4 operations a
// residual (the zigzag, a bit test and an add a plane, the seed's shift
// and add), 7.0 G operations, 0.10 ms at the card's 67 T/s: bytes
// bound it.
//
// Design: a warp a row.  Lane l reads residual base + l of each
// 32-residual step, so a warp's loads are one 128-byte line; a plane's
// count over the step is the population count of one warp ballot, and
// lane r keeps plane r's running count, so no count is ever reduced
// across lanes.  Each lane sums its own u >> J0 and one butterfly of
// shuffles adds the 32 sums at the row's end.  Lane r < J0 writes
// plane r and lane J0 the seed (J0 + 1 <= 32).

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;           // rows (warps) a CUDA block
constexpr unsigned kFull = 0xffffffffu;

__global__ void __launch_bounds__(kWarps * 32)
    rice_planes_kernel(const int32_t* __restrict__ res, long long rows,
                       int psize, int j0, int32_t* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const long long row =
      static_cast<long long>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  if (row >= rows) {
    return;                         // the whole warp leaves together
  }
  const int32_t* src = res + row * psize;
  uint32_t plane = 0;               // plane `lane`'s count (lane < j0)
  uint32_t seed = 0;                // this lane's sum of u >> j0
  for (int base = 0; base < psize; base += 32) {
    const int i = base + lane;
    uint32_t u = 0;
    if (i < psize) {
      const int32_t x = __ldg(src + i);
      u = (static_cast<uint32_t>(x) << 1) ^ static_cast<uint32_t>(x >> 31);
    }
    seed += u >> j0;
#pragma unroll
    for (int r = 0; r < 31; ++r) {
      if (r < j0) {
        const unsigned bits = __ballot_sync(kFull, (u >> r) & 1u);
        if (lane == r) {
          plane += __popc(bits);
        }
      }
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    seed += __shfl_xor_sync(kFull, seed, off);
  }
  int32_t* dst = out + row * (j0 + 1);
  if (lane < j0) {
    dst[lane] = static_cast<int32_t>(plane);
  } else if (lane == j0) {
    dst[j0] = static_cast<int32_t>(seed);
  }
}

}  // namespace

// res: int32 [rows, psize] (the residual rows, partition after
// partition); out: int32 [rows, j0 + 1].  Device pointers, contiguous.
// Launches on `stream` without synchronising and returns
// cudaGetLastError().
extern "C" int atpu_rice_planes(const void* res, long long rows, int psize,
                                int j0, void* out, void* stream) {
  if (rows <= 0) {
    return 0;
  }
  if (psize <= 0 || j0 < 0 || j0 > 31) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long blocks = (rows + kWarps - 1) / kWarps;
  if (blocks > 0x7fffffffLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  rice_planes_kernel<<<static_cast<unsigned>(blocks), kWarps * 32, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(res), rows, psize, j0,
      static_cast<int32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}
