// TTA forward hybrid filter (the encoder's) for NVIDIA Hopper (sm_90a).
//
// Replaces the reference's audiotools_tpu/ops/tta_scan.py:70
// (hybrid_filter), a lax.scan over sample positions with no Pallas
// form.  Lane l of L (one frame's channel) follows the reference's
// numpy form step for step, from the all-zero state:
//   qm[j] += sign(res[i-1]) * dx[j]                      (res[-1] = 0)
//   res[i] = p[i] - ((round + sum_j dl[j] * qm[j]) >> fshift)
//   then    dx <- (dx[1..4], dl[4] >= 0 ? 1 : -1, dl[5] >= 0 ? 2 : -2,
//                  dl[6] >= 0 ? 2 : -2, dl[7] >= 0 ? 4 : -4)
//           d7 = p - dl[7], d6 = d7 - dl[6], d5 = d6 - dl[5]
//           dl <- (dl[1..4], d5, d6, d7, p)     (the signs read the old dl)
// with round = 1 << (fshift - 1) and p the fixed predictor's output
// (ops/tta_scan.fixed_predict).  The filter is defined mod 2^32: every
// add, subtract, multiply and negation runs in uint32 and is read back
// as int32; the shift is an arithmetic shift of the int32 value.  Step
// 0 needs no case of its own: sign(0) = 0 leaves qm alone, the sum is
// round, and round >> fshift = 0 gives res = p.
//
// What bounds it.  Bytes: L * n inputs read and L * n residuals written
// (L = 512, n = 46080 for 256 frames of 44.1 kHz stereo: 189 MB, 0.056
// ms at 3.35 TB/s).  But each lane is a serial recurrence of n steps.
// dx and dl depend on the inputs only; the one serial link is
// sign(res[i-1]) -> the dot product -> res[i].  Written as
//   acc = (round + sum_j dl[j] * qm[j]) + sign * (sum_j dl[j] * dx[j])
// (equal mod 2^32), both sums need only values known before res[i-1],
// so the chain is the sign (shifts and an or), one multiply-add, the
// shift and the subtract.
//
// Design (the simple form; speed is later work): one thread a lane, its
// qm, dx and dl in registers (the 8-wide loops fully unrolled, so every
// index is static); a warp owns 32 lanes and stages their inputs three
// tiles of 32 samples ahead through shared memory with 16-byte
// cp.async copies, and writes its residuals back through an output tile
// the same way (row_tiles.cuh), where a lane-per-thread walk of device
// memory touches 32 lines n * 4 bytes apart every step.

#include <cstdint>
#include <cuda_runtime.h>

#include "row_tiles.cuh"

namespace {

using atpu::kTile;

__device__ __forceinline__ int32_t s(uint32_t v) {
  return static_cast<int32_t>(v);
}

struct Lane {
  uint32_t qm[8], dx[8], dl[8];
  uint32_t prev_res;
};

// one step of the lane: input p -> residual
__device__ __forceinline__ uint32_t step(Lane& st, uint32_t p,
                                         uint32_t round_v, int fshift) {
  // sign(res[i-1]) as -1, 0 or 1: its sign bit, or'ed with that of its
  // negation
  const uint32_t sgn = static_cast<uint32_t>(s(st.prev_res) >> 31) |
                       ((0u - st.prev_res) >> 31);
  uint32_t a = round_v;
  uint32_t b = 0;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    a += st.dl[j] * st.qm[j];
    b += st.dl[j] * st.dx[j];
    st.qm[j] += sgn * st.dx[j];
  }
  const uint32_t acc = a + sgn * b;
  const uint32_t res = p - static_cast<uint32_t>(s(acc) >> fshift);
  // the rotation, the signs from the old dl
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    st.dx[j] = st.dx[j + 1];
  }
  st.dx[4] = s(st.dl[4]) >= 0 ? 1u : 0u - 1u;
  st.dx[5] = s(st.dl[5]) >= 0 ? 2u : 0u - 2u;
  st.dx[6] = s(st.dl[6]) >= 0 ? 2u : 0u - 2u;
  st.dx[7] = s(st.dl[7]) >= 0 ? 4u : 0u - 4u;
  const uint32_t d7 = p - st.dl[7];
  const uint32_t d6 = d7 - st.dl[6];
  const uint32_t d5 = d6 - st.dl[5];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    st.dl[j] = st.dl[j + 1];
  }
  st.dl[4] = d5;
  st.dl[5] = d6;
  st.dl[6] = d7;
  st.dl[7] = p;
  st.prev_res = res;
  return res;
}

__global__ void __launch_bounds__(32)
tta_filter_kernel(const int32_t* __restrict__ predicted, int lanes, int n,
                  int fshift, bool vec, int32_t* __restrict__ out) {
  constexpr int ROWS = 32;
  __shared__ __align__(16) int32_t in_tiles[atpu::kStages][ROWS * kTile];
  __shared__ __align__(16) int32_t out_tile[ROWS * kTile];
  const int lane = threadIdx.x;
  const uint32_t round_v = 1u << (fshift - 1);

  Lane st;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    st.qm[j] = st.dx[j] = st.dl[j] = 0;
  }
  st.prev_res = 0;

  const int tiles = (n + kTile - 1) / kTile;
  const atpu::RowTiles<ROWS> io(predicted, out, lanes, n,
                                blockIdx.x * ROWS, vec, lane);
  io.prefetch(in_tiles, tiles);
  for (int t = 0; t < tiles; ++t) {
    const int32_t* in = io.next(in_tiles, t, tiles);
#pragma unroll 1
    for (int c = 0; c < kTile; c += 4) {
      const int4 pv =
          *reinterpret_cast<const int4*>(in + atpu::tile_word(lane, c));
      int4 rv;
      rv.x = s(step(st, static_cast<uint32_t>(pv.x), round_v, fshift));
      rv.y = s(step(st, static_cast<uint32_t>(pv.y), round_v, fshift));
      rv.z = s(step(st, static_cast<uint32_t>(pv.z), round_v, fshift));
      rv.w = s(step(st, static_cast<uint32_t>(pv.w), round_v, fshift));
      *reinterpret_cast<int4*>(out_tile + atpu::tile_word(lane, c)) = rv;
    }
    io.finish(out_tile, t * kTile);
  }
}

}  // namespace

// predicted: int32 [lanes, n]; out: int32 [lanes, n]; fshift (9 or 10)
// from the stream's bits per sample.  Device pointers, contiguous.
// Launches on `stream` without synchronising and returns
// cudaGetLastError().
extern "C" int atpu_tta_filter(const void* predicted, int lanes, int n,
                               int fshift, void* out, void* stream) {
  if (lanes <= 0 || n <= 0) {
    return 0;
  }
  if (fshift < 1 || fshift > 30) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  tta_filter_kernel<<<(lanes + 31) / 32, 32, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(predicted), lanes, n, fshift,
      atpu::rows_vectorizable(predicted, out, n),
      static_cast<int32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}
