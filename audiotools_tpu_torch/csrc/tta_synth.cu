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
// arithmetic shifts of int32 values.  Step 0 needs no case of its own:
// from the all-zero state, sign(0) = 0 leaves qm alone, the sum is
// round, round >> fshift = 0, and prev = 0 gives x = p.
//
// What bounds it.  Bytes: L * n residuals read and L * n samples
// written (L = 512, n = 46080 at a 256-frame stereo 44.1 kHz group:
// 189 MB, 0.056 ms at 3.35 TB/s).  But each lane is a serial
// recurrence of n steps: a lane takes at least n times the step's
// dependent chain.  Written as above that chain runs three subtracts
// (d7, d6, d5 from p), then the multiply-adds that take the new dl,
// the shift and the add; restructured (below) it is p -> IMAD -> SHF
// -> IADD, ~15 cycles on an H100, so the floor is 46080 steps = 0.35
// ms at 1.98 GHz, 6x the byte bound.  512 lanes are 16 warps, each
// alone on its scheduler, so the instructions a warp dispatches per
// step set the time: ~17
// IMADs (~2 cycles each on the multiply-add pipe; cycle counts by
// tools_dev/int_op_cycles.py) and ~20 other instructions, some of
// which the compiler also puts on that pipe (IMAD.IADD, IMAD.MOV).
//
// Design, point by point:
// - Memory.  A warp owns 32 lanes and stages their residuals kStages
//   tiles of 32 samples ahead through shared memory with 16-byte
//   cp.async copies, and writes its samples back through an output
//   tile the same way (row_tiles.cuh), where a lane-per-thread walk
//   of device memory touches 32 lines 184 KB apart every step.
// - A one-multiply chain.  dl's new tail is (d5, d6, d7, p) with
//   d7 = p - dl7, d6 = d7 - dl6, d5 = d6 - dl5 (the old dl), so mod 2^32
//     sum_{j=4..7} dl'[j] * qm[j] = p * (qm4 + qm5 + qm6 + qm7)
//         - dl7 * (qm4 + qm5 + qm6) - dl6 * (qm4 + qm5) - dl5 * qm4
//   and acc = C + p[i-1] * Q, where C and Q need only values of step
//   i-2 and older, and qm, whose update reads sign(res[i-1]) and dx,
//   whose signs come from step i-2.  The chain is p[i-1] -> IMAD ->
//   SHF -> IADD -> p[i]; the fixed predictor's x chain runs beside it,
//   and d6, d5 are each one subtract from p.
// - No moves.  dl[0..4] is the d5 of the last five steps and dx[0..4]
//   the signs of the d5 of steps i-6 .. i-2; they, d6, d7, p and the
//   signs of d6, d7 and p live in rings of 8 registers indexed by the
//   step, and each 8 steps (one turn of the rings) are unrolled, so
//   every index is static and the rotation renames registers instead
//   of moving them.  (Unrolling whole 32-step tiles was no faster.)
// - Off the multiply-add pipe.  The signs and sign(res) come from
//   shifts and logic, not compares and selects.

#include <cstdint>
#include <cuda_runtime.h>

#include "row_tiles.cuh"

namespace {

using atpu::kTile;

__device__ __forceinline__ int32_t s(uint32_t v) {
  return static_cast<int32_t>(v);
}

// a lane's filter state: qm, and rings of 8 indexed by step % 8
struct Lane {
  uint32_t qm[8];
  uint32_t d5[8], d6[8], d7[8], pv[8];  // values of step k at slot k % 8
  uint32_t g4[8], g5[8], g6[8], g7[8];  // their signs as dx takes them
  int32_t prev_res;
  uint32_t prev_x;
};

// Computes kTile steps of the lane from residuals in `in` into
// `out_tile`, 8 steps (one turn of the rings) to an unrolled body: the
// tile starts at a multiple of 8.
__device__ __forceinline__ void run_tile(const int32_t* in, int32_t* out_tile,
                                         int r, int fshift, int shift,
                                         Lane& st) {
  const uint32_t round_v = 1u << (fshift - 1);
#pragma unroll 1
  for (int c8 = 0; c8 < kTile; c8 += 8) {
#pragma unroll
  for (int c = 0; c < 8; c += 4) {
    const int4 rv =
        *reinterpret_cast<const int4*>(in + atpu::tile_word(r, c8 + c));
    const int32_t res[4] = {rv.x, rv.y, rv.z, rv.w};
    int32_t x4[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int i = c + u;
#define AT(ring, back) st.ring[(i - (back)) & 7]
      // sign(res[i-1]) as -1, 0 or 1: its sign bit, or'ed with that of
      // its negation
      const uint32_t sgn = static_cast<uint32_t>(st.prev_res >> 31) |
                           ((0u - static_cast<uint32_t>(st.prev_res)) >> 31);
      // dx of this step: dx[j] = g4 of step i-6+j (j <= 4), the signs
      // of d6, d7, p of step i-2
      st.qm[0] += sgn * AT(g4, 6);
      st.qm[1] += sgn * AT(g4, 5);
      st.qm[2] += sgn * AT(g4, 4);
      st.qm[3] += sgn * AT(g4, 3);
      st.qm[4] += sgn * AT(g4, 2);
      st.qm[5] += sgn * AT(g5, 2);
      st.qm[6] += sgn * AT(g6, 2);
      st.qm[7] += sgn * AT(g7, 2);
      const uint32_t a2 = st.qm[4] + st.qm[5];
      const uint32_t a3 = a2 + st.qm[6];
      const uint32_t qsum = a3 + st.qm[7];
      // dl[0..3] = d5 of steps i-5 .. i-2; the old dl5, dl6, dl7 are
      // d6, d7, p of step i-2
      const uint32_t c_part = round_v + AT(d5, 5) * st.qm[0] +
                              AT(d5, 4) * st.qm[1] + AT(d5, 3) * st.qm[2] +
                              AT(d5, 2) * st.qm[3] - AT(pv, 2) * a3 -
                              AT(d7, 2) * a2 - AT(d6, 2) * st.qm[4];
      const uint32_t acc = c_part + AT(pv, 1) * qsum;
      const uint32_t p = static_cast<uint32_t>(res[u]) +
                         static_cast<uint32_t>(s(acc) >> fshift);
      // d7 = p - p[i-1], d6 = d7 - d7[i-1], d5 = d6 - d6[i-1], each one
      // subtract from p of sums of step i-1's values
      const uint32_t k2 = AT(pv, 1) + AT(d7, 1);
      const uint32_t d7 = p - AT(pv, 1);
      const uint32_t d6 = p - k2;
      const uint32_t d5 = p - (k2 + AT(d6, 1));
      AT(pv, 0) = p;
      AT(d7, 0) = d7;
      AT(d6, 0) = d6;
      AT(d5, 0) = d5;
      // v >= 0 ? m : -m from v's sign mask (m = 1, 2, 2, 4): shifts
      // and logic, off the multiply-add pipe
      AT(g4, 0) = static_cast<uint32_t>(s(d5) >> 31) | 1u;
      AT(g5, 0) = (static_cast<uint32_t>(s(d6) >> 31) & 0xfffffffcu) + 2u;
      AT(g6, 0) = (static_cast<uint32_t>(s(d7) >> 31) & 0xfffffffcu) + 2u;
      AT(g7, 0) = (static_cast<uint32_t>(s(p) >> 31) & 0xfffffff8u) + 4u;
#undef AT
      const uint32_t x =
          p + st.prev_x + static_cast<uint32_t>(s(0u - st.prev_x) >> shift);
      st.prev_x = x;
      st.prev_res = res[u];
      x4[u] = s(x);
    }
    *reinterpret_cast<int4*>(out_tile + atpu::tile_word(r, c8 + c)) =
        make_int4(x4[0], x4[1], x4[2], x4[3]);
  }
  }
}

__global__ void __launch_bounds__(32)
tta_synth_kernel(const int32_t* __restrict__ residuals, int lanes, int n,
                 int fshift, int shift, bool vec,
                 int32_t* __restrict__ out) {
  constexpr int ROWS = 32;
  __shared__ __align__(16) int32_t in_tiles[atpu::kStages][ROWS * kTile];
  __shared__ __align__(16) int32_t out_tile[ROWS * kTile];
  const int lane = threadIdx.x;
  const int l0 = blockIdx.x * ROWS;

  // the all-zero state; the signs dx takes at step 1 read the zero dl
  // of step -1 (+1, +2, +2, +4), those of earlier steps are dx's zeros
  Lane st;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    st.qm[j] = st.d5[j] = st.d6[j] = st.d7[j] = st.pv[j] = 0;
    st.g4[j] = st.g5[j] = st.g6[j] = st.g7[j] = 0;
  }
  st.g4[7] = 1;
  st.g5[7] = 2;
  st.g6[7] = 2;
  st.g7[7] = 4;
  st.prev_res = 0;
  st.prev_x = 0;

  const int tiles = (n + kTile - 1) / kTile;
  const atpu::RowTiles<ROWS> io(residuals, out, lanes, n, l0, vec, lane);
  io.prefetch(in_tiles, tiles);
  for (int t = 0; t < tiles; ++t) {
    const int32_t* in = io.next(in_tiles, t, tiles);
    run_tile(in, out_tile, lane, fshift, shift, st);
    io.finish(out_tile, t * kTile);
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
  tta_synth_kernel<<<(lanes + 31) / 32, 32, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(residuals), lanes, n, fshift, shift,
      atpu::rows_vectorizable(residuals, out, n),
      static_cast<int32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}
