// FLAC subframe predictor synthesis for NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel audiotools_tpu/ops/flac_synth.py:96
// (_synthesize_i32_pallas), and with it the reference's int32 safety
// guard (i32_synthesis_safe) and its float64 scan fallback.
//
// Row s of S subframe rows inverts its predictor:
//   out[i] = warmup[i] (0 past kw)                         for i < order
//   out[i] = wrap32(res[i] + ((sum_j q[j] * out[i-1-j]) >> shift))
// with the sum over the coefficient columns and out[<0] = 0.  The sum
// of at most 32 products of 15-bit coefficients and 31-bit samples is
// exact in int64, so the arithmetic shift equals the reference's exact
// float64 floor form, and the int32 wrap is numpy's
// astype(int64).astype(int32).  shift is clamped to 0..63 (the host
// scan clamps negative shifts to 0).
//
// What bounds it.  Bytes: S * n residuals read and S * n samples
// written (S = 2048, n = 4096 at the FLAC -8 stereo batch: 67 MB,
// 0.020 ms at 3.35 TB/s).  But each row is a serial recurrence of n
// steps, so a row takes at least n times the step's dependent chain,
// out[i-1] -> IMAD.WIDE -> SHF.R.S64 -> IADD -> out[i]: ~27 cycles on
// an H100, 4096 steps = 0.056 ms at 1.98 GHz, nearly 3x the byte
// bound.  With 2048 rows there are 128 warps, each alone on its
// scheduler, so the instructions a warp dispatches per step set the
// time, and its IMAD.WIDEs dominate: one holds the dispatch ~9-10
// cycles (a 32-bit IMAD ~2), and a step needs one for each tap it
// multiplies.
// (Cycle counts: tools_dev/int_op_cycles.py.)
//
// Design, point by point:
// - Memory.  A warp owns 16 rows and stages their residuals kStages
//   tiles of 32 samples ahead through shared memory with 16-byte
//   cp.async copies, and writes its samples back through an output
//   tile the same way (row_tiles.cuh): coalesced both ways, where a
//   row-per-thread walk of device memory touches 32 lines 16 KB apart
//   every step.  One warp a block spreads the blocks over 128 SMs.
// - One IMAD.WIDE a tap.  Each product is a PTX mad.wide.s32
//   (mad_wide below); int64 C++ arithmetic compiled to a full 64-bit
//   product, four instructions a tap.
// - The chain.  The older taps are summed first, sum_{j>=1} q[j] *
//   out[i-1-j], while the previous step finishes; q[0] * out[i-1]
//   enters last, so the chain is one multiply-add, the shift and the
//   add.
// - History in registers.  The tile loop is unrolled and the last
//   samples live in a ring of R registers (R a power of two >= taps,
//   dividing the tile), indexed statically: nothing moves.
// - Warm-up.  Only tiles that start below the warp's largest order
//   take the variant that selects the stored warm-up samples (patched
//   into the residual tile); every other tile runs without the test.
// - Taps.  The host passes the batch's nonzero coefficient columns;
//   the kernel multiplies K = 4, 8, 12, 16 or 32 of them (12 at -8),
//   not the array's width.
// - Rows per warp.  16 rows a warp, two threads a row: both compute
//   taps 0 and 1 and each takes half of taps 2..K-1 (7 IMAD.WIDEs a
//   step at K 12), and one 64-bit __shfl_xor_sync joins the halves.
//   Thread 1 sums its half for step i+1 at step i and sends it a step
//   later, so both threads read the same static ring slots; the
//   exchange (~30 cycles) sits two steps before the chain that needs
//   it.  This beat 32 rows a warp, one thread a row (K IMAD.WIDEs a
//   step), by 15-20 % at -8 (PERF.md, section 6).

#include <cstdint>
#include <cuda_runtime.h>

#include "row_tiles.cuh"

namespace {

using atpu::kTile;

__host__ __device__ constexpr int ring_size(int k) {
  return k <= 4 ? 4 : k <= 8 ? 8 : k <= 16 ? 16 : 32;
}

// c + a * b for int32 a, b and int64 c: one IMAD.WIDE.  Written as
// int64 C++, the product became a full 64 x 64-bit one (IMAD.WIDE.U32,
// two IMADs for the sign words and an add); as PTX mad.wide.s32 the
// compiler also cannot reassociate the sums written below.
__device__ __forceinline__ int64_t mad_wide(int32_t a, int32_t b, int64_t c) {
  int64_t d;
  asm("mad.wide.s32 %0, %1, %2, %3;" : "=l"(d) : "r"(a), "r"(b), "l"(c));
  return d;
}

// coefficient registers a thread keeps: taps 0 and 1 and its half of
// taps 2..K-1
__host__ __device__ constexpr int coeff_regs(int k) {
  return 2 + (k - 2) / 2;
}

// Computes one tile of the thread's row: kTile steps from residuals in
// `in` into `out_tile`.  WARM: the tile holds warm-up positions
// (c0 + i < ord), whose residual slots carry the stored samples.
template <int K, bool WARM>
__device__ __forceinline__ void run_tile(
    const int32_t* in, int32_t* out_tile, int r, int h, int c0, int ord,
    int sh, const int32_t (&q)[coeff_regs(K)],
    int32_t (&hist)[ring_size(K)], int64_t& lag) {
  constexpr int R = ring_size(K);
  constexpr int M = (K - 2) / 2;
#pragma unroll
  for (int c = 0; c < kTile; c += 4) {
    const int4 rv =
        *reinterpret_cast<const int4*>(in + atpu::tile_word(r, c));
    const int32_t res[4] = {rv.x, rv.y, rv.z, rv.w};
    int32_t v4[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int i = c + u;   // c0 % R == 0: slot of out[c0 + i] is i % R
      // this thread's half of taps 2..K-1 against out[i-3-2m]: thread
      // 0's are taps 2+2m of step i, thread 1's taps 3+2m of step i+1
      int64_t part = 0;
#pragma unroll
      for (int m = M - 1; m >= 0; --m) {
        part = mad_wide(q[2 + m], hist[(i - 3 - 2 * m) & (R - 1)], part);
      }
      const int64_t send = h ? lag : part;
      lag = part;
      int64_t acc = send + __shfl_xor_sync(0xffffffffu, send, 1);
      acc = mad_wide(q[1], hist[(i - 2) & (R - 1)], acc);
      acc = mad_wide(q[0], hist[(i - 1) & (R - 1)], acc);
      int32_t v = static_cast<int32_t>(static_cast<uint32_t>(res[u]) +
                                       static_cast<uint32_t>(acc >> sh));
      if (WARM && c0 + i < ord) {
        v = res[u];
      }
      hist[i & (R - 1)] = v;
      v4[u] = v;
    }
    if (h == 0) {
      *reinterpret_cast<int4*>(out_tile + atpu::tile_word(r, c)) =
          make_int4(v4[0], v4[1], v4[2], v4[3]);
    }
  }
}

template <int K>
__global__ void __launch_bounds__(32)
flac_synth_kernel(const int32_t* __restrict__ residuals,
                  const int32_t* __restrict__ warmup,
                  const int32_t* __restrict__ qlp,
                  const int32_t* __restrict__ shift,
                  const int32_t* __restrict__ order,
                  int s_count, int n, int kw, bool vec,
                  int32_t* __restrict__ out) {
  constexpr int ROWS = 16;
  constexpr int NQ = coeff_regs(K);
  __shared__ __align__(16) int32_t in_tiles[atpu::kStages][ROWS * kTile];
  __shared__ __align__(16) int32_t out_tile[ROWS * kTile];

  const int lane = threadIdx.x;
  const int r = lane / 2;
  const int h = lane % 2;
  const int s0 = blockIdx.x * ROWS;
  const int s = s0 + r;
  const bool live = s < s_count;
  const int64_t qrow = static_cast<int64_t>(s) * kw;

  int32_t q[NQ];
#pragma unroll
  for (int m = 0; m < NQ; ++m) {
    const int j = m < 2 ? m : 2 + 2 * (m - 2) + h;
    q[m] = live && j < kw ? qlp[qrow + j] : 0;
  }
  const int sh = live ? min(max(shift[s], 0), 63) : 0;
  const int ord = live ? order[s] : 0;
  const int max_ord = __reduce_max_sync(0xffffffffu, ord);

  int32_t hist[ring_size(K)];
#pragma unroll
  for (int j = 0; j < ring_size(K); ++j) {
    hist[j] = 0;
  }
  int64_t lag = 0;

  const int tiles = (n + kTile - 1) / kTile;
  const atpu::RowTiles<ROWS> io(residuals, out, s_count, n, s0, vec, lane);
  io.prefetch(in_tiles, tiles);
  for (int t = 0; t < tiles; ++t) {
    int32_t* in = io.next(in_tiles, t, tiles);
    const int c0 = t * kTile;
    if (c0 < max_ord) {
      if (h == 0) {
        for (int i = 0; i < kTile && c0 + i < ord; ++i) {
          in[atpu::tile_word(r, i)] =
              c0 + i < kw ? warmup[qrow + c0 + i] : 0;
        }
      }
      __syncwarp();
      run_tile<K, true>(in, out_tile, r, h, c0, ord, sh, q, hist, lag);
    } else {
      run_tile<K, false>(in, out_tile, r, h, c0, ord, sh, q, hist, lag);
    }
    io.finish(out_tile, c0);
  }
}

template <int K>
void launch(const int32_t* r, const int32_t* w, const int32_t* q,
            const int32_t* sh, const int32_t* o, int s_count, int n, int kw,
            bool vec, int32_t* dst, cudaStream_t st) {
  flac_synth_kernel<K><<<(s_count + 15) / 16, 32, 0, st>>>(
      r, w, q, sh, o, s_count, n, kw, vec, dst);
}

}  // namespace

// residuals: int32 [s_count, n]; warmup, qlp: int32 [s_count, kw] with
// 1 <= kw <= 32; shift, order: int32 [s_count]; out: int32
// [s_count, n].  All device pointers, contiguous.  taps (0..kw): the
// coefficient columns that may be nonzero (qlp[:, taps:] must be 0).
// Launches on `stream` without synchronising and returns
// cudaGetLastError().
extern "C" int atpu_flac_synth(const void* residuals, const void* warmup,
                               const void* qlp, const void* shift,
                               const void* order, int s_count, int n,
                               int kw, int taps, void* out,
                               void* stream) {
  if (s_count <= 0 || n <= 0) {
    return 0;
  }
  if (kw < 1 || kw > 32 || taps < 0 || taps > kw) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* r = static_cast<const int32_t*>(residuals);
  const auto* w = static_cast<const int32_t*>(warmup);
  const auto* q = static_cast<const int32_t*>(qlp);
  const auto* sh = static_cast<const int32_t*>(shift);
  const auto* o = static_cast<const int32_t*>(order);
  auto* dst = static_cast<int32_t*>(out);
  const bool vec = atpu::rows_vectorizable(residuals, out, n);
  if (taps <= 4) {
    launch<4>(r, w, q, sh, o, s_count, n, kw, vec, dst, st);
  } else if (taps <= 8) {
    launch<8>(r, w, q, sh, o, s_count, n, kw, vec, dst, st);
  } else if (taps <= 12) {
    launch<12>(r, w, q, sh, o, s_count, n, kw, vec, dst, st);
  } else if (taps <= 16) {
    launch<16>(r, w, q, sh, o, s_count, n, kw, vec, dst, st);
  } else {
    launch<32>(r, w, q, sh, o, s_count, n, kw, vec, dst, st);
  }
  return static_cast<int>(cudaGetLastError());
}
