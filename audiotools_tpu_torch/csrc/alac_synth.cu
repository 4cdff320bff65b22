// ALAC sign-adaptive predictor synthesis for NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel audiotools_tpu/ops/alac_synth.py:233
// (_synthesize_pallas), and with it the reference's host guard
// (pallas_synthesis_safe): the prediction sum is exact, so 24-bit rows
// and drifting coefficients stay exact.
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
// What bounds it.  Bytes: S * n residuals read and S * n samples
// written (S = 2048, n = 4096 at a 1024-frameset stereo batch: 67 MB,
// 0.020 ms at 3.35 TB/s).  But a row is a serial recurrence, and 2048
// rows, 16 a warp, make 128 warps, each alone on its scheduler: the
// instructions a warp dispatches per step, and the latency it cannot
// hide among them, set the time.  At order 8 a thread dispatches ~91
// instructions a step (a row on one thread took 141).  The samples'
// own chain, out[i-1] -> IMAD -> SHF -> IADD -> LOP3 -> IADD -> out[i],
// is far shorter (tools_dev/int_op_cycles.py times it: PERF.md).
//
// Design, point by point:
// - Memory.  Each warp stages its 16 rows' residuals kStages tiles of
//   32 samples ahead through shared memory with 16-byte cp.async
//   copies and writes its samples back through an output tile
//   (row_tiles.cuh), instead of touching 32 lines 16 KB apart at every
//   step.  The rows are gathered: the host lists them grouped by order
//   (`rows`, 16 a warp), so every warp's rows share one order.
// - A static order.  A warp whose rows share an order 0..8 (and walk
//   at least that many steps) runs an instance compiled for it: base is
//   w[ORDER], a static register; one for the difference chain; any
//   other warp (orders 9..30, mixed orders, a shorter walk) runs the
//   generic KMAX = 32 loop, one sample at a time.
// - Two threads a row.  Thread 1 takes the walk's first ORDER/2 steps
//   (the oldest samples, j = ORDER-1 down) and their taps; thread 0 the
//   rest, down to j = 1.  Each sums its taps and one shuffle joins the
//   halves; coefficient 0, whose product with out[i-1] enters last, is
//   held by both.  In the walk, thread 0's residual starts after thread
//   1's deltas (one shuffle) and its steps live only if all of thread
//   1's were (a ballot); a second ballot gives both threads j = 0's
//   flag.  Every lane shuffles and votes: none sits in a branch.  This
//   beat 32 rows a warp, one thread a row, by 17 % (PERF.md, section 6).
// - Narrow sums.  Only bits [shift, shift + sample_size) of the sum
//   reach out[i].  When shift + sample_size <= 32 on all of a warp's
//   rows (16-bit audio), the sum runs modulo 2^32 with one 32-bit IMAD
//   a tap; otherwise (24-bit) with one PTX mad.wide.s32 a tap, exact in
//   int64 (C++ int64 products compile to a full 64 x 64-bit product).
// - The chain.  The older taps are summed first; in the narrow sum
//   q[0] * (out[i-1] - base) enters as q[0] * out[i-1] after
//   -q[0] * base, so the chain is one IMAD, the shift, the add and the
//   truncation.  The walk of step i reads only the window before out[i]
//   and changes only the q of step i+1, so it stays off the chain.
// - A walk without branches.  For static t, val_t, sgn_t and
//   delta_t = ((val_t * sgn_t) >> shift) * (t+1) do not depend on the
//   running residual, which before step t is res[i] - sum_{u<t} delta_u;
//   a step is live while (residual * s0 > 0) held at it and at every
//   step before (a sticky AND: a step that fails leaves the residual as
//   it was, so every later step fails too).  q[j] -= live ? sgn_t : 0
//   as one multiply-add, (live ? -s0 : 0) * sign(val), and val * sgn =
//   |val| * s0.
// - History in registers.  The last ORDER + 1 samples live in a ring of
//   R registers (R a power of two, dividing the tile), indexed
//   statically over an unrolled group of max(R, 8) samples: nothing
//   moves.  Warm-up (i <= order) happens only in the first tile.

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

#include "row_tiles.cuh"

namespace {

using atpu::kTile;

constexpr int kRows = 16;   // rows a warp, two threads a row
constexpr int kmax = 32;    // coefficients of the generic loop
constexpr int kChain = 31;  // orders from here up: the difference chain

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

// -1, 0 or 1 (two IMNMX)
__device__ __forceinline__ int32_t sign_of(int32_t v) {
  return min(max(v, -1), 1);
}

// |v| modulo 2^32 (IABS): |INT_MIN| = INT_MIN
__device__ __forceinline__ uint32_t uabs(int32_t v) {
  return static_cast<uint32_t>(v < 0 ? -static_cast<int64_t>(v) : v);
}

// c + a * b for int32 a, b and int64 c: one IMAD.WIDE (see flac_synth.cu)
__device__ __forceinline__ int64_t mad_wide(int32_t a, int32_t b, int64_t c) {
  int64_t d;
  asm("mad.wide.s32 %0, %1, %2, %3;" : "=l"(d) : "r"(a), "r"(b), "l"(c));
  return d;
}

// a row's shift and truncation
struct RowParams {
  int sh;          // 0..31
  uint32_t nmask;  // 2^size - 1
  uint32_t sbit;   // 2^(size - 1)
  uint32_t half;   // 1 << min(sh - 1, 30) for sh > 0, else 0
};

__device__ __forceinline__ int32_t trunc_bits(uint32_t v, const RowParams& p) {
  return static_cast<int32_t>(((v & p.nmask) ^ p.sbit) - p.sbit);
}

// ring registers for order o: the least power of two >= o + 1
__host__ __device__ constexpr int ring_len(int o) {
  return o < 1 ? 1 : o < 2 ? 2 : o < 4 ? 4 : o < 8 ? 8 : 16;
}

// a thread's place: lanes 2 r and 2 r + 1 work on tile row r
struct Lane {
  int r;      // tile row
  int h;      // which thread of the row
  int pair;   // lane 2 r
  // thread 0 writes the row's four samples at c (a multiple of 4)
  __device__ __forceinline__ void store4(int32_t* tile, int c,
                                         const int32_t (&v)[4]) const {
    if (h == 0) {
      *reinterpret_cast<int4*>(tile + atpu::tile_word(r, c)) =
          make_int4(v[0], v[1], v[2], v[3]);
    }
  }
};

// walk steps a thread of a row takes at order o: thread 0 takes t =
// o/2 .. o-1 (its last is j = 0), thread 1 t = 0 .. o/2-1 (for odd o
// its last of the L is a dummy)
__host__ __device__ constexpr int half_steps(int o) { return o - o / 2; }

// one predicted step of a static order, split between the row's two
// threads: out[i] from res[i], then the walk's update of q for step
// i+1.  k: the step's static ring position (slot of out[i - 1 - j] is
// (k - 1 - j) % R).  q[u]: the coefficient of the thread's walk step u
// (thread 1: j = ORDER-1-u; thread 0: j = L-1-u for u < L-1, and its
// q[L-1] stays 0); q0: coefficient 0, held by both threads alike.
// h: which thread of the row; pair: the bit of lane & ~1.
template <int ORDER, bool WIDE>
__device__ __forceinline__ int32_t predict(
    int k, int32_t r, const RowParams& p, int h, int pair,
    int32_t (&q)[half_steps(ORDER) > 0 ? half_steps(ORDER) : 1],
    int32_t& q0, const int32_t (&hist)[ring_len(ORDER)]) {
  constexpr int R = ring_len(ORDER);
  constexpr int L = half_steps(ORDER);
  constexpr int A = ORDER / 2;      // thread 1's walk steps
  constexpr bool ODD = ORDER % 2 != 0;
  constexpr unsigned kAll = 0xffffffffu;
  const int32_t base = hist[(k - 1 - ORDER) & (R - 1)];
  const int32_t w0 = hist[(k - 1) & (R - 1)];

  // w[j] of the thread's steps (thread 1's lie A slots further back)
  int32_t wv[L > 0 ? L : 1];
#pragma unroll
  for (int u = 0; u < L; ++u) {
    wv[u] = h ? hist[(k - ORDER + u) & (R - 1)] : hist[(k - L + u) & (R - 1)];
  }

  // the sum: each thread's share of taps 1..ORDER-1 (thread 0's q[L-1]
  // is coefficient 0, which enters last, in both threads alike)
  uint32_t x;
  if constexpr (WIDE) {
    int64_t part = 0;
#pragma unroll
    for (int u = 0; u < (ODD ? L - 1 : L); ++u) {
      const int32_t wd = u == L - 1 ? (h ? wv[u] : base) : wv[u];
      part = mad_wide(q[u], wrap_sub(wd, base), part);
    }
    int64_t acc = p.half + part + __shfl_xor_sync(kAll, part, 1);
    if constexpr (ORDER > 0) {
      acc = mad_wide(q0, wrap_sub(w0, base), acc);
    }
    x = static_cast<uint32_t>(acc >> p.sh);
  } else {
    // bits [sh, sh + size) of the sum, sh + size <= 32: modulo 2^32
    uint32_t part = 0;
#pragma unroll
    for (int u = 0; u < (ODD ? L - 1 : L); ++u) {
      const int32_t wd = u == L - 1 ? (h ? wv[u] : base) : wv[u];
      part += static_cast<uint32_t>(q[u]) *
              static_cast<uint32_t>(wrap_sub(wd, base));
    }
    uint32_t acc = p.half + part + __shfl_xor_sync(kAll, part, 1);
    if constexpr (ORDER > 0) {
      acc -= static_cast<uint32_t>(q0) * static_cast<uint32_t>(base);
      acc += static_cast<uint32_t>(q0) * static_cast<uint32_t>(w0);
    }
    x = acc >> p.sh;
  }
  const int32_t v = trunc_bits(x + static_cast<uint32_t>(r) +
                               static_cast<uint32_t>(base), p);
  if constexpr (ORDER == 0) {
    return v;
  }

  // the walk, over the window before out[i].  Each thread sums its
  // steps' deltas (val * sgn as |val| * s0, modulo 2^32, |INT_MIN| =
  // INT_MIN as in the reference); thread 0's residual starts after
  // thread 1's deltas, and its steps are live only if all of thread 1's
  // were (both exchanged once); the live flag of j = 0 is thread 0's
  // last, which both threads apply to q0
  const int32_t s0 = sign_of(r);
  int32_t val[L > 0 ? L : 1];
  uint32_t spent[L + 1];
  spent[0] = 0;
#pragma unroll
  for (int u = 0; u < L; ++u) {
    val[u] = wrap_sub(base, wv[u]);
    if (!(ODD && u == L - 1)) {
      const int mult = (h ? 0 : A) + u + 1;   // t + 1
      spent[u + 1] = spent[u] + static_cast<uint32_t>(wrap_mul(
          wrap_mul(static_cast<int32_t>(uabs(val[u])), s0) >> p.sh, mult));
    } else {
      spent[u + 1] = spent[u];
    }
  }
  // (every lane shuffles and votes: none of them sits in a branch)
  const uint32_t partner = static_cast<uint32_t>(
      __shfl_xor_sync(kAll, static_cast<int32_t>(spent[L]), 1));
  const uint32_t before = h ? 0u : partner;
  const int32_t rb = wrap_sub(r, static_cast<int32_t>(before));
  bool live[L > 0 ? L : 1];
  bool all = true;
#pragma unroll
  for (int u = 0; u < L; ++u) {
    bool c = wrap_mul(wrap_sub(rb, static_cast<int32_t>(spent[u])), s0) > 0;
    if (ODD && u == L - 1) {
      c = c || h != 0;   // thread 1's dummy step
    }
    all = all && c;
    live[u] = all;
  }
  // thread 1's steps all live, for thread 0; then j = 0's flag
  const unsigned alls = __ballot_sync(kAll, all);
  const bool live_in = h != 0 || ((alls >> (pair + 1)) & 1u) != 0;
  const unsigned lasts = __ballot_sync(kAll, live_in && all);
  const bool live0 = ((lasts >> pair) & 1u) != 0;
  // q[j] -= live ? s0 * sign(val) : 0, as one multiply-add each: -s0
  // where the step is live (else 0) times sign(val)
  const int32_t ns0 = live_in ? wrap_sub(0, s0) : 0;
#pragma unroll
  for (int u = 0; u < L; ++u) {
    // thread 0's step L-1 is j = 0 (q0, below); so is nothing of
    // thread 1's for even orders, its dummy for odd ones
    const bool keep = u < L - 1 || (!ODD && h);
    q[u] = wrap_add(q[u], wrap_mul(keep && live[u] ? ns0 : 0,
                                   sign_of(val[u])));
  }
  q0 = wrap_add(q0, wrap_mul(live0 ? wrap_sub(0, s0) : 0,
                             sign_of(wrap_sub(base, w0))));
  return v;
}

// one tile of a static order: kTile steps from the residual tile `in`
// into `out_tile`.  FIRST: the row's first tile (warm-up).
template <int ORDER, bool WIDE, bool FIRST>
__device__ __forceinline__ void order_tile(
    const int32_t* in, int32_t* out_tile, const Lane& ln, const RowParams& p,
    int32_t (&q)[half_steps(ORDER) > 0 ? half_steps(ORDER) : 1], int32_t& q0,
    int32_t (&hist)[ring_len(ORDER)]) {
  constexpr int R = ring_len(ORDER);
  constexpr int U = R < 8 ? 8 : R;   // unrolled steps: a multiple of R
#pragma unroll 1
  for (int c = 0; c < kTile; c += U) {
#pragma unroll
    for (int c4 = 0; c4 < U; c4 += 4) {
      const int4 rv =
          *reinterpret_cast<const int4*>(in + atpu::tile_word(ln.r, c + c4));
      const int32_t res[4] = {rv.x, rv.y, rv.z, rv.w};
      int32_t v4[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int k = c4 + u;   // c % R == 0: out[c + k] goes to slot k % R
        int32_t v;
        if (FIRST && c + k == 0) {
          v = res[u];
        } else if (FIRST && c + k <= ORDER) {
          v = trunc_bits(static_cast<uint32_t>(hist[(k - 1) & (R - 1)]) +
                             static_cast<uint32_t>(res[u]), p);
        } else {
          v = predict<ORDER, WIDE>(k, res[u], p, ln.h, ln.pair, q, q0, hist);
        }
        hist[k & (R - 1)] = v;
        v4[u] = v;
      }
      ln.store4(out_tile, c + c4, v4);
    }
  }
}

// the tile loop shared by every instance: tile(in, t) computes tile t
template <class Tile>
__device__ __forceinline__ void run_tiles(
    const atpu::RowTiles<kRows, true>& io,
    int32_t (*in_tiles)[kRows * kTile], int32_t* out_tile, int n,
    Tile tile) {
  const int tiles = (n + kTile - 1) / kTile;
  io.prefetch(in_tiles, tiles);
  for (int t = 0; t < tiles; ++t) {
    const int32_t* in = io.next(in_tiles, t, tiles);
    tile(in, t);
    io.finish(out_tile, t * kTile);
  }
}

template <int ORDER, bool WIDE>
__device__ __forceinline__ void run_order(
    const atpu::RowTiles<kRows, true>& io,
    int32_t (*in_tiles)[kRows * kTile], int32_t* out_tile, const Lane& ln,
    int n, const RowParams& p, const int32_t* qrow, int kw) {
  constexpr int L = half_steps(ORDER);
  constexpr int A = ORDER / 2;
  int32_t q[L > 0 ? L : 1];
  int32_t hist[ring_len(ORDER)];
#pragma unroll
  for (int u = 0; u < (L > 0 ? L : 1); ++u) {
    // the coefficient of the thread's walk step u (predict)
    const int j = ln.h ? (u < A ? ORDER - 1 - u : -1)
                       : (u < L - 1 ? L - 1 - u : -1);
    q[u] = qrow != nullptr && j >= 0 && j < kw ? qrow[j] : 0;
  }
  int32_t q0 = qrow != nullptr && ORDER > 0 ? qrow[0] : 0;
#pragma unroll
  for (int j = 0; j < ring_len(ORDER); ++j) {
    hist[j] = 0;
  }
  run_tiles(io, in_tiles, out_tile, n, [&](const int32_t* in, int t) {
    if (t == 0) {
      order_tile<ORDER, WIDE, true>(in, out_tile, ln, p, q, q0, hist);
    } else {
      order_tile<ORDER, WIDE, false>(in, out_tile, ln, p, q, q0, hist);
    }
  });
}

// the difference chain (order >= 31): out[i] = trunc(out[i-1] + res[i])
__device__ __forceinline__ void run_chain(
    const atpu::RowTiles<kRows, true>& io,
    int32_t (*in_tiles)[kRows * kTile], int32_t* out_tile, const Lane& ln,
    int n, const RowParams& p) {
  int32_t prev = 0;
  run_tiles(io, in_tiles, out_tile, n, [&](const int32_t* in, int t) {
#pragma unroll
    for (int c = 0; c < kTile; c += 4) {
      const int4 rv =
          *reinterpret_cast<const int4*>(in + atpu::tile_word(ln.r, c));
      const int32_t res[4] = {rv.x, rv.y, rv.z, rv.w};
      int32_t v4[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        prev = t == 0 && c + u == 0
                   ? res[u]
                   : trunc_bits(static_cast<uint32_t>(prev) +
                                    static_cast<uint32_t>(res[u]), p);
        v4[u] = prev;
      }
      ln.store4(out_tile, c, v4);
    }
  });
}

// any order, any walk length: one sample at a time, the window (kmax +
// 1 samples) and the coefficients (kmax) in registers, the walk over j
// from kmax-1 down to 0 live where order - max_order <= j < order, and
// base a select over the window; both threads of a row compute it all
__device__ __forceinline__ void run_generic(
    const atpu::RowTiles<kRows, true>& io,
    int32_t (*in_tiles)[kRows * kTile], int32_t* out_tile, const Lane& ln,
    int n, const RowParams& p, const int32_t* qrow, int kw, int ord,
    int max_order) {
  const int ord_eff = ord >= kChain ? n : ord;
  const int walk_lo = ord - max_order;
  const int64_t half = p.half;
  int32_t q[kmax];
  int32_t w[kmax + 1];   // w[j] = out[i - 1 - j]
#pragma unroll
  for (int j = 0; j < kmax; ++j) {
    q[j] = qrow != nullptr && j < ord && j < kw ? qrow[j] : 0;
    w[j] = 0;
  }
  w[kmax] = 0;
  run_tiles(io, in_tiles, out_tile, n, [&](const int32_t* in, int t) {
#pragma unroll 1
    for (int c = 0; c < kTile; ++c) {
      const int i = t * kTile + c;
      const int32_t r = in[atpu::tile_word(ln.r, c)];
      int32_t v;
      if (i == 0) {
        v = r;
      } else if (i <= ord_eff) {
        v = trunc_bits(static_cast<uint32_t>(wrap_add(w[0], r)), p);
      } else {
        int32_t base = 0;
#pragma unroll
        for (int j = 0; j <= kmax; ++j) {
          base = j == ord ? w[j] : base;
        }
        int64_t acc = 0;
#pragma unroll
        for (int j = 0; j < kmax; ++j) {
          acc = mad_wide(q[j], wrap_sub(w[j], base), acc);
        }
        const int64_t pred = ((half + acc) >> p.sh) + r + base;
        v = trunc_bits(static_cast<uint32_t>(pred), p);

        const int32_t s0 = sign_of(r);
        int32_t residual = r;
#pragma unroll
        for (int j = kmax - 1; j >= 0; --j) {
          if (j < ord && j >= walk_lo && wrap_mul(residual, s0) > 0) {
            const int32_t val = wrap_sub(base, w[j]);
            const int32_t sgn = s0 * sign_of(val);
            q[j] = wrap_sub(q[j], sgn);
            residual = wrap_sub(
                residual, wrap_mul(wrap_mul(val, sgn) >> p.sh, ord - j));
          }
        }
      }
      if (ln.h == 0) {
        out_tile[atpu::tile_word(ln.r, c)] = v;
      }
#pragma unroll
      for (int j = kmax; j > 0; --j) {
        w[j] = w[j - 1];
      }
      w[0] = v;
    }
  });
}

template <int ORDER>
__device__ __forceinline__ void run_static(
    bool wide, const atpu::RowTiles<kRows, true>& io,
    int32_t (*in_tiles)[kRows * kTile], int32_t* out_tile, const Lane& ln,
    int n, const RowParams& p, const int32_t* qrow, int kw) {
  if (wide) {
    run_order<ORDER, true>(io, in_tiles, out_tile, ln, n, p, qrow, kw);
  } else {
    run_order<ORDER, false>(io, in_tiles, out_tile, ln, n, p, qrow, kw);
  }
}

// one warp a block; warp b synthesizes rows rows[16 b .. 16 b + 15]
// (-1, or a row outside 0..s_count-1: none), lanes 2 r and 2 r + 1 row
// rows[16 b + r]
__global__ void __launch_bounds__(32)
alac_synth_kernel(const int32_t* __restrict__ residuals,
                  const int32_t* __restrict__ qlp,
                  const int32_t* __restrict__ order,
                  const int32_t* __restrict__ shift,
                  const int32_t* __restrict__ sample_size,
                  const int32_t* __restrict__ rows, int s_count, int n,
                  int kw, int max_order, bool vec,
                  int32_t* __restrict__ out) {
  __shared__ __align__(16) int32_t in_tiles[atpu::kStages][kRows * kTile];
  __shared__ __align__(16) int32_t out_tile[kRows * kTile];
  constexpr unsigned kAll = 0xffffffffu;
  const int lane = threadIdx.x;
  const Lane ln{lane >> 1, lane & 1, lane & ~1};
  int s = rows[static_cast<int64_t>(blockIdx.x) * kRows + ln.r];
  s = s >= 0 && s < s_count ? s : -1;
  const bool live = s >= 0;
  if (__all_sync(kAll, !live)) {
    return;
  }
  const int ord = live ? order[s] : 0;
  const int sh = live ? min(max(shift[s], 0), 31) : 0;
  const int ss = live ? min(max(sample_size[s], 1), 30) : 1;
  const RowParams p{sh, static_cast<uint32_t>((1u << ss) - 1u),
                    1u << (ss - 1),
                    sh > 0 ? 1u << min(sh - 1, 30) : 0u};
  const int32_t* qrow = live ? qlp + static_cast<int64_t>(s) * kw : nullptr;
  const int omin = __reduce_min_sync(kAll, live ? ord : INT_MAX);
  const int omax = __reduce_max_sync(kAll, live ? ord : INT_MIN);
  const bool wide = !__all_sync(kAll, !live || sh + ss <= 32);

  const atpu::RowTiles<kRows, true> io(residuals, out, s_count, n, s, vec,
                                       lane);
  if (omin >= kChain) {
    run_chain(io, in_tiles, out_tile, ln, n, p);
    return;
  }
  if (omin != omax || omax > 8 || max_order < omax) {
    run_generic(io, in_tiles, out_tile, ln, n, p, qrow, kw, ord, max_order);
    return;
  }
  switch (omax) {
    case 0: run_static<0>(wide, io, in_tiles, out_tile, ln, n, p, qrow, kw); break;
    case 1: run_static<1>(wide, io, in_tiles, out_tile, ln, n, p, qrow, kw); break;
    case 2: run_static<2>(wide, io, in_tiles, out_tile, ln, n, p, qrow, kw); break;
    case 3: run_static<3>(wide, io, in_tiles, out_tile, ln, n, p, qrow, kw); break;
    case 4: run_static<4>(wide, io, in_tiles, out_tile, ln, n, p, qrow, kw); break;
    case 5: run_static<5>(wide, io, in_tiles, out_tile, ln, n, p, qrow, kw); break;
    case 6: run_static<6>(wide, io, in_tiles, out_tile, ln, n, p, qrow, kw); break;
    case 7: run_static<7>(wide, io, in_tiles, out_tile, ln, n, p, qrow, kw); break;
    default: run_static<8>(wide, io, in_tiles, out_tile, ln, n, p, qrow, kw); break;
  }
}

}  // namespace

// residuals: int32 [s_count, n]; qlp: int32 [s_count, kw], 1 <= kw <=
// 32, holding every coefficient of a row with order < 31; order,
// shift (0..31), sample_size: int32 [s_count]; rows: int32
// [row_slots], row_slots a multiple of 16, each row 0..s_count-1 once,
// grouped 16 a warp (-1 pads), the rows of a warp best of one order;
// out: int32 [s_count, n];
// max_order: walk steps (1..32).  All device pointers, contiguous.
// Launches on `stream` without synchronising and returns
// cudaGetLastError().
extern "C" int atpu_alac_synth(const void* residuals, const void* qlp,
                               const void* order, const void* shift,
                               const void* sample_size, const void* rows,
                               int s_count, int n, int kw, int max_order,
                               int row_slots, void* out, void* stream) {
  if (s_count <= 0 || n <= 0 || row_slots <= 0) {
    return 0;
  }
  if (kw < 1 || kw > 32 || max_order < 1 || max_order > 32 ||
      row_slots % kRows != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  alac_synth_kernel<<<row_slots / kRows, 32, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(residuals),
      static_cast<const int32_t*>(qlp), static_cast<const int32_t*>(order),
      static_cast<const int32_t*>(shift),
      static_cast<const int32_t*>(sample_size),
      static_cast<const int32_t*>(rows), s_count, n, kw, max_order,
      atpu::rows_vectorizable(residuals, out, n),
      static_cast<int32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}
