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
// ms at 3.35 TB/s).  But each lane is a serial recurrence of n steps,
// and 512 lanes are 16 warps: a lane takes at least n times the step's
// dependent chain, and a warp alone on its scheduler pays for every
// instruction it issues.
//
// The look-ahead.  Write DL(i), DX(i) and QM(i) for dl, dx before step
// i's rotation and qm after step i's update, and sgn(i) = sign(res[i-1]).
// In the encoder p is an input, so DL and DX depend on the inputs
// alone, and so do
//   b(i) = DL(i) . DX(i)   and   c(i) = DL(i) . DX(i-1).
// Since QM(i) = QM(i-2) + sgn(i-1) DX(i-1) + sgn(i) DX(i), mod 2^32
//   acc(i) = a'(i) + sgn(i-1) c(i) + sgn(i) b(i),
//   a'(i)  = round + DL(i) . QM(i-2).
// a'(i) and the qm update QM(i-1) = QM(i-2) + sgn(i-1) DX(i-1) need
// signs one step old, so the 8-term dot product has a whole step of
// slack, and the loop from one step to the next is the sign (shifts and
// logic), one multiply-add, the shift and the subtract
// (tools_dev/int_op_cycles.py TTA_FILTER_CASE).
//
// Design, point by point:
// - Two roles.  A CTA owns 32 lanes and runs two warps.  The input
//   warp stages the lanes' p through shared memory kStages tiles of 32
//   samples ahead with 16-byte cp.async copies (row_tiles.cuh), and
//   from p alone computes each step's dl tail (d5, d6, d7), the dx
//   signs, b and c.  The chain warp keeps qm in registers and runs the
//   recurrence above: a' and e = a' + sgn(i-1) c(i), the qm update,
//   then acc = e + sgn(i) b(i), the shift, the subtract and the sign.
//   It writes its residuals back through an output tile the same way.
// - Hand-off.  The input warp writes p, b, c, d5, d6, d7 and the four
//   dx signs of a whole tile into one of kStages buffers in shared
//   memory and arrives on that buffer's named barrier; the chain warp
//   waits there, reads the tile, and arrives on the buffer's other
//   barrier, on which the input warp waits before it writes the buffer
//   again.  One barrier a tile for each warp, and the input warp runs
//   up to kStages tiles ahead.  Recomputing d5 .. the signs in the
//   chain warp from p instead (11 more shifts, logic ops and subtracts
//   a step against 1.75 more 16-byte loads) was slower.
// - What is left.  The chain warp issues about 29 instructions a step,
//   20 of them IMADs (the qm update, the dot product, e and acc), and
//   alone on its scheduler takes about 68 cycles a step on an H100,
//   against the 29-cycle chain.  Updating qm with a LOP3 and an IADD3
//   instead of an IMAD, or lightening the input warp (b's and c's d5
//   terms as sliding windows), was no faster.
// - No moves.  dl and dx are windows on rings of 8 registers indexed
//   by the step (d5, d6, d7, p and the signs of d5, d6, d7, p), and each
//   8 steps (one turn of the rings) are unrolled, so every index is
//   static and the rotation renames registers instead of moving them
//   (as in tta_synth.cu).
// - Off the multiply-add pipe.  The signs and sign(res) come from
//   shifts and logic, not compares and selects.

#include <cstdint>
#include <cuda_runtime.h>

#include "row_tiles.cuh"

namespace {

using atpu::kStages;
using atpu::kTile;

constexpr int kRows = 32;
constexpr int kTileWords = kRows * kTile;
// the tiles of a hand-off buffer
enum { kP, kB, kC, kD5, kD6, kD7, kG4, kG5, kG6, kG7, kCross };
// dynamic shared memory: the input staging, the output tile, the
// hand-off buffers
constexpr int kSmemBytes =
    (kStages + 1 + kStages * kCross) * kTileWords * 4;
// named barriers (0 is __syncthreads'): buffer s full, buffer s free
constexpr int kFullBar = 1;
constexpr int kFreeBar = 1 + kStages;

__device__ __forceinline__ int32_t s(uint32_t v) {
  return static_cast<int32_t>(v);
}

__device__ __forceinline__ uint32_t sign_mask(uint32_t v) {
  return static_cast<uint32_t>(s(v) >> 31);
}

// sign(v) as -1, 0 or 1: its sign bit, or'ed with that of its negation
__device__ __forceinline__ uint32_t sign_of(uint32_t v) {
  return sign_mask(v) | ((0u - v) >> 31);
}

__device__ __forceinline__ void bar_sync(int id) {
  asm volatile("bar.sync %0, 64;\n" ::"r"(id) : "memory");
}

__device__ __forceinline__ void bar_arrive(int id) {
  asm volatile("bar.arrive %0, 64;\n" ::"r"(id) : "memory");
}

// the input-only history of a lane: the values of step k at slot k % 8
struct Rings {
  uint32_t d5[8], d6[8], d7[8], pv[8];
  uint32_t g4[8], g5[8], g6[8], g7[8];  // their signs as dx takes them

  // the all-zero state: the signs dx takes at step 1 read the zero dl
  // of step -1 (+1, +2, +2, +4), those of earlier steps are dx's zeros
  __device__ __forceinline__ void init() {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      d5[j] = d6[j] = d7[j] = pv[j] = 0;
      g4[j] = g5[j] = g6[j] = g7[j] = 0;
    }
    g4[7] = 1;
    g5[7] = 2;
    g6[7] = 2;
    g7[7] = 4;
  }

  // step i's dl tail and signs from its input p, into slot i % 8
  __device__ __forceinline__ void advance(int i, uint32_t p) {
    const uint32_t d7v = p - pv[(i - 1) & 7];
    const uint32_t d6v = d7v - d7[(i - 1) & 7];
    const uint32_t d5v = d6v - d6[(i - 1) & 7];
    pv[i & 7] = p;
    d7[i & 7] = d7v;
    d6[i & 7] = d6v;
    d5[i & 7] = d5v;
    // v >= 0 ? m : -m from v's sign mask (m = 1, 2, 2, 4)
    g4[i & 7] = sign_mask(d5v) | 1u;
    g5[i & 7] = (sign_mask(d6v) & 0xfffffffcu) + 2u;
    g6[i & 7] = (sign_mask(d7v) & 0xfffffffcu) + 2u;
    g7[i & 7] = (sign_mask(p) & 0xfffffff8u) + 4u;
  }

  // DL(i): d5 of steps i-5 .. i-1, then d6, d7, p of step i-1
  __device__ __forceinline__ void dl(int i, uint32_t (&v)[8]) const {
#pragma unroll
    for (int j = 0; j < 5; ++j) {
      v[j] = d5[(i - 5 + j) & 7];
    }
    v[5] = d6[(i - 1) & 7];
    v[6] = d7[(i - 1) & 7];
    v[7] = pv[(i - 1) & 7];
  }

  // DX(k): the d5 signs of steps k-6 .. k-2, then those of d6, d7, p of
  // step k-2
  __device__ __forceinline__ void dx(int k, uint32_t (&v)[8]) const {
#pragma unroll
    for (int j = 0; j < 5; ++j) {
      v[j] = g4[(k - 6 + j) & 7];
    }
    v[5] = g5[(k - 2) & 7];
    v[6] = g6[(k - 2) & 7];
    v[7] = g7[(k - 2) & 7];
  }
};

// init + a . b (written as a tree; the compiler sums it as one chain of
// IMADs, which the step of slack covers)
__device__ __forceinline__ uint32_t dot8(const uint32_t (&a)[8],
                                         const uint32_t (&b)[8],
                                         uint32_t init) {
  const uint32_t t0 = init + a[0] * b[0] + a[1] * b[1];
  const uint32_t t1 = a[2] * b[2] + a[3] * b[3];
  const uint32_t t2 = a[4] * b[4] + a[5] * b[5];
  const uint32_t t3 = a[6] * b[6] + a[7] * b[7];
  return (t0 + t1) + (t2 + t3);
}

__device__ __forceinline__ void store4(int32_t* tile, int w, uint32_t a,
                                       uint32_t b, uint32_t c, uint32_t d) {
  *reinterpret_cast<int4*>(tile + w) = make_int4(s(a), s(b), s(c), s(d));
}

__device__ __forceinline__ void load4(const int32_t* tile, int w,
                                      uint32_t (&v)[4]) {
  const int4 q = *reinterpret_cast<const int4*>(tile + w);
  v[0] = static_cast<uint32_t>(q.x);
  v[1] = static_cast<uint32_t>(q.y);
  v[2] = static_cast<uint32_t>(q.z);
  v[3] = static_cast<uint32_t>(q.w);
}

// The input warp: p tile by tile from device memory, and from it each
// step's p, b, c and the rings' new values into the hand-off buffers.
__device__ __forceinline__ void input_warp(
    const atpu::RowTiles<kRows>& io, int32_t (*in_tiles)[kTileWords],
    int32_t* hand, int tiles, int lane) {
  Rings r;
  r.init();
  io.prefetch(in_tiles, tiles);
  for (int t = 0; t < tiles; ++t) {
    const int32_t* in = io.next(in_tiles, t, tiles);
    const int st = t % kStages;
    if (t >= kStages) {
      bar_sync(kFreeBar + st);  // the chain warp is done with tile t - S
    }
    int32_t* h = hand + st * kCross * kTileWords;
#pragma unroll 1
    for (int c8 = 0; c8 < kTile; c8 += 8) {
#pragma unroll
      for (int c = 0; c < 8; c += 4) {
        const int w = atpu::tile_word(lane, c8 + c);
        uint32_t p4[4], b4[4], c4[4];
        load4(in, w, p4);
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int i = c + u;
          r.advance(i, p4[u]);
          uint32_t dl[8], dx[8], dxp[8];
          r.dl(i, dl);
          r.dx(i, dx);
          r.dx(i - 1, dxp);
          b4[u] = dot8(dl, dx, 0u);
          c4[u] = dot8(dl, dxp, 0u);
        }
#define RING4(ring) r.ring[c], r.ring[c + 1], r.ring[c + 2], r.ring[c + 3]
        store4(h + kP * kTileWords, w, RING4(pv));
        store4(h + kB * kTileWords, w, b4[0], b4[1], b4[2], b4[3]);
        store4(h + kC * kTileWords, w, c4[0], c4[1], c4[2], c4[3]);
        store4(h + kD5 * kTileWords, w, RING4(d5));
        store4(h + kD6 * kTileWords, w, RING4(d6));
        store4(h + kD7 * kTileWords, w, RING4(d7));
        store4(h + kG4 * kTileWords, w, RING4(g4));
        store4(h + kG5 * kTileWords, w, RING4(g5));
        store4(h + kG6 * kTileWords, w, RING4(g6));
        store4(h + kG7 * kTileWords, w, RING4(g7));
#undef RING4
      }
    }
    bar_arrive(kFullBar + st);
  }
}

// The chain warp: qm and the residuals, from the hand-off buffers.
__device__ __forceinline__ void chain_warp(const atpu::RowTiles<kRows>& io,
                                           int32_t* out_tile,
                                           const int32_t* hand, int tiles,
                                           int lane, int fshift) {
  const uint32_t round_v = 1u << (fshift - 1);
  Rings r;
  r.init();
  uint32_t qm[8];  // QM(i-2) at the start of step i
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    qm[j] = 0;
  }
  uint32_t sg_prev = 0;  // sgn(i-1)
  uint32_t sg = 0;       // sgn(i)
  for (int t = 0; t < tiles; ++t) {
    const int st = t % kStages;
    bar_sync(kFullBar + st);
    const int32_t* h = hand + st * kCross * kTileWords;
#pragma unroll 1
    for (int c8 = 0; c8 < kTile; c8 += 8) {
#pragma unroll
      for (int c = 0; c < 8; c += 4) {
        const int w = atpu::tile_word(lane, c8 + c);
        uint32_t x[kCross][4], res4[4];
#pragma unroll
        for (int q = 0; q < kCross; ++q) {
          load4(h + q * kTileWords, w, x[q]);
        }
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int i = c + u;
          // step i's own values enter slot i % 8, which step i does not
          // read (it reads steps i-7 .. i-1)
          r.pv[i] = x[kP][u];
          r.d5[i] = x[kD5][u];
          r.d6[i] = x[kD6][u];
          r.d7[i] = x[kD7][u];
          r.g4[i] = x[kG4][u];
          r.g5[i] = x[kG5][u];
          r.g6[i] = x[kG6][u];
          r.g7[i] = x[kG7][u];
          uint32_t dl[8], dxp[8];
          r.dl(i, dl);
          r.dx(i - 1, dxp);
          // a'(i) and e(i) need sgn(i-1) and QM(i-2): a step old
          const uint32_t e = dot8(dl, qm, round_v) + sg_prev * x[kC][u];
#pragma unroll
          for (int j = 0; j < 8; ++j) {  // QM(i-1)
            qm[j] += sg_prev * dxp[j];
          }
          // the chain: sgn(i) -> one multiply-add -> shift -> subtract
          const uint32_t acc = e + sg * x[kB][u];
          res4[u] = x[kP][u] - static_cast<uint32_t>(s(acc) >> fshift);
          sg_prev = sg;
          sg = sign_of(res4[u]);
        }
        store4(out_tile, w, res4[0], res4[1], res4[2], res4[3]);
      }
    }
    if (t + kStages < tiles) {
      bar_arrive(kFreeBar + st);  // the input warp may refill buffer st
    }
    io.finish(out_tile, t * kTile);
  }
}

__global__ void __launch_bounds__(64)
tta_filter_kernel(const int32_t* __restrict__ predicted, int lanes, int n,
                  int fshift, bool vec, int32_t* __restrict__ out) {
  extern __shared__ __align__(16) int32_t smem[];
  auto in_tiles = reinterpret_cast<int32_t (*)[kTileWords]>(smem);
  int32_t* out_tile = smem + kStages * kTileWords;
  int32_t* hand = out_tile + kTileWords;
  const int lane = threadIdx.x & 31;
  const int tiles = (n + kTile - 1) / kTile;
  const atpu::RowTiles<kRows> io(predicted, out, lanes, n,
                                 blockIdx.x * kRows, vec, lane);
  if (threadIdx.x < 32) {
    input_warp(io, in_tiles, hand, tiles, lane);
  } else {
    chain_warp(io, out_tile, hand, tiles, lane, fshift);
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
  const cudaError_t attr = cudaFuncSetAttribute(
      tta_filter_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kSmemBytes);
  if (attr != cudaSuccess) {
    return static_cast<int>(attr);
  }
  tta_filter_kernel<<<(lanes + kRows - 1) / kRows, 64, kSmemBytes,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(predicted), lanes, n, fshift,
      atpu::rows_vectorizable(predicted, out, n),
      static_cast<int32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}
