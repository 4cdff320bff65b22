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
// Design: a persistent grid (as many CTAs as fit on the card) whose
// warps stride over groups of kRows consecutive rows.  A step is 32
// residuals of each of the group's rows, lane l holding residual
// base + l of every row, so each of the group's loads is one 128-byte
// line; the next step's kRows loads are issued before the current
// step is counted (a register double buffer, 1 KB a warp in flight).
// A step's zigzag words go through a 32 x 32 bit transpose across the
// warp: five __shfl_xor_sync stages, d = 16, 8, 4, 2, 1, in which lane
// l keeps the half of its word whose position bit d equals its own
// lane bit d and fills the other half from lane l ^ d's word rotated
// left by d (a shuffle, a funnel shift and a lop3).  The rotation puts
// the partner's bits on the freed positions with the position bits
// below d unchanged, so the later stages still find each bit's plane
// there; it changes the bits above d, which by then only say which
// lane a bit came from.  After the five stages lane r holds plane r of
// the 32 residuals as one word, in some order of its bits, and one
// __popc counts it: lane r keeps plane r's running count for
// every row of the group.  The seed needs no sum of its own: sum_i
// (u_i >> J0) = sum_{r >= J0} count_r << (r - J0), exactly and so
// modulo 2^32 as the plain version's int32 cast wraps it, one
// __reduce_add_sync over the lanes.  At a group's end each row's J0 + 1
// values are staged in shared memory and the group's contiguous
// kRows x (J0 + 1) int32 are stored as 16-byte writes.  Instance
// kTail = 0 takes psize % 32 == 0; kTail = 1 masks a row's last step.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;           // warps a CUDA block
constexpr int kRows = 8;            // rows a warp counts together; a
                                    // multiple of 4 keeps each group's
                                    // counts 16-byte aligned
constexpr unsigned kFull = 0xffffffffu;

// the bit positions p with p & d == 0 (0x0000ffff for d = 16, ...,
// 0x55555555 for d = 1): the half of a word that the transpose's stage
// d keeps in the lower lane of a pair
__host__ __device__ constexpr uint32_t low_half(int d) {
  return 0xffffffffu / ((1u << d) + 1u);
}

// (a & sel) | (b & ~sel) in one lop3 (left to itself the compiler
// rebuilds a per-lane `sel` from its immediate half and the lane's bit,
// three lop3s a stage)
__device__ __forceinline__ uint32_t select_bits(uint32_t a, uint32_t b,
                                                uint32_t sel) {
  uint32_t out;
  asm("lop3.b32 %0, %1, %2, %3, 0xe4;" : "=r"(out) : "r"(a), "r"(b),
      "r"(sel));
  return out;
}

__device__ __forceinline__ uint32_t zigzag(int32_t x) {
  return (static_cast<uint32_t>(x) << 1) ^ static_cast<uint32_t>(x >> 31);
}

// the group's step at `base`: lane l gets residual base + l of each
// row of group `g` (0 past the rows or past psize)
template <int kTail>
__device__ __forceinline__ void load_step(int32_t (&v)[kRows],
                                          const int32_t* __restrict__ res,
                                          long long rows, int psize,
                                          long long g, int base, int lane) {
  const long long row0 = g * kRows;
  const int32_t* p = res + row0 * psize + base + lane;
  const bool in_row = !kTail || base + lane < psize;
  if (row0 + kRows <= rows) {
#pragma unroll
    for (int k = 0; k < kRows; ++k) {
      v[k] = in_row ? __ldg(p + static_cast<long long>(k) * psize) : 0;
    }
  } else {
#pragma unroll
    for (int k = 0; k < kRows; ++k) {
      v[k] = (in_row && row0 + k < rows)
                 ? __ldg(p + static_cast<long long>(k) * psize) : 0;
    }
  }
}

// writes group g's counts: lane r < j0 holds plane r's count of row k
// in acc[k]; lanes r >= j0 hold the planes that make up the seed
__device__ __forceinline__ void store_group(const uint32_t (&acc)[kRows],
                                            long long g, long long rows,
                                            int j0, int32_t* __restrict__ out,
                                            int32_t* stage, int lane) {
  const int width = j0 + 1;
  const int shift = lane - j0;
#pragma unroll
  for (int k = 0; k < kRows; ++k) {
    const uint32_t seed =
        __reduce_add_sync(kFull, shift >= 0 ? acc[k] << shift : 0u);
    if (lane <= j0) {
      stage[k * width + lane] =
          static_cast<int32_t>(lane < j0 ? acc[k] : seed);
    }
  }
  __syncwarp();
  const long long row0 = g * kRows;
  const long long left = rows - row0;
  const int words = (left < kRows ? static_cast<int>(left) : kRows) * width;
  int32_t* dst = out + row0 * width;
  if (words == kRows * width &&
      (reinterpret_cast<uintptr_t>(out) & 15) == 0) {
    // row0 * width is a multiple of 4 words: 16-byte stores
    const int4* src4 = reinterpret_cast<const int4*>(stage);
    int4* dst4 = reinterpret_cast<int4*>(dst);
#pragma unroll
    for (int i = 0; i < kRows / 4; ++i) {
      const int q = i * 32 + lane;
      if (q < words / 4) {
        dst4[q] = src4[q];
      }
    }
  } else {
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int q = i * 32 + lane;
      if (q < words) {
        dst[q] = stage[q];
      }
    }
  }
  __syncwarp();
}

template <int kTail>
__global__ void __launch_bounds__(kWarps * 32)
    rice_planes_kernel(const int32_t* __restrict__ res, long long rows,
                       int psize, int j0, int32_t* __restrict__ out) {
  __shared__ __align__(16) int32_t stage[kWarps][kRows * 32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long groups = (rows + kRows - 1) / kRows;
  const long long stride = static_cast<long long>(gridDim.x) * kWarps;
  long long g = static_cast<long long>(blockIdx.x) * kWarps + warp;
  if (g >= groups) {
    return;                         // the whole warp leaves together
  }
  // stage s pairs lane l with lane l ^ d (d = 16 >> s): the lower lane
  // keeps its low_half(d) bits, the upper lane the others, and each
  // fills the rest from its partner's word rotated left by d
  uint32_t keep[5];
#pragma unroll
  for (int s = 0; s < 5; ++s) {
    const int d = 16 >> s;
    keep[s] = (lane & d) ? ~low_half(d) : low_half(d);
  }
  int32_t cur[kRows];
  int32_t ahead[kRows];
  uint32_t acc[kRows];
#pragma unroll
  for (int k = 0; k < kRows; ++k) {
    acc[k] = 0;
  }
  int base = 0;
  load_step<kTail>(cur, res, rows, psize, g, base, lane);
  for (;;) {
    long long g_next = g;
    int base_next = base + 32;
    if (base_next >= psize) {
      g_next += stride;
      base_next = 0;
    }
    const bool more = g_next < groups;
    if (more) {
      load_step<kTail>(ahead, res, rows, psize, g_next, base_next, lane);
    }
    uint32_t u[kRows];
#pragma unroll
    for (int k = 0; k < kRows; ++k) {
      u[k] = zigzag(cur[k]);
    }
#pragma unroll
    for (int s = 0; s < 5; ++s) {
#pragma unroll
      for (int k = 0; k < kRows; ++k) {
        const uint32_t y = __shfl_xor_sync(kFull, u[k], 16 >> s);
        u[k] = select_bits(u[k], __funnelshift_l(y, y, 16 >> s), keep[s]);
      }
    }
#pragma unroll
    for (int k = 0; k < kRows; ++k) {
      acc[k] += __popc(u[k]);
    }
    if (base_next == 0) {
      store_group(acc, g, rows, j0, out, stage[warp], lane);
#pragma unroll
      for (int k = 0; k < kRows; ++k) {
        acc[k] = 0;
      }
    }
    if (!more) {
      break;
    }
#pragma unroll
    for (int k = 0; k < kRows; ++k) {
      cur[k] = ahead[k];
    }
    g = g_next;
    base = base_next;
  }
}

template <int kTail>
int launch(const int32_t* res, long long rows, int psize, int j0,
           int32_t* out, cudaStream_t stream) {
  // a persistent grid: the CTAs that fit on the card at once, or fewer
  // where the rows need fewer
  int device = 0;
  int sms = 0;
  int per_sm = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                 device);
  }
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, rice_planes_kernel<kTail>, kWarps * 32, 0);
  }
  if (err != cudaSuccess) {
    return static_cast<int>(err);
  }
  const long long resident = static_cast<long long>(sms) *
                             (per_sm > 0 ? per_sm : 1);
  const long long groups = (rows + kRows - 1) / kRows;
  const long long wanted = (groups + kWarps - 1) / kWarps;
  const unsigned ctas = static_cast<unsigned>(
      wanted < resident ? wanted : resident);
  rice_planes_kernel<kTail><<<ctas, kWarps * 32, 0, stream>>>(
      res, rows, psize, j0, out);
  return static_cast<int>(cudaGetLastError());
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
  const auto* r = static_cast<const int32_t*>(res);
  auto* o = static_cast<int32_t*>(out);
  auto* s = static_cast<cudaStream_t>(stream);
  return psize % 32 == 0 ? launch<0>(r, rows, psize, j0, o, s)
                         : launch<1>(r, rows, psize, j0, o, s);
}
