// Row tiles staged through shared memory, for the serial-recurrence
// kernels (flac_synth.cu, tta_synth.cu, alac_synth.cu, tta_filter.cu).
//
// Those kernels give each row of a row-major int32 [rows, n] array to
// one thread (or two) and walk it sample by sample.  Read straight
// from device memory, a warp's step touches one word in each of 32
// rows n * 4 bytes apart.  Here a warp instead copies a tile of
// ROWS rows x kTile samples into shared memory with cp.async (16
// bytes a thread, neighbouring threads on neighbouring addresses, or
// 4 bytes where the rows are not 16-byte aligned), several tiles
// ahead of the one it computes, and writes its samples back through
// an output tile the same way.
//
// Element (r, i) of a tile lives at word r * kTile + i with the
// 16-byte chunk index i / 4 XOR-ed with r % 8: the eight threads that
// one shared-memory wavefront serves for a 16-byte access (eight
// consecutive rows, the same chunk) then hit eight different bank
// groups, and so do the copies, whose eight threads take eight chunks
// of one row.
//
// With GATHER (alac_synth.cu) a warp's rows need not be consecutive:
// each thread names the row it works on, and the copies go to and from
// those rows.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace atpu {

// samples a tile holds of each row: a multiple of 8 (the TTA state
// ring) and of 32 / 4 chunks, so that the XOR swizzle stays in the row
constexpr int kTile = 32;
// tiles in flight: the one computed and the next kStages - 1
constexpr int kStages = 3;
// 16-byte chunks in a tile row, and the rows one pass of a warp's 32
// lanes covers
constexpr int kChunks = kTile / 4;
constexpr int kRowStep = 32 / kChunks;

__device__ __forceinline__ int tile_word(int r, int i) {
  return r * kTile + ((((i >> 2) ^ (r & 7))) << 2) + (i & 3);
}

__device__ __forceinline__ void cp_async16(int32_t* smem, const int32_t* gmem,
                                           int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               ::"r"(s), "l"(gmem), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async4(int32_t* smem, const int32_t* gmem,
                                          int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               ::"r"(s), "l"(gmem), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// waits until the oldest of the kStages groups in flight has landed
// (the caller commits one group a tile, empty past the last tile)
__device__ __forceinline__ void cp_async_wait_oldest() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kStages - 1));
}

// The rows [r0, r0 + ROWS) of a row-major int32 [rows, n] source and
// destination, as one warp copies them tile by tile.  With `vec`
// (n % 4 == 0, both arrays 16-byte aligned) lane l copies chunk
// l % kChunks of rows l / kChunks + kRowStep * m: its addresses, which
// of its rows exist and its shared-memory words are worked out once,
// so a tile costs a pointer increment a chunk (a 64-bit row * n
// product is an IMAD.WIDE, the slowest integer instruction, on the
// pipe the recurrences keep busy).  Otherwise it copies 4-byte words.
//
// The loop over the tiles, with `in_tiles` [kStages][ROWS * kTile] and
// `out_tile` [ROWS * kTile] in shared memory:
//
//   io.prefetch(in_tiles, tiles);
//   for (int t = 0; t < tiles; ++t) {
//     int32_t* in = io.next(in_tiles, t, tiles);   // tile t has landed
//     ... compute from `in` into out_tile ...
//     io.finish(out_tile, t * kTile);              // out_tile -> dst
//   }
//
// With GATHER (tile row r belongs to lanes r * kLanes .. r * kLanes +
// kLanes - 1, kLanes = 32 / ROWS) the constructor's `r0` is instead the
// row of the calling lane's tile row, -1 for none; each lane then keeps
// the kPasses element offsets of its chunks.
template <int ROWS, bool GATHER = false>
struct RowTiles {
  static constexpr int kPasses = ROWS / kRowStep;
  static constexpr int kLanes = 32 / ROWS;
  const int32_t* src;
  int32_t* dst;
  int rows, n, r0, lane;
  bool vec;
  int64_t offset;    // element of the lane's chunk in its first row
  int64_t stride;    // elements between its chunks: kRowStep rows
  int64_t goff[GATHER ? kPasses : 1];   // GATHER: element of chunk m
  int col;           // its chunk's first sample within a tile
  unsigned rows_in;  // bit m: its m-th row exists
  int word[2];       // shared-memory word of its chunk, m even and odd

  __device__ RowTiles(const int32_t* src_, int32_t* dst_, int rows_, int n_,
                      int r0_, bool vec_, int lane_)
      : src(src_), dst(dst_), rows(rows_), n(n_), r0(r0_), lane(lane_),
        vec(vec_) {
    const int r = lane / kChunks;
    col = (lane % kChunks) * 4;
    offset = static_cast<int64_t>(r0 + r) * n + col;
    stride = static_cast<int64_t>(kRowStep) * n;
    rows_in = 0;
#pragma unroll
    for (int m = 0; m < kPasses; ++m) {
      if constexpr (GATHER) {
        const int row = gathered_row(r + kRowStep * m);
        goff[m] = static_cast<int64_t>(row) * n + col;
        rows_in |= (row >= 0 ? 1u : 0u) << m;
      } else {
        rows_in |= (r0 + r + kRowStep * m < rows ? 1u : 0u) << m;
      }
    }
    // rows r and r + kRowStep * m swizzle alike for even m (r < 4)
    word[0] = tile_word(r, col);
    word[1] = tile_word(r + kRowStep, col) - kRowStep * kTile;
  }

  // the lane's chunk m at sample c0, `g` being where it lies when the
  // rows are consecutive
  template <class T>
  __device__ __forceinline__ T* chunk(T* base, T* g, int m, int c0) const {
    if constexpr (GATHER) {
      return base + goff[m] + c0;
    } else {
      return g;
    }
  }

  // the row that tile row r holds, or -1 (GATHER tiles; all 32 lanes
  // call it)
  __device__ __forceinline__ int gathered_row(int r) const {
    return __shfl_sync(0xffffffffu, r0, r * kLanes);
  }

  // copies samples [c0, c0 + kTile) of the rows into `tile`; what lies
  // past the array reads as 0.  The caller commits the group.
  __device__ __forceinline__ void load(int32_t* tile, int c0) const {
    if (vec) {
      const bool col_in = c0 + col < n;
      const int32_t* g = src + offset + c0;
#pragma unroll
      for (int m = 0; m < kPasses; ++m) {
        const bool in = col_in && ((rows_in >> m) & 1u);
        cp_async16(tile + word[m & 1] + kRowStep * m * kTile,
                   in ? chunk(src, g, m, c0) : src, in ? 16 : 0);
        g += stride;
      }
    } else {
      for (int k = lane; k < ROWS * kTile; k += 32) {
        const int r = k / kTile;
        const int i = k % kTile;
        const int row = GATHER ? gathered_row(r) : r0 + r;
        const bool in = (GATHER ? row >= 0 : row < rows) && c0 + i < n;
        const int32_t* g =
            in ? src + static_cast<int64_t>(row) * n + c0 + i : src;
        cp_async4(tile + tile_word(r, i), g, in ? 4 : 0);
      }
    }
  }

  // writes `tile` to samples [c0, c0 + kTile) of the rows, dropping
  // what lies past the array
  __device__ __forceinline__ void store(const int32_t* tile, int c0) const {
    if (vec) {
      if (c0 + col >= n) {
        return;
      }
      int32_t* g = dst + offset + c0;
#pragma unroll
      for (int m = 0; m < kPasses; ++m) {
        if ((rows_in >> m) & 1u) {
          *reinterpret_cast<int4*>(chunk(dst, g, m, c0)) =
              *reinterpret_cast<const int4*>(
                  tile + word[m & 1] + kRowStep * m * kTile);
        }
        g += stride;
      }
    } else {
      for (int k = lane; k < ROWS * kTile; k += 32) {
        const int r = k / kTile;
        const int i = k % kTile;
        const int row = GATHER ? gathered_row(r) : r0 + r;
        if ((GATHER ? row >= 0 : row < rows) && c0 + i < n) {
          dst[static_cast<int64_t>(row) * n + c0 + i] =
              tile[tile_word(r, i)];
        }
      }
    }
  }

  // starts the copies of tiles 0 .. kStages - 2, one group each
  __device__ __forceinline__ void prefetch(int32_t (*in_tiles)[ROWS * kTile],
                                           int tiles) const {
#pragma unroll
    for (int t = 0; t < kStages - 1; ++t) {
      if (t < tiles) {
        load(in_tiles[t], t * kTile);
      }
      cp_async_commit();
    }
  }

  // starts the copy of tile t + kStages - 1 (into the buffer tile t - 1
  // used), then waits for tile t and returns it
  __device__ __forceinline__ int32_t* next(int32_t (*in_tiles)[ROWS * kTile],
                                           int t, int tiles) const {
    const int ahead = t + kStages - 1;
    if (ahead < tiles) {
      load(in_tiles[ahead % kStages], ahead * kTile);
    }
    cp_async_commit();
    cp_async_wait_oldest();
    __syncwarp();
    return in_tiles[t % kStages];
  }

  // writes the computed output tile of samples [c0, c0 + kTile) back
  __device__ __forceinline__ void finish(const int32_t* out_tile,
                                         int c0) const {
    __syncwarp();
    store(out_tile, c0);
    __syncwarp();
  }
};

// whether [rows, n] int32 arrays at these addresses take 16-byte copies
inline bool rows_vectorizable(const void* a, const void* b, int n) {
  return n % 4 == 0 && reinterpret_cast<uintptr_t>(a) % 16 == 0 &&
         reinterpret_cast<uintptr_t>(b) % 16 == 0;
}

}  // namespace atpu
