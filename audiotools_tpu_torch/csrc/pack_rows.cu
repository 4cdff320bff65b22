// FLAC residual partition pack for NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel audiotools_tpu/ops/pallas_bitpack.py:195
// (scatter_words_pallas) together with what feeds it there: the token
// model (tokenize, split_contributions) and the sideband of
// pack_chosen_residuals.  From the chosen subframes' residuals and Rice
// parameters it writes each row's residual partition block as MSB-first
// 32-bit words, the block's length in bits and the row's ok flag.
//
// Stream layout of a coded (FIXED/LPC) row, as the serial writers emit it:
//   [method(2) porder(4)] ([param(4|5)] [rice codes ...]) * parts
// with method 1 (5-bit parameters) when a used parameter exceeds 14.  A
// Rice code of zigzag value u with parameter r is (u >> r) zeros, a stop
// bit and the r low bits of u; warm-up residuals (below the predictor
// order) are not coded.  CONSTANT and VERBATIM rows get zero words, 0 bits
// and ok.
//
// The TPU has no per-lane scatter, so the reference turns every field into
// (word, value) contributions in device memory and ORs them into words
// with a one-hot matrix product.  A GPU block can place bits itself, so
// here nothing between the residuals and the words reaches device memory:
// one block of 256 threads a row
//   1. loads the row's parameters into shared memory, and works out the
//      method and the parameter width plen;
//   2. gives each thread a contiguous run of ceil(n / 256) residuals (16 at
//      n = 4096, read as 16-byte loads where the run and the row allow,
//      and issued before step 1's barrier so that the two loads overlap),
//      and takes each one's code length (u >> r) + 1 + r in 64 bits, with
//      the clip test of the LPC residuals on the same values;
//   3. takes an exclusive scan of the threads' 64-bit sums, by shuffles in
//      a warp and across the 8 warp totals in shared memory: residual i of
//      partition p ends at stream bit 6 + (p + 1) * plen + prefix(i) +
//      len(i), and partition p's parameter ends where its first residual
//      begins;
//   4. ORs each field into a tile of the row's words in shared memory, one
//      shared atomicOr for each of the one or two words it touches (exact,
//      because the fields' bits are disjoint), with bit positions in 32
//      bits where the row's block is shorter than 2^32 bits.  Holding the
//      word in hand in a register until a lane's fields moved past it cost
//      more, in branches that split the warp, than the atomics it saved.
//      Bits at or past 32 * n_words are dropped, as the reference drops
//      contributions past its output;
//   5. copies the tile out with 16-byte stores.  A row of the output
//      starts at word row * n_words, which need not be 16-byte aligned, so
//      the tile starts `lead` words into shared memory, (row * n_words) % 4,
//      and the quads that lie wholly inside the row go out as uint4.
//
// Three barriers a row: after step 1 (which also zeroes the tile), in the
// scan, and between the words and their copy out.  A thread holds its run
// of 16 residuals in 16 registers and works out each one's parameter from
// shared memory when it needs it, so 64 registers a thread suffice and 4
// blocks share an SM, which hides more of each block's barriers and load
// latency than 2 blocks of 116 registers did.
//
// The tile holds n_words words (9.8 KB at FLAC -8 stereo, 2445 words).  It
// takes dynamic shared memory past the default 48 KB when a row needs it,
// and where a row's words exceed what a block may hold at all, the row is
// written in windows of the tile's size, each thread skipping the windows
// its fields do not reach.  Neither case falls back or fails.
//
// What bounds it: bytes.  At the FLAC -8 bench shape (S = 2048 rows of
// n = 4096) it reads the residuals (33.5 MB) and the parameters and writes
// the words (20.0 MB): 0.016 ms at 3.35 TB/s.  Some 20 integer operations
// a code over 8.4 M codes take 0.003 ms at 67 T operations/s, the
// card's scalar 32-bit rate.
//
// Contract (the analysis guarantees it for coded rows): parameters in
// [0, 30], porder in [0, 15] with n % (1 << porder) == 0 and
// (1 << porder) <= max_parts.  Out of it the kernel stays inside its
// buffers but its words are unspecified.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kItems = 16;        // residuals a thread holds in registers
// blocks an SM should hold: caps the registers at 64 a thread
constexpr int kBlocksPerSM = 4;
constexpr int kHeaderBits = 6;    // method(2) + porder(4)
constexpr int kChoiceFixed = 2;   // ops/flac_frames.CHOICE_FIXED
constexpr int kChoiceLpc = 3;     // ops/flac_frames.CHOICE_LPC

struct Row {
  int n;
  int order;      // warm-up residuals below it are not coded
  int parts;      // 1 << porder
  int psize;      // n >> porder
  int max_parts;  // parameters a row has
  const int32_t* params;  // the row's parameters, in shared memory

  __device__ __forceinline__ uint32_t param(int p) const {
    return static_cast<uint32_t>(params[min(p, max_parts - 1)]);
  }
};

// up to kItems consecutive residuals of one thread's run: loaded as raw
// residuals, then turned into zigzag values in place
struct Items {
  uint32_t u[kItems];
  uint32_t live;  // bit k: item k is coded
};

__device__ __forceinline__ unsigned long long code_length(uint32_t u,
                                                          uint32_t r) {
  return static_cast<unsigned long long>(u >> r) + 1ull + r;
}

// loads residuals i0 .. i0 + cnt - 1 of `res` (a row) into it.u
__device__ __forceinline__ void load_items(const int32_t* __restrict__ res,
                                           int i0, int cnt, bool vec,
                                           Items& it) {
  if (vec && cnt == kItems) {
    const uint4* src = reinterpret_cast<const uint4*>(res + i0);
#pragma unroll
    for (int q = 0; q < kItems / 4; ++q) {
      const uint4 x = __ldg(src + q);
      it.u[4 * q] = x.x;
      it.u[4 * q + 1] = x.y;
      it.u[4 * q + 2] = x.z;
      it.u[4 * q + 3] = x.w;
    }
  } else {
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
      it.u[k] = k < cnt ? static_cast<uint32_t>(__ldg(res + i0 + k)) : 0u;
    }
  }
}

// turns the loaded residuals i0 .. i0 + cnt - 1 into zigzag values and
// marks the coded ones; returns the sum of their code lengths and ORs the
// clip test into `clip_hit`
__device__ __forceinline__ unsigned long long code_items(
    Items& it, int i0, int cnt, const Row& row, long long clip,
    bool& clip_hit) {
  int p = i0 / row.psize;
  int next = (p + 1) * row.psize;  // first residual of partition p + 1
  uint32_t r = row.param(p);
  unsigned long long sum = 0;
  it.live = 0u;
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    const int i = i0 + k;
    if (i == next) {
      ++p;
      next += row.psize;
      r = row.param(p);
    }
    const int32_t x = static_cast<int32_t>(it.u[k]);
    // |x| as torch.abs takes it in int32: -2^31 stays negative
    const int32_t a =
        x < 0 ? static_cast<int32_t>(0u - static_cast<uint32_t>(x)) : x;
    clip_hit |= k < cnt && static_cast<long long>(a) >= clip;
    const uint32_t u =
        (static_cast<uint32_t>(x) << 1) ^ static_cast<uint32_t>(x >> 31);
    const bool live = k < cnt && i >= row.order && p < row.parts;
    it.u[k] = u;
    it.live |= static_cast<uint32_t>(live) << k;
    sum += live ? code_length(u, r) : 0ull;
  }
  return sum;
}

// ORs fields into the words [w0, w1) of a row, held at tile[q - w0].  The
// fields' bits are disjoint, so the order in which threads land does not
// matter.  P holds stream bit positions: 32 bits for a row whose block is
// shorter than 2^32 bits, else 64.
template <typename P>
struct Writer {
  uint32_t* tile;
  P w0;
  P w1;

  __device__ __forceinline__ void word(P q, uint32_t bits) const {
    if (bits != 0u && q >= w0 && q < w1) {
      atomicOr(tile + static_cast<size_t>(q - w0), bits);
    }
  }
  // a field whose value (at most 31 bits wide) ends at stream bit `end`:
  // its low bits in word (end - 1) / 32, the rest in the word before
  __device__ __forceinline__ void put(P end, uint32_t value) const {
    const P q1 = (end - 1) >> 5;
    const uint32_t shift = 31u - static_cast<uint32_t>((end - 1) & 31);
    word(q1 - 1, __funnelshift_l(value, 0u, shift));
    word(q1, value << shift);
  }
};

// writes the parameters and codes of the coded residuals i0 .. i0 + cnt -
// 1, whose codes start at `pos` bits into the row's codes; returns where
// they end
template <typename P>
__device__ __forceinline__ P write_items(const Writer<P>& w, const Items& it,
                                         int i0, int cnt, P pos,
                                         const Row& row, int plen) {
  int p = i0 / row.psize;
  int first = p * row.psize;  // first residual of partition p
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    const int i = i0 + k;
    if (k < cnt) {
      if (i == first + row.psize) {
        ++p;
        first += row.psize;
      }
      const P base = kHeaderBits + static_cast<P>(p + 1) * plen + pos;
      const uint32_t r = row.param(p);
      if (i == first && p < row.parts) {
        w.put(base, r);
      }
      if ((it.live >> k) & 1u) {
        const uint32_t u = it.u[k];
        const P len = static_cast<P>(u >> r) + 1 + r;
        pos += len;
        w.put(base + len, (1u << r) | (u & ((1u << r) - 1u)));
      }
    }
  }
  return pos;
}

// writes this thread's fields that fall in the words [w0, w1), the header
// too on thread 0; a run of one chunk is still in `it`
template <typename P>
__device__ __forceinline__ void write_run(
    uint32_t* tile, long long w0, long long w1, Items& it,
    const int32_t* __restrict__ row_res, int start, int end, bool one_chunk,
    bool vec, const Row& row, long long clip, int plen, uint32_t header,
    unsigned long long excl) {
  const Writer<P> w{tile, static_cast<P>(w0), static_cast<P>(w1)};
  if (threadIdx.x == 0) {
    w.put(kHeaderBits, header);
  }
  P pos = static_cast<P>(excl);
  for (int i0 = start; i0 < end; i0 += kItems) {
    const int cnt = min(kItems, end - i0);
    if (!one_chunk) {
      bool unused = false;
      load_items(row_res, i0, cnt, vec, it);
      code_items(it, i0, cnt, row, clip, unused);
    }
    pos = write_items(w, it, i0, cnt, pos, row, plen);
  }
}

__global__ void __launch_bounds__(kThreads, kBlocksPerSM)
pack_rows_kernel(const int32_t* __restrict__ res,
                 const int32_t* __restrict__ orders,
                 const int32_t* __restrict__ porders,
                 const int32_t* __restrict__ choice,
                 const int32_t* __restrict__ params, int n, int max_parts,
                 int n_words, long long clip, int tile_words,
                 uint32_t* __restrict__ words, int32_t* __restrict__ bits,
                 uint8_t* __restrict__ ok) {
  // the word tile (tile_words + 4 words: up to 3 lead words and the
  // rounding of the last quad), then the row's parameters
  extern __shared__ __align__(16) uint32_t smem[];
  __shared__ unsigned long long warp_sums[kWarps];
  uint32_t* tile = smem;
  uint4* tile4 = reinterpret_cast<uint4*>(tile);
  int32_t* sparams = reinterpret_cast<int32_t*>(smem + tile_words + 4);

  const int row_i = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const long long row_word = static_cast<long long>(row_i) * n_words;

  const int kind = choice[row_i];
  const bool coded = kind == kChoiceFixed || kind == kChoiceLpc;
  const int porder = min(max(porders[row_i], 0), 15);
  Row row;
  row.n = n;
  row.order = orders[row_i];
  row.parts = 1 << porder;
  row.psize = max(n >> porder, 1);
  row.max_parts = max_parts;
  row.params = sparams;

  // this thread's run of residuals; a run of one chunk is loaded before
  // the first barrier, so that its latency overlaps the parameters'
  const int run = (n + kThreads - 1) / kThreads;
  const int start = min(tid * run, n);
  const int end = min(start + run, n);
  const bool one_chunk = run <= kItems;
  const int32_t* row_res = res + static_cast<size_t>(row_i) * n;
  const bool vec = run % 4 == 0 && n % 4 == 0 &&
                   (reinterpret_cast<uintptr_t>(res) & 15) == 0;
  Items it;
  if (coded && one_chunk && start < end) {
    load_items(row_res, start, end - start, vec, it);
  }

  // ---- 1. the row's parameters; the first window's tile zeroed ----------
  int big = 0;
  for (int p = tid; p < max_parts; p += kThreads) {
    const int32_t r = params[static_cast<size_t>(row_i) * max_parts + p];
    sparams[p] = r;
    big |= p < row.parts && r > 14;
  }
  const int first_span =
      static_cast<int>((row_word & 3) + min(tile_words, n_words));
  for (int k = tid; k < (first_span + 3) >> 2; k += kThreads) {
    tile4[k] = make_uint4(0u, 0u, 0u, 0u);
  }
  const bool method1 = __syncthreads_or(big) != 0;
  const int plen = method1 ? 5 : 4;

  // ---- 2. code lengths of this thread's run -----------------------------
  unsigned long long sum = 0;
  bool clip_hit = false;
  if (coded) {
    for (int i0 = start; i0 < end; i0 += kItems) {
      const int cnt = min(kItems, end - i0);
      if (!one_chunk) {
        load_items(row_res, i0, cnt, vec, it);
      }
      sum += code_items(it, i0, cnt, row, clip, clip_hit);
    }
  }

  // ---- 3. exclusive scan of the threads' sums ---------------------------
  unsigned long long incl = sum;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const unsigned long long y = __shfl_up_sync(0xffffffffu, incl, d);
    if (lane >= d) {
      incl += y;
    }
  }
  if (lane == 31) {
    warp_sums[warp] = incl;
  }
  const bool clipped = __syncthreads_or(clip_hit) != 0;
  unsigned long long before = 0;
  unsigned long long codes = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    const unsigned long long t = warp_sums[w];
    before += w < warp ? t : 0ull;
    codes += t;
  }
  const unsigned long long excl = before + incl - sum;

  // ---- the row's bits and ok flag --------------------------------------
  const unsigned long long total =
      coded ? kHeaderBits + static_cast<unsigned long long>(row.parts) * plen
                  + codes
            : 0ull;
  if (tid == 0) {
    bits[row_i] = static_cast<int32_t>(static_cast<uint32_t>(total));
    ok[row_i] = !coded || (total <= 32ull * static_cast<unsigned>(n_words) &&
                           !(kind == kChoiceLpc && clipped));
  }

  // the stream bits this thread's fields lie in: its parameters and codes
  // from the start of its first partition's region, and thread 0's header
  unsigned long long lo_bit = 0;
  unsigned long long hi_bit = 0;
  if (start < end) {
    lo_bit = kHeaderBits +
             static_cast<unsigned long long>(start / row.psize) * plen + excl;
    hi_bit = kHeaderBits +
             static_cast<unsigned long long>((end - 1) / row.psize + 1) *
                 plen +
             excl + sum;
  }
  if (tid == 0) {
    lo_bit = 0;
    hi_bit = max(hi_bit, static_cast<unsigned long long>(kHeaderBits));
  }

  // ---- 4-5. words, a window of the tile's size at a time ----------------
  for (long long w0 = 0; w0 < n_words; w0 += tile_words) {
    const long long w1 = min(w0 + tile_words, static_cast<long long>(n_words));
    const int lead = static_cast<int>((row_word + w0) & 3);
    const int span = lead + static_cast<int>(w1 - w0);
    const int quads = (span + 3) >> 2;
    if (w0 > 0) {   // the previous window is out: zero the tile again
      __syncthreads();
      for (int k = tid; k < quads; k += kThreads) {
        tile4[k] = make_uint4(0u, 0u, 0u, 0u);
      }
      __syncthreads();
    }
    if (coded && hi_bit > 32ull * w0 && lo_bit < 32ull * w1) {
      const uint32_t header = (static_cast<uint32_t>(method1) << 4) | porder;
      if (total <= 0xffffffffull) {
        write_run<uint32_t>(tile + lead, w0, w1, it, row_res, start, end,
                            one_chunk, vec, row, clip, plen, header, excl);
      } else {
        write_run<unsigned long long>(tile + lead, w0, w1, it, row_res,
                                      start, end, one_chunk, vec, row, clip,
                                      plen, header, excl);
      }
    }
    __syncthreads();
    // tile quad k holds the row's words w0 - lead + 4k .. + 3
    uint32_t* out = words + (row_word + w0 - lead);
    for (int k = tid; k < quads; k += kThreads) {
      const int s = 4 * k;
      if (s >= lead && s + 4 <= span) {
        reinterpret_cast<uint4*>(out)[k] = tile4[k];
      } else {
        for (int j = max(s, lead); j < min(s + 4, span); ++j) {
          out[j] = tile[j];
        }
      }
    }
  }
}

// what a device allows the kernel, looked up on its first launch there:
// the shared memory a block may opt in to, the kernel's static shared
// memory, and the dynamic shared memory it is set to take
struct Limits {
  long long optin;
  long long static_bytes;
  long long allowed;
};
constexpr int kMaxDevices = 64;
Limits g_limits[kMaxDevices] = {};

}  // namespace

// res: int32 [s, n]; orders, porders, choice: int32 [s]; params: int32
// [s, max_parts]; words: u32 [s, n_words], 16-byte aligned; bits: int32
// [s]; ok: bool [s].  All device pointers, contiguous.  LPC rows with a
// residual of |x| >= 2^(max_bps + 4) are not ok.  Launches on `stream`
// without synchronising and returns cudaGetLastError() (or the error of a
// refused launch configuration).
extern "C" int atpu_pack_rows(const void* res, const void* orders,
                              const void* porders, const void* choice,
                              const void* params, int s, int n, int max_parts,
                              int n_words, int max_bps, void* words, void* bits, void* ok,
                              void* stream) {
  if (s <= 0) {
    return 0;
  }
  if (n <= 0 || max_parts <= 0 || n_words < 0 || max_bps < 0 ||
      max_bps > 58 ||
      (reinterpret_cast<uintptr_t>(words) & 15) != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) {
    return static_cast<int>(err);
  }
  if (device < 0 || device >= kMaxDevices) {
    return static_cast<int>(cudaErrorInvalidDevice);
  }
  Limits& lim = g_limits[device];
  if (lim.optin == 0) {
    cudaFuncAttributes attr;
    err = cudaFuncGetAttributes(&attr, pack_rows_kernel);
    int optin = 0;
    if (err == cudaSuccess) {
      err = cudaDeviceGetAttribute(
          &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
    }
    if (err != cudaSuccess) {
      return static_cast<int>(err);
    }
    lim.static_bytes = static_cast<long long>(attr.sharedSizeBytes);
    lim.allowed = 48 * 1024;
    lim.optin = optin;
  }
  const long long param_bytes = (static_cast<long long>(max_parts) * 4 + 15)
                                / 16 * 16;
  // tile words that fit beside the parameters and the static arrays
  const long long room =
      ((lim.optin - lim.static_bytes - param_bytes) / 4 - 4) & ~3ll;
  const long long tile =
      min(max((static_cast<long long>(n_words) + 3) & ~3ll, 4ll), room);
  if (tile < 4) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long dyn = (tile + 4) * 4 + param_bytes;
  if (dyn > lim.allowed) {
    err = cudaFuncSetAttribute(pack_rows_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(dyn));
    if (err != cudaSuccess) {
      return static_cast<int>(err);
    }
    lim.allowed = dyn;
  }
  pack_rows_kernel<<<s, kThreads, static_cast<size_t>(dyn),
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(res), static_cast<const int32_t*>(orders),
      static_cast<const int32_t*>(porders),
      static_cast<const int32_t*>(choice),
      static_cast<const int32_t*>(params), n, max_parts, n_words,
      1ll << (max_bps + 4), static_cast<int>(tile),
      static_cast<uint32_t*>(words), static_cast<int32_t*>(bits),
      static_cast<uint8_t*>(ok));
  return static_cast<int>(cudaGetLastError());
}
