// FLAC residual-partition Rice decode for NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel audiotools_tpu/ops/rice_decode.py:309
// (decode_partitions_pallas), and with it the reference's pointer
// doubling and lock-step scan forms: one kernel serves every bucket.
//
// Each record p (a residual partition, or a chunk of one, as the host
// scan recorded it) is a run of count[p] codes starting at bit
// base_bits[p] of word word_base[p] of the frame bytes, read as
// big-endian 32-bit words.  A Rice run (k >= 0) codes each value as a
// unary quotient, a stop bit and k low bits, zigzag-mapped; a raw run
// (raw_bits >= 0) codes raw_bits-wide two's-complement values.  The
// output row p holds the decoded values, and zeros from count[p] to C.
//
// The TPU has no per-lane gather, so the Pallas kernel keeps each
// record's window of W words in VMEM and reads a word by a one-hot
// multiply-reduce over the window, with a precomputed next-nonzero-
// word table for long quotients.  A GPU thread addresses memory
// directly: one thread a record finds each quotient with a count of
// leading zeros.
//
// The arithmetic follows the reference's scan form exactly, clamps
// included (rice_decode.py:196-199, 222-266): the window is the W + 1
// words from word_base, each read clamped to the buffer's last word
// Wtot - 1; bit positions clamp to N - 1 = 32 W - 1; a quotient that
// runs off the window ends at N - 1; the low bits' word clamps to
// W - 1.  Padded records (count 0) and the last record of the buffer
// never read past it.  base_bits must be >= 0.
//
// What bounds it.  Bytes: each record's span of words read once (~12
// MB for a 1024-frame FLAC -8 stereo batch) and P * C int32 written (P
// ~ 131k records of C = 64: 34 MB), 0.015 ms at 3.35 TB/s.  A thread
// walks its record serially, but 131k threads fill the card, so the
// memory instructions decide.  Read straight from device memory, one
// thread a record makes three dependent loads a code, each warp
// instruction touching up to 32 lines ~80 bytes apart, and stores
// strided by C * 4 bytes across the warp.  Here the loads come from
// shared memory and the stores are coalesced; what is left is each
// code's dependent chain in the reader (tools_dev/int_op_cycles.py:
// PERF.md), hidden by the warps an SM holds.
//
// Design (W <= 64 and C = 32 or 64: the buckets of the FLAC decoder
// but its catch-all):
// - Words in shared memory.  A block of 128 records copies the words
//   they read, 4-byte cp.async copies all in flight at once: in a
//   bucket the records lie in stream order, so their windows
//   [word_base, word_base + W] make one span of ~128 * 23 + W words at
//   -8, copied whole when it fits kSpanWords; otherwise each record's
//   own W + 1 words.  Either copy clamps each word into the buffer as
//   the window does.
// - A reader in registers.  The two window words at the current
//   position sit in a 64-bit register and the next one is loaded a word
//   ahead, so a code costs no dependent load.  A Rice code whose
//   quotient and low bits lie in those 64 bits, inside the window's
//   first W words, takes the fast path (a count of leading zeros and
//   two shifts); any other code, near the window's end or with a long
//   quotient, takes the reference's arithmetic on the shared words,
//   clamps and all.  A raw code always lies in the 64 bits.
// - Staged output.  Each warp's 32 rows, [32, C], are one contiguous
//   run of `out`.  32 columns at a time, each lane writes its row's
//   codes (zeros past its count) into a shared tile, word j of row r at
//   column j ^ r so that one code of the 32 rows hits 32 banks, and the
//   warp stores the tile 16 bytes a lane, four 128-byte rows a store
//   instruction.
// Other buckets (the catch-all (2048, 4096)) take the direct kernel:
// one thread a record reading device memory.

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;   // records a block, both kernels
// the staged kernel: its buckets, and the words of a block's joint span
// it copies whole
constexpr int kStagedW = 64;
constexpr int kStagedC = 64;
constexpr int kSpanWords = 4096;
constexpr int kPart = 32;   // the columns a warp's output tile holds
constexpr int kMaxDevices = 64;

struct Window {
  const uint32_t* words;
  int64_t base;     // word_base of the record
  int64_t last;     // Wtot - 1
  int w;            // window words W

  // window word j (0 <= j <= W), read clamped into the buffer
  __device__ __forceinline__ uint32_t at(int j) const {
    int64_t i = base + j;
    i = i < 0 ? 0 : (i > last ? last : i);
    return words[i];
  }
};

__global__ void __launch_bounds__(kThreads)
rice_direct_kernel(const uint32_t* __restrict__ words,
                   const int32_t* __restrict__ word_base,
                   const int32_t* __restrict__ base_bits,
                   const int32_t* __restrict__ rice_k,
                   const int32_t* __restrict__ raw_bits,
                   const int32_t* __restrict__ count,
                   int p_count, int64_t w_total, int w, int c,
                   int32_t* __restrict__ out) {
  const int p = blockIdx.x * kThreads + threadIdx.x;
  if (p >= p_count) return;
  int32_t* row = out + static_cast<int64_t>(p) * c;
  const int codes = min(max(count[p], 0), c);

  const Window win{words, word_base[p], w_total - 1, w};
  const int n_last = w * 32 - 1;
  const bool is_raw = raw_bits[p] >= 0;
  const int kc = max(rice_k[p], 0);
  const int rc = max(raw_bits[p], 0);
  const int nbits = is_raw ? rc : kc;
  const int nb_safe = min(max(nbits, 1), 32);
  const uint32_t sbit = nbits > 0 ? (1u << (nb_safe - 1)) : 0u;

  int cur = base_bits[p];
  for (int j = 0; j < codes; ++j) {
    const int st = min(cur, n_last);
    const int wi = st >> 5;
    const uint32_t rem = win.at(wi) << (st & 31);
    int qpos;
    if (rem != 0u) {
      qpos = st + __clz(static_cast<int>(rem));
    } else {
      // first set bit of the next nonzero window word, if any
      int wn = wi + 1;
      while (wn < w && win.at(wn) == 0u) ++wn;
      qpos = wn >= w ? n_last
                     : (wn << 5) + __clz(static_cast<int>(win.at(wn)));
    }
    qpos = min(qpos, n_last);
    const uint32_t q = static_cast<uint32_t>(qpos - st);
    const int off = is_raw ? st : qpos + 1;
    const int wi2 = min(off >> 5, w - 1);
    const uint32_t w0 = win.at(wi2);
    const uint32_t w1 = win.at(wi2 + 1);
    const int sh = off & 31;
    const uint32_t hi = sh == 0 ? w0 : (w0 << sh) | (w1 >> (32 - sh));
    const uint32_t lsb = nbits <= 0 ? 0u : hi >> (32 - nb_safe);
    int32_t res;
    if (is_raw) {
      res = static_cast<int32_t>((lsb ^ sbit) - sbit);
    } else {
      const uint32_t u = (q << kc) | lsb;
      res = static_cast<int32_t>((u >> 1) ^ (0u - (u & 1u)));
    }
    row[j] = res;
    cur = min(is_raw ? st + rc : qpos + 1 + kc, n_last);
  }
  for (int j = codes; j < c; ++j) row[j] = 0;
}


// a << b, 0 for b >= 32 (PTX shl clamps the shift)
__device__ __forceinline__ uint32_t shl_clamped(uint32_t a, int b) {
  uint32_t d;
  asm("shl.b32 %0, %1, %2;" : "=r"(d) : "r"(a), "r"(b));
  return d;
}

// the reference's arithmetic for one Rice code at bit st of the window
// `win` (W + 1 words): its quotient, low bits and the next position
// before the clamp
__device__ __forceinline__ void rice_exact(const uint32_t* win, int w,
                                           int st, int kc, int nb_safe,
                                           uint32_t& q, uint32_t& lsb,
                                           int& next) {
  const int n_last = w * 32 - 1;
  const int wi = st >> 5;
  const uint32_t rem = win[wi] << (st & 31);
  int qpos;
  if (rem != 0u) {
    qpos = st + __clz(static_cast<int>(rem));
  } else {
    int wn = wi + 1;
    while (wn < w && win[wn] == 0u) ++wn;
    qpos = wn >= w ? n_last : (wn << 5) + __clz(static_cast<int>(win[wn]));
  }
  qpos = min(qpos, n_last);
  q = static_cast<uint32_t>(qpos - st);
  const int off = qpos + 1;
  const int wi2 = min(off >> 5, w - 1);
  const uint32_t w0 = win[wi2];
  const uint32_t w1 = win[wi2 + 1];
  const int sh = off & 31;
  const uint32_t hi = sh == 0 ? w0 : (w0 << sh) | (w1 >> (32 - sh));
  lsb = kc <= 0 ? 0u : hi >> (32 - nb_safe);
  next = qpos + 1 + kc;
}

// a 4-byte copy from device to shared memory that does not wait
__device__ __forceinline__ void cp_async4(uint32_t* smem, const uint32_t* g) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(g));
}

// one record's codes, one at a time, from its window `win` (W + 1
// words in shared memory)
struct Reader {
  const uint32_t* win;
  int w, n_last, kc, nbits, nb_safe;
  bool is_raw;
  uint32_t sbit;
  int st, cw;     // the position, and its window word (<= W - 1)
  uint64_t buf;   // window words cw and cw + 1
  uint32_t nxt;   // window word cw + 2 (clamped to W)

  __device__ __forceinline__ Reader(const uint32_t* win_, int w_, int bits,
                                    int k, int raw)
      : win(win_), w(w_), n_last(w_ * 32 - 1), kc(max(k, 0)),
        is_raw(raw >= 0) {
    nbits = is_raw ? max(raw, 0) : kc;
    nb_safe = min(max(nbits, 1), 32);
    sbit = nbits > 0 ? (1u << (nb_safe - 1)) : 0u;
    st = min(max(bits, 0), n_last);
    cw = st >> 5;
    buf = (static_cast<uint64_t>(win[cw]) << 32) | win[cw + 1];
    nxt = win[min(cw + 2, w)];
  }

  __device__ __forceinline__ int32_t next() {
    const int o = st & 31;
    const uint64_t x = buf << o;   // bits from st on: 64 - o >= 33 of them
    // a raw code is a Rice code with no quotient and no stop bit
    uint32_t q = is_raw ? ~0u
                        : static_cast<uint32_t>(
                              __clzll(static_cast<long long>(x)));
    const int used = static_cast<int>(q + 1) + nbits;   // the code's bits
    uint32_t lsb;
    int nxt_pos;
    if (is_raw || (cw + 1 < w && used <= 64 - o)) {
      // the stop bit and the low bits lie in the 64, and for a Rice code
      // in the first W words: no clamp can apply
      lsb = nbits > 0 ? static_cast<uint32_t>((x << (q + 1)) >> (64 - nb_safe))
                      : 0u;
      nxt_pos = st + used;
    } else {
      rice_exact(win, w, st, kc, nb_safe, q, lsb, nxt_pos);
    }
    const uint32_t u = shl_clamped(q, kc) | lsb;
    const int32_t res =
        is_raw ? static_cast<int32_t>((lsb ^ sbit) - sbit)
               : static_cast<int32_t>((u >> 1) ^ (0u - (u & 1u)));
    st = min(nxt_pos, n_last);
    // the next word in, without a branch (lanes advance at different
    // codes); a jump of two words or more reloads
    const int ncw = st >> 5;
    const bool adv = ncw != cw;
    buf = adv ? (buf << 32) | nxt : buf;
    nxt = adv ? win[min(ncw + 2, w)] : nxt;
    if (ncw > cw + 1) {
      buf = (static_cast<uint64_t>(win[ncw]) << 32) | win[ncw + 1];
    }
    cw = ncw;
    return res;
  }
};

// W <= kStagedW, C a multiple of kPart up to kStagedC, `out` 16-byte
// aligned.  Dynamic shared memory: `span_cap` words for the windows,
// then a [32, kPart] tile a warp.
__global__ void __launch_bounds__(kThreads)
rice_staged_kernel(const uint32_t* __restrict__ words,
                   const int32_t* __restrict__ word_base,
                   const int32_t* __restrict__ base_bits,
                   const int32_t* __restrict__ rice_k,
                   const int32_t* __restrict__ raw_bits,
                   const int32_t* __restrict__ count,
                   int p_count, int64_t w_total, int w, int c, int span_cap,
                   int32_t* __restrict__ out) {
  extern __shared__ __align__(16) uint32_t smem[];
  __shared__ int block_lo[kThreads / 32];
  __shared__ int block_hi[kThreads / 32];
  __shared__ int bases[kThreads];
  constexpr unsigned kAll = 0xffffffffu;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int64_t p = static_cast<int64_t>(blockIdx.x) * kThreads + tid;
  const bool live = p < p_count;
  const int base = live ? word_base[p] : 0;
  const int codes = live ? min(max(count[p], 0), c) : 0;

  // the span of the windows of the records that decode anything
  const bool reads = codes > 0;
  int lo = __reduce_min_sync(kAll, reads ? base : INT_MAX);
  int hi = __reduce_max_sync(kAll, reads ? base : INT_MIN);
  if (lane == 0) {
    block_lo[warp] = lo;
    block_hi[warp] = hi;
  }
  bases[tid] = base;
  __syncthreads();
#pragma unroll
  for (int v = 0; v < kThreads / 32; ++v) {
    lo = min(lo, block_lo[v]);
    hi = max(hi, block_hi[v]);
  }
  const int64_t span =
      lo > hi ? 0 : static_cast<int64_t>(hi) - lo + w + 1;
  const bool joint = span <= span_cap;
  // window word indices stay within int32 (a buffer of < 2^31 words);
  // only their clamp into it matters for one far out of it.  The copies
  // are all in flight at once.
  const int last = static_cast<int>(min(w_total - 1, int64_t{INT_MAX}));
  if (joint) {
    for (int e = tid; e < span; e += kThreads) {
      cp_async4(smem + e, words + min(max(lo + e, 0), last));
    }
  } else {
    for (int e = tid; e < kThreads * (w + 1); e += kThreads) {
      const int r = e / (w + 1);
      cp_async4(smem + e,
                words + min(max(bases[r] + (e - r * (w + 1)), 0), last));
    }
  }
  asm volatile("cp.async.wait_all;\n" ::);
  __syncthreads();

  // (a record that decodes nothing reads words it does not use)
  const uint32_t* win = !reads ? smem
                        : joint ? smem + (base - lo)
                                : smem + tid * (w + 1);
  Reader rd(win, w, live ? base_bits[p] : 0, live ? rice_k[p] : 0,
            live ? raw_bits[p] : -1);
  // the warp's rows p0 .. p0 + 31 are [32, C] contiguous in out: kPart
  // columns at a time, each lane writes its row's codes into the tile
  // (word j of row r at column j ^ r: one code of the 32 rows hits 32
  // banks), then the warp stores the tile 16 bytes a lane, 4 rows of
  // 128 bytes a store instruction
  int32_t* tile = reinterpret_cast<int32_t*>(smem + span_cap) +
                  warp * 32 * kPart;
  const int64_t p0 = p - lane;
  for (int j0 = 0; j0 < c; j0 += kPart) {
#pragma unroll 1
    for (int jj = 0; jj < kPart; ++jj) {
      tile[lane * kPart + (jj ^ lane)] = j0 + jj < codes ? rd.next() : 0;
    }
    __syncwarp();
    const int c4 = (lane & 7) * 4;
#pragma unroll
    for (int m = 0; m < 8; ++m) {
      const int r = 4 * m + (lane >> 3);
      const int32_t* t = tile + r * kPart;
      if (p0 + r < p_count) {
        *reinterpret_cast<int4*>(out + (p0 + r) * c + j0 + c4) =
            make_int4(t[c4 ^ r], t[(c4 + 1) ^ r], t[(c4 + 2) ^ r],
                      t[(c4 + 3) ^ r]);
      }
    }
    __syncwarp();
  }
}

}  // namespace

// words: u32 bit patterns [w_total]; word_base, base_bits, rice_k,
// raw_bits, count: int32 [p_count]; out: int32 [p_count, c].  All
// device pointers, contiguous.  Launches on `stream` without
// synchronising and returns cudaGetLastError().
extern "C" int atpu_rice_decode(const void* words, const void* word_base,
                                const void* base_bits, const void* rice_k,
                                const void* raw_bits, const void* count,
                                int p_count, int64_t w_total, int w, int c,
                                void* out, void* stream) {
  if (p_count <= 0 || w_total <= 0 || w <= 0 || c <= 0) {
    return 0;
  }
  const int blocks = (p_count + kThreads - 1) / kThreads;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* wd = static_cast<const uint32_t*>(words);
  const auto* wb = static_cast<const int32_t*>(word_base);
  const auto* bb = static_cast<const int32_t*>(base_bits);
  const auto* rk = static_cast<const int32_t*>(rice_k);
  const auto* rb = static_cast<const int32_t*>(raw_bits);
  const auto* ct = static_cast<const int32_t*>(count);
  auto* dst = static_cast<int32_t*>(out);
  if (w <= kStagedW && c % kPart == 0 && c <= kStagedC &&
      reinterpret_cast<uintptr_t>(out) % 16 == 0) {
    // room for the joint span, or for each record's own window
    const int span_cap = kThreads * (w + 1) > kSpanWords ? kThreads * (w + 1)
                                                         : kSpanWords;
    const int bytes = (span_cap + kThreads * kPart) * 4;
    // the shared memory the largest staged bucket needs, allowed once
    // per device (the call is not free, and need not be repeated)
    static bool allowed[kMaxDevices] = {};
    int dev = 0;
    cudaError_t rc = cudaGetDevice(&dev);
    if (rc == cudaSuccess && (dev >= kMaxDevices || !allowed[dev])) {
      rc = cudaFuncSetAttribute(
          rice_staged_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
          (kThreads * (kStagedW + 1) + kThreads * kPart) * 4);
      if (rc == cudaSuccess && dev < kMaxDevices) {
        allowed[dev] = true;
      }
    }
    if (rc != cudaSuccess) {
      return static_cast<int>(rc);
    }
    rice_staged_kernel<<<blocks, kThreads, bytes, st>>>(
        wd, wb, bb, rk, rb, ct, p_count, w_total, w, c, span_cap, dst);
  } else {
    rice_direct_kernel<<<blocks, kThreads, 0, st>>>(
        wd, wb, bb, rk, rb, ct, p_count, w_total, w, c, dst);
  }
  return static_cast<int>(cudaGetLastError());
}
