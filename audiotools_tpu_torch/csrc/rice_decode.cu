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
// directly: one thread per record reads the stream's words from
// global memory, finds the quotient with __clz on the current word,
// and past it walks forward to the next nonzero word.
//
// The arithmetic follows the reference's scan form exactly, clamps
// included (rice_decode.py:196-199, 222-266): the window is the W + 1
// words from word_base, each read clamped to the buffer's last word
// Wtot - 1; bit positions clamp to N - 1 = 32 W - 1; a quotient that
// runs off the window ends at N - 1.  Padded records (count 0) and the
// last record of the buffer never read past it.
//
// Bound: memory.  The kernel reads each record's span of the words
// once (the whole word buffer, ~12 MB for a 1024-frame FLAC -8 stereo
// batch) and writes P * C int32 (P ~ 131k records of C = 64: 34 MB).
// Design: a thread walks its record serially, so 131k threads fill
// the card, but each thread's stores of its own row are strided by
// C * 4 bytes across the warp.  Later work: stage output rows through
// shared memory for coalesced stores, and tile word loads.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;

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
rice_decode_kernel(const uint32_t* __restrict__ words,
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
  rice_decode_kernel<<<blocks, kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(words),
      static_cast<const int32_t*>(word_base),
      static_cast<const int32_t*>(base_bits),
      static_cast<const int32_t*>(rice_k),
      static_cast<const int32_t*>(raw_bits),
      static_cast<const int32_t*>(count), p_count, w_total, w, c,
      static_cast<int32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}
