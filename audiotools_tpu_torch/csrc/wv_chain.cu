// WavPack decorrelation pass chains, encode and decode, for NVIDIA
// Hopper (sm_90a).
//
// Replace the reference's audiotools_tpu/ops/wv_scan.py:268
// (run_pass_chain, the encoder's chain over pass_positive :54 and
// pass_negative :91) and :249 (run_dec_chain, the decoder's, over
// dec_pass_positive :138 and dec_pass_negative :197), lax.scan
// recurrences with no Pallas form.  A block of 1 or 2 channels runs its
// passes (at most 16) in order, each pass's output the next one's
// input; a pass of term t and delta d keeps a weight w a channel and,
// sample by sample,
//   encode:  v = x - ((w * s + 512) >> 10)     w += update(s, v)
//   decode:  v = ((w * s + 512) >> 10) + x     w += update(s, x)
// where update(s, u) is 0 when s or u is 0, +d when their signs agree,
// else -d, and w is clamped to [-1024, 1024] after each step of a
// negative term only.  The source s reads the pass's series (its input
// when encoding, its output when decoding), seeded by the pass's stored
// samples: terms 1-8 the series t samples back; 17 and 18 the two
// latest samples s1, s2 as 2 * s1 - s2 and (3 * s1 - s2) >> 1; the
// negative terms the other channel's series, one sample back but for
// channel 1 under -1 and channel 0 under -2, which read the other
// channel's sample of the same step (so under -2 channel 1 goes first).
// Stored samples: terms 1-8 [t] oldest first, 17/18 [s0, s1] newer
// first, negative terms [1], a channel's chain starting from the other
// channel's stored sample.  The encoder returns each pass's final
// weights and its new stored samples: the last t (1-8) or the last two,
// newer first (17/18), of the stored samples followed by the pass's
// outputs; negative terms keep theirs.  All of it in int64, exactly,
// as ops/wv_scan.py's plain versions and the host C++
// (atpu_wv_correlate / atpu_wv_decorrelate) compute it.
//
// What bounds it.  Bytes: each block's samples read and its outputs
// written once (8 bytes each; a 44,100-sample stereo block is 1.4 MB,
// 0.42 us at 3.35 TB/s).  But every pass is a serial recurrence over
// the block's samples, and the passes of a block run one after another:
// a block is passes * n dependent steps, the weight's update after one
// step feeding the next step's product (and, decoding, each output
// feeding the next step's source).  The step's chain is a 64-bit
// multiply (w * s), the add and shift, the add or subtract of x, the
// compares and select of the update, and its add, each of them two or
// more instructions on 64-bit values, so that one thread also issues
// several dozen instructions a step.
//
// Design (the simple form; speed is later work): one thread a block
// and one block a CUDA block (each thread alone on its SM), both
// channels in one loop, every pass instantiated for its term and the
// block's channel count.  The passes run in place in the output; each
// weight, and each term's history (a ring of up to 8 samples a channel
// for terms 1-8), lives in registers.  The loops step through chunks of
// up to 8 samples, unrolled (for terms 1-8 a multiple of t, so that
// every ring index is static), and load the next chunk into registers
// before they compute the current one.  A batch of blocks (the
// decoder's 32-block groups, the encoder's channel groups of one frame)
// is one launch, blocks of different lengths and chains side by side.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxPasses = 16;
constexpr int kMaxSamples = 8;

__device__ __forceinline__ int64_t apply_weight(int64_t w, int64_t s) {
  return (w * s + 512) >> 10;
}

__device__ __forceinline__ int64_t update_weight(int64_t s, int64_t u,
                                                 int64_t delta) {
  return (s == 0 || u == 0) ? 0 : ((s ^ u) >= 0 ? delta : -delta);
}

__device__ __forceinline__ int64_t clamp1024(int64_t w) {
  return w > 1024 ? 1024 : (w < -1024 ? -1024 : w);
}

// one step of a pass: input x, source s -> the pass's output; updates w
template <bool kEncode>
__device__ __forceinline__ int64_t wv_step(int64_t x, int64_t s, int64_t& w,
                                           int64_t delta) {
  if (kEncode) {
    const int64_t v = x - apply_weight(w, s);
    w += update_weight(s, v, delta);
    return v;
  }
  const int64_t v = apply_weight(w, s) + x;
  w += update_weight(s, x, delta);
  return v;
}

// C consecutive samples of each of a block's CC channels (channel c at
// in + c * n), in registers; past the block's end (kAll false) zeros
template <int CC, int C>
struct Chunk {
  int64_t v[CC][C];
};

template <int CC, int C, bool kAll>
__device__ __forceinline__ void load_chunk(const int64_t* in, int64_t n,
                                           int64_t i, Chunk<CC, C>& ch) {
#pragma unroll
  for (int c = 0; c < CC; ++c) {
#pragma unroll
    for (int j = 0; j < C; ++j) {
      ch.v[c][j] = (kAll || i + j < n) ? in[c * n + i + j] : 0;
    }
  }
}

// runs a pass over a block, C samples a channel at a time: the chunk's
// steps are unrolled (so a pass's state, indexed by the position in the
// chunk, stays in registers) and the next chunk is loaded before the
// current one is computed.  A load may not move above an earlier store
// it may alias (the passes run in place), so without that every step
// would wait for its own load.  Full chunks run without a bound check;
// the last n % C samples after them.
template <int CC, int C, typename Pass>
__device__ __forceinline__ void drive(Pass& pass, const int64_t* in,
                                      int64_t* out, int64_t n) {
  const int64_t full = n - n % C;
  Chunk<CC, C> cur;
  Chunk<CC, C> next;
  if (full > 0) {
    load_chunk<CC, C, true>(in, n, 0, cur);
  } else {
    load_chunk<CC, C, false>(in, n, 0, cur);
  }
  for (int64_t i = 0; i < full; i += C) {
    if (i + C < full) {
      load_chunk<CC, C, true>(in, n, i + C, next);
    } else {
      load_chunk<CC, C, false>(in, n, i + C, next);
    }
#pragma unroll
    for (int j = 0; j < C; ++j) {
      pass.step(j, cur.v[0][j], cur.v[CC - 1][j], out + i + j, n);
    }
    cur = next;
  }
#pragma unroll
  for (int j = 0; j < C; ++j) {
    if (full + j < n) {
      pass.step(j, cur.v[0][j], cur.v[CC - 1][j], out + full + j, n);
    }
  }
}

// terms 1-8: a ring of the last T samples of the series a channel,
// seeded with the stored samples, oldest first; chunks of a multiple of
// T samples keep every ring index static
template <bool kEncode, int CC, int T>
struct RingPass {
  static constexpr int C = T * (8 / T);
  int64_t ring[CC][T];
  int64_t w[CC];
  int64_t delta;

  __device__ __forceinline__ void step(int j, int64_t x0, int64_t x1,
                                       int64_t* o, int64_t n) {
#pragma unroll
    for (int c = 0; c < CC; ++c) {
      const int64_t x = c == 0 ? x0 : x1;
      const int64_t v = wv_step<kEncode>(x, ring[c][j % T], w[c], delta);
      ring[c][j % T] = kEncode ? x : v;
      o[c * n] = v;
    }
  }
};

// terms 17 and 18: the two latest samples of the series, seeded with
// the stored [s0, s1] as (older, newer) = (s1, s0)
template <bool kEncode, int CC, int T>
struct Pass1718 {
  static constexpr int C = 8;
  int64_t older[CC];
  int64_t newer[CC];
  int64_t w[CC];
  int64_t delta;

  __device__ __forceinline__ void step(int, int64_t x0, int64_t x1,
                                       int64_t* o, int64_t n) {
#pragma unroll
    for (int c = 0; c < CC; ++c) {
      const int64_t x = c == 0 ? x0 : x1;
      const int64_t src = T == 18 ? (3 * newer[c] - older[c]) >> 1
                                  : 2 * newer[c] - older[c];
      const int64_t v = wv_step<kEncode>(x, src, w[c], delta);
      older[c] = newer[c];
      newer[c] = kEncode ? x : v;
      o[c * n] = v;
    }
  }
};

// terms -1, -2 and -3 (two channels): each channel's source is the
// other channel's series, channel 0's chain starting from channel 1's
// stored sample and channel 1's from channel 0's
template <bool kEncode, int T>
struct PassNeg {
  static constexpr int C = 8;
  int64_t prev0;
  int64_t prev1;
  int64_t w[2];
  int64_t delta;

  __device__ __forceinline__ void step(int, int64_t x0, int64_t x1,
                                       int64_t* o, int64_t n) {
    int64_t v0;
    int64_t v1;
    if (T == -2) {
      v1 = wv_step<kEncode>(x1, prev0, w[1], delta);
      v0 = wv_step<kEncode>(x0, kEncode ? x1 : v1, w[0], delta);
    } else {
      v0 = wv_step<kEncode>(x0, prev1, w[0], delta);
      v1 = wv_step<kEncode>(x1, T == -1 ? (kEncode ? x0 : v0) : prev0, w[1],
                            delta);
    }
    w[0] = clamp1024(w[0]);
    w[1] = clamp1024(w[1]);
    prev0 = kEncode ? x0 : v0;
    prev1 = kEncode ? x1 : v1;
    o[0] = v0;
    o[n] = v1;
  }
};

template <bool kEncode, int CC, int T>
__device__ __forceinline__ void ring_pass(const int64_t* in, int64_t* out,
                                          int64_t n, int64_t delta,
                                          int64_t* w, const int64_t* s) {
  RingPass<kEncode, CC, T> pass;
#pragma unroll
  for (int c = 0; c < CC; ++c) {
#pragma unroll
    for (int j = 0; j < T; ++j) {
      pass.ring[c][j] = s[c * kMaxSamples + j];
    }
    pass.w[c] = w[c];
  }
  pass.delta = delta;
  drive<CC, RingPass<kEncode, CC, T>::C>(pass, in, out, n);
#pragma unroll
  for (int c = 0; c < CC; ++c) {
    w[c] = pass.w[c];
  }
}

template <bool kEncode, int CC, int T>
__device__ __forceinline__ void pass_1718(const int64_t* in, int64_t* out,
                                          int64_t n, int64_t delta,
                                          int64_t* w, const int64_t* s) {
  Pass1718<kEncode, CC, T> pass;
#pragma unroll
  for (int c = 0; c < CC; ++c) {
    pass.older[c] = s[c * kMaxSamples + 1];
    pass.newer[c] = s[c * kMaxSamples];
    pass.w[c] = w[c];
  }
  pass.delta = delta;
  drive<CC, Pass1718<kEncode, CC, T>::C>(pass, in, out, n);
#pragma unroll
  for (int c = 0; c < CC; ++c) {
    w[c] = pass.w[c];
  }
}

template <bool kEncode, int T>
__device__ __forceinline__ void pass_neg(const int64_t* in, int64_t* out,
                                         int64_t n, int64_t delta,
                                         int64_t* w, const int64_t* s) {
  PassNeg<kEncode, T> pass;
  pass.prev0 = s[kMaxSamples];
  pass.prev1 = s[0];
  pass.w[0] = w[0];
  pass.w[1] = w[1];
  pass.delta = delta;
  drive<2, PassNeg<kEncode, T>::C>(pass, in, out, n);
  w[0] = pass.w[0];
  w[1] = pass.w[1];
}

// one pass over a block of CC channels, from `in` (x for the first pass,
// else `out`: the passes run in place) to `out`; w the weights, s the
// stored samples [2][8]
template <bool kEncode, int CC>
__device__ __forceinline__ void run_pass(int term, const int64_t* in,
                                         int64_t* out, int64_t n,
                                         int64_t delta, int64_t* w,
                                         const int64_t* s) {
  switch (term) {
    case 1: ring_pass<kEncode, CC, 1>(in, out, n, delta, w, s); return;
    case 2: ring_pass<kEncode, CC, 2>(in, out, n, delta, w, s); return;
    case 3: ring_pass<kEncode, CC, 3>(in, out, n, delta, w, s); return;
    case 4: ring_pass<kEncode, CC, 4>(in, out, n, delta, w, s); return;
    case 5: ring_pass<kEncode, CC, 5>(in, out, n, delta, w, s); return;
    case 6: ring_pass<kEncode, CC, 6>(in, out, n, delta, w, s); return;
    case 7: ring_pass<kEncode, CC, 7>(in, out, n, delta, w, s); return;
    case 8: ring_pass<kEncode, CC, 8>(in, out, n, delta, w, s); return;
    case 17: pass_1718<kEncode, CC, 17>(in, out, n, delta, w, s); return;
    case 18: pass_1718<kEncode, CC, 18>(in, out, n, delta, w, s); return;
    default: break;
  }
  if constexpr (CC == 2) {
    switch (term) {
      case -1: pass_neg<kEncode, -1>(in, out, n, delta, w, s); return;
      case -2: pass_neg<kEncode, -2>(in, out, n, delta, w, s); return;
      case -3: pass_neg<kEncode, -3>(in, out, n, delta, w, s); return;
      default: break;
    }
  }
  // not a term of CC channels (the wrapper's packing refuses these)
  for (int64_t i = 0; i < CC * n; ++i) {
    out[i] = in[i];
  }
}

// the new stored samples of an encode pass (see the file's comment), for
// one channel: s the stored samples it started from, out its outputs
__device__ void new_samples(int term, int64_t n, const int64_t* out,
                            const int64_t* s, int64_t* s_new) {
  if (term < 0) {
    for (int j = 0; j < kMaxSamples; ++j) {
      s_new[j] = s[j];
    }
    return;
  }
  const bool t1718 = term == 17 || term == 18;
  const int span = t1718 ? 2 : term;
  for (int j = 0; j < kMaxSamples; ++j) {
    int64_t v = 0;
    if (j < span) {
      // the position among the outputs of the j-th new sample; before
      // them, the stored samples
      const int64_t pos = t1718 ? n - 1 - j : n - span + j;
      v = pos >= 0 ? out[pos] : (t1718 ? s[0] : s[n + j]);
    }
    s_new[j] = v;
  }
}

template <bool kEncode, int CC>
__device__ __forceinline__ void run_block(
    int blk, const int64_t* x, int64_t* out, int64_t n, int passes,
    const int64_t* __restrict__ chain, const int64_t* __restrict__ weights,
    const int64_t* __restrict__ samples, int64_t* __restrict__ w_out,
    int64_t* __restrict__ s_out) {
  if (passes == 0) {
    for (int64_t i = 0; i < CC * n; ++i) {
      out[i] = x[i];
    }
  }
  const int64_t* in = x;
  for (int p = 0; p < kMaxPasses; ++p) {
    const int64_t at = static_cast<int64_t>(blk) * kMaxPasses + p;
    const int64_t* sp = samples + at * 2 * kMaxSamples;
    int64_t w[2] = {weights[at * 2], weights[at * 2 + 1]};
    const int term = static_cast<int>(chain[at * 2]);
    if (p < passes) {
      run_pass<kEncode, CC>(term, in, out, n, chain[at * 2 + 1], w, sp);
      in = out;
    }
    if (kEncode) {
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        w_out[at * 2 + c] = w[c];
        int64_t* so = s_out + (at * 2 + c) * kMaxSamples;
        if (p < passes && c < CC) {
          new_samples(term, n, out + c * n, sp + c * kMaxSamples, so);
        } else {
          for (int j = 0; j < kMaxSamples; ++j) {
            so[j] = sp[c * kMaxSamples + j];
          }
        }
      }
    }
  }
}

template <bool kEncode>
__global__ void __launch_bounds__(1)
wv_chain_kernel(const int64_t* x, const int64_t* __restrict__ meta,
                const int64_t* __restrict__ chain,
                const int64_t* __restrict__ weights,
                const int64_t* __restrict__ samples, int64_t* out,
                int64_t* __restrict__ w_out, int64_t* __restrict__ s_out) {
  const int blk = blockIdx.x;
  const int64_t offset = meta[blk * 4];
  const int64_t n = meta[blk * 4 + 1];
  const int passes = static_cast<int>(meta[blk * 4 + 3]);
  if (meta[blk * 4 + 2] == 2) {
    run_block<kEncode, 2>(blk, x + offset, out + offset, n, passes, chain,
                          weights, samples, w_out, s_out);
  } else {
    run_block<kEncode, 1>(blk, x + offset, out + offset, n, passes, chain,
                          weights, samples, w_out, s_out);
  }
}

template <bool kEncode>
int launch(const void* x, const void* meta, const void* chain,
           const void* weights, const void* samples, int blocks, void* out,
           void* w_out, void* s_out, void* stream) {
  if (blocks <= 0) {
    return 0;
  }
  wv_chain_kernel<kEncode><<<blocks, 1, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int64_t*>(x), static_cast<const int64_t*>(meta),
      static_cast<const int64_t*>(chain), static_cast<const int64_t*>(weights),
      static_cast<const int64_t*>(samples), static_cast<int64_t*>(out),
      static_cast<int64_t*>(w_out), static_cast<int64_t*>(s_out));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The batch's int64 arrays (ops/wv_scan.py pack_blocks): x [total],
// meta [blocks, 4] (offset, n, cc, passes), chain [blocks, 16, 2]
// (term, delta), weights [blocks, 16, 2], samples [blocks, 16, 2, 8];
// out [total] in x's layout.  The encoder also writes each pass's final
// weights w_out [blocks, 16, 2] and new stored samples s_out [blocks,
// 16, 2, 8] (passes past a block's count, and channel 1 of a
// one-channel block, keep their inputs).  Device pointers, contiguous.
// Each launches on `stream` without synchronising and returns
// cudaGetLastError().
extern "C" int atpu_wv_corr(const void* x, const void* meta, const void* chain,
                            const void* weights, const void* samples,
                            int blocks, void* out, void* w_out, void* s_out,
                            void* stream) {
  return launch<true>(x, meta, chain, weights, samples, blocks, out, w_out,
                      s_out, stream);
}

extern "C" int atpu_wv_decorr(const void* x, const void* meta,
                              const void* chain, const void* weights,
                              const void* samples, int blocks, void* out,
                              void* stream) {
  return launch<false>(x, meta, chain, weights, samples, blocks, out, nullptr,
                       nullptr, stream);
}
