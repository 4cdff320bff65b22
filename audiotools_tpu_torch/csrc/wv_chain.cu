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
// first, negative terms [1], channel c's chain starting from the
// sample stored for channel c.  The encoder returns each pass's final
// weights and its new stored samples: the last t (1-8) or the last two,
// newer first (17/18), of the stored samples followed by the pass's
// outputs; negative terms keep theirs.  All of it in int64, exactly,
// as ops/wv_scan.py's plain versions and the host C++
// (atpu_wv_correlate / atpu_wv_decorrelate) compute it.
//
// What bounds it.  Bytes: each block's samples read and its outputs
// written once (8 bytes each; a 44,100-sample stereo block is 1.4 MB,
// 0.42 us at 3.35 TB/s).  The recurrences: within a pass the weight's
// update after one step feeds the next step's product (and, decoding,
// each output feeds the next step's source), so a pass is n dependent
// steps.  But pass p + 1 at step i needs only pass p's outputs up to
// step i, and when encoding every source is the pass's own input, so
// the only chain is the weight's.  So a block's critical path is n
// steps of its slowest pass plus the pipeline's fill, (P - 1) * K steps
// for P passes and chunks of K samples, not P * n.  Decoding under -1
// and -2 the two channels' steps of a sample depend on each other: two
// steps a sample for those passes.  On the card a warp's step is a few
// dozen integer instructions issued for the whole warp though two
// lanes work, so a scheduler that holds two or more pass warps (five
// passes and the loader on four schedulers, sixteen on four) is bound
// by its issue rate before the chain.
//
// Design: one CUDA block a WavPack block, one warp a pass, with lane c
// computing channel c (every lane of a warp runs the same term, so
// nothing diverges, and the two channels cost one instruction stream).
// Warp 0 loads the block's input a chunk of K samples at a time into a
// ring of kStages chunks in shared memory; warp p + 1 runs pass p,
// reading pass p's input ring and writing the next pass's ring, which
// is pass p + 1's input.  The last pass writes the output to global
// memory, so the series between passes never leave shared memory.  A
// ring stage is handed on by two mbarriers, "full" (the producer
// arrives when it has written the chunk) and "empty" (the consumer
// arrives when it has read it).  Each pass's state lives in its lanes'
// registers for the whole block: the weight, the last t samples of
// terms 1-8 (newest first; the chunk's steps are unrolled, so the
// shifts are register renames), the two latest samples of 17/18.
// Every step is int64: a 32-bit weight and a 32 x 32 -> 64-bit product
// would shorten the chain only where a chunk's weight and sources fit,
// and the check and the int64 rerun it needs cost the standard block
// more than the shorter chain gains it (PERF.md).  Encoding, a negative
// term's source is the other channel's input, which the ring holds, so
// each lane reads it there.  Decoding, a negative term's source is the
// other channel's output: lane 0 computes both channels of those passes
// (WV_DEC_SHFL 0), or each lane its own, the outputs of every step
// passed across by a warp shuffle (WV_DEC_SHFL 1).  The encoder's warps
// write their pass's final weights and new stored samples at its end,
// reading the last outputs back from the ring (or from the output, for
// the last pass).  A batch of blocks (the decoder's 32-block groups,
// the encoder's channel groups of one frame) is one launch, blocks of
// different lengths and chains side by side.  WV_CHUNK, WV_STAGES and
// WV_DEC_SHFL are the build's choices, which
// tools_dev/wv_chain_variants.py times.

#include <cstdint>
#include <cuda_runtime.h>

#ifndef WV_CHUNK
#define WV_CHUNK 16
#endif
#ifndef WV_STAGES
#define WV_STAGES 4
#endif
#ifndef WV_DEC_SHFL
#define WV_DEC_SHFL 0
#endif


namespace {

constexpr int kMaxPasses = 16;
constexpr int kMaxSamples = 8;
constexpr int kChunk = WV_CHUNK;
constexpr int kStages = WV_STAGES;
// a channel's row of a ring stage, padded so that the two lanes' 8-byte
// accesses fall in different banks
constexpr int kPitch = kChunk + 1;
constexpr int kStage = 2 * kPitch;
constexpr int kThreads = 32 * (1 + kMaxPasses);
constexpr size_t kBarrierBytes = 2 * kMaxPasses * kStages * sizeof(uint64_t);
constexpr size_t kSmemBytes =
    kBarrierBytes + sizeof(int64_t) * kMaxPasses * kStages * kStage;
static_assert(kChunk >= kMaxSamples,
              "a pass's last 8 outputs must lie in its ring's last two "
              "chunks");
static_assert(kStages >= 2, "the ring needs two stages");

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void bar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;"
               :: "r"(smem_addr(bar)), "r"(count) : "memory");
}

// arrives on the barrier, releasing the thread's earlier writes to
// whoever waits on the phase
__device__ __forceinline__ void bar_arrive(uint64_t* bar) {
  asm volatile("{\n\t.reg .b64 state;\n\t"
               "mbarrier.arrive.shared::cta.b64 state, [%0];\n\t}"
               :: "r"(smem_addr(bar)) : "memory");
}

// waits until the barrier's phase of the given parity has completed
__device__ __forceinline__ void bar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile("{\n\t.reg .pred p;\n\t"
                 "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
                 "selp.u32 %0, 1, 0, p;\n\t}"
                 : "=r"(done) : "r"(smem_addr(bar)), "r"(parity)
                 : "memory");
  } while (!done);
}

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

// one step of a pass: input x, source s -> the pass's output; updates
// the weight
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

// a pass's place in the pipeline: its input ring and barriers, its
// output ring and barriers (ring_out null for the block's last pass,
// which writes the block's output gout, channel c at gout + c * n)
struct Link {
  const int64_t* in;
  uint64_t* in_full;
  uint64_t* in_empty;
  int64_t* ring_out;
  uint64_t* out_full;
  uint64_t* out_empty;
  int64_t* gout;
  int64_t n;
  unsigned mask;  // the warp's working lanes: one a channel
};

// a chunk's steps, unrolled: all kChunk of them (kFull) or the first
// rem
template <bool kFull, typename Pass>
__device__ __forceinline__ void steps(Pass& pass, const int64_t* mine,
                                      const int64_t* other, int64_t* o_mine,
                                      int64_t* o_other, int rem) {
#pragma unroll
  for (int k = 0; k < kChunk; ++k) {
    if (kFull || k < rem) {
      pass.step(mine, other, k, o_mine[k], o_other[Pass::kBoth ? k : 0]);
    }
  }
}

// runs a pass over its block, a chunk of kChunk samples at a time: waits
// for the input chunk (and, unless it is the last pass, for its output
// stage to be free), runs the chunk's steps unrolled (full chunks
// without a bound check), and hands both stages on.  step(mine, other,
// k, v_mine, v_other) reads sample k of lane c's channel and of the
// other channel and gives the output of lane c's channel (and, for a
// pass one lane runs for both channels, kBoth, the other channel's).
template <typename Pass>
__device__ __forceinline__ void drive(Pass& pass, int c, const Link& io) {
  const bool last = io.ring_out == nullptr;
  const int64_t n = io.n;
  int64_t j = 0;
  for (int64_t i0 = 0; i0 < n; i0 += kChunk, ++j) {
    const int s = static_cast<int>(j % kStages);
    const uint32_t phase = static_cast<uint32_t>(j / kStages) & 1u;
    bar_wait(io.in_full + s, phase);
    if (!last) {
      bar_wait(io.out_empty + s, phase ^ 1u);
    }
    const int64_t* in = io.in + s * kStage;
    int64_t* o0 = last ? io.gout + i0 : io.ring_out + s * kStage;
    const int64_t ostride = last ? n : kPitch;
    const int64_t* mine = in + c * kPitch;
    const int64_t* other = in + (c ^ 1) * kPitch;
    int64_t* o_mine = o0 + c * ostride;
    int64_t* o_other = o0 + (c ^ 1) * ostride;
    if (pass.computes) {
      if (i0 + kChunk <= n) {
        steps<true>(pass, mine, other, o_mine, o_other, kChunk);
      } else {
        steps<false>(pass, mine, other, o_mine, o_other,
                     static_cast<int>(n - i0));
      }
    }
    __syncwarp(io.mask);
    bar_arrive(io.in_empty + s);
    if (!last) {
      bar_arrive(io.out_full + s);
    }
  }
}

// Each pass below keeps its weight(s) w; step(mine, other, k, v_mine,
// v_other) runs sample k.

// terms 1-8, a channel a lane: the last T samples of the series, newest
// first (h[T - 1] is the source)
template <bool kEncode, int T>
struct RingLane {
  static constexpr bool kBoth = false;
  bool computes = true;
  int64_t h[T];
  int64_t w;
  int64_t delta;

  __device__ __forceinline__ void step(const int64_t* mine, const int64_t*,
                                       int k, int64_t& o, int64_t&) {
    const int64_t x = mine[k];
    const int64_t v = wv_step<kEncode>(x, h[T - 1], w, delta);
#pragma unroll
    for (int m = T - 1; m > 0; --m) {
      h[m] = h[m - 1];
    }
    h[0] = kEncode ? x : v;
    o = v;
  }
};

// terms 17 and 18, a channel a lane: the two latest samples
template <bool kEncode, int T>
struct Lane1718 {
  static constexpr bool kBoth = false;
  bool computes = true;
  int64_t older;
  int64_t newer;
  int64_t w;
  int64_t delta;

  __device__ __forceinline__ void step(const int64_t* mine, const int64_t*,
                                       int k, int64_t& o, int64_t&) {
    const int64_t x = mine[k];
    const int64_t src = T == 18 ? (3 * newer - older) >> 1
                                : 2 * newer - older;
    const int64_t v = wv_step<kEncode>(x, src, w, delta);
    older = newer;
    newer = kEncode ? x : v;
    o = v;
  }
};

// encoding under -1, -2 and -3, a channel a lane: the source is the
// other channel's input, of this step (`same`) or of the step before
// (`prev`, seeded with the lane's stored sample)
struct NegEncLane {
  static constexpr bool kBoth = false;
  bool computes = true;
  bool same;
  int64_t prev;
  int64_t w;
  int64_t delta;

  __device__ __forceinline__ void step(const int64_t* mine,
                                       const int64_t* other, int k,
                                       int64_t& o, int64_t&) {
    const int64_t x = mine[k];
    const int64_t xo = other[k];
    const int64_t v = wv_step<true>(x, same ? xo : prev, w, delta);
    w = clamp1024(w);
    prev = xo;
    o = v;
  }
};

// decoding under -1, -2 and -3, lane 0 computing both channels (lane 1
// only hands the stages on): prev0 and prev1 the channels' outputs of
// the step before, seeded with the samples stored for channel 1 and 0
template <int T>
struct NegDecPair {
  static constexpr bool kBoth = true;
  bool computes;
  int64_t prev0;
  int64_t prev1;
  int64_t w0;
  int64_t w1;
  int64_t delta;

  __device__ __forceinline__ void step(const int64_t* in0,
                                       const int64_t* in1, int k,
                                       int64_t& o0, int64_t& o1) {
    const int64_t x0 = in0[k];
    const int64_t x1 = in1[k];
    int64_t v0;
    int64_t v1;
    if (T == -2) {
      v1 = wv_step<false>(x1, prev0, w1, delta);
      v0 = wv_step<false>(x0, v1, w0, delta);
    } else {
      v0 = wv_step<false>(x0, prev1, w0, delta);
      v1 = wv_step<false>(x1, T == -1 ? v0 : prev0, w1, delta);
    }
    w0 = clamp1024(w0);
    w1 = clamp1024(w1);
    prev0 = v0;
    prev1 = v1;
    o0 = v0;
    o1 = v1;
  }
};

// decoding under -1, -2 and -3, a channel a lane: `prev` is the other
// channel's output of the step before (seeded with the lane's stored
// sample).  Under -1 (-2) lane 0 (1) steps first and passes its output
// across for the other lane's source; under -3 both step at once.
// Every step ends with a shuffle of the two outputs.
template <int T>
struct NegDecLane {
  static constexpr bool kBoth = false;
  bool computes = true;
  bool first;  // the lane that steps first under -1 and -2
  int64_t prev;
  int64_t w;
  int64_t delta;

  __device__ __forceinline__ void step(const int64_t* mine, const int64_t*,
                                       int k, int64_t& o, int64_t&) {
    const int64_t x = mine[k];
    int64_t v = 0;
    if (T == -3) {
      v = wv_step<false>(x, prev, w, delta);
    } else {
      if (first) {
        v = wv_step<false>(x, prev, w, delta);
      }
      const int64_t vf = __shfl_sync(0x3u, v, T == -2 ? 1 : 0);
      if (!first) {
        v = wv_step<false>(x, vf, w, delta);
      }
    }
    w = clamp1024(w);
    prev = __shfl_xor_sync(0x3u, v, 1);
    o = v;
  }
};

// a term the kernel does not take (the wrapper's packing refuses
// these): the output is the input, the weight kept
struct CopyLane {
  static constexpr bool kBoth = false;
  bool computes = true;
  int64_t w;

  __device__ __forceinline__ void step(const int64_t* mine, const int64_t*,
                                       int k, int64_t& o, int64_t&) {
    o = mine[k];
  }
};

template <bool kEncode, int T>
__device__ __forceinline__ int64_t ring_lane(int c, const Link& io,
                                          int64_t delta, const int64_t* wp,
                                          const int64_t* sp) {
  RingLane<kEncode, T> pass;
#pragma unroll
  for (int m = 0; m < T; ++m) {
    pass.h[m] = sp[c * kMaxSamples + T - 1 - m];
  }
  pass.w = wp[c];
  pass.delta = delta;
  drive(pass, c, io);
  return pass.w;
}

template <bool kEncode, int T>
__device__ __forceinline__ int64_t lane_1718(int c, const Link& io,
                                          int64_t delta, const int64_t* wp,
                                          const int64_t* sp) {
  Lane1718<kEncode, T> pass;
  pass.newer = sp[c * kMaxSamples];
  pass.older = sp[c * kMaxSamples + 1];
  pass.w = wp[c];
  pass.delta = delta;
  drive(pass, c, io);
  return pass.w;
}

__device__ __forceinline__ int64_t neg_enc_lane(int term, int c,
                                             const Link& io, int64_t delta,
                                             const int64_t* wp,
                                             const int64_t* sp) {
  NegEncLane pass;
  pass.same = (term == -1 && c == 1) || (term == -2 && c == 0);
  pass.prev = sp[c * kMaxSamples];
  pass.w = wp[c];
  pass.delta = delta;
  drive(pass, c, io);
  return pass.w;
}

template <int T>
__device__ __forceinline__ void neg_dec(int c, const Link& io, int64_t delta,
                                       const int64_t* wp, const int64_t* sp) {
#if WV_DEC_SHFL
  NegDecLane<T> pass;
  pass.first = c == (T == -2 ? 1 : 0);
  pass.prev = sp[c * kMaxSamples];
  pass.w = wp[c];
#else
  NegDecPair<T> pass;
  pass.computes = c == 0;
  pass.prev0 = sp[kMaxSamples];
  pass.prev1 = sp[0];
  pass.w0 = wp[0];
  pass.w1 = wp[1];
#endif
  pass.delta = delta;
  drive(pass, c, io);
}

__device__ __forceinline__ int64_t copy_lane(int c, const Link& io,
                                          const int64_t* wp) {
  CopyLane pass;
  pass.w = wp[c];
  drive(pass, c, io);
  return pass.w;
}

// one pass of a block, lane c's channel; returns the lane's final
// weight (decoding, the starting one: the decoder returns no weights)
template <bool kEncode>
__device__ int64_t run_pass(int term, int c, int cc, const Link& io,
                            int64_t delta, const int64_t* wp,
                            const int64_t* sp) {
  switch (term) {
    case 1: return ring_lane<kEncode, 1>(c, io, delta, wp, sp);
    case 2: return ring_lane<kEncode, 2>(c, io, delta, wp, sp);
    case 3: return ring_lane<kEncode, 3>(c, io, delta, wp, sp);
    case 4: return ring_lane<kEncode, 4>(c, io, delta, wp, sp);
    case 5: return ring_lane<kEncode, 5>(c, io, delta, wp, sp);
    case 6: return ring_lane<kEncode, 6>(c, io, delta, wp, sp);
    case 7: return ring_lane<kEncode, 7>(c, io, delta, wp, sp);
    case 8: return ring_lane<kEncode, 8>(c, io, delta, wp, sp);
    case 17: return lane_1718<kEncode, 17>(c, io, delta, wp, sp);
    case 18: return lane_1718<kEncode, 18>(c, io, delta, wp, sp);
    default: break;
  }
  if (cc == 2 && term >= -3 && term <= -1) {
    if constexpr (kEncode) {
      return neg_enc_lane(term, c, io, delta, wp, sp);
    } else {
      switch (term) {
        case -1: neg_dec<-1>(c, io, delta, wp, sp); break;
        case -2: neg_dec<-2>(c, io, delta, wp, sp); break;
        default: neg_dec<-3>(c, io, delta, wp, sp); break;
      }
      return wp[c];
    }
  }
  return copy_lane(c, io, wp);
}

// an encode pass's new stored samples for channel c (see the file's
// comment), reading its last outputs back from where it wrote them
__device__ void store_samples(int term, int c, const Link& io,
                              const int64_t* sp, int64_t* so) {
  const int64_t* own = sp + c * kMaxSamples;
  const bool t1718 = term == 17 || term == 18;
  if (!(t1718 || (term >= 1 && term <= 8))) {
    for (int j = 0; j < kMaxSamples; ++j) {
      so[j] = own[j];
    }
    return;
  }
  const int64_t n = io.n;
  const int span = t1718 ? 2 : term;
  for (int j = 0; j < kMaxSamples; ++j) {
    int64_t v = 0;
    if (j < span) {
      // the position among the outputs of the j-th new sample; before
      // them, the stored samples
      const int64_t pos = t1718 ? n - 1 - j : n - span + j;
      if (pos < 0) {
        v = t1718 ? own[0] : own[n + j];
      } else if (io.ring_out == nullptr) {
        v = io.gout[c * n + pos];
      } else {
        v = io.ring_out[((pos / kChunk) % kStages) * kStage + c * kPitch +
                        pos % kChunk];
      }
    }
    so[j] = v;
  }
}

// warp 0: the block's input, a chunk at a time, into pass 0's ring
// (zeros past the block's end)
__device__ void load_input(const int64_t* __restrict__ xb, int64_t n, int cc,
                           int64_t* ring, uint64_t* full, uint64_t* empty,
                           int lane) {
  int64_t j = 0;
  for (int64_t i0 = 0; i0 < n; i0 += kChunk, ++j) {
    const int s = static_cast<int>(j % kStages);
    const uint32_t phase = static_cast<uint32_t>(j / kStages) & 1u;
    bar_wait(empty + s, phase ^ 1u);
    int64_t* stage = ring + s * kStage;
#pragma unroll 4
    for (int v = lane; v < cc * kChunk; v += 32) {
      const int ch = v / kChunk;
      const int k = v % kChunk;
      const int64_t i = i0 + k;
      stage[ch * kPitch + k] = i < n ? xb[ch * n + i] : 0;
    }
    bar_arrive(full + s);
  }
}

// one pass of a block (lane c's channel), or, for a pass past the
// block's count and channel 1 of a one-channel block, the state kept
template <bool kEncode>
__device__ void run_warp(int blk, int p, int c, int64_t n, int cc, int passes,
                         const int64_t* __restrict__ chain,
                         const int64_t* __restrict__ weights,
                         const int64_t* __restrict__ samples, int64_t* ob,
                         int64_t* rings, uint64_t* full, uint64_t* empty,
                         int64_t* __restrict__ w_out,
                         int64_t* __restrict__ s_out) {
  const int64_t at = static_cast<int64_t>(blk) * kMaxPasses + p;
  const int64_t* wp = weights + at * 2;
  const int64_t* sp = samples + at * 2 * kMaxSamples;
  if (p >= passes || c >= cc) {
    if (kEncode) {
      w_out[at * 2 + c] = wp[c];
      for (int j = 0; j < kMaxSamples; ++j) {
        s_out[(at * 2 + c) * kMaxSamples + j] = sp[c * kMaxSamples + j];
      }
    }
    return;
  }
  const bool last = p == passes - 1;
  Link io;
  io.in = rings + p * kStages * kStage;
  io.in_full = full + p * kStages;
  io.in_empty = empty + p * kStages;
  io.ring_out = last ? nullptr : rings + (p + 1) * kStages * kStage;
  io.out_full = last ? nullptr : full + (p + 1) * kStages;
  io.out_empty = last ? nullptr : empty + (p + 1) * kStages;
  io.gout = ob;
  io.n = n;
  io.mask = cc == 2 ? 0x3u : 0x1u;
  const int term = static_cast<int>(chain[at * 2]);
  const int64_t w = run_pass<kEncode>(term, c, cc, io, chain[at * 2 + 1],
                                      wp, sp);
  if (kEncode) {
    w_out[at * 2 + c] = w;
    store_samples(term, c, io, sp, s_out + (at * 2 + c) * kMaxSamples);
  }
}

template <bool kEncode>
__global__ void __launch_bounds__(kThreads, 1)
wv_chain_kernel(const int64_t* __restrict__ x,
                const int64_t* __restrict__ meta,
                const int64_t* __restrict__ chain,
                const int64_t* __restrict__ weights,
                const int64_t* __restrict__ samples, int64_t* out,
                int64_t* __restrict__ w_out, int64_t* __restrict__ s_out) {
  extern __shared__ __align__(16) unsigned char smem[];
  // full[b][s] and empty[b][s] of ring b (pass b's input), then the
  // rings [b][s][2][kPitch]
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  uint64_t* empty = full + kMaxPasses * kStages;
  int64_t* rings = reinterpret_cast<int64_t*>(smem + kBarrierBytes);
  const int blk = blockIdx.x;
  const int64_t offset = meta[blk * 4];
  const int64_t n = meta[blk * 4 + 1];
  const int cc = meta[blk * 4 + 2] == 2 ? 2 : 1;
  const int64_t passes_in = meta[blk * 4 + 3];
  const int passes = static_cast<int>(
      passes_in < 0 ? 0 : (passes_in > kMaxPasses ? kMaxPasses : passes_in));
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (threadIdx.x == 0) {
    for (int b = 0; b < kMaxPasses; ++b) {
      for (int s = 0; s < kStages; ++s) {
        bar_init(full + b * kStages + s, b == 0 ? 32 : cc);
        bar_init(empty + b * kStages + s, cc);
      }
    }
  }
  __syncthreads();
  const int64_t* xb = x + offset;
  int64_t* ob = out + offset;
  if (warp == 0) {
    if (passes == 0) {
      for (int64_t i = lane; i < cc * n; i += 32) {
        ob[i] = xb[i];
      }
    } else {
      load_input(xb, n, cc, rings, full, empty, lane);
    }
  } else if (lane < 2) {
    run_warp<kEncode>(blk, warp - 1, lane, n, cc, passes, chain, weights,
                      samples, ob, rings, full, empty, w_out, s_out);
  }
}

template <bool kEncode>
int launch(const void* x, const void* meta, const void* chain,
           const void* weights, const void* samples, int blocks, void* out,
           void* w_out, void* s_out, void* stream) {
  if (blocks <= 0) {
    return 0;
  }
  // rings past the 48 KB a block gets without asking (a build with
  // larger chunks or more stages) need the opt-in, which belongs to the
  // current device
  if constexpr (kSmemBytes > 48 * 1024) {
    const cudaError_t rc = cudaFuncSetAttribute(
        wv_chain_kernel<kEncode>,
        cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(kSmemBytes));
    if (rc != cudaSuccess) {
      return static_cast<int>(rc);
    }
  }
  wv_chain_kernel<kEncode><<<blocks, kThreads, kSmemBytes,
                             static_cast<cudaStream_t>(stream)>>>(
          static_cast<const int64_t*>(x), static_cast<const int64_t*>(meta),
          static_cast<const int64_t*>(chain),
          static_cast<const int64_t*>(weights),
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

// the build's pipeline: chunk samples, ring stages, and whether the
// decoder's negative terms run a lane a channel with shuffles (1) or
// both channels on one lane (0)
extern "C" void atpu_wv_chain_config(int* chunk, int* stages,
                                     int* dec_shfl) {
  *chunk = kChunk;
  *stages = kStages;
  *dec_shfl = WV_DEC_SHFL;
}
