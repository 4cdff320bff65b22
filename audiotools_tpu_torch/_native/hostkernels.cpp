// Host-side FLAC, ALAC, TTA, Shorten and WavPack kernels of the
// PyTorch/CUDA port.
//
// A copy of the FLAC, ALAC, TTA, Shorten, WavPack, CRC and MD5 parts of
// the reference package's host library (audiotools_tpu/_native/
// hostkernels.cpp), so that the port loads nothing of the reference.
// Entry points, layouts and error codes are the reference's, unchanged,
// but for the output capacity of the TTA encoder and packer
// (atpu_tta_encode_frames) and of the WavPack residual coder
// (atpu_wv_write_bitstream):
//   * atpu_flac_emit_frames2 / atpu_flac_emit_frames2rb: FLAC frame
//     emit from packed decision rows (the batched encoder's emitter),
//     optionally splicing device-packed residual bits;
//   * atpu_md5_*: MD5 with a fused int32-PCM update;
//   * atpu_pack_pcm / atpu_unpack_pcm, atpu_crc8 / atpu_crc16,
//     atpu_ogg_crc (the Ogg page CRC-32);
//   * atpu_flac_decode: the complete host FLAC frame decoder;
//   * atpu_flac_scan: the structural scan of the device decode path
//     (frame/subframe metadata and residual-partition bit spans);
//   * atpu_alac_emit_framesets / atpu_alac_decode / atpu_alac_scan:
//     the ALAC adaptive emitter, host decoder and the structural scan
//     of the device decode path;
//   * atpu_tta_encode_frames / atpu_tta_pack_frames /
//     atpu_tta_decode_frame / atpu_tta_scan_residuals: the TTA host
//     encoder, residual packer, frame decoder and the entropy scan of
//     the device decode path;
//   * atpu_shn_encode2 / atpu_shn_encode / atpu_shn_decode /
//     atpu_shn_scan / atpu_shn_split: the Shorten emitter (steered by
//     the device analysis's decisions, or deciding itself), host
//     decoder, the entropy scan of the device decode path and the
//     VERBATIM container split;
//   * atpu_wv_crc / atpu_wv_correlate / atpu_wv_write_bitstream /
//     atpu_wv_read_bitstream / atpu_wv_decorrelate: the WavPack block
//     CRC, one encode decorrelation pass, the adaptive-medians residual
//     coder and reader, and one decode decorrelation pass;
//   * atpu_resample_fir / atpu_accuraterip_update / atpu_iir: the
//     converters' host twins (the resampler's polyphase FIR, the
//     AccurateRip V1/V2 sums and the ReplayGain filters' IIR);
//   * atpu_verify_mpeg: the MPEG audio frame walker (MP3 and MP2
//     verification and frame counts);
//   * atpu_mlp_new / atpu_mlp_free / atpu_mlp_decode: the MLP decoder
//     context of the DVD-Audio title reader.
// The port's own additions: atpu_shn_header (the stream header's
// fields and leading VERBATIM bytes) and atpu_shn_warm_chain (the device decode's warm-up chain,
// a Python loop over rows in the reference).
//
// Build: g++ -O3 -shared -fPIC (see __init__.py); loaded via ctypes.

#include <cstdint>
#include <cstring>
#include <vector>
#include <cstdio>
#include <cstdlib>

#if defined(__AVX512F__)
#include <immintrin.h>
#define ATPU_AVX512 1
#endif

#if defined(__GNUC__)
#define RESTRICT __restrict__
#else
#define RESTRICT
#endif

namespace {

// ---------------------------------------------------------------- CRC --
struct CrcTables {
    uint8_t crc8[256];
    uint16_t crc16[8][256];   // slice-by-8: crc16[k][x] = CRC of byte
                              // x followed by k zero bytes
    CrcTables() {
        for (int b = 0; b < 256; b++) {
            uint32_t c8 = b;
            for (int i = 0; i < 8; i++)
                c8 = (c8 & 0x80) ? ((c8 << 1) ^ 0x07) : (c8 << 1);
            crc8[b] = (uint8_t)c8;
            uint32_t c16 = (uint32_t)b << 8;
            for (int i = 0; i < 8; i++)
                c16 = (c16 & 0x8000) ? ((c16 << 1) ^ 0x8005) : (c16 << 1);
            crc16[0][b] = (uint16_t)c16;
        }
        for (int k = 1; k < 8; k++)
            for (int b = 0; b < 256; b++) {
                const uint16_t c = crc16[k - 1][b];
                crc16[k][b] = (uint16_t)(crc16[0][c >> 8] ^ (c << 8));
            }
    }
};
static const CrcTables tables;

static inline uint8_t crc8_buf(const uint8_t* p, int64_t n, uint8_t crc) {
    for (int64_t i = 0; i < n; i++) crc = tables.crc8[crc ^ p[i]];
    return crc;
}

static inline uint16_t crc16_buf(const uint8_t* p, int64_t n,
                                 uint16_t crc) {
    // slice-by-8 main loop (the CRC distributes over the high bytes
    // because the generator acts linearly on each byte lane)
    while (n >= 8) {
        crc = (uint16_t)(tables.crc16[7][(crc >> 8) ^ p[0]] ^
                         tables.crc16[6][(crc & 0xFF) ^ p[1]] ^
                         tables.crc16[5][p[2]] ^
                         tables.crc16[4][p[3]] ^
                         tables.crc16[3][p[4]] ^
                         tables.crc16[2][p[5]] ^
                         tables.crc16[1][p[6]] ^
                         tables.crc16[0][p[7]]);
        p += 8;
        n -= 8;
    }
    for (int64_t i = 0; i < n; i++)
        crc = (uint16_t)(tables.crc16[0][(crc >> 8) ^ p[i]] ^
                         (crc << 8));
    return crc;
}

// ---------------------------------------------------------- bit writer --
struct BitWriter {
    uint8_t* out;
    int64_t pos;        // byte position
    uint64_t acc;       // bit accumulator, MSB-first
    int bits;           // bits currently in acc
    int64_t limit;      // byte capacity (writes stop, overflow set)
    bool overflow;

    explicit BitWriter(uint8_t* buffer, int64_t start,
                       int64_t capacity = INT64_MAX)
        : out(buffer), pos(start), acc(0), bits(0), limit(capacity),
          overflow(false) {}

    inline void flush_bytes() {
        if (__builtin_expect(pos + 8 > limit, 0)) {
            // slow guarded path near the end of the buffer; bad
            // decision arrays must error, never scribble
            while (bits >= 8) {
                bits -= 8;
                if (pos >= limit) {
                    overflow = true;
                    bits = 0;
                    acc = 0;
                    return;
                }
                out[pos++] = (uint8_t)(acc >> bits);
            }
            acc &= (bits ? ((1ULL << bits) - 1) : 0);
            return;
        }
        // one top-aligned 8-byte store drains every full byte (the
        // 1-2 scratch bytes past the new pos are rewritten by later
        // flushes; capacity was checked above)
        if (bits == 0) return;
        const int nbytes = bits >> 3;
        const int rem = bits & 7;
        uint64_t v = (bits == 64) ? acc : (acc << (64 - bits));
        v = __builtin_bswap64(v);
        __builtin_memcpy(out + pos, &v, 8);
        pos += nbytes;
        bits = rem;
        acc &= (rem ? ((1ULL << rem) - 1) : 0);
    }

    // writes a token: nbits total, low bits of val are the payload,
    // leading bits are zero (val's significant bits <= 57 guaranteed).
    // Flushing is LAZY: the accumulator drains only when the next
    // token would overflow 64 bits, so the typical token is a single
    // predicted branch + shift + or (the emitters' hottest path —
    // per-sample Rice codes)
    inline void put(uint64_t val, int64_t nbits) {
        const int64_t nb = bits + nbits;
        if (__builtin_expect(nb <= 64, 1)) {
            if (__builtin_expect(overflow, 0)) return;
            acc = (acc << nbits) | val;
            bits = (int)nb;
            return;
        }
        put_slow(val, nbits);
    }

    __attribute__((noinline))
    void put_slow(uint64_t val, int64_t nbits) {
        if (overflow) return;
        flush_bytes();                          // leaves bits < 8
        // emit implicit leading zeros beyond 57 payload bits
        while (nbits > 57) {
            if (overflow) return;
            int64_t zeros = nbits - 57;
            int64_t take = zeros > 32 ? 32 : zeros;
            acc <<= take;        // append 'take' zero bits
            bits += (int)take;
            flush_bytes();
            nbits -= take;
        }
        acc = (acc << nbits) | val;
        bits += (int)nbits;
    }

    inline void byte_align() {
        flush_bytes();          // drain lazy accumulator (bits < 8)
        if (bits) {
            acc <<= (8 - bits);
            bits = 8;
            flush_bytes();
        }
    }
};

// ---------------------------------------------------------- bit reader --
struct BitReader {
    const uint8_t* data;
    int64_t len;
    int64_t pos;       // byte position
    uint64_t acc;
    int bits;
    bool error;

    BitReader(const uint8_t* d, int64_t n)
        : data(d), len(n), pos(0), acc(0), bits(0), error(false) {}

    inline bool refill(int need) {
        while (bits < need) {
            if (pos >= len) { error = true; return false; }
            acc = (acc << 8) | data[pos++];
            bits += 8;
        }
        return true;
    }

    inline uint64_t get(int n) {
        if (n == 0) return 0;
        uint64_t value = 0;
        while (n > 56) {
            if (!refill(8)) return 0;
            value = (value << 8) | ((acc >> (bits - 8)) & 0xFF);
            bits -= 8;
            n -= 8;
        }
        if (!refill(n)) return 0;
        value = (value << n) | ((acc >> (bits - n)) & ((1ULL << n) - 1));
        bits -= n;
        return value;
    }

    inline int64_t get_signed(int n) {
        uint64_t v = get(n);
        if (n && (v & (1ULL << (n - 1)))) {
            return (int64_t)v - (1LL << n);
        }
        return (int64_t)v;
    }

    // counts zero bits before the next 1 bit
    inline int64_t unary() {
        int64_t count = 0;
        for (;;) {
            if (bits == 0) {
                if (pos >= len) { error = true; return 0; }
                acc = data[pos++];
                bits = 8;
            }
            uint64_t window = acc & ((1ULL << bits) - 1);
            if (window == 0) {
                count += bits;
                bits = 0;
                continue;
            }
            // index of highest set bit within window
            int high = 63 - __builtin_clzll(window);
            count += bits - 1 - high;
            bits = high;        // consume through the 1 bit
            return count;
        }
    }

    inline void byte_align() { bits -= bits % 8; }

    inline int64_t byte_pos() const { return pos - bits / 8; }
};


}  // namespace


// ---------------------------------------------------- FLAC frame emit --
namespace {

inline void put_signed(BitWriter& w, int64_t value, int nbits) {
    w.put((uint64_t)(value & ((1LL << nbits) - 1)), nbits);
}

inline void put_wasted(BitWriter& w, int wasted) {
    if (wasted > 0) {
        w.put(1, 1);
        w.put(1, wasted);       // (wasted-1) implicit zeros then a 1
    } else {
        w.put(0, 1);
    }
}

// order-specialized LPC residual kernels: the fixed trip count lets
// the compiler fully unroll + vectorize the MAC loop (the emitter's
// hottest arithmetic)
template <int ORDER>
static void lpc_res_t(const int32_t* samp, int64_t n,
                      const int32_t* q, int shift, int64_t* res) {
    for (int64_t i = ORDER; i < n; i++) {
        int64_t pred = 0;
        for (int j = 0; j < ORDER; j++)
            pred += (int64_t)q[j] * samp[i - 1 - j];
        res[i] = samp[i] - (pred >> shift);
    }
}

static void lpc_res_generic(const int32_t* samp, int64_t n, int order,
                            const int32_t* q, int shift, int64_t* res) {
    for (int64_t i = order; i < n; i++) {
        int64_t pred = 0;
        for (int j = 0; j < order; j++)
            pred += (int64_t)q[j] * samp[i - 1 - j];
        res[i] = samp[i] - (pred >> shift);
    }
}

static void lpc_residuals_dispatch(const int32_t* samp, int64_t n,
                                   int order, const int32_t* q,
                                   int shift, int64_t* res) {
    switch (order) {
    case 1: lpc_res_t<1>(samp, n, q, shift, res); break;
    case 2: lpc_res_t<2>(samp, n, q, shift, res); break;
    case 3: lpc_res_t<3>(samp, n, q, shift, res); break;
    case 4: lpc_res_t<4>(samp, n, q, shift, res); break;
    case 5: lpc_res_t<5>(samp, n, q, shift, res); break;
    case 6: lpc_res_t<6>(samp, n, q, shift, res); break;
    case 7: lpc_res_t<7>(samp, n, q, shift, res); break;
    case 8: lpc_res_t<8>(samp, n, q, shift, res); break;
    case 9: lpc_res_t<9>(samp, n, q, shift, res); break;
    case 10: lpc_res_t<10>(samp, n, q, shift, res); break;
    case 11: lpc_res_t<11>(samp, n, q, shift, res); break;
    case 12: lpc_res_t<12>(samp, n, q, shift, res); break;
    default: lpc_res_generic(samp, n, order, q, shift, res); break;
    }
}

// int32 residual variants: halve the residual buffer traffic and let
// the zigzag pass below vectorize.  The int64 intermediate plus an
// accumulated wrap check keeps them exact for ANY decision array —
// a residual that does not fit int32 (possible only with extreme
// coefficient/shift combinations, or >26-bit streams) reports
// overflow and the caller recomputes through the int64 path.
template <int ORDER>
static bool lpc_res32_t(const int32_t* samp, int64_t n,
                        const int32_t* q, int shift, int32_t* res) {
    int64_t ov = 0;
    for (int64_t i = ORDER; i < n; i++) {
        int64_t pred = 0;
        for (int j = 0; j < ORDER; j++)
            pred += (int64_t)q[j] * samp[i - 1 - j];
        const int64_t r = samp[i] - (pred >> shift);
        res[i] = (int32_t)r;
        ov |= (r - (int32_t)r);
    }
    return ov != 0;
}

static bool lpc_res32_generic(const int32_t* samp, int64_t n,
                              int order, const int32_t* q, int shift,
                              int32_t* res) {
    int64_t ov = 0;
    for (int64_t i = order; i < n; i++) {
        int64_t pred = 0;
        for (int j = 0; j < order; j++)
            pred += (int64_t)q[j] * samp[i - 1 - j];
        const int64_t r = samp[i] - (pred >> shift);
        res[i] = (int32_t)r;
        ov |= (r - (int32_t)r);
    }
    return ov != 0;
}

#ifdef ATPU_AVX512
// 8-wide int64 lanes, two accumulator chains over 16 samples/step;
// _mm512_mul_epi32 sign-extends the low 32 bits of each lane (which
// cvtepi32_epi64 fills), so products and the <= 32-term sum are exact
// int64 — identical results to the scalar path, ~2x faster measured
template <int ORDER>
static bool lpc_res32_avx(const int32_t* samp, int64_t n,
                          const int32_t* q, int shift, int32_t* res) {
    __m512i qv[ORDER];
    for (int j = 0; j < ORDER; j++) qv[j] = _mm512_set1_epi64(q[j]);
    const __m128i sh = _mm_cvtsi64_si128(shift);
    __m512i ovacc = _mm512_setzero_si512();
    int64_t i = ORDER;
    for (; i + 16 <= n; i += 16) {
        __m512i p0 = _mm512_setzero_si512();
        __m512i p1 = _mm512_setzero_si512();
        for (int j = 0; j < ORDER; j++) {
            p0 = _mm512_add_epi64(p0, _mm512_mul_epi32(
                _mm512_cvtepi32_epi64(_mm256_loadu_si256(
                    (const __m256i*)(samp + i - 1 - j))), qv[j]));
            p1 = _mm512_add_epi64(p1, _mm512_mul_epi32(
                _mm512_cvtepi32_epi64(_mm256_loadu_si256(
                    (const __m256i*)(samp + i + 7 - j))), qv[j]));
        }
        const __m512i r0 = _mm512_sub_epi64(
            _mm512_cvtepi32_epi64(_mm256_loadu_si256(
                (const __m256i*)(samp + i))),
            _mm512_sra_epi64(p0, sh));
        const __m512i r1 = _mm512_sub_epi64(
            _mm512_cvtepi32_epi64(_mm256_loadu_si256(
                (const __m256i*)(samp + i + 8))),
            _mm512_sra_epi64(p1, sh));
        const __m256i a = _mm512_cvtepi64_epi32(r0);
        const __m256i b = _mm512_cvtepi64_epi32(r1);
        ovacc = _mm512_or_si512(ovacc, _mm512_xor_si512(
            r0, _mm512_cvtepi32_epi64(a)));
        ovacc = _mm512_or_si512(ovacc, _mm512_xor_si512(
            r1, _mm512_cvtepi32_epi64(b)));
        _mm256_storeu_si256((__m256i*)(res + i), a);
        _mm256_storeu_si256((__m256i*)(res + i + 8), b);
    }
    alignas(64) int64_t tmp[8];
    _mm512_store_si512((__m512i*)tmp, ovacc);
    int64_t ov = 0;
    for (int j = 0; j < 8; j++) ov |= tmp[j];
    for (; i < n; i++) {
        int64_t pred = 0;
        for (int j = 0; j < ORDER; j++)
            pred += (int64_t)q[j] * samp[i - 1 - j];
        const int64_t r = samp[i] - (pred >> shift);
        res[i] = (int32_t)r;
        ov |= (r - (int32_t)r);
    }
    return ov != 0;
}
#endif  // ATPU_AVX512

static bool lpc_residuals32_dispatch(const int32_t* samp, int64_t n,
                                     int order, const int32_t* q,
                                     int shift, int32_t* res) {
#ifdef ATPU_AVX512
    if (n >= 32) {
        switch (order) {
        case 1: return lpc_res32_avx<1>(samp, n, q, shift, res);
        case 2: return lpc_res32_avx<2>(samp, n, q, shift, res);
        case 3: return lpc_res32_avx<3>(samp, n, q, shift, res);
        case 4: return lpc_res32_avx<4>(samp, n, q, shift, res);
        case 5: return lpc_res32_avx<5>(samp, n, q, shift, res);
        case 6: return lpc_res32_avx<6>(samp, n, q, shift, res);
        case 7: return lpc_res32_avx<7>(samp, n, q, shift, res);
        case 8: return lpc_res32_avx<8>(samp, n, q, shift, res);
        case 9: return lpc_res32_avx<9>(samp, n, q, shift, res);
        case 10: return lpc_res32_avx<10>(samp, n, q, shift, res);
        case 11: return lpc_res32_avx<11>(samp, n, q, shift, res);
        case 12: return lpc_res32_avx<12>(samp, n, q, shift, res);
        default: break;
        }
    }
#endif
    switch (order) {
    case 1: return lpc_res32_t<1>(samp, n, q, shift, res);
    case 2: return lpc_res32_t<2>(samp, n, q, shift, res);
    case 3: return lpc_res32_t<3>(samp, n, q, shift, res);
    case 4: return lpc_res32_t<4>(samp, n, q, shift, res);
    case 5: return lpc_res32_t<5>(samp, n, q, shift, res);
    case 6: return lpc_res32_t<6>(samp, n, q, shift, res);
    case 7: return lpc_res32_t<7>(samp, n, q, shift, res);
    case 8: return lpc_res32_t<8>(samp, n, q, shift, res);
    case 9: return lpc_res32_t<9>(samp, n, q, shift, res);
    case 10: return lpc_res32_t<10>(samp, n, q, shift, res);
    case 11: return lpc_res32_t<11>(samp, n, q, shift, res);
    case 12: return lpc_res32_t<12>(samp, n, q, shift, res);
    default:
        return lpc_res32_generic(samp, n, order, q, shift, res);
    }
}

// fixed-predictor residuals, int32 (coefficient rows of Pascal's
// triangle with alternating signs — reference py_encoders/flac.py
// diff orders 0-4)
static void fixed_res32(const int32_t* samp, int64_t n, int order,
                        int32_t* res) {
    switch (order) {
    case 0:
        for (int64_t i = 0; i < n; i++) res[i] = samp[i];
        break;
    case 1:
        for (int64_t i = 1; i < n; i++)
            res[i] = samp[i] - samp[i - 1];
        break;
    case 2:
        for (int64_t i = 2; i < n; i++)
            res[i] = samp[i] - 2 * samp[i - 1] + samp[i - 2];
        break;
    case 3:
        for (int64_t i = 3; i < n; i++)
            res[i] = samp[i] - 3 * samp[i - 1] + 3 * samp[i - 2] -
                     samp[i - 3];
        break;
    default:
        for (int64_t i = 4; i < n; i++)
            res[i] = samp[i] - 4 * samp[i - 1] + 6 * samp[i - 2] -
                     4 * samp[i - 3] + samp[i - 4];
        break;
    }
}

// zigzag int32 residuals to uint32 Rice magnitudes, unit-stride
// (autovectorizes; keeps the serial pack loop to pure shift/or work)
static inline void zigzag32(const int32_t* res, int64_t start,
                            int64_t end, uint32_t* u) {
    for (int64_t i = start; i < end; i++)
        u[i] = ((uint32_t)res[i] << 1) ^ (uint32_t)(res[i] >> 31);
}

inline void put_utf8(BitWriter& w, uint64_t value) {
    if (value <= 127) {
        w.put(value, 8);
        return;
    }
    int total_bytes;
    if (value <= 2047) total_bytes = 2;
    else if (value <= 65535) total_bytes = 3;
    else if (value <= 2097151) total_bytes = 4;
    else if (value <= 67108863) total_bytes = 5;
    else total_bytes = 6;

    int shift = (total_bytes - 1) * 6;
    w.put(((1ULL << total_bytes) - 1) << 1, total_bytes + 1);
    w.put(value >> shift, 7 - total_bytes);
    shift -= 6;
    while (shift >= 0) {
        w.put(2, 2);
        w.put((value >> shift) & 0x3F, 6);
        shift -= 6;
    }
}

}  // namespace

extern "C" {


// Emits complete FLAC frames from raw PCM blocks + packed decisions.
//
// The round-2 fast path: the device ships ONE packed int32 decision
// array per batch ([n_frames, 1 + max_subframes*W] with W =
// 6 + max_order + max_partitions; per-subframe columns
// [choice, wasted, order, porder, shift, sub_bits, qlp*K, rice*P]) and
// the emitter derives everything else — variant samples (L/R/mid/side
// from the interleaved input blocks), wasted-bit shifts, and exact
// int64 residuals — so the host Python layer does no per-sample work.
// env-gated (ATPU_EMIT_PROF) cycle accounting for the emit hot path;
// zero overhead when off (checked once per process)
static inline uint64_t emit_rdtsc() {
    unsigned lo, hi;
    __asm__ __volatile__("rdtsc" : "=a"(lo), "=d"(hi));
    return ((uint64_t)hi << 32) | lo;
}
static bool emit_prof_on() {
    static const bool on = (getenv("ATPU_EMIT_PROF") != nullptr);
    return on;
}
enum { EP_DECODE, EP_HEADER, EP_VARIANT, EP_RESID, EP_ZZ, EP_PACK,
       EP_CRC, EP_N };
static uint64_t emit_prof_cyc[EP_N];
extern "C" void atpu_emit_prof_dump() {
    static const char* names[EP_N] = {"decode", "header", "variant",
                                      "resid", "zigzag", "pack",
                                      "crc"};
    for (int i = 0; i < EP_N; i++) {
        fprintf(stderr, "[emit_prof] %-8s %8.2f Mcyc\n", names[i],
                emit_prof_cyc[i] / 1e6);
        emit_prof_cyc[i] = 0;
    }
}
#define EP_T(slot, stmt) do { \
    if (emit_prof_on()) { \
        const uint64_t t0_ = emit_rdtsc(); \
        stmt; \
        emit_prof_cyc[slot] += emit_rdtsc() - t0_; \
    } else { stmt; } } while (0)

}  // extern "C" — paused for the C++ template below

static inline int bit_length_u64(uint64_t v) {
    return v ? (64 - __builtin_clzll(v)) : 0;
}

// emit-stage EXACT Rice entropy re-search (pure-int64 spec; scalar
// mirror: ref/flac_enc.emit_rice_search).  Re-picks the final
// (porder, params) of one FIXED/LPC subframe from the EXACT residual
// zigzag tokens the emitter just derived, over every (porder,
// partition, parameter) triple: cost = count*(1+r) + sum(u >> r),
// 4 header bits per partition plus one extra bit each when any
// chosen parameter escapes past 14 (coding method 1).  First
// minimum wins on both axes (strict <, ascending porder/r).  The
// analysis stage may have searched on quantized-upload samples
// (ops/qpack.py) — this stage restores exact-entropy output for
// free, since the residuals are already in hand for serialization.
// zz[0..order) MUST be zero (warmup positions).
template <typename T>
static void emit_rice_research(const T* zz, int n, int order,
                               int max_porder, int max_pred,
                               int max_rice,
                               int* porder_out, int32_t* params_out) {
    // contiguous valid porder list (ref/flac_analysis
    // .valid_partition_orders): stop at the first non-dividing
    // porder or where the first partition would go non-positive
    int pmax = 0;
    for (int po = 0; po <= max_porder; po++) {
        if (n % (1 << po)) break;
        if (po > 0 && (n >> po) <= max_pred) break;
        pmax = po;
    }
    const int R = max_rice + 1;
    const int parts_f = 1 << pmax;
    const int psize_f = n >> pmax;
    // WINDOWED exact search (spec shared with the oracle mirror
    // ref/flac_enc.emit_rice_search): a first pass takes each finest
    // partition's total S0 = sum(u) and its abs-sum threshold
    // parameter rt (smallest r with count * 2^r >= S0, the classic
    // Rice estimate); the exhaustive (partition, parameter) scan
    // then restricts r to the subframe-global window
    // [min_p(rt_p) - 3, max_p(rt_p) + 3] — the exact optimum sits
    // within +-1 of rt in all but adversarial cases, and coarser
    // partition unions' thresholds stay between their children's.
    // First-minimum semantics WITHIN the window on both axes.  This
    // cuts the finest-level sum(u >> r) passes (the research's wall)
    // roughly in half on typical material.
    int rt_min = R, rt_max = 0;
    {
        for (int p = 0; p < parts_f; p++) {
            const T* seg = zz + (size_t)p * psize_f;
            int64_t s0 = 0;
            for (int i = 0; i < psize_f; i++)
                s0 += (int64_t)seg[i];
            const int64_t count = psize_f - (p == 0 ? order : 0);
            int rt = 0;
            for (int r = 0; r < max_rice; r++)
                if ((count << r) < s0) rt++;
            if (rt < rt_min) rt_min = rt;
            if (rt > rt_max) rt_max = rt;
        }
    }
    const int rlo = rt_min > 3 ? rt_min - 3 : 0;
    const int rhi0 = rt_max + 3;
    const int rhi = rhi0 < max_rice ? rhi0 : max_rice;
    // exact per-level sums S[l][p][r] = sum(u >> r) over partition p
    // at level l (2^l partitions), stored flat at ((1<<l)-1 + p)*R;
    // finest level computed directly, coarser levels by pair-sum
    static thread_local std::vector<int64_t> sums;
    const size_t need = ((size_t)(parts_f << 1) - 1) * R;
    if (sums.size() < need) sums.resize(need);
    for (int p = 0; p < parts_f; p++) {
        int64_t* S = &sums[(size_t)(parts_f - 1 + p) * R];
        const T* seg = zz + (size_t)p * psize_f;
        uint64_t mx = 0;
        for (int i = 0; i < psize_f; i++) mx |= (uint64_t)seg[i];
        const int maxbit = mx ? 64 - __builtin_clzll(mx) : 0;
        const int rlim = maxbit < (rhi + 1) ? maxbit : (rhi + 1);
        for (int r = rlo; r < rlim; r++) {
            int64_t acc = 0;
            for (int i = 0; i < psize_f; i++)
                acc += (int64_t)(seg[i] >> r);
            S[r] = acc;
        }
        for (int r = rlim; r <= rhi; r++) S[r] = 0;
    }
    for (int l = pmax - 1; l >= 0; l--) {
        const int off = (1 << l) - 1;
        const int offc = (1 << (l + 1)) - 1;
        for (int p = 0; p < (1 << l); p++) {
            int64_t* D = &sums[(size_t)(off + p) * R];
            const int64_t* A = &sums[(size_t)(offc + 2 * p) * R];
            const int64_t* B = A + R;
            for (int r = rlo; r <= rhi; r++) D[r] = A[r] + B[r];
        }
    }
    static thread_local std::vector<int32_t> rtmp;
    if ((int)rtmp.size() < parts_f) rtmp.resize(parts_f);
    int64_t best_total = INT64_MAX;
    int best_porder = 0;
    for (int po = 0; po <= pmax; po++) {
        const int parts = 1 << po;
        const int psz = n >> po;
        const int off = parts - 1;
        int64_t total = 0;
        int maxr = 0;
        for (int p = 0; p < parts; p++) {
            const int64_t* S = &sums[(size_t)(off + p) * R];
            const int64_t count = psz - (p == 0 ? order : 0);
            int64_t bc = INT64_MAX;
            int br = rlo;
            for (int r = rlo; r <= rhi; r++) {
                const int64_t c = S[r] + count * (int64_t)(1 + r);
                if (c < bc) { bc = c; br = r; }
            }
            rtmp[p] = br;
            if (br > maxr) maxr = br;
            total += 4 + bc;
        }
        if (maxr > 14) total += parts;
        if (total < best_total) {
            best_total = total;
            best_porder = po;
            for (int p = 0; p < parts; p++) params_out[p] = rtmp[p];
        }
    }
    *porder_out = best_porder;
}

extern "C" {

// shared implementation; rb_words/rb_bits (nullable) carry
// device-packed residual partition blocks (ops/pallas_bitpack.py):
// when present, FIXED/LPC subframes splice the pre-packed bits
// ([method(2) porder(4)] header + params + Rice codes, MSB-first in
// big-endian u32 word rows of rb_stride) instead of re-deriving and
// serializing residuals on host
static int64_t flac_emit_frames_impl(
                               const int32_t* blocks,    // [F,max_block,ch]
                               const int64_t* frame_numbers,
                               const int32_t* block_sizes,
                               const int32_t* packed,
                               int64_t n_frames,
                               int32_t max_subframes,
                               int32_t max_order,
                               int32_t max_partitions,
                               int32_t max_block,
                               int32_t sample_rate,
                               int32_t stream_bps,
                               int32_t stream_channels,
                               int32_t qlp_precision,
                               int32_t compact,
                               int32_t emit_max_rice,
                               const int32_t* probe_thr,  // nullable
                               uint8_t* probe_out,        // nullable
                               uint8_t* out,
                               int64_t* out_lens,
                               int64_t out_capacity,
                               const uint32_t* rb_words,
                               const int64_t* rb_bits,
                               int64_t rb_stride) {
    const int W = 6 + max_order + max_partitions;
    const int row_width = 1 + max_subframes * W;
    // compact wire layout (ops/flac_frames.compact_decisions): one
    // packed scalar word + int16 qlp pairs + u8 rice quads per
    // subframe; decoded below into the standard row layout
    const int CW = 1 + (max_order + 1) / 2 + (max_partitions + 3) / 4;
    const int crow_width = 1 + max_subframes * CW;
    static thread_local int32_t* row_buf = nullptr;
    static thread_local int64_t row_cap = 0;
    if (compact && row_width > row_cap) {
        delete[] row_buf;
        row_buf = new int32_t[row_width];
        row_cap = row_width;
    }

    static thread_local int32_t* samp_buf = nullptr;
    static thread_local int64_t* res_buf = nullptr;
    static thread_local int32_t* res32_buf = nullptr;
    static thread_local uint32_t* zz_buf = nullptr;
    static thread_local int64_t buf_size = 0;
    if (max_block > buf_size) {
        delete[] samp_buf;
        delete[] res_buf;
        delete[] res32_buf;
        delete[] zz_buf;
        samp_buf = new int32_t[max_block * 2];
        res_buf = new int64_t[max_block * 2];
        res32_buf = new int32_t[max_block];
        zz_buf = new uint32_t[max_block];
        buf_size = max_block;
    }
    // fast path gate: FIXED residuals fit int32 when subframe
    // samples (incl. the +1-bit side channel) stay <= 26 bits
    // (order-4 diffs bound |res| <= 16 * 2^26 < 2^31); LPC residuals
    // additionally carry a runtime wrap check that falls back to the
    // int64 path on the (pathological-decision-array) overflow case
    const bool res32_ok = (stream_bps + 1 + 5) <= 31;

    // emit-stage re-search bounds (emit_max_rice >= 0): the porder
    // ceiling implied by the decision layout's partition capacity
    // and the same predictor bound the analysis porder list used
    int emit_max_porder = 0;
    while ((1 << (emit_max_porder + 1)) <= max_partitions)
        emit_max_porder++;
    const int emit_pred_bound = max_order > 4 ? max_order : 4;

    const bool prof = emit_prof_on();
    uint64_t tp = prof ? emit_rdtsc() : 0;
    auto mark = [&](int slot) {
        if (prof) {
            const uint64_t now = emit_rdtsc();
            emit_prof_cyc[slot] += now - tp;
            tp = now;
        }
    };

    for (int64_t f = 0; f < n_frames; f++) {
        const int64_t frame_start = (f == 0) ? 0 : out_lens[f - 1];
        BitWriter w(out, frame_start, out_capacity);
        mark(EP_CRC);
        const int block_size = block_sizes[f];
        const int32_t* prow;
        if (compact) {
            const int32_t* crow = packed + f * crow_width;
            row_buf[0] = crow[0];
            for (int s = 0; s < max_subframes; s++) {
                const int32_t* csub = crow + 1 + s * CW;
                int32_t* dsub = row_buf + 1 + s * W;
                const uint32_t w0 = (uint32_t)csub[0];
                dsub[0] = (int32_t)(w0 & 0xF);
                dsub[1] = (int32_t)((w0 >> 4) & 0x3F);
                dsub[2] = (int32_t)((w0 >> 10) & 0x3F);
                dsub[3] = (int32_t)((w0 >> 16) & 0xF);
                dsub[4] = (int32_t)((w0 >> 20) & 0x1F);
                dsub[5] = 0;
                const int32_t* qw = csub + 1;
                for (int j = 0; j < max_order; j++)
                    dsub[6 + j] = (int16_t)(
                        ((uint32_t)qw[j >> 1] >> ((j & 1) * 16)) &
                        0xFFFF);
                const int32_t* rw = csub + 1 + (max_order + 1) / 2;
                for (int p = 0; p < max_partitions; p++)
                    dsub[6 + max_order + p] = (int32_t)(
                        ((uint32_t)rw[p >> 2] >> ((p & 3) * 8)) &
                        0xFF);
            }
            prow = row_buf;
        } else {
            prow = packed + f * row_width;
        }
        mark(EP_DECODE);
        const int assignment = prow[0];
        const int32_t* frame_pcm =
            blocks + f * (int64_t)max_block * stream_channels;

        // ---- frame header ----
        w.put(0x3FFE, 14);
        w.put(0, 1);
        w.put(0, 1);

        int bs_code;
        switch (block_size) {
        case 192: bs_code = 1; break;
        case 256: bs_code = 8; break;
        case 512: bs_code = 9; break;
        case 576: bs_code = 2; break;
        case 1024: bs_code = 10; break;
        case 1152: bs_code = 3; break;
        case 2048: bs_code = 11; break;
        case 2304: bs_code = 4; break;
        case 4096: bs_code = 12; break;
        case 4608: bs_code = 5; break;
        case 8192: bs_code = 13; break;
        case 16384: bs_code = 14; break;
        case 32768: bs_code = 15; break;
        default:
            bs_code = (block_size <= 256) ? 6 :
                      (block_size <= 65536) ? 7 : 0;
        }
        w.put(bs_code, 4);

        int sr_code;
        switch (sample_rate) {
        case 8000: sr_code = 4; break;
        case 16000: sr_code = 5; break;
        case 22050: sr_code = 6; break;
        case 24000: sr_code = 7; break;
        case 32000: sr_code = 8; break;
        case 44100: sr_code = 9; break;
        case 48000: sr_code = 10; break;
        case 88200: sr_code = 1; break;
        case 96000: sr_code = 11; break;
        case 176400: sr_code = 2; break;
        case 192000: sr_code = 3; break;
        default:
            if ((sample_rate % 1000 == 0) && sample_rate <= 255000)
                sr_code = 12;
            else if ((sample_rate % 10 == 0) && sample_rate <= 655350)
                sr_code = 14;
            else if (sample_rate <= 65535)
                sr_code = 13;
            else
                sr_code = 0;
        }
        w.put(sr_code, 4);
        w.put(assignment, 4);

        int bps_code;
        switch (stream_bps) {
        case 8: bps_code = 1; break;
        case 12: bps_code = 2; break;
        case 16: bps_code = 4; break;
        case 20: bps_code = 5; break;
        case 24: bps_code = 6; break;
        default: bps_code = 0;
        }
        w.put(bps_code, 3);
        w.put(0, 1);

        put_utf8(w, (uint64_t)frame_numbers[f]);

        if (bs_code == 6) w.put(block_size - 1, 8);
        else if (bs_code == 7) w.put(block_size - 1, 16);

        if (sr_code == 12) w.put(sample_rate % 1000, 8);
        else if (sr_code == 13) w.put(sample_rate, 16);
        else if (sr_code == 14) w.put(sample_rate % 10, 16);

        w.flush_bytes();              // drain lazy accumulator
        if (w.bits != 0) return -20;  // header must be byte-aligned
        int64_t pos = w.pos;
        out[pos] = crc8_buf(out + frame_start, pos - frame_start, 0);
        pos += 1;
        mark(EP_HEADER);

        // ---- subframes ----
        int n_subframes;
        if (assignment <= 7) n_subframes = assignment + 1;
        else n_subframes = 2;

        // stereo assignments derive both subframes' variant samples
        // in ONE pass over the interleaved PCM (the switch hoists out
        // of the loop, and the L/R loads are shared instead of read
        // twice); independent channels (assignment <= 7, up to 8
        // subframes) derive per-subframe below into slot 0
        if (assignment > 7) {
            const int w0 = prow[1 + 1];
            const int w1 = prow[1 + W + 1];
            int32_t* d0 = samp_buf;
            int32_t* d1 = samp_buf + max_block;
            int i = 0;
#ifdef ATPU_AVX512
            // deinterleave 16 stereo pairs per step with two
            // cross-register permutes, then the variant math runs
            // 16-wide (the scalar loop below keeps the tail + the
            // non-AVX build)
            {
                alignas(64) static const int32_t EVEN[16] = {
                    0, 2, 4, 6, 8, 10, 12, 14,
                    16, 18, 20, 22, 24, 26, 28, 30};
                alignas(64) static const int32_t ODD[16] = {
                    1, 3, 5, 7, 9, 11, 13, 15,
                    17, 19, 21, 23, 25, 27, 29, 31};
                const __m512i evp =
                    _mm512_load_si512((const __m512i*)EVEN);
                const __m512i odp =
                    _mm512_load_si512((const __m512i*)ODD);
                const __m128i sh0 = _mm_cvtsi64_si128(w0);
                const __m128i sh1 = _mm_cvtsi64_si128(w1);
                for (; i + 16 <= block_size; i += 16) {
                    const __m512i a = _mm512_loadu_si512(
                        (const __m512i*)(frame_pcm + (int64_t)i * 2));
                    const __m512i b = _mm512_loadu_si512(
                        (const __m512i*)(frame_pcm +
                                         (int64_t)i * 2 + 16));
                    const __m512i L = _mm512_permutex2var_epi32(
                        a, evp, b);
                    const __m512i R = _mm512_permutex2var_epi32(
                        a, odp, b);
                    const __m512i S = _mm512_sub_epi32(L, R);
                    __m512i v0, v1;
                    if (assignment == 8) {
                        v0 = _mm512_sra_epi32(L, sh0);
                        v1 = _mm512_sra_epi32(S, sh1);
                    } else if (assignment == 9) {
                        v0 = _mm512_sra_epi32(S, sh0);
                        v1 = _mm512_sra_epi32(R, sh1);
                    } else {
                        v0 = _mm512_sra_epi32(
                            _mm512_srai_epi32(
                                _mm512_add_epi32(L, R), 1), sh0);
                        v1 = _mm512_sra_epi32(S, sh1);
                    }
                    _mm512_storeu_si512((__m512i*)(d0 + i), v0);
                    _mm512_storeu_si512((__m512i*)(d1 + i), v1);
                }
            }
#endif
            switch (assignment) {
            case 8:                               // L / side
                for (; i < block_size; i++) {
                    const int32_t L = frame_pcm[(int64_t)i * 2];
                    const int32_t R = frame_pcm[(int64_t)i * 2 + 1];
                    d0[i] = L >> w0;
                    d1[i] = (L - R) >> w1;
                }
                break;
            case 9:                               // side / R
                for (; i < block_size; i++) {
                    const int32_t L = frame_pcm[(int64_t)i * 2];
                    const int32_t R = frame_pcm[(int64_t)i * 2 + 1];
                    d0[i] = (L - R) >> w0;
                    d1[i] = R >> w1;
                }
                break;
            default:                              // mid / side
                for (; i < block_size; i++) {
                    const int32_t L = frame_pcm[(int64_t)i * 2];
                    const int32_t R = frame_pcm[(int64_t)i * 2 + 1];
                    d0[i] = ((L + R) >> 1) >> w0;
                    d1[i] = (L - R) >> w1;
                }
                break;
            }
        }
        mark(EP_VARIANT);

        BitWriter w2(out, pos, out_capacity);
        for (int s = 0; s < n_subframes; s++) {
            const int32_t* sub = prow + 1 + s * W;
            const int choice = sub[0];
            const int wasted = sub[1];
            const int order = sub[2];
            const int porder = sub[3];
            const int shift = sub[4];
            const int32_t* qlp = sub + 6;
            const int32_t* params = sub + 6 + max_order;
            const int32_t* samp;
            if (assignment <= 7) {
                for (int i = 0; i < block_size; i++)
                    samp_buf[i] =
                        frame_pcm[(int64_t)i * stream_channels + s]
                        >> sub[1];
                samp = samp_buf;
            } else {
                samp = samp_buf + (int64_t)s * max_block;
            }
            mark(EP_VARIANT);

            int sub_bps = stream_bps;
            if ((assignment == 8 && s == 1) ||
                (assignment == 9 && s == 0) ||
                (assignment == 10 && s == 1))
                sub_bps += 1;
            const int ebps = sub_bps - wasted;

            if (choice == 0) {                    // CONSTANT
                w2.put(0, 1); w2.put(0, 6); w2.put(0, 1);
                put_signed(w2, samp[0], sub_bps);
                continue;
            } else if (choice == 1) {             // VERBATIM
                w2.put(0, 1); w2.put(1, 6);
                put_wasted(w2, wasted);
                for (int i = 0; i < block_size; i++)
                    put_signed(w2, samp[i], ebps);
                continue;
            }

            bool use32 = res32_ok;
            const bool splice = (rb_words != nullptr);
            if (choice == 2) {                    // FIXED
                w2.put(0, 1); w2.put(1, 3); w2.put(order, 3);
                put_wasted(w2, wasted);
                for (int i = 0; i < order; i++)
                    put_signed(w2, samp[i], ebps);
                if (splice) {
                    // residual block arrives pre-packed from device
                } else if (use32) {
                    fixed_res32(samp, block_size, order, res32_buf);
                } else {
                    static const int64_t FC[5][4] = {
                        {0, 0, 0, 0},
                        {1, 0, 0, 0},
                        {2, -1, 0, 0},
                        {3, -3, 1, 0},
                        {4, -6, 4, -1}};
                    for (int i = order; i < block_size; i++) {
                        int64_t pred = 0;
                        for (int j = 0; j < order; j++)
                            pred += FC[order][j] * samp[i - 1 - j];
                        res_buf[i] = samp[i] - pred;
                    }
                }
            } else {                              // LPC
                w2.put(0, 1); w2.put(1, 1); w2.put(order - 1, 5);
                put_wasted(w2, wasted);
                for (int i = 0; i < order; i++)
                    put_signed(w2, samp[i], ebps);
                w2.put(qlp_precision - 1, 4);
                put_signed(w2, shift, 5);
                for (int i = 0; i < order; i++)
                    put_signed(w2, qlp[i], qlp_precision);
                if (splice) {
                    // residual block arrives pre-packed from device
                } else if (use32 &&
                    lpc_residuals32_dispatch(samp, block_size, order,
                                             qlp, shift, res32_buf))
                    use32 = false;                // int32 wrapped
                if (!splice && !use32)
                    lpc_residuals_dispatch(samp, block_size, order,
                                           qlp, shift, res_buf);
            }

            // quantization-floor stage-2 probe (spec:
            // ref/flac_analysis.analyze_frame stage 2, fast mirror
            // codecs/flac_enc_fast._floor_limited): the exact
            // residuals just derived ARE the exact samples run
            // through the quantized-fit predictor, so the probe is
            // one abs-sum here instead of a separate host predictor
            // pass.  probe_thr[f] = t_base - 2 for frames passing
            // the host-side stage-1 rice-band check, else -1.
            if (!splice && probe_thr != nullptr &&
                probe_thr[f] >= 0 && !probe_out[f]) {
                uint64_t acc = 0;
                if (use32) {
                    for (int i = order; i < block_size; i++) {
                        const int32_t r = res32_buf[i];
                        acc += (uint32_t)(r < 0 ? -r : r);
                    }
                } else {
                    for (int i = order; i < block_size; i++) {
                        const int64_t r = res_buf[i];
                        acc += (uint64_t)(r < 0 ? -r : r);
                    }
                }
                // divisor guarded as the scalar spec does
                // (ref/flac_analysis: divide by max(n - o, 1)) —
                // flac_emit_frames2 is a general entry point and a
                // decision row with order == block_size must not trap
                const int64_t nres = block_size - order;
                const uint64_t m = acc / (uint64_t)(nres > 0 ? nres
                                                             : 1);
                if (bit_length_u64(m) <= probe_thr[f])
                    probe_out[f] = 1;
            }

            if (splice) {
                // bit-copy the device-packed residual block: full
                // 32-bit source words stream through put(), the tail
                // word contributes its TOP bits (device layout is
                // MSB-first within each big-endian word)
                const int64_t row = f * max_subframes + s;
                const uint32_t* src = rb_words + row * rb_stride;
                const int64_t nbits = rb_bits[row];
                if (nbits <= 0 || nbits > rb_stride * 32)
                    return -33;   // caller must pre-validate capacity
                const int64_t full_words = nbits >> 5;
                for (int64_t i = 0; i < full_words; i++)
                    w2.put(src[i], 32);
                const int rem = (int)(nbits & 31);
                if (rem)
                    w2.put(src[full_words] >> (32 - rem), rem);
                mark(EP_PACK);
                continue;
            }

            mark(EP_RESID);
            // residual block
            int porder_u = porder;
            const int32_t* params_u = params;
            if (use32) {
                // unit-stride zigzag pass (vectorizes); derived
                // before the residual header so the emit-stage
                // re-search below can run on the exact tokens the
                // pack loop will serialize
                zigzag32(res32_buf, order, block_size, zz_buf);
                mark(EP_ZZ);
            }
            if (emit_max_rice >= 0) {
                // emit-stage exact entropy re-search (see
                // emit_rice_research): override the analysis-stage
                // (porder, params) with the exact-residual optimum
                static thread_local std::vector<int32_t> rs_params;
                if ((int64_t)rs_params.size() < max_block)
                    rs_params.resize(max_block);
                int rp = porder_u;
                if (use32) {
                    for (int i = 0; i < order; i++) zz_buf[i] = 0;
                    emit_rice_research<uint32_t>(
                        zz_buf, block_size, order, emit_max_porder,
                        emit_pred_bound, emit_max_rice, &rp,
                        rs_params.data());
                } else {
                    static thread_local std::vector<uint64_t> zz64;
                    if ((int64_t)zz64.size() < max_block)
                        zz64.resize(max_block);
                    for (int i = 0; i < order; i++) zz64[i] = 0;
                    for (int i = order; i < block_size; i++) {
                        const int64_t r = res_buf[i];
                        zz64[i] = (uint64_t)((r << 1) ^ (r >> 63));
                    }
                    emit_rice_research<uint64_t>(
                        zz64.data(), block_size, order,
                        emit_max_porder, emit_pred_bound,
                        emit_max_rice, &rp, rs_params.data());
                }
                porder_u = rp;
                params_u = rs_params.data();
            }
            const int n_partitions = 1 << porder_u;
            int coding_method = 0;
            for (int p = 0; p < n_partitions; p++)
                if (params_u[p] > 14) coding_method = 1;
            w2.put(coding_method, 2);
            w2.put(porder_u, 4);

            const int psize = block_size >> porder_u;
            if (use32) {
                // pure shift/or pack loop over u32 tokens; tokens
                // combine in PAIRS when their joint width fits 64
                // bits (the common case at param <= 14), halving the
                // length of the serial accumulator dependency chain
                for (int p = 0; p < n_partitions; p++) {
                    const int param = params_u[p];
                    w2.put(param, coding_method ? 5 : 4);
                    const int start = (p == 0) ? order : p * psize;
                    const int end = (p + 1) * psize;
                    const uint32_t lsb_mask =
                        (uint32_t)((1ULL << param) - 1);
                    const uint64_t stop = 1ULL << param;
                    int i = start;
                    // branchless fast path: every token pair does ONE
                    // unconditional top-aligned 8-byte drain, so the
                    // flush cadence carries no data-dependent branch
                    // (the old lazy-flush loop mispredicted on every
                    // accumulator fill, ~4x the pack cost).  Worst
                    // case bytes: <= 8 per token + the 8-byte store
                    // overhang; fall back to the guarded loop when
                    // the partition might not fit.
                    const int64_t worst =
                        (int64_t)(end - start) * 8 + 16;
                    if (!w2.overflow && w2.pos + worst <= w2.limit) {
                        w2.flush_bytes();       // leaves bits < 8
                        uint64_t acc = w2.acc;
                        int bits = w2.bits;
                        int64_t pos = w2.pos;
                        bool bailed = false;
                        for (; i + 2 <= end; i += 2) {
                            const uint32_t u1 = zz_buf[i];
                            const uint32_t u2 = zz_buf[i + 1];
                            const int l1 = (int)(u1 >> param) + 1 +
                                           param;
                            const int l2 = (int)(u2 >> param) + 1 +
                                           param;
                            const int L = l1 + l2;
                            if (__builtin_expect(L <= 56, 1)) {
                                acc = (acc << L) |
                                      (((stop | (u1 & lsb_mask))
                                        << l2) |
                                       (stop | (u2 & lsb_mask)));
                                bits += L;
                            } else {
                                // rare long-unary pair: restore the
                                // writer and take the guarded path
                                w2.acc = acc;
                                w2.bits = bits;
                                w2.pos = pos;
                                w2.put(stop | (u1 & lsb_mask), l1);
                                w2.put(stop | (u2 & lsb_mask), l2);
                                w2.flush_bytes();
                                if (w2.overflow) {
                                    // put() maintains w2 itself from
                                    // here; locals are stale
                                    bailed = true;
                                    break;
                                }
                                acc = w2.acc;
                                bits = w2.bits;
                                pos = w2.pos;
                                continue;
                            }
                            // unconditional drain of full bytes
                            // (bits is 2..63 here; scratch bytes past
                            // the new pos get rewritten next drain)
                            uint64_t v = __builtin_bswap64(
                                acc << ((64 - bits) & 63));
                            __builtin_memcpy(out + pos, &v, 8);
                            pos += bits >> 3;
                            bits &= 7;
                            acc &= (bits ? ((1ULL << bits) - 1) : 0);
                        }
                        if (!bailed) {
                            w2.acc = acc;
                            w2.bits = bits;
                            w2.pos = pos;
                        }
                    } else {
                        for (; i + 2 <= end; i += 2) {
                            const uint32_t u1 = zz_buf[i];
                            const uint32_t u2 = zz_buf[i + 1];
                            const int64_t l1 =
                                (int64_t)(u1 >> param) + 1 + param;
                            const int64_t l2 =
                                (int64_t)(u2 >> param) + 1 + param;
                            if (__builtin_expect(l1 + l2 <= 64, 1)) {
                                w2.put(((stop | (u1 & lsb_mask))
                                        << l2) |
                                           (stop | (u2 & lsb_mask)),
                                       l1 + l2);
                            } else {
                                w2.put(stop | (u1 & lsb_mask), l1);
                                w2.put(stop | (u2 & lsb_mask), l2);
                            }
                        }
                    }
                    for (; i < end; i++) {
                        const uint32_t u = zz_buf[i];
                        w2.put(stop | (u & lsb_mask),
                               (int64_t)(u >> param) + 1 + param);
                    }
                }
                mark(EP_PACK);
            } else {
                for (int p = 0; p < n_partitions; p++) {
                    const int param = params_u[p];
                    w2.put(param, coding_method ? 5 : 4);
                    const int start = (p == 0) ? order : p * psize;
                    const int end = (p + 1) * psize;
                    const uint64_t lsb_mask = (1ULL << param) - 1;
                    const uint64_t stop = 1ULL << param;
                    for (int i = start; i < end; i++) {
                        const int64_t r = res_buf[i];
                        // branchless zigzag: 2r / -2r-1
                        const uint64_t u =
                            (uint64_t)((r << 1) ^ (r >> 63));
                        const uint64_t msb = u >> param;
                        w2.put(stop | (u & lsb_mask),
                               (int64_t)msb + 1 + param);
                    }
                }
            }
        }

        w2.byte_align();
        if (w.overflow || w2.overflow || w2.pos + 2 > out_capacity)
            return -31;         // decision array overran the buffer
        pos = w2.pos;
        const uint16_t crc = crc16_buf(out + frame_start,
                                       pos - frame_start, 0);
        out[pos++] = (uint8_t)(crc >> 8);
        out[pos++] = (uint8_t)(crc & 0xFF);
        out_lens[f] = pos;      // cumulative end offsets
    }
    return (n_frames > 0) ? out_lens[n_frames - 1] : 0;
}

int64_t atpu_flac_emit_frames2(const int32_t* blocks,
                               const int64_t* frame_numbers,
                               const int32_t* block_sizes,
                               const int32_t* packed,
                               int64_t n_frames,
                               int32_t max_subframes,
                               int32_t max_order,
                               int32_t max_partitions,
                               int32_t max_block,
                               int32_t sample_rate,
                               int32_t stream_bps,
                               int32_t stream_channels,
                               int32_t qlp_precision,
                               int32_t compact,
                               int32_t emit_max_rice,
                               const int32_t* probe_thr,
                               uint8_t* probe_out,
                               uint8_t* out,
                               int64_t* out_lens,
                               int64_t out_capacity) {
    return flac_emit_frames_impl(
        blocks, frame_numbers, block_sizes, packed, n_frames,
        max_subframes, max_order, max_partitions, max_block,
        sample_rate, stream_bps, stream_channels, qlp_precision,
        compact, emit_max_rice, probe_thr, probe_out, out, out_lens,
        out_capacity, nullptr, nullptr, 0);
}

// splice variant: residual partition blocks pre-packed on device
// (ops/pallas_bitpack.py); rb_words [n_frames*max_subframes,
// rb_stride] big-endian u32 rows, rb_bits exact bit lengths
int64_t atpu_flac_emit_frames2rb(const int32_t* blocks,
                                 const int64_t* frame_numbers,
                                 const int32_t* block_sizes,
                                 const int32_t* packed,
                                 int64_t n_frames,
                                 int32_t max_subframes,
                                 int32_t max_order,
                                 int32_t max_partitions,
                                 int32_t max_block,
                                 int32_t sample_rate,
                                 int32_t stream_bps,
                                 int32_t stream_channels,
                                 int32_t qlp_precision,
                                 int32_t compact,
                                 uint8_t* out,
                                 int64_t* out_lens,
                                 int64_t out_capacity,
                                 const uint32_t* rb_words,
                                 const int64_t* rb_bits,
                                 int64_t rb_stride) {
    // splice mode serializes device-packed residual bits verbatim,
    // so neither the emit-stage re-search (-1) nor the floor probe
    // (nullptr; it needs host-derived residuals) applies here
    return flac_emit_frames_impl(
        blocks, frame_numbers, block_sizes, packed, n_frames,
        max_subframes, max_order, max_partitions, max_block,
        sample_rate, stream_bps, stream_channels, qlp_precision,
        compact, -1, nullptr, nullptr, out, out_lens, out_capacity,
        rb_words, rb_bits, rb_stride);
}

uint16_t atpu_crc16(const uint8_t* data, int64_t n, uint16_t initial) {
    return crc16_buf(data, n, initial);
}

// Ogg page CRC-32: polynomial 0x04C11DB7, MSB-first, init 0, no
// final xor (RFC 3533); the table is built once, on first use, by
// whichever thread comes first
static const uint32_t* ogg_crc_table() {
    static const struct Table {
        uint32_t v[256];
        Table() {
            for (uint32_t b = 0; b < 256; b++) {
                uint32_t c = b << 24;
                for (int i = 0; i < 8; i++)
                    c = (c & 0x80000000u) ? ((c << 1) ^ 0x04C11DB7u)
                                          : (c << 1);
                v[b] = c;
            }
        }
    } table;
    return table.v;
}

uint32_t atpu_ogg_crc(const uint8_t* data, int64_t n, uint32_t initial) {
    const uint32_t* table = ogg_crc_table();
    uint32_t crc = initial;
    for (int64_t i = 0; i < n; i++)
        crc = (crc << 8) ^ table[((crc >> 24) ^ data[i]) & 0xFF];
    return crc;
}

// ------------------------------------------------------------- MD5 ----
// Standard MD5 (RFC 1321 algorithm, re-implemented) with a fused
// "update from int32 PCM samples" entry point so stream hashes never
// materialize intermediate byte buffers on the (slow) host.

namespace {

struct MD5State {
    uint32_t a, b, c, d;
    uint64_t total_len;
    uint8_t pending[64];
    uint32_t pending_len;
};

static inline uint32_t rotl32(uint32_t x, int c) {
    return (x << c) | (x >> (32 - c));
}

static const uint32_t MD5_K[64] = {
    0xd76aa478, 0xe8c7b756, 0x242070db, 0xc1bdceee,
    0xf57c0faf, 0x4787c62a, 0xa8304613, 0xfd469501,
    0x698098d8, 0x8b44f7af, 0xffff5bb1, 0x895cd7be,
    0x6b901122, 0xfd987193, 0xa679438e, 0x49b40821,
    0xf61e2562, 0xc040b340, 0x265e5a51, 0xe9b6c7aa,
    0xd62f105d, 0x02441453, 0xd8a1e681, 0xe7d3fbc8,
    0x21e1cde6, 0xc33707d6, 0xf4d50d87, 0x455a14ed,
    0xa9e3e905, 0xfcefa3f8, 0x676f02d9, 0x8d2a4c8a,
    0xfffa3942, 0x8771f681, 0x6d9d6122, 0xfde5380c,
    0xa4beea44, 0x4bdecfa9, 0xf6bb4b60, 0xbebfbc70,
    0x289b7ec6, 0xeaa127fa, 0xd4ef3085, 0x04881d05,
    0xd9d4d039, 0xe6db99e5, 0x1fa27cf8, 0xc4ac5665,
    0xf4292244, 0x432aff97, 0xab9423a7, 0xfc93a039,
    0x655b59c3, 0x8f0ccc92, 0xffeff47d, 0x85845dd1,
    0x6fa87e4f, 0xfe2ce6e0, 0xa3014314, 0x4e0811a1,
    0xf7537e82, 0xbd3af235, 0x2ad7d2bb, 0xeb86d391};

static const int MD5_S[64] = {
    7, 12, 17, 22, 7, 12, 17, 22, 7, 12, 17, 22, 7, 12, 17, 22,
    5, 9, 14, 20, 5, 9, 14, 20, 5, 9, 14, 20, 5, 9, 14, 20,
    4, 11, 16, 23, 4, 11, 16, 23, 4, 11, 16, 23, 4, 11, 16, 23,
    6, 10, 15, 21, 6, 10, 15, 21, 6, 10, 15, 21, 6, 10, 15, 21};

static void md5_block(MD5State* st, const uint8_t* p) {
    uint32_t m[16];
    __builtin_memcpy(m, p, 64);   // little-endian host assumed
    uint32_t a = st->a, b = st->b, c = st->c, d = st->d;
    // four explicitly-split rounds let the compiler unroll fully;
    // rounds 1-2 use the xor-select forms (one op fewer on the
    // critical dependency chain than the (x&y)|(~x&z) originals)
    for (int i = 0; i < 16; i++) {
        const uint32_t f = d ^ (b & (c ^ d));
        const uint32_t tmp = d; d = c; c = b;
        b = b + rotl32(a + f + MD5_K[i] + m[i], MD5_S[i]);
        a = tmp;
    }
    for (int i = 16; i < 32; i++) {
        const uint32_t f = c ^ (d & (b ^ c));
        const uint32_t tmp = d; d = c; c = b;
        b = b + rotl32(a + f + MD5_K[i] + m[(5 * i + 1) % 16],
                       MD5_S[i]);
        a = tmp;
    }
    for (int i = 32; i < 48; i++) {
        const uint32_t f = b ^ c ^ d;
        const uint32_t tmp = d; d = c; c = b;
        b = b + rotl32(a + f + MD5_K[i] + m[(3 * i + 5) % 16],
                       MD5_S[i]);
        a = tmp;
    }
    for (int i = 48; i < 64; i++) {
        const uint32_t f = c ^ (b | ~d);
        const uint32_t tmp = d; d = c; c = b;
        b = b + rotl32(a + f + MD5_K[i] + m[(7 * i) % 16], MD5_S[i]);
        a = tmp;
    }
    st->a += a; st->b += b; st->c += c; st->d += d;
}

static void md5_update(MD5State* st, const uint8_t* data, int64_t n) {
    st->total_len += n;
    if (st->pending_len) {
        while (n > 0 && st->pending_len < 64) {
            st->pending[st->pending_len++] = *data++;
            n--;
        }
        if (st->pending_len == 64) {
            md5_block(st, st->pending);
            st->pending_len = 0;
        }
    }
    while (n >= 64) {
        md5_block(st, data);
        data += 64;
        n -= 64;
    }
    while (n > 0) {
        st->pending[st->pending_len++] = *data++;
        n--;
    }
}

}  // namespace

void atpu_md5_init(uint8_t* state) {
    MD5State* st = (MD5State*)state;
    st->a = 0x67452301; st->b = 0xefcdab89;
    st->c = 0x98badcfe; st->d = 0x10325476;
    st->total_len = 0;
    st->pending_len = 0;
}

void atpu_md5_update(uint8_t* state, const uint8_t* data, int64_t n) {
    md5_update((MD5State*)state, data, n);
}

// fused: pack int32 samples to little-endian signed PCM and hash them
void atpu_md5_update_pcm(uint8_t* state,
                         const int32_t* samples,
                         int64_t n,
                         int32_t bytes_per_sample,
                         int32_t is_signed) {
    MD5State* st = (MD5State*)state;
    const int32_t offset = is_signed ? 0
        : (1 << (bytes_per_sample * 8 - 1));
    uint8_t buf[65536];
    int64_t i = 0;
    const int64_t per = 65536 / bytes_per_sample;
    while (i < n) {
        int64_t chunk = per;
        if (chunk > (n - i)) chunk = n - i;
        if (bytes_per_sample == 2 && is_signed) {
            int16_t* out16 = (int16_t*)buf;   // LE host
            for (int64_t j = 0; j < chunk; j++)
                out16[j] = (int16_t)samples[i + j];
        } else {
            uint8_t* out = buf;
            for (int64_t j = 0; j < chunk; j++) {
                const uint32_t v = (uint32_t)(samples[i + j] + offset);
                for (int b = 0; b < bytes_per_sample; b++)
                    *out++ = (uint8_t)(v >> (8 * b));
            }
        }
        md5_update(st, buf, chunk * bytes_per_sample);
        i += chunk;
    }
}

void atpu_md5_final(uint8_t* state, uint8_t* digest) {
    MD5State st = *(MD5State*)state;   // work on a copy
    const uint64_t bit_len = st.total_len * 8;
    const uint8_t one = 0x80;
    md5_update(&st, &one, 1);
    const uint8_t zero = 0x00;
    while (st.pending_len != 56)
        md5_update(&st, &zero, 1);
    uint8_t len_bytes[8];
    for (int i = 0; i < 8; i++)
        len_bytes[i] = (uint8_t)(bit_len >> (8 * i));
    md5_update(&st, len_bytes, 8);
    uint32_t out[4] = {st.a, st.b, st.c, st.d};
    for (int i = 0; i < 4; i++)
        for (int b = 0; b < 4; b++)
            digest[i * 4 + b] = (uint8_t)(out[i] >> (8 * b));
}

// ------------------------------------------------------- PCM packing --
// Converts int32 samples to packed 8/16/24-bit bytes and back — the
// data-plane hot path of FrameList.to_bytes()/from-bytes (reference
// src/pcm.c pack/unpack loops).

void atpu_pack_pcm(const int32_t* samples,
                   int64_t n,
                   int32_t bytes_per_sample,
                   int32_t big_endian,
                   int32_t is_signed,
                   uint8_t* out) {
    const int32_t offset = is_signed ? 0
        : (1 << (bytes_per_sample * 8 - 1));
    if (bytes_per_sample == 2 && !big_endian && is_signed) {
        // common case: memcpy-able on little-endian hosts
        int16_t* out16 = (int16_t*)out;
        for (int64_t i = 0; i < n; i++)
            out16[i] = (int16_t)samples[i];
        return;
    }
    for (int64_t i = 0; i < n; i++) {
        uint32_t v = (uint32_t)(samples[i] + offset);
        if (big_endian) {
            for (int b = bytes_per_sample - 1; b >= 0; b--)
                *out++ = (uint8_t)(v >> (8 * b));
        } else {
            for (int b = 0; b < bytes_per_sample; b++)
                *out++ = (uint8_t)(v >> (8 * b));
        }
    }
}

void atpu_unpack_pcm(const uint8_t* data,
                     int64_t n,
                     int32_t bytes_per_sample,
                     int32_t big_endian,
                     int32_t is_signed,
                     int32_t* out) {
    const int bits = bytes_per_sample * 8;
    const int32_t offset = is_signed ? 0 : (1 << (bits - 1));
    const uint32_t sign_bit = 1u << (bits - 1);
    const uint32_t sign_extend = ~((1u << bits) - 1);
    for (int64_t i = 0; i < n; i++) {
        uint32_t v = 0;
        if (big_endian) {
            for (int b = 0; b < bytes_per_sample; b++)
                v = (v << 8) | *data++;
        } else {
            for (int b = 0; b < bytes_per_sample; b++)
                v |= ((uint32_t)(*data++)) << (8 * b);
        }
        if (is_signed && (v & sign_bit))
            v |= sign_extend;
        out[i] = (int32_t)v - offset;
    }
}

uint8_t atpu_crc8(const uint8_t* data, int64_t n, uint8_t initial) {
    return crc8_buf(data, n, initial);
}

// ---------------------------------------------------- polyphase FIR --
// ---------------------------------------------- quantized upload --
// The FLAC/ALAC quantized upload wire (spec: ops/qpack.py plan_t,
// variant_sideband, pack, pack_patched): the plan scan with the
// exact sideband and the MD5 fold, and the two bit packs.

// the per-channel quantization shift t (spec: ops/qpack.plan_t).
// Noise-adaptive coarsening (noise_extra > 0): blocks whose mean
// |second difference| is >= 1.6x the mean |first difference| are
// noise-dominated (white noise gives sqrt(3) ~= 1.73, tonal content
// <= ~1.0 — differencing amplifies noise but cancels smooth
// structure), so t gains noise_extra bits and the cap releases by 2;
// the emit-stage exact entropy re-search keeps coded size unaffected
// there while the wire width typically halves
static inline int qplan_t_for(const int32_t* xb, int64_t n,
                              int32_t bps, int32_t guard,
                              int32_t cap_margin,
                              int32_t noise_extra) {
    if (n <= 2) return 0;
    uint64_t sum1 = 0, sum2 = 0;
    for (int64_t i = 2; i < n; i++) {
        const int32_t d1 = xb[i] - xb[i - 1];
        const int32_t d2 = d1 - (xb[i - 1] - xb[i - 2]);
        sum1 += (uint32_t)(d1 < 0 ? -d1 : d1);
        sum2 += (uint32_t)(d2 < 0 ? -d2 : d2);
    }
    const int32_t d0 = xb[1] - xb[0];
    sum1 += (uint32_t)(d0 < 0 ? -d0 : d0);
    const uint64_t m = sum2 / (uint64_t)(n - 2);
    int extra = 0;
    int margin = cap_margin;
    // pre-shift (spec: ops/qpack.plan_t): sum2 < 2^(bps+18), so the
    // 5/8 cross-multiply would wrap uint64 above bps 29 at n = 65535;
    // shifting both sums by max(0, bps-26) keeps 5*(sum2>>s)*(n-1)
    // provably < 2^63 for every admitted bps (s == 0 for bps <= 26,
    // i.e. all real 16/24-bit content incl. side channels)
    const int pshift = bps > 26 ? bps - 26 : 0;
    if (noise_extra > 0 && m > 0 &&
        5 * (sum2 >> pshift) * (uint64_t)(n - 1) >=
            8 * (sum1 >> pshift) * (uint64_t)(n - 2)) {
        extra = noise_extra;
        margin = cap_margin > 2 ? cap_margin - 2 : 0;
    }
    const int cap = (bps > margin) ? (bps - margin) : 0;
    int t = bit_length_u64(m) - 1 - guard + extra;
    if (t < 0) t = 0;
    if (t > cap) t = cap;
    return t;
}

int32_t atpu_flac_qplan(const int32_t* blocks,   // [B, n, ch]
                        int64_t B, int64_t n, int64_t ch,
                        int32_t bps, int32_t guard,
                        int32_t cap_margin,      // t <= bps - margin
                        int32_t noise_extra,
                        int32_t stereo_trial,
                        int32_t* t_out,          // [B, ch]
                        int32_t* x0_out,         // [B, ch]
                        int32_t* or_out,         // [B, V]
                        uint8_t* const_out,      // [B, V]
                        uint8_t* md5_state) {    // optional (may be null)
    // md5_state: when non-null, the stream MD5 (packed little-endian
    // signed PCM at bps) is folded into this scan while each block is
    // cache-hot, replacing a separate full pass over the batch
    const int64_t V = (stereo_trial && ch == 2) ? 4 : ch;
    uint64_t max_u = 0;

    // per-channel deinterleave buffer: unit-stride scans vectorize
    // where the strided originals ran scalar; one block-channel is
    // L1/L2-resident (<= 128 KB at n = 4096, ch <= 8)
    static thread_local int32_t* chan_buf = nullptr;
    static thread_local int64_t chan_cap = 0;
    if (n * ch > chan_cap) {
        delete[] chan_buf;
        chan_buf = new int32_t[n * ch];
        chan_cap = n * ch;
    }

    for (int64_t b = 0; b < B; b++) {
        const int32_t* blk = blocks + b * n * ch;

#ifdef ATPU_AVX512
        // stereo fast path: ONE pass over the interleaved PCM does
        // the deinterleave (cross-register permutes) AND the L/R/M/S
        // OR-ne sideband — the loads are shared, and the reductions
        // run 16-wide
        if (stereo_trial && ch == 2 && n >= 32) {
            alignas(64) static const int32_t EVEN[16] = {
                0, 2, 4, 6, 8, 10, 12, 14,
                16, 18, 20, 22, 24, 26, 28, 30};
            alignas(64) static const int32_t ODD[16] = {
                1, 3, 5, 7, 9, 11, 13, 15,
                17, 19, 21, 23, 25, 27, 29, 31};
            const __m512i evp =
                _mm512_load_si512((const __m512i*)EVEN);
            const __m512i odp =
                _mm512_load_si512((const __m512i*)ODD);
            const int32_t L0s = blk[0];
            const int32_t R0s = blk[1];
            const __m512i L0v = _mm512_set1_epi32(L0s);
            const __m512i R0v = _mm512_set1_epi32(R0s);
            const __m512i M0v = _mm512_set1_epi32((L0s + R0s) >> 1);
            const __m512i S0v = _mm512_set1_epi32(L0s - R0s);
            __m512i orL = _mm512_setzero_si512();
            __m512i orR = orL, orM = orL, orS = orL;
            __m512i neL = orL, neR = orL, neM = orL, neS = orL;
            int32_t* dstL = chan_buf;
            int32_t* dstR = chan_buf + n;
            int64_t i = 0;
            for (; i + 16 <= n; i += 16) {
                const __m512i a = _mm512_loadu_si512(
                    (const __m512i*)(blk + i * 2));
                const __m512i bb = _mm512_loadu_si512(
                    (const __m512i*)(blk + i * 2 + 16));
                const __m512i L = _mm512_permutex2var_epi32(
                    a, evp, bb);
                const __m512i R = _mm512_permutex2var_epi32(
                    a, odp, bb);
                const __m512i M = _mm512_srai_epi32(
                    _mm512_add_epi32(L, R), 1);
                const __m512i S = _mm512_sub_epi32(L, R);
                _mm512_storeu_si512((__m512i*)(dstL + i), L);
                _mm512_storeu_si512((__m512i*)(dstR + i), R);
                orL = _mm512_or_si512(orL, L);
                orR = _mm512_or_si512(orR, R);
                orM = _mm512_or_si512(orM, M);
                orS = _mm512_or_si512(orS, S);
                neL = _mm512_or_si512(neL, _mm512_xor_si512(L, L0v));
                neR = _mm512_or_si512(neR, _mm512_xor_si512(R, R0v));
                neM = _mm512_or_si512(neM, _mm512_xor_si512(M, M0v));
                neS = _mm512_or_si512(neS, _mm512_xor_si512(S, S0v));
            }
            int32_t oL = (int32_t)_mm512_reduce_or_epi32(orL);
            int32_t oR = (int32_t)_mm512_reduce_or_epi32(orR);
            int32_t oM = (int32_t)_mm512_reduce_or_epi32(orM);
            int32_t oS = (int32_t)_mm512_reduce_or_epi32(orS);
            int32_t nL = (int32_t)_mm512_reduce_or_epi32(neL);
            int32_t nR = (int32_t)_mm512_reduce_or_epi32(neR);
            int32_t nM = (int32_t)_mm512_reduce_or_epi32(neM);
            int32_t nS = (int32_t)_mm512_reduce_or_epi32(neS);
            for (; i < n; i++) {
                const int32_t L = blk[i * 2];
                const int32_t R = blk[i * 2 + 1];
                const int32_t M = (L + R) >> 1;
                const int32_t S = L - R;
                dstL[i] = L; dstR[i] = R;
                oL |= L; oR |= R; oM |= M; oS |= S;
                nL |= (L ^ L0s); nR |= (R ^ R0s);
                nM |= (M ^ ((L0s + R0s) >> 1));
                nS |= (S ^ (L0s - R0s));
            }
            or_out[b * V + 0] = oL; or_out[b * V + 1] = oR;
            or_out[b * V + 2] = oM; or_out[b * V + 3] = oS;
            const_out[b * V + 0] = (nL == 0);
            const_out[b * V + 1] = (nR == 0);
            const_out[b * V + 2] = (nM == 0);
            const_out[b * V + 3] = (nS == 0);

            if (md5_state != nullptr)
                atpu_md5_update_pcm(md5_state, blk, n * 2, bps / 8, 1);

            for (int64_t c = 0; c < 2; c++) {
                const int32_t* xb = chan_buf + c * n;
                x0_out[b * 2 + c] = xb[0];
                const int t = qplan_t_for(xb, n, bps, guard,
                                          cap_margin, noise_extra);
                t_out[b * 2 + c] = t;
                uint32_t wid = 0;
                int32_t prev = xb[0] >> t;
                for (int64_t j = 1; j < n; j++) {
                    const int32_t xq = xb[j] >> t;
                    const int32_t d = xq - prev;
                    prev = xq;
                    wid |= ((uint32_t)d << 1) ^ (uint32_t)(d >> 31);
                }
                if ((uint64_t)wid > max_u) max_u = wid;
            }
            continue;
        }
#endif
        // deinterleave once (the only strided pass)
        for (int64_t c = 0; c < ch; c++) {
            int32_t* dst = chan_buf + c * n;
            for (int64_t i = 0; i < n; i++)
                dst[i] = blk[i * ch + c];
        }

        // exactness sideband over the exact samples (unit-stride);
        // the mid/side OR-ne pass shares the L/R loads
        if (stereo_trial && ch == 2) {
            const int32_t* Lb = chan_buf;
            const int32_t* Rb = chan_buf + n;
            const int32_t L0 = Lb[0];
            const int32_t R0 = Rb[0];
            const int32_t m0 = (L0 + R0) >> 1;
            const int32_t s0 = L0 - R0;
            int32_t orL = 0, orR = 0, orM = 0, orS = 0;
            int32_t neL = 0, neR = 0, neM = 0, neS = 0;
            for (int64_t i = 0; i < n; i++) {
                const int32_t L = Lb[i];
                const int32_t R = Rb[i];
                const int32_t M = (L + R) >> 1;
                const int32_t S = L - R;
                orL |= L; orR |= R; orM |= M; orS |= S;
                neL |= (L ^ L0); neR |= (R ^ R0);
                neM |= (M ^ m0); neS |= (S ^ s0);
            }
            or_out[b * V + 0] = orL; or_out[b * V + 1] = orR;
            or_out[b * V + 2] = orM; or_out[b * V + 3] = orS;
            const_out[b * V + 0] = (neL == 0);
            const_out[b * V + 1] = (neR == 0);
            const_out[b * V + 2] = (neM == 0);
            const_out[b * V + 3] = (neS == 0);
        } else {
            for (int64_t c = 0; c < ch; c++) {
                const int32_t* xb = chan_buf + c * n;
                int32_t orv = 0, ne = 0;
                const int32_t f0 = xb[0];
                for (int64_t i = 0; i < n; i++) {
                    orv |= xb[i];
                    ne |= (xb[i] ^ f0);
                }
                or_out[b * V + c] = orv;
                const_out[b * V + c] = (ne == 0);
            }
        }

        if (md5_state != nullptr)
            atpu_md5_update_pcm(md5_state, blk, n * ch, bps / 8, 1);

        // t from the first/second-difference scan (qplan_t_for);
        // then the diff width pass
        for (int64_t c = 0; c < ch; c++) {
            const int32_t* xb = chan_buf + c * n;
            x0_out[b * ch + c] = xb[0];
            const int t = qplan_t_for(xb, n, bps, guard,
                                      cap_margin, noise_extra);
            t_out[b * ch + c] = t;

            // max zigzag width of quantized first differences:
            // max |u| == 2 * max(d, -d - 1); track the OR of both
            // shifted diffs and read the width off one bit_length
            uint32_t wid = 0;
            int32_t prev = xb[0] >> t;
            for (int64_t i = 1; i < n; i++) {
                const int32_t xq = xb[i] >> t;
                const int32_t d = xq - prev;
                prev = xq;
                const uint32_t u =
                    ((uint32_t)d << 1) ^ (uint32_t)(d >> 31);
                wid |= u;
            }
            if ((uint64_t)wid > max_u) max_u = wid;
        }
    }
    const int k = bit_length_u64(max_u);
    return k > 0 ? k : 1;
}

// Bit-packs zigzag first-differences of the quantized samples at
// width k into little-endian uint32 lanes ([B, ch, W] with
// W = ceil((n-1)*k/32) + 1, caller-zeroed) — same words as
// ops/qpack.py pack().
// packs one scratch row of k-bit tokens into little-endian uint32
// lanes.  For the word-aligned grid widths (32 % k == 0: k = 4/8/16,
// the common cases) this is an exact per-word OR chain with no
// carried accumulator state — fully unrolled, no data-dependent
// branches; other widths use a 64-bit accumulator drain.
static void pack_row(const uint32_t* zz, int64_t m, int32_t k,
                     uint32_t* out) {
    if (k > 0 && 32 % k == 0) {
        const int G = 32 / k;              // values per word
        const int64_t full = m / G;
        for (int64_t w = 0; w < full; w++) {
            const uint32_t* v = zz + w * (int64_t)G;
            uint32_t word = 0;
            for (int g = 0; g < G; g++)
                word |= v[g] << (g * k);
            out[w] = word;
        }
        uint32_t word = 0;
        for (int64_t i = full * G; i < m; i++)
            word |= zz[i] << ((i - full * G) * k);
        if (m > full * G)
            out[full] = word;
    } else {
        uint64_t acc = 0;
        int accbits = 0;
        for (int64_t i = 0; i < m; i++) {
            acc |= (uint64_t)zz[i] << accbits;
            accbits += k;
            if (accbits >= 32) {
                *out++ = (uint32_t)acc;
                acc >>= 32;
                accbits -= 32;
            }
        }
        if (accbits > 0)
            *out = (uint32_t)acc;
    }
}

// fills zz_all[c*n .. c*n + (n-1)) with the zigzag first differences
// of channel c quantized at t_row[c] (shared by both pack entries)
static void qpack_zigzag_block(const int32_t* blk, int64_t n,
                               int64_t ch, const int32_t* t_row,
                               uint32_t* zz_all) {
    {
#ifdef ATPU_AVX512
        if (ch == 2) {
            // both channels' quantized zigzag diffs in ONE pass over
            // the interleaved PCM: two cross-register permutes
            // deinterleave 16 pairs/step (the emitter's pattern), so
            // the strided loads that kept the scalar loop serial
            // become wide unit-stride ones
            alignas(64) static const int32_t EVEN[16] = {
                0, 2, 4, 6, 8, 10, 12, 14,
                16, 18, 20, 22, 24, 26, 28, 30};
            alignas(64) static const int32_t ODD[16] = {
                1, 3, 5, 7, 9, 11, 13, 15,
                17, 19, 21, 23, 25, 27, 29, 31};
            const __m512i evp = _mm512_load_si512((const __m512i*)EVEN);
            const __m512i odp = _mm512_load_si512((const __m512i*)ODD);
            const __m128i sh0 = _mm_cvtsi64_si128(t_row[0]);
            const __m128i sh1 = _mm_cvtsi64_si128(t_row[1]);
            const int tt0 = t_row[0], tt1 = t_row[1];
            uint32_t* z0 = zz_all;
            uint32_t* z1 = zz_all + n;
            int32_t p0 = blk[0] >> tt0;
            int32_t p1 = blk[1] >> tt1;
            int64_t i = 1;
            for (; i + 16 <= n; i += 16) {
                const __m512i a = _mm512_loadu_si512(
                    (const __m512i*)(blk + i * 2));
                const __m512i bb = _mm512_loadu_si512(
                    (const __m512i*)(blk + i * 2 + 16));
                const __m512i q0 = _mm512_sra_epi32(
                    _mm512_permutex2var_epi32(a, evp, bb), sh0);
                const __m512i q1 = _mm512_sra_epi32(
                    _mm512_permutex2var_epi32(a, odp, bb), sh1);
                // previous-quantized vector: lane j-1 of q, lane -1
                // from the carried scalar
                const __m512i pr0 = _mm512_alignr_epi32(
                    q0, _mm512_set1_epi32(p0), 15);
                const __m512i pr1 = _mm512_alignr_epi32(
                    q1, _mm512_set1_epi32(p1), 15);
                const __m512i d0 = _mm512_sub_epi32(q0, pr0);
                const __m512i d1 = _mm512_sub_epi32(q1, pr1);
                const __m512i u0 = _mm512_xor_si512(
                    _mm512_slli_epi32(d0, 1), _mm512_srai_epi32(d0, 31));
                const __m512i u1 = _mm512_xor_si512(
                    _mm512_slli_epi32(d1, 1), _mm512_srai_epi32(d1, 31));
                _mm512_storeu_si512((__m512i*)(z0 + i - 1), u0);
                _mm512_storeu_si512((__m512i*)(z1 + i - 1), u1);
                p0 = (int32_t)_mm_cvtsi128_si32(
                    _mm512_castsi512_si128(_mm512_alignr_epi32(
                        q0, q0, 15)));
                p1 = (int32_t)_mm_cvtsi128_si32(
                    _mm512_castsi512_si128(_mm512_alignr_epi32(
                        q1, q1, 15)));
            }
            for (; i < n; i++) {
                const int32_t xq0 = blk[i * 2] >> tt0;
                const int32_t xq1 = blk[i * 2 + 1] >> tt1;
                const int32_t d0 = xq0 - p0, d1 = xq1 - p1;
                p0 = xq0; p1 = xq1;
                z0[i - 1] = ((uint32_t)d0 << 1) ^ (uint32_t)(d0 >> 31);
                z1[i - 1] = ((uint32_t)d1 << 1) ^ (uint32_t)(d1 >> 31);
            }
            return;
        }
#endif
        for (int64_t c = 0; c < ch; c++) {
            const int tt = t_row[c];
            const int32_t* src = blk + c;
            uint32_t* zz = zz_all + c * n;
            int32_t prev = src[0] >> tt;
            for (int64_t i = 1; i < n; i++) {
                const int32_t xq = src[i * ch] >> tt;
                const int32_t d = xq - prev;   // fits int32: k <= 31
                prev = xq;
                zz[i - 1] = ((uint32_t)d << 1) ^ (uint32_t)(d >> 31);
            }
        }
    }
}

static thread_local uint32_t* qpack_zz_all = nullptr;
static thread_local int64_t qpack_zz_cap = 0;

static inline uint32_t* qpack_zz_scratch(int64_t need) {
    if (need > qpack_zz_cap) {
        delete[] qpack_zz_all;
        qpack_zz_all = new uint32_t[need];
        qpack_zz_cap = need;
    }
    return qpack_zz_all;
}

void atpu_flac_qpack_bits(const int32_t* blocks,   // [B, n, ch]
                          int64_t B, int64_t n, int64_t ch,
                          const int32_t* t, int32_t k,
                          uint32_t* packed, int64_t W) {
    // two passes per (block, channel): a quantize + zigzag-first-
    // difference pass into a scratch row (AVX deinterleave for
    // stereo; shift/sub/xor auto-vectorizes elsewhere), then the
    // pack_row bit pack above.
    uint32_t* zz_all = qpack_zz_scratch(n * ch);
    for (int64_t b = 0; b < B; b++) {
        const int32_t* blk = blocks + b * n * ch;
        qpack_zigzag_block(blk, n, ch, t + b * ch, zz_all);
        for (int64_t c = 0; c < ch; c++)
            pack_row(zz_all + c * n, n - 1, k,
                     packed + (b * ch + c) * W);
    }
}

// Patched-base wire: packs every diff at the NARROW width k_base and
// records the rare values needing more bits as (position, full
// value) exceptions — the device unpack scatters them back before
// the cumsum, so reconstruction stays exact while the wire drops
// from k_full to ~k_base bits/sample (content-measured: the zigzag
// diff distribution's mean bit length sits 2-3 bits under its max).
// Exceptions beyond E per (block, channel) are counted but not
// recorded; the caller MUST treat max_count > E as an invalid pack
// and retry with a larger E or the plain format.  Unused exception
// slots pad with (pos 0, the true value at pos 0) — scattering a
// duplicate of an exact value is a no-op.
int32_t atpu_flac_qpack_bits2(const int32_t* blocks,  // [B, n, ch]
                              int64_t B, int64_t n, int64_t ch,
                              const int32_t* t, int32_t k_base,
                              uint32_t* packed, int64_t W,
                              int32_t E,
                              int32_t* exc_pos,       // [B, ch, E]
                              uint32_t* exc_val) {    // [B, ch, E]
    uint32_t* zz_all = qpack_zz_scratch(n * ch);
    const uint32_t mask = (k_base >= 32)
        ? 0xFFFFFFFFu : ((1u << k_base) - 1u);
    int32_t max_count = 0;
    for (int64_t b = 0; b < B; b++) {
        const int32_t* blk = blocks + b * n * ch;
        qpack_zigzag_block(blk, n, ch, t + b * ch, zz_all);
        for (int64_t c = 0; c < ch; c++) {
            uint32_t* zz = zz_all + c * n;
            const int64_t m = n - 1;
            int32_t* pos = exc_pos + (b * ch + c) * E;
            uint32_t* val = exc_val + (b * ch + c) * E;
            const uint32_t u0 = m > 0 ? zz[0] : 0;
            int32_t cnt = 0;
            for (int64_t i = 0; i < m; i++) {
                const uint32_t u = zz[i];
                if (u >> k_base) {
                    if (cnt < E) {
                        pos[cnt] = (int32_t)i;
                        val[cnt] = u;
                    }
                    cnt++;
                    zz[i] = u & mask;
                }
            }
            for (int32_t e = cnt < E ? cnt : E; e < E; e++) {
                pos[e] = 0;
                val[e] = u0;   // true u at pos 0 (saved pre-mask)
            }
            if (cnt > max_count) max_count = cnt;
            pack_row(zz, m, k_base, packed + (b * ch + c) * W);
        }
    }
    return max_count;
}

}  // extern "C"

// ------------------------------------------------------------ decoding --

namespace {

// Sliding-window bit reader for the FLAC frame decoder (reference
// counterpart: src/decoders/flac.c bit readers).  Keeps a byte-swapped
// 64-bit window of the stream and a consumed-bit count, so every
// refill is one unaligned load + bswap and every read is two shifts —
// no byte-at-a-time accumulator feeding.  After refill() at least
// 57 bits are readable (when the stream has them); reads of up to
// 57 bits are handled inline.
struct FlacBR {
    const uint8_t* data;
    int64_t len;
    int64_t byteoff;   // window start byte
    uint64_t window;   // big-endian view of data[byteoff..byteoff+8)
    int used;          // bits consumed from the window top, 0..64
    bool error;

    FlacBR(const uint8_t* d, int64_t n)
        : data(d), len(n), byteoff(0), window(0), used(0),
          error(false) { load(); }

    inline void load() {
        if (__builtin_expect(byteoff + 8 <= len, 1)) {
            uint64_t w;
            memcpy(&w, data + byteoff, 8);
            window = __builtin_bswap64(w);
        } else {
            uint64_t w = 0;   // zero-pad past EOF; avail() guards use
            for (int i = 0; i < 8; i++)
                w = (w << 8) |
                    (uint64_t)(byteoff + i < len ? data[byteoff + i] : 0);
            window = w;
        }
    }
    inline void refill() {
        byteoff += used >> 3;
        used &= 7;
        load();
    }
    inline int64_t avail() const {
        return (len - byteoff) * 8 - used;
    }

    inline uint64_t get(int n) {        // 0 <= n <= 57
        if (n == 0) return 0;
        refill();
        if (__builtin_expect(avail() < n, 0)) { error = true; return 0; }
        const uint64_t v = (window << used) >> (64 - n);
        used += n;
        return v;
    }
    inline int64_t get_signed(int n) {
        if (n == 0) return 0;
        const uint64_t v = get(n);
        return (int64_t)(v << (64 - n)) >> (64 - n);
    }
    inline int64_t unary() {
        int64_t count = 0;
        for (;;) {
            refill();
            const int64_t av = avail();
            if (av <= 0) { error = true; return 0; }
            const uint64_t w = window << used;
            if (w == 0) {               // rest of window is zeros
                const int zeros = 64 - used;
                // no 1-bit within the remaining real bits: truncated
                if (zeros >= av) { error = true; return 0; }
                count += zeros;
                used = 64;
                continue;
            }
            const int lz = __builtin_clzll(w);
            if (lz >= av) { error = true; return 0; }
            count += lz;
            used += lz + 1;
            return count;
        }
    }
    inline void byte_align() {
        used = (used + 7) & ~7;
    }
    inline int64_t byte_pos() const {
        return byteoff + ((used + 7) >> 3);
    }
    inline int64_t bit_pos() const {
        return byteoff * 8 + used;
    }
    inline void skip_bits(int64_t nbits) {
        // consume without extracting (device-decoded spans)
        if (avail() < nbits) { error = true; return; }
        const int64_t total = byteoff * 8 + used + nbits;
        byteoff = total >> 3;
        used = (int)(total & 7);
        load();
    }
};

// Rice-decodes n residuals with parameter k into out (zigzag undone).
// The common token (unary quotient + k low bits) is consumed with one
// clz inside the refilled window; the careful path handles long
// quotients and the zero-padded EOF region.
static inline void rice_run32(FlacBR& r, int32_t* RESTRICT out,
                              int64_t n, int k) {
    // local copies of the reader state: out[] writes would otherwise
    // alias the struct fields through the reference, forcing a
    // store/load of byteoff/used every token (~30% of decode time on
    // the bench corpus); these stay in registers for the whole run
    const uint8_t* RESTRICT data = r.data;
    const int64_t safe_end = r.len - 16;
    int64_t byteoff = r.byteoff;
    int used = r.used;

    int64_t i = 0;
    while (i < n) {
        if (__builtin_expect(byteoff > safe_end, 0)) {
            // zero-padded EOF region: careful path, one token
            r.byteoff = byteoff;
            r.used = used;
            const uint64_t q = (uint64_t)r.unary();
            const uint64_t u = k ? ((q << k) | r.get(k)) : q;
            out[i++] = (int32_t)((u >> 1) ^ -(int64_t)(u & 1));
            byteoff = r.byteoff;
            used = r.used;
            if (r.error) return;
            continue;
        }
        byteoff += used >> 3;
        used &= 7;
        uint64_t w;
        memcpy(&w, data + byteoff, 8);
        w = __builtin_bswap64(w) << used;
        int bits_left = 64 - used;
        // drain whole tokens from the loaded window: the loop-carried
        // chain is clz -> shift (~5 cycles/token) instead of a
        // load -> bswap -> shift -> clz chain per token
        const int64_t i_before = i;
        while (i < n) {
            const int lz = __builtin_clzll(w | 1);
            const int total = lz + 1 + k;
            if (__builtin_expect((w == 0) | (total > bits_left), 0))
                break;
            const uint64_t u = k
                ? (((uint64_t)lz << k) | ((w << (lz + 1)) >> (64 - k)))
                : (uint64_t)lz;
            out[i++] = (int32_t)((u >> 1) ^ -(int64_t)(u & 1));
            w <<= total;
            bits_left -= total;
            used += total;
        }
        if (__builtin_expect(i == i_before && i < n, 0)) {
            // token longer than a fresh window (huge unary quotient):
            // the careful path makes progress where a refill cannot
            r.byteoff = byteoff;
            r.used = used;
            const uint64_t q = (uint64_t)r.unary();
            const uint64_t u = k ? ((q << k) | r.get(k)) : q;
            out[i++] = (int32_t)((u >> 1) ^ -(int64_t)(u & 1));
            byteoff = r.byteoff;
            used = r.used;
            if (r.error) return;
        }
    }
    r.byteoff = byteoff;
    r.used = used;
    r.load();
}

// The synthesis recurrence is serial by nature (each output feeds the
// next prediction), so the win is a tight scalar chain: coefficients
// and the ORDER-deep history live in registers (rotating locals), and
// auto-vectorization is disabled — gcc otherwise emits masked AVX-512
// gather code for the inner dot product that measures ~70% slower
// than this scalar form on the bench corpus.
template <int ORDER>
__attribute__((optimize("no-tree-vectorize")))
static inline void synth_lpc_t(int32_t* s, int n, const int32_t* c,
                               int shift) {
    int64_t cr[ORDER];
    int64_t h[ORDER];   // h[j] == s[i - 1 - j], newest first
    if (n < ORDER) return;
    for (int j = 0; j < ORDER; j++) {
        cr[j] = c[j];
        h[j] = s[ORDER - 1 - j];
    }
    for (int i = ORDER; i < n; i++) {
        int64_t p = 0;
        for (int j = 0; j < ORDER; j++)
            p += cr[j] * h[j];
        // int32 truncation before the history keeps hostile streams
        // (samples wrapped past 32 bits) bit-identical to the plain
        // int32 recurrence
        const int32_t v = (int32_t)(s[i] + (p >> shift));
        s[i] = v;
        for (int j = ORDER - 1; j > 0; j--)
            h[j] = h[j - 1];
        h[0] = v;
    }
}

static void synth_lpc32(int32_t* s, int n, const int32_t* c, int order,
                        int shift) {
    switch (order) {
    case 1:  synth_lpc_t<1>(s, n, c, shift); return;
    case 2:  synth_lpc_t<2>(s, n, c, shift); return;
    case 3:  synth_lpc_t<3>(s, n, c, shift); return;
    case 4:  synth_lpc_t<4>(s, n, c, shift); return;
    case 5:  synth_lpc_t<5>(s, n, c, shift); return;
    case 6:  synth_lpc_t<6>(s, n, c, shift); return;
    case 7:  synth_lpc_t<7>(s, n, c, shift); return;
    case 8:  synth_lpc_t<8>(s, n, c, shift); return;
    case 9:  synth_lpc_t<9>(s, n, c, shift); return;
    case 10: synth_lpc_t<10>(s, n, c, shift); return;
    case 11: synth_lpc_t<11>(s, n, c, shift); return;
    case 12: synth_lpc_t<12>(s, n, c, shift); return;
    default:
        for (int i = order; i < n; i++) {
            int64_t p = 0;
            for (int j = 0; j < order; j++)
                p += (int64_t)c[j] * s[i - 1 - j];
            s[i] += (int32_t)(p >> shift);
        }
    }
}

// decodes one subframe into samples[0..block_size), stride 1.
// int32 sample plane (valid for bps <= 26: side channels and fixed-
// order intermediate sums stay inside int32; LPC accumulates in
// int64).  returns 0 on success, negative error code otherwise.
// parsed predictor state of one subframe, synthesis deferred: the
// stereo frame loop parses both channels first, then runs the two
// (independent) synthesis recurrences interleaved — each chain alone
// is latency-bound, so pairing them nearly doubles port utilization
struct SubframeSynth {
    int order;
    bool lpc;          // LPC vs FIXED predictor
    bool need_synth;   // false for CONSTANT/VERBATIM
    int shift;
    int wasted;
    int32_t coeff[32];
};

// parses one subframe into samples[0..block_size) (residuals at
// absolute positions past the warm-up samples) without synthesizing.
// returns 0 on success, negative error code otherwise.
int parse_subframe(FlacBR& r, int block_size, int bps,
                   int32_t* samples, SubframeSynth* ss) {
    if (r.get(1) != 0) return -2;            // reserved pad bit
    const int type = (int)r.get(6);
    int wasted = 0;
    if (r.get(1)) wasted = (int)r.unary() + 1;
    const int ebps = bps - wasted;
    ss->wasted = wasted;
    ss->need_synth = false;
    ss->order = 0;
    ss->lpc = false;
    ss->shift = 0;

    int order;
    bool lpc;
    if (type == 0) {                          // CONSTANT
        const int32_t v = (int32_t)r.get_signed(ebps);
        for (int i = 0; i < block_size; i++) samples[i] = v;
        return r.error ? -1 : 0;
    } else if (type == 1) {                   // VERBATIM
        for (int i = 0; i < block_size; i++)
            samples[i] = (int32_t)r.get_signed(ebps);
        return r.error ? -1 : 0;
    } else if (type >= 8 && type <= 12) {     // FIXED
        order = type - 8;
        lpc = false;
    } else if (type >= 32) {                  // LPC
        order = type - 31;
        lpc = true;
    } else {
        return -3;
    }

    for (int i = 0; i < order; i++)
        samples[i] = (int32_t)r.get_signed(ebps);

    int shift = 0;
    if (lpc) {
        const int precision = (int)r.get(4) + 1;
        shift = (int)r.get_signed(5);
        if (shift < 0) shift = 0;
        for (int i = 0; i < order; i++)
            ss->coeff[i] = (int32_t)r.get_signed(precision);
    }
    ss->order = order;
    ss->lpc = lpc;
    ss->shift = shift;
    ss->need_synth = true;

    // residuals
    const int coding_method = (int)r.get(2);
    if (coding_method > 1) return -4;
    const int porder = (int)r.get(4);
    const int param_bits = coding_method ? 5 : 4;
    const int escape = coding_method ? 31 : 15;
    int32_t* res = samples + order;
    int64_t produced = 0;
    const int64_t partitions = 1LL << porder;
    for (int64_t p = 0; p < partitions; p++) {
        int64_t psize = (block_size >> porder) - (p == 0 ? order : 0);
        if (psize < 0) return -5;
        const int param = (int)r.get(param_bits);
        if (param == escape) {
            const int raw = (int)r.get(5);
            if (raw == 0) {
                for (int64_t i = 0; i < psize; i++) res[produced++] = 0;
            } else {
                for (int64_t i = 0; i < psize; i++)
                    res[produced++] = (int32_t)r.get_signed(raw);
            }
        } else {
            rice_run32(r, res + produced, psize, param);
            produced += psize;
        }
        if (r.error) return -1;
    }
    return r.error ? -1 : 0;
}

static void synth_fixed(int32_t* samples, int block_size, int order) {
    switch (order) {
    case 0: break;
    case 1:
        for (int i = 1; i < block_size; i++)
            samples[i] += samples[i - 1];
        break;
    case 2:
        for (int i = 2; i < block_size; i++)
            samples[i] += 2 * samples[i - 1] - samples[i - 2];
        break;
    case 3:
        for (int i = 3; i < block_size; i++)
            samples[i] += 3 * samples[i - 1] - 3 * samples[i - 2] +
                          samples[i - 3];
        break;
    case 4:
        for (int i = 4; i < block_size; i++)
            samples[i] += 4 * samples[i - 1] - 6 * samples[i - 2] +
                          4 * samples[i - 3] - samples[i - 4];
        break;
    }
}

// single-subframe synthesis + wasted-bits restore
static void finish_subframe(int32_t* samples, int block_size,
                            const SubframeSynth& ss) {
    if (ss.need_synth) {
        if (ss.lpc)
            synth_lpc32(samples, block_size, ss.coeff, ss.order,
                        ss.shift);
        else
            synth_fixed(samples, block_size, ss.order);
    }
    if (ss.wasted)
        for (int i = 0; i < block_size; i++)
            samples[i] <<= ss.wasted;
}

// two independent LPC recurrences interleaved in one loop: the chains
// share no data, so the out-of-order core overlaps their multiply
// latencies (~1.6x the throughput of running them back to back)
template <int O0, int O1>
__attribute__((optimize("no-tree-vectorize")))
static void synth_lpc_dual_t(int32_t* RESTRICT s0, const int32_t* c0,
                             int sh0,
                             int32_t* RESTRICT s1, const int32_t* c1,
                             int sh1, int n) {
    constexpr int M = (O0 > O1) ? O0 : O1;
    if (n < M) {
        synth_lpc32(s0, n, c0, O0, sh0);
        synth_lpc32(s1, n, c1, O1, sh1);
        return;
    }
    // bring the shorter-order channel up to the joint start
    if (O0 < M) synth_lpc32(s0, M, c0, O0, sh0);
    if (O1 < M) synth_lpc32(s1, M, c1, O1, sh1);
    for (int i = M; i < n; i++) {
        int64_t p0 = 0, p1 = 0;
        for (int j = 0; j < O0; j++)
            p0 += (int64_t)c0[j] * s0[i - 1 - j];
        for (int j = 0; j < O1; j++)
            p1 += (int64_t)c1[j] * s1[i - 1 - j];
        s0[i] += (int32_t)(p0 >> sh0);
        s1[i] += (int32_t)(p1 >> sh1);
    }
}

typedef void (*SynthDualFn)(int32_t*, const int32_t*, int,
                            int32_t*, const int32_t*, int, int);

template <int O0>
static SynthDualFn synth_dual_row(int o1) {
    switch (o1) {
    case 1: return synth_lpc_dual_t<O0, 1>;
    case 2: return synth_lpc_dual_t<O0, 2>;
    case 3: return synth_lpc_dual_t<O0, 3>;
    case 4: return synth_lpc_dual_t<O0, 4>;
    case 5: return synth_lpc_dual_t<O0, 5>;
    case 6: return synth_lpc_dual_t<O0, 6>;
    case 7: return synth_lpc_dual_t<O0, 7>;
    case 8: return synth_lpc_dual_t<O0, 8>;
    case 9: return synth_lpc_dual_t<O0, 9>;
    case 10: return synth_lpc_dual_t<O0, 10>;
    case 11: return synth_lpc_dual_t<O0, 11>;
    case 12: return synth_lpc_dual_t<O0, 12>;
    default: return nullptr;
    }
}

static SynthDualFn synth_dual_lookup(int o0, int o1) {
    switch (o0) {
    case 1: return synth_dual_row<1>(o1);
    case 2: return synth_dual_row<2>(o1);
    case 3: return synth_dual_row<3>(o1);
    case 4: return synth_dual_row<4>(o1);
    case 5: return synth_dual_row<5>(o1);
    case 6: return synth_dual_row<6>(o1);
    case 7: return synth_dual_row<7>(o1);
    case 8: return synth_dual_row<8>(o1);
    case 9: return synth_dual_row<9>(o1);
    case 10: return synth_dual_row<10>(o1);
    case 11: return synth_dual_row<11>(o1);
    case 12: return synth_dual_row<12>(o1);
    default: return nullptr;
    }
}

// finishes a pair of subframes, fusing the two LPC recurrences into
// one interleaved loop when both channels used LPC orders 1-12
static void finish_two(int32_t* s0, int32_t* s1, int block_size,
                       const SubframeSynth& a, const SubframeSynth& b) {
    if (a.need_synth && b.need_synth && a.lpc && b.lpc) {
        SynthDualFn fn = synth_dual_lookup(a.order, b.order);
        if (fn != nullptr) {
            fn(s0, a.coeff, a.shift, s1, b.coeff, b.shift, block_size);
            if (a.wasted)
                for (int i = 0; i < block_size; i++)
                    s0[i] <<= a.wasted;
            if (b.wasted)
                for (int i = 0; i < block_size; i++)
                    s1[i] <<= b.wasted;
            return;
        }
    }
    finish_subframe(s0, block_size, a);
    finish_subframe(s1, block_size, b);
}

// parse + synthesize one subframe (the non-stereo path)
int decode_subframe(FlacBR& r, int block_size, int bps,
                    int32_t* samples) {
    SubframeSynth ss;
    const int rc = parse_subframe(r, block_size, bps, samples, &ss);
    if (rc != 0) return rc;
    finish_subframe(samples, block_size, ss);
    return 0;
}

}  // namespace

extern "C" {

// Decodes FLAC frames from a buffer of frame data.
//
// data/data_len: raw frame bytes (past all metadata blocks); the call
//   decodes frames until max_samples would be exceeded, the buffer is
//   exhausted, or an error occurs.
// stream_bps / stream_channels: STREAMINFO values (frame headers with
//   code 0 inherit them)
// out_samples: int32 interleaved output [max_samples * channels]
// consumed_bytes (out): bytes consumed from data
// verify_crc: when nonzero, CRC-8/CRC-16 are checked
// returns the number of PCM frames decoded, or a negative error code
int64_t atpu_flac_decode(const uint8_t* data,
                         int64_t data_len,
                         int32_t stream_bps,
                         int32_t stream_channels,
                         int64_t max_samples,
                         int32_t* out_samples,
                         int64_t* consumed_bytes,
                         int32_t verify_crc,
                         uint8_t* md5_state) {   // optional (may be null)
    // md5_state: when non-null, the stream MD5 (packed little-endian
    // signed PCM, same convention as atpu_md5_update_pcm) is folded
    // in per frame while the interleaved samples are cache-hot,
    // replacing a separate full pass at the Python layer
    static thread_local int32_t* chan_buf = nullptr;
    static thread_local int64_t chan_buf_size = 0;

    int64_t total_frames = 0;
    int64_t consumed = 0;

    while (consumed < data_len) {
        FlacBR r(data + consumed, data_len - consumed);

        // frame header
        if (r.get(14) != 0x3FFE) break;
        r.get(2);                               // reserved + blocking
        const int bs_code = (int)r.get(4);
        const int sr_code = (int)r.get(4);
        const int assignment = (int)r.get(4);
        const int bps_code = (int)r.get(3);
        r.get(1);
        if (r.error) break;

        // UTF-8 frame number
        {
            uint64_t first = r.get(8);
            int extra = 0;
            if (first >= 0xC0) {
                uint64_t mask = 0x20;
                extra = 1;
                while (first & mask) { extra++; mask >>= 1; }
            }
            for (int i = 0; i < extra; i++) r.get(8);
        }

        int block_size;
        switch (bs_code) {
        case 1: block_size = 192; break;
        case 2: block_size = 576; break;
        case 3: block_size = 1152; break;
        case 4: block_size = 2304; break;
        case 5: block_size = 4608; break;
        case 6: block_size = (int)r.get(8) + 1; break;
        case 7: block_size = (int)r.get(16) + 1; break;
        default:
            if (bs_code >= 8) block_size = 256 << (bs_code - 8);
            else return -10;
        }

        if (sr_code == 12) r.get(8);
        else if (sr_code == 13 || sr_code == 14) r.get(16);
        else if (sr_code == 15) return -11;

        int bps;
        switch (bps_code) {
        case 0: bps = stream_bps; break;
        case 1: bps = 8; break;
        case 2: bps = 12; break;
        case 4: bps = 16; break;
        case 5: bps = 20; break;
        case 6: bps = 24; break;
        default: return -12;
        }

        // a buffer boundary can land INSIDE the frame header (UTF-8
        // number / blocksize / samplerate fields read after the
        // first r.error check): truncated reads return zeros with
        // r.error set, and comparing a CRC-8 against that garbage
        // must stop cleanly at the previous frame (the caller
        // refills and rescans), not hard-fail a valid stream
        if (r.error) break;
        if (verify_crc) {
            const int64_t header_len = r.byte_pos();
            const uint8_t expected = crc8_buf(data + consumed,
                                              header_len, 0);
            const uint8_t got = (uint8_t)r.get(8);
            if (r.error) break;   // CRC byte itself truncated
            if (got != expected) return -13;
        } else {
            r.get(8);
        }
        if (r.error) break;

        int channels;
        if (assignment <= 7) channels = assignment + 1;
        else if (assignment <= 10) channels = 2;
        else return -14;
        if (channels != stream_channels) return -15;

        if (total_frames + block_size > max_samples) break;

        // ensure scratch
        const int64_t needed = (int64_t)block_size * channels;
        if (needed > chan_buf_size) {
            delete[] chan_buf;
            chan_buf = new int32_t[needed * 2];
            chan_buf_size = needed;
        }

        // decode subframes: parse channel pairs first, then run both
        // synthesis recurrences interleaved (independent chains)
        if (assignment <= 7) {
            int c = 0;
            for (; c + 2 <= channels; c += 2) {
                SubframeSynth sa, sb;
                int32_t* s0 = chan_buf + (int64_t)c * block_size;
                int32_t* s1 = s0 + block_size;
                int rc = parse_subframe(r, block_size, bps, s0, &sa);
                if (rc) return rc;
                rc = parse_subframe(r, block_size, bps, s1, &sb);
                if (rc) return rc;
                finish_two(s0, s1, block_size, sa, sb);
            }
            for (; c < channels; c++) {
                const int rc = decode_subframe(
                    r, block_size, bps, chan_buf + (int64_t)c * block_size);
                if (rc) return rc;
            }
        } else {
            const int bps0 = bps + (assignment == 9 ? 1 : 0);
            const int bps1 = bps + (assignment != 9 ? 1 : 0);
            SubframeSynth sa, sb;
            int rc = parse_subframe(r, block_size, bps0, chan_buf, &sa);
            if (rc) return rc;
            rc = parse_subframe(r, block_size, bps1,
                                chan_buf + block_size, &sb);
            if (rc) return rc;
            finish_two(chan_buf, chan_buf + block_size, block_size,
                       sa, sb);

            int32_t* c0 = chan_buf;
            int32_t* c1 = chan_buf + block_size;
            if (assignment == 8) {            // left-side
                for (int i = 0; i < block_size; i++)
                    c1[i] = c0[i] - c1[i];
            } else if (assignment == 9) {     // side-right
                for (int i = 0; i < block_size; i++)
                    c0[i] = c0[i] + c1[i];
            } else {                          // mid-side
                for (int i = 0; i < block_size; i++) {
                    const int64_t mid = c0[i];
                    const int64_t side = c1[i];
                    const int64_t sum = (mid << 1) | (side & 1);
                    c0[i] = (int32_t)((sum + side) >> 1);
                    c1[i] = (int32_t)((sum - side) >> 1);
                }
            }
        }

        r.byte_align();
        if (verify_crc) {
            const int64_t body_len = r.byte_pos();
            const uint16_t expected = crc16_buf(data + consumed,
                                                body_len, 0);
            const uint16_t got16 = (uint16_t)r.get(16);
            if (!r.error && got16 != expected) return -16;
        } else {
            r.get(16);
        }
        if (r.error) break;

        // interleave into output
        int32_t* out = out_samples + total_frames * channels;
        if (channels == 2) {
            const int32_t* c0 = chan_buf;
            const int32_t* c1 = chan_buf + block_size;
            for (int i = 0; i < block_size; i++) {
                out[2 * i] = c0[i];
                out[2 * i + 1] = c1[i];
            }
        } else if (channels == 1) {
            memcpy(out, chan_buf, (size_t)block_size * 4);
        } else {
            for (int c = 0; c < channels; c++) {
                const int32_t* src = chan_buf + (int64_t)c * block_size;
                for (int i = 0; i < block_size; i++)
                    out[(int64_t)i * channels + c] = src[i];
            }
        }

        if (md5_state != nullptr)
            atpu_md5_update_pcm(md5_state, out,
                                (int64_t)block_size * channels,
                                stream_bps / 8, 1);

        consumed += r.byte_pos();
        total_frames += block_size;
    }

    *consumed_bytes = consumed;
    return total_frames;
}

// Structural scan for the DEVICE decode path (ATPU_FLAC_DEC_BACKEND=jax).
//
// Walks FLAC frames like atpu_flac_decode but extracts NO residual
// values and runs NO synthesis: it records per-frame / per-subframe
// predictor metadata (type, order, wasted bits, warm-up samples, QLP
// coefficients, shift) plus one record per residual *partition* (Rice
// parameter or raw width, residual count, destination offset, absolute
// bit offset and bit length within `data`).  The device then Rice-
// decodes the partitions in batch (ops/rice_decode.py, a vectorized
// pointer-doubling state machine over u32 lanes) and runs the
// synthesis recurrences as fused scans (ops/flac_synth.py) — the
// TPU-native split of reference src/decoders/flac.c:174-260,1156-1193.
//
// Layouts (int32 unless noted):
//   frame_meta[f*4]  = {block_size, assignment, bps, frame_byte_len}
//   sub_meta[s*8]    = {frame_idx, type(0=const 1=verbatim 2=fixed
//                       3=lpc), order, wasted, shift, ebps, const_val,
//                       porder}
//   warmup[s*32], qlp[s*32]
//   part_meta[p*8]   = {sub_idx, dest_off, count, rice_k(-1 if raw),
//                       raw_bits(-1 if rice), bit_off, bit_len, 0}
// counts (int64[6] out) = {n_frames, n_subs, n_parts, consumed_bytes,
//                          total_pcm_frames, 0}
// Returns total PCM frames scanned (>= 0) or a negative error code.
// Stops cleanly (without consuming) before a frame that would exceed
// max_frames / max_parts / max_samples; CRC-8/16 are verified here
// (byte-local work), so the device path inherits the same strictness.
extern "C" int64_t atpu_flac_scan(const uint8_t* data,
                                  int64_t data_len,
                                  int32_t stream_bps,
                                  int32_t stream_channels,
                                  int64_t max_samples,
                                  int32_t max_frames,
                                  int32_t max_parts,
                                  int32_t verify_crc,
                                  int32_t chunk_codes,
                                  int32_t* frame_meta,
                                  int32_t* sub_meta,
                                  int32_t* warmup,
                                  int32_t* qlp,
                                  int32_t* part_meta,
                                  int64_t* counts) {
    static thread_local std::vector<int32_t> skip_buf;

    int64_t n_frames = 0, n_subs = 0, n_parts = 0;
    int64_t consumed = 0, total_pcm = 0;

    while (consumed < data_len && n_frames < max_frames) {
        FlacBR r(data + consumed, data_len - consumed);

        if (r.get(14) != 0x3FFE) break;
        r.get(2);
        const int bs_code = (int)r.get(4);
        const int sr_code = (int)r.get(4);
        const int assignment = (int)r.get(4);
        const int bps_code = (int)r.get(3);
        r.get(1);
        if (r.error) break;

        {   // UTF-8 frame number
            uint64_t first = r.get(8);
            int extra = 0;
            if (first >= 0xC0) {
                uint64_t mask = 0x20;
                extra = 1;
                while (first & mask) { extra++; mask >>= 1; }
            }
            for (int i = 0; i < extra; i++) r.get(8);
        }

        int block_size;
        switch (bs_code) {
        case 1: block_size = 192; break;
        case 2: block_size = 576; break;
        case 3: block_size = 1152; break;
        case 4: block_size = 2304; break;
        case 5: block_size = 4608; break;
        case 6: block_size = (int)r.get(8) + 1; break;
        case 7: block_size = (int)r.get(16) + 1; break;
        default:
            if (bs_code >= 8) block_size = 256 << (bs_code - 8);
            else return -10;
        }

        if (sr_code == 12) r.get(8);
        else if (sr_code == 13 || sr_code == 14) r.get(16);
        else if (sr_code == 15) return -11;

        int bps;
        switch (bps_code) {
        case 0: bps = stream_bps; break;
        case 1: bps = 8; break;
        case 2: bps = 12; break;
        case 4: bps = 16; break;
        case 5: bps = 20; break;
        case 6: bps = 24; break;
        default: return -12;
        }

        // a buffer boundary can land INSIDE the frame header (UTF-8
        // number / blocksize / samplerate fields read after the
        // first r.error check): truncated reads return zeros with
        // r.error set, and comparing a CRC-8 against that garbage
        // must stop cleanly at the previous frame (the caller
        // refills and rescans), not hard-fail a valid stream
        if (r.error) break;
        if (verify_crc) {
            const int64_t header_len = r.byte_pos();
            const uint8_t expected = crc8_buf(data + consumed,
                                              header_len, 0);
            const uint8_t got = (uint8_t)r.get(8);
            if (r.error) break;   // CRC byte itself truncated
            if (got != expected) return -13;
        } else {
            r.get(8);
        }
        if (r.error) break;

        int channels;
        if (assignment <= 7) channels = assignment + 1;
        else if (assignment <= 10) channels = 2;
        else return -14;
        if (channels != stream_channels) return -15;

        if (total_pcm + block_size > max_samples) break;

        const int64_t frame_subs_base = n_subs;
        const int64_t frame_parts_base = n_parts;
        bool capacity = true;
        // set when the frame's bits run past the buffered data: the
        // frame rolls back and the scan stops cleanly at the last
        // complete frame (callers refill the buffer and rescan) —
        // decode-ahead batches legitimately end mid-frame
        bool frame_error = false;

        for (int c = 0; c < channels && capacity && !frame_error;
             c++) {
            int sub_bps = bps;
            if (assignment == 8 && c == 1) sub_bps = bps + 1;
            else if (assignment == 9 && c == 0) sub_bps = bps + 1;
            else if (assignment == 10 && c == 1) sub_bps = bps + 1;

            // ---- subframe header ----
            if (r.get(1) != 0) return -2;
            const int type_code = (int)r.get(6);
            int wasted = 0;
            if (r.get(1)) wasted = (int)r.unary() + 1;
            const int ebps = sub_bps - wasted;

            int32_t* sm = sub_meta + n_subs * 8;
            int32_t* wu = warmup + n_subs * 32;
            int32_t* ql = qlp + n_subs * 32;
            for (int i = 0; i < 32; i++) { wu[i] = 0; ql[i] = 0; }
            sm[0] = (int32_t)n_frames;
            sm[2] = 0; sm[3] = wasted; sm[4] = 0; sm[5] = ebps;
            sm[6] = 0; sm[7] = 0;

            int order = 0;
            bool lpc = false;
            if (type_code == 0) {                       // CONSTANT
                sm[1] = 0;
                sm[6] = (int32_t)r.get_signed(ebps);
                if (r.error) { frame_error = true; break; }
                n_subs++;
                continue;
            } else if (type_code == 1) {                // VERBATIM
                sm[1] = 1;
                // chunk_codes > 0 splits the run into <= chunk_codes
                // sample records (see the residual loop note)
                const int64_t vstep =
                    (chunk_codes > 0 && block_size > chunk_codes)
                        ? chunk_codes : block_size;
                int64_t vdone = 0;
                do {
                    const int64_t cn =
                        std::min(vstep, (int64_t)block_size - vdone);
                    if (n_parts >= max_parts) {
                        capacity = false; break;
                    }
                    int32_t* pm = part_meta + n_parts * 8;
                    pm[0] = (int32_t)n_subs;
                    pm[1] = (int32_t)vdone;
                    pm[2] = (int32_t)cn;
                    pm[3] = -1;
                    pm[4] = ebps;
                    const int64_t off = consumed * 8 + r.bit_pos();
                    pm[5] = (int32_t)off;
                    r.skip_bits(cn * ebps);
                    pm[6] = (int32_t)(consumed * 8 + r.bit_pos() -
                                      off);
                    pm[7] = 0;
                    if (r.error) { frame_error = true; break; }
                    vdone += cn;
                    n_parts++;
                } while (vdone < block_size);
                if (!capacity || frame_error) break;
                n_subs++;
                continue;
            } else if (type_code >= 8 && type_code <= 12) {  // FIXED
                order = type_code - 8;
                sm[1] = 2;
            } else if (type_code >= 32) {               // LPC
                order = type_code - 31;
                lpc = true;
                sm[1] = 3;
            } else {
                return -3;
            }
            sm[2] = order;

            for (int i = 0; i < order; i++)
                wu[i] = (int32_t)r.get_signed(ebps);

            if (lpc) {
                const int precision = (int)r.get(4) + 1;
                int shift = (int)r.get_signed(5);
                if (shift < 0) shift = 0;
                sm[4] = shift;
                for (int i = 0; i < order; i++)
                    ql[i] = (int32_t)r.get_signed(precision);
            }
            if (r.error) { frame_error = true; break; }

            // ---- residual partitions ----
            const int coding_method = (int)r.get(2);
            if (coding_method > 1) return -4;
            const int porder = (int)r.get(4);
            sm[7] = porder;
            const int param_bits = coding_method ? 5 : 4;
            const int escape = coding_method ? 31 : 15;
            const int64_t partitions = 1LL << porder;
            int64_t dest = order;
            for (int64_t p = 0; p < partitions; p++) {
                int64_t psize = (block_size >> porder) -
                                (p == 0 ? order : 0);
                if (psize < 0) return -5;
                const int param = (int)r.get(param_bits);
                int rice_k = -1, raw_w = -1;
                if (param == escape) {
                    raw_w = (int)r.get(5);
                } else {
                    rice_k = param;
                    if (psize > 0 &&
                        (int64_t)skip_buf.size() < psize)
                        skip_buf.resize(psize);
                }
                // chunk_codes > 0 splits the partition into records
                // of <= chunk_codes codes each, with exact bit
                // offsets: the walk below visits every code anyway
                // (unary lengths are data-dependent), so these
                // checkpoints are free — and they turn the device
                // decoder's C-long sequential problem into C/chunk
                // INDEPENDENT lanes (the lock-step scan then runs
                // chunk_codes steps over many-thousand-lane vectors
                // instead of 4096 steps over a few hundred).
                // Records additionally break at DESTINATION
                // positions that are multiples of chunk_codes, so
                // every record fits one aligned chunk_codes-wide
                // output slot — the device then assembles the
                // residual plane with a single-contributor ROW
                // scatter instead of a per-element general scatter
                // (the element scatter measured ~370 ms per decode
                // batch on v5e)
                int64_t done = 0;
                do {
                    int64_t cn;
                    if (chunk_codes > 0 && psize > 0) {
                        const int64_t room = chunk_codes -
                            ((dest + done) % chunk_codes);
                        cn = std::min(room, psize - done);
                    } else {
                        cn = psize > 0 ? psize : 0;
                    }
                    if (n_parts >= max_parts) {
                        capacity = false; break;
                    }
                    int32_t* pm = part_meta + n_parts * 8;
                    pm[0] = (int32_t)n_subs;
                    pm[1] = (int32_t)(dest + done);
                    pm[2] = (int32_t)cn;
                    pm[3] = rice_k;
                    pm[4] = raw_w;
                    pm[7] = 0;
                    const int64_t coff = consumed * 8 + r.bit_pos();
                    pm[5] = (int32_t)coff;
                    if (rice_k >= 0) {
                        if (cn > 0)
                            rice_run32(r, skip_buf.data(), cn,
                                       rice_k);
                    } else if (raw_w > 0) {
                        r.skip_bits(cn * raw_w);
                    }
                    pm[6] = (int32_t)(consumed * 8 + r.bit_pos() -
                                      coff);
                    if (r.error) { frame_error = true; break; }
                    done += cn;
                    n_parts++;
                } while (done < psize);
                if (!capacity || frame_error) break;
                dest += psize;
            }
            if (!capacity || frame_error) break;
            n_subs++;
        }

        if (frame_error) {
            // incomplete frame at the end of the buffered bytes:
            // roll back; consumed stays at the last complete frame
            n_subs = frame_subs_base;
            n_parts = frame_parts_base;
            break;
        }
        if (!capacity) {
            // frame didn't fit the caller's buffers: roll back and
            // stop (an over-capacity FIRST frame is an error — the
            // caller must fall back to the host decoder)
            n_subs = frame_subs_base;
            n_parts = frame_parts_base;
            if (n_frames == 0) return -30;
            break;
        }

        r.byte_align();
        if (verify_crc) {
            const int64_t body_len = r.byte_pos();
            const uint16_t expected = crc16_buf(data + consumed,
                                                body_len, 0);
            const uint16_t got16 = (uint16_t)r.get(16);
            if (!r.error && got16 != expected) return -16;
        } else {
            r.get(16);
        }
        if (r.error) {
            n_subs = frame_subs_base;
            n_parts = frame_parts_base;
            break;
        }

        int32_t* fm = frame_meta + n_frames * 4;
        fm[0] = block_size;
        fm[1] = assignment;
        fm[2] = bps;
        fm[3] = (int32_t)r.byte_pos();
        consumed += r.byte_pos();
        total_pcm += block_size;
        n_frames++;
    }

    counts[0] = n_frames;
    counts[1] = n_subs;
    counts[2] = n_parts;
    counts[3] = consumed;
    counts[4] = total_pcm;
    counts[5] = 0;
    return total_pcm;
}

}  // extern "C"

// ======================================================================
// ALAC (Apple Lossless) — host-side adaptive encode/decode kernels.
//
// Role of reference src/encoders/alac.c / src/decoders/alac.c
// (behavioral spec: audiotools/py_encoders/alac.py, py_decoders/alac.py,
// mirrored by audiotools_tpu/ref/alac.py).  ALAC's residual filter
// adapts its coefficients per sample and its Rice variant carries a
// running history — true recurrences, so they run here on the host;
// the batched device kernel (ops/alac_frames.py) supplies the LPC
// coefficient candidates (qlp4/qlp8 per block, group, leftweight,
// channel), computed with the shared contraction-immune numerics, and
// this emitter makes all size decisions from exact candidate bits.

namespace alac {

constexpr int QLP_SHIFT = 9;
// qlp4[4] + qlp8[8] + degenerate + est4 + est8
constexpr int PACKED_COLS = 15;
constexpr int N_LW = 5;

struct Opts {
    int block_size;
    int initial_history;
    int history_multiplier;
    int maximum_k;
    int interlacing_shift;
    int min_lw, max_lw;
    int bps;
};

static inline int ilog2_floor(uint32_t v) {
    return (v == 0) ? -1 : (31 - __builtin_clz(v));
}

static inline int32_t trunc_bits(int64_t v, int bits) {
    const int64_t mask = (1LL << bits) - 1;
    int64_t t = v & mask;
    if (t & (1LL << (bits - 1))) t -= (1LL << bits);
    return (int32_t)t;
}

static inline int sign_only(int64_t v) { return (v > 0) - (v < 0); }

// sign-adaptive LPC residual producer (py_encoders/alac.py:349-397).
// Generates residuals on demand so the Rice coder consumes them in
// the same pass — no intermediate buffer, one traversal per
// candidate.  Templated on ORDER (4 or 8 in practice) so the MAC and
// adaptation loops fully unroll.  The coefficient state adapts per
// sample (mutating a local copy).
template <int ORDER>
struct AdaptiveProducer {
    const int32_t* ch;
    int64_t n;
    int sample_size;
    int32_t qlp[ORDER];
    int64_t i;

    AdaptiveProducer(const int32_t* channel, int64_t count, int ss,
                     const int32_t* coeffs)
        : ch(channel), n(count), sample_size(ss), i(0) {
        for (int j = 0; j < ORDER; j++) qlp[j] = coeffs[j];
    }

    inline int32_t next() {
        const int64_t pos = i++;
        if (pos == 0) return ch[0];
        if (pos <= ORDER)
            return trunc_bits((int64_t)ch[pos] - ch[pos - 1],
                              sample_size);
        const int64_t base = ch[pos - ORDER - 1];
        int64_t lpc_sum = 0;
        for (int j = 0; j < ORDER; j++)
            lpc_sum += (int64_t)qlp[j] * (ch[pos - 1 - j] - base);
        int64_t residual = trunc_bits(
            ch[pos] - base -
            ((lpc_sum + (1LL << (QLP_SHIFT - 1))) >> QLP_SHIFT),
            sample_size);
        const int32_t out = (int32_t)residual;
        if (residual > 0) {
            for (int j = 0; j < ORDER && residual > 0; j++) {
                const int64_t diff = base - ch[pos - ORDER + j];
                const int sign = sign_only(diff);
                qlp[ORDER - j - 1] -= sign;
                residual -= (((diff * sign) >> QLP_SHIFT) * (j + 1));
            }
        } else if (residual < 0) {
            for (int j = 0; j < ORDER && residual < 0; j++) {
                const int64_t diff = base - ch[pos - ORDER + j];
                const int sign = sign_only(diff);
                qlp[ORDER - j - 1] += sign;
                residual -= (((diff * -sign) >> QLP_SHIFT) * (j + 1));
            }
        }
        return out;
    }
};

struct BitCounter {
    int64_t total = 0;
    inline void put(uint64_t, int64_t nbits) { total += nbits; }
};

// reciprocal table for division by (2^k - 1), k = 1..14:
// q = (u * RECIP[k]) >> 47 is exact for u < 2^33 (verified vs plain
// division at table build)
struct RiceRecip {
    uint64_t m[15];
    RiceRecip() {
        for (int k = 1; k <= 14; k++) {
            const uint64_t d = (1ULL << k) - 1;
            m[k] = ((1ULL << 47) + d - 1) / d;   // ceil(2^47 / d)
        }
    }
};
static const RiceRecip rice_recip;

template <typename Sink>
static inline void put_residual(Sink& w, uint32_t unsigned_v, int k,
                                int sample_size) {
    const uint32_t div = (1u << k) - 1;
    const uint32_t MSB = (uint32_t)(((unsigned __int128)unsigned_v *
                                     rice_recip.m[k]) >> 47);
    const uint32_t LSB = unsigned_v - MSB * div;
    if (MSB > 8) {
        w.put(0x1FF, 9);
        w.put(unsigned_v, sample_size);
    } else {
        // MSB one-bits then a zero stop bit
        w.put(((1ULL << MSB) - 1) << 1, MSB + 1);
        if (k > 1) {
            if (LSB > 0) w.put(LSB + 1, k);
            else w.put(0, k - 1);
        }
    }
}

// history-adaptive residual block (py_encoders/alac.py:400-435),
// pulling residuals from an AdaptiveProducer in the same pass;
// returns false on residual overflow (caller falls back uncompressed)
template <typename Sink, typename Prod>
static bool put_residual_block(Sink& w, const Opts& o,
                               int sample_size, Prod& p, int64_t n) {
    int64_t history = o.initial_history;
    int sign_modifier = 0;
    int64_t i = 0;
    int32_t pending = 0;
    bool has_pending = false;
    while (i < n) {
        const int64_t r = has_pending ? pending : p.next();
        has_pending = false;
        const uint64_t unsigned_v = (r >= 0) ? (uint64_t)(r * 2)
                                             : (uint64_t)(-r * 2 - 1);
        if (unsigned_v >= (1ULL << sample_size)) return false;
        int k = ilog2_floor((uint32_t)((history >> 9) + 3));
        if (k > o.maximum_k) k = o.maximum_k;
        put_residual(w, (uint32_t)(unsigned_v - sign_modifier), k,
                     sample_size);
        sign_modifier = 0;
        if (unsigned_v <= 0xFFFF) {
            history += (int64_t)(unsigned_v * o.history_multiplier) -
                       ((history * o.history_multiplier) >> 9);
            i += 1;
            if (history < 128 && i < n) {
                int zk = 7 - ilog2_floor((uint32_t)history) +
                         (int)((history + 16) >> 6);
                if (zk > o.maximum_k) zk = o.maximum_k;
                uint32_t zeroes = 0;
                while (i < n) {
                    const int32_t z = p.next();
                    if (z == 0) {
                        zeroes++;
                        i++;
                    } else {
                        pending = z;
                        has_pending = true;
                        break;
                    }
                }
                put_residual(w, zeroes, zk, 16);
                if (zeroes < 65535) sign_modifier = 1;
                history = 0;
            }
        } else {
            i += 1;
            history = 0xFFFF;
        }
    }
    return true;
}

template <typename Sink>
static void put_subframe_header(Sink& w, const int32_t* qlp,
                                int order) {
    w.put(0, 4);
    w.put(QLP_SHIFT, 4);
    w.put(4, 3);
    w.put(order, 5);
    for (int i = 0; i < order; i++)
        w.put((uint64_t)(qlp[i] & 0xFFFF), 16);
}

// runs one (channel, order) candidate through producer + rice sink
template <typename Sink>
static bool run_candidate(Sink& w, const Opts& o, int sample_size,
                          const int32_t* channel, int64_t n,
                          const int32_t* qlp, int order) {
    if (order == 4) {
        AdaptiveProducer<4> p(channel, n, sample_size, qlp);
        return put_residual_block(w, o, sample_size, p, n);
    } else {
        AdaptiveProducer<8> p(channel, n, sample_size, qlp);
        return put_residual_block(w, o, sample_size, p, n);
    }
}

// per-(leftweight, channel) candidate state for one frame group
struct Candidate {
    int order;                 // chosen order (4 or 8)
    const int32_t* qlp;        // chosen coefficients (packed row)
};

struct Scratch {
    int32_t* ch[2];            // shifted channels
};

static const int32_t ZERO_QLP[8] = {0, 0, 0, 0, 0, 0, 0, 0};

// selects one channel's order-4 vs order-8 candidate from the
// device-computed residual-size estimates (packed cols 13/14; the
// same policy as ref/alac.py calculate_lpc_coefficients) — the
// adaptive recurrence only runs for the winner, at write time
static Candidate pick_channel(const int32_t* packed_row) {
    if (packed_row[12] != 0)                    // degenerate
        return Candidate{4, ZERO_QLP};
    if (packed_row[13] <= packed_row[14])
        return Candidate{4, packed_row};
    return Candidate{8, packed_row + 4};
}

// writes the residual block for a decided candidate; returns false
// on residual overflow (caller rolls the writer back)
template <typename Sink>
static bool write_candidate_residuals(Sink& w, const Opts& o,
                                      int sample_size,
                                      const int32_t* channel,
                                      int64_t n, const Candidate& c) {
    return run_candidate(w, o, sample_size, channel, n, c.qlp,
                         c.order);
}

}  // namespace alac

extern "C" {

// Emits ALAC framesets (one per block) from raw PCM + LPC candidates.
//
// blocks: int32 [n_blocks, max_n, ch_total] interleaved, WAVE order
// ns: per-block sample counts
// layout_off/layout_w: [n_groups] channel group offsets/widths
// packed: int32 [n_blocks, n_groups, 5, 2, 13] per-(leftweight,
//   channel) qlp4[4] + qlp8[8] + degenerate flag (device output)
// out/out_ends: frameset bytes and cumulative end offsets
// returns total bytes or negative error code
int64_t atpu_alac_emit_framesets(const int32_t* blocks,
                                 const int32_t* ns,
                                 int64_t n_blocks,
                                 const int32_t* layout_off,
                                 const int32_t* layout_w,
                                 int32_t n_groups,
                                 const int32_t* packed,
                                 int32_t ch_total,
                                 int32_t max_n,
                                 int32_t block_size,
                                 int32_t initial_history,
                                 int32_t history_multiplier,
                                 int32_t maximum_k,
                                 int32_t interlacing_shift,
                                 int32_t min_lw,
                                 int32_t max_lw,
                                 int32_t bps,
                                 uint8_t* out,
                                 int64_t* out_ends) {
    using namespace alac;
    Opts o{block_size, initial_history, history_multiplier, maximum_k,
           interlacing_shift, min_lw, max_lw, bps};

    static thread_local int32_t* buf = nullptr;
    static thread_local int64_t buf_n = 0;
    if (max_n > buf_n) {
        delete[] buf;
        buf = new int32_t[(int64_t)max_n * 8];
        buf_n = max_n;
    }
    Scratch s;
    s.ch[0] = buf;
    s.ch[1] = buf + max_n;
    int32_t* raw0 = buf + 2 * (int64_t)max_n;  // unshifted channels
    int32_t* raw1 = buf + 3 * (int64_t)max_n;
    int32_t* cor0 = buf + 4 * (int64_t)max_n;  // correlated pair
    int32_t* cor1 = buf + 5 * (int64_t)max_n;

    const int lsb_bytes = (bps > 16) ? (bps - 16) / 8 : 0;
    const int lsb_shift = lsb_bytes * 8;

    for (int64_t b = 0; b < n_blocks; b++) {
        const int64_t n = ns[b];
        const int32_t* pcm = blocks + b * (int64_t)max_n * ch_total;
        BitWriter w(out, (b == 0) ? 0 : out_ends[b - 1]);

        for (int g = 0; g < n_groups; g++) {
            const int off = layout_off[g];
            const int width = layout_w[g];
            const int32_t* prow_base =
                packed + ((b * n_groups + g) * N_LW) * 2 * PACKED_COLS;

            w.put(width - 1, 3);

            // gather raw + shifted channels
            for (int64_t i = 0; i < n; i++)
                raw0[i] = pcm[i * ch_total + off];
            if (width == 2)
                for (int64_t i = 0; i < n; i++)
                    raw1[i] = pcm[i * ch_total + off + 1];
            for (int64_t i = 0; i < n; i++)
                s.ch[0][i] = raw0[i] >> lsb_shift;
            if (width == 2)
                for (int64_t i = 0; i < n; i++)
                    s.ch[1][i] = raw1[i] >> lsb_shift;

            // uncompressed frame size (always a candidate)
            const bool partial = (n != block_size);
            const int64_t unc_bits = 16 + 1 + 2 + 1 +
                (partial ? 32 : 0) + n * width * bps;

            bool write_uncompressed = (n < 10);
            int chosen_lw = 0;
            Candidate chosen[2];

            if (!write_uncompressed && width == 1) {
                chosen[0] = pick_channel(prow_base);
            } else if (!write_uncompressed) {
                // leftweight from the device residual estimates:
                // lowest min(est4, est8) sum over both correlated
                // channels, ties to the lowest leftweight (the
                // oracle's encode_compressed_frame policy)
                int64_t best_score = 0;
                for (int lw = min_lw; lw <= max_lw; lw++) {
                    const int32_t* prow0 = prow_base +
                        (lw * 2 + 0) * PACKED_COLS;
                    const int32_t* prow1 = prow_base +
                        (lw * 2 + 1) * PACKED_COLS;
                    const int64_t score =
                        (int64_t)(prow0[13] < prow0[14] ? prow0[13]
                                                        : prow0[14]) +
                        (int64_t)(prow1[13] < prow1[14] ? prow1[13]
                                                        : prow1[14]);
                    if (lw == min_lw || score < best_score) {
                        best_score = score;
                        chosen_lw = lw;
                    }
                }
                chosen[0] = pick_channel(
                    prow_base + (chosen_lw * 2 + 0) * PACKED_COLS);
                chosen[1] = pick_channel(
                    prow_base + (chosen_lw * 2 + 1) * PACKED_COLS);
            }

            // write the compressed frame speculatively; roll the
            // writer back to this snapshot on residual overflow or
            // when the exact size loses to the uncompressed frame
            const BitWriter snapshot = w;
            bool ok = !write_uncompressed;
            if (ok && width == 1) {
                const int sample_size = bps - lsb_shift;
                w.put(0, 16);
                w.put(partial ? 1 : 0, 1);
                w.put(lsb_bytes, 2);
                w.put(0, 1);
                if (partial) w.put((uint64_t)n, 32);
                w.put(0, 8);
                w.put(0, 8);
                put_subframe_header(w, chosen[0].qlp, chosen[0].order);
                if (lsb_bytes > 0) {
                    const uint32_t lmask = (1u << lsb_shift) - 1;
                    for (int64_t i = 0; i < n; i++)
                        w.put((uint32_t)raw0[i] & lmask, lsb_shift);
                }
                ok = write_candidate_residuals(
                    w, o, sample_size, s.ch[0], n, chosen[0]);
            } else if (ok) {
                const int sample_size = bps - lsb_shift + 1;
                w.put(0, 16);
                w.put(partial ? 1 : 0, 1);
                w.put(lsb_bytes, 2);
                w.put(0, 1);
                if (partial) w.put((uint64_t)n, 32);
                w.put(interlacing_shift, 8);
                w.put(chosen_lw, 8);
                put_subframe_header(w, chosen[0].qlp, chosen[0].order);
                put_subframe_header(w, chosen[1].qlp, chosen[1].order);
                if (lsb_bytes > 0) {
                    const uint32_t lmask = (1u << lsb_shift) - 1;
                    for (int64_t i = 0; i < n; i++) {
                        w.put((uint32_t)raw0[i] & lmask, lsb_shift);
                        w.put((uint32_t)raw1[i] & lmask, lsb_shift);
                    }
                }
                const int32_t* c0;
                const int32_t* c1;
                if (chosen_lw == 0) {
                    c0 = s.ch[0];
                    c1 = s.ch[1];
                } else {
                    for (int64_t i = 0; i < n; i++) {
                        const int64_t a = s.ch[0][i];
                        const int64_t bb = s.ch[1][i];
                        cor0[i] = (int32_t)(bb +
                            (((a - bb) * chosen_lw) >>
                             interlacing_shift));
                        cor1[i] = (int32_t)(a - bb);
                    }
                    c0 = cor0;
                    c1 = cor1;
                }
                ok = write_candidate_residuals(
                    w, o, sample_size, c0, n, chosen[0]);
                if (ok)
                    ok = write_candidate_residuals(
                        w, o, sample_size, c1, n, chosen[1]);
            }
            if (ok) {
                const int64_t comp_bits =
                    (w.pos * 8 + w.bits) -
                    (snapshot.pos * 8 + snapshot.bits);
                if (comp_bits >= unc_bits) ok = false;
            }
            if (!ok) {
                w = snapshot;
                w.put(0, 16);
                w.put(partial ? 1 : 0, 1);
                w.put(0, 2);
                w.put(1, 1);
                if (partial) w.put((uint64_t)n, 32);
                const uint64_t mask = (1ULL << bps) - 1;
                for (int64_t i = 0; i < n; i++) {
                    w.put((uint64_t)raw0[i] & mask, bps);
                    if (width == 2)
                        w.put((uint64_t)raw1[i] & mask, bps);
                }
            }
        }

        w.put(7, 3);          // end-of-frameset
        w.byte_align();
        out_ends[b] = w.pos;
    }
    return (n_blocks > 0) ? out_ends[n_blocks - 1] : 0;
}

}  // extern "C"

// ---------------------------------------------------------------------
// ALAC decoder (role of reference src/decoders/alac.c): framesets ->
// interleaved wave-order PCM.  Mirrors ref/alac.py ALACDecoder.

namespace alac {

// ALAC frameset channel order -> wave order (ref/alac.py WAVE_ORDER)
static const int WAVE_ORDER_TBL[9][8] = {
    {},
    {0},
    {0, 1},
    {1, 2, 0},
    {1, 2, 0, 3},
    {1, 2, 0, 3, 4},
    {1, 2, 0, 5, 3, 4},
    {1, 2, 0, 6, 3, 4, 5},
    {3, 4, 0, 7, 5, 6, 1, 2},
};

// reads one adaptive residual (ref/alac.py:666-679)
static inline int64_t read_residual(BitReader& r, int k,
                                    int sample_size) {
    // limited unary: up to 8 one-bits then a zero; 9 ones = escape
    int msb = 0;
    while (msb < 9 && r.get(1) == 1) msb++;
    if (r.error) return 0;
    if (msb == 9) return (int64_t)r.get(sample_size);
    if (k == 0) return msb;
    const int64_t hi = (k > 1) ? (int64_t)r.get(k - 1) : 0;
    if (hi != 0) {
        const int64_t lsb = (hi << 1) | r.get(1);
        return (int64_t)msb * ((1LL << k) - 1) + (lsb - 1);
    }
    return (int64_t)msb * ((1LL << k) - 1);
}

struct DecOpts {
    int initial_history, history_multiplier, maximum_k;
};

// ref/alac.py:627-664
static bool read_residuals(BitReader& r, const DecOpts& o,
                           int sample_size, int64_t count,
                           int32_t* out) {
    int64_t history = o.initial_history;
    int sign_modifier = 0;
    int64_t i = 0;
    while (i < count) {
        int k = ilog2_floor((uint32_t)((history >> 9) + 3));
        if (k > o.maximum_k) k = o.maximum_k;
        const int64_t unsigned_v = read_residual(r, k, sample_size) +
                                   sign_modifier;
        sign_modifier = 0;
        out[i] = (unsigned_v & 1)
            ? (int32_t)(-((unsigned_v + 1) >> 1))
            : (int32_t)(unsigned_v >> 1);
        if (unsigned_v <= 0xFFFF)
            history += (unsigned_v * o.history_multiplier) -
                       ((history * o.history_multiplier) >> 9);
        else
            history = 0xFFFF;
        if (history < 128 && (i + 1) < count) {
            int zk = 7 - ilog2_floor((uint32_t)history) +
                     (int)((history + 16) >> 6);
            if (zk > o.maximum_k) zk = o.maximum_k;
            const int64_t zeroes = read_residual(r, zk, 16);
            if (zeroes > 0) {
                for (int64_t z = 0; z < zeroes && (i + 1) < count;
                     z++) {
                    i += 1;
                    out[i] = 0;
                }
                // the spec extends exactly `zeroes` zeros; bail on
                // malformed streams that would overrun
            }
            history = 0;
            if (zeroes <= 0xFFFF) sign_modifier = 1;
        }
        i += 1;
        if (r.error) return false;
    }
    return true;
}

// ref/alac.py:681-730 — in-place residual -> sample synthesis with
// sign-adaptive coefficient updates
static void decode_subframe(int32_t* qlp, int order, int shift,
                            int sample_size, int32_t* data,
                            int64_t count) {
    if (order >= 31) {
        for (int64_t i = 1; i < count; i++)
            data[i] = trunc_bits((int64_t)data[i - 1] + data[i],
                                 sample_size);
        return;
    }
    for (int i = 1; i <= order && i < count; i++)
        data[i] = trunc_bits((int64_t)data[i - 1] + data[i],
                             sample_size);
    for (int64_t i = order + 1; i < count; i++) {
        int64_t residual = data[i];
        const int64_t base = data[i - order - 1];
        int64_t lpc_sum = 0;
        for (int j = 0; j < order; j++)
            lpc_sum += ((int64_t)data[i - 1 - j] - base) * qlp[j];
        int64_t outval = ((1LL << (shift - 1)) + lpc_sum) >> shift;
        data[i] = trunc_bits(outval + residual + base, sample_size);

        // buf = samples[-order-2 : -1] relative to position i
        const int32_t* buf = data + (i - order - 1);
        if (residual > 0) {
            for (int pn = order - 1; pn >= 0 && residual > 0; pn--) {
                const int64_t val = (int64_t)buf[0] -
                                    buf[order - pn];
                const int sign = sign_only(val);
                qlp[pn] -= sign;
                residual -= (((val * sign) >> shift) * (order - pn));
            }
        } else if (residual < 0) {
            for (int pn = order - 1; pn >= 0 && residual < 0; pn--) {
                const int64_t val = (int64_t)buf[0] -
                                    buf[order - pn];
                const int sign = -sign_only(val);
                qlp[pn] -= sign;
                // val * sign == -|val|; the shifted negative value
                // walks the residual back toward zero
                residual -= (((val * sign) >> shift) * (order - pn));
            }
        }
    }
}

}  // namespace alac

extern "C" {

// Decodes ALAC framesets into interleaved wave-order int32 PCM.
//
// data/len: mdat payload positioned at the first frameset
// returns PCM frames decoded, or negative error; consumed_bytes
// reports how much of data was read
// Structural scan for the DEVICE ALAC decode path: walks framesets,
// decodes the history-adaptive entropy half (bit positions are
// data-dependent — host work, like the FLAC scan) and exports
// residual planes + predictor metadata; the sign-adaptive predictor
// recurrence, decorrelation and LSB merge run on device
// (ops/alac_synth.py).  Layouts:
//   res_out  [max_subs, spf] int32   residual planes (raw samples for
//                                    uncompressed subframes)
//   sub_meta [max_subs, 8]   int32   (pair_slot, chan_in_pair, order,
//                                    shift, sample_size, count,
//                                    is_raw, 0)
//   qlp_out  [max_subs, 32]  int32
//   pair_meta[max_pairs, 8]  int32   (fs_channel_base, width,
//                                    lsb_bytes, ishift, lweight,
//                                    count, frameset_idx, 0)
//   lsb_out  [max_pairs, spf, 2] int32
//   fs_count [max_framesets] int32   PCM frames per frameset
//   info[0..4] = (n_subs, n_pairs, n_framesets, total_frames,
//                 consumed_bytes)
// Returns total PCM frames scanned or a negative error code.
int64_t atpu_alac_scan(const uint8_t* data,
                       int64_t len,
                       int32_t bps,
                       int32_t channels,
                       int32_t samples_per_frame,
                       int32_t initial_history,
                       int32_t history_multiplier,
                       int32_t maximum_k,
                       int64_t max_frames,
                       int64_t max_subs,
                       int32_t* res_out,
                       int32_t* sub_meta,
                       int32_t* qlp_out,
                       int32_t* pair_meta,
                       int32_t* lsb_out,
                       int32_t* fs_count,
                       int64_t* info) {
    using namespace alac;
    if (channels < 1 || channels > 8) return -30;
    DecOpts o{initial_history, history_multiplier, maximum_k};
    const int64_t spf = samples_per_frame;

    BitReader r(data, len);
    int64_t total = 0;
    int64_t n_subs = 0, n_pairs = 0, n_fs = 0;
    int64_t consumed = 0;

    int64_t save_subs = 0, save_pairs = 0;
    while (total < max_frames && r.byte_pos() < len) {
        // bail BEFORE a frameset that might not fit the batch
        if (n_subs + channels > max_subs) break;
        save_subs = n_subs;
        save_pairs = n_pairs;
        int fs_channels = 0;
        int64_t this_count = -1;
        int frame_channels = (int)r.get(3) + 1;
        if (r.error) break;
        while (frame_channels != 8) {
            const int width = frame_channels;
            if (fs_channels + width > channels)
                return (total > 0) ? -100 : -31;

            int32_t* pm = pair_meta + n_pairs * 8;
            int32_t* lsb_dst = lsb_out + n_pairs * spf * 2;

            r.get(16);
            const int has_count = (int)r.get(1);
            const int lsb_bytes = (int)r.get(2);
            const int uncompressed = (int)r.get(1);
            const int64_t count = has_count ? (int64_t)r.get(32)
                                            : spf;
            if (count > spf)
                return (total > 0) ? -100 : -32;

            int ishift = 0, lweight = 0;
            if (uncompressed) {
                for (int64_t i = 0; i < count; i++)
                    for (int c = 0; c < width; c++)
                        res_out[(n_subs + c) * spf + i] =
                            (int32_t)r.get_signed(bps);
                for (int c = 0; c < width; c++) {
                    int32_t* sm = sub_meta + (n_subs + c) * 8;
                    sm[0] = (int32_t)n_pairs;
                    sm[1] = c;
                    sm[2] = 0;                 // order
                    sm[3] = 0;                 // shift
                    sm[4] = bps;               // sample_size
                    sm[5] = (int32_t)count;
                    sm[6] = 1;                 // is_raw
                    sm[7] = 0;
                    for (int j = 0; j < 32; j++)
                        qlp_out[(n_subs + c) * 32 + j] = 0;
                }
                pm[2] = 0;                     // lsb_bytes (merged)
                pm[3] = 0;
                pm[4] = 0;                     // lweight 0 = pass
            } else {
                ishift = (int)r.get(8);
                lweight = (int)r.get(8);
                int order[2];
                int shift[2];
                for (int c = 0; c < width; c++) {
                    r.get(4);
                    shift[c] = (int)r.get(4);
                    r.get(3);
                    order[c] = (int)r.get(5);
                    if (order[c] > 32)
                        return (total > 0) ? -100 : -33;
                    for (int j = 0; j < 32; j++)
                        qlp_out[(n_subs + c) * 32 + j] = 0;
                    for (int j = 0; j < order[c]; j++)
                        qlp_out[(n_subs + c) * 32 + j] =
                            (int32_t)r.get_signed(16);
                }
                if (lsb_bytes > 0) {
                    for (int64_t i = 0; i < count; i++)
                        for (int c = 0; c < width; c++)
                            lsb_dst[i * 2 + c] =
                                (int32_t)r.get(lsb_bytes * 8);
                }
                const int sample_size = bps - lsb_bytes * 8 +
                                        width - 1;
                for (int c = 0; c < width; c++) {
                    if (!read_residuals(
                            r, o, sample_size, count,
                            res_out + (n_subs + c) * spf))
                        return (total > 0) ? -100 : -34;
                    int32_t* sm = sub_meta + (n_subs + c) * 8;
                    sm[0] = (int32_t)n_pairs;
                    sm[1] = c;
                    sm[2] = order[c];
                    sm[3] = shift[c];
                    sm[4] = sample_size;
                    sm[5] = (int32_t)count;
                    sm[6] = 0;
                    sm[7] = 0;
                }
                pm[2] = lsb_bytes;
                pm[3] = ishift;
                pm[4] = (width == 2) ? lweight : 0;
            }
            pm[0] = fs_channels;
            pm[1] = width;
            pm[5] = (int32_t)count;
            pm[6] = (int32_t)n_fs;
            pm[7] = 0;

            n_pairs++;
            n_subs += width;
            fs_channels += width;
            if (this_count < 0) this_count = count;
            else if (this_count != count)
                return (total > 0) ? -100 : -35;

            frame_channels = (int)r.get(3) + 1;
            if (r.error) goto done;   // truncated buffer
        }
        r.byte_align();
        if (fs_channels != channels)
            return (total > 0) ? -100 : -37;
        if (this_count < 0) break;
        if (total + this_count > max_frames ||
            r.error) {
            n_subs = save_subs;
            n_pairs = save_pairs;
            break;
        }
        fs_count[n_fs] = (int32_t)this_count;
        n_fs++;
        total += this_count;
        consumed = r.byte_pos();
        save_subs = n_subs;
        save_pairs = n_pairs;
    }
done:
    // a frameset interrupted mid-walk (truncated buffer jumps here)
    // must not leak its partial rows: roll back to the last COMPLETE
    // frameset's counters
    n_subs = save_subs;
    n_pairs = save_pairs;
    info[0] = n_subs;
    info[1] = n_pairs;
    info[2] = n_fs;
    info[3] = total;
    info[4] = consumed;
    return total;
}

int64_t atpu_alac_decode(const uint8_t* data,
                         int64_t len,
                         int32_t bps,
                         int32_t channels,
                         int32_t samples_per_frame,
                         int32_t initial_history,
                         int32_t history_multiplier,
                         int32_t maximum_k,
                         int64_t max_frames,
                         int32_t* out,
                         int64_t* consumed_bytes) {
    using namespace alac;
    if (channels < 1 || channels > 8) return -30;
    DecOpts o{initial_history, history_multiplier, maximum_k};

    static thread_local int32_t* chan_buf = nullptr;
    static thread_local int64_t chan_cap = 0;
    const int64_t needed = (int64_t)samples_per_frame * (channels + 2);
    if (needed > chan_cap) {
        delete[] chan_buf;
        chan_buf = new int32_t[needed * 2];
        chan_cap = needed;
    }
    static thread_local uint32_t* lsb_buf = nullptr;
    static thread_local int64_t lsb_cap = 0;
    const int64_t lsb_needed = (int64_t)samples_per_frame * channels;
    if (lsb_needed > lsb_cap) {
        delete[] lsb_buf;
        lsb_buf = new uint32_t[lsb_needed * 2];
        lsb_cap = lsb_needed;
    }

    BitReader r(data, len);
    int64_t total = 0;
    *consumed_bytes = 0;

    while (total < max_frames && r.byte_pos() < len) {
        // one frameset
        int32_t* frameset[8];
        int fs_channels = 0;
        int64_t fs_count = -1;

        int frame_channels = (int)r.get(3) + 1;
        if (r.error) break;
        while (frame_channels != 8) {
            const int width = frame_channels;
            if (fs_channels + width > channels)
                return (total > 0) ? total : -31;
            int32_t* ch0 = chan_buf +
                (int64_t)fs_channels * samples_per_frame;
            int32_t* ch1 = ch0 + samples_per_frame;

            r.get(16);
            const int has_count = (int)r.get(1);
            const int lsb_bytes = (int)r.get(2);
            const int uncompressed = (int)r.get(1);
            const int64_t count = has_count ? (int64_t)r.get(32)
                                            : samples_per_frame;
            if (count > samples_per_frame)
                return (total > 0) ? total : -32;

            if (uncompressed) {
                for (int64_t i = 0; i < count; i++)
                    for (int c = 0; c < width; c++)
                        (c == 0 ? ch0 : ch1)[i] =
                            (int32_t)r.get_signed(bps);
            } else {
                const int ishift = (int)r.get(8);
                const int lweight = (int)r.get(8);
                int32_t qlp[2][32];
                int order[2];
                int shift[2];
                for (int c = 0; c < width; c++) {
                    r.get(4);
                    shift[c] = (int)r.get(4);
                    r.get(3);
                    order[c] = (int)r.get(5);
                    if (order[c] > 32)
                        return (total > 0) ? total : -33;
                    for (int j = 0; j < order[c]; j++)
                        qlp[c][j] = (int32_t)r.get_signed(16);
                }
                if (lsb_bytes > 0)
                    for (int64_t i = 0; i < count * width; i++)
                        lsb_buf[i] = (uint32_t)r.get(lsb_bytes * 8);
                const int sample_size = bps - lsb_bytes * 8 +
                                        width - 1;
                for (int c = 0; c < width; c++) {
                    int32_t* dst = (c == 0) ? ch0 : ch1;
                    if (!read_residuals(r, o, sample_size, count,
                                        dst))
                        return (total > 0) ? total : -34;
                    decode_subframe(qlp[c], order[c], shift[c],
                                    sample_size, dst, count);
                }
                if (width == 2 && lweight != 0) {
                    for (int64_t i = 0; i < count; i++) {
                        const int64_t right = ch0[i] -
                            (((int64_t)ch1[i] * lweight) >> ishift);
                        ch0[i] = (int32_t)(ch1[i] + right);
                        ch1[i] = (int32_t)right;
                    }
                }
                if (lsb_bytes > 0) {
                    const int ls = lsb_bytes * 8;
                    for (int c = 0; c < width; c++) {
                        int32_t* dst = (c == 0) ? ch0 : ch1;
                        for (int64_t i = 0; i < count; i++)
                            dst[i] = (int32_t)(((int64_t)dst[i] << ls) |
                                               lsb_buf[i * width + c]);
                    }
                }
            }

            for (int c = 0; c < width; c++)
                frameset[fs_channels + c] =
                    (c == 0 ? ch0 : ch1);
            fs_channels += width;
            if (fs_count < 0) fs_count = count;
            else if (fs_count != count)
                return (total > 0) ? total : -35;

            frame_channels = (int)r.get(3) + 1;
            if (r.error) return total;   // truncated buffer
        }
        r.byte_align();
        if (fs_channels != channels)
            return (total > 0) ? total : -37;
        if (fs_count < 0) break;
        if (total + fs_count > max_frames) break;

        // reorder ALAC frameset channels into wave order
        const int* order_tbl = WAVE_ORDER_TBL[channels];
        int32_t* dst = out + total * channels;
        for (int c = 0; c < channels; c++) {
            const int32_t* src = frameset[order_tbl[c]];
            for (int64_t i = 0; i < fs_count; i++)
                dst[i * channels + c] = src[i];
        }
        if (r.error) return total;       // truncated buffer
        total += fs_count;
        *consumed_bytes = r.byte_pos();
    }
    return total;
}

}  // extern "C"


// ======================================================================
// TTA (True Audio) — host codec kernels.
//
// Role of reference src/encoders/tta.c / src/decoders/tta.c (spec:
// audiotools/py_encoders/tta.py, py_decoders/tta.py, mirrored by
// audiotools_tpu/ref/tta.py).  The hybrid filter, fixed predictor and
// two-level adaptive Rice coder are all per-sample recurrences with
// 32-bit wraparound — host-serial by nature.  TTA bitstreams are
// little-endian (LSB-first).

namespace tta {

static const uint32_t* crc32_table() {
    static uint32_t table[256];
    static bool done = false;
    if (!done) {
        for (uint32_t b = 0; b < 256; b++) {
            uint32_t c = b;
            for (int i = 0; i < 8; i++)
                c = (c & 1) ? (0xEDB88320u ^ (c >> 1)) : (c >> 1);
            table[b] = c;
        }
        done = true;
    }
    return table;
}

static uint32_t crc32_buf(const uint8_t* p, int64_t n) {
    const uint32_t* table = crc32_table();
    uint32_t crc = 0xFFFFFFFFu;
    for (int64_t i = 0; i < n; i++)
        crc = table[(crc ^ p[i]) & 0xFF] ^ (crc >> 8);
    return crc ^ 0xFFFFFFFFu;
}

// Bytes at or past `limit` are counted, not written, and set
// `overflow`: a frame's size has no useful bound (a loud sample at the
// start of a frame, before the Rice parameters adapt, takes up to
// 2^32 >> 10 unary bits), so the callers take the buffer's capacity
// and report -54 when it is too small, where the reference writes past
// its buffer.
struct LEWriter {
    uint8_t* out;
    int64_t pos;
    int64_t limit;
    uint64_t acc = 0;
    int bits = 0;
    bool overflow = false;
    LEWriter(uint8_t* buffer, int64_t start, int64_t capacity)
        : out(buffer), pos(start), limit(capacity) {}
    inline void put(uint64_t value, int nbits) {
        acc |= (value & ((nbits >= 64) ? ~0ULL
                                       : ((1ULL << nbits) - 1)))
               << bits;
        bits += nbits;
        while (bits >= 8) {
            if (__builtin_expect(pos < limit, 1)) out[pos] = (uint8_t)acc;
            else overflow = true;
            pos++;
            acc >>= 8;
            bits -= 8;
        }
    }
    inline void put_unary1(uint32_t value) {
        // value one-bits then a zero bit
        while (value >= 32) {
            put(0xFFFFFFFFu, 32);
            value -= 32;
        }
        put((1ULL << value) - 1, value + 1);
    }
    inline void byte_align() {
        if (bits) {
            if (pos < limit) out[pos] = (uint8_t)acc;
            else overflow = true;
            pos++;
            acc = 0;
            bits = 0;
        }
    }

    // byte-aligns and appends the CRC-32 of [start, pos); false when
    // the frame did not fit the buffer
    inline bool finish_frame(int64_t start) {
        byte_align();
        if (overflow || pos + 4 > limit) return false;
        const uint32_t crc = crc32_buf(out + start, pos - start);
        for (int k = 0; k < 4; k++) out[pos++] = (uint8_t)(crc >> (8 * k));
        return true;
    }
};

struct LEReader {
    const uint8_t* data;
    int64_t len;
    int64_t pos = 0;
    uint64_t acc = 0;
    int bits = 0;
    bool error = false;
    LEReader(const uint8_t* d, int64_t n) : data(d), len(n) {}
    // bulk refill: one 8-byte little-endian load appends every whole
    // byte that fits (vs the byte-at-a-time feed loop, which costs a
    // loop iteration per byte on the residual-decode hot path)
    inline void refill_bulk() {
        if (__builtin_expect(pos + 8 <= len, 1)) {
            const int take = (64 - bits) >> 3;
            if (take) {
                uint64_t w;
                memcpy(&w, data + pos, 8);
                const int tb = take * 8;
                if (tb < 64) w &= (1ULL << tb) - 1;
                acc |= w << bits;
                pos += take;
                bits += tb;
            }
        }
    }
    inline uint64_t get(int nbits) {
        if (__builtin_expect(bits < nbits, 0)) {
            refill_bulk();
            while (bits < nbits) {
                if (pos >= len) { error = true; return 0; }
                acc |= ((uint64_t)data[pos++]) << bits;
                bits += 8;
            }
        }
        const uint64_t v = acc & ((nbits >= 64) ? ~0ULL
                                                : ((1ULL << nbits) - 1));
        acc = (nbits >= 64) ? 0 : (acc >> nbits);
        bits -= nbits;
        return v;
    }
    inline uint32_t unary1() {
        // counts one-bits before the next zero bit
        uint32_t count = 0;
        for (;;) {
            if (bits == 0) {
                refill_bulk();
                if (bits == 0) {
                    if (pos >= len) { error = true; return count; }
                    acc = data[pos++];
                    bits = 8;
                }
            }
            if ((acc & 1) == 0) {
                acc >>= 1;
                bits -= 1;
                return count;
            }
            // count trailing ones (bits may be up to 64 after a bulk
            // refill: guard ~acc == 0 AND the tz+1 == 64 shift, which
            // is UB and leaves acc unshifted on x86)
            const uint64_t inv = ~acc;
            if (inv == 0 || __builtin_ctzll(inv) >= bits) {
                count += bits;
                acc = 0;
                bits = 0;
            } else {
                const int tz = __builtin_ctzll(inv);
                count += tz;
                acc = (tz + 1 >= 64) ? 0 : (acc >> (tz + 1));
                bits -= (tz + 1);
                return count;
            }
        }
    }
    inline void byte_align() {
        // drop only the partial byte: bulk refills may have whole
        // unread bytes buffered in acc
        const int drop = bits & 7;
        acc >>= drop;
        bits -= drop;
    }
    inline int64_t byte_pos() const { return pos - bits / 8; }
};

static inline int shift_for(int bps) { return (bps == 8) ? 4 : 5; }
static inline int fshift_for(int bps) { return (bps == 16) ? 9 : 10; }

struct Filter {
    int32_t qm[8] = {0};
    int32_t dx[8] = {0};
    int32_t dl[8] = {0};
    int32_t prev_res = 0;

    // shared state stepping for encode (residual from p) and decode
    // (p from residual); ref/tta.py tta_filter/tta_unfilter
    inline void adapt() {
        if (prev_res < 0)
            for (int j = 0; j < 8; j++) qm[j] -= dx[j];
        else if (prev_res > 0)
            for (int j = 0; j < 8; j++) qm[j] += dx[j];
    }
    inline int32_t dot(int round_v) const {
        int64_t sum = round_v;
        for (int j = 0; j < 8; j++)
            sum += (int64_t)dl[j] * qm[j];
        return (int32_t)(uint32_t)sum;     // 32-bit wraparound
    }
    inline void shift_state(int32_t p) {
        dx[0] = dx[1]; dx[1] = dx[2]; dx[2] = dx[3]; dx[3] = dx[4];
        dx[4] = (dl[4] >= 0) ? 1 : -1;
        dx[5] = (dl[5] >= 0) ? 2 : -2;
        dx[6] = (dl[6] >= 0) ? 2 : -2;
        dx[7] = (dl[7] >= 0) ? 4 : -4;
        const int32_t d7 = p - dl[7];
        const int32_t d6 = -dl[6] + d7;
        const int32_t d5 = -dl[5] + d6;
        dl[0] = dl[1]; dl[1] = dl[2]; dl[2] = dl[3]; dl[3] = dl[4];
        dl[4] = d5; dl[5] = d6; dl[6] = d7; dl[7] = p;
    }
};

struct Rice {
    int k0 = 10, k1 = 10;
    int64_t sum0 = 1 << 14, sum1 = 1 << 14;
};

}  // namespace tta

extern "C" {

// Encodes TTA frames from interleaved PCM.
//
// samples: int32 [total_frames, channels]; frame_sizes: PCM frames
// per TTA frame.  Writes each frame's payload + little-endian CRC-32
// to out (out_cap bytes); out_ends holds cumulative byte offsets.
// Returns the bytes written, -50 for more than 8 channels, or -54 when
// out_cap is too small (the port's repair: the reference takes no
// capacity and writes past a buffer sized at bps / 8 + 2 bytes a
// sample, which a short loud 24-bit frame exceeds).
int64_t atpu_tta_encode_frames(const int32_t* samples,
                               const int32_t* frame_sizes,
                               int64_t n_tta_frames,
                               int32_t channels,
                               int32_t bps,
                               uint8_t* out,
                               int64_t out_cap,
                               int64_t* out_ends) {
    using namespace tta;
    if (channels > 8) return -50;
    const int shift = shift_for(bps);
    const int fshift = fshift_for(bps);
    const int32_t round_v = 1 << (fshift - 1);

    static thread_local int32_t* cor = nullptr;
    static thread_local int64_t cor_cap = 0;

    int64_t sample_pos = 0;
    int64_t out_pos = 0;
    for (int64_t f = 0; f < n_tta_frames; f++) {
        const int64_t n = frame_sizes[f];
        if (n * channels > cor_cap) {
            delete[] cor;
            cor = new int32_t[n * channels * 2];
            cor_cap = n * channels;
        }
        const int32_t* pcm = samples + sample_pos * channels;

        // channel decorrelation (ref/tta.py correlate_channels)
        if (channels == 1) {
            for (int64_t i = 0; i < n; i++) cor[i] = pcm[i];
        } else {
            for (int64_t i = 0; i < n; i++) {
                const int32_t* row = pcm + i * channels;
                int32_t* crow = cor + i * channels;
                for (int c = 0; c < channels - 1; c++)
                    crow[c] = row[c + 1] - row[c];
                const int32_t prev = crow[channels - 2];
                const int32_t half = (prev >= 0) ? (prev / 2)
                                                 : -((-prev) / 2);
                crow[channels - 1] = row[channels - 1] - half;
            }
        }

        LEWriter w(out, out_pos, out_cap);
        Filter filt[8];
        Rice rice[8];
        int32_t prev_cor[8] = {0};   // for the fixed predictor

        for (int64_t i = 0; i < n; i++) {
            for (int c = 0; c < channels; c++) {
                const int32_t x = cor[i * channels + c];
                // fixed predictor
                int32_t predicted;
                if (i == 0) {
                    predicted = x;
                } else {
                    const int32_t prev = prev_cor[c];
                    predicted = x -
                        (int32_t)((((int64_t)prev << shift) - prev) >>
                                  shift);
                }
                prev_cor[c] = x;

                // hybrid adaptive filter
                Filter& ft = filt[c];
                int32_t residual;
                if (i == 0) {
                    residual = predicted + (round_v >> fshift);
                } else {
                    ft.adapt();
                    residual = predicted - (ft.dot(round_v) >> fshift);
                }
                ft.prev_res = residual;
                ft.shift_state(predicted);

                // two-level adaptive Rice
                Rice& rc = rice[c];
                const uint32_t unsigned_v = (residual > 0)
                    ? (uint32_t)(residual * 2 - 1)
                    : (uint32_t)(-residual) * 2;
                if (unsigned_v < (1u << rc.k0)) {
                    w.put(0, 1);
                    w.put(unsigned_v, rc.k0);
                } else {
                    const uint32_t shifted = unsigned_v -
                        (1u << rc.k0);
                    const uint32_t msb = 1 + (shifted >> rc.k1);
                    const uint32_t lsb = shifted -
                        ((msb - 1) << rc.k1);
                    w.put_unary1(msb);
                    w.put(lsb, rc.k1);
                    rc.sum1 += shifted - (rc.sum1 >> 4);
                    if (rc.sum1 < (1LL << (rc.k1 + 4))) {
                        if (rc.k1 > 0) rc.k1 -= 1;
                    } else if (rc.sum1 > (1LL << (rc.k1 + 5))) {
                        rc.k1 += 1;
                    }
                }
                rc.sum0 += unsigned_v - (rc.sum0 >> 4);
                if (rc.sum0 < (1LL << (rc.k0 + 4))) {
                    if (rc.k0 > 0) rc.k0 -= 1;
                } else if (rc.sum0 > (1LL << (rc.k0 + 5))) {
                    rc.k0 += 1;
                }
            }
        }
        if (!w.finish_frame(out_pos)) return -54;
        out_pos = w.pos;
        out_ends[f] = out_pos;
        sample_pos += n;
    }
    return out_pos;
}

// Packs PRECOMPUTED TTA residuals (the device analysis path,
// ATPU_TTA_BACKEND=jax: ops/tta_scan.py runs the decorrelation +
// fixed predictor + hybrid adaptive filter as batched scans and this
// kernel serializes them) with the two-level adaptive Rice coder and
// per-frame CRC-32 — the byte-serial tail of atpu_tta_encode_frames.
//
// residuals: int32 [total_frames, channels] filter output in frame
// order; frame_sizes: PCM frames per TTA frame.  Byte-identical to
// the fused encoder for identical residuals.  out_cap and the return
// codes as atpu_tta_encode_frames's.
int64_t atpu_tta_pack_frames(const int32_t* residuals,
                             const int32_t* frame_sizes,
                             int64_t n_tta_frames,
                             int32_t channels,
                             uint8_t* out,
                             int64_t out_cap,
                             int64_t* out_ends) {
    using namespace tta;
    if (channels > 8) return -50;
    int64_t sample_pos = 0;
    int64_t out_pos = 0;
    for (int64_t f = 0; f < n_tta_frames; f++) {
        const int64_t n = frame_sizes[f];
        const int32_t* res = residuals + sample_pos * channels;
        LEWriter w(out, out_pos, out_cap);
        Rice rice[8];
        for (int64_t i = 0; i < n; i++) {
            for (int c = 0; c < channels; c++) {
                const int32_t residual = res[i * channels + c];
                Rice& rc = rice[c];
                const uint32_t unsigned_v = (residual > 0)
                    ? (uint32_t)(residual * 2 - 1)
                    : (uint32_t)(-residual) * 2;
                if (unsigned_v < (1u << rc.k0)) {
                    w.put(0, 1);
                    w.put(unsigned_v, rc.k0);
                } else {
                    const uint32_t shifted = unsigned_v -
                        (1u << rc.k0);
                    const uint32_t msb = 1 + (shifted >> rc.k1);
                    const uint32_t lsb = shifted -
                        ((msb - 1) << rc.k1);
                    w.put_unary1(msb);
                    w.put(lsb, rc.k1);
                    rc.sum1 += shifted - (rc.sum1 >> 4);
                    if (rc.sum1 < (1LL << (rc.k1 + 4))) {
                        if (rc.k1 > 0) rc.k1 -= 1;
                    } else if (rc.sum1 > (1LL << (rc.k1 + 5))) {
                        rc.k1 += 1;
                    }
                }
                rc.sum0 += unsigned_v - (rc.sum0 >> 4);
                if (rc.sum0 < (1LL << (rc.k0 + 4))) {
                    if (rc.k0 > 0) rc.k0 -= 1;
                } else if (rc.sum0 > (1LL << (rc.k0 + 5))) {
                    rc.k0 += 1;
                }
            }
        }
        if (!w.finish_frame(out_pos)) return -54;
        out_pos = w.pos;
        out_ends[f] = out_pos;
        sample_pos += n;
    }
    return out_pos;
}

// Decodes one TTA frame of n PCM frames; returns bytes consumed or a
// negative error code.
int64_t atpu_tta_decode_frame(const uint8_t* data,
                              int64_t len,
                              int64_t n,
                              int32_t channels,
                              int32_t bps,
                              int32_t* out,
                              int32_t verify_crc) {
    using namespace tta;
    if (channels > 8) return -50;
    const int shift = shift_for(bps);
    const int fshift = fshift_for(bps);
    const int32_t round_v = 1 << (fshift - 1);

    LEReader r(data, len);
    Filter filt[8];
    Rice rice[8];
    int32_t prev_out[8] = {0};

    for (int64_t i = 0; i < n; i++) {
        for (int c = 0; c < channels; c++) {
            Rice& rc = rice[c];
            const uint32_t msb = r.unary1();
            uint32_t unsigned_v;
            if (msb == 0) {
                unsigned_v = (uint32_t)r.get(rc.k0);
            } else {
                const uint32_t lsb = (uint32_t)r.get(rc.k1);
                const uint32_t shifted = ((msb - 1) << rc.k1) | lsb;
                unsigned_v = shifted + (1u << rc.k0);
                rc.sum1 += shifted - (rc.sum1 >> 4);
                if (rc.sum1 < (1LL << (rc.k1 + 4))) {
                    if (rc.k1 > 0) rc.k1 -= 1;
                } else if (rc.sum1 > (1LL << (rc.k1 + 5))) {
                    rc.k1 += 1;
                }
            }
            const int32_t residual = (unsigned_v & 1)
                ? (int32_t)((unsigned_v + 1) >> 1)
                : -(int32_t)(unsigned_v >> 1);
            rc.sum0 += unsigned_v - (rc.sum0 >> 4);
            if (rc.sum0 < (1LL << (rc.k0 + 4))) {
                if (rc.k0 > 0) rc.k0 -= 1;
            } else if (rc.sum0 > (1LL << (rc.k0 + 5))) {
                rc.k0 += 1;
            }
            if (r.error) return -51;

            // inverse hybrid filter
            Filter& ft = filt[c];
            int32_t predicted;
            if (i == 0) {
                predicted = residual - (round_v >> fshift);
            } else {
                ft.adapt();
                predicted = residual + (ft.dot(round_v) >> fshift);
            }
            ft.prev_res = residual;
            ft.shift_state(predicted);

            // inverse fixed predictor
            int32_t x;
            if (i == 0) {
                x = predicted;
            } else {
                const int32_t prev = prev_out[c];
                x = predicted +
                    (int32_t)((((int64_t)prev << shift) - prev) >>
                              shift);
            }
            prev_out[c] = x;
            out[i * channels + c] = x;
        }
    }
    r.byte_align();
    const int64_t payload = r.byte_pos();
    if (payload + 4 > len) return -52;
    if (verify_crc) {
        const uint32_t expected = crc32_buf(data, payload);
        const uint32_t stored = (uint32_t)data[payload] |
            ((uint32_t)data[payload + 1] << 8) |
            ((uint32_t)data[payload + 2] << 16) |
            ((uint32_t)data[payload + 3] << 24);
        if (expected != stored) return -53;
    }

    // inverse channel decorrelation
    if (channels > 1) {
        for (int64_t i = 0; i < n; i++) {
            int32_t* row = out + i * channels;
            const int32_t prev = row[channels - 2];
            const int32_t half = (prev >= 0) ? (prev / 2)
                                             : -((-prev) / 2);
            row[channels - 1] += half;
            for (int c = channels - 2; c >= 0; c--)
                row[c] = row[c + 1] - row[c];
        }
    }
    return payload + 4;
}

// Residual-only entropy unpack of concatenated TTA frames for the
// DEVICE decode path (ATPU_TTA_DEC_BACKEND=jax): runs the two-level
// adaptive Rice decoder (whose k0/k1 adaptation depends only on the
// unsigned values, never on the filter) and the per-frame CRC-32,
// WITHOUT the hybrid filter / fixed predictor / decorrelation — the
// device inverts those as one fused scan (ops/tta_synth.py).
// Reference per-sample loop: src/decoders/tta.c:849.
//
// data: concatenated frame bytes; frame_lens: bytes per frame;
// frame_sizes: PCM frames per frame; out: int32 [total, channels].
int64_t atpu_tta_scan_residuals(const uint8_t* data,
                                int64_t len,
                                const int64_t* frame_lens,
                                const int32_t* frame_sizes,
                                int64_t n_tta_frames,
                                int32_t channels,
                                int32_t* out,
                                int32_t verify_crc) {
    using namespace tta;
    if (channels > 8) return -50;
    int64_t byte_pos = 0;
    int64_t sample_pos = 0;
    for (int64_t f = 0; f < n_tta_frames; f++) {
        const int64_t n = frame_sizes[f];
        const int64_t flen = frame_lens[f];
        if (byte_pos + flen > len) return -52;
        LEReader r(data + byte_pos, flen);
        Rice rice[8];
        int32_t* res_out = out + sample_pos * channels;
        for (int64_t i = 0; i < n; i++) {
            for (int c = 0; c < channels; c++) {
                Rice& rc = rice[c];
                const uint32_t msb = r.unary1();
                uint32_t unsigned_v;
                if (msb == 0) {
                    unsigned_v = (uint32_t)r.get(rc.k0);
                } else {
                    const uint32_t lsb = (uint32_t)r.get(rc.k1);
                    const uint32_t shifted =
                        ((msb - 1) << rc.k1) | lsb;
                    unsigned_v = shifted + (1u << rc.k0);
                    rc.sum1 += shifted - (rc.sum1 >> 4);
                    if (rc.sum1 < (1LL << (rc.k1 + 4))) {
                        if (rc.k1 > 0) rc.k1 -= 1;
                    } else if (rc.sum1 > (1LL << (rc.k1 + 5))) {
                        rc.k1 += 1;
                    }
                }
                res_out[i * channels + c] = (unsigned_v & 1)
                    ? (int32_t)((unsigned_v + 1) >> 1)
                    : -(int32_t)(unsigned_v >> 1);
                rc.sum0 += unsigned_v - (rc.sum0 >> 4);
                if (rc.sum0 < (1LL << (rc.k0 + 4))) {
                    if (rc.k0 > 0) rc.k0 -= 1;
                } else if (rc.sum0 > (1LL << (rc.k0 + 5))) {
                    rc.k0 += 1;
                }
                if (r.error) return -51;
            }
        }
        r.byte_align();
        const int64_t payload = r.byte_pos();
        if (payload + 4 > flen) return -52;
        if (verify_crc) {
            const uint32_t expected = crc32_buf(data + byte_pos,
                                                payload);
            const uint32_t stored =
                (uint32_t)data[byte_pos + payload] |
                ((uint32_t)data[byte_pos + payload + 1] << 8) |
                ((uint32_t)data[byte_pos + payload + 2] << 16) |
                ((uint32_t)data[byte_pos + payload + 3] << 24);
            if (expected != stored) return -53;
        }
        byte_pos += flen;
        sample_pos += n;
    }
    return sample_pos;
}

}  // extern "C"


// ======================================================================
// Shorten (SHN v2) — host codec kernels.
//
// Role of reference src/encoders/shn.c / src/decoders/shn.c (spec:
// audiotools/py_encoders/shn.py, py_decoders/shn.py, mirrored by
// audiotools_tpu/ref/shn.py): diff1-3 predictors chosen by absolute
// delta sums, unary/Rice "energy" coding, VERBATIM container chunks,
// ZERO blocks, BITSHIFT commands, MSB-first bitstream.

namespace shn {

enum {
    FN_DIFF0 = 0, FN_DIFF1, FN_DIFF2, FN_DIFF3, FN_QUIT,
    FN_BLOCKSIZE, FN_BITSHIFT, FN_QLPC, FN_ZERO, FN_VERBATIM
};

static inline void put_unsigned(BitWriter& w, int size,
                                uint64_t value) {
    const uint64_t msb = value >> size;
    const uint64_t lsb = value - (msb << size);
    // msb zero bits, a one bit, then size LSBs
    w.put((1ULL << size) | lsb, (int64_t)msb + 1 + size);
}

static inline void put_signed(BitWriter& w, int size, int64_t value) {
    if (value >= 0)
        put_unsigned(w, size + 1, (uint64_t)(value * 2));
    else
        put_unsigned(w, size + 1, (uint64_t)((-value - 1) * 2 + 1));
}

static inline void put_long(BitWriter& w, uint64_t value) {
    if (value == 0) {
        put_unsigned(w, 2, 0);
        put_unsigned(w, 0, 0);
    } else {
        int bits = 64 - __builtin_clzll(value);
        put_unsigned(w, 2, bits);
        put_unsigned(w, bits, value);
    }
}

static inline uint64_t get_unsigned(BitReader& r, int size) {
    uint64_t msb = 0;
    while (!r.error && r.get(1) == 0) msb++;
    return (msb << size) | r.get(size);
}

static inline int64_t get_signed(BitReader& r, int size) {
    const uint64_t u = get_unsigned(r, size + 1);
    return (u & 1) ? -((int64_t)(u >> 1)) - 1 : (int64_t)(u >> 1);
}

static inline uint64_t get_long(BitReader& r) {
    const int bits = (int)get_unsigned(r, 2);
    return get_unsigned(r, bits);
}

}  // namespace shn

extern "C" {

// Encodes a complete Shorten stream from interleaved PCM.
// samples: int32 [n, ch]; returns total bytes or negative error.
// decisions: optional per-(block, channel) analysis steering array
// ([nblocks * channels * 4] int32 rows [zero, wasted, diff, energy]
// in block-major walk order, from ops/shn_scan.py device analysis);
// nullptr computes decisions inline (the all-host path).  Residuals
// are always re-derived exactly from the samples either way.
int64_t atpu_shn_encode2(const int32_t* samples,
                         int64_t n,
                         int32_t channels,
                         int32_t bps,
                         int32_t signed_samples,
                         int32_t is_big_endian,
                         const uint8_t* header_data,
                         int64_t header_len,
                         const uint8_t* footer_data,
                         int64_t footer_len,
                         int32_t block_size,
                         const int32_t* decisions,
                         uint8_t* out) {
    using namespace shn;
    if (channels > 64) return -60;

    BitWriter w(out, 0);
    w.put(0x616A6B67, 32);       // "ajkg"
    w.put(2, 8);
    const int64_t magic_bytes = 5;

    int file_type;
    int32_t sign_adjustment = 0;
    if (bps == 8) {
        file_type = signed_samples ? 1 : 2;
        if (!signed_samples) sign_adjustment = 1 << 7;
    } else if (bps == 16) {
        if (signed_samples) file_type = is_big_endian ? 3 : 5;
        else file_type = is_big_endian ? 4 : 6;
        if (!signed_samples) sign_adjustment = 1 << 15;
    } else {
        return -61;
    }
    put_long(w, file_type);
    put_long(w, channels);
    put_long(w, block_size);
    put_long(w, 0);              // max LPC
    put_long(w, 0);              // mean count
    put_long(w, 0);              // bytes to skip

    put_unsigned(w, 2, FN_VERBATIM);
    put_unsigned(w, 5, (uint64_t)header_len);
    for (int64_t i = 0; i < header_len; i++)
        put_unsigned(w, 8, header_data[i]);

    // per-channel warm-up history (last 3 shifted samples)
    static thread_local int64_t* hist = nullptr;
    static thread_local int64_t hist_cap = 0;
    if (channels * 3 > hist_cap) {
        delete[] hist;
        hist = new int64_t[channels * 3 * 2];
        hist_cap = channels * 3;
    }
    for (int i = 0; i < channels * 3; i++) hist[i] = 0;
    bool has_hist = false;

    int left_shift = 0;
    int64_t pos = 0;
    int64_t block_index = 0;
    int64_t current_block = block_size;
    while (pos < n) {
        const int64_t m = (n - pos < current_block) ? (n - pos)
                                                    : current_block;
        if (m != current_block) {
            current_block = m;
            put_unsigned(w, 2, FN_BLOCKSIZE);
            put_long(w, (uint64_t)m);
        }
        for (int c = 0; c < channels; c++) {
            const int32_t* dec = decisions
                ? decisions + (block_index * channels + c) * 4
                : nullptr;
            // gather channel block (sign-adjusted)
            bool all_zero;
            int32_t or_all = 0;
            if (dec) {
                all_zero = dec[0] != 0;
            } else {
                all_zero = true;
                for (int64_t i = 0; i < m; i++) {
                    const int32_t v =
                        samples[(pos + i) * channels + c] +
                        sign_adjustment;
                    if (v != 0) all_zero = false;
                    or_all |= v;
                }
            }
            int64_t* h = hist + c * 3;
            if (all_zero) {
                put_unsigned(w, 2, FN_ZERO);
                h[0] = h[1] = h[2] = 0;
                continue;
            }
            // wasted bits
            int wasted = 0;
            if (dec) {
                wasted = dec[1];
            } else if (or_all != 0) {
                wasted = __builtin_ctz((uint32_t)or_all);
            }
            if (wasted != left_shift) {
                put_unsigned(w, 2, FN_BITSHIFT);
                put_unsigned(w, 2, (uint64_t)wasted);
                left_shift = wasted;
            }

            // best diff order by absolute delta sums (full includes
            // the previous 3 shifted samples, or zeros at start)
            int64_t prev3[3] = {h[0], h[1], h[2]};
            if (!has_hist && pos == 0) {
                prev3[0] = prev3[1] = prev3[2] = 0;
            }
            int diff;
            int energy;
            if (dec) {
                diff = dec[2];
                energy = dec[3];
                if (diff < 1 || diff > 3 || energy < 0 || energy > 31)
                    return -62;
            } else {
            // sums over the block-length suffix of each delta level
            int64_t s1 = 0, s2 = 0, s3 = 0;
            {
                int64_t p0 = prev3[0], p1 = prev3[1], p2 = prev3[2];
                // carry deltas across the boundary
                int64_t d1a = p1 - p0, d1b = p2 - p1;
                int64_t d2a = d1b - d1a;
                int64_t prev = p2, prevd1 = d1b, prevd2 = d2a;
                for (int64_t i = 0; i < m; i++) {
                    const int64_t x =
                        (int64_t)(samples[(pos + i) * channels + c] +
                                  sign_adjustment) >> left_shift;
                    const int64_t d1 = x - prev;
                    const int64_t d2 = d1 - prevd1;
                    const int64_t d3 = d2 - prevd2;
                    s1 += (d1 < 0) ? -d1 : d1;
                    s2 += (d2 < 0) ? -d2 : d2;
                    s3 += (d3 < 0) ? -d3 : d3;
                    prev = x;
                    prevd1 = d1;
                    prevd2 = d2;
                }
            }
            if (s1 < s2 && s1 < s3) diff = 1;
            else if (s2 < s3) diff = 2;
            else diff = 3;

            // energy: smallest e with (m << e) >= sum(|residuals|)
            const int64_t abs_sum = (diff == 1) ? s1 :
                                    (diff == 2) ? s2 : s3;
            energy = 0;
            while ((m << energy) < abs_sum) energy++;
            }

            put_unsigned(w, 2, (uint64_t)(FN_DIFF0 + diff));
            put_unsigned(w, 3, (uint64_t)energy);

            // emit residuals of the chosen order
            {
                int64_t p0 = prev3[0], p1 = prev3[1], p2 = prev3[2];
                int64_t d1a = p1 - p0, d1b = p2 - p1;
                int64_t d2a = d1b - d1a;
                int64_t prev = p2, prevd1 = d1b, prevd2 = d2a;
                for (int64_t i = 0; i < m; i++) {
                    const int64_t x =
                        (int64_t)(samples[(pos + i) * channels + c] +
                                  sign_adjustment) >> left_shift;
                    const int64_t d1 = x - prev;
                    const int64_t d2 = d1 - prevd1;
                    const int64_t d3 = d2 - prevd2;
                    put_signed(w, energy,
                               (diff == 1) ? d1 :
                               (diff == 2) ? d2 : d3);
                    prev = x;
                    prevd1 = d1;
                    prevd2 = d2;
                }
            }
            // update history: last 3 shifted samples of THIS
            // block, front-padded with zeros when the block is short
            // (the oracle re-derives history from the current block
            // only)
            for (int j = 0; j < 3; j++) {
                const int64_t idx = m - 3 + j;
                h[j] = (idx >= 0)
                    ? ((int64_t)(samples[(pos + idx) * channels + c] +
                                 sign_adjustment) >> left_shift)
                    : 0;
            }
        }
        has_hist = true;
        pos += m;
        block_index++;
    }

    if (footer_len > 0) {
        put_unsigned(w, 2, FN_VERBATIM);
        put_unsigned(w, 5, (uint64_t)footer_len);
        for (int64_t i = 0; i < footer_len; i++)
            put_unsigned(w, 8, footer_data[i]);
    }
    put_unsigned(w, 2, FN_QUIT);
    w.byte_align();
    // pad the post-magic section to a 4-byte multiple
    int64_t payload = w.pos - magic_bytes;
    while (payload % 4) {
        out[w.pos++] = 0;
        payload++;
    }
    return w.pos;
}

int64_t atpu_shn_encode(const int32_t* samples,
                        int64_t n,
                        int32_t channels,
                        int32_t bps,
                        int32_t signed_samples,
                        int32_t is_big_endian,
                        const uint8_t* header_data,
                        int64_t header_len,
                        const uint8_t* footer_data,
                        int64_t footer_len,
                        int32_t block_size,
                        uint8_t* out) {
    return atpu_shn_encode2(samples, n, channels, bps, signed_samples,
                            is_big_endian, header_data, header_len,
                            footer_data, footer_len, block_size,
                            nullptr, out);
}

// Decodes a complete Shorten stream into interleaved int32 samples.
// Fills info[0..3] = (channels, file_type, block_size, left-over) and
// returns PCM frames decoded or a negative error code.
int64_t atpu_shn_decode(const uint8_t* data,
                        int64_t len,
                        int64_t max_frames,
                        int32_t* out,
                        int64_t* info) {
    using namespace shn;
    BitReader r(data, len);
    if (r.get(32) != 0x616A6B67 || r.get(8) != 2) return -62;
    const int file_type = (int)get_long(r);
    const int channels = (int)get_long(r);
    int64_t block_size = (int64_t)get_long(r);
    const int max_lpc = (int)get_long(r);
    const int n_means = (int)get_long(r);
    const int64_t skip = (int64_t)get_long(r);
    if (channels < 1 || channels > 64) return -63;
    if (r.error) return -64;
    for (int64_t i = 0; i < skip; i++) get_unsigned(r, 8);

    int bps;
    int32_t sign_adjustment = 0;
    switch (file_type) {
    case 1: bps = 8; break;
    case 2: bps = 8; sign_adjustment = 1 << 7; break;
    case 3: case 5: bps = 16; break;
    case 4: case 6: bps = 16; sign_adjustment = 1 << 15; break;
    default: return -65;
    }

    const int wrap = (max_lpc > 3) ? max_lpc : 3;
    static thread_local int64_t* state = nullptr;
    static thread_local int64_t state_cap = 0;
    const int64_t need = (int64_t)channels * (wrap + 32);
    if (need > state_cap) {
        delete[] state;
        state = new int64_t[need * 2];
        state_cap = need;
    }
    for (int64_t i = 0; i < need; i++) state[i] = 0;
    // per channel: wrap history ring [wrap] + means [n_means]
    static thread_local int64_t* blockbuf = nullptr;
    static thread_local int64_t block_cap = 0;

    int left_shift = 0;
    int64_t frames = 0;
    int chan = 0;

    while (!r.error) {
        const int command = (int)get_unsigned(r, 2);
        if (r.error) return -66;
        if (command == FN_QUIT) break;
        switch (command) {
        case FN_BLOCKSIZE:
            block_size = (int64_t)get_long(r);
            if (block_size < 0) return -67;
            break;
        case FN_BITSHIFT:
            left_shift = (int)get_unsigned(r, 2);
            break;
        case FN_VERBATIM: {
            const int64_t count = (int64_t)get_unsigned(r, 5);
            for (int64_t i = 0; i < count; i++) get_unsigned(r, 8);
            break;
        }
        case FN_DIFF0: case FN_DIFF1: case FN_DIFF2: case FN_DIFF3:
        case FN_QLPC: case FN_ZERO: {
            if (frames + block_size > max_frames) return -68;
            if (block_size + wrap > block_cap) {
                delete[] blockbuf;
                blockbuf = new int64_t[(block_size + wrap) * 2];
                block_cap = block_size + wrap;
            }
            int64_t* hist = state + (int64_t)chan * (wrap + 32);
            int64_t* means = hist + wrap;
            int64_t* buf = blockbuf;
            for (int j = 0; j < wrap; j++) buf[j] = hist[j];
            int64_t* s = buf + wrap;

            // shnmean: floor((len/2 + sum) / len)
            auto floor_div = [](int64_t a, int64_t b) {
                return (a >= 0) ? a / b : -((-a + b - 1) / b);
            };
            if (command == FN_ZERO) {
                for (int64_t i = 0; i < block_size; i++) s[i] = 0;
            } else if (command == FN_DIFF0) {
                int64_t offset = 0;
                if (n_means > 0) {
                    int64_t sum = n_means / 2;
                    for (int j = 0; j < n_means; j++)
                        sum += means[j];
                    offset = floor_div(sum, n_means);
                }
                const int energy = (int)get_unsigned(r, 3);
                for (int64_t i = 0; i < block_size; i++)
                    s[i] = get_signed(r, energy) + offset;
            } else if (command == FN_QLPC) {
                // means offset (floor)
                int64_t offset = 0;
                if (n_means > 0) {
                    int64_t sum = n_means / 2;
                    for (int j = 0; j < n_means; j++)
                        sum += means[j];
                    offset = floor_div(sum, n_means);
                }
                const int energy = (int)get_unsigned(r, 3);
                const int lpc_count = (int)get_unsigned(r, 2);
                int64_t coeff[32];
                for (int j = 0; j < lpc_count && j < 32; j++)
                    coeff[j] = get_signed(r, 5);
                for (int64_t i = 0; i < block_size; i++) {
                    const int64_t residual = get_signed(r, energy);
                    int64_t lpc_sum = 1 << 5;
                    for (int j = 0; j < lpc_count; j++) {
                        if (i - j - 1 < 0)
                            lpc_sum += coeff[j] *
                                (buf[wrap + (i - j - 1)] - offset);
                        else
                            lpc_sum += coeff[j] * (s[i - j - 1] -
                                                   offset);
                    }
                    s[i] = (lpc_sum >> 5) + residual + offset;
                }
                // QLPC: unoffset values feed the recurrence; the
                // stored samples are offset-added (handled above by
                // keeping s[] offset-added and subtracting in loop)
            } else {
                const int order = command;   // DIFF1/2/3
                const int energy = (int)get_unsigned(r, 3);
                for (int64_t i = 0; i < block_size; i++) {
                    const int64_t res = get_signed(r, energy);
                    int64_t pred;
                    const int64_t* p = s + i;
                    if (order == 1) pred = p[-1];
                    else if (order == 2) pred = 2 * p[-1] - p[-2];
                    else pred = 3 * (p[-1] - p[-2]) + p[-3];
                    s[i] = pred + res;
                }
            }
            if (r.error) return -69;

            // update means (shnmean uses floor semantics via the
            // (len/2 + sum) / len formula)
            if (n_means > 0) {
                int64_t sum = block_size / 2;
                for (int64_t i = 0; i < block_size; i++) sum += s[i];
                const int64_t mean = floor_div(sum, block_size);
                for (int j = 0; j < n_means - 1; j++)
                    means[j] = means[j + 1];
                means[n_means - 1] = mean;
            }
            // wrap history
            for (int j = 0; j < wrap; j++) {
                const int64_t idx = block_size - wrap + j;
                hist[j] = (idx >= 0) ? s[idx] : buf[wrap + idx];
            }
            // emit
            for (int64_t i = 0; i < block_size; i++) {
                int64_t v = s[i];
                if (left_shift > 0) v <<= left_shift;
                v -= sign_adjustment;
                out[(frames + i) * channels + chan] = (int32_t)v;
            }
            chan += 1;
            if (chan == channels) {
                chan = 0;
                frames += block_size;
            }
            break;
        }
        default:
            return -70;
        }
    }
    if (info != nullptr) {
        info[0] = channels;
        info[1] = file_type;
        info[2] = block_size;
        info[3] = bps;
    }
    return frames;
}

/* Residual-only entropy scan of a Shorten stream for the DEVICE
 * decode path (codecs/shn.TorchSHNDecoder): walks the command stream
 * and entropy-decodes each (block, channel) row's residuals WITHOUT
 * applying predictors — the device inverts DIFF1-3 as k-fold cumsums
 * plus affine warm-up terms (ops/shn_synth.py), the TPU-native
 * re-expression of reference src/decoders/shn.c's per-sample loops.
 *
 * row_meta per row: {cmd, block_len, left_shift, chan}
 * residuals: [max_rows, max_block] int32, zero-padded per row
 * info: {channels, file_type, bps, sign_adjustment, total_frames}
 * Returns row count, or <0: -80 = the stream uses features the
 * device path does not cover (QLPC, DIFF0-with-means, energy > 30)
 * and the caller must decode on host; -81 = capacity. */
int64_t atpu_shn_scan(const uint8_t* data,
                      int64_t len,
                      int64_t max_rows,
                      int64_t max_block,
                      int32_t* residuals,
                      int32_t* row_meta,
                      int64_t* info) {
    using namespace shn;
    BitReader r(data, len);
    if (r.get(32) != 0x616A6B67 || r.get(8) != 2) return -62;
    const int file_type = (int)get_long(r);
    const int channels = (int)get_long(r);
    int64_t block_size = (int64_t)get_long(r);
    (void)get_long(r);                        /* max LPC */
    const int n_means = (int)get_long(r);
    const int64_t skip = (int64_t)get_long(r);
    if (channels < 1 || channels > 64) return -63;
    if (r.error) return -64;
    for (int64_t i = 0; i < skip; i++) get_unsigned(r, 8);

    int bps;
    int32_t sign_adjustment = 0;
    switch (file_type) {
    case 1: bps = 8; break;
    case 2: bps = 8; sign_adjustment = 1 << 7; break;
    case 3: case 5: bps = 16; break;
    case 4: case 6: bps = 16; sign_adjustment = 1 << 15; break;
    default: return -65;
    }

    int left_shift = 0;
    int64_t rows = 0, frames = 0;
    int chan = 0;

    while (!r.error) {
        const int command = (int)get_unsigned(r, 2);
        if (r.error) return -66;
        if (command == FN_QUIT) break;
        switch (command) {
        case FN_BLOCKSIZE:
            block_size = (int64_t)get_long(r);
            if (block_size < 0) return -67;
            break;
        case FN_BITSHIFT:
            left_shift = (int)get_unsigned(r, 2);
            break;
        case FN_VERBATIM: {
            const int64_t count = (int64_t)get_unsigned(r, 5);
            for (int64_t i = 0; i < count; i++) get_unsigned(r, 8);
            break;
        }
        case FN_QLPC:
            return -80;
        case FN_DIFF0: case FN_DIFF1: case FN_DIFF2: case FN_DIFF3:
        case FN_ZERO: {
            if (command == FN_DIFF0 && n_means > 0)
                return -80;   /* offset needs decoded means: host */
            if (rows >= max_rows || block_size > max_block)
                return -81;
            int32_t* res = residuals + rows * max_block;
            for (int64_t i = 0; i < max_block; i++) res[i] = 0;
            if (command != FN_ZERO) {
                const int energy = (int)get_unsigned(r, 3);
                if (energy > 30) return -80;
                for (int64_t i = 0; i < block_size; i++)
                    res[i] = (int32_t)get_signed(r, energy);
            }
            if (r.error) return -69;
            int32_t* rm = row_meta + rows * 4;
            rm[0] = command;
            rm[1] = (int32_t)block_size;
            rm[2] = left_shift;
            rm[3] = chan;
            rows++;
            chan += 1;
            if (chan == channels) {
                chan = 0;
                frames += block_size;
            }
            break;
        }
        default:
            return -70;
        }
    }
    if (info != nullptr) {
        info[0] = channels;
        info[1] = file_type;
        info[2] = bps;
        info[3] = sign_adjustment;
        info[4] = frames;
    }
    return rows;
}

/* parse-only walk of a Shorten stream collecting the VERBATIM
 * container bytes before (head) and after (tail) the PCM data —
 * the role of the reference SHNDecoder read_header/read_tail
 * (shn.py:287-331) without decoding any samples.
 * sizes[0]=head bytes, sizes[1]=tail bytes; returns 0 or <0. */
int64_t atpu_shn_split(const uint8_t* data,
                       int64_t len,
                       uint8_t* head_out, int64_t head_cap,
                       uint8_t* tail_out, int64_t tail_cap,
                       int64_t* sizes) {
    using namespace shn;
    BitReader r(data, len);
    if (r.get(32) != 0x616A6B67 || r.get(8) != 2) return -62;
    (void)get_long(r);                        /* file type */
    (void)get_long(r);                        /* channels */
    int64_t block_size = (int64_t)get_long(r);
    (void)get_long(r);                        /* max LPC */
    (void)get_long(r);                        /* means */
    const int64_t skip = (int64_t)get_long(r);
    if (r.error) return -64;
    for (int64_t i = 0; i < skip; i++) get_unsigned(r, 8);

    uint8_t* sink = head_out;
    int64_t sink_cap = head_cap;
    int64_t* sink_n = &sizes[0];
    sizes[0] = sizes[1] = 0;

    while (!r.error) {
        const int command = (int)get_unsigned(r, 2);
        if (r.error) return -66;
        if (command == FN_QUIT) break;
        switch (command) {
        case FN_BLOCKSIZE:
            block_size = (int64_t)get_long(r);
            if (block_size < 0) return -67;
            break;
        case FN_BITSHIFT:
            get_unsigned(r, 2);
            break;
        case FN_VERBATIM: {
            const int64_t count = (int64_t)get_unsigned(r, 5);
            for (int64_t i = 0; i < count; i++) {
                const uint8_t byte =
                    (uint8_t)(get_unsigned(r, 8) & 0xFF);
                if (*sink_n >= sink_cap) return -69;
                sink[(*sink_n)++] = byte;
            }
            break;
        }
        case FN_DIFF0: case FN_DIFF1: case FN_DIFF2: case FN_DIFF3: {
            sink = tail_out;
            sink_cap = tail_cap;
            sink_n = &sizes[1];
            const int energy = (int)get_unsigned(r, 3);
            for (int64_t i = 0; i < block_size; i++)
                get_signed(r, energy);
            break;
        }
        case FN_QLPC: {
            sink = tail_out;
            sink_cap = tail_cap;
            sink_n = &sizes[1];
            const int energy = (int)get_unsigned(r, 3);
            const int lpc_count = (int)get_unsigned(r, 2);
            for (int j = 0; j < lpc_count; j++) get_signed(r, 5);
            for (int64_t i = 0; i < block_size; i++)
                get_signed(r, energy);
            break;
        }
        case FN_ZERO:
            sink = tail_out;
            sink_cap = tail_cap;
            sink_n = &sizes[1];
            break;
        default:
            return -70;
        }
    }
    return 0;
}

/* Reads a Shorten stream's header and its first command, as the
 * reference's scalar decoder does (ref/shn.py read_header and
 * read_metadata): info = {file_type, channels, block_size, max_lpc,
 * n_means, verbatim}, where verbatim is the byte count of a leading
 * FN_VERBATIM chunk (its first head_cap bytes go to head_out), or -1
 * when the first command is another.  The header's skip bytes are
 * plain bytes, as the reference reads them.  Returns 0, or -62 for a
 * stream that is not Shorten v2, -64 for one that ends inside its
 * header or that chunk. */
int64_t atpu_shn_header(const uint8_t* data, int64_t len, int64_t* info,
                        uint8_t* head_out, int64_t head_cap) {
    using namespace shn;
    BitReader r(data, len);
    if (r.get(32) != 0x616A6B67 || r.get(8) != 2) return -62;
    for (int i = 0; i < 5; i++) info[i] = (int64_t)get_long(r);
    const int64_t skip = (int64_t)get_long(r);
    for (int64_t i = 0; i < skip && !r.error; i++) r.get(8);
    info[5] = -1;
    if (get_unsigned(r, 2) == FN_VERBATIM) {
        info[5] = (int64_t)get_unsigned(r, 5);
        for (int64_t i = 0; i < info[5] && !r.error; i++) {
            const uint8_t byte = (uint8_t)(get_unsigned(r, 8) & 0xFF);
            if (i < head_cap) head_out[i] = byte;
        }
    }
    if (r.error) return -64;
    return 0;
}

/* The warm-up chain of the device decode (the port's ops/shn_synth.py):
 * for each row of atpu_shn_scan's output, in stream order, the last
 * three PRE-SHIFT samples of the previous row of the same channel,
 * newest first (zeros at the stream's start), into warm [rows, 3].
 * A row's last three samples come from the closed forms of
 * ops/shn_synth.py over its running 1-, 2- and 3-fold residual sums
 * C1, C2, C3, without decoding the row:
 *   DIFF1: x[t] = w1 + C1[t]
 *   DIFF2: x[t] = w1 + (t+1) a1 + C2[t]
 *   DIFF3: x[t] = w1 + (t+1) a1 + T(t) a2 + C3[t],  T(t) = (t+1)(t+2)/2
 *   ZERO:  x[t] = 0;  DIFF0 (no means): x[t] = r[t]
 * with (w1, w2, w3) the row's warm values, a1 = w1 - w2 and
 * a2 = w1 - 2 w2 + w3.  A block shorter than 3 samples pushes its
 * samples and keeps the older history behind them (the reference
 * decoder's rule); an empty block leaves the history alone.  The sums
 * wrap as two's-complement int64.  One pass over the rows.  Returns 0,
 * or -1 for a row whose channel or length is out of range. */
int64_t atpu_shn_warm_chain(const int32_t* residuals,
                            const int32_t* row_meta,
                            int64_t rows,
                            int64_t width,
                            int32_t channels,
                            int64_t* warm) {
    using namespace shn;
    if (channels < 1) return -1;
    std::vector<uint64_t> hist((size_t)channels * 3, 0);
    for (int64_t row = 0; row < rows; row++) {
        const int32_t* rm = row_meta + row * 4;
        const int cmd = rm[0];
        const int64_t n = rm[1];
        const int chan = rm[3];
        if (chan < 0 || chan >= channels || n > width) return -1;
        uint64_t* h = hist.data() + (size_t)chan * 3;
        for (int j = 0; j < 3; j++) warm[row * 3 + j] = (int64_t)h[j];
        if (n <= 0) continue;
        const int32_t* r = residuals + row * width;
        const uint64_t w1 = h[0], w2 = h[1], w3 = h[2];
        const uint64_t a1 = w1 - w2;
        const uint64_t a2 = w1 - 2 * w2 + w3;
        const int64_t first = (n > 3) ? n - 3 : 0;
        uint64_t tails[3];
        int nt = 0;
        uint64_t c1 = 0, c2 = 0, c3 = 0;
        const bool sums = (cmd == FN_DIFF1 || cmd == FN_DIFF2 ||
                           cmd == FN_DIFF3);
        for (int64_t t = sums ? 0 : first; t < n; t++) {
            if (sums) {
                c1 += (uint64_t)(int64_t)r[t];
                c2 += c1;
                c3 += c2;
            }
            if (t < first) continue;
            const uint64_t i1 = (uint64_t)(t + 1);
            uint64_t x;
            if (cmd == FN_DIFF1) {
                x = w1 + c1;
            } else if (cmd == FN_DIFF2) {
                x = w1 + i1 * a1 + c2;
            } else if (cmd == FN_DIFF3) {
                x = w1 + i1 * a1 + (i1 * (i1 + 1) / 2) * a2 + c3;
            } else if (cmd == FN_ZERO) {
                x = 0;
            } else {
                x = (uint64_t)(int64_t)r[t];
            }
            tails[nt++] = x;
        }
        /* newest first: the row's tail reversed, then the old history */
        uint64_t next[6];
        int k = 0;
        for (int j = nt - 1; j >= 0; j--) next[k++] = tails[j];
        for (int j = 0; j < 3; j++) next[k++] = h[j];
        for (int j = 0; j < 3; j++) h[j] = next[j];
    }
    return 0;
}

}  // extern "C"

// ======================================================================
// WavPack — hot host kernels behind the Python block assembler.
//
// Role of reference src/encoders/wavpack.c / src/decoders/wavpack.c
// (spec: audiotools/py_encoders/wavpack.py, py_decoders/wavpack.py,
// mirrored by audiotools_tpu/ref/wavpack.py).  Block/sub-block
// assembly stays in Python (small per block); the per-sample work —
// decorrelation passes, the adaptive-medians residual coder, and the
// sample CRC — runs here.  WavPack bitstreams are LSB-first.

namespace wv {

using tta::LEWriter;
using tta::LEReader;

static inline int64_t apply_weight(int64_t weight, int64_t sample) {
    return ((weight * sample) + 512) >> 10;
}

static inline int64_t update_weight(int64_t source, int64_t result,
                                    int64_t delta) {
    if (source == 0 || result == 0) return 0;
    return ((source ^ result) >= 0) ? delta : -delta;
}

static inline void put_egc(LEWriter& w, uint32_t value) {
    if (value > 1) {
        const int t = 32 - __builtin_clz(value);
        // unary(0, t): t one-bits then a zero
        w.put(((1ULL << t) - 1), t + 1);
        w.put(value % (1u << (t - 1)), t - 1);
    } else {
        w.put(((1ULL << value) - 1), value + 1);
    }
}

static inline uint32_t get_egc(LEReader& r) {
    const uint32_t t = r.unary1();
    if (t > 1)
        return (1u << (t - 1)) | (uint32_t)r.get(t - 1);
    return t;
}

struct Residual {
    bool has_zeroes = false;
    uint32_t zeroes = 0;
    bool has_m = false;
    int64_t m = 0;
    int64_t offset = 0;
    int64_t add = 0;
    int sign = 0;
};

// encodes one residual against the channel's entropy state
// (ref/wavpack.py _Residual.encode)
static Residual encode_residual(int64_t residual, int64_t* entropy) {
    Residual out;
    out.has_m = true;
    int64_t unsigned_v;
    if (residual >= 0) {
        unsigned_v = residual;
        out.sign = 0;
    } else {
        unsigned_v = -residual - 1;
        out.sign = 1;
    }
    const int64_t med0 = (entropy[0] >> 4) + 1;
    const int64_t med1 = (entropy[1] >> 4) + 1;
    const int64_t med2 = (entropy[2] >> 4) + 1;

    if (unsigned_v < med0) {
        out.m = 0;
        out.offset = unsigned_v;
        out.add = med0 - 1;
        entropy[0] -= ((entropy[0] + 126) >> 7) * 2;
    } else if (unsigned_v - med0 < med1) {
        out.m = 1;
        out.offset = unsigned_v - med0;
        out.add = med1 - 1;
        entropy[0] += ((entropy[0] + 128) >> 7) * 5;
        entropy[1] -= ((entropy[1] + 62) >> 6) * 2;
    } else if (unsigned_v - (med0 + med1) < med2) {
        out.m = 2;
        out.offset = unsigned_v - (med0 + med1);
        out.add = med2 - 1;
        entropy[0] += ((entropy[0] + 128) >> 7) * 5;
        entropy[1] += ((entropy[1] + 64) >> 6) * 5;
        entropy[2] -= ((entropy[2] + 30) >> 5) * 2;
    } else {
        out.m = ((unsigned_v - (med0 + med1)) / med2) + 2;
        out.offset = unsigned_v -
            (med0 + med1 + (out.m - 2) * med2);
        out.add = med2 - 1;
        entropy[0] += ((entropy[0] + 128) >> 7) * 5;
        entropy[1] += ((entropy[1] + 64) >> 6) * 5;
        entropy[2] += ((entropy[2] + 32) >> 5) * 5;
    }
    return out;
}

// flushes residual_{i-1}; returns the new u_{i-1} state
// (-1 encodes "None"); ref/wavpack.py _Residual.flush
static int64_t flush_residual(const Residual& r, LEWriter& w,
                              int64_t u_i_2, int64_t m_i) {
    if (r.has_zeroes)
        put_egc(w, r.zeroes);
    if (!r.has_m)
        return -1;

    int64_t u_i_1;
    bool has_u = true;
    if (r.m > 0 && m_i > 0) {
        if (u_i_2 < 0 || (u_i_2 % 2) == 0) u_i_1 = r.m * 2 + 1;
        else u_i_1 = r.m * 2 - 1;
    } else if (r.m == 0 && m_i > 0) {
        if (u_i_2 < 0 || (u_i_2 % 2) == 1) u_i_1 = 1;
        else { u_i_1 = -1; has_u = false; }
    } else if (r.m > 0 && m_i == 0) {
        if (u_i_2 < 0 || (u_i_2 % 2) == 0) u_i_1 = r.m * 2;
        else u_i_1 = (r.m - 1) * 2;
    } else {
        if (u_i_2 < 0 || (u_i_2 % 2) == 1) u_i_1 = 0;
        else { u_i_1 = -1; has_u = false; }
    }

    if (has_u) {
        if (u_i_1 < 16) {
            w.put((1ULL << u_i_1) - 1, (int)u_i_1 + 1);
        } else {
            w.put((1ULL << 16) - 1, 17);
            put_egc(w, (uint32_t)(u_i_1 - 16));
        }
    }
    if (r.add > 0) {
        const int p = 63 - __builtin_clzll((uint64_t)r.add);
        const int64_t e = (1LL << (p + 1)) - r.add - 1;
        if (r.offset < e) {
            w.put((uint64_t)r.offset, p);
        } else {
            w.put((uint64_t)((r.offset + e) / 2), p);
            w.put((uint64_t)((r.offset + e) % 2), 1);
        }
    }
    w.put((uint64_t)r.sign, 1);
    return has_u ? u_i_1 : -1;
}

static inline bool unary_undefined(int64_t prev_u, const Residual& r) {
    if (!r.has_m) return true;
    if (r.m == 0 && prev_u >= 0 && (prev_u % 2) == 0) return true;
    return false;
}

}  // namespace wv

extern "C" {

// WavPack per-block sample CRC: crc = 3*crc + sample (mod 2^32) over
// interleaved samples.
uint32_t atpu_wv_crc(const int32_t* samples, int64_t n) {
    uint32_t crc = 0xFFFFFFFFu;
    for (int64_t i = 0; i < n; i++)
        crc = 3 * crc + (uint32_t)samples[i];
    return crc;
}

// One WavPack decorrelation pass over 1 or 2 channels, matching
// ref/wavpack.py correlation_pass_1ch/2ch.
//
// samples: int64 [n] per channel (in/out); weights: int64 [2]
// (in/out); corr: per-channel history (in/out; layout per term:
// 17/18 -> [2] as stored (newest first), 1..8 -> [term] oldest first,
// negative terms -> [1] per channel).
// returns 0 or a negative error code
int32_t atpu_wv_correlate(int64_t* ch0,
                          int64_t* ch1,
                          int64_t n,
                          int32_t channel_count,
                          int32_t term,
                          int32_t delta,
                          int64_t* weights,
                          int64_t* corr0,
                          int64_t* corr1) {
    using namespace wv;
    if (term >= 1 || term == 17 || term == 18) {
        // two-channel 17/18: the per-channel recurrences are
        // independent — interleave them so the out-of-order core
        // overlaps the two weight-adaptation chains (the same
        // treatment as atpu_wv_decorrelate's decode side)
        if (channel_count == 2 && (term == 17 || term == 18)) {
            int64_t wA = weights[0], wB = weights[1];
            int64_t a2 = corr0[1], a1 = corr0[0];
            int64_t b2 = corr1[1], b1 = corr1[0];
            int64_t lastA = 0, prevA = 0, lastB = 0, prevB = 0;
            for (int64_t i = 0; i < n; i++) {
                const int64_t tA = (term == 18)
                    ? ((3 * a1 - a2) >> 1) : (2 * a1 - a2);
                const int64_t tB = (term == 18)
                    ? ((3 * b1 - b2) >> 1) : (2 * b1 - b2);
                const int64_t xA = ch0[i];
                const int64_t xB = ch1[i];
                const int64_t cA = xA - apply_weight(wA, tA);
                const int64_t cB = xB - apply_weight(wB, tB);
                wA += update_weight(tA, cA, delta);
                wB += update_weight(tB, cB, delta);
                a2 = a1; a1 = xA; ch0[i] = cA;
                b2 = b1; b1 = xB; ch1[i] = cB;
                prevA = lastA; lastA = cA;
                prevB = lastB; lastB = cB;
            }
            if (n >= 2) {
                corr0[0] = lastA; corr0[1] = prevA;
                corr1[0] = lastB; corr1[1] = prevB;
            } else if (n == 1) {
                corr0[1] = corr0[0]; corr0[0] = lastA;
                corr1[1] = corr1[0]; corr1[0] = lastB;
            }
            weights[0] = wA;
            weights[1] = wB;
            return 0;
        }
        if (channel_count == 2 && term >= 1 && term <= 8) {
            // interleaved ring for terms 1..8, mirroring the decode
            // side's shared two-slot ring
            static thread_local int64_t* ring2 = nullptr;
            static thread_local int64_t ring2_cap = 0;
            if (term > ring2_cap) {
                delete[] ring2;
                ring2 = new int64_t[term * 2];
                ring2_cap = term;
            }
            for (int j = 0; j < term; j++) {
                ring2[j * 2] = corr0[j];
                ring2[j * 2 + 1] = corr1[j];
            }
            int64_t wA = weights[0], wB = weights[1];
            int rpos = 0;
            for (int64_t i = 0; i < n; i++) {
                const int64_t sA = ring2[rpos * 2];
                const int64_t sB = ring2[rpos * 2 + 1];
                const int64_t xA = ch0[i];
                const int64_t xB = ch1[i];
                const int64_t cA = xA - apply_weight(wA, sA);
                const int64_t cB = xB - apply_weight(wB, sB);
                ring2[rpos * 2] = xA;
                ring2[rpos * 2 + 1] = xB;
                ch0[i] = cA;
                ch1[i] = cB;
                rpos += 1;
                if (rpos == term) rpos = 0;
                wA += update_weight(sA, cA, delta);
                wB += update_weight(sB, cB, delta);
            }
            for (int j = 0; j < term; j++) {
                const int64_t idx = n - term + j;
                if (idx >= 0) {
                    corr0[j] = ch0[idx];
                    corr1[j] = ch1[idx];
                } else {
                    corr0[j] = corr0[(term + idx) % term];
                    corr1[j] = corr1[(term + idx) % term];
                }
            }
            weights[0] = wA;
            weights[1] = wB;
            return 0;
        }
        for (int c = 0; c < channel_count; c++) {
            int64_t* s = (c == 0) ? ch0 : ch1;
            int64_t* hist = (c == 0) ? corr0 : corr1;
            int64_t weight = weights[c];
            if (term == 17 || term == 18) {
                int64_t p2 = hist[1];     // full[i-2]
                int64_t p1 = hist[0];     // full[i-1]
                int64_t last_cor = 0, prev_cor = 0;
                for (int64_t i = 0; i < n; i++) {
                    const int64_t temp = (term == 18)
                        ? ((3 * p1 - p2) >> 1)
                        : (2 * p1 - p2);
                    const int64_t cor = s[i] -
                        apply_weight(weight, temp);
                    weight += update_weight(temp, cor, delta);
                    p2 = p1;
                    p1 = s[i];
                    s[i] = cor;
                    prev_cor = last_cor;
                    last_cor = cor;
                }
                // the oracle stores the last two CORRELATED outputs,
                // newest first (reversed(correlated[-2:]))
                if (n >= 2) {
                    hist[0] = last_cor;
                    hist[1] = prev_cor;
                } else if (n == 1) {
                    hist[1] = hist[0];
                    hist[0] = last_cor;
                }
            } else {
                // terms 1..8: full = hist(term) + samples; the weight
                // update uses correlated[i - term], which for the
                // first `term` outputs falls OUTSIDE this block — the
                // oracle indexes `correlated[i - term]` with
                // i starting at `term`, i.e. output index i-term
                // within this block, always >= 0
                static thread_local int64_t* ring = nullptr;
                static thread_local int64_t ring_cap = 0;
                if (term > ring_cap) {
                    delete[] ring;
                    ring = new int64_t[term * 2];
                    ring_cap = term;
                }
                for (int j = 0; j < term; j++) ring[j] = hist[j];
                int rpos = 0;
                for (int64_t i = 0; i < n; i++) {
                    const int64_t source = ring[rpos];
                    const int64_t cor = s[i] -
                        apply_weight(weight, source);
                    // correlated[i - term]: the output emitted
                    // `term` samples ago (or not yet for i < term —
                    // the oracle uses correlated[i-term] where the
                    // correlated list starts at full[term], so for
                    // the first `term` iterations it indexes the
                    // samples being appended this loop; replicate by
                    // using the ring of recent outputs)
                    ring[rpos] = s[i];
                    s[i] = cor;
                    rpos += 1;
                    if (rpos == term) rpos = 0;  // % is a div/sample
                    weight += update_weight(source, cor, delta);
                }
                for (int j = 0; j < term; j++) {
                    const int64_t idx = n - term + j;
                    hist[j] = (idx >= 0) ? s[idx] : hist[(term + idx) %
                                                         term];
                }
            }
            weights[c] = weight;
        }
        return 0;
    } else if (term >= -3 && term <= -1) {
        if (channel_count != 2) return -80;
        // full[0] = corr1[0] + ch0; full[1] = corr0[0] + ch1
        int64_t prev0 = corr1[0];
        int64_t prev1 = corr0[0];
        int64_t w0 = weights[0];
        int64_t w1 = weights[1];
        for (int64_t i = 0; i < n; i++) {
            const int64_t x0 = ch0[i];
            const int64_t x1 = ch1[i];
            int64_t c0, c1;
            if (term == -1) {
                c0 = x0 - apply_weight(w0, prev1);
                c1 = x1 - apply_weight(w1, x0);
                w0 += update_weight(prev1, c0, delta);
                w1 += update_weight(x0, c1, delta);
            } else if (term == -2) {
                c0 = x0 - apply_weight(w0, x1);
                c1 = x1 - apply_weight(w1, prev0);
                w0 += update_weight(x1, c0, delta);
                w1 += update_weight(prev0, c1, delta);
            } else {
                c0 = x0 - apply_weight(w0, prev1);
                c1 = x1 - apply_weight(w1, prev0);
                w0 += update_weight(prev1, c0, delta);
                w1 += update_weight(prev0, c1, delta);
            }
            if (w0 > 1024) w0 = 1024;
            if (w0 < -1024) w0 = -1024;
            if (w1 > 1024) w1 = 1024;
            if (w1 < -1024) w1 = -1024;
            prev0 = x0;
            prev1 = x1;
            ch0[i] = c0;
            ch1[i] = c1;
        }
        weights[0] = w0;
        weights[1] = w1;
        // negative terms keep their original correlation samples
        return 0;
    }
    return -81;
}

// The adaptive-medians residual coder (ref/wavpack.py
// write_bitstream): correlated int64 [n] per channel; entropies
// int64 [2][3] (mutated); out holds out_cap bytes; returns bytes
// written, or -54 when they do not fit out_cap.
int64_t atpu_wv_write_bitstream(const int64_t* ch0,
                                const int64_t* ch1,
                                int64_t n,
                                int32_t channel_count,
                                int64_t* entropies,
                                uint8_t* out,
                                int64_t out_cap) {
    using namespace wv;
    LEWriter w(out, 0, out_cap);
    Residual r_prev;          // starts with no m, no zeroes
    int64_t u_i_2 = -1;
    const int64_t total = n * channel_count;

    for (int64_t i = 0; i < total; i++) {
        const int c = (int)(i % channel_count);
        const int64_t r = (c == 0) ? ch0[i / channel_count]
                                   : ch1[i / channel_count];
        int64_t* entropy = entropies + c * 3;

        if (entropies[0] < 2 && entropies[3] < 2 &&
                unary_undefined(u_i_2, r_prev)) {
            if (r_prev.has_zeroes && !r_prev.has_m) {
                // inside a zero block
                if (r == 0) {
                    r_prev.zeroes += 1;
                } else {
                    Residual r_i = encode_residual(r, entropy);
                    r_i.has_zeroes = true;
                    r_i.zeroes = r_prev.zeroes;
                    r_prev = r_i;
                }
            } else {
                if (r == 0) {
                    Residual r_i;
                    r_i.has_zeroes = true;
                    r_i.zeroes = 1;
                    u_i_2 = flush_residual(r_prev, w, u_i_2, 0);
                    for (int j = 0; j < 6; j++) entropies[j] = 0;
                    r_prev = r_i;
                } else {
                    Residual r_i = encode_residual(r, entropy);
                    r_i.has_zeroes = true;
                    r_i.zeroes = 0;
                    u_i_2 = flush_residual(r_prev, w, u_i_2, r_i.m);
                    r_prev = r_i;
                }
            }
        } else {
            Residual r_i = encode_residual(r, entropy);
            r_i.has_zeroes = false;
            u_i_2 = flush_residual(r_prev, w, u_i_2, r_i.m);
            r_prev = r_i;
        }
    }
    // final flush of the last pending residual (m_i = 0)
    flush_residual(r_prev, w, u_i_2, 0);
    w.byte_align();
    return w.overflow ? -54 : w.pos;
}

}  // extern "C"

// ---------------------------------------------------------------------
// WavPack decode kernels: adaptive-medians residual reader and inverse
// decorrelation passes (ref/wavpack.py _read_bitstream,
// _decorrelation_pass_1ch/2ch).

extern "C" {

// Reads n*channel_count residuals; entropies int64 [2][3] mutated;
// out: int64 [n] per channel. returns bytes consumed or negative.
int64_t atpu_wv_read_bitstream(const uint8_t* data,
                               int64_t len,
                               int64_t n,
                               int32_t channel_count,
                               int64_t* entropies,
                               int64_t* out0,
                               int64_t* out1) {
    using namespace wv;
    LEReader r(data, len);
    const int64_t total = n * channel_count;
    int64_t i = 0;
    int64_t u = -1;          // -1 encodes None
    bool u_none = true;

    auto read_residual = [&](int64_t* entropy, int64_t* residual)
            -> bool {
        int64_t m;
        if (u_none) {
            uint32_t uu = r.unary1();
            if (uu == 16) uu += get_egc(r);
            u = uu;
            u_none = false;
            m = u / 2;
        } else if ((u % 2) == 1) {
            uint32_t uu = r.unary1();
            if (uu == 16) uu += get_egc(r);
            u = uu;
            m = (u / 2) + 1;
        } else {
            u_none = true;
            m = 0;
        }
        int64_t base, add;
        if (m == 0) {
            base = 0;
            add = entropy[0] >> 4;
            entropy[0] -= ((entropy[0] + 126) >> 7) * 2;
        } else if (m == 1) {
            base = (entropy[0] >> 4) + 1;
            add = entropy[1] >> 4;
            entropy[0] += ((entropy[0] + 128) >> 7) * 5;
            entropy[1] -= ((entropy[1] + 62) >> 6) * 2;
        } else if (m == 2) {
            base = ((entropy[0] >> 4) + 1) + ((entropy[1] >> 4) + 1);
            add = entropy[2] >> 4;
            entropy[0] += ((entropy[0] + 128) >> 7) * 5;
            entropy[1] += ((entropy[1] + 64) >> 6) * 5;
            entropy[2] -= ((entropy[2] + 30) >> 5) * 2;
        } else {
            base = ((entropy[0] >> 4) + 1) + ((entropy[1] >> 4) + 1) +
                   ((entropy[2] >> 4) + 1) * (m - 2);
            add = entropy[2] >> 4;
            entropy[0] += ((entropy[0] + 128) >> 7) * 5;
            entropy[1] += ((entropy[1] + 64) >> 6) * 5;
            entropy[2] += ((entropy[2] + 32) >> 5) * 5;
        }
        int64_t unsigned_v;
        if (add == 0) {
            unsigned_v = base;
        } else {
            const int p = 63 - __builtin_clzll((uint64_t)add);
            const int64_t e = (1LL << (p + 1)) - add - 1;
            const int64_t rv = (int64_t)r.get(p);
            if (rv >= e)
                unsigned_v = base + rv * 2 - e + (int64_t)r.get(1);
            else
                unsigned_v = base + rv;
        }
        *residual = r.get(1) ? (-unsigned_v - 1) : unsigned_v;
        return !r.error;
    };

    while (i < total) {
        int64_t* out = (i % channel_count == 0) ? out0 : out1;
        int64_t* entropy = entropies + (i % channel_count) * 3;
        if (u_none && entropies[0] < 2 && entropies[3] < 2) {
            uint32_t zeroes = get_egc(r);
            if (zeroes > 0) {
                for (uint32_t z = 0; z < zeroes && i < total; z++) {
                    ((i % channel_count == 0) ? out0 : out1)
                        [i / channel_count] = 0;
                    i += 1;
                }
                for (int j = 0; j < 6; j++) entropies[j] = 0;
            }
            if (i < total) {
                out = (i % channel_count == 0) ? out0 : out1;
                entropy = entropies + (i % channel_count) * 3;
                int64_t residual;
                if (!read_residual(entropy, &residual)) return -85;
                out[i / channel_count] = residual;
                i += 1;
            }
        } else {
            int64_t residual;
            if (!read_residual(entropy, &residual)) return -85;
            out[i / channel_count] = residual;
            i += 1;
        }
        if (r.error) return -85;
    }
    return r.byte_pos();
}

// One inverse decorrelation pass (ref/wavpack.py
// _decorrelation_pass_1ch/2ch); ch arrays in/out, dec samples are
// the per-pass stored history (layouts as in the reader).
int32_t atpu_wv_decorrelate(int64_t* ch0,
                            int64_t* ch1,
                            int64_t n,
                            int32_t channel_count,
                            int32_t term,
                            int32_t delta,
                            const int64_t* weights,
                            const int64_t* dec0,
                            const int64_t* dec1) {
    using namespace wv;
    if (term == 17 || term == 18) {
        // the per-channel recurrences are independent: with two
        // channels, run them interleaved in one loop so the
        // out-of-order core overlaps the two weight-adaptation chains
        if (channel_count == 2) {
            int64_t wA = weights[0], wB = weights[1];
            int64_t a0 = dec0[1], a1 = dec0[0];
            int64_t b0 = dec1[1], b1 = dec1[0];
            if (term == 18) {
                for (int64_t i = 0; i < n; i++) {
                    const int64_t tA = (3 * a1 - a0) >> 1;
                    const int64_t tB = (3 * b1 - b0) >> 1;
                    const int64_t cA = ch0[i];
                    const int64_t cB = ch1[i];
                    const int64_t dA = apply_weight(wA, tA) + cA;
                    const int64_t dB = apply_weight(wB, tB) + cB;
                    wA += update_weight(tA, cA, delta);
                    wB += update_weight(tB, cB, delta);
                    a0 = a1; a1 = dA; ch0[i] = dA;
                    b0 = b1; b1 = dB; ch1[i] = dB;
                }
            } else {
                for (int64_t i = 0; i < n; i++) {
                    const int64_t tA = 2 * a1 - a0;
                    const int64_t tB = 2 * b1 - b0;
                    const int64_t cA = ch0[i];
                    const int64_t cB = ch1[i];
                    const int64_t dA = apply_weight(wA, tA) + cA;
                    const int64_t dB = apply_weight(wB, tB) + cB;
                    wA += update_weight(tA, cA, delta);
                    wB += update_weight(tB, cB, delta);
                    a0 = a1; a1 = dA; ch0[i] = dA;
                    b0 = b1; b1 = dB; ch1[i] = dB;
                }
            }
            return 0;
        }
        for (int c = 0; c < channel_count; c++) {
            int64_t* s = (c == 0) ? ch0 : ch1;
            const int64_t* dec = (c == 0) ? dec0 : dec1;
            int64_t weight = weights[c];
            // dec stored newest-first; reversed gives [old, new]
            int64_t p0 = dec[1];     // decorrelated[i]
            int64_t p1 = dec[0];     // decorrelated[i+1]
            for (int64_t i = 0; i < n; i++) {
                const int64_t temp = (term == 18)
                    ? ((3 * p1 - p0) >> 1)
                    : (2 * p1 - p0);
                const int64_t cor = s[i];
                const int64_t dv = apply_weight(weight, temp) + cor;
                weight += update_weight(temp, cor, delta);
                p0 = p1;
                p1 = dv;
                s[i] = dv;
            }
        }
        return 0;
    } else if (term >= 1 && term <= 8) {
        static thread_local int64_t* ring = nullptr;
        static thread_local int64_t ring_cap = 0;
        if (term > ring_cap) {
            delete[] ring;
            ring = new int64_t[term * 2];
            ring_cap = term;
        }
        if (channel_count == 2) {
            // interleaved channel pair, shared ring (two slots per
            // position); wrap via compare (a runtime % is a divide
            // per sample)
            int64_t wA = weights[0], wB = weights[1];
            for (int j = 0; j < term; j++) {
                ring[j * 2] = dec0[j];
                ring[j * 2 + 1] = dec1[j];
            }
            int rpos = 0;
            for (int64_t i = 0; i < n; i++) {
                const int64_t sA = ring[rpos * 2];
                const int64_t sB = ring[rpos * 2 + 1];
                const int64_t cA = ch0[i];
                const int64_t cB = ch1[i];
                const int64_t dA = apply_weight(wA, sA) + cA;
                const int64_t dB = apply_weight(wB, sB) + cB;
                wA += update_weight(sA, cA, delta);
                wB += update_weight(sB, cB, delta);
                ring[rpos * 2] = dA;
                ring[rpos * 2 + 1] = dB;
                rpos += 1;
                if (rpos == term) rpos = 0;
                ch0[i] = dA;
                ch1[i] = dB;
            }
            return 0;
        }
        for (int c = 0; c < channel_count; c++) {
            int64_t* s = (c == 0) ? ch0 : ch1;
            const int64_t* dec = (c == 0) ? dec0 : dec1;
            int64_t weight = weights[c];
            for (int j = 0; j < term; j++) ring[j] = dec[j];
            int rpos = 0;
            for (int64_t i = 0; i < n; i++) {
                const int64_t source = ring[rpos];
                const int64_t cor = s[i];
                const int64_t dv = apply_weight(weight, source) + cor;
                weight += update_weight(source, cor, delta);
                ring[rpos] = dv;
                rpos += 1;
                if (rpos == term) rpos = 0;
                s[i] = dv;
            }
        }
        return 0;
    } else if (term >= -3 && term <= -1) {
        if (channel_count != 2) return -86;
        int64_t prev0 = dec1[0];     // decorrelated[0] head
        int64_t prev1 = dec0[0];     // decorrelated[1] head
        int64_t w0 = weights[0];
        int64_t w1 = weights[1];
        for (int64_t i = 0; i < n; i++) {
            const int64_t c0 = ch0[i];
            const int64_t c1 = ch1[i];
            int64_t d0, d1;
            if (term == -1) {
                d0 = apply_weight(w0, prev1) + c0;
                d1 = apply_weight(w1, d0) + c1;
                w0 += update_weight(prev1, c0, delta);
                w1 += update_weight(d0, c1, delta);
            } else if (term == -2) {
                d1 = apply_weight(w1, prev0) + c1;
                d0 = apply_weight(w0, d1) + c0;
                w1 += update_weight(prev0, c1, delta);
                w0 += update_weight(d1, c0, delta);
            } else {
                d0 = apply_weight(w0, prev1) + c0;
                d1 = apply_weight(w1, prev0) + c1;
                w0 += update_weight(prev1, c0, delta);
                w1 += update_weight(prev0, c1, delta);
            }
            if (w0 > 1024) w0 = 1024;
            if (w0 < -1024) w0 = -1024;
            if (w1 > 1024) w1 = 1024;
            if (w1 < -1024) w1 = -1024;
            prev0 = d0;
            prev1 = d1;
            ch0[i] = d0;
            ch1[i] = d1;
        }
        return 0;
    }
    return -87;
}

}  // extern "C"

// ------------------------------------------------------- converters --
// The converter suite's host kernels, copied from the reference's
// library: the resampler's polyphase FIR (both of its summation
// orders), the AccurateRip V1/V2 multiply-accumulate and the direct-form
// II transposed IIR of the ReplayGain filters.  They are the host twins
// of the device converters in ops/converters.py: the device routes
// never call them.

// Windowed-sinc resampler hot loop (reference counterpart:
// src/samplerate/src_sinc.c:1207 calc_output).  For each output m,
// out[m,:] = sum_t bank[q[m], t] * hist[starts[m] + t, :].
// hist is interleaved float64 [n, ch]; bank rows are per-phase
// coefficient vectors.  Channel-templated so the tap loop carries
// fixed accumulator registers and vectorizes.
namespace {

template <int CH>
static void resample_fir_t(const double* hist,
                           const int64_t* starts,
                           const int32_t* q,
                           const double* bank,
                           int taps,
                           int64_t m_count,
                           double* out) {
    for (int64_t m = 0; m < m_count; m++) {
        const double* h = hist + starts[m] * CH;
        const double* b = bank + (int64_t)q[m] * taps;
        // four independent accumulator chains per channel: the FMA
        // latency chain otherwise serializes the tap loop (f64 adds
        // cannot be reassociated by the compiler without fast-math,
        // and this fixed grouping keeps output deterministic)
        double a0[CH] = {}, a1[CH] = {}, a2[CH] = {}, a3[CH] = {};
        double a4[CH] = {}, a5[CH] = {}, a6[CH] = {}, a7[CH] = {};
        int t = 0;
        for (; t + 8 <= taps; t += 8) {
            for (int c = 0; c < CH; c++) {
                a0[c] += b[t] * h[t * CH + c];
                a1[c] += b[t + 1] * h[(t + 1) * CH + c];
                a2[c] += b[t + 2] * h[(t + 2) * CH + c];
                a3[c] += b[t + 3] * h[(t + 3) * CH + c];
                a4[c] += b[t + 4] * h[(t + 4) * CH + c];
                a5[c] += b[t + 5] * h[(t + 5) * CH + c];
                a6[c] += b[t + 6] * h[(t + 6) * CH + c];
                a7[c] += b[t + 7] * h[(t + 7) * CH + c];
            }
        }
        for (; t < taps; t++)
            for (int c = 0; c < CH; c++)
                a0[c] += b[t] * h[t * CH + c];
        for (int c = 0; c < CH; c++)
            out[m * CH + c] = ((a0[c] + a1[c]) + (a2[c] + a3[c])) +
                              ((a4[c] + a5[c]) + (a6[c] + a7[c]));
    }
}

#ifdef ATPU_AVX512
// stereo FIR: interleaved [L,R]x4 lanes with pairwise-duplicated
// coefficients (one permute + FMA covers 4 taps x 2 channels).
// Summation order differs from the scalar path's 8-chain grouping —
// like the NumPy fallback, which already sums tap-at-a-time; the
// resampler's contract is filter quality (SNR/band tests), not
// bit-reproducible f64 rounding across backends.
static void resample_fir_stereo_avx(const double* hist,
                                    const int64_t* starts,
                                    const int32_t* q,
                                    const double* bank,
                                    int taps,
                                    int64_t m_count,
                                    double* out) {
    alignas(64) static const int64_t DUP[8] = {0, 0, 1, 1, 2, 2, 3, 3};
    const __m512i dup = _mm512_load_si512((const __m512i*)DUP);
    for (int64_t m = 0; m < m_count; m++) {
        const double* h = hist + starts[m] * 2;
        const double* b = bank + (int64_t)q[m] * taps;
        __m512d acc0 = _mm512_setzero_pd();
        __m512d acc1 = _mm512_setzero_pd();
        int t = 0;
        for (; t + 8 <= taps; t += 8) {
            const __m512d b0 = _mm512_permutexvar_pd(
                dup, _mm512_castpd256_pd512(
                    _mm256_loadu_pd(b + t)));
            const __m512d b1 = _mm512_permutexvar_pd(
                dup, _mm512_castpd256_pd512(
                    _mm256_loadu_pd(b + t + 4)));
            acc0 = _mm512_fmadd_pd(
                b0, _mm512_loadu_pd(h + t * 2), acc0);
            acc1 = _mm512_fmadd_pd(
                b1, _mm512_loadu_pd(h + t * 2 + 8), acc1);
        }
        const __m512d acc = _mm512_add_pd(acc0, acc1);
        alignas(64) double lanes[8];
        _mm512_store_pd(lanes, acc);
        double L = ((lanes[0] + lanes[2]) + (lanes[4] + lanes[6]));
        double R = ((lanes[1] + lanes[3]) + (lanes[5] + lanes[7]));
        for (; t < taps; t++) {
            L += b[t] * h[t * 2];
            R += b[t] * h[t * 2 + 1];
        }
        out[m * 2] = L;
        out[m * 2 + 1] = R;
    }
}
#endif  // ATPU_AVX512

}  // namespace

extern "C" void atpu_resample_fir(const double* hist,
                                  int64_t hist_len,
                                  int32_t channels,
                                  const int64_t* starts,
                                  const int32_t* q,
                                  const double* bank,
                                  int32_t taps,
                                  int64_t m_count,
                                  double* out) {
    (void)hist_len;
#ifdef ATPU_AVX512
    if (channels == 2 && taps >= 8) {
        resample_fir_stereo_avx(hist, starts, q, bank, taps, m_count,
                                out);
        return;
    }
#endif
    switch (channels) {
    case 1: resample_fir_t<1>(hist, starts, q, bank, taps, m_count,
                              out); return;
    case 2: resample_fir_t<2>(hist, starts, q, bank, taps, m_count,
                              out); return;
    default:
        for (int64_t m = 0; m < m_count; m++) {
            const double* h = hist + starts[m] * channels;
            const double* b = bank + (int64_t)q[m] * taps;
            for (int c = 0; c < channels; c++) {
                double acc = 0.0;
                for (int t = 0; t < taps; t++)
                    acc += b[t] * h[t * channels + c];
                out[m * channels + c] = acc;
            }
        }
    }
}

extern "C" {

// ------------------------------------------------- AccurateRip CRCs --
// Offset-windowed multiply-accumulate CRCs over CD PCM (reference
// src/accuraterip.c:44-326).  samples: int32 interleaved [n, 2],
// 16-bit range.  first_index is the 1-based index of samples[0]
// within the track; [start_offset, end_offset] is the inclusive
// window (first-track skip / last-track stop).  Accumulates into
// v1/v2 so chunked callers can fold this into a decode pass.
void atpu_accuraterip_update(const int32_t* samples,
                             int64_t n,
                             int64_t first_index,
                             int64_t start_offset,
                             int64_t end_offset,
                             uint32_t* v1,
                             uint32_t* v2) {
    uint32_t a1 = *v1, a2 = *v2;
    // hoist the offset-window test to the loop bounds: the inner
    // multiply-accumulate is then branchless and auto-vectorizes
    // (sums are mod-2^32 commutative, so lane order is free)
    int64_t i0 = start_offset - first_index;
    if (i0 < 0) i0 = 0;
    int64_t i1 = end_offset - first_index + 1;
    if (i1 > n) i1 = n;
    for (int64_t i = i0; i < i1; i++) {
        const int64_t idx = first_index + i;
        const uint32_t lo = (uint16_t)samples[2 * i];
        const uint32_t hi = (uint16_t)samples[2 * i + 1];
        const uint64_t p = (uint64_t)((hi << 16) | lo) * (uint64_t)idx;
        a1 += (uint32_t)p;
        a2 += (uint32_t)p + (uint32_t)(p >> 32);
    }
    *v1 = a1;
    *v2 = a2;
}


/* y[i] = b0*x[i] + z0; z[j] = b[j+1]*x[i] + z[j+1] - a[j+1]*y[i]
 * b, a: double[n]; z: double[n-1] in/out; x, y: double[len] */
void atpu_iir(const double* b, const double* a, int32_t n,
              const double* x, double* y, int64_t len, double* z) {
    for (int64_t i = 0; i < len; i++) {
        const double xi = x[i];
        const double yi = b[0] * xi + z[0];
        for (int32_t j = 0; j < n - 2; j++)
            z[j] = b[j + 1] * xi + z[j + 1] - a[j + 1] * yi;
        z[n - 2] = b[n - 1] * xi - a[n - 1] * yi;
        y[i] = yi;
    }
}

}  // extern "C"

// ======================================================================
// MPEG audio frame walker (role of reference src/verify/mpeg.c:1-351):
// validates sync/version/layer/bitrate/samplerate consistency frame by
// frame and accumulates stream statistics without decoding.

namespace mpeg {

// bitrate tables in kbps, [version][layer][index]; version 0 = MPEG1,
// 1 = MPEG2/2.5; layer index 0 = I, 1 = II, 2 = III
static const int BITRATES[2][3][16] = {
    {{0, 32, 64, 96, 128, 160, 192, 224, 256, 288, 320, 352, 384,
      416, 448, -1},
     {0, 32, 48, 56, 64, 80, 96, 112, 128, 160, 192, 224, 256, 320,
      384, -1},
     {0, 32, 40, 48, 56, 64, 80, 96, 112, 128, 160, 192, 224, 256,
      320, -1}},
    {{0, 32, 48, 56, 64, 80, 96, 112, 128, 144, 160, 176, 192, 224,
      256, -1},
     {0, 8, 16, 24, 32, 40, 48, 56, 64, 80, 96, 112, 128, 144, 160,
      -1},
     {0, 8, 16, 24, 32, 40, 48, 56, 64, 80, 96, 112, 128, 144, 160,
      -1}}};

static const int SAMPLERATES[4][4] = {
    {11025, 12000, 8000, -1},     // MPEG2.5
    {-1, -1, -1, -1},             // reserved
    {22050, 24000, 16000, -1},    // MPEG2
    {44100, 48000, 32000, -1}};   // MPEG1

struct FrameInfo {
    int64_t frame_size;
    int samples;
    int sample_rate;
    int channels;
    int layer;        // 1, 2, 3
    int version;      // 1 = MPEG1, 2 = MPEG2, 25 = MPEG2.5
};

// parses a 4-byte frame header; returns false if invalid
static bool parse_header(const uint8_t* p, FrameInfo* out) {
    if (p[0] != 0xFF || (p[1] & 0xE0) != 0xE0) return false;
    const int version_bits = (p[1] >> 3) & 3;
    const int layer_bits = (p[1] >> 1) & 3;
    const int bitrate_idx = (p[2] >> 4) & 0xF;
    const int rate_idx = (p[2] >> 2) & 3;
    const int padding = (p[2] >> 1) & 1;
    const int channel_mode = (p[3] >> 6) & 3;
    if (version_bits == 1 || layer_bits == 0) return false;
    if (bitrate_idx == 0 || bitrate_idx == 15) return false;
    const int layer = 4 - layer_bits;             // 1, 2, 3
    const bool mpeg1 = (version_bits == 3);
    const int sample_rate = SAMPLERATES[version_bits][rate_idx];
    if (sample_rate <= 0) return false;
    const int bitrate =
        BITRATES[mpeg1 ? 0 : 1][layer - 1][bitrate_idx] * 1000;
    if (bitrate <= 0) return false;

    int64_t frame_size;
    int samples;
    if (layer == 1) {
        frame_size = (12 * bitrate / sample_rate + padding) * 4;
        samples = 384;
    } else if (layer == 2) {
        frame_size = 144 * bitrate / sample_rate + padding;
        samples = 1152;
    } else {
        if (mpeg1) {
            frame_size = 144 * bitrate / sample_rate + padding;
            samples = 1152;
        } else {
            frame_size = 72 * bitrate / sample_rate + padding;
            samples = 576;
        }
    }
    out->frame_size = frame_size;
    out->samples = samples;
    out->sample_rate = sample_rate;
    out->channels = (channel_mode == 3) ? 1 : 2;
    out->layer = layer;
    out->version = mpeg1 ? 1 : (version_bits == 2 ? 2 : 25);
    return true;
}

}  // namespace mpeg

extern "C" {

// Walks an MPEG audio stream, validating frame headers.
//
// data/len: the complete file contents; leading ID3v2 and trailing
// ID3v1/APE tags are tolerated.  On success returns the number of
// frames and fills info[0..3] with (total_samples, sample_rate,
// channels, layer); returns a negative error code on corruption.
int64_t atpu_verify_mpeg(const uint8_t* data, int64_t len,
                         int64_t* info) {
    using namespace mpeg;
    int64_t pos = 0;
    // skip ID3v2 tags
    while (pos + 10 <= len && data[pos] == 'I' &&
           data[pos + 1] == 'D' && data[pos + 2] == '3' &&
           data[pos + 3] >= 2 && data[pos + 3] <= 4) {
        int64_t size = 0;
        for (int i = 6; i < 10; i++)
            size = (size << 7) | (data[pos + i] & 0x7F);
        pos += 10 + size;
    }
    // ignore trailing ID3v1
    int64_t end = len;
    if (end - pos >= 128 && end >= 128 &&
        data[end - 128] == 'T' && data[end - 127] == 'A' &&
        data[end - 126] == 'G')
        end -= 128;

    int64_t frames = 0;
    int64_t total_samples = 0;
    FrameInfo first{0, 0, 0, 0, 0, 0};
    while (pos < end) {
        if (pos + 4 > end) {
            // trailing partial bytes are corruption unless tag-like
            return frames > 0 ? -2 : -1;
        }
        FrameInfo fi;
        if (!parse_header(data + pos, &fi)) {
            // tolerate trailing APE tags
            if (end - pos >= 8 &&
                memcmp(data + pos, "APETAGEX", 8) == 0)
                break;
            if (end - pos >= 9 &&
                memcmp(data + pos, "LYRICSBEG", 9) == 0)
                break;
            return frames > 0 ? -2 : -1;
        }
        if (frames == 0) {
            first = fi;
        } else if (fi.sample_rate != first.sample_rate ||
                   fi.layer != first.layer) {
            return -3;
        }
        if (pos + fi.frame_size > end) return -4;   // truncated frame
        total_samples += fi.samples;
        pos += fi.frame_size;
        frames += 1;
    }
    if (frames == 0) return -1;
    if (info != nullptr) {
        info[0] = total_samples;
        info[1] = first.sample_rate;
        info[2] = first.channels;
        info[3] = first.layer;
    }
    return frames;
}

}  // extern "C"

/* ====================================================================
 * MLP (Meridian Lossless Packing) decoder
 *
 * Fast path mirroring the scalar oracle in ref/mlp.py; a copy of the
 * reference package's MLP decoder (its src/decoders/mlp.c:124-1109
 * rebuild).  Frames of 1-2 substreams; blocks carry restart
 * headers, decoding parameters and Huffman-coded residuals which are
 * reconstructed through FIR/IIR filters, rematrixed with seeded
 * noise and reordered to WAVE channel order.
 * ==================================================================== */

namespace mlp {


constexpr int MAXCH = 8;

/* MLP channel index -> WAVE channel index per 5-bit assignment
 * (reference mlp.c:169-191) */
static const int8_t WAVE_CHANNEL[0x15][6] = {
    {0, -1, -1, -1, -1, -1}, {0, 1, -1, -1, -1, -1},
    {0, 1, 2, -1, -1, -1},   {0, 1, 2, 3, -1, -1},
    {0, 1, 2, -1, -1, -1},   {0, 1, 2, 3, -1, -1},
    {0, 1, 2, 3, 4, -1},     {0, 1, 2, -1, -1, -1},
    {0, 1, 2, 3, -1, -1},    {0, 1, 2, 3, 4, -1},
    {0, 1, 2, 3, -1, -1},    {0, 1, 2, 3, 4, -1},
    {0, 1, 2, 3, 4, 5},      {0, 1, 2, 3, -1, -1},
    {0, 1, 2, 3, 4, -1},     {0, 1, 2, 3, -1, -1},
    {0, 1, 2, 3, 4, -1},     {0, 1, 2, 3, 4, 5},
    {0, 1, 3, 4, 2, -1},     {0, 1, 3, 4, 2, -1},
    {0, 1, 4, 5, 2, 3}};

static const int CHANNEL_COUNT[0x15] =
    {1, 2, 3, 4, 3, 4, 5, 3, 4, 5, 4, 5, 6, 4, 5, 4, 5, 6, 5, 5, 6};

static const int BPS[3] = {16, 20, 24};

static int sample_rate_of(unsigned field) {
    switch (field) {
    case 0: return 48000;
    case 1: return 96000;
    case 2: return 192000;
    case 8: return 44100;
    case 9: return 88200;
    case 10: return 176400;
    default: return 0;
    }
}

/* MSB-first CRC-8 over polynomial x^8+x^6+x^5+x+1, init 0x3C
 * (derived, not copied, from the reference's table) */
struct Checkdata {
    uint8_t parity = 0;
    uint8_t crc = 0x3C;
    uint8_t final_crc = 0;

    static const uint8_t* table() {
        static uint8_t t[256];
        static bool built = false;
        if (!built) {
            for (int i = 0; i < 256; i++) {
                unsigned crc = (unsigned)i;
                for (int b = 0; b < 8; b++)
                    crc = (crc & 0x80) ? (((crc << 1) ^ 0x63) & 0xFF)
                                       : ((crc << 1) & 0xFF);
                t[i] = (uint8_t)crc;
            }
            built = true;
        }
        return t;
    }

    void update(const uint8_t* data, int64_t n) {
        const uint8_t* t = table();
        for (int64_t i = 0; i < n; i++) {
            parity ^= data[i];
            final_crc = crc ^ data[i];
            crc = t[final_crc];
        }
    }
};

/* algebraic form of the three Huffman codebooks (see ref/mlp.py):
 * leading 1 -> dense values from 7; 01 0^m 1 -> top+m;
 * 00 0^z 1 -> 6-z */
static const int BOOK_DENSE[4] = {0, 2, 1, 0};
static const int BOOK_TOP[4] = {0, 11, 9, 8};

static inline int read_huff(BitReader& r, unsigned book) {
    if (r.get(1)) {
        const int dense = BOOK_DENSE[book];
        return 7 + (dense ? (int)r.get(dense) : 0);
    }
    if (r.get(1)) {
        int m = 0;
        while (!r.get(1)) {
            if (++m > 6 || r.error) return INT32_MIN;
        }
        return BOOK_TOP[book] + m;
    }
    int z = 0;
    while (!r.get(1)) {
        if (++z > 6 || r.error) return INT32_MIN;
    }
    return 6 - z;
}

static inline int64_t mask_q(int64_t x, unsigned q) {
    return q ? ((x >> q) << q) : x;
}

struct Filter {
    unsigned shift = 0;
    int order = 0;
    int32_t coeff[8] = {0};
    int64_t state[8] = {0};    // state[7] is the most recent value

    void push(int64_t v) {
        for (int i = 0; i < 7; i++) state[i] = state[i + 1];
        state[7] = v;
    }
    void reset_state() {
        for (int i = 0; i < 8; i++) state[i] = 0;
    }
};

struct Channel {
    Filter fir, iir;
    int huffman_offset = 0;
    unsigned codebook = 0;
    unsigned huffman_lsbs = 24;
};

struct Matrix {
    unsigned out_channel = 0;
    unsigned lsb_bypass = 0;
    int32_t coeff[MAXCH] = {0};
    std::vector<uint8_t> bypassed;
};

struct Substream {
    unsigned min_channel = 0, max_channel = 0, max_matrix_channel = 0;
    unsigned noise_shift = 0;
    uint32_t noise_seed = 0;
    unsigned flags[8] = {1, 1, 1, 1, 1, 1, 1, 1};
    unsigned block_size = 8;
    std::vector<Matrix> matrix;
    int output_shift[MAXCH] = {0};
    unsigned quant[MAXCH] = {0};
    Channel channel[MAXCH];
};

struct Context {
    bool has_sync = false;
    unsigned assignment = 0;
    int channels = 0;
    int bits_per_sample = 0;
    int sample_rate = 0;
    unsigned substream_count = 0;
    Substream ss[2];
    std::vector<int64_t> chan[MAXCH];
};

enum {
    ERR_INVALID = -1,
    ERR_PARITY = -2,
    ERR_CRC8 = -3,
    ERR_IO = -4,
    ERR_OVERFLOW = -5,
    ERR_MAJOR_SYNC = -6,
};

static int read_restart_header(BitReader& r, Substream& ss) {
    const unsigned sync = (unsigned)r.get(13);
    const unsigned noise_type = (unsigned)r.get(1);
    r.get(16);                              /* output timestamp */
    ss.min_channel = (unsigned)r.get(4);
    ss.max_channel = (unsigned)r.get(4);
    ss.max_matrix_channel = (unsigned)r.get(4);
    ss.noise_shift = (unsigned)r.get(4);
    ss.noise_seed = (uint32_t)r.get(23);
    r.get(19);
    r.get(1);
    r.get(8);
    r.get(16);
    if (sync != 0x18F5 || noise_type != 0) return ERR_INVALID;
    if (ss.max_channel < ss.min_channel ||
        ss.max_matrix_channel < ss.max_channel ||
        ss.max_matrix_channel >= MAXCH)
        return ERR_INVALID;
    for (unsigned c = 0; c <= ss.max_matrix_channel; c++) {
        if (r.get(6) > ss.max_matrix_channel) return ERR_INVALID;
    }
    r.get(8);                               /* checksum */
    return r.error ? ERR_IO : 0;
}

static int read_filter(BitReader& r, Filter& f, bool is_iir) {
    const unsigned order = (unsigned)r.get(4);
    if (order > 8) return ERR_INVALID;
    if (order == 0) {
        f.shift = 0;
        f.order = 0;
        if (is_iir) f.reset_state();
        return 0;
    }
    f.shift = (unsigned)r.get(4);
    const unsigned coeff_bits = (unsigned)r.get(5);
    if (coeff_bits < 1 || coeff_bits > 16) return ERR_INVALID;
    const unsigned coeff_shift = (unsigned)r.get(3);
    if (coeff_bits + coeff_shift > 16) return ERR_INVALID;
    f.order = (int)order;
    for (unsigned i = 0; i < order; i++)
        f.coeff[i] = (int32_t)(r.get_signed(coeff_bits) << coeff_shift);
    if (is_iir) {
        f.reset_state();
        if (r.get(1)) {
            const unsigned state_bits = (unsigned)r.get(4);
            const unsigned state_shift = (unsigned)r.get(4);
            /* values appended then reversed: the first value read
               lands closest to the present (state[7]) */
            for (unsigned i = 0; i < order; i++) {
                const int64_t v = state_bits
                    ? (r.get_signed(state_bits) << state_shift) : 0;
                f.state[7 - i] = v;
            }
        }
    } else if (r.get(1)) {
        return ERR_INVALID;
    }
    return r.error ? ERR_IO : 0;
}

static int read_matrix_params(BitReader& r, Substream& ss) {
    const unsigned count = (unsigned)r.get(4);
    ss.matrix.clear();
    for (unsigned m = 0; m < count; m++) {
        Matrix mat;
        mat.out_channel = (unsigned)r.get(4);
        if (mat.out_channel > ss.max_matrix_channel) return ERR_INVALID;
        const unsigned fractional_bits = (unsigned)r.get(4);
        if (fractional_bits > 14) return ERR_INVALID;
        mat.lsb_bypass = (unsigned)r.get(1);
        for (unsigned c = 0; c < ss.max_matrix_channel + 3u; c++) {
            if (r.get(1)) {
                const int64_t v = r.get_signed(fractional_bits + 2);
                mat.coeff[c] = (int32_t)(v << (14 - fractional_bits));
            } else {
                mat.coeff[c] = 0;
            }
        }
        ss.matrix.push_back(mat);
    }
    return r.error ? ERR_IO : 0;
}

static int read_decoding_parameters(BitReader& r, bool header_present,
                                    Substream& ss) {
    int err;
    if (header_present) {
        if (r.get(1)) {
            for (int i = 0; i < 8; i++) ss.flags[i] = (unsigned)r.get(1);
        } else {
            for (int i = 0; i < 8; i++) ss.flags[i] = 1;
        }
    } else if (ss.flags[0] && r.get(1)) {
        for (int i = 0; i < 8; i++) ss.flags[i] = (unsigned)r.get(1);
    }

    if (ss.flags[7] && r.get(1)) {
        ss.block_size = (unsigned)r.get(9);
        if (ss.block_size < 8) return ERR_INVALID;
    } else if (header_present) {
        ss.block_size = 8;
    }

    if (ss.flags[6] && r.get(1)) {
        if ((err = read_matrix_params(r, ss)) != 0) return err;
    } else if (header_present) {
        ss.matrix.clear();
    }

    if (ss.flags[5] && r.get(1)) {
        for (unsigned c = 0; c <= ss.max_matrix_channel; c++)
            ss.output_shift[c] = (int)r.get_signed(4);
    } else if (header_present) {
        for (int c = 0; c < MAXCH; c++) ss.output_shift[c] = 0;
    }

    if (ss.flags[4] && r.get(1)) {
        for (unsigned c = 0; c <= ss.max_channel; c++)
            ss.quant[c] = (unsigned)r.get(4);
    } else if (header_present) {
        for (int c = 0; c < MAXCH; c++) ss.quant[c] = 0;
    }

    for (unsigned c = ss.min_channel; c <= ss.max_channel; c++) {
        Channel& ch = ss.channel[c];
        if (r.get(1)) {
            if (ss.flags[3] && r.get(1)) {
                if ((err = read_filter(r, ch.fir, false)) != 0)
                    return err;
            } else if (header_present) {
                ch.fir.shift = 0;
                ch.fir.order = 0;
            }
            if (ss.flags[2] && r.get(1)) {
                if ((err = read_filter(r, ch.iir, true)) != 0)
                    return err;
            } else if (header_present) {
                ch.iir.shift = 0;
                ch.iir.order = 0;
                ch.iir.reset_state();
            }
            if (ss.flags[1] && r.get(1)) {
                ch.huffman_offset = (int)r.get_signed(15);
            } else if (header_present) {
                ch.huffman_offset = 0;
            }
            ch.codebook = (unsigned)r.get(2);
            ch.huffman_lsbs = (unsigned)r.get(5);
            if (ch.huffman_lsbs > 24) return ERR_INVALID;
        } else if (header_present) {
            ch.fir.shift = 0;
            ch.fir.order = 0;
            ch.iir.shift = 0;
            ch.iir.order = 0;
            ch.iir.reset_state();
            ch.huffman_offset = 0;
            ch.codebook = 0;
            ch.huffman_lsbs = 24;
        }
    }
    return r.error ? ERR_IO : 0;
}

static int read_block(BitReader& r, Substream& ss,
                      std::vector<int64_t>* chan) {
    int err;
    if (r.get(1)) {
        const bool header_present = r.get(1) != 0;
        if (header_present) {
            if ((err = read_restart_header(r, ss)) != 0) return err;
            /* a restart resets all filter warm-up state */
            for (int c = 0; c < MAXCH; c++) {
                ss.channel[c].fir.reset_state();
                ss.channel[c].iir.reset_state();
            }
        }
        if ((err = read_decoding_parameters(r, header_present, ss))
            != 0)
            return err;
    }

    /* per-channel entropy parameters (reference mlp.c:893-918) */
    int lsb_bits[MAXCH];
    int64_t offsets[MAXCH];
    for (unsigned c = ss.min_channel; c <= ss.max_channel; c++) {
        const Channel& ch = ss.channel[c];
        lsb_bits[c] = (int)ch.huffman_lsbs - (int)ss.quant[c];
        if (lsb_bits[c] < 0) return ERR_INVALID;
        if (ch.codebook) {
            const int sign_shift = lsb_bits[c] + 2 - (int)ch.codebook;
            offsets[c] = (int64_t)ch.huffman_offset -
                         (7LL << lsb_bits[c]) -
                         (sign_shift >= 0 ? (1LL << sign_shift) : 0);
        } else {
            const int sign_shift = lsb_bits[c] - 1;
            offsets[c] = (int64_t)ch.huffman_offset -
                         (sign_shift >= 0 ? (1LL << sign_shift) : 0);
        }
    }

    /* residual decode + filtering, fused per sample per channel */
    const unsigned n = ss.block_size;
    std::vector<int64_t> residual[MAXCH];
    for (unsigned c = ss.min_channel; c <= ss.max_channel; c++)
        residual[c].resize(n);
    for (auto& m : ss.matrix) m.bypassed.reserve(m.bypassed.size() + n);

    for (unsigned i = 0; i < n; i++) {
        for (auto& m : ss.matrix)
            m.bypassed.push_back(
                m.lsb_bypass ? (uint8_t)r.get(1) : 0);
        for (unsigned c = ss.min_channel; c <= ss.max_channel; c++) {
            const Channel& ch = ss.channel[c];
            int msb = 0;
            if (ch.codebook) {
                msb = read_huff(r, ch.codebook);
                if (msb == INT32_MIN) return ERR_INVALID;
            }
            const int64_t lsb =
                lsb_bits[c] ? (int64_t)r.get(lsb_bits[c]) : 0;
            residual[c][i] =
                (((int64_t)msb << lsb_bits[c]) + lsb + offsets[c])
                << ss.quant[c];
        }
    }
    if (r.error) return ERR_IO;

    /* FIR/IIR reconstruction (reference mlp.c:994) */
    for (unsigned c = ss.min_channel; c <= ss.max_channel; c++) {
        Channel& ch = ss.channel[c];
        if (ch.fir.order + ch.iir.order > 8) return ERR_INVALID;
        unsigned shift;
        if (ch.fir.shift > 0 && ch.iir.shift > 0) {
            if (ch.fir.shift != ch.iir.shift) return ERR_INVALID;
            shift = ch.fir.shift;
        } else if (ch.fir.order > 0) {
            shift = ch.fir.shift;
        } else {
            shift = ch.iir.shift;
        }
        std::vector<int64_t>& out = chan[c];
        for (unsigned i = 0; i < n; i++) {
            int64_t acc = 0;
            for (int j = 0; j < ch.fir.order; j++)
                acc += (int64_t)ch.fir.coeff[j] * ch.fir.state[7 - j];
            for (int k = 0; k < ch.iir.order; k++)
                acc += (int64_t)ch.iir.coeff[k] * ch.iir.state[7 - k];
            const int64_t shifted = acc >> shift;
            const int64_t value =
                mask_q(shifted + residual[c][i], ss.quant[c]);
            out.push_back(value);
            ch.fir.push(value);
            ch.iir.push(value - shifted);
        }
    }
    return 0;
}

static void rematrix(std::vector<int64_t>* chan, Substream& ss) {
    const size_t n = chan[0].size();
    uint32_t seed = ss.noise_seed;
    std::vector<int64_t> noise0(n), noise1(n);
    for (size_t i = 0; i < n; i++) {
        const uint32_t shifted = (seed >> 7) & 0xFFFF;
        noise0[i] = (int64_t)((int8_t)(seed >> 15)) << ss.noise_shift;
        noise1[i] = (int64_t)((int8_t)shifted) << ss.noise_shift;
        seed = ((seed << 16) ^ shifted ^ (shifted << 5));
    }
    ss.noise_seed = seed;

    const unsigned mmc = ss.max_matrix_channel;
    for (auto& m : ss.matrix) {
        for (size_t i = 0; i < n; i++) {
            int64_t acc = 0;
            for (unsigned c = 0; c <= mmc; c++)
                acc += chan[c][i] * (int64_t)m.coeff[c];
            acc += noise0[i] * (int64_t)m.coeff[mmc + 1];
            acc += noise1[i] * (int64_t)m.coeff[mmc + 2];
            chan[m.out_channel][i] =
                mask_q(acc >> 14, ss.quant[m.out_channel]) +
                (m.bypassed.empty() ? 0 : (int64_t)m.bypassed[i]);
        }
    }
}

/* decodes one frame body (without the 4-byte length header);
 * appends WAVE-ordered interleaved samples to out; returns PCM
 * frames decoded or a negative error */
static int64_t decode_frame(Context& ctx, const uint8_t* frame,
                            int64_t frame_len, int32_t* out,
                            int64_t out_cap) {
    BitReader r(frame, frame_len);

    /* major sync (reference mlp.c:415) */
    if (frame_len >= 28 && frame[0] == 0xF8 && frame[1] == 0x72 &&
        frame[2] == 0x6F && frame[3] == 0xBB) {
        r.get(32);
        const unsigned bps0 = (unsigned)r.get(4);
        r.get(4);
        const unsigned rate0 = (unsigned)r.get(4);
        r.get(4);
        r.get(11);
        const unsigned assignment = (unsigned)r.get(5);
        r.get(48);
        r.get(1);
        r.get(15);
        const unsigned substreams = (unsigned)r.get(4);
        /* 92 pad bits */
        r.get(56); r.get(36);
        if (substreams != 1 && substreams != 2) return ERR_MAJOR_SYNC;
        if (assignment > 0x14 || bps0 > 2 ||
            sample_rate_of(rate0) == 0)
            return ERR_MAJOR_SYNC;
        if (ctx.has_sync) {
            if ((int)assignment != (int)ctx.assignment ||
                BPS[bps0] != ctx.bits_per_sample ||
                sample_rate_of(rate0) != ctx.sample_rate ||
                substreams != ctx.substream_count)
                return ERR_MAJOR_SYNC;
        } else {
            ctx.has_sync = true;
            ctx.assignment = assignment;
            ctx.bits_per_sample = BPS[bps0];
            ctx.sample_rate = sample_rate_of(rate0);
            ctx.channels = CHANNEL_COUNT[assignment];
            ctx.substream_count = substreams;
        }
    }
    if (!ctx.has_sync) return ERR_MAJOR_SYNC;

    /* substream info blocks */
    unsigned checkdata_present[2] = {0, 0};
    unsigned substream_end[2] = {0, 0};
    for (unsigned s = 0; s < ctx.substream_count; s++) {
        const unsigned extraword = (unsigned)r.get(1);
        r.get(1);                           /* nonrestart */
        checkdata_present[s] = (unsigned)r.get(1);
        r.get(1);
        substream_end[s] = (unsigned)r.get(12) * 2;
        if (extraword) return ERR_INVALID;
    }
    if (r.error) return ERR_IO;

    for (int c = 0; c < MAXCH; c++) ctx.chan[c].clear();

    int64_t data_start = r.byte_pos();
    unsigned offset = 0;
    for (unsigned s = 0; s < ctx.substream_count; s++) {
        const unsigned end = substream_end[s];
        if (end < offset) return ERR_INVALID;
        unsigned length = end - offset;
        offset = end;
        if (data_start + length > frame_len) return ERR_IO;
        const uint8_t* data = frame + data_start;
        data_start += length;
        if (checkdata_present[s]) {
            if (length < 2) return ERR_INVALID;
            length -= 2;
            Checkdata check;
            check.update(data, length);
            const uint8_t parity = data[length];
            const uint8_t crc8 = data[length + 1];
            if ((uint8_t)(parity ^ check.parity) != 0xA9)
                return ERR_PARITY;
            if (check.final_crc != crc8) return ERR_CRC8;
        }

        Substream& ss = ctx.ss[s];
        for (auto& m : ss.matrix) m.bypassed.clear();
        BitReader sub(data, length);
        for (;;) {
            const int err = read_block(sub, ss, ctx.chan);
            if (err != 0) return err;
            if (sub.get(1)) break;
            if (sub.error) return ERR_IO;
        }
    }

    /* rematrix with the last substream's parameters, apply output
     * shifts, reorder to WAVE order */
    Substream& ss = ctx.ss[ctx.substream_count - 1];
    const int64_t n = (int64_t)ctx.chan[0].size();
    if (n > 0) rematrix(ctx.chan, ss);
    for (unsigned c = 0; c <= ss.max_matrix_channel; c++) {
        const int shift = ss.output_shift[c];
        if (shift > 0) {
            for (auto& v : ctx.chan[c]) v <<= shift;
        } else if (shift < 0) {
            for (auto& v : ctx.chan[c]) v >>= -shift;
        }
    }

    if (n * ctx.channels > out_cap) return ERR_OVERFLOW;
    const int8_t* order = WAVE_CHANNEL[ctx.assignment];
    for (int c = 0; c < ctx.channels; c++) {
        const int w = order[c];
        const std::vector<int64_t>& src = ctx.chan[c];
        for (int64_t i = 0; i < n; i++)
            out[i * ctx.channels + w] = (int32_t)src[i];
    }
    return n;
}

}  // namespace mlp

extern "C" {

void* atpu_mlp_new(void) { return new mlp::Context(); }

void atpu_mlp_free(void* ctx) {
    delete static_cast<mlp::Context*>(ctx);
}

/* decodes every whole length-prefixed MLP frame in data;
 * out receives WAVE-ordered interleaved int32 samples.
 * info[0..3] = {sample_rate, channels, bits_per_sample, consumed}.
 * returns total PCM frames decoded, or a negative error code. */
int64_t atpu_mlp_decode(void* ctx_ptr, const uint8_t* data,
                        int64_t data_len, int32_t* out,
                        int64_t out_cap, int64_t* info) {
    mlp::Context& ctx = *static_cast<mlp::Context*>(ctx_ptr);
    int64_t pos = 0;
    int64_t total = 0;
    while (pos + 4 <= data_len) {
        const unsigned total_frame_size =
            ((unsigned)(data[pos] & 0x0F) << 8) | data[pos + 1];
        const int64_t frame_bytes = (int64_t)total_frame_size * 2;
        if (frame_bytes < 4 || pos + frame_bytes > data_len) break;
        const int64_t n = mlp::decode_frame(
            ctx, data + pos + 4, frame_bytes - 4,
            out + total * (ctx.channels ? ctx.channels : 1),
            out_cap - total * (ctx.channels ? ctx.channels : 1));
        if (n < 0) return n;
        total += n;
        pos += frame_bytes;
    }
    info[0] = ctx.sample_rate;
    info[1] = ctx.channels;
    info[2] = ctx.bits_per_sample;
    info[3] = pos;
    return total;
}

}  // extern "C"
