"""Scalar FLAC frame encoder: the oracle the batched encoder uses for
the short tail block, and the STREAMINFO and header serializers.

Copy of the reference package's ``ref/flac_enc.py``, trimmed to
``encode_frame``, ``build_streaminfo`` and what they call.  Bits are
serialized as (value, nbits) tokens packed MSB-first; unary codes are
single tokens with implicit leading zeros.
"""

from __future__ import annotations

import numpy as np

from .crc import CRC8_TABLE, CRC16_TABLE

class EncodingOptions:
    """FLAC encoding parameters (reference py_encoders/flac.py:65)"""

    def __init__(self, block_size=4096, max_lpc_order=8,
                 adaptive_mid_side=False, mid_side=True,
                 exhaustive_model_search=False,
                 min_residual_partition_order=0,
                 max_residual_partition_order=5,
                 max_rice_parameter=14,
                 disable_verbatim_subframes=False,
                 disable_constant_subframes=False,
                 disable_fixed_subframes=False,
                 disable_lpc_subframes=False):
        self.block_size = block_size
        self.max_lpc_order = max_lpc_order
        self.adaptive_mid_side = adaptive_mid_side
        self.mid_side = mid_side
        self.exhaustive_model_search = exhaustive_model_search
        self.min_residual_partition_order = min_residual_partition_order
        self.max_residual_partition_order = max_residual_partition_order
        self.max_rice_parameter = max_rice_parameter
        self.disable_verbatim_subframes = disable_verbatim_subframes
        self.disable_constant_subframes = disable_constant_subframes
        self.disable_fixed_subframes = disable_fixed_subframes
        self.disable_lpc_subframes = disable_lpc_subframes

        # qlp precision from block size (reference py_encoders/flac.py:79)
        if block_size <= 192:
            self.qlp_precision = 7
        elif block_size <= 384:
            self.qlp_precision = 8
        elif block_size <= 576:
            self.qlp_precision = 9
        elif block_size <= 1152:
            self.qlp_precision = 10
        elif block_size <= 2304:
            self.qlp_precision = 11
        elif block_size <= 4608:
            self.qlp_precision = 12
        else:
            self.qlp_precision = 13


class TokenStream:
    """accumulates (value, nbits) big-endian bit tokens

    unary-coded values are single tokens whose leading zeros are implicit
    (nbits may exceed the payload's significant bits)
    """

    def __init__(self):
        self.values = []
        self.nbits = []
        self._bits = 0

    def write(self, nbits, value):
        assert value >= 0 and (value >> nbits) == 0
        self.values.append(value)
        self.nbits.append(nbits)
        self._bits += nbits

    def write_signed(self, nbits, value):
        limit = 1 << (nbits - 1)
        assert -limit <= value < limit
        self.write(nbits, value + (1 << nbits) if value < 0 else value)

    def unary(self, value):
        """writes value zero bits then a 1 bit (FLAC rice MSB form)"""
        self.values.append(1)
        self.nbits.append(value + 1)
        self._bits += value + 1

    def extend(self, other):
        self.values.extend(other.values)
        self.nbits.extend(other.nbits)
        self._bits += other._bits

    def extend_arrays(self, values, nbits):
        self.values.extend(values.tolist())
        self.nbits.extend(nbits.tolist())
        self._bits += int(np.sum(nbits))

    def bits(self):
        return self._bits

    def to_bytes(self):
        """packs the tokens MSB-first, zero-padding to a byte boundary"""
        return pack_tokens(self.values, self.nbits)


def pack_tokens(values, nbits):
    """packs (value, nbits) tokens MSB-first into bytes (zero-padded)"""
    # build one big integer; Python bignum shifts are fast enough
    # for the oracle (the production path uses the C++ packer)
    acc = 1  # sentinel top bit to preserve leading zeros
    for (v, n) in zip(values, nbits):
        acc = (acc << n) | v
    total_bits = acc.bit_length() - 1
    pad = (-total_bits) % 8
    acc <<= pad
    total_bits += pad
    data = acc.to_bytes((total_bits // 8) + 1, "big")[1:]
    return data


def crc8(data):
    value = 0
    table = CRC8_TABLE
    for byte in data:
        value = int(table[value ^ byte])
    return value


def crc16(data):
    value = 0
    table = CRC16_TABLE
    for byte in data:
        value = int(table[(value >> 8) ^ byte] ^ ((value << 8) & 0xFFFF))
    return value


def build_streaminfo(minimum_block_size, maximum_block_size,
                     minimum_frame_size, maximum_frame_size,
                     sample_rate, channels, bits_per_sample,
                     total_pcm_frames, md5sum):
    """returns the 34-byte STREAMINFO block body"""
    t = TokenStream()
    t.write(16, minimum_block_size)
    t.write(16, maximum_block_size)
    t.write(24, minimum_frame_size)
    t.write(24, maximum_frame_size)
    t.write(20, sample_rate)
    t.write(3, channels - 1)
    t.write(5, bits_per_sample - 1)
    t.write(36, total_pcm_frames)
    data = t.to_bytes()
    return data + md5sum


def frame_header_tokens(pcmreader, frame_number, block_size, assignment):
    """builds the frame header token stream (minus CRC-8)"""
    t = TokenStream()
    t.write(14, 0x3FFE)
    t.write(1, 0)
    t.write(1, 0)

    encoded_block_size = {192: 1, 256: 8, 512: 9, 576: 2,
                          1024: 10, 1152: 3, 2048: 11, 2304: 4,
                          4096: 12, 4608: 5, 8192: 13, 16384: 14,
                          32768: 15}.get(block_size)
    if encoded_block_size is None:
        if block_size <= 256:
            encoded_block_size = 6
        elif block_size <= 65536:
            encoded_block_size = 7
        else:
            encoded_block_size = 0
    t.write(4, encoded_block_size)

    encoded_sample_rate = {8000: 4, 16000: 5, 22050: 6, 24000: 7,
                           32000: 8, 44100: 9, 48000: 10, 88200: 1,
                           96000: 11, 176400: 2, 192000: 3}.get(
                               pcmreader.sample_rate)
    if encoded_sample_rate is None:
        if ((pcmreader.sample_rate % 1000 == 0) and
                (pcmreader.sample_rate <= 255000)):
            encoded_sample_rate = 12
        elif ((pcmreader.sample_rate % 10 == 0) and
                (pcmreader.sample_rate <= 655350)):
            encoded_sample_rate = 14
        elif pcmreader.sample_rate <= 65535:
            encoded_sample_rate = 13
        else:
            encoded_sample_rate = 0
    t.write(4, encoded_sample_rate)

    t.write(4, assignment)

    t.write(3, {8: 1, 12: 2, 16: 4, 20: 5, 24: 6}.get(
        pcmreader.bits_per_sample, 0))
    t.write(1, 0)

    write_utf8(t, frame_number)

    if encoded_block_size == 6:
        t.write(8, block_size - 1)
    elif encoded_block_size == 7:
        t.write(16, block_size - 1)

    if encoded_sample_rate == 12:
        t.write(8, pcmreader.sample_rate % 1000)
    elif encoded_sample_rate == 13:
        t.write(16, pcmreader.sample_rate)
    elif encoded_sample_rate == 14:
        t.write(16, pcmreader.sample_rate % 10)

    return t


def write_utf8(t, value):
    """writes a UTF-8 encoded frame number to a TokenStream"""
    if value <= 127:
        t.write(8, value)
    else:
        if value <= 2047:
            total_bytes = 2
        elif value <= 65535:
            total_bytes = 3
        elif value <= 2097151:
            total_bytes = 4
        elif value <= 67108863:
            total_bytes = 5
        elif value <= 2147483647:
            total_bytes = 6
        else:
            raise ValueError("UTF-8 value too large")

        shift = (total_bytes - 1) * 6
        # total_bytes 1-bits then a 0 bit
        t.write(total_bytes + 1, ((1 << total_bytes) - 1) << 1)
        t.write(7 - total_bytes, value >> shift)
        shift -= 6
        while shift >= 0:
            t.write(2, 2)
            t.write(6, (value >> shift) & 0x3F)
            shift -= 6


def write_wasted(t, wasted_bps):
    if wasted_bps > 0:
        t.write(1, 1)
        # unary with stop bit 1: (wasted_bps - 1) zeros then a 1
        t.unary(wasted_bps - 1)
    else:
        t.write(1, 0)


FC_TABLE = {0: [], 1: [1], 2: [2, -1], 3: [3, -3, 1], 4: [4, -6, 4, -1]}


def exact_residuals(samples, coeffs, shift):
    """exact int64 residuals for a FIXED/LPC predictor

    r[i] = s[i] - (sum_j coeffs[j] * s[i-1-j] >> shift), aligned at
    absolute positions (entries below the order are zero).  This is
    the *written* residual path — identical to the C++ emitter's int64
    recompute (_native/hostkernels.cpp) — and is exact regardless of
    the analysis backend's precision, keeping streams lossless."""
    order = len(coeffs)
    n = len(samples)
    out = np.zeros(n, dtype=np.int64)
    if order == 0:
        return samples.astype(np.int64)
    pred = np.zeros(n - order, dtype=np.int64)
    s = samples.astype(np.int64)
    for (j, c) in enumerate(coeffs):
        pred += int(c) * s[order - 1 - j:n - 1 - j]
    out[order:] = s[order:] - (pred >> shift)
    return out


def emit_exact_rice_enabled():
    """whether the emit-stage exact entropy re-search is active
    (default on): the final (porder, Rice params) of every FIXED/LPC
    subframe are re-searched EXACTLY on the exact residuals at
    serialization time, independent of the (possibly
    quantized-upload) analysis that chose the predictor.  Pure-int64
    spec shared with the C++ emitter
    (_native/hostkernels.cpp emit_rice_research)."""
    import os
    return os.environ.get("ATPU_EMIT_EXACT_RICE", "1") != "0"


def emit_rice_search(res_aligned, order, n, porders, max_rice):
    """emit-stage EXACT Rice entropy search (pure-int64 spec)

    res_aligned: int64 [n] residuals at absolute positions (warmup
    entries < order are zero).  Searches every (porder in porders,
    partition, parameter in 0..max_rice) triple over the EXACT coded
    cost count*(1+r) + sum(u >> r), partition header 4 bits each plus
    one extra bit per partition when any chosen parameter escapes to
    coding method 1.  First minimum wins on both axes (strict <,
    ascending porder / ascending r).  Returns (porder, params list).

    The parameter axis is WINDOWED (spec shared with the C++
    emit_rice_research): each finest partition's abs-sum threshold
    rt (smallest r with count * 2^r >= sum(u), capped at max_rice)
    bounds the scan to the subframe-global window
    [min_p(rt_p) - 3, max_p(rt_p) + 3] — the exact optimum sits
    within +-1 of rt in all but adversarial cases, and coarser
    partition unions' thresholds stay between their children's.
    First minimum WITHIN the window wins on both axes.

    This is the stage the C++ emitter mirrors bit-exactly; unlike the
    analysis-stage ``ref/flac_analysis._rice_search`` it runs on
    exact residuals and in pure integer arithmetic, so byte-identity
    never depends on float tie-breaking."""
    u = np.where(res_aligned >= 0,
                 res_aligned << 1,
                 ((-res_aligned - 1) << 1) | 1).astype(np.int64)
    pmax = porders[-1]
    parts_f = 1 << pmax
    psize_f = n >> pmax
    seg0 = u.reshape(parts_f, psize_f).sum(axis=1)
    counts_f = np.full(parts_f, psize_f, dtype=np.int64)
    counts_f[0] = psize_f - order
    rt = np.zeros(parts_f, dtype=np.int64)
    for rr in range(max_rice):
        rt += (counts_f << rr) < seg0
    rlo = max(int(rt.min()) - 3, 0)
    rhi = min(int(rt.max()) + 3, max_rice)
    best = None
    for porder in porders:
        parts = 1 << porder
        psize = n >> porder
        useg = u.reshape(parts, psize)
        counts = np.full(parts, psize, dtype=np.int64)
        counts[0] = psize - order
        cand = np.stack(
            [(useg >> rr).sum(axis=1) + counts * (1 + rr)
             for rr in range(rlo, rhi + 1)], axis=1)   # [parts, R']
        ridx = np.argmin(cand, axis=1)                 # first min
        r = ridx + rlo
        total = int(cand[np.arange(parts), ridx].sum()) + 4 * parts
        if int(r.max()) > 14:
            total += parts
        if best is None or total < best[2]:
            best = (porder, [int(v) for v in r], total)
    return (best[0], best[1])


def write_residual_block(t, block_size, order, porder, params,
                         res_aligned):
    """writes a residual partition block from chosen parameters

    res_aligned: int64 [block_size] residuals at absolute positions"""
    n_partitions = 1 << porder
    coding_method = 1 if max(params[:n_partitions]) > 14 else 0
    t.write(2, coding_method)
    t.write(4, porder)
    psize = block_size >> porder
    u = np.where(res_aligned >= 0,
                 res_aligned << 1,
                 ((-res_aligned - 1) << 1) | 1).astype(np.int64)
    for p in range(n_partitions):
        r = int(params[p])
        t.write(5 if coding_method else 4, r)
        start = order if p == 0 else p * psize
        seg = u[start:(p + 1) * psize]
        msb = seg >> r
        payload = (1 << r) | (seg & ((1 << r) - 1))
        t.extend_arrays(payload, msb + (1 + r))


def serialize_subframe(t, sub_bps, samples, choice, wasted, order,
                       porder, shift, precision, qlp, rice,
                       respec=None):
    """serializes one subframe from its decision row

    samples: int64 [n] variant samples (pre-wasted-shift)
    respec: optional (porders, max_rice) — when given, FIXED/LPC
    subframes re-search (porder, rice) exactly on the exact
    residuals (emit_rice_search) instead of trusting the analysis
    decision row"""
    from .flac_analysis import (CHOICE_CONSTANT, CHOICE_VERBATIM,
                                CHOICE_FIXED)
    n = len(samples)
    if choice == CHOICE_CONSTANT:
        t.write(1, 0)
        t.write(6, 0)
        t.write(1, 0)
        t.write_signed(sub_bps, int(samples[0]))
        return
    samp = samples >> wasted
    ebps = sub_bps - wasted
    if choice == CHOICE_VERBATIM:
        t.write(1, 0)
        t.write(6, 1)
        write_wasted(t, wasted)
        vals = np.where(samp < 0, samp + (1 << ebps), samp)
        t.extend_arrays(vals.astype(np.int64),
                        np.full(n, ebps, dtype=np.int64))
        return
    if choice == CHOICE_FIXED:
        t.write(1, 0)
        t.write(3, 1)
        t.write(3, order)
        write_wasted(t, wasted)
        for s in samp[:order]:
            t.write_signed(ebps, int(s))
        res = exact_residuals(samp, FC_TABLE[order], 0)
    else:                                       # LPC
        t.write(1, 0)
        t.write(1, 1)
        t.write(5, order - 1)
        write_wasted(t, wasted)
        for s in samp[:order]:
            t.write_signed(ebps, int(s))
        t.write(4, precision - 1)
        t.write_signed(5, shift)
        for c in qlp[:order]:
            t.write_signed(precision, int(c))
        res = exact_residuals(samp, [int(c) for c in qlp[:order]],
                              shift)
    if respec is not None:
        (porder, rice) = emit_rice_search(res, order, n,
                                          respec[0], respec[1])
    write_residual_block(t, n, order, porder, rice, res)


def encode_frame(pcmreader, options, frame_number, samples):
    """encodes one FLAC frame, returning its bytes

    samples is an int64 [frames, channels] array.  Analysis AND
    serialization are fully independent of the batched fast path:
    decisions come from the scalar spec implementation in
    ``ref/flac_analysis.py`` / ``ref/scalar_lpc.py`` (zero ops/
    imports), serialization from the TokenStream packer here — the
    dual-implementation oracle pattern of the reference\'s
    ``py_encoders`` vs ``src/encoders`` (SURVEY.md \u00a72.2).  Byte-compare
    tests hold this implementation and the batched device path to
    identical streams."""
    from . import flac_analysis

    bps = pcmreader.bits_per_sample
    n = samples.shape[0]
    ch = samples.shape[1]

    body = TokenStream()

    if n <= 4:
        # degenerate tail blocks: constant or verbatim (always valid)
        assignment = ch - 1
        for c in range(ch):
            col = samples[:, c]
            if np.all(col == col[0]):
                body.write(1, 0)
                body.write(6, 0)
                body.write(1, 0)
                body.write_signed(bps, int(col[0]))
            else:
                body.write(1, 0)
                body.write(6, 1)
                body.write(1, 0)
                vals = np.where(col < 0, col + (1 << bps), col)
                body.extend_arrays(vals.astype(np.int64),
                                   np.full(n, bps, dtype=np.int64))
    else:
        (assignment, decisions, variants) = flac_analysis.analyze_frame(
            np.asarray(samples, dtype=np.int64), bps, options)
        respec = None
        if emit_exact_rice_enabled():
            respec = (flac_analysis.valid_partition_orders(
                n, options.max_residual_partition_order,
                max(options.max_lpc_order, 4)),
                options.max_rice_parameter)
        for (s, (dec, var)) in enumerate(zip(decisions, variants)):
            sub_bps = bps
            if ((assignment == 8 and s == 1) or
                    (assignment == 9 and s == 0) or
                    (assignment == 10 and s == 1)):
                sub_bps += 1
            serialize_subframe(
                body, sub_bps, var,
                choice=dec["choice"], wasted=dec["wasted"],
                order=dec["order"], porder=dec["porder"],
                shift=dec["shift"],
                precision=options.qlp_precision,
                qlp=dec["qlp"], rice=dec["rice"],
                respec=respec)

    header = frame_header_tokens(pcmreader, frame_number, n, assignment)
    header_bytes = header.to_bytes()
    header_bytes += bytes([crc8(header_bytes)])
    frame = header_bytes + body.to_bytes()
    return frame + crc16(frame).to_bytes(2, "big")
