"""ALAC: the scalar encoder and decoder behind ATPU_ALAC_ORACLE, and
what the port's ALAC paths share with them.

Copy of the reference package's ``ref/alac.py``:

* the frameset channel layouts and the ALAC half of the
  quantized-analysis spec (``qpack_enabled``, ``plan_t``,
  ``quantize_channel``, ``pick_candidate``, ``group_score``,
  ``floor_limited``; ``analysis_channels`` is the port's own), which
  the batched encode (``codecs/alac_fast.py``) applies to a batch and
  the tests hold to the scalar rules;
* the scalar encoder (``encode_mdat`` and the ``encode_*`` it is built
  of: the candidate analysis over ``ref/scalar_lpc``, the
  sign-adaptive residual recurrence and the adaptive Rice coder);
* ``ALACDecoder``, the scalar decoder;
* the M4A header parse and the stsz frame-size table that the port's
  host and card decoders read (``read_m4a_header``), which walks the
  atom headers with ``struct``: the top-level atoms by seeking over
  them (the mdat is never read), and ``moov`` whole.
"""

from __future__ import annotations

import os
import struct

import numpy as np

from .. import pcm
from ..bitstream import BitstreamReader, BitstreamRecorder
from . import scalar_lpc

# the ALAC coefficient shift
QLP_SHIFT_NEEDED = 9

# frameset channel-pair groupings per channel count, as (offset,
# width) in ALAC channel order
FRAMESET_LAYOUT = {
    1: [(0, 1)],
    2: [(0, 2)],
    3: [(2, 1), (0, 2)],
    4: [(2, 1), (0, 2), (3, 1)],
    5: [(2, 1), (0, 2), (3, 2)],
    6: [(2, 1), (0, 2), (4, 2), (3, 1)],
    7: [(2, 1), (0, 2), (4, 2), (6, 1), (3, 1)],
    8: [(2, 1), (6, 2), (0, 2), (4, 2), (3, 1)],
}

# decoder side: ALAC frameset channel order -> wave channel order
WAVE_ORDER = {
    1: [0], 2: [0, 1],
    3: [1, 2, 0],
    4: [1, 2, 0, 3],
    5: [1, 2, 0, 3, 4],
    6: [1, 2, 0, 5, 3, 4],
    7: [1, 2, 0, 6, 3, 4, 5],
    8: [3, 4, 0, 7, 5, 6, 1, 2],
}

CHANNEL_MASKS = {1: 0x0004, 2: 0x0003, 3: 0x0007, 4: 0x0107,
                 5: 0x0037, 6: 0x003F, 7: 0x013F, 8: 0x00FF}


def log2(i):
    """floor(log2(i)); -1 for 0 (reference py_decoders/alac.py:26)"""
    return i.bit_length() - 1


def sign_only(x):
    return (x > 0) - (x < 0)


def truncate_bits(value, bits):
    truncated = value & ((1 << bits) - 1)
    if truncated & (1 << (bits - 1)):
        return truncated - (1 << bits)
    return truncated


class ResidualOverflow(Exception):
    pass


class EncodingOptions:
    def __init__(self, block_size=4096,
                 initial_history=10, history_multiplier=40,
                 maximum_k=14, interlacing_shift=2,
                 min_interlacing_leftweight=0,
                 max_interlacing_leftweight=4):
        self.block_size = block_size
        self.initial_history = initial_history
        self.history_multiplier = history_multiplier
        self.maximum_K = maximum_k
        self.interlacing_shift = interlacing_shift
        self.min_interlacing_leftweight = min_interlacing_leftweight
        self.max_interlacing_leftweight = max_interlacing_leftweight


def encode_mdat(file, pcmreader,
                block_size=4096,
                initial_history=10,
                history_multiplier=40,
                maximum_k=14,
                interlacing_shift=2,
                min_interlacing_leftweight=0,
                max_interlacing_leftweight=4):
    """writes an mdat atom from the PCMReader's data

    returns (frame_byte_sizes, total_pcm_frames)"""
    bps = pcmreader.bits_per_sample
    if bps > 16 and (bps - 16) % 8:
        # uncompressed_LSBs stores whole bytes; a non-byte shift
        # would silently drop bits (see encode_compressed_frame)
        raise ValueError(
            "bits_per_sample %d unsupported: bps - 16 must be a "
            "multiple of 8" % (bps,))

    options = EncodingOptions(block_size, initial_history,
                              history_multiplier, maximum_k,
                              interlacing_shift,
                              min_interlacing_leftweight,
                              max_interlacing_leftweight)
    pcmreader = pcm.BufferedPCMReader(pcmreader)

    total_pcm_frames = 0
    frame_byte_sizes = []

    mdat_start = file.tell()
    file.write(b"\x00" * 4 + b"mdat")

    frame = pcmreader.read(block_size)
    while len(frame) > 0:
        total_pcm_frames += frame.frames
        frame_start = file.tell()
        rec = BitstreamRecorder(False)
        encode_frameset(rec, pcmreader, options, frame)
        file.write(rec.data())
        frame_byte_sizes.append(file.tell() - frame_start)
        frame = pcmreader.read(block_size)

    end = file.tell()
    file.seek(mdat_start)
    file.write((sum(frame_byte_sizes) + 8).to_bytes(4, "big"))
    file.seek(end)

    return (frame_byte_sizes, total_pcm_frames)


def encode_frameset(writer, pcmreader, options, frame):
    """encodes one frameset (wave order converted to ALAC order)"""
    channels = pcmreader.channels
    if channels not in FRAMESET_LAYOUT:
        raise ValueError("unsupported channel count")
    samples = frame.samples
    for (offset, width) in FRAMESET_LAYOUT[channels]:
        group = [samples[:, offset + i].tolist()
                 for i in range(width)]
        encode_frame(writer, pcmreader, options, group)
    writer.write(3, 7)
    writer.byte_align()


def encode_frame(writer, pcmreader, options, channels):
    writer.write(3, len(channels) - 1)

    uncompressed_frame = BitstreamRecorder(False)
    encode_uncompressed_frame(uncompressed_frame, pcmreader, options,
                              channels)

    if len(channels[0]) >= 10:
        try:
            compressed_frame = BitstreamRecorder(False)
            encode_compressed_frame(compressed_frame, pcmreader,
                                    options, channels)
            if compressed_frame.bits() < uncompressed_frame.bits():
                compressed_frame.copy(writer)
            else:
                uncompressed_frame.copy(writer)
        except ResidualOverflow:
            uncompressed_frame.copy(writer)
    else:
        uncompressed_frame.copy(writer)


def encode_uncompressed_frame(writer, pcmreader, options, channels):
    writer.write(16, 0)
    writer.write(1, 0 if len(channels[0]) == options.block_size else 1)
    writer.write(2, 0)
    writer.write(1, 1)
    if len(channels[0]) != options.block_size:
        writer.write(32, len(channels[0]))
    bps = pcmreader.bits_per_sample
    for pcm_frame in zip(*channels):
        for sample in pcm_frame:
            writer.write_signed(bps, sample)


def encode_compressed_frame(writer, pcmreader, options, channels):
    if pcmreader.bits_per_sample <= 16:
        uncompressed_LSBs = 0
        LSBs = []
    else:
        shift = pcmreader.bits_per_sample - 16
        uncompressed_LSBs = shift // 8
        LSBs = []
        for i in range(len(channels[0])):
            for c in range(len(channels)):
                LSBs.append(channels[c][i] % (1 << shift))
        channels = [[(s >> shift) for s in channel]
                    for channel in channels]

    # candidate analysis: quantized under the qpack spec (with the
    # floor-limited exact retry), exact otherwise; the residual
    # recurrences below always consume exact samples either way
    bps_eff = pcmreader.bits_per_sample - uncompressed_LSBs * 8
    t_group = 0
    if qpack_enabled():
        ts = [plan_t(c, bps_eff, options.block_size)
              for c in channels]
        t_group = max(ts)
    if t_group > 0:
        analysis = [quantize_channel(c, t)
                    for (c, t) in zip(channels, ts)]
        (leftweight, cands) = group_candidates(analysis, options)
        if floor_limited(cands, t_group, options.block_size, bps_eff):
            (lw_e, cands_e) = group_candidates(channels, options)
            if group_score(cands_e) < group_score(cands):
                (leftweight, cands) = (lw_e, cands_e)
    else:
        (leftweight, cands) = group_candidates(channels, options)

    if len(channels) == 1:
        encode_non_interlaced_frame(writer, pcmreader, options,
                                    uncompressed_LSBs, LSBs, channels,
                                    cands)
    else:
        encode_interlaced_frame(writer, pcmreader, options,
                                uncompressed_LSBs, LSBs,
                                options.interlacing_shift,
                                leftweight, channels, cands)


def encode_non_interlaced_frame(writer, pcmreader, options,
                                uncompressed_LSBs, LSBs, channels,
                                cands):
    n = len(channels[0])
    writer.write(16, 0)
    writer.write(1, 1 if n != options.block_size else 0)
    writer.write(2, uncompressed_LSBs)
    writer.write(1, 0)
    if n != options.block_size:
        writer.write(32, n)
    writer.write(8, 0)
    writer.write(8, 0)

    sample_size = pcmreader.bits_per_sample - (uncompressed_LSBs * 8)
    (coefficients, residual) = encode_chosen_subframe(
        options, sample_size, cands[0], channels[0])
    write_subframe_header(writer, coefficients)
    if uncompressed_LSBs > 0:
        for LSB in LSBs:
            writer.write(uncompressed_LSBs * 8, LSB)
    residual.copy(writer)


def encode_interlaced_frame(writer, pcmreader, options,
                            uncompressed_LSBs, LSBs,
                            interlacing_shift, interlacing_leftweight,
                            channels, cands):
    n = len(channels[0])
    writer.write(16, 0)
    writer.write(1, 1 if n != options.block_size else 0)
    writer.write(2, uncompressed_LSBs)
    writer.write(1, 0)
    if n != options.block_size:
        writer.write(32, n)
    writer.write(8, interlacing_shift)
    writer.write(8, interlacing_leftweight)

    sample_size = (pcmreader.bits_per_sample -
                   (uncompressed_LSBs * 8) + 1)

    (correlated0, correlated1) = correlate_channels(
        channels[0], channels[1], interlacing_shift,
        interlacing_leftweight)

    (coefficients0, residual0) = encode_chosen_subframe(
        options, sample_size, cands[0], correlated0)
    (coefficients1, residual1) = encode_chosen_subframe(
        options, sample_size, cands[1], correlated1)

    write_subframe_header(writer, coefficients0)
    write_subframe_header(writer, coefficients1)
    if uncompressed_LSBs > 0:
        for LSB in LSBs:
            writer.write(uncompressed_LSBs * 8, LSB)
    residual0.copy(writer)
    residual1.copy(writer)


def correlate_channels(channel0, channel1, interlacing_shift,
                       interlacing_leftweight):
    if interlacing_leftweight > 0:
        c0 = np.asarray(channel0, dtype=np.int64)
        c1 = np.asarray(channel1, dtype=np.int64)
        correlated0 = c1 + (((c0 - c1) * interlacing_leftweight) >>
                            interlacing_shift)
        correlated1 = c0 - c1
        return (correlated0.tolist(), correlated1.tolist())
    else:
        return (list(channel0), list(channel1))


def alac_quantize_coefficients(row):
    """ALAC error-feedback quantization of one Levinson row

    scale 2^9, clamp to signed 16 bits (reference
    py_encoders/alac.py:336-347); scalar re-derivation of the spec
    (every product is exact — f32-valued coefficient times a power of
    two — and every add re-rounds to f32, so this matches the batched
    kernel bit for bit while sharing no code with it)"""
    qlp_max = (1 << 15) - 1
    qlp_min = -(1 << 15)
    error = 0.0
    out = []
    for c in row:
        candidate = scalar_lpc.f32r(
            error + c * float(1 << QLP_SHIFT_NEEDED))
        q = min(max(float(np.round(candidate)), qlp_min), qlp_max)
        error = candidate - q
        out.append(int(q))
    return out


def residual_size_estimate(channel, qlp, order):
    """integer-exact estimate of a candidate's residual magnitude

    the NON-adaptive ALAC-form residuals
    ``e_i = x_i - base_i - ((sum_j q_j (x_{i-1-j} - base_i)) >> 9)``
    (base_i = x_{i-order-1}) over i in [order+1, n), returning
    ``min(sum|e_i| // 64, 2^31-1)`` — the order/leftweight RANKING
    metric shared (as a spec, not as code) with the batched kernel
    and the C++ emitter."""
    x = np.asarray(channel, dtype=np.int64)
    n = len(x)
    count = n - 1 - order
    if count <= 0:
        return 0
    conv = np.zeros(count, dtype=np.int64)
    for (j, q) in enumerate(qlp):
        conv += int(q) * x[order - j:n - 1 - j]
    base = x[0:count]
    shifted = (conv - base * sum(int(q) for q in qlp)) >> \
        QLP_SHIFT_NEEDED
    e = x[order + 1:n] - base - shifted
    return int(min(int(np.abs(e).sum()) // 64, (1 << 31) - 1))


# ---------------------------------------------------------------------
# quantized-analysis spec: the candidate analysis runs on (x >> t) << t
# per channel while the emitter's residual recurrences always read the
# exact samples, so any candidate table gives a lossless stream
# ---------------------------------------------------------------------

def qpack_enabled():
    """whether the ALAC quantized analysis is on (ATPU_ALAC_QPACK,
    default on)"""
    return os.environ.get("ATPU_ALAC_QPACK", "1") != "0"


def qpack_guard():
    return int(os.environ.get("ATPU_QPACK_GUARD", "0"))


def qpack_cap_margin():
    return int(os.environ.get("ATPU_QPACK_CAP", "6"))


def qpack_noise_extra():
    return int(os.environ.get("ATPU_QPACK_NOISE_EXTRA", "2"))


def plan_t(channel, bps_eff, block_size):
    """the quantization shift t of one (LSB-shifted) channel, over the
    channel zero-padded to block_size: the FLAC plan's spec
    (ops/qpack.plan_t), noise-adaptive coarsening included"""
    n = block_size
    if n <= 2:
        return 0
    x = np.zeros(n, dtype=np.int64)
    x[:len(channel)] = channel
    sum1 = int(np.abs(x[1:] - x[:-1]).sum())
    sum2 = int(np.abs(x[2:] - 2 * x[1:-1] + x[:-2]).sum())
    m = sum2 // (n - 2)
    s = max(0, int(bps_eff) - 26)
    extra = qpack_noise_extra()
    e = 0
    marg = qpack_cap_margin()
    if (extra > 0 and m > 0 and
            5 * (sum2 >> s) * (n - 1) >= 8 * (sum1 >> s) * (n - 2)):
        e = extra
        marg = max(marg - 2, 0)
    cap = max(int(bps_eff) - marg, 0)
    return min(max(m.bit_length() - 1 - qpack_guard() + e, 0), cap)


def quantize_channel(channel, t):
    """the analysis input (x >> t) << t"""
    if t == 0:
        return list(channel)
    return [(int(s) >> t) << t for s in channel]


def analysis_channels(channels, bps_eff, block_size):
    """(t_group, the channels the candidate analysis reads): quantized
    at their planned shifts when the spec is on and the group's largest
    shift is positive, else the channels as given"""
    if not qpack_enabled():
        return (0, channels)
    ts = [plan_t(c, bps_eff, block_size) for c in channels]
    t_group = max(ts)
    if t_group <= 0:
        return (0, channels)
    return (t_group, [quantize_channel(c, t) for (c, t) in zip(channels, ts)])


def pick_candidate(cand):
    """(order, qlp, est) of a (qlp4, qlp8, degenerate, est4, est8)
    candidate: order 4 when degenerate or est4 <= est8"""
    (qlp4, qlp8, degenerate, est4, est8) = cand
    if degenerate or est4 <= est8:
        return (4, qlp4, est4)
    return (8, qlp8, est8)


def group_score(cands):
    """a group's summed estimate over its chosen candidates"""
    return sum(pick_candidate(c)[2] for c in cands)


def floor_limited(cands, t_group, block_size, bps_eff):
    """the quantization-floor retry rule: a group whose chosen
    candidate's estimated mean |residual| has a bit length of at least
    t_group + 2 is re-analysed exactly (the quantization hurt its
    fit); a group at the plan's cap (bps_eff - cap margin) or with
    t_group 0 never is"""
    if t_group <= 0:
        return False
    if t_group >= max(int(bps_eff) - qpack_cap_margin(), 0):
        return False
    for cand in cands:
        (order, _qlp, est) = pick_candidate(cand)
        count = block_size - 1 - order
        if count <= 0:
            continue
        if ((int(est) * 64) // count).bit_length() >= t_group + 2:
            return True
    return False


def group_candidates(analysis_channels, options):
    """leftweight + per-channel candidate tables for one frame group

    analysis_channels: 1 or 2 channels (quantized under the qpack
    spec, exact otherwise).  Width-2 groups choose the interlacing
    leftweight by lowest min(est4, est8) sum over both correlated
    channels, ties to the lowest leftweight (the C++ emitter's
    policy); returns (leftweight, [cand per channel])."""
    if len(analysis_channels) == 1:
        return (0, [lpc_coefficient_candidates(analysis_channels[0],
                                               options.block_size)])
    best = None
    for leftweight in range(options.min_interlacing_leftweight,
                            options.max_interlacing_leftweight + 1):
        (c0, c1) = correlate_channels(
            analysis_channels[0], analysis_channels[1],
            options.interlacing_shift, leftweight)
        k0 = lpc_coefficient_candidates(c0, options.block_size)
        k1 = lpc_coefficient_candidates(c1, options.block_size)
        score = min(k0[3], k0[4]) + min(k1[3], k1[4])
        if best is None or score < best[0]:
            best = (score, leftweight, [k0, k1])
    return (best[1], best[2])


def lpc_coefficient_candidates(channel, analysis_block_size=None):
    """returns (qlp4, qlp8, degenerate, est4, est8) for one channel

    INDEPENDENT scalar analysis (ref/scalar_lpc.py, zero ops/
    imports): tukey windowing, autocorrelation over 9 lags,
    Levinson-Durbin and the ALAC error-feedback quantization, plus
    the order-4/order-8 residual-size estimates.  The batched kernel
    (ops/alac_frames.py) implements the same spec; byte-compare tests
    hold the two to identical streams.

    Short (tail) channels zero-pad to analysis_block_size for the
    candidate ANALYSIS only: the fast path analyzes tails the same
    way (one compiled device program per shape), and the shared spec
    keeps oracle and fast outputs byte-identical."""
    if (analysis_block_size is not None and
            len(channel) < analysis_block_size):
        channel = (list(channel) +
                   [0] * (analysis_block_size - len(channel)))
    window = scalar_lpc.tukey_window(len(channel), 0.5)
    x = np.asarray(channel, dtype=np.int64)
    ac = scalar_lpc.windowed_autocorr(x, window, 8)
    degenerate = (ac[0][0] == 0.0)
    (rows, _errors) = scalar_lpc.levinson(ac, 8)
    qlp4 = alac_quantize_coefficients(rows[3][:4])
    qlp8 = alac_quantize_coefficients(rows[7][:8])
    if degenerate:
        qlp4 = [0, 0, 0, 0]
        qlp8 = [0] * 8
    est4 = residual_size_estimate(x, qlp4, 4)
    est8 = residual_size_estimate(x, qlp8, 8)
    return (qlp4, qlp8, degenerate, est4, est8)


def encode_chosen_subframe(options, sample_size, cand, channel):
    """returns (qlp_coefficients, residual_block) for one channel

    the order choice uses the residual-size estimate spec
    (residual_size_estimate above; ops/alac_frames.residual_estimate
    is the batched implementation of the same spec) so only the
    chosen candidate's adaptive recurrence runs — the same policy as
    the C++ emitter, keeping the paths byte-identical.  The candidate
    table may come from quantized analysis (group_candidates under the
    qpack spec); the residual recurrence below always consumes the
    EXACT channel, which is what keeps any candidate lossless."""
    (_order, qlp, _est) = pick_candidate(cand)
    qlp = list(qlp)
    residuals = compute_residuals(sample_size, qlp[:], channel)
    block = BitstreamRecorder(False)
    encode_residuals(block, options, sample_size, residuals)
    return (qlp, block)


def compute_residuals(sample_size, qlp_coefficients, channel):
    """the sign-adaptive LPC residual computation (scalar recurrence)"""
    channel = list(channel)
    residuals = [channel[0]]
    order = len(qlp_coefficients)

    if order < 31:
        for i in range(1, order + 1):
            residuals.append(truncate_bits(
                channel[i] - channel[i - 1], sample_size))

        for i in range(order + 1, len(channel)):
            base_sample = channel[i - order - 1]
            lpc_sum = 0
            for (c, s) in zip(qlp_coefficients,
                              reversed(channel[i - order:i])):
                lpc_sum += c * (s - base_sample)

            residual = truncate_bits(
                channel[i] - base_sample -
                ((lpc_sum + (1 << (QLP_SHIFT_NEEDED - 1))) >>
                 QLP_SHIFT_NEEDED),
                sample_size)
            residuals.append(residual)

            if residual > 0:
                for j in range(order):
                    diff = base_sample - channel[i - order + j]
                    sign = sign_only(diff)
                    qlp_coefficients[order - j - 1] -= sign
                    residual -= (((diff * sign) >> QLP_SHIFT_NEEDED) *
                                 (j + 1))
                    if residual <= 0:
                        break
            elif residual < 0:
                for j in range(order):
                    diff = base_sample - channel[i - order + j]
                    sign = sign_only(diff)
                    qlp_coefficients[order - j - 1] += sign
                    residual -= (((diff * -sign) >> QLP_SHIFT_NEEDED) *
                                 (j + 1))
                    if residual >= 0:
                        break
    else:
        for sample in channel[1:]:
            residuals.append(truncate_bits(
                sample - residuals[-1], sample_size))

    return residuals


def encode_residuals(writer, options, sample_size, residuals):
    history = options.initial_history
    sign_modifier = 0
    i = 0
    while i < len(residuals):
        if residuals[i] >= 0:
            unsigned = residuals[i] * 2
        else:
            unsigned = (-residuals[i] * 2) - 1

        if unsigned >= (1 << sample_size):
            raise ResidualOverflow()

        k = min(log2((history >> 9) + 3), options.maximum_K)
        encode_residual(writer, unsigned - sign_modifier, k,
                        sample_size)
        sign_modifier = 0

        if unsigned <= 0xFFFF:
            history += ((unsigned * options.history_multiplier) -
                        ((history * options.history_multiplier) >> 9))
            i += 1
            if (history < 128) and (i < len(residuals)):
                k = min(7 - log2(history) + ((history + 16) >> 6),
                        options.maximum_K)
                zeroes = 0
                while (i < len(residuals)) and (residuals[i] == 0):
                    zeroes += 1
                    i += 1
                encode_residual(writer, zeroes, k, 16)
                if zeroes < 65535:
                    sign_modifier = 1
                history = 0
        else:
            i += 1
            history = 0xFFFF


def encode_residual(writer, unsigned, k, sample_size):
    MSB = unsigned // ((1 << k) - 1)
    LSB = unsigned % ((1 << k) - 1)
    if MSB > 8:
        writer.write(9, 0x1FF)
        writer.write(sample_size, unsigned)
    else:
        writer.unary(0, MSB)
        if k > 1:
            if LSB > 0:
                writer.write(k, LSB + 1)
            else:
                writer.write(k - 1, 0)


def write_subframe_header(writer, qlp_coefficients):
    writer.write(4, 0)
    writer.write(4, QLP_SHIFT_NEEDED)
    writer.write(3, 4)
    writer.write(5, len(qlp_coefficients))
    for coeff in qlp_coefficients:
        writer.write_signed(16, coeff)


# ---------------------------------------------------------------------------
# decoder
# ---------------------------------------------------------------------------

class ALACDecoder:
    """a PCMReader-compatible decoder for ALAC frames in an M4A file"""

    CHANNEL_MASKS = {1: 0x0004, 2: 0x0003, 3: 0x0007, 4: 0x0107,
                     5: 0x0037, 6: 0x003F, 7: 0x013F, 8: 0x00FF}

    def __init__(self, file_or_path):
        if isinstance(file_or_path, str):
            f = open(file_or_path, "rb")
        else:
            f = file_or_path
        self.reader = BitstreamReader(f, False)

        self.reader.mark()
        try:
            try:
                stsd = self._find_sub_atom(b"moov", b"trak", b"mdia",
                                           b"minf", b"stbl", b"stsd")
            except KeyError:
                raise ValueError("required stsd atom not found")

            stsd.parse("8u 24p 32u")
            (alac1, alac2,
             self.samples_per_frame,
             self.bits_per_sample,
             self.history_multiplier,
             self.initial_history,
             self.maximum_k,
             self.channels,
             self.sample_rate) = stsd.parse(
                 "32p 4b 6P 16p 16p 16p 4P 16p 16p 16p 16p 4P"
                 "32p 4b 4P 32u 8p 8u 8u 8u 8u 8u 16p 32p 32p 32u")
            if (alac1 != b"alac") or (alac2 != b"alac"):
                raise ValueError("invalid alac atom")

            self.channel_mask = self.CHANNEL_MASKS.get(self.channels, 0)

            self.reader.rewind()
            mdhd = self._find_sub_atom(b"moov", b"trak", b"mdia",
                                       b"mdhd")
            (version,) = mdhd.parse("8u 24p")
            if version == 0:
                (self.total_pcm_frames,) = mdhd.parse(
                    "32p 32p 32p 32u 2P 16p")
            elif version == 1:
                (self.total_pcm_frames,) = mdhd.parse(
                    "64p 64p 32p 64U 2P 16p")
            else:
                raise ValueError("invalid mdhd version")

            self.reader.rewind()
            (atom_size, atom_name) = self.reader.parse("32u 4b")
            while atom_name != b"mdat":
                self.reader.skip_bytes(atom_size - 8)
                (atom_size, atom_name) = self.reader.parse("32u 4b")
        finally:
            self.reader.unmark()

    def _find_sub_atom(self, *atom_names):
        reader = self.reader
        for (i, next_atom) in enumerate(atom_names):
            last = (i == len(atom_names) - 1)
            try:
                (length, stream_atom) = reader.parse("32u 4b")
                while stream_atom != next_atom:
                    reader.skip_bytes(length - 8)
                    (length, stream_atom) = reader.parse("32u 4b")
                if last:
                    return reader.substream(length - 8)
                else:
                    reader = reader.substream(length - 8)
            except IOError:
                raise KeyError(next_atom)

    def read(self, pcm_frames):
        if self.total_pcm_frames == 0:
            return pcm.empty_framelist(self.channels,
                                       self.bits_per_sample)

        frameset_data = []
        frame_channels = self.reader.read(3) + 1
        while frame_channels != 0x8:
            frameset_data.extend(self.read_frame(frame_channels))
            frame_channels = self.reader.read(3) + 1
        self.reader.byte_align()

        order = WAVE_ORDER.get(self.channels)
        if order is None:
            raise ValueError("unsupported channel count")
        reordered = [frameset_data[i] for i in order]

        out = np.stack([np.asarray(ch, dtype=np.int64)
                        for ch in reordered], axis=1)
        framelist = pcm.FrameList._wrap(out.astype(np.int32),
                                        self.bits_per_sample)
        self.total_pcm_frames -= framelist.frames
        return framelist

    def read_frame(self, channel_count):
        self.reader.skip(16)
        has_sample_count = self.reader.read(1)
        uncompressed_lsb_size = self.reader.read(2)
        uncompressed = self.reader.read(1)
        if has_sample_count:
            sample_count = self.reader.read(32)
        else:
            sample_count = self.samples_per_frame

        if uncompressed == 1:
            samples = [self.reader.read_signed(self.bits_per_sample)
                       for _ in range(sample_count * channel_count)]
            return [samples[i::channel_count]
                    for i in range(channel_count)]

        interlacing_shift = self.reader.read(8)
        interlacing_leftweight = self.reader.read(8)
        subframe_headers = [self.read_subframe_header()
                            for _ in range(channel_count)]

        if uncompressed_lsb_size > 0:
            uncompressed_lsbs = [
                self.reader.read(uncompressed_lsb_size * 8)
                for _ in range(sample_count * channel_count)]
        else:
            uncompressed_lsbs = []

        sample_size = (self.bits_per_sample -
                       (uncompressed_lsb_size * 8) +
                       channel_count - 1)

        residual_blocks = [self.read_residuals(sample_size,
                                               sample_count)
                           for _ in range(channel_count)]

        decoded = [self.decode_subframe(header[0], header[1],
                                        sample_size, residuals)
                   for (header, residuals) in zip(subframe_headers,
                                                  residual_blocks)]

        decorrelated = self.decorrelate_channels(
            decoded, interlacing_shift, interlacing_leftweight)

        if uncompressed_lsb_size > 0:
            channels = []
            for (i, channel) in enumerate(decorrelated):
                lsbs = uncompressed_lsbs[i::channel_count]
                channels.append(
                    [(s << (uncompressed_lsb_size * 8)) | l
                     for (s, l) in zip(channel, lsbs)])
            return channels
        else:
            return decorrelated

    def read_subframe_header(self):
        self.reader.read(4)
        qlp_shift_needed = self.reader.read(4)
        self.reader.read(3)
        qlp_coefficients = [self.reader.read_signed(16)
                            for _ in range(self.reader.read(5))]
        return (qlp_shift_needed, qlp_coefficients)

    def read_residuals(self, sample_size, sample_count):
        residuals = []
        history = self.initial_history
        sign_modifier = 0
        i = 0

        while i < sample_count:
            k = min(log2((history >> 9) + 3), self.maximum_k)
            unsigned = self.read_residual(k, sample_size) + \
                sign_modifier
            sign_modifier = 0

            if unsigned & 1:
                residuals.append(-((unsigned + 1) >> 1))
            else:
                residuals.append(unsigned >> 1)

            if unsigned <= 0xFFFF:
                history += ((unsigned * self.history_multiplier) -
                            ((history * self.history_multiplier) >> 9))
            else:
                history = 0xFFFF

            if (history < 128) and ((i + 1) < sample_count):
                zeroes_k = min(7 - log2(history) +
                               ((history + 16) >> 6),
                               self.maximum_k)
                zero_residuals = self.read_residual(zeroes_k, 16)
                if zero_residuals > 0:
                    residuals.extend([0] * zero_residuals)
                    i += zero_residuals
                history = 0
                if zero_residuals <= 0xFFFF:
                    sign_modifier = 1

            i += 1

        return residuals

    def read_residual(self, k, sample_size):
        msb = self.reader.limited_unary(0, 9)
        if msb is None:
            return self.reader.read(sample_size)
        elif k == 0:
            return msb
        else:
            # the encoder writes k bits when LSB >= 2, else k-1 zeros
            hi = self.reader.read(k - 1) if k > 1 else 0
            if hi != 0:
                lsb = (hi << 1) | self.reader.read(1)
                return msb * ((1 << k) - 1) + (lsb - 1)
            else:
                return msb * ((1 << k) - 1)

    def decode_subframe(self, qlp_shift_needed, qlp_coefficients,
                        sample_size, residuals):
        residuals = list(residuals)
        samples = [residuals.pop(0)]
        order = len(qlp_coefficients)

        if order < 31:
            for i in range(order):
                samples.append(truncate_bits(
                    samples[-1] + residuals.pop(0), sample_size))

            for residual in residuals:
                base_sample = samples[-order - 1]
                lpc_sum = 0
                for (s, c) in zip(samples[-order:],
                                  reversed(qlp_coefficients)):
                    lpc_sum += (s - base_sample) * c
                outval = (1 << (qlp_shift_needed - 1)) + lpc_sum
                outval >>= qlp_shift_needed
                samples.append(truncate_bits(
                    outval + residual + base_sample, sample_size))

                buf = samples[-order - 2:-1]

                if residual > 0:
                    predictor_num = order - 1
                    while (predictor_num >= 0) and (residual > 0):
                        val = buf[0] - buf[order - predictor_num]
                        sign = sign_only(val)
                        qlp_coefficients[predictor_num] -= sign
                        val *= sign
                        residual -= ((val >> qlp_shift_needed) *
                                     (order - predictor_num))
                        predictor_num -= 1
                elif residual < 0:
                    predictor_num = order - 1
                    while (predictor_num >= 0) and (residual < 0):
                        val = buf[0] - buf[order - predictor_num]
                        sign = -sign_only(val)
                        qlp_coefficients[predictor_num] -= sign
                        val *= sign
                        residual -= ((val >> qlp_shift_needed) *
                                     (order - predictor_num))
                        predictor_num -= 1
        else:
            for residual in residuals:
                samples.append(truncate_bits(
                    samples[-1] + residual, sample_size))

        return samples

    def decorrelate_channels(self, channel_data, interlacing_shift,
                             interlacing_leftweight):
        if len(channel_data) != 2 or interlacing_leftweight == 0:
            return channel_data
        ch0 = np.asarray(channel_data[0], dtype=np.int64)
        ch1 = np.asarray(channel_data[1], dtype=np.int64)
        right = ch0 - ((ch1 * interlacing_leftweight) >>
                       interlacing_shift)
        left = ch1 + right
        return [left.tolist(), right.tolist()]

    def close(self):
        self.reader.close()


def _atoms(data):
    """(name, payload) of each atom in ``data``, in order; stops at a
    size below 8 or an atom running past the end"""
    pos = 0
    while pos + 8 <= len(data):
        (size, name) = struct.unpack(">I4s", data[pos:pos + 8])
        if size < 8 or pos + size > len(data):
            return
        yield (name, data[pos + 8:pos + size])
        pos += size


def _find(data, *names):
    """the payload of the nested atom ``names`` in ``data``; raises
    KeyError with the first name not found"""
    for name in names:
        for (atom, payload) in _atoms(data):
            if atom == name:
                data = payload
                break
        else:
            raise KeyError(name)
    return data


def _top_level(file):
    """the top-level atoms of ``file`` from its current position:
    returns (moov payload or None, offset of the mdat payload or
    None), reading nothing of the mdat"""
    (moov, mdat) = (None, None)
    pos = file.tell()
    while moov is None or mdat is None:
        file.seek(pos)
        header = file.read(8)
        if len(header) < 8:
            break
        (size, name) = struct.unpack(">I4s", header)
        if size < 8:
            break
        if name == b"mdat":
            mdat = pos + 8
        elif name == b"moov":
            moov = file.read(size - 8)
        pos += size
    return (moov, mdat)


def read_m4a_header(file):
    """parses an ALAC M4A file's atoms from a seekable binary file at
    its start

    Returns a dict of the reference ALACDecoder's attributes
    (samples_per_frame, bits_per_sample, history_multiplier,
    initial_history, maximum_k, channels, sample_rate, channel_mask,
    total_pcm_frames), ``mdat_offset``, the file offset of the first
    frameset, and ``frame_sizes``, the stsz table (empty when it cannot
    be read, as in the reference).  Raises ValueError where the
    reference's parse fails."""
    (moov, mdat) = _top_level(file)
    if moov is None:
        raise ValueError("required stsd atom not found")
    try:
        stsd = _find(moov, b"trak", b"mdia", b"minf", b"stbl", b"stsd")
    except KeyError:
        raise ValueError("required stsd atom not found")
    if len(stsd) < 80:
        raise ValueError("invalid alac atom")
    # version/flags, entry count, then the alac sample entry and its
    # alac sub-atom (ALACAudio's layout)
    if stsd[12:16] != b"alac" or stsd[48:52] != b"alac":
        raise ValueError("invalid alac atom")
    (samples_per_frame,) = struct.unpack(">I", stsd[56:60])
    (bits_per_sample, history_multiplier, initial_history, maximum_k,
     channels) = struct.unpack(">5B", stsd[61:66])
    (sample_rate,) = struct.unpack(">I", stsd[76:80])

    try:
        mdhd = _find(moov, b"trak", b"mdia", b"mdhd")
    except KeyError:
        raise ValueError("required mdhd atom not found")
    version = mdhd[0] if mdhd else -1
    if version == 0 and len(mdhd) >= 20:
        (total_pcm_frames,) = struct.unpack(">I", mdhd[16:20])
    elif version == 1 and len(mdhd) >= 32:
        (total_pcm_frames,) = struct.unpack(">Q", mdhd[24:32])
    else:
        raise ValueError("invalid mdhd version")
    if mdat is None:
        raise ValueError("mdat atom not found")

    try:
        stsz = _find(moov, b"trak", b"mdia", b"minf", b"stbl", b"stsz")
        (fixed_size, count) = struct.unpack(">II", stsz[4:12])
        if fixed_size:
            frame_sizes = [fixed_size] * count
        else:
            frame_sizes = list(struct.unpack(">%dI" % (count,),
                                             stsz[12:12 + 4 * count]))
    except (KeyError, struct.error):
        frame_sizes = []

    return dict(samples_per_frame=samples_per_frame,
                bits_per_sample=bits_per_sample,
                history_multiplier=history_multiplier,
                initial_history=initial_history,
                maximum_k=maximum_k, channels=channels,
                sample_rate=sample_rate,
                channel_mask=CHANNEL_MASKS.get(channels, 0),
                total_pcm_frames=total_pcm_frames,
                mdat_offset=mdat, frame_sizes=frame_sizes)
