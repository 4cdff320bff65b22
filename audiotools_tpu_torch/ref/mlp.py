"""Scalar MLP (Meridian Lossless Packing) decoder and a test-stream
synthesizer.

A copy of the reference package's ``ref/mlp.py`` over the port's
big-endian ``bitstream``: frames of 1-2 substreams, each a sequence of
blocks carrying restart headers, decoding parameters (matrices, output
shifts, quant step sizes, per-channel FIR/IIR filters and Huffman
parameters) and residual data; residuals are entropy-coded with one of
three small Huffman codebooks plus raw LSBs, reconstructed through the
FIR/IIR filter pair, rematrixed with two seeded noise channels, shifted
and reordered to WAVE channel order.

This module is the oracle for the C++ decoder
(``_native.MLPDecoderHandle``), which ``dvda.MLPTitleReader`` takes
unless ``ATPU_MLP_ORACLE=1``, and also provides ``MLPEncoder`` and
``MLPEncoderMulti``, synthesizers producing valid MLP streams for
round-trip tests and the smoke run's MLP title (no MLP encoder ships
with the format's tools; fixtures must be self-made).

The Huffman codebooks are format constants (the same tables appear in
every MLP/TrueHD implementation); here they are expressed through
their algebraic structure instead of literal tables: each book is a
unary ladder ``0 0^z 1 -> 6-z`` below the base and ``0 1 0^m 1 ->
top+m`` above it, with a dense 0-2 bit prefix covering the middle
values.
"""

from __future__ import annotations

import numpy as np

from ..bitstream import BitstreamReader, BitstreamRecorder

# ---- format constants -------------------------------------------------

MAJOR_SYNC_WORDS = 0xF8726F
MAJOR_SYNC_TYPE = 0xBB
RESTART_SYNC = 0x18F5

BITS_PER_SAMPLE = {0: 16, 1: 20, 2: 24}
SAMPLE_RATE = {0: 48000, 1: 96000, 2: 192000,
               8: 44100, 9: 88200, 10: 176400}

# channel count per 5-bit channel-assignment field
# (reference src/decoders/aob.c dvda_channel_count)
CHANNEL_COUNT = {0x00: 1, 0x01: 2, 0x02: 3, 0x03: 4, 0x04: 3,
                 0x05: 4, 0x06: 5, 0x07: 3, 0x08: 4, 0x09: 5,
                 0x0A: 4, 0x0B: 5, 0x0C: 6, 0x0D: 4, 0x0E: 5,
                 0x0F: 4, 0x10: 5, 0x11: 6, 0x12: 5, 0x13: 5,
                 0x14: 6}

# MLP channel index -> WAVE channel index per assignment
# (reference mlp.c:169-191)
WAVE_CHANNEL = {
    0x00: [0], 0x01: [0, 1], 0x02: [0, 1, 2], 0x03: [0, 1, 2, 3],
    0x04: [0, 1, 2], 0x05: [0, 1, 2, 3], 0x06: [0, 1, 2, 3, 4],
    0x07: [0, 1, 2], 0x08: [0, 1, 2, 3], 0x09: [0, 1, 2, 3, 4],
    0x0A: [0, 1, 2, 3], 0x0B: [0, 1, 2, 3, 4],
    0x0C: [0, 1, 2, 3, 4, 5], 0x0D: [0, 1, 2, 3],
    0x0E: [0, 1, 2, 3, 4], 0x0F: [0, 1, 2, 3],
    0x10: [0, 1, 2, 3, 4], 0x11: [0, 1, 2, 3, 4, 5],
    0x12: [0, 1, 3, 4, 2], 0x13: [0, 1, 3, 4, 2],
    0x14: [0, 1, 4, 5, 2, 3],
}

# Huffman codebook parameters: (dense prefix bits, top value)
# book 1: 2 dense bits after a leading 1 (values 7-10), 011 -> 11
# book 2: 1 dense bit after a leading 1 (values 7-8),  011 -> 9
# book 3: 0 dense bits (1 -> 7),                       011 -> 8
_BOOK_DENSE = {1: 2, 2: 1, 3: 0}
_BOOK_TOP = {1: 11, 2: 9, 3: 8}


def _crc8_table():
    """MSB-first CRC-8, polynomial x^8+x^6+x^5+x+1 (0x63)
    (reference mlp.c:1115-1147 table, derived not copied)"""
    table = []
    for i in range(256):
        crc = i
        for _ in range(8):
            crc = ((crc << 1) ^ 0x63) & 0xFF if (crc & 0x80) \
                else (crc << 1) & 0xFF
        table.append(crc)
    return table


CRC8_TABLE = _crc8_table()


class Checkdata:
    """substream parity/CRC-8 accumulator (reference mlp.c:1111)"""

    def __init__(self):
        self.parity = 0
        self.crc = 0x3C
        self.final_crc = 0

    def update(self, data):
        for byte in data:
            self.parity ^= byte
            self.final_crc = self.crc ^ byte
            self.crc = CRC8_TABLE[self.final_crc]


def read_huffman(reader, book):
    """decodes one MSB value with codebook 1-3
    (algebraic form of reference mlp_codebook*.json)"""
    if reader.read(1):
        dense = _BOOK_DENSE[book]
        return 7 + (reader.read(dense) if dense else 0)
    if reader.read(1):
        # 01 0^m 1 -> top+m (m <= 6)
        m = 0
        while not reader.read(1):
            m += 1
            if m > 6:
                raise ValueError("invalid MLP block data")
        return _BOOK_TOP[book] + m
    # 00 0^z 1 -> 6-z (z <= 6)
    z = 0
    while not reader.read(1):
        z += 1
        if z > 6:
            raise ValueError("invalid MLP block data")
    return 6 - z


def write_huffman(writer, book, msb):
    """encodes one MSB value with codebook 1-3 (inverse of
    read_huffman; used by the test synthesizer)"""
    dense = _BOOK_DENSE[book]
    top = _BOOK_TOP[book]
    if 7 <= msb < 7 + (1 << dense):
        writer.write(1, 1)
        if dense:
            writer.write(dense, msb - 7)
    elif top <= msb <= top + 6:
        writer.write(2, 1)      # 01
        m = msb - top
        writer.write(m, 0)
        writer.write(1, 1)
    elif 0 <= msb <= 6:
        writer.write(2, 0)      # 00
        z = 6 - msb
        writer.write(z, 0)
        writer.write(1, 1)
    else:
        raise ValueError("MSB %d not codable with book %d"
                         % (msb, book))


def _mask(x, q):
    return (x >> q) << q if q else x


class _Filter:
    def __init__(self):
        self.shift = 0
        self.coeff = []
        self.state = []


class _Channel:
    def __init__(self):
        self.FIR = _Filter()
        self.IIR = _Filter()
        self.huffman_offset = 0
        self.codebook = 0
        self.huffman_lsbs = 24


class _Matrix:
    def __init__(self):
        self.out_channel = 0
        self.LSB_bypass = 0
        self.coeff = [0] * 8
        self.bypassed_LSB = []


class _Substream:
    def __init__(self):
        # restart header state
        self.min_channel = 0
        self.max_channel = 0
        self.max_matrix_channel = 0
        self.noise_shift = 0
        self.noise_gen_seed = 0
        # decoding parameters
        self.flags = [1] * 8
        self.block_size = 8
        self.matrix = []
        self.output_shift = [0] * 8
        self.quant_step_size = [0] * 8
        self.channel = [_Channel() for _ in range(8)]


class MLPDecoder:
    """a stateful MLP frame decoder

    feed whole frames (without the 4-byte length header) to
    decode_frame(); returns [block, channels] int32 in WAVE order"""

    def __init__(self):
        self.major_sync = None
        self.substream = [_Substream(), _Substream()]

    # ---- headers -----------------------------------------------------

    def _read_major_sync(self, reader, frame):
        """returns a dict if a major sync is present (consuming it),
        None otherwise (reference mlp.c:415)"""
        if (len(frame) < 28 or frame[0] != 0xF8 or
                frame[1] != 0x72 or frame[2] != 0x6F or
                frame[3] != MAJOR_SYNC_TYPE):
            return None
        reader.skip_bytes(4)
        (bps0, bps1, rate0, rate1, assignment, is_vbr, peak,
         substreams) = reader.parse(
            "4u 4u 4u 4u 11p 5u 48p 1u 15u 4u 92p")
        if substreams not in (1, 2):
            raise ValueError("invalid MLP major sync")
        return {"bits_per_sample": BITS_PER_SAMPLE[bps0],
                "sample_rate": SAMPLE_RATE[rate0],
                "channel_assignment": assignment,
                "channel_count": CHANNEL_COUNT[assignment],
                "is_vbr": is_vbr, "peak_bitrate": peak,
                "substream_count": substreams}

    def _read_restart_header(self, reader, ss):
        (sync, noise_type, _timestamp, ss.min_channel,
         ss.max_channel, ss.max_matrix_channel, ss.noise_shift,
         ss.noise_gen_seed, _unknown1, _checkdata, _lossless,
         _unknown2) = reader.parse(
            "13u 1u 16u 4u 4u 4u 4u 23u 19u 1u 8u 16u")
        if sync != RESTART_SYNC or noise_type != 0:
            raise ValueError("invalid MLP restart header")
        if ss.max_channel < ss.min_channel or \
                ss.max_matrix_channel < ss.max_channel:
            raise ValueError("invalid MLP restart header")
        for c in range(ss.max_matrix_channel + 1):
            if reader.read(6) > ss.max_matrix_channel:
                raise ValueError("invalid MLP restart header")
        reader.read(8)          # checksum

    def _read_filter(self, reader, f, is_iir):
        order = reader.read(4)
        if order > 8:
            raise ValueError("invalid MLP filter parameters")
        if order == 0:
            f.shift = 0
            f.coeff = []
            if is_iir:
                f.state = []
            return
        f.shift = reader.read(4)
        coeff_bits = reader.read(5)
        if not (1 <= coeff_bits <= 16):
            raise ValueError("invalid MLP filter parameters")
        coeff_shift = reader.read(3)
        if coeff_bits + coeff_shift > 16:
            raise ValueError("invalid MLP filter parameters")
        f.coeff = [reader.read_signed(coeff_bits) << coeff_shift
                   for _ in range(order)]
        if is_iir:
            f.state = []
            if reader.read(1):
                state_bits = reader.read(4)
                state_shift = reader.read(4)
                f.state = [reader.read_signed(state_bits)
                           << state_shift
                           for _ in range(order)][::-1]
        elif reader.read(1):
            raise ValueError("invalid MLP filter parameters")

    def _read_matrix_params(self, reader, ss):
        ss.matrix = []
        for _ in range(reader.read(4)):
            m = _Matrix()
            m.out_channel = reader.read(4)
            if m.out_channel > ss.max_matrix_channel:
                raise ValueError("invalid MLP matrix parameters")
            fractional_bits = reader.read(4)
            if fractional_bits > 14:
                raise ValueError("invalid MLP matrix parameters")
            m.LSB_bypass = reader.read(1)
            for c in range(ss.max_matrix_channel + 3):
                if reader.read(1):
                    v = reader.read_signed(fractional_bits + 2)
                    m.coeff[c] = v << (14 - fractional_bits)
                else:
                    m.coeff[c] = 0
            ss.matrix.append(m)

    def _read_decoding_parameters(self, reader, header_present, ss):
        if header_present:
            if reader.read(1):
                ss.flags = [reader.read(1) for _ in range(8)]
            else:
                ss.flags = [1] * 8
        elif ss.flags[0] and reader.read(1):
            ss.flags = [reader.read(1) for _ in range(8)]

        if ss.flags[7] and reader.read(1):
            ss.block_size = reader.read(9)
            if ss.block_size < 8:
                raise ValueError("invalid MLP decoding parameters")
        elif header_present:
            ss.block_size = 8

        if ss.flags[6] and reader.read(1):
            self._read_matrix_params(reader, ss)
        elif header_present:
            ss.matrix = []

        if ss.flags[5] and reader.read(1):
            for c in range(ss.max_matrix_channel + 1):
                ss.output_shift[c] = reader.read_signed(4)
        elif header_present:
            ss.output_shift = [0] * 8

        if ss.flags[4] and reader.read(1):
            for c in range(ss.max_channel + 1):
                ss.quant_step_size[c] = reader.read(4)
        elif header_present:
            ss.quant_step_size = [0] * 8

        for c in range(ss.min_channel, ss.max_channel + 1):
            ch = ss.channel[c]
            if reader.read(1):
                if ss.flags[3] and reader.read(1):
                    self._read_filter(reader, ch.FIR, False)
                elif header_present:
                    ch.FIR.shift = 0
                    ch.FIR.coeff = []
                if ss.flags[2] and reader.read(1):
                    self._read_filter(reader, ch.IIR, True)
                elif header_present:
                    ch.IIR.shift = 0
                    ch.IIR.coeff = []
                    ch.IIR.state = []
                if ss.flags[1] and reader.read(1):
                    ch.huffman_offset = reader.read_signed(15)
                elif header_present:
                    ch.huffman_offset = 0
                ch.codebook = reader.read(2)
                ch.huffman_lsbs = reader.read(5)
                if ch.huffman_lsbs > 24:
                    raise ValueError("invalid MLP channel parameters")
            elif header_present:
                ch.FIR.shift = 0
                ch.FIR.coeff = []
                ch.IIR.shift = 0
                ch.IIR.coeff = []
                ch.IIR.state = []
                ch.huffman_offset = 0
                ch.codebook = 0
                ch.huffman_lsbs = 24

    # ---- residuals / filtering / matrixing ----------------------------

    def _read_residuals(self, reader, ss):
        """returns residuals[channel] lists; appends bypassed LSBs to
        each matrix (reference mlp.c:866)"""
        lsb_bits = {}
        offsets = {}
        for c in range(ss.min_channel, ss.max_channel + 1):
            ch = ss.channel[c]
            lsb_bits[c] = ch.huffman_lsbs - ss.quant_step_size[c]
            if ch.codebook:
                sign_shift = lsb_bits[c] + 2 - ch.codebook
                offsets[c] = (ch.huffman_offset -
                              7 * (1 << lsb_bits[c]) -
                              ((1 << sign_shift)
                               if sign_shift >= 0 else 0))
            else:
                sign_shift = lsb_bits[c] - 1
                offsets[c] = (ch.huffman_offset -
                              ((1 << sign_shift)
                               if sign_shift >= 0 else 0))

        residuals = {c: [] for c in
                     range(ss.min_channel, ss.max_channel + 1)}
        for _ in range(ss.block_size):
            for m in ss.matrix:
                m.bypassed_LSB.append(
                    reader.read(1) if m.LSB_bypass else 0)
            for c in range(ss.min_channel, ss.max_channel + 1):
                ch = ss.channel[c]
                if ch.codebook:
                    msb = read_huffman(reader, ch.codebook)
                else:
                    msb = 0
                lsb = reader.read(lsb_bits[c]) if lsb_bits[c] else 0
                residuals[c].append(
                    ((msb << lsb_bits[c]) + lsb + offsets[c])
                    << ss.quant_step_size[c])
        return residuals

    @staticmethod
    def _filter_channel(residuals, ch, quant_step_size):
        """reference mlp.c:994 (64-bit accumulator, shared shift)"""
        fir, iir = ch.FIR, ch.IIR
        if len(fir.coeff) + len(iir.coeff) > 8:
            raise ValueError("invalid MLP filter parameters")
        # normalize filter state to 8 entries, zero-padded on the
        # left (the C decoder leaves pre-restart state undefined;
        # zero warm-up state is the sane interpretation and the
        # synthesizer mirrors it)
        fir.state = ([0] * 8 + fir.state)[-8:]
        iir.state = ([0] * 8 + iir.state)[-8:]
        if fir.shift > 0 and iir.shift > 0:
            if fir.shift != iir.shift:
                raise ValueError("invalid MLP filter parameters")
            shift = fir.shift
        elif fir.coeff:
            shift = fir.shift
        else:
            shift = iir.shift

        filtered = []
        for r in residuals:
            acc = 0
            for (j, coeff) in enumerate(fir.coeff):
                acc += coeff * fir.state[-(j + 1)]
            for (k, coeff) in enumerate(iir.coeff):
                acc += coeff * iir.state[-(k + 1)]
            shifted = acc >> shift
            value = _mask(shifted + r, quant_step_size)
            filtered.append(value)
            fir.state.append(value)
            iir.state.append(value - shifted)
        fir.state = fir.state[-8:]
        iir.state = iir.state[-8:]
        return filtered

    @staticmethod
    def _rematrix(channels, ss):
        """in-place rematrixing with seeded noise
        (reference mlp.c:1059); advances ss.noise_gen_seed"""
        block_size = len(channels[0])
        seed = ss.noise_gen_seed
        noise0 = []
        noise1 = []
        for _ in range(block_size):
            shifted = (seed >> 7) & 0xFFFF
            n0 = (seed >> 15) & 0xFF
            n0 = (n0 - 256 if n0 >= 128 else n0) << ss.noise_shift
            n1 = shifted & 0xFF
            n1 = (n1 - 256 if n1 >= 128 else n1) << ss.noise_shift
            noise0.append(n0)
            noise1.append(n1)
            seed = (((seed << 16) & 0xFFFFFFFF) ^
                    shifted ^ (shifted << 5)) & 0xFFFFFFFF
        ss.noise_gen_seed = seed

        mmc = ss.max_matrix_channel
        for m in ss.matrix:
            for i in range(block_size):
                acc = 0
                for c in range(mmc + 1):
                    acc += channels[c][i] * m.coeff[c]
                acc += noise0[i] * m.coeff[mmc + 1]
                acc += noise1[i] * m.coeff[mmc + 2]
                channels[m.out_channel][i] = \
                    _mask(acc >> 14,
                          ss.quant_step_size[m.out_channel]) + \
                    m.bypassed_LSB[i]

    # ---- frame/substream/block loops -----------------------------------

    def _read_block(self, reader, ss, channels):
        if reader.read(1):      # decoding parameters present
            header_present = reader.read(1)
            if header_present:
                self._read_restart_header(reader, ss)
            self._read_decoding_parameters(reader, header_present, ss)
        residuals = self._read_residuals(reader, ss)
        for c in range(ss.min_channel, ss.max_channel + 1):
            filtered = self._filter_channel(
                residuals[c], ss.channel[c], ss.quant_step_size[c])
            channels[c].extend(filtered)

    def _read_substream(self, data, ss, channels):
        reader = BitstreamReader(data)
        while True:
            self._read_block(reader, ss, channels)
            if reader.read(1):
                break

    def decode_frame(self, frame):
        """decodes one MLP frame (without the 4-byte length header);
        returns [block_size, channels] int32 in WAVE order"""
        reader = BitstreamReader(frame)
        sync = self._read_major_sync(reader, frame)
        if sync is not None:
            if self.major_sync is None:
                self.major_sync = sync
            elif (sync["bits_per_sample"] !=
                  self.major_sync["bits_per_sample"] or
                  sync["sample_rate"] !=
                  self.major_sync["sample_rate"] or
                  sync["channel_assignment"] !=
                  self.major_sync["channel_assignment"] or
                  sync["substream_count"] !=
                  self.major_sync["substream_count"]):
                raise ValueError("invalid MLP major sync")
        if self.major_sync is None:
            raise ValueError("MLP frame before major sync")

        substream_count = self.major_sync["substream_count"]
        infos = []
        for s in range(substream_count):
            (extraword, _nonrestart, checkdata_present,
             end) = reader.parse("1u 1u 1u 1p 12u")
            if extraword:
                raise ValueError("invalid extraword present value "
                                 "in substream info")
            infos.append((checkdata_present, end * 2))

        channels = [[] for _ in range(8)]
        offset = 0
        for s in range(substream_count):
            (checkdata_present, end) = infos[s]
            length = end - offset
            offset = end
            if checkdata_present:
                data = reader.read_bytes(length - 2)
                checkdata = Checkdata()
                checkdata.update(data)
                parity = reader.read(8)
                if (parity ^ checkdata.parity) != 0xA9:
                    raise ValueError("parity mismatch decoding "
                                     "MLP substream")
                crc8 = reader.read(8)
                if checkdata.final_crc != crc8:
                    raise ValueError("CRC8 mismatch decoding "
                                     "MLP substream")
            else:
                data = reader.read_bytes(length)
            ss = self.substream[s]
            for m in ss.matrix:
                m.bypassed_LSB = []
            self._read_substream(data, ss, channels)

        # rematrix using the last substream's parameters
        ss = self.substream[substream_count - 1]
        count = self.major_sync["channel_count"]
        live = channels[:ss.max_matrix_channel + 1]
        if live and live[0]:
            self._rematrix(live, ss)
        for c in range(ss.max_matrix_channel + 1):
            shift = ss.output_shift[c]
            if shift:
                channels[c] = [v << shift for v in channels[c]]

        wave_order = WAVE_CHANNEL[
            self.major_sync["channel_assignment"]]
        block = np.zeros((len(channels[0]), count), dtype=np.int32)
        for c in range(count):
            block[:, wave_order[c]] = np.asarray(channels[c],
                                                 dtype=np.int64)
        return block


def split_frames(data):
    """splits a buffer of length-prefixed MLP frames; returns
    (frames, leftover) where each frame EXCLUDES the 4-byte header
    (reference mlp.c:124-159)"""
    frames = []
    pos = 0
    while pos + 4 <= len(data):
        total_frame_size = ((data[pos] & 0x0F) << 8) | data[pos + 1]
        frame_bytes = total_frame_size * 2
        if pos + frame_bytes > len(data) or frame_bytes < 4:
            break
        frames.append(data[pos + 4:pos + frame_bytes])
        pos += frame_bytes
    return (frames, data[pos:])


# ---- synthesizer ------------------------------------------------------

class MLPEncoder:
    """synthesizes valid MLP streams for round-trip testing

    supports 1-substream streams with the full decoder feature set:
    Huffman codebooks 0-3, FIR/IIR filters, rematrixing with LSB
    bypass, output shifts, quant step sizes, and checkdata"""

    def __init__(self, sample_rate=48000, bits_per_sample=16,
                 channels=2, block_size=40, codebook=0,
                 huffman_lsbs=None, fir_coeff=None, iir_coeff=None,
                 filter_shift=0, checkdata=True, matrices=None,
                 noise_shift=0, noise_seed=0x123456,
                 output_shift=None, quant_step_size=None,
                 channel_offset=0, assignment=None):
        rate_field = {v: k for (k, v) in SAMPLE_RATE.items()}[
            sample_rate]
        bps_field = {v: k for (k, v) in BITS_PER_SAMPLE.items()}[
            bits_per_sample]
        if assignment is None:
            assignment = {1: 0x00, 2: 0x01}.get(channels)
        if assignment is None:
            raise ValueError("pass assignment explicitly for >2 "
                             "channels (or use MLPEncoderMulti)")
        self.channel_offset = channel_offset
        self.sample_rate = sample_rate
        self.bits_per_sample = bits_per_sample
        self.channels = channels
        self.rate_field = rate_field
        self.bps_field = bps_field
        self.assignment = assignment
        self.block_size = block_size
        self.codebook = codebook
        self.huffman_lsbs = (huffman_lsbs if huffman_lsbs is not None
                             else bits_per_sample)
        self.fir_coeff = list(fir_coeff or [])
        self.iir_coeff = list(iir_coeff or [])
        self.filter_shift = filter_shift
        self.checkdata = checkdata
        self.matrices = matrices or []
        self.noise_shift = noise_shift
        self.noise_seed = noise_seed
        self.output_shift = output_shift or [0] * channels
        self.quant_step_size = quant_step_size or [0] * channels
        self._started = False
        self._fir_state = [[0] * 8 for _ in range(channels)]
        self._iir_state = [[0] * 8 for _ in range(channels)]
        self._dec_noise_seed = noise_seed

    # -- helpers ---------------------------------------------------------

    def _write_major_sync(self, writer, substream_count=1):
        writer.write(24, MAJOR_SYNC_WORDS)
        writer.write(8, MAJOR_SYNC_TYPE)
        writer.build("4u 4u 4u 4u 11p 5u 48p 1u 15u 4u 92p",
                     [self.bps_field, self.bps_field,
                      self.rate_field, self.rate_field,
                      self.assignment, 0, 0, substream_count])

    def _write_restart_header(self, writer):
        off = self.channel_offset
        mmc = off + self.channels - 1
        writer.build("13u 1u 16u 4u 4u 4u 4u 23u 19u 1u 8u 16u",
                     [RESTART_SYNC, 0, 0,
                      off, mmc, mmc,
                      self.noise_shift, self.noise_seed,
                      0, 0, 0, 0])
        for c in range(mmc + 1):
            writer.write(6, c)
        writer.write(8, 0)      # checksum (unchecked by decoders)

    def _write_filter(self, writer, coeff, is_iir):
        if not coeff:
            writer.write(4, 0)
            return
        writer.write(4, len(coeff))
        writer.write(4, self.filter_shift)
        writer.write(5, 16)     # coeff_bits
        writer.write(3, 0)      # coeff_shift
        for v in coeff:
            writer.write_signed(16, v)
        writer.write(1, 0)      # no IIR initial state / FIR terminator

    def _write_parameters(self, writer):
        writer.write(1, 0)      # default flags (all present)
        writer.write(1, 1)      # block size present
        writer.write(9, self.block_size)
        if self.matrices:
            writer.write(1, 1)
            writer.write(4, len(self.matrices))
            for m in self.matrices:
                writer.write(4, m["out_channel"])
                writer.write(4, 14)             # fractional bits
                writer.write(1, m.get("lsb_bypass", 0))
                coeffs = m["coeff"]             # len channels+2
                for v in coeffs:
                    if v:
                        writer.write(1, 1)
                        writer.write_signed(16, v)
                    else:
                        writer.write(1, 0)
        else:
            writer.write(1, 0)
        if any(self.output_shift):
            # the decoder reads max_matrix_channel+1 entries; pad
            # zeros for channels below this substream's offset
            writer.write(1, 1)
            for _ in range(self.channel_offset):
                writer.write_signed(4, 0)
            for c in range(self.channels):
                writer.write_signed(4, self.output_shift[c])
        else:
            writer.write(1, 0)
        if any(self.quant_step_size):
            writer.write(1, 1)
            for _ in range(self.channel_offset):
                writer.write(4, 0)
            for c in range(self.channels):
                writer.write(4, self.quant_step_size[c])
        else:
            writer.write(1, 0)
        for c in range(self.channels):
            writer.write(1, 1)  # channel parameters present
            writer.write(1, 1)  # FIR present
            self._write_filter(writer, self.fir_coeff, False)
            writer.write(1, 1)  # IIR present
            self._write_filter(writer, self.iir_coeff, True)
            writer.write(1, 0)  # default huffman offset
            writer.write(2, self.codebook)
            writer.write(5, self.huffman_lsbs)

    def _advance_noise(self, n):
        """mirrors the decoder's noise generator to compute the
        pre-matrix channel values the decoder must reconstruct"""
        out = []
        seed = self._dec_noise_seed
        for _ in range(n):
            shifted = (seed >> 7) & 0xFFFF
            n0 = (seed >> 15) & 0xFF
            n0 = (n0 - 256 if n0 >= 128 else n0) << self.noise_shift
            n1 = shifted & 0xFF
            n1 = (n1 - 256 if n1 >= 128 else n1) << self.noise_shift
            out.append((n0, n1))
            seed = (((seed << 16) & 0xFFFFFFFF) ^
                    shifted ^ (shifted << 5)) & 0xFFFFFFFF
        self._dec_noise_seed = seed
        return out

    def _unmatrix(self, block):
        """computes the channel data to ENCODE such that the
        decoder's rematrix pass reproduces ``block`` exactly.

        each matrix row must be invertible on its out_channel: we
        require coeff[out_channel] == 1<<14 so the pre-matrix value
        can be recovered by subtracting the other terms."""
        data = [list(block[:, c]) for c in range(self.channels)]
        lsb_streams = [[] for _ in self.matrices]
        noise = self._advance_noise(len(block))
        for (mi, m) in reversed(list(enumerate(self.matrices))):
            out = m["out_channel"]
            coeff = m["coeff"]
            q = self.quant_step_size[out]
            assert coeff[out] == (1 << 14), \
                "matrix must be unit on its out_channel"
            for i in range(len(block)):
                target = data[out][i]
                if m.get("lsb_bypass", 0):
                    lsb = target & 1
                    target_masked = target - lsb
                else:
                    lsb = 0
                    target_masked = _mask(target, q)
                    assert target_masked == target, \
                        "quantized target loses bits"
                lsb_streams[mi].append(lsb)
                acc = 0
                for c in range(self.channels):
                    if c != out:
                        acc += data[c][i] * coeff[c]
                acc += noise[i][0] * coeff[self.channels]
                acc += noise[i][1] * coeff[self.channels + 1]
                # target_masked = mask((acc + pre*2^14) >> 14, q);
                # with the unit coefficient, pre = target -
                # floor(acc / 2^14) makes the floored shift land
                # exactly on target_masked
                pre = target_masked - (acc >> 14)
                got = _mask((acc + pre * (1 << 14)) >> 14, q)
                assert got == target_masked
                data[out][i] = pre
        return (data, lsb_streams)

    def _encode_residual_block(self, writer, data, lsb_streams):
        """entropy-codes pre-filter residuals for one block"""
        n = len(data[0])
        residuals = []
        for c in range(self.channels):
            fir_state = self._fir_state[c]
            iir_state = self._iir_state[c]
            res = []
            q = self.quant_step_size[c]
            for i in range(n):
                acc = 0
                for (j, coeff) in enumerate(self.fir_coeff):
                    acc += coeff * fir_state[-(j + 1)]
                for (k, coeff) in enumerate(self.iir_coeff):
                    acc += coeff * iir_state[-(k + 1)]
                shifted = acc >> self.filter_shift
                value = data[c][i]
                assert value == _mask(value, q), \
                    "sample not representable at quant step"
                res.append(value - shifted)
                fir_state.append(value)
                iir_state.append(value - shifted)
            self._fir_state[c] = fir_state[-8:]
            self._iir_state[c] = iir_state[-8:]
            residuals.append(res)

        lsb_bits = [self.huffman_lsbs - self.quant_step_size[c]
                    for c in range(self.channels)]
        offsets = []
        for c in range(self.channels):
            if self.codebook:
                sign_shift = lsb_bits[c] + 2 - self.codebook
                offsets.append(-(7 * (1 << lsb_bits[c])) -
                               ((1 << sign_shift)
                                if sign_shift >= 0 else 0))
            else:
                sign_shift = lsb_bits[c] - 1
                offsets.append(-((1 << sign_shift)
                                 if sign_shift >= 0 else 0))

        for i in range(n):
            for (mi, m) in enumerate(self.matrices):
                if m.get("lsb_bypass", 0):
                    writer.write(1, lsb_streams[mi][i])
            for c in range(self.channels):
                q = self.quant_step_size[c]
                res = residuals[c][i]
                assert res == _mask(res, q), \
                    "residual not representable at quant step"
                coded = (res >> q) - offsets[c]
                msb = coded >> lsb_bits[c]
                lsb = coded - (msb << lsb_bits[c])
                if self.codebook:
                    write_huffman(writer, self.codebook, msb)
                else:
                    assert msb == 0, \
                        "value out of range for codebook 0"
                if lsb_bits[c]:
                    writer.write(lsb_bits[c], lsb)

    # -- public ----------------------------------------------------------

    def encode_frame(self, block):
        """encodes [n, channels] int array (n a multiple of
        block_size) into one length-prefixed MLP frame"""
        block = np.asarray(block, dtype=np.int64)
        assert block.shape[1] == self.channels
        assert block.shape[0] % self.block_size == 0
        if any(self.output_shift):
            # the decoder applies output shifts after rematrixing,
            # so encode the pre-shift values
            shifts = np.asarray(self.output_shift[:self.channels])
            assert not np.any(block % (1 << shifts)), \
                "samples not representable at output shift"
            block = block >> shifts

        body = BitstreamRecorder()
        if not self._started:
            self._write_major_sync(body)

        ss_bytes = self._substream_bytes(block)
        end = len(ss_bytes)
        body.build("1u 1u 1u 1p 12u",
                   [0, 0, 1 if self.checkdata else 0, end // 2])
        body.write_bytes(ss_bytes)
        return _frame_with_header(body.data())

    def _substream_bytes(self, block):
        """one substream's complete byte payload for a frame
        (word-aligned; checkdata appended when enabled)"""
        substream = BitstreamRecorder()
        n_blocks = block.shape[0] // self.block_size
        for b in range(n_blocks):
            chunk = block[b * self.block_size:
                          (b + 1) * self.block_size]
            substream.write(1, 1)   # decoding parameters present
            if not self._started and b == 0:
                substream.write(1, 1)
                self._write_restart_header(substream)
                self._write_parameters(substream)
            else:
                substream.write(1, 0)
                substream.write(1, 0)   # no flag update
                substream.write(1, 0)   # no block size change
                substream.write(1, 0)   # no matrices change
                substream.write(1, 0)   # no output shifts
                substream.write(1, 0)   # no quant step sizes
                for _ in range(self.channels):
                    substream.write(1, 0)   # no channel params
            (data, lsb_streams) = self._unmatrix(chunk)
            self._encode_residual_block(substream, data,
                                        lsb_streams)
            substream.write(1, 1 if b == n_blocks - 1 else 0)
        substream.byte_align()
        self._started = True

        ss_bytes = substream.data()
        if (len(ss_bytes) + (2 if self.checkdata else 0)) % 2:
            ss_bytes += b"\x00"     # pad to a 16-bit word boundary
        if self.checkdata:
            check = Checkdata()
            check.update(ss_bytes)
            tail = BitstreamRecorder()
            tail.write(8, 0xA9 ^ check.parity)
            tail.write(8, check.final_crc)
            ss_bytes += tail.data()
        return ss_bytes


def _frame_with_header(payload):
    """prefixes a frame body with the 4-byte length header"""
    total = len(payload) + 4
    if total % 2:
        payload += b"\x00"
        total += 1
    header = BitstreamRecorder()
    header.build("4p 12u 16p", [total // 2])
    return header.data() + payload


class MLPEncoderMulti:
    """2-substream synthesizer for >2-channel streams

    substream 0 carries channels 0-1 (the stereo downmix slot) and
    substream 1 carries channels 2..C-1, the layout the reference
    decoder expects for multichannel titles (mlp.h:188-193); the
    decoder rematrixes with the LAST substream's parameters, so
    matrices are not used here"""

    def __init__(self, sample_rate=48000, bits_per_sample=16,
                 channels=6, block_size=40, codebook=1,
                 huffman_lsbs=None, fir_coeff=None, iir_coeff=None,
                 filter_shift=0, checkdata=True):
        assignment = {3: 0x02, 4: 0x03, 5: 0x06, 6: 0x0C}.get(
            channels)
        if assignment is None:
            raise ValueError("multi synthesizer supports 3-6 "
                             "channels")
        common = dict(sample_rate=sample_rate,
                      bits_per_sample=bits_per_sample,
                      block_size=block_size, codebook=codebook,
                      huffman_lsbs=huffman_lsbs,
                      fir_coeff=fir_coeff, iir_coeff=iir_coeff,
                      filter_shift=filter_shift,
                      checkdata=checkdata, assignment=assignment)
        self.channels = channels
        self.checkdata = checkdata
        self.sample_rate = sample_rate
        self.block_size = block_size
        self.ss0 = MLPEncoder(channels=2, **common)
        self.ss1 = MLPEncoder(channels=channels - 2,
                              channel_offset=2, **common)
        self._started = False

    def encode_frame(self, block):
        """encodes [n, channels] int array into one length-prefixed
        2-substream MLP frame"""
        block = np.asarray(block, dtype=np.int64)
        assert block.shape[1] == self.channels

        body = BitstreamRecorder()
        if not self._started:
            self.ss0._write_major_sync(body, substream_count=2)
            self._started = True

        b0 = self.ss0._substream_bytes(block[:, :2])
        b1 = self.ss1._substream_bytes(block[:, 2:])
        cd = 1 if self.checkdata else 0
        body.build("1u 1u 1u 1p 12u", [0, 0, cd, len(b0) // 2])
        body.build("1u 1u 1u 1p 12u",
                   [0, 1, cd, (len(b0) + len(b1)) // 2])
        body.write_bytes(b0)
        body.write_bytes(b1)
        return _frame_with_header(body.data())
