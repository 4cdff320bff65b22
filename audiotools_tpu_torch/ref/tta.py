"""True Audio (TTA1): the scalar encoder and decoder behind
ATPU_TTA_ORACLE, and what the port's TTA paths share with them.

Copy of the reference package's ``ref/tta.py``, after the TTA format
and its pure-Python specification: channel decorrelation with
truncating halving of the final channel, the fixed predictor, the
sign-adaptive hybrid IIR filter (qm/dx/dl state with 32-bit
wraparound), the two-level adaptive Rice coder (k0/k1 with running
sums), the per-frame CRC-32 and the ~1.045 s frame size of
sample_rate*256//245.  ``read_tta_header`` is the port's own parse of
the header and seektable, which the card decoder uses.

TTA's CRC-32 is the reflected polynomial 0xEDB88320 with initial value
and final xor 0xFFFFFFFF, which is zlib's ``crc32``; the streaming
``CRC32`` is the scalar decoder's bitstream callback.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

from .. import pcm, text
from ..bitstream import BitstreamReader
from .crc import CRC32_TABLE


def div_ceil(n, d):
    return n // d + (1 if (n % d) else 0)


def block_size_for(sample_rate):
    """PCM frames per TTA frame (about 1.045 s)"""
    return (sample_rate * 256) // 245


def crc32(data):
    return zlib.crc32(data)


class CRC32:
    def __init__(self):
        self.crc = 0xFFFFFFFF

    def update(self, byte):
        self.crc = int(CRC32_TABLE[(self.crc ^ byte) & 0xFF] ^
                       (self.crc >> 8))

    def __int__(self):
        return self.crc ^ 0xFFFFFFFF


def read_tta_header(file):
    """parses a TTA1 stream's header and seektable from a binary file
    at the stream's start, leaving it at the first frame

    Returns a dict: channels, bits_per_sample, sample_rate,
    total_pcm_frames, channel_mask, block_size, total_tta_frames and
    frame_lengths (bytes per TTA frame, from the seektable).  Raises
    ValueError on a bad signature or format, a short read, or a header
    or seektable CRC that does not match."""
    header = file.read(22)
    if len(header) < 22 or header[:4] != b"TTA1":
        raise ValueError("invalid TTA signature")
    (format_, channels, bits_per_sample, sample_rate,
     total_pcm_frames) = struct.unpack("<HHHII", header[4:18])
    if format_ != 1:
        raise ValueError("invalid TTA format")
    if struct.unpack("<I", header[18:22])[0] != crc32(header[:18]):
        raise ValueError("invalid TTA header CRC")
    if not channels or not sample_rate:
        raise ValueError("invalid TTA header")
    total_tta_frames = div_ceil(total_pcm_frames * 245, sample_rate * 256)
    table = file.read(total_tta_frames * 4 + 4)
    if len(table) < total_tta_frames * 4 + 4:
        raise ValueError("truncated TTA seektable")
    if (struct.unpack("<I", table[-4:])[0] !=
            crc32(table[:total_tta_frames * 4])):
        raise ValueError("invalid TTA seektable CRC")
    return dict(channels=channels, bits_per_sample=bits_per_sample,
                sample_rate=sample_rate, total_pcm_frames=total_pcm_frames,
                channel_mask={1: 0x4, 2: 0x3}.get(channels, 0),
                block_size=block_size_for(sample_rate),
                total_tta_frames=total_tta_frames,
                frame_lengths=list(struct.unpack(
                    "<%dI" % (total_tta_frames,),
                    table[:total_tta_frames * 4])))


def _trunc_half(x):
    """x / 2 rounded toward zero (int array or scalar)"""
    return np.sign(x) * (np.abs(x) // 2)


def correlate_channels(channels):
    """encoder-side decorrelation; channels is int64 [n, ch]"""
    ch = channels.shape[1]
    correlated = np.empty_like(channels)
    for c in range(ch - 1):
        correlated[:, c] = channels[:, c + 1] - channels[:, c]
    correlated[:, ch - 1] = (channels[:, ch - 1] -
                             _trunc_half(correlated[:, ch - 2]))
    return correlated


def decorrelate_channels(correlated):
    """decoder-side inverse of correlate_channels"""
    ch = correlated.shape[1]
    out = np.empty_like(correlated)
    out[:, ch - 1] = (correlated[:, ch - 1] +
                      _trunc_half(correlated[:, ch - 2]))
    for c in range(ch - 2, -1, -1):
        out[:, c] = out[:, c + 1] - correlated[:, c]
    return out


def _shift_for(bps):
    return {8: 4, 16: 5, 24: 5}[bps]


def _filter_shift_for(bps):
    return {8: 10, 16: 9, 24: 10}[bps]


def fixed_predict(bps, correlated):
    """encoder fixed predictor (vectorized)"""
    shift = _shift_for(bps)
    out = correlated.copy()
    prev = correlated[:-1]
    out[1:] = correlated[1:] - (((prev << shift) - prev) >> shift)
    return out


def fixed_unpredict(bps, predicted):
    """decoder inverse fixed predictor (recurrence)"""
    shift = _shift_for(bps)
    out = np.empty_like(predicted)
    out[0] = predicted[0]
    p = int(predicted[0])
    result = [p]
    for i in range(1, len(predicted)):
        p = int(predicted[i]) + (((p << shift) - p) >> shift)
        result.append(p)
    return np.array(result, dtype=np.int64)


def _wrap32(v):
    v &= 0xFFFFFFFF
    return v - (1 << 32) if v >= (1 << 31) else v


def tta_filter(bps, predicted):
    """encoder hybrid adaptive filter (scalar recurrence)"""
    shift = _filter_shift_for(bps)
    round_ = 1 << (shift - 1)
    residuals = []
    qm = [0] * 8
    dx = [0] * 8
    dl = [0] * 8
    for i in range(len(predicted)):
        p = int(predicted[i])
        if i == 0:
            residuals.append(p + (round_ >> shift))
        else:
            prev_res = residuals[i - 1]
            if prev_res < 0:
                qm = [m - x for (m, x) in zip(qm, dx)]
            elif prev_res > 0:
                qm = [m + x for (m, x) in zip(qm, dx)]
            sum_ = _wrap32(round_ +
                           sum(l * m for (l, m) in zip(dl, qm)))
            residuals.append(p - (sum_ >> shift))
        dx = [dx[1], dx[2], dx[3], dx[4],
              1 if dl[4] >= 0 else -1,
              2 if dl[5] >= 0 else -2,
              2 if dl[6] >= 0 else -2,
              4 if dl[7] >= 0 else -4]
        dl = [dl[1], dl[2], dl[3], dl[4],
              -dl[5] + (-dl[6] + (p - dl[7])),
              -dl[6] + (p - dl[7]),
              p - dl[7],
              p]
    return np.array(residuals, dtype=np.int64)


def tta_unfilter(bps, residuals):
    """decoder inverse hybrid filter (scalar recurrence)"""
    shift = _filter_shift_for(bps)
    round_ = 1 << (shift - 1)
    predicted = []
    qm = [0] * 8
    dx = [0] * 8
    dl = [0] * 8
    for i in range(len(residuals)):
        r = int(residuals[i])
        if i == 0:
            p = r - (round_ >> shift)
        else:
            prev_res = int(residuals[i - 1])
            if prev_res < 0:
                qm = [m - x for (m, x) in zip(qm, dx)]
            elif prev_res > 0:
                qm = [m + x for (m, x) in zip(qm, dx)]
            sum_ = _wrap32(round_ +
                           sum(l * m for (l, m) in zip(dl, qm)))
            p = r + (sum_ >> shift)
        predicted.append(p)
        dx = [dx[1], dx[2], dx[3], dx[4],
              1 if dl[4] >= 0 else -1,
              2 if dl[5] >= 0 else -2,
              2 if dl[6] >= 0 else -2,
              4 if dl[7] >= 0 else -4]
        dl = [dl[1], dl[2], dl[3], dl[4],
              -dl[5] + (-dl[6] + (p - dl[7])),
              -dl[6] + (p - dl[7]),
              p - dl[7],
              p]
    return np.array(predicted, dtype=np.int64)


def encode_tta(file, pcmreader):
    """writes TTA frames from a (buffered) PCMReader to a file object

    returns a list of frame lengths in bytes
    (reference py_encoders/tta.py:31-49)"""
    from .flac_enc import TokenStream

    block_size = block_size_for(pcmreader.sample_rate)
    bps = pcmreader.bits_per_sample
    channels = pcmreader.channels
    frame_sizes = []

    framelist = pcmreader.read(block_size)
    while len(framelist) > 0:
        data = encode_tta_frame(bps, channels,
                                framelist.samples.astype(np.int64))
        frame_sizes.append(len(data))
        file.write(data)
        framelist = pcmreader.read(block_size)
    return frame_sizes


def encode_tta_frame(bps, channels, samples):
    """encodes one TTA frame, returning bytes (with CRC-32)"""
    if channels == 1:
        correlated = samples.copy()
    else:
        correlated = correlate_channels(samples)

    residuals = np.stack(
        [tta_filter(bps, fixed_predict(bps, correlated[:, c]))
         for c in range(channels)], axis=1)

    # adaptive rice code; little-endian bit order, tokens built LSB-first
    bits = _LEBitWriter()
    k0 = [10] * channels
    k1 = [10] * channels
    sum0 = [1 << 14] * channels
    sum1 = [1 << 14] * channels

    for i in range(residuals.shape[0]):
        for c in range(channels):
            residual = int(residuals[i, c])
            if residual > 0:
                unsigned = (residual * 2) - 1
            else:
                unsigned = (-residual) * 2

            if unsigned < (1 << k0[c]):
                # unary(0, 0): single 0 bit
                bits.write(1, 0)
                bits.write(k0[c], unsigned)
            else:
                shifted = unsigned - (1 << k0[c])
                msb = 1 + (shifted >> k1[c])
                lsb = shifted - ((msb - 1) << k1[c])
                # unary(0, msb): msb one-bits then a 0
                bits.write_unary0(msb)
                bits.write(k1[c], lsb)
                sum1[c] += shifted - (sum1[c] >> 4)
                if sum1[c] < (1 << (k1[c] + 4)):
                    k1[c] = max(k1[c] - 1, 0)
                elif sum1[c] > (1 << (k1[c] + 5)):
                    k1[c] += 1

            sum0[c] += unsigned - (sum0[c] >> 4)
            if sum0[c] < (1 << (k0[c] + 4)):
                k0[c] = max(k0[c] - 1, 0)
            elif sum0[c] > (1 << (k0[c] + 5)):
                k0[c] += 1

    data = bits.to_bytes()
    return data + crc32(data).to_bytes(4, "little")


class _LEBitWriter:
    """little-endian bit accumulator (first bit written = LSB)"""

    def __init__(self):
        self.acc = 0
        self.bits = 0
        self.out = bytearray()

    def write(self, nbits, value):
        self.acc |= (value & ((1 << nbits) - 1)) << self.bits
        self.bits += nbits
        while self.bits >= 8:
            self.out.append(self.acc & 0xFF)
            self.acc >>= 8
            self.bits -= 8

    def write_unary0(self, value):
        """value one-bits then a zero bit"""
        while value >= 32:
            self.write(32, 0xFFFFFFFF)
            value -= 32
        self.write(value + 1, (1 << value) - 1)

    def to_bytes(self):
        if self.bits:
            self.out.append(self.acc & 0xFF)
            self.acc = 0
            self.bits = 0
        return bytes(self.out)


class TTADecoder:
    """a PCMReader-compatible TTA stream decoder"""

    def __init__(self, file_or_path):
        if isinstance(file_or_path, str):
            f = open(file_or_path, "rb")
        else:
            f = file_or_path
        self.reader = BitstreamReader(f, True)

        crc = CRC32()
        self.reader.add_callback(crc.update)
        (signature, format_, self.channels, self.bits_per_sample,
         self.sample_rate, self.total_pcm_frames) = self.reader.parse(
             "4b 16u 16u 16u 32u 32u")
        self.reader.pop_callback()
        header_crc = self.reader.read(32)
        if signature != b"TTA1":
            raise ValueError(text.ERR_TTA_INVALID_SIGNATURE)
        if format_ != 1:
            raise ValueError("invalid TTA format")
        if header_crc != int(crc):
            raise ValueError("invalid TTA header CRC")

        self.channel_mask = {1: 0x4, 2: 0x3}.get(self.channels, 0)

        self.total_tta_frames = div_ceil(self.total_pcm_frames * 245,
                                         self.sample_rate * 256)
        self.frame_lengths = [self.reader.read(32)
                              for _ in range(self.total_tta_frames)]
        self.reader.read(32)    # seektable CRC

        self.block_size = block_size_for(self.sample_rate)
        self.remaining = self.total_pcm_frames
        self.closed = False

    def read(self, pcm_frames):
        if self.closed:
            raise ValueError("stream is closed")
        if self.remaining <= 0:
            return pcm.empty_framelist(self.channels,
                                       self.bits_per_sample)

        frame_size = min(self.block_size, self.remaining)
        samples = self.decode_frame(frame_size)
        self.remaining -= frame_size
        return pcm.FrameList._wrap(samples.astype(np.int32),
                                   self.bits_per_sample)

    def decode_frame(self, n):
        """decodes one TTA frame of n PCM frames"""
        crc = CRC32()
        self.reader.add_callback(crc.update)

        channels = self.channels
        k0 = [10] * channels
        k1 = [10] * channels
        sum0 = [1 << 14] * channels
        sum1 = [1 << 14] * channels
        residuals = np.empty((n, channels), dtype=np.int64)

        unary = self.reader.unary
        read = self.reader.read
        for i in range(n):
            for c in range(channels):
                msb = unary(0)
                if msb == 0:
                    unsigned = read(k0[c])
                else:
                    lsb = read(k1[c])
                    shifted = ((msb - 1) << k1[c]) | lsb
                    unsigned = shifted + (1 << k0[c])
                    sum1[c] += shifted - (sum1[c] >> 4)
                    if sum1[c] < (1 << (k1[c] + 4)):
                        k1[c] = max(k1[c] - 1, 0)
                    elif sum1[c] > (1 << (k1[c] + 5)):
                        k1[c] += 1

                if unsigned & 1:
                    residuals[i, c] = (unsigned + 1) >> 1
                else:
                    residuals[i, c] = -(unsigned >> 1)

                sum0[c] += unsigned - (sum0[c] >> 4)
                if sum0[c] < (1 << (k0[c] + 4)):
                    k0[c] = max(k0[c] - 1, 0)
                elif sum0[c] > (1 << (k0[c] + 5)):
                    k0[c] += 1

        self.reader.byte_align()
        self.reader.pop_callback()
        frame_crc = self.reader.read(32)
        if frame_crc != int(crc):
            raise ValueError(text.ERR_TTA_INVALID_CRC)

        correlated = np.stack(
            [fixed_unpredict(self.bits_per_sample,
                             tta_unfilter(self.bits_per_sample,
                                          residuals[:, c]))
             for c in range(channels)], axis=1)

        if channels == 1:
            return correlated[:, :1]
        else:
            return decorrelate_channels(correlated)

    def close(self):
        self.closed = True
        self.reader.close()
