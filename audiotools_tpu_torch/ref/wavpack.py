"""WavPack: the block format, the host encoder and decoder.

The port's copy of the reference's ``audiotools_tpu/ref/wavpack.py``:
block and sub-block structure, 1-16 decorrelation passes with adaptive
weights (terms 18/17, 1-8 and the cross-channel -1/-2/-3), the
wv_log2/wv_exp2 storage of weights, samples and entropies, joint
stereo, extended (wasted-bit) integers, the per-block CRC and the
stream MD5.

The CRC, the residual reader and writer and the correlation and
decorrelation passes run on the host C++ (``_native.wv_*``), or, with
``ATPU_WV_ORACLE=1`` (read at each call, ``_use_native``), as the
reference's scalar Python oracle.  One repair of the reference: the
scalar residual writer codes Python integers (``_write_egc``), where
the reference's raised AttributeError on a numpy integer as soon as a
residual reached the escape code.

Its module-global hooks for device decorrelation are explicit here:
``encode_wavpack`` takes a ``correlate`` callable that decorrelates all
the channel groups of one frame (``correlate_host`` by default), and
the decoder's two phases, ``parse_block`` and ``finish_block``, let a
batched decoder (``codecs/wavpack.TorchWavPackDecoder``) decorrelate
many blocks between them.
"""

from __future__ import annotations

import os
import struct
from hashlib import md5

import numpy as np

from .. import _native, pcm
from ..bitstream import BitstreamReader, BitstreamRecorder, BitstreamWriter
from ..formats.wav import build_fmt
from ..ops.wv_scan import span

(WV_WAVE_HEADER, WV_TERMS, WV_WEIGHTS, WV_SAMPLES, WV_ENTROPY,
 WV_MD5, WV_SAMPLE_RATE) = (0x1, 0x2, 0x3, 0x4, 0x5, 0x6, 0x7)
# the RIFF bytes after the PCM: function 2 with the nondecoder flag
WV_WAVE_FOOTER = 0x2
WV_INT32_INFO = 0x9
WV_BITSTREAM = 0xA
WV_CHANNEL_INFO = 0xD

SAMPLE_RATES = [6000, 8000, 9600, 11025, 12000, 16000, 22050, 24000,
                32000, 44100, 48000, 64000, 88200, 96000, 192000]

# EXP2[i] = round(256 * 2^(i/256)) and LOG2[i] = round(256 *
# log2(1 + i/256)): the format's defining curves
EXP2_TABLE = np.round(256.0 * np.exp2(np.arange(256) / 256.0)).astype(
    np.int64)
LOG2_TABLE = np.round(256.0 * np.log2(1.0 + np.arange(256) / 256.0)).astype(
    np.int64)


def _use_native():
    """False when ATPU_WV_ORACLE is 1: the scalar oracle runs in place
    of the host C++"""
    return os.environ.get("ATPU_WV_ORACLE", "0") != "1"


def wv_exp2(value):
    """the 16-bit log-domain value as a linear one"""
    if -32768 <= value < -2304:
        return -int(EXP2_TABLE[-value & 0xFF] << ((-value >> 8) - 9))
    elif -2304 <= value < 0:
        return -int(EXP2_TABLE[-value & 0xFF] >> (9 - (-value >> 8)))
    elif 0 <= value <= 2304:
        return int(EXP2_TABLE[value & 0xFF] >> (9 - (value >> 8)))
    return int(EXP2_TABLE[value & 0xFF] << ((value >> 8) - 9))


def wv_log2(value):
    """the linear value as a 16-bit log-domain one"""
    value = int(value)
    a = abs(value) + (abs(value) >> 9)
    c = a.bit_length() if a else 0
    if 0 <= a < 256:
        log_val = (c << 8) + int(LOG2_TABLE[(a << (9 - c)) % 256])
    else:
        log_val = (c << 8) + int(LOG2_TABLE[(a >> (c - 9)) % 256])
    return log_val if value > 0 else (0 if value == 0 else -log_val)


def apply_weight(weight, sample):
    return ((weight * sample) + 512) >> 10


def update_weight(source, result, delta):
    if (source == 0) or (result == 0):
        return 0
    elif (source ^ result) >= 0:
        return delta
    else:
        return -delta


def store_weight(w):
    w = min(max(w, -1024), 1024)
    if w > 0:
        return ((w - ((w + 64) >> 7)) + 4) >> 3
    elif w == 0:
        return 0
    return (w + 4) >> 3


def restore_weight(v):
    if v > 0:
        return (v << 3) + (((v << 3) + 64) >> 7)
    elif v == 0:
        return 0
    return v << 3


def calculate_crc(channels):
    """the per-block sample CRC of 1-2 channels: the host C++, or the
    scalar oracle under ATPU_WV_ORACLE=1"""
    if _use_native():
        return _native.wv_crc(channels)
    crc = 0xFFFFFFFF
    for frame in zip(*[np.asarray(c, dtype=np.int64).tolist()
                       for c in channels]):
        for s in frame:
            crc = (3 * crc + s) & 0xFFFFFFFF
    return crc


# ---------------------------------------------------------------------------
# decoder
# ---------------------------------------------------------------------------

class Block_Header:
    FIELDS = ["block_size", "version", "track_number", "index_number",
              "total_samples", "block_index", "block_samples",
              "bits_per_sample", "mono_output", "hybrid_mode",
              "joint_stereo", "channel_decorrelation",
              "hybrid_noise_shaping", "floating_point_data",
              "extended_size_integers", "hybrid_controls_bitrate",
              "hybrid_noise_balanced", "initial_block", "final_block",
              "left_shift_data", "maximum_magnitude", "sample_rate",
              "use_IIR", "false_stereo", "CRC"]

    def __init__(self, *values):
        if values[0] != b"wvpk":
            raise ValueError("invalid WavPack block ID")
        for (field, value) in zip(self.FIELDS, values[1:]):
            setattr(self, field, value)

    @classmethod
    def read(cls, reader):
        return cls(*reader.parse("4b 32u 16u 8u 8u 32u 32u 32u"
                                 "2u 11* 1u 5u 5u 4u 2p 1u 1u 1p"
                                 "32u"))


class WavPackDecoder:
    """a PCMReader decoding a WavPack stream on the host, one block
    group (all channels of a block index) a read"""

    def __init__(self, file_or_path):
        if isinstance(file_or_path, str):
            f = open(file_or_path, "rb")
        else:
            f = file_or_path
        self.reader = BitstreamReader(f, little_endian=True)

        # where the stream starts in an already open file, for seek()
        self._stream_start = self.reader.source.tell()
        self._block_index_cache = None

        # the initial block's stream parameters
        self.reader.mark()
        header = Block_Header.read(self.reader)
        sub_blocks = self.reader.read_bytes(header.block_size - 24)

        if header.sample_rate != 15:
            self.sample_rate = SAMPLE_RATES[header.sample_rate]
        else:
            for (function, nondecoder, data) in walk_sub_blocks(sub_blocks):
                if (function == WV_SAMPLE_RATE) and nondecoder:
                    self.sample_rate = int.from_bytes(data, "little")
                    break
            else:
                raise ValueError("invalid sample rate")

        self.bits_per_sample = [8, 16, 24, 32][header.bits_per_sample]

        if header.initial_block and header.final_block:
            if (header.mono_output == 0) or header.false_stereo:
                self.channels = 2
                self.channel_mask = 0x3
            else:
                self.channels = 1
                self.channel_mask = 0x4
        else:
            for (function, nondecoder, data) in walk_sub_blocks(sub_blocks):
                if (function == WV_CHANNEL_INFO) and (nondecoder == 0):
                    self.channels = data[0]
                    self.channel_mask = int.from_bytes(data[1:], "little")
                    break
            else:
                raise ValueError("channel mask sub block not found")

        self.total_frames = header.total_samples

        self.reader.rewind()
        self.reader.unmark()

        self.pcm_finished = False
        self.md5_checked = False
        self.md5sum = md5()

    def read_group(self):
        """reads one initial..final run of blocks: ([(header, sub-block
        bytes)], True), or what was read and False at the stream's end"""
        group = []
        while True:
            try:
                header = Block_Header.read(self.reader)
            except (ValueError, IOError):
                return (group, False)
            group.append((header,
                          self.reader.read_bytes(header.block_size - 24)))
            if header.final_block == 1:
                return (group, True)

    def check_md5(self):
        """checks the stream MD5 of a trailing block, if there is one,
        once: ValueError when it differs from the samples' MD5"""
        if self.md5_checked:
            return
        try:
            self.reader.mark()
            try:
                header = Block_Header.read(self.reader)
                sub_blocks = self.reader.read_bytes(header.block_size - 24)
                for (function, nondecoder, data) in \
                        walk_sub_blocks(sub_blocks):
                    if (function == WV_MD5) and nondecoder:
                        if data[:16] != self.md5sum.digest():
                            raise ValueError("invalid stream MD5 sum")
            except (IOError, ValueError) as err:
                if "MD5" in str(err):
                    raise
            finally:
                self.reader.rewind()
                self.reader.unmark()
        finally:
            self.md5_checked = True

    def group_done(self, header):
        """notes a decoded group: the stream is finished once its last
        block reaches the total sample count"""
        if (header.block_index + header.block_samples) >= \
                header.total_samples:
            self.pcm_finished = True

    def framelist(self, channels):
        """the group's channels as a FrameList, hashed into the MD5"""
        out = np.stack([np.asarray(ch, dtype=np.int64) for ch in channels],
                       axis=1).astype(np.int32)
        framelist = pcm.FrameList._wrap(out, self.bits_per_sample)
        self.md5sum.update(framelist.to_bytes(False,
                                              self.bits_per_sample > 8))
        return framelist

    def read(self, pcm_frames):
        if self.pcm_finished:
            self.check_md5()
            return pcm.empty_framelist(self.channels, self.bits_per_sample)
        (group, ok) = self.read_group()
        if not ok:
            self.pcm_finished = True
            return pcm.empty_framelist(self.channels, self.bits_per_sample)
        channels = []
        for (header, sub_blocks) in group:
            parsed = parse_block(header, sub_blocks)
            channels.extend(finish_block(header, parsed,
                                         decorrelate_host(parsed)))
        self.group_done(group[-1][0])
        return self.framelist(channels)

    def seekable(self):
        return True

    def seek(self, pcm_frame):
        """seeks to the last initial block at or before the given PCM
        frame; returns its position.  Blocks decode independently, so
        one scan of the block headers builds a table of the initial
        blocks that later seeks reuse.  Seeking turns the end-of-stream
        MD5 check off."""
        target = max(int(pcm_frame), 0)
        r = self.reader
        if self._block_index_cache is None:
            index = []
            r.seek(self._stream_start, 0)
            byte_pos = self._stream_start
            while True:
                try:
                    header = Block_Header.read(r)
                except (IOError, ValueError):
                    break
                if header.initial_block:
                    index.append((header.block_index, byte_pos))
                # a block is block_size + 8 bytes long, 32 of them read
                r.skip_bytes(header.block_size - 24)
                byte_pos += header.block_size + 8
            self._block_index_cache = index
        best = (0, self._stream_start)
        for (block_index, byte_pos) in self._block_index_cache:
            if block_index <= target:
                best = (block_index, byte_pos)
            else:
                break
        r.seek(best[1], 0)
        self.pcm_finished = False
        self.md5_checked = True
        return best[0]

    def close(self):
        self.reader.close()


def walk_sub_blocks(data):
    """yields (metadata function, nondecoder flag, data bytes)"""
    pos = 0
    while pos < len(data):
        byte0 = data[pos]
        function = byte0 & 0x1F
        nondecoder = (byte0 >> 5) & 1
        actual_size_1_less = (byte0 >> 6) & 1
        if (byte0 >> 7) & 1:
            size = int.from_bytes(data[pos + 1:pos + 4], "little")
            pos += 4
        else:
            size = data[pos + 1]
            pos += 2
        payload = data[pos:pos + size * 2]
        if actual_size_1_less:
            payload = payload[:-1]
        pos += size * 2
        yield (function, nondecoder, payload)


def parse_block(header, sub_blocks):
    """phase 1 of a block's decode: the sub-block walk and the entropy
    decode, no decorrelation; returns a dict of residuals, terms,
    deltas, weights, samples, two_ch and the extended-integer bits"""
    if header.hybrid_mode:
        raise ValueError("hybrid mode not supported")
    if header.floating_point_data:
        raise ValueError("floating point data not supported")

    terms = deltas = weights = samples = entropies = None
    residuals = None
    zero_bits = one_bits = duplicate_bits = 0

    two_ch = (header.mono_output == 0) and (header.false_stereo == 0)

    for (function, nondecoder, data) in walk_sub_blocks(sub_blocks):
        if nondecoder:
            continue
        reader = BitstreamReader(data, little_endian=True)
        if function == WV_TERMS:
            terms = []
            deltas = []
            for byte in data:
                term = (byte & 0x1F) - 5
                if not ((1 <= term <= 18) or (-3 <= term <= -1)):
                    raise ValueError("invalid decorrelation term")
                terms.append(term)
                deltas.append((byte >> 5) & 0x7)
            terms.reverse()
            deltas.reverse()
        elif function == WV_WEIGHTS:
            values = [restore_weight(v - 256 if v >= 128 else v)
                      for v in data]
            weights = []
            if two_ch:
                for i in range(len(values) // 2):
                    weights.append([values[i * 2], values[i * 2 + 1]])
                for i in range(len(values) // 2, len(terms)):
                    weights.append([0, 0])
            else:
                for v in values:
                    weights.append([v])
                for i in range(len(values), len(terms)):
                    weights.append([0])
            weights.reverse()
        elif function == WV_SAMPLES:
            samples = read_decorrelation_samples(reader, terms, two_ch,
                                                 len(data))
        elif function == WV_ENTROPY:
            entropies = [[wv_exp2(reader.read_signed(16))
                          for _ in range(3)]]
            if two_ch:
                entropies.append([wv_exp2(reader.read_signed(16))
                                  for _ in range(3)])
            else:
                entropies.append([0, 0, 0])
        elif function == WV_INT32_INFO:
            (_sent, zero_bits, one_bits, duplicate_bits) = data[0:4]
        elif function == WV_BITSTREAM:
            if entropies is None:
                raise ValueError("bitstream before entropy variables")
            residuals = read_bitstream(reader, data, header.block_samples,
                                       2 if two_ch else 1, entropies)

    if residuals is None:
        raise ValueError("bitstream sub block not found")

    return {"residuals": residuals, "terms": terms, "deltas": deltas,
            "weights": weights, "samples": samples, "two_ch": two_ch,
            "zero_bits": zero_bits, "one_bits": one_bits,
            "duplicate_bits": duplicate_bits}


def read_bitstream(reader, data, block_samples, channel_count, entropies):
    """the residuals of a bitstream sub-block (``data``, read by
    ``reader``), block_samples a channel: the host C++, or the scalar
    oracle under ATPU_WV_ORACLE=1; entropies, [[3], [3]], are updated
    in place"""
    if _use_native():
        return _native.wv_read_bitstream(data, block_samples, channel_count,
                                         entropies)
    return _read_bitstream(reader, block_samples, channel_count, entropies)


def _read_egc(reader):
    t = reader.unary(0)
    if t > 0:
        p = reader.read(t - 1)
        return (1 << (t - 1)) + p
    else:
        return t


def _read_residual(reader, last_u, entropies):
    if last_u is None:
        u = reader.unary(0)
        if u == 16:
            u += _read_egc(reader)
        m = u // 2
    elif (last_u % 2) == 1:
        u = reader.unary(0)
        if u == 16:
            u += _read_egc(reader)
        m = (u // 2) + 1
    else:
        u = None
        m = 0

    if m == 0:
        base = 0
        add = entropies[0] >> 4
        entropies[0] -= ((entropies[0] + 126) >> 7) * 2
    elif m == 1:
        base = (entropies[0] >> 4) + 1
        add = entropies[1] >> 4
        entropies[0] += ((entropies[0] + 128) >> 7) * 5
        entropies[1] -= ((entropies[1] + 62) >> 6) * 2
    elif m == 2:
        base = ((entropies[0] >> 4) + 1) + ((entropies[1] >> 4) + 1)
        add = entropies[2] >> 4
        entropies[0] += ((entropies[0] + 128) >> 7) * 5
        entropies[1] += ((entropies[1] + 64) >> 6) * 5
        entropies[2] -= ((entropies[2] + 30) >> 5) * 2
    else:
        base = (((entropies[0] >> 4) + 1) +
                ((entropies[1] >> 4) + 1) +
                (((entropies[2] >> 4) + 1) * (m - 2)))
        add = entropies[2] >> 4
        entropies[0] += ((entropies[0] + 128) >> 7) * 5
        entropies[1] += ((entropies[1] + 64) >> 6) * 5
        entropies[2] += ((entropies[2] + 32) >> 5) * 5

    if add == 0:
        unsigned = base
    else:
        p = add.bit_length() - 1
        e = (1 << (p + 1)) - add - 1
        r = reader.read(p)
        if r >= e:
            b = reader.read(1)
            unsigned = base + (r * 2) - e + b
        else:
            unsigned = base + r

    if reader.read(1):
        return (-unsigned - 1, u)
    else:
        return (unsigned, u)


def _read_bitstream(reader, block_samples, channel_count, entropies):
    """the scalar residual reader"""
    residuals = [[] for _ in range(channel_count)]
    u = None
    i = 0
    total = block_samples * channel_count
    while i < total:
        if ((u is None) and (entropies[0][0] < 2) and
                (entropies[1][0] < 2)):
            zeroes = _read_egc(reader)
            if zeroes > 0:
                for _ in range(zeroes):
                    residuals[i % channel_count].append(0)
                    i += 1
                entropies[0][0:3] = [0, 0, 0]
                entropies[1][0:3] = [0, 0, 0]
            if i < total:
                (residual, u) = _read_residual(
                    reader, u, entropies[i % channel_count])
                residuals[i % channel_count].append(residual)
                i += 1
        else:
            (residual, u) = _read_residual(
                reader, u, entropies[i % channel_count])
            residuals[i % channel_count].append(residual)
            i += 1
    return residuals


def finish_block(header, parsed, decorrelated):
    """phase 2 of a block's decode: joint stereo undone, the CRC
    checked, extended integers restored, false stereo expanded; returns
    the block's channels"""
    two_ch = parsed["two_ch"]
    if two_ch and header.joint_stereo:
        decorrelated = undo_joint_stereo(decorrelated)

    if calculate_crc(decorrelated) != header.CRC:
        raise ValueError("block CRC mismatch")

    if header.extended_size_integers:
        decorrelated = undo_extended_integers(
            parsed["zero_bits"], parsed["one_bits"],
            parsed["duplicate_bits"], decorrelated)

    if header.false_stereo:
        return [decorrelated[0], decorrelated[0]]
    return list(decorrelated)


def read_decorrelation_samples(reader, terms, two_ch, data_bytes):
    """samples[pass][channel][s], in the stored order"""
    samples = []
    remaining = data_bytes
    channels = 2 if two_ch else 1

    def read_values(count):
        return [wv_exp2(reader.read_signed(16)) for _ in range(count)]

    for term in reversed(terms):
        if 17 <= term <= 18:
            needed = 4 * channels
            if remaining >= needed:
                samples.append([read_values(2) for _ in range(channels)])
                remaining -= needed
            else:
                samples.append([[0, 0] for _ in range(channels)])
                remaining = 0
        elif 1 <= term <= 8:
            needed = term * 2 * channels
            if remaining >= needed:
                values = read_values(term * channels)
                samples.append([values[c::channels]
                                for c in range(channels)])
                remaining -= needed
            else:
                samples.append([[0] * term for _ in range(channels)])
                remaining = 0
        elif -3 <= term <= -1:
            if remaining >= 4:
                samples.append([read_values(1), read_values(1)])
                remaining -= 4
            else:
                samples.append([[0], [0]])
                remaining = 0
        else:
            raise ValueError("invalid decorrelation term")
    samples.reverse()
    return samples


def decorrelate_host(parsed):
    """a parsed block's decode decorrelation on the host C++ (the scalar
    oracle under ATPU_WV_ORACLE=1), pass by pass; the residuals when the
    block has no passes"""
    residuals = parsed["residuals"]
    if not parsed["terms"]:
        return residuals
    if not _use_native():
        return _decorrelate_channels(
            [np.asarray(r, dtype=np.int64).tolist() for r in residuals],
            parsed["terms"], parsed["deltas"], parsed["weights"],
            parsed["samples"])
    cc = len(residuals)
    latest = list(residuals)
    for (term, delta, weights, dec_samples) in zip(
            parsed["terms"], parsed["deltas"], parsed["weights"],
            parsed["samples"]):
        if not (17 <= term <= 18 or 1 <= term <= 8 or
                (cc == 2 and -3 <= term <= -1)):
            raise ValueError("unsupported term")
        latest = _native.wv_decorrelate(latest, term, delta, weights[:cc],
                                        dec_samples)
    return latest


# the scalar decode passes (ATPU_WV_ORACLE=1)

def _decorrelate_channels(residuals, terms, deltas, weights,
                          samples_list):
    if len(residuals) == 2:
        latest = [r for r in residuals]
        for (term, delta, weight_pair, dec_samples) in zip(
                terms, deltas, weights, samples_list):
            latest = _decorrelation_pass_2ch(latest, term, delta,
                                             weight_pair, dec_samples)
        return latest
    else:
        latest = residuals[0]
        for (term, delta, weight_pair, dec_samples) in zip(
                terms, deltas, weights, samples_list):
            latest = _decorrelation_pass_1ch(latest, term, delta,
                                             weight_pair[0],
                                             dec_samples[0])
        return [latest]


def _decorrelation_pass_1ch(correlated, term, delta, weight,
                            dec_samples):
    if term in (17, 18):
        decorrelated = list(dec_samples[::-1])
        for i in range(len(correlated)):
            if term == 18:
                temp = (3 * decorrelated[i + 1] - decorrelated[i]) >> 1
            else:
                temp = 2 * decorrelated[i + 1] - decorrelated[i]
            decorrelated.append(apply_weight(weight, temp) +
                                correlated[i])
            weight += update_weight(temp, correlated[i], delta)
        return decorrelated[2:]
    elif 1 <= term <= 8:
        decorrelated = list(dec_samples)
        for i in range(len(correlated)):
            decorrelated.append(apply_weight(weight, decorrelated[i]) +
                                correlated[i])
            weight += update_weight(decorrelated[i], correlated[i],
                                    delta)
        return decorrelated[term:]
    else:
        raise ValueError("unsupported term")


def _decorrelation_pass_2ch(correlated, term, delta, weights,
                            dec_samples):
    if (17 <= term <= 18) or (1 <= term <= 8):
        return [_decorrelation_pass_1ch(correlated[0], term, delta,
                                        weights[0], dec_samples[0]),
                _decorrelation_pass_1ch(correlated[1], term, delta,
                                        weights[1], dec_samples[1])]
    elif -3 <= term <= -1:
        decorrelated = ([dec_samples[1][0]], [dec_samples[0][0]])
        weights = list(weights)
        n = len(correlated[0])
        for i in range(n):
            if term == -1:
                decorrelated[0].append(
                    apply_weight(weights[0], decorrelated[1][i]) +
                    correlated[0][i])
                decorrelated[1].append(
                    apply_weight(weights[1], decorrelated[0][i + 1]) +
                    correlated[1][i])
                weights[0] += update_weight(decorrelated[1][i],
                                            correlated[0][i], delta)
                weights[1] += update_weight(decorrelated[0][i + 1],
                                            correlated[1][i], delta)
            elif term == -2:
                decorrelated[1].append(
                    apply_weight(weights[1], decorrelated[0][i]) +
                    correlated[1][i])
                decorrelated[0].append(
                    apply_weight(weights[0], decorrelated[1][i + 1]) +
                    correlated[0][i])
                weights[1] += update_weight(decorrelated[0][i],
                                            correlated[1][i], delta)
                weights[0] += update_weight(decorrelated[1][i + 1],
                                            correlated[0][i], delta)
            else:  # term == -3
                decorrelated[0].append(
                    apply_weight(weights[0], decorrelated[1][i]) +
                    correlated[0][i])
                decorrelated[1].append(
                    apply_weight(weights[1], decorrelated[0][i]) +
                    correlated[1][i])
                weights[0] += update_weight(decorrelated[1][i],
                                            correlated[0][i], delta)
                weights[1] += update_weight(decorrelated[0][i],
                                            correlated[1][i], delta)
            weights[0] = max(min(weights[0], 1024), -1024)
            weights[1] = max(min(weights[1], 1024), -1024)
        return [decorrelated[0][1:], decorrelated[1][1:]]
    else:
        raise ValueError("unsupported term")


def undo_joint_stereo(samples):
    mid = np.asarray(samples[0], dtype=np.int64)
    side = np.asarray(samples[1], dtype=np.int64)
    right = side - (mid >> 1)
    return [mid + right, right]


def undo_extended_integers(zero_bits, one_bits, duplicate_bits, channels):
    out = []
    for channel in channels:
        arr = np.asarray(channel, dtype=np.int64)
        if zero_bits:
            arr = arr << zero_bits
        elif one_bits:
            arr = (arr << one_bits) + ((1 << one_bits) - 1)
        elif duplicate_bits:
            ones = (1 << duplicate_bits) - 1
            arr = np.where(arr % 2 == 0, arr << duplicate_bits,
                           (arr << duplicate_bits) + ones)
        out.append(arr)
    return out


# ---------------------------------------------------------------------------
# encoder
# ---------------------------------------------------------------------------

class CorrelationParameters:
    """the parameters of one correlation pass"""

    def __init__(self, term, delta, weights, samples):
        self.term = term
        self.delta = delta
        self.weights = weights
        self.samples = samples

    def update_weights(self, weights):
        self.weights = [restore_weight(store_weight(w)) for w in weights]

    def update_samples(self, samples):
        self.samples = [[wv_exp2(wv_log2(s)) for s in c] for c in samples]


# (term, delta) of each pass, by pass count (the reference's
# py_encoders/wavpack.py:176-282, the standard WavPack filter specs)
PASS_RECIPES_2CH = {
    0: [],
    1: [(18, 2)],
    2: [(17, 2), (18, 2)],
    5: [(3, 2), (17, 2), (2, 2), (18, 2), (18, 2)],
    10: [(4, 2), (17, 2), (-1, 2), (5, 2), (3, 2), (2, 2), (-2, 2),
         (18, 2), (18, 2), (18, 2)],
    16: [(2, 2), (18, 2), (-1, 2), (8, 2), (6, 2), (3, 2), (5, 2),
         (7, 2), (4, 2), (2, 2), (18, 2), (-2, 2), (3, 2), (2, 2),
         (18, 2), (18, 2)],
}
PASS_RECIPES_1CH = {
    0: [],
    1: [(18, 2)],
    2: [(17, 2), (18, 2)],
    5: [(3, 2), (17, 2), (2, 2), (18, 2), (18, 2)],
    10: [(3, 2), (17, 2), (2, 2), (18, 2), (18, 2)],
    16: [(3, 2), (17, 2), (2, 2), (18, 2), (18, 2)],
}


class EncodingParameters:
    """the encoding state of one 1-2 channel block group"""

    def __init__(self, channel_count, correlation_passes):
        self.channel_count = channel_count
        self.correlation_passes = correlation_passes
        self.entropy_variables = [[0, 0, 0], [0, 0, 0]]
        self._parameters_channel_count = 0
        self._correlation_parameters = None

    def correlation_parameters(self, false_stereo):
        """the CorrelationParameters of each pass (made anew when the
        group's coded channel count changes)"""
        if (self.channel_count == 2) and (not false_stereo):
            channel_count = 2
            recipes = PASS_RECIPES_2CH[self.correlation_passes]
        else:
            channel_count = 1
            recipes = PASS_RECIPES_1CH[self.correlation_passes]

        if channel_count != self._parameters_channel_count:
            self._parameters_channel_count = channel_count
            self._correlation_parameters = [
                CorrelationParameters(
                    term, delta, [0] * channel_count,
                    [[0] * span(term)
                     for _ in range(channel_count)])
                for (term, delta) in recipes]
        return list(self._correlation_parameters)


def block_parameters(channel_count, channel_mask, correlation_passes):
    """splits a channel layout into 1-2 channel block groups"""
    layouts = {(3, 0x7): (2, 1), (4, 0x33): (2, 2), (4, 0x107): (2, 1, 1),
               (5, 0x37): (2, 1, 2), (6, 0x3F): (2, 1, 1, 2)}
    if channel_count in (1, 2):
        counts = (channel_count,)
    else:
        counts = layouts.get((channel_count, channel_mask),
                             (1,) * channel_count)
    return [EncodingParameters(c, correlation_passes) for c in counts]


class EncoderContext:
    def __init__(self, pcmreader, parameters, wave_header=None,
                 wave_footer=None):
        self.pcmreader = pcmreader
        self.block_parameters = parameters
        self.total_frames = 0
        self.block_offsets = []
        self.md5sum = md5()
        self.first_block_written = False
        self.wave_header = wave_header
        self.wave_footer = wave_footer


def write_wave_header(writer, pcmreader, total_frames, footer_size=0):
    """the RIFF header stored in the first block, for a stored footer of
    ``footer_size`` bytes"""
    fmt = build_fmt(pcmreader.channels, pcmreader.sample_rate,
                    pcmreader.bits_per_sample, pcmreader.channel_mask)
    data_size = (total_frames * pcmreader.channels *
                 (pcmreader.bits_per_sample // 8))
    total_size = 4 + (8 + len(fmt)) + (8 + data_size) + footer_size
    writer.write_bytes(b"RIFF" + struct.pack("<I", total_size) + b"WAVE" +
                       b"fmt " + struct.pack("<I", len(fmt)) + fmt +
                       b"data" + struct.pack("<I", data_size))


def correlate_channels(uncorrelated, params, channel_count):
    """runs a group's correlation passes on the host C++ (the scalar
    oracle under ATPU_WV_ORACLE=1), updating the parameters in place;
    returns the correlated channels"""
    if not _use_native():
        return _correlate_scalar(uncorrelated, params, channel_count)
    latest = list(uncorrelated[:channel_count])
    for p in params:
        (latest, weights, samples) = _native.wv_correlate(
            latest, p.term, p.delta, p.weights, p.samples)
        p.update_weights(weights)
        # negative terms keep their stored samples
        p.update_samples(samples if p.term > 0 else p.samples)
    return latest


def _correlate_scalar(uncorrelated, params, channel_count):
    """the scalar correlation passes, updating the parameters in place"""
    uncorrelated = [np.asarray(c, dtype=np.int64).tolist()
                    for c in uncorrelated[:channel_count]]
    if channel_count == 1:
        latest = uncorrelated[0]
        for p in params:
            (latest, weight, samples) = correlation_pass_1ch(
                latest, p.term, p.delta, p.weights[0], p.samples[0])
            p.update_weights([weight])
            p.update_samples([samples])
        return [latest]
    else:
        latest = uncorrelated
        for p in params:
            (latest, weights, samples) = correlation_pass_2ch(
                latest, p.term, p.delta, p.weights, p.samples)
            p.update_weights(weights)
            p.update_samples(samples)
        return latest


def correlation_pass_1ch(uncorrelated, term, delta, weight,
                         correlation_samples):
    if term in (17, 18):
        full = [correlation_samples[1],
                correlation_samples[0]] + list(uncorrelated)
        correlated = []
        for i in range(2, len(full)):
            if term == 18:
                temp = (3 * full[i - 1] - full[i - 2]) >> 1
            else:
                temp = 2 * full[i - 1] - full[i - 2]
            correlated.append(full[i] - apply_weight(weight, temp))
            weight += update_weight(temp, correlated[i - 2], delta)
        return (correlated, weight, list(reversed(correlated[-2:])))
    elif 1 <= term <= 8:
        full = list(correlation_samples) + list(uncorrelated)
        correlated = []
        for i in range(term, len(full)):
            correlated.append(full[i] -
                              apply_weight(weight, full[i - term]))
            weight += update_weight(full[i - term],
                                    correlated[i - term], delta)
        return (correlated, weight, correlated[-term:])
    else:
        raise ValueError("unsupported term")


def correlation_pass_2ch(uncorrelated, term, delta, weights,
                         correlation_samples):
    if (17 <= term <= 18) or (1 <= term <= 8):
        (un1, w1, s1) = correlation_pass_1ch(
            uncorrelated[0], term, delta, weights[0],
            correlation_samples[0])
        (un2, w2, s2) = correlation_pass_1ch(
            uncorrelated[1], term, delta, weights[1],
            correlation_samples[1])
        return ([un1, un2], [w1, w2], [s1, s2])
    elif -3 <= term <= -1:
        full = (list(correlation_samples[1]) + list(uncorrelated[0]),
                list(correlation_samples[0]) + list(uncorrelated[1]))
        correlated = [[], []]
        weights = list(weights)
        for i in range(1, len(full[0])):
            if term == -1:
                correlated[0].append(full[0][i] -
                                     apply_weight(weights[0],
                                                  full[1][i - 1]))
                correlated[1].append(full[1][i] -
                                     apply_weight(weights[1],
                                                  full[0][i]))
                weights[0] += update_weight(full[1][i - 1],
                                            correlated[0][-1], delta)
                weights[1] += update_weight(full[0][i],
                                            correlated[1][-1], delta)
            elif term == -2:
                correlated[0].append(full[0][i] -
                                     apply_weight(weights[0],
                                                  full[1][i]))
                correlated[1].append(full[1][i] -
                                     apply_weight(weights[1],
                                                  full[0][i - 1]))
                weights[0] += update_weight(full[1][i],
                                            correlated[0][-1], delta)
                weights[1] += update_weight(full[0][i - 1],
                                            correlated[1][-1], delta)
            else:  # term == -3
                correlated[0].append(full[0][i] -
                                     apply_weight(weights[0],
                                                  full[1][i - 1]))
                correlated[1].append(full[1][i] -
                                     apply_weight(weights[1],
                                                  full[0][i - 1]))
                weights[0] += update_weight(full[1][i - 1],
                                            correlated[0][-1], delta)
                weights[1] += update_weight(full[0][i - 1],
                                            correlated[1][-1], delta)
            weights[0] = max(min(weights[0], 1024), -1024)
            weights[1] = max(min(weights[1], 1024), -1024)
        return (correlated, weights, correlation_samples)
    else:
        raise ValueError("unsupported term")


def correlate_host(jobs):
    """the default ``correlate`` of encode_wavpack: each job (the
    uncorrelated channels, the CorrelationParameters and the coded
    channel count of one block) on the host C++; returns each job's
    correlated channels"""
    return [correlate_channels(*job) for job in jobs]


def encode_wavpack(file_or_path, pcmreader, block_size, total_pcm_frames=0,
                   correlation_passes=0, correlate=correlate_host,
                   wave_header=None, wave_footer=None):
    """encodes a WavPack stream from a PCMReader

    correlate: called once a frame with the list of (uncorrelated
    channels, CorrelationParameters, coded channel count) of the frame's
    block groups that have passes; returns their correlated channels and
    leaves each pass's quantized weights and stored samples in its
    parameters, as correlate_host does.  wave_header, wave_footer: the
    RIFF bytes to store before and after the PCM (a WAVE's foreign
    chunks); without a header, one of the fmt and data chunks alone is
    built and stored"""
    pcmreader = pcm.BufferedPCMReader(pcmreader)
    if isinstance(file_or_path, str):
        output_file = open(file_or_path, "wb")
        close_file = True
    else:
        output_file = file_or_path
        close_file = False
    writer = BitstreamWriter(output_file, little_endian=True)
    context = EncoderContext(pcmreader,
                             block_parameters(pcmreader.channels,
                                              pcmreader.channel_mask,
                                              correlation_passes),
                             wave_header, wave_footer)

    block_index = 0
    frame = pcmreader.read(block_size)
    while frame.frames > 0:
        context.total_frames += frame.frames
        context.md5sum.update(
            frame.to_bytes(False, pcmreader.bits_per_sample >= 16))

        blocks = []
        c = 0
        for parameters in context.block_parameters:
            channel_data = [frame.samples[:, c + k].astype(np.int64)
                            for k in range(parameters.channel_count)]
            blocks.append(begin_block(context, channel_data, parameters))
            c += parameters.channel_count
        jobs = [(b["uncorrelated"], b["params"], b["channel_count"])
                for b in blocks if b["params"]]
        correlated = iter(correlate(jobs) if jobs else [])
        for (parameters, block) in zip(context.block_parameters, blocks):
            if total_pcm_frames == 0:
                writer.flush()
                context.block_offsets.append(output_file.tell())
            end_block(writer, context, block,
                      next(correlated) if block["params"]
                      else block["uncorrelated"],
                      total_pcm_frames, block_index,
                      parameters is context.block_parameters[0],
                      parameters is context.block_parameters[-1],
                      parameters)

        block_index += frame.frames
        frame = pcmreader.read(block_size)

    # the final block: the MD5 sum and the stored footer
    sub_blocks = BitstreamRecorder(little_endian=True)
    sub_block = BitstreamRecorder(little_endian=True)
    sub_block.write_bytes(context.md5sum.digest())
    write_sub_block(sub_blocks, WV_MD5, 1, sub_block)
    if wave_footer is not None:
        sub_block.reset()
        sub_block.write_bytes(wave_footer)
        write_sub_block(sub_blocks, WV_WAVE_FOOTER, 1, sub_block)

    if total_pcm_frames == 0:
        writer.flush()
        context.block_offsets.append(output_file.tell())
    write_block_header(
        writer, sub_blocks.bytes(),
        (total_pcm_frames if total_pcm_frames > 0 else 0xFFFFFFFF),
        0xFFFFFFFF, 0, pcmreader.bits_per_sample, 1, 0, 0, 0, 1, 1, 0,
        pcmreader.sample_rate, 0, 0xFFFFFFFF)
    sub_blocks.copy(writer)
    writer.flush()

    # the built RIFF header's sizes, now that the length is known
    if wave_header is None:
        output_file.seek(32 + 2)
        header_rec = BitstreamRecorder(little_endian=True)
        write_wave_header(header_rec, context.pcmreader,
                          context.total_frames, _footer_size(wave_footer))
        output_file.write(header_rec.data())

    # the total sample count of streamed block headers
    for block_offset in context.block_offsets:
        output_file.seek(block_offset + 12, 0)
        output_file.write(block_index.to_bytes(4, "little"))

    if close_file:
        output_file.close()
    else:
        output_file.seek(0, 2)


def _footer_size(wave_footer):
    return 0 if wave_footer is None else len(wave_footer)


def begin_block(context, channels, parameters):
    """the first half of a block's encode (the reference's write_block
    up to its correlation): the false-stereo, wasted-bits and joint
    stereo decisions and the sub-blocks before the entropy coder's;
    returns them as a dict"""
    if (len(channels) == 1) or bool(np.array_equal(channels[0],
                                                   channels[1])):
        false_stereo = 0 if len(channels) == 1 else 1
        arrays = [np.asarray(channels[0], dtype=np.int64)]
    else:
        false_stereo = 0
        arrays = [np.asarray(ch, dtype=np.int64) for ch in channels]
    magnitude = max(int(np.abs(a).max()).bit_length() if a.size else 0
                    for a in arrays)
    nonzero = np.concatenate([a[a != 0] for a in arrays])
    if len(nonzero):
        low = np.bitwise_or.reduce(nonzero)
        wasted = int(low & -low).bit_length() - 1
    else:
        wasted = 0
    shifted = [a >> wasted for a in arrays] if wasted > 0 else arrays
    crc = calculate_crc(shifted)
    if len(shifted) == 2:
        # joint stereo: mid = l - r, side = floor((l + r) / 2)
        uncorrelated = [shifted[0] - shifted[1],
                        (shifted[0] + shifted[1]) >> 1]
    else:
        uncorrelated = shifted

    sub_blocks = BitstreamRecorder(little_endian=True)
    sub_block = BitstreamRecorder(little_endian=True)

    # the first block of the file carries the RIFF header
    if not context.first_block_written:
        if context.wave_header is None:
            write_wave_header(sub_block, context.pcmreader, 0,
                              _footer_size(context.wave_footer))
        else:
            sub_block.write_bytes(context.wave_header)
        write_sub_block(sub_blocks, WV_WAVE_HEADER, 1, sub_block)
        context.first_block_written = True

    channel_count = len(uncorrelated)
    params = None
    if parameters.correlation_passes > 0:
        params = parameters.correlation_parameters(false_stereo)
        sub_block.reset()
        for p in params:
            sub_block.write(5, p.term + 5)
            sub_block.write(3, p.delta)
        write_sub_block(sub_blocks, WV_TERMS, 0, sub_block)

        sub_block.reset()
        for p in params:
            for weight in p.weights:
                sub_block.write(8, store_weight(weight) & 0xFF)
        write_sub_block(sub_blocks, WV_WEIGHTS, 0, sub_block)

        sub_block.reset()
        for p in params:
            write_correlation_samples(sub_block, p.term, p.samples,
                                      channel_count)
        write_sub_block(sub_blocks, WV_SAMPLES, 0, sub_block)

    if wasted > 0:
        sub_block.reset()
        sub_block.build("8u 8u 8u 8u", (0, wasted, 0, 0))
        write_sub_block(sub_blocks, WV_INT32_INFO, 0, sub_block)

    if context.pcmreader.channels > 2:
        sub_block.reset()
        sub_block.write(8, context.pcmreader.channels)
        sub_block.write(32, int(context.pcmreader.channel_mask))
        write_sub_block(sub_blocks, WV_CHANNEL_INFO, 0, sub_block)

    if context.pcmreader.sample_rate not in SAMPLE_RATES:
        sub_block.reset()
        sub_block.write(32, context.pcmreader.sample_rate)
        write_sub_block(sub_blocks, WV_SAMPLE_RATE, 1, sub_block)

    return {"sub_blocks": sub_blocks, "uncorrelated": uncorrelated,
            "params": params, "channel_count": channel_count,
            "channels": len(channels), "n": len(channels[0]),
            "false_stereo": false_stereo, "wasted": wasted,
            "magnitude": magnitude, "crc": crc}


def end_block(writer, context, block, correlated, total_pcm_frames,
              block_index, first_block, last_block, parameters):
    """the second half of a block's encode: the entropy variables, the
    residual coder's sub-block, the block header; writes the block"""
    sub_blocks = block["sub_blocks"]
    sub_block = BitstreamRecorder(little_endian=True)
    write_entropy_variables(sub_block, correlated,
                            parameters.entropy_variables)
    write_sub_block(sub_blocks, WV_ENTROPY, 0, sub_block)

    sub_block.reset()
    write_bitstream(sub_block, correlated, parameters.entropy_variables)
    write_sub_block(sub_blocks, WV_BITSTREAM, 0, sub_block)

    cross_decorrelation = bool(block["params"]) and any(
        p.term < 0 for p in block["params"])
    write_block_header(
        writer, sub_blocks.bytes(), total_pcm_frames, block_index,
        block["n"], context.pcmreader.bits_per_sample, block["channels"],
        1 if block["channel_count"] == 2 else 0,
        1 if cross_decorrelation else 0,
        block["wasted"], 1 if first_block else 0, 1 if last_block else 0,
        block["magnitude"], context.pcmreader.sample_rate,
        block["false_stereo"], block["crc"])
    sub_blocks.copy(writer)

    # the entropy variables round-trip through their stored form
    parameters.entropy_variables = [
        [wv_exp2(wv_log2(e)) for e in parameters.entropy_variables[0]],
        [wv_exp2(wv_log2(e)) for e in parameters.entropy_variables[1]]]


def write_block_header(writer, sub_blocks_size, total_pcm_frames,
                       block_index, block_samples, bits_per_sample,
                       channel_count, joint_stereo,
                       cross_channel_decorrelation, wasted_bps,
                       initial_block, final_block, maximum_magnitude,
                       sample_rate, false_stereo, CRC):
    writer.write_bytes(b"wvpk")
    writer.write(32, sub_blocks_size + 24)
    writer.write(16, 0x0410)
    writer.write(8, 0)
    writer.write(8, 0)
    writer.write(32, total_pcm_frames)
    writer.write(32, block_index)
    writer.write(32, block_samples)
    writer.write(2, (bits_per_sample // 8) - 1)
    writer.write(1, 2 - channel_count)
    writer.write(1, 0)                      # hybrid mode
    writer.write(1, joint_stereo)
    writer.write(1, cross_channel_decorrelation)
    writer.write(1, 0)                      # hybrid noise shaping
    writer.write(1, 0)                      # floating point data
    writer.write(1, 1 if wasted_bps else 0)
    writer.write(1, 0)                      # hybrid controls bitrate
    writer.write(1, 0)                      # hybrid noise balanced
    writer.write(1, initial_block)
    writer.write(1, final_block)
    writer.write(5, 0)                      # left shift data
    writer.write(5, maximum_magnitude)
    writer.write(4, SAMPLE_RATES.index(sample_rate)
                 if sample_rate in SAMPLE_RATES else 15)
    writer.write(2, 0)
    writer.write(1, 0)                      # use IIR
    writer.write(1, false_stereo)
    writer.write(1, 0)
    writer.write(32, CRC)


def write_sub_block(writer, function, nondecoder_data, recorder):
    recorder.byte_align()
    actual_size_1_less = recorder.bytes() % 2
    writer.build("5u 1u 1u", (function, nondecoder_data,
                              actual_size_1_less))
    if recorder.bytes() > (255 * 2):
        writer.write(1, 1)
        writer.write(24, (recorder.bytes() // 2) + actual_size_1_less)
    else:
        writer.write(1, 0)
        writer.write(8, (recorder.bytes() // 2) + actual_size_1_less)
    recorder.copy(writer)
    if actual_size_1_less:
        writer.write(8, 0)


def write_correlation_samples(writer, term, samples, channel_count):
    if 17 <= term <= 18:
        values = [samples[c][s] for c in range(channel_count)
                  for s in range(2)]
    elif 1 <= term <= 8:
        values = [samples[c][s] for s in range(term)
                  for c in range(channel_count)]
    elif -3 <= term <= -1 and channel_count == 2:
        values = [samples[0][0], samples[1][0]]
    else:
        raise ValueError("invalid correlation term")
    for v in values:
        writer.write_signed(16, wv_log2(v))


def write_entropy_variables(writer, channels, entropies):
    for e in entropies[0]:
        writer.write(16, wv_log2(e) & 0xFFFF)
    if len(channels) == 2:
        for e in entropies[1]:
            writer.write(16, wv_log2(e) & 0xFFFF)


def _write_egc(writer, value):
    """an Elias gamma code; value as a Python integer (the reference's
    raised AttributeError on a numpy one)"""
    value = int(value)
    if value > 1:
        t = value.bit_length()
        writer.unary(0, t)
        writer.write(t - 1, value % (1 << (t - 1)))
    else:
        writer.unary(0, value)


class _Residual:
    __slots__ = ("zeroes", "m", "offset", "add", "sign")

    def __init__(self, zeroes, m, offset, add, sign):
        self.zeroes = zeroes
        self.m = m
        self.offset = offset
        self.add = add
        self.sign = sign

    @classmethod
    def encode(cls, residual, entropy):
        if residual >= 0:
            unsigned = residual
            sign = 0
        else:
            unsigned = -residual - 1
            sign = 1

        medians = [(e >> 4) + 1 for e in entropy]

        if unsigned < medians[0]:
            m = 0
            offset = unsigned
            add = medians[0] - 1
            entropy[0] -= ((entropy[0] + 126) >> 7) * 2
        elif (unsigned - medians[0]) < medians[1]:
            m = 1
            offset = unsigned - medians[0]
            add = medians[1] - 1
            entropy[0] += ((entropy[0] + 128) >> 7) * 5
            entropy[1] -= ((entropy[1] + 62) >> 6) * 2
        elif (unsigned - (medians[0] + medians[1])) < medians[2]:
            m = 2
            offset = unsigned - (medians[0] + medians[1])
            add = medians[2] - 1
            entropy[0] += ((entropy[0] + 128) >> 7) * 5
            entropy[1] += ((entropy[1] + 64) >> 6) * 5
            entropy[2] -= ((entropy[2] + 30) >> 5) * 2
        else:
            m = (((unsigned - (medians[0] + medians[1])) //
                  medians[2]) + 2)
            offset = (unsigned -
                      (medians[0] + medians[1] +
                       ((m - 2) * medians[2])))
            add = medians[2] - 1
            entropy[0] += ((entropy[0] + 128) >> 7) * 5
            entropy[1] += ((entropy[1] + 64) >> 6) * 5
            entropy[2] += ((entropy[2] + 32) >> 5) * 5

        return cls(zeroes=None, m=m, offset=offset, add=add, sign=sign)

    def flush(self, writer, u_i_2, m_i):
        """encodes residual_{i-1} given u_{i-2} and m_{i}"""
        if self.zeroes is not None:
            _write_egc(writer, self.zeroes)

        if self.m is not None:
            if (self.m > 0) and (m_i > 0):
                if (u_i_2 is None) or (u_i_2 % 2 == 0):
                    u_i_1 = (self.m * 2) + 1
                else:
                    u_i_1 = (self.m * 2) - 1
            elif (self.m == 0) and (m_i > 0):
                if (u_i_2 is None) or (u_i_2 % 2 == 1):
                    u_i_1 = 1
                else:
                    u_i_1 = None
            elif (self.m > 0) and (m_i == 0):
                if (u_i_2 is None) or (u_i_2 % 2 == 0):
                    u_i_1 = self.m * 2
                else:
                    u_i_1 = (self.m - 1) * 2
            elif (self.m == 0) and (m_i == 0):
                if (u_i_2 is None) or (u_i_2 % 2 == 1):
                    u_i_1 = 0
                else:
                    u_i_1 = None
            else:
                raise ValueError("invalid m")

            if u_i_1 is not None:
                if u_i_1 < 16:
                    writer.unary(0, u_i_1)
                else:
                    writer.unary(0, 16)
                    _write_egc(writer, u_i_1 - 16)

            if self.add > 0:
                p = self.add.bit_length() - 1
                e = (1 << (p + 1)) - self.add - 1
                if self.offset < e:
                    writer.write(p, self.offset)
                else:
                    writer.write(p, (self.offset + e) // 2)
                    writer.write(1, (self.offset + e) % 2)

            writer.write(1, self.sign)
        else:
            u_i_1 = None

        return u_i_1


def _unary_undefined(prev_u, m):
    if m is None:
        return True
    if (m == 0) and (prev_u is not None) and (prev_u % 2 == 0):
        return True
    return False


def write_bitstream(writer, channels, entropies):
    """writes the residual coder's bits of 1-2 channels: the host C++,
    or the scalar oracle under ATPU_WV_ORACLE=1; entropies, [[3], [3]],
    are updated in place"""
    if _use_native():
        writer.write_bytes(_native.wv_write_bitstream(channels, entropies))
        return
    channels = [np.asarray(c, dtype=np.int64).tolist() for c in channels]
    r_i_1 = _Residual(zeroes=None, m=None, offset=None, add=None,
                      sign=None)
    u_i_2 = None
    i = 0
    channel_count = len(channels)
    total = channel_count * len(channels[0])

    while i < total:
        r = channels[i % channel_count][i // channel_count]

        if ((entropies[0][0] < 2) and (entropies[1][0] < 2) and
                _unary_undefined(u_i_2, r_i_1.m)):
            if (r_i_1.zeroes is not None) and (r_i_1.m is None):
                # in a block of zeroes
                if r == 0:
                    r_i_1.zeroes += 1
                else:
                    r_i = _Residual.encode(r,
                                           entropies[i % channel_count])
                    r_i.zeroes = r_i_1.zeroes
                    r_i_1 = r_i
            else:
                if r == 0:
                    r_i = _Residual(zeroes=1, m=None, offset=None,
                                    add=None, sign=None)
                    u_i_2 = r_i_1.flush(writer, u_i_2, 0)
                    entropies[0][0:3] = [0, 0, 0]
                    entropies[1][0:3] = [0, 0, 0]
                    r_i_1 = r_i
                else:
                    r_i = _Residual.encode(r,
                                           entropies[i % channel_count])
                    r_i.zeroes = 0
                    u_i_2 = r_i_1.flush(writer, u_i_2, r_i.m)
                    r_i_1 = r_i
        else:
            r_i = _Residual.encode(r, entropies[i % channel_count])
            r_i.zeroes = None
            u_i_2 = r_i_1.flush(writer, u_i_2, r_i.m)
            r_i_1 = r_i

        i += 1

    r_i_1.flush(writer, u_i_2, 0)
