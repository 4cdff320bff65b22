"""Shorten (SHN v2): the scalar encoder and decoder behind
ATPU_SHN_ORACLE.

Copy of the reference package's ``ref/shn.py``, after the Shorten
format and its pure-Python specification: diff0-3 predictors, QLPC,
unary/Rice "energy" coding, embedded WAV/AIFF headers as VERBATIM
chunks, ZERO blocks, BITSHIFT (wasted bits) commands and the 4-byte
stream padding.

The encoder emits DIFF1/2/3 chosen by absolute-delta sums; the decoder
also handles DIFF0 and QLPC.  One difference from the reference: a
block of 1 or 2 samples predicts from the samples kept from earlier
blocks, as the port's C++ decoder does, where the reference's scalar
decoder raises IndexError (``SHNDecoder._history``).
"""

from __future__ import annotations

import io

import numpy as np

from .. import pcm
from ..bitstream import BitstreamReader
from .flac_enc import TokenStream

COMMAND_SIZE = 2
VERBATIM_SIZE = 5
VERBATIM_BYTE_SIZE = 8
ENERGY_SIZE = 3
BITSHIFT_SIZE = 2

(FN_DIFF0, FN_DIFF1, FN_DIFF2, FN_DIFF3, FN_QUIT, FN_BLOCKSIZE,
 FN_BITSHIFT, FN_QLPC, FN_ZERO, FN_VERBATIM) = range(10)


def shnmean(values):
    """the Shorten rounding mean (floor division semantics)"""
    return ((len(values) // 2) + sum(values)) // len(values)


# ---------------------------------------------------------------------------
# encoder
# ---------------------------------------------------------------------------

def write_unsigned(t, size, value):
    """MSB zeros + stop bit + size LSBs, as a single token"""
    msb = value >> size
    lsb = value - (msb << size)
    t.values.append((1 << size) | lsb)
    t.nbits.append(msb + 1 + size)
    t._bits += msb + 1 + size


def write_signed(t, size, value):
    if value >= 0:
        write_unsigned(t, size + 1, value * 2)
    else:
        write_unsigned(t, size + 1, ((-value - 1) * 2) + 1)


def write_long(t, value):
    if value == 0:
        write_unsigned(t, 2, 0)
        write_unsigned(t, 0, 0)
    else:
        lsb_size = int(value).bit_length()
        write_unsigned(t, 2, lsb_size)
        write_unsigned(t, lsb_size, value)


def best_diff(previous_samples, samples):
    """returns (diff_order, residuals) for a channel block

    reference py_encoders/shn.py:215-252: three delta levels compared
    by absolute sums over the block-sized suffix"""
    prev = np.asarray(previous_samples[-3:], dtype=np.int64)
    if len(prev) < 3:
        prev = np.concatenate([np.zeros(3 - len(prev), dtype=np.int64),
                               prev])
    full = np.concatenate([prev, np.asarray(samples, dtype=np.int64)])

    delta1 = np.diff(full)
    abs_sum1 = int(np.abs(delta1[2:]).sum())
    delta2 = np.diff(delta1)
    abs_sum2 = int(np.abs(delta2[1:]).sum())
    delta3 = np.diff(delta2)
    abs_sum3 = int(np.abs(delta3).sum())

    if abs_sum1 < min(abs_sum2, abs_sum3):
        return (1, delta1[2:])
    elif abs_sum2 < abs_sum3:
        return (2, delta2[1:])
    else:
        return (3, delta3)


def best_energy(residuals):
    """smallest energy e with count * 2^e >= sum(|residuals|)"""
    partition_sum = int(np.abs(residuals).sum())
    e = 0
    while (len(residuals) << e) < partition_sum:
        e += 1
    return e


def wasted_bps(samples):
    nonzero = samples[samples != 0]
    if len(nonzero) == 0:
        return 0
    low = np.bitwise_or.reduce(nonzero)
    low = int(low & -low)
    return low.bit_length() - 1


def encode_shn(file_or_path,
               pcmreader,
               is_big_endian,
               signed_samples,
               header_data,
               footer_data=b"",
               block_size=256):
    """encodes a Shorten file from a PCMReader

    header_data / footer_data are the original container's bytes,
    stored as VERBATIM chunks"""
    from ..pcmstream import BufferedPCMReader

    if isinstance(file_or_path, str):
        output_file = open(file_or_path, "wb")
        close_file = True
    else:
        output_file = file_or_path
        close_file = False

    pcmreader = BufferedPCMReader(pcmreader)
    t = TokenStream()

    left_shift = 0
    wrapped = [np.zeros(0, dtype=np.int64)
               for _ in range(pcmreader.channels)]

    t.write(32, int.from_bytes(b"ajkg", "big"))
    t.write(8, 2)
    magic_bits = t.bits()

    if pcmreader.bits_per_sample == 8:
        if signed_samples:
            write_long(t, 1)
            sign_adjustment = 0
        else:
            write_long(t, 2)
            sign_adjustment = 1 << 7
    elif pcmreader.bits_per_sample == 16:
        if signed_samples:
            write_long(t, 3 if is_big_endian else 5)
            sign_adjustment = 0
        else:
            write_long(t, 4 if is_big_endian else 6)
            sign_adjustment = 1 << 15
    else:
        raise ValueError("unsupported bits_per_sample")

    write_long(t, pcmreader.channels)
    write_long(t, block_size)
    write_long(t, 0)    # max LPC
    write_long(t, 0)    # mean count
    write_long(t, 0)    # bytes to skip

    # header as a VERBATIM block
    write_unsigned(t, COMMAND_SIZE, FN_VERBATIM)
    write_unsigned(t, VERBATIM_SIZE, len(header_data))
    for b in header_data:
        write_unsigned(t, VERBATIM_BYTE_SIZE, b)

    frame = pcmreader.read(block_size)
    while len(frame) > 0:
        if frame.frames != block_size:
            block_size = frame.frames
            write_unsigned(t, COMMAND_SIZE, FN_BLOCKSIZE)
            write_long(t, block_size)

        for c in range(pcmreader.channels):
            channel = frame.samples[:, c].astype(np.int64)
            if not signed_samples:
                channel = channel + sign_adjustment

            if np.all(channel == 0):
                write_unsigned(t, COMMAND_SIZE, FN_ZERO)
                wrapped[c] = channel
            else:
                wasted = wasted_bps(channel)
                if wasted != left_shift:
                    write_unsigned(t, COMMAND_SIZE, FN_BITSHIFT)
                    write_unsigned(t, BITSHIFT_SIZE, wasted)
                    left_shift = wasted
                shifted = (channel >> left_shift) if left_shift \
                    else channel

                (diff, residuals) = best_diff(wrapped[c], shifted)
                energy = best_energy(residuals)

                write_unsigned(t, COMMAND_SIZE,
                               {1: FN_DIFF1, 2: FN_DIFF2,
                                3: FN_DIFF3}[diff])
                write_unsigned(t, ENERGY_SIZE, energy)
                for residual in residuals.tolist():
                    write_signed(t, energy, residual)
                wrapped[c] = shifted

        frame = pcmreader.read(block_size)

    if len(footer_data) > 0:
        write_unsigned(t, COMMAND_SIZE, FN_VERBATIM)
        write_unsigned(t, VERBATIM_SIZE, len(footer_data))
        for b in footer_data:
            write_unsigned(t, VERBATIM_BYTE_SIZE, b)

    write_unsigned(t, COMMAND_SIZE, FN_QUIT)

    # byte-align and pad the post-magic section to a 4-byte multiple
    data = t.to_bytes()
    payload = len(data) - magic_bits // 8
    data += b"\x00" * ((-payload) % 4)

    output_file.write(data)
    if close_file:
        output_file.close()


# ---------------------------------------------------------------------------
# decoder
# ---------------------------------------------------------------------------

class SHNDecoder:
    """a PCMReader-compatible Shorten stream decoder"""

    def __init__(self, file_or_path):
        if isinstance(file_or_path, str):
            f = open(file_or_path, "rb")
        else:
            f = file_or_path
        self.reader = BitstreamReader(f, False)

        (self.file_type,
         self.channels,
         self.block_length,
         self.max_LPC,
         self.number_of_means) = self.read_header()

        if 1 <= self.file_type <= 2:
            self.bits_per_sample = 8
            self.signed_samples = (self.file_type == 1)
        elif 3 <= self.file_type <= 6:
            self.bits_per_sample = 16
            self.signed_samples = (self.file_type in (3, 5))
        else:
            raise ValueError("unsupported Shorten file type")

        self.wrapped_samples = [[0] * 3 for _ in range(self.channels)]
        self.means = [[0] * self.number_of_means
                      for _ in range(self.channels)]
        self.left_shift = 0
        self.stream_finished = False

        # read the first command for an embedded wave/aiff header
        self.reader.mark()
        self.read_metadata()
        self.reader.rewind()
        self.reader.unmark()

    def read_metadata(self):
        command = self.unsigned(2)
        if command == FN_VERBATIM:
            verbatim = bytes(self.unsigned(8) & 0xFF
                             for _ in range(self.unsigned(5)))
            if self._parse_wave_header(verbatim):
                return
            if self._parse_aiff_header(verbatim):
                return
        # otherwise invent PCM parameters
        self.sample_rate = 44100
        self.channel_mask = {1: 0x4, 2: 0x3}.get(self.channels, 0)

    def _parse_wave_header(self, verbatim):
        from ..formats.wav import parse_fmt
        import struct
        if not (verbatim[0:4] == b"RIFF" and verbatim[8:12] == b"WAVE"):
            return False
        pos = 12
        while pos + 8 <= len(verbatim):
            (chunk_id, chunk_size) = struct.unpack(
                "<4sI", verbatim[pos:pos + 8])
            pos += 8
            if chunk_id == b"fmt ":
                try:
                    (_channels, self.sample_rate, _bps, mask) = \
                        parse_fmt(verbatim[pos:pos + chunk_size])
                    self.channel_mask = int(mask)
                    return True
                except ValueError:
                    return False
            pos += chunk_size + (chunk_size % 2)
        return False

    def _parse_aiff_header(self, verbatim):
        from ..formats.aiff import parse_comm
        import struct
        if not (verbatim[0:4] == b"FORM" and verbatim[8:12] == b"AIFF"):
            return False
        pos = 12
        while pos + 8 <= len(verbatim):
            (chunk_id, chunk_size) = struct.unpack(
                ">4sI", verbatim[pos:pos + 8])
            pos += 8
            if chunk_id == b"COMM":
                (_ch, _frames, _bps, self.sample_rate, mask) = \
                    parse_comm(verbatim[pos:pos + chunk_size])
                self.channel_mask = int(mask)
                return True
            pos += chunk_size + (chunk_size % 2)
        return False

    def unsigned(self, c):
        msb = self.reader.unary(1)
        lsb = self.reader.read(c)
        return (msb << c) | lsb

    def signed(self, c):
        u = self.unsigned(c + 1)
        if (u % 2) == 0:
            return u // 2
        else:
            return -(u // 2) - 1

    def long(self):
        return self.unsigned(self.unsigned(2))

    def read_header(self):
        if self.reader.read_bytes(4) != b"ajkg":
            raise ValueError("invalid magic number")
        if self.reader.read(8) != 2:
            raise ValueError("unsupported Shorten version")
        file_type = self.long()
        channels = self.long()
        block_length = self.long()
        max_LPC = self.long()
        number_of_means = self.long()
        bytes_to_skip = self.long()
        self.reader.read_bytes(bytes_to_skip)
        return (file_type, channels, block_length, max_LPC,
                number_of_means)

    def read(self, pcm_frames):
        """returns a FrameList of one block per channel"""
        if self.stream_finished:
            return pcm.empty_framelist(self.channels,
                                       self.bits_per_sample)

        c = 0
        samples = []
        unshifted = []
        while True:
            command = self.unsigned(2)
            if (0 <= command <= 3) or (7 <= command <= 8):
                if command == FN_DIFF0:
                    samples.append(self.read_diff0(self.block_length,
                                                   self.means[c]))
                elif command == FN_DIFF1:
                    samples.append(self.read_diff1(
                        self.block_length, self.wrapped_samples[c]))
                elif command == FN_DIFF2:
                    samples.append(self.read_diff2(
                        self.block_length, self.wrapped_samples[c]))
                elif command == FN_DIFF3:
                    samples.append(self.read_diff3(
                        self.block_length, self.wrapped_samples[c]))
                elif command == FN_QLPC:
                    samples.append(self.read_qlpc(
                        self.block_length, self.means[c],
                        self.wrapped_samples[c]))
                elif command == FN_ZERO:
                    samples.append([0] * self.block_length)

                if self.number_of_means:
                    self.means[c].append(shnmean(samples[c]))
                    self.means[c] = self.means[c][1:]
                # the history keeps older samples when a block is
                # shorter than it (the C++ decoder's ring); the
                # reference kept the block alone, and a DIFF block
                # after a 1- or 2-sample one raised IndexError
                self.wrapped_samples[c] = (self.wrapped_samples[c] +
                                           list(samples[c]))[
                    -(max(3, self.max_LPC)):]

                if self.left_shift > 0:
                    unshifted.append([s << self.left_shift
                                      for s in samples[c]])
                else:
                    unshifted.append(samples[c])

                c += 1
                if c == self.channels:
                    out = np.stack(
                        [np.asarray(ch, dtype=np.int64)
                         for ch in unshifted], axis=1)
                    if not self.signed_samples:
                        out = out - (1 << (self.bits_per_sample - 1))
                    return pcm.FrameList._wrap(out.astype(np.int32),
                                               self.bits_per_sample)
            else:
                if command == FN_QUIT:
                    self.stream_finished = True
                    return pcm.empty_framelist(self.channels,
                                               self.bits_per_sample)
                elif command == FN_BLOCKSIZE:
                    self.block_length = self.long()
                elif command == FN_BITSHIFT:
                    self.left_shift = self.unsigned(2)
                elif command == FN_VERBATIM:
                    for _ in range(self.unsigned(5)):
                        self.unsigned(8)
                else:
                    raise ValueError("unsupported Shorten command")

    def read_diff0(self, block_length, means):
        offset = shnmean(means)
        energy = self.unsigned(3)
        return [self.signed(energy) + offset
                for _ in range(block_length)]

    def read_diff1(self, block_length, previous_samples):
        samples = list(previous_samples[-1:])
        energy = self.unsigned(3)
        for i in range(1, block_length + 1):
            samples.append(samples[i - 1] + self.signed(energy))
        return samples[1:]

    def read_diff2(self, block_length, previous_samples):
        samples = list(previous_samples[-2:])
        energy = self.unsigned(3)
        for i in range(2, block_length + 2):
            samples.append((2 * samples[i - 1]) - samples[i - 2] +
                           self.signed(energy))
        return samples[2:]

    def read_diff3(self, block_length, previous_samples):
        samples = list(previous_samples[-3:])
        energy = self.unsigned(3)
        for i in range(3, block_length + 3):
            samples.append((3 * (samples[i - 1] - samples[i - 2])) +
                           samples[i - 3] + self.signed(energy))
        return samples[3:]

    def read_qlpc(self, block_length, means, previous_samples):
        offset = shnmean(means)
        energy = self.unsigned(3)
        lpc_count = self.unsigned(2)
        lpc_coeff = [self.signed(5) for _ in range(lpc_count)]
        unoffset = []
        samples = previous_samples[-lpc_count:] if lpc_count else []
        for i in range(block_length):
            residual = self.signed(energy)
            lpc_sum = 1 << 5
            for j in range(lpc_count):
                if (i - j - 1) < 0:
                    lpc_sum += (lpc_coeff[j] *
                                (samples[lpc_count + (i - j - 1)] -
                                 offset))
                else:
                    lpc_sum += lpc_coeff[j] * unoffset[i - j - 1]
            unoffset.append((lpc_sum >> 5) + residual)
        return [u + offset for u in unoffset]

    def pcm_split(self):
        """returns a (head, tail) bytes pair of the VERBATIM chunks
        surrounding the PCM data (reference shn.py:287-331 usage)"""
        head = io.BytesIO()
        tail = io.BytesIO()
        current = head

        # scan the whole stream from the start
        self.reader.seek(0)
        decoder = SHNDecoder.__new__(SHNDecoder)
        decoder.reader = self.reader
        (decoder.file_type, decoder.channels, decoder.block_length,
         decoder.max_LPC, decoder.number_of_means) = \
            decoder.read_header()
        if 1 <= decoder.file_type <= 2:
            decoder.bits_per_sample = 8
            decoder.signed_samples = (decoder.file_type == 1)
        else:
            decoder.bits_per_sample = 16
            decoder.signed_samples = (decoder.file_type in (3, 5))

        while True:
            command = decoder.unsigned(2)
            if command == FN_QUIT:
                break
            elif command == FN_VERBATIM:
                data = bytes(decoder.unsigned(8) & 0xFF
                             for _ in range(decoder.unsigned(5)))
                current.write(data)
            elif command == FN_BLOCKSIZE:
                decoder.block_length = decoder.long()
            elif command == FN_BITSHIFT:
                decoder.unsigned(2)
            elif command in (FN_DIFF0, FN_DIFF1, FN_DIFF2, FN_DIFF3):
                current = tail
                energy = decoder.unsigned(3)
                for _ in range(decoder.block_length):
                    decoder.signed(energy)
            elif command == FN_QLPC:
                current = tail
                energy = decoder.unsigned(3)
                lpc_count = decoder.unsigned(2)
                for _ in range(lpc_count):
                    decoder.signed(5)
                for _ in range(decoder.block_length):
                    decoder.signed(energy)
            elif command == FN_ZERO:
                current = tail
            else:
                raise ValueError("unsupported Shorten command")

        return (head.getvalue(), tail.getvalue())

    def pcm_head(self):
        """returns only the VERBATIM bytes BEFORE the PCM data

        stops at the first audio command, so opening a file to read
        its embedded container header doesn't pay for a full scalar
        stream scan (pcm_split does, for the trailing chunks)"""
        head = io.BytesIO()
        self.reader.seek(0)
        decoder = SHNDecoder.__new__(SHNDecoder)
        decoder.reader = self.reader
        (decoder.file_type, decoder.channels, decoder.block_length,
         decoder.max_LPC, decoder.number_of_means) = \
            decoder.read_header()

        while True:
            command = decoder.unsigned(2)
            if command == FN_QUIT:
                break
            elif command == FN_VERBATIM:
                data = bytes(decoder.unsigned(8) & 0xFF
                             for _ in range(decoder.unsigned(5)))
                head.write(data)
            elif command == FN_BLOCKSIZE:
                decoder.long()
            elif command == FN_BITSHIFT:
                decoder.unsigned(2)
            elif command in (FN_DIFF0, FN_DIFF1, FN_DIFF2, FN_DIFF3,
                             FN_QLPC, FN_ZERO):
                break           # PCM data reached
            else:
                raise ValueError("unsupported Shorten command")
        return head.getvalue()

    def close(self):
        self.reader.close()
