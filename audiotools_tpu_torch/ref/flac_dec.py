"""Scalar FLAC decoder (NumPy): the oracle behind ATPU_FLAC_ORACLE.

Copy of the reference package's ``ref/flac_dec.py``, derived from the
public FLAC format: the STREAMINFO parse, the frame header with its
CRC-8, the CONSTANT, VERBATIM, FIXED and LPC subframes, Rice residuals
with escape partitions, stereo decorrelation, the frame CRC-16 and the
stream MD5 check.  It favours clarity over speed: the port's decode
path is ``codecs.flac_dec.TorchFlacDecoder``.  Implements the PCMReader
protocol.
"""

from __future__ import annotations

from .. import text

from hashlib import md5

import numpy as np

from .. import pcm
from ..bitstream import BitstreamReader
from .crc import CRC8, CRC16

(BLOCK_STREAMINFO, BLOCK_PADDING, BLOCK_APPLICATION, BLOCK_SEEKTABLE,
 BLOCK_VORBIS_COMMENT, BLOCK_CUESHEET, BLOCK_PICTURE) = range(7)


class FlacDecoder:
    """a PCMReader-compatible FLAC stream decoder"""

    CHANNEL_COUNT_MASKS = {1: 0x0004,   # front center
                           2: 0x0003,   # front left, front right
                           3: 0x0007,
                           4: 0x0033,
                           5: 0x0037,
                           6: 0x003F,
                           7: 0x013F,
                           8: 0x063F}

    def __init__(self, file_or_path, channel_mask=None):
        if isinstance(file_or_path, str):
            self.file = open(file_or_path, "rb")
        else:
            self.file = file_or_path
        self.reader = BitstreamReader(self.file, False)

        if self.reader.read_bytes(4) != b"fLaC":
            raise ValueError("invalid FLAC file (no 'fLaC' marker)")

        self.streaminfo = None
        last = 0
        while last != 1:
            (last, block_type, block_length) = \
                self.reader.parse("1u 7u 24u")
            if block_type == BLOCK_STREAMINFO:
                (self.minimum_block_size,
                 self.maximum_block_size,
                 self.minimum_frame_size,
                 self.maximum_frame_size,
                 self.sample_rate,
                 channels,
                 bps,
                 self.total_frames,
                 self.md5sum) = self.reader.parse(
                     "16u 16u 24u 24u 20u 3u 5u 36U 16b")
                self.channels = channels + 1
                self.bits_per_sample = bps + 1
                self.streaminfo = True
            else:
                self.reader.skip_bytes(block_length)

        if self.streaminfo is None:
            raise ValueError("no STREAMINFO block found")

        if channel_mask is None:
            self.channel_mask = self.CHANNEL_COUNT_MASKS.get(
                self.channels, 0)
        else:
            self.channel_mask = channel_mask

        self.current_md5sum = md5()
        self.remaining_frames = self.total_frames
        self.closed = False

    def read(self, pcm_frames):
        """returns a FrameList of up to one FLAC frame of data"""
        if self.closed:
            raise ValueError("stream is closed")
        if (self.total_frames > 0) and (self.remaining_frames <= 0):
            # verify MD5 at end of stream
            if ((self.md5sum != b"\x00" * 16) and
                    (self.md5sum != self.current_md5sum.digest())):
                raise ValueError(text.ERR_FLAC_MD5_MISMATCH)
            return pcm.empty_framelist(self.channels, self.bits_per_sample)

        if self.total_frames == 0:
            # total stream length unknown; decode until EOF
            try:
                samples = self.decode_frame()
            except IOError:
                return pcm.empty_framelist(self.channels,
                                           self.bits_per_sample)
        else:
            samples = self.decode_frame()
        framelist = pcm.FrameList._wrap(samples, self.bits_per_sample)
        self.remaining_frames -= framelist.frames
        self.current_md5sum.update(framelist.to_bytes(False, True))
        return framelist

    def decode_frame(self):
        """decodes one FLAC frame, returning int32 [frames, channels]"""
        crc8 = CRC8()
        crc16 = CRC16()
        self.reader.add_callback(crc16.update)
        self.reader.add_callback(crc8.update)

        sync = self.reader.read(14)
        if sync != 0x3FFE:
            raise ValueError("invalid sync code in frame header")
        self.reader.skip(1)
        blocking_strategy = self.reader.read(1)
        block_size_code = self.reader.read(4)
        sample_rate_code = self.reader.read(4)
        channel_assignment = self.reader.read(4)
        bps_code = self.reader.read(3)
        self.reader.skip(1)
        self.read_utf8()  # frame number / sample number

        block_size = {0: None,
                      1: 192, 2: 576, 3: 1152, 4: 2304, 5: 4608,
                      8: 256, 9: 512, 10: 1024, 11: 2048,
                      12: 4096, 13: 8192, 14: 16384, 15: 32768}.get(
                          block_size_code)
        if block_size_code == 6:
            block_size = self.reader.read(8) + 1
        elif block_size_code == 7:
            block_size = self.reader.read(16) + 1
        elif block_size is None:
            raise ValueError("invalid block size code")

        if sample_rate_code == 12:
            self.reader.read(8)
        elif sample_rate_code in (13, 14):
            self.reader.read(16)
        elif sample_rate_code == 15:
            raise ValueError("invalid sample rate code")

        bps = {0: self.bits_per_sample,
               1: 8, 2: 12, 4: 16, 5: 20, 6: 24}.get(bps_code)
        if bps is None:
            raise ValueError("invalid bits-per-sample code")

        # CRC-8 covers the entire header up to this point
        self.reader.pop_callback()
        header_crc = self.reader.read(8)
        if header_crc != int(crc8):
            raise ValueError("invalid checksum in frame header")

        if channel_assignment <= 7:
            channel_count = channel_assignment + 1
            subframes = [self.decode_subframe(block_size, bps)
                         for _ in range(channel_count)]
            out = np.stack(subframes, axis=1)
        elif channel_assignment == 8:
            # left-side
            left = self.decode_subframe(block_size, bps)
            side = self.decode_subframe(block_size, bps + 1)
            right = left - side
            out = np.stack([left, right], axis=1)
        elif channel_assignment == 9:
            # side-right
            side = self.decode_subframe(block_size, bps + 1)
            right = self.decode_subframe(block_size, bps)
            left = side + right
            out = np.stack([left, right], axis=1)
        elif channel_assignment == 10:
            # mid-side
            mid = self.decode_subframe(block_size, bps)
            side = self.decode_subframe(block_size, bps + 1)
            # mid is the floor average; reconstruct exactly
            sum_ = (mid << 1) | (side & 1)
            left = (sum_ + side) >> 1
            right = (sum_ - side) >> 1
            out = np.stack([left, right], axis=1)
        else:
            raise ValueError("invalid channel assignment")

        self.reader.byte_align()
        self.reader.pop_callback()
        frame_crc = self.reader.read(16)
        if frame_crc != int(crc16):
            raise ValueError("invalid checksum in frame")

        return out.astype(np.int32)

    def read_utf8(self):
        """reads a UTF-8 encoded frame/sample number"""
        total_bytes = self.reader.unary(0)
        value = self.reader.read(7 - total_bytes)
        while total_bytes > 1:
            value = (value << 6) | self.reader.parse("2p 6u")[0]
            total_bytes -= 1
        return value

    def decode_subframe(self, block_size, bps):
        """returns one subframe's samples as an int64 array"""
        self.reader.skip(1)
        subframe_type = self.reader.read(6)
        if self.reader.read(1):
            wasted_bps = self.reader.unary(1) + 1
        else:
            wasted_bps = 0

        effective_bps = bps - wasted_bps

        if subframe_type == 0:
            # CONSTANT
            value = self.reader.read_signed(effective_bps)
            samples = np.full(block_size, value, dtype=np.int64)
        elif subframe_type == 1:
            # VERBATIM
            samples = np.array(
                [self.reader.read_signed(effective_bps)
                 for _ in range(block_size)], dtype=np.int64)
        elif 8 <= subframe_type <= 12:
            # FIXED, order 0-4
            order = subframe_type - 8
            warmup = [self.reader.read_signed(effective_bps)
                      for _ in range(order)]
            residuals = self.read_residuals(block_size, order)
            samples = self.predict_fixed(order, warmup, residuals)
        elif subframe_type >= 32:
            # LPC
            order = subframe_type - 31
            warmup = [self.reader.read_signed(effective_bps)
                      for _ in range(order)]
            qlp_precision = self.reader.read(4) + 1
            qlp_shift = self.reader.read_signed(5)
            qlp_coeffs = [self.reader.read_signed(qlp_precision)
                          for _ in range(order)]
            residuals = self.read_residuals(block_size, order)
            samples = self.predict_lpc(order, warmup, qlp_coeffs,
                                       max(qlp_shift, 0), residuals)
        else:
            raise ValueError("invalid subframe type")

        if wasted_bps:
            samples = samples << wasted_bps
        return samples

    def read_residuals(self, block_size, order):
        """reads a residual block, returning an int64 array"""
        coding_method = self.reader.read(2)
        if coding_method not in (0, 1):
            raise ValueError("invalid residual coding method")
        partition_order = self.reader.read(4)
        residuals = []
        for p in range(1 << partition_order):
            if p == 0:
                partition_size = (block_size >> partition_order) - order
            else:
                partition_size = block_size >> partition_order
            if coding_method == 0:
                rice = self.reader.read(4)
                escaped = (rice == 15)
            else:
                rice = self.reader.read(5)
                escaped = (rice == 31)
            if escaped:
                raw_bits = self.reader.read(5)
                if raw_bits:
                    part = [self.reader.read_signed(raw_bits)
                            for _ in range(partition_size)]
                else:
                    part = [0] * partition_size
            else:
                part = [self.read_rice(rice)
                        for _ in range(partition_size)]
            residuals.extend(part)
        return np.array(residuals, dtype=np.int64)

    def read_rice(self, rice):
        msb = self.reader.unary(1)
        lsb = self.reader.read(rice)
        unsigned = (msb << rice) | lsb
        if unsigned & 1:
            return -(unsigned >> 1) - 1
        else:
            return unsigned >> 1

    @staticmethod
    def predict_fixed(order, warmup, residuals):
        """inverts the fixed difference predictor of the given order"""
        n = order + len(residuals)
        samples = np.empty(n, dtype=np.int64)
        samples[:order] = warmup
        if order == 0:
            samples[:] = residuals
        elif order == 1:
            samples[1:] = residuals
            samples = np.cumsum(samples)
        elif order == 2:
            out = samples
            out[0:2] = warmup
            for (i, r) in enumerate(residuals):
                out[i + 2] = r + 2 * out[i + 1] - out[i]
        elif order == 3:
            out = samples
            out[0:3] = warmup
            for (i, r) in enumerate(residuals):
                out[i + 3] = r + 3 * out[i + 2] - 3 * out[i + 1] + out[i]
        elif order == 4:
            out = samples
            out[0:4] = warmup
            for (i, r) in enumerate(residuals):
                out[i + 4] = (r + 4 * out[i + 3] - 6 * out[i + 2] +
                              4 * out[i + 1] - out[i])
        else:
            raise ValueError("invalid FIXED subframe order")
        return samples

    @staticmethod
    def predict_lpc(order, warmup, qlp_coeffs, qlp_shift, residuals):
        """inverts the LPC predictor (true recurrence, scalar loop)"""
        n = order + len(residuals)
        samples = np.empty(n, dtype=np.int64)
        samples[:order] = warmup
        coeffs = np.array(list(reversed(qlp_coeffs)), dtype=np.int64)
        s = samples
        for (i, r) in enumerate(residuals):
            s[i + order] = r + (int(np.dot(coeffs, s[i:i + order])) >>
                                qlp_shift)
        return samples

    def close(self):
        self.closed = True
        self.reader.close()
