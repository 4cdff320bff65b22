"""RIFF WAVE files: the fmt chunk, a data-chunk reader and ``WaveAudio``.

A copy of the parts of the reference's ``audiotools_tpu/formats/wav.py``
that the farm, the command line and the Shorten writer reach:
``build_fmt`` and ``parse_fmt`` with their constants, ``WaveReader``
and ``WaveAudio`` (``from_pcm``, ``to_pcm``, ``verify``, the stream
accessors, and the foreign chunks: ``has_foreign_wave_chunks``,
``wave_header_footer`` and ``from_wave``) for plain RIFF/WAVE files of
8, 16 or 24 bits and 1-8 channels, WAVE_FORMAT_EXTENSIBLE's channel
mask included.  Channel masks are plain ints here.  AIFF is in
``formats/aiff``.
"""

from __future__ import annotations

import os
import struct

from ..audiofile import EncodingError, InvalidFile, WaveContainer
from ..pcm import (CHANNEL_MASKS, FRAMELIST_SIZE, CounterPCMReader,
                   FrameList, LimitedFileReader, PCMReader, bytes_to_samples)

WAVE_FORMAT_PCM = 0x0001
WAVE_FORMAT_EXTENSIBLE = 0xFFFE
EXTENSIBLE_GUID = (b"\x00\x00\x00\x00\x10\x00\x80\x00"
                   b"\x00\xaa\x00\x38\x9b\x71")


class InvalidWave(InvalidFile, ValueError):
    """a file that is not a RIFF WAVE file this module reads"""


def parse_fmt(chunk_data):
    """parses a fmt chunk body

    returns (channels, sample_rate, bits_per_sample, channel_mask) and
    raises ValueError if the fmt chunk is invalid"""
    if len(chunk_data) < 16:
        raise ValueError("fmt chunk is too short")
    (compression, channels, sample_rate,
     _bytes_per_second, _block_align,
     bits_per_sample) = struct.unpack("<HHIIHH", chunk_data[:16])

    if compression == WAVE_FORMAT_PCM:
        channel_mask = CHANNEL_MASKS[channels] if channels in (1, 2) else 0
        return (channels, sample_rate, bits_per_sample, channel_mask)
    elif compression == WAVE_FORMAT_EXTENSIBLE:
        if len(chunk_data) < 40:
            raise ValueError("fmt chunk is too short for "
                             "WAVEFORMATEXTENSIBLE")
        (_cb_size, _valid_bits, mask) = struct.unpack(
            "<HHI", chunk_data[16:24])
        sub_format = chunk_data[24:40]
        if (sub_format[0:2] != b"\x01\x00" or
                sub_format[2:] != EXTENSIBLE_GUID):
            raise ValueError("unsupported WAVE compression")
        return (channels, sample_rate, bits_per_sample, mask)
    else:
        raise ValueError("unsupported WAVE compression")


def build_fmt(channels, sample_rate, bits_per_sample, channel_mask):
    """returns a fmt chunk body from the given stream attributes

    uses plain PCM for 1-2 channel streams and WAVEFORMATEXTENSIBLE
    for anything else"""
    block_align = channels * (bits_per_sample // 8)
    bytes_per_second = sample_rate * block_align
    if (channels <= 2) and (bits_per_sample <= 16):
        return struct.pack("<HHIIHH",
                           WAVE_FORMAT_PCM, channels, sample_rate,
                           bytes_per_second, block_align, bits_per_sample)
    return (struct.pack("<HHIIHHHHI",
                        WAVE_FORMAT_EXTENSIBLE, channels, sample_rate,
                        bytes_per_second, block_align, bits_per_sample,
                        22, bits_per_sample, int(channel_mask)) +
            b"\x01\x00" + EXTENSIBLE_GUID)


def wave_chunks(header):
    """(chunk_id, chunk_size) of the RIFF chunks in a WAVE's header
    bytes, up to and including the data chunk"""
    pos = 12
    while pos + 8 <= len(header):
        (chunk_id, size) = struct.unpack("<4sI", header[pos:pos + 8])
        pos += 8
        yield (chunk_id, size)
        if chunk_id == b"data":
            return
        pos += size + (size % 2)


def riff_data_size(header):
    """the data chunk's size in a WAVE's header bytes; raises ValueError
    for bytes that are no RIFF WAVE header or hold no data chunk"""
    if len(header) < 12 or header[0:4] != b"RIFF" or header[8:12] != b"WAVE":
        raise ValueError("invalid wave header")
    for (chunk_id, size) in wave_chunks(header):
        if chunk_id == b"data":
            return size
    raise ValueError("no data chunk found in header")


def pcm_to_samples(data, channels, bits_per_sample):
    """little-endian WAVE PCM bytes (8-bit unsigned, else signed) ->
    int32 [frames, channels]"""
    return bytes_to_samples(data, channels, bits_per_sample,
                            bits_per_sample != 8, False)


def samples_to_pcm(samples, bits_per_sample):
    """int32 [frames, channels] -> little-endian WAVE PCM bytes"""
    return FrameList._wrap(samples, bits_per_sample).to_bytes(
        False, bits_per_sample != 8)


class RIFF_Chunk:
    """one RIFF chunk: its ID and its data"""

    def __init__(self, chunk_id, chunk_data):
        self.id = chunk_id
        self.__data = chunk_data

    def __repr__(self):
        return "RIFF_Chunk(%r)" % (self.id,)

    def size(self):
        """the data's size in bytes, the pad byte not counted"""
        return len(self.__data)

    def total_size(self):
        """the chunk's size in bytes, its header and pad byte counted"""
        size = len(self.__data)
        return 8 + size + (size % 2)

    def data(self):
        return self.__data

    def verify(self):
        return True

    def write(self, f):
        """writes the chunk (header, data, pad byte) to a binary file;
        returns the bytes written"""
        f.write(struct.pack("<4sI", self.id, len(self.__data)))
        f.write(self.__data)
        if len(self.__data) % 2:
            f.write(b"\x00")
        return self.total_size()


class WaveReader(PCMReader):
    """a PCMReader over the data chunk of an open WAVE file, positioned
    at the chunk's first byte; reads and seeks within ``data_length``
    bytes"""

    def __init__(self, wave_file, sample_rate, channels, channel_mask,
                 bits_per_sample, data_length):
        PCMReader.__init__(self, LimitedFileReader(wave_file, data_length),
                           sample_rate, channels, channel_mask,
                           bits_per_sample, signed=bits_per_sample != 8,
                           big_endian=False)


class WaveAudio(WaveContainer):
    """a waveform audio file (RIFF WAVE), read and written on the host"""

    SUFFIX = "wav"
    NAME = SUFFIX
    DESCRIPTION = "Waveform Audio File Format"

    def __init__(self, filename):
        WaveContainer.__init__(self, filename)
        self.__channels = 0
        self.__sample_rate = 0
        self.__bits_per_sample = 0
        self.__channel_mask = 0
        self.__data_size = 0
        self.__chunk_ids = chunk_ids = []
        try:
            with open(filename, "rb") as f:
                for (chunk_id, chunk_size, offset) in _chunks(f):
                    chunk_ids.append(chunk_id)
                    if chunk_id == b"fmt ":
                        f.seek(offset, 0)
                        try:
                            (self.__channels, self.__sample_rate,
                             self.__bits_per_sample,
                             self.__channel_mask) = parse_fmt(
                                 f.read(chunk_size))
                        except ValueError as err:
                            raise InvalidWave(str(err)) from err
                    elif chunk_id == b"data":
                        self.__data_size = chunk_size
        except OSError as err:
            raise InvalidWave(str(err)) from err
        if b"fmt " not in chunk_ids:
            raise InvalidWave("fmt chunk not found")
        if b"data" not in chunk_ids:
            raise InvalidWave("data chunk not found")

    def bits_per_sample(self):
        return self.__bits_per_sample

    def channels(self):
        return self.__channels

    def channel_mask(self):
        return self.__channel_mask

    def sample_rate(self):
        return self.__sample_rate

    def total_frames(self):
        bytes_per_frame = self.__channels * (self.__bits_per_sample // 8)
        return self.__data_size // bytes_per_frame if bytes_per_frame else 0

    def seekable(self):
        return True

    def chunks(self):
        """yields a RIFF_Chunk for each chunk of the file"""
        with open(self.filename, "rb") as f:
            for (chunk_id, chunk_size, offset) in _chunks(f):
                f.seek(offset, 0)
                yield RIFF_Chunk(chunk_id, f.read(chunk_size))

    @classmethod
    def wave_from_chunks(cls, filename, chunk_iter):
        """writes a new RIFF WAVE file of RIFF_Chunk-like objects, as
        they are, and returns it"""
        try:
            f = open(filename, "wb")
        except IOError as err:
            raise EncodingError(str(err))
        try:
            f.write(struct.pack("<4sI4s", b"RIFF", 4, b"WAVE"))
            total = 4
            for chunk in chunk_iter:
                total += chunk.write(f)
            f.seek(4, 0)
            f.write(struct.pack("<I", total))
        finally:
            f.close()
        return cls(filename)

    def has_foreign_wave_chunks(self):
        return set(self.__chunk_ids) != {b"fmt ", b"data"}

    def wave_header_footer(self):
        """the file's bytes before the data chunk's PCM and after it (the
        data chunk's pad byte among them)"""
        with open(self.filename, "rb") as f:
            for (chunk_id, chunk_size, offset) in _chunks(f):
                if chunk_id == b"data":
                    f.seek(0, 0)
                    header = f.read(offset)
                    f.seek(offset + chunk_size, 0)
                    return (header, f.read())
        raise ValueError("no data chunk found")

    @classmethod
    def from_wave(cls, filename, header, pcmreader, footer, compression=None,
                  device=None):
        """writes a new WAVE file of a header, a PCMReader's PCM and a
        footer, as they are, and returns it: a PCM shorter or longer than
        the header's data chunk is written as read, as the reference
        writes it.  Raises EncodingError (and leaves no file) on an I/O
        or a format error.  ``device`` as in ``from_pcm``."""
        bps = pcmreader.bits_per_sample
        try:
            with open(filename, "wb") as f:
                f.write(header)
                while True:
                    framelist = pcmreader.read(FRAMELIST_SIZE)
                    if framelist.frames == 0:
                        break
                    f.write(samples_to_pcm(framelist.samples, bps))
                f.write(footer)
            return cls(filename)
        except (IOError, ValueError) as err:
            _unlink(filename)
            raise EncodingError(str(err))
        finally:
            pcmreader.close()

    def verify(self, progress=None, sink=None):
        """checks that every chunk is whole (the reference's check),
        raising InvalidWave if not; then, when ``sink`` is given, reads
        the PCM into it"""
        with open(self.filename, "rb") as f:
            for (chunk_id, chunk_size, offset) in _chunks(f):
                f.seek(offset, 0)
                if len(f.read(chunk_size)) != chunk_size:
                    raise InvalidWave("truncated %s chunk" % (
                        chunk_id.decode("ascii", "replace"),))
        if sink is not None:
            WaveContainer.verify(self, progress, sink)
        return True

    def to_pcm(self):
        """a WaveReader of this file's data chunk"""
        f = open(self.filename, "rb")
        try:
            for (chunk_id, chunk_size, offset) in _chunks(f):
                if chunk_id == b"data":
                    f.seek(offset, 0)
                    return WaveReader(f, self.__sample_rate,
                                      self.__channels, self.__channel_mask,
                                      self.__bits_per_sample, chunk_size)
        except BaseException:
            f.close()
            raise
        f.close()
        raise InvalidWave("data chunk not found")

    @classmethod
    def from_pcm(cls, filename, pcmreader, compression=None,
                 total_pcm_frames=None, device=None):
        """writes a new WAVE file from a PCMReader of 8, 16 or 24 bits
        and returns it; a written frame count other than
        ``total_pcm_frames`` (when given) raises, and no file is left.
        ``device`` is accepted for the signature the other classes
        share: WAVE is written on the host."""
        bps = pcmreader.bits_per_sample
        try:
            if bps not in (8, 16, 24):
                raise ValueError("unsupported bits per sample %d" % (bps,))
            with open(filename, "wb") as f:
                counter = CounterPCMReader(pcmreader)
                fmt = build_fmt(pcmreader.channels, pcmreader.sample_rate,
                                bps, pcmreader.channel_mask)
                # placeholder sizes, rewritten after the data is known
                f.write(b"RIFF" + b"\x00" * 4 + b"WAVE")
                f.write(b"fmt " + struct.pack("<I", len(fmt)) + fmt)
                f.write(b"data" + b"\x00" * 4)
                data_offset = f.tell()
                while True:
                    framelist = counter.read(FRAMELIST_SIZE)
                    if framelist.frames == 0:
                        break
                    f.write(samples_to_pcm(framelist.samples, bps))
                data_size = f.tell() - data_offset
                if data_size % 2:
                    f.write(b"\x00")
                total_size = f.tell() - 8
                f.seek(4, 0)
                f.write(struct.pack("<I", total_size))
                f.seek(data_offset - 4, 0)
                f.write(struct.pack("<I", data_size))
            if (total_pcm_frames is not None and
                    counter.frames_written != total_pcm_frames):
                raise ValueError("total PCM frames mismatch")
            return cls(filename)
        except BaseException:
            _unlink(filename)
            raise
        finally:
            pcmreader.close()


def _chunks(wave_file):
    """yields (chunk_id, chunk_size, chunk_data_offset) of a RIFF WAVE
    file's chunks"""
    header = wave_file.read(12)
    if (len(header) < 12 or header[0:4] != b"RIFF" or
            header[8:12] != b"WAVE"):
        raise InvalidWave("not a RIFF WAVE file")
    total_size = struct.unpack("<I", header[4:8])[0] - 4
    while total_size > 0:
        chunk_header = wave_file.read(8)
        if len(chunk_header) < 8:
            break
        (chunk_id, chunk_size) = struct.unpack("<4sI", chunk_header)
        total_size -= 8
        offset = wave_file.tell()
        yield (chunk_id, chunk_size, offset)
        # chunks are padded to even sizes
        padded = chunk_size + (chunk_size % 2)
        wave_file.seek(offset + padded, 0)
        total_size -= padded


def _unlink(filename):
    try:
        os.unlink(filename)
    except OSError:
        pass
