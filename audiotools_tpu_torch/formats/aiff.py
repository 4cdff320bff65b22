"""AIFF files: the COMM chunk, ``AIFF_Chunk`` and ``AiffAudio``.

A copy of the reference's ``audiotools_tpu/formats/aiff.py``: the
80-bit IEEE extended sample rate (``parse_ieee_extended``,
``build_ieee_extended``), ``parse_comm``, ``AIFF_Chunk``, and
``AiffAudio`` with ``from_pcm``, ``to_pcm``, ``verify``, ``chunks``,
``aiff_from_chunks`` and the foreign chunks (``has_foreign_aiff_chunks``,
``aiff_header_footer`` and ``from_aiff``) for files of 8, 16 or 24 bits.
AIFF's samples are signed and big-endian, 8-bit ones too (unlike
WAVE's); the SSND chunk's offset and block-size words come before
them.  AIFF is read and written on the host: ``device`` arguments are
taken for the signature the classes share, and ``device`` is None.
"""

from __future__ import annotations

import struct

from ..audiofile import AiffContainer, EncodingError, InvalidFile
from ..pcm import (CHANNEL_MASKS, CounterPCMReader, LimitedFileReader,
                   PCMReader, transfer_framelist_data)
from .wav import _unlink


class InvalidAIFF(InvalidFile, ValueError):
    """a file that is not an AIFF file this module reads"""


def parse_ieee_extended(data):
    """the integer of an 80-bit IEEE extended float's bytes (a sample
    rate); NaN for an infinity or NaN"""
    (sign_exponent, mantissa) = struct.unpack(">HQ", data[:10])
    exponent = sign_exponent & 0x7FFF
    sign = -1 if (sign_exponent & 0x8000) else 1
    if exponent == mantissa == 0:
        return 0
    if exponent == 0x7FFF:
        return float("nan")
    return int(sign * mantissa * (2.0 ** (exponent - 16383 - 63)))


def build_ieee_extended(value):
    """the 80-bit IEEE extended float bytes of an integer"""
    sign = 0
    if value < 0:
        (sign, value) = (0x8000, -value)
    if value == 0:
        return b"\x00" * 10
    exponent = 16383 + 63
    mantissa = value
    while mantissa < (1 << 63):
        mantissa <<= 1
        exponent -= 1
    while mantissa >= (1 << 64):
        mantissa >>= 1
        exponent += 1
    return struct.pack(">HQ", sign | exponent, mantissa)


def parse_comm(data):
    """(channels, total sample frames, bits per sample, sample rate,
    channel mask) of a COMM chunk's body; the mask is the default of 1
    or 2 channels, else 0"""
    (channels, total_sample_frames, bits_per_sample) = struct.unpack(
        ">HIH", bytes(data[:8]))
    sample_rate = parse_ieee_extended(bytes(data[8:18]))
    channel_mask = CHANNEL_MASKS[channels] if channels in (1, 2) else 0
    return (channels, total_sample_frames, bits_per_sample, sample_rate,
            channel_mask)


class AIFF_Chunk:
    """one AIFF chunk: its ID and body"""

    def __init__(self, chunk_id, chunk_data):
        self.id = chunk_id
        self.__data = chunk_data

    def __repr__(self):
        return "AIFF_Chunk(%r)" % (self.id,)

    def size(self):
        return len(self.__data)

    def total_size(self):
        """the chunk's bytes in a file: its header, body and pad byte"""
        size = len(self.__data)
        return 8 + size + (size % 2)

    def data(self):
        return self.__data

    def verify(self):
        return True

    def write(self, f):
        """writes the chunk to a binary file; returns total_size()"""
        f.write(struct.pack(">4sI", self.id, len(self.__data)))
        f.write(self.__data)
        if len(self.__data) % 2:
            f.write(b"\x00")
        return self.total_size()


def _chunks(aiff_file):
    """yields (chunk_id, chunk_size, chunk_data_offset) of an AIFF
    file's chunks"""
    header = aiff_file.read(12)
    if (len(header) < 12 or header[0:4] != b"FORM" or
            header[8:12] != b"AIFF"):
        raise InvalidAIFF("not an AIFF file")
    total_size = struct.unpack(">I", header[4:8])[0] - 4
    while total_size > 0:
        chunk_header = aiff_file.read(8)
        if len(chunk_header) < 8:
            break
        (chunk_id, chunk_size) = struct.unpack(">4sI", chunk_header)
        total_size -= 8
        offset = aiff_file.tell()
        yield (chunk_id, chunk_size, offset)
        # chunks are padded to even sizes
        padded = chunk_size + (chunk_size % 2)
        aiff_file.seek(offset + padded, 0)
        total_size -= padded


def aiff_chunks(header):
    """(chunk_id, chunk_size) of the AIFF chunks in an AIFF's header
    bytes, up to and including the SSND chunk"""
    pos = 12
    while pos + 8 <= len(header):
        (chunk_id, size) = struct.unpack(">4sI", header[pos:pos + 8])
        yield (chunk_id, size)
        if chunk_id == b"SSND":
            return
        pos += 8 + size + (size % 2)


def _ssnd_span(aiff_file):
    """(offset, size) of the samples of an AIFF file's SSND chunk, past
    its offset and block-size words; None when there is no SSND chunk"""
    for (chunk_id, chunk_size, offset) in _chunks(aiff_file):
        if chunk_id == b"SSND":
            aiff_file.seek(offset, 0)
            (data_offset, _block_size) = struct.unpack(
                ">II", aiff_file.read(8))
            return (offset + 8 + data_offset, chunk_size - 8 - data_offset)
    return None


class AiffAudio(AiffContainer):
    """an Audio Interchange File Format file, read and written on the
    host"""

    SUFFIX = "aiff"
    NAME = SUFFIX
    DESCRIPTION = "Audio Interchange File Format"

    def __init__(self, filename):
        AiffContainer.__init__(self, filename)
        self.__channels = 0
        self.__sample_rate = 0
        self.__bits_per_sample = 0
        self.__total_sample_frames = 0
        self.__channel_mask = 0
        self.__chunk_ids = chunk_ids = []
        try:
            with open(filename, "rb") as f:
                for (chunk_id, chunk_size, offset) in _chunks(f):
                    chunk_ids.append(chunk_id)
                    if chunk_id == b"COMM":
                        f.seek(offset, 0)
                        (self.__channels, self.__total_sample_frames,
                         self.__bits_per_sample, self.__sample_rate,
                         self.__channel_mask) = parse_comm(
                             f.read(chunk_size))
        except (IOError, struct.error) as err:
            raise InvalidAIFF(str(err)) from err
        if b"COMM" not in chunk_ids:
            raise InvalidAIFF("COMM chunk not found")
        if b"SSND" not in chunk_ids:
            raise InvalidAIFF("SSND chunk not found")

    def bits_per_sample(self):
        return self.__bits_per_sample

    def channels(self):
        return self.__channels

    def channel_mask(self):
        return self.__channel_mask

    def sample_rate(self):
        return self.__sample_rate

    def total_frames(self):
        return self.__total_sample_frames

    def to_pcm(self):
        """a PCMReader of the SSND chunk's samples"""
        f = open(self.filename, "rb")
        try:
            span = _ssnd_span(f)
            if span is None:
                raise InvalidAIFF("SSND chunk not found")
            f.seek(span[0], 0)
        except BaseException:
            f.close()
            raise
        return PCMReader(LimitedFileReader(f, span[1]), self.__sample_rate,
                         self.__channels, self.__channel_mask,
                         self.__bits_per_sample, signed=True,
                         big_endian=True)

    @classmethod
    def from_pcm(cls, filename, pcmreader, compression=None,
                 total_pcm_frames=None, device=None):
        """writes a new AIFF file from a PCMReader of 8, 16 or 24 bits
        and returns it: FORM, COMM, then SSND, sizes filled in once the
        samples are written; a written frame count other than
        ``total_pcm_frames`` (when given) raises.  Any failure raises
        EncodingError and leaves no file.  ``compression`` and
        ``device`` are ignored."""
        bps = pcmreader.bits_per_sample
        if bps not in (8, 16, 24):
            pcmreader.close()
            raise EncodingError("unsupported bits per sample: %d" % (bps,))
        try:
            with open(filename, "wb") as f:
                counter = CounterPCMReader(pcmreader)
                # placeholder sizes, rewritten once the samples are known
                f.write(b"FORM" + b"\x00" * 4 + b"AIFF")
                f.write(b"COMM" + struct.pack(">I", 18))
                comm_offset = f.tell()
                f.write(b"\x00" * 18)
                f.write(b"SSND" + b"\x00" * 4)
                ssnd_offset = f.tell()
                f.write(struct.pack(">II", 0, 0))
                transfer_framelist_data(counter, f.write, signed=True,
                                        big_endian=True)
                data_size = f.tell() - ssnd_offset
                if f.tell() % 2:
                    f.write(b"\x00")
                total_size = f.tell() - 8
                f.seek(4, 0)
                f.write(struct.pack(">I", total_size))
                f.seek(comm_offset, 0)
                f.write(struct.pack(">HIH", pcmreader.channels,
                                    counter.frames_written, bps))
                f.write(build_ieee_extended(pcmreader.sample_rate))
                f.seek(ssnd_offset - 4, 0)
                f.write(struct.pack(">I", data_size))
            if (total_pcm_frames is not None and
                    counter.frames_written != total_pcm_frames):
                raise EncodingError("total PCM frames mismatch")
            return cls(filename)
        except (IOError, ValueError) as err:
            _unlink(filename)
            if isinstance(err, EncodingError):
                raise
            raise EncodingError(str(err)) from err
        finally:
            pcmreader.close()

    def chunks(self):
        """yields an AIFF_Chunk of each of the file's chunks"""
        with open(self.filename, "rb") as f:
            for (chunk_id, chunk_size, offset) in _chunks(f):
                f.seek(offset, 0)
                yield AIFF_Chunk(chunk_id, f.read(chunk_size))

    @classmethod
    def aiff_from_chunks(cls, filename, chunk_iter):
        """writes a new AIFF file of AIFF_Chunk-like objects and returns
        it"""
        try:
            f = open(filename, "wb")
        except IOError as err:
            raise EncodingError(str(err)) from err
        with f:
            f.write(struct.pack(">4sI4s", b"FORM", 4, b"AIFF"))
            total = 4
            for chunk in chunk_iter:
                total += chunk.write(f)
            f.seek(4, 0)
            f.write(struct.pack(">I", total))
        return cls(filename)

    def has_foreign_aiff_chunks(self):
        return set(self.__chunk_ids) != {b"COMM", b"SSND"}

    def aiff_header_footer(self):
        """the file's bytes before the SSND chunk's samples (its offset
        and block-size words among them) and after them (its pad byte
        among them)"""
        with open(self.filename, "rb") as f:
            span = _ssnd_span(f)
            if span is None:
                raise ValueError("no SSND chunk found")
            f.seek(0, 0)
            header = f.read(span[0])
            f.seek(span[0] + span[1], 0)
            return (header, f.read())

    @classmethod
    def from_aiff(cls, filename, header, pcmreader, footer, compression=None,
                  device=None):
        """writes a new AIFF file of a header, a PCMReader's samples and
        a footer, as they are, and returns it.  Raises EncodingError
        (and leaves no file) on an I/O or a format error.  ``device`` as
        in ``from_pcm``."""
        try:
            with open(filename, "wb") as f:
                f.write(header)
                transfer_framelist_data(pcmreader, f.write, signed=True,
                                        big_endian=True)
                f.write(footer)
            return cls(filename)
        except (IOError, ValueError) as err:
            _unlink(filename)
            raise EncodingError(str(err)) from err
        finally:
            pcmreader.close()

    def verify(self, progress=None, sink=None):
        """checks that every chunk is whole (the reference's check),
        raising InvalidAIFF if not; then, when ``sink`` is given, reads
        the samples into it"""
        with open(self.filename, "rb") as f:
            for (chunk_id, chunk_size, offset) in _chunks(f):
                f.seek(offset, 0)
                if len(f.read(chunk_size)) != chunk_size:
                    raise InvalidAIFF("truncated %s chunk" % (
                        chunk_id.decode("ascii", "replace"),))
        if sink is not None:
            AiffContainer.verify(self, progress, sink)
        return True
