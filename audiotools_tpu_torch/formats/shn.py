"""Shorten files: the writer and ``ShortenAudio``.

Port of the reference's ``ShortenAudio`` (``audiotools_tpu/formats/shn.py``):
``write_shn`` puts a minimal RIFF/WAVE header in the leading VERBATIM
chunk, then the stream that ``codecs.shn.encode_shn`` writes
(``encode_samples``, its form for samples in hand), 8- and 16-bit PCM
only, 8-bit stored unsigned as WAVE has it.  ``ShortenAudio`` reads a
stream whose VERBATIM head is a WAVE or an AIFF header (its frame count
from the data chunk or COMM; 0 for any other head) and decodes with
``codecs.shn.TorchSHNDecoder`` on its device.  A WAVE's or an AIFF's
foreign chunks travel in the stream's leading and trailing VERBATIM
chunks (``from_wave``, ``wave_header_footer``; ``from_aiff``, which
stores big-endian signed samples as AIFF has them,
``aiff_header_footer``).  Shorten holds no tags: ``get_metadata`` is
None.
"""

from __future__ import annotations

import os
import struct

from .. import _native, text
from .._device import resolve_device
from ..audiofile import (AiffContainer, EncodingError, InvalidFile,
                         WaveContainer)
from ..codecs.shn import encode_samples, encode_shn, stream_params
from ..pcm import read_all, to_pcm_progress
from .aiff import aiff_chunks, parse_comm
from .wav import build_fmt, wave_chunks


def wave_header(channels, sample_rate, bits_per_sample, channel_mask,
                data_size):
    """the RIFF/WAVE header of a PCM stream of data_size bytes: the fmt
    chunk and the data chunk's header"""
    fmt = build_fmt(channels, sample_rate, bits_per_sample, channel_mask)
    return (b"RIFF" + struct.pack("<I", 4 + 8 + len(fmt) + 8 + data_size) +
            b"WAVE" + b"fmt " + struct.pack("<I", len(fmt)) + fmt +
            b"data" + struct.pack("<I", data_size))


def write_shn(file_or_path, pcmreader, total_pcm_frames=None, block_size=256,
              device="cuda", timings=None):
    """encodes a Shorten file from a PCMReader

    file_or_path: a path or a writable binary file.  The PCM is read
    whole first (the WAVE header carries its length); with
    total_pcm_frames, a reader that gives another count raises
    ValueError and nothing is written.  device and timings as in
    ``codecs.shn.encode_shn``.  The reader is closed at the end."""
    try:
        bps = pcmreader.bits_per_sample
        if bps not in (8, 16):
            raise ValueError("Shorten takes 8- or 16-bit PCM, not %r"
                             % (bps,))
        samples = read_all(pcmreader)
        frames = samples.shape[0]
        if total_pcm_frames is not None and frames != total_pcm_frames:
            raise ValueError("total PCM frames mismatch")
        header = wave_header(pcmreader.channels, pcmreader.sample_rate, bps,
                             pcmreader.channel_mask,
                             frames * pcmreader.channels * (bps // 8))
        encode_samples(file_or_path, samples, bps, is_big_endian=False,
                       signed_samples=(bps != 8), header_data=header,
                       block_size=block_size, device=device, timings=timings)
    finally:
        pcmreader.close()


class InvalidShorten(InvalidFile, ValueError):
    """a file that is not a Shorten file this module reads"""


def _is_wave(head):
    return head[0:4] == b"RIFF" and head[8:12] == b"WAVE"


def _is_aiff(head):
    return head[0:4] == b"FORM" and head[8:12] == b"AIFF"


class ShortenAudio(WaveContainer, AiffContainer):
    """a Shorten file, encoded and decoded on a torch device

    device: "cuda" (raises when no card is usable) or "cpu" (the plain
    torch ops, for tests); ``to_pcm`` decodes there."""

    SUFFIX = "shn"
    NAME = SUFFIX
    DESCRIPTION = "Shorten"
    COMPRESSION_DESCRIPTIONS = {"": text.COMP_SHN}
    DEFAULT_COMPRESSION = ""
    COMPRESSION_MODES = ("",)

    def __init__(self, filename, device="cuda"):
        WaveContainer.__init__(self, filename)
        self.device = resolve_device(device)
        try:
            with open(filename, "rb") as f:
                data = f.read()
            header = _native.shn_header(data)
        except (IOError, ValueError) as err:
            raise InvalidShorten(str(err))
        head = header["head"]
        self.__head = head
        self.__tail = None
        self.__channels = header["channels"]
        self.__bits_per_sample = 8 if header["file_type"] in (1, 2) else 16
        try:
            (self.__sample_rate, self.__channel_mask) = stream_params(
                head, self.__channels)
        except struct.error as err:
            raise InvalidShorten(str(err)) from err
        bytes_per_frame = self.__channels * (self.__bits_per_sample // 8)
        self.__total_frames = 0
        if _is_wave(head):
            for (chunk_id, size) in wave_chunks(head):
                if chunk_id == b"data":
                    self.__total_frames = size // bytes_per_frame
        elif _is_aiff(head):
            pos = 12
            for (chunk_id, size) in aiff_chunks(head):
                if chunk_id == b"COMM":
                    self.__total_frames = parse_comm(
                        head[pos + 8:pos + 8 + size])[1]
                    break
                pos += 8 + size + (size % 2)

    def bits_per_sample(self):
        return self.__bits_per_sample

    def channels(self):
        return self.__channels

    def channel_mask(self):
        return self.__channel_mask

    def sample_rate(self):
        return self.__sample_rate

    def total_frames(self):
        return self.__total_frames

    def _tail(self):
        """the trailing VERBATIM bytes (read once: it takes a scan of the
        whole stream)"""
        if self.__tail is None:
            with open(self.filename, "rb") as f:
                (_head, self.__tail) = _native.shn_split(f.read())
        return self.__tail

    def has_foreign_wave_chunks(self):
        """for a WAVE head: chunks besides fmt and data in it, or a tail
        of trailing chunks"""
        return _is_wave(self.__head) and (
            any(chunk_id not in (b"fmt ", b"data")
                for (chunk_id, _size) in wave_chunks(self.__head)) or
            len(self._tail()) >= 8)

    def wave_header_footer(self):
        """the leading and trailing VERBATIM bytes of a WAVE head"""
        if not _is_wave(self.__head):
            raise ValueError("no wave header stored")
        return (self.__head, self._tail())

    def has_foreign_aiff_chunks(self):
        """for an AIFF head: chunks besides COMM and SSND in it, or a
        tail of trailing chunks"""
        return _is_aiff(self.__head) and (
            any(chunk_id not in (b"COMM", b"SSND")
                for (chunk_id, _size) in aiff_chunks(self.__head)) or
            len(self._tail()) >= 8)

    def aiff_header_footer(self):
        """the leading and trailing VERBATIM bytes of an AIFF head"""
        if not _is_aiff(self.__head):
            raise ValueError("no aiff header stored")
        return (self.__head, self._tail())

    def convert(self, target_path, target_class, compression=None,
                progress=None, device=None):
        """as the reference's: a WAVE head's foreign chunks to a target
        that takes a WAVE's, an AIFF head's to one that takes an
        AIFF's; else the PCM alone, with the frame count passed ahead
        None when the header gives none"""
        if (self.has_foreign_wave_chunks() and
                callable(getattr(target_class, "from_wave", None))):
            return WaveContainer.convert(self, target_path, target_class,
                                         compression, progress, device)
        if (self.has_foreign_aiff_chunks() and
                callable(getattr(target_class, "from_aiff", None))):
            return AiffContainer.convert(self, target_path, target_class,
                                         compression, progress, device)
        return target_class.from_pcm(
            target_path, to_pcm_progress(self, progress), compression,
            total_pcm_frames=self.total_frames() or None,
            device=self.device if device is None else device)

    def to_pcm(self):
        """a TorchSHNDecoder of the file on the file's device"""
        from ..codecs.shn import TorchSHNDecoder
        return TorchSHNDecoder(self.filename, device=self.device)

    @classmethod
    def from_pcm(cls, filename, pcmreader, compression=None,
                 total_pcm_frames=None, device="cuda", block_size=256):
        """encodes a new file from a PCMReader on ``device`` (through
        ``write_shn``) and returns it; ``compression`` is ignored.  Any
        failure raises EncodingError and leaves no file."""
        device = resolve_device(device)
        if pcmreader.bits_per_sample not in (8, 16):
            pcmreader.close()
            raise EncodingError("unsupported bits per sample: %d"
                                % (pcmreader.bits_per_sample,))
        try:
            write_shn(filename, pcmreader, total_pcm_frames=total_pcm_frames,
                      block_size=block_size, device=device)
            return cls(filename, device)
        except (IOError, ValueError) as err:
            try:
                os.unlink(filename)
            except OSError:
                pass
            raise EncodingError(str(err))

    @classmethod
    def from_wave(cls, filename, header, pcmreader, footer, compression=None,
                  device="cuda", block_size=256):
        """encodes a new file from a WAVE's header, PCM and footer on
        ``device``, the header and footer in the stream's VERBATIM
        chunks; ``compression`` is ignored.  Any failure raises
        EncodingError and leaves no file."""
        return cls._from_container(filename, header, pcmreader, footer,
                                   False, pcmreader.bits_per_sample != 8,
                                   device, block_size)

    @classmethod
    def from_aiff(cls, filename, header, pcmreader, footer, compression=None,
                  device="cuda", block_size=256):
        """encodes a new file from an AIFF's header, PCM and footer on
        ``device``, as ``from_wave`` does, the samples big-endian and
        signed as AIFF stores them"""
        return cls._from_container(filename, header, pcmreader, footer,
                                   True, True, device, block_size)

    @classmethod
    def _from_container(cls, filename, header, pcmreader, footer,
                        is_big_endian, signed_samples, device, block_size):
        device = resolve_device(device)
        try:
            encode_shn(filename, pcmreader, is_big_endian=is_big_endian,
                       signed_samples=signed_samples, header_data=header,
                       footer_data=footer, block_size=block_size,
                       device=device)
            return cls(filename, device)
        except (IOError, ValueError) as err:
            try:
                os.unlink(filename)
            except OSError:
                pass
            raise EncodingError(str(err))
        finally:
            pcmreader.close()
