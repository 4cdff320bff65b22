"""TTA files: the container writer and ``TrueAudio``.

Port of the reference's ``TrueAudio`` (``audiotools_tpu/formats/tta.py``):
the TTA1 header with its CRC, the seektable of frame lengths with its
CRC, then the frames that ``codecs.tta.encode_tta`` writes, with the
filters on a torch device; ``TrueAudio`` reads the header (past any
ID3v2 tags) and decodes with ``codecs.tta.TorchTTADecoder`` on its
device; its tags are the APEv2 tag at the file's end
(``meta.ape.ApeTaggedAudio``).  Like the reference's, it supports
ReplayGain in name but adds none: ``add_replay_gain`` does nothing.
"""

from __future__ import annotations

import contextlib
import io
import os
import struct

from .. import text
from .._device import resolve_device
from ..audiofile import AudioFile, EncodingError, InvalidFile
from ..codecs.tta import encode_tta
from ..meta.ape import ApeTaggedAudio
from ..meta.id3 import skip_id3v2_comment
from ..pcm import CounterPCMReader
from ..ref.tta import crc32, div_ceil, read_tta_header


def build_header(channels, bits_per_sample, sample_rate, total_pcm_frames):
    """the 22-byte TTA1 header including its CRC"""
    data = b"TTA1" + struct.pack("<HHHII", 1, channels, bits_per_sample,
                                 sample_rate, total_pcm_frames)
    return data + crc32(data).to_bytes(4, "little")


def build_seektable(frame_sizes):
    """the seektable bytes (32-bit little-endian lengths and a CRC)"""
    data = b"".join(struct.pack("<I", size) for size in frame_sizes)
    return data + crc32(data).to_bytes(4, "little")


def write_tta(file_or_path, pcmreader, total_pcm_frames=None, device="cuda",
              timings=None):
    """encodes a TTA file from a PCMReader

    file_or_path: a path or a writable, seekable binary file.  With
    total_pcm_frames the header and a zeroed seektable are written
    first and the seektable is filled in at the end, as the reference
    does (ValueError when the reader gives another count); without it
    the frames are encoded first.  device and timings as in
    ``codecs.tta.encode_tta``.  The reader is closed at the end.

    returns the frame lengths in bytes"""
    counter = CounterPCMReader(pcmreader)
    if isinstance(file_or_path, str):
        opened = open(file_or_path, "wb")
    else:
        opened = contextlib.nullcontext(file_or_path)
    try:
        with opened as f:
            if total_pcm_frames is not None:
                total_tta_frames = div_ceil(total_pcm_frames * 245,
                                            pcmreader.sample_rate * 256)
                f.write(build_header(pcmreader.channels,
                                     pcmreader.bits_per_sample,
                                     pcmreader.sample_rate,
                                     total_pcm_frames))
                seektable_offset = f.tell()
                f.write(build_seektable([0] * total_tta_frames))
                frame_sizes = encode_tta(f, counter, device=device,
                                         timings=timings)
                if counter.frames_written != total_pcm_frames:
                    raise ValueError("total PCM frames mismatch")
                end = f.tell()
                f.seek(seektable_offset, 0)
                f.write(build_seektable(frame_sizes))
                f.seek(end, 0)
            else:
                frames = io.BytesIO()
                frame_sizes = encode_tta(frames, counter, device=device,
                                         timings=timings)
                f.write(build_header(pcmreader.channels,
                                     pcmreader.bits_per_sample,
                                     pcmreader.sample_rate,
                                     counter.frames_written))
                f.write(build_seektable(frame_sizes))
                f.write(frames.getbuffer())
        return frame_sizes
    finally:
        pcmreader.close()


class InvalidTTA(InvalidFile, ValueError):
    """a file that is not a TTA file this module reads"""


class TrueAudio(ApeTaggedAudio, AudioFile):
    """a True Audio file, encoded and decoded on a torch device

    device: "cuda" (raises when no card is usable) or "cpu" (the
    kernels' plain versions, for tests); ``to_pcm`` decodes there."""

    SUFFIX = "tta"
    NAME = SUFFIX
    DESCRIPTION = "True Audio"
    COMPRESSION_DESCRIPTIONS = {"": text.COMP_TTA}
    DEFAULT_COMPRESSION = ""
    COMPRESSION_MODES = ("",)

    def __init__(self, filename, device="cuda"):
        AudioFile.__init__(self, filename)
        self.device = resolve_device(device)
        try:
            with open(filename, "rb") as f:
                self.__stream_offset = skip_id3v2_comment(f)
                self.__header = read_tta_header(f)
        except (IOError, ValueError) as err:
            raise InvalidTTA(str(err))

    def bits_per_sample(self):
        return self.__header["bits_per_sample"]

    def channels(self):
        return self.__header["channels"]

    def channel_mask(self):
        return self.__header["channel_mask"]

    def sample_rate(self):
        return self.__header["sample_rate"]

    def total_frames(self):
        return self.__header["total_pcm_frames"]

    @classmethod
    def supports_replay_gain(cls):
        return True

    @classmethod
    def lossless_replay_gain(cls):
        return True

    @classmethod
    def can_add_replay_gain(cls, audiofiles):
        return all(isinstance(f, TrueAudio) for f in audiofiles)

    def to_pcm(self):
        """a TorchTTADecoder of the stream on the file's device"""
        from ..codecs.tta import TorchTTADecoder
        f = open(self.filename, "rb")
        try:
            f.seek(self.__stream_offset, 0)
            return TorchTTADecoder(f, device=self.device)
        except BaseException:
            f.close()
            raise

    @classmethod
    def from_pcm(cls, filename, pcmreader, compression=None,
                 total_pcm_frames=None, device="cuda"):
        """encodes a new file from a PCMReader on ``device`` (through
        ``write_tta``) and returns it; ``compression`` is ignored.  Any
        failure raises EncodingError and leaves no file."""
        device = resolve_device(device)
        try:
            write_tta(filename, pcmreader, total_pcm_frames=total_pcm_frames,
                      device=device)
            return cls(filename, device)
        except (IOError, ValueError) as err:
            try:
                os.unlink(filename)
            except OSError:
                pass
            raise EncodingError(str(err))
