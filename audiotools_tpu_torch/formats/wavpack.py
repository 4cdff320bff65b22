"""WavPack files: the writer and ``WavPackAudio``.

Port of the reference's ``WavPackAudio``
(``audiotools_tpu/formats/wavpack.py``):
its compression modes, each a block size and a pass count, and the
RIFF header the first block stores; the correlation passes on a torch
device (``codecs.wavpack.encode_wavpack``).  ``WavPackAudio`` reads the
first block's header and decodes with
``codecs.wavpack.TorchWavPackDecoder`` on its device.  APE tags (so
ReplayGain) and ``from_wave``'s foreign RIFF chunks are not ported: a
file holding either is refused by a conversion rather than losing them.
"""

from __future__ import annotations

import os
import struct

from .._device import resolve_device
from ..audiofile import EncodingError, InvalidFile, WaveContainer
from ..codecs.wavpack import encode_wavpack
from ..pcm import CounterPCMReader
from ..ref.wavpack import WV_WAVE_HEADER, WavPackDecoder, walk_sub_blocks
from . import apetag

WV_WAVE_FOOTER = 0x2

DEFAULT_COMPRESSION = "standard"
OPTIONS = {"veryfast": {"block_size": 44100, "correlation_passes": 1},
           "fast": {"block_size": 44100, "correlation_passes": 2},
           "standard": {"block_size": 44100, "correlation_passes": 5},
           "high": {"block_size": 44100, "correlation_passes": 10},
           "veryhigh": {"block_size": 44100, "correlation_passes": 16}}


def write_wavpack(path_or_file, pcmreader, compression=DEFAULT_COMPRESSION,
                  total_pcm_frames=None, device="cuda", timings=None):
    """encodes a WavPack file from a PCMReader

    path_or_file: a path or a writable, seekable binary file.
    compression: a key of OPTIONS.  With total_pcm_frames the block
    headers carry it from the start, as the reference writes them
    (ValueError when the reader gives another count).  device and
    timings as in ``codecs.wavpack.encode_wavpack``.  The reader is
    closed at the end."""
    if compression not in OPTIONS:
        raise ValueError("unknown WavPack compression %r" % (compression,))
    counter = CounterPCMReader(pcmreader)
    try:
        encode_wavpack(
            path_or_file, counter, total_pcm_frames=total_pcm_frames or 0,
            device=device, timings=timings, **OPTIONS[compression])
        if (total_pcm_frames is not None and
                counter.frames_written != total_pcm_frames):
            raise ValueError("total PCM frames mismatch")
    finally:
        pcmreader.close()


class InvalidWavPack(InvalidFile, ValueError):
    """a file that is not a WavPack file this module reads"""


class WavPackAudio(WaveContainer):
    """a WavPack file, encoded and decoded on a torch device

    device: "cuda" (raises when no card is usable) or "cpu" (the
    kernels' plain versions, for tests); ``to_pcm`` decodes there."""

    SUFFIX = "wv"
    NAME = "wavpack"
    DEFAULT_COMPRESSION = DEFAULT_COMPRESSION
    COMPRESSION_MODES = ("veryfast", "fast", "standard", "high",
                         "veryhigh")

    def __init__(self, filename, device="cuda"):
        WaveContainer.__init__(self, filename)
        self.device = resolve_device(device)
        try:
            with open(filename, "rb") as f:
                decoder = WavPackDecoder(f)
        except (IOError, ValueError) as err:
            raise InvalidWavPack(str(err))
        self.__sample_rate = decoder.sample_rate
        self.__bits_per_sample = decoder.bits_per_sample
        self.__channels = decoder.channels
        self.__channel_mask = decoder.channel_mask
        self.__total_frames = decoder.total_frames

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

    def tag_names(self):
        """the APEv2 items' keys, None without a tag"""
        return apetag.item_keys(self.filename)

    def write_blank_tags(self):
        apetag.append_empty_tag(self.filename)

    def wave_header_footer(self):
        """the RIFF bytes the blocks store before and after the PCM"""
        (header, footer) = (b"", b"")
        with open(self.filename, "rb") as f:
            while True:
                block = f.read(32)
                if len(block) < 32 or block[0:4] != b"wvpk":
                    break
                (block_size,) = struct.unpack("<I", block[4:8])
                for (function, nondecoder, data) in walk_sub_blocks(
                        f.read(block_size - 24)):
                    if nondecoder and function == WV_WAVE_HEADER:
                        header += data
                    elif nondecoder and function == WV_WAVE_FOOTER:
                        footer += data
        return (header, footer)

    def has_foreign_wave_chunks(self):
        """a stored footer, or chunks besides fmt and data in the
        stored header"""
        (header, footer) = self.wave_header_footer()
        if len(footer) >= 8:
            return True
        pos = 12
        while pos + 8 <= len(header):
            (chunk_id, size) = struct.unpack("<4sI", header[pos:pos + 8])
            pos += 8
            if chunk_id not in (b"fmt ", b"data"):
                return True
            if chunk_id == b"data":
                continue
            pos += size + (size % 2)
        return False

    def to_pcm(self):
        """a TorchWavPackDecoder of the file on the file's device"""
        from ..codecs.wavpack import TorchWavPackDecoder
        return TorchWavPackDecoder(self.filename, device=self.device)

    @classmethod
    def from_pcm(cls, filename, pcmreader, compression=None,
                 total_pcm_frames=None, device="cuda"):
        """encodes a new file from a PCMReader on ``device`` (through
        ``write_wavpack``) and returns it; ``compression`` outside
        COMPRESSION_MODES means DEFAULT_COMPRESSION.  Any failure
        raises EncodingError and leaves no file."""
        device = resolve_device(device)
        if compression not in cls.COMPRESSION_MODES:
            compression = cls.DEFAULT_COMPRESSION
        try:
            write_wavpack(filename, pcmreader, compression=compression,
                          total_pcm_frames=total_pcm_frames, device=device)
            return cls(filename, device)
        except (IOError, ValueError) as err:
            try:
                os.unlink(filename)
            except OSError:
                pass
            raise EncodingError(str(err))
