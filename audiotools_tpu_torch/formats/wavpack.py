"""WavPack files: the writer and ``WavPackAudio``.

Port of the reference's ``WavPackAudio``
(``audiotools_tpu/formats/wavpack.py``):
its compression modes, each a block size and a pass count, and the
RIFF header the first block stores; the correlation passes on a torch
device (``codecs.wavpack.encode_wavpack``).  ``WavPackAudio`` reads the
first block's header and decodes with
``codecs.wavpack.TorchWavPackDecoder`` on its device.  Its tags are
the APEv2 tag at the file's end (``meta.ape.ApeTaggedAudio``), where
``add_replay_gain`` writes the four replaygain_* items from the album
analysis on the device; a WAVE's foreign RIFF chunks are stored in the
blocks as its header and footer (``from_wave``, ``wave_header_footer``).
"""

from __future__ import annotations

import os
import struct

from .. import text
from .._device import resolve_device
from ..audiofile import EncodingError, InvalidFile, ReplayGain, WaveContainer
from ..codecs.wavpack import encode_wavpack
from ..meta.ape import ApeTag, ApeTaggedAudio, ApeTagItem
from ..pcm import CounterPCMReader
from ..ref.wavpack import (WV_WAVE_FOOTER, WV_WAVE_HEADER, WavPackDecoder,
                           walk_sub_blocks)
from ..utils.config import default_quality
from .wav import riff_data_size, wave_chunks

DEFAULT_COMPRESSION = "standard"
OPTIONS = {"veryfast": {"block_size": 44100, "correlation_passes": 1},
           "fast": {"block_size": 44100, "correlation_passes": 2},
           "standard": {"block_size": 44100, "correlation_passes": 5},
           "high": {"block_size": 44100, "correlation_passes": 10},
           "veryhigh": {"block_size": 44100, "correlation_passes": 16}}


def write_wavpack(path_or_file, pcmreader, compression=DEFAULT_COMPRESSION,
                  total_pcm_frames=None, device="cuda", timings=None,
                  wave_header=None, wave_footer=None):
    """encodes a WavPack file from a PCMReader

    path_or_file: a path or a writable, seekable binary file.
    compression: a key of OPTIONS.  With total_pcm_frames the block
    headers carry it from the start, as the reference writes them
    (ValueError when the reader gives another count).  device, timings,
    wave_header and wave_footer as in ``codecs.wavpack.encode_wavpack``.
    The reader is closed at the end; returns the PCM bytes written."""
    if compression not in OPTIONS:
        raise ValueError("unknown WavPack compression %r" % (compression,))
    counter = CounterPCMReader(pcmreader)
    try:
        encode_wavpack(
            path_or_file, counter, total_pcm_frames=total_pcm_frames or 0,
            device=device, timings=timings, wave_header=wave_header,
            wave_footer=wave_footer, **OPTIONS[compression])
        if (total_pcm_frames is not None and
                counter.frames_written != total_pcm_frames):
            raise ValueError("total PCM frames mismatch")
        return counter.bytes_written()
    finally:
        pcmreader.close()


class InvalidWavPack(InvalidFile, ValueError):
    """a file that is not a WavPack file this module reads"""


class WavPackAudio(ApeTaggedAudio, WaveContainer):
    """a WavPack file, encoded and decoded on a torch device

    device: "cuda" (raises when no card is usable) or "cpu" (the
    kernels' plain versions, for tests); ``to_pcm`` decodes there."""

    SUFFIX = "wv"
    NAME = "wavpack"
    DESCRIPTION = "WavPack"
    COMPRESSION_DESCRIPTIONS = {"veryfast": text.COMP_WAVPACK_VERYFAST,
                                "veryhigh": text.COMP_WAVPACK_VERYHIGH}
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

    def wave_header_footer(self):
        """the RIFF bytes the blocks store before and after the PCM;
        raises ValueError when they store no header"""
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
        if not header:
            raise ValueError("no wave header stored")
        return (header, footer)

    def has_foreign_wave_chunks(self):
        """a stored footer, or chunks besides fmt and data in the
        stored header"""
        try:
            (header, footer) = self.wave_header_footer()
        except (ValueError, IOError):
            return False
        return (len(footer) >= 8 or
                any(chunk_id not in (b"fmt ", b"data")
                    for (chunk_id, _size) in wave_chunks(header)))

    @classmethod
    def default_compression(cls, compression):
        """``compression`` when it is one of COMPRESSION_MODES, else the
        user's configured ``[Quality] wavpack``, else DEFAULT_COMPRESSION;
        a configured value that is no mode raises KeyError, as the
        reference's lookup of its options does"""
        if compression in cls.COMPRESSION_MODES:
            return compression
        compression = default_quality(cls.NAME) or cls.DEFAULT_COMPRESSION
        if compression not in cls.COMPRESSION_MODES:
            raise KeyError(compression)
        return compression

    def to_pcm(self):
        """a TorchWavPackDecoder of the file on the file's device"""
        from ..codecs.wavpack import TorchWavPackDecoder
        return TorchWavPackDecoder(self.filename, device=self.device)

    @classmethod
    def from_pcm(cls, filename, pcmreader, compression=None,
                 total_pcm_frames=None, device="cuda"):
        """encodes a new file from a PCMReader on ``device`` (through
        ``write_wavpack``) and returns it; ``compression`` outside
        COMPRESSION_MODES means ``default_compression``'s.  Any failure
        raises EncodingError and leaves no file."""
        device = resolve_device(device)
        compression = cls.default_compression(compression)
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

    @classmethod
    def from_wave(cls, filename, header, pcmreader, footer, compression=None,
                  device="cuda"):
        """encodes a new file from a WAVE's header, PCM and footer on
        ``device``, the header and footer stored in the blocks; raises
        EncodingError (and leaves no file) when the PCM is not the
        header's data chunk's size; ``compression`` as ``from_pcm``'s"""
        device = resolve_device(device)
        compression = cls.default_compression(compression)
        try:
            data_size = riff_data_size(header)
            written = write_wavpack(filename, pcmreader, compression,
                                    device=device, wave_header=header,
                                    wave_footer=footer)
            if written != data_size:
                raise ValueError("truncated data chunk")
            return cls(filename, device)
        except (IOError, ValueError) as err:
            try:
                os.unlink(filename)
            except OSError:
                pass
            raise EncodingError(str(err))

    @classmethod
    def supports_replay_gain(cls):
        return True

    @classmethod
    def lossless_replay_gain(cls):
        return True

    @classmethod
    def can_add_replay_gain(cls, audiofiles):
        return all(isinstance(f, WavPackAudio) for f in audiofiles)

    @classmethod
    def add_replay_gain(cls, filenames, progress=None, device="cuda"):
        """writes the replaygain_* APEv2 items of the WavPack files
        named, analysed as one album on ``device``"""
        from ..dispatch import open_files
        from ..replaygain import calculate_replay_gain_values
        tracks = [t for t in open_files(filenames, device=device)
                  if isinstance(t, cls)]
        for (track, gain, peak, album_gain, album_peak) in \
                calculate_replay_gain_values(tracks, progress, device):
            metadata = track.get_metadata()
            if metadata is None:
                metadata = ApeTag([])
            for (key, value) in (
                    ("replaygain_track_gain", "%+1.2f dB" % (gain,)),
                    ("replaygain_track_peak", "%1.6f" % (peak,)),
                    ("replaygain_album_gain", "%+1.2f dB" % (album_gain,)),
                    ("replaygain_album_peak", "%1.6f" % (album_peak,))):
                metadata[key] = ApeTagItem.string(key, value)
            track.update_metadata(metadata)

    def replay_gain(self):
        """the replaygain_* items' ReplayGain, or None"""
        metadata = self.get_metadata()
        if metadata is None:
            return None
        try:
            return ReplayGain(
                str(metadata["replaygain_track_gain"]).split(" ")[0],
                str(metadata["replaygain_track_peak"]),
                str(metadata["replaygain_album_gain"]).split(" ")[0],
                str(metadata["replaygain_album_peak"]))
        except (KeyError, ValueError):
            return None
