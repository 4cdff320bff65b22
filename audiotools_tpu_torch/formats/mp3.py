"""MP3 and MP2 files.

The port's copy of the reference's ``audiotools_tpu/formats/mp3.py``:
MPEG-1 layer III and layer II streams, with an ID3v2 tag in front and
an ID3v1 tag at the end (``set_metadata`` writes an ID3v2.3 and ID3v1
pair), decoded by libmpg123 and encoded by libmp3lame (MP3, VBR
qualities) or libtwolame (MP2, bitrates) through ``codecs/mpeg``, and
verified and counted by the host frame walker ``_native.verify_mpeg``.
A class is available when its libraries are found.  Everything runs on
the host: ``device`` arguments are taken for the signature the classes
share.
"""

from __future__ import annotations

import io
import os
import subprocess

from .. import _native, text
from ..audiofile import AudioFile, EncodingError, InvalidFile
from ..bitstream import BitstreamWriter
from ..codecs.mpeg import (MP3Decoder, encode_mp2, encode_mp3, lame_lib,
                           mpg123_lib, twolame_lib)
from ..meta.id3 import (ID3CommentPair, ID3v22Comment, ID3v23Comment,
                        ID3v24Comment, read_id3v2_comment,
                        skip_id3v2_comment)
from ..meta.id3v1 import ID3v1Comment
from ..pcm import BufferedPCMReader, ChannelMask, PCMReaderError
from ..pcmconverter import Averager, BPSConverter
from ..utils.config import BIN, default_quality
from ..utils.files import TemporaryFile


class InvalidMP3(InvalidFile, ValueError):
    """a file whose first MPEG frame header does not parse"""


def _strip_tags(data):
    """returns (audio bytes, leading tag size) without ID3v2/ID3v1"""
    start = skip_id3v2_comment(io.BytesIO(data))
    end = len(data)
    if end - start >= 128 and data[end - 128:end - 125] == b"TAG":
        end -= 128
    return (data[start:end], start)


class MP3Audio(AudioFile):
    """an MPEG-1 layer III file, read and written on the host"""

    SUFFIX = "mp3"
    NAME = SUFFIX
    DESCRIPTION = "MPEG-1 Audio Layer III"
    DEFAULT_COMPRESSION = "2"
    COMPRESSION_MODES = tuple(map(str, range(0, 10)))
    COMPRESSION_DESCRIPTIONS = {"0": text.COMP_LAME_0,
                                "9": text.COMP_LAME_9}

    def __init__(self, filename):
        AudioFile.__init__(self, filename)
        try:
            with open(filename, "rb") as f:
                skip_id3v2_comment(f)
                header = f.read(4)
        except IOError as err:
            raise InvalidMP3(str(err))
        info = _parse_first_frame(header)
        if info is None:
            raise InvalidMP3("invalid MPEG frame header")
        (self.__sample_rate__, self.__channels__,
         self.__layer__) = info
        self.__total_frames__ = None

    @classmethod
    def available(cls, system_binaries=None):
        """True when libmpg123 and libmp3lame are found"""
        return (mpg123_lib() is not None) and (lame_lib() is not None)

    def lossless(self):
        return False

    def bits_per_sample(self):
        return 16

    def channels(self):
        return self.__channels__

    def channel_mask(self):
        return ChannelMask(0x3 if self.__channels__ == 2 else 0x4)

    def sample_rate(self):
        return self.__sample_rate__

    def total_frames(self):
        """the samples a channel of the frames the walker counts (0 for
        a stream it refuses)"""
        if self.__total_frames__ is None:
            try:
                with open(self.filename, "rb") as f:
                    (_frames, samples, _sr, _ch,
                     _layer) = _native.verify_mpeg(f.read())
                self.__total_frames__ = samples
            except (IOError, ValueError):
                self.__total_frames__ = 0
        return self.__total_frames__

    def seekable(self):
        return False

    # ---- metadata -------------------------------------------------------

    def get_metadata(self):
        """returns ID3CommentPair / ID3v2 / ID3v1 metadata or None"""
        id3v2 = None
        id3v1 = None
        with open(self.filename, "rb") as f:
            try:
                id3v2 = read_id3v2_comment(f)
            except ValueError:
                pass
            try:
                id3v1 = ID3v1Comment.parse(f)
            except (IOError, ValueError):
                pass
        if id3v2 is not None and id3v1 is not None:
            return ID3CommentPair(id3v2, id3v1)
        return id3v2 if id3v2 is not None else id3v1

    def update_metadata(self, metadata):
        """writes the ID3 metadata object(s) back to the file"""
        if metadata is None:
            return
        if not isinstance(metadata, (ID3CommentPair, ID3v22Comment,
                                     ID3v23Comment, ID3v24Comment,
                                     ID3v1Comment)):
            raise ValueError("metadata must be ID3 metadata")

        with open(self.filename, "rb") as f:
            (audio, _lead) = _strip_tags(f.read())
        with TemporaryFile(self.filename) as new_file:
            if isinstance(metadata, ID3CommentPair):
                writer = BitstreamWriter(new_file, False)
                metadata.id3v2.build(writer)
                writer.flush()
                new_file.write(audio)
                metadata.id3v1.build(new_file)
            elif isinstance(metadata, ID3v1Comment):
                new_file.write(audio)
                metadata.build(new_file)
            else:
                writer = BitstreamWriter(new_file, False)
                metadata.build(writer)
                writer.flush()
                new_file.write(audio)

    def set_metadata(self, metadata):
        """converts and writes a MetaData object (an ID3CommentPair of
        ID3v2.3 and ID3v1)"""
        if metadata is None:
            return
        self.update_metadata(ID3CommentPair.converted(metadata))

    def delete_metadata(self):
        with open(self.filename, "rb") as f:
            (audio, _lead) = _strip_tags(f.read())
        with TemporaryFile(self.filename) as new_file:
            new_file.write(audio)

    # ---- audio ----------------------------------------------------------

    def to_pcm(self):
        try:
            return MP3Decoder(self.filename)
        except ValueError as err:
            return PCMReaderError(str(err), self.sample_rate(),
                                  self.channels(),
                                  int(self.channel_mask()), 16)

    @classmethod
    def from_pcm(cls, filename, pcmreader, compression=None,
                 total_pcm_frames=None, device=None):
        """encodes an MP3 file with libmp3lame at a VBR quality (the
        configured or default one when ``compression`` is no mode) from
        the PCM averaged to one channel when it has more than two and
        converted to 16 bits; raises EncodingError.  ``total_pcm_frames``
        and ``device`` are ignored: the encode runs on the host."""
        if (compression is None or
                compression not in cls.COMPRESSION_MODES):
            compression = default_quality(cls.NAME) or \
                cls.DEFAULT_COMPRESSION

        try:
            encode_mp3(filename,
                       BufferedPCMReader(
                           _to_16bit_stereo(pcmreader)),
                       compression)
        except (ValueError, IOError) as err:
            raise EncodingError(str(err))
        return cls(filename)

    def verify(self, progress=None, sink=None):
        """frame-walks the MPEG stream; raises InvalidFile on error.
        ``sink(samples)``, when given, then takes each decoded int32
        [frames, channels] array in stream order."""
        try:
            with open(self.filename, "rb") as f:
                _native.verify_mpeg(f.read())
        except (IOError, ValueError) as err:
            raise InvalidFile(str(err))
        if sink is not None:
            AudioFile.verify(self, progress, sink)
        return True

    # ReplayGain through the mp3gain program, when it is found: it
    # rewrites the frames' global gain fields, so the operation is not
    # lossless
    REPLAYGAIN_BINARIES = ("mp3gain",)

    @classmethod
    def supports_replay_gain(cls):
        return True

    @classmethod
    def lossless_replay_gain(cls):
        return False

    @classmethod
    def can_add_replay_gain(cls, audiofiles):
        if not all(isinstance(f, MP3Audio) for f in audiofiles):
            return False
        return BIN.can_execute(BIN["mp3gain"])

    @classmethod
    def add_replay_gain(cls, filenames, progress=None, device="cuda"):
        """applies ReplayGain with the mp3gain program (nothing when it
        is absent); ``device`` is the one the files named are opened
        on"""
        from ..dispatch import open_files

        track_names = [track.filename for track in
                       open_files(filenames, device=device)
                       if isinstance(track, cls)]
        if progress is not None:
            progress(0, 1)
        if track_names and BIN.can_execute(BIN["mp3gain"]):
            with open(os.devnull, "ab") as devnull:
                subprocess.run(
                    [BIN["mp3gain"], "-f", "-k", "-q", "-r"] +
                    track_names,
                    stdout=devnull, stderr=devnull)
        if progress is not None:
            progress(1, 1)


class MP2Audio(MP3Audio):
    """an MPEG-1 layer II file, read and written on the host"""

    SUFFIX = "mp2"
    NAME = SUFFIX
    DESCRIPTION = "MPEG-1 Audio Layer II"
    DEFAULT_COMPRESSION = str(192)
    COMPRESSION_MODES = tuple(map(str, (64, 96, 112, 128, 160, 192,
                                        224, 256, 320, 384)))
    COMPRESSION_DESCRIPTIONS = {"64": text.COMP_TWOLAME_64,
                                "384": text.COMP_TWOLAME_384}

    @classmethod
    def available(cls, system_binaries=None):
        """True when libmpg123 and libtwolame are found"""
        return ((mpg123_lib() is not None) and
                (twolame_lib() is not None))

    @classmethod
    def from_pcm(cls, filename, pcmreader, compression=None,
                 total_pcm_frames=None, device=None):
        """encodes an MP2 file with libtwolame at a bitrate, as
        MP3Audio's from_pcm does"""
        if (compression is None or
                compression not in cls.COMPRESSION_MODES):
            compression = default_quality(cls.NAME) or \
                cls.DEFAULT_COMPRESSION
        try:
            encode_mp2(filename,
                       BufferedPCMReader(
                           _to_16bit_stereo(pcmreader)),
                       compression)
        except (ValueError, IOError) as err:
            raise EncodingError(str(err))
        return cls(filename)


def _parse_first_frame(header):
    """parses a 4-byte MPEG frame header; returns
    (sample_rate, channels, layer) or None"""
    if len(header) < 4 or header[0] != 0xFF or \
            (header[1] & 0xE0) != 0xE0:
        return None
    version_bits = (header[1] >> 3) & 3
    layer_bits = (header[1] >> 1) & 3
    rate_idx = (header[2] >> 2) & 3
    channel_mode = (header[3] >> 6) & 3
    if version_bits == 1 or layer_bits == 0:
        return None
    rates = {0: (11025, 12000, 8000),
             2: (22050, 24000, 16000),
             3: (44100, 48000, 32000)}[version_bits]
    if rate_idx == 3:
        return None
    return (rates[rate_idx],
            1 if channel_mode == 3 else 2,
            4 - layer_bits)


def _to_16bit_stereo(pcmreader):
    """a PCMReader of at most two channels (more are averaged to one)
    and 16 bits, for the MPEG encoders"""
    out = pcmreader
    if out.channels > 2:
        out = Averager(out)
    if out.bits_per_sample != 16:
        out = BPSConverter(out, 16)
    return out
