"""Sun AU files: ``AuAudio``.

A copy of the reference's ``audiotools_tpu/formats/au.py``: signed
big-endian linear PCM (encodings 2, 3 and 4: 8, 16 and 24 bits) behind
a ``.snd`` header of data offset, data size, encoding, sample rate and
channel count.  AU has no footer and holds no tags.  It is read and
written on the host: ``device`` arguments are taken for the signature
the classes share, and ``device`` is None.
"""

from __future__ import annotations

import struct

from ..audiofile import AudioFile, EncodingError, InvalidFile
from ..pcm import (CHANNEL_MASKS, CounterPCMReader, LimitedFileReader,
                   PCMReader, transfer_framelist_data)
from .wav import _unlink


class InvalidAU(InvalidFile, ValueError):
    """a file that is not a Sun AU file this module reads"""


class AuAudio(AudioFile):
    """a Sun AU file"""

    SUFFIX = "au"
    NAME = SUFFIX
    DESCRIPTION = "Sun Au"

    # bits per sample of the linear PCM encodings
    ENCODINGS = {2: 8, 3: 16, 4: 24}

    def __init__(self, filename):
        AudioFile.__init__(self, filename)
        try:
            with open(filename, "rb") as f:
                header = f.read(24)
        except IOError as err:
            raise InvalidAU(str(err)) from err
        if len(header) < 24 or header[0:4] != b".snd":
            raise InvalidAU("invalid Au header")
        (self.__data_offset, self.__data_size, encoding,
         self.__sample_rate, self.__channels) = struct.unpack(
             ">IIIII", header[4:24])
        if encoding not in self.ENCODINGS:
            raise InvalidAU("unsupported Au encoding")
        self.__bits_per_sample = self.ENCODINGS[encoding]

    def bits_per_sample(self):
        return self.__bits_per_sample

    def channels(self):
        return self.__channels

    def channel_mask(self):
        return (CHANNEL_MASKS[self.__channels]
                if self.__channels in (1, 2) else 0)

    def sample_rate(self):
        return self.__sample_rate

    def total_frames(self):
        bytes_per_frame = self.__channels * (self.__bits_per_sample // 8)
        return self.__data_size // bytes_per_frame if bytes_per_frame else 0

    def seekable(self):
        return True

    def to_pcm(self):
        """a PCMReader of the data's samples"""
        f = open(self.filename, "rb")
        f.seek(self.__data_offset, 0)
        return PCMReader(LimitedFileReader(f, self.__data_size),
                         self.__sample_rate, self.__channels,
                         self.channel_mask(), self.__bits_per_sample,
                         signed=True, big_endian=True)

    @classmethod
    def from_pcm(cls, filename, pcmreader, compression=None,
                 total_pcm_frames=None, device=None):
        """writes a new AU file from a PCMReader of 8, 16 or 24 bits and
        returns it; a written frame count other than
        ``total_pcm_frames`` (when given) raises.  Any failure raises
        EncodingError and leaves no file.  ``compression`` and
        ``device`` are ignored."""
        bps = pcmreader.bits_per_sample
        if bps not in (8, 16, 24):
            pcmreader.close()
            raise EncodingError("unsupported bits per sample: %d" % (bps,))
        encoding = {8: 2, 16: 3, 24: 4}[bps]
        try:
            with open(filename, "wb") as f:
                counter = CounterPCMReader(pcmreader)
                f.write(b".snd" + struct.pack(">IIIII", 24, 0, encoding,
                                              pcmreader.sample_rate,
                                              pcmreader.channels))
                transfer_framelist_data(counter, f.write, signed=True,
                                        big_endian=True)
                data_size = f.tell() - 24
                f.seek(8, 0)
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

    def pcm_split(self):
        """the (header, footer) bytes around the PCM: the header up to
        the data offset, and no footer"""
        with open(self.filename, "rb") as f:
            (magic, data_offset) = struct.unpack(">4sI", f.read(8))
            if magic != b".snd":
                raise ValueError("invalid Sun AU header")
            f.seek(0, 0)
            return (f.read(data_offset), b"")

    @classmethod
    def track_name(cls, file_path, track_metadata=None, format=None,
                   suffix=None):
        """AudioFile.track_name with the class's suffix, whatever
        ``suffix`` is given (as the reference's)"""
        return AudioFile.track_name(file_path, track_metadata, format,
                                    suffix=cls.SUFFIX)
