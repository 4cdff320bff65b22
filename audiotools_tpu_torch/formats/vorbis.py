"""Ogg Vorbis files.

The port's copy of the reference's ``audiotools_tpu/formats/vorbis.py``:
Ogg Vorbis streams with a VorbisComment in the second header packet,
decoded and encoded by the system's Vorbis libraries
(``codecs/vorbis``), their comments rewritten through the port's
``ogg`` pages, and ReplayGain read from the comments.  ``verify`` is
``AudioFile.verify``: the whole stream decoded (a lossy class checks no
frame count).  The class is available when its libraries are found.  Everything runs on the host:
``device`` arguments are taken for the signature the classes share.
"""

from __future__ import annotations

import os
import struct
import subprocess

from .. import text
from ..audiofile import (AudioFile, EncodingError, InvalidFile, MetaData,
                         ReplayGain)
from ..codecs.vorbis import VorbisDecoder, encode_vorbis, vorbis_libs, \
    vorbisfile_lib
from ..meta.vorbiscomment import VorbisComment
from ..ogg import PacketReader, PageReader, PageWriter, packets_to_pages
from ..pcm import ChannelMask, PCMReaderError
from ..utils.config import BIN, default_quality
from ..utils.files import TemporaryFile


class InvalidVorbis(InvalidFile, ValueError):
    """a file whose first packet is no Vorbis identification header"""


def _parse_comment_packet(packet, prefix):
    """parses a vorbis-style comment packet into a VorbisComment"""
    pos = len(prefix)
    (vendor_len,) = struct.unpack("<I", packet[pos:pos + 4])
    pos += 4
    vendor = packet[pos:pos + vendor_len].decode("utf-8", "replace")
    pos += vendor_len
    (count,) = struct.unpack("<I", packet[pos:pos + 4])
    pos += 4
    comments = []
    for _ in range(count):
        (length,) = struct.unpack("<I", packet[pos:pos + 4])
        pos += 4
        comments.append(packet[pos:pos + length].decode("utf-8",
                                                        "replace"))
        pos += length
    return VorbisComment(comments, vendor)


def _build_comment_packet(comment, prefix, framing=True):
    """serializes a VorbisComment into a comment packet"""
    out = bytearray(prefix)
    vendor = comment.vendor_string.encode("utf-8")
    out += struct.pack("<I", len(vendor)) + vendor
    strings = [s.encode("utf-8") for s in comment.comment_strings]
    out += struct.pack("<I", len(strings))
    for s in strings:
        out += struct.pack("<I", len(s)) + s
    if framing:
        out += b"\x01"
    return bytes(out)


def _read_pages(filename):
    """every page of an Ogg file up to the first one that does not
    read"""
    pages = []
    with open(filename, "rb") as f:
        reader = PageReader(f)
        while True:
            try:
                pages.append(reader.read())
            except (IOError, ValueError):
                return pages


def _last_granule(filename):
    """the granule position of the file's last page that has one (the
    total samples of a Vorbis stream), 0 when none is found in its
    last 64 KiB"""
    with open(filename, "rb") as f:
        f.seek(0, 2)
        size = f.tell()
        # scan the file tail for the final page header
        window = min(size, 1 << 16)
        f.seek(size - window, 0)
        data = f.read(window)
    pos = data.rfind(b"OggS")
    while pos >= 0:
        try:
            (granule,) = struct.unpack("<q", data[pos + 6:pos + 14])
            if granule >= 0:
                return granule
        except struct.error:
            pass
        pos = data.rfind(b"OggS", 0, pos)
    return 0


class VorbisAudio(AudioFile):
    """an Ogg Vorbis file, read and written on the host"""

    SUFFIX = "ogg"
    NAME = "vorbis"
    DESCRIPTION = "Ogg Vorbis"
    DEFAULT_COMPRESSION = "3"
    COMPRESSION_MODES = tuple(str(i) for i in range(0, 11))
    COMPRESSION_DESCRIPTIONS = {"0": text.COMP_VORBIS_0,
                                "10": text.COMP_VORBIS_10}

    def __init__(self, filename):
        AudioFile.__init__(self, filename)
        try:
            with open(filename, "rb") as f:
                packets = PacketReader(PageReader(f))
                ident = packets.read_packet()
                if ident[0:7] != b"\x01vorbis":
                    raise InvalidVorbis("invalid Vorbis ID packet")
                (_version, channels, rate) = struct.unpack(
                    "<IBI", ident[7:16])
                self.__channels__ = channels
                self.__sample_rate__ = rate
        except (IOError, ValueError) as err:
            raise InvalidVorbis(str(err))
        self.__total_frames__ = None

    @classmethod
    def available(cls, system_binaries=None):
        """True when libvorbisfile, libvorbis, libvorbisenc and libogg
        are found"""
        return (vorbisfile_lib() is not None and
                vorbis_libs() is not None)

    def lossless(self):
        return False

    def bits_per_sample(self):
        return 16

    def channels(self):
        return self.__channels__

    def channel_mask(self):
        return ChannelMask(
            {1: 0x4, 2: 0x3, 3: 0x7, 5: 0x37, 6: 0x3F}.get(
                self.__channels__, 0))

    def sample_rate(self):
        return self.__sample_rate__

    def total_frames(self):
        if self.__total_frames__ is None:
            self.__total_frames__ = _last_granule(self.filename)
        return self.__total_frames__

    def seekable(self):
        return False

    # ---- metadata -------------------------------------------------------

    def get_metadata(self):
        with open(self.filename, "rb") as f:
            packets = PacketReader(PageReader(f))
            packets.read_packet()               # ID header
            comment = packets.read_packet()     # comment header
            if comment[0:7] != b"\x03vorbis":
                return None
            return _parse_comment_packet(comment, b"\x03vorbis")

    def update_metadata(self, metadata):
        if not isinstance(metadata, VorbisComment):
            raise ValueError("metadata must be VorbisComment")

        with open(self.filename, "rb") as f:
            packets = PacketReader(PageReader(f))
            ident = packets.read_packet()
            packets.read_packet()               # old comment
            setup = packets.read_packet()       # codebooks
            last_header_page = packets.page.sequence_number
            serial = packets.page.bitstream_serial_number
        pages = _read_pages(self.filename)
        seqs = [p.sequence_number for p in pages]
        first_audio_index = seqs.index(last_header_page) + 1

        comment_packet = _build_comment_packet(metadata,
                                               b"\x03vorbis")
        with TemporaryFile(self.filename) as new_file:
            writer = PageWriter(new_file)
            # ID packet gets its own first page; comment+setup packed next
            ident_pages = list(packets_to_pages([ident], serial, 0))
            ident_pages[0].stream_beginning = True
            for page in ident_pages:
                writer.write(page)
            seq = len(ident_pages)
            for page in packets_to_pages([comment_packet, setup],
                                         serial, seq):
                writer.write(page)
                seq += 1
            for page in pages[first_audio_index:]:
                page.sequence_number = seq
                seq += 1
                writer.write(page)

    def set_metadata(self, metadata):
        metadata = VorbisComment.converted(metadata)
        if metadata is None:
            return
        old = self.get_metadata()
        if old is not None:
            metadata.vendor_string = old.vendor_string
        self.update_metadata(metadata)

    def delete_metadata(self):
        self.set_metadata(MetaData())

    # ---- audio ----------------------------------------------------------

    def to_pcm(self):
        try:
            return VorbisDecoder(self.filename)
        except ValueError as err:
            return PCMReaderError(str(err), self.sample_rate(),
                                  self.channels(),
                                  int(self.channel_mask()), 16)

    @classmethod
    def from_pcm(cls, filename, pcmreader, compression=None,
                 total_pcm_frames=None, device=None):
        """encodes an Ogg Vorbis file at VBR quality ``compression`` / 10
        (the configured or default one when it is no mode); raises
        EncodingError.  ``total_pcm_frames`` and ``device`` are ignored:
        the encode runs on the host."""
        if (compression is None or
                compression not in cls.COMPRESSION_MODES):
            compression = default_quality(cls.NAME) or \
                cls.DEFAULT_COMPRESSION
        try:
            encode_vorbis(filename, pcmreader,
                          quality=int(compression) / 10.0)
        except (ValueError, IOError) as err:
            raise EncodingError(str(err))
        return cls(filename)

    # ReplayGain through the vorbisgain program, when it is found: the
    # gains land in the comments, so the operation is lossless
    REPLAYGAIN_BINARIES = ("vorbisgain",)

    @classmethod
    def supports_replay_gain(cls):
        return True

    @classmethod
    def lossless_replay_gain(cls):
        return True

    @classmethod
    def can_add_replay_gain(cls, audiofiles):
        if not all(isinstance(f, VorbisAudio) for f in audiofiles):
            return False
        return BIN.can_execute(BIN["vorbisgain"])

    @classmethod
    def add_replay_gain(cls, filenames, progress=None, device="cuda"):
        """adds ReplayGain comments with the vorbisgain program (nothing
        when it is absent); ``device`` is the one the files named are
        opened on"""
        from ..dispatch import open_files

        track_names = [track.filename for track in
                       open_files(filenames, device=device)
                       if isinstance(track, cls)]
        if progress is not None:
            progress(0, 1)
        if track_names and BIN.can_execute(BIN["vorbisgain"]):
            with open(os.devnull, "ab") as devnull:
                subprocess.run(
                    [BIN["vorbisgain"], "-q", "-a"] + track_names,
                    stdout=devnull, stderr=devnull)
        if progress is not None:
            progress(1, 1)

    def replay_gain(self):
        """a ReplayGain of the four REPLAYGAIN_* comments, or None"""
        metadata = self.get_metadata()
        keys = {"REPLAYGAIN_TRACK_PEAK", "REPLAYGAIN_TRACK_GAIN",
                "REPLAYGAIN_ALBUM_PEAK", "REPLAYGAIN_ALBUM_GAIN"}
        if metadata is None or not keys.issubset(set(metadata.keys())):
            return None
        try:
            return ReplayGain(
                metadata["REPLAYGAIN_TRACK_GAIN"][0][:-len(" dB")],
                metadata["REPLAYGAIN_TRACK_PEAK"][0],
                metadata["REPLAYGAIN_ALBUM_GAIN"][0][:-len(" dB")],
                metadata["REPLAYGAIN_ALBUM_PEAK"][0])
        except (IndexError, ValueError):
            return None
