"""Ogg Opus files.

The port's copy of the reference's ``audiotools_tpu/formats/opus.py``:
Ogg Opus streams with their OpusTags (a VorbisComment), coded by the
system's libopus with the port's Ogg pages (``codecs/opus``).  Opus
always decodes at 48 kHz.  ``from_pcm`` feeds the encoder through
``opus_input``: more than two channels averaged to one, 16 bits, and
any other rate resampled to 48 kHz by ``pcmconverter.Resampler`` on the
device given (the encode itself runs on the host).  The class is
available when libopus is found.
"""

from __future__ import annotations

from .. import text
from .._device import resolve_device
from ..audiofile import AudioFile, EncodingError, InvalidFile, MetaData
from ..codecs.opus import (OPUS_RATE, OpusDecoder, encode_opus, opus_lib,
                           parse_opus_head)
from ..meta.vorbiscomment import VorbisComment
from ..ogg import Page, PacketReader, PageReader, PageWriter, packet_to_pages
from ..pcm import ChannelMask, PCMReaderError
from ..pcmconverter import Averager, BPSConverter, Resampler
from ..utils.config import default_quality
from ..utils.files import TemporaryFile
from .vorbis import (_build_comment_packet, _last_granule,
                     _parse_comment_packet, _read_pages)


class InvalidOpus(InvalidFile, ValueError):
    """a file whose first packet is no OpusHead"""


def opus_input(pcmreader, device):
    """the PCMReader the Opus encoder takes from ``pcmreader``: averaged
    to one channel when it has more than two, converted to 16 bits, and
    resampled to 48 kHz on ``device`` when its rate is another"""
    reader = pcmreader
    if reader.channels > 2:
        reader = Averager(reader)
    if reader.bits_per_sample != 16:
        reader = BPSConverter(reader, 16)
    if reader.sample_rate != OPUS_RATE:
        reader = Resampler(reader, OPUS_RATE, device=device)
    return reader


class OpusAudio(AudioFile):
    """an Ogg Opus file"""

    SUFFIX = "opus"
    NAME = "opus"
    DESCRIPTION = "Opus Audio Codec"
    DEFAULT_COMPRESSION = "10"
    COMPRESSION_MODES = tuple(map(str, range(0, 11)))
    COMPRESSION_DESCRIPTIONS = {"0": text.COMP_OPUS_0,
                                "10": text.COMP_OPUS_10}

    def __init__(self, filename):
        AudioFile.__init__(self, filename)
        try:
            with open(filename, "rb") as f:
                packets = PacketReader(PageReader(f))
                head = packets.read_packet()
                (channels, preskip, _input_rate,
                 _mapping) = parse_opus_head(head)
                self.__channels__ = channels
                self.__preskip__ = preskip
        except (IOError, ValueError) as err:
            raise InvalidOpus(str(err))
        self.__total_frames__ = None

    @classmethod
    def available(cls, system_binaries=None):
        """True when libopus is found"""
        return opus_lib() is not None

    def lossless(self):
        return False

    def bits_per_sample(self):
        return 16

    def channels(self):
        return self.__channels__

    def channel_mask(self):
        return ChannelMask(0x3 if self.__channels__ == 2 else 0x4)

    def sample_rate(self):
        return OPUS_RATE

    def total_frames(self):
        """the last granule position less the pre-skip"""
        if self.__total_frames__ is None:
            granule = _last_granule(self.filename)
            self.__total_frames__ = max(granule - self.__preskip__, 0)
        return self.__total_frames__

    def seekable(self):
        return False

    # ---- metadata -------------------------------------------------------

    def get_metadata(self):
        with open(self.filename, "rb") as f:
            packets = PacketReader(PageReader(f))
            packets.read_packet()               # OpusHead
            tags = packets.read_packet()
            if tags[0:8] != b"OpusTags":
                return None
            return _parse_comment_packet(tags, b"OpusTags")

    def update_metadata(self, metadata):
        if not isinstance(metadata, VorbisComment):
            raise ValueError("metadata must be VorbisComment")

        with open(self.filename, "rb") as f:
            packets = PacketReader(PageReader(f))
            head = packets.read_packet()
            packets.read_packet()               # old OpusTags
            last_header_page = packets.page.sequence_number
            serial = packets.page.bitstream_serial_number
        pages = _read_pages(self.filename)
        seqs = [p.sequence_number for p in pages]
        first_audio_index = seqs.index(last_header_page) + 1

        tags_packet = _build_comment_packet(metadata, b"OpusTags",
                                            framing=False)
        with TemporaryFile(self.filename) as new_file:
            writer = PageWriter(new_file)
            writer.write(Page(False, True, False, 0, serial, 0, [head]))
            seq = 1
            for page in packet_to_pages(tags_packet, serial, seq):
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
            return OpusDecoder(self.filename)
        except (IOError, ValueError) as err:
            return PCMReaderError(str(err), OPUS_RATE, self.channels(),
                                  int(self.channel_mask()), 16)

    @classmethod
    def from_pcm(cls, filename, pcmreader, compression=None,
                 total_pcm_frames=None, device="cuda"):
        """encodes an Ogg Opus file at complexity ``compression`` (the
        configured or default one when it is no mode) from
        ``opus_input(pcmreader, device)``; ``device`` is resolved first,
        so a request for an absent card raises.  Raises EncodingError;
        ``total_pcm_frames`` is ignored."""
        device = resolve_device(device)
        if (compression is None or
                compression not in cls.COMPRESSION_MODES):
            compression = default_quality(cls.NAME) or \
                cls.DEFAULT_COMPRESSION
        try:
            encode_opus(filename, opus_input(pcmreader, device),
                        compression=int(compression))
        except (ValueError, IOError) as err:
            raise EncodingError(str(err))
        return cls(filename)
