"""FLAC files: metadata blocks, ``FlacAudio`` and ``OggFlacAudio``.

A copy of the reference's ``audiotools_tpu/formats/flac.py``: the
STREAMINFO, PADDING, APPLICATION, SEEKTABLE, VORBIS_COMMENT, CUESHEET
and PICTURE blocks, the ``FlacMetaData`` container (a MetaData over its
VORBIS_COMMENT and PICTURE blocks), ``seektable_from_offsets``, and
``FlacAudio`` with the reference's compression levels "0"-"8",
``from_pcm`` (padding sized for the seektable, a seekpoint every 10 s
from the encoder's frame offsets, the WAVEFORMATEXTENSIBLE_CHANNEL_MASK
comment for more than two channels or more than 16 bits),
``get/set/update/delete_metadata``, ``to_pcm``, ``verify``, the
REPLAYGAIN_* comments (``add_replay_gain``, ``replay_gain``), foreign
RIFF and AIFF chunks kept as APPLICATION "riff" and "aiff" blocks
(``from_wave``, ``from_aiff``, ``wave_header_footer``,
``aiff_header_footer``, ``convert``'s routing between them), the
CUESHEET block made from and read as a ``Sheet`` (``get_cuesheet``,
``set_cuesheet``), and ``clean`` (the blocks' fixes that tracklint
reports and makes).  A FLAC stream behind ID3v2 tags (stacked ones
too) opens at its 'fLaC' marker, and rewriting its blocks keeps the
tags and whatever follows its last frame (an ID3v1 tag).
``OggFlacAudio`` is FLAC in an Ogg container (``ogg``): a header packet
with STREAMINFO, a packet a further block, a packet a frame.
The blocks are parsed from and built into bytes with ``struct`` (FLAC
metadata is big-endian; a VORBIS_COMMENT body is little-endian).

``from_pcm`` encodes with the port's ``encode_flac_fast`` on the
file's device, on the route the reference's environment selects (by
default the quantized upload wire), so its bytes equal the reference's
``FlacAudio.from_pcm`` under the same ``ATPU_*`` settings; so do
``OggFlacAudio``'s, whose frames ``TorchFlacDecoder`` decodes on the
file's device where the reference decodes them on the host.

A CUESHEET block is 396 bytes and 36 a track with 12 an index point,
as it is written.  The reference's ``size`` counts 9 bytes an index
point (``Flac_CUESHEET_track.size``), so its block headers understate
a cuesheet with index points; the port does not copy that fault, nor
the reference's Ogg FLAC header packet count after ``update_metadata``
(``OggFlacAudio``).

Not ported: the rest of the reference's class (``seektable``,
``metadata_length``).  A block of a reserved type (7-127) raises
InvalidFLAC when parsed.
"""

from __future__ import annotations

import io
import os
import struct
from fractions import Fraction

from .. import text
from .._device import resolve_device
from ..audiofile import (AiffContainer, AudioFile, EncodingError, Image,
                         InvalidFile, MetaData, ReplayGain, SheetIndex, SheetTrack,
                         WaveContainer)
from ..utils.config import default_quality
from ..utils.files import TemporaryFile
from ..meta.id3 import skip_id3v2_comment
from ..meta.vorbiscomment import VENDOR_STRING, VorbisComment
from ..pcm import CHANNEL_MASKS, BufferedPCMReader, CounterPCMReader


class InvalidFLAC(InvalidFile, ValueError):
    """a file that is not a FLAC file this module reads"""


class Flac_STREAMINFO:
    BLOCK_ID = 0

    def __init__(self, minimum_block_size, maximum_block_size,
                 minimum_frame_size, maximum_frame_size,
                 sample_rate, channels, bits_per_sample,
                 total_samples, md5sum):
        self.minimum_block_size = minimum_block_size
        self.maximum_block_size = maximum_block_size
        self.minimum_frame_size = minimum_frame_size
        self.maximum_frame_size = maximum_frame_size
        self.sample_rate = sample_rate
        self.channels = channels
        self.bits_per_sample = bits_per_sample
        self.total_samples = total_samples
        self.md5sum = md5sum

    def __eq__(self, block):
        return (isinstance(block, Flac_STREAMINFO) and
                vars(self) == vars(block))

    @classmethod
    def parse(cls, data):
        """the block from its 34-byte body"""
        (min_block, max_block) = struct.unpack(">HH", data[0:4])
        min_frame = int.from_bytes(data[4:7], "big")
        max_frame = int.from_bytes(data[7:10], "big")
        info = int.from_bytes(data[10:18], "big")
        return cls(min_block, max_block, min_frame, max_frame,
                   info >> 44, ((info >> 41) & 0x7) + 1,
                   ((info >> 36) & 0x1F) + 1, info & ((1 << 36) - 1),
                   bytes(data[18:34]))

    def build(self):
        """the block's body"""
        info = ((self.sample_rate << 44) | ((self.channels - 1) << 41) |
                ((self.bits_per_sample - 1) << 36) | self.total_samples)
        return (struct.pack(">HH", self.minimum_block_size,
                            self.maximum_block_size) +
                self.minimum_frame_size.to_bytes(3, "big") +
                self.maximum_frame_size.to_bytes(3, "big") +
                info.to_bytes(8, "big") + bytes(self.md5sum))

    def size(self):
        return 34

    def raw_info(self):
        return "\n".join(
            ["STREAMINFO:",
             "  minimum block size = %d" % (self.minimum_block_size,),
             "  maximum block size = %d" % (self.maximum_block_size,),
             "  minimum frame size = %d" % (self.minimum_frame_size,),
             "  maximum frame size = %d" % (self.maximum_frame_size,),
             "  sample rate        = %d" % (self.sample_rate,),
             "  channels           = %d" % (self.channels,),
             "  bits-per-sample    = %d" % (self.bits_per_sample,),
             "  total samples      = %d" % (self.total_samples,),
             "  MD5 sum            = %s" % (self.md5sum.hex(),)])


class Flac_PADDING:
    BLOCK_ID = 1

    def __init__(self, length):
        self.length = length

    def __eq__(self, block):
        return isinstance(block, Flac_PADDING) and block.length == self.length

    @classmethod
    def parse(cls, data):
        return cls(len(data))

    def build(self):
        return b"\x00" * self.length

    def size(self):
        return self.length

    def raw_info(self):
        return "PADDING:\n  length = %d" % (self.length,)


class Flac_APPLICATION:
    """an APPLICATION block: a 4-byte application ID and its data"""

    BLOCK_ID = 2

    def __init__(self, application_id, data):
        self.application_id = application_id
        self.data = data

    def __eq__(self, block):
        return (getattr(block, "application_id", None) ==
                self.application_id and
                getattr(block, "data", None) == self.data)

    def __repr__(self):
        return "Flac_APPLICATION(%r, ...)" % (self.application_id,)

    @classmethod
    def parse(cls, data):
        return cls(bytes(data[0:4]), bytes(data[4:]))

    def build(self):
        return self.application_id + self.data

    def size(self):
        return 4 + len(self.data)

    def raw_info(self):
        return "APPLICATION:\n  %s (%d bytes)" % (
            self.application_id.decode("ascii", "replace"), len(self.data))


class Flac_SEEKTABLE:
    BLOCK_ID = 3

    def __init__(self, seekpoints):
        """seekpoints is a list of
        (PCM frame offset, byte offset, PCM frame count) triples"""
        self.seekpoints = [tuple(p) for p in seekpoints]

    def __eq__(self, block):
        return (isinstance(block, Flac_SEEKTABLE) and
                block.seekpoints == self.seekpoints)

    @classmethod
    def parse(cls, data):
        return cls([struct.unpack(">QQH", data[i:i + 18])
                    for i in range(0, len(data) - 17, 18)])

    def build(self):
        return b"".join(struct.pack(">QQH", *p) for p in self.seekpoints)

    def size(self):
        return len(self.seekpoints) * 18

    def clean(self):
        """a (Flac_SEEKTABLE, fixes) pair: placeholder points dropped,
        and each point whose frame offset does not grow"""
        fixes = []
        cleaned = []
        for point in self.seekpoints:
            if point == (0xFFFFFFFFFFFFFFFF, 0, 0):
                continue
            if cleaned and point[0] <= cleaned[-1][0]:
                fixes.append(text.CLEAN_FLAC_REMOVE_SEEKPOINT)
            else:
                cleaned.append(point)
        return (Flac_SEEKTABLE(cleaned), fixes)

    def raw_info(self):
        return "\n".join(
            ["SEEKTABLE:", "  sample offset / byte offset / frame count"] +
            ["  %d / %d / %d" % tuple(p) for p in self.seekpoints])


class Flac_VORBISCOMMENT(VorbisComment):
    """a VORBIS_COMMENT block: a VorbisComment with its byte form
    (little-endian lengths)"""

    BLOCK_ID = 4

    def __repr__(self):
        return "Flac_VORBISCOMMENT(%r, %r)" % (self.comment_strings,
                                               self.vendor_string)

    @classmethod
    def parse(cls, data):
        (vendor_length,) = struct.unpack("<I", data[0:4])
        pos = 4 + vendor_length
        vendor = bytes(data[4:pos]).decode("utf-8", "replace")
        (total,) = struct.unpack("<I", data[pos:pos + 4])
        pos += 4
        comments = []
        for _ in range(total):
            (length,) = struct.unpack("<I", data[pos:pos + 4])
            comments.append(bytes(data[pos + 4:pos + 4 + length]).decode(
                "utf-8", "replace"))
            pos += 4 + length
        return cls(comments, vendor)

    def build(self):
        vendor = self.vendor_string.encode("utf-8")
        out = [struct.pack("<I", len(vendor)), vendor,
               struct.pack("<I", len(self.comment_strings))]
        for comment in self.comment_strings:
            comment = comment.encode("utf-8")
            out.extend([struct.pack("<I", len(comment)), comment])
        return b"".join(out)

    def size(self):
        return (4 + len(self.vendor_string.encode("utf-8")) + 4 +
                sum(4 + len(c.encode("utf-8"))
                    for c in self.comment_strings))

    @classmethod
    def converted(cls, metadata):
        """a Flac_VORBISCOMMENT of another MetaData's fields (another
        VorbisComment's comments and vendor string as they are)"""
        if metadata is None:
            return None
        if isinstance(metadata, VorbisComment):
            return cls(metadata.comment_strings[:], metadata.vendor_string)
        return cls(["%s=%s" % (key, getattr(metadata, attr))
                    for (attr, key) in cls.ATTRIBUTE_MAP.items()
                    if getattr(metadata, attr) is not None], VENDOR_STRING)


class Flac_CUESHEET:
    """a CUESHEET block: the catalog number, lead-in, CD-DA flag and the
    tracks (the lead-out, number 170, among them)"""

    BLOCK_ID = 5

    def __init__(self, catalog_number, lead_in_samples, is_cdda, tracks):
        self.catalog_number = catalog_number
        self.lead_in_samples = lead_in_samples
        self.is_cdda = is_cdda
        self.tracks = list(tracks)

    def __eq__(self, sheet):
        if isinstance(sheet, Flac_CUESHEET):
            return (self.catalog_number == sheet.catalog_number and
                    self.lead_in_samples == sheet.lead_in_samples and
                    self.is_cdda == sheet.is_cdda and
                    self.tracks == sheet.tracks)
        try:        # another Sheet-like layout
            return (self.catalog() == sheet.catalog() and
                    list(self.sheet_tracks()) == list(sheet.tracks()))
        except AttributeError:
            return False

    def __repr__(self):
        return "Flac_CUESHEET(%r, %r, %r, %r)" % (
            self.catalog_number, self.lead_in_samples, self.is_cdda,
            self.tracks)

    @classmethod
    def parse(cls, data):
        """the block from its body: 128 bytes of catalog number, the
        lead-in, the flag and 258 reserved bytes, the track count, then
        the tracks"""
        (lead_in, flags) = struct.unpack(">QB", data[128:137])
        tracks = []
        pos = 396
        for _ in range(data[395]):
            (track, pos) = Flac_CUESHEET_track.parse(data, pos)
            tracks.append(track)
        return cls(bytes(data[0:128]), lead_in, flags >> 7, tracks)

    def build(self):
        return (self.catalog_number +
                struct.pack(">QB", self.lead_in_samples, self.is_cdda << 7) +
                b"\x00" * 258 + bytes([len(self.tracks)]) +
                b"".join(t.build() for t in self.tracks))

    def size(self):
        return 396 + sum(t.size() for t in self.tracks)

    @classmethod
    def converted(cls, sheet, total_pcm_frames, sample_rate):
        """the block of a Sheet-like layout: its tracks at their first
        index point, and the lead-out (170) at ``total_pcm_frames``"""
        catalog = sheet.catalog()
        if catalog is None:
            catalog_number = b"\x00" * 128
        else:
            if isinstance(catalog, str):
                catalog = catalog.encode("ascii", "replace")
            catalog_number = catalog + b"\x00" * (128 - len(catalog))
        tracks = [Flac_CUESHEET_track.converted(t, sample_rate)
                  for t in sheet.tracks()]
        tracks.append(Flac_CUESHEET_track(total_pcm_frames, 170,
                                          b"\x00" * 12, 0, 0, []))
        return cls(catalog_number, sample_rate * 2, 1, tracks)

    def catalog(self):
        """the catalog number as a string, or None"""
        catalog = self.catalog_number.rstrip(b"\x00")
        return catalog.decode("ascii", "replace") if catalog else None

    def sheet_tracks(self):
        """the SheetTracks of the tracks but the lead-out, at the sample
        rate ``get_cuesheet`` noted (44,100 when none)"""
        sample_rate = getattr(self, "__sample_rate__", 44100)
        for track in self.tracks:
            if track.number != 170:
                yield track.to_sheet_track(sample_rate)

    def pcm_lengths(self, total_pcm_frames, sample_rate):
        """each track's length in PCM frames, from the tracks' offsets;
        the last track runs to ``total_pcm_frames``"""
        offsets = [t.track_offset for t in self.tracks if t.number != 170]
        if len(offsets) == 0:
            return
        for (start, end) in zip(offsets, offsets[1:]):
            total_pcm_frames -= end - start
            yield end - start
        yield total_pcm_frames

    def raw_info(self):
        return "\n".join(
            ["CUESHEET:",
             "  catalog number = %s" % (self.catalog(),),
             "  lead-in samples = %d" % (self.lead_in_samples,),
             "  is CDDA = %d" % (self.is_cdda,)] +
            ["  " + repr(t) for t in self.tracks])


class Flac_CUESHEET_track:
    def __init__(self, track_offset, number, ISRC, track_type, pre_emphasis,
                 index_points):
        self.track_offset = track_offset
        self.number = number
        self.ISRC = ISRC
        self.track_type = track_type
        self.pre_emphasis = pre_emphasis
        self.index_points = list(index_points)

    def __eq__(self, track):
        return all(getattr(track, attr, None) == getattr(self, attr)
                   for attr in ("track_offset", "number", "ISRC",
                                "track_type", "pre_emphasis",
                                "index_points"))

    def __repr__(self):
        return "Flac_CUESHEET_track(%r, %r, %r, %r, %r, %r)" % (
            self.track_offset, self.number, self.ISRC, self.track_type,
            self.pre_emphasis, self.index_points)

    @classmethod
    def parse(cls, data, pos):
        """(the track at ``pos`` of a CUESHEET body: its offset, number,
        ISRC, the type and pre-emphasis flags and 13 reserved bytes, the
        index count and the indexes; the position after it)"""
        (offset, number) = struct.unpack(">QB", data[pos:pos + 9])
        flags = data[pos + 21]
        indexes = [Flac_CUESHEET_index.parse(data[i:i + 12])
                   for i in range(pos + 36, pos + 36 + 12 * data[pos + 35],
                                  12)]
        return (cls(offset, number, bytes(data[pos + 9:pos + 21]),
                    flags >> 7, (flags >> 6) & 1, indexes),
                pos + 36 + 12 * len(indexes))

    def build(self):
        return (struct.pack(">QB", self.track_offset, self.number) +
                self.ISRC +
                bytes([(self.track_type << 7) | (self.pre_emphasis << 6)]) +
                b"\x00" * 13 + bytes([len(self.index_points)]) +
                b"".join(i.build() for i in self.index_points))

    def size(self):
        return 36 + 12 * len(self.index_points)

    @classmethod
    def converted(cls, sheet_track, sample_rate):
        """the block's track of a SheetTrack: its offset the first index
        point's, each index point's offset from it"""
        ISRC = sheet_track.ISRC()
        if ISRC is None:
            ISRC = b"\x00" * 12
        else:
            if isinstance(ISRC, str):
                ISRC = ISRC.encode("ascii", "replace")
            ISRC = ISRC + b"\x00" * (12 - len(ISRC))
        indexes = list(sheet_track.indexes())
        track_offset = int(min(i.offset() for i in indexes) * sample_rate)
        return cls(track_offset, sheet_track.number(), ISRC,
                   0 if sheet_track.audio() else 1, 0,
                   [Flac_CUESHEET_index(int(i.offset() * sample_rate) -
                                        track_offset, i.number())
                    for i in indexes])

    def to_sheet_track(self, sample_rate):
        ISRC = self.ISRC.rstrip(b"\x00")
        return SheetTrack(
            self.number,
            [SheetIndex(i.number, Fraction(self.track_offset + i.offset,
                                           sample_rate))
             for i in self.index_points],
            self.track_type == 0,
            ISRC.decode("ascii", "replace") if len(ISRC) else None)


class Flac_CUESHEET_index:
    def __init__(self, offset, number):
        self.offset = offset
        self.number = number

    def __eq__(self, index):
        return (getattr(index, "offset", None) == self.offset and
                getattr(index, "number", None) == self.number)

    def __repr__(self):
        return "Flac_CUESHEET_index(%r, %r)" % (self.offset, self.number)

    @classmethod
    def parse(cls, data):
        (offset, number) = struct.unpack(">QB", data[0:9])
        return cls(offset, number)

    def build(self):
        return struct.pack(">QB", self.offset, self.number) + b"\x00" * 3


class Flac_PICTURE(Image):
    """a PICTURE block: an Image with the FLAC picture type"""

    BLOCK_ID = 6

    def __init__(self, picture_type, mime_type, description, width, height,
                 color_depth, color_count, data):
        self.picture_type = picture_type
        Image.__init__(self, data=data, mime_type=mime_type, width=width,
                       height=height, color_depth=color_depth,
                       color_count=color_count, description=description,
                       # front cover, back cover, leaflet page, media
                       type={3: 0, 4: 1, 5: 2, 6: 3}.get(picture_type, 4))

    def __repr__(self):
        return ("Flac_PICTURE(picture_type=%r, mime_type=%r, width=%r, "
                "height=%r)" % (self.picture_type, self.mime_type,
                                self.width, self.height))

    @classmethod
    def parse(cls, data):
        (picture_type, length) = struct.unpack(">II", data[0:8])
        mime_type = bytes(data[8:8 + length]).decode("ascii", "replace")
        pos = 8 + length
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        description = bytes(data[pos + 4:pos + 4 + length]).decode(
            "utf-8", "replace")
        pos += 4 + length
        (width, height, color_depth, color_count, length) = struct.unpack(
            ">5I", data[pos:pos + 20])
        return cls(picture_type, mime_type, description, width, height,
                   color_depth, color_count,
                   bytes(data[pos + 20:pos + 20 + length]))

    def build(self):
        mime = self.mime_type.encode("ascii")
        description = self.description.encode("utf-8")
        return (struct.pack(">II", self.picture_type, len(mime)) + mime +
                struct.pack(">I", len(description)) + description +
                struct.pack(">5I", self.width, self.height, self.color_depth,
                            self.color_count, len(self.data)) + self.data)

    def size(self):
        return (32 + len(self.mime_type.encode("ascii")) +
                len(self.description.encode("utf-8")) + len(self.data))

    def clean(self):
        """a (Flac_PICTURE, fixes) pair, the MIME type and metrics taken
        from the image's own bytes where they differ"""
        from ..meta.image import image_metrics
        img = image_metrics(self.data)
        if (self.mime_type != img.mime_type or self.width != img.width or
                self.height != img.height or
                self.color_depth != img.bits_per_pixel or
                self.color_count != img.color_count):
            return (Flac_PICTURE(self.picture_type, img.mime_type,
                                 self.description, img.width, img.height,
                                 img.bits_per_pixel, img.color_count,
                                 self.data),
                    [text.CLEAN_FIX_IMAGE_FIELDS])
        return (self, [])

    @classmethod
    def converted(cls, image):
        """a Flac_PICTURE of an Image"""
        return cls(picture_type={0: 3, 1: 4, 2: 5, 3: 6}.get(image.type, 0),
                   mime_type=image.mime_type, description=image.description,
                   width=image.width, height=image.height,
                   color_depth=image.color_depth,
                   color_count=image.color_count, data=image.data)

    def raw_info(self):
        return "\n".join(
            ["PICTURE:",
             "  picture type = %d" % (self.picture_type,),
             "  MIME type    = %s" % (self.mime_type,),
             "  width        = %d" % (self.width,),
             "  height       = %d" % (self.height,),
             "  color depth  = %d" % (self.color_depth,),
             "  color count  = %d" % (self.color_count,),
             "  bytes        = %d" % (len(self.data),)])


BLOCK_CLASSES = {block.BLOCK_ID: block for block in (
    Flac_STREAMINFO, Flac_PADDING, Flac_APPLICATION, Flac_SEEKTABLE,
    Flac_VORBISCOMMENT, Flac_CUESHEET, Flac_PICTURE)}


class FlacMetaData(MetaData):
    """a FLAC file's metadata blocks, in file order: a MetaData whose
    fields are its VORBIS_COMMENT block's and whose images are its
    PICTURE blocks"""

    def __init__(self, blocks):
        self.__dict__["block_list"] = list(blocks)

    @classmethod
    def converted(cls, metadata):
        """a FlacMetaData of another MetaData: copies of another
        FlacMetaData's blocks, else a VORBIS_COMMENT of its fields, a
        PICTURE for each image and 4096 bytes of PADDING"""
        if metadata is None:
            return None
        if isinstance(metadata, FlacMetaData):
            return cls([type(b).parse(b.build()) for b in metadata.block_list])
        return cls([Flac_VORBISCOMMENT.converted(metadata)] +
                   [Flac_PICTURE.converted(image)
                    for image in metadata.images()] +
                   [Flac_PADDING(4096)])

    def has_block(self, block_id):
        """True if a block of the given ID is present"""
        return any(b.BLOCK_ID == block_id for b in self.block_list)

    def add_block(self, block):
        """adds the block in ascending ID order, PADDING last"""
        if block.BLOCK_ID != Flac_PADDING.BLOCK_ID:
            for (i, b) in enumerate(self.block_list):
                if (b.BLOCK_ID > block.BLOCK_ID or
                        b.BLOCK_ID == Flac_PADDING.BLOCK_ID):
                    self.block_list.insert(i, block)
                    return
        self.block_list.append(block)

    def get_block(self, block_id):
        """the first block of the given ID; raises IndexError if none"""
        for block in self.block_list:
            if block.BLOCK_ID == block_id:
                return block
        raise IndexError(block_id)

    def get_blocks(self, block_id):
        """every block of the given ID, in order"""
        return [b for b in self.block_list if b.BLOCK_ID == block_id]

    def replace_blocks(self, block_id, blocks):
        """replaces every block of the given ID with ``blocks``, at the
        first one's place (added in ID order if there was none)"""
        new_blocks = []
        inserted = False
        for block in self.block_list:
            if block.BLOCK_ID == block_id:
                if not inserted:
                    new_blocks.extend(blocks)
                    inserted = True
            else:
                new_blocks.append(block)
        if not inserted:
            for block in blocks:
                self.add_block(block)
            return
        self.__dict__["block_list"] = new_blocks

    def __repr__(self):
        return "FlacMetaData(%r)" % (self.block_list,)

    def __getattr__(self, attr):
        if attr in MetaData.FIELDS:
            try:
                return getattr(self.get_block(Flac_VORBISCOMMENT.BLOCK_ID),
                               attr)
            except IndexError:
                return None
        try:
            return self.__dict__[attr]
        except KeyError:
            raise AttributeError(attr)

    def __setattr__(self, attr, value):
        if attr in MetaData.FIELDS:
            try:
                vorbis_comment = self.get_block(Flac_VORBISCOMMENT.BLOCK_ID)
            except IndexError:
                vorbis_comment = Flac_VORBISCOMMENT([], VENDOR_STRING)
                self.add_block(vorbis_comment)
            setattr(vorbis_comment, attr, value)
        else:
            self.__dict__[attr] = value

    def __delattr__(self, attr):
        if attr in MetaData.FIELDS:
            try:
                delattr(self.get_block(Flac_VORBISCOMMENT.BLOCK_ID), attr)
            except IndexError:
                pass
        else:
            try:
                del self.__dict__[attr]
            except KeyError:
                raise AttributeError(attr)

    def images(self):
        return self.get_blocks(Flac_PICTURE.BLOCK_ID)

    def add_image(self, image):
        self.add_block(Flac_PICTURE.converted(image))

    def delete_image(self, image):
        self.replace_blocks(Flac_PICTURE.BLOCK_ID,
                            [p for p in self.images() if p != image])

    def clean(self):
        """a (FlacMetaData, fixes) pair: the VORBIS_COMMENT and SEEKTABLE
        blocks cleaned, and a second STREAMINFO, VORBIS_COMMENT or
        SEEKTABLE block dropped"""
        fixes_performed = []
        new_blocks = []
        seen = set()
        for block in self.block_list:
            if block.BLOCK_ID == Flac_VORBISCOMMENT.BLOCK_ID:
                if block.BLOCK_ID in seen:
                    fixes_performed.append(
                        text.CLEAN_FLAC_MULTIPLE_VORBISCOMMENT)
                    continue
                (cleaned, fixes) = block.clean()
                fixes_performed.extend(fixes)
                new_blocks.append(Flac_VORBISCOMMENT(
                    cleaned.comment_strings, cleaned.vendor_string))
            elif block.BLOCK_ID == Flac_SEEKTABLE.BLOCK_ID:
                if block.BLOCK_ID in seen:
                    fixes_performed.append(text.CLEAN_FLAC_MULTIPLE_SEEKTABLE)
                    continue
                (cleaned, fixes) = block.clean()
                fixes_performed.extend(fixes)
                new_blocks.append(cleaned)
            elif (block.BLOCK_ID == Flac_STREAMINFO.BLOCK_ID and
                    block.BLOCK_ID in seen):
                fixes_performed.append(text.CLEAN_FLAC_MULTIPLE_STREAMINFO)
                continue
            else:
                new_blocks.append(block)
            seen.add(block.BLOCK_ID)
        return (FlacMetaData(new_blocks), fixes_performed)

    def raw_info(self):
        return os.linesep.join(b.raw_info() for b in self.block_list)

    @classmethod
    def parse(cls, file):
        """the blocks of a binary file positioned past the 'fLaC' marker
        (left at the first frame)"""
        blocks = []
        last = 0
        while not last:
            header = file.read(4)
            if len(header) != 4:
                raise InvalidFLAC("truncated FLAC metadata")
            (last, block_type) = (header[0] >> 7, header[0] & 0x7F)
            length = int.from_bytes(header[1:4], "big")
            if block_type not in BLOCK_CLASSES:
                raise InvalidFLAC("invalid FLAC metadata block type")
            body = file.read(length)
            if len(body) != length:
                raise InvalidFLAC("truncated FLAC metadata")
            blocks.append(BLOCK_CLASSES[block_type].parse(body))
        return cls(blocks)

    def _sized_blocks(self):
        return [b for b in self.block_list if b.size() < (1 << 24)]

    def build(self):
        """every block with its header, the last one flagged"""
        blocks = self._sized_blocks()
        out = []
        for (i, block) in enumerate(blocks):
            last = 0x80 if i == len(blocks) - 1 else 0
            out.append(bytes([last | block.BLOCK_ID]) +
                       block.size().to_bytes(3, "big"))
            out.append(block.build())
        return b"".join(out)

    def size(self):
        """the bytes of every block, headers included"""
        return sum(4 + b.size() for b in self._sized_blocks())


def seektable_from_offsets(offsets, seekpoint_interval):
    """a Flac_SEEKTABLE from the encoder's (byte_offset, pcm_frames)
    pairs, a seekpoint at the first frame starting at or past each
    multiple of ``seekpoint_interval`` PCM frames"""
    seekpoints = []
    current_pcm_frame = 0
    next_seekpoint = 0
    for (byte_offset, pcm_frames) in offsets:
        if current_pcm_frame >= next_seekpoint:
            seekpoints.append((current_pcm_frame, byte_offset, pcm_frames))
            next_seekpoint += seekpoint_interval
        current_pcm_frame += pcm_frames
    return Flac_SEEKTABLE(seekpoints)


# the containers whose chunks FLAC keeps as APPLICATION blocks: (the
# blocks' application ID, big-endian sizes, the format chunk's ID, the
# PCM chunk's ID, the PCM chunk's bytes between its size and the PCM)
RIFF = (b"riff", False, b"fmt ", b"data", 0)
AIFF = (b"aiff", True, b"COMM", b"SSND", 8)


def chunks_to_blocks(container, header, footer):
    """the APPLICATION blocks of a RIFF or AIFF container's header and
    footer (``container`` RIFF or AIFF): the prologue, each chunk, and
    the PCM chunk's header (AIFF's SSND with its offset and block-size
    words) as blocks in file order; returns (blocks, the PCM's size in
    bytes, the container's total size) and raises EncodingError for
    bytes that are no such container"""
    (application_id, big_endian, fmt_id, data_id, data_header_extra) = \
        container
    order = ">" if big_endian else "<"
    if len(header) < 12:
        raise EncodingError("container header too short")
    (_magic, remaining, _form) = struct.unpack(order + "4sI4s", header[0:12])
    blocks = [Flac_APPLICATION(application_id, header[0:12])]
    total_size = remaining + 8
    pos = 12
    fmt_found = False
    data_chunk_size = None
    while pos < len(header):
        if pos + 8 > len(header):
            raise EncodingError("truncated container chunk")
        (chunk_id, chunk_size) = struct.unpack(order + "4sI",
                                               header[pos:pos + 8])
        if not all(0x20 <= b <= 0x7E for b in chunk_id):
            raise EncodingError("invalid container chunk ID")
        if chunk_id == data_id:
            end = pos + 8 + data_header_extra
            if end != len(header):
                raise EncodingError(
                    "unexpected data after the PCM chunk header")
            if not fmt_found:
                raise EncodingError("no format chunk in header")
            blocks.append(Flac_APPLICATION(application_id, header[pos:end]))
            data_chunk_size = chunk_size - data_header_extra
            break
        padded = chunk_size + (chunk_size % 2)
        chunk = header[pos:pos + 8 + padded]
        if len(chunk) != 8 + padded:
            raise EncodingError("truncated container chunk")
        if chunk_id == fmt_id:
            if fmt_found:
                raise EncodingError("multiple format chunks")
            fmt_found = True
        blocks.append(Flac_APPLICATION(application_id, chunk))
        pos += 8 + padded
    if data_chunk_size is None:
        raise EncodingError("no PCM data chunk in header")

    fpos = data_chunk_size % 2      # past the PCM chunk's pad byte
    while fpos < len(footer):
        if fpos + 8 > len(footer):
            raise EncodingError("truncated container footer")
        (chunk_id, chunk_size) = struct.unpack(order + "4sI",
                                               footer[fpos:fpos + 8])
        if not all(0x20 <= b <= 0x7E for b in chunk_id):
            raise EncodingError("invalid container chunk ID")
        if chunk_id in (fmt_id, data_id):
            raise EncodingError("duplicate %s chunk in footer" %
                                (chunk_id.decode("ascii"),))
        padded = chunk_size + (chunk_size % 2)
        chunk = footer[fpos:fpos + 8 + padded]
        if len(chunk) != 8 + padded:
            raise EncodingError("truncated container footer")
        blocks.append(Flac_APPLICATION(application_id, chunk))
        fpos += 8 + padded
    return (blocks, data_chunk_size, total_size)


class FlacAudio(WaveContainer, AiffContainer):
    """a Free Lossless Audio Codec file, encoded and decoded on a torch
    device

    device: "cuda" (raises when no card is usable) or "cpu" (the
    kernels' plain versions, for tests); ``to_pcm`` decodes there."""

    SUFFIX = "flac"
    NAME = SUFFIX
    DESCRIPTION = "Free Lossless Audio Codec"
    COMPRESSION_MODES = tuple(map(str, range(0, 9)))
    COMPRESSION_DESCRIPTIONS = {"0": text.COMP_FLAC_0, "8": text.COMP_FLAC_8}
    DEFAULT_COMPRESSION = "8"

    # the reference's exact per-level options
    COMPRESSION_OPTIONS = {
        "0": {"block_size": 1152, "max_lpc_order": 0,
              "min_residual_partition_order": 0,
              "max_residual_partition_order": 3},
        "1": {"block_size": 1152, "max_lpc_order": 0,
              "adaptive_mid_side": True,
              "min_residual_partition_order": 0,
              "max_residual_partition_order": 3},
        "2": {"block_size": 1152, "max_lpc_order": 0,
              "exhaustive_model_search": True,
              "min_residual_partition_order": 0,
              "max_residual_partition_order": 3},
        "3": {"block_size": 4096, "max_lpc_order": 6,
              "min_residual_partition_order": 0,
              "max_residual_partition_order": 4},
        "4": {"block_size": 4096, "max_lpc_order": 8,
              "adaptive_mid_side": True,
              "min_residual_partition_order": 0,
              "max_residual_partition_order": 4},
        "5": {"block_size": 4096, "max_lpc_order": 8,
              "mid_side": True,
              "min_residual_partition_order": 0,
              "max_residual_partition_order": 5},
        "6": {"block_size": 4096, "max_lpc_order": 8,
              "mid_side": True,
              "min_residual_partition_order": 0,
              "max_residual_partition_order": 6},
        "7": {"block_size": 4096, "max_lpc_order": 8,
              "mid_side": True, "exhaustive_model_search": True,
              "min_residual_partition_order": 0,
              "max_residual_partition_order": 6},
        "8": {"block_size": 4096, "max_lpc_order": 12,
              "mid_side": True, "exhaustive_model_search": True,
              "min_residual_partition_order": 0,
              "max_residual_partition_order": 6}}

    def __init__(self, filename, device="cuda"):
        WaveContainer.__init__(self, filename)
        self.device = resolve_device(device)
        try:
            with open(filename, "rb") as f:
                # the bytes up to the first block: the 'fLaC' marker,
                # behind any ID3v2 tags (stacked ones too)
                self.__stream_offset = skip_id3v2_comment(f) + 4
                if f.read(4) != b"fLaC":
                    raise InvalidFLAC("not a FLAC file (no 'fLaC' marker)")
                header = f.read(4)
                if len(header) != 4 or header[0] & 0x7F != 0:
                    raise InvalidFLAC("STREAMINFO block not found")
                self._streaminfo = Flac_STREAMINFO.parse(f.read(34))
        except OSError as err:
            raise InvalidFLAC(str(err)) from err

    def bits_per_sample(self):
        return self._streaminfo.bits_per_sample

    def channels(self):
        return self._streaminfo.channels

    def sample_rate(self):
        return self._streaminfo.sample_rate

    def total_frames(self):
        return self._streaminfo.total_samples

    def channel_mask(self):
        """the WAVEFORMATEXTENSIBLE_CHANNEL_MASK comment's mask, else the
        default layout of the channel count (0 above 6 channels)"""
        metadata = self.get_metadata()
        try:
            vorbis = metadata.get_block(Flac_VORBISCOMMENT.BLOCK_ID)
            return int(vorbis["WAVEFORMATEXTENSIBLE_CHANNEL_MASK"][0], 16)
        except (IndexError, KeyError, ValueError):
            pass
        channels = self.channels()
        return CHANNEL_MASKS[channels] if channels <= 6 else 0

    def _open_stream(self):
        """the file opened and positioned at its 'fLaC' marker (past any
        ID3v2 tags)"""
        f = open(self.filename, "rb")
        f.seek(self.__stream_offset - 4, 0)
        return f

    def get_metadata(self):
        """the file's FlacMetaData"""
        with self._open_stream() as f:
            if f.read(4) != b"fLaC":
                raise InvalidFLAC("not a FLAC file (no 'fLaC' marker)")
            return FlacMetaData.parse(f)

    def set_metadata(self, metadata):
        """writes ``metadata`` (any MetaData, converted) into the file, as
        the reference's set_metadata does: the file keeps its
        STREAMINFO, SEEKTABLE, CUESHEET and APPLICATION blocks, its
        vendor string and its channel mask comment, and a PADDING block
        is added where there is none"""
        if metadata is None:
            return
        new_metadata = FlacMetaData.converted(metadata)
        old_metadata = self.get_metadata()
        for block_id in (Flac_STREAMINFO.BLOCK_ID, Flac_SEEKTABLE.BLOCK_ID,
                         Flac_CUESHEET.BLOCK_ID, Flac_APPLICATION.BLOCK_ID):
            new_metadata.replace_blocks(block_id,
                                        old_metadata.get_blocks(block_id))
        old_vorbis = old_metadata.get_blocks(Flac_VORBISCOMMENT.BLOCK_ID)
        new_vorbis = new_metadata.get_blocks(Flac_VORBISCOMMENT.BLOCK_ID)
        if new_vorbis and old_vorbis:
            new_vorbis[0].__dict__["vendor_string"] = \
                old_vorbis[0].vendor_string
            if "WAVEFORMATEXTENSIBLE_CHANNEL_MASK" in old_vorbis[0]:
                new_vorbis[0]["WAVEFORMATEXTENSIBLE_CHANNEL_MASK"] = \
                    old_vorbis[0]["WAVEFORMATEXTENSIBLE_CHANNEL_MASK"]
        if not new_metadata.has_block(Flac_PADDING.BLOCK_ID):
            new_metadata.add_block(Flac_PADDING(4096))
        self.update_metadata(new_metadata)

    def delete_metadata(self):
        """an empty VORBIS_COMMENT block and no PICTURE blocks"""
        metadata = self.get_metadata()
        metadata.replace_blocks(Flac_VORBISCOMMENT.BLOCK_ID,
                                [Flac_VORBISCOMMENT([], VENDOR_STRING)])
        metadata.replace_blocks(Flac_PICTURE.BLOCK_ID, [])
        self.update_metadata(metadata)

    @classmethod
    def supports_replay_gain(cls):
        return True

    @classmethod
    def lossless_replay_gain(cls):
        return True

    @classmethod
    def can_add_replay_gain(cls, audiofiles):
        return all(isinstance(f, FlacAudio) for f in audiofiles)

    @classmethod
    def add_replay_gain(cls, filenames, progress=None, device="cuda"):
        """writes the REPLAYGAIN_* comments of the FLAC files named,
        analysed as one album on ``device``"""
        from ..dispatch import open_files
        from ..replaygain import calculate_replay_gain_values
        tracks = [t for t in open_files(filenames, device=device)
                  if isinstance(t, cls)]
        for (track, gain, peak, album_gain, album_peak) in \
                calculate_replay_gain_values(tracks, progress, device):
            metadata = track.get_metadata()
            try:
                vorbis = metadata.get_block(Flac_VORBISCOMMENT.BLOCK_ID)
            except IndexError:
                vorbis = Flac_VORBISCOMMENT([], VENDOR_STRING)
                metadata.add_block(vorbis)
            vorbis["REPLAYGAIN_TRACK_GAIN"] = ["%1.2f dB" % (gain,)]
            vorbis["REPLAYGAIN_TRACK_PEAK"] = ["%1.8f" % (peak,)]
            vorbis["REPLAYGAIN_ALBUM_GAIN"] = ["%1.2f dB" % (album_gain,)]
            vorbis["REPLAYGAIN_ALBUM_PEAK"] = ["%1.8f" % (album_peak,)]
            vorbis["REPLAYGAIN_REFERENCE_LOUDNESS"] = ["89.0 dB"]
            track.update_metadata(metadata)

    def replay_gain(self):
        """the REPLAYGAIN_* comments' ReplayGain, or None"""
        try:
            vorbis = self.get_metadata().get_block(
                Flac_VORBISCOMMENT.BLOCK_ID)
            return ReplayGain(
                vorbis["REPLAYGAIN_TRACK_GAIN"][0].split(" ")[0],
                vorbis["REPLAYGAIN_TRACK_PEAK"][0],
                vorbis["REPLAYGAIN_ALBUM_GAIN"][0].split(" ")[0],
                vorbis["REPLAYGAIN_ALBUM_PEAK"][0])
        except (IndexError, KeyError, ValueError, IOError):
            return None

    def update_metadata(self, metadata):
        """writes ``metadata``'s blocks back to the file: in place when
        they fit the old blocks' room (growing or shrinking the PADDING
        block to fill it), else the whole file is rewritten through a
        temporary file.  Any ID3v2 tags in front of the stream and
        whatever follows its last frame (an ID3v1 tag) are kept."""
        if not isinstance(metadata, FlacMetaData):
            raise ValueError("metadata not from audio file")
        offset = self.__stream_offset
        with open(self.filename, "rb") as f:
            stream_prefix = f.read(offset - 4)
            if f.read(4) != b"fLaC":
                raise InvalidFLAC("not a FLAC file (no 'fLaC' marker)")
            FlacMetaData.parse(f)
            frames_offset = f.tell()
        old_size = frames_offset - offset
        new_size = metadata.size()
        if metadata.has_block(Flac_PADDING.BLOCK_ID):
            padding = metadata.get_block(Flac_PADDING.BLOCK_ID)
            if new_size < old_size:
                padding.length += old_size - new_size
                new_size = old_size
            elif new_size > old_size and padding.length >= new_size - \
                    old_size:
                padding.length -= new_size - old_size
                new_size = old_size
        if new_size == old_size:
            with open(self.filename, "r+b") as f:
                f.seek(offset, 0)
                f.write(metadata.build())
            return
        with TemporaryFile(self.filename) as out, \
                open(self.filename, "rb") as f:
            out.write(stream_prefix + b"fLaC" + metadata.build())
            f.seek(frames_offset, 0)
            while True:
                chunk = f.read(0x100000)
                if not chunk:
                    break
                out.write(chunk)

    def get_cuesheet(self):
        """the CUESHEET block (its sheet_tracks at the file's sample
        rate), or None"""
        try:
            cuesheet = self.get_metadata().get_block(Flac_CUESHEET.BLOCK_ID)
        except IndexError:
            return None
        cuesheet.__sample_rate__ = self.sample_rate()
        return cuesheet

    def set_cuesheet(self, cuesheet):
        """writes a Sheet-like layout as the file's CUESHEET block"""
        if cuesheet is None:
            return
        metadata = self.get_metadata()
        metadata.replace_blocks(
            Flac_CUESHEET.BLOCK_ID,
            [Flac_CUESHEET.converted(cuesheet, self.total_frames(),
                                     self.sample_rate())])
        self.update_metadata(metadata)

    def clean(self, output_filename=None):
        """the fixes the file's blocks need; with ``output_filename``, a
        copy of the file written there with its blocks cleaned"""
        (cleaned, fixes) = self.get_metadata().clean()
        if output_filename is not None:
            with open(self.filename, "rb") as old_file, \
                    open(output_filename, "wb") as new_file:
                new_file.write(old_file.read())
            FlacAudio(output_filename, self.device).update_metadata(cleaned)
        return fixes

    def _foreign_blocks(self, application_id):
        return [b for b in
                self.get_metadata().get_blocks(Flac_APPLICATION.BLOCK_ID)
                if b.application_id == application_id]

    def has_foreign_wave_chunks(self):
        """True when the file holds APPLICATION "riff" blocks"""
        return len(self._foreign_blocks(RIFF[0])) > 0

    def has_foreign_aiff_chunks(self):
        """True when the file holds APPLICATION "aiff" blocks"""
        return len(self._foreign_blocks(AIFF[0])) > 0

    def _header_footer(self, container):
        """the container's header and footer reassembled from its
        APPLICATION blocks: those up to the PCM chunk's header, then the
        rest (after the PCM chunk's pad byte, where its size is odd)"""
        (application_id, _big_endian, _fmt_id, data_id, _extra) = container
        blocks = self._foreign_blocks(application_id)
        if not blocks:
            raise ValueError("no foreign %s chunks"
                             % (application_id.decode("ascii"),))
        data_bytes = (self.total_frames() * self.channels() *
                      (self.bits_per_sample() // 8))
        header = []
        footer = [b"\x00"] if data_bytes % 2 else []
        current = header
        for block in blocks:
            current.append(block.data)
            if block.data[0:4] == data_id:
                current = footer
        return (b"".join(header), b"".join(footer))

    def wave_header_footer(self):
        """the RIFF header and footer of the APPLICATION "riff" blocks"""
        return self._header_footer(RIFF)

    def aiff_header_footer(self):
        """the AIFF header and footer of the APPLICATION "aiff" blocks"""
        return self._header_footer(AIFF)

    @classmethod
    def _from_container(cls, container, filename, header, pcmreader, footer,
                        compression, device):
        """encodes a new file from a container's header, PCM and footer
        on ``device``, keeping every chunk as an APPLICATION block;
        raises EncodingError (and leaves no file) when the PCM is not
        the PCM chunk's size or the parts do not make the container's
        size"""
        (blocks, data_chunk_size, total_size) = chunks_to_blocks(
            container, header, footer)
        counter = CounterPCMReader(pcmreader)
        flac = cls.from_pcm(filename, counter, compression, device=device)
        data_written = counter.bytes_written()
        if data_written != data_chunk_size:
            _unlink(filename)
            raise EncodingError("PCM data size differs from the "
                                "container's data chunk")
        if len(header) + data_written + len(footer) != total_size:
            _unlink(filename)
            raise EncodingError("container size mismatch")
        metadata = flac.get_metadata()
        for block in blocks:
            metadata.add_block(block)
        flac.update_metadata(metadata)
        return flac

    @classmethod
    def from_wave(cls, filename, header, pcmreader, footer, compression=None,
                  device="cuda"):
        """encodes a new file from a WAVE's header, PCM and footer on
        ``device``, keeping every chunk as an APPLICATION "riff" block"""
        return cls._from_container(RIFF, filename, header, pcmreader, footer,
                                   compression, device)

    @classmethod
    def from_aiff(cls, filename, header, pcmreader, footer, compression=None,
                  device="cuda"):
        """encodes a new file from an AIFF's header, PCM and footer on
        ``device``, keeping every chunk as an APPLICATION "aiff" block
        (the SSND chunk's with its offset and block-size words)"""
        return cls._from_container(AIFF, filename, header, pcmreader, footer,
                                   compression, device)

    def to_pcm(self):
        """a TorchFlacDecoder of the file on the file's device (the
        STREAMINFO MD5 checked at the end of the stream), from its
        'fLaC' marker on"""
        from ..codecs.flac_dec import TorchFlacDecoder
        channel_mask = self.channel_mask()
        f = self._open_stream()
        try:
            return TorchFlacDecoder(f, channel_mask, device=self.device)
        except BaseException:
            f.close()
            raise

    @classmethod
    def from_pcm(cls, filename, pcmreader, compression=None,
                 total_pcm_frames=None, device="cuda"):
        """encodes a new file from a PCMReader on ``device`` and returns
        it

        compression: one of COMPRESSION_MODES; None or any other value
        means the user's configured ``[Quality] flac``, else
        DEFAULT_COMPRESSION (a configured value that is no mode raises
        KeyError, as the reference's does).
        total_pcm_frames: the frame count when known ahead, which sizes
        the PADDING block to hold the seektable.  On any failure the
        partial file is removed and the error raised."""
        device = resolve_device(device)
        if compression not in cls.COMPRESSION_MODES:
            compression = (default_quality(cls.NAME) or
                           cls.DEFAULT_COMPRESSION)
        encoding_options = cls.COMPRESSION_OPTIONS[compression]
        try:
            if pcmreader.channels > 8:
                raise ValueError("unsupported channel count %d"
                                 % (pcmreader.channels,))
            mask = int(pcmreader.channel_mask)
            if mask == 0:
                channel_mask = (CHANNEL_MASKS[pcmreader.channels]
                                if pcmreader.channels <= 6 else 0)
            elif mask not in (0x0001, 0x0004, 0x0003, 0x0007, 0x0033,
                              0x0603, 0x0037, 0x0607, 0x003F, 0x060F):
                raise ValueError("unsupported channel mask 0x%X" % (mask,))
            else:
                channel_mask = mask

            interval = pcmreader.sample_rate * 10
            if total_pcm_frames is not None:
                expected_seekpoints = -(-total_pcm_frames // interval)
                padding_size = 4096 + 4 + expected_seekpoints * 18
            else:
                padding_size = 4096

            from ..codecs.flac_enc_fast import encode_flac_fast
            offsets = encode_flac_fast(
                filename, BufferedPCMReader(pcmreader),
                padding_size=padding_size, device=device,
                **encoding_options)
            flac = cls(filename, device)
            metadata = flac.get_metadata()
            metadata.add_block(seektable_from_offsets(offsets, interval))
            # record explicit channel masks for unusual layouts
            if ((pcmreader.channels > 2 or pcmreader.bits_per_sample > 16)
                    and channel_mask != 0):
                try:
                    vorbis = metadata.get_block(Flac_VORBISCOMMENT.BLOCK_ID)
                except IndexError:
                    vorbis = Flac_VORBISCOMMENT([], VENDOR_STRING)
                    metadata.add_block(vorbis)
                vorbis["WAVEFORMATEXTENSIBLE_CHANNEL_MASK"] = [
                    "0x%.4X" % (channel_mask,)]
            flac.update_metadata(metadata)
            return flac
        except BaseException:
            _unlink(filename)
            raise
        finally:
            pcmreader.close()


# the serial number of the one logical stream an Ogg FLAC file holds
OGG_SERIAL = 0x464C4143


class _OggFlacFrames:
    """a binary stream, for TorchFlacDecoder, of an Ogg FLAC file's FLAC
    stream: 'fLaC', its STREAMINFO as the last block, then the audio
    packets' frames, read from the file's pages as they are asked for.
    As in the reference's decoder, a page that is cut short, or whose
    capture pattern or CRC is bad, ends the stream: the decoder then
    finds it short of STREAMINFO's frame count."""

    def __init__(self, filename, header_packets, streaminfo):
        from ..ogg import PacketReader, PageReader
        self.file = open(filename, "rb")
        try:
            self.packets = PacketReader(PageReader(self.file))
            for _ in range(1 + header_packets):
                self.packets.read_packet()
        except BaseException:
            self.file.close()
            raise
        self.buffer = (b"fLaC" + bytes([0x80]) + (34).to_bytes(3, "big") +
                       streaminfo.build())
        self.eof = False
        self.position = 0

    def tell(self):
        """the bytes of the FLAC stream read so far"""
        return self.position

    def read(self, size):
        pieces = [self.buffer]
        have = len(self.buffer)
        while have < size and not self.eof:
            try:
                packet = self.packets.read_packet()
            except (IOError, ValueError):
                self.eof = True
                break
            pieces.append(packet)
            have += len(packet)
        data = b"".join(pieces)
        self.buffer = data[size:]
        self.position += min(size, len(data))
        return data[:size]

    def close(self):
        self.file.close()


class OggFlacAudio(FlacAudio):
    """a FLAC stream in an Ogg container, encoded and decoded on a
    torch device

    The first packet is 0x7F "FLAC", the mapping's version 1.0, the
    count of header packets that follow, 'fLaC' and the STREAMINFO
    block; each further header packet holds one metadata block, and
    each audio packet one FLAC frame, its pages' granule position the
    PCM frames up to its end.  ``from_pcm`` encodes with the port's
    ``encode_flac_fast`` on the file's device; ``to_pcm`` decodes the
    packets' frames with ``TorchFlacDecoder`` on it.  As the
    reference's: ``from_pcm`` takes DEFAULT_COMPRESSION where no valid
    mode is given (not the configured quality), ``set_metadata`` keeps
    the STREAMINFO block alone, and no MD5 is checked.  Unlike the
    reference's, ``update_metadata`` keeps the header packet count it
    wrote, so the object reads its new blocks back."""

    SUFFIX = "oga"
    NAME = "oggflac"
    DESCRIPTION = "Ogg FLAC"

    def __init__(self, filename, device="cuda"):
        from ..ogg import PacketReader, PageReader
        AudioFile.__init__(self, filename)
        self.device = resolve_device(device)
        try:
            with open(filename, "rb") as f:
                header = PacketReader(PageReader(f)).read_packet()
        except (IOError, ValueError) as err:
            raise InvalidFLAC(str(err)) from err
        if len(header) < 51 or header[0:5] != b"\x7FFLAC":
            raise InvalidFLAC("invalid Ogg FLAC header")
        self.__header_packets = (header[7] << 8) | header[8]
        self._streaminfo = Flac_STREAMINFO.parse(header[17:51])

    def get_metadata(self):
        """a FlacMetaData of the STREAMINFO block and the header packets'
        blocks"""
        from ..ogg import PacketReader, PageReader
        blocks = [self._streaminfo]
        with open(self.filename, "rb") as f:
            packets = PacketReader(PageReader(f))
            packets.read_packet()
            for _ in range(self.__header_packets):
                packet = packets.read_packet()
                block_type = packet[0] & 0x7F
                if block_type not in BLOCK_CLASSES:
                    raise InvalidFLAC("unsupported metadata block type")
                blocks.append(BLOCK_CLASSES[block_type].parse(
                    packet[4:4 + int.from_bytes(packet[1:4], "big")]))
        return FlacMetaData(blocks)

    def update_metadata(self, metadata):
        """rewrites the file with ``metadata``'s blocks as its header
        packets, then its audio pages, numbered on from them"""
        from ..ogg import PacketReader, PageReader, PageWriter
        if not isinstance(metadata, FlacMetaData):
            raise ValueError("metadata not from audio file")
        with open(self.filename, "rb") as f:
            packets = PacketReader(PageReader(f))
            for _ in range(1 + self.__header_packets):
                packets.read_packet()
            # each header packet starts a page, so the audio starts on
            # the page after the last header packet's
            serial = packets.page.bitstream_serial_number
            audio_pages = []
            while True:
                try:
                    audio_pages.append(packets.pagereader.read())
                except IOError:
                    break
        with TemporaryFile(self.filename) as out:
            writer = PageWriter(out)
            (seq, header_packets) = _write_oggflac_headers(
                writer, metadata, serial)
            for page in audio_pages:
                page.sequence_number = seq
                seq += 1
                writer.write(page)
        self.__header_packets = header_packets

    def set_metadata(self, metadata):
        """writes ``metadata`` (any MetaData, converted) as the file's
        blocks, the STREAMINFO block kept"""
        metadata = FlacMetaData.converted(metadata)
        if metadata is None:
            return
        metadata.replace_blocks(Flac_STREAMINFO.BLOCK_ID, [self._streaminfo])
        self.update_metadata(metadata)

    def delete_metadata(self):
        self.set_metadata(MetaData())

    def to_pcm(self):
        """a TorchFlacDecoder of the packets' frames on the file's device
        (no MD5 checked, as the reference checks none; the channel mask
        the default of the channel count, 0 above 6 channels)"""
        from ..codecs.flac_dec import TorchFlacDecoder
        stream = _OggFlacFrames(self.filename, self.__header_packets,
                                self._streaminfo)
        try:
            decoder = TorchFlacDecoder(stream, device=self.device)
        except BaseException:
            stream.close()
            raise
        decoder.md5sum = b"\x00" * 16
        channels = self.channels()
        decoder.channel_mask = CHANNEL_MASKS[channels] if channels <= 6 else 0
        return decoder

    def verify(self, progress=None, sink=None):
        """decodes the whole stream; raises InvalidFLAC on a page or
        frame error, or when it holds fewer frames than STREAMINFO
        announces"""
        try:
            return AudioFile.verify(self, progress, sink)
        except InvalidFile as err:
            if str(err) == "incorrect PCM frame count":
                raise InvalidFLAC("truncated Ogg FLAC stream") from err
            raise InvalidFLAC(str(err)) from err

    @classmethod
    def from_pcm(cls, filename, pcmreader, compression=None,
                 total_pcm_frames=None, device="cuda"):
        """encodes a new file from a PCMReader on ``device`` and returns
        it: the FLAC stream's STREAMINFO block in the header packets and
        a packet a frame.  compression: one of COMPRESSION_MODES, else
        DEFAULT_COMPRESSION; ``total_pcm_frames`` is not needed.  A
        failed encode raises EncodingError and writes no file."""
        from ..codecs.flac_enc_fast import encode_flac_fast
        from ..ogg import Page, PageWriter, packet_to_pages
        device = resolve_device(device)
        if compression not in cls.COMPRESSION_MODES:
            compression = cls.DEFAULT_COMPRESSION
        raw = io.BytesIO()
        try:
            offsets = encode_flac_fast(
                raw, BufferedPCMReader(pcmreader), padding_size=None,
                device=device, **cls.COMPRESSION_OPTIONS[compression])
        except (IOError, ValueError) as err:
            raise EncodingError(str(err)) from err
        finally:
            pcmreader.close()
        raw.seek(4, 0)
        metadata = FlacMetaData.parse(raw)
        frames_offset = raw.tell()
        flac_data = raw.getvalue()
        try:
            with open(filename, "wb") as output:
                writer = PageWriter(output)
                (seq, _header_packets) = _write_oggflac_headers(
                    writer, metadata, OGG_SERIAL)
                pages = []
                granule = 0
                ends = [o for (o, _frames) in offsets[1:]] + [
                    len(flac_data) - frames_offset]
                for ((start, pcm_frames), end) in zip(offsets, ends):
                    granule += pcm_frames
                    for page in packet_to_pages(
                            flac_data[frames_offset + start:
                                      frames_offset + end], OGG_SERIAL, seq):
                        page.granule_position = granule
                        pages.append(page)
                        seq += 1
                if not pages:
                    pages = [Page(False, False, False, 0, OGG_SERIAL, seq,
                                  [])]
                pages[-1].stream_end = True
                for page in pages:
                    writer.write(page)
        except IOError as err:
            _unlink(filename)
            raise EncodingError(str(err)) from err
        return cls(filename, device)


def _write_oggflac_headers(writer, metadata, serial):
    """writes the header packets of ``metadata`` (a FlacMetaData with a
    STREAMINFO block), each from a page of its own; returns (the next
    page's sequence number, the count of header packets after the
    first)"""
    from ..ogg import packet_to_pages
    streaminfo = metadata.get_block(Flac_STREAMINFO.BLOCK_ID)
    blocks = [b for b in metadata._sized_blocks()
              if b.BLOCK_ID != Flac_STREAMINFO.BLOCK_ID]
    first = (b"\x7FFLAC\x01\x00" + len(blocks).to_bytes(2, "big") +
             b"fLaC" + bytes([Flac_STREAMINFO.BLOCK_ID]) +
             streaminfo.size().to_bytes(3, "big") + streaminfo.build())
    pages = list(packet_to_pages(first, serial, 0))
    pages[0].stream_beginning = True
    for page in pages:
        writer.write(page)
    seq = len(pages)
    for (i, block) in enumerate(blocks, 1):
        last = 0x80 if i == len(blocks) else 0
        packet = (bytes([last | block.BLOCK_ID]) +
                  block.size().to_bytes(3, "big") + block.build())
        for page in packet_to_pages(packet, serial, seq):
            writer.write(page)
            seq += 1
    return (seq, len(blocks))


def _unlink(filename):
    try:
        os.unlink(filename)
    except OSError:
        pass
