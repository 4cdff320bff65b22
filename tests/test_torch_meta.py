"""The port's tag formats (``audiotools_tpu_torch/meta`` and the FLAC
blocks) against the reference's ``audiotools_tpu/meta``: the bytes each
builds from a full MetaData, the fields each parses from the
reference's bytes, ``converted`` between every pair of formats, and
``image_metrics`` of each image type.  Exact: no tolerance applies.
"""

import io
import struct
import zlib

import pytest

from audiotools_tpu import audiofile as ref_audiofile
from audiotools_tpu.bitstream import BitstreamReader as RefReader
from audiotools_tpu.bitstream import BitstreamRecorder as RefRecorder
from audiotools_tpu.formats import flac as ref_flac
from audiotools_tpu.meta import ape as ref_ape
from audiotools_tpu.meta import image as ref_image
from audiotools_tpu.meta import m4a_atoms as ref_m4a_atoms
from audiotools_tpu.meta import vorbiscomment as ref_vorbiscomment
from audiotools_tpu_torch import audiofile
from audiotools_tpu_torch.formats import flac
from audiotools_tpu_torch.meta import ape, image, m4a_atoms, vorbiscomment


def png_bytes(width, height, color_type=2, palette=0):
    """a PNG of width x height pixels, all zero (with a palette of
    ``palette`` entries for color type 3)"""
    def chunk(name, body):
        return (struct.pack(">I", len(body)) + name + body +
                struct.pack(">I", zlib.crc32(name + body)))
    channels = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}[color_type]
    rows = b"".join(b"\x00" + b"\x00" * (width * channels)
                    for _ in range(height))
    body = chunk(b"IHDR", struct.pack(">IIBBBBB", width, height, 8,
                                      color_type, 0, 0, 0))
    if palette:
        body += chunk(b"PLTE", b"\x10\x20\x30" * palette)
    return (b"\x89PNG\r\n\x1a\n" + body + chunk(b"IDAT", zlib.compress(rows))
            + chunk(b"IEND", b""))


def jpeg_bytes(width, height, components=3):
    """a JPEG header: SOI, an APP0 segment, then a baseline SOF0"""
    app0 = b"JFIF\x00\x01\x01\x00\x00\x01\x00\x01\x00\x00"
    sof = struct.pack(">BHHB", 8, height, width, components) + \
        b"\x01\x11\x00" * components
    return (b"\xff\xd8" + b"\xff\xe0" + struct.pack(">H", len(app0) + 2) +
            app0 + b"\xff\xc0" + struct.pack(">H", len(sof) + 2) + sof +
            b"\xff\xd9")


def gif_bytes(width, height, bits=3):
    return (b"GIF89a" + struct.pack("<HHBBB", width, height,
                                    0x80 | (bits - 1), 0, 0) +
            b"\x00" * (3 << bits) + b"\x3b")


def bmp_bytes(width, height, bpp=24, colors=0):
    return (b"BM" + struct.pack("<IHHI", 54, 0, 0, 54) +
            struct.pack("<IiiHHIIiiII", 40, width, -height, 1, bpp, 0, 0,
                        2835, 2835, colors, 0))


def tiff_bytes(width, height, endian="<", bps=8):
    magic = b"II*\x00" if endian == "<" else b"MM\x00*"
    entries = [(0x0100, 3, 1, width), (0x0101, 4, 1, height),
               (0x0102, 3, 1, bps), (0x0140, 3, 768, 0)]
    ifd = struct.pack(endian + "H", len(entries))
    for (tag, ftype, n, value) in entries:
        if ftype == 3:
            ifd += struct.pack(endian + "HHIHH", tag, ftype, n, value, 0)
        else:
            ifd += struct.pack(endian + "HHII", tag, ftype, n, value)
    return magic + struct.pack(endian + "I", 8) + ifd + b"\x00" * 4


IMAGES = {"png-rgb": png_bytes(3, 2),
          "png-gray": png_bytes(5, 1, color_type=0),
          "png-palette": png_bytes(2, 2, color_type=3, palette=7),
          "png-rgba": png_bytes(1, 4, color_type=6),
          "jpeg": jpeg_bytes(640, 480),
          "jpeg-gray": jpeg_bytes(17, 9, components=1),
          "gif": gif_bytes(20, 10),
          "bmp": bmp_bytes(33, 21),
          "bmp-palette": bmp_bytes(8, 8, bpp=8, colors=16),
          "tiff-le": tiff_bytes(12, 34),
          "tiff-be": tiff_bytes(56, 78, endian=">", bps=16)}


@pytest.mark.parametrize("name", sorted(IMAGES))
def test_image_metrics_are_the_references(name):
    got = image.image_metrics(IMAGES[name])
    want = ref_image.image_metrics(IMAGES[name])
    fields = ("width", "height", "bits_per_pixel", "color_count",
              "mime_type")
    assert ([getattr(got, f) for f in fields] ==
            [getattr(want, f) for f in fields])


def test_unknown_image_bytes_raise_as_the_references():
    with pytest.raises(image.InvalidImage) as got:
        image.image_metrics(b"not an image")
    with pytest.raises(ref_image.InvalidImage) as want:
        ref_image.image_metrics(b"not an image")
    assert str(got.value) == str(want.value)


FULL = dict(track_name="Tïtle – “one”", track_number=2, track_total=4,
            album_name="Àlbum", artist_name="Ärtist",
            performer_name="Pérformer", composer_name="Cömposer",
            conductor_name="Cönductor", media="CD", ISRC="USRC17607839",
            catalog="Çat-001", copyright="© 2026 Lïbel",
            publisher="Püblisher", year="2026", date="2026-10-17",
            album_number=1, album_total=1, comment="Cömment ∞")
COVER = png_bytes(4, 3)


def full(package):
    """the full MetaData of one package (``audiofile`` of the port or of
    the reference), a front cover among its images"""
    cover = package.Image.new(COVER, "cövér", 0)
    return package.MetaData(images=[cover], **FULL)


# each format's class, the port's and the reference's
FORMATS = {"vorbis": (vorbiscomment.VorbisComment,
                      ref_vorbiscomment.VorbisComment),
           "flac_vorbis": (flac.Flac_VORBISCOMMENT,
                           ref_flac.Flac_VORBISCOMMENT),
           "flac": (flac.FlacMetaData, ref_flac.FlacMetaData),
           "ape": (ape.ApeTag, ref_ape.ApeTag),
           "m4a": (m4a_atoms.M4A_META_Atom, ref_m4a_atoms.M4A_META_Atom)}


def ref_build(metadata):
    """a reference tag's bytes, built as its format builds them"""
    if isinstance(metadata, (ref_ape.ApeTag, ref_m4a_atoms.M4A_META_Atom)):
        return metadata.build()
    recorder = RefRecorder(False)
    metadata.build(recorder)
    return recorder.data()


def fields_of(metadata):
    """a MetaData's fields and its images' bytes and attributes"""
    return ([getattr(metadata, f) for f in audiofile.MetaData.FIELDS],
            [(i.data, i.mime_type, i.width, i.height, i.color_depth,
              i.color_count, i.description, i.type)
             for i in metadata.images()])


@pytest.mark.parametrize("name", ["flac_vorbis", "flac", "ape", "m4a"])
def test_a_full_metadata_builds_the_references_bytes(name):
    (cls, ref_cls) = FORMATS[name]
    got = cls.converted(full(audiofile)).build()
    assert got == ref_build(ref_cls.converted(full(ref_audiofile)))


def test_vorbis_comment_converts_to_the_references_comments():
    got = vorbiscomment.VorbisComment.converted(full(audiofile))
    want = ref_vorbiscomment.VorbisComment.converted(full(ref_audiofile))
    assert (got.comment_strings, got.vendor_string) == (
        want.comment_strings, want.vendor_string)
    assert fields_of(got) == fields_of(want)


def parse(name, data):
    """the port's tag of ``name`` parsed from bytes"""
    if name == "flac_vorbis":
        return flac.Flac_VORBISCOMMENT.parse(data)
    if name == "flac":
        return flac.FlacMetaData.parse(io.BytesIO(data))
    if name == "ape":
        return ape.ApeTag.read(io.BytesIO(data))
    [atom] = m4a_atoms.parse_atoms(data)
    return atom


@pytest.mark.parametrize("name", ["flac_vorbis", "flac", "ape", "m4a"])
def test_the_references_bytes_parse_to_its_fields(name):
    (_cls, ref_cls) = FORMATS[name]
    want = ref_cls.converted(full(ref_audiofile))
    got = parse(name, ref_build(want))
    assert fields_of(got) == fields_of(want)
    assert got.build() == ref_build(want)
    assert got.raw_info() == want.raw_info()
    assert str(got) == str(want)


@pytest.mark.parametrize("source", sorted(FORMATS))
@pytest.mark.parametrize("target", sorted(FORMATS))
def test_converted_between_formats_gives_the_references_fields(source,
                                                                 target):
    got = FORMATS[target][0].converted(
        FORMATS[source][0].converted(full(audiofile)))
    want = FORMATS[target][1].converted(
        FORMATS[source][1].converted(full(ref_audiofile)))
    assert fields_of(got) == fields_of(want)
    assert type(got).__name__ == type(want).__name__


@pytest.mark.parametrize("name", ["vorbis", "ape", "m4a"])
def test_field_edits_are_the_references(name):
    """setting and deleting numbers and text on a converted tag: the
    slashed number pairs and the ilst trkn/disk pairs"""
    (cls, ref_cls) = FORMATS[name]
    (got, want) = (cls.converted(full(audiofile)),
                   ref_cls.converted(full(ref_audiofile)))
    for tag in (got, want):
        tag.track_number = 7
        del tag.track_total
        tag.album_total = 3
        del tag.artist_name
        tag.comment = "nüw"
    assert fields_of(got) == fields_of(want)
    if name != "vorbis":
        assert got.build() == want.build()


def test_flac_picture_and_application_blocks_round_trip():
    picture = flac.Flac_PICTURE.converted(audiofile.Image.new(COVER, "d", 1))
    application = flac.Flac_APPLICATION(b"riff", b"LIST\x04\x00\x00\x00abcd")
    blocks = flac.FlacMetaData([picture, application, flac.Flac_PADDING(3)])
    data = blocks.build()
    ref = ref_flac.FlacMetaData.parse(RefReader(
        io.BytesIO(data), False))
    assert ref_build(ref) == data
    again = parse("flac", data)
    assert again.block_list == blocks.block_list
    assert again.images()[0].type == 1 and again.images()[0].picture_type == 4


def test_flac_cuesheet_blocks_parse_and_build_to_equal_bytes():
    """the CUESHEET body laid out by hand: a catalog number, a CD-DA
    track of two indexes and the lead-out"""
    def track(offset, number, isrc, indexes):
        return (struct.pack(">QB", offset, number) + isrc + b"\x00" * 14 +
                bytes([len(indexes)]) +
                b"".join(struct.pack(">QB", o, n) + b"\x00" * 3
                         for (o, n) in indexes))
    body = (b"1234567890123".ljust(128, b"\x00") +
            struct.pack(">QB", 88200, 0x80) + b"\x00" * 258 + bytes([2]) +
            track(0, 1, b"USRC17607839", [(0, 1), (588 * 30, 2)]) +
            track(441000, 170, b"\x00" * 12, []))
    sheet = flac.Flac_CUESHEET.parse(body)
    assert sheet.build() == body and sheet.size() == len(body)
    assert (sheet.catalog(), sheet.lead_in_samples, sheet.is_cdda) == (
        "1234567890123", 88200, 1)
    assert [(t.number, t.track_offset, len(t.index_points))
            for t in sheet.tracks] == [(1, 0, 2), (170, 441000, 0)]
    ref = ref_flac.Flac_CUESHEET.parse(RefReader(
        io.BytesIO(body), False))
    assert ref.catalog() == sheet.catalog()
    assert [(t.number, t.track_offset, [(i.offset, i.number)
                                         for i in t.index_points])
            for t in ref.tracks] == [
        (t.number, t.track_offset, [(i.offset, i.number)
                                    for i in t.index_points])
        for t in sheet.tracks]
