"""ID3 tags in the port against the reference: ``meta/id3`` (ID3v2.2,
v2.3 and v2.4: text, user text, URL, comment and picture frames,
syncsafe sizes, v2.4's UTF-8 and UTF-16BE text, padding,
``read_id3v2_comment``), ``meta/id3v1`` (ID3v1 and v1.1) and
``ID3CommentPair``; ``converted`` from a plain MetaData, a
VorbisComment and an APEv2 tag, and ``clean``.  Each case builds or
parses the same tag with both packages and holds the port to the
reference's bytes, fields, ``raw_info``, ``str`` and fixes exactly (no
tolerance: tags are bytes and strings)."""

import io

import numpy as np
import pytest

from audiotools_tpu import audiofile as ref_audiofile
from audiotools_tpu.bitstream import BitstreamRecorder as RefRecorder
from audiotools_tpu.meta import ape as ref_ape
from audiotools_tpu.meta import id3 as ref_id3
from audiotools_tpu.meta import id3v1 as ref_id3v1
from audiotools_tpu.meta import vorbiscomment as ref_vorbiscomment
from audiotools_tpu_torch import audiofile
from audiotools_tpu_torch.bitstream import BitstreamReader, BitstreamRecorder
from audiotools_tpu_torch.meta import ape, id3, id3v1, vorbiscomment
from test_torch_meta import jpeg_bytes, png_bytes

V2 = ["ID3v22Comment", "ID3v23Comment", "ID3v24Comment"]

FIELDS = dict(track_name="Träck Näme", track_number=3, track_total=10,
              album_name="Album", artist_name="Artist",
              performer_name="Performer", composer_name="Composer",
              conductor_name="Conductor", media="CD", ISRC="USABC1234567",
              catalog="CAT-1", copyright="(c) 2024", publisher="Pub",
              year="2024", date="2024-05-06", album_number=1, album_total=2,
              comment="some comment")
UNICODE = dict(FIELDS, track_name="日本語 テスト", artist_name="Ærtist ∂")


def pair(name):
    return (getattr(id3, name), getattr(ref_id3, name))


def build(tag, recorder):
    rec = recorder(False)
    tag.build(rec)
    return rec.data()


def images(fields_side):
    """a PNG front cover and a JPEG back cover with a description"""
    (module, image_cls) = fields_side
    return [image_cls(png_bytes(16, 12), "image/png", 16, 12, 24, 0, "",
                      0),
            image_cls(jpeg_bytes(40, 30), "image/jpeg", 40, 30, 24, 0,
                      "back", 1)]


def metadata_pair(fields, with_images=True):
    port = audiofile.MetaData(**fields)
    ref = ref_audiofile.MetaData(**fields)
    if with_images:
        for image in images((audiofile, audiofile.Image)):
            port.add_image(image)
        for image in images((ref_audiofile, ref_audiofile.Image)):
            ref.add_image(image)
    return (port, ref)


def assert_same_tag(port, ref):
    """the same fields, images, raw_info and display"""
    for field in audiofile.MetaData.FIELDS:
        assert getattr(port, field) == getattr(ref, field), field
    assert port.raw_info() == ref.raw_info()
    assert str(port) == str(ref)
    assert [(i.data, i.mime_type, i.width, i.height, i.color_depth,
             i.color_count, i.description, i.type) for i in port.images()] \
        == [(i.data, i.mime_type, i.width, i.height, i.color_depth,
             i.color_count, i.description, i.type) for i in ref.images()]


def test_syncsafe_integers_are_the_references():
    rng = np.random.default_rng(3)
    for value in [0, 1, 127, 128, 0x3FFF, 0x4000, 0x0FFFFFFF] + \
            [int(v) for v in rng.integers(0, 1 << 28, 200)]:
        assert id3.encode_syncsafe32(value) == \
            ref_id3.encode_syncsafe32(value)
        assert id3.decode_syncsafe32(id3.encode_syncsafe32(value)) == value
    for raw in [int(v) for v in rng.integers(0, 1 << 32, 200,
                                             dtype=np.uint64)]:
        assert id3.decode_syncsafe32(raw) == ref_id3.decode_syncsafe32(raw)


@pytest.mark.parametrize("fields", [FIELDS, UNICODE],
                         ids=["latin1", "unicode"])
@pytest.mark.parametrize("name", V2)
def test_converted_tags_build_the_references_bytes(name, fields):
    """every field, a PNG and a JPEG cover: v2.2's PIC and 3-byte ids,
    v2.3's UTF-16 and v2.4's UTF-8 where latin-1 does not hold the
    text"""
    (cls, ref_cls) = pair(name)
    (port_md, ref_md) = metadata_pair(fields)
    tag = cls.converted(port_md)
    ref = ref_cls.converted(ref_md)
    data = build(tag, BitstreamRecorder)
    assert data == build(ref, RefRecorder)
    assert tag.size() == ref.size() == len(data)
    assert_same_tag(tag, ref)
    parsed = id3.read_id3v2_comment(io.BytesIO(data))
    ref_parsed = ref_id3.read_id3v2_comment(io.BytesIO(data))
    assert type(parsed) is cls
    assert_same_tag(parsed, ref_parsed)
    assert build(parsed, BitstreamRecorder) == data
    assert parsed.keys() == ref_parsed.keys()


def frames(name):
    """hand-made frame bodies of each kind, by class name (the same
    frames for the port's and the reference's modules)"""
    v22 = name == "ID3v22Comment"
    v24 = name == "ID3v24Comment"
    (title, user, url, comm, pic, other) = (
        (b"TT2", b"TXX", b"WXX", b"COM", b"PIC", b"XYZ") if v22 else
        (b"TIT2", b"TXXX", b"WXXX", b"COMM", b"APIC", b"PRIV"))
    bodies = [
        (title, b"\x00latin title\x00"),
        (b"TP1" if v22 else b"TPE1",
         b"\x01" + "ärtist".encode("utf-16") + b"\x00\x00"),
        (b"TRK" if v22 else b"TRCK", b"\x00" + b"04/12"),
        (user, b"\x00desc\x00value"),
        (url, b"\x00site\x00http://example.com/"),
        (b"WCM" if v22 else b"WCOM", b"http://example.com/buy"),
        (comm, b"\x00eng" + b"short\x00the comment text"),
        (comm, b"\x01eng" + "d".encode("utf-16") + b"\x00\x00" +
         "ü".encode("utf-16")),
        (pic, b"\x00" + (b"PNG" if v22 else b"image/png\x00") + b"\x03" +
         b"cover\x00" + png_bytes(7, 5)),
        (other, b"\x01\x02opaque\xff"),
    ]
    if v24:
        bodies += [(b"TALB", b"\x03" + "álbum ✓".encode("utf-8")),
                   (b"TCOM", b"\x02" + "cömposer".encode("utf-16-be")),
                   (b"TPE2", b"\x03one\x00two")]
    return bodies


def raw_tag(name, bodies, padding=0):
    """the bytes of an ID3v2 tag of ``bodies``, with ``padding`` zero
    bytes after the frames"""
    version = {"ID3v22Comment": 2, "ID3v23Comment": 3,
               "ID3v24Comment": 4}[name]
    out = b""
    for (frame_id, body) in bodies:
        if version == 2:
            out += frame_id + len(body).to_bytes(3, "big")
        elif version == 3:
            out += frame_id + len(body).to_bytes(4, "big") + b"\x00\x00"
        else:
            out += frame_id + id3.encode_syncsafe32(len(body)).to_bytes(
                4, "big") + b"\x00\x00"
        out += body
    out += b"\x00" * padding
    return (b"ID3" + bytes([version, 0, 0]) +
            id3.encode_syncsafe32(len(out)).to_bytes(4, "big") + out)


@pytest.mark.parametrize("padding", [0, 300])
@pytest.mark.parametrize("name", V2)
def test_frames_of_each_kind_parse_and_build_as_the_references(name,
                                                               padding):
    """text (latin-1, UTF-16 with a BOM, v2.4's UTF-8 and UTF-16BE and
    several strings), user text, URL frames, comments with a language
    and description, a picture, an unknown frame; a tag padded past
    its frames keeps its size"""
    data = raw_tag(name, frames(name), padding) + b"\xff\xfb audio"
    tag = id3.read_id3v2_comment(io.BytesIO(data))
    ref = ref_id3.read_id3v2_comment(io.BytesIO(data))
    assert type(tag).__name__ == type(ref).__name__ == name
    assert_same_tag(tag, ref)
    assert [type(f).__name__ for f in tag.frames] == \
        [type(f).__name__ for f in ref.frames]
    assert [f.raw_info() for f in tag.frames] == \
        [f.raw_info() for f in ref.frames]
    assert build(tag, BitstreamRecorder) == build(ref, RefRecorder)
    assert tag.total_size == ref.total_size
    for field in ("track_name", "track_number", "album_number"):
        setattr(tag, field, "7" if field != "track_name" else "Nëw")
        setattr(ref, field, "7" if field != "track_name" else "Nëw")
    assert build(tag, BitstreamRecorder) == build(ref, RefRecorder)


def test_a_frame_larger_than_127_bytes_has_a_syncsafe_size_in_v24():
    body = b"\x00" + b"x" * 300
    for name in V2[1:]:
        data = raw_tag(name, [(b"TIT2", body)])
        size_field = data[14:18]
        if name == "ID3v24Comment":
            assert size_field == id3.encode_syncsafe32(301).to_bytes(4, "big")
        else:
            assert size_field == (301).to_bytes(4, "big")
        tag = id3.read_id3v2_comment(io.BytesIO(data))
        assert tag.track_name == "x" * 300
        assert build(tag, BitstreamRecorder) == data


@pytest.mark.parametrize("name", V2)
def test_field_edits_are_the_references(name):
    """setting and deleting numbers keeps the other half of "N/T", as
    the reference's does; images added and deleted"""
    (cls, ref_cls) = pair(name)
    (port_md, ref_md) = metadata_pair(FIELDS)
    (tag, ref) = (cls.converted(port_md), ref_cls.converted(ref_md))
    steps = [("set", "track_number", 7), ("del", "track_number", None),
             ("set", "album_total", 5), ("del", "album_number", None),
             ("del", "track_total", None), ("set", "comment", "nëw"),
             ("del", "track_name", None), ("set", "year", 1999),
             ("del", "catalog", None), ("set", "track_total", 4)]
    for (op, field, value) in steps:
        for t in (tag, ref):
            if op == "set":
                setattr(t, field, value)
            else:
                delattr(t, field)
        assert build(tag, BitstreamRecorder) == build(ref, RefRecorder), \
            (op, field)
        assert_same_tag(tag, ref)
    tag.delete_image(tag.images()[0])
    ref.delete_image(ref.images()[0])
    assert build(tag, BitstreamRecorder) == build(ref, RefRecorder)
    with pytest.raises(KeyError):
        tag[b"NONE"]


V1_CASES = {
    # ID3v1.1: a 0 byte then the track number after a 28-byte comment
    "v1.1": b"TAG" + b"Title".ljust(30, b"\x00") +
            b"Artist".ljust(30, b"\x00") + b"Album".ljust(30, b"\x00") +
            b"1999" + b"a comment".ljust(28, b"\x00") + b"\x00\x07\x11",
    # ID3v1: a 30-byte comment, no track number
    "v1": b"TAG" + b"T\xe9tle".ljust(30, b" ") +
          b"Artist".ljust(30, b"\x00") + b"".ljust(30, b"\x00") +
          b"2001" + b"a comment that fills thirty b!" + b"\x02",
    # a track number byte of 0 and padding spaces
    "v1.1-zero": b"TAG" + b"  spaced  ".ljust(30, b"\x00") +
                 b"".ljust(30, b"\x00") + b"A".ljust(30, b"\x00") +
                 b"\x00\x00\x00\x00" + b"".ljust(28, b"\x00") +
                 b"\x00\x00\xff",
}


@pytest.mark.parametrize("case", sorted(V1_CASES))
def test_id3v1_parses_and_builds_as_the_references(case):
    data = b"\xff\xfb" + b"\x00" * 50 + V1_CASES[case]
    (tag, ref) = (id3v1.ID3v1Comment.parse(io.BytesIO(data)),
                  ref_id3v1.ID3v1Comment.parse(io.BytesIO(data)))
    assert_same_tag(tag, ref)
    assert repr(tag) == repr(ref)
    (out, ref_out) = (io.BytesIO(), io.BytesIO())
    tag.build(out)
    ref.build(ref_out)
    assert out.getvalue() == ref_out.getvalue()
    assert tag.size() == 128
    (fixed, fixes) = tag.clean()
    (ref_fixed, ref_fixes) = ref.clean()
    assert fixes == ref_fixes
    assert repr(fixed) == repr(ref_fixed)
    with pytest.raises(ValueError):
        id3v1.ID3v1Comment.parse(io.BytesIO(b"\x00" * 200))


@pytest.mark.parametrize("fields", [FIELDS, UNICODE],
                         ids=["latin1", "unicode"])
def test_id3v1_converted_is_the_references(fields):
    (port_md, ref_md) = metadata_pair(fields, with_images=False)
    (tag, ref) = (id3v1.ID3v1Comment.converted(port_md),
                  ref_id3v1.ID3v1Comment.converted(ref_md))
    (out, ref_out) = (io.BytesIO(), io.BytesIO())
    tag.build(out)
    ref.build(ref_out)
    assert out.getvalue() == ref_out.getvalue()
    assert_same_tag(tag, ref)
    for t in (tag, ref):
        t.track_number = 12
        t.composer_name = "dropped"
        del t.album_name
    assert_same_tag(tag, ref)


@pytest.mark.parametrize("name", V2)
def test_comment_pair_is_the_references(name):
    """converted with each ID3v2 class; reads prefer the ID3v2 half,
    writes and deletions go to both; clean joins both halves' fixes"""
    (cls, ref_cls) = pair(name)
    (port_md, ref_md) = metadata_pair(FIELDS)
    tag = id3.ID3CommentPair.converted(port_md, id3v2_class=cls)
    ref = ref_id3.ID3CommentPair.converted(ref_md, id3v2_class=ref_cls)
    assert type(tag.id3v2) is cls
    assert_same_tag(tag, ref)
    for t in (tag, ref):
        t.track_name = "  Spaced  "
        del t.artist_name
        del t.id3v2.album_name
    assert_same_tag(tag, ref)
    assert build(tag.id3v2, BitstreamRecorder) == \
        build(ref.id3v2, RefRecorder)
    (fixed, fixes) = tag.clean()
    (ref_fixed, ref_fixes) = ref.clean()
    assert fixes == ref_fixes and fixes
    assert_same_tag(fixed, ref_fixed)
    again = id3.ID3CommentPair.converted(tag)
    assert again is not tag and again.id3v2 is not tag.id3v2
    assert_same_tag(again, tag)
    # the default ID3v2 half is v2.3, as MP3's set_metadata writes
    assert type(id3.ID3CommentPair.converted(port_md).id3v2) is \
        id3.ID3v23Comment


def other_tags(fields):
    """(port tag, reference tag) pairs of a VorbisComment and an APEv2
    tag holding ``fields``"""
    (port_md, ref_md) = metadata_pair(fields, with_images=False)
    return [(vorbiscomment.VorbisComment.converted(port_md),
             ref_vorbiscomment.VorbisComment.converted(ref_md)),
            (ape.ApeTag.converted(port_md), ref_ape.ApeTag.converted(ref_md))]


@pytest.mark.parametrize("source", ["vorbiscomment", "ape"])
@pytest.mark.parametrize("name", V2 + ["ID3v1Comment", "ID3CommentPair"])
def test_converted_from_other_tags_is_the_references(name, source):
    (port_src, ref_src) = other_tags(FIELDS)[
        ["vorbiscomment", "ape"].index(source)]
    if name == "ID3v1Comment":
        (cls, ref_cls) = (id3v1.ID3v1Comment, ref_id3v1.ID3v1Comment)
    else:
        (cls, ref_cls) = pair(name)
    (tag, ref) = (cls.converted(port_src), ref_cls.converted(ref_src))
    assert_same_tag(tag, ref)
    if name in V2:
        assert build(tag, BitstreamRecorder) == build(ref, RefRecorder)
        # and back: the ID3 fields into the other format
        assert vorbiscomment.VorbisComment.converted(tag).comment_strings \
            == ref_vorbiscomment.VorbisComment.converted(ref).comment_strings


UNTIDY = [
    ("TIT2", ["  padded title "]),
    ("TRCK", ["03/010"]),
    ("TPOS", ["01"]),
    ("TPE1", [""]),
    ("TALB", ["album"]),
    ("TYER", [" 2001"]),
]


@pytest.mark.parametrize("name", V2)
def test_clean_fixes_are_the_references(name):
    """whitespace stripped, leading zeroes removed from the number
    pairs, empty text frames removed; a tidy tag needs no fix"""
    (cls, ref_cls) = pair(name)
    ids = {"ID3v22Comment": {"TIT2": b"TT2", "TRCK": b"TRK", "TPOS": b"TPA",
                             "TPE1": b"TP1", "TALB": b"TAL",
                             "TYER": b"TYE"}}.get(name)

    def frame_id(key):
        return ids[key] if ids else key.encode("ascii")

    tag = cls([id3.ID3TextFrame(frame_id(k), 0, v) for (k, v) in UNTIDY])
    ref = ref_cls([ref_id3.ID3TextFrame(frame_id(k), 0, v)
                   for (k, v) in UNTIDY])
    (fixed, fixes) = tag.clean()
    (ref_fixed, ref_fixes) = ref.clean()
    assert fixes == ref_fixes and len(fixes) >= 4
    assert build(fixed, BitstreamRecorder) == build(ref_fixed, RefRecorder)
    assert_same_tag(fixed, ref_fixed)
    assert fixed.clean()[1] == ref_fixed.clean()[1] == []


def test_stacked_tags_are_skipped_and_counted():
    (port_md, _ref_md) = metadata_pair(FIELDS, with_images=False)
    data = build(id3.ID3v23Comment.converted(port_md), BitstreamRecorder)
    stream = io.BytesIO(data + data + b"\xff\xfb")
    assert id3.total_id3v2_comments(stream) == 2
    assert id3.skip_id3v2_comment(stream) == 2 * len(data)
    assert stream.read(2) == b"\xff\xfb"


@pytest.mark.parametrize("data", [b"", b"TAG" + b"\x00" * 20,
                                  b"ID3\x05\x00\x00\x00\x00\x00\x00"],
                         ids=["empty", "no-tag", "version-5"])
def test_read_id3v2_comment_errors_are_the_references(data):
    with pytest.raises(ValueError) as err:
        id3.read_id3v2_comment(io.BytesIO(data))
    with pytest.raises(ValueError) as ref_err:
        ref_id3.read_id3v2_comment(io.BytesIO(data))
    assert str(err.value) == str(ref_err.value)
    # a tag of another version than its class's
    v3 = build(id3.ID3v23Comment([]), BitstreamRecorder)
    with pytest.raises(ValueError, match="major version"):
        id3.ID3v24Comment.parse(BitstreamReader(v3))
