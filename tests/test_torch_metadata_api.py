"""The port's tag helpers and the members below the tag classes against
the reference's, on the CPU.

Every tag class (the plain MetaData, VorbisComment and FLAC's
VORBIS_COMMENT block, FlacMetaData, ApeTag, the M4A meta atom, ID3v1,
ID3v2.2-2.4 and ID3CommentPair) is converted from the same MetaData in
both packages: a full set of fields, or some of them, with an image of
each of the five types or none.  ``front_covers``, ``back_covers``,
``leaflet_pages``, ``media_images``, ``other_images``,
``filled_fields``, ``empty_fields`` and ``intersection`` must give the
reference's answers.  So must ``ReplayGain``'s equality, ``ApeTag``'s
``get``, ``index``, ``in`` and ``total_size`` and its items'
``total_size`` and ``external``, VorbisComment's ``items`` and
``values``, the M4A atom tree's indexing, iteration, ``has_child``,
``remove_child``, ``child_offset`` and ``has_ilst_atom``, every FLAC
block's ``copy``, FlacMetaData's ``blocks`` and
``added_removed_blocks``, and the FLAC CUESHEET's ``track`` and
``image_formatted``.
"""

import pytest

from audiotools_tpu import audiofile as ref_audiofile
from audiotools_tpu.formats import flac as ref_flac
from audiotools_tpu.meta import ape as ref_ape
from audiotools_tpu.meta import id3 as ref_id3
from audiotools_tpu.meta import id3v1 as ref_id3v1
from audiotools_tpu.meta import m4a_atoms as ref_m4a_atoms
from audiotools_tpu.meta import vorbiscomment as ref_vorbiscomment
from audiotools_tpu_torch import audiofile
from audiotools_tpu_torch.formats import flac
from audiotools_tpu_torch.meta import ape, id3, id3v1, m4a_atoms
from audiotools_tpu_torch.meta import vorbiscomment
from test_torch_meta import FULL, png_bytes

PACKAGES = {
    "ref": dict(audiofile=ref_audiofile, flac=ref_flac, ape=ref_ape,
                id3=ref_id3, id3v1=ref_id3v1, m4a_atoms=ref_m4a_atoms,
                vorbiscomment=ref_vorbiscomment),
    "port": dict(audiofile=audiofile, flac=flac, ape=ape, id3=id3,
                 id3v1=id3v1, m4a_atoms=m4a_atoms,
                 vorbiscomment=vorbiscomment)}

TAGS = {
    "MetaData": lambda p, m: m,
    "VorbisComment": lambda p, m: p["vorbiscomment"].VorbisComment
    .converted(m),
    "Flac_VORBISCOMMENT": lambda p, m: p["flac"].Flac_VORBISCOMMENT
    .converted(m),
    "FlacMetaData": lambda p, m: p["flac"].FlacMetaData.converted(m),
    "ApeTag": lambda p, m: p["ape"].ApeTag.converted(m),
    "M4A_META_Atom": lambda p, m: p["m4a_atoms"].M4A_META_Atom.converted(m),
    "ID3v1Comment": lambda p, m: p["id3v1"].ID3v1Comment.converted(m),
    "ID3v22Comment": lambda p, m: p["id3"].ID3v22Comment.converted(m),
    "ID3v23Comment": lambda p, m: p["id3"].ID3v23Comment.converted(m),
    "ID3v24Comment": lambda p, m: p["id3"].ID3v24Comment.converted(m),
    "ID3CommentPair": lambda p, m: p["id3"].ID3CommentPair.converted(m),
}

SOME = dict(track_name="Ōne", track_number=3, artist_name="Ärtist",
            year="1999", comment="c")


def metadata(p, fields, image_types):
    af = p["audiofile"]
    images = [af.Image.new(png_bytes(2 + t, 1 + t), "image %d" % (t,), t)
              for t in image_types]
    return af.MetaData(images=images, **fields)


def images_of(images):
    return [(i.data, i.mime_type, i.width, i.height, i.description, i.type)
            for i in images]


def answers(tag, other):
    return {
        "front_covers": images_of(tag.front_covers()),
        "back_covers": images_of(tag.back_covers()),
        "leaflet_pages": images_of(tag.leaflet_pages()),
        "media_images": images_of(tag.media_images()),
        "other_images": images_of(tag.other_images()),
        "filled_fields": list(tag.filled_fields()),
        "empty_fields": list(tag.empty_fields()),
        "intersection": list(tag.intersection(other).filled_fields()),
        "intersection of itself": list(
            tag.intersection(tag).filled_fields()),
    }


@pytest.mark.parametrize("tag", sorted(TAGS))
@pytest.mark.parametrize("fields", ["full", "some", "none"])
@pytest.mark.parametrize("image_types", [(), (0, 1, 2, 3, 4), (0, 0, 4)])
def test_the_tag_helpers_are_the_references(tag, fields, image_types):
    values = {"full": FULL, "some": SOME, "none": {}}[fields]
    results = []
    for p in (PACKAGES["ref"], PACKAGES["port"]):
        converted = TAGS[tag](p, metadata(p, values, image_types))
        other = metadata(p, dict(SOME, track_name=values.get("track_name")),
                         ())
        results.append(answers(converted, other))
    assert results[0] == results[1]


@pytest.mark.parametrize("a,b", [((-1.5, 0.9, -2.0, 1.0),
                                  (-1.5, 0.9, -2.0, 1.0)),
                                 ((-1.5, 0.9, -2.0, 1.0),
                                  (-1.5, 0.9, -2.0, 0.99)),
                                 ((0, 0, 0, 0), None)])
def test_replay_gain_equality_is_the_references(a, b):
    def compare(af):
        rg = af.ReplayGain(*a)
        other = af.ReplayGain(*b) if b is not None else object()
        return (rg == other, rg != other, rg == rg)
    assert compare(audiofile) == compare(ref_audiofile)


def ape_tag(p):
    a = p["ape"]
    return a.ApeTag([a.ApeTagItem.string("Title", "Tïtle"),
                     a.ApeTagItem.binary("Cover Art (front)", b"\x00" * 9),
                     a.ApeTagItem.external("Link", b"http://example"),
                     a.ApeTagItem.string("Track", "2/5")],
                    contains_header=True, contains_footer=True)


@pytest.mark.parametrize("case", [
    ("get", lambda t: repr(t.get("Track", None))),
    ("get missing", lambda t: t.get("Nope", "default")),
    ("index", lambda t: [t.index(k) for k in ("Title", "Link", "Track")]),
    ("index missing", lambda t: t.index("Nope")),
    ("in", lambda t: ["Title" in t, "title" in t, "Nope" in t]),
    ("total_size", lambda t: t.total_size()),
    ("no header", lambda t: (setattr(t, "contains_header", False),
                             t.total_size())[1]),
    ("item sizes", lambda t: [item.total_size() for item in t.tags]),
    ("external", lambda t: [(item.type, item.read_only) for item in t.tags]),
    ("item equal", lambda t: [t.tags[0] == t.tags[0].copy(),
                              t.tags[0] == t.tags[1]]),
])
def test_ape_members_are_the_references(case):
    results = []
    for p in (PACKAGES["ref"], PACKAGES["port"]):
        try:
            results.append(("ok", case[1](ape_tag(p))))
        except Exception as err:
            results.append(("raise", type(err).__name__, str(err)))
    assert results[0] == results[1]


@pytest.mark.parametrize("comments", [
    ["TITLE=a", "ARTIST=b", "TITLE=c", "notakey", "comment=x=y"], []])
def test_vorbis_items_and_values_are_the_references(comments):
    def run(v):
        c = v.VorbisComment(comments, "vendor")
        return (sorted(c.items()), sorted(c.values()), sorted(c.keys()))
    assert run(vorbiscomment) == run(ref_vorbiscomment)


def atom_tree(m):
    leaf = m.M4A_Leaf_Atom
    return m.M4A_Tree_Atom(b"moov", [
        leaf(b"mvhd", b"\x00" * 12),
        m.M4A_Tree_Atom(b"trak", [leaf(b"tkhd", b"\x01" * 5),
                                  m.M4A_Tree_Atom(b"mdia", [
                                      leaf(b"mdhd", b"\x02" * 7)])]),
        leaf(b"udta", b"\x03" * 3)])


@pytest.mark.parametrize("case", [
    ("getitem", lambda t: t[b"udta"].data),
    ("getitem missing", lambda t: t[b"nope"]),
    ("iter", lambda t: [a.name for a in t]),
    ("has_child", lambda t: [t.has_child(b"trak"), t.has_child(b"mdia")]),
    ("remove_child", lambda t: (t.remove_child(b"trak"), t.remove_child(
        b"nope"), [a.name for a in t])[2]),
    ("child_offset", lambda t: [t.child_offset(b"udta"),
                                t.child_offset(b"trak", b"mdia", b"mdhd"),
                                t.child_offset(b"trak", b"tkhd")]),
    ("child_offset missing", lambda t: t.child_offset(b"trak", b"nope")),
    ("leaf equal", lambda t: [t[b"mvhd"] == t[b"mvhd"].copy(),
                              t[b"mvhd"] == t[b"udta"]]),
    ("build", lambda t: t.build()),
])
def test_m4a_atom_trees_are_the_references(case):
    results = []
    for m in (ref_m4a_atoms, m4a_atoms):
        try:
            results.append(("ok", case[1](atom_tree(m))))
        except Exception as err:
            results.append(("raise", type(err).__name__, str(err)))
    assert results[0] == results[1]


@pytest.mark.parametrize("fields", ["full", "none"])
def test_has_ilst_atom_is_the_references(fields):
    values = {"full": FULL, "none": {}}[fields]
    results = []
    for p in (PACKAGES["ref"], PACKAGES["port"]):
        meta = p["m4a_atoms"].M4A_META_Atom.converted(
            metadata(p, values, ()))
        before = meta.has_ilst_atom()
        meta.remove_child(b"ilst")
        results.append((before, meta.has_ilst_atom()))
    assert results[0] == results[1]


def flac_blocks(f):
    index = f.Flac_CUESHEET_index
    track = f.Flac_CUESHEET_track
    return [
        f.Flac_STREAMINFO(4096, 4096, 14, 9000, 44100, 2, 16, 123456,
                          b"\x05" * 16),
        f.Flac_PADDING(17),
        f.Flac_APPLICATION(b"riff", b"chunk"),
        f.Flac_SEEKTABLE([(0, 0, 4096), (441000, 900, 4096)]),
        f.Flac_VORBISCOMMENT(["TITLE=t", "ARTIST=a"], "vendor"),
        f.Flac_CUESHEET(b"1234567890123", 88200, 1, [
            track(0, 1, b"ABCDE1234567", 0, 0, [index(0, 1)]),
            track(588 * 100, 2, b"\x00" * 12, 0, 0,
                  [index(0, 0), index(588 * 7, 1)]),
            track(123456, 170, b"\x00" * 12, 0, 0, [])]),
        f.Flac_PICTURE(3, "image/png", "d", 2, 1, 24, 0, png_bytes(2, 1))]


def state(value):
    """a block's attributes, its nested blocks' too"""
    if hasattr(value, "__dict__"):
        return {k: state(v) for (k, v) in vars(value).items()}
    if isinstance(value, (list, tuple)):
        return [state(v) for v in value]
    return value


def test_flac_block_copies_are_the_references():
    results = []
    for f in (ref_flac, flac):
        out = []
        for block in flac_blocks(f):
            copied = block.copy()
            out.append((type(copied).__name__, copied is not block,
                        state(copied) == state(block)))
        results.append(out)
    assert results[0] == results[1]
    assert all(equal for (_, _, equal) in results[1])


def test_flac_metadata_blocks_are_the_references():
    results = []
    for f in (ref_flac, flac):
        meta = f.FlacMetaData(flac_blocks(f))
        results.append(([type(b).__name__ for b in meta.blocks()],
                        [type(b).__name__
                         for b in meta.added_removed_blocks()]))
    assert results[0] == results[1]


@pytest.mark.parametrize("number", [1, 2, 3, 170])
def test_flac_cuesheet_tracks_are_the_references(number):
    results = []
    for f in (ref_flac, flac):
        sheet = flac_blocks(f)[5]
        try:
            track = sheet.track(number)
            results.append((track.number(), track.ISRC(),
                            [(i.number(), i.offset())
                             for i in track.indexes()],
                            sheet.image_formatted()))
        except KeyError as err:
            results.append(("KeyError", str(err), sheet.image_formatted()))
    assert results[0] == results[1]
