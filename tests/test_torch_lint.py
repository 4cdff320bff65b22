"""The port's ``clean`` methods, ``delta.UndoDB`` and ``tracklint``
against the reference's: each tag type's fixes and cleaned tags from
untidy input like that of the reference's own ``clean`` tests
(``tests/test_reference_fixtures.py``): leading and trailing spaces,
leading zeroes, empty fields, duplicate blocks and items, a bad image
MIME type and misplaced seekpoints; then ``tracklint`` (report,
``--fix``, ``--db`` and ``--undo``) over a file of each class, the
reference's run in-process with ``-j``-less arguments and the port's
with ``--devices cpu``, as ``tests/test_torch_cli.py`` runs them.
Exact: no tolerance applies.

One difference is by design: the reference's ``ApeTag.clean`` raises
AttributeError on any tag with something to fix (a local variable hides
its ``text`` module), and so does its ``tracklint`` on such a TTA or
WavPack file; the port reports and makes the fixes.  Those cases hold
the reference to its raise and the port to the fixes spelled out.
"""

import os
import shutil
import time

import pytest
import torch

from audiotools_tpu import audiofile as ref_audiofile
from audiotools_tpu import delta as ref_delta
from audiotools_tpu import dispatch as ref_dispatch
from audiotools_tpu.bitstream import BitstreamRecorder as RefRecorder
from audiotools_tpu.formats import flac as ref_flac
from audiotools_tpu.meta import ape as ref_ape
from audiotools_tpu.meta import vorbiscomment as ref_vorbiscomment
from audiotools_tpu_torch import audiofile, delta, dispatch
from audiotools_tpu_torch.formats import flac
from audiotools_tpu_torch.meta import ape, vorbiscomment
from test_torch_cli import (CLOCK, REFERENCE_ENV, port_tool, read, ref_tool,
                            signal)
from test_torch_tags import full_metadata, png_bytes, ref_reader

torch.set_num_threads(1)

SR = 8000
# comment lists of the shapes tracklint meets
VORBIS_CASES = {
    "spaces": ["TITLE= A Title ", "ARTIST=Artist  ", "ALBUM=  Album",
               "COMMENT=fine"],
    "zeroes": ["TRACKNUMBER=01", "TRACKTOTAL=0012", "DISCNUMBER=002",
               "DISCTOTAL=03", "totaltracks=07"],
    "slashes": ["TRACKNUMBER= 03 / 012 ", "DISCNUMBER=1/02",
                "TRACKNUMBER=4/5"],
    "empty": ["TITLE=", "ARTIST=   ", "PERFORMER= x ", "UNKNOWN=  keep  ",
              "no equals sign", "ALBUM ARTIST=  aa"],
    "tidy": ["TITLE=Title", "TRACKNUMBER=3", "TRACKTOTAL=10"],
}
SEEKTABLES = {
    "misordered": [(0, 0, 4096), (8192, 500, 4096), (4096, 250, 4096),
                   (8192, 600, 4096), (12288, 900, 4096)],
    "placeholders": [(0, 0, 4096), (0xFFFFFFFFFFFFFFFF, 0, 0),
                     (4096, 100, 4096), (0xFFFFFFFFFFFFFFFF, 0, 0)],
    "tidy": [(0, 0, 4096), (4096, 100, 4096)],
}


def ref_body(block):
    recorder = RefRecorder(False)
    block.build(recorder)
    return recorder.data()


@pytest.mark.parametrize("case", sorted(VORBIS_CASES))
def test_vorbis_comment_clean_is_the_references(case):
    comments = VORBIS_CASES[case]
    (cleaned, fixes) = vorbiscomment.VorbisComment(
        comments, "vendor").clean()
    (ref_cleaned, ref_fixes) = ref_vorbiscomment.VorbisComment(
        comments, "vendor").clean()
    assert fixes == ref_fixes
    assert (cleaned.comment_strings, cleaned.vendor_string) == (
        ref_cleaned.comment_strings, ref_cleaned.vendor_string)
    assert bool(fixes) == (case != "tidy")
    for field in audiofile.MetaData.FIELDS:
        assert getattr(cleaned, field) == getattr(ref_cleaned, field), field
    (block, _fixes) = flac.Flac_VORBISCOMMENT(comments, "vendor").clean()
    assert isinstance(block, flac.Flac_VORBISCOMMENT)
    assert block.build() == ref_body(ref_flac.Flac_VORBISCOMMENT(
        ref_cleaned.comment_strings, "vendor"))


@pytest.mark.parametrize("case", sorted(SEEKTABLES))
def test_flac_seektable_clean_is_the_references(case):
    (cleaned, fixes) = flac.Flac_SEEKTABLE(SEEKTABLES[case]).clean()
    (ref_cleaned, ref_fixes) = ref_flac.Flac_SEEKTABLE(
        SEEKTABLES[case]).clean()
    assert fixes == ref_fixes
    assert cleaned.build() == ref_body(ref_cleaned)


def picture_cases():
    png = png_bytes(5, 3)
    return {"bad-mime": ("image/jpeg", 5, 3, 24, 0, png),
            "bad-size": ("image/png", 9, 9, 24, 0, png),
            "bad-depth": ("image/png", 5, 3, 8, 16, png),
            "tidy": ("image/png", 5, 3, 24, 0, png)}


@pytest.mark.parametrize("case", sorted(picture_cases()))
def test_flac_picture_clean_is_the_references(case):
    (mime, width, height, depth, count, data) = picture_cases()[case]
    (cleaned, fixes) = flac.Flac_PICTURE(3, mime, "cövér", width, height,
                                         depth, count, data).clean()
    (ref_cleaned, ref_fixes) = ref_flac.Flac_PICTURE(
        3, mime, "cövér", width, height, depth, count, data).clean()
    assert fixes == ref_fixes
    assert bool(fixes) == (case != "tidy")
    assert cleaned.build() == ref_body(ref_cleaned)


def untidy_blocks(module):
    """a block list with two STREAMINFOs, two VORBIS_COMMENTs and two
    SEEKTABLEs, the first misordered, and a PICTURE of a bad MIME type"""
    streaminfo = module.Flac_STREAMINFO(4096, 4096, 12, 3000, 8000, 2, 16,
                                        SR * 2, b"\x01" * 16)
    return [streaminfo,
            module.Flac_SEEKTABLE(SEEKTABLES["misordered"]),
            module.Flac_VORBISCOMMENT(VORBIS_CASES["spaces"] +
                                      VORBIS_CASES["zeroes"], "vendor"),
            module.Flac_PICTURE(3, "image/gif", "", 1, 1, 1, 1,
                                png_bytes(2, 2)),
            module.Flac_VORBISCOMMENT(["TITLE=second"], "vendor"),
            module.Flac_SEEKTABLE(SEEKTABLES["tidy"]),
            module.Flac_STREAMINFO(4096, 4096, 12, 3000, 8000, 2, 16,
                                   SR * 2, b"\x02" * 16),
            module.Flac_PADDING(100)]


def test_flac_metadata_clean_is_the_references():
    (cleaned, fixes) = flac.FlacMetaData(untidy_blocks(flac)).clean()
    (ref_cleaned, ref_fixes) = ref_flac.FlacMetaData(
        untidy_blocks(ref_flac)).clean()
    assert fixes == ref_fixes
    assert {"removed duplicate STREAMINFO", "removed duplicate seektable",
            "removed duplicate Vorbis comment block",
            "removed misordered seekpoint"} <= set(fixes)
    assert ([(b.BLOCK_ID, b.build()) for b in cleaned.block_list] ==
            [(b.BLOCK_ID, ref_body(b)) for b in ref_cleaned.block_list])


def test_metadata_clean_is_the_references():
    """the base class: a plain MetaData of the fields, no images, no
    fixes; ALAC's tags take it"""
    fields = dict(track_name=" x ", track_number=1, album_total=2,
                  comment="")
    (cleaned, fixes) = audiofile.MetaData(**fields).clean()
    (ref_cleaned, ref_fixes) = ref_audiofile.MetaData(**fields).clean()
    assert (fixes, ref_fixes) == ([], [])
    assert type(cleaned) is audiofile.MetaData
    for field in audiofile.MetaData.FIELDS:
        assert getattr(cleaned, field) == getattr(ref_cleaned, field)
    assert cleaned.images() == []


APE_UNTIDY = [("Title", " A Title "), ("Track", "01/012"), ("Media", "02"),
              ("Artist", ""), ("title", "duplicate"), ("Year", "2026  ")]
APE_FIXES = ["removed leading whitespace from Title",
             "removed trailing whitespace from Title",
             "removed leading zeroes from Track",
             "removed leading zeroes from Media",
             "removed empty field Artist",
             "removed duplicate tag title",
             "removed trailing whitespace from Year"]


def ape_tag(module, items):
    return module.ApeTag([module.ApeTagItem.string(k, v) for (k, v) in items]
                         + [module.ApeTagItem.binary("Cover Art (front)",
                                                     b"x\x00" + b"data")])


def test_ape_clean_reports_the_references_fixes():
    """a tidy tag cleans to itself in both packages; an untidy one makes
    the reference raise (its fault) and the port make each fix, in the
    reference's words"""
    tidy = [("Title", "A Title"), ("Track", "1/12"), ("Year", "2026")]
    (cleaned, fixes) = ape_tag(ape, tidy).clean()
    (ref_cleaned, ref_fixes) = ape_tag(ref_ape, tidy).clean()
    assert (fixes, ref_fixes) == ([], [])
    assert cleaned.build() == ref_cleaned.build() == ape_tag(ape,
                                                             tidy).build()
    with pytest.raises(AttributeError):
        ape_tag(ref_ape, APE_UNTIDY).clean()
    (cleaned, fixes) = ape_tag(ape, APE_UNTIDY).clean()
    assert sorted(fixes) == sorted(APE_FIXES)
    assert [(t.key, t.type, t.data) for t in cleaned.tags] == [
        ("Title", 0, b"A Title"), ("Track", 0, b"1/12"), ("Media", 0, b"2"),
        ("Year", 0, b"2026"), ("Cover Art (front)", 1, b"x\x00data")]
    assert (cleaned.track_number, cleaned.track_total,
            cleaned.album_number) == (1, 12, 2)


# the classes tracklint runs over, and the reference's name for each
CLASSES = ["flac", "alac", "tta", "wavpack", "wav", "shn"]


def untidy(path, name, tidy=False):
    """writes untidy tags into a tagged file of the reference, through
    the reference: FLAC's comments and a second seektable, APEv2 items;
    ``tidy`` leaves the APEv2 items clean (the reference's clean cannot
    report on them)"""
    track = ref_dispatch.open(path)
    if name == "flac":
        metadata = track.get_metadata()
        vorbis = metadata.get_block(4)
        vorbis.comment_strings.extend(VORBIS_CASES["spaces"] +
                                      VORBIS_CASES["zeroes"] + ["GENRE="])
        metadata.block_list.insert(
            2, ref_flac.Flac_SEEKTABLE(SEEKTABLES["misordered"]))
        track.update_metadata(metadata)
    elif name in ("tta", "wavpack"):
        track.update_metadata(ape_tag(ref_ape, [
            ("Title", "A Title"), ("Track", "1/12"), ("Year", "2026")]
            if tidy else APE_UNTIDY))


@pytest.fixture(scope="module")
def album(tmp_path_factory):
    """a file of each class (the tagged ones with every field and a
    cover, then untidy tags), written by the reference; and the same
    files with tidy APEv2 tags"""
    base = tmp_path_factory.mktemp("lint")
    paths = {}
    with pytest.MonkeyPatch.context() as mp:
        for (key, value) in REFERENCE_ENV.items():
            mp.setenv(key, value)
        mp.setattr(time, "time", lambda: CLOCK)
        for (k, name) in enumerate(CLASSES):
            cls = ref_dispatch.TYPE_MAP[name]
            path = str(base / ("t%d.%s" % (k + 1, cls.SUFFIX)))
            cls.from_pcm(path, ref_reader(signal(k + 1, SR // 4, SR)))
            cls(path).set_metadata(full_metadata(k + 1))
            paths[name] = path
            if name in ("tta", "wavpack"):
                tidy = str(base / ("tidy%d.%s" % (k + 1, cls.SUFFIX)))
                shutil.copy(path, tidy)
                untidy(tidy, name, tidy=True)
                paths[name + "-tidy"] = tidy
            untidy(path, name)
    return paths


def copies(album, tmp_path, name):
    """the class's file copied to ref/ and port/ under tmp_path: (ref
    path, port path), relative to tmp_path"""
    source = album[name]
    rel = os.path.basename(source)
    for side in ("ref", "port"):
        os.makedirs(str(tmp_path / side), exist_ok=True)
        shutil.copy(source, str(tmp_path / side / rel))
    return ("ref/" + rel, "port/" + rel)


REPORTED = ["flac", "alac", "wav", "shn", "tta-tidy", "wavpack-tidy"]


@pytest.mark.parametrize("name", REPORTED)
def test_tracklint_reports_the_references_lines(album, tmp_path,
                                                monkeypatch, name):
    monkeypatch.chdir(tmp_path)
    (ref_path, port_path) = copies(album, tmp_path, name)
    ref = ref_tool("tracklint", ref_path)
    port = port_tool("tracklint", port_path)
    assert port == (ref[0], ref[1], ref[2].replace("ref/", "port/"))
    assert port[0] == 0 and port[1] == ""
    assert bool(port[2]) == (name == "flac")
    assert read(port_path) == read(ref_path) == read(album[name])


@pytest.mark.parametrize("name", REPORTED)
def test_tracklint_fix_db_and_undo_are_the_references(album, tmp_path,
                                                      monkeypatch, name):
    """--fix --db writes the reference's file and a database either
    package undoes; --undo gives the old bytes back exactly; a second
    --undo finds no backup"""
    monkeypatch.chdir(tmp_path)
    (ref_path, port_path) = copies(album, tmp_path, name)
    ref = ref_tool("tracklint", "--fix", "--db", "ref.db", ref_path)
    port = port_tool("tracklint", "--fix", "--db", "port.db", port_path)
    assert port == (ref[0], ref[1], ref[2].replace("ref/", "port/"))
    assert read(port_path) == read(ref_path)
    assert (read(port_path) != read(album[name])) == (name == "flac")
    assert (dispatch.open(port_path, "cpu").clean() ==
            ref_dispatch.open(ref_path).clean())
    # each package undoes the other's database
    ref = ref_tool("tracklint", "--undo", "--db", "port.db", ref_path)
    port = port_tool("tracklint", "--undo", "--db", "ref.db", port_path)
    assert port == (ref[0], ref[1], ref[2].replace("ref/", "port/"))
    assert read(port_path) == read(ref_path) == read(album[name])
    # the rows hold both ways: the old file is taken forward again
    again = port_tool("tracklint", "--undo", "--db", "port.db", port_path)
    assert again == (0, "", "* %s: %s\n" % (
        port_path, "restored" if name == "flac" else "no stored backup"))


@pytest.mark.parametrize("name", ["tta", "wavpack"])
def test_tracklint_fixes_apev2_tags(album, tmp_path, monkeypatch, name):
    """where the reference's tracklint raises (its ApeTag.clean fault),
    the port reports each fix, makes them with --fix and undoes them"""
    monkeypatch.chdir(tmp_path)
    (ref_path, port_path) = copies(album, tmp_path, name)
    with pytest.raises(AttributeError):
        ref_tool("tracklint", ref_path)
    (code, stdout, stderr) = port_tool("tracklint", port_path)
    assert (code, stdout) == (0, "")
    assert sorted(stderr.splitlines()) == sorted(
        "* %s: %s" % (port_path, fix) for fix in APE_FIXES)
    (code, stdout, stderr) = port_tool("tracklint", "--fix", "--db", "u.db",
                                       port_path)
    assert (code, stdout) == (0, "")
    assert stderr.splitlines()[-1] == "* %s: fixed" % (port_path,)
    tag = dispatch.open(port_path, "cpu").get_metadata()
    assert tag.clean()[1] == []
    assert (tag.track_name, tag.track_number, tag.track_total,
            tag.album_number, tag.year, tag.artist_name) == (
        "A Title", 1, 12, 2, "2026", None)
    assert port_tool("tracklint", "--undo", "--db", "u.db", port_path) == (
        0, "", "* %s: restored\n" % (port_path,))
    assert read(port_path) == read(album[name])


def test_tracklint_undo_requires_a_database(tmp_path):
    path = str(tmp_path / "missing.flac")
    ref = ref_tool("tracklint", "--undo", path)
    assert port_tool("tracklint", "--undo", path) == ref == (
        1, "", "*** Error: --undo requires --db\n")


def test_flac_clean_writes_the_references_copy(album, tmp_path):
    """FlacAudio.clean and AudioFile.clean: the fixes, and with an
    output file the reference's cleaned copy, the source left alone"""
    source = album["flac"]
    track = flac.FlacAudio(source, "cpu")
    ref_track = ref_flac.FlacAudio(source)
    assert track.clean() == ref_track.clean()
    assert audiofile.AudioFile.clean(track) == ref_track.clean()
    (out, ref_out) = (str(tmp_path / "port.flac"), str(tmp_path / "ref.flac"))
    assert track.clean(out) == ref_track.clean(ref_out)
    assert read(out) == read(ref_out)
    assert read(source) == read(album["flac"])
    assert flac.FlacAudio(out, "cpu").clean() == []
    # the base class's copy through set_metadata: a TTA file's tags
    tta = dispatch.open(album["tta-tidy"], "cpu")
    copy = str(tmp_path / "copy.tta")
    assert audiofile.AudioFile.clean(tta, copy) == []
    assert read(copy) == read(album["tta-tidy"])


def test_undodb_round_trip(album, tmp_path):
    """patches of a FLAC fix and of ALAC's whole-file rewrite: the
    port's patches are the reference's, each database undoes the other's
    rows both ways, and an unknown file has no backup"""
    for name in ("flac", "alac"):
        old = read(album[name])
        new_path = str(tmp_path / ("new-" + os.path.basename(album[name])))
        shutil.copy(album[name], new_path)
        track = dispatch.open(new_path, "cpu")
        if name == "flac":
            track.set_metadata(track.get_metadata().clean()[0])
        else:
            track.set_metadata(audiofile.MetaData(track_name="Rewritten",
                                                  comment="x" * 300))
        new = read(new_path)
        assert new != old
        assert (delta.UndoDB.build_patch(old, new) ==
                ref_delta.UndoDB.build_patch(old, new))
        for (module, other) in ((delta, ref_delta), (ref_delta, delta)):
            db_path = str(tmp_path / ("%s-%s.db" % (name, module.__name__)))
            old_path = str(tmp_path / "old")
            with open(old_path, "wb") as f:
                f.write(old)
            db = module.UndoDB(db_path)
            db.add(old_path, new_path)
            db.close()
            db = other.UndoDB(db_path)
            assert db.undo(new_path)          # new -> old
            assert read(new_path) == old
            assert db.undo(new_path)          # old -> new
            assert read(new_path) == new
            db.close()
        db = delta.UndoDB(str(tmp_path / "empty.db"))
        assert not db.undo(new_path)
        db.close()
