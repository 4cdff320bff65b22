"""tracktag, trackrename, coverdump and covertag of
``audiotools_tpu_torch.cli`` (with ``--devices cpu``) against those of
``audiotools_tpu.cli``, in-process as ``tests/test_torch_cli.py`` runs
them, over copies of one album written and tagged by the reference:
FLAC, ALAC, TTA and WavPack tracks of 0.25 s at 8 kHz (short enough for
the plain TTA, ALAC and WavPack loops), each tagged with every field and
a PNG front cover.  Each case runs both tools on their own copy.

Files, names, lines and exit codes must be equal; ReplayGain's gains
may differ by 0.011 dB, the bound of
``test_torch_cli.py::test_replay_gain_agrees_with_the_reference``, its
peaks must be equal.  The coverdump and covertag cases mirror
``tests/test_cover_cli.py``.
"""

import contextlib
import io
import os
import shutil
import time

import pytest
import torch

from audiotools_tpu import dispatch as ref_dispatch
from audiotools_tpu.formats import flac as ref_flac
from audiotools_tpu_torch import dispatch
from test_torch_cli import (CLOCK, REFERENCE_ENV, as_port,
                            flac_blocks_and_frames, port_tool, read, ref_tool,
                            signal)
from test_torch_tags import apetag_and_frames, full_metadata, png_bytes, \
    ref_reader

torch.set_num_threads(1)

SR = 8000
ALBUM = [("t1.flac", "flac"), ("t2.m4a", "alac"), ("t3.tta", "tta"),
         ("t4.wv", "wavpack")]
GAIN_DB = 0.011
COMMENT = "Cömment\nof two lines ∞"

# tracktag cases: (arguments before the files, the album's files taken)
TAG_CASES = {
    "fields": (["--name", "Nämé", "--artist", "Ärtist", "--performer", "P",
                "--composer", "C", "--conductor", "D", "--album", "Àlbum",
                "--catalog", "CAT-1", "--number", "7", "--track-total", "9",
                "--album-number", "2", "--album-total", "3", "--ISRC",
                "USRC17607839", "--publisher", "Pub", "--media-type", "CD",
                "--year", "1999", "--date", "1999-01-02", "--copyright",
                "© x", "--comment", "a comment"], None),
    "replace": (["-r", "--name", "Only", "--number", "5"], None),
    "remove": (["--remove-name", "--remove-number", "--remove-album",
                "--remove-comment", "--remove-ISRC", "--remove-year",
                "--remove-album-total", "--remove-media-type"], None),
    "remove-and-set": (["--remove-artist", "--artist", "New Artist",
                        "--remove-images"], None),
    "covers": (["--remove-images", "--front-cover", "cover.png"], None),
    "cover-added": (["--front-cover", "cover.png"], ["t1.flac", "t4.wv"]),
    "comment-file": (["--comment-file", "comment.txt"], None),
    "replay-gain-flac": (["--replay-gain", "--album", "RG"], ["t1.flac"]),
    "replay-gain-wavpack": (["--replay-gain"], ["t4.wv"]),
    "replay-gain-mixed": (["--replay-gain"], None),
}
TAG_ERRORS = {
    "bad-number": (["--number", "seven"], None),
    "comment-missing": (["--comment-file", "missing.txt"], None),
    "comment-not-utf8": (["--comment-file", "latin1.txt"], None),
    "no-files": (["--name", "x"], ["missing.flac"]),
}


def make_album(directory):
    """the album, written and tagged by the reference, in ``directory``"""
    os.makedirs(directory)
    for (k, (name, type_name)) in enumerate(ALBUM):
        cls = ref_dispatch.TYPE_MAP[type_name]
        path = os.path.join(directory, name)
        cls.from_pcm(path, ref_reader(signal(k + 1, SR // 4, SR)))
        cls(path).set_metadata(full_metadata(k + 1))


def copy_album(case):
    """ref/<case> and port/<case>, each a copy of src"""
    for side in ("ref", "port"):
        shutil.copytree("src", os.path.join(side, case))


def files_of(base, side, case):
    directory = os.path.join(str(base), side, case)
    return {name: read(os.path.join(directory, name))
            for name in sorted(os.listdir(directory))}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """every tool run, each case once by each side on its own copy of
    the album: a dict of case -> ((ref code, stdout, stderr), (port
    code, stdout, stderr)), and the base directory"""
    base = tmp_path_factory.mktemp("tagtools")
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        for (key, value) in REFERENCE_ENV.items():
            mp.setenv(key, value)
        mp.setattr(time, "time", lambda: CLOCK)
        mp.chdir(base)
        make_album("src")
        with open("cover.png", "wb") as f:
            f.write(png_bytes(6, 4))
        with open("back.png", "wb") as f:
            f.write(png_bytes(2, 9))
        with open("comment.txt", "wb") as f:
            f.write(COMMENT.encode("utf-8"))
        with open("latin1.txt", "wb") as f:
            f.write("Cömment".encode("latin-1"))

        def both(case, tool, args, names=None):
            copy_album(case)
            names = names or [name for (name, _t) in ALBUM]
            out[case] = tuple(
                run(tool, *(args + [os.path.join(side, case, name)
                                    for name in names]))
                for (run, side) in ((ref_tool, "ref"), (port_tool, "port")))

        for (case, (args, names)) in TAG_CASES.items():
            both(case, "tracktag", args, names)
        for (case, (args, names)) in TAG_ERRORS.items():
            both(case, "tracktag", args, names)
        both("rename", "trackrename", [])
        both("rename-format", "trackrename",
             ["--format", "%(album_track_number)s %(artist_name)s "
              "%(basename)s.%(suffix)s"])
        # two files to one name: the second rename collides
        both("rename-collision", "trackrename", ["--format", "same.flac"],
             ["t1.flac", "t2.m4a"])
        for (case, args) in (
                ("dump", ["-d", "dump"]),
                ("dump-prefix", ["-d", "dump", "-p", "cover-"])):
            copy_album(case)
            for (run, side) in ((ref_tool, "ref"), (port_tool, "port")):
                directory = os.path.join(side, case)
                args_here = [a if a != "dump" else os.path.join(directory,
                                                                "dump")
                             for a in args]
                out.setdefault(case, ())
                out[case] += (run("coverdump", *(args_here + [
                    os.path.join(directory, name) for (name, _t) in ALBUM])),)
        both("covertag", "covertag", ["--front-cover", "cover.png",
                                      "--back-cover", "back.png"])
        both("covertag-replace", "covertag", ["-r", "--back-cover",
                                              "back.png"])
        both("covertag-remove", "covertag", ["--remove-images"])
        both("covertag-every-kind", "covertag",
             ["--leaflet", "cover.png", "--media", "back.png",
              "--other-image", "cover.png"], ["t1.flac"])
    return (base, out)


def same_lines(case, ref, port):
    """the port's (code, stdout, stderr) are the reference's with its
    paths named as the port's"""
    assert port[0] == ref[0], (case, port[2], ref[2])
    assert port[1] == as_port(ref[1])
    assert port[2] == as_port(ref[2])


EXACT = [c for c in TAG_CASES if not c.startswith("replay-gain")]


@pytest.mark.parametrize("case", EXACT)
def test_tracktag_writes_the_references_files(runs, case):
    (base, out) = runs
    (ref, port) = out[case]
    same_lines(case, ref, port)
    assert port[0] == 0
    want = files_of(base, "ref", case)
    got = files_of(base, "port", case)
    assert sorted(got) == sorted(want)
    for name in want:
        assert got[name] == want[name], name
    if case == "comment-file":
        for name in want:
            assert dispatch.open(os.path.join(str(base), "port", case, name),
                                 "cpu").get_metadata().comment == COMMENT


@pytest.mark.parametrize("case", sorted(TAG_ERRORS))
def test_tracktag_errors_are_the_references(runs, case):
    (base, out) = runs
    (ref, port) = out[case]
    same_lines(case, ref, port)
    assert port[0] == 1 and port[2].startswith("*** ")
    assert files_of(base, "port", case) == files_of(base, "src", "")


@pytest.mark.parametrize("case", ["replay-gain-flac", "replay-gain-wavpack",
                                  "replay-gain-mixed"])
def test_tracktag_replay_gain_agrees_with_the_reference(runs, case):
    """FLAC's comments and WavPack's APEv2 items from each class's album
    analysis: the audio and every other byte of the tags the
    reference's, the gains within GAIN_DB, the peaks equal; ALAC and
    TTA untouched"""
    (base, out) = runs
    (ref, port) = out[case]
    same_lines(case, ref, port)
    assert port[0] == 0 and "ReplayGain added" in port[2]
    want = files_of(base, "ref", case)
    got = files_of(base, "port", case)
    assert sorted(got) == sorted(want)
    for name in want:
        (port_path, ref_path) = (os.path.join(str(base), side, case, name)
                                 for side in ("port", "ref"))
        rg = dispatch.open(port_path, "cpu").replay_gain()
        if (name.endswith((".m4a", ".tta")) or
                name not in (TAG_CASES[case][1] or want)):
            assert got[name] == want[name]
            continue
        if name.endswith(".wv"):
            (items, frames) = apetag_and_frames(port_path)
            (ref_items, ref_frames) = apetag_and_frames(ref_path)
            assert frames == ref_frames
            assert sorted(items) == sorted(ref_items)
            for (key, value) in ref_items.items():
                if not key.endswith("gain"):
                    assert items[key] == value, key
            ref_rg = [float(ref_items["replaygain_%s" % (k,)].split()[0])
                      for k in ("track_gain", "track_peak", "album_gain",
                                "album_peak")]
        else:
            port_tags = dispatch.open(port_path, "cpu").get_metadata()
            ref_tags = ref_flac.FlacAudio(ref_path).get_metadata()
            (blocks, frames) = flac_blocks_and_frames(port_path)
            (ref_blocks, ref_frames) = flac_blocks_and_frames(ref_path)
            assert frames == ref_frames
            for block_type in (0, 3, 6):   # STREAMINFO, SEEKTABLE, PICTURE
                assert blocks[block_type] == ref_blocks[block_type]
            vorbis = port_tags.get_block(4)
            ref_vorbis = ref_tags.get_block(4)
            assert [c for c in vorbis.comment_strings
                    if "_GAIN=" not in c] == [
                c for c in ref_vorbis.comment_strings if "_GAIN=" not in c]
            ref_track = ref_flac.FlacAudio(ref_path)
            ref_rg = [float(v) for v in (
                ref_track.replay_gain().track_gain,
                ref_track.replay_gain().track_peak,
                ref_track.replay_gain().album_gain,
                ref_track.replay_gain().album_peak)]
        assert abs(rg.track_gain - ref_rg[0]) <= GAIN_DB
        assert rg.track_peak == ref_rg[1]
        assert abs(rg.album_gain - ref_rg[2]) <= GAIN_DB
        assert rg.album_peak == ref_rg[3]


@pytest.mark.parametrize("case", ["rename", "rename-format",
                                  "rename-collision"])
def test_trackrename_is_the_references(runs, case):
    (base, out) = runs
    (ref, port) = out[case]
    same_lines(case, ref, port)
    assert port[0] == (1 if case == "rename-collision" else 0)
    want = files_of(base, "ref", case)
    assert files_of(base, "port", case) == want
    if case == "rename":
        assert sorted(want) == sorted(
            "%02d - Sóng %d-Ä.%s" % (k + 1, k + 1, name.split(".")[1])
            for (k, (name, _t)) in enumerate(ALBUM))


def test_trackrename_refuses_a_template_that_does_not_format(tmp_path):
    """the reference's tool raises UnsupportedTracknameField; the port's
    exits 1 with its text as the error line, the file left as it was"""
    from audiotools_tpu.audiofile import UnsupportedTracknameField
    flac_file = one_flac(tmp_path)
    with pytest.raises(UnsupportedTracknameField):
        ref_tool("trackrename", "--format", "%(nosuch)s", flac_file)
    assert port_tool("trackrename", "--format", "%(nosuch)s", flac_file) == (
        1, "", "*** Error: unknown field \"nosuch\" in file format\n")
    assert os.listdir(str(tmp_path)) == ["t.flac"]


@pytest.mark.parametrize("case", ["dump", "dump-prefix"])
def test_coverdump_is_the_references(runs, case):
    (base, out) = runs
    (ref, port) = out[case]
    same_lines(case, ref, port)
    assert port[0] == 0
    want = files_of(base, "ref", os.path.join(case, "dump"))
    assert files_of(base, "port", os.path.join(case, "dump")) == want
    assert len(want) == len(ALBUM)
    assert all(data[:8] == b"\x89PNG\r\n\x1a\n" for data in want.values())


@pytest.mark.parametrize("case", ["covertag", "covertag-replace",
                                  "covertag-remove", "covertag-every-kind"])
def test_covertag_writes_the_references_files(runs, case):
    (base, out) = runs
    (ref, port) = out[case]
    same_lines(case, ref, port)
    assert port[0] == 0
    assert files_of(base, "port", case) == files_of(base, "ref", case)


def one_flac(tmp_path):
    """a FLAC track of the reference's, untagged (test_cover_cli.py's
    fixture)"""
    path = str(tmp_path / "t.flac")
    with pytest.MonkeyPatch.context() as mp:
        for (key, value) in REFERENCE_ENV.items():
            mp.setenv(key, value)
        ref_flac.FlacAudio.from_pcm(path, ref_reader(signal(1, SR // 4, SR)))
    return path


def test_covertag_coverdump_roundtrip(tmp_path):
    flac_file = one_flac(tmp_path)
    png_path = str(tmp_path / "cover.png")
    with open(png_path, "wb") as f:
        f.write(png_bytes(1, 1))
    assert port_tool("covertag", "--front-cover", png_path,
                     flac_file)[0] == 0
    outdir = str(tmp_path / "dump")
    os.makedirs(outdir)
    (code, _stdout, stderr) = port_tool("coverdump", "-d", outdir, flac_file)
    assert code == 0, stderr
    dumped = sorted(os.listdir(outdir))
    assert dumped == ["t-front_cover00.png"]
    assert read(os.path.join(outdir, dumped[0])) == png_bytes(1, 1)


def test_covertag_remove_images(tmp_path):
    flac_file = one_flac(tmp_path)
    png_path = str(tmp_path / "cover.png")
    with open(png_path, "wb") as f:
        f.write(png_bytes(1, 1))
    assert port_tool("covertag", "--front-cover", png_path,
                     flac_file)[0] == 0
    assert port_tool("covertag", "--remove-images", flac_file)[0] == 0
    outdir = str(tmp_path / "dump")
    os.makedirs(outdir)
    assert port_tool("coverdump", "-d", outdir, flac_file)[0] == 1
    assert os.listdir(outdir) == []


def test_coverdump_no_images(tmp_path):
    flac_file = one_flac(tmp_path)
    outdir = str(tmp_path / "dump")
    os.makedirs(outdir)
    ref = ref_tool("coverdump", "-d", outdir, flac_file)
    port = port_tool("coverdump", "-d", outdir, flac_file)
    assert port == ref == (1, "", "*** Error: no images found\n")
    assert os.listdir(outdir) == []


@pytest.mark.parametrize("tool,flag", [("tracktag", "-I"),
                                       ("tracktag", "-M"),
                                       ("trackrename", "-I"),
                                       ("config_tool", "-I")])
def test_interactive_and_lookup_are_refused(tmp_path, monkeypatch, tool,
                                            flag):
    flac_file = one_flac(tmp_path)
    before = read(flac_file)
    if tool == "config_tool":
        # it takes no files and no --devices; HOME is left alone
        monkeypatch.setenv("HOME", str(tmp_path))
        from audiotools_tpu_torch.cli import config_tool
        (out, err) = (io.StringIO(), io.StringIO())
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
            code = config_tool.main([flag, "-t", "wav"])
        (stdout, stderr) = (out.getvalue(), err.getvalue())
    else:
        (code, stdout, stderr) = port_tool(tool, flag, flac_file)
    assert (code, stdout) == (1, "")
    assert "not ported" in stderr
    assert os.listdir(str(tmp_path)) == ["t.flac"]
    assert read(flac_file) == before


@pytest.mark.parametrize("tool,args", [
    ("tracktag", ["--name", "x"]), ("tracklint", []), ("trackrename", []),
    ("coverdump", ["-d", "dump"]), ("covertag", ["--remove-images"]),
    ("trackcat", ["-o", "cat.flac"]), ("tracksplit", ["-d", "split"])])
def test_the_tools_default_to_the_card(tmp_path, monkeypatch, tool, args):
    """without --devices a tool opens its files on the current card; with
    none usable it exits 1 naming it, and writes nothing"""
    import importlib
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    flac_file = one_flac(tmp_path)
    before = read(flac_file)
    monkeypatch.chdir(tmp_path)
    module = importlib.import_module("audiotools_tpu_torch.cli." + tool)
    err = io.StringIO()
    with contextlib.redirect_stderr(err), \
            contextlib.redirect_stdout(io.StringIO()):
        assert module.main(args + [flac_file]) == 1
    assert "cuda" in err.getvalue()
    assert os.listdir(str(tmp_path)) == ["t.flac"]
    assert read(flac_file) == before
