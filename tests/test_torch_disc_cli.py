"""The port's disc tools and lookups against the reference's tools:
cdinfo, cd2track and track2cd over a short cue/bin (and NRG) image,
-M and its option family in track2track, trackcat, tracksplit and
tracktag, and trackverify --accuraterip's database lines.  Each case is
run by both packages in-process (``-j 1``; the port with ``--devices
cpu``), the reference with the environment the other tool tests pin
(``REFERENCE_ENV``); files must be equal byte for byte, and stdout,
stderr and the exit code equal.  Every lookup is answered from canned
replies by a patched ``urllib.request.urlopen``, which records the URLs
each side asks for, and ``socket.create_connection`` raises."""

import contextlib
import importlib
import io
import os
import re
import shutil
import socket
import urllib.request

import numpy as np
import pytest
import torch

from audiotools_tpu.accuraterip_checksum import \
    accuraterip_checksums as ref_checksums
from audiotools_tpu.dispatch import open as ref_open
from audiotools_tpu.formats.flac import FlacAudio as RefFlacAudio
from audiotools_tpu.formats.wav import WaveAudio as RefWaveAudio
from audiotools_tpu_torch import cdio, dispatch, pcm
from audiotools_tpu_torch.formats.wav import WaveAudio
from audiotools_tpu_torch.services import accuraterip, freedb, musicbrainz
from cli_harness import run_tool
from test_torch_cli import URWID_REQUIRED
from torch_ui_helpers import urwid_as
from torch_disc_helpers import (CannedServer, accuraterip_record,
                                make_image, make_nrg, musicbrainz_release,
                                musicbrainz_xml, no_socket, xmcd)

torch.set_num_threads(1)

REFERENCE_ENV = {"ATPU_FLAC_BACKEND": "numpy", "ATPU_FLAC_QPACK": "0",
                 "ATPU_EMIT_EXACT_RICE": "0", "ATPU_ALAC_BACKEND": "numpy",
                 "ATPU_ALAC_QPACK": "0"}
# the disc: three tracks, 1.7 s in all
LENGTHS = [40, 25, 60]
RIPS = ["ref/flac8/%2.2d - .flac" % (n,) for n in (1, 2, 3)]
# the seven lookup options, each used without -M
LOOKUP_OPTIONS = [["--no-freedb"], ["--freedb-server", "fdb.test"],
                  ["--freedb-port", "8888"], ["--no-musicbrainz"],
                  ["--musicbrainz-server", "mb.test"],
                  ["--musicbrainz-port", "8889"], ["-D"]]


def port_tool(name, *args):
    """the port's tool run in-process, on the CPU where it runs jobs:
    (exit code, stdout, stderr)"""
    module = importlib.import_module("audiotools_tpu_torch.cli." + name)
    (out, err) = (io.StringIO(), io.StringIO())
    devices = [] if name == "cdinfo" else ["--devices", "cpu"]
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        try:
            code = module.main(list(args) + devices)
        except SystemExit as exit_err:
            code = exit_err.code
    return (code or 0, out.getvalue(), err.getvalue())


def ref_tool(name, *args):
    r = run_tool(name, *args)
    return (r.returncode, r.stdout, r.stderr)


def as_port(text):
    """the reference's output with its paths named as the port's"""
    return re.sub(r"(?<![\w/])ref/", "port/", text)


def read(path):
    with open(path, "rb") as f:
        return f.read()


def tree(root):
    """{relative path: bytes} of every file under ``root``"""
    out = {}
    if os.path.isdir(root):
        for (base, _dirs, names) in os.walk(root):
            for name in names:
                path = os.path.join(base, name)
                out[os.path.relpath(path, root)] = read(path)
    return out


def copy_rips(dest):
    os.makedirs(dest)
    for path in RIPS:
        shutil.copy(path, dest)
    return [os.path.join(dest, os.path.basename(p)) for p in RIPS]


class Runs:
    """each case run by each side: ``results[case]`` is ((ref code,
    stdout, stderr), (port code, stdout, stderr)), ``urls[case]`` the
    URLs each side asked for"""

    def __init__(self, server):
        self.server = server
        self.results = {}
        self.urls = {}

    def both(self, case, name, args, replies=None, port_args=None):
        self.server.replies = dict(replies or {})
        start = len(self.server.urls)
        ref = ref_tool(name, *args)
        middle = len(self.server.urls)
        port = port_tool(name, *(port_args if port_args is not None
                                 else [as_port(a) for a in args]))
        self.results[case] = (ref, port)
        self.urls[case] = (self.server.urls[start:middle],
                           self.server.urls[middle:])


def rip_disc_ids(paths):
    """the MusicBrainz and AccurateRip disc IDs that the lookups build
    from files (in sorted order, each its CD frame count long)"""
    tracks = dispatch.sorted_tracks(dispatch.open_files(paths, device="cpu"))
    frames = [t.cd_frames() for t in tracks]
    offsets = [int(sum(frames[:i])) for i in range(len(frames))]
    mb_id = musicbrainz.DiscID(1, len(frames), 150 + sum(frames),
                               [150 + o for o in offsets])
    numbers = [t.get_metadata().track_number for t in tracks]
    ar_id = accuraterip.DiscID(numbers, offsets, sum(frames), freedb.DiscID(
        [150 + o for o in offsets], sum(frames), len(frames)))
    return (mb_id, ar_id)


@pytest.fixture(scope="module")
def disc_runs(tmp_path_factory):
    base = tmp_path_factory.mktemp("disc_cli")
    server = CannedServer()
    runs = Runs(server)
    with pytest.MonkeyPatch.context() as mp:
        for (key, value) in REFERENCE_ENV.items():
            mp.setenv(key, value)
        mp.setattr(urllib.request, "urlopen", server.urlopen)
        mp.setattr(socket, "create_connection", no_socket)
        mp.chdir(base)
        os.makedirs("src")
        (cue, arr) = make_image("src", LENGTHS)
        make_nrg("src", LENGTHS)
        # the whole disc as one FLAC album, and a mono 8-bit copy
        WaveAudio.from_pcm("src/album.wav", pcm.reader_from_array(arr, 16))
        RefFlacAudio.from_pcm("src/album.flac",
                              RefWaveAudio("src/album.wav").to_pcm())
        WaveAudio.from_pcm("src/mono8.wav", pcm.reader_from_array(
            (arr[:588 * 30, :1] >> 8), 8))
        cdda = cdio.CDDA(cue)
        disc_replies = {
            "freedb": xmcd(3),
            "musicbrainz": musicbrainz_xml(
                [str(musicbrainz.disc_id(cdda))], 3)}
        cdda.close()

        def rip(case, args, replies=None, tracks=()):
            runs.both("cd2track-" + case, "cd2track",
                      ["-c", cue, "-j", "1", "-d", "ref/" + case] + args +
                      [str(n) for n in tracks], replies)

        runs.both("cdinfo", "cdinfo", ["-c", cue])
        runs.both("cdinfo-nrg", "cdinfo", ["-c", "src/disc.nrg"])
        runs.both("cdinfo-missing", "cdinfo", ["-c", "src/none.cue"])
        rip("flac8", ["-t", "flac", "-q", "8"])
        rip("wav", ["-t", "wav"])
        rip("wavpack", ["-t", "wavpack"], tracks=[2])
        rip("offset", ["-t", "wav", "--offset", "667"])
        rip("offset-back", ["-t", "flac", "-q", "0", "--offset", "-588"],
            tracks=[1, 3])
        rip("album", ["-t", "flac", "-q", "0", "--album-number", "2",
                      "--album-total", "3"])
        rip("replay-gain", ["-t", "flac", "--replay-gain"])
        rip("M", ["-M", "-t", "flac", "-q", "0"], disc_replies)
        rip("M-freedb-reply", ["-M", "-t", "wav"],
            {"freedb": disc_replies["freedb"]})
        rip("M-musicbrainz-reply", ["-M", "-t", "flac", "-q", "0"],
            {"musicbrainz": disc_replies["musicbrainz"]})
        rip("M-offline", ["-M", "-t", "wav"])
        rip("M-D", ["-M", "-D", "-t", "flac", "-q", "0"], disc_replies)
        rip("M-no-musicbrainz", ["-M", "--no-musicbrainz", "-t", "wav"],
            disc_replies)
        rip("M-no-freedb", ["-M", "--no-freedb", "-t", "wav", "--album-number",
                            "4"], disc_replies)
        rip("M-servers", ["-M", "--musicbrainz-server", "mb.test",
                          "--musicbrainz-port", "81", "--freedb-server",
                          "fdb.test", "--freedb-port", "82", "-t", "wav"],
            disc_replies, tracks=[3])
        rip("D", ["-D", "-t", "wav"], disc_replies)
        runs.both("cd2track-nrg", "cd2track",
                  ["-c", "src/disc.nrg", "-t", "wav", "-j", "1", "-d",
                   "ref/nrg"])
        rip("past-the-disc", ["-t", "wav"], tracks=[2, 4])
        rip("no-type", ["-t", "nosuch"])

        # track2cd: the FLAC rips back to an image, the album by its
        # sheet, a source not in CD format, and no burner
        os.makedirs("ref/t2cd")
        os.makedirs("port/t2cd")
        runs.both("track2cd-image", "track2cd",
                  ["--image", "ref/t2cd/disc"] + RIPS,
                  port_args=["--image", "port/t2cd/disc"] + RIPS)
        os.makedirs("ref/t2cd-cue")
        os.makedirs("port/t2cd-cue")
        runs.both("track2cd-cue", "track2cd",
                  ["--image", "ref/t2cd-cue/disc", "--cue", cue,
                   "src/album.flac"])
        os.makedirs("ref/t2cd-mono8")
        os.makedirs("port/t2cd-mono8")
        runs.both("track2cd-mono8", "track2cd",
                  ["--image", "ref/t2cd-mono8/disc", "src/mono8.wav"])
        path = os.environ.get("PATH", "")
        empty = os.path.join(str(base), "no-programs")
        os.makedirs(empty)
        mp.setenv("PATH", empty)
        runs.both("track2cd-no-burner", "track2cd", RIPS[:1])
        mp.setenv("PATH", path)

        # -M and the lookup options in the four tools, over the rips
        (mb_id, ar_id) = rip_disc_ids(RIPS)
        rip_replies = {"freedb": xmcd(3),
                       "musicbrainz": musicbrainz_release(str(mb_id), 3)}
        for (i, extra) in enumerate([["-M"], ["-M", "-D"]] +
                                    LOOKUP_OPTIONS):
            case = "".join(extra).replace("-", "") or "M"
            runs.both("track2track-" + case, "track2track",
                      extra + ["-t", "flac", "-q", "0", "-j", "1", "-d",
                               "ref/t2t-" + case] + RIPS, rip_replies)
            runs.both("trackcat-" + case, "trackcat",
                      extra + ["-t", "flac", "-q", "0", "-o",
                               "ref/cat-%s.flac" % (case,)] + RIPS,
                      rip_replies)
            runs.both("tracksplit-" + case, "tracksplit",
                      extra + ["-t", "flac", "-q", "0", "-j", "1", "--cue",
                               cue, "-d", "ref/split-" + case,
                               "src/album.flac"], rip_replies)
            ref_copies = copy_rips("ref/tag-" + case)
            port_copies = copy_rips("port/tag-" + case)
            runs.both("tracktag-" + case, "tracktag",
                      extra + ["--comment", "tagged"] + ref_copies,
                      rip_replies,
                      port_args=extra + ["--comment", "tagged"] + port_copies)
        runs.both("track2track-M-offline", "track2track",
                  ["-M", "-t", "wav", "-j", "1", "-d", "ref/t2t-offline"] +
                  RIPS, {})
        runs.both("tracktag-M-name", "tracktag",
                  ["-M", "--name", "Given"] + copy_rips("ref/tag-name"),
                  rip_replies,
                  port_args=["-M", "--name", "Given"] +
                  copy_rips("port/tag-name"))

        # trackverify --accuraterip: the rips' own sums, other sums, none
        sums = []
        for path in RIPS:
            track = ref_open(path)
            sums.append(ref_checksums(track.to_pcm(), track.total_frames()))
        match = accuraterip_record(ar_id, [(7 + i, v1, 0x5EED)
                                           for (i, (v1, _v2))
                                           in enumerate(sums)])
        v2_match = accuraterip_record(ar_id, [(20, 0x5EED, v2)
                                              for (_v1, v2) in sums])
        mismatch = accuraterip_record(ar_id, [(9, 1, 2)] * 3)
        for (case, reply, files) in (
                ("match", match, RIPS),
                ("match-v2", v2_match, RIPS),
                ("match-reversed", match, RIPS[::-1]),
                ("mismatch", mismatch, RIPS),
                ("absent", None, RIPS),
                ("other-disc", mismatch[:13 + 18], RIPS),
                ("with-a-wave", match, RIPS[:1] + ["src/album.wav"])):
            runs.both("trackverify-" + case, "trackverify",
                      ["-j", "1", "--accuraterip"] + files,
                      {"accuraterip": reply})
    return (base, runs, arr)


def test_cdinfo_prints_the_references_lines(disc_runs):
    (_base, runs, _arr) = disc_runs
    for case in ("cdinfo", "cdinfo-nrg", "cdinfo-missing"):
        (ref, port) = runs.results[case]
        assert port == ref, case
    assert runs.results["cdinfo"][1][0] == 0
    assert runs.results["cdinfo-missing"][1][0] == 1
    assert runs.results["cdinfo"][1][1].startswith("Tracks : 3\n")


CD2TRACK_CASES = ["flac8", "wav", "wavpack", "offset", "offset-back", "album",
                  "replay-gain", "M", "M-freedb-reply", "M-musicbrainz-reply",
                  "M-offline", "M-D", "M-no-musicbrainz", "M-no-freedb",
                  "M-servers", "D", "nrg", "past-the-disc", "no-type"]


@pytest.mark.parametrize("case", CD2TRACK_CASES)
def test_cd2track_writes_the_references_files(disc_runs, case):
    (base, runs, _arr) = disc_runs
    (ref, port) = runs.results["cd2track-" + case]
    assert port == (ref[0], as_port(ref[1]), as_port(ref[2])), (ref, port)
    ref_files = tree(os.path.join(str(base), "ref", case))
    assert tree(os.path.join(str(base), "port", case)) == ref_files
    (ref_urls, port_urls) = runs.urls["cd2track-" + case]
    assert port_urls == ref_urls
    if case in ("past-the-disc", "no-type"):
        assert port[0] == 1 and not ref_files
    else:
        assert port[0] == 0 and ref_files
    if case.startswith("M") and case != "M-offline":
        assert "Using metadata: " in port[2]
    if case == "M-servers":
        assert [CannedServer.kind(u) for u in port_urls] == [
            "musicbrainz", "freedb"]
        assert port_urls[0].startswith("http://mb.test:81/")
        assert port_urls[1].startswith("http://fdb.test:82/")
    if not case.startswith("M"):
        assert port_urls == []


def test_cd2track_rips_decode_to_the_disc(disc_runs):
    """the FLAC rips hold the disc's samples; the offset rips the
    shifted window, silence before the disc's start"""
    (base, _runs, arr) = disc_runs
    starts = np.cumsum([0] + LENGTHS) * 588
    for n in (1, 2, 3):
        got = pcm.read_all(dispatch.open(os.path.join(
            str(base), "port", "flac8", "%2.2d - .flac" % (n,)),
            device="cpu").to_pcm())
        assert np.array_equal(got, arr[starts[n - 1]:starts[n]])
    padded = np.concatenate([np.zeros((588, 2), np.int32), arr])
    got = pcm.read_all(dispatch.open(os.path.join(
        str(base), "port", "offset-back", "01 - .flac"),
        device="cpu").to_pcm())
    assert np.array_equal(got, padded[:starts[1]])


def test_cd2track_lookup_names_and_tags_the_rips(disc_runs):
    (base, _runs, _arr) = disc_runs
    names = sorted(os.listdir(os.path.join(str(base), "port", "M")))
    assert names == ["01 - Track 1.flac", "02 - Track 2.flac",
                     "03 - Track 3.flac"]
    metadata = dispatch.open(os.path.join(str(base), "port", "M", names[1]),
                             device="cpu").get_metadata()
    assert (metadata.track_name, metadata.artist_name, metadata.album_name,
            metadata.album_number, metadata.album_total) == (
                "Track 2", "Gamma", "Double Album", 2, 2)
    names = sorted(os.listdir(os.path.join(str(base), "port",
                                           "M-freedb-reply")))
    assert names[1] == "02 - Song 2.wav"


@pytest.mark.parametrize("case", ["image", "cue", "mono8", "no-burner"])
def test_track2cd_writes_the_references_image(disc_runs, case):
    (base, runs, _arr) = disc_runs
    (ref, port) = runs.results["track2cd-" + case]
    if case == "no-burner":
        # the image is staged in a temporary directory of its own
        (ref, port) = [(r[0], r[1], re.sub(r"track2cd-\w+", "track2cd-X",
                                           r[2])) for r in (ref, port)]
        assert port == ref and port[0] == 1
        assert "no CD burning binary found (cdrdao/cdrecord)" in port[2]
        return
    assert port == (ref[0], as_port(ref[1]), as_port(ref[2]))
    assert port[0] == 0
    directory = {"image": "t2cd", "cue": "t2cd-cue",
                 "mono8": "t2cd-mono8"}[case]
    ref_files = tree(os.path.join(str(base), "ref", directory))
    assert sorted(ref_files) == ["disc.bin", "disc.cue"]
    assert tree(os.path.join(str(base), "port", directory)) == ref_files
    if case in ("image", "cue"):
        # the rips, or the album cut by the disc's sheet, give the
        # disc's image back
        assert ref_files["disc.bin"] == read(os.path.join(str(base), "src",
                                                          "disc.bin"))
        port_cdda = cdio.CDDA(os.path.join(str(base), "port", directory,
                                           "disc.cue"))
        assert [length for (_start, length) in
                port_cdda.track_offsets()] == LENGTHS
        port_cdda.close()


LOOKUP_CASES = ["M", "MD"] + ["".join(o).replace("-", "")
                              for o in LOOKUP_OPTIONS]


@pytest.mark.parametrize("case", LOOKUP_CASES)
@pytest.mark.parametrize("tool", ["track2track", "trackcat", "tracksplit",
                                  "tracktag"])
def test_lookup_options_in_the_tools_are_the_references(disc_runs, tool,
                                                        case):
    (base, runs, _arr) = disc_runs
    (ref, port) = runs.results["%s-%s" % (tool, case)]
    assert port == (ref[0], as_port(ref[1]), as_port(ref[2])), (ref, port)
    assert port[0] == 0
    (ref_urls, port_urls) = runs.urls["%s-%s" % (tool, case)]
    assert port_urls == ref_urls
    assert bool(port_urls) == case.startswith("M")
    directory = {"track2track": "t2t-" + case, "trackcat": None,
                 "tracksplit": "split-" + case, "tracktag": "tag-" + case}[tool]
    if directory is None:
        ref_files = {"cat": read(os.path.join(str(base), "ref",
                                              "cat-%s.flac" % (case,)))}
        port_files = {"cat": read(os.path.join(str(base), "port",
                                               "cat-%s.flac" % (case,)))}
    else:
        ref_files = tree(os.path.join(str(base), "ref", directory))
        port_files = tree(os.path.join(str(base), "port", directory))
    assert ref_files and port_files == ref_files


def test_the_lookup_reaches_the_files(disc_runs):
    """-M's first choice names and tags what the tools write; -D keeps
    the default choice"""
    (base, runs, _arr) = disc_runs
    port = os.path.join(str(base), "port")
    assert sorted(os.listdir(os.path.join(port, "t2t-M"))) == [
        "01 - Take 1.flac", "02 - Take 2.flac", "03 - Take 3.flac"]
    assert "Using metadata: Canned Release" in \
        runs.results["track2track-M"][1][2]
    assert sorted(os.listdir(os.path.join(port, "t2t-MD"))) == [
        "01 - .flac", "02 - .flac", "03 - .flac"]
    cat = dispatch.open(os.path.join(port, "cat-M.flac"),
                        device="cpu").get_metadata()
    assert (cat.album_name, cat.year, cat.track_total) == (
        "Canned Release", "2011", 3)
    split = dispatch.open(os.path.join(port, "split-M", "02 - Take 2.flac"),
                          device="cpu").get_metadata()
    assert (split.track_name, split.artist_name) == ("Take 2", "Player 1")
    tagged = dispatch.open(os.path.join(port, "tag-M", "02 - .flac"),
                           device="cpu").get_metadata()
    assert (tagged.track_name, tagged.comment) == ("Take 2", "tagged")
    named = dispatch.open(os.path.join(port, "tag-name", "01 - .flac"),
                          device="cpu").get_metadata()
    assert (named.track_name, named.album_name) == ("Given",
                                                    "Canned Release")
    (ref, got) = runs.results["track2track-M-offline"]
    assert got == (ref[0], as_port(ref[1]), as_port(ref[2])) and got[0] == 0
    assert "Using metadata" not in got[2]
    assert tree(os.path.join(port, "t2t-offline")) == tree(
        os.path.join(str(base), "ref", "t2t-offline"))
    (ref, got) = runs.results["tracktag-M-name"]
    assert got == (ref[0], as_port(ref[1]), as_port(ref[2]))
    assert tree(os.path.join(port, "tag-name")) == tree(
        os.path.join(str(base), "ref", "tag-name"))


VERIFY_CASES = {"match": "confidence", "match-v2": "confidence",
                "match-reversed": "MISMATCH", "mismatch": "MISMATCH",
                "absent": "not present", "other-disc": "not present",
                "with-a-wave": "not present"}


@pytest.mark.parametrize("case", sorted(VERIFY_CASES))
def test_trackverify_prints_the_references_database_lines(disc_runs, case):
    (_base, runs, _arr) = disc_runs
    (ref, port) = runs.results["trackverify-" + case]
    assert port == (ref[0], as_port(ref[1]), as_port(ref[2]))
    assert port[0] == 0
    lines = port[2].splitlines()
    assert len(lines) == (2 if case == "with-a-wave" else 3)
    assert VERIFY_CASES[case] in lines[0]
    (ref_urls, port_urls) = runs.urls["trackverify-" + case]
    assert port_urls == ref_urls and len(port_urls) == 1
    if case == "match-reversed":
        # numbered by place in the list: the middle track alone matches
        assert [("confidence" in line) for line in lines] == [False, True,
                                                              False]


def test_interactive_rips_are_refused(tmp_path):
    """with urwid absent, cd2track -I exits 1 with the reference's lines
    (the disc ID, then the error), before any rip"""
    (cue, _arr) = make_image(str(tmp_path), [2])
    out = str(tmp_path / "out")
    with urwid_as(None):
        ref = ref_tool("cd2track", "-I", "-c", cue, "-d", out)
        port = port_tool("cd2track", "-I", "-c", cue, "-d", out)
    assert port == ref
    assert port[0] == 1 and port[2].endswith(URWID_REQUIRED)
    assert not os.path.exists(out)


@pytest.mark.parametrize("tool", ["track2track", "trackcat", "tracksplit",
                                  "tracktag"])
def test_interactive_mode_alone_is_refused(tmp_path, monkeypatch, tool):
    """-I without -M and with urwid absent: the reference's exit code,
    lines and files (its trackcat and tracksplit look at -I only with
    -M, so trackcat writes its file and tracksplit stops at the missing
    sheet; track2track and tracktag exit 1 with the error)"""
    for (key, value) in REFERENCE_ENV.items():
        monkeypatch.setenv(key, value)
    args = {"track2track": ["-t", "flac", "-d", "x"],
            "trackcat": ["-t", "flac", "-o", "x.flac"],
            "tracksplit": ["-t", "flac", "-d", "x"],
            "tracktag": ["--name", "x"]}[tool]
    results = {}
    with urwid_as(None):
        for (side, run) in (("ref", ref_tool), ("port", port_tool)):
            os.makedirs(str(tmp_path / side))
            monkeypatch.chdir(tmp_path / side)
            WaveAudio.from_pcm("a.wav", pcm.reader_from_array(
                np.zeros((588, 2), np.int32), 16))
            results[side] = (run(tool, "-I", *args, "a.wav"),
                             {name: read(name) for name in os.listdir(".")})
    assert results["port"] == results["ref"]
    (code, _stdout, stderr) = results["port"][0]
    assert code == (0 if tool == "trackcat" else 1)
    if tool in ("track2track", "tracktag"):
        assert stderr == URWID_REQUIRED
    assert sorted(results["port"][1]) == (["a.wav", "x.flac"]
                                          if tool == "trackcat" else
                                          ["a.wav"])
