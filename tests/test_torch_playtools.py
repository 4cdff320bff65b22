"""The port's players and cover viewer on the command line against the
reference's: ``trackplay -o NULL`` (plain, with -T and -A, -I without
urwid, and on a missing file), ``cdplay -o NULL`` over a cue/bin image,
and ``coverview`` with ``DISPLAY`` unset.  Both tools run in-process, the
port's with ``--devices cpu`` where it takes it; the exit codes, stdout
and stderr must be the same.  The NULL output paces at real time, so
every track is 0.25 s or less.
"""

import contextlib
import importlib
import io
import os

import numpy as np
import pytest

from audiotools_tpu_torch import pcm
from audiotools_tpu_torch.audiofile import Image
from audiotools_tpu_torch.formats.flac import FlacAudio
from cli_harness import run_tool
from torch_disc_helpers import make_image
from torch_ui_helpers import urwid_as

RATE = 22050


def port_tool(name, *args, devices=True):
    """the port's tool run in-process: (exit code, stdout, stderr)"""
    module = importlib.import_module("audiotools_tpu_torch.cli." + name)
    (out, err) = (io.StringIO(), io.StringIO())
    extra = ["--devices", "cpu"] if devices else []
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        try:
            code = module.main(list(args) + extra)
        except SystemExit as exit_err:
            code = exit_err.code
    return (code or 0, out.getvalue(), err.getvalue())


def ref_tool(name, *args):
    r = run_tool(name, *args)
    return (r.returncode, r.stdout, r.stderr)


def flac_track(path, seed, seconds=0.25, scale=1):
    rng = np.random.default_rng(seed)
    arr = (rng.normal(0, 3000 // scale, (int(RATE * seconds), 2))).astype(
        np.int32)
    return FlacAudio.from_pcm(path, pcm.reader_from_array(arr, 16, RATE),
                              device="cpu")


@pytest.fixture(scope="module")
def album(tmp_path_factory):
    """two 0.25 s FLAC tracks with ReplayGain tags, and a third with none"""
    base = tmp_path_factory.mktemp("play")
    paths = [str(base / ("%d.flac" % (i,))) for i in (1, 2, 3)]
    for (i, path) in enumerate(paths):
        flac_track(path, i, scale=1 + 3 * i)
    FlacAudio.add_replay_gain(paths[:2], device="cpu")
    return paths


@pytest.mark.parametrize("flags", [[], ["-T"], ["-A"], ["--shuffle"],
                                   ["-V", "quiet"]],
                         ids=["plain", "track-gain", "album-gain", "shuffle",
                              "quiet"])
def test_trackplay_is_the_references(album, flags):
    if flags == ["--shuffle"]:
        paths = album[:1]       # one file: the order cannot differ
    else:
        paths = album
    ref = ref_tool("trackplay", "-o", "NULL", *flags, *paths)
    port = port_tool("trackplay", "-o", "NULL", *flags, *paths)
    assert port == ref
    assert port[0] == 0
    if flags != ["-V", "quiet"]:
        assert port[2].splitlines() == ["playing %s" % (p,) for p in paths]


def test_trackplay_paces_at_real_time(album):
    import time
    t0 = time.perf_counter()
    assert port_tool("trackplay", "-o", "NULL", album[0])[0] == 0
    assert time.perf_counter() - t0 >= 0.25


@pytest.mark.parametrize("case", ["missing", "not-audio", "no-output"])
def test_trackplay_errors_are_the_references(tmp_path, album, case):
    if case == "missing":
        args = ["-o", "NULL", str(tmp_path / "missing.flac")]
    elif case == "not-audio":
        path = str(tmp_path / "x.txt")
        with open(path, "w") as f:
            f.write("not audio")
        args = ["-o", "NULL", path]
    else:
        args = ["-o", "NO SUCH OUTPUT", album[0]]
    ref = ref_tool("trackplay", *args)
    port = port_tool("trackplay", *args)
    assert port == ref
    assert port[0] == 1


def test_trackplay_interactive_without_urwid(album):
    with urwid_as(None):
        ref = ref_tool("trackplay", "-I", "-o", "NULL", album[0])
        port = port_tool("trackplay", "-I", "-o", "NULL", album[0])
    assert port == ref == (1, "", "*** Error: urwid is required for "
                           "interactive mode; run without -I or install "
                           "urwid\n")


def test_trackplay_without_a_card_exits(album, monkeypatch):
    """no --devices and no card: exit 1 naming it, nothing played"""
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    (code, stdout, stderr) = port_tool("trackplay", "-o", "NULL", album[0],
                                       devices=False)
    assert (code, stdout) == (1, "")
    assert stderr.startswith("*** Error: ") and "playing" not in stderr


@pytest.mark.parametrize("tracks", [[], ["2"], ["2", "1"]],
                         ids=["all", "second", "reversed"])
def test_cdplay_is_the_references(tmp_path, tracks):
    (cue, _arr) = make_image(str(tmp_path), [9, 6])
    ref = ref_tool("cdplay", "-o", "NULL", "-c", cue, *tracks)
    port = port_tool("cdplay", "-o", "NULL", "-c", cue, *tracks,
                     devices=False)
    assert port == ref
    assert port[0] == 0
    numbers = tracks or ["1", "2"]
    assert port[2].splitlines() == ["playing track %s" % (n,)
                                    for n in numbers]


@pytest.mark.parametrize("case", ["missing-image", "no-output"])
def test_cdplay_errors_are_the_references(tmp_path, case):
    (cue, _arr) = make_image(str(tmp_path), [3])
    args = (["-c", str(tmp_path / "none.cue"), "-o", "NULL"]
            if case == "missing-image" else ["-c", cue, "-o", "NOPE"])
    ref = ref_tool("cdplay", *args)
    port = port_tool("cdplay", *args, devices=False)
    assert port == ref
    assert port[0] == 1


def png(width, height):
    import struct
    import zlib

    def chunk(kind, data):
        return (struct.pack(">I", len(data)) + kind + data +
                struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))

    rows = b"".join(b"\x00" + bytes(3 * width) for _ in range(height))
    return (b"\x89PNG\r\n\x1a\n" +
            chunk(b"IHDR", struct.pack(">IIBBBBB", width, height, 8, 2, 0,
                                       0, 0)) +
            chunk(b"IDAT", zlib.compress(rows)) + chunk(b"IEND", b""))


@pytest.mark.parametrize("images", [0, 1, 2])
def test_coverview_is_the_references(tmp_path, monkeypatch, images):
    monkeypatch.delenv("DISPLAY", raising=False)
    path = str(tmp_path / "c.flac")
    track = flac_track(path, 9, seconds=0.05)
    metadata = track.get_metadata()
    for (i, size) in enumerate([(3, 2), (5, 4)][:images]):
        metadata.add_image(Image.new(png(*size), "cover %d" % (i,), i))
    track.set_metadata(metadata)
    ref = ref_tool("coverview", path)
    port = port_tool("coverview", path)
    assert port == ref
    if images:
        assert port[0] == 0 and len(port[1].splitlines()) == images
    else:
        assert port[0] == 1


def test_coverview_missing_file_is_the_references(tmp_path, monkeypatch):
    monkeypatch.delenv("DISPLAY", raising=False)
    path = str(tmp_path / "none.flac")
    assert port_tool("coverview", path) == ref_tool("coverview", path)


def test_the_tools_run_as_modules(album):
    """``python -m`` runs each new tool's main"""
    import subprocess
    import sys
    env = dict(os.environ, PYTHONPATH=os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    result = subprocess.run(
        [sys.executable, "-m", "audiotools_tpu_torch.cli.trackplay", "-o",
         "NULL", "--devices", "cpu", album[0]],
        capture_output=True, text=True, env=env, timeout=300)
    assert result.returncode == 0, result.stderr
    assert result.stderr.splitlines() == ["playing %s" % (album[0],)]
