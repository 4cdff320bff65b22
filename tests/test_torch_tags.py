"""Tags and foreign RIFF chunks through the port's command line, against
the reference's: ``track2track``, ``trackinfo`` and ``tracklength`` of
``audiotools_tpu_torch.cli`` with ``--devices cpu`` and those of
``audiotools_tpu.cli``, run in-process with ``-j 1`` as
``tests/test_torch_cli.py`` runs them, over one mixed album made and
tagged by the reference: FLAC, ALAC, TTA and WavPack tracks, each
tagged with every field (non-ASCII text, a "/" in the title) and a
front-cover PNG, an untagged WAVE and Shorten track, and a WAVE with a
LIST chunk before its data chunk and another chunk after it.  1 s at
8 kHz keeps the plain TTA, ALAC and WavPack loops short.

Files, lines and exit codes must be equal; ReplayGain's gains may
differ by 0.011 dB, the bound of
``test_torch_cli.py::test_replay_gain_agrees_with_the_reference``.
"""

import contextlib
import importlib
import io
import os
import socket
import struct
import time
import urllib.request
import zlib

import pytest
import torch

from audiotools_tpu import audiofile as ref_audiofile
from audiotools_tpu import dispatch as ref_dispatch
from audiotools_tpu import pcm as ref_pcm
from audiotools_tpu.pcmstream import PCMReader as RefPCMReader
from audiotools_tpu_torch import dispatch, pcm
from audiotools_tpu_torch.meta.ape import ApeTag, ApeTagItem, _existing_tag_size
from audiotools_tpu_torch.meta.image import InvalidImage
from test_torch_cli import (CLOCK, REFERENCE_ENV, _offline, as_port,
                            port_tool, read, ref_tool, signal)

torch.set_num_threads(1)

SR = 8000
FRAMES = SR
TYPES = ["wav", "flac", "alac", "tta", "shn", "wavpack"]
# the tagged sources: (file, class name, track number)
TAGGED = [("src/t1.flac", "flac", 1), ("src/t2.m4a", "alac", 2),
          ("src/t3.tta", "tta", 3), ("src/t4.wv", "wavpack", 4)]
MIXED = [path for (path, _name, _n) in TAGGED] + ["src/u5.wav",
                                                  "src/u6.shn"]
# names each output by its tags and its source's basename
MIXED_FORMAT = ["--format", "%(album_track_number)s %(track_name)s "
                "%(artist_name)s %(basename)s.%(suffix)s"]
BASENAME = ["--format", "%(basename)s.%(suffix)s"]
# the classes that keep foreign chunks (their from_wave)
CARRIERS = ["flac", "wavpack", "shn"]
TRACKINFO = [[], ["-n"], ["-L"], ["-b"], ["-%"], ["-C"]]
GAIN_DB = 0.011


def png_bytes(width, height):
    """a PNG of width x height RGB pixels, all black"""
    def chunk(name, body):
        return (struct.pack(">I", len(body)) + name + body +
                struct.pack(">I", zlib.crc32(name + body)))
    rows = b"".join(b"\x00" * (1 + 3 * width) for _ in range(height))
    return (b"\x89PNG\r\n\x1a\n" +
            chunk(b"IHDR", struct.pack(">IIBBBBB", width, height, 8, 2, 0, 0,
                                       0)) +
            chunk(b"IDAT", zlib.compress(rows)) + chunk(b"IEND", b""))


def full_metadata(number):
    """the reference's MetaData of every field, for track ``number``"""
    cover = ref_audiofile.Image.new(png_bytes(3 + number, 2), "cövér", 0)
    return ref_audiofile.MetaData(
        track_name="Sóng %d/Ä" % (number,), track_number=number,
        track_total=4, album_name="Àlbum", artist_name="Ärtïst",
        performer_name="Pérformer", composer_name="Cömposer",
        conductor_name="Cönductor", media="CD", ISRC="USRC1760783%d" %
        (number,), catalog="Çat-001", copyright="© 2026",
        publisher="Püblisher", year="2026", date="2026-10-17",
        album_number=1, album_total=1, comment="Cömment ∞",
        images=[cover])


def write_riff_wave(path, arr):
    """a WAVE of ``arr`` with a LIST chunk before its data chunk and an
    odd-sized chunk (and its pad byte) after it"""
    data = arr.astype("<i2").tobytes()
    fmt = struct.pack("<HHIIHH", 1, 2, SR, SR * 4, 4, 16)
    info = b"INFO" + b"ISFT" + struct.pack("<I", 5) + b"tpu!\x00\x00"
    chunks = (b"fmt " + struct.pack("<I", len(fmt)) + fmt +
              b"LIST" + struct.pack("<I", len(info)) + info +
              b"data" + struct.pack("<I", len(data)) + data +
              b"note" + struct.pack("<I", 5) + b"hello\x00")
    with open(path, "wb") as f:
        f.write(b"RIFF" + struct.pack("<I", 4 + len(chunks)) + b"WAVE" +
                chunks)


def ref_reader(arr):
    fl = ref_pcm.FrameList._wrap(arr, 16)
    return RefPCMReader(io.BytesIO(fl.to_bytes(False, True)), SR, 2, 3, 16)


def make_sources():
    """the album in src/, written and tagged by the reference"""
    os.makedirs("src")
    for (k, (path, name, number)) in enumerate(TAGGED):
        cls = ref_dispatch.TYPE_MAP[name]
        cls.from_pcm(path, ref_reader(signal(k + 1, FRAMES, SR)))
        cls(path).set_metadata(full_metadata(number))
    ref_dispatch.TYPE_MAP["wav"].from_pcm("src/u5.wav",
                                          ref_reader(signal(5, FRAMES, SR)))
    ref_dispatch.TYPE_MAP["shn"].from_pcm("src/u6.shn",
                                          ref_reader(signal(6, FRAMES, SR)))
    write_riff_wave("src/riff.wav", signal(7, FRAMES, SR))


def suffix(name):
    return dispatch.TYPE_MAP[name].SUFFIX


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """every tool run, each case once by each side: a dict of case ->
    ((ref code, stdout, stderr), (port code, stdout, stderr)), and the
    base directory"""
    base = tmp_path_factory.mktemp("tags")
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        for (key, value) in REFERENCE_ENV.items():
            mp.setenv(key, value)
        mp.setattr(time, "time", lambda: CLOCK)
        mp.setattr(urllib.request, "urlopen", _offline)
        mp.setattr(socket, "create_connection", _offline)
        mp.chdir(base)
        make_sources()

        def both(case, name, ref_args, port_args=None):
            out[case] = (ref_tool(name, *ref_args),
                         port_tool(name, *(port_args or
                                           [as_port(a) for a in ref_args])))

        for name in TYPES:
            both("mixed-" + name, "track2track",
                 ["-t", name, "-j", "1", "-d", "ref/mixed-" + name] +
                 MIXED_FORMAT + MIXED)
            both("riff-" + name, "track2track",
                 ["-t", name, "-j", "1", "-d", "ref/riff-" + name] +
                 BASENAME + ["src/riff.wav"])
        both("default", "track2track",
             ["-t", "flac", "-j", "1", "-d", "ref/default"] +
             [path for (path, _n, _k) in TAGGED])
        both("output", "track2track",
             ["-t", "alac", "-o", "ref/output.m4a", "src/t4.wv"])
        for name in CARRIERS:
            both("back-" + name, "track2track",
                 ["-t", "wav", "-j", "1", "-d", "ref/back-" + name] +
                 BASENAME + ["ref/riff-%s/riff.%s" % (name, suffix(name))])
        for name in ("wavpack", "tta"):
            both("rg-" + name, "track2track",
                 ["-t", name, "--replay-gain", "-j", "1", "-d",
                  "ref/rg-" + name] + MIXED_FORMAT +
                 [path for (path, _n, _k) in TAGGED])
        with open("src/notes.txt", "w") as f:
            f.write("not audio")
        listed = MIXED + ["src/riff.wav", "src/notes.txt",
                          "src/missing.flac"]
        for flags in TRACKINFO:
            both("info" + "".join(flags), "trackinfo", flags + listed,
                 flags + listed)
        both("length", "tracklength", ["src", "ref/mixed-flac"],
             ["src", "ref/mixed-flac"])
        both("length-files", "tracklength", MIXED, MIXED)
    return (base, out)


def files_of(base, side, case):
    directory = os.path.join(str(base), side, case)
    return {name: read(os.path.join(directory, name))
            for name in sorted(os.listdir(directory))}


CONVERSIONS = (["mixed-" + name for name in TYPES] +
               ["riff-" + name for name in TYPES] + ["default"] +
               ["back-" + name for name in CARRIERS])


@pytest.mark.parametrize("case", CONVERSIONS)
def test_track2track_writes_the_references_files(runs, case):
    (base, out) = runs
    ((ref_code, ref_out, ref_err), (code, stdout, stderr)) = out[case]
    assert (code, ref_code) == (0, 0), stderr
    assert (stdout, stderr) == (as_port(ref_out), as_port(ref_err))
    want = files_of(base, "ref", case)
    assert want
    got = files_of(base, "port", case)
    assert sorted(got) == sorted(want)
    for name in want:
        assert got[name] == want[name], name


def test_output_names_come_from_the_tags(runs):
    (base, _out) = runs
    assert sorted(files_of(base, "port", "default")) == [
        "0%d - Sóng %d-Ä.flac" % (n, n) for n in range(1, 5)]
    names = sorted(files_of(base, "port", "mixed-alac"))
    assert names[:2] == ["00   u5.m4a", "00   u6.m4a"]
    assert names[2:] == ["10%d Sóng %d-Ä Ärtïst t%d.m4a" % (n, n, n)
                         for n in range(1, 5)]


def test_output_option_carries_the_tags(runs):
    (base, out) = runs
    ((ref_code, ref_out, _), (code, stdout, stderr)) = out["output"]
    assert (code, ref_code, stdout, ref_out) == (0, 0, "", ""), stderr
    path = os.path.join(str(base), "port", "output.m4a")
    assert read(path) == read(os.path.join(str(base), "ref", "output.m4a"))
    metadata = dispatch.open(path, device="cpu").get_metadata()
    assert (metadata.track_name, metadata.track_number,
            metadata.artist_name) == ("Sóng 4/Ä", 4, "Ärtïst")


@pytest.mark.parametrize("name", TYPES)
def test_each_output_holds_its_sources_tags(runs, name):
    """every field the target holds equals the source's, and each cover
    its bytes (Shorten and WAVE hold none)"""
    (base, _out) = runs
    directory = os.path.join(str(base), "port", "mixed-" + name)
    for (path, _source, number) in TAGGED:
        source = dispatch.open(os.path.join(str(base), path),
                               device="cpu").get_metadata()
        [output] = [f for f in os.listdir(directory)
                    if f.endswith(" %s.%s" % (os.path.splitext(
                        os.path.basename(path))[0], suffix(name)))]
        metadata = dispatch.open(os.path.join(directory, output),
                                 device="cpu").get_metadata()
        if name in ("wav", "shn"):
            assert metadata is None
            continue
        assert metadata.track_number == number
        for field in metadata.FIELDS:
            if getattr(metadata, field) is not None:
                assert getattr(metadata, field) == getattr(source, field)
        assert [i.data for i in metadata.images()] == [
            i.data for i in source.images()]


@pytest.mark.parametrize("name", CARRIERS)
def test_foreign_chunks_round_trip_to_the_source_bytes(runs, name):
    (base, _out) = runs
    assert (files_of(base, "port", "back-" + name)["riff.wav"] ==
            read(os.path.join(str(base), "src", "riff.wav")))
    track = dispatch.open(os.path.join(str(base), "port", "riff-" + name,
                                       "riff." + suffix(name)),
                          device="cpu")
    assert track.has_foreign_wave_chunks()


def apetag_and_frames(path):
    """the APEv2 items of a file's tag ({key: text}) and the bytes
    before the tag"""
    with open(path, "rb") as f:
        tag = ApeTag.read(f)
        f.seek(0, 2)
        size = f.tell() - _existing_tag_size(f)
    return ({item.key: str(item) for item in tag.tags}, read(path)[:size])


@pytest.mark.parametrize("name", ["wavpack", "tta"])
def test_replay_gain_agrees_with_the_reference(runs, name):
    """WavPack's four replaygain_* items within GAIN_DB of the
    reference's, the peaks equal; TTA adds none, as the reference's"""
    (base, out) = runs
    ((ref_code, ref_out, ref_err), (code, stdout, stderr)) = out["rg-" + name]
    assert (code, ref_code) == (0, 0), stderr
    assert (stdout, stderr) == (as_port(ref_out), as_port(ref_err))
    assert "ReplayGain added" in stderr
    want = files_of(base, "ref", "rg-" + name)
    got = files_of(base, "port", "rg-" + name)
    assert sorted(got) == sorted(want)
    keys = ["replaygain_%s_%s" % (scope, kind) for scope in ("track", "album")
            for kind in ("gain", "peak")]
    for file_name in want:
        (ref_items, ref_frames) = apetag_and_frames(
            os.path.join(str(base), "ref", "rg-" + name, file_name))
        (items, frames) = apetag_and_frames(
            os.path.join(str(base), "port", "rg-" + name, file_name))
        assert frames == ref_frames
        if name == "tta":
            assert got[file_name] == want[file_name]
            assert not set(keys) & set(items)
            continue
        assert [k for k in items if k not in keys] == [
            k for k in ref_items if k not in keys]
        for key in keys:
            if key.endswith("gain"):
                assert items[key].endswith(" dB")
                assert abs(float(items[key][:-3]) -
                           float(ref_items[key][:-3])) <= GAIN_DB
            else:
                assert items[key] == ref_items[key]
        rg = dispatch.open(os.path.join(str(base), "port", "rg-" + name,
                                        file_name), device="cpu").replay_gain()
        assert rg.track_peak == float(ref_items["replaygain_track_peak"])


@pytest.mark.parametrize("flags", ["".join(f) or "plain" for f in TRACKINFO])
def test_trackinfo_prints_the_references_lines(runs, flags):
    ((ref_code, ref_out, ref_err), (code, stdout, stderr)) = runs[1][
        "info" + ("" if flags == "plain" else flags)]
    assert (code, stdout, stderr) == (ref_code, ref_out, ref_err)
    assert code == 0 and stderr.splitlines() == [
        "*** Error: src/notes.txt: src/notes.txt",
        "*** Error: src/missing.flac: [Errno 2] No such file or directory: "
        "'src/missing.flac'"]
    if flags in ("plain", "-L"):
        assert "Sóng 1/Ä" in stdout


@pytest.mark.parametrize("case", ["length", "length-files"])
def test_tracklength_prints_the_references_total(runs, case):
    ((ref_code, ref_out, ref_err), (code, stdout, stderr)) = runs[1][case]
    assert (code, stdout, stderr) == (ref_code, ref_out, ref_err)
    assert code == 0 and stdout.strip() == (
        "0:00:13" if case == "length" else "0:00:06")


def test_a_tag_the_target_cannot_write_raises(tmp_path, monkeypatch):
    """a cover of no known image type in an APEv2 tag: converting the
    track to ALAC raises InvalidImage in set_metadata on both sides.
    The reference's tool lets it out of main; the port's fails the job
    with the same text, exit code 1 and no output file."""
    from audiotools_tpu.meta.image import InvalidImage as RefInvalidImage
    for (key, value) in REFERENCE_ENV.items():
        monkeypatch.setenv(key, value)
    monkeypatch.setattr(time, "time", lambda: CLOCK)
    monkeypatch.chdir(tmp_path)
    track = dispatch.TYPE_MAP["tta"].from_pcm(
        "a.tta", pcm.reader_from_array(signal(1, 800, SR), 16, SR),
        device="cpu")
    track.update_metadata(ApeTag([ApeTagItem.binary(
        "Cover Art (front)", b"desc\x00not an image")]))
    with pytest.raises(InvalidImage):
        track.get_metadata().images()
    with pytest.raises(RefInvalidImage) as ref_err:
        ref_tool("track2track", "-t", "alac", "-j", "1", "-d", "ref",
                 "a.tta")
    assert port_tool("track2track", "-t", "alac", "-j", "1", "-d", "port",
                     "a.tta") == (1, "", "*** Error: %s\n" % (ref_err.value,))
    assert not os.path.exists("port") or os.listdir("port") == []


@pytest.mark.cuda
def test_the_card_writes_the_cpu_runs_files(runs, tmp_path, monkeypatch):
    """the mixed album through the card, two workers: the CPU run's
    files, tags and foreign chunks included"""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    for (key, value) in REFERENCE_ENV.items():
        monkeypatch.setenv(key, value)
    monkeypatch.setattr(time, "time", lambda: CLOCK)
    (base, _out) = runs
    module = importlib.import_module("audiotools_tpu_torch.cli.track2track")
    for name in TYPES:
        for (case, fmt, sources) in (("mixed-", MIXED_FORMAT, MIXED),
                                     ("riff-", BASENAME, ["src/riff.wav"])):
            dest = str(tmp_path / (case + name))
            with contextlib.redirect_stdout(io.StringIO()):
                assert module.main(
                    ["-t", name, "-j", "2", "-d", dest] + fmt +
                    [os.path.join(str(base), s) for s in sources]) == 0
            want = files_of(base, "port", case + name)
            assert sorted(os.listdir(dest)) == sorted(want)
            for (file_name, data) in want.items():
                assert read(os.path.join(dest, file_name)) == data, (
                    case + name, file_name)
