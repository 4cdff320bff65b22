"""The port's command line against the reference's: track2track,
trackverify and trackcmp of ``audiotools_tpu_torch.cli`` with
``--devices cpu`` and those of ``audiotools_tpu.cli`` (run in-process,
``-j 1``, on their host paths) over the same seeded signals: 2 s at
8 kHz (short enough for the plain TTA, ALAC and WavPack loops), and
0.1 s at 44.1 kHz for the AccurateRip sums, which only CD-format tracks
get.

The reference encodes FLAC and ALAC on its numpy backend with exact
uploads and no emit-stage Rice re-search, the configuration the port's
encoders follow; ALAC's creation time is pinned in both runs.  Its
AccurateRip database lookup is kept off the network.
"""

import contextlib
import importlib
import io
import os
import re
import socket
import struct
import time
import urllib.request

import numpy as np
import pytest
import torch

from audiotools_tpu.formats.flac import FlacAudio as RefFlacAudio
from audiotools_tpu.formats.wav import WaveAudio as RefWaveAudio
from audiotools_tpu import pcm as ref_pcm
from audiotools_tpu.pcmstream import PCMReader as RefPCMReader
from audiotools_tpu_torch import dispatch, pcm
from audiotools_tpu_torch.formats import flac
from audiotools_tpu_torch.formats.wav import WaveAudio
from cli_harness import run_tool

torch.set_num_threads(1)

SR = 8000
CD = 44100
FORMAT = ["--format", "%(basename)s.%(suffix)s"]
REFERENCE_ENV = {"ATPU_FLAC_BACKEND": "numpy", "ATPU_FLAC_QPACK": "0",
                 "ATPU_EMIT_EXACT_RICE": "0", "ATPU_ALAC_BACKEND": "numpy",
                 "ATPU_ALAC_QPACK": "0"}
CLOCK = 1.7e9

# (case, track2track arguments, sources); a case writes into its own
# directory, the port's with --devices cpu
CONVERSIONS = [
    ("wav-flac-0", ["-t", "flac", "-q", "0"], ["src/a.wav"]),
    ("wav-flac-8", ["-t", "flac", "-q", "8"], ["src/a.wav"]),
    ("wav-alac", ["-t", "alac"], ["src/a.wav"]),
    ("wav-tta", ["-t", "tta"], ["src/a.wav"]),
    ("wav-shn", ["-t", "shn"], ["src/a.wav"]),
    ("wav-wavpack-fast", ["-t", "wavpack", "-q", "fast"], ["src/a.wav"]),
    ("wav-wavpack-standard", ["-t", "wavpack", "-q", "standard"],
     ["src/a.wav"]),
    ("flac-flac", ["-t", "flac"], ["src/a.flac"]),
    ("flac-alac", ["-t", "alac"], ["src/a.flac"]),
    ("flac-tta", ["-t", "tta"], ["src/a.flac"]),
    ("flac-shn", ["-t", "shn"], ["src/a.flac"]),
    ("flac-wavpack", ["-t", "wavpack"], ["src/a.flac"]),
    # also WAVE to FLAC at -q 5
    ("album", ["-t", "flac", "-q", "5"], ["src/a.wav", "src/b.wav"]),
]
GOOD = ["wav-flac-8/a.flac", "wav-alac/a.m4a", "wav-tta/a.tta",
        "wav-shn/a.shn", "wav-wavpack-standard/a.wv"]


def signal(seed, frames, rate):
    t = np.arange(frames)
    rng = np.random.default_rng(seed)
    arr = np.stack([8000 * np.sin(2 * np.pi * 440 * t / rate) +
                    rng.normal(0, 200, frames),
                    7000 * np.sin(2 * np.pi * (550 + 50 * seed) * t / rate)],
                   axis=1)
    return np.clip(arr, -32768, 32767).astype(np.int32)


def write_wave(path, arr, rate):
    WaveAudio.from_pcm(path, pcm.reader_from_array(arr, 16, rate))


def port_tool(name, *args):
    """runs the port's tool in-process: (exit code, stdout, stderr)"""
    module = importlib.import_module("audiotools_tpu_torch.cli." + name)
    (out, err) = (io.StringIO(), io.StringIO())
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        try:
            code = module.main(list(args) + ["--devices", "cpu"])
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


def _offline(*_args, **_kwargs):
    raise OSError("network access is disabled in the tests")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """every tool run, each case once by each side: a dict of case ->
    ((ref code, stdout, stderr), (port code, stdout, stderr)), and the
    base directory"""
    base = tmp_path_factory.mktemp("cli")
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        for (key, value) in REFERENCE_ENV.items():
            mp.setenv(key, value)
        mp.setattr(time, "time", lambda: CLOCK)
        mp.setattr(urllib.request, "urlopen", _offline)
        mp.setattr(socket, "create_connection", _offline)
        mp.chdir(base)
        os.makedirs("src")
        write_wave("src/a.wav", signal(1, 2 * SR, SR), SR)
        write_wave("src/b.wav", signal(2, 2 * SR, SR), SR)
        off = signal(1, 2 * SR, SR)
        off[SR // 3, 1] += 1
        write_wave("src/off.wav", off, SR)
        write_wave("src/cd.wav", signal(3, CD // 10, CD), CD)
        RefFlacAudio.from_pcm("src/a.flac", RefWaveAudio("src/a.wav").to_pcm(),
                              compression="8")

        def both(case, name, ref_args, port_args=None):
            out[case] = (ref_tool(name, *ref_args),
                         port_tool(name, *(port_args or
                                           [as_port(a) for a in ref_args])))

        for (case, args, sources) in CONVERSIONS:
            both(case, "track2track",
                 args + FORMAT + ["-j", "1", "-d", "ref/" + case] + sources)
        both("output", "track2track",
             ["-t", "flac", "-o", "ref/output.flac", "src/a.wav"])
        # the port's farm with two workers, against the reference's album
        out["album-j2"] = (out["album"][0], port_tool(
            "track2track", "-t", "flac", "-q", "5", *FORMAT, "-j", "2",
            "-d", "port/album-j2", "src/a.wav", "src/b.wav"))
        both("replay-gain", "track2track",
             ["-t", "flac", "--replay-gain"] + FORMAT +
             ["-j", "1", "-d", "ref/replay-gain", "src/a.wav", "src/b.wav"])
        both("sample-rate", "track2track",
             ["-t", "flac", "--sample-rate", "48000"] + FORMAT +
             ["-j", "1", "-d", "ref/sample-rate", "src/a.wav"])
        for name in ("flac", "alac", "shn", "wavpack"):
            both("cd-" + name, "track2track",
                 ["-t", name] + FORMAT + ["-j", "1", "-d", "ref/cd-" + name,
                                          "src/cd.wav"])
        both("off", "track2track", ["-t", "flac"] + FORMAT +
             ["-j", "1", "-d", "ref/off", "src/off.wav"])

        # damaged copies of the good files, the same bytes for both
        os.makedirs("damaged")
        damaged = []
        for name in GOOD:
            data = read("ref/" + name)
            (stem, suffix) = os.path.basename(name).split(".")
            for (tag, body) in (
                    ("half", data[:len(data) // 2]),
                    ("flip", data[:len(data) * 3 // 4] +
                     bytes([data[len(data) * 3 // 4] ^ 0x55]) +
                     data[len(data) * 3 // 4 + 1:])):
                path = "damaged/%s-%s.%s" % (stem, tag, suffix)
                with open(path, "wb") as f:
                    f.write(body)
                damaged.append(path)
        with open("damaged/half.wav", "wb") as f:
            f.write(read("src/a.wav")[:SR])
        damaged.append("damaged/half.wav")
        good = ["ref/" + name for name in GOOD] + ["src/a.wav"]
        cd = ["ref/cd-flac/cd.flac", "ref/cd-alac/cd.m4a",
              "ref/cd-shn/cd.shn", "ref/cd-wavpack/cd.wv", "src/cd.wav"]
        truncated = [path for path in damaged if "half" in path]
        for (case, args) in (
                ("verify-good", good),
                ("verify-damaged", damaged),
                ("verify-ar-truncated", ["--accuraterip"] + truncated),
                ("verify-ar-cd", ["--accuraterip"] + cd)):
            both(case, "trackverify", ["-j", "1"] + args,
                 ["-j", "1"] + args)
        pairs = ["src/a.wav", "ref/wav-flac-8/a.flac",
                 "src/a.wav", "ref/off/off.flac",
                 "ref/wav-shn/a.shn", "ref/flac-flac/a.flac",
                 "src/b.wav", "ref/wav-flac-8/a.flac"]
        both("cmp", "trackcmp", ["-j", "1"] + pairs, ["-j", "1"] + pairs)
        both("cmp-dirs", "trackcmp", ["-j", "1", "ref/wav-shn",
                                      "ref/flac-shn"],
             ["-j", "1", "ref/wav-shn", "ref/flac-shn"])
    return (base, out)


def files_of(base, case):
    directory = os.path.join(str(base), "ref", case)
    return sorted(os.listdir(directory))


@pytest.mark.parametrize("case", [c[0] for c in CONVERSIONS] +
                         ["album-j2", "cd-flac", "cd-alac", "cd-shn",
                          "cd-wavpack", "off"])
def test_track2track_writes_the_references_files(runs, case):
    (base, out) = runs
    ((ref_code, ref_out, _), (code, stdout, stderr)) = out[case]
    assert (code, ref_code) == (0, 0), stderr
    names = files_of(base, "album" if case == "album-j2" else case)
    assert names
    assert sorted(os.listdir(os.path.join(str(base), "port", case))) == names
    for name in names:
        assert (read(os.path.join(str(base), "port", case, name)) ==
                read(os.path.join(str(base), "ref",
                                  case.replace("-j2", ""), name))), name
    if case == "album-j2":
        stdout = stdout.replace("album-j2", "album")
        assert sorted(stdout.splitlines()) == sorted(
            as_port(ref_out).splitlines())
    else:
        assert stdout == as_port(ref_out)


def test_track2track_output_option(runs):
    (base, out) = runs
    ((ref_code, ref_out, _), (code, stdout, stderr)) = out["output"]
    assert (code, ref_code, stdout, ref_out) == (0, 0, "", ""), stderr
    assert (read(os.path.join(str(base), "port", "output.flac")) ==
            read(os.path.join(str(base), "ref", "output.flac")))


@pytest.mark.parametrize("case,want_code", [
    ("verify-good", 0), ("verify-damaged", 1), ("verify-ar-truncated", 1),
    ("verify-ar-cd", 0), ("cmp", 1), ("cmp-dirs", 0)])
def test_trackverify_and_trackcmp_print_the_references_lines(runs, case,
                                                             want_code):
    ((ref_code, ref_out, _), (code, stdout, _stderr)) = runs[1][case]
    assert code == ref_code == want_code
    assert stdout == ref_out
    if case == "verify-ar-cd":
        assert stdout.count("AccurateRip v1=") == 5


def flac_blocks_and_frames(path):
    """{block type: [bodies]} and the frame bytes of a FLAC file"""
    data = read(path)
    (pos, last, blocks) = (4, 0, {})
    while not last:
        (last, block_type) = (data[pos] >> 7, data[pos] & 0x7F)
        size = int.from_bytes(data[pos + 1:pos + 4], "big")
        blocks.setdefault(block_type, []).append(data[pos + 4:pos + 4 + size])
        pos += 4 + size
    return (blocks, data[pos:])


def test_replay_gain_agrees_with_the_reference(runs):
    (base, out) = runs
    ((ref_code, ref_out, _), (code, stdout, stderr)) = out["replay-gain"]
    assert (code, ref_code) == (0, 0), stderr
    assert stdout == as_port(ref_out)
    for name in ("a.flac", "b.flac"):
        port_path = os.path.join(str(base), "port", "replay-gain", name)
        ref_path = os.path.join(str(base), "ref", "replay-gain", name)
        (blocks, frames) = flac_blocks_and_frames(port_path)
        (ref_blocks, ref_frames) = flac_blocks_and_frames(ref_path)
        assert frames == ref_frames
        for block_type in (0, 3):      # STREAMINFO, SEEKTABLE
            assert blocks[block_type] == ref_blocks[block_type]
        port_gain = flac.FlacAudio(port_path, device="cpu").replay_gain()
        ref_gain = RefFlacAudio(ref_path).replay_gain()
        assert abs(port_gain.track_gain - float(ref_gain.track_gain)) <= 0.011
        assert abs(port_gain.album_gain - float(ref_gain.album_gain)) <= 0.011
        assert port_gain.track_peak == float(ref_gain.track_peak)
        assert port_gain.album_peak == float(ref_gain.album_peak)


def test_sample_rate_conversion_agrees_with_the_reference(runs):
    (base, out) = runs
    ((ref_code, ref_out, _), (code, stdout, stderr)) = out["sample-rate"]
    assert (code, ref_code) == (0, 0), stderr
    assert stdout == as_port(ref_out)
    got = flac.FlacAudio(os.path.join(str(base), "port", "sample-rate",
                                      "a.flac"), device="cpu")
    want = RefFlacAudio(os.path.join(str(base), "ref", "sample-rate",
                                     "a.flac"))
    assert (got.sample_rate(), got.total_frames()) == (48000, 2 * 48000)
    got_samples = pcm.read_all(got.to_pcm())
    want_samples = want.to_pcm().read(1 << 20).samples
    assert got_samples.shape == want_samples.shape
    diff = np.abs(got_samples.astype(np.int64) - want_samples)
    assert diff.max() <= 1
    assert np.count_nonzero(diff) < 1e-4 * diff.size


# error exits: (arguments, the stderr line both print, or None where the
# texts differ by design)
ERRORS = [
    (["-t", "flac", "-q", "99", "-d", "x", "src/a.wav"],
     "*** Error: \"99\" is not a supported compression mode for type "
     "\"flac\""),
    (["-t", "flac", "-d", "x", "src/missing.wav"],
     "*** Error: you must specify at least 1 supported audio file"),
    (["-t", "nosuch", "-d", "x", "src/a.wav"],
     "*** Error: unsupported audio type \"nosuch\""),
    (["-t", "flac", "-o", "x.flac", "src/a.wav", "src/b.wav"],
     "*** Error: you may specify only 1 input file for use with -o"),
    (["-t", "wav", "-d", "src", "--format", "%(basename)s.%(suffix)s",
      "src/a.wav"],
     "*** Error: src/a.wav cannot be both input and output file"),
    (["-t", "flac", "-d", "x", "src/a.wav", "src/b.wav"],
     "*** Error: output file occurs more than once; use --format with "
     "distinguishing fields"),
    (["-t", "flac", "-d", "x", "--format", "%(nosuch)s", "src/a.wav"],
     None),
]


@pytest.mark.parametrize("args,line", ERRORS)
def test_error_exits_are_the_references(tmp_path, monkeypatch, args, line):
    monkeypatch.chdir(tmp_path)
    os.makedirs("src")
    write_wave("src/a.wav", signal(1, 800, SR), SR)
    write_wave("src/b.wav", signal(2, 800, SR), SR)
    port = port_tool("track2track", *args)
    assert port[0] == 1
    assert not os.path.exists("x") or not os.listdir("x")
    if line is None:
        assert port[2].startswith("*** Error: ")
        return
    ref = ref_tool("track2track", *args)
    assert ref[0] == 1
    assert line in port[2].splitlines()
    assert line in ref[2].splitlines()


@pytest.mark.parametrize("flag", ["-I", "-M"])
def test_interactive_and_lookup_are_refused(tmp_path, flag):
    path = str(tmp_path / "a.wav")
    write_wave(path, signal(1, 800, SR), SR)
    (code, stdout, stderr) = port_tool("track2track", flag, "-t", "flac",
                                       "-d", str(tmp_path / "out"), path)
    assert (code, stdout) == (1, "")
    assert "not ported" in stderr
    assert not os.path.exists(str(tmp_path / "out"))


def foreign_chunk_wave(path, arr):
    """a WAVE file with a LIST chunk after its data chunk"""
    write_wave(path, arr, SR)
    data = bytearray(read(path))
    extra = b"LIST" + (12).to_bytes(4, "little") + b"INFOISFT\x00\x00\x00\x00"
    data += extra
    data[4:8] = (len(data) - 8).to_bytes(4, "little")
    with open(path, "wb") as f:
        f.write(bytes(data))


def convert_both(args, source):
    """``track2track`` of the reference into ref/ and of the port into
    port/ (cwd), each -j 1: the two (exit code, stdout, stderr) and the
    files each wrote, {name: bytes}"""
    ref = ref_tool("track2track", *args, "-j", "1", "-d", "ref", source)
    port = port_tool("track2track", *args, "-j", "1", "-d", "port", source)
    return (ref, port, {name: read(os.path.join("ref", name))
                        for name in os.listdir("ref")},
            {name: read(os.path.join("port", name))
             for name in os.listdir("port")})


@pytest.mark.parametrize("type_name", ["flac", "wavpack", "alac"])
def test_a_wave_with_foreign_chunks_is_refused(tmp_path, monkeypatch,
                                               type_name):
    """named for the refusal it once checked, which is gone: a WAVE with
    a LIST chunk after its data chunk converts to the reference's file,
    the chunk kept by FLAC's and WavPack's from_wave and dropped by
    ALAC, which has none"""
    for (key, value) in REFERENCE_ENV.items():
        monkeypatch.setenv(key, value)
    monkeypatch.setattr(time, "time", lambda: CLOCK)
    monkeypatch.chdir(tmp_path)
    foreign_chunk_wave("a.wav", signal(1, 800, SR))
    (ref, port, ref_files, port_files) = convert_both(
        ["-t", type_name] + FORMAT, "a.wav")
    assert ref[:2] == (0, "a.wav -> ref/a.%s\n" % (
        dispatch.TYPE_MAP[type_name].SUFFIX,))
    assert port[:2] == (0, as_port(ref[1])), port[2]
    assert port_files == ref_files
    [output] = port_files
    track = dispatch.open(os.path.join("port", output), device="cpu")
    if type_name != "alac":
        assert track.has_foreign_wave_chunks()


def tagged_flac(path):
    """a FLAC file that the reference tags with a title and a number"""
    from audiotools_tpu.audiofile import MetaData
    arr = signal(4, 3000, SR)
    fl = ref_pcm.FrameList._wrap(arr, 16)
    track = RefFlacAudio.from_pcm(
        path, RefPCMReader(io.BytesIO(fl.to_bytes(False, True)), SR, 2, 3,
                           16))
    track.set_metadata(MetaData(track_name="A Title", track_number=3))


def test_flac_to_flac_carries_the_comments(tmp_path, monkeypatch):
    for (key, value) in REFERENCE_ENV.items():
        monkeypatch.setenv(key, value)
    monkeypatch.chdir(tmp_path)
    tagged_flac("t.flac")
    args = ["-t", "flac"] + FORMAT + ["-j", "1"]
    assert ref_tool("track2track", *args, "-d", "ref", "t.flac")[0] == 0
    assert port_tool("track2track", *args, "-d", "port", "t.flac")[0] == 0
    assert read("port/t.flac") == read("ref/t.flac")
    metadata = flac.FlacAudio("port/t.flac", device="cpu").get_metadata()
    assert sorted(metadata.get_block(4).keys()) == ["TITLE", "TRACKNUMBER"]
    assert (metadata.track_name, metadata.track_number) == ("A Title", 3)


@pytest.mark.parametrize("type_name", ["alac", "tta", "shn", "wavpack"])
def test_tags_that_cannot_be_carried_fail_the_job(tmp_path, monkeypatch,
                                                  type_name):
    """named for the refusal it once checked, which is gone: no job
    fails for its tags, and a tagged FLAC converts to the reference's
    file, the title and number written into the target's tags (none
    for Shorten, which holds none)"""
    for (key, value) in REFERENCE_ENV.items():
        monkeypatch.setenv(key, value)
    monkeypatch.setattr(time, "time", lambda: CLOCK)
    monkeypatch.chdir(tmp_path)
    tagged_flac("t.flac")
    (ref, port, ref_files, port_files) = convert_both(
        ["-t", type_name], "t.flac")
    assert ref[0] == 0 and port[:2] == (0, as_port(ref[1])), port[2]
    assert port_files == ref_files
    [output] = port_files
    assert output == "03 - A Title." + dispatch.TYPE_MAP[type_name].SUFFIX
    metadata = dispatch.open(os.path.join("port", output),
                             device="cpu").get_metadata()
    if type_name == "shn":
        assert metadata is None
    else:
        assert (metadata.track_name, metadata.track_number) == ("A Title", 3)


def test_the_tools_default_to_the_card(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    path = str(tmp_path / "a.wav")
    write_wave(path, signal(1, 800, SR), SR)
    for (name, args) in (("track2track", ["-t", "flac", "-d",
                                          str(tmp_path / "out"), path]),
                         ("trackverify", [path]),
                         ("trackcmp", [path, path])):
        module = importlib.import_module("audiotools_tpu_torch.cli." + name)
        err = io.StringIO()
        with contextlib.redirect_stderr(err), \
                contextlib.redirect_stdout(io.StringIO()):
            assert module.main(args) == 1
        assert "cuda" in err.getvalue()
    assert not os.path.exists(str(tmp_path / "out"))


@pytest.mark.cuda
def test_the_card_writes_the_cpu_runs_files(runs, tmp_path, monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    # the CPU run's settings: the port's host FLAC emitter reads
    # ATPU_EMIT_EXACT_RICE as the reference's does
    for (key, value) in REFERENCE_ENV.items():
        monkeypatch.setenv(key, value)
    monkeypatch.setattr(time, "time", lambda: CLOCK)
    (base, _out) = runs
    for (case, args, sources) in CONVERSIONS:
        dest = str(tmp_path / case)
        module = importlib.import_module("audiotools_tpu_torch.cli."
                                         "track2track")
        with contextlib.redirect_stdout(io.StringIO()):
            assert module.main(
                args + FORMAT + ["-j", "2", "-d", dest] +
                [os.path.join(str(base), s) for s in sources]) == 0
        for name in files_of(base, case):
            assert read(os.path.join(dest, name)) == read(
                os.path.join(str(base), "port", case, name)), (case, name)


@pytest.mark.parametrize("args", [["-t", "flac", "-q", "8"],
                                  ["-t", "flac", "-q", "0"],
                                  ["-t", "alac"]])
def test_track2track_default_environment_writes_the_references_files(
        tmp_path, monkeypatch, args):
    """no ATPU_* variable set: both tools take their default routes, the
    quantized upload wires, and write the same files"""
    for key in list(os.environ):
        if key.startswith("ATPU_"):
            monkeypatch.delenv(key)
    monkeypatch.setattr(time, "time", lambda: CLOCK)
    monkeypatch.chdir(tmp_path)
    os.makedirs("src")
    # a tonal track, whose quantized analysis the floor retries repair
    t = np.arange(2 * SR)
    tone = np.stack([12000 * np.sin(2 * np.pi * 300 * t / SR),
                     9000 * np.sin(2 * np.pi * 450 * t / SR)], axis=1)
    write_wave("src/t.wav", tone.astype(np.int32), SR)
    write_wave("src/a.wav", signal(4, 2 * SR, SR), SR)
    sources = ["src/a.wav", "src/t.wav"]
    ref = ref_tool("track2track", *(args + FORMAT + ["-j", "1", "-d", "ref"]
                                    + sources))
    port = port_tool("track2track", *(args + FORMAT + ["-j", "2", "-d",
                                                       "port"] + sources))
    assert (ref[0], port[0]) == (0, 0), port[2]
    names = sorted(os.listdir("ref"))
    assert len(names) == 2 and sorted(os.listdir("port")) == names
    for name in names:
        assert read(os.path.join("port", name)) == read(
            os.path.join("ref", name)), name


@pytest.mark.parametrize("damage", ["truncated", "partial-frame"])
def test_track2track_to_wave_of_a_short_data_chunk(tmp_path, monkeypatch,
                                                   damage):
    """a WAVE with a foreign chunk (so that both tools convert it through
    ``from_wave``) whose data chunk is cut short, or is not a whole
    number of frames, converted to WAVE by both tools: the same exit
    code, lines and files (the reference writes the PCM it reads, as
    read)"""
    for (key, value) in REFERENCE_ENV.items():
        monkeypatch.setenv(key, value)
    monkeypatch.chdir(tmp_path)
    os.makedirs("src")
    write_wave("src/w.wav", signal(5, SR // 2, SR), SR)
    data = read("src/w.wav")
    pos = data.index(b"data")
    (size,) = struct.unpack("<I", data[pos + 4:pos + 8])
    pcm_bytes = data[pos + 8:pos + 8 + size]
    if damage == "truncated":
        # the header's size kept, 1001 bytes of PCM gone
        body = struct.pack("<4sI", b"data", size) + pcm_bytes[:-1001]
    else:
        # one byte past the last whole frame, and the pad byte
        body = (struct.pack("<4sI", b"data", size + 1) + pcm_bytes +
                b"\x07\x00")
    chunks = (data[12:pos] + b"LIST" + struct.pack("<I", 10) +
              b"INFOabcdef" + body)
    with open("src/w.wav", "wb") as f:
        f.write(struct.pack("<4sI4s", b"RIFF", 4 + len(chunks), b"WAVE") +
                chunks)
    ref = ref_tool("track2track", "-t", "wav", *FORMAT, "-j", "1", "-d",
                   "ref", "src/w.wav")
    port = port_tool("track2track", "-t", "wav", *FORMAT, "-j", "1", "-d",
                     "port", "src/w.wav")
    assert port[:2] == (ref[0], as_port(ref[1])), (ref, port)
    assert port[2] == as_port(ref[2])
    names = sorted(os.listdir("ref")) if os.path.isdir("ref") else []
    assert names
    assert sorted(os.listdir("port")) == names
    for name in names:
        assert read(os.path.join("port", name)) == read(
            os.path.join("ref", name)), name


# ---------------------------------------------------------------------------
# the lossy types: MP3, MP2, Ogg Vorbis and Opus through the tools

LOSSY = {"mp3": ("mp3", "5"), "mp2": ("mp2", "128"), "vorbis": ("ogg", "6"),
         "opus": ("opus", "3")}


def lossy_available(name):
    """the reference's class for ``name`` when it is available (its
    library found), else the test is skipped"""
    from audiotools_tpu import dispatch as ref_dispatch
    if name not in ref_dispatch.TYPE_MAP:
        pytest.skip("the libraries of %s are not found" % (name,))
    assert name in dispatch.TYPE_MAP


@pytest.fixture(scope="module")
def lossy_runs(tmp_path_factory):
    """each lossy type's tool runs by each side: track2track from a
    FLAC -8 file at the default quality and at another, and the first
    back to FLAC; tracktag (fields, a PNG front cover, --replay-gain,
    which adds nothing without mp3gain or vorbisgain, as the
    reference's); trackinfo and trackverify; a dict of (case, type) ->
    (ref result, port result), and the base directory"""
    from audiotools_tpu import dispatch as ref_dispatch
    base = tmp_path_factory.mktemp("lossy")
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        for (key, value) in REFERENCE_ENV.items():
            mp.setenv(key, value)
        # the reference's trackverify --accuraterip looks the sums up
        # over the network
        mp.setattr(urllib.request, "urlopen", _offline)
        mp.setattr(socket, "create_connection", _offline)
        mp.chdir(base)
        os.makedirs("src")
        write_wave("src/a.wav", signal(7, CD, CD), CD)
        write_wave("src/b.wav", signal(8, CD, CD), CD)
        with open("src/two.cue", "w") as f:
            f.write('FILE "x.wav" WAVE\n  TRACK 01 AUDIO\n'
                    '    INDEX 01 00:00:00\n  TRACK 02 AUDIO\n'
                    '    INDEX 01 00:00:30\n')
        RefFlacAudio.from_pcm("src/a.flac",
                              RefWaveAudio("src/a.wav").to_pcm(),
                              compression="8")
        with open("src/cover.png", "wb") as f:
            f.write(b"\x89PNG\r\n\x1a\n\x00\x00\x00\rIHDR" +
                    struct.pack(">II", 9, 7) + bytes([8, 2, 0, 0, 0]) +
                    b"\x00" * 4)

        def both(key, name, args):
            out[key] = (ref_tool(name, *args),
                        port_tool(name, *[as_port(a) for a in args]))

        for (name, (suffix, quality)) in LOSSY.items():
            if name not in ref_dispatch.TYPE_MAP:
                continue
            lossy = "ref/%s/a.%s" % (name, suffix)
            both(("t2t", name), "track2track",
                 ["-t", name] + FORMAT + ["-j", "1", "-d", "ref/" + name,
                                          "src/a.flac"])
            both(("t2t-q", name), "track2track",
                 ["-t", name, "-q", quality, "-o",
                  "ref/%s-q.%s" % (name, suffix), "src/a.flac"])
            both(("back", name), "track2track",
                 ["-t", "flac"] + FORMAT + ["-j", "1", "-d",
                                            "ref/%s-back" % (name,), lossy])
            # a cover where the tags hold one (ID3; Vorbis comments
            # hold none, and both tools fail the file)
            cover = (["--front-cover", "src/cover.png"]
                     if name in ("mp3", "mp2") else [])
            both(("tag", name), "tracktag",
                 ["--name", "Söng", "--artist", "Artist", "--number", "4",
                  "--track-total", "11", "--album", "Album", "--year",
                  "2020", "--comment", "a comment", "--replay-gain"] +
                 cover + [lossy])
            both(("cover", name), "tracktag",
                 ["--front-cover", "src/cover.png", "src/a.flac",
                  "ref/%s-q.%s" % (name, suffix)])
            both(("retag", name), "tracktag",
                 ["--remove-artist", "--album-number", "2", lossy])
            for args in ([], ["-n"], ["-L"], ["-b"], ["-C"]):
                both(("info" + "".join(args), name), "trackinfo",
                     args + [lossy])
            both(("verify", name), "trackverify",
                 ["-j", "1", "--accuraterip", lossy])
            both(("cmp", name), "trackcmp",
                 ["-j", "1", lossy, "ref/%s-back/a.flac" % (name,)])
            both(("bad-q", name), "track2track",
                 ["-t", name, "-q", "99", "-o", "ref/x." + suffix,
                  "src/a.flac"])
            # an album: lint, length, joined and split
            album = "ref/%s-album" % (name,)
            both(("album", name), "track2track",
                 ["-t", name] + FORMAT + ["-j", "1", "-d", album,
                                          "src/a.wav", "src/b.wav"])
            first = "%s/a.%s" % (album, suffix)
            both(("untidy", name), "tracktag",
                 ["--name", "  padded  ", "--number", "3", first])
            both(("lint", name), "tracklint", [first])
            both(("lint-fix", name), "tracklint", ["--fix", first])
            both(("length", name), "tracklength", [album])
            both(("cat-from", name), "trackcat",
                 ["-t", "flac", "-o", "ref/%s-cat.flac" % (name,), first,
                  "%s/b.%s" % (album, suffix)])
            both(("cat-to", name), "trackcat",
                 ["-t", name, "-o", "ref/%s-cat.%s" % (name, suffix),
                  "src/a.wav", "src/b.wav"])
            both(("split-to", name), "tracksplit",
                 ["-t", name, "--cue", "src/two.cue", "-j", "1", "-d",
                  "ref/%s-split-to" % (name,), "ref/%s-cat.flac" % (name,)])
            both(("split-from", name), "tracksplit",
                 ["-t", "flac", "--cue", "src/two.cue", "-j", "1", "-d",
                  "ref/%s-split-from" % (name,),
                  "ref/%s-cat.%s" % (name, suffix)])
    return (base, out)


@pytest.mark.parametrize("name", sorted(LOSSY))
def test_track2track_to_and_from_a_lossy_type(lossy_runs, name):
    """FLAC to each lossy type (the default quality and another) and
    back to FLAC: the reference's files, lines and exit codes, and the
    FLAC that comes back holds the lossy file's PCM"""
    lossy_available(name)
    (base, out) = lossy_runs
    suffix = LOSSY[name][0]
    for case in ("t2t", "t2t-q", "back", "bad-q"):
        (ref, port) = out[(case, name)]
        assert port == (ref[0], as_port(ref[1]), as_port(ref[2])), case
    assert out[("bad-q", name)][1][0] == 1
    for (path, ref_path) in (
            ("port/%s/a.%s" % (name, suffix), None),
            ("port/%s-q.%s" % (name, suffix), None),
            ("port/%s-back/a.flac" % (name,), None)):
        ref_path = path.replace("port/", "ref/", 1)
        assert read(os.path.join(str(base), path)) == \
            read(os.path.join(str(base), ref_path)), path
    lossy = dispatch.open(os.path.join(str(base), "port", name,
                                       "a." + suffix), device="cpu")
    back = dispatch.open(os.path.join(str(base), "port", name + "-back",
                                      "a.flac"), device="cpu")
    assert np.array_equal(pcm.read_all(lossy.to_pcm()),
                          pcm.read_all(back.to_pcm()))


@pytest.mark.parametrize("name", sorted(LOSSY))
def test_tracktag_and_trackinfo_on_a_lossy_type(lossy_runs, name):
    """tracktag twice (MP3 and MP2: an ID3v2.3 and ID3v1 pair with an
    APIC cover; Vorbis and Opus: comments), a cover given to a FLAC
    and a lossy file at once (Vorbis and Opus fail it), then trackinfo,
    trackverify
    --accuraterip and trackcmp: the reference's files, lines and exit
    codes (trackverify's stdout: the reference also reports its
    database lookup, kept offline here, which the port does not make)"""
    lossy_available(name)
    (base, out) = lossy_runs
    for case in ("tag", "retag", "cover", "info", "info-n", "info-L",
                 "info-b", "info-C", "cmp"):
        (ref, port) = out[(case, name)]
        assert port == (ref[0], as_port(ref[1]), as_port(ref[2])), case
    assert out[("tag", name)][1][0] == out[("retag", name)][1][0] == 0
    q_path = "port/%s-q.%s" % (name, LOSSY[name][0])
    assert read(os.path.join(str(base), q_path)) == \
        read(os.path.join(str(base), q_path.replace("port/", "ref/", 1)))
    (ref, port) = out[("verify", name)]
    assert port[:2] == (ref[0], as_port(ref[1])) and port[0] == 0
    # Opus decodes at 48 kHz, which AccurateRip's CD sums do not take
    assert ("AccurateRip v1=" in port[1]) == (name != "opus")
    path = "port/%s/a.%s" % (name, LOSSY[name][0])
    assert read(os.path.join(str(base), path)) == \
        read(os.path.join(str(base), path.replace("port/", "ref/", 1)))
    metadata = dispatch.open(os.path.join(str(base), path),
                             device="cpu").get_metadata()
    assert (metadata.track_name, metadata.artist_name, metadata.track_number,
            metadata.album_number) == ("Söng", None, 4, 2)
    info = out[("info", name)][1][1]
    assert "Söng" in info and "Album" in info


@pytest.mark.parametrize("name", sorted(LOSSY))
def test_the_other_tools_on_a_lossy_album(lossy_runs, name):
    """a two-title lossy album: tracklint and tracklint --fix of untidy
    ID3 or comment tags, tracklength, trackcat from the lossy titles
    and to the lossy type, tracksplit to it and from it: the
    reference's files, lines and exit codes"""
    lossy_available(name)
    (base, out) = lossy_runs
    for case in ("album", "untidy", "lint", "lint-fix", "length", "cat-from",
                 "cat-to", "split-to", "split-from"):
        (ref, port) = out[(case, name)]
        assert port == (ref[0], as_port(ref[1]), as_port(ref[2])), case
        assert port[0] == 0, case
    # the fixes, reported on stderr
    assert "stripped whitespace" in out[("lint", name)][1][2] or \
        "removed trailing whitespace" in out[("lint", name)][1][2]
    ref_base = os.path.join(str(base), "ref")
    written = []
    for (root, _dirs, names) in os.walk(ref_base):
        written += [os.path.relpath(os.path.join(root, n), ref_base)
                    for n in names if n.startswith(("a.", "b.", "0")) or
                    name + "-cat" in n]
    written = [w for w in written if w.startswith(name)]
    assert len(written) >= 8
    for path in written:
        assert read(os.path.join(str(base), "port", path)) == \
            read(os.path.join(ref_base, path)), path
