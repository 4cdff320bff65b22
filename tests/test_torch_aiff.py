"""AIFF and Sun AU in the port against the reference: ``formats/aiff``
and ``formats/au`` (files byte for byte at 8, 16 and 24 bits, 1, 2 and
6 channels, odd frame counts; their samples; chunks and errors), the
AIFF chunks FLAC keeps as APPLICATION "aiff" blocks and Shorten in its
VERBATIM chunks (``from_aiff``, ``aiff_header_footer``, ``convert``'s
routing), and the tools on the new types, run in fresh interpreters
under a temporary HOME as ``tests/test_torch_config.py`` runs them.
Every input is made from a numpy seed; the encoders run pinned
(``REFERENCE_ENV``)."""

import io
import json
import os
import struct
import subprocess
import sys

import numpy as np
import pytest
import torch

from audiotools_tpu import dispatch as ref_dispatch
from audiotools_tpu import EncodingError as RefEncodingError
from audiotools_tpu.formats import aiff as ref_aiff
from audiotools_tpu.formats.au import AuAudio as RefAuAudio
from audiotools_tpu.formats.flac import FlacAudio as RefFlacAudio
from audiotools_tpu.formats.shn import ShortenAudio as RefShortenAudio
from audiotools_tpu.formats.wav import WaveAudio as RefWaveAudio
from audiotools_tpu.pcmstream import PCMReader as RefPCMReader
from audiotools_tpu_torch import dispatch, pcm
from audiotools_tpu_torch.audiofile import EncodingError
from audiotools_tpu_torch.codecs.shn import FastSHNDecoder, TorchSHNDecoder
from audiotools_tpu_torch.formats import aiff
from audiotools_tpu_torch.formats.au import AuAudio, InvalidAU
from audiotools_tpu_torch.formats.flac import FlacAudio
from audiotools_tpu_torch.formats.shn import ShortenAudio
from audiotools_tpu_torch.formats.wav import WaveAudio
from test_torch_cli import REFERENCE_ENV
from test_torch_config import environment

torch.set_num_threads(1)

SR = 8000
CLOCK = 1.7e9


@pytest.fixture
def pinned(monkeypatch):
    for (key, value) in REFERENCE_ENV.items():
        monkeypatch.setenv(key, value)


def samples(seed, frames, channels, bps):
    """seeded noise over a sine, full scale at ``bps`` bits, the extremes
    among the first samples"""
    rng = np.random.default_rng(seed)
    top = 1 << (bps - 1)
    t = np.arange(frames)[:, None]
    arr = (0.5 * top * np.sin(2 * np.pi * (220 + 50 * np.arange(channels)) *
                              t / SR) +
           rng.normal(0, top / 20, (frames, channels)))
    arr = np.clip(arr, -top, top - 1).astype(np.int32)
    arr[:min(frames, 1)] = -top
    arr[1:min(frames, 2)] = top - 1
    return arr


def reader(arr, bps, rate=SR):
    return pcm.reader_from_array(arr, bps, rate)


def ref_reader(arr, bps, rate=SR):
    """a reference PCMReader of the same samples and channel mask"""
    return RefPCMReader(io.BytesIO(pcm.FrameList(arr, bps).to_bytes(
        False, True)), rate, arr.shape[1],
        pcm.CHANNEL_MASKS.get(arr.shape[1], 0), bps, signed=True)


def read(path):
    with open(path, "rb") as f:
        return f.read()


def with_chunks(path, arr, bps, before=b"hello", after=b"abc"):
    """an AIFF of ``arr`` at ``path`` with a NAME chunk between COMM and
    SSND and an ANNO chunk after SSND (both of odd length)"""
    aiff.AiffAudio.from_pcm(path, reader(arr, bps))
    data = read(path)
    comm_end = 12 + 8 + 18
    name = b"NAME" + struct.pack(">I", len(before)) + before + \
        b"\x00" * (len(before) % 2)
    anno = b"ANNO" + struct.pack(">I", len(after)) + after + \
        b"\x00" * (len(after) % 2)
    body = data[12:comm_end] + name + data[comm_end:] + anno
    with open(path, "wb") as f:
        f.write(b"FORM" + struct.pack(">I", 4 + len(body)) + b"AIFF" + body)


RATES = [0, 1, 8000, 11025, 22050, 32000, 44100, 48000, 88200, 96000,
         176400, 192000, 65535, 1 << 20]


def test_ieee_extended_equals_the_references():
    for rate in RATES:
        data = aiff.build_ieee_extended(rate)
        assert data == ref_aiff.build_ieee_extended(rate)
        assert aiff.parse_ieee_extended(data) == rate
        assert aiff.parse_ieee_extended(data) == \
            ref_aiff.parse_ieee_extended(data)
    assert aiff.build_ieee_extended(-44100) == \
        ref_aiff.build_ieee_extended(-44100)
    nan = b"\x7f\xff" + b"\x00" * 8
    assert np.isnan(aiff.parse_ieee_extended(nan))
    comm = struct.pack(">HIH", 2, 1234, 16) + aiff.build_ieee_extended(44100)
    assert aiff.parse_comm(comm)[:4] == ref_aiff.parse_comm(comm)[:4] == \
        (2, 1234, 16, 44100)


@pytest.mark.parametrize("bps", [8, 16, 24])
@pytest.mark.parametrize("channels", [1, 2, 6])
def test_aiff_and_au_files_equal_the_references(tmp_path, bps, channels):
    """from_pcm of 1,001 frames (an odd byte count at 8 and 24 bits
    mono): the reference's bytes; the samples, stream fields and
    checks back"""
    arr = samples(bps + channels, 1001, channels, bps)
    for (cls, ref_cls, suffix) in ((aiff.AiffAudio, ref_aiff.AiffAudio,
                                    "aiff"), (AuAudio, RefAuAudio, "au")):
        (mine, theirs) = (str(tmp_path / ("p." + suffix)),
                          str(tmp_path / ("r." + suffix)))
        track = cls.from_pcm(mine, reader(arr, bps), total_pcm_frames=1001)
        ref = ref_cls.from_pcm(theirs, ref_reader(arr, bps))
        assert read(mine) == read(theirs)
        assert (track.total_frames(), track.sample_rate(), track.channels(),
                track.bits_per_sample(), track.channel_mask()) == (
                    ref.total_frames(), ref.sample_rate(), ref.channels(),
                    ref.bits_per_sample(), int(ref.channel_mask()))
        got = track.to_pcm()
        assert got.channel_mask == int(ref.to_pcm().channel_mask)
        assert np.array_equal(pcm.read_all(got), arr)
        assert track.verify() and ref.verify()
        assert type(dispatch.open(mine, device="cpu")) is cls


@pytest.mark.parametrize("frames", [0, 1])
def test_empty_and_one_frame_files_equal_the_references(tmp_path, frames):
    arr = samples(3, frames, 2, 16)
    for (cls, ref_cls) in ((aiff.AiffAudio, ref_aiff.AiffAudio),
                           (AuAudio, RefAuAudio)):
        cls.from_pcm(str(tmp_path / "p"), reader(arr, 16))
        ref_cls.from_pcm(str(tmp_path / "r"), ref_reader(arr, 16))
        assert read(tmp_path / "p") == read(tmp_path / "r")
        assert np.array_equal(pcm.read_all(cls(str(tmp_path / "p")).to_pcm()),
                              arr)


def test_a_frame_count_mismatch_leaves_no_file(tmp_path):
    for cls in (aiff.AiffAudio, AuAudio):
        path = str(tmp_path / "x")
        with pytest.raises(EncodingError):
            cls.from_pcm(path, reader(samples(1, 10, 2, 16), 16),
                         total_pcm_frames=11)
        assert not os.path.exists(path)
        with pytest.raises(EncodingError):
            cls.from_pcm(path, reader(samples(1, 10, 2, 16), 32))
        assert not os.path.exists(path)


def test_aiff_chunks_equal_the_references(tmp_path):
    """chunks(), aiff_from_chunks, the foreign chunks and the header and
    footer around the samples"""
    path = str(tmp_path / "a.aiff")
    with_chunks(path, samples(4, 501, 1, 8), 8)
    (track, ref) = (aiff.AiffAudio(path), ref_aiff.AiffAudio(path))
    chunks = list(track.chunks())
    assert [(c.id, c.data()) for c in chunks] == [
        (c.id, c.data()) for c in ref.chunks()]
    assert [c.id for c in chunks] == [b"COMM", b"NAME", b"SSND", b"ANNO"]
    assert track.has_foreign_aiff_chunks() and ref.has_foreign_aiff_chunks()
    assert track.aiff_header_footer() == ref.aiff_header_footer()
    (header, footer) = track.aiff_header_footer()
    assert footer.startswith(b"\x00ANNO")     # the SSND chunk's pad byte
    rebuilt = aiff.AiffAudio.aiff_from_chunks(str(tmp_path / "b.aiff"),
                                              chunks)
    ref_aiff.AiffAudio.aiff_from_chunks(str(tmp_path / "c.aiff"),
                                        ref.chunks())
    assert read(tmp_path / "b.aiff") == read(tmp_path / "c.aiff") == \
        read(path)
    assert np.array_equal(pcm.read_all(rebuilt.to_pcm()),
                          samples(4, 501, 1, 8))
    copy = aiff.AiffAudio.from_aiff(str(tmp_path / "d.aiff"), header,
                                    track.to_pcm(), footer)
    assert read(copy.filename) == read(path)
    plain = str(tmp_path / "plain.aiff")
    aiff.AiffAudio.from_pcm(plain, reader(samples(4, 501, 1, 8), 8))
    assert not aiff.AiffAudio(plain).has_foreign_aiff_chunks()


def test_invalid_aiff_and_au_raise_as_the_references(tmp_path):
    path = str(tmp_path / "a.aiff")
    aiff.AiffAudio.from_pcm(path, reader(samples(5, 100, 2, 16), 16))
    data = read(path)
    comm = data[12:12 + 26]
    ssnd = data[12 + 26:]
    cases = {"no SSND": (b"FORM" + struct.pack(">I", 4 + len(comm)) +
                         b"AIFF" + comm, "SSND chunk not found"),
             "no COMM": (b"FORM" + struct.pack(">I", 4 + len(ssnd)) +
                         b"AIFF" + ssnd, "COMM chunk not found"),
             "no FORM": (b"RIFX" + data[4:], "not an AIFF file")}
    for (name, (body, message)) in cases.items():
        bad = str(tmp_path / (name + ".aiff"))
        with open(bad, "wb") as f:
            f.write(body)
        with pytest.raises(aiff.InvalidAIFF) as err:
            aiff.AiffAudio(bad)
        assert str(err.value) == message
        with pytest.raises(ref_aiff.InvalidAIFF) as ref_err:
            ref_aiff.AiffAudio(bad)
        assert str(ref_err.value) == message
    au = str(tmp_path / "a.au")
    AuAudio.from_pcm(au, reader(samples(5, 100, 2, 16), 16))
    data = read(au)
    for (encoding, message) in ((1, "unsupported Au encoding"),
                                (6, "unsupported Au encoding"),
                                (None, "invalid Au header")):
        bad = str(tmp_path / "bad.au")
        with open(bad, "wb") as f:
            f.write(data[:12] + struct.pack(">I", encoding) + data[16:]
                    if encoding is not None else b".snx" + data[4:])
        with pytest.raises(InvalidAU) as err:
            AuAudio(bad)
        assert str(err.value) == message
        with pytest.raises(Exception) as ref_err:
            RefAuAudio(bad)
        assert str(ref_err.value) == message
        with pytest.raises(dispatch.UnknownAudioType if encoding is None
                           else InvalidAU):
            dispatch.open(bad, device="cpu")


def test_au_header_split_and_names_equal_the_references(tmp_path):
    path = str(tmp_path / "a.au")
    AuAudio.from_pcm(path, reader(samples(6, 77, 1, 24), 24))
    assert AuAudio(path).pcm_split() == RefAuAudio(path).pcm_split() == (
        read(path)[:24], b"")
    for suffix in (None, "wav"):
        assert AuAudio.track_name("x/y.flac", None, "%(basename)s.%(suffix)s",
                                  suffix) == RefAuAudio.track_name(
            "x/y.flac", None, "%(basename)s.%(suffix)s", suffix) == "y.au"


# (target, bits, channels, frames): an odd byte count of samples at 8
# and 24 bits mono
CARRIERS = [("flac", 8, 1, 4001), ("flac", 16, 2, 4000), ("flac", 24, 1, 4001),
            ("shn", 8, 1, 4001), ("shn", 16, 2, 4000)]


@pytest.mark.parametrize("case", CARRIERS, ids=lambda c: "%s-%d-%d" % c[:3])
def test_aiff_chunks_travel_through_flac_and_shorten(tmp_path, pinned, case):
    """an AIFF with chunks before and after SSND converted to FLAC or
    Shorten, and back: each file the reference's, the samples equal, the
    AIFF given back byte for byte"""
    (target, bps, channels, frames) = case
    arr = samples(bps * channels, frames, channels, bps)
    source = str(tmp_path / "a.aiff")
    with_chunks(source, arr, bps)
    (cls, ref_cls) = {"flac": (FlacAudio, RefFlacAudio),
                      "shn": (ShortenAudio, RefShortenAudio)}[target]
    (mine, theirs) = (str(tmp_path / ("p." + target)),
                      str(tmp_path / ("r." + target)))
    track = aiff.AiffAudio(source).convert(mine, cls, device="cpu")
    ref_aiff.AiffAudio(source).convert(theirs, ref_cls)
    assert read(mine) == read(theirs)
    assert track.has_foreign_aiff_chunks()
    assert not track.has_foreign_wave_chunks()
    assert track.total_frames() == frames
    assert track.aiff_header_footer() == \
        ref_dispatch.open(theirs).aiff_header_footer()
    assert np.array_equal(pcm.read_all(track.to_pcm()), arr)
    assert track.verify()
    for (side, opened) in (("p", track), ("r", ref_dispatch.open(theirs))):
        back = str(tmp_path / (side + "-back.aiff"))
        if side == "p":
            opened.convert(back, aiff.AiffAudio, device="cpu")
        else:
            opened.convert(back, ref_aiff.AiffAudio)
        assert read(back) == read(source)
    if target == "shn":
        # the stream holds big-endian signed samples as AIFF has them
        ref_samples = pcm.read_all(ref_dispatch.open(theirs).to_pcm())
        assert np.array_equal(ref_samples, arr)
        for decoder in (TorchSHNDecoder(mine, device="cpu"),
                        FastSHNDecoder(mine)):
            assert decoder.signed_samples
            assert np.array_equal(pcm.read_all(decoder), arr)


def test_container_blocks_route_as_the_references(tmp_path, pinned):
    """a FLAC holding "aiff" blocks converts to WAVE with the PCM alone
    and to Shorten through from_aiff; one holding "riff" blocks to AIFF
    with the PCM alone: the reference's files"""
    arr = samples(9, 3000, 2, 16)
    source = str(tmp_path / "a.aiff")
    with_chunks(source, arr, 16)
    aiff.AiffAudio(source).convert(str(tmp_path / "aiff.flac"), FlacAudio,
                                   device="cpu")
    wave = str(tmp_path / "a.wav")
    WaveAudio.from_pcm(wave, reader(arr, 16))
    with open(wave, "rb") as f:
        data = f.read()
    list_chunk = b"LIST" + struct.pack("<I", 4) + b"INFO"
    with open(wave, "wb") as f:
        f.write(b"RIFF" + struct.pack("<I", len(data) - 8 + len(list_chunk)) +
                data[8:36] + list_chunk + data[36:])
    WaveAudio(wave).convert(str(tmp_path / "riff.flac"), FlacAudio,
                            device="cpu")
    for (name, cls, ref_cls, suffix) in (
            ("aiff.flac", WaveAudio, RefWaveAudio, "wav"),
            ("aiff.flac", ShortenAudio, RefShortenAudio, "shn"),
            ("riff.flac", aiff.AiffAudio, ref_aiff.AiffAudio, "aiff")):
        src = str(tmp_path / name)
        (mine, theirs) = (str(tmp_path / ("p." + suffix)),
                          str(tmp_path / ("r." + suffix)))
        FlacAudio(src, device="cpu").convert(mine, cls, device="cpu")
        ref_dispatch.open(src).convert(theirs, ref_cls)
        assert read(mine) == read(theirs)
        assert np.array_equal(pcm.read_all(dispatch.open(
            mine, device="cpu").to_pcm()), arr)


def test_bad_aiff_parts_raise_as_the_references(tmp_path, pinned):
    """from_aiff of parts that make no AIFF: the same EncodingError text
    from both packages, and no file left"""
    arr = samples(10, 600, 2, 16)
    source = str(tmp_path / "a.aiff")
    with_chunks(source, arr, 16)
    (header, footer) = aiff.AiffAudio(source).aiff_header_footer()
    comm_at = header.index(b"COMM")
    ssnd_at = header.index(b"SSND")
    cases = {
        "short": (header[:8], footer, arr),
        "no COMM": (header[:12] + header[ssnd_at:], footer, arr),
        "after SSND": (header + b"\x00\x00", footer, arr),
        "SSND in footer": (header, footer + header[ssnd_at:ssnd_at + 16],
                           arr),
        "two COMMs": (header[:ssnd_at] + header[comm_at:comm_at + 26] +
                      header[ssnd_at:], footer, arr),
        "short PCM": (header, footer, arr[:-1]),
        "truncated footer": (header, footer[:-2], arr)}
    for (name, (head, foot, pcm_arr)) in cases.items():
        errors = []
        for (cls, make, error) in (
                (FlacAudio, reader, EncodingError),
                (RefFlacAudio, ref_reader, RefEncodingError)):
            path = str(tmp_path / "x.flac")
            kwargs = {"device": "cpu"} if cls is FlacAudio else {}
            with pytest.raises(error) as err:
                cls.from_aiff(path, head, make(pcm_arr, 16), foot, **kwargs)
            assert not os.path.exists(path), name
            errors.append(str(err.value))
        assert errors[0] == errors[1], name


# the tools' session: one fresh interpreter a side runs every step's
# main() in-process, with ALAC's clock pinned, and prints each step's
# (exit code, stdout, stderr) as JSON
SESSION = r"""
import contextlib, importlib, io, json, sys, time
time.time = lambda: %r
(package, steps) = (sys.argv[1], json.loads(sys.argv[2]))
results = []
for (tool, args) in steps:
    module = importlib.import_module(package + ".cli." + tool)
    if package == "audiotools_tpu_torch":
        args = args + ["--devices", "cpu"]
    (out, err) = (io.StringIO(), io.StringIO())
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        try:
            code = module.main(args)
        except SystemExit as exit_err:
            code = exit_err.code
    results.append((code or 0, out.getvalue(), err.getvalue()))
print(json.dumps(results))
""" % (CLOCK,)


def run_session(side, steps, home, pinned=True):
    """each (tool, args) step run by the reference's (``side`` "ref") or
    the port's tools in one fresh interpreter from the current
    directory, ``{side}`` in the arguments replaced by ``side``: a list
    of (exit code, stdout, stderr), the reference's paths named as the
    port's"""
    package = "audiotools_tpu" if side == "ref" else "audiotools_tpu_torch"
    steps = [(tool, [a.replace("{side}", side) for a in args])
             for (tool, args) in steps]
    proc = subprocess.run(
        [sys.executable, "-c", SESSION, package, json.dumps(steps)],
        capture_output=True, text=True, timeout=900,
        env=environment(home, pinned))
    assert proc.returncode == 0, proc.stderr
    return [(code, out.replace("ref/", "port/"), err.replace("ref/", "port/"))
            for (code, out, err) in json.loads(proc.stdout.splitlines()[-1])]


def tree(root):
    return {os.path.relpath(os.path.join(base, name), root):
            read(os.path.join(base, name))
            for (base, _dirs, names) in os.walk(root) for name in names}


FORMAT = ["--format", "%(basename)s.%(suffix)s", "-j", "1"]
TOOL_STEPS = [
    ("track2track", ["-t", "aiff", "-d", "{side}/aiff"] + FORMAT +
     ["src/a.wav", "src/c.au"]),
    ("track2track", ["-t", "au", "-d", "{side}/au"] + FORMAT +
     ["src/a.wav", "src/b.aiff"]),
    ("track2track", ["-t", "flac", "-q", "5", "-d", "{side}/flac"] + FORMAT +
     ["src/b.aiff", "src/c.au"]),
    ("track2track", ["-t", "shn", "-d", "{side}/shn"] + FORMAT +
     ["src/b.aiff"]),
    ("track2track", ["-t", "wavpack", "-d", "{side}/wavpack"] + FORMAT +
     ["src/b.aiff"]),
    ("track2track", ["-t", "tta", "-d", "{side}/tta"] + FORMAT +
     ["src/b.aiff"]),
    ("track2track", ["-t", "alac", "-d", "{side}/alac"] + FORMAT +
     ["src/b.aiff"]),
    ("track2track", ["-t", "aiff", "-d", "{side}/back-flac"] + FORMAT +
     ["{side}/flac/b.flac", "{side}/flac/c.flac"]),
    ("track2track", ["-t", "aiff", "-d", "{side}/back-shn"] + FORMAT +
     ["{side}/shn/b.shn"]),
    ("track2track", ["-t", "aiff", "-o", "{side}/back-wv.aiff",
                     "{side}/wavpack/b.wv"]),
    ("track2track", ["-t", "au", "-o", "{side}/back-alac.au",
                     "{side}/alac/b.m4a"]),
    ("track2track", ["-t", "aiff", "-o", "{side}/back-tta.aiff",
                     "{side}/tta/b.tta"]),
    ("track2track", ["-t", "aiff", "-o", "{side}/one.aiff", "src/c.au"]),
    ("trackinfo", ["{side}/aiff/a.aiff", "{side}/au/b.au", "src/b.aiff",
                   "{side}/flac/b.flac"]),
    ("trackinfo", ["-L", "-C", "{side}/au/a.au", "{side}/one.aiff"]),
    ("tracklength", ["{side}"]),
    ("trackverify", ["-j", "1", "{side}/aiff/a.aiff", "{side}/au/b.au",
                     "{side}/flac/b.flac", "{side}/shn/b.shn",
                     "{side}/back-flac/b.aiff", "src/bad.au"]),
    ("trackcmp", ["-j", "1", "src/b.aiff", "{side}/flac/b.flac",
                  "src/b.aiff", "{side}/back-shn/b.aiff",
                  "src/a.wav", "{side}/au/a.au",
                  "src/c.au", "{side}/aiff/a.aiff"]),
]


def test_tools_on_aiff_and_au_equal_the_references(tmp_path, monkeypatch):
    """track2track to and from AIFF and AU (foreign chunks carried
    through FLAC and Shorten, given back byte for byte), trackinfo,
    tracklength, trackverify and trackcmp across the containers: the
    same files, lines and exit codes"""
    monkeypatch.chdir(tmp_path)
    home = tmp_path / "home"
    home.mkdir()
    os.makedirs("src")
    WaveAudio.from_pcm("src/a.wav", reader(samples(11, 2 * SR, 2, 16), 16))
    with_chunks("src/b.aiff", samples(12, 2 * SR + 1, 2, 16), 16)
    AuAudio.from_pcm("src/c.au", reader(samples(13, SR, 2, 16), 16))
    with open("src/c.au", "rb") as f:
        data = f.read()
    with open("src/bad.au", "wb") as f:
        f.write(data[:len(data) // 2])
    ref = run_session("ref", TOOL_STEPS, home)
    port = run_session("port", TOOL_STEPS, home)
    for ((tool, _args), want, got) in zip(TOOL_STEPS, ref, port):
        if tool == "trackverify":
            (want, got) = ((want[0], sorted(want[1].splitlines()), want[2]),
                           (got[0], sorted(got[1].splitlines()), got[2]))
        assert got == want, tool
    assert [code for (code, _out, _err) in port] == [0] * 16 + [1, 1]
    ref_files = tree("ref")
    assert tree("port") == ref_files and len(ref_files) == 17
    assert ref_files["back-flac/b.aiff"] == ref_files["back-shn/b.aiff"] == \
        read("src/b.aiff")
    # WavPack, ALAC and TTA keep no AIFF chunks: the samples alone
    want = pcm.read_all(aiff.AiffAudio("src/b.aiff").to_pcm())
    for name in ("back-wv.aiff", "back-alac.au", "back-tta.aiff"):
        got = pcm.read_all(dispatch.open("port/" + name, device="cpu").to_pcm())
        assert np.array_equal(got, want), name
