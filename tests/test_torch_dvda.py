"""The port's DVD-Audio layer and tools against the reference's.

Synthetic AUDIO_TS directories (``torch_dvda_helpers``) go through both
packages' ``DVDAudio``: PCM titles of 16 and 24 bits at 1-6 channels
and 44.1, 48 and 96 kHz, MLP titles of 1, 2 and 6 channels, AOBs split
across files, and a CPPM-scrambled copy read with a ``CPPMDecoder``.
Titlesets, titles, tracks, ``info()``, ``total_frames()`` and sectors
are equal, and every title's PCM is equal sample for sample, with
``ATPU_MLP_ORACLE`` unset and set to 1.  Then ``dvdainfo`` and
``dvda2track`` run in-process through both packages (the port with
``--devices cpu``, the reference under the other tool tests'
environment), every lookup answered from canned replies: files equal
byte for byte, stdout, stderr and exit codes equal."""

import contextlib
import importlib
import io
import os
import re
import socket
import urllib.request

import numpy as np
import pytest
import torch

from audiotools_tpu import cppm as ref_cppm
from audiotools_tpu import dvda as ref_dvda
from audiotools_tpu_torch import cppm, dispatch, dvda, pcm
from audiotools_tpu_torch.services import musicbrainz
from cli_harness import run_tool
from test_torch_cli import URWID_REQUIRED
from torch_ui_helpers import canned_lookups, urwid_as
from test_torch_disc_cli import REFERENCE_ENV
import torch_dvda_helpers as dh
from torch_disc_helpers import (CannedServer, musicbrainz_release, no_socket,
                                xmcd)

torch.set_num_threads(1)


# each structure disc's titlesets: titles as (kind, bits, channels, rate,
# track frames)
STRUCTURE = [
    [("pcm", 16, c, 48000, [160 * (c + 1), 96]) for c in range(1, 7)],
    [("pcm", 24, c, 96000, [320, 160 * c]) for c in range(1, 7)],
    [("pcm", 16, 2, 44100, [882, 1000]),      # PTS rounded on each track
     ("mlp", 16, 2, 48000, [480, 320]),
     ("mlp", 24, 1, 96000, [320]),
     ("mlp", 16, 6, 48000, [160, 320, 160])],
]


def title_sectors(kind, bits, channels, rate, frames, seed):
    samples = dh.signal(sum(frames), channels, bits, seed=seed)
    if kind == "pcm":
        return (dh.pcm_sectors(samples, bits, rate), samples)
    return (dh.mlp_sectors(dh.mlp_stream(
        samples, bits_per_sample=bits, sample_rate=rate,
        fir_coeff=[200, -90], filter_shift=8)), samples)


def build_disc(directory, layout, aob_sectors=None):
    """(AUDIO_TS path, {(titleset, title): samples})"""
    titlesets = []
    samples = {}
    for (ts, titles) in enumerate(layout, 1):
        built = []
        for (t, (kind, bits, channels, rate, frames)) in enumerate(titles,
                                                                   1):
            (data, arr) = title_sectors(kind, bits, channels, rate, frames,
                                        seed=ts * 10 + t)
            built.append((data, frames, rate))
            samples[(ts, t)] = arr
        titlesets.append(built)
    return (dh.write_audio_ts(directory, titlesets, aob_sectors), samples)


def read_all(reader, chunk=4096):
    out = []
    while True:
        framelist = reader.read(chunk)
        if framelist.frames == 0:
            break
        out.append(np.asarray(framelist.samples))
    reader.close()
    return np.concatenate(out)


def describe(disc):
    """everything of a DVDAudio but its PCM, as plain values"""
    out = []
    for titles in disc.titlesets:
        for title in titles:
            out.append((repr(title), title.info(), title.total_frames(),
                        [(t.total_frames(), list(t.sectors()))
                         for t in title.tracks]))
    return out


@pytest.fixture(scope="module")
def structure_disc(tmp_path_factory):
    base = str(tmp_path_factory.mktemp("dvda_structure"))
    return build_disc(base, STRUCTURE, aob_sectors=5)


def test_the_discs_structure_is_the_references(structure_disc):
    (path, _samples) = structure_disc
    port = dvda.DVDAudio(path)
    ref = ref_dvda.DVDAudio(path)
    assert len(port) == len(ref) == len(STRUCTURE)
    assert [len(ts) for ts in port.titlesets] == [len(ts) for ts in STRUCTURE]
    assert describe(port) == describe(ref)
    for (ts, titles) in enumerate(port.titlesets):
        assert port.titleset_aobs(ts + 1) == ref.titleset_aobs(ts + 1)
        assert len(port.titleset_aobs(ts + 1)) > 1


@pytest.mark.parametrize("oracle", [None, "1"])
@pytest.mark.parametrize("titleset", [1, 2, 3])
def test_every_title_decodes_to_the_references_pcm(structure_disc,
                                                   monkeypatch, oracle,
                                                   titleset):
    (path, samples) = structure_disc
    if oracle is None:
        monkeypatch.delenv("ATPU_MLP_ORACLE", raising=False)
    else:
        monkeypatch.setenv("ATPU_MLP_ORACLE", oracle)
    port = dvda.DVDAudio(path)[titleset - 1]
    ref = ref_dvda.DVDAudio(path)[titleset - 1]
    for (number, (title, ref_title)) in enumerate(zip(port, ref), 1):
        got = read_all(title.to_pcm())
        want = read_all(ref_title.to_pcm())
        assert got.dtype == np.int32
        assert np.array_equal(got, want)
        assert got.shape[0] == title.total_frames()
        arr = samples[(titleset, number)]
        assert np.array_equal(got, arr[:got.shape[0]])


@pytest.mark.parametrize("chunk", [1, 333, 65536])
def test_reads_of_any_size_give_the_references_framelists(structure_disc,
                                                         chunk):
    (path, _samples) = structure_disc
    for (ts, t) in ((2, 6), (3, 2), (3, 4)):
        port = dvda.DVDAudio(path)[ts - 1][t - 1].to_pcm()
        ref = ref_dvda.DVDAudio(path)[ts - 1][t - 1].to_pcm()
        while True:
            got = port.read(chunk)
            want = ref.read(chunk)
            assert (got.frames, got.bits_per_sample) == (
                want.frames, want.bits_per_sample)
            assert np.array_equal(got.samples, want.samples)
            if got.frames == 0:
                break
        for reader in (port, ref):
            reader.close()
            with pytest.raises(ValueError):
                reader.read(1)


def test_the_readers_attributes_and_refusals_are_the_references(
        structure_disc):
    (path, _samples) = structure_disc
    port = dvda.DVDAudio(path)
    ref = ref_dvda.DVDAudio(path)
    for (title, ref_title) in ((port[0][1], ref[0][1]),
                               (port[2][1], ref[2][1])):
        reader = title.to_pcm()
        ref_reader = ref_title.to_pcm()
        assert type(reader).__name__ == type(ref_reader).__name__
        assert [getattr(reader, a) for a in (
            "sample_rate", "channels", "channel_mask", "bits_per_sample")] \
            == [getattr(ref_reader, a) for a in (
                "sample_rate", "channels", "channel_mask", "bits_per_sample")]
        reader.close()
        ref_reader.close()
    # a PCM reader refuses an MLP title and the MLP reader a PCM one
    for (cls, ref_cls, title, ref_title) in (
            (dvda.DVDATitleReader, ref_dvda.DVDATitleReader, port[2][1],
             ref[2][1]),
            (dvda.MLPTitleReader, ref_dvda.MLPTitleReader, port[0][0],
             ref[0][0])):
        with pytest.raises(ValueError) as err:
            cls(title)
        with pytest.raises(ValueError) as ref_err:
            ref_cls(ref_title)
        assert str(err.value) == str(ref_err.value)
    assert dvda.AOB_BYTE_SWAP == ref_dvda.AOB_BYTE_SWAP
    for name in ("SAMPLE_RATE", "CHANNELS", "CHANNEL_MASK",
                 "BITS_PER_SAMPLE"):
        assert getattr(dvda, name) == getattr(ref_dvda, name)
    for (a, b) in ((0, 5), (3, 9), (8, 2)):
        ranges = (dvda.Rangeset(0, a + b) & dvda.Rangeset(a, 20),
                  ref_dvda.Rangeset(0, a + b) & ref_dvda.Rangeset(a, 20))
        assert repr(ranges[0]) == repr(ranges[1])
        assert len(ranges[0]) == len(ranges[1])


@pytest.mark.parametrize("damage", ["no-amg", "bad-amg", "bad-ats",
                                    "bad-sync"])
def test_broken_discs_are_refused_as_the_reference_refuses_them(
        tmp_path, damage):
    (path, _samples) = build_disc(str(tmp_path), [STRUCTURE[0][:1]])
    if damage == "no-amg":
        os.unlink(os.path.join(path, "AUDIO_TS.IFO"))
    else:
        name = {"bad-amg": "AUDIO_TS.IFO", "bad-ats": "ATS_01_0.IFO",
                "bad-sync": "ATS_01_1.AOB"}[damage]
        with open(os.path.join(path, name), "r+b") as f:
            f.write(b"\x00\x00\x00\x00")

    def opened(package):
        try:
            package.DVDAudio(path)
        except Exception as err:  # noqa: BLE001 - compared below
            return (type(err).__name__, str(err))
        return None

    assert opened(dvda) == opened(ref_dvda)
    assert opened(dvda)[0] == "InvalidDVDA"


@pytest.fixture(scope="module")
def scrambled_disc(tmp_path_factory):
    base = str(tmp_path_factory.mktemp("dvda_cppm"))
    (path, samples) = build_disc(base, [[STRUCTURE[0][1], STRUCTURE[1][1],
                                        STRUCTURE[2][1]]])
    cipher = dh.synthetic_cipher(31)
    rng = np.random.default_rng(37)
    keys = (int(rng.integers(0, 1 << 56)), int(rng.integers(0, 1 << 63)))
    assert dh.cppm_scramble(path, cipher, *keys) > 0
    return (path, samples, cipher, keys)


def test_a_scrambled_disc_decodes_with_the_references_decoder(
        scrambled_disc):
    (path, samples, cipher, (media_key, id_album)) = scrambled_disc
    port = dvda.DVDAudio(path, cppm_decoder=cppm.CPPMDecoder(
        media_key, id_album, cipher))
    ref = ref_dvda.DVDAudio(path, cppm_decoder=ref_cppm.CPPMDecoder(
        media_key, id_album, ref_cppm.C2Cipher(cipher.sbox, cipher.sbox_f)))
    assert describe(port) == describe(ref)
    for (t, (title, ref_title)) in enumerate(zip(port[0], ref[0]), 1):
        got = read_all(title.to_pcm())
        assert np.array_equal(got, read_all(ref_title.to_pcm()))
        assert np.array_equal(got, samples[(1, t)][:got.shape[0]])
    # without the decoder the payload is noise to both
    plain = dvda.DVDAudio(path)[0][0]
    try:
        garbled = read_all(plain.to_pcm())
    except (ValueError, IOError):
        garbled = None
    if garbled is not None:
        assert not np.array_equal(garbled, samples[(1, 1)][:len(garbled)])


# ---------------------------------------------------------------------------
# the tools

# the tools' disc: a 24-bit 96 kHz stereo PCM title of three tracks and an
# MLP title of two, then a 6-channel 16-bit titleset
TOOLS_DISC = [[("pcm", 24, 2, 96000, [3200, 4800, 1600]),
               ("mlp", 16, 2, 48000, [1600, 1600])],
              [("pcm", 16, 6, 48000, [960, 640])]]


def port_tool(name, *args, devices=("--devices", "cpu")):
    module = importlib.import_module("audiotools_tpu_torch.cli." + name)
    (out, err) = (io.StringIO(), io.StringIO())
    extra = list(devices) if name != "dvdainfo" else []
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        try:
            code = module.main(list(args) + extra)
        except SystemExit as exit_err:
            code = exit_err.code
    return (code or 0, out.getvalue(), err.getvalue())


def ref_tool(name, *args):
    r = run_tool(name, *args)
    return (r.returncode, r.stdout, r.stderr)


def as_port(text):
    return re.sub(r"(?<![\w/])ref/", "port/", text)


def tree(root):
    out = {}
    if os.path.isdir(root):
        for (base, _dirs, names) in os.walk(root):
            for name in names:
                with open(os.path.join(base, name), "rb") as f:
                    out[os.path.relpath(os.path.join(base, name), root)] = \
                        f.read()
    return out


def title_disc_id(title):
    """the MusicBrainz DiscID that dvda2track -M asks for"""
    frames = [(t.total_frames() * 75) // title.sample_rate
              for t in title.tracks]
    offsets = [150 + sum(frames[:i]) for i in range(len(frames))]
    return musicbrainz.DiscID(1, len(frames), 150 + sum(frames), offsets)


# case: dvda2track's arguments (the output directory after -d added)
DVDA2TRACK_CASES = {
    "flac8": ["-t", "flac", "-q", "8"],
    "wavpack": ["-t", "wavpack"],
    "subset": ["-t", "flac", "-q", "0", "3", "1"],
    "numbers": ["-t", "wav", "--track-start", "5", "--track-total", "9",
                "--album-number", "1", "--album-total", "2"],
    "format": ["-t", "flac", "-q", "0", "--format",
               "%(track_number)2.2d of %(track_total)d.%(suffix)s"],
    "mlp": ["--title", "2", "-t", "flac", "-q", "0"],
    "mlp-wav": ["--title", "2", "-t", "wav", "2"],
    "titleset2": ["--titleset", "2", "-t", "flac", "-q", "5"],
    "replay-gain": ["-t", "flac", "-q", "0", "--replay-gain"],
    "M": ["-M", "-t", "flac", "-q", "0"],
    "M-D": ["-M", "-D", "-t", "wav"],
    "M-freedb": ["-M", "--no-musicbrainz", "-t", "wav"],
    "M-offline": ["-M", "-t", "wav"],
    "M-servers": ["-M", "--musicbrainz-server", "mb.test",
                  "--musicbrainz-port", "81", "--freedb-server", "fdb.test",
                  "--freedb-port", "82", "-t", "wav", "2"],
    "cdrom": ["-c", "/dev/dvd", "-t", "wav", "1"],
    "no-title": ["--title", "3", "-t", "wav"],
    "no-titleset": ["--titleset", "4", "-t", "wav"],
    "no-type": ["-t", "nosuch"],
}


@pytest.fixture(scope="module")
def tool_runs(tmp_path_factory):
    base = tmp_path_factory.mktemp("dvda_cli")
    server = CannedServer()
    results = {}
    urls = {}
    with pytest.MonkeyPatch.context() as mp:
        for (key, value) in REFERENCE_ENV.items():
            mp.setenv(key, value)
        mp.delenv("ATPU_MLP_ORACLE", raising=False)
        mp.setattr(urllib.request, "urlopen", server.urlopen)
        mp.setattr(socket, "create_connection", no_socket)
        # the reference's -M asks each track for a sample_rate() that
        # DVDATrack lacks; the title's rate is the one it means
        mp.setattr(ref_dvda.DVDATrack, "sample_rate",
                   lambda track: track.title.sample_rate, raising=False)
        mp.chdir(base)
        (path, samples) = build_disc(".", TOOLS_DISC)
        title = dvda.DVDAudio(path)[0][0]
        replies = {"freedb": xmcd(len(title)),
                   "musicbrainz": musicbrainz_release(
                       str(title_disc_id(title)), len(title))}

        def both(case, name, args, case_replies=None):
            server.replies = dict(case_replies or {})
            start = len(server.urls)
            ref = ref_tool(name, *args)
            middle = len(server.urls)
            port = port_tool(name, *[as_port(a) for a in args])
            results[case] = (ref, port)
            urls[case] = (server.urls[start:middle], server.urls[middle:])

        both("dvdainfo", "dvdainfo", ["-A", path])
        both("dvdainfo-missing", "dvdainfo", ["-A", "nowhere/AUDIO_TS"])
        for (case, args) in DVDA2TRACK_CASES.items():
            both(case, "dvda2track", ["-A", path, "-d", "ref/" + case] + args,
                 None if case == "M-offline" else replies)
    return (str(base), samples, results, urls)


def test_dvdainfo_prints_the_references_lines(tool_runs):
    (_base, _samples, results, _urls) = tool_runs
    for case in ("dvdainfo", "dvdainfo-missing"):
        (ref, port) = results[case]
        assert port == ref, case
    (code, stdout, _stderr) = results["dvdainfo"][1]
    assert code == 0
    assert stdout.splitlines()[:2] == [
        "Titleset 1:", "  Title 1: 3 track(s), 0:00, 96000Hz 2ch 24-bit PCM"]
    assert "48000Hz 2ch 16-bit MLP" in stdout
    assert results["dvdainfo-missing"][1][0] == 1


@pytest.mark.parametrize("case", list(DVDA2TRACK_CASES))
def test_dvda2track_writes_the_references_files(tool_runs, case):
    (base, _samples, results, urls) = tool_runs
    (ref, port) = results[case]
    assert port == (ref[0], as_port(ref[1]), as_port(ref[2])), (ref, port)
    ref_files = tree(os.path.join(base, "ref", case))
    assert tree(os.path.join(base, "port", case)) == ref_files
    (ref_urls, port_urls) = urls[case]
    assert port_urls == ref_urls
    assert bool(port_urls) == case.startswith("M")
    if case.startswith("no-"):
        assert port[0] == 1 and not ref_files
    else:
        assert port[0] == 0 and ref_files
    if case == "M-servers":
        assert port_urls[0].startswith("http://mb.test:81/")
        assert port_urls[1].startswith("http://fdb.test:82/")


def test_dvda2track_rips_decode_to_the_titles(tool_runs):
    (base, samples, _results, _urls) = tool_runs
    for (case, key, frames) in (("flac8", (1, 1), [3200, 4800, 1600]),
                                ("wavpack", (1, 1), [3200, 4800, 1600]),
                                ("mlp", (1, 2), [1600, 1600]),
                                ("titleset2", (2, 1), [960, 640])):
        directory = os.path.join(base, "port", case)
        names = sorted(os.listdir(directory))
        assert len(names) == len(frames)
        got = np.concatenate([pcm.read_all(dispatch.open(
            os.path.join(directory, n), device="cpu").to_pcm())
            for n in names])
        assert np.array_equal(got, samples[key][:sum(frames)])


def test_dvda2track_names_and_tags_its_files(tool_runs):
    (base, _samples, _results, _urls) = tool_runs
    names = sorted(os.listdir(os.path.join(base, "port", "M")))
    assert len(names) == 3
    metadata = dispatch.open(os.path.join(base, "port", "M", names[1]),
                             device="cpu").get_metadata()
    assert (metadata.track_number, metadata.track_total,
            metadata.album_name) == (2, 3, "Canned Release")
    # --track-start 5: the three tracks named 5 to 7
    assert sorted(os.listdir(os.path.join(base, "port", "numbers"))) == [
        "05 - .wav", "06 - .wav", "07 - .wav"]


@pytest.mark.parametrize("flags", [["-I"], ["-M", "-I"]],
                         ids=["alone", "with-lookup"])
def test_dvda2track_refuses_interactive_mode(tmp_path, monkeypatch, flags):
    """with urwid absent, the reference's dvda2track looks at -I only
    with -M: alone it rips, with -M it exits 1 with the error after the
    lookup and before any rip; the port does the same, writing the same
    files"""
    for (key, value) in REFERENCE_ENV.items():
        monkeypatch.setenv(key, value)
    monkeypatch.setattr(ref_dvda.DVDATrack, "sample_rate",
                        lambda track: track.title.sample_rate, raising=False)
    monkeypatch.chdir(tmp_path)
    (path, _samples) = build_disc(".", [STRUCTURE[0][:1]])
    with urwid_as(None), canned_lookups() as server:
        ref = ref_tool("dvda2track", *flags, "-A", path, "-d", "ref")
        ref_urls = list(server.urls)
        port = port_tool("dvda2track", *flags, "-A", path, "-d", "port")
    assert port == (ref[0], as_port(ref[1]), as_port(ref[2]))
    assert server.urls[len(ref_urls):] == ref_urls
    assert tree("port") == tree("ref")
    if flags == ["-I"]:
        assert port[0] == 0 and len(tree("port")) == 2
    else:
        assert port[0] == 1 and port[2].endswith(URWID_REQUIRED)
        assert tree("port") == {} and len(ref_urls) == 2


def test_dvda2track_needs_a_card_or_the_cpu_named(tmp_path):
    (path, _samples) = build_disc(str(tmp_path), [STRUCTURE[0][:1]])
    out = str(tmp_path / "out")
    (code, stdout, stderr) = port_tool("dvda2track", "-A", path, "-d", out,
                                       devices=())
    if torch.cuda.is_available():
        assert code == 0
    else:
        assert (code, stdout) == (1, "")
        assert stderr.startswith("*** Error: ")
        assert not os.path.exists(out)
