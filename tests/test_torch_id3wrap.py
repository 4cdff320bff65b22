"""FLAC files behind ID3v2 tags (stacked ones too), with and without an
ID3v1 tag after the last frame: the port opens, decodes, verifies and
retags them as the reference does, and its files equal the
reference's byte for byte.  ``meta/id3``'s two helpers against the
reference's.  The signals are seeded; the encoders run pinned
(``REFERENCE_ENV``)."""

import io
import os
import shutil

import numpy as np
import pytest
import torch

from audiotools_tpu import dispatch as ref_dispatch
from audiotools_tpu.audiofile import MetaData as RefMetaData
from audiotools_tpu.meta import id3 as ref_id3
from audiotools_tpu_torch import dispatch, pcm
from audiotools_tpu_torch.audiofile import MetaData
from audiotools_tpu_torch.formats.flac import FlacAudio
from audiotools_tpu_torch.meta import id3
from test_torch_cli import REFERENCE_ENV, port_tool, ref_tool

torch.set_num_threads(1)

RATE = 8000


def id3v2(body_size, version=3):
    """an ID3v2 tag of ``version`` holding a TIT2 frame, padded to
    ``body_size`` bytes after its 10-byte header"""
    frame = (b"TIT2" + (11).to_bytes(4, "big") + b"\x00\x00\x00" +
             b"0123456789")
    body = frame + b"\x00" * (body_size - len(frame))
    size = bytes((len(body) >> shift) & 0x7F for shift in (21, 14, 7, 0))
    return b"ID3" + bytes([version, 0, 0]) + size + body


# 128 bytes: "TAG", title, artist, album, year, comment, genre
ID3V1 = (b"TAG" + b"Title".ljust(30, b"\x00") + b"Artist".ljust(30, b"\x00") +
         b"Album".ljust(30, b"\x00") + b"1999" + b"\x00" * 30 + b"\x0c")

PREFIXES = {"single": id3v2(64), "stacked": id3v2(64) + id3v2(30, 4)}


def signal(seed, frames=3 * RATE):
    rng = np.random.default_rng(seed)
    t = np.arange(frames)
    arr = np.stack([6000 * np.sin(2 * np.pi * 330 * t / RATE) +
                    rng.normal(0, 300, frames),
                    rng.normal(0, 2000, frames)], axis=1)
    return np.clip(arr, -32768, 32767).astype(np.int32)


@pytest.fixture
def pinned(monkeypatch):
    for (key, value) in REFERENCE_ENV.items():
        monkeypatch.setenv(key, value)


def wrapped_flac(path, prefix, trailer, seed=1):
    """a FLAC -5 file of signal(seed) at ``path`` with ``prefix`` before
    it and ``trailer`` after it; returns the samples"""
    arr = signal(seed)
    plain = path + ".plain"
    FlacAudio.from_pcm(plain, pcm.reader_from_array(arr, 16, RATE), "5",
                       device="cpu")
    with open(plain, "rb") as f:
        data = f.read()
    os.unlink(plain)
    with open(path, "wb") as f:
        f.write(prefix + data + trailer)
    return arr


def read(path):
    with open(path, "rb") as f:
        return f.read()


@pytest.mark.parametrize("data", [
    b"", b"ID3", b"fLaC" + b"\x00" * 20, id3v2(20), id3v2(20, 2),
    id3v2(20) + id3v2(40, 4) + b"fLaC", id3v2(20, 5) + b"fLaC",
    id3v2(300) + b"tail"])
def test_id3v2_skip_and_count_equal_the_references(data):
    for start in (0, 3) if len(data) > 3 else (0,):
        (f, g) = (io.BytesIO(data), io.BytesIO(data))
        f.seek(start)
        g.seek(start)
        assert id3.skip_id3v2_comment(f) == ref_id3.skip_id3v2_comment(g)
        assert f.tell() == g.tell()
        f.seek(start)
        g.seek(start)
        assert id3.total_id3v2_comments(f) == ref_id3.total_id3v2_comments(g)
        assert f.tell() == start


@pytest.mark.parametrize("prefix", sorted(PREFIXES))
@pytest.mark.parametrize("trailer", ["none", "id3v1"])
def test_wrapped_flac_opens_decodes_and_verifies(tmp_path, pinned, prefix,
                                                 trailer):
    path = str(tmp_path / "a.flac")
    arr = wrapped_flac(path, PREFIXES[prefix],
                       ID3V1 if trailer == "id3v1" else b"")
    ref = ref_dispatch.open(path)
    track = dispatch.open(path, device="cpu")
    assert type(track) is FlacAudio and type(ref).__name__ == "FlacAudio"
    assert track.total_frames() == ref.total_frames() == len(arr)
    assert (track.sample_rate(), track.channels(), track.bits_per_sample()) \
        == (ref.sample_rate(), ref.channels(), ref.bits_per_sample())
    assert np.array_equal(pcm.read_all(track.to_pcm()), arr)
    assert track.verify() and ref.verify()
    assert track.get_metadata().block_list[0] == \
        FlacAudio(path, device="cpu").get_metadata().block_list[0]


@pytest.mark.parametrize("prefix", sorted(PREFIXES))
@pytest.mark.parametrize("trailer", ["none", "id3v1"])
@pytest.mark.parametrize("size", ["in place", "rewritten"])
def test_set_metadata_keeps_the_tags_around_the_stream(tmp_path, pinned,
                                                       prefix, trailer,
                                                       size):
    """the new blocks fit the old PADDING ("in place") or outgrow it
    ("rewritten", through a temporary file): both files equal the
    reference's, the ID3v2 tags before and the ID3v1 tag after kept"""
    tail = ID3V1 if trailer == "id3v1" else b""
    source = str(tmp_path / "a.flac")
    arr = wrapped_flac(source, PREFIXES[prefix], tail)
    (mine, theirs) = (str(tmp_path / "port.flac"), str(tmp_path / "ref.flac"))
    shutil.copy(source, mine)
    shutil.copy(source, theirs)
    name = "x" * (10 if size == "in place" else 6000)
    track = dispatch.open(mine, device="cpu")
    track.set_metadata(MetaData(track_name=name, artist_name="Künstler",
                                track_number=4))
    ref_dispatch.open(theirs).set_metadata(RefMetaData(
        track_name=name, artist_name="Künstler", track_number=4))
    data = read(mine)
    assert data == read(theirs)
    assert data.startswith(PREFIXES[prefix]) and data.endswith(tail)
    assert (len(data) == os.path.getsize(source)) == (size == "in place")
    again = dispatch.open(mine, device="cpu")
    assert again.get_metadata().track_name == name
    assert np.array_equal(pcm.read_all(again.to_pcm()), arr)
    assert again.verify()
    # a second retag of the same object
    track.delete_metadata()
    ref_dispatch.open(theirs).delete_metadata()
    assert read(mine) == read(theirs)


def test_clean_and_update_metadata_keep_the_prefix(tmp_path, pinned):
    """clean() with an output file, and update_metadata of the file's
    own blocks, on a wrapped file: the reference's bytes"""
    source = str(tmp_path / "a.flac")
    wrapped_flac(source, PREFIXES["stacked"], ID3V1)
    track = FlacAudio(source, device="cpu")
    assert track.clean(str(tmp_path / "port.flac")) == []
    ref_dispatch.open(source).clean(str(tmp_path / "ref.flac"))
    assert read(tmp_path / "port.flac") == read(tmp_path / "ref.flac")
    assert read(tmp_path / "port.flac").startswith(PREFIXES["stacked"])
    before = read(source)
    track.update_metadata(track.get_metadata())
    assert read(source) == before


def test_tools_on_wrapped_flac_equal_the_references(tmp_path, pinned,
                                                    monkeypatch):
    """tracktag, trackinfo, trackverify and track2track (to WAVE) of
    both packages, in-process, on copies of the same wrapped files"""
    monkeypatch.chdir(tmp_path)
    for side in ("ref", "port"):
        os.makedirs(side)
    for (name, prefix, trailer, seed) in (("a", "single", b"", 1),
                                          ("b", "stacked", ID3V1, 2)):
        wrapped_flac("ref/%s.flac" % name, PREFIXES[prefix], trailer, seed)
        shutil.copy("ref/%s.flac" % name, "port/%s.flac" % name)
    files = {side: ["%s/a.flac" % side, "%s/b.flac" % side]
             for side in ("ref", "port")}
    for (tool, args) in (
            ("tracktag", ["--name=Song", "--album=Album", "--number=2"]),
            ("trackinfo", []),
            ("trackverify", ["-j", "1"]),
            ("track2track", ["-t", "wav", "-j", "1", "--format",
                             "%(basename)s.%(suffix)s", "-d", "{side}/out"])):
        (code, out, err) = ref_tool(tool, *[a.format(side="ref")
                                            for a in args], *files["ref"])
        (pcode, pout, perr) = port_tool(tool, *[a.format(side="port")
                                                for a in args],
                                        *files["port"])
        assert (pcode, perr) == (code, err) == (0, "")
        out = out.replace("ref/", "port/")
        if tool == "trackverify":
            (out, pout) = (sorted(out.splitlines()), sorted(pout.splitlines()))
            assert "port/b.flac : OK" in pout
        assert pout == out
    for name in ("a.flac", "b.flac", "out/a.wav", "out/b.wav"):
        assert read("port/" + name) == read("ref/" + name)
    assert read("port/b.flac").endswith(ID3V1)
