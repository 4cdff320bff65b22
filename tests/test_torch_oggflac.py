"""Ogg pages and packets (``ogg``) and Ogg FLAC (``OggFlacAudio``) in the
port against the reference: the page CRC, pages and lacing byte for
byte, a corrupted page, files at levels 0, 5 and 8 and after
``set_metadata`` byte for byte, their decodes equal, the STREAMINFO
MD5 unchecked, the header packet count kept (a difference from the
reference), and the tools on Ogg FLAC in fresh interpreters under a
temporary HOME.  Every input is made from a numpy seed; the encoders
run pinned (``REFERENCE_ENV``)."""

import io
import os
import shutil

import numpy as np
import pytest
import torch

from audiotools_tpu import _native as ref_native
from audiotools_tpu import ogg as ref_ogg
from audiotools_tpu.audiofile import MetaData as RefMetaData
from audiotools_tpu.formats.flac import InvalidFLAC as RefInvalidFLAC
from audiotools_tpu.formats.flac import OggFlacAudio as RefOggFlacAudio
from audiotools_tpu_torch import _native, dispatch, ogg, pcm
from audiotools_tpu_torch.audiofile import InvalidFile, MetaData
from audiotools_tpu_torch.formats import flac as flac_module
from audiotools_tpu_torch.formats.flac import (FlacAudio, InvalidFLAC,
                                               OggFlacAudio)
from audiotools_tpu_torch.formats.wav import WaveAudio
from test_torch_aiff import ref_reader, run_session, samples, tree
from test_torch_cli import REFERENCE_ENV

torch.set_num_threads(1)

SR = 8000


@pytest.fixture
def pinned(monkeypatch):
    for (key, value) in REFERENCE_ENV.items():
        monkeypatch.setenv(key, value)


def read(path):
    with open(path, "rb") as f:
        return f.read()


def test_page_crc_equals_the_references():
    rng = np.random.default_rng(1)
    for size in (0, 1, 27, 4096, 65307):
        data = rng.integers(0, 256, size, dtype=np.uint8).tobytes()
        for initial in (0, 0x12345678):
            assert _native.ogg_crc(data, initial) == \
                ref_native.ogg_crc(data, initial)


LENGTHS = [0, 1, 254, 255, 256, 510, 600, 255 * 255, 255 * 255 + 1,
           70000]


@pytest.mark.parametrize("length", LENGTHS)
def test_packets_and_pages_equal_the_references(length):
    rng = np.random.default_rng(length)
    packet = rng.integers(0, 256, length, dtype=np.uint8).tobytes()
    assert list(ogg.packet_to_segments(packet)) == \
        list(ref_ogg.packet_to_segments(packet))
    mine = list(ogg.packet_to_pages(packet, 0x1234, 7))
    theirs = list(ref_ogg.packet_to_pages(packet, 0x1234, 7))
    for (page, ref_page) in zip(mine, theirs):
        page.granule_position = ref_page.granule_position = length
    assert [p.build() for p in mine] == [p.build() for p in theirs]
    packets = [packet, packet[:100], b"", packet[::-1]]
    mine = list(ogg.packets_to_pages(packets, 5))
    theirs = list(ref_ogg.packets_to_pages(packets, 5))
    assert [p.build() for p in mine] == [p.build() for p in theirs]
    stream = b"".join(p.build() for p in theirs)
    reader = ogg.PacketReader(ogg.PageReader(io.BytesIO(stream)))
    assert [reader.read_packet() for _ in packets] == packets
    with pytest.raises(IOError):
        reader.read_packet()
    (page, size) = ogg.Page.parse(stream)
    (ref_page, ref_size) = ref_ogg.Page.parse(stream)
    assert size == ref_size and page.segments == ref_page.segments
    assert (page.packet_continuation, page.stream_beginning,
            page.stream_end, page.granule_position,
            page.bitstream_serial_number, page.sequence_number) == (
                ref_page.packet_continuation, ref_page.stream_beginning,
                ref_page.stream_end, ref_page.granule_position,
                ref_page.bitstream_serial_number, ref_page.sequence_number)


def test_a_corrupted_page_raises_as_the_references():
    page = ogg.Page(False, True, False, 1234, 99, 0, [b"abc", b""])
    data = bytearray(page.build())
    assert ogg.Page.parse(bytes(data))[0].segments == [b"abc", b""]
    data[-2] ^= 0x40
    for module in (ogg, ref_ogg):
        with pytest.raises(ValueError) as err:
            module.PageReader(io.BytesIO(bytes(data))).read()
        assert str(err.value) == "Ogg page checksum mismatch"
        assert module.Page.parse(bytes(data), verify_crc=False)[0].segments \
            == [bytes(data[-3:]), b""]
        with pytest.raises(ValueError) as err:
            module.Page.parse(b"OggX" + bytes(data[4:]))
        assert str(err.value) == "invalid Ogg page marker"
        with pytest.raises(IOError):
            module.Page.parse(bytes(data[:30]))


def encode_both(tmp_path, arr, level, bps=16, rate=SR):
    """(the port's file, the reference's) of ``arr`` at ``level``"""
    (mine, theirs) = (str(tmp_path / "p.oga"), str(tmp_path / "r.oga"))
    OggFlacAudio.from_pcm(mine, pcm.reader_from_array(arr, bps, rate), level,
                          device="cpu")
    RefOggFlacAudio.from_pcm(theirs, ref_reader(arr, bps, rate), level)
    return (mine, theirs)


def ref_decode(path):
    decoder = RefOggFlacAudio(path).to_pcm()
    pieces = []
    try:
        while True:
            framelist = decoder.read(4096)
            if framelist.frames == 0:
                break
            pieces.append(framelist.to_bytes(False, True))
    finally:
        decoder.close()
    return b"".join(pieces)


@pytest.mark.parametrize("level", ["0", "5", "8"])
@pytest.mark.parametrize("frames", [0, 1, 4096, 3 * SR + 7])
def test_ogg_flac_files_equal_the_references(tmp_path, pinned, level, frames):
    arr = samples(frames + int(level), frames, 2, 16)
    (mine, theirs) = encode_both(tmp_path, arr, level)
    assert read(mine) == read(theirs)
    track = dispatch.open(mine, device="cpu")
    assert type(track) is OggFlacAudio
    assert (track.total_frames(), track.sample_rate(), track.channels(),
            track.bits_per_sample()) == (frames, SR, 2, 16)
    got = pcm.read_all(track.to_pcm())
    assert np.array_equal(got, arr)
    assert (pcm.FrameList._wrap(got, 16).to_bytes(False, True) ==
            ref_decode(theirs))
    assert track.verify()


def test_a_frame_across_pages_equals_the_references(tmp_path, pinned):
    """6 channels of 24-bit noise at level 8: each 4096-frame FLAC frame
    is a packet of more than 255 x 255 bytes, laced over two pages"""
    rng = np.random.default_rng(3)
    arr = rng.integers(-(1 << 23), 1 << 23, (2 * 4096 + 5, 6)).astype(
        np.int32)
    (mine, theirs) = encode_both(tmp_path, arr, "8", bps=24, rate=48000)
    assert read(mine) == read(theirs)
    with open(mine, "rb") as f:
        pages = []
        reader = ogg.PageReader(f)
        while True:
            try:
                pages.append(reader.read())
            except IOError:
                break
    assert any(p.packet_continuation for p in pages)
    track = OggFlacAudio(mine, device="cpu")
    decoder = track.to_pcm()
    assert decoder.channel_mask == 0x3F
    assert np.array_equal(pcm.read_all(decoder), arr)


def test_from_pcm_takes_no_configured_quality(tmp_path, pinned, monkeypatch):
    """the reference's OggFlacAudio.from_pcm takes DEFAULT_COMPRESSION
    when none is given, whatever [Quality] flac says; FlacAudio takes
    the configured level"""
    monkeypatch.setattr(flac_module, "default_quality",
                        lambda name: "0" if name == "flac" else "")
    arr = samples(4, 2 * SR, 2, 16)
    default = str(tmp_path / "default.oga")
    OggFlacAudio.from_pcm(default, pcm.reader_from_array(arr, 16, SR), None,
                          device="cpu")
    (level8, _theirs) = encode_both(tmp_path, arr, "8")
    assert read(default) == read(level8)
    FlacAudio.from_pcm(str(tmp_path / "a.flac"),
                       pcm.reader_from_array(arr, 16, SR), None, device="cpu")
    assert FlacAudio(str(tmp_path / "a.flac"), device="cpu").get_metadata(
        ).block_list[0].maximum_block_size == 1152


def test_set_metadata_equals_the_references_and_reads_back(tmp_path, pinned):
    """after set_metadata both files are equal; the reference's object
    then reads an audio packet as a block (it counts 1 + the blocks
    that are no STREAMINFO, its header counts those blocks) and raises,
    where the port's reads its new tags; a fresh open of either reads
    them"""
    arr = samples(5, 2 * SR, 2, 16)
    (mine, theirs) = encode_both(tmp_path, arr, "5")
    (track, ref) = (OggFlacAudio(mine, device="cpu"), RefOggFlacAudio(theirs))
    track.set_metadata(MetaData(track_name="Tëst", artist_name="A",
                                track_number=2))
    ref.set_metadata(RefMetaData(track_name="Tëst", artist_name="A",
                                 track_number=2))
    assert read(mine) == read(theirs)
    with pytest.raises(RefInvalidFLAC):
        ref.get_metadata()
    with pytest.raises(RefInvalidFLAC):
        ref.set_metadata(RefMetaData(track_name="Again"))
    assert track.get_metadata().track_name == "Tëst"
    assert RefOggFlacAudio(theirs).get_metadata().track_name == "Tëst"
    assert np.array_equal(pcm.read_all(track.to_pcm()), arr)
    # the port's object retags again; the reference's needs a fresh open
    track.set_metadata(MetaData(track_name="Again"))
    RefOggFlacAudio(theirs).set_metadata(RefMetaData(track_name="Again"))
    assert read(mine) == read(theirs)
    assert track.get_metadata().track_name == "Again"
    track.delete_metadata()
    RefOggFlacAudio(theirs).delete_metadata()
    assert read(mine) == read(theirs)
    assert track.get_metadata().track_name is None
    assert np.array_equal(pcm.read_all(OggFlacAudio(
        mine, device="cpu").to_pcm()), arr)
    assert track.verify()


def with_streaminfo_md5(path, md5):
    """rewrites the first page of an Ogg FLAC file with another MD5 in
    its STREAMINFO (its CRC made anew)"""
    data = read(path)
    (page, size) = ogg.Page.parse(data)
    packet = page.segments[0]
    page.segments[0] = packet[:35] + md5 + packet[51:]
    with open(path, "wb") as f:
        f.write(page.build() + data[size:])


def test_a_wrong_streaminfo_md5_is_not_checked(tmp_path, pinned):
    """the reference checks no MD5 on Ogg FLAC: a wrong one decodes and
    verifies in both packages (and raises in native FLAC)"""
    arr = samples(6, 3 * SR, 2, 16)
    (mine, theirs) = encode_both(tmp_path, arr, "5")
    for path in (mine, theirs):
        with_streaminfo_md5(path, b"\x5a" * 16)
    track = OggFlacAudio(mine, device="cpu")
    assert track.get_metadata().block_list[0].md5sum == b"\x5a" * 16
    assert np.array_equal(pcm.read_all(track.to_pcm()), arr)
    assert track.verify() and RefOggFlacAudio(theirs).verify()
    flac = str(tmp_path / "a.flac")
    FlacAudio.from_pcm(flac, pcm.reader_from_array(arr, 16, SR), "5",
                       device="cpu")
    metadata = FlacAudio(flac, device="cpu").get_metadata()
    metadata.block_list[0].md5sum = b"\x5a" * 16
    FlacAudio(flac, device="cpu").update_metadata(metadata)
    with pytest.raises(InvalidFile):
        FlacAudio(flac, device="cpu").verify()


def test_damaged_streams_fail_as_the_references(tmp_path, pinned):
    """a corrupted audio page ends the stream, and so does a cut one:
    both packages report the stream truncated; a corrupted first page
    is no Ogg FLAC file"""
    arr = samples(7, 3 * SR, 2, 16)
    (mine, _theirs) = encode_both(tmp_path, arr, "5")
    data = read(mine)
    cases = {"crc": data[:len(data) // 2] + bytes([data[len(data) // 2] ^ 1]) +
             data[len(data) // 2 + 1:], "cut": data[:len(data) // 2]}
    for (name, body) in cases.items():
        path = str(tmp_path / (name + ".oga"))
        with open(path, "wb") as f:
            f.write(body)
        with pytest.raises(InvalidFLAC) as err:
            OggFlacAudio(path, device="cpu").verify()
        with pytest.raises(RefInvalidFLAC) as ref_err:
            RefOggFlacAudio(path).verify()
        assert str(err.value) == str(ref_err.value) == \
            "truncated Ogg FLAC stream"
    bad = str(tmp_path / "head.oga")
    with open(bad, "wb") as f:
        f.write(data[:40] + bytes([data[40] ^ 1]) + data[41:])
    with pytest.raises(InvalidFLAC) as err:
        dispatch.open(bad, device="cpu")
    with pytest.raises(RefInvalidFLAC) as ref_err:
        RefOggFlacAudio(bad)
    assert str(err.value) == str(ref_err.value) == \
        "Ogg page checksum mismatch"


def test_other_ogg_streams_are_not_opened(tmp_path):
    """named for what it once checked, that the port opened no Ogg
    Vorbis or Opus stream: each is now the reference's class (whose
    header the class reads when it is available), and an Ogg stream of
    another codec is unknown to both packages"""
    from audiotools_tpu import dispatch as ref_dispatch
    heads = {"vorbis": b"\x01vorbis" + b"\x00" * 23,
             "opus": b"OpusHead\x01\x02" + b"\x00" * 9,
             None: b"\x80theora" + b"\x00" * 35}
    for (name, head) in heads.items():
        page = ogg.Page(False, True, False, 0, 1, 0, [head])
        path = str(tmp_path / "x.ogg")
        with open(path, "wb") as f:
            f.write(page.build())
        with open(path, "rb") as f:
            got = dispatch.file_type(f)
            want = ref_dispatch.file_type(f)
        assert (got and got.NAME) == (want and want.NAME) == name
        if name is None:
            with pytest.raises(dispatch.UnknownAudioType):
                dispatch.open(path, device="cpu")
        elif got.available():
            assert type(dispatch.open(path, device="cpu")) is got


OGG_STEPS = [
    ("track2track", ["-t", "oggflac", "-d", "{side}/oga", "--format",
                     "%(basename)s.%(suffix)s", "-j", "1", "src/a.wav",
                     "src/b.flac"]),
    ("track2track", ["-t", "oggflac", "-q", "0", "-o", "{side}/zero.oga",
                     "src/a.wav"]),
    ("track2track", ["-t", "flac", "-o", "{side}/configured.flac",
                     "src/a.wav"]),
    ("tracktag", ["--name=Title", "--artist=Artist", "--number=3",
                  "{side}/oga/a.oga", "{side}/oga/b.oga"]),
    ("tracktag", ["--comment=Again", "--replay-gain", "{side}/oga/a.oga",
                  "{side}/oga/b.oga"]),
    ("track2track", ["-t", "wav", "-d", "{side}/wav", "--format",
                     "%(basename)s.%(suffix)s", "-j", "1",
                     "{side}/oga/a.oga"]),
    ("trackinfo", ["-L", "{side}/oga/a.oga", "{side}/zero.oga"]),
    ("tracklength", ["{side}/oga"]),
    ("trackverify", ["-j", "1", "{side}/oga/a.oga", "{side}/oga/b.oga",
                     "src/cut.oga"]),
    ("trackcmp", ["-j", "1", "src/a.wav", "{side}/oga/a.oga",
                  "src/b.flac", "{side}/oga/b.oga",
                  "src/a.wav", "{side}/zero.oga",
                  "src/b.flac", "{side}/oga/a.oga"]),
]


def test_tools_on_ogg_flac_equal_the_references(tmp_path, monkeypatch):
    """under a configured ``[Quality] flac = 0``: track2track to Ogg FLAC
    (at level 8, the configuration not taken, where FLAC takes it),
    tracktag twice (tags, then ReplayGain), back to WAVE, trackinfo,
    tracklength, trackverify and trackcmp: the same files, lines and
    exit codes"""
    monkeypatch.chdir(tmp_path)
    home = tmp_path / "home"
    home.mkdir()
    (home / ".audiotools.cfg").write_text("[Quality]\nflac = 0\n")
    os.makedirs("src")
    arr = samples(8, 2 * SR, 2, 16)
    WaveAudio.from_pcm("src/a.wav", pcm.reader_from_array(arr, 16, SR))
    with monkeypatch.context() as mp:
        for (key, value) in REFERENCE_ENV.items():
            mp.setenv(key, value)
        FlacAudio.from_pcm("src/b.flac", pcm.reader_from_array(
            samples(9, SR, 2, 16), 16, SR), "5", device="cpu")
        OggFlacAudio.from_pcm("src/cut.oga", pcm.reader_from_array(
            arr, 16, SR), "0", device="cpu")
        OggFlacAudio.from_pcm(str(tmp_path / "level8.oga"),
                              pcm.reader_from_array(arr, 16, SR), "8",
                              device="cpu")
    data = read("src/cut.oga")
    with open("src/cut.oga", "wb") as f:
        f.write(data[:len(data) * 2 // 3])
    ref = run_session("ref", OGG_STEPS, home)
    port = run_session("port", OGG_STEPS, home)
    for ((tool, _args), want, got) in zip(OGG_STEPS, ref, port):
        if tool == "trackverify":
            (want, got) = ((want[0], sorted(want[1].splitlines()), want[2]),
                           (got[0], sorted(got[1].splitlines()), got[2]))
        assert got == want, tool
    assert [code for (code, _out, _err) in port] == [0] * 8 + [1, 1]
    ref_files = tree("ref")
    assert tree("port") == ref_files and len(ref_files) == 5
    # the configured level went to FLAC (block size 1152), not Ogg FLAC
    assert OggFlacAudio("port/zero.oga", device="cpu").get_metadata(
        ).block_list[0].maximum_block_size == 1152
    assert FlacAudio("port/configured.flac", device="cpu").get_metadata(
        ).block_list[0].maximum_block_size == 1152
    tagged = OggFlacAudio("port/oga/a.oga", device="cpu")
    assert (tagged.get_metadata().track_name, tagged.replay_gain()
            is not None) == ("Title", True)
    assert np.array_equal(pcm.read_all(tagged.to_pcm()), arr)
    # the untagged level-8 file's frames are the tagged file's
    shutil.copy(str(tmp_path / "level8.oga"), "level8-tagged.oga")
    OggFlacAudio("level8-tagged.oga", device="cpu").set_metadata(
        tagged.get_metadata())
    assert read("level8-tagged.oga") == read("port/oga/a.oga")
