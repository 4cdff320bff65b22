"""The lossy formats in the port against the reference: MP3 and MP2
(``formats/mp3``, ``codecs/mpeg``, ``_native.verify_mpeg``), Ogg Vorbis
(``formats/vorbis``, ``codecs/vorbis``) and Ogg Opus (``formats/opus``,
``codecs/opus``), and AAC M4A detection (``formats/m4a.M4AAudio``).

Both packages load the same system libraries, and neither encoder
draws on a seed (the Ogg serials are fixed), so from the same seeded
PCM the port's ``from_pcm`` must write the reference's bytes and its
``to_pcm`` must give the reference's samples: every comparison here is
exact, no tolerance.  A class whose library is not found skips, as the
reference's ``tests/test_lossy_ogg.py`` does; the decision is made in
each test, not at import.  Where the reference dithers (a 24-bit source
to 16 bits), both run with the same stand-in for ``os.urandom``.
"""

import io
import os
import struct

import numpy as np
import pytest

import audiotools_tpu as ref_root
from audiotools_tpu import _native as ref_native
from audiotools_tpu import audiofile as ref_audiofile
from audiotools_tpu import dispatch as ref_dispatch
from audiotools_tpu.formats import m4a as ref_m4a
from audiotools_tpu.formats import mp3 as ref_mp3
from audiotools_tpu.formats import opus as ref_opus
from audiotools_tpu.formats import vorbis as ref_vorbis
from audiotools_tpu.pcmstream import PCMReader as RefPCMReader
from audiotools_tpu_torch import _native, audiofile, dispatch, pcm
from audiotools_tpu_torch.formats import m4a, mp3, opus, vorbis
from audiotools_tpu_torch.meta import id3
from test_torch_converters import urandom_stand_in
from test_torch_meta import png_bytes

SR = 44100

# (port class, reference class, qualities besides the default)
CLASSES = {
    "mp3": (mp3.MP3Audio, ref_mp3.MP3Audio, ["0", "9"]),
    "mp2": (mp3.MP2Audio, ref_mp3.MP2Audio, ["64", "384"]),
    "vorbis": (vorbis.VorbisAudio, ref_vorbis.VorbisAudio, ["0", "10"]),
    "opus": (opus.OpusAudio, ref_opus.OpusAudio, ["0", "10"]),
}
NAMES = sorted(CLASSES)


def classes(name):
    """the port's and the reference's class, the test skipped where the
    reference finds no library for it"""
    (cls, ref_cls, _qualities) = CLASSES[name]
    if not ref_cls.available():
        pytest.skip("the libraries of %s are not found" % (name,))
    assert cls.available()
    return (cls, ref_cls)


def signal(seed, frames, channels=2, bps=16):
    """tones over seeded noise, full scale at ``bps`` bits"""
    rng = np.random.default_rng(seed)
    top = 1 << (bps - 1)
    t = np.arange(frames)[:, None]
    arr = (0.3 * top * np.sin(2 * np.pi * (330 + 110 * np.arange(channels))
                              * t / SR) +
           rng.normal(0, top / 100, (frames, channels)))
    return np.clip(arr, -top, top - 1).astype(np.int32)


def ref_reader(arr, bps=16, rate=SR):
    return RefPCMReader(io.BytesIO(pcm.FrameList(arr, bps).to_bytes(
        False, True)), rate, arr.shape[1],
        pcm.CHANNEL_MASKS.get(arr.shape[1], 0), bps, signed=True)


def drain(reader):
    """every frame of a PCMReader of either package, int32 [n, ch]"""
    chunks = []
    while True:
        frame = reader.read(4096)
        if frame.frames == 0:
            break
        chunks.append(np.array(frame.samples, dtype=np.int32))
    reader.close()
    return (np.concatenate(chunks) if chunks else
            np.zeros((0, reader.channels), np.int32))


def read(path):
    with open(path, "rb") as f:
        return f.read()


def encode_both(tmp_path, name, arr, bps=16, rate=SR, compression=None):
    """(port file, reference file) of ``arr`` through each from_pcm"""
    (cls, ref_cls) = classes(name)
    suffix = cls.SUFFIX
    (mine, theirs) = (str(tmp_path / ("p-%s.%s" % (compression, suffix))),
                      str(tmp_path / ("r-%s.%s" % (compression, suffix))))
    kwargs = {"device": "cpu"} if name == "opus" else {}
    track = cls.from_pcm(mine, pcm.reader_from_array(arr, bps, rate),
                         compression, **kwargs)
    ref = ref_cls.from_pcm(theirs, ref_reader(arr, bps, rate), compression)
    return (track, ref)


@pytest.fixture(scope="module")
def stereo():
    return signal(1, SR + 4321)


@pytest.mark.parametrize("name", NAMES)
def test_from_pcm_writes_the_references_bytes(tmp_path, stereo, name):
    """the default quality and the extremes of the class's modes"""
    for compression in [None] + CLASSES[name][2]:
        (track, ref) = encode_both(tmp_path, name, stereo,
                                   compression=compression)
        assert read(track.filename) == read(ref.filename), compression
        # LAME's -V 9 resamples to an MPEG-2 rate, which neither
        # package's file_type takes for MP3
        with open(track.filename, "rb") as f:
            got = dispatch.file_type(f)
            want = ref_dispatch.file_type(f)
        assert (got and got.NAME) == (want and want.NAME)


@pytest.mark.parametrize("name", NAMES)
def test_to_pcm_gives_the_references_samples(tmp_path, stereo, name):
    (track, ref) = encode_both(tmp_path, name, stereo)
    (got, want) = (track.to_pcm(), ref.to_pcm())
    assert (got.sample_rate, got.channels, got.channel_mask,
            got.bits_per_sample) == (want.sample_rate, want.channels,
                                     int(want.channel_mask),
                                     want.bits_per_sample)
    (got, want) = (drain(got), drain(want))
    assert got.shape[1] == 2 and len(got) > 0.9 * len(stereo)
    assert np.array_equal(got, want)
    # the port's decoder on the reference's own file
    assert np.array_equal(
        drain(type(track)(ref.filename).to_pcm()), want)
    assert (track.sample_rate(), track.channels(), track.bits_per_sample(),
            int(track.channel_mask()), track.lossless()) == (
                ref.sample_rate(), ref.channels(), ref.bits_per_sample(),
                int(ref.channel_mask()), ref.lossless())


@pytest.mark.parametrize("name", NAMES)
def test_total_frames_and_verify_are_the_references(tmp_path, stereo, name):
    """total_frames; verify on the file and on it cut short (an MPEG
    stream cut inside its last frame fails; Vorbis and Opus decode what
    is left, in both packages)"""
    (track, ref) = encode_both(tmp_path, name, stereo)
    assert track.total_frames() == ref.total_frames() > 0
    if name in ("vorbis", "opus"):
        # an Ogg stream's last granule is the decoded frame count
        assert track.total_frames() == len(drain(track.to_pcm()))
    assert track.verify() is True and ref.verify() is True
    data = read(track.filename)
    for cut in (100, len(data) // 2):
        path = str(tmp_path / ("cut-%d.%s" % (cut, track.SUFFIX)))
        with open(path, "wb") as f:
            f.write(data[:len(data) - cut])
        outcome = []
        for cls in (type(track), type(ref)):
            try:
                outcome.append(cls(path).verify())
            except (audiofile.InvalidFile, ref_root.InvalidFile) as err:
                outcome.append(str(err))
        assert outcome[0] == outcome[1], cut
        if name in ("mp3", "mp2"):
            assert outcome[0] != True, cut     # noqa: E712
            with pytest.raises(audiofile.InvalidFile):
                type(track)(path).verify()


def test_mpeg_walker_is_the_references(tmp_path, stereo):
    """verify_mpeg on MP3 and MP2 streams, with tags before and after,
    cut, and on bytes that are no stream"""
    cases = []
    for name in ("mp3", "mp2"):
        (track, _ref) = encode_both(tmp_path, name, stereo)
        data = read(track.filename)
        tag = id3.ID3v23Comment.converted(audiofile.MetaData(
            track_name="x" * 200)).size()
        cases += [data, data[:-57], data[:3], b"ID3\x03\x00\x00\x00\x00\x00"
                  b"\x05abcde" + data, data + b"TAG" + b"\x00" * 125,
                  data + b"APETAGEX" + b"\x00" * 24, b"\x00" * 1000,
                  data[:200] + data[1000:], b"x" * tag]
    for data in cases:
        try:
            want = ref_native.verify_mpeg(data)
        except ValueError as err:
            with pytest.raises(ValueError) as got:
                _native.verify_mpeg(data)
            assert str(got.value) == str(err)
        else:
            assert _native.verify_mpeg(data) == want


def tags():
    """a MetaData of most fields and a PNG cover, in each package"""
    fields = dict(track_name="Sông", track_number=2, track_total=9,
                  album_name="Album", artist_name="Artist",
                  composer_name="Composer", year="2003", album_number=1,
                  album_total=2, comment="a comment", ISRC="USX000000001")
    port = audiofile.MetaData(**fields)
    ref = ref_audiofile.MetaData(**fields)
    port.add_image(audiofile.Image(png_bytes(5, 4), "image/png", 5, 4, 24,
                                   0, "", 0))
    ref.add_image(ref_audiofile.Image(png_bytes(5, 4), "image/png", 5, 4,
                                      24, 0, "", 0))
    return (port, ref)


@pytest.mark.parametrize("name", NAMES)
def test_metadata_round_trip_is_the_references(tmp_path, stereo, name):
    """set_metadata (MP3 and MP2: an ID3v2.3 and ID3v1 pair; Vorbis and
    Opus: comments keeping the encoder's vendor string), an edit
    through update_metadata, and delete_metadata: the reference's files
    and fields at each step; the audio is untouched"""
    (track, ref) = encode_both(tmp_path, name, stereo)
    before = drain(track.to_pcm())
    assert (track.get_metadata() is None) == (ref.get_metadata() is None)
    (port_md, ref_md) = tags()
    track.set_metadata(port_md)
    ref.set_metadata(ref_md)
    assert read(track.filename) == read(ref.filename)
    (got, want) = (track.get_metadata(), ref.get_metadata())
    for field in audiofile.MetaData.FIELDS:
        assert getattr(got, field) == getattr(want, field), field
    assert got.raw_info() == want.raw_info()
    assert str(got) == str(want)
    got.track_name = "Edited"
    want.track_name = "Edited"
    track.update_metadata(got)
    ref.update_metadata(want)
    assert read(track.filename) == read(ref.filename)
    assert track.get_metadata().track_name == "Edited"
    assert np.array_equal(drain(track.to_pcm()), before)
    track.delete_metadata()
    ref.delete_metadata()
    assert read(track.filename) == read(ref.filename)
    assert np.array_equal(drain(track.to_pcm()), before)
    assert track.verify() is True
    with pytest.raises(ValueError):
        track.update_metadata(audiofile.MetaData(track_name="x"))


@pytest.mark.parametrize("name", ["mp3", "mp2"])
def test_id3_only_tags_are_read_and_written_as_the_references(tmp_path,
                                                              stereo, name):
    """an ID3v1 tag alone, then an ID3v2.4 tag alone, through
    update_metadata"""
    (track, ref) = encode_both(tmp_path, name, stereo)
    from audiotools_tpu.meta import id3 as ref_id3
    from audiotools_tpu.meta import id3v1 as ref_id3v1
    from audiotools_tpu_torch.meta import id3v1
    (port_md, ref_md) = tags()
    for (cls, ref_cls) in ((id3v1.ID3v1Comment, ref_id3v1.ID3v1Comment),
                           (id3.ID3v24Comment, ref_id3.ID3v24Comment)):
        track.delete_metadata()
        ref.delete_metadata()
        track.update_metadata(cls.converted(port_md))
        ref.update_metadata(ref_cls.converted(ref_md))
        assert read(track.filename) == read(ref.filename)
        assert type(track.get_metadata()) is cls
        assert track.get_metadata().raw_info() == \
            ref.get_metadata().raw_info()


def test_vorbis_replay_gain_is_read_from_the_comments(tmp_path, stereo):
    (track, ref) = encode_both(tmp_path, "vorbis", stereo)
    assert track.replay_gain() is None and ref.replay_gain() is None
    for t in (track, ref):
        comment = t.get_metadata()
        comment["REPLAYGAIN_TRACK_GAIN"] = ["-3.21 dB"]
        comment["REPLAYGAIN_TRACK_PEAK"] = ["0.812345"]
        comment["REPLAYGAIN_ALBUM_GAIN"] = ["-2.50 dB"]
        comment["REPLAYGAIN_ALBUM_PEAK"] = ["0.9"]
        t.update_metadata(comment)
    assert read(track.filename) == read(ref.filename)
    (got, want) = (track.replay_gain(), ref.replay_gain())
    assert (got.track_gain, got.track_peak, got.album_gain,
            got.album_peak) == (want.track_gain, want.track_peak,
                                want.album_gain, want.album_peak)
    for (cls, ref_cls) in ((type(track), type(ref)),
                           (mp3.MP3Audio, ref_mp3.MP3Audio)):
        assert cls.supports_replay_gain() == ref_cls.supports_replay_gain()
        assert cls.lossless_replay_gain() == ref_cls.lossless_replay_gain()
    # no vorbisgain or mp3gain here, as for the reference
    assert track.can_add_replay_gain([track]) == \
        ref.can_add_replay_gain([ref])


@pytest.mark.parametrize("name", ["mp3", "vorbis", "opus"])
def test_mono_and_multichannel_sources_are_the_references(tmp_path, name,
                                                         monkeypatch):
    """a mono 16-bit source, and a 6-channel 24-bit 44.1 kHz source (MP3
    and Opus average it to one channel and dither it to 16 bits, Opus
    resamples it to 48 kHz on the CPU; Vorbis takes six 24-bit
    channels)"""
    monkeypatch.setattr(os, "urandom", urandom_stand_in)
    for (channels, bps) in ((1, 16), (6, 24)):
        arr = signal(channels + bps, SR // 2 + 77, channels, bps)
        (track, ref) = encode_both(tmp_path, name, arr, bps)
        assert read(track.filename) == read(ref.filename), (channels, bps)
        assert np.array_equal(drain(track.to_pcm()), drain(ref.to_pcm()))


def test_opus_resamples_through_opus_input(tmp_path, monkeypatch):
    """OpusAudio.from_pcm feeds the encoder what opus_input gives: the
    Averager, BPSConverter and Resampler chain, resampling on the
    device given; a 22,050 Hz source as the reference's bytes; a card
    asked for where there is none raises before a file is written"""
    classes("opus")
    monkeypatch.setattr(os, "urandom", urandom_stand_in)
    arr = signal(8, 22050 // 3, 6, 24)
    reader = opus.opus_input(pcm.reader_from_array(arr, 24, 22050), "cpu")
    assert type(reader).__name__ == "Resampler"
    assert (reader.device.type, reader.sample_rate, reader.channels,
            reader.bits_per_sample) == ("cpu", 48000, 1, 16)
    assert len(drain(reader)) == len(arr) * 48000 // 22050
    (track, ref) = encode_both(tmp_path, "opus", arr, 24, 22050)
    assert read(track.filename) == read(ref.filename)
    if not __import__("torch").cuda.is_available():
        path = str(tmp_path / "card.opus")
        with pytest.raises(RuntimeError):
            opus.OpusAudio.from_pcm(path, pcm.reader_from_array(arr, 24,
                                                                22050))
        assert not os.path.exists(path)


def id3_wrapped(path, data, frames=None):
    tag = id3.ID3v24Comment.converted(audiofile.MetaData(track_name="w"))
    from audiotools_tpu_torch.bitstream import BitstreamRecorder
    rec = BitstreamRecorder()
    tag.build(rec)
    with open(path, "wb") as f:
        f.write(rec.data() + data)
    return path


@pytest.mark.parametrize("name", NAMES)
def test_file_type_is_the_references(tmp_path, stereo, name):
    """each file, the same behind an ID3v2 tag (MP3 and MP2 open so;
    an Ogg stream so wrapped is unknown, as the reference's)"""
    (track, ref) = encode_both(tmp_path, name, stereo)
    wrapped = id3_wrapped(str(tmp_path / ("w." + track.SUFFIX)),
                          read(track.filename))
    for path in (track.filename, wrapped):
        with open(path, "rb") as f:
            got = dispatch.file_type(f)
            assert f.tell() == 0
            want = ref_dispatch.file_type(f)
        assert (got and got.NAME) == (want and want.NAME)
    if name in ("mp3", "mp2"):
        opened = dispatch.open(wrapped, device="cpu")
        assert type(opened) is type(track)
        assert opened.total_frames() == track.total_frames()
        assert opened.get_metadata().track_name == "w"
        assert np.array_equal(drain(opened.to_pcm()),
                              drain(track.to_pcm()))
    else:
        with pytest.raises(dispatch.UnknownAudioType):
            dispatch.open(wrapped, device="cpu")


def aac_m4a(tmp_path):
    """an ALAC file whose sample description is renamed mp4a"""
    from audiotools_tpu_torch.formats.m4a import write_m4a
    path = str(tmp_path / "alac.m4a")
    write_m4a(path, pcm.reader_from_array(signal(5, 5000), 16), device="cpu")
    data = read(path)
    pos = data.index(b"stsd")
    aac = str(tmp_path / "aac.m4a")
    with open(aac, "wb") as f:
        f.write(data[:pos + 16] + b"mp4a" + data[pos + 20:])
    return aac


def test_an_aac_m4a_is_detected_and_unavailable_as_the_references(
        tmp_path):
    """M4AAudio's stream fields are the reference's; without faac and
    faad it is unavailable on both sides, so open refuses it and
    open_files tells what it needs"""
    aac = aac_m4a(tmp_path)
    with open(aac, "rb") as f:
        assert dispatch.file_type(f) is m4a.M4AAudio
        assert ref_dispatch.file_type(f) is ref_m4a.M4AAudio
    (track, ref) = (m4a.M4AAudio(aac), ref_m4a.M4AAudio(aac))
    assert (track.channels(), track.bits_per_sample(), track.sample_rate(),
            track.total_frames(), track.lossless()) == (
                ref.channels(), ref.bits_per_sample(), ref.sample_rate(),
                ref.total_frames(), ref.lossless())
    assert m4a.M4AAudio.available() == ref_m4a.M4AAudio.available()
    if not ref_m4a.M4AAudio.available():
        assert "m4a" not in dispatch.TYPE_MAP
        with pytest.raises(audiofile.UnsupportedFile) as err:
            dispatch.open(aac, device="cpu")
        with pytest.raises(ref_root.UnsupportedFile) as ref_err:
            ref_dispatch.open(aac)
        assert str(err.value) == str(ref_err.value)

        class Lines:
            def __init__(self):
                self.lines = []

            def info(self, s):
                self.lines.append(s)

            warning = error = info
        (lines, ref_lines) = (Lines(), Lines())
        assert dispatch.open_files([aac, aac], messenger=lines,
                                   device="cpu") == []
        assert ref_dispatch.open_files([aac, aac], messenger=ref_lines) == []
        assert lines.lines == ref_lines.lines and lines.lines


@pytest.mark.parametrize("name", NAMES)
def test_an_unavailable_class_is_refused_as_the_references(
        tmp_path, stereo, name, monkeypatch):
    """where a class's library is not found, open raises
    UnsupportedFile and open_files skips the file, on both sides"""
    (track, ref) = encode_both(tmp_path, name, stereo)
    monkeypatch.setattr(type(track), "available",
                        classmethod(lambda cls, system_binaries=None: False))
    monkeypatch.setattr(type(ref), "available",
                        classmethod(lambda cls, system_binaries=None: False))
    with pytest.raises(audiofile.UnsupportedFile):
        dispatch.open(track.filename, device="cpu")
    with pytest.raises(ref_root.UnsupportedFile):
        ref_dispatch.open(ref.filename)
    assert dispatch.open_files([track.filename], device="cpu") == \
        ref_dispatch.open_files([ref.filename]) == []


def test_type_map_and_libraries_are_the_references():
    assert list(dispatch.TYPE_MAP) == list(ref_dispatch.TYPE_MAP)
    assert [cls.NAME for cls in dispatch.AVAILABLE_TYPES] == \
        [cls.NAME for cls in ref_dispatch.AVAILABLE_TYPES]
    for cls in dispatch.AVAILABLE_TYPES:
        ref_cls = [c for c in ref_dispatch.AVAILABLE_TYPES
                   if c.NAME == cls.NAME][0]
        assert cls.available() == ref_cls.available(), cls.NAME
        assert (cls.SUFFIX, cls.DESCRIPTION, cls.DEFAULT_COMPRESSION,
                tuple(cls.COMPRESSION_MODES), cls.COMPRESSION_DESCRIPTIONS,
                cls.BINARIES) == (
                    ref_cls.SUFFIX, ref_cls.DESCRIPTION,
                    ref_cls.DEFAULT_COMPRESSION,
                    tuple(ref_cls.COMPRESSION_MODES),
                    ref_cls.COMPRESSION_DESCRIPTIONS, ref_cls.BINARIES)


def test_decoders_of_a_damaged_file_report_as_the_references(tmp_path):
    """a file whose stream header is damaged after sniffing: to_pcm is
    a PCMReaderError whose reads raise the reference's message"""
    for name in NAMES:
        (cls, ref_cls) = classes(name)
        path = str(tmp_path / ("bad." + cls.SUFFIX))
        (track, _ref) = encode_both(tmp_path, name, signal(2, 3000))
        data = bytearray(read(track.filename))
        if name in ("mp3", "mp2"):
            continue        # libmpg123 resyncs past damage
        # Vorbis's version field, Opus's channel mapping family: bytes
        # the classes do not read, which their decoders refuse
        data[28 + (7 if name == "vorbis" else 18)] ^= 0x01
        # keep the page's CRC right so that only the codec objects
        page_len = 27 + data[26] + sum(data[27:27 + data[26]])
        data[22:26] = b"\x00" * 4
        crc = _native.ogg_crc(bytes(data[:page_len]))
        data[22:26] = struct.pack("<I", crc)
        with open(path, "wb") as f:
            f.write(bytes(data))
        outcome = []
        for c in (cls, ref_cls):
            try:
                reader = c(path).to_pcm()
                reader.read(100)
                outcome.append("read")
            except (ValueError, IOError) as err:
                outcome.append(str(err))
        assert outcome[0] == outcome[1], name
