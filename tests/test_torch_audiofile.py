"""The port's AudioFile layer against the reference's: ``dispatch``'s
content sniffing and ``open``, each class's header fields, ``verify``
and ``verify_track``, ``track_name``, ``pcm.pcm_frame_cmp`` and the
farm writing each of the five device classes.  Short 8 kHz signals
keep the plain TTA, ALAC and WavPack loops quick on the CPU.
"""

import io
import os
import time

import numpy as np
import pytest
import torch

from audiotools_tpu import dispatch as ref_dispatch
from audiotools_tpu import pcm as ref_pcm
from audiotools_tpu.audiofile import AudioFile as RefAudioFile
from audiotools_tpu.parallel import farm as ref_farm
from audiotools_tpu.pcmstream import PCMReader as RefPCMReader
from audiotools_tpu.pcmstream import pcm_frame_cmp as ref_pcm_frame_cmp
from audiotools_tpu_torch import dispatch, pcm
from audiotools_tpu_torch.accuraterip_checksum import accuraterip_checksums
from audiotools_tpu_torch.audiofile import (AudioFile, EncodingError,
                                            InvalidFile, InvalidFilenameFormat,
                                            UnsupportedFile,
                                            UnsupportedTracknameField)
from audiotools_tpu_torch.parallel import farm

torch.set_num_threads(1)

SR = 8000
FRAMES = 2000
CLOCK = 1.7e9
NAMES = ["wav", "flac", "alac", "tta", "shn", "wavpack"]
DEVICE_NAMES = NAMES[1:]


def signal(seed=0, frames=FRAMES):
    rng = np.random.default_rng(seed)
    t = np.arange(frames)
    base = 6000 * np.sin(2 * np.pi * 300 * t / SR)
    arr = np.stack([base + rng.integers(-400, 400, frames), 0.5 * base],
                   axis=1)
    return np.clip(arr, -32768, 32767).astype(np.int32)


def ref_reader(arr, rate=SR):
    fl = ref_pcm.FrameList._wrap(arr, 16)
    return RefPCMReader(io.BytesIO(fl.to_bytes(False, True)), rate, 2, 3, 16)


def read(path):
    with open(path, "rb") as f:
        return f.read()


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """a file of each of the six classes from one signal, written by the
    port on the CPU (name -> path), and the signal"""
    base = tmp_path_factory.mktemp("files")
    arr = signal()
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(time, "time", lambda: CLOCK)
        for name in NAMES:
            cls = dispatch.TYPE_MAP[name]
            path = str(base / ("a." + cls.SUFFIX))
            cls.from_pcm(path, pcm.reader_from_array(arr, 16, SR),
                         total_pcm_frames=FRAMES, device="cpu")
            out[name] = path
    return (out, arr)


def test_type_map_names_the_references_classes():
    """the available classes: the reference's names in its order (the
    lossy ones where their libraries are found, AAC only with faac and
    faad, as the reference's)"""
    assert list(dispatch.TYPE_MAP) == list(ref_dispatch.TYPE_MAP)
    assert set(NAMES + ["aiff", "au", "oggflac"]) <= set(dispatch.TYPE_MAP)
    for (name, cls) in dispatch.TYPE_MAP.items():
        ref = ref_dispatch.TYPE_MAP[name]
        assert (cls.NAME, cls.SUFFIX, cls.DEFAULT_COMPRESSION,
                tuple(cls.COMPRESSION_MODES)) == (
            ref.NAME, ref.SUFFIX, ref.DEFAULT_COMPRESSION,
            tuple(ref.COMPRESSION_MODES)), name


@pytest.mark.parametrize("name", NAMES)
def test_file_type_and_header_fields_are_the_references(files, name):
    (paths, _arr) = files
    path = paths[name]
    with open(path, "rb") as f:
        cls = dispatch.file_type(f)
        assert f.tell() == 0
        assert cls.NAME == ref_dispatch.file_type(f).NAME == name
    track = dispatch.open(path, device="cpu")
    ref = ref_dispatch.open(path)
    assert type(track) is cls
    assert track.device == (None if name == "wav" else torch.device("cpu"))
    for field in ("bits_per_sample", "channels", "sample_rate",
                  "total_frames", "seconds_length", "lossless"):
        assert getattr(track, field)() == getattr(ref, field)(), field
    assert track.channel_mask() == int(ref.channel_mask())


@pytest.mark.parametrize("name", ["tta", "flac"])
def test_id3_wrapped_files_are_sniffed_through(files, tmp_path, name):
    (paths, _arr) = files
    tag = b"ID3\x03\x00\x00" + bytes([0, 0, 0, 20]) + b"\x00" * 20
    path = str(tmp_path / ("id3." + dispatch.TYPE_MAP[name].SUFFIX))
    with open(path, "wb") as f:
        f.write(tag + read(paths[name]))
    with open(path, "rb") as f:
        assert dispatch.file_type(f).NAME == ref_dispatch.file_type(f).NAME
    if name == "tta":
        track = dispatch.open(path, device="cpu")
        assert track.get_metadata() is None
        assert ref_dispatch.open(path).get_metadata() is None
        assert np.array_equal(farm.verify_track(track), files[1])


def test_other_types_are_unknown(files, tmp_path):
    """named for what it once checked, that the port opened no AAC M4A
    and no Ogg Vorbis stream: both are now the reference's classes, and
    content that neither package knows (an Ogg Speex stream, an MPEG-2
    layer III frame) is unknown to both.  An AAC M4A is refused by open
    where faac and faad are absent, as the reference's is"""
    from audiotools_tpu import UnsupportedFile as RefUnsupportedFile
    from audiotools_tpu import ogg as ref_ogg
    (paths, _arr) = files
    aac = str(tmp_path / "aac.m4a")
    data = read(paths["alac"])
    pos = data.index(b"stsd")
    with open(aac, "wb") as f:
        f.write(data[:pos + 16] + b"mp4a" + data[pos + 20:])
    vorbis = str(tmp_path / "a.ogg")
    with open(vorbis, "wb") as f:
        f.write(ref_ogg.Page(False, True, False, 0, 1, 0, [
            b"\x01vorbis" + b"\x00" * 23]).build())
    for (path, name) in ((aac, "m4a"), (vorbis, "vorbis")):
        with open(path, "rb") as f:
            assert ref_dispatch.file_type(f).NAME == name
            assert dispatch.file_type(f).NAME == name
    if "m4a" not in ref_dispatch.TYPE_MAP:
        with pytest.raises(UnsupportedFile):
            dispatch.open(aac, device="cpu")
        with pytest.raises(RefUnsupportedFile):
            ref_dispatch.open(aac)
    speex = str(tmp_path / "s.spx")
    with open(speex, "wb") as f:
        f.write(ref_ogg.Page(False, True, False, 0, 1, 0, [
            b"Speex   " + b"\x00" * 72]).build())
    mpeg2 = str(tmp_path / "a.mp3")
    with open(mpeg2, "wb") as f:
        f.write(b"\xff\xf3\x90\xc4" + b"\x00" * 200)
    for path in (speex, mpeg2):
        with open(path, "rb") as f:
            assert ref_dispatch.file_type(f) is None
            assert dispatch.file_type(f) is None
        with pytest.raises(dispatch.UnknownAudioType):
            dispatch.open(path, device="cpu")


@pytest.mark.parametrize("name", DEVICE_NAMES)
def test_verify_track_decodes_each_class(files, name):
    (paths, arr) = files
    track = dispatch.open(paths[name], device="cpu")
    (samples, sums) = farm.verify_track(track, chunk=700,
                                        accuraterip=(True, False))
    assert np.array_equal(samples, arr)
    assert sums == accuraterip_checksums(
        pcm.reader_from_array(arr, 16, SR), FRAMES, True, False, SR,
        device="cpu")
    assert track.verify() is True


@pytest.mark.parametrize("name", NAMES)
def test_verify_raises_on_a_truncated_file(files, tmp_path, name):
    (paths, _arr) = files
    data = read(paths[name])
    path = str(tmp_path / os.path.basename(paths[name]))
    with open(path, "wb") as f:
        f.write(data[:len(data) * 2 // 3])
    with pytest.raises(InvalidFile):
        dispatch.open(path, device="cpu").verify()


@pytest.mark.parametrize("name", DEVICE_NAMES[1:])
def test_a_frame_count_mismatch_raises_and_leaves_no_file(tmp_path, name):
    cls = dispatch.TYPE_MAP[name]
    path = str(tmp_path / ("a." + cls.SUFFIX))
    with pytest.raises(EncodingError, match="mismatch"):
        cls.from_pcm(path, pcm.reader_from_array(signal(), 16, SR),
                     total_pcm_frames=FRAMES + 1, device="cpu")
    assert not os.path.exists(path)


@pytest.mark.parametrize("name", DEVICE_NAMES[1:])
def test_the_farm_writes_the_reference_farms_files(tmp_path, monkeypatch,
                                                   name):
    monkeypatch.setattr(time, "time", lambda: CLOCK)
    monkeypatch.setenv("ATPU_ALAC_BACKEND", "numpy")
    monkeypatch.setenv("ATPU_ALAC_QPACK", "0")
    source = str(tmp_path / "src.wav")
    dispatch.TYPE_MAP["wav"].from_pcm(source, pcm.reader_from_array(
        signal(1), 16, SR))
    cls = dispatch.TYPE_MAP[name]
    port_path = str(tmp_path / ("port." + cls.SUFFIX))
    ref_path = str(tmp_path / ("ref." + cls.SUFFIX))
    [result] = farm.transcode([farm.FarmJob(source, port_path, cls)],
                              devices=["cpu"])
    assert result.ok, result.error
    assert isinstance(result.dest, cls)
    [ref] = ref_farm.transcode([ref_farm.FarmJob(
        source, ref_path, ref_dispatch.TYPE_MAP[name])], workers=1)
    assert ref.ok
    assert read(port_path) == read(ref_path)


@pytest.mark.parametrize("template", [
    "%(track_number)2.2d - %(track_name)s.%(suffix)s",
    "%(basename)s.%(suffix)s",
    "%(album_track_number)s %(artist_name)s-%(album_name)s.%(suffix)s",
    "%(album_number)d/%(track_total)d %(comment)s%(ISRC)s.%(suffix)s"])
def test_track_name_is_the_references_for_a_file_without_metadata(template):
    for path in ("a.wav", "dir/b.c.flac"):
        assert (AudioFile.track_name(path, None, template, suffix="m4a") ==
                RefAudioFile.track_name(path, None, template, suffix="m4a"))


def test_track_name_errors():
    with pytest.raises(UnsupportedTracknameField, match="nosuch"):
        AudioFile.track_name("a.wav", None, "%(nosuch)s")
    with pytest.raises(InvalidFilenameFormat):
        AudioFile.track_name("a.wav", None, "%(track_number)s %d")


def frame_cmp_cases():
    arr = signal(2, 5000)
    off = arr.copy()
    off[3210, 0] += 1
    return {"equal": (arr, SR, arr, SR), "one off": (arr, SR, off, SR),
            "shorter": (arr, SR, arr[:4000], SR),
            "longer": (arr[:300000], SR, arr, SR),
            "other rate": (arr, SR, arr, 44100)}


@pytest.mark.parametrize("case", sorted(frame_cmp_cases()))
def test_pcm_frame_cmp_is_the_references(case):
    (a, rate_a, b, rate_b) = frame_cmp_cases()[case]
    got = pcm.pcm_frame_cmp(pcm.reader_from_array(a, 16, rate_a),
                            pcm.reader_from_array(b, 16, rate_b))
    assert got == ref_pcm_frame_cmp(ref_reader(a, rate_a),
                                    ref_reader(b, rate_b))
