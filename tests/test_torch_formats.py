"""The port's file formats on the CPU against the reference's:
``formats.wav.WaveAudio`` writes and reads the reference's bytes and
samples, and ``formats.flac.FlacAudio.from_pcm(..., device="cpu")``
writes the reference ``FlacAudio.from_pcm``'s bytes at every level.

The reference runs its numpy backend with exact uploads and without
the emit-stage Rice re-search (ATPU_FLAC_QPACK=0, ATPU_EMIT_EXACT_RICE=0),
the configuration its own suites hold equal to its ATPU_PALLAS=1 JAX
path and that the port's encoder follows.
"""

import io
import os

import numpy as np
import pytest
import torch

from audiotools_tpu import pcm as ref_pcm
from audiotools_tpu.formats import flac as ref_flac
from audiotools_tpu.formats.wav import WaveAudio as RefWaveAudio
from audiotools_tpu.pcmstream import PCMReader
from audiotools_tpu_torch import dispatch, pcm
from audiotools_tpu_torch.formats import flac
from audiotools_tpu_torch.formats.wav import WaveAudio

torch.set_num_threads(1)

MASKS = {1: 0x4, 2: 0x3, 6: 0x3F}


def signal(bps, ch, n=44100 + 777, seed=9):
    """tones + noise, a constant first stretch, a short last block"""
    rng = np.random.default_rng(seed)
    t = np.arange(n)
    amp = 1 << (bps - 3)
    arr = np.stack([(amp * np.sin(2 * np.pi * (300 + 170 * c) * t
                                  / 44100)).astype(np.int64)
                    + rng.integers(-amp // 64, amp // 64, n)
                    for c in range(ch)], axis=1).astype(np.int32)
    arr[:3000] = 1234 if bps > 8 else 12
    return arr


def ref_reader(arr, bps, rate=44100):
    fl = ref_pcm.FrameList._wrap(arr, bps)
    return PCMReader(io.BytesIO(fl.to_bytes(False, bps != 8)), rate,
                     arr.shape[1], MASKS[arr.shape[1]], bps,
                     signed=bps != 8)


def port_reader(arr, bps, rate=44100):
    reader = pcm.reader_from_array(arr, bps, rate)
    reader.channel_mask = MASKS[arr.shape[1]]
    return reader


def ref_read_all(reader):
    """every frame of a reference PCMReader, int32 [frames, channels]"""
    pieces = []
    while True:
        framelist = reader.read(4096)
        if framelist.frames == 0:
            break
        pieces.append(np.asarray(framelist.samples, dtype=np.int32))
    reader.close()
    return np.concatenate(pieces)


def read_bytes(path):
    with open(path, "rb") as f:
        return f.read()


@pytest.fixture
def exact_reference(monkeypatch):
    monkeypatch.setenv("ATPU_FLAC_BACKEND", "numpy")
    monkeypatch.setenv("ATPU_FLAC_QPACK", "0")
    monkeypatch.setenv("ATPU_EMIT_EXACT_RICE", "0")


@pytest.mark.parametrize("bps,ch", [(8, 1), (16, 2), (24, 2), (16, 6)])
def test_wave_matches_the_reference(tmp_path, bps, ch):
    arr = signal(bps, ch, n=5001)
    (ref_path, path) = (str(tmp_path / "r.wav"), str(tmp_path / "p.wav"))
    RefWaveAudio.from_pcm(ref_path, ref_reader(arr, bps))
    wav = WaveAudio.from_pcm(path, port_reader(arr, bps),
                             total_pcm_frames=len(arr))
    assert read_bytes(path) == read_bytes(ref_path)
    ref = RefWaveAudio(ref_path)
    assert (wav.channels(), wav.bits_per_sample(), wav.sample_rate(),
            wav.total_frames(), wav.channel_mask()) == (
        ref.channels(), ref.bits_per_sample(), ref.sample_rate(),
        ref.total_frames(), int(ref.channel_mask()))
    got = pcm.read_all(WaveAudio(ref_path).to_pcm())
    assert np.array_equal(got, arr)
    assert np.array_equal(got, ref_read_all(ref.to_pcm()))


def test_wave_frame_count_mismatch_leaves_no_file(tmp_path):
    path = str(tmp_path / "p.wav")
    with pytest.raises(ValueError, match="mismatch"):
        WaveAudio.from_pcm(path, port_reader(signal(16, 2, n=100), 16),
                           total_pcm_frames=99)
    assert not os.path.exists(path)


def _flac_pair(tmp_path, arr, bps, level, total):
    (ref_path, path) = (str(tmp_path / "r.flac"), str(tmp_path / "p.flac"))
    ref_flac.FlacAudio.from_pcm(ref_path, ref_reader(arr, bps),
                                compression=level, total_pcm_frames=total)
    audio = flac.FlacAudio.from_pcm(path, port_reader(arr, bps),
                                    compression=level,
                                    total_pcm_frames=total, device="cpu")
    return (audio, read_bytes(ref_path), read_bytes(path))


@pytest.mark.parametrize("with_total", [False, True])
@pytest.mark.parametrize("level", list("012345678"))
def test_flac_levels_match_the_reference(tmp_path, exact_reference, level,
                                         with_total):
    arr = signal(16, 2)
    (audio, want, got) = _flac_pair(tmp_path, arr, 16, level,
                                    len(arr) if with_total else None)
    assert got == want
    assert (audio.channels(), audio.bits_per_sample(),
            audio.total_frames(), audio.channel_mask()) == (2, 16, len(arr),
                                                            0x3)


@pytest.mark.parametrize("with_total", [False, True])
@pytest.mark.parametrize("level", ["0", "8"])
@pytest.mark.parametrize("bps,ch", [(16, 1), (24, 2), (16, 6)])
def test_flac_layouts_match_the_reference(tmp_path, exact_reference, bps,
                                          ch, level, with_total):
    """mono, 24-bit stereo, and 6 channels with mask 0x3F (which take
    the WAVEFORMATEXTENSIBLE_CHANNEL_MASK comment when over 2 channels
    or 16 bits)"""
    arr = signal(bps, ch)
    (audio, want, got) = _flac_pair(tmp_path, arr, bps, level,
                                    len(arr) if with_total else None)
    assert got == want
    assert audio.channel_mask() == MASKS[ch]
    metadata = audio.get_metadata()
    assert metadata.has_block(flac.Flac_VORBISCOMMENT.BLOCK_ID) == (
        ch > 2 or bps > 16)
    samples = pcm.read_all(audio.to_pcm())
    assert np.array_equal(samples, arr)


def test_to_pcm_decodes_and_checks_md5(tmp_path):
    arr = signal(16, 2)
    path = str(tmp_path / "p.flac")
    audio = flac.FlacAudio.from_pcm(path, port_reader(arr, 16),
                                    device="cpu")
    assert np.array_equal(pcm.read_all(audio.to_pcm()), arr)
    # a wrong STREAMINFO MD5 (bytes 26-41 of the file) fails the decode
    data = bytearray(read_bytes(path))
    data[30] ^= 0xFF
    with open(path, "wb") as f:
        f.write(data)
    with pytest.raises(ValueError, match="MD5"):
        pcm.read_all(flac.FlacAudio(path, device="cpu").to_pcm())


def test_seektable_points_match_the_reference(tmp_path, exact_reference):
    """at 2 kHz, 65 s of stereo: seekpoints at 0, 10, ... 60 s"""
    rate = 2000
    arr = signal(16, 2, n=rate * 65 + 321)
    (ref_path, path) = (str(tmp_path / "r.flac"), str(tmp_path / "p.flac"))
    ref_flac.FlacAudio.from_pcm(ref_path, ref_reader(arr, 16, rate),
                                compression="5")
    audio = flac.FlacAudio.from_pcm(path, port_reader(arr, 16, rate),
                                    compression="5", device="cpu")
    assert read_bytes(path) == read_bytes(ref_path)
    want = ref_flac.FlacAudio(ref_path).get_metadata().get_block(
        ref_flac.Flac_SEEKTABLE.BLOCK_ID).seekpoints
    got = audio.get_metadata().get_block(
        flac.Flac_SEEKTABLE.BLOCK_ID).seekpoints
    assert got == [tuple(p) for p in want]
    assert [p[0] for p in got] == [i * 10 * rate // 4096 * 4096 +
                                   (4096 if i * 10 * rate % 4096 else 0)
                                   for i in range(7)]


@pytest.mark.parametrize("change", ["grow_padding", "shrink_padding",
                                    "rewrite"])
def test_update_metadata_matches_the_reference(tmp_path, exact_reference,
                                               change):
    """the in-place branches (padding grown or shrunk to fill the old
    room) and the full rewrite through a temporary file"""
    arr = signal(16, 2, n=20000)
    (audio, want, got) = _flac_pair(tmp_path, arr, 16, "8", None)
    assert got == want
    ref = ref_flac.FlacAudio(str(tmp_path / "r.flac"))
    (ref_meta, meta) = (ref.get_metadata(), audio.get_metadata())
    if change == "grow_padding":
        ref_meta.replace_blocks(ref_flac.Flac_SEEKTABLE.BLOCK_ID, [])
        meta.replace_blocks(flac.Flac_SEEKTABLE.BLOCK_ID, [])
    else:
        comment = ["TITLE=" + "x" * (100 if change == "shrink_padding"
                                     else 9000)]
        ref_meta.add_block(ref_flac.Flac_VORBISCOMMENT(comment, "v"))
        meta.add_block(flac.Flac_VORBISCOMMENT(comment, "v"))
    ref.update_metadata(ref_meta)
    audio.update_metadata(meta)
    data = read_bytes(audio.filename)
    assert data == read_bytes(ref.filename)
    assert (len(data) == len(got)) == (change != "rewrite")
    assert np.array_equal(pcm.read_all(audio.to_pcm()), arr)


def test_blocks_round_trip(tmp_path):
    """each block's build parses back to an equal block, and the
    reference parses the port's metadata to the same values"""
    blocks = [
        flac.Flac_STREAMINFO(4096, 4096, 14, 9000, 44100, 6, 24,
                             (1 << 36) - 5, bytes(range(16))),
        flac.Flac_SEEKTABLE([(0, 0, 4096), (441000, 123456, 4096)]),
        flac.Flac_VORBISCOMMENT(["A=1", "b=é"], "vendor é"),
        flac.Flac_PADDING(10)]
    metadata = flac.FlacMetaData(blocks)
    data = metadata.build()
    assert len(data) == metadata.size()
    again = flac.FlacMetaData.parse(io.BytesIO(data))
    assert again.block_list == blocks
    from audiotools_tpu.bitstream import BitstreamReader
    ref = ref_flac.FlacMetaData.parse(BitstreamReader(io.BytesIO(data),
                                                      False))
    info = ref.get_block(0)
    assert (info.channels, info.bits_per_sample, info.total_samples,
            info.md5sum) == (6, 24, (1 << 36) - 5, bytes(range(16)))
    assert ref.get_block(3).seekpoints == blocks[1].seekpoints
    assert ref.get_block(4).comment_strings == ["A=1", "b=é"]
    vorbis = again.get_block(4)
    vorbis["a"] = ["2", "3"]
    assert vorbis.comment_strings == ["A=2", "b=é", "A=3"]
    assert vorbis["A"] == ["2", "3"] and "B" in vorbis


def test_dispatch_opens_by_content(tmp_path):
    arr = signal(16, 2, n=3000)
    wav = str(tmp_path / "a.bin")
    WaveAudio.from_pcm(wav, port_reader(arr, 16))
    fl = str(tmp_path / "b.bin")
    flac.FlacAudio.from_pcm(fl, port_reader(arr, 16), device="cpu")
    other = str(tmp_path / "c.wav")
    with open(other, "wb") as f:
        f.write(b"OggS" + bytes(40))
    assert isinstance(dispatch.open(wav, device="cpu"), WaveAudio)
    opened = dispatch.open(fl, device="cpu")
    assert isinstance(opened, flac.FlacAudio)
    assert opened.device == torch.device("cpu")
    with open(fl, "rb") as f:
        assert dispatch.file_type(f) is flac.FlacAudio
        assert f.tell() == 0
    with pytest.raises(dispatch.UnknownAudioType):
        dispatch.open(other, device="cpu")


def test_cuda_requests_raise_without_a_card(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    arr = signal(16, 2, n=3000)
    path = str(tmp_path / "p.flac")
    with pytest.raises(RuntimeError, match="cuda"):
        flac.FlacAudio.from_pcm(path, port_reader(arr, 16))
    assert not os.path.exists(path)
    flac.FlacAudio.from_pcm(path, port_reader(arr, 16), device="cpu")
    with pytest.raises(RuntimeError, match="cuda"):
        flac.FlacAudio(path)
    with pytest.raises(RuntimeError, match="cuda"):
        dispatch.open(path)
