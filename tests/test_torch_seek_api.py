"""The port's seek surface against the reference's, on the CPU:
``seekable()`` of every class, the seeks of each decoder that
``to_pcm()`` returns, and ``FlacAudio.seektable()``.

Following the reference's ``tests/test_seek.py`` and
``test_seek_more.py``: one 1.3 s signal at 8 kHz from a numpy seed is
written as FLAC, ALAC, Shorten and WAVE by the port's classes (on the
CPU, through its kernels' plain versions), as TTA by the reference's
host writer and as WavPack of 2048-frame blocks by the reference's host
encoder, which are quicker here than the port's plain loops.  Both
packages open each file and seek one decoder in turn to 4096, past the
end, to the middle, back to the start and to 5000 frames before the
end: each seek must return the reference's frame, and the
4096 frames read from there must be the reference's and those of the
signal at that frame.  A raw PCM stream
(``PCMReader``) seeks as the reference's.  ``seektable()`` of a FLAC
file, plain and behind an ID3v2 tag, must equal the reference's walk
and the SEEKTABLE the encoder wrote.
"""

import io
import os

import numpy as np
import pytest

from audiotools_tpu import dispatch as ref_dispatch
from audiotools_tpu import pcmstream as ref_stream
from audiotools_tpu.ref import wavpack as ref_wavpack_codec
from audiotools_tpu.formats import (aiff as ref_aiff, au as ref_au,
                                    flac as ref_flac, m4a as ref_m4a,
                                    mp3 as ref_mp3, opus as ref_opus,
                                    shn as ref_shn, tta as ref_tta,
                                    vorbis as ref_vorbis, wav as ref_wav,
                                    wavpack as ref_wavpack)
from audiotools_tpu_torch import dispatch, pcm
from audiotools_tpu_torch.formats import (aiff, au, flac, m4a, mp3, opus,
                                          shn, tta, vorbis, wav, wavpack)

RATE = 8000
FRAMES = 10333
WINDOW = 4096
POSITIONS = (4096, FRAMES + 10, FRAMES // 2, 0, FRAMES - 5000)

CLASSES = [(ref_flac.FlacAudio, flac.FlacAudio),
           (ref_flac.OggFlacAudio, flac.OggFlacAudio),
           (ref_m4a.ALACAudio, m4a.ALACAudio),
           (ref_m4a.M4AAudio, m4a.M4AAudio),
           (ref_tta.TrueAudio, tta.TrueAudio),
           (ref_wavpack.WavPackAudio, wavpack.WavPackAudio),
           (ref_shn.ShortenAudio, shn.ShortenAudio),
           (ref_wav.WaveAudio, wav.WaveAudio),
           (ref_aiff.AiffAudio, aiff.AiffAudio),
           (ref_au.AuAudio, au.AuAudio),
           (ref_mp3.MP3Audio, mp3.MP3Audio),
           (ref_mp3.MP2Audio, mp3.MP2Audio),
           (ref_vorbis.VorbisAudio, vorbis.VorbisAudio),
           (ref_opus.OpusAudio, opus.OpusAudio)]


@pytest.mark.parametrize("ref_cls,cls", CLASSES,
                         ids=[c[1].__name__ for c in CLASSES])
def test_seekable_is_the_references(ref_cls, cls):
    # each class's answer is a constant of the class
    assert cls.seekable(None) is ref_cls.seekable(None)


def signal(channels, bps, seed=3):
    rng = np.random.default_rng(seed + channels + bps)
    walk = np.cumsum(rng.integers(-300, 300, (FRAMES, channels)), axis=0)
    span = 1 << (bps - 2)
    return (walk % (2 * span) - span).astype(np.int32)


def write(directory, name, arr, bps):
    suffix = {"alac": "m4a", "wavpack": "wv"}.get(name, name)
    path = os.path.join(directory, "%s_%d_%d.%s" % (name, arr.shape[1], bps,
                                                    suffix))
    reader = pcm.reader_from_array(arr, bps, RATE)
    if name in ("tta", "wavpack"):
        raw = pcm.FrameList._wrap(arr, bps).to_bytes(False, True)
        source = ref_stream.PCMReader(io.BytesIO(raw), RATE, arr.shape[1],
                                      reader.channel_mask, bps)
        if name == "tta":
            ref_tta.TrueAudio.from_pcm(path, source)
        else:
            ref_wavpack_codec.encode_wavpack(
                path, source, block_size=2048, total_pcm_frames=FRAMES,
                correlation_passes=2, joint_stereo=True)
    elif name == "wav":
        wav.WaveAudio.from_pcm(path, reader)
    else:
        {"flac": flac.FlacAudio, "alac": m4a.ALACAudio,
         "shn": shn.ShortenAudio}[name].from_pcm(path, reader,
                                                 device="cpu")
    return path


def read_window(reader, frames):
    pieces = []
    have = 0
    while have < frames:
        framelist = reader.read(frames - have)
        if framelist.frames == 0:
            break
        pieces.append(np.asarray(framelist.samples))
        have += framelist.frames
    return (np.concatenate(pieces)[:frames] if pieces
            else np.zeros((0, reader.channels), dtype=np.int32))


CASES = [("flac", 2, 16), ("flac", 1, 24), ("alac", 2, 16),
         ("tta", 2, 16), ("wavpack", 2, 16),
         ("wavpack", 1, 24), ("shn", 2, 16), ("wav", 2, 16), ("wav", 1, 8)]


@pytest.mark.parametrize("name,channels,bps", CASES)
def test_seek_windows_are_the_references(tmp_path, name, channels, bps):
    arr = signal(channels, bps)
    path = write(str(tmp_path), name, arr, bps)
    (theirs, ours) = (ref_dispatch.open(path),
                      dispatch.open(path, device="cpu"))
    assert ours.seekable() == theirs.seekable()
    (a, b) = (theirs.to_pcm(), ours.to_pcm())
    try:
        for position in POSITIONS:
            (ra, rb) = (a.seek(position), b.seek(position))
            assert ra == rb
            (wa, wb) = (read_window(a, WINDOW), read_window(b, WINDOW))
            assert np.array_equal(wa, wb)
            assert np.array_equal(wb, arr[rb:rb + WINDOW])
    finally:
        a.close()
        b.close()


@pytest.mark.parametrize("positions", [[0], [100, 7], [-3, 50], [10 ** 6],
                                       [FRAMES - 1, 0]])
def test_raw_pcm_seeks_are_the_references(positions):
    arr = signal(2, 16)
    data = pcm.FrameList._wrap(arr, 16).to_bytes(False, True)
    results = []
    for module in (ref_stream, pcm):
        reader = module.PCMReader(io.BytesIO(data), RATE, 2, 0x3, 16)
        out = []
        for position in positions:
            out.append(reader.seek(position))
            out.append(np.asarray(reader.read(300).samples).tolist())
        results.append(out)
    assert results[0] == results[1]


def id3v2_wrapped(path):
    """the FLAC file behind a 10-byte ID3v2.4 tag of 20 bytes of padding"""
    with open(path, "rb") as f:
        data = f.read()
    wrapped = path + ".id3.flac"
    with open(wrapped, "wb") as f:
        f.write(b"ID3\x04\x00\x00\x00\x00\x00\x14" + b"\x00" * 20 + data)
    return wrapped


@pytest.mark.parametrize("wrapped", [False, True])
@pytest.mark.parametrize("interval", [None, 4096, 1])
def test_seektables_are_the_references(tmp_path, wrapped, interval):
    arr = signal(2, 16)
    path = write(str(tmp_path), "flac", arr, 16)
    if wrapped:
        path = id3v2_wrapped(path)
    (theirs, ours) = (ref_flac.FlacAudio(path),
                      flac.FlacAudio(path, device="cpu"))
    table = ours.seektable(seekpoint_interval=interval)
    assert table.seekpoints == theirs.seektable(
        seekpoint_interval=interval).seekpoints
    assert ours.metadata_length() == theirs.metadata_length()
    offsets = ours.__walk_frame_offsets__()
    assert offsets == theirs.__walk_frame_offsets__()
    assert ours.seektable(offsets, interval).seekpoints == table.seekpoints
    if interval is None:
        # the table from_pcm wrote: a seekpoint every 10 s
        written = ours.get_metadata().get_block(
            flac.Flac_SEEKTABLE.BLOCK_ID)
        assert written.seekpoints == table.seekpoints
