"""The port's PCM helpers: ``reader_from_array`` feeds the encoder the
same samples as the reference's reader, ``BufferedPCMReader`` and
``FrameList.to_bytes`` behave as the reference's, and ``decode_flac``
returns the samples of a FLAC stream after checking its STREAMINFO and
MD5."""

import io

import numpy as np
import pytest
import torch

from audiotools_tpu import pcm as ref_pcm
from audiotools_tpu.pcmstream import BufferedPCMReader, PCMReader
from audiotools_tpu_torch import pcm
from audiotools_tpu_torch.codecs import flac_enc_fast as port

torch.set_num_threads(1)

OPTS = dict(block_size=1024, max_lpc_order=8, batch_frames=4)


def signal(bps, ch, n):
    rng = np.random.default_rng(bps * 10 + ch)
    t = np.arange(n)
    amp = 1 << (bps - 3)
    return np.stack([(amp * np.sin(2 * np.pi * (440 + 300 * c) * t
                                   / 44100)).astype(np.int64)
                     + rng.integers(-amp // 32, amp // 32, n)
                     for c in range(ch)], axis=1).astype(np.int32)


def encode(arr, bps):
    out = io.BytesIO()
    port.encode_flac_fast(out, pcm.reader_from_array(arr, bps),
                          device="cpu", mid_side=arr.shape[1] == 2, **OPTS)
    return out.getvalue()


@pytest.mark.parametrize("bps,ch", [(16, 2), (16, 1), (24, 2)])
def test_reader_matches_reference_reader(bps, ch):
    arr = signal(bps, ch, 3000)
    data = ref_pcm.FrameList._wrap(arr, bps).to_bytes(False, True)
    want = PCMReader(io.BytesIO(data), 44100, ch, {1: 4, 2: 3}[ch], bps)
    got = pcm.reader_from_array(arr, bps)
    assert (got.sample_rate, got.channels, got.channel_mask,
            got.bits_per_sample) == (want.sample_rate, want.channels,
                                     want.channel_mask,
                                     want.bits_per_sample)
    assert np.array_equal(got.read(4096).samples, want.read(4096).samples)


@pytest.mark.parametrize("bps,ch", [(16, 2), (16, 1), (24, 2)])
def test_decode_round_trip(bps, ch):
    arr = signal(bps, ch, 1024 * 5 + 77)
    data = encode(arr, bps)
    assert pcm.streaminfo(data)[:4] == (44100, ch, bps, len(arr))
    assert np.array_equal(pcm.decode_flac(data), arr)


def test_decode_checks_md5():
    data = bytearray(encode(signal(16, 2, 3000), 16))
    data[30] ^= 0x01                   # a bit of STREAMINFO's MD5
    with pytest.raises(ValueError, match="MD5"):
        pcm.decode_flac(bytes(data))


def test_decode_refuses_other_streams():
    with pytest.raises(ValueError, match="FLAC"):
        pcm.decode_flac(b"RIFF" + bytes(60))


class _Ragged:
    """a PCMReader that returns fewer frames than asked, in a fixed
    cycle of sizes"""

    def __init__(self, arr, bps, framelist):
        self.arr = arr
        self.pos = 0
        self.sizes = [1, 700, 3, 5000, 64]
        self.calls = 0
        self.framelist = framelist
        (self.sample_rate, self.channels, self.channel_mask,
         self.bits_per_sample) = (44100, arr.shape[1], 3, bps)

    def read(self, pcm_frames):
        take = min(pcm_frames, self.sizes[self.calls % len(self.sizes)])
        self.calls += 1
        chunk = self.arr[self.pos:self.pos + take]
        self.pos += chunk.shape[0]
        return self.framelist(chunk)

    def close(self):
        pass


def test_buffered_reader_matches_reference():
    """exact counts (fewer only at the end) over a reader that returns
    ragged chunks, of the port's or the reference's frame lists"""
    arr = signal(16, 2, 20000)
    sizes = [0, 1, 4096, 3, 9000, 6000, 4096, 4096]
    for framelist in (lambda a: ref_pcm.FrameList._wrap(a, 16),
                      lambda a: pcm.FrameList(a, 16)):
        got = pcm.BufferedPCMReader(_Ragged(arr, 16, framelist))
        want = BufferedPCMReader(_Ragged(
            arr, 16, lambda a: ref_pcm.FrameList._wrap(a, 16)))
        for size in sizes:
            (a, b) = (got.read(size), want.read(size))
            assert a.frames == b.frames
            assert np.array_equal(a.samples, b.samples)
        got.close()
        with pytest.raises(ValueError):
            got.read(1)


@pytest.mark.parametrize("bps", [8, 16, 24])
def test_to_bytes_matches_reference(bps):
    arr = signal(bps, 2, 100)
    fl = pcm.FrameList(arr, bps)
    ref = ref_pcm.FrameList._wrap(arr, bps)
    for big_endian in (False, True):
        for signed in (False, True):
            assert (fl.to_bytes(big_endian, signed) ==
                    ref.to_bytes(big_endian, signed))
