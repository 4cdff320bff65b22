"""The port's PCM helpers: ``reader_from_array`` feeds the encoder the
same bytes as the reference's reader, and ``decode_flac`` returns the
samples of a FLAC stream after checking its STREAMINFO and MD5."""

import io

import numpy as np
import pytest
import torch

from audiotools_tpu import pcm as ref_pcm
from audiotools_tpu.pcmstream import PCMReader
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
