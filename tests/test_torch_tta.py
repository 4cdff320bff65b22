"""The port's TTA codec on the CPU: the files of ``formats.tta.write_tta``
(device="cpu": the plain versions of the device encode) equal the
reference's ``TrueAudio.from_pcm`` byte for byte; ``TorchTTADecoder``
equals the reference's host decoder (``FastTTADecoder``) and device
decoder (``JaxTTADecoder``) over
channel counts and depths, with a partial final frame, and seeks as
the host decoder does.  The streams are 8 kHz (8,359-sample frames),
which keeps the plain version's per-sample loop short.  On a card the
decode equals the reference's host decoder."""

import io

import numpy as np
import pytest
import torch

from audiotools_tpu import pcm as ref_pcm
from audiotools_tpu.codecs import tta as ref_tta
from audiotools_tpu.formats.tta import TrueAudio
from audiotools_tpu.pcmstream import PCMReader
from audiotools_tpu_torch import pcm
from audiotools_tpu_torch.codecs import tta
from audiotools_tpu_torch.formats import tta as tta_format
from audiotools_tpu_torch.ref import tta as oracle

torch.set_num_threads(1)

RATE = 8000


def signal(channels, bps, n, seed):
    rng = np.random.default_rng(seed)
    t = np.arange(n)
    amp = 1 << (bps - 3)
    x = np.stack([amp * np.sin(2 * np.pi * (300 + 70 * c) * t / RATE)
                  + rng.integers(-amp // 16, amp // 16 + 1, n)
                  for c in range(channels)], axis=1)
    return np.clip(x, -(1 << (bps - 1)), (1 << (bps - 1)) - 1).astype(
        np.int32)


def ref_reader(arr, bps, rate=RATE):
    data = ref_pcm.FrameList._wrap(arr, bps).to_bytes(False, True)
    return PCMReader(io.BytesIO(data), rate, arr.shape[1], 0, bps)


def reference_file(tmp_path, arr, bps, rate=RATE):
    path = str(tmp_path / ("ref-%d-%d.tta" % (arr.shape[1], bps)))
    TrueAudio.from_pcm(path, ref_reader(arr, bps, rate))
    return path


def drain(dec, chunk=4096):
    pieces = []
    while True:
        framelist = dec.read(chunk)
        if framelist.frames == 0:
            break
        pieces.append(np.asarray(framelist.samples, dtype=np.int32))
    dec.close()
    return np.concatenate(pieces)


def reference_decode(path, backend):
    """the reference's decoder for a file (``native`` host or ``jax``
    device backend)"""
    import os
    old = os.environ.get("ATPU_TTA_DEC_BACKEND")
    os.environ["ATPU_TTA_DEC_BACKEND"] = backend
    try:
        return drain(ref_tta.decoder_for_file(open(path, "rb")), 65536)
    finally:
        if old is None:
            del os.environ["ATPU_TTA_DEC_BACKEND"]
        else:
            os.environ["ATPU_TTA_DEC_BACKEND"] = old


CASES = [(1, 16), (2, 16), (2, 24), (2, 8)]


@pytest.mark.parametrize("channels,bps", CASES + [(3, 16)])
@pytest.mark.parametrize("known_length", [False, True])
def test_file_matches_reference(tmp_path, channels, bps, known_length):
    arr = signal(channels, bps, 2 * 8359 + 1234, seed=channels + bps)
    with open(reference_file(tmp_path, arr, bps), "rb") as f:
        want = f.read()
    out = io.BytesIO()
    sizes = tta_format.write_tta(
        out, pcm.reader_from_array(arr, bps, RATE),
        total_pcm_frames=arr.shape[0] if known_length else None,
        device="cpu")
    assert out.getvalue() == want
    assert len(sizes) == 3


def test_encode_at_44100_matches_reference(tmp_path):
    arr = signal(2, 16, 46080 + 1000, seed=1)
    with open(reference_file(tmp_path, arr, 16, 44100), "rb") as f:
        want = f.read()
    out = io.BytesIO()
    tta_format.write_tta(out, pcm.reader_from_array(arr, 16, 44100),
                         device="cpu")
    assert out.getvalue() == want


def test_wrong_length_raises():
    arr = signal(1, 16, 1000, seed=2)
    with pytest.raises(ValueError, match="mismatch"):
        tta_format.write_tta(io.BytesIO(), pcm.reader_from_array(arr, 16,
                                                                 RATE),
                             total_pcm_frames=999, device="cpu")


@pytest.mark.parametrize("channels,bps", CASES)
def test_decoder_matches_reference_decoders(tmp_path, channels, bps):
    arr = signal(channels, bps, 2 * 8359 + 1234, seed=10 + channels + bps)
    path = reference_file(tmp_path, arr, bps)
    host = reference_decode(path, "native")
    assert np.array_equal(host, arr)
    assert np.array_equal(drain(tta.TorchTTADecoder(path, device="cpu")),
                          host)
    assert np.array_equal(reference_decode(path, "jax"), host)
    assert np.array_equal(drain(tta.FastTTADecoder(path)), host)


def test_group_boundaries(tmp_path, monkeypatch):
    """groups of 2 frames over a 5-frame stream, read in odd sizes"""
    monkeypatch.setattr(tta, "DEC_GROUP_FRAMES", 2)
    arr = signal(2, 16, 4 * 8359 + 77, seed=4)
    path = reference_file(tmp_path, arr, 16)
    dec = tta.TorchTTADecoder(path, device="cpu")
    got = drain(dec, chunk=3001)
    assert np.array_equal(got, arr)


def test_seek(tmp_path):
    arr = signal(2, 16, 3 * 8359 + 500, seed=5)
    path = reference_file(tmp_path, arr, 16)
    ref = ref_tta.FastTTADecoder(open(path, "rb"))
    ref.__frames_start__ = ref.reader.source.tell()
    for cls in (tta.FastTTADecoder, tta.TorchTTADecoder):
        args = {} if cls is tta.FastTTADecoder else {"device": "cpu"}
        dec = cls(path, **args)
        for target in (20000, 0, 8359, 10 ** 9):
            pos = dec.seek(target)
            assert pos == ref.seek(target)
            got = dec.read(4000).samples
            assert got.shape[0] > 0
            assert np.array_equal(got, arr[pos:pos + got.shape[0]])
        dec.close()


def test_header_checks(tmp_path):
    arr = signal(1, 16, 1000, seed=6)
    out = io.BytesIO()
    tta_format.write_tta(out, pcm.reader_from_array(arr, 16, RATE),
                         device="cpu")
    data = out.getvalue()
    header = oracle.read_tta_header(io.BytesIO(data))
    assert (header["channels"], header["bits_per_sample"],
            header["sample_rate"], header["total_pcm_frames"]) == (
                1, 16, RATE, 1000)
    assert header["block_size"] == oracle.block_size_for(RATE) == 8359
    for (offset, message) in ((0, "signature"), (6, "header CRC"),
                              (23, "seektable CRC")):
        bad = bytearray(data)
        bad[offset] ^= 0x01
        with pytest.raises(ValueError, match=message):
            tta.TorchTTADecoder(io.BytesIO(bytes(bad)), device="cpu")
    bad = bytearray(data)
    bad[-10] ^= 0x01
    with pytest.raises(ValueError, match="corrupt"):
        tta.decode_tta(bytes(bad), device="cpu")


def test_copied_helpers_match_the_reference():
    from audiotools_tpu.formats import tta as ref_format
    from audiotools_tpu.ref import tta as ref_oracle
    rng = np.random.default_rng(7)
    for n in (0, 1, 17, 1000):
        data = rng.integers(0, 256, n).astype(np.uint8).tobytes()
        assert oracle.crc32(data) == ref_oracle.crc32(data)
    for rate in (8000, 44100, 48000, 96000):
        assert oracle.block_size_for(rate) == ref_oracle.block_size_for(rate)
    assert (tta_format.build_header(2, 24, 48000, 123456) ==
            ref_format.build_header(2, 24, 48000, 123456))
    assert (tta_format.build_seektable([5, 77, 123]) ==
            ref_format.build_seektable([5, 77, 123]))


def test_native_scan_matches_the_reference():
    """the port's copy of the C++ residual scan, residual packer and
    frame decoder give the reference's (packing the scanned residuals
    gives the frames back)"""
    from audiotools_tpu import _native as ref_native
    from audiotools_tpu_torch import _native
    arr = signal(2, 24, 8359 + 100, seed=8)
    out = io.BytesIO()
    tta_format.write_tta(out, pcm.reader_from_array(arr, 24, RATE),
                         device="cpu")
    f = io.BytesIO(out.getvalue())
    header = oracle.read_tta_header(f)
    data = f.read()
    lens = np.asarray(header["frame_lengths"], dtype=np.int64)
    sizes = np.asarray([8359, 100], dtype=np.int32)
    residuals = ref_native.tta_scan_residuals(data, lens, sizes, 2)
    assert np.array_equal(_native.tta_scan_residuals(data, lens, sizes, 2),
                          residuals)
    (packed, packed_lens) = _native.tta_pack_frames(residuals, sizes, 2)
    assert packed == ref_native.tta_pack_frames(residuals, sizes, 2)[0]
    assert list(packed_lens) == list(lens)
    (got, used) = _native.tta_decode_frame(data, 8359, 2, 24)
    assert np.array_equal(got, arr[:8359])
    assert used == ref_native.tta_decode_frame(data, 8359, 2, 24)[1]


def test_cuda_request_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        tta.TorchTTADecoder(io.BytesIO(b""), device="cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("channels,bps", CASES)
def test_cuda_decode_matches_host_decoder(tmp_path, channels, bps):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    # a last frame of 1234 samples: the reference's host encoder writes
    # past its buffer on a 99-sample 24-bit one
    arr = signal(channels, bps, 5 * 8359 + 1234, seed=20 + channels)
    path = reference_file(tmp_path, arr, bps)
    before = tta.tta_synth.inverse_filter_predict.launches
    got = drain(tta.TorchTTADecoder(path, device="cuda"))
    assert tta.tta_synth.inverse_filter_predict.launches > before
    assert np.array_equal(got, reference_decode(path, "native"))
