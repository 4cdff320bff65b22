"""The port's FLAC decoder (``codecs/flac_dec.TorchFlacDecoder``) on
the CPU: byte for byte the reference's host decoder
(``FastFlacDecoder``) over channel counts, depths, block sizes and
subframe types, and the reference's device decoder
(``JaxFlacDecoder``) on a stereo -8 stream; seek, the end-of-stream MD5
check, truncation, the host fallbacks and the scan's cut points.  On a
card the device decode must equal the host decoder."""

import io
import os

import numpy as np
import pytest
import torch

from conftest import REFERENCE_DIR, reference_available

from audiotools_tpu import pcm as ref_pcm
from audiotools_tpu.codecs.flac_dec_fast import FastFlacDecoder
from audiotools_tpu.pcmstream import PCMReader
from audiotools_tpu_torch import _native, pcm
from audiotools_tpu_torch.codecs import flac_dec
from audiotools_tpu_torch.codecs import flac_enc_fast as port_enc
from test_flac_dec_jax import drain_bytes, encode_flac, make_reader

torch.set_num_threads(1)

MINUS_8 = dict(block_size=4096, max_lpc_order=12,
               exhaustive_model_search=True, max_residual_partition_order=6)
SMALL = dict(block_size=4096, max_lpc_order=8,
             exhaustive_model_search=False, max_residual_partition_order=4)


def stream(tmp_path, kind, bps, channels, n, **opts):
    path = str(tmp_path / ("%s-%d-%d.flac" % (kind, bps, channels)))
    encode_flac(path, make_reader(kind, bps, channels, n),
                mid_side=channels == 2, **opts)
    return path


def drain(dec):
    """every PCM byte a decoder gives; closes it"""
    try:
        return drain_bytes(dec)
    finally:
        dec.close()


def port_vs_host(path):
    """the port's CPU decode and the reference's host decoder give the
    same PCM bytes; returns them"""
    want = drain(FastFlacDecoder(path))
    assert drain(flac_dec.TorchFlacDecoder(path, device="cpu")) == want
    return want


def test_matches_jax_decoder(tmp_path):
    """a stereo -8 stream against the reference's device decoder (one
    jit signature)"""
    from audiotools_tpu.codecs.flac_dec_jax import JaxFlacDecoder
    path = stream(tmp_path, "tone", 16, 2, 44100, **MINUS_8)
    want = drain(JaxFlacDecoder(path))
    assert drain(flac_dec.TorchFlacDecoder(path, device="cpu")) == want
    assert port_vs_host(path) == want


@pytest.mark.parametrize("bps,channels,kind", [
    (16, 2, "tone"), (8, 2, "tone"), (24, 2, "noise"), (16, 1, "noise"),
    (16, 6, "noise"), (24, 8, "tone")])
def test_matches_host_decoder(tmp_path, bps, channels, kind):
    data = port_vs_host(stream(tmp_path, kind, bps, channels, 9000,
                               **SMALL))
    assert len(data) == 9000 * channels * (bps // 8)


@pytest.mark.parametrize("block_size", [192, 256, 1000, 1152])
def test_small_blocks(tmp_path, block_size):
    """partitions that do not fill whole 64-code slots (block 192
    porder 1: 96-code partitions) share slots, so records add; block
    1000 leaves the last slot of a row part-filled"""
    port_vs_host(stream(tmp_path, "noise", 16, 2, 20000,
                        block_size=block_size, max_lpc_order=8,
                        exhaustive_model_search=False,
                        max_residual_partition_order=4))


def test_verbatim_and_constant(tmp_path):
    rng = np.random.default_rng(3)
    flat = np.zeros((9000, 2), dtype=np.int32)
    flat[4096:8192, 0] = rng.integers(-32768, 32767, 4096)
    flat[4096:8192, 1] = 777
    fl = ref_pcm.FrameList._wrap(flat, 16)
    path = str(tmp_path / "vc.flac")
    encode_flac(path, PCMReader(io.BytesIO(fl.to_bytes(False, True)),
                                44100, 2, 3, 16),
                mid_side=False, **SMALL)
    data = port_vs_host(path)
    assert (np.frombuffer(data, dtype="<i2").reshape(-1, 2) == flat).all()


def test_seek_and_read_sizes(tmp_path):
    """seek lands at or before the target and drops the in-flight
    batch; read never returns more frames than asked"""
    path = stream(tmp_path, "tone", 16, 2, 44100 * 2, **SMALL)
    full = np.frombuffer(port_vs_host(path), dtype="<i2").reshape(-1, 2)
    dec = flac_dec.TorchFlacDecoder(path, device="cpu")
    assert dec.read(100).frames == 100
    landed = dec.seek(50000)
    assert landed <= 50000
    rest = []
    while True:
        framelist = dec.read(7000)
        assert framelist.frames <= 7000
        if framelist.frames == 0:
            break
        rest.append(framelist.samples)
    assert np.array_equal(np.concatenate(rest), full[landed:])
    assert sorted(dec.timings) == sorted(flac_dec.STAGES)
    assert all(v >= 0.0 for v in dec.timings.values())
    dec.close()
    with pytest.raises(ValueError):
        dec.read(10)


def test_md5_mismatch_raises(tmp_path):
    path = stream(tmp_path, "noise", 16, 2, 30000, **SMALL)
    with open(path, "r+b") as f:
        f.seek(26)
        raw = bytearray(f.read(16))
        raw[0] ^= 0xFF
        f.seek(26)
        f.write(bytes(raw))
    with pytest.raises(ValueError, match="MD5"):
        drain(flac_dec.TorchFlacDecoder(path, device="cpu"))


def test_truncated_stream_raises(tmp_path):
    with open(stream(tmp_path, "noise", 16, 2, 60000, **SMALL), "rb") as f:
        data = f.read()
    cut = io.BytesIO(data[:len(data) - len(data) // 3])
    with pytest.raises(ValueError):
        drain(flac_dec.TorchFlacDecoder(cut, device="cpu"))


def test_host_fallbacks(tmp_path, monkeypatch):
    """a chunk over the scan's capacity, or with a record no bucket
    holds, goes through the host decoder and is counted"""
    path = stream(tmp_path, "noise", 16, 2, 30000, **SMALL)
    want = port_vs_host(path)
    before = flac_dec.host_chunks
    monkeypatch.setattr(flac_dec, "MAX_PARTS", 8)
    assert drain(flac_dec.TorchFlacDecoder(path, device="cpu")) == want
    assert flac_dec.host_chunks > before
    monkeypatch.undo()
    before = flac_dec.host_chunks
    monkeypatch.setattr(flac_dec, "BUCKETS", ((8, 64),))
    assert drain(flac_dec.TorchFlacDecoder(path, device="cpu")) == want
    assert flac_dec.host_chunks > before


def test_decode_flac_round_trip():
    """the port's encoder and decoder, end to end on the CPU"""
    rng = np.random.default_rng(8)
    arr = np.cumsum(rng.integers(-400, 401, (4096 * 3 + 77, 2)),
                    axis=0).clip(-32768, 32767).astype(np.int32)
    out = io.BytesIO()
    port_enc.encode_flac_fast(out, pcm.reader_from_array(arr, 16),
                              device="cpu", batch_frames=2, **MINUS_8)
    assert np.array_equal(flac_dec.decode_flac(out.getvalue(), device="cpu"),
                          arr)
    assert np.array_equal(pcm.decode_flac(out.getvalue()), arr)


def test_not_a_flac_stream(tmp_path):
    path = str(tmp_path / "x.flac")
    with open(path, "wb") as f:
        f.write(b"RIFF" + bytes(60))
    with pytest.raises(ValueError, match="fLaC"):
        flac_dec.TorchFlacDecoder(path, device="cpu")
    with pytest.raises(ValueError, match="truncated"):
        flac_dec.TorchFlacDecoder(io.BytesIO(b"fLaC\x00\x00\x00\x22"),
                                  device="cpu")


def test_cuda_request_raises_without_a_card(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        flac_dec.TorchFlacDecoder(io.BytesIO(b"fLaC"), device="cuda")


def test_scan_stops_cleanly_at_every_cut():
    """a buffer may end anywhere inside a frame: the port's scan stops
    at the last complete frame for every cut point of the stream"""
    rng = np.random.default_rng(17)
    arr = np.cumsum(rng.integers(-300, 301, (1152 * 4, 2)),
                    axis=0).clip(-32768, 32767).astype(np.int32)
    out = io.BytesIO()
    port_enc.encode_flac_fast(out, pcm.reader_from_array(arr, 16),
                              device="cpu", block_size=1152,
                              max_lpc_order=8, batch_frames=4)
    data = out.getvalue()
    frames = data[pcm.streaminfo(data)[4]:]
    full = _native.flac_scan(frames, 16, 2, max_samples=1 << 30,
                             max_frames=64, max_parts=8192, chunk_codes=64)
    assert full["total_pcm_frames"] == arr.shape[0]
    ends = np.cumsum(full["frame_meta"][:, 3])
    for cut in range(len(frames) + 1):
        scan = _native.flac_scan(frames[:cut], 16, 2, max_samples=1 << 30,
                                 max_frames=64, max_parts=8192,
                                 chunk_codes=64)
        complete = int((ends <= cut).sum())
        assert scan["frame_meta"].shape[0] == complete, cut
        assert scan["consumed_bytes"] == (ends[complete - 1] if complete
                                          else 0), cut


@pytest.mark.skipif(not reference_available(),
                    reason="reference fixtures absent")
@pytest.mark.parametrize("name", ["flac-allframes.flac",
                                  "flac-disordered.flac"])
def test_reference_fixtures(name):
    port_vs_host(os.path.join(REFERENCE_DIR, "test", name))


@pytest.mark.cuda
@pytest.mark.parametrize("bps,channels,kind", [
    (16, 2, "tone"), (24, 2, "noise"), (16, 6, "noise")])
def test_cuda_decode_matches_host_decoder(tmp_path, bps, channels, kind):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    path = stream(tmp_path, kind, bps, channels, 44100 * 3, **MINUS_8)
    want = drain(FastFlacDecoder(path))
    before = flac_dec.host_chunks
    assert drain(flac_dec.TorchFlacDecoder(path, device="cuda")) == want
    assert flac_dec.host_chunks == before
