"""The port's WavPack encoder, writer and decoder on the CPU, held byte
for byte and sample for sample to the reference: ``encode_wavpack``
(device="cpu", the plain pass chains) and ``write_wavpack`` against the
reference's ``encode_wavpack`` and ``WavPackAudio.from_pcm`` at 0-16
passes, 1, 2, 3 and 6 channels, 8, 16 and 24 bits, short final blocks
(down to one sample, shorter than the chain's warm-up span, which the
reference's own route sends to its host passes), false stereo and
wasted bits, and against the reference's JAX
encode route; ``TorchWavPackDecoder`` against the reference's host and
batched JAX decoders, with seeking and a corrupt MD5; the port's C++
wrappers and bit readers and writers against the reference's.  The
blocks are 4096 samples (the writer's 44,100 in one case), which keeps
the plain per-sample loops short.  On a card the encode and decode
give the reference's bytes and samples."""

import hashlib
import io

import numpy as np
import pytest
import torch

from audiotools_tpu import bitstream as ref_bitstream
from audiotools_tpu import pcm as ref_pcm
from audiotools_tpu.codecs import wavpack_jax
from audiotools_tpu.formats.wavpack import WavPackAudio
from audiotools_tpu.pcmstream import PCMReader
from audiotools_tpu.ref import wavpack as ref_wv
from audiotools_tpu_torch import _native, bitstream, pcm
from audiotools_tpu_torch.codecs import wavpack
from audiotools_tpu_torch.formats import wavpack as wv_format
from audiotools_tpu_torch.ops import wv_scan
from audiotools_tpu_torch.ref import wavpack as oracle

torch.set_num_threads(1)

BLOCK = 4096


def signal(n, channels=2, bps=16, seed=7):
    """tones and noise at about a quarter of full scale"""
    rng = np.random.default_rng(seed)
    t = np.arange(n)
    amp = 1 << (bps - 3)
    x = np.stack([amp * np.sin(t * 0.013 * (c + 1)) +
                  rng.integers(-amp // 20, amp // 20 + 1, n)
                  for c in range(channels)], axis=1)
    return np.clip(x, -(1 << (bps - 1)), (1 << (bps - 1)) - 1).astype(
        np.int32)


def ref_reader(arr, bps=16):
    mask = pcm.CHANNEL_MASKS.get(arr.shape[1], 0)
    data = ref_pcm.FrameList._wrap(arr, bps).to_bytes(False, True)
    return PCMReader(io.BytesIO(data), 44100, arr.shape[1], mask, bps)


def ref_encode(arr, passes, bps=16, block_size=BLOCK):
    out = io.BytesIO()
    ref_wv.encode_wavpack(out, ref_reader(arr, bps), block_size=block_size,
                          correlation_passes=passes)
    return out.getvalue()


def port_encode(arr, passes, bps=16, block_size=BLOCK, device="cpu"):
    out = io.BytesIO()
    wavpack.encode_wavpack(out, pcm.reader_from_array(arr, bps), block_size,
                           correlation_passes=passes, device=device)
    return out.getvalue()


def host_encode(arr, passes, bps=16, block_size=BLOCK):
    out = io.BytesIO()
    oracle.encode_wavpack(out, pcm.reader_from_array(arr, bps), block_size,
                          correlation_passes=passes)
    return out.getvalue()


def ref_decode(data):
    dec = ref_wv.WavPackDecoder(io.BytesIO(data))
    return pcm.read_all(dec)


@pytest.mark.parametrize("passes", [0, 1, 2, 5, 10, 16])
def test_encode_matches_reference(passes):
    arr = signal(BLOCK + 904, seed=passes)
    want = ref_encode(arr, passes)
    assert port_encode(arr, passes) == want
    assert host_encode(arr, passes) == want
    assert np.array_equal(ref_decode(want), arr)


@pytest.mark.parametrize("channels", [1, 2, 3, 6])
def test_encode_channel_layouts(channels):
    """mono, stereo, 0x7 (a pair and a mono group) and 0x3F (pair,
    mono, mono, pair): a frame's groups correlate in one batch"""
    arr = signal(BLOCK + 300, channels, seed=channels)
    want = ref_encode(arr, 5)
    assert port_encode(arr, 5) == want
    assert np.array_equal(ref_decode(want), arr)


@pytest.mark.parametrize("bps", [8, 16, 24])
def test_encode_bit_depths(bps):
    arr = signal(BLOCK + 500, 2, bps, seed=bps)
    want = ref_encode(arr, 2, bps)
    assert port_encode(arr, 2, bps) == want
    assert np.array_equal(ref_decode(want), arr)


@pytest.mark.parametrize("tail", [700, 2, 1])
def test_short_final_block(tail):
    """a final block of 700 samples, and one of 1 or 2, shorter than the
    5-pass chain's warm-up span of 3 (which the reference sends to its
    host passes), run on the device"""
    arr = signal(BLOCK + tail, seed=tail)
    want = ref_encode(arr, 5)
    assert port_encode(arr, 5) == want
    assert np.array_equal(wavpack.decode_wavpack(want, device="cpu"), arr)


def test_short_final_block_of_every_group():
    arr = signal(BLOCK + 1, 6, seed=11)
    assert port_encode(arr, 10) == ref_encode(arr, 10)


def test_false_stereo_and_wasted_bits():
    """identical channels code as one (false stereo); samples with
    their low 3 bits zero store the shift (wasted bits); a silent
    stretch"""
    rng = np.random.default_rng(5)
    mono = signal(BLOCK + 900, 1, seed=5)[:, 0]
    arr = np.stack([mono, mono], axis=1)
    arr[BLOCK:] = (signal(900, 2, seed=6) >> 3) << 3
    arr[100:400] = 0
    for passes in (2, 10):
        want = ref_encode(arr, passes)
        assert port_encode(arr, passes) == want
        assert np.array_equal(wavpack.decode_wavpack(want, device="cpu"), arr)
    odd = arr.copy()
    odd[BLOCK:, 1] = rng.integers(-5, 5, 900) * 8 + 1
    assert port_encode(odd, 5) == ref_encode(odd, 5)


def test_encode_matches_reference_jax_route(monkeypatch):
    wavpack_jax.install()
    monkeypatch.setenv("ATPU_WV_BACKEND", "jax")
    arr = signal(2 * BLOCK + 808, seed=12)
    assert port_encode(arr, 1) == ref_encode(arr, 1)


@pytest.mark.parametrize("compression,known", [("veryfast", False),
                                               ("veryfast", True)])
def test_write_wavpack_matches_from_pcm(tmp_path, compression, known):
    """the writer's 44,100-sample blocks, the stored RIFF header, and
    the total length known up front or back-patched"""
    arr = signal(44100 + 1900, seed=3)
    path = str(tmp_path / "ref.wv")
    WavPackAudio.from_pcm(path, ref_reader(arr), compression=compression,
                          total_pcm_frames=arr.shape[0] if known else None)
    with open(path, "rb") as f:
        want = f.read()
    out = io.BytesIO()
    wv_format.write_wavpack(
        out, pcm.reader_from_array(arr, 16), compression,
        total_pcm_frames=arr.shape[0] if known else None, device="cpu")
    assert out.getvalue() == want
    with pytest.raises(ValueError, match="mismatch"):
        wv_format.write_wavpack(io.BytesIO(), pcm.reader_from_array(arr, 16),
                                compression, total_pcm_frames=5,
                                device="cpu")
    with pytest.raises(ValueError, match="compression"):
        wv_format.write_wavpack(io.BytesIO(), pcm.reader_from_array(arr, 16),
                                "insane", device="cpu")


def test_write_wavpack_to_a_path(tmp_path):
    arr = signal(3000, 2, seed=4)
    path = str(tmp_path / "port.wv")
    wv_format.write_wavpack(path, pcm.reader_from_array(arr, 16), "fast",
                            device="cpu")
    with open(path, "rb") as f:
        data = f.read()
    assert np.array_equal(ref_decode(data), arr)


def stream(channels=2, passes=10, n=3 * BLOCK + 500, bps=16, seed=21):
    arr = signal(n, channels, bps, seed=seed)
    return (arr, ref_encode(arr, passes, bps))


@pytest.mark.parametrize("channels,passes,bps", [
    (2, 16, 16), (1, 5, 24), (6, 5, 16), (2, 0, 8), (3, 10, 16)])
def test_decode_matches_reference(channels, passes, bps):
    (arr, data) = stream(channels, passes, bps=bps, seed=channels + passes)
    dec = wavpack.TorchWavPackDecoder(io.BytesIO(data), device="cpu")
    got = pcm.read_all(dec)
    assert np.array_equal(got, arr)
    assert np.array_equal(got, ref_decode(data))
    assert dec.md5_checked and dec.host_blocks == 0
    assert sorted(dec.timings) == sorted(wavpack.DECODE_STAGES)
    assert (dec.channels, dec.channel_mask, dec.bits_per_sample,
            dec.sample_rate, dec.total_frames) == (
        channels, pcm.CHANNEL_MASKS[channels], bps, 44100, arr.shape[0])


def test_decode_matches_batched_reference(monkeypatch):
    """the reference's BatchedWavPackDecoder (its JAX route), read for
    read; the port's batch of 2 blocks splits no group"""
    (arr, data) = stream(2, 2, n=2 * BLOCK + 77, seed=8)
    monkeypatch.setenv("ATPU_WV_DEC_BACKEND", "jax")
    ref_dec = wavpack_jax.BatchedWavPackDecoder(io.BytesIO(data))
    dec = wavpack.TorchWavPackDecoder(io.BytesIO(data), device="cpu",
                                      batch_blocks=2)
    while True:
        (a, b) = (ref_dec.read(BLOCK), dec.read(BLOCK))
        assert np.array_equal(a.samples, b.samples)
        if b.frames == 0:
            break
    assert dec.host_blocks == 0


def test_decode_host_route(monkeypatch):
    """blocks the device path does not take run the host passes and are
    counted; the output does not change"""
    (arr, data) = stream(6, 10, n=BLOCK + 10, seed=9)
    taken = []
    device_inputs = wavpack.device_inputs

    def every_other(parsed):
        taken.append(len(taken) % 2 == 0)
        return device_inputs(parsed) if taken[-1] else None

    monkeypatch.setattr(wavpack, "device_inputs", every_other)
    dec = wavpack.TorchWavPackDecoder(io.BytesIO(data), device="cpu")
    assert np.array_equal(pcm.read_all(dec), arr)
    assert dec.host_blocks == taken.count(False) == 4


def test_device_inputs_refuses_what_the_kernels_do_not_take():
    parsed = {"residuals": [np.arange(5), np.arange(5)],
              "terms": [18, -1], "deltas": [2, 2],
              "weights": [[1, 2], [3, 4]],
              "samples": [[[1, 2], [3, 4]], [[5], [6]]]}
    (x, chain, w, s) = wavpack.device_inputs(parsed)
    assert x.shape == (2, 5) and chain == [(18, 2), (-1, 2)]
    assert w == [[1, 2], [3, 4]] and s == parsed["samples"]
    for change in ({"terms": [9, -1]}, {"terms": []},
                   {"residuals": [np.arange(5)]},
                   {"residuals": [np.arange(0), np.arange(0)]},
                   {"samples": [[[1], [3]], [[5], [6]]]}):
        assert wavpack.device_inputs(dict(parsed, **change)) is None


def test_corrupt_md5_raises():
    (arr, data) = stream(2, 2, n=BLOCK + 10, seed=10)
    bad = bytearray(data)
    digest = hashlib.md5(pcm.FrameList(arr, 16).to_bytes(False, True))
    bad[data.rindex(digest.digest())] ^= 1
    with pytest.raises(ValueError, match="MD5"):
        wavpack.decode_wavpack(bytes(bad), device="cpu")
    with pytest.raises(ValueError, match="MD5"):
        ref_decode(bytes(bad))


def test_corrupt_block_raises():
    (_arr, data) = stream(2, 2, n=BLOCK + 10, seed=13)
    bad = bytearray(data)
    bad[len(bad) // 2] ^= 0x10
    with pytest.raises(ValueError):
        wavpack.decode_wavpack(bytes(bad), device="cpu")


def test_seek_matches_reference():
    (arr, data) = stream(2, 2, n=4 * BLOCK + 123, seed=14)
    dec = wavpack.TorchWavPackDecoder(io.BytesIO(data), device="cpu",
                                      batch_blocks=3)
    ref_dec = ref_wv.WavPackDecoder(io.BytesIO(data))
    first = dec.read(BLOCK)
    assert np.array_equal(first.samples, arr[:BLOCK])
    for target in (2 * BLOCK + 5, 10, 3 * BLOCK, 10 ** 9):
        pos = dec.seek(target)
        assert pos == ref_dec.seek(target) == min(target, 4 * BLOCK) \
            // BLOCK * BLOCK
        assert np.array_equal(pcm.read_all(dec), arr[pos:])
        assert np.array_equal(pcm.read_all(ref_dec), arr[pos:])


def test_native_wrappers_match_reference():
    """crc, one encode and one decode pass of each term, the residual
    coder and reader: the port's C++ against the reference's"""
    rng = np.random.default_rng(15)
    x = [rng.integers(-40000, 40000, 300), rng.integers(-40000, 40000, 300)]
    assert _native.wv_crc(x) == ref_wv.calculate_crc(x)
    assert _native.wv_crc(x[:1]) == ref_wv.calculate_crc(x[:1])
    for term in wv_scan.TERMS:
        for cc in ((2,) if term < 0 else (1, 2)):
            span = wv_scan.span(term)
            w = [int(v) for v in rng.integers(-1024, 1025, cc)]
            s = [[int(v) for v in rng.integers(-3000, 3000, span)]
                 for _ in range(cc)]
            (chs, ws, ss) = _native.wv_correlate(x[:cc], term, 3, w, s)
            (rchs, rws, rss) = ref_wv._native_correlate(
                [c.copy() for c in x[:cc]], cc, term, 3, w, s)
            assert ws == rws
            assert all(np.array_equal(a, b) for (a, b) in zip(chs, rchs))
            assert all(np.array_equal(a, b) for (a, b) in zip(ss, rss))
            dec = _native.wv_decorrelate(x[:cc], term, 3, w, s)
            rdec = ref_wv._native_decorrelate([c.copy() for c in x[:cc]],
                                              cc, term, 3, w, s)
            assert all(np.array_equal(a, b) for (a, b) in zip(dec, rdec))
    for cc in (1, 2):
        ent = [[100, 2000, 30], [5, 60, 700]]
        ref_ent = [list(e) for e in ent]
        coded = _native.wv_write_bitstream(x[:cc], ent)
        rec = ref_bitstream.BitstreamRecorder(True)
        ref_wv.write_bitstream(rec, x[:cc], ref_ent)
        assert coded == rec.data() and ent == ref_ent
        ent = [[100, 2000, 30], [5, 60, 700]]
        ref_ent = [list(e) for e in ent]
        got = _native.wv_read_bitstream(coded, 300, cc, ent)
        header = type("H", (), {"block_samples": 300})()
        want = ref_wv._read_bitstream(ref_bitstream.BitstreamReader(
            coded, True), header, ref_ent, cc == 2, raw_data=coded)
        assert all(np.array_equal(a, b) for (a, b) in zip(got, want))
        assert all(np.array_equal(a, b) for (a, b) in zip(got, x[:cc]))
        assert ent == ref_ent
    with pytest.raises(ValueError, match="bitstream"):
        _native.wv_read_bitstream(coded[:10], 300, 2, [[100] * 3, [5] * 3])
    with pytest.raises(ValueError, match="decorrelation"):
        _native.wv_correlate(x[:1], -1, 2, [0], [[0]])


def test_bitstream_matches_reference():
    rng = np.random.default_rng(16)
    fields = [(int(b), int(rng.integers(0, 1 << b))) for b in
              rng.integers(1, 33, 200)]
    rec = bitstream.BitstreamRecorder(True)
    ref_rec = ref_bitstream.BitstreamRecorder(True)
    for w in (rec, ref_rec):
        for (bits, value) in fields:
            w.write(bits, value)
        w.write_signed(16, -1234)
        w.build("5u 1u 1u 2p 8u", (17, 1, 0, 200))
        w.write_bytes(b"wvpk")
        w.write(3, 5)
    assert (rec.data(), rec.bytes()) == (ref_rec.data(), ref_rec.bytes())
    out = io.BytesIO()
    writer = bitstream.BitstreamWriter(out, True)
    rec.copy(writer)
    writer.byte_align()
    writer.flush()
    ref_out = io.BytesIO()
    ref_writer = ref_bitstream.BitstreamWriter(ref_out, True)
    ref_rec.copy(ref_writer)
    ref_writer.byte_align()
    ref_writer.flush()
    data = out.getvalue()
    assert data == ref_out.getvalue()
    for reader in (bitstream.BitstreamReader(data, True),
                   bitstream.BitstreamReader(io.BytesIO(data), True)):
        ref_reader_ = ref_bitstream.BitstreamReader(data, True)
        assert [reader.read(b) for (b, _v) in fields] == \
            [v for (_b, v) in fields]
        assert [ref_reader_.read(b) for (b, _v) in fields] == \
            [v for (_b, v) in fields]
        reader.mark()
        assert reader.read_signed(16) == -1234
        reader.rewind()
        reader.unmark()
        assert reader.parse("16s 5u 1u 1u 2p 8u 4b") == [
            -1234, 17, 1, 0, 200, b"wvpk"]
        assert reader.unary(0) == 1
        reader.seek(1)
        assert reader.substream(3).read_bytes(3) == data[1:4]
        with pytest.raises(IOError):
            reader.read_bytes(len(data))
    for stop in (0, 1):
        for data in (b"\x0b", b"\xf4\x01"):
            assert bitstream.BitstreamReader(data, True).unary(stop) == \
                ref_bitstream.BitstreamReader(data, True).unary(stop)


def test_cuda_request_raises_without_a_card(monkeypatch):
    """every entry point defaults to the card and raises without one"""
    (arr, data) = stream(2, 2, n=1000, seed=17)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (
            lambda: wavpack.encode_wavpack(
                io.BytesIO(), pcm.reader_from_array(arr, 16), BLOCK),
            lambda: wv_format.write_wavpack(
                io.BytesIO(), pcm.reader_from_array(arr, 16)),
            lambda: wavpack.TorchWavPackDecoder(io.BytesIO(data)),
            lambda: wavpack.decode_wavpack(data)):
        with pytest.raises(RuntimeError, match="cuda"):
            call()


@pytest.mark.cuda
@pytest.mark.parametrize("channels,passes,tail", [
    (2, 5, 700), (2, 16, 2), (1, 10, 3), (6, 16, 900), (3, 2, 1)])
def test_cuda_encode_matches_reference(channels, passes, tail):
    """one launch a frame for all its channel groups, a final block
    shorter than its chain's warm-up span too"""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    arr = signal(2 * BLOCK + tail, channels, seed=30 + passes)
    before = wv_scan.run_pass_chain.launches
    assert port_encode(arr, passes, device="cuda") == ref_encode(arr, passes)
    assert wv_scan.run_pass_chain.launches - before == 3


@pytest.mark.cuda
@pytest.mark.parametrize("channels,passes,bps,launches", [
    (2, 16, 16, 2), (1, 5, 24, 2), (6, 10, 16, 6), (2, 2, 8, 2)])
def test_cuda_decode_matches_reference(channels, passes, bps, launches):
    """41 block groups, in batches of whole groups up to 32 blocks"""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    (arr, data) = stream(channels, passes, n=40 * BLOCK + 11, bps=bps,
                         seed=40 + channels)
    before = wv_scan.run_dec_chain.launches
    dec = wavpack.TorchWavPackDecoder(io.BytesIO(data), device="cuda")
    got = pcm.read_all(dec)
    assert np.array_equal(got, arr)
    assert np.array_equal(got, ref_decode(data))
    assert dec.md5_checked and dec.host_blocks == 0
    assert wv_scan.run_dec_chain.launches - before == launches
