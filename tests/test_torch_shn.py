"""The port's Shorten path on the CPU, held exactly to the reference:
the decision analysis (``ops/shn_scan``) against the reference's numpy
and jitted forms; the encoded bytes of ``codecs.shn.encode_shn`` and
``formats.shn.write_shn`` against the reference's encoder (all-host
and device-steered) and ``ShortenAudio.from_pcm``; the warm-up chain
(``_native.shn_warm_chain``) and the synthesis (``ops/shn_synth``)
against the reference's; the decoded PCM of ``codecs.shn.decode_shn``
against the reference's host and device decoders; the reader's read
and seek; a QLPC stream that takes the host route.  On a card the
encode and decode equal the reference's bytes and PCM."""

import io
import struct

import numpy as np
import pytest
import torch

from audiotools_tpu import _native as ref_native
from audiotools_tpu import pcm as ref_pcm
from audiotools_tpu.codecs import shn as ref_shn
from audiotools_tpu.formats.shn import ShortenAudio
from audiotools_tpu.ops import shn_scan as ref_scan
from audiotools_tpu.ops import shn_synth as ref_synth
from audiotools_tpu.pcmstream import PCMReader
from audiotools_tpu_torch import _native, pcm
from audiotools_tpu_torch.codecs import shn
from audiotools_tpu_torch.formats import shn as shn_format
from audiotools_tpu_torch.ops import shn_scan, shn_synth

torch.set_num_threads(1)

HEADER = b"RIFF" + b"H" * 40
FOOTER = b"tail"


def signal(nch, bps, n, seed):
    """a random walk with a silent stretch (FN_ZERO blocks) and a
    stretch with wasted low bits"""
    rng = np.random.default_rng(seed)
    arr = (rng.integers(-2 ** (bps - 1), 2 ** (bps - 1), (n, nch))
           // 3).astype(np.int64)
    arr = np.cumsum(arr // 64, axis=0)
    arr[n // 4:n // 4 + 600] = 0
    arr[n // 2:n // 2 + 700] &= ~7
    return np.clip(arr, -2 ** (bps - 1), 2 ** (bps - 1) - 1).astype(
        np.int32)


def ref_reader(arr, bps, rate=44100):
    data = ref_pcm.FrameList._wrap(arr, bps).to_bytes(False, True)
    return PCMReader(io.BytesIO(data), rate, arr.shape[1],
                     pcm.CHANNEL_MASKS[arr.shape[1]], bps)


# (channels, bits, signed, frames, block size): 1-3 channels, 8 and 16
# bits, signed and unsigned, partial final blocks, 5 frames, and blocks
# of 2 (every block shorter than the predictor's history).  The
# reference's encoder zero-pads a short block's history where its
# decoders keep the older samples, so a stream of blocks of 2 need not
# decode to its input: only the reference's decoders say what it
# decodes to.
CASES = [(1, 16, True, 5000, 256), (2, 16, True, 10000, 256),
         (2, 8, False, 3000, 256), (3, 16, True, 777, 256),
         (2, 16, True, 5, 256), (2, 8, True, 2000, 256),
         (1, 16, False, 4099, 256), (2, 16, True, 301, 2)]


def reference_encode(arr, bps, signed, block_size, backend, monkeypatch):
    monkeypatch.setenv("ATPU_SHN_BACKEND", backend)
    out = io.BytesIO()
    ref_shn.encode_shn(out, ref_reader(arr, bps), False, signed, HEADER,
                       FOOTER, block_size)
    return out.getvalue()


def reference_encode_head(arr, head, monkeypatch):
    monkeypatch.setenv("ATPU_SHN_BACKEND", "native")
    out = io.BytesIO()
    ref_shn.encode_shn(out, ref_reader(arr, 16), False, True, head)
    return out.getvalue()


def port_encode(arr, bps, signed, block_size, device="cpu"):
    out = io.BytesIO()
    shn.encode_shn(out, pcm.reader_from_array(arr, bps), False, signed,
                   HEADER, FOOTER, block_size, device=device)
    return out.getvalue()


@pytest.mark.parametrize("nch,bps,signed,n,block", CASES)
def test_decisions_match_reference(nch, bps, signed, n, block):
    """the full blocks against analyze_blocks(np, ...) and the jitted
    analysis; the whole stream, the final partial block included,
    against the reference's _device_decisions"""
    arr = signal(nch, bps, n, seed=n)
    sa = 0 if signed else 1 << (bps - 1)
    nfull = n // block
    if nfull:
        blocks = arr[:nfull * block].reshape(nfull, block, nch)
        got = shn_scan.analyze_blocks(torch.as_tensor(blocks), sa).numpy()
        assert np.array_equal(got, ref_scan.analyze_blocks(np, blocks, sa))
        assert np.array_equal(got, ref_shn._analyze_jax(blocks, sa))
    got = shn_scan.stream_decisions(torch.as_tensor(arr), bps, signed, block)
    assert np.array_equal(got.numpy(), ref_shn._device_decisions(
        arr, bps, signed, block))


def test_analysis_warm_up_input():
    """prev3_in seeds block 0's history, as in the reference"""
    rng = np.random.default_rng(3)
    blocks = rng.integers(-3000, 3000, (4, 97, 2)).astype(np.int32)
    blocks[1] = 0
    blocks[2] <<= 3
    prev3 = rng.integers(-500, 500, (3, 2)).astype(np.int32)
    got = shn_scan.analyze_blocks(torch.as_tensor(blocks), 0,
                                  prev3_in=torch.as_tensor(prev3))
    assert np.array_equal(got.numpy(), ref_scan.analyze_blocks(
        np, blocks, 0, prev3_in=prev3))


@pytest.mark.parametrize("nch,bps,signed,n,block", CASES)
def test_encode_matches_reference(nch, bps, signed, n, block, monkeypatch):
    arr = signal(nch, bps, n, seed=n + 1)
    got = port_encode(arr, bps, signed, block)
    assert got == reference_encode(arr, bps, signed, block, "native",
                                   monkeypatch)
    assert got == reference_encode(arr, bps, signed, block, "jax",
                                   monkeypatch)
    assert got == _native.shn_encode(arr, bps, signed, False, HEADER, FOOTER,
                                     block)


@pytest.mark.parametrize("nch,bps", [(1, 16), (2, 16), (2, 8), (3, 16)])
@pytest.mark.parametrize("known_length", [False, True])
def test_write_shn_matches_from_pcm(tmp_path, nch, bps, known_length):
    arr = signal(nch, bps, 3000 + 7 * nch, seed=bps + nch)
    path = str(tmp_path / "ref.shn")
    ShortenAudio.from_pcm(path, ref_reader(arr, bps, 48000),
                          total_pcm_frames=arr.shape[0] if known_length
                          else None)
    with open(path, "rb") as f:
        want = f.read()
    out = io.BytesIO()
    shn_format.write_shn(out, pcm.reader_from_array(arr, bps, 48000),
                         total_pcm_frames=arr.shape[0] if known_length
                         else None, device="cpu")
    assert out.getvalue() == want
    dec = shn.TorchSHNDecoder(io.BytesIO(want), device="cpu")
    assert (dec.sample_rate, dec.channel_mask, dec.bits_per_sample,
            dec.signed_samples) == (48000, pcm.CHANNEL_MASKS[nch], bps,
                                    bps != 8)


def test_write_shn_checks():
    arr = signal(1, 16, 1000, seed=2)
    with pytest.raises(ValueError, match="mismatch"):
        shn_format.write_shn(io.BytesIO(), pcm.reader_from_array(arr, 16),
                             total_pcm_frames=999, device="cpu")
    with pytest.raises(ValueError, match="8- or 16-bit"):
        shn_format.write_shn(io.BytesIO(), pcm.reader_from_array(arr, 24),
                             device="cpu")


def test_build_fmt_matches_reference():
    from audiotools_tpu.formats import wav as ref_wav
    from audiotools_tpu_torch.formats import wav
    for args in ((1, 44100, 16, 0x4), (2, 48000, 8, 0x3),
                 (3, 96000, 16, 0x7), (6, 44100, 24, 0x3F)):
        assert wav.build_fmt(*args) == ref_wav.build_fmt(*args)


@pytest.mark.parametrize("nch,bps,signed,n,block", CASES)
def test_warm_chain_and_synthesis_match_reference(nch, bps, signed, n, block,
                                                  monkeypatch):
    arr = signal(nch, bps, n, seed=n + 2)
    data = reference_encode(arr, bps, signed, block, "native", monkeypatch)
    (res, row_meta, info) = _native.shn_scan(data)
    (ref_res, ref_meta, ref_info) = ref_native.shn_scan(data)
    assert np.array_equal(res, ref_res) and np.array_equal(row_meta, ref_meta)
    assert info == ref_info
    warm = _native.shn_warm_chain(res, row_meta, nch)
    assert np.array_equal(warm, ref_synth.warmup_chain(res, row_meta, nch))
    got = shn_synth.synthesize(
        torch.as_tensor(res), torch.as_tensor(row_meta[:, 0]),
        torch.as_tensor(warm), torch.as_tensor(row_meta[:, 2]),
        info["sign_adjustment"])
    want = ref_synth.synthesize(np, res, row_meta[:, 0], warm,
                                row_meta[:, 2], info["sign_adjustment"])
    assert np.array_equal(got.numpy(), want)


def test_warm_chain_rejects_bad_rows():
    res = np.zeros((2, 4), dtype=np.int32)
    meta = np.array([[1, 4, 0, 0], [1, 4, 0, 2]], dtype=np.int32)
    with pytest.raises(ValueError, match="out of range"):
        _native.shn_warm_chain(res, meta, 2)
    meta[1] = [1, 5, 0, 1]
    with pytest.raises(ValueError, match="out of range"):
        _native.shn_warm_chain(res, meta, 2)


@pytest.mark.parametrize("nch,bps,signed,n,block", CASES)
def test_decode_matches_reference(nch, bps, signed, n, block, monkeypatch):
    arr = signal(nch, bps, n, seed=n + 3)
    data = reference_encode(arr, bps, signed, block, "native", monkeypatch)
    (host, _ftype, _bps) = ref_native.shn_decode(data, n + 1024, nch)
    assert np.array_equal(host, arr) or block < 3
    got = shn.decode_shn(data, device="cpu")
    assert np.array_equal(got, host)
    assert np.array_equal(ref_shn._decode_jax(data), host)
    dec = shn.TorchSHNDecoder(io.BytesIO(data), device="cpu")
    dec.seek(0)
    assert not dec.host_fallback
    assert dec.timings["scan"] > 0


def test_interleave_drops_an_incomplete_channel_set():
    """rows of channel 0 past the last whole set are dropped, and a
    row's frames start where the channel's earlier rows end"""
    planes = torch.arange(5 * 4, dtype=torch.int32).view(5, 4)
    lens = torch.tensor([4, 4, 3, 3, 2], dtype=torch.int32)
    chan = torch.tensor([0, 1, 0, 1, 0], dtype=torch.int32)
    got = shn_synth.interleave(planes, lens, chan, 2, 7)
    want = np.array([[0, 4], [1, 5], [2, 6], [3, 7], [8, 12], [9, 13],
                     [10, 14]], dtype=np.int32)
    assert np.array_equal(got.numpy(), want)


def test_reader_read_and_seek(monkeypatch):
    arr = signal(2, 16, 4096 + 333, seed=9)
    data = reference_encode(arr, 16, True, 256, "native", monkeypatch)
    for dec in (shn.TorchSHNDecoder(io.BytesIO(data), device="cpu"),
                shn.FastSHNDecoder(io.BytesIO(data))):
        pieces = []
        while True:
            framelist = dec.read(1000)
            if framelist.frames == 0:
                break
            assert framelist.frames <= 1000
            pieces.append(framelist.samples)
        assert np.array_equal(np.concatenate(pieces), arr)
        for target in (1234, 0, 10 ** 9, -5):
            pos = dec.seek(target)
            assert pos == max(min(target, arr.shape[0]), 0)
            assert np.array_equal(dec.read(100).samples, arr[pos:pos + 100])
        dec.close()
        with pytest.raises(ValueError, match="closed"):
            dec.read(10)


def test_stream_parameters_match_the_reference_decoder(monkeypatch):
    """sample rate and channel mask from an embedded WAVE fmt chunk
    (plain and extensible), an AIFF COMM chunk, or neither"""
    from audiotools_tpu.formats.aiff import build_ieee_extended
    from audiotools_tpu.formats.wav import build_fmt
    from audiotools_tpu.ref.shn import SHNDecoder

    def riff(fmt):
        return (b"RIFF" + struct.pack("<I", 4 + 8 + len(fmt) + 8) + b"WAVE" +
                b"fmt " + struct.pack("<I", len(fmt)) + fmt + b"data" +
                struct.pack("<I", 0))

    comm = struct.pack(">HIH", 2, 100, 16) + build_ieee_extended(22050)
    heads = [riff(build_fmt(2, 32000, 16, 0x3)),
             riff(build_fmt(3, 88200, 16, 0x107)),
             riff(b"\x02\x00" + build_fmt(2, 8000, 16, 3)[2:]),
             b"FORM" + struct.pack(">I", 4 + 8 + len(comm)) + b"AIFF" +
             b"COMM" + struct.pack(">I", len(comm)) + comm,
             b"not a container header"]
    for (k, head) in enumerate(heads):
        nch = 3 if k == 1 else 2
        arr = signal(nch, 16, 600, seed=k)
        data = reference_encode_head(arr, head, monkeypatch)
        ref = SHNDecoder(io.BytesIO(data))
        dec = shn.TorchSHNDecoder(io.BytesIO(data), device="cpu")
        assert (dec.sample_rate, dec.channel_mask) == (
            ref.sample_rate, int(ref.channel_mask))


def qlpc_stream():
    """the QLPC stream of tests/test_shn_dec_jax.py"""
    from audiotools_tpu.bitstream import BitstreamWriter
    out = io.BytesIO()
    w = BitstreamWriter(out, False)

    def unsigned(c, v):
        w.unary(1, v >> c)
        w.write(c, v & ((1 << c) - 1))

    def long_(v):
        unsigned(2, 2)
        unsigned(2, v)

    w.write_bytes(b"ajkg")
    w.write(8, 2)
    for v in (2, 1, 3, 3, 0, 0):    # type, channels, block, LPC, means, skip
        long_(v)
    unsigned(2, 7)                  # FN_QLPC
    unsigned(3, 0)                  # energy
    unsigned(2, 0)                  # lpc_count 0
    for _ in range(3):
        unsigned(1, 0)
    unsigned(2, 4)                  # FN_QUIT
    w.byte_align()
    w.flush()
    return out.getvalue()


def test_qlpc_stream_takes_the_host_route():
    data = qlpc_stream()
    with pytest.raises(_native.ShnDeviceUnsupported):
        _native.shn_scan(data)
    assert ref_shn._decode_jax(data) is None
    dec = shn.TorchSHNDecoder(io.BytesIO(data), device="cpu")
    got = dec.read(100).samples
    assert dec.host_fallback
    (want, _ftype, _bps) = ref_native.shn_decode(data, 1024, 1)
    assert np.array_equal(got, want)


def test_split_and_header_match_the_reference(monkeypatch):
    arr = signal(2, 16, 1000, seed=5)
    data = reference_encode(arr, 16, True, 256, "native", monkeypatch)
    assert _native.shn_split(data) == ref_native.shn_split(data)
    assert _native.shn_split(data) == (HEADER, FOOTER)
    assert _native.shn_header(data) == dict(
        file_type=5, channels=2, block_size=256, max_lpc=0, n_means=0,
        head=HEADER)
    long_head = bytes(range(256)) * 300
    long_data = reference_encode_head(arr, long_head, monkeypatch)
    assert _native.shn_header(long_data)["head"] == long_head
    assert _native.shn_header(qlpc_stream())["head"] == b""
    with pytest.raises(ValueError, match="Shorten"):
        _native.shn_header(b"RIFF" + data[4:])


def test_cuda_request_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    arr = signal(1, 16, 100, seed=1)
    with pytest.raises(RuntimeError, match="cuda"):
        shn.encode_shn(io.BytesIO(), pcm.reader_from_array(arr, 16), False,
                       True, HEADER)
    with pytest.raises(RuntimeError, match="cuda"):
        shn.TorchSHNDecoder(io.BytesIO(port_encode(arr, 16, True, 256)))


@pytest.mark.cuda
@pytest.mark.parametrize("nch,bps,signed,n,block", CASES)
def test_cuda_encode_decode_match_reference(nch, bps, signed, n, block,
                                            monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    arr = signal(nch, bps, n, seed=n + 4)
    data = port_encode(arr, bps, signed, block, device="cuda")
    assert data == reference_encode(arr, bps, signed, block, "native",
                                    monkeypatch)
    dec = shn.TorchSHNDecoder(io.BytesIO(data), device="cuda")
    dec.seek(0)
    assert not dec.host_fallback
    (host, _ftype, _bps) = ref_native.shn_decode(data, n + 1024, nch)
    assert np.array_equal(dec.decoded, host)
    assert np.array_equal(host, arr) or block < 3
