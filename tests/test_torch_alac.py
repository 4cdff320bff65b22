"""The port's ALAC codec on the CPU: the mdat bytes and frame sizes of
``codecs.alac_fast.encode_mdat_fast`` and the whole M4A file of
``formats.m4a.write_m4a`` equal the reference's (its numpy backend
with exact uploads, ``ATPU_ALAC_QPACK=0``); ``TorchALACDecoder``
equals the reference's host decoder (``FastALACDecoder``) and its
device decoder (``JaxALACDecoder``) on the signal matrix of the
reference's own decode tests, and seeks as the host decoder does.  On
a card the encode and the decode equal the reference's."""

import io
import struct

import numpy as np
import pytest
import torch

from audiotools_tpu.codecs.alac_fast import FastALACDecoder as RefHostDecoder
from audiotools_tpu.codecs.alac_fast import encode_mdat_fast as ref_encode
from audiotools_tpu_torch import pcm
from audiotools_tpu_torch.codecs import alac_dec, alac_fast
from audiotools_tpu_torch.formats import m4a
from test_alac_dec_jax import _drain, _m4a, _reader, _signals

torch.set_num_threads(1)

# the channel masks the reference's test readers give
MASKS = {1: 0x4, 2: 0x3, 4: 0x107, 6: 0x3F}


def port_reader(arr, bps):
    reader = pcm.reader_from_array(arr, bps)
    reader.channel_mask = MASKS[arr.shape[1]]
    return reader


def signal(kind, channels, bps, n, seed=3):
    rng = np.random.default_rng(seed)
    amp = 1 << (bps - 3)
    t = np.arange(n)
    if kind == "tone":
        x = np.stack([amp * np.sin(2 * np.pi * (330 + 110 * c) * t / 44100)
                      for c in range(channels)], axis=1)
        x = x + rng.integers(-amp // 64, amp // 64, (n, channels))
    else:
        x = rng.integers(-amp, amp, (n, channels))
    return x.astype(np.int32)


@pytest.fixture
def exact_uploads(monkeypatch):
    """the reference encoder on its numpy backend without the quantized
    analysis wire"""
    monkeypatch.setenv("ATPU_ALAC_QPACK", "0")
    monkeypatch.setenv("ATPU_ALAC_BACKEND", "numpy")


@pytest.mark.parametrize("kind,channels,bps,n", [
    ("tone", 2, 16, 4096 * 5 + 1234),
    ("noise", 2, 16, 4096 * 2),
    ("tone", 1, 16, 3000),
    ("tone", 2, 24, 4096 * 2 + 7),
    ("noise", 4, 16, 4096 + 100),
    ("tone", 6, 24, 4096 + 1),
])
def test_mdat_matches_reference(exact_uploads, kind, channels, bps, n):
    arr = signal(kind, channels, bps, n)
    want = io.BytesIO()
    (want_sizes, want_frames) = ref_encode(want, _reader(arr, bps),
                                           backend="numpy")
    got = io.BytesIO()
    (sizes, frames) = alac_fast.encode_mdat_fast(
        got, port_reader(arr, bps), device="cpu", batch_frames=2)
    assert got.getvalue() == want.getvalue()
    assert (sizes, frames) == (want_sizes, want_frames)


def test_batch_size_does_not_change_the_bytes():
    arr = signal("tone", 2, 16, 4096 * 5 + 17)
    outs = []
    for batch_frames in (1, 3, 1024):
        out = io.BytesIO()
        alac_fast.encode_mdat_fast(out, port_reader(arr, 16), device="cpu",
                                   batch_frames=batch_frames)
        outs.append(out.getvalue())
    assert outs[0] == outs[1] == outs[2]


@pytest.mark.parametrize("channels,bps", [(2, 16), (1, 24)])
def test_m4a_file_matches_reference(exact_uploads, monkeypatch, tmp_path,
                                    channels, bps):
    """the whole file, with the creation time pinned"""
    from audiotools_tpu.formats import m4a as ref_m4a
    now = 1700000000
    monkeypatch.setattr(ref_m4a.time, "time", lambda: float(now))
    arr = signal("tone", channels, bps, 4096 * 6 + 333)
    path = str(tmp_path / "ref.m4a")
    ref_m4a.ALACAudio.from_pcm(path, _reader(arr, bps))
    out = io.BytesIO()
    m4a.write_m4a(out, port_reader(arr, bps), device="cpu",
                  create_date=now + m4a.QUICKTIME_EPOCH_OFFSET)
    with open(path, "rb") as f:
        assert out.getvalue() == f.read()


def test_m4a_writer_refuses_what_alac_cannot_carry():
    arr = signal("tone", 2, 16, 100)
    with pytest.raises(ValueError, match="bits per sample"):
        m4a.write_m4a(io.BytesIO(), pcm.reader_from_array(arr, 8),
                      device="cpu")
    reader = pcm.reader_from_array(np.zeros((10, 4), np.int32), 16)
    reader.channel_mask = 0x33
    with pytest.raises(ValueError, match="channel mask"):
        m4a.write_m4a(io.BytesIO(), reader, device="cpu")


def reference_file(tmp_path, arr, bps, name):
    """an M4A file written by the reference (its default quantized
    analysis, numpy backend)"""
    return _m4a(tmp_path, arr, bps, name=name)


def signal_matrix():
    sig16 = _signals()
    rng = np.random.default_rng(5)
    return {
        "tone": (sig16["tone"], 16),
        "noise": (sig16["noise"], 16),
        "mixed": (sig16["mixed"], 16),
        "mono": (sig16["mono"], 16),
        "24bit": (_signals(24)["tone"], 24),
        "4ch": (rng.integers(-8000, 8000, (22050, 4)).astype(np.int32), 16),
    }


@pytest.mark.parametrize("name", ["tone", "noise", "mixed", "mono", "24bit",
                                  "4ch"])
def test_decoder_matches_reference_decoders(monkeypatch, tmp_path, name):
    from audiotools_tpu.codecs.alac_dec_jax import JaxALACDecoder
    monkeypatch.setenv("ATPU_ALAC_BACKEND", "numpy")
    (arr, bps) = signal_matrix()[name]
    path = reference_file(tmp_path, arr, bps, name + ".m4a")
    host = _drain(RefHostDecoder(path))
    assert np.array_equal(host, arr)
    before = alac_dec.host_chunks
    got = _drain(alac_dec.TorchALACDecoder(path, device="cpu"))
    assert alac_dec.host_chunks == before
    assert np.array_equal(got, host)
    assert np.array_equal(_drain(JaxALACDecoder(path)), got)
    # the port's own host decoder
    assert np.array_equal(_drain(alac_fast.FastALACDecoder(path)), host)


def test_seek(tmp_path):
    arr = signal("tone", 2, 16, 4096 * 5 + 99)
    path = str(tmp_path / "seek.m4a")
    m4a.write_m4a(path, port_reader(arr, 16), device="cpu")
    for cls in (alac_fast.FastALACDecoder, alac_dec.TorchALACDecoder):
        args = {} if cls is alac_fast.FastALACDecoder else {"device": "cpu"}
        dec = cls(path, **args)
        ref = RefHostDecoder(path)
        for target in (0, 9000, 4096 * 3, 10 ** 9):
            pos = dec.seek(target)
            assert pos == ref.seek(target)
            got = dec.read(5000).samples
            assert got.shape[0] > 0
            assert np.array_equal(got, arr[pos:pos + got.shape[0]])
        dec.close()
        ref.close()


def test_reads_never_exceed_the_request(tmp_path):
    arr = signal("noise", 2, 16, 4096 * 3 + 5)
    out = io.BytesIO()
    m4a.write_m4a(out, port_reader(arr, 16), device="cpu")
    dec = alac_dec.TorchALACDecoder(io.BytesIO(out.getvalue()), device="cpu")
    pieces = []
    while True:
        framelist = dec.read(1000)
        assert framelist.frames <= 1000
        if framelist.frames == 0:
            break
        pieces.append(framelist.samples)
    assert np.array_equal(np.concatenate(pieces), arr)


def test_host_route_is_counted(monkeypatch):
    """a batch with an order above the device path's limit goes to the
    host decoder and is counted (here the limit is lowered to 3, below
    the encoder's orders 4 and 8)"""
    arr = signal("tone", 2, 16, 4096 * 2)
    out = io.BytesIO()
    m4a.write_m4a(out, port_reader(arr, 16), device="cpu")
    monkeypatch.setattr(alac_dec, "MAX_ORDER", 3)
    before = alac_dec.host_chunks
    got = alac_dec.decode_alac(out.getvalue(), device="cpu")
    assert alac_dec.host_chunks > before
    assert np.array_equal(got, arr)


@pytest.mark.parametrize("mdhd_version", [0, 1])
def test_header_parse_matches_reference(monkeypatch, tmp_path,
                                        mdhd_version):
    """the atom walk gives the reference oracle's header fields and its
    stsz table, for both mdhd versions"""
    from audiotools_tpu.ref.alac import ALACDecoder
    from audiotools_tpu_torch.ref.alac import read_m4a_header
    if mdhd_version == 1:
        def mdhd_v1(pcmreader, create_date, total_pcm_frames):
            return m4a.M4A_Leaf_Atom(b"mdhd", struct.pack(
                ">B3xQQIQHH", 1, create_date, create_date,
                pcmreader.sample_rate, total_pcm_frames, 0x55C4, 0))
        monkeypatch.setattr(m4a, "mdhd_atom", mdhd_v1)
    arr = signal("tone", 2, 16, 4096 * 3 + 5)
    path = str(tmp_path / "header.m4a")
    m4a.write_m4a(path, port_reader(arr, 16), device="cpu")
    with open(path, "rb") as f:
        header = read_m4a_header(f)
    ref = ALACDecoder(open(path, "rb"))
    for key in ("samples_per_frame", "bits_per_sample",
                "history_multiplier", "initial_history", "maximum_k",
                "channels", "sample_rate", "channel_mask",
                "total_pcm_frames"):
        assert header[key] == getattr(ref, key), key
    ref.close()
    assert header["frame_sizes"] == RefHostDecoder(path)._read_frame_sizes()
    assert np.array_equal(_drain(alac_fast.FastALACDecoder(path)), arr)


def test_native_scan_matches_the_reference(tmp_path):
    """the port's copy of the C++ scan and decoder give the reference's
    arrays on a 24-bit stereo stream with low bytes"""
    from audiotools_tpu import _native as ref_native
    from audiotools_tpu_torch import _native
    from audiotools_tpu_torch.ref.alac import read_m4a_header
    arr = signal("tone", 2, 24, 4096 * 2 + 9)
    out = io.BytesIO()
    m4a.write_m4a(out, port_reader(arr, 24), device="cpu")
    data = out.getvalue()
    frames = data[read_m4a_header(io.BytesIO(data))["mdat_offset"]:]
    args = (frames, 24, 2, 4096, 10, 40, 14)
    scan = _native.alac_scan(*args, 4096 * 3, 8)
    want = ref_native.alac_scan(*args, 4096 * 3, 8)
    assert sorted(scan) == sorted(want)
    for key in scan:
        assert np.array_equal(scan[key], want[key]), key
    (got, used) = _native.alac_decode(*args, arr.shape[0])
    assert np.array_equal(got, arr)
    assert used == ref_native.alac_decode(*args, arr.shape[0])[1]


def test_header_errors():
    with pytest.raises(ValueError):
        alac_dec.TorchALACDecoder(io.BytesIO(b"\x00" * 64), device="cpu")
    arr = signal("tone", 1, 16, 100)
    out = io.BytesIO()
    m4a.write_m4a(out, port_reader(arr, 16), device="cpu")
    data = bytearray(out.getvalue())
    data[data.index(b"alac") + 0] ^= 0xFF
    with pytest.raises(ValueError):
        alac_fast.FastALACDecoder(io.BytesIO(bytes(data)))


def test_cuda_request_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        alac_dec.TorchALACDecoder(io.BytesIO(b""), device="cuda")
    with pytest.raises(RuntimeError, match="cuda"):
        alac_fast.encode_mdat_fast(io.BytesIO(), port_reader(
            np.zeros((10, 2), np.int32), 16), device="cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["tone", "24bit", "4ch"])
def test_cuda_decode_matches_host_decoder(monkeypatch, tmp_path, name):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    monkeypatch.setenv("ATPU_ALAC_BACKEND", "numpy")
    (arr, bps) = signal_matrix()[name]
    path = reference_file(tmp_path, arr, bps, name + ".m4a")
    before = (alac_dec.host_chunks, alac_dec.alac_synth.synthesize.launches)
    got = _drain(alac_dec.TorchALACDecoder(path, device="cuda"))
    assert alac_dec.host_chunks == before[0]
    assert alac_dec.alac_synth.synthesize.launches > before[1]
    assert np.array_equal(got, _drain(RefHostDecoder(path)))


@pytest.mark.cuda
@pytest.mark.parametrize("channels,bps", [(2, 16), (1, 24), (6, 24)])
def test_cuda_encode_matches_reference(exact_uploads, channels, bps):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    arr = signal("tone", channels, bps, 4096 * 9 + 5)
    want = io.BytesIO()
    ref_encode(want, _reader(arr, bps), backend="numpy")
    got = io.BytesIO()
    alac_fast.encode_mdat_fast(got, port_reader(arr, bps), device="cuda",
                               batch_frames=4)
    assert got.getvalue() == want.getvalue()
