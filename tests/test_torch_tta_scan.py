"""The port's TTA encode analysis on the CPU, held exactly to the
reference: ``correlate``, ``fixed_predict``, ``hybrid_filter_plain``
and ``analyze_frames`` against the reference's numpy forms and its
jitted analysis, for 8/16/24 bits and 1-3 channels, the filter also on
full-range lanes that wrap; the bytes of ``codecs.tta.encode_tta`` and
``formats.tta.write_tta`` with device="cpu" against the reference's
encoder (all-host and device backends) and writer.  The streams are 8
kHz (8,359-sample frames), which keeps the plain per-sample loop
short.  On a card the kernel equals its plain version, at the tile
edges too, and the card's encode gives the reference's bytes."""

import io

import numpy as np
import pytest
import torch

from audiotools_tpu import pcm as ref_pcm
from audiotools_tpu.codecs import tta as ref_tta
from audiotools_tpu.formats.tta import TrueAudio
from audiotools_tpu.ops import tta_scan as ref_scan
from audiotools_tpu.pcmstream import PCMReader
from audiotools_tpu_torch import _native, pcm
from audiotools_tpu_torch.codecs import tta
from audiotools_tpu_torch.formats import tta as tta_format
from audiotools_tpu_torch.ops import tta_scan

torch.set_num_threads(1)

RATE = 8000
FRAME = 8359


def signal(channels, bps, n, seed, loud=False):
    """tones and noise at an eighth of full scale, or near full scale
    (``loud``).  A loud short frame overflows the reference's host
    encoder's buffer, so only the port encodes those."""
    rng = np.random.default_rng(seed)
    t = np.arange(n)
    amp = 1 << (bps - (2 if loud else 3))
    noise = amp // (4 if loud else 16)
    x = np.stack([amp * np.sin(2 * np.pi * (300 + 70 * c) * t / RATE)
                  + rng.integers(-noise, noise + 1, n)
                  for c in range(channels)], axis=1)
    return np.clip(x, -(1 << (bps - 1)), (1 << (bps - 1)) - 1).astype(
        np.int32)


def batch(channels, bps, seed, frames=2, n=300):
    """int32 [frames, n, ch] of near full-scale PCM, a silent stretch
    and the extremes"""
    arr = signal(channels, bps, frames * n, seed, loud=True).reshape(
        frames, n, channels)
    arr[0, 40:60] = 0
    arr[-1, 100:110] = -(1 << (bps - 1))
    arr[-1, 110:120] = (1 << (bps - 1)) - 1
    return arr


def ref_reader(arr, bps, rate=RATE):
    data = ref_pcm.FrameList._wrap(arr, bps).to_bytes(False, True)
    return PCMReader(io.BytesIO(data), rate, arr.shape[1], 0, bps)


STREAMS = [(c, b) for b in (8, 16, 24) for c in (1, 2, 3)]


@pytest.mark.parametrize("channels,bps", STREAMS)
def test_correlate_and_fixed_predict_match_reference(channels, bps):
    arr = batch(channels, bps, seed=channels * bps)
    correlated = tta_scan.correlate(torch.as_tensor(arr))
    ref_correlated = ref_scan.correlate(np, arr)
    assert np.array_equal(correlated.numpy(), ref_correlated)
    predicted = tta_scan.fixed_predict(correlated, bps)
    assert np.array_equal(predicted.numpy(),
                          ref_scan.fixed_predict(np, ref_correlated, bps))


@pytest.mark.parametrize("bps", [8, 16, 24])
def test_hybrid_filter_plain_matches_reference(bps):
    """signal-shaped lanes, and full-range int32 lanes on which every
    sum of the filter wraps"""
    rng = np.random.default_rng(bps)
    arr = batch(2, bps, seed=bps)
    lanes = np.ascontiguousarray(np.swapaxes(arr, 1, 2).reshape(4, -1))
    wild = rng.integers(-2 ** 31, 2 ** 31, (3, 200)).astype(np.int32)
    for x in (lanes, wild):
        got = tta_scan.hybrid_filter_plain(torch.as_tensor(x), bps)
        assert np.array_equal(got.numpy(), ref_scan.hybrid_filter(np, x, bps))
        # on a CPU tensor the wrapper is the plain version, no launch
        before = tta_scan.hybrid_filter.launches
        assert torch.equal(tta_scan.hybrid_filter(torch.as_tensor(x), bps),
                           got)
        assert tta_scan.hybrid_filter.launches == before


@pytest.mark.parametrize("channels,bps", STREAMS)
def test_analyze_frames_matches_reference(channels, bps):
    arr = batch(channels, bps, seed=10 + channels * bps)
    got = tta_scan.analyze_frames(torch.as_tensor(arr), bps).numpy()
    assert np.array_equal(got, ref_scan.analyze_frames(np, arr, bps))
    assert np.array_equal(got, ref_tta._analyze_jax(arr, bps))


def test_argument_checks():
    x = torch.zeros((2, 8), dtype=torch.int32)
    with pytest.raises(ValueError, match="2-D"):
        tta_scan.hybrid_filter(x[0], 16)
    with pytest.raises(TypeError, match="int32"):
        tta_scan.hybrid_filter(x.to(torch.int64), 16)
    with pytest.raises(ValueError, match="unsupported"):
        tta_scan.hybrid_filter(x, 20)
    with pytest.raises(ValueError, match="unsupported device"):
        tta_scan.hybrid_filter(x.to("meta"), 16)


def reference_frames(arr, bps, backend, monkeypatch):
    """the reference encoder's frame bytes and lengths"""
    monkeypatch.setenv("ATPU_TTA_BACKEND", backend)
    out = io.BytesIO()
    sizes = ref_tta.encode_tta(out, ref_reader(arr, bps))
    return (out.getvalue(), sizes)


@pytest.mark.parametrize("channels,bps", [(1, 16), (2, 24), (2, 8), (3, 16)])
def test_encode_matches_reference(channels, bps, monkeypatch):
    arr = signal(channels, bps, 2 * FRAME + 1234, seed=channels + bps)
    out = io.BytesIO()
    sizes = tta.encode_tta(out, pcm.reader_from_array(arr, bps, RATE),
                           device="cpu")
    for backend in ("native", "jax"):
        assert (out.getvalue(), sizes) == reference_frames(
            arr, bps, backend, monkeypatch)
    (data, lens) = _native.tta_encode_frames(
        arr, np.array([FRAME, FRAME, 1234], dtype=np.int32), channels, bps)
    assert (out.getvalue(), sizes) == (data, list(lens))


def test_loud_short_frame():
    """a near full-scale 24-bit stream whose last frame is 99 samples:
    that frame's codes pass the bps / 8 + 2 bytes a sample that the
    reference's host encoder allots (it writes past its buffer); the
    port's writers grow theirs.  The frames equal the reference's
    scalar oracle's and decode back."""
    from audiotools_tpu.ref import tta as ref_oracle
    arr = signal(2, 24, FRAME + 99, seed=3, loud=True)
    out = io.BytesIO()
    sizes = tta.encode_tta(out, pcm.reader_from_array(arr, 24, RATE),
                           device="cpu")
    assert sizes[1] > 99 * 2 * (24 // 8 + 2) + 64 + 1024
    (data, lens) = _native.tta_encode_frames(
        arr, np.array([FRAME, 99], dtype=np.int32), 2, 24)
    assert (out.getvalue(), sizes) == (data, list(lens))
    want = io.BytesIO()
    assert ref_oracle.encode_tta(want, ref_reader(arr[FRAME:], 24)) == [
        sizes[1]]
    assert out.getvalue()[sizes[0]:] == want.getvalue()
    whole = io.BytesIO()
    tta_format.write_tta(whole, pcm.reader_from_array(arr, 24, RATE),
                         device="cpu")
    assert np.array_equal(tta.decode_tta(whole.getvalue(), device="cpu"),
                          arr)


def test_output_does_not_depend_on_the_batch(monkeypatch):
    """5 frames in batches of 2: the last batch holds the short frame"""
    monkeypatch.setattr(tta, "ENC_BATCH_FRAMES", 2)
    arr = signal(2, 16, 4 * FRAME + 77, seed=4)
    out = io.BytesIO()
    timings = {}
    sizes = tta.encode_tta(out, pcm.reader_from_array(arr, 16, RATE),
                           device="cpu", timings=timings)
    assert len(sizes) == 5
    assert sorted(timings) == sorted(tta.ENCODE_STAGES)
    (data, lens) = _native.tta_encode_frames(
        arr, np.array([FRAME] * 4 + [77], dtype=np.int32), 2, 16)
    assert (out.getvalue(), sizes) == (data, list(lens))


@pytest.mark.parametrize("known_length", [False, True])
def test_write_tta_matches_reference(tmp_path, known_length):
    arr = signal(2, 16, FRAME + 500, seed=6)
    path = str(tmp_path / "ref.tta")
    TrueAudio.from_pcm(path, ref_reader(arr, 16))
    with open(path, "rb") as f:
        want = f.read()
    out = io.BytesIO()
    tta_format.write_tta(out, pcm.reader_from_array(arr, 16, RATE),
                         total_pcm_frames=arr.shape[0] if known_length
                         else None, device="cpu")
    assert out.getvalue() == want


def test_cuda_request_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    arr = signal(1, 16, 100, seed=1)
    with pytest.raises(RuntimeError, match="cuda"):
        tta.encode_tta(io.BytesIO(), pcm.reader_from_array(arr, 16, RATE))


def wrap32(v):
    """int64 values read as int32 (mod 2^32)"""
    return ((v + (1 << 31)) & 0xffffffff) - (1 << 31)


def later(a, k, at_minus_1=0):
    """[L, n] values of the steps moved k steps later: column i holds
    step i - k; step -1 reads ``at_minus_1``, earlier steps 0"""
    out = np.zeros_like(a)
    if k <= a.shape[1]:
        out[:, k:] = a[:, :a.shape[1] - k]
        out[:, k - 1] = at_minus_1
    return out


def lookahead_filter(x, bps):
    """csrc/tta_filter.cu's split of the hybrid filter, in numpy int64
    masked to 32 bits.  DL(i), DX(i) (dl, dx before step i's rotation),
    b(i) = DL(i) . DX(i) and c(i) = DL(i) . DX(i-1) come from the inputs
    alone, for every step at once; the loop carries only qm and the
    residuals' signs:
      acc(i) = a'(i) + sgn(i-1) c(i) + sgn(i) b(i),
      a'(i) = round + DL(i) . QM(i-2),
    with sgn(i) the sign of res[i-1] and QM(i) qm after step i's
    update."""
    fshift = ref_scan.filter_shift_for(bps)
    round_v = 1 << (fshift - 1)
    p = x.astype(np.int64)
    (L, n) = p.shape
    d7 = wrap32(p - later(p, 1))
    d6 = wrap32(d7 - later(d7, 1))
    d5 = wrap32(d6 - later(d6, 1))
    (g4, g5, g6, g7) = (np.where(v >= 0, m, -m) for (v, m) in
                        ((d5, 1), (d6, 2), (d7, 2), (p, 4)))
    dl = np.stack([later(d5, 5), later(d5, 4), later(d5, 3), later(d5, 2),
                   later(d5, 1), later(d6, 1), later(d7, 1), later(p, 1)],
                  axis=-1)
    # dx's signs come from dl two steps back; those dx takes at step 1
    # read the zero dl of step -1 (+m), those of earlier steps are 0
    dx = np.stack([later(g4, 6, 1), later(g4, 5, 1), later(g4, 4, 1),
                   later(g4, 3, 1), later(g4, 2, 1), later(g5, 2, 2),
                   later(g6, 2, 2), later(g7, 2, 4)], axis=-1)
    dx_prev = np.zeros_like(dx)
    dx_prev[:, 1:] = dx[:, :-1]
    b = wrap32(wrap32(dl * dx).sum(axis=-1))
    c = wrap32(wrap32(dl * dx_prev).sum(axis=-1))
    qm = np.zeros((L, 8), dtype=np.int64)       # QM(i-2)
    (sg_prev, sg) = (np.zeros(L, dtype=np.int64),) * 2
    out = np.empty((L, n), dtype=np.int32)
    for i in range(n):
        e = wrap32(round_v + wrap32(dl[:, i] * qm).sum(axis=-1) +
                   sg_prev * c[:, i])
        qm = wrap32(qm + sg_prev[:, None] * dx_prev[:, i])
        res = wrap32(p[:, i] - (wrap32(e + sg * b[:, i]) >> fshift))
        (sg_prev, sg) = (sg, np.sign(res))
        out[:, i] = res
    return out


@pytest.mark.parametrize("bps", [8, 16, 24])
def test_lookahead_split_matches_reference(bps):
    """the kernel's look-ahead algebra equals the reference's numpy
    filter on full-range lanes (every product and sum wraps), lanes of
    the stream's own width and signal-shaped lanes, from 1 to 300
    steps"""
    rng = np.random.default_rng(100 + bps)
    arr = batch(2, bps, seed=bps)
    signal_lanes = np.ascontiguousarray(
        np.swapaxes(arr, 1, 2).reshape(4, -1))
    for x in [signal_lanes] + [
            rng.integers(-2 ** 31, 2 ** 31, (6, n)).astype(np.int32)
            for n in (1, 2, 7, 9, 300)]:
        x[3:5] >>= 32 - bps
        assert np.array_equal(lookahead_filter(x, bps),
                              ref_scan.hybrid_filter(np, x, bps))


@pytest.mark.cuda
@pytest.mark.parametrize("bps", [8, 16, 24])
@pytest.mark.parametrize("n", [1, 7, 8, 9, 31, 32, 33, 63, 64, 65, 95, 97,
                               100, 1000])
def test_cuda_kernel_matches_plain(bps, n):
    """1, 31, 33 and 45 lanes (partial warps) of full-range values
    (lanes 20 on), n at the edges of the 8-step unroll and of the tiles
    and hand-off stages; an offset view (rows not 16-byte aligned) takes
    the 4-byte copies"""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    rng = np.random.default_rng(n + bps)
    x = rng.integers(-2 ** 31, 2 ** 31, (45, n + 1)).astype(np.int32)
    x[:20] >>= 32 - bps
    dev = torch.device("cuda")
    for count in (1, 31, 33, 45):
        offset = torch.as_tensor(x[:count], device=dev).reshape(-1)[
            1:1 + count * n].view(count, n)
        for lanes in (torch.as_tensor(x[:count, :n].copy(), device=dev),
                      torch.as_tensor(x[:count], device=dev)[:, 1:]
                      .contiguous(), offset):
            before = tta_scan.hybrid_filter.launches
            got = tta_scan.hybrid_filter(lanes, bps)
            torch.cuda.synchronize()
            assert tta_scan.hybrid_filter.launches == before + 1
            assert torch.equal(got.cpu(), tta_scan.hybrid_filter_plain(
                lanes.cpu(), bps))


@pytest.mark.cuda
@pytest.mark.parametrize("channels,bps", [(1, 16), (2, 24), (2, 8), (3, 16)])
def test_cuda_encode_matches_reference(channels, bps, monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    arr = signal(channels, bps, 5 * FRAME + 1234, seed=20 + channels)
    out = io.BytesIO()
    before = tta_scan.hybrid_filter.launches
    sizes = tta.encode_tta(out, pcm.reader_from_array(arr, bps, RATE),
                           device="cuda")
    assert tta_scan.hybrid_filter.launches > before
    assert (out.getvalue(), sizes) == reference_frames(arr, bps, "native",
                                                       monkeypatch)
