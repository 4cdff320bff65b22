"""The quantized upload wire of the PyTorch port on the CPU, against the
reference package.

The transport (``ops/qpack``: plan, quantize, sideband, the plain and
patched-base packs and ``unpack``; ``_native``'s C++ scans) equals the
reference's, word for word.  Under the reference's default environment
(no ``ATPU_*`` variable set) the port's FLAC encode writes the bytes of
the reference's ``backend="numpy"`` encode at levels 0-8, at bench.py's
options, through the quantization-floor retry and through an emit
overflow; its ALAC encode writes the reference's mdat, 16- and 24-bit.
``ATPU_DEVICE_RICE=exact`` gives the reference's bytes, the exact
ladder's bit-plane sums (``rice_planes``) equal the reference's stacked
form, and a batch split over ``["cpu", "cpu"]`` gives the one-device
bytes.  The reference and the port read the same environment, so each
case sets it once for both.
"""

import io
import os
import sys

import numpy as np
import pytest
import torch

from audiotools_tpu import _native as ref_native
from audiotools_tpu.codecs import alac_fast as ref_alac
from audiotools_tpu.codecs import flac_enc_fast as ref_flac
from audiotools_tpu.ops import qpack as ref_qpack
from audiotools_tpu.ref import alac as ref_alac_oracle
from audiotools_tpu_torch import _native
from audiotools_tpu_torch.codecs import alac_fast, flac_enc_fast
from audiotools_tpu_torch.formats.flac import FlacAudio
from audiotools_tpu_torch.ops import flac_frames, qpack
from audiotools_tpu_torch.pcm import reader_from_array
from audiotools_tpu_torch.ref import alac as port_alac_oracle
from test_torch_flac_enc import flac_decode_all, reader

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
import bench  # noqa: E402

SR = 44100
KNOBS = ("ATPU_FLAC_QPACK", "ATPU_ALAC_QPACK", "ATPU_QPACK_PATCH",
         "ATPU_QPACK_GUARD", "ATPU_QPACK_CAP", "ATPU_QPACK_NOISE_EXTRA",
         "ATPU_EMIT_EXACT_RICE", "ATPU_DEVICE_RICE", "ATPU_PALLAS",
         "ATPU_DEVICES", "ATPU_FLAC_BATCH", "ATPU_ALAC_BATCH")


@pytest.fixture(autouse=True)
def default_environment(monkeypatch):
    """no ATPU_* setting: the reference's defaults"""
    for key in KNOBS:
        monkeypatch.delenv(key, raising=False)


def program(n, seed=7):
    """bench.py's signal, int32 [n, 2]"""
    return bench.make_signal(n, seed)


def tones(n, bps=16, channels=2):
    """pure tones: the quantized analysis of such blocks is limited by
    its step, which the floor retry repairs"""
    t = np.arange(n)
    amp = 0.6 * (1 << (bps - 1))
    return np.stack([amp * np.sin(2 * np.pi * (1000 + 500 * c) * t / SR + c)
                     for c in range(channels)], axis=1).astype(np.int32)


def loud_and_quiet(n, seed=5):
    """blocks half loud noise and half quiet positive noise: the plan's
    step buries the quiet half, whose partitions the quantized analysis
    codes at Rice parameter 0"""
    rng = np.random.default_rng(seed)
    x = rng.integers(0, 2000, (n, 2))
    for b in range(0, n, 4096):
        x[b:b + 2048] = rng.integers(-30000, 30000, (min(2048, n - b), 2))
    return x.astype(np.int32)


def ref_flac_bytes(arr, bps, **opts):
    buf = io.BytesIO()
    ref_flac.encode_flac_fast(buf, reader(arr, bps), backend="numpy", **opts)
    return buf.getvalue()


def port_flac_bytes(arr, bps, device="cpu", **opts):
    buf = io.BytesIO()
    flac_enc_fast.encode_flac_fast(buf, reader_from_array(arr, bps),
                                   device=device, **opts)
    return buf.getvalue()


# ---- the transport ------------------------------------------------------

def plan_inputs(kind, bps, ch, B=5, n=512, seed=2):
    rng = np.random.default_rng(seed)
    t = np.arange(n)
    amp = 1 << (bps - 2)
    if kind == "noise":
        x = rng.integers(-amp, amp, (B, n, ch))
    else:
        x = np.stack([np.stack([(amp * np.sin(2 * np.pi * (200 + 90 * b +
                                                           40 * c) * t / SR))
                                + rng.integers(-64, 64, n)
                                for c in range(ch)], axis=1)
                      for b in range(B)])
    x = x.astype(np.int32)
    x[0] = 77                       # a constant block
    x[1, :, 0] <<= 3                # wasted bits on one channel
    return x


CASES = [("tone", 16, 2), ("noise", 16, 2), ("tone", 24, 1),
         ("noise", 24, 2), ("tone", 16, 6)]


@pytest.mark.parametrize("kind,bps,ch", CASES)
@pytest.mark.parametrize("knobs", [{}, {"guard": 1, "margin": 4, "extra": 0},
                                   {"guard": 0, "margin": 8, "extra": 3}])
def test_plan_t_matches_reference(kind, bps, ch, knobs):
    x = plan_inputs(kind, bps, ch)
    assert np.array_equal(qpack.plan_t(x, bps, **knobs),
                          ref_qpack.plan_t(x, bps, **knobs))


@pytest.mark.parametrize("kind,bps,ch", CASES)
def test_pack_matches_reference(kind, bps, ch):
    x = plan_inputs(kind, bps, ch)
    t = qpack.plan_t(x, bps)
    (got, k, x0) = qpack.pack(x, t)
    (want, k_ref, x0_ref) = ref_qpack.pack(x, t)
    assert (k, got.tolist(), x0.tolist()) == (k_ref, want.tolist(),
                                              x0_ref.tolist())
    assert np.array_equal(qpack.quantize(x, t), ref_qpack.quantize(np, x, t))
    for stereo in ((True, False) if ch == 2 else (False,)):
        for (a, b) in zip(qpack.variant_sideband(x, stereo),
                          ref_qpack.variant_sideband(x, stereo)):
            assert np.array_equal(a, b)


@pytest.mark.parametrize("kind,bps,ch", CASES)
@pytest.mark.parametrize("k_base,E", [(4, 8), (6, 32), (3, 128)])
def test_pack_patched_matches_reference(kind, bps, ch, k_base, E):
    x = plan_inputs(kind, bps, ch)
    t = qpack.plan_t(x, bps)
    got = qpack.pack_patched(x, t, k_base, E)
    want = ref_qpack.pack_patched(x, t, k_base, E)
    for (a, b) in zip(got, want):
        assert np.array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("kind,bps,ch", CASES)
@pytest.mark.parametrize("stereo", [True, False])
def test_native_scans_match_reference(kind, bps, ch, stereo):
    x = plan_inputs(kind, bps, ch)
    guard = 0
    (md5, ref_md5) = (_native.MD5(), ref_native.MD5())
    got = _native.flac_qpack(x, bps, guard, stereo, md5=md5)
    want = ref_native.flac_qpack(x, bps, guard, stereo, md5=ref_md5)
    for (a, b) in zip(got, want):
        assert np.array_equal(np.asarray(a), np.asarray(b))
    assert md5.digest() == ref_md5.digest()
    plain = _native.MD5()
    plain.update_pcm(x.reshape(-1, ch), bps)
    assert md5.digest() == plain.digest()
    # the scan's words are the numpy spec's
    assert np.array_equal(got[0], qpack.pack(x, got[2])[0])
    assert np.array_equal(got[2], qpack.plan_t(x, bps))
    for (k_base, E) in ((None, 8), (3, 128)):
        got = _native.flac_qpack_patched(x, bps, guard, stereo, k_base, E)
        want = ref_native.flac_qpack_patched(x, bps, guard, stereo, k_base,
                                             E)
        for (a, b) in zip(got, want):
            assert np.array_equal(np.asarray(a), np.asarray(b))
    assert np.array_equal(_native.flac_qplan_t(x, bps),
                          ref_native.flac_qplan_t(x, bps))
    assert np.array_equal(_native.flac_qplan_t(x, bps, noise_extra=2),
                          qpack.plan_t(x, bps, extra=2))


@pytest.mark.parametrize("kind,bps,ch", CASES)
def test_unpack_equals_quantize(kind, bps, ch):
    x = plan_inputs(kind, bps, ch)
    n = x.shape[1]
    t = qpack.plan_t(x, bps)
    want = qpack.quantize(x, t)
    (words, k, x0) = qpack.pack(x, t)
    got = qpack.unpack(torch.from_numpy(words.view(np.int32)), k,
                       torch.from_numpy(t), torch.from_numpy(x0), n)
    assert np.array_equal(got.numpy(), want)
    # the patched wire, with slots enough for every exception
    (words, pos, val, max_exc) = qpack.pack_patched(x, t, 2, 512)
    assert 0 < max_exc <= 512
    got = qpack.unpack(torch.from_numpy(words.view(np.int32)), 2,
                       torch.from_numpy(t), torch.from_numpy(x0), n,
                       torch.from_numpy(pos),
                       torch.from_numpy(val.view(np.int32)))
    assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("patched", [False, True])
def test_consolidated_wire_round_trip(patched):
    x = np.ascontiguousarray(program(8 * 512).reshape(8, 512, 2))
    x[0] = 5
    n = x.shape[1]
    if patched:
        (words, k_full, t, x0, orv, cf, pos, val, mexc, k) = \
            _native.flac_qpack_patched(x, 16, 0, True, None, 128)
        assert mexc <= 128
        (E, extra) = (128, (pos, val))
    else:
        (words, k, t, x0, orv, cf) = _native.flac_qpack(x, 16, 0, True)
        (E, extra) = (0, ())
    wire = qpack.assemble_wire(words, t, x0, orv, cf, *extra)
    W = words.shape[2]
    assert wire.shape == (x.shape[0], qpack.wire_columns(2, W, E, 4))
    (blocks, o, c) = qpack.unpack_wire(torch.from_numpy(wire.view(np.int32)),
                                       k, W, 2, n, E, 4)
    assert np.array_equal(blocks.numpy(), qpack.quantize(x, t))
    assert np.array_equal(o.numpy(), orv)
    assert np.array_equal(c.numpy(), cf)


def test_round_k():
    assert [qpack.round_k(k) for k in (1, 2, 5, 9, 17, 31)] == \
        [ref_qpack.round_k(k) for k in (1, 2, 5, 9, 17, 31)]
    with pytest.raises(ValueError):
        qpack.round_k(32)
    assert qpack.K_GRID == ref_qpack.K_GRID
    assert qpack.E_GRID == ref_qpack.E_GRID


# ---- FLAC under the default environment --------------------------------

@pytest.mark.parametrize("level", [str(q) for q in range(9)])
def test_flac_levels_match_reference(level):
    opts = dict(FlacAudio.COMPRESSION_OPTIONS[level], batch_frames=8)
    arr = program(4096 * 3 + 1500)
    data = port_flac_bytes(arr, 16, **opts)
    assert data == ref_flac_bytes(arr, 16, **opts)
    assert np.array_equal(flac_decode_all(data, 16, 2, len(arr)), arr)


def test_bench_shape_matches_reference():
    """bench.py's options and signal, cut to 10 blocks and a tail; the
    wire is the patched one"""
    opts = dict(bench.OPTS, batch_frames=4)
    arr = program(4096 * 10 + 321)
    before = (flac_enc_fast.wire_batches, flac_enc_fast.patched_batches)
    data = port_flac_bytes(arr, 16, **opts)
    assert data == ref_flac_bytes(arr, 16, **opts)
    assert flac_enc_fast.wire_batches - before[0] == 3
    assert flac_enc_fast.patched_batches > before[1]


@pytest.mark.parametrize("bps,channels", [(16, 2), (24, 2), (16, 1)])
def test_floor_retry_matches_reference(bps, channels):
    opts = dict(FlacAudio.COMPRESSION_OPTIONS["8"], batch_frames=8)
    arr = tones(4096 * 4 + 77, bps, channels)
    before = flac_enc_fast.floor_frames
    data = port_flac_bytes(arr, bps, **opts)
    assert flac_enc_fast.floor_frames > before
    assert data == ref_flac_bytes(arr, bps, **opts)
    assert np.array_equal(flac_decode_all(data, bps, channels, len(arr)),
                          arr)


def test_emit_overflow_retry_matches_reference(monkeypatch):
    """without the emit-stage Rice re-search the quantized decisions of
    the quiet halves overflow the emitter; the batch is analysed again
    exactly, as the reference does"""
    monkeypatch.setenv("ATPU_EMIT_EXACT_RICE", "0")
    opts = dict(block_size=4096, max_lpc_order=8,
                max_residual_partition_order=4, batch_frames=8)
    arr = loud_and_quiet(4096 * 4 + 77)
    before = flac_enc_fast.overflow_batches
    data = port_flac_bytes(arr, 16, **opts)
    assert flac_enc_fast.overflow_batches == before + 1
    assert data == ref_flac_bytes(arr, 16, **opts)
    assert np.array_equal(flac_decode_all(data, 16, 2, len(arr)), arr)


@pytest.mark.parametrize("env", [
    {"ATPU_QPACK_PATCH": "0"}, {"ATPU_QPACK_NOISE_EXTRA": "0"},
    {"ATPU_QPACK_GUARD": "2"}, {"ATPU_QPACK_CAP": "3"},
    {"ATPU_EMIT_EXACT_RICE": "0"}, {"ATPU_FLAC_QPACK": "0"}])
def test_wire_settings_match_reference(monkeypatch, env):
    for (key, value) in env.items():
        monkeypatch.setenv(key, value)
    opts = dict(FlacAudio.COMPRESSION_OPTIONS["5"], batch_frames=8)
    arr = program(4096 * 3 + 99)
    assert port_flac_bytes(arr, 16, **opts) == ref_flac_bytes(arr, 16,
                                                              **opts)


def test_routes():
    assert flac_enc_fast.choose_route(None, 16) == "wire"
    assert flac_enc_fast.choose_route(None, 30) == "exact"
    assert flac_enc_fast.choose_route(True, 16) == "pack"
    assert flac_enc_fast.choose_route(False, 16) == "exact"


def test_pallas_switch_takes_the_pack_route(monkeypatch):
    monkeypatch.setenv("ATPU_PALLAS", "1")
    assert flac_enc_fast.choose_route(None, 16) == "pack"
    monkeypatch.setenv("ATPU_FLAC_QPACK", "0")
    monkeypatch.setenv("ATPU_PALLAS", "0")
    assert flac_enc_fast.choose_route(None, 16) == "exact"


# ---- the exact Rice ladder ----------------------------------------------

@pytest.mark.parametrize("bps,channels", [(16, 2), (24, 2), (16, 1)])
def test_exact_rice_encode_matches_reference(monkeypatch, bps, channels):
    monkeypatch.setenv("ATPU_DEVICE_RICE", "exact")
    opts = dict(FlacAudio.COMPRESSION_OPTIONS["8"], batch_frames=8)
    arr = (program(4096 * 2 + 700) if bps == 16 else
           (program(4096 * 2 + 700).astype(np.int64) * 256 + 17)
           .astype(np.int32))[:, :channels]
    data = port_flac_bytes(arr, bps, **opts)
    assert data == ref_flac_bytes(arr, bps, **opts)
    assert np.array_equal(flac_decode_all(data, bps, channels, len(arr)),
                          arr)


@pytest.mark.parametrize("bps", [16, 24])
def test_rice_planes_match_the_stacked_form(bps):
    """rice_planes_plain against the reference's stacked reduction
    (audiotools_tpu/ops/flac_frames.py, the exact ladder's w_fin)"""
    rng = np.random.default_rng(bps)
    (S, C, n, parts) = (6, 5, 256, 16)
    res = rng.integers(-(1 << (bps + 3)), 1 << (bps + 3),
                       (S, C, n)).astype(np.int32)
    res[0] = 0
    res[1, :, ::3] = -1
    J0 = min(14 if bps <= 16 else 30, bps + 1 + 7)
    u = np.where(res >= 0, res << 1, ((-res - 1) << 1) | 1)
    u_fin = u.reshape(S, C, parts, n // parts)
    rr = np.arange(J0 + 1, dtype=np.int32)
    vals = u_fin[..., None, :] >> rr[:, None]
    want = np.where(rr[:, None] < J0, vals & 1, vals).sum(axis=-1,
                                                          dtype=np.int32)
    got = flac_frames.rice_planes(torch.from_numpy(res), parts, J0)
    assert np.array_equal(got.numpy(), want)


def test_rice_planes_refuse_other_devices():
    with pytest.raises(ValueError):
        flac_frames.rice_planes(torch.zeros((1, 1, 8), dtype=torch.int32,
                                            device="meta"), 2, 14)


@pytest.mark.cuda
@pytest.mark.skipif(not torch.cuda.is_available(), reason="needs a card")
@pytest.mark.parametrize("psize,J0", [(64, 14), (18, 30), (4096, 14)])
def test_rice_planes_kernel_matches_plain(psize, J0):
    rng = np.random.default_rng(psize)
    res = torch.as_tensor(rng.integers(-(1 << 20), 1 << 20,
                                       (3, 4, psize * 4)).astype(np.int32))
    want = flac_frames.rice_planes_plain(res, 4, J0)
    got = flac_frames.rice_planes(res.cuda(), 4, J0).cpu()
    assert torch.equal(got, want)


# ---- several devices ----------------------------------------------------

@pytest.mark.parametrize("pack", [None, True, False])
def test_two_devices_equal_one(pack):
    opts = dict(FlacAudio.COMPRESSION_OPTIONS["8"], batch_frames=3)
    arr = program(4096 * 5 + 10)        # batches of 3 and 2 blocks
    one = port_flac_bytes(arr, 16, pack=pack, **opts)
    two = port_flac_bytes(arr, 16, pack=pack, devices=["cpu", "cpu"],
                          **opts)
    assert two == one


def test_devices_from_the_environment(monkeypatch):
    opts = dict(FlacAudio.COMPRESSION_OPTIONS["5"], batch_frames=3)
    arr = program(4096 * 3 + 10)
    one = port_flac_bytes(arr, 16, **opts)
    monkeypatch.setenv("ATPU_DEVICES", "3")
    assert flac_enc_fast.resolve_encode_devices("cpu", None) == \
        [torch.device("cpu")] * 3
    assert port_flac_bytes(arr, 16, **opts) == one
    assert port_flac_bytes(arr, 16, **opts) == ref_flac_bytes(arr, 16,
                                                              **opts)


def test_devices_beyond_the_cards_raise(monkeypatch):
    monkeypatch.setenv("ATPU_DEVICES", "2")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    with pytest.raises(ValueError):
        flac_enc_fast.resolve_encode_devices("cuda", None)


# ---- ALAC ---------------------------------------------------------------

def ref_mdat(arr, bps):
    buf = io.BytesIO()
    ref_alac.encode_mdat_fast(buf, reader(arr, bps), backend="numpy")
    return buf.getvalue()


def port_mdat(arr, bps, **kw):
    buf = io.BytesIO()
    alac_fast.encode_mdat_fast(buf, reader_from_array(arr, bps),
                               device="cpu", **kw)
    return buf.getvalue()


@pytest.mark.parametrize("kind,bps,channels", [
    ("program", 16, 2), ("tones", 16, 2), ("tones", 24, 2),
    ("program", 24, 1), ("tones", 16, 1)])
def test_alac_matches_reference(kind, bps, channels):
    n = 4096 * 3 + 77
    arr = program(n) if kind == "program" else tones(n, 16, channels)
    arr = arr[:, :channels]
    if bps == 24:
        arr = (arr.astype(np.int64) * 256 +
               np.random.default_rng(1).integers(-500, 500, arr.shape)
               ).astype(np.int32)
    before = alac_fast.floor_groups
    got = port_mdat(arr, bps, batch_frames=2)
    assert got == ref_mdat(arr, bps)
    if kind == "tones":
        assert alac_fast.floor_groups > before


def test_alac_wire_off_matches_reference(monkeypatch):
    monkeypatch.setenv("ATPU_ALAC_QPACK", "0")
    arr = tones(4096 * 2 + 5)
    before = alac_fast.wire_batches
    assert port_mdat(arr, 16) == ref_mdat(arr, 16)
    assert alac_fast.wire_batches == before


@pytest.mark.parametrize("kind", ["program", "tones", "quiet"])
def test_alac_plan_matches_the_scalar_spec(kind):
    """ref/alac.plan_t of each channel (zero-padded to the block) equals
    the reference's scalar plan and the C++ scan's t"""
    n = 4096
    arr = {"program": program(n - 100), "tones": tones(n - 100),
           "quiet": np.full((n - 100, 2), 3, dtype=np.int32)}[kind]
    padded = np.zeros((1, n, 2), dtype=np.int32)
    padded[0, :len(arr)] = arr
    t = _native.flac_qpack(padded, 16, 0, False)[2][0]
    for c in range(2):
        got = port_alac_oracle.plan_t(arr[:, c], 16, n)
        assert got == ref_alac_oracle.plan_t(arr[:, c], 16, n) == t[c]
        q = port_alac_oracle.quantize_channel(arr[:, c], got)
        assert q == ref_alac_oracle.quantize_channel(arr[:, c], got)
    assert port_alac_oracle.analysis_channels(
        [arr[:, 0], arr[:, 1]], 16, n)[0] == max(t)


def test_alac_floor_rule_matches_the_scalar_spec():
    """the batched retry's pick and flag against ref/alac's scalar rule
    on random candidate rows"""
    rng = np.random.default_rng(4)
    rows = np.zeros((64, alac_fast.alac_frames.N_LEFTWEIGHTS, 2,
                     alac_fast.alac_frames.PACKED_COLS), dtype=np.int32)
    rows[..., 12] = rng.integers(0, 2, rows.shape[:3]) * (
        rng.random(rows.shape[:3]) < 0.2)
    rows[..., 13:15] = rng.integers(0, 1 << 14, rows.shape[:3] + (2,))
    (order, est, score) = alac_fast._pick_scores(rows, 0, 4, 2)
    for b in range(rows.shape[0]):
        ests = rows[b, :, :, 13:15].astype(np.int64)
        lw = int(np.argmin(ests.min(axis=2).sum(axis=1)))
        cands = [(None, None, int(rows[b, lw, c, 12]),
                  int(rows[b, lw, c, 13]), int(rows[b, lw, c, 14]))
                 for c in range(2)]
        assert [port_alac_oracle.pick_candidate(c)[0] for c in cands] == \
            order[b].tolist()
        assert port_alac_oracle.group_score(cands) == score[b] == \
            ref_alac_oracle.group_score(cands)
        for t in (0, 3, 6, 9, 12):
            assert (port_alac_oracle.floor_limited(cands, t, 4096, 16) ==
                    ref_alac_oracle.floor_limited(cands, t, 4096, 16))


# ---- whole files through the format classes ----------------------------

@pytest.mark.parametrize("level", ["0", "5", "8"])
@pytest.mark.parametrize("bps,channels", [(16, 2), (24, 2), (16, 6)])
def test_flac_files_match_reference(tmp_path, monkeypatch, level, bps,
                                    channels):
    """FlacAudio.from_pcm of both packages on the default route (the
    reference on its numpy backend, which its suites hold to its JAX
    one): the whole file, seektable and channel mask comment included"""
    from audiotools_tpu.formats.flac import FlacAudio as RefFlacAudio
    from test_torch_formats import port_reader, ref_reader
    monkeypatch.setenv("ATPU_FLAC_BACKEND", "numpy")
    arr = tones(4096 * 3 + 500, bps, channels)
    arr[:, 0] += np.random.default_rng(2).integers(-40, 40, len(arr),
                                                   dtype=np.int32)
    (ref_path, path) = (str(tmp_path / "ref.flac"), str(tmp_path / "p.flac"))
    RefFlacAudio.from_pcm(ref_path, ref_reader(arr, bps), compression=level,
                          total_pcm_frames=len(arr))
    FlacAudio.from_pcm(path, port_reader(arr, bps), compression=level,
                       total_pcm_frames=len(arr), device="cpu")
    with open(ref_path, "rb") as a, open(path, "rb") as b:
        assert b.read() == a.read()


@pytest.mark.parametrize("channels,bps", [(2, 16), (1, 24)])
def test_m4a_files_match_reference(monkeypatch, tmp_path, channels, bps):
    """the whole M4A file on the default route (the ALAC wire), the
    creation time pinned"""
    from audiotools_tpu.formats import m4a as ref_m4a
    from audiotools_tpu_torch.formats import m4a
    from test_torch_alac import port_reader as alac_reader
    monkeypatch.setenv("ATPU_ALAC_BACKEND", "numpy")
    now = 1700000000
    monkeypatch.setattr(ref_m4a.time, "time", lambda: float(now))
    arr = tones(4096 * 3 + 333, bps, channels)
    path = str(tmp_path / "ref.m4a")
    ref_m4a.ALACAudio.from_pcm(path, reader(arr, bps))
    out = io.BytesIO()
    m4a.write_m4a(out, alac_reader(arr, bps), device="cpu",
                  create_date=now + m4a.QUICKTIME_EPOCH_OFFSET)
    with open(path, "rb") as f:
        assert out.getvalue() == f.read()
