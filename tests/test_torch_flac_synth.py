"""The port's FLAC synthesis (``ops/flac_synth``): the plain int64
version must give exactly the reference's float64 numpy form
(``flac_synth.synthesize(np, ...)``) for every order, shift and FIXED
predictor, including 24-bit rows the reference's int32 path refuses;
``reconstruct_frames`` must equal the reference's for every channel
assignment.  A numpy model of the card kernel's arithmetic (tiles,
warm-up tiles, register ring, older taps first, the two-thread tap
split) must give the reference's samples too.  On a card the kernel
must equal the plain version."""

import numpy as np
import pytest
import torch

from audiotools_tpu.ops import flac_synth as ref
from audiotools_tpu_torch.ops import flac_synth as port

torch.set_num_threads(1)


def t(a):
    return torch.as_tensor(np.asarray(a, dtype=np.int32))


def rows(seed, S, n, Kw, orders, shifts, value_bits=15):
    """S stable predictor rows: sum |q| <= 2^shift keeps the
    recurrence within value_bits + log2(n)"""
    rng = np.random.default_rng(seed)
    lim = 1 << value_bits
    residuals = rng.integers(-lim // 8, lim // 8, (S, n)).astype(np.int32)
    warmup = rng.integers(-lim, lim, (S, Kw)).astype(np.int32)
    raw = rng.integers(-(1 << 13), 1 << 13, (S, Kw))
    denom = np.abs(raw).sum(axis=1, keepdims=True) + 1
    shifts = np.asarray(shifts, dtype=np.int32)
    qlp = (raw * (1 << shifts.astype(np.int64))[:, None]
           // denom).astype(np.int32)
    return (residuals, warmup, qlp, shifts,
            np.asarray(orders, dtype=np.int32))


def check(residuals, warmup, qlp, shift, order):
    n = residuals.shape[1]
    want = ref.synthesize(np, residuals, warmup, qlp, shift, order, n)
    got = port.synthesize_plain(t(residuals), t(warmup), t(qlp), t(shift),
                                t(order))
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), want)
    return got


@pytest.mark.parametrize("order", [0, 1, 4, 8, 12, 32])
def test_orders_and_shifts(order):
    """one row per shift 0..15 at each order, coefficients in every
    column (the reference sums all of them)"""
    check(*rows(order, 16, 96, 32, [order] * 16, range(16)))


def test_fixed_rows():
    """FIXED orders 0-4 through fill_fixed_qlp, beside LPC rows"""
    sub_meta = np.zeros((7, 8), dtype=np.int32)
    sub_meta[:5, 1] = 2
    sub_meta[:5, 2] = range(5)
    sub_meta[5:, 1] = 3
    sub_meta[5:, 2] = [6, 12]
    (residuals, warmup, qlp, shift, order) = rows(
        9, 7, 128, 16, sub_meta[:, 2], [0, 0, 0, 0, 0, 9, 12])
    qlp[5, 6:] = 0
    qlp[6, 12:] = 0
    fixed = port.fill_fixed_qlp(sub_meta, qlp)
    assert np.array_equal(fixed, ref.fill_fixed_qlp(sub_meta, qlp))
    assert np.array_equal(fixed[5:], qlp[5:])
    check(residuals, warmup, fixed, shift, order)


def test_24_bit_rows_beyond_the_int32_guard():
    """24-bit values with 15-bit coefficients: the reference's int32
    path refuses these rows; the int64 form is exact"""
    rng = np.random.default_rng(24)
    (S, n, Kw) = (6, 200, 32)
    order = np.array([32, 32, 12, 8, 1, 0], dtype=np.int32)
    shift = np.array([15, 14, 15, 13, 0, 0], dtype=np.int32)
    qlp = rng.integers(-(1 << 14), 1 << 14, (S, Kw)).astype(np.int32)
    qlp[4] = 0
    qlp[4, 0] = 1
    warmup = rng.integers(-(1 << 23), 1 << 23, (S, Kw)).astype(np.int32)
    residuals = rng.integers(-(1 << 23), 1 << 23, (S, n)).astype(np.int32)
    assert not ref.i32_synthesis_safe(qlp, shift, np.full(S, 25))
    check(residuals, warmup, qlp, shift, order)


def test_narrow_coefficient_width():
    """Kw 8 as the decoder passes for -8 streams (order <= 8 here)"""
    check(*rows(3, 9, 300, 8, [0, 1, 2, 3, 4, 5, 6, 7, 8],
                [0, 3, 5, 7, 9, 11, 12, 13, 14]))


@pytest.mark.parametrize("ch", [1, 2, 6])
def test_reconstruct_frames(ch):
    """wasted bits, and for stereo every assignment 0-10"""
    rng = np.random.default_rng(ch)
    (F, n) = (11, 40)
    samples = rng.integers(-(1 << 17), 1 << 17, (F * ch, n)).astype(np.int32)
    wasted = rng.integers(0, 4, F * ch).astype(np.int32)
    assignment = (np.arange(F) if ch == 2
                  else np.full(F, ch - 1)).astype(np.int32)
    want = ref.reconstruct_frames(np, samples, wasted, assignment, ch)
    got = port.reconstruct_frames(t(samples), t(wasted), t(assignment), ch)
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), want)


def test_dispatch():
    """a CPU tensor runs the plain version; other devices and bad
    arguments raise"""
    args = [t(a) for a in rows(1, 4, 32, 8, [1, 2, 3, 4], [0, 1, 2, 3])]
    before = port.synthesize.launches
    assert torch.equal(port.synthesize(*args), port.synthesize_plain(*args))
    assert port.synthesize.launches == before
    with pytest.raises(ValueError, match="device"):
        port.synthesize(*[a.to("meta") for a in args])
    with pytest.raises(ValueError):
        port.synthesize(args[0], args[1][:, :4], *args[2:])
    with pytest.raises(TypeError):
        port.synthesize(args[0].to(torch.int64), *args[1:])


# the kernel's samples a tile (csrc/row_tiles.cuh kTile)
TILE = 32
EDGE_NS = [1, TILE - 1, TILE, TILE + 1, 192, 4608]


def kernel_taps(taps):
    """the coefficient registers csrc/flac_synth.cu multiplies"""
    return next(k for k in (4, 8, 12, 16, 32) if taps <= k)


def kernel_model(residuals, warmup, qlp, shift, order, taps):
    """numpy int64 model of csrc/flac_synth.cu, step for step: K taps
    from ``taps``, the last samples in a ring of R slots (slot i % R),
    tiles of TILE samples, the warm-up select only in tiles that start
    below the warp's largest order (16 rows a warp; the stored samples
    patched into the residual tile), the older taps summed before the
    newest; taps 2.. split by parity between a row's two threads, the
    odd half summed a step early and carried (``lag``)"""
    (S, n) = residuals.shape
    Kw = qlp.shape[1]
    K = kernel_taps(taps)
    R = next(r for r in (4, 8, 16, 32) if K <= r)
    q = np.zeros((S, K), dtype=np.int64)
    q[:, :min(K, Kw)] = qlp[:, :min(K, Kw)]
    sh = np.clip(shift, 0, 63).astype(np.int64)
    rows_per_warp = 16
    warp_max = np.zeros(S, dtype=np.int64)
    for w0 in range(0, S, rows_per_warp):
        warp_max[w0:w0 + rows_per_warp] = order[w0:w0 + rows_per_warp].max()
    hist = np.zeros((R, S), dtype=np.int64)
    lag = np.zeros(S, dtype=np.int64)
    out = np.zeros((S, n), dtype=np.int32)
    M = (K - 2) // 2
    for c0 in range(0, n, TILE):
        tile = np.zeros((S, TILE), dtype=np.int64)
        width = min(TILE, n - c0)
        tile[:, :width] = residuals[:, c0:c0 + width]
        warm_tile = c0 < warp_max
        for i in range(TILE):
            g = c0 + i
            if g < Kw:
                patch = warm_tile & (g < order)
                tile[patch, i] = warmup[patch, g]
            else:
                tile[warm_tile & (g < order), i] = 0
            even = sum(q[:, 2 + 2 * m] * hist[(g - 3 - 2 * m) % R]
                       for m in range(M - 1, -1, -1))
            odd = sum(q[:, 3 + 2 * m] * hist[(g - 3 - 2 * m) % R]
                      for m in range(M - 1, -1, -1))
            acc = even + lag + q[:, 1] * hist[(g - 2) % R]
            lag = odd
            acc = acc + q[:, 0] * hist[(g - 1) % R]
            v = (tile[:, i] + (acc >> sh)).astype(np.int32)
            v = np.where(warm_tile & (g < order), tile[:, i], v)
            hist[g % R] = v
            if g < n:
                out[:, g] = v
    return out


def edge_rows(seed, S, n, Kw, orders):
    """S stable rows, at least one of them past the last coefficient
    column, so that a later tile carries warm-up (samples Kw.. are 0)"""
    return rows(seed, S, n, Kw, orders, np.arange(S) % 16)


@pytest.mark.parametrize("n", EDGE_NS)
def test_kernel_model_orders_0_to_32(n):
    """every order 0-32 and one of 40 (warm-up into the second tile),
    Kw 32, 45 rows: three warps of 16 rows, the last one part full"""
    orders = [o % 33 for o in range(44)] + [40]
    args = edge_rows(n, 45, n, 32, orders)
    want = ref.synthesize(np, *args, n)
    got = kernel_model(*args, 32)
    assert np.array_equal(got, want)


@pytest.mark.parametrize("n", EDGE_NS)
def test_kernel_model_fewer_taps(n):
    """the -8 decode's shape: Kw 16, columns 12.. zero, so the kernel
    multiplies 12 taps; FIXED rows (orders 0-4) beside LPC ones"""
    sub_meta = np.zeros((40, 8), dtype=np.int32)
    sub_meta[:, 1] = np.where(np.arange(40) % 3 == 0, 2, 3)
    sub_meta[:, 2] = np.where(sub_meta[:, 1] == 2, np.arange(40) % 5,
                              1 + np.arange(40) % 12)
    (residuals, warmup, qlp, shift, order) = edge_rows(
        n + 7, 40, n, 16, sub_meta[:, 2])
    qlp[:, 12:] = 0
    qlp = port.fill_fixed_qlp(sub_meta, qlp)
    taps = port.nonzero_columns(qlp)
    assert taps == 12
    want = ref.synthesize(np, residuals, warmup, qlp, shift, order, n)
    got = kernel_model(residuals, warmup, qlp, shift, order, taps)
    assert np.array_equal(got, want)


def test_nonzero_columns():
    qlp = np.zeros((3, 16), dtype=np.int32)
    assert port.nonzero_columns(qlp) == 0
    qlp[1, 4] = -1
    assert port.nonzero_columns(qlp) == 5
    qlp[2, 15] = 7
    assert port.nonzero_columns(qlp) == 16
    assert port.nonzero_columns(np.zeros((0, 8), dtype=np.int32)) == 0


def test_taps_argument_checks():
    """taps outside 0..Kw raise on every device; on the CPU a valid one
    changes nothing"""
    args = [t(a) for a in rows(1, 4, 32, 8, [1, 2, 3, 4], [0, 1, 2, 3])]
    for bad in (-1, 9):
        with pytest.raises(ValueError, match="taps"):
            port.synthesize(*args, taps=bad)
    assert torch.equal(port.synthesize(*args, taps=8),
                       port.synthesize_plain(*args))


@pytest.mark.cuda
@pytest.mark.parametrize("n", EDGE_NS + [512])
@pytest.mark.parametrize("Kw", [8, 16, 32])
def test_cuda_kernel_matches_plain(Kw, n):
    """45 rows (not a multiple of the kernel's 16 rows a warp) at
    the tile edges, every order up to Kw and one past it, with all Kw
    taps and with the columns past Kw // 2 + 1 zero"""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    orders = [o % (Kw + 1) for o in range(44)] + [Kw + 8]
    (residuals, warmup, qlp, shift, order) = edge_rows(Kw, 45, n, Kw,
                                                       orders)
    for cols in (Kw, Kw // 2 + 1):
        qlp[:, cols:] = 0
        args = [t(a).cuda() for a in (residuals, warmup, qlp, shift, order)]
        before = port.synthesize.launches
        got = port.synthesize(*args, taps=port.nonzero_columns(qlp))
        torch.cuda.synchronize()
        assert port.synthesize.launches == before + 1
        assert torch.equal(got, port.synthesize_plain(*args))
