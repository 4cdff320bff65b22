"""The port's FLAC synthesis (``ops/flac_synth``): the plain int64
version must give exactly the reference's float64 numpy form
(``flac_synth.synthesize(np, ...)``) for every order, shift and FIXED
predictor, including 24-bit rows the reference's int32 path refuses;
``reconstruct_frames`` must equal the reference's for every channel
assignment.  On a card the kernel must equal the plain version."""

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


@pytest.mark.cuda
@pytest.mark.parametrize("Kw", [8, 16, 32])
def test_cuda_kernel_matches_plain(Kw):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    orders = [Kw, Kw // 2, 1, 0] * 8
    args = [t(a).cuda() for a in rows(Kw, 32, 512, Kw, orders,
                                      np.arange(32) % 16)]
    got = port.synthesize(*args)
    torch.cuda.synchronize()
    assert torch.equal(got, port.synthesize_plain(*args))
