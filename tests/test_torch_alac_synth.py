"""The port's ALAC synthesis (``ops/alac_synth``): the plain version
must give exactly the reference's numpy form
(``alac_synth.synthesize(np, ...)``), the scalar oracle's
``decode_subframe``, and the reference's Pallas kernel in interpret
mode where its guard admits the rows; it must also hold on 24-bit
rows and on coefficients that drift out of what the reference's guard
checked.  ``decorrelate`` and ``merge_lsbs`` must
equal the reference's.  On a card the kernel must equal the plain
version."""

import numpy as np
import pytest
import torch

from audiotools_tpu.ops import alac_synth as ref
from audiotools_tpu.ref.alac import ALACDecoder
from audiotools_tpu_torch.ops import alac_synth as port

torch.set_num_threads(1)


def t(a):
    return torch.as_tensor(np.asarray(a, dtype=np.int32))


def rows(seed, S, n, orders, shifts, sample_sizes, qmax=2000, rmax=500):
    rng = np.random.default_rng(seed)
    residuals = rng.integers(-rmax, rmax, (S, n)).astype(np.int32)
    qlp = np.zeros((S, ref.K), dtype=np.int32)
    for (s, o) in enumerate(orders):
        if o < 31:
            qlp[s, :o] = rng.integers(-qmax, qmax, o)
    return (residuals, qlp, np.asarray(orders, dtype=np.int32),
            np.asarray(shifts, dtype=np.int32),
            np.asarray(sample_sizes, dtype=np.int32))


def plain(residuals, qlp, order, shift, sample_size, kw=None, max_order=8):
    if kw is not None:
        qlp = qlp[:, :kw]
    return port.synthesize_plain(t(residuals), t(qlp), t(order), t(shift),
                                 t(sample_size), max_order).numpy()


def numpy_form(residuals, qlp, order, shift, sample_size, max_order=8):
    return ref.synthesize(np, residuals, qlp, order, shift, sample_size,
                          residuals.shape[1], max_order=max_order)


def test_matches_oracle_subframe():
    """the adversarial rows of the reference's own oracle test: zero
    runs, positive-heavy residuals, shifts 7..12"""
    rng = np.random.default_rng(17)
    (S, n) = (6, 256)
    orders = [1, 2, 4, 8, 4, 8]
    shift = np.array([9, 9, 7, 9, 12, 9], dtype=np.int32)
    sample_size = np.full(S, 17, dtype=np.int32)
    residuals = rng.integers(-1500, 1500, (S, n)).astype(np.int32)
    residuals[2, :16] = 0
    residuals[3] = np.abs(residuals[3])
    qlp = np.zeros((S, ref.K), dtype=np.int32)
    for (s, o) in enumerate(orders):
        qlp[s, :o] = rng.integers(-2000, 2000, o)
    order = np.asarray(orders, dtype=np.int32)
    want = np.stack([ALACDecoder.decode_subframe(
        None, int(shift[s]), [int(v) for v in qlp[s, :orders[s]]],
        int(sample_size[s]), [int(v) for v in residuals[s]])
        for s in range(S)]).astype(np.int32)
    assert np.array_equal(numpy_form(residuals, qlp, order, shift,
                                     sample_size), want)
    assert np.array_equal(plain(residuals, qlp, order, shift, sample_size),
                          want)
    assert np.array_equal(plain(residuals, qlp, order, shift, sample_size,
                                kw=8), want)


def test_difference_chain_and_order_zero():
    """order >= 31 rows (the pure difference chain), order 0 and shift
    0 rows"""
    args = rows(3, 6, 128, [31, 31, 0, 0, 3, 5], [9, 9, 9, 0, 0, 9],
                [17, 16, 16, 17, 16, 24])
    assert np.array_equal(plain(*args), numpy_form(*args))
    want = ALACDecoder.decode_subframe(
        None, 9, [0] * 31, 17, [int(v) for v in args[0][0]])
    assert np.array_equal(plain(*args)[0], want)


@pytest.mark.parametrize("seed,S,n,order_hi", [
    (1, 8, 64, 4),
    (2, 16, 128, 8),
])
def test_matches_pallas_interpret(seed, S, n, order_hi):
    """the reference's Pallas kernel in interpret mode, at the shapes of
    its own test, on rows its guard admits"""
    import jax.numpy as jnp
    rng = np.random.default_rng(seed)
    residuals = rng.integers(-500, 500, (S, n)).astype(np.int32)
    order = rng.integers(1, order_hi + 1, S).astype(np.int32)
    qlp = np.zeros((S, ref.K), dtype=np.int32)
    for s in range(S):
        qlp[s, :order[s]] = rng.integers(-2000, 2000, order[s])
    shift = rng.integers(6, 13, S).astype(np.int32)
    sample_size = np.full(S, 16, dtype=np.int32)
    assert ref.pallas_synthesis_safe(qlp, shift, sample_size, order)
    want = np.asarray(ref._synthesize_pallas(
        jnp.asarray(residuals), jnp.asarray(qlp), jnp.asarray(order),
        jnp.asarray(shift), jnp.asarray(sample_size), n, 8))
    assert np.array_equal(plain(residuals, qlp, order, shift, sample_size),
                          want)


@pytest.mark.parametrize("sample_size", [17, 25])
def test_24bit_rows(sample_size):
    """24-bit content: sample size 17 (the coded part of a stereo pair
    with one low byte bypassed) and 25 (a pair coded whole), with wide
    coefficients and residuals"""
    rng = np.random.default_rng(sample_size)
    S = 12
    args = rows(sample_size, S, 300, rng.integers(1, 9, S),
                rng.integers(9, 16, S), np.full(S, sample_size),
                qmax=30000, rmax=1 << (sample_size - 4))
    assert np.array_equal(plain(*args), numpy_form(*args))


def test_guard_drift_rows():
    """the reference's guard-drift fault: sample sizes 25..30, shifts
    above 11, small initial coefficients that the reference's int32
    guard (pallas_synthesis_safe) admits, and one-signed unit residuals
    that keep the adaptation walk running at every sample, so that the
    coefficients drift by most of n, out of what the guard checked"""
    rng = np.random.default_rng(41)
    (S, n) = (16, 1024)
    args = rows(41, S, n, rng.integers(1, 9, S), rng.integers(12, 16, S),
                rng.integers(25, 31, S), qmax=4)
    residuals = args[0]
    residuals[:] = np.where(np.arange(S) % 2, -1, 1)[:, None]
    (qlp, order, shift, sample_size) = args[1:]
    assert ref.pallas_synthesis_safe(qlp, shift, sample_size, order)
    drifted = drifted_qlp(*args)
    assert np.abs(drifted - qlp).max() > n // 2
    assert not ref.pallas_synthesis_safe(drifted, shift, sample_size, order)
    assert np.array_equal(plain(*args), numpy_form(*args))


def drifted_qlp(residuals, qlp, order, shift, sample_size):
    """the coefficients after the scalar oracle's walk over each row"""
    out = np.array(qlp, copy=True)
    for s in range(residuals.shape[0]):
        coeffs = [int(v) for v in qlp[s, :order[s]]]
        ALACDecoder.decode_subframe(None, int(shift[s]), coeffs,
                                    int(sample_size[s]),
                                    [int(v) for v in residuals[s]])
        out[s, :order[s]] = coeffs
    return out


def test_orders_above_8_and_a_short_walk():
    """orders 9..30 with the reference's 8-step walk, and a 3-step
    walk"""
    rng = np.random.default_rng(8)
    S = 10
    args = rows(8, S, 200, rng.integers(9, 31, S), np.full(S, 9),
                np.full(S, 17))
    assert np.array_equal(plain(*args), numpy_form(*args))
    args = rows(9, S, 200, rng.integers(1, 9, S), np.full(S, 9),
                np.full(S, 17))
    assert np.array_equal(plain(*args, max_order=3),
                          numpy_form(*args, max_order=3))


def test_argument_checks():
    args = [t(a) for a in rows(1, 4, 16, [4, 4, 4, 4], [9] * 4, [16] * 4)]
    with pytest.raises(ValueError, match="columns"):
        port.synthesize_plain(args[0], args[1][:, :2], *args[2:])
    with pytest.raises(ValueError, match="shift"):
        port.synthesize(args[0], args[1], args[2], t([9, 9, 40, 9]),
                        args[4])
    with pytest.raises(TypeError):
        port.synthesize(args[0].to(torch.int64), *args[1:])
    with pytest.raises(ValueError, match="unsupported device"):
        port.synthesize(*[a.to("meta") for a in args])


def test_cpu_dispatch_runs_the_plain_version():
    args = [t(a) for a in rows(4, 4, 64, [1, 4, 8, 31], [9] * 4, [16] * 4)]
    before = port.synthesize.launches
    assert torch.equal(port.synthesize(*args), port.synthesize_plain(*args))
    assert port.synthesize.launches == before


@pytest.mark.parametrize("lw,ishift,lsb_bytes", [
    (0, 2, 0), (3, 2, 0), (4, 1, 1), (2, 3, 2)])
def test_decorrelate_and_merge_lsbs(lw, ishift, lsb_bytes):
    rng = np.random.default_rng(lw + ishift)
    G = 5
    ch0 = rng.integers(-(1 << 17), 1 << 17, (G, 64)).astype(np.int32)
    ch1 = rng.integers(-(1 << 17), 1 << 17, (G, 64)).astype(np.int32)
    lweight = np.full(G, lw, dtype=np.int32)
    lweight[0] = 0
    shift = np.full(G, ishift, dtype=np.int32)
    want = ref.decorrelate(np, ch0, ch1, lweight, shift)
    got = port.decorrelate(t(ch0), t(ch1), t(lweight), t(shift))
    for (g, w) in zip(got, want):
        assert np.array_equal(g.numpy(), w)
    bits = np.full(G, 8 * lsb_bytes, dtype=np.int32)
    lsbs = rng.integers(0, 1 << (8 * lsb_bytes), (G, 64)).astype(np.int32)
    assert np.array_equal(
        port.merge_lsbs(got[0], t(lsbs), t(bits)).numpy(),
        ref.merge_lsbs(np, want[0], lsbs, bits))


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["16bit", "24bit", "drift", "wide",
                                  "chain"])
def test_cuda_kernel_matches_plain(case):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    rng = np.random.default_rng(5)
    S = 64
    if case == "16bit":
        args = rows(1, S, 512, rng.integers(0, 9, S), rng.integers(1, 16, S),
                    np.full(S, 16))
    elif case == "24bit":
        args = rows(2, S, 512, rng.integers(1, 9, S),
                    rng.integers(9, 16, S), rng.choice([17, 25], S),
                    qmax=30000, rmax=1 << 20)
    elif case == "drift":
        args = rows(3, S, 1024, rng.integers(1, 9, S),
                    rng.integers(12, 16, S), rng.integers(25, 31, S), qmax=4)
        args[0][:] = np.where(np.arange(S) % 2, -1, 1)[:, None]
    elif case == "wide":
        args = rows(4, S, 256, rng.integers(9, 31, S), np.full(S, 9),
                    np.full(S, 17))
    else:
        args = rows(5, S, 256, [31] * (S // 2) + [2] * (S // 2),
                    np.full(S, 9), np.full(S, 17))
    tensors = [t(a).cuda() for a in args]
    before = port.synthesize.launches
    got = port.synthesize(*tensors)
    torch.cuda.synchronize()
    assert port.synthesize.launches == before + 1
    assert torch.equal(got, port.synthesize_plain(*tensors))
    assert np.array_equal(got.cpu().numpy(), numpy_form(*args))
