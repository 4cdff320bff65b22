"""The PyTorch port's LPC analysis (audiotools_tpu_torch/ops/lpc.py,
df.py) against the reference's numpy path, bit for bit.

The numeric spec is exact under IEEE f64 (every product exact, every
sum an exact integer sum or one add followed by an f32 rounding), so
the tolerance is 0 everywhere: hi and lo planes, coefficients,
errors, quantized coefficients, shifts and residuals must be equal.
One case also runs the reference's jax.numpy path (CPU, x64).
"""

import numpy as np
import pytest
import torch

from audiotools_tpu.ops import lpc as ref
from audiotools_tpu_torch.ops import lpc as port

torch.set_num_threads(1)


def signals(n, bps, rows=6, seed=0):
    """int32 [rows, n]: tones, tone + noise, noise, a transient, an
    all-zero row and a constant row (the degenerate cases)"""
    rng = np.random.default_rng(seed + n + bps)
    t = np.arange(n)
    amp = float(1 << (bps - 2))
    out = np.zeros((rows, n), dtype=np.int64)
    out[0] = amp * np.sin(2 * np.pi * 441 * t / 44100)
    out[1] = (0.6 * amp * np.sin(2 * np.pi * 1201 * t / 44100 + 0.3) +
              rng.normal(0, amp / 300, n))
    out[2] = rng.integers(-int(amp), int(amp), n)
    out[3] = np.where(t > n // 2, amp * np.sin(0.37 * t), 0.0)
    out[4] = 0
    out[5] = 77
    return out.astype(np.int32)


def to_t(a):
    return torch.as_tensor(np.asarray(a))


def same(got, want):
    got = got.numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    assert got.shape == want.shape
    assert got.dtype == want.dtype, (got.dtype, want.dtype)
    assert np.array_equal(got, want)


def ref_chain(x, n, K, precision):
    window = ref.tukey_window_df(n)
    ac = ref.windowed_autocorr_df(np, x, window, K)
    (coeffs, errors) = ref.levinson_df(np, ac, K)
    (qlp, shifts) = ref.quantize_all_orders(np, coeffs, precision)
    return (window, ac, coeffs, errors, qlp, shifts)


CASES = [(n, K, bps) for n in (256, 4096) for K in (4, 12)
         for bps in (16, 24)]


@pytest.mark.parametrize("n,K,bps", CASES)
def test_analysis_chain_matches_numpy(n, K, bps):
    x = signals(n, bps)
    precision = 12
    (window, ac, coeffs, errors, qlp, shifts) = ref_chain(x, n, K,
                                                          precision)
    ac_t = port.windowed_autocorr_df(
        to_t(x), port.window_to_torch(window, "cpu"), K)
    same(ac_t[0], ac[0])
    same(ac_t[1], ac[1])
    (coeffs_t, errors_t) = port.levinson_df((to_t(ac[0]), to_t(ac[1])), K)
    same(coeffs_t, coeffs)
    same(errors_t, errors)
    (qlp_t, shifts_t) = port.quantize_all_orders(to_t(coeffs), precision)
    same(qlp_t, qlp)
    same(shifts_t, shifts)
    bps_vec = np.full(x.shape[0], bps, dtype=np.int32)
    same(port.estimate_best_lpc_order(
        to_t(errors), n, to_t(bps_vec.astype(np.float64)), precision, K),
        ref.estimate_best_lpc_order(np, errors, n,
                                    bps_vec.astype(np.float64),
                                    precision, K))


@pytest.mark.parametrize("n,K,bps", CASES)
def test_residuals_match_numpy(n, K, bps):
    """the dispatcher takes the int32 hi/lo branch at 16 bits and the
    exact-f64 branch at 24 bits; both branches are also compared on
    their own wherever the int32 one is valid"""
    x = signals(n, bps)
    precision = 14 if bps == 16 else 12
    (_w, _ac, _c, _e, qlp, shifts) = ref_chain(x, n, K, precision)
    clip_bits = bps + 4
    want = ref.lpc_residuals(np, x, qlp, shifts, bps, precision, clip_bits)
    same(port.lpc_residuals(to_t(x), to_t(qlp), to_t(shifts), bps,
                            precision, clip_bits), want)
    same(port.lpc_residuals_f64(to_t(x), to_t(qlp), to_t(shifts),
                                clip_bits),
         ref.lpc_residuals_f64(np, x, qlp, shifts, clip_bits))
    if bps == 16:
        same(port.lpc_residuals_i32(to_t(x), to_t(qlp), to_t(shifts),
                                    clip_bits),
             ref.lpc_residuals_i32(np, x, qlp, shifts, clip_bits))


def test_integer_helpers_match_numpy():
    rng = np.random.default_rng(5)
    ints = np.concatenate([[0, 1, 2, 3, (1 << 30) - 1, 1 << 30],
                           rng.integers(0, 1 << 31, 200)]).astype(np.int64)
    same(port.int_bit_length(to_t(ints)), ref.int_bit_length(np, ints))
    exps = np.arange(-1100, 1100, 7, dtype=np.int64)
    same(port.exact_exp2(to_t(exps)), ref.exact_exp2(np, exps))
    vals = np.concatenate([
        [2.0 ** -30, 0.25, 0.5, 0.75, 1.0, 1.5, 2.0, 3.0, 1024.0],
        rng.uniform(1e-6, 1e6, 200)])
    same(port.ilog2_trunc(to_t(vals)), ref.ilog2_trunc(np, vals))
    same(port.frexp_exponent(to_t(vals)), ref.frexp_exponent(np, vals))


def test_analysis_chain_matches_jax():
    """the same chain through the reference's jax.numpy functions"""
    import jax
    jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp

    (n, K, bps, precision) = (4096, 12, 16, 12)
    x = signals(n, bps)
    window = ref.tukey_window_df(n)
    ac = ref.windowed_autocorr_df(jnp, jnp.asarray(x),
                                  (jnp.asarray(window[0]),
                                   jnp.asarray(window[1])), K)
    (coeffs, errors) = ref.levinson_df(jnp, ac, K)
    (qlp, shifts) = ref.quantize_all_orders(jnp, coeffs, precision)
    res = ref.lpc_residuals(jnp, jnp.asarray(x), qlp, shifts, bps,
                            precision, bps + 4)

    ac_t = port.windowed_autocorr_df(
        to_t(x), port.window_to_torch(window, "cpu"), K)
    (coeffs_t, errors_t) = port.levinson_df(ac_t, K)
    (qlp_t, shifts_t) = port.quantize_all_orders(coeffs_t, precision)
    res_t = port.lpc_residuals(to_t(x), qlp_t, shifts_t, bps, precision,
                               bps + 4)
    for (got, want) in [(ac_t[0], ac[0]), (ac_t[1], ac[1]),
                        (coeffs_t, coeffs), (errors_t, errors),
                        (qlp_t, qlp), (shifts_t, shifts), (res_t, res)]:
        same(got, np.asarray(want))


@pytest.mark.parametrize("n", [192, 1152, 4096])
def test_tukey_window_matches_reference(n):
    """the port's own host-split window equals the reference's bit for
    bit"""
    (hi, lo) = port.tukey_window_df(n)
    (want_hi, want_lo) = ref.tukey_window_df(n)
    assert np.array_equal(hi, want_hi) and np.array_equal(lo, want_lo)
