"""Scalar LPC analysis primitives of the FLAC oracle encoder.

Copy of the reference package's ``ref/scalar_lpc.py``, trimmed to the
functions ``ref/flac_analysis.analyze_frame`` calls.  Straight-line
scalar loops over one subframe at a time, under the decision spec the
batched analysis (``ops/lpc.py``) follows: every float product exact,
every result re-rounded to f32 (``f32r``), integer sums exact, powers
of two built exactly.  The reference's docstrings carry the proofs.
"""

from __future__ import annotations

import math

import numpy as np

_window_cache = {}


def f32r(x):
    """rounds one f64 value to f32 precision (returned as float)"""
    return float(np.float64(np.float32(x)))


def exp2i(e):
    """exact 2^e for integer e, clamped to the f64 normal range"""
    return math.ldexp(1.0, max(-1022, min(1023, int(e))))


def tukey_window(n, alpha=0.5):
    """the tukey window exactly as the reference computes it
    (py_encoders/flac.py:565-582); float64 ndarray, cached"""
    key = (n, alpha)
    if key not in _window_cache:
        window1 = (alpha * (n - 1)) / 2
        window2 = (n - 1) * (1 - (alpha / 2))
        out = np.empty(n, dtype=np.float64)
        for i in range(n):
            if i <= window1:
                out[i] = 0.5 * (1 + np.cos(
                    np.pi * (((2 * i) / (alpha * (n - 1))) - 1)))
            elif i <= window2:
                out[i] = 1.0
            else:
                out[i] = 0.5 * (1 + np.cos(
                    np.pi * (((2 * i) / (alpha * (n - 1))) -
                             (2 / alpha) + 1)))
        _window_cache[key] = out
    return _window_cache[key]


def _dts(a, b):
    """magnitude-ordered Fast2Sum: exact (s, e), both f32-valued"""
    if abs(a) < abs(b):
        (a, b) = (b, a)
    s = f32r(a + b)
    z = s - a
    e = f32r(b - z)
    return (s, e)


def _dadd(a, b):
    (sh, se) = _dts(a[0], b[0])
    t = f32r(f32r(se + a[1]) + b[1])
    return _dts(sh, t)


def _dsub(a, b):
    return _dadd(a, (-b[0], -b[1]))


def _dmul(a, b):
    p = a[0] * b[0]
    ph = f32r(p)
    pe = p - ph
    cross = f32r(f32r(a[0] * b[1]) + f32r(a[1] * b[0]))
    t = f32r(pe + cross)
    return _dts(ph, t)


def _dmul1(a, b):
    """df * f32-valued scalar"""
    p = a[0] * b
    ph = f32r(p)
    pe = p - ph
    t = f32r(pe + f32r(a[1] * b))
    return _dts(ph, t)


def _ddiv(a, b):
    if b[0] == 0.0:
        return (0.0, 0.0)
    q1 = f32r(a[0] / b[0])
    r = _dsub(a, _dmul1(b, q1))
    q2 = f32r(r[0] / b[0])
    return _dts(q1, q2)


def _dsplit(x):
    """exact <=47-bit f64 value -> df pair"""
    hi = f32r(x)
    lo = f32r(x - hi)
    return (hi, lo)


def _dto_f32(a):
    """df -> f32-valued float (exact sum, one rounding)"""
    return f32r(a[0] + a[1])


def windowed_autocorr(x, window, max_order):
    """two-plane windowed autocorrelation of one subframe (~2^-39)

    x: int array [n] (post-wasted-shift); window: f64 [n]
    returns list of max_order+1 double-f32 pairs.

    Mirrors ops/lpc.windowed_autocorr_df exactly: samples pre-shift to
    17 bits; the window splits into a df pair; windowed values
    quantize onto TWO 17-bit integer planes (u, v); lag sums are three
    exact integer sums (< 2^47, any-order safe) recombined through the
    scalar df accumulator with the exact power-of-two scale."""
    n = len(x)
    w64 = np.asarray(window, dtype=np.float64)
    wh = w64.astype(np.float32).astype(np.float64)
    wl = (w64 - wh).astype(np.float32).astype(np.float64)
    amax = int(np.max(np.abs(x))) if n else 0
    pre = max(amax.bit_length() - 17, 0)
    xs = (np.asarray(x, dtype=np.int64) >> pre).astype(np.float64)
    a = xs * wh                                         # exact products
    b = xs * wl                                         # exact
    nb = 1
    while (1 << nb) < n:
        nb += 1
    m = min((47 - nb) // 2, 23)
    s0 = m - 17
    y = a * exp2i(s0)
    u = np.floor(y + 0.5)
    if m >= 16:
        r = y - u                                       # exact, f32
        b2 = (b * exp2i(s0)).astype(np.float32).astype(np.float64)
        t = (r + b2).astype(np.float32).astype(np.float64)
        v = np.floor(t * 131072.0 + 0.5)
    else:
        # blocks past ~32k samples degrade to the single-plane spec
        # (mirrors ops/lpc.windowed_autocorr_df)
        v = np.zeros_like(u)
    scale = exp2i(2 * (pre - 17 - s0))
    out = []
    for lag in range(max_order + 1):
        (u0, u1) = (u[:n - lag], u[lag:])
        (v0, v1) = (v[:n - lag], v[lag:])
        s_uu = float(np.sum(u0 * u1))
        s_cross = float(np.sum(u0 * v1 + v0 * u1))
        s_vv = float(np.sum(v0 * v1))
        acc = _dsplit(s_uu * exp2i(34))
        acc = _dadd(acc, _dsplit(s_cross * exp2i(17)))
        acc = _dadd(acc, _dsplit(s_vv))
        out.append((acc[0] * scale, acc[1] * scale))
    return out


def levinson(ac, max_order):
    """scalar Levinson-Durbin in double-f32 (~45-bit) arithmetic

    ac: list of max_order+1 df pairs (from windowed_autocorr)
    returns (rows, errors): rows[o-1][:o] are the order-o LP
    coefficients, errors[o-1] the order-o prediction error — plain
    f32-VALUED floats (one exact hi+lo sum, one f32 rounding), so
    quantization and the order estimate are untouched.
    Degenerate divisions (zero denominator) continue with ki = 0."""
    K = max_order
    one = (1.0, 0.0)
    k0 = _ddiv(ac[1], ac[0])
    rows = [[(0.0, 0.0)] * K]
    rows[0][0] = k0
    errors = [_dmul(ac[0], _dsub(one, _dmul(k0, k0)))]
    for i in range(1, K):
        prev = rows[i - 1]
        acc = (0.0, 0.0)
        for j in range(i):
            acc = _dadd(acc, _dmul(prev[j], ac[i - j]))
        err_prev = errors[i - 1]
        ki = _ddiv(_dsub(ac[i + 1], acc), err_prev)
        row = [(0.0, 0.0)] * K
        for j in range(i):
            row[j] = _dsub(prev[j], _dmul(ki, prev[i - 1 - j]))
        row[i] = ki
        rows.append(row)
        errors.append(_dmul(err_prev,
                            _dsub(one, _dmul(ki, ki))))
    rows_f = [[_dto_f32(c) for c in row] for row in rows]
    errs_f = [_dto_f32(e) for e in errors]
    return (rows_f, errs_f)


def quantize_coefficients(row, precision):
    """error-feedback quantization of one order's coefficients

    row: list of floats (the order-o Levinson row prefix)
    returns (qlp list of ints, shift int); mirrors the reference's C
    (production) encoder, src/encoders/flac.c:1271-1325: the shift
    comes from frexp's exponent (the Python mirror's int(log2(l))
    form over-shifts for coefficients in [1, 2) and clamps the lead
    coefficient — ~40-90% worse on tonal content), rounding is C
    round() (half away from zero), and the error feedback subtracts
    the UNCLAMPED rounded value; negative shifts scale coefficients
    down and emit shift 0"""
    import math

    order = len(row)
    l = max(abs(c) for c in row) if order else 0.0
    if l > 0.0:
        (_m, e) = math.frexp(l)
        raw_shift = min(max((precision - 1) - (e - 1) - 1, -(1 << 4)),
                        (1 << 4) - 1)
    else:
        raw_shift = 0
    scale = exp2i(raw_shift)
    qlp_max = (1 << (precision - 1)) - 1
    qlp_min = -(1 << (precision - 1))
    error = 0.0
    qlp = []
    for j in range(order):
        candidate = f32r(error + row[j] * scale)
        rounded = math.copysign(
            math.floor(abs(candidate) + 0.5), candidate)
        q = min(max(rounded, qlp_min), qlp_max)
        error = candidate - rounded
        qlp.append(int(q))
    return (qlp, max(raw_shift, 0))


def estimate_best_lpc_order(errors, block_size, bits_per_sample,
                            qlp_precision, max_order):
    """log-domain order estimate (reference py_encoders/flac.py:676)

    errors: list of floats from levinson(); returns int order.
    Orders with error > 0 compete on estimated bits (strict <,
    earliest wins); the first order with error == 0.0 wins outright."""
    error_scale = float(np.float32(np.log(2) ** 2))
    inv_2log2 = float(np.float32(1.0 / (np.log(2) * 2)))
    best_order = 0
    best_bits = 1e32
    for i in range(max_order):
        order = i + 1
        err = errors[i]
        if err == 0.0:
            return order
        if err > 0.0:
            header_bits = order * (float(bits_per_sample) +
                                   qlp_precision)
            log_err = f32r(np.log(err * error_scale))
            bits_per_residual = f32r(max(log_err * inv_2log2, 0.0))
            estimated = header_bits + bits_per_residual * (
                block_size - order)
            if estimated < best_bits:
                best_order = order
                best_bits = estimated
    return best_order


def lpc_residuals_aligned(x, qlp, shift, clip_bits):
    """exact integer LPC residuals at absolute positions

    x: int64 array [n]; positions below the order are zero; residual
    magnitudes clip to +-2^clip_bits (degenerate-candidate bound —
    part of the decision spec, matching the batched kernels; the
    *written* residuals are re-derived exactly elsewhere)"""
    order = len(qlp)
    n = len(x)
    out = np.zeros(n, dtype=np.int64)
    if order == 0:
        out[:] = x
    else:
        pred = np.zeros(n - order, dtype=np.int64)
        for (j, q) in enumerate(qlp):
            pred += int(q) * x[order - 1 - j:n - 1 - j]
        out[order:] = x[order:] - (pred >> shift)
    bound = 1 << clip_bits
    return np.clip(out, -bound, bound)
