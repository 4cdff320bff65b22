"""Batched LPC analysis primitives in torch, bit-identical to the
reference's numeric spec (``audiotools_tpu/ops/lpc.py``).

The spec keeps every float product exact (operands of <= 26
significant bits), every sum an exact integer sum or a single add
followed by an f32 re-round, and every power of two built from its bit
pattern.  Under those rules eager torch on the CPU or on a CUDA card
gives the same values as numpy, whatever order a reduction takes.
The reference's docstrings carry the proofs; comments here note only
where the port differs in form.

Every float tensor is created as float64 explicitly: torch promotes
``int32_tensor * 2.0`` to float32 where numpy gives float64.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..ref.scalar_lpc import tukey_window as tukey_window_f64
from . import df as dfm
from .bits import exact_exp2

# (n, alpha) -> the (hi, lo) window pair; threads that miss at once each
# compute the same read-only pair and one store wins, so it needs no lock
_window_df_cache = {}


def f32round(x):
    """rounds f64 values to f32 precision, keeping the f64 dtype"""
    return x.to(torch.float32).to(torch.float64)


def int_bit_length(v):
    """bit_length of non-negative integer tensors (0 -> 0), int32"""
    out = torch.zeros(v.shape, dtype=torch.int32, device=v.device)
    for k in range(31):
        out += (v >= (1 << k)).to(torch.int32)
    return out


def tukey_window_df(n, alpha=0.5):
    """the Tukey window (the scalar oracle's, computed as the reference
    computes it) split into a double-f32 (hi, lo) pair of float64 numpy
    arrays on the host

    The split must happen in host IEEE f64 so that every backend sees
    the same f32-valued halves."""
    key = (n, alpha)
    if key not in _window_df_cache:
        w = tukey_window_f64(n, alpha)
        hi = w.astype(np.float32).astype(np.float64)
        lo = (w - hi).astype(np.float32).astype(np.float64)
        _window_df_cache[key] = (hi, lo)
    return _window_df_cache[key]


def window_to_torch(window_pair, device):
    """a host-split (hi, lo) window pair from ``tukey_window_df`` -> a
    pair of float64 tensors on ``device``"""
    (hi, lo) = window_pair
    return (torch.as_tensor(np.asarray(hi, dtype=np.float64),
                            device=device),
            torch.as_tensor(np.asarray(lo, dtype=np.float64),
                            device=device))


def tukey_window(block_size, device):
    """the (hi, lo) Tukey window for ``block_size``, made on the host
    by ``tukey_window_df`` and moved to ``device``"""
    return window_to_torch(tukey_window_df(block_size), device)


def windowed_autocorr_df(samples, window, max_order):
    """two-plane windowed autocorrelation as a df pair

    samples: int32 [S, n] (post-wasted-shift); window: (hi, lo) f64
    [n] pair from window_to_torch.  Returns (hi, lo), each f64
    [S, max_order+1]; the lag sums are exact integer sums."""
    n = samples.shape[-1]
    (wh, wl) = window
    amax = torch.amax(torch.abs(samples), dim=-1, keepdim=True)
    pre = torch.clamp(int_bit_length(amax) - 17, min=0)   # [S, 1]
    xs = (samples >> pre).to(torch.float64)
    a = xs * wh                                           # exact
    b = xs * wl                                           # exact
    nb = 1
    while (1 << nb) < n:
        nb += 1
    m = min((47 - nb) // 2, 23)
    s0 = m - 17
    y = a * math.ldexp(1.0, s0)                           # exact
    u = torch.floor(y + 0.5)
    if m >= 16:
        r = y - u                                         # exact, f32
        b2 = f32round(b * math.ldexp(1.0, s0))
        t = f32round(r + b2)
        v = torch.floor(t * 131072.0 + 0.5)
    else:
        # blocks past ~32k samples: single-plane spec (v = 0)
        v = torch.zeros_like(u)
    lags_uu = []
    lags_cross = []
    lags_vv = []
    for lag in range(max_order + 1):
        u0 = u[..., :n - lag]
        u1 = u[..., lag:]
        v0 = v[..., :n - lag]
        v1 = v[..., lag:]
        lags_uu.append(torch.sum(u0 * u1, dim=-1))
        lags_cross.append(torch.sum(u0 * v1 + v0 * u1, dim=-1))
        lags_vv.append(torch.sum(v0 * v1, dim=-1))
    S_uu = torch.stack(lags_uu, dim=-1)
    S_cross = torch.stack(lags_cross, dim=-1)
    S_vv = torch.stack(lags_vv, dim=-1)
    acc = dfm.from_parts(S_uu * math.ldexp(1.0, 34),
                         S_cross * math.ldexp(1.0, 17), S_vv)
    scale = exact_exp2(2 * (pre.to(torch.int64) - 17 - s0))
    return (acc[0] * scale, acc[1] * scale)


def levinson_df(ac, max_order):
    """batched Levinson-Durbin in double-f32 arithmetic

    ac: df pair, each f64 [S, max_order+1].  Returns (coeffs f64
    [S, K, K], errors f64 [S, K]), both f32-valued; row o-1 of coeffs
    holds the order-o predictor, zero past column o-1.  Rows are kept
    as lists of df columns instead of the reference's in-place
    column writes; the arithmetic is the same op for op."""
    (ach, acl) = ac
    batch = ach.shape[:-1]
    K = max_order

    def at(i):
        return (ach[..., i], acl[..., i])

    def zero():
        return torch.zeros(batch, dtype=torch.float64, device=ach.device)

    one = (torch.ones(batch, dtype=torch.float64, device=ach.device),
           zero())
    k0 = dfm.div(at(1), at(0))
    rows = [[k0]]
    errors = [dfm.mul(at(0), dfm.sub(one, dfm.mul(k0, k0)))]

    for i in range(1, K):
        prev = rows[i - 1]
        acc = (zero(), zero())
        for j in range(i):
            acc = dfm.add(acc, dfm.mul(prev[j], at(i - j)))
        err_prev = errors[i - 1]
        ki = dfm.div(dfm.sub(at(i + 1), acc), err_prev)
        row = [dfm.sub(prev[j], dfm.mul(ki, prev[i - 1 - j]))
               for j in range(i)]
        rows.append(row + [ki])
        errors.append(dfm.mul(err_prev,
                              dfm.sub(one, dfm.mul(ki, ki))))

    coeffs = torch.zeros(batch + (K, K), dtype=torch.float64,
                         device=ach.device)
    for (i, row) in enumerate(rows):
        for (j, col) in enumerate(row):
            coeffs[..., i, j] = dfm.to_f32(col)
    errs = torch.stack([dfm.to_f32(e) for e in errors], dim=-1)
    return (coeffs, errs)


def _warmup_mask(n, K, device):
    """[1, K, n] bool: position i lies below order o (row o-1)"""
    pos = torch.arange(n, dtype=torch.int32, device=device)[None, None, :]
    order = torch.arange(1, K + 1, dtype=torch.int32,
                         device=device)[None, :, None]
    return pos < order


def _lagged(x_pad, K, j, n):
    """the window of ``x_pad`` (x padded left by K zeros) whose
    position i holds sample i-1-j: [S, 1, n]"""
    return x_pad[:, None, K - 1 - j:K - 1 - j + n]


def lpc_residuals_i32(samples, qlp, shifts, clip_bits):
    """batched integer LPC residuals for every order row, exact, in
    int32 via the reference's hi/lo sample split

    samples: int32 [S, n]; qlp: int32 [S, K, K]; shifts: int32 [S, K].
    Returns int32 [S, K, n] with warm-up positions zeroed.  The
    accumulators update in place to hold one [S, K, n] temporary at a
    time (the reference's arrays are immutable)."""
    (S, n) = samples.shape
    K = qlp.shape[1]
    hi_pad = torch.nn.functional.pad(samples >> 11, (K, 0))
    lo_pad = torch.nn.functional.pad(samples & 2047, (K, 0))
    A = torch.zeros((S, K, n), dtype=torch.int32, device=samples.device)
    Bv = torch.zeros_like(A)
    for j in range(K):
        q = qlp[:, :, j][:, :, None]
        A += q * _lagged(hi_pad, K, j, n)
        Bv += q * _lagged(lo_pad, K, j, n)
    s = shifts[:, :, None].to(torch.int32)
    s_le = torch.clamp(s, max=11)
    cap = torch.full_like(s_le, 1 << 19) << s_le             # 2^(19+s)
    A_sat = torch.clamp(A, min=-cap, max=cap)
    pred_lo = (A_sat << (11 - s_le)) + (Bv >> s_le)
    pred_hi = (A + (Bv >> 11)) >> (torch.clamp(s, min=11) - 11)
    pred = torch.where(s <= 11, pred_lo, pred_hi)
    del A, Bv, A_sat, pred_lo, pred_hi
    res = samples[:, None, :] - pred
    bound = 1 << clip_bits
    res = torch.clamp(res, -bound, bound)
    return res.masked_fill_(_warmup_mask(n, K, samples.device), 0)


def lpc_residuals_f64(samples, qlp, shifts, clip_bits):
    """batched integer LPC residuals via exact f64 accumulation (the
    wide-bound path: products < 2^40, sums < 2^45, all exact)"""
    (S, n) = samples.shape
    K = qlp.shape[1]
    x_pad = torch.nn.functional.pad(samples.to(torch.float64), (K, 0))
    acc = torch.zeros((S, K, n), dtype=torch.float64,
                      device=samples.device)
    for j in range(K):
        q = qlp[:, :, j].to(torch.float64)[:, :, None]
        acc += q * _lagged(x_pad, K, j, n)
    scale = exact_exp2(-shifts)[:, :, None]
    pred = torch.floor(acc * scale)
    res = samples[:, None, :].to(torch.float64) - pred
    bound = float(1 << clip_bits)
    res = torch.clamp(res, -bound, bound)
    res = res.masked_fill_(_warmup_mask(n, K, samples.device), 0.0)
    return res.to(torch.int32)


def lpc_residuals(samples, qlp, shifts, value_bits, precision,
                  clip_bits):
    """dispatches between the int32 hi/lo and exact-f64 residual paths
    on the reference's static bounds (value_bits: bits of |samples|)"""
    K = qlp.shape[1]
    logk = math.ceil(math.log2(max(K, 1)))
    hi_bits = logk + (precision - 1) + max(value_bits - 11, 0)
    bv_bits = logk + (precision - 1) + 11
    if hi_bits < 31 and bv_bits <= 29:
        return lpc_residuals_i32(samples, qlp, shifts, clip_bits)
    return lpc_residuals_f64(samples, qlp, shifts, clip_bits)


def _floor_log2(values):
    """exact floor(log2(v)) for v > 0, as float64: an approximate log2
    corrected by exact power-of-two comparisons"""
    approx = torch.floor(torch.log2(values))
    approx = torch.where(exact_exp2(approx + 1.0) <= values,
                         approx + 1.0, approx)
    return torch.where(exact_exp2(approx) > values, approx - 1.0, approx)


def ilog2_trunc(values):
    """exact int(log2(v)) truncated toward zero for v > 0, int32"""
    approx = _floor_log2(values)
    exact_power = exact_exp2(approx) == values
    trunc = torch.where((values >= 1.0) | exact_power, approx,
                        approx + 1.0)
    return trunc.to(torch.int32)


def frexp_exponent(values):
    """exact frexp exponent for v > 0 (floor(log2(v)) + 1), int32"""
    return (_floor_log2(values) + 1.0).to(torch.int32)


def quantize_all_orders(coeffs, precision):
    """batched error-feedback coefficient quantization for every order

    coeffs: f64 [..., K, K] from levinson_df; returns (qlp int32
    [..., K, K], shifts int32 [..., K]) with the reference's C
    (frexp, round-half-away) semantics"""
    K = coeffs.shape[-1]
    order_idx = torch.arange(K, device=coeffs.device)
    valid = order_idx[None, :] <= order_idx[:, None]          # [K, K]
    masked = torch.where(valid, torch.abs(coeffs), 0.0)
    l = torch.amax(masked, dim=-1)                            # [..., K]

    has_l = l > 0
    safe_l = torch.where(has_l, l, 1.0)
    e = frexp_exponent(safe_l)
    raw_shift = torch.clamp((precision - 1) - (e - 1) - 1,
                            -(1 << 4), (1 << 4) - 1)
    raw_shift = torch.where(has_l, raw_shift, 0)
    shift_nonneg = torch.clamp(raw_shift, min=0)
    scale = exact_exp2(raw_shift)

    qlp_max = float((1 << (precision - 1)) - 1)
    qlp_min = float(-(1 << (precision - 1)))

    error = torch.zeros(l.shape, dtype=torch.float64, device=l.device)
    cols = []
    for j in range(K):
        contribution = coeffs[..., j] * scale                 # exact
        active = valid[:, j]                                  # [K]
        error_candidate = f32round(error + contribution)
        rounded = torch.sign(error_candidate) * torch.floor(
            torch.abs(error_candidate) + 0.5)
        q = torch.clamp(rounded, qlp_min, qlp_max)
        new_error = error_candidate - rounded
        q = torch.where(active, q, 0.0)
        error = torch.where(active, new_error, error)
        cols.append(q.to(torch.int32))
    qlp = torch.stack(cols, dim=-1)
    return (qlp, shift_nonneg.to(torch.int32))


def estimate_best_lpc_order(errors, block_size, bits_per_sample,
                            qlp_precision, max_lpc_order):
    """batched log-domain order estimate (reference
    py_encoders/flac.py:676 semantics: strict <, earliest wins; the
    first order with error == 0 wins outright)

    errors: f64 [..., K]; bits_per_sample: f64 tensor broadcastable to
    the batch shape; returns int32 order per batch element"""
    error_scale = float(np.float32(np.log(2) ** 2))
    inv_2log2 = float(np.float32(1.0 / (np.log(2) * 2)))
    batch = errors.shape[:-1]
    dev = errors.device
    bps = torch.as_tensor(bits_per_sample, dtype=torch.float64,
                          device=dev)
    best_order = torch.zeros(batch, dtype=torch.int32, device=dev)
    best_bits = torch.full(batch, 1e32, dtype=torch.float64, device=dev)
    found_zero = torch.zeros(batch, dtype=torch.bool, device=dev)

    for i in range(max_lpc_order):
        order = i + 1
        err = errors[..., i]
        header_bits = order * (bps + qlp_precision)
        log_err = f32round(torch.log(
            torch.where(err > 0.0, err * error_scale, 1.0)))
        bits_per_residual = f32round(
            torch.clamp(log_err * inv_2log2, min=0.0))
        estimated = header_bits + bits_per_residual * (block_size - order)

        improves = (err > 0.0) & (estimated < best_bits) & ~found_zero
        best_order = torch.where(improves, order, best_order)
        best_bits = torch.where(improves, estimated, best_bits)

        is_zero = (err == 0.0) & ~found_zero
        best_order = torch.where(is_zero, order, best_order)
        found_zero = found_zero | is_zero

    return best_order
