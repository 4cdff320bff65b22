"""Batched ALAC LPC analysis in torch, bit-identical to the
reference's numpy form (``audiotools_tpu/ops/alac_frames.py``).

ALAC's residual filter and its Rice variant adapt per sample, so the
encoder's back half runs on the host (``_native.alac_emit_framesets``);
the front half runs here, for every (block, channel group,
interlacing leftweight, channel) candidate at once: Tukey windowing,
the 9-lag autocorrelation, Levinson-Durbin and ALAC's error-feedback
coefficient quantization, plus an integer residual-size estimate that
ranks the candidates.  The numerics are ``ops/lpc``'s: every product
exact, every sum an exact integer sum or one add followed by an f32
re-round, so the card, the CPU and the reference agree bit for bit.
"""

from __future__ import annotations

import torch

from . import lpc as lpc_ops

QLP_SHIFT_NEEDED = 9
N_LEFTWEIGHTS = 5          # leftweight candidates 0..4

# packed per-(block, group, leftweight, channel) layout:
#   cols 0..3  qlp order-4 coefficients
#   cols 4..11 qlp order-8 coefficients
#   col 12     degenerate flag (windowed autocorrelation[0] == 0)
#   col 13     order-4 residual-size estimate (see residual_estimate;
#              selects order and leftweight)
#   col 14     order-8 residual-size estimate
PACKED_COLS = 15


def alac_quantize(coeff_row):
    """ALAC error-feedback quantization of one order's coefficients

    coeff_row: f64 [..., order] (f32-valued, from levinson_df); returns
    int32 [..., order]: scale 2^9, round half to even, clamp to signed
    16 bits"""
    order = coeff_row.shape[-1]
    error = torch.zeros(coeff_row.shape[:-1], dtype=torch.float64,
                        device=coeff_row.device)
    cols = []
    for j in range(order):
        candidate = lpc_ops.f32round(
            error + coeff_row[..., j] * float(1 << QLP_SHIFT_NEEDED))
        q = torch.clamp(torch.round(candidate), -(1 << 15), (1 << 15) - 1)
        error = candidate - q
        cols.append(q.to(torch.int32))
    return torch.stack(cols, dim=-1)


def correlate(ch0, ch1, shift, leftweight):
    """ALAC channel interlacing, int32-exact for <= 17-bit inputs;
    leftweight 0 passes through"""
    if leftweight == 0:
        return (ch0, ch1)
    return (ch1 + (((ch0 - ch1) * leftweight) >> shift), ch0 - ch1)


def residual_estimate(X, qlp, order):
    """integer-exact estimate of a candidate's residual magnitude

    X: int32 [S, n]; qlp: int32 [S, order].  The non-adaptive ALAC-form
    residuals e_i = x_i - base_i - ((sum_j q_j (x_{i-1-j} - base_i))
    >> 9), base_i = x_{i-order-1}, over i in [order+1, n); returns
    min(floor(sum |e_i| / 64), 2^31 - 1) as int32.  Every value is an
    exact integer in float64 (products <= 2^36, sums <= 2^40)."""
    n = X.shape[1]
    count = n - 1 - order
    if count <= 0:
        return torch.zeros(X.shape[0], dtype=torch.int32, device=X.device)
    Xf = X.to(torch.float64)
    qf = qlp.to(torch.float64)
    conv = torch.zeros((X.shape[0], count), dtype=torch.float64,
                       device=X.device)
    for j in range(order):
        conv += qf[:, j:j + 1] * Xf[:, order - j:n - 1 - j]
    base = Xf[:, 0:count]
    Q = torch.sum(qf, dim=1)[:, None]
    shifted = torch.floor((conv - base * Q) *
                          (1.0 / float(1 << QLP_SHIFT_NEEDED)))
    e = Xf[:, order + 1:n] - base - shifted
    total = torch.sum(torch.abs(e), dim=1)
    return torch.clamp(torch.floor(total * (1.0 / 64.0)),
                       max=float((1 << 31) - 1)).to(torch.int32)


def lpc_candidates(X, window):
    """windowed LPC coefficient candidates for a batch of channels

    X: int32 [S, n] (after the LSB shift, possibly correlated);
    window: (hi, lo) pair from lpc.window_to_torch.  Returns int32
    [S, PACKED_COLS]: qlp4, qlp8, degenerate flag, order-4 and order-8
    residual-size estimates."""
    autocorr = lpc_ops.windowed_autocorr_df(X, window, 8)
    degenerate = autocorr[0][:, 0] == 0.0
    (coeffs, _errors) = lpc_ops.levinson_df(autocorr, 8)
    qlp4 = torch.where(degenerate[:, None], 0,
                       alac_quantize(coeffs[:, 3, :4]))
    qlp8 = torch.where(degenerate[:, None], 0,
                       alac_quantize(coeffs[:, 7, :8]))
    est4 = residual_estimate(X, qlp4, 4)
    est8 = residual_estimate(X, qlp8, 8)
    return torch.cat([qlp4, qlp8, degenerate[:, None].to(torch.int32),
                      est4[:, None], est8[:, None]], dim=1)


def analyze_framesets_packed(blocks, layout, lsb_shift, interlacing_shift,
                             min_leftweight, max_leftweight, window):
    """LPC candidates for every (block, group, leftweight, channel)

    blocks: int16 or int32 [B, n, ch] (the reader's channel order; the
    group offsets index it directly, as in the reference); layout:
    (offset, width) groups (``ref.alac.FRAMESET_LAYOUT``); lsb_shift:
    bps - 16 for > 16-bit streams, whose samples are shifted before the
    analysis (the emitter carries the low bytes verbatim); window: the
    block's (hi, lo) Tukey window on the blocks' device.

    Returns int32 [B, G, N_LEFTWEIGHTS, 2, PACKED_COLS]; width-1 groups
    fill only [:, g, 0, 0]."""
    B = blocks.shape[0]
    series = []
    slots = []           # (group, leftweight, channel) per series
    for (g, (offset, width)) in enumerate(layout):
        c0 = blocks[:, :, offset].to(torch.int32) >> lsb_shift
        if width == 1:
            series.append(c0)
            slots.append((g, 0, 0))
            continue
        c1 = blocks[:, :, offset + 1].to(torch.int32) >> lsb_shift
        for lw in range(min_leftweight, max_leftweight + 1):
            (s0, s1) = correlate(c0, c1, interlacing_shift, lw)
            series.extend([s0, s1])
            slots.extend([(g, lw, 0), (g, lw, 1)])
    X = torch.cat(series, dim=0)                  # [B * n_series, n]
    rows = lpc_candidates(X, window).reshape(len(series), B, PACKED_COLS)
    full = torch.zeros((B, len(layout), N_LEFTWEIGHTS, 2, PACKED_COLS),
                       dtype=torch.int32, device=blocks.device)
    for (i, (g, lw, ch)) in enumerate(slots):
        full[:, g, lw, ch] = rows[i]
    return full
