"""Batched FLAC subframe synthesis and stereo reconstruction, in torch
+ CUDA.

Port of ``audiotools_tpu/ops/flac_synth.py``.  Each subframe row
inverts its predictor, seeded from the stored warm-up samples:

    s[i] = warmup[i]                                   for i < order
    s[i] = wrap32(r[i] + ((sum_j q[j] * s[i-1-j]) >> shift))  otherwise

with the sum over every coefficient column (FIXED rows carry the fixed
difference coefficients, see ``fill_fixed_qlp``; CONSTANT and VERBATIM
rows have order 0 and zero coefficients, so they pass through).  The
sum is exact in int64 (at most 32 products of 15-bit coefficients and
31-bit samples), so the arithmetic shift equals the reference's exact
float64 floor form by construction, and no guard or fallback is
needed; ``wrap32`` is numpy's ``astype(int64).astype(int32)``.

On a CUDA tensor ``synthesize`` launches the hand-written kernel in
``csrc/flac_synth.cu`` (rows staged through shared memory, two threads
a row, the history in registers); on a CPU tensor it runs
``synthesize_plain``.  ``reconstruct_frames`` (wasted bits, stereo
decorrelation, interleave) is plain torch on every device.
"""

from __future__ import annotations

import numpy as np
import torch

from .._device import COUNT_LOCK

K = 32   # coefficient columns a FLAC subframe can need (order <= 32)

FIXED_COEFFS = {
    0: [],
    1: [1],
    2: [2, -1],
    3: [3, -3, 1],
    4: [4, -6, 4, -1],
}


def fill_fixed_qlp(sub_meta, qlp):
    """host-side (numpy): writes the FIXED-predictor coefficient rows
    into a copy of the qlp array for subframes of type 2 (sub_meta
    layout from _native.flac_scan) and returns it"""
    qlp = np.array(qlp, dtype=np.int32, copy=True)
    for order, coeffs in FIXED_COEFFS.items():
        rows = np.nonzero((sub_meta[:, 1] == 2) &
                          (sub_meta[:, 2] == order))[0]
        if len(rows):
            qlp[rows] = 0
            for j, c in enumerate(coeffs):
                qlp[rows, j] = c
    return qlp


def _check_args(residuals, warmup, qlp, shift, order):
    if residuals.dim() != 2 or warmup.dim() != 2 or qlp.dim() != 2:
        raise ValueError("residuals, warmup and qlp must be 2-D")
    (S, _n) = residuals.shape
    Kw = qlp.shape[1]
    if (warmup.shape != (S, Kw) or shift.shape != (S,)
            or order.shape != (S,)):
        raise ValueError("warmup and qlp must be [S, Kw], shift and "
                         "order [S], for residuals [S, n]")
    if not 1 <= Kw <= K:
        raise ValueError("coefficient width %d outside 1..%d" % (Kw, K))
    tensors = (residuals, warmup, qlp, shift, order)
    if any(t.dtype != torch.int32 for t in tensors):
        raise TypeError("synthesis inputs must be int32")
    if any(t.device != residuals.device for t in tensors):
        raise ValueError("synthesis inputs lie on different devices")


def synthesize_plain(residuals, warmup, qlp, shift, order):
    """plain torch version of the synthesis, on any device

    residuals: int32 [S, n] (positions < order are ignored); warmup,
    qlp: int32 [S, Kw]; shift, order: int32 [S].  Returns int32
    [S, n]."""
    _check_args(residuals, warmup, qlp, shift, order)
    (S, n) = residuals.shape
    Kw = qlp.shape[1]
    q = qlp.to(torch.int64)
    sh = torch.clamp(shift.to(torch.int64), 0, 63)
    hist = torch.zeros((S, Kw), dtype=torch.int64, device=residuals.device)
    out = torch.empty((S, n), dtype=torch.int32, device=residuals.device)
    zero = torch.zeros(S, dtype=torch.int32, device=residuals.device)
    for i in range(n):
        pred = torch.sum(q * hist, dim=1) >> sh
        warm = warmup[:, i] if i < Kw else zero
        val = torch.where(i < order, warm.to(torch.int64),
                          residuals[:, i].to(torch.int64) + pred)
        v32 = val.to(torch.int32)
        out[:, i] = v32
        hist = torch.cat([v32[:, None].to(torch.int64), hist[:, :-1]],
                         dim=1)
    return out


def nonzero_columns(qlp):
    """host-side (numpy): the coefficient columns up to the last one
    that holds a nonzero value in any row (what ``taps`` may be)"""
    cols = np.flatnonzero(np.asarray(qlp).any(axis=0))
    return int(cols[-1]) + 1 if len(cols) else 0


def synthesize(residuals, warmup, qlp, shift, order, taps=None):
    """inverts the predictors for a batch of subframes

    Same contract as synthesize_plain.  A CPU tensor runs the plain
    version; a CUDA tensor launches the hand-written kernel
    (csrc/flac_synth.cu) on the current stream, without synchronising,
    and counts the launch in ``synthesize.launches``.  Any other device
    raises.  ``taps``, known on the host (``nonzero_columns``), tells
    the kernel that columns ``taps`` and up of qlp are 0, so it
    multiplies only the first ones; None takes all Kw."""
    Kw = qlp.shape[-1]
    taps = Kw if taps is None else int(taps)
    if not 0 <= taps <= Kw:
        raise ValueError("taps %d outside 0..%d" % (taps, Kw))
    if residuals.device.type == "cpu":
        return synthesize_plain(residuals, warmup, qlp, shift, order)
    if residuals.device.type != "cuda":
        raise ValueError("synthesize: unsupported device %s"
                         % (residuals.device,))
    _check_args(residuals, warmup, qlp, shift, order)
    from .. import kernels
    args = [t.contiguous() for t in (residuals, warmup, qlp, shift, order)]
    out = torch.empty(residuals.shape, dtype=torch.int32,
                      device=residuals.device)
    if out.numel():
        kernels.flac_synth(*args, taps, out)
        with COUNT_LOCK:
            synthesize.launches += 1
    return out


synthesize.launches = 0


def reconstruct_frames(samples, wasted, frame_assignment, ch):
    """wasted-bits restore + stereo decorrelation + interleave

    samples: int32 [F * ch, n] synthesized subframe planes (frame f's
    channels at rows f*ch..f*ch+ch); wasted: int32 [F * ch];
    frame_assignment: int32 [F] FLAC channel assignment (0-7
    independent, 8 left-side, 9 side-right, 10 mid-side).  Returns
    int32 [F, n, ch] interleaved PCM; int32 arithmetic wraps as the
    reference's does."""
    n = samples.shape[1]
    shifted = torch.bitwise_left_shift(samples, wasted[:, None])
    F = frame_assignment.shape[0]
    planes = shifted.reshape(F, ch, n)
    if ch == 2:
        a = frame_assignment[:, None]
        c0 = planes[:, 0]
        c1 = planes[:, 1]
        msum = torch.bitwise_left_shift(c0, 1) | (c1 & 1)
        left = torch.where(a == 9, c0 + c1,
                           torch.where(a == 10, (msum + c1) >> 1, c0))
        right = torch.where(a == 8, c0 - c1,
                            torch.where(a == 10, (msum - c1) >> 1, c1))
        planes = torch.stack([left, right], dim=1)
    return planes.transpose(1, 2)
