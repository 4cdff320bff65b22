"""Batched ALAC subframe synthesis (the sign-adaptive predictor),
stereo decorrelation and LSB merge, in torch + CUDA.

Port of ``audiotools_tpu/ops/alac_synth.py``.  Each subframe row
inverts ALAC's predictor, which adapts its coefficients after every
sample by a walk that stops when the residual crosses zero (see
``csrc/alac_synth.cu`` for the recurrence, step for step).  The port
is held to the reference's numpy form (``synthesize(np, ...)``), which
the reference's tests hold to its scalar oracle: the prediction sum is
exact there in float64 and here in int64, so the port needs none of
the reference's guard (``pallas_synthesis_safe``) and none of its
fallback to the float64 scan.

On a CUDA tensor ``synthesize`` launches the hand-written kernel (two
threads a row, 16 rows of one order a warp, as ``group_rows`` lists
them); on a CPU tensor it runs ``synthesize_plain``, a loop over
sample positions with every row advancing together.  ``decorrelate``
and ``merge_lsbs`` are plain torch on every device.
"""

from __future__ import annotations

import numpy as np
import torch

from .._device import COUNT_LOCK

K = 32   # coefficient columns an ALAC subframe can need (order < 32)
MAX_ORDER = 8   # walk steps of the reference's decoder path
WARP_ROWS = 16  # rows a warp of the kernel synthesizes
CHAIN = 31      # orders from here up: the pure difference chain


def group_rows(order):
    """the kernel's row grouping, on the host: the rows of each order
    (every order >= CHAIN counting as one) in WARP_ROWS-row groups, each
    padded with -1, the orders ascending; int32 numpy [WARP_ROWS * warps].

    order: int numpy [S]."""
    key = np.minimum(np.asarray(order, dtype=np.int64), CHAIN)
    idx = np.argsort(key, kind="stable")
    (_keys, counts) = np.unique(key[idx], return_counts=True)
    padded = -(-counts // WARP_ROWS) * WARP_ROWS
    out = np.full(int(padded.sum()), -1, dtype=np.int32)
    starts = np.cumsum(padded) - padded
    firsts = np.cumsum(counts) - counts
    for (start, first, count) in zip(starts, firsts, counts):
        out[start:start + count] = idx[first:first + count]
    return out


def _check_rows(rows, residuals, values):
    """the row grouping's form, and with ``values`` (a CPU tensor) its
    values: a card's caller builds it on the host with group_rows"""
    if rows.dim() != 1 or rows.dtype != torch.int32:
        raise ValueError("rows must be a 1-D int32 tensor")
    if rows.device != residuals.device:
        raise ValueError("rows lies on another device than residuals")
    if rows.shape[0] % WARP_ROWS:
        raise ValueError("rows must hold whole groups of %d" % WARP_ROWS)
    if values:
        S = residuals.shape[0]
        listed = rows[rows >= 0]
        if (bool((rows < -1).any()) or listed.numel() != S or
                not torch.equal(torch.sort(listed).values,
                                torch.arange(S, dtype=torch.int32))):
            raise ValueError("rows must list every row once, -1 padding")


def _check_args(residuals, qlp, order, shift, sample_size, max_order):
    if residuals.dim() != 2 or qlp.dim() != 2:
        raise ValueError("residuals and qlp must be 2-D")
    S = residuals.shape[0]
    if (qlp.shape[0] != S or order.shape != (S,) or shift.shape != (S,)
            or sample_size.shape != (S,)):
        raise ValueError("qlp must be [S, kw], order, shift and "
                         "sample_size [S], for residuals [S, n]")
    if not 1 <= qlp.shape[1] <= K:
        raise ValueError("coefficient width %d outside 1..%d"
                         % (qlp.shape[1], K))
    if not 1 <= max_order <= K:
        raise ValueError("max_order %d outside 1..%d" % (max_order, K))
    tensors = (residuals, qlp, order, shift, sample_size)
    if any(t.dtype != torch.int32 for t in tensors):
        raise TypeError("synthesis inputs must be int32")
    if any(t.device != residuals.device for t in tensors):
        raise ValueError("synthesis inputs lie on different devices")


def _check_values(qlp, order, shift):
    """the value ranges the synthesis is defined for (reads the
    tensors, so a card's caller checks them on the host)"""
    if shift.numel() and (int(shift.min()) < 0 or int(shift.max()) > 31):
        raise ValueError("shift outside 0..31")
    lpc = order < 31
    if bool((lpc & ((order < 0) | (order > qlp.shape[1]))).any()):
        raise ValueError("an order below 31 exceeds the coefficient "
                         "columns given")


def _trunc(v, nmask, sbit):
    """two's-complement truncation to sample_size bits (int64 in, int64
    out): nmask = 2^size - 1, sbit = 2^(size - 1)"""
    return ((v & nmask) ^ sbit) - sbit


def synthesize_plain(residuals, qlp, order, shift, sample_size,
                     max_order=MAX_ORDER, stats=None):
    """plain torch version of the synthesis, on any device

    residuals: int32 [S, n] (raw rows are selected by the caller);
    qlp: int32 [S, kw] initial coefficients (kw >= every order below
    31); order: int32 [S], >= 31 selects the pure difference chain;
    shift: int32 [S] in 0..31; sample_size: int32 [S].  max_order:
    steps of the adaptation walk.  Returns int32 [S, n].  The walk and
    the window are int32 with torch's wrapping arithmetic, as the
    reference's numpy form is; the prediction sum is int64.  stats: an
    optional dict whose "walk_steps" receives the number of walk steps
    the rows took (the data-dependent part of the work)."""
    _check_args(residuals, qlp, order, shift, sample_size, max_order)
    _check_values(qlp, order, shift)
    (S, n) = residuals.shape
    dev = residuals.device
    kw = qlp.shape[1]
    ordv = order.to(torch.int64)
    ord_eff = torch.where(ordv >= 31, n, ordv)
    sh = shift.to(torch.int64)
    sh32 = shift
    ss = torch.clamp(sample_size.to(torch.int64), 1, 30)
    nmask = (torch.ones_like(ss) << ss) - 1
    sbit = torch.ones_like(ss) << (ss - 1)
    half = torch.where(sh > 0, torch.ones_like(sh) << torch.clamp(sh - 1,
                                                                 0, 30), 0)
    jj = torch.arange(kw, device=dev)[None, :]
    q = torch.where(jj < ordv[:, None], qlp, 0)
    tt = torch.arange(max_order, device=dev)[None, :]
    pn = ordv[:, None] - 1 - tt                              # [S, T]
    pn_col = torch.clamp(pn, 0, kw - 1)
    walk_live = pn >= 0
    base_idx = torch.clamp(ordv, 0, kw)[:, None]
    rows = torch.arange(S, device=dev)
    window = torch.zeros((S, kw + 1), dtype=torch.int32, device=dev)
    out = torch.empty((S, n), dtype=torch.int32, device=dev)
    for i in range(n):
        res = residuals[:, i]
        if i == 0:
            val_out = res
        else:
            prev = window[:, 0].to(torch.int64)
            diff_val = _trunc(prev + res.to(torch.int64), nmask, sbit)
            base = torch.take_along_dim(window, base_idx, dim=1)[:, 0]
            diffs = window[:, :kw] - base[:, None]             # wraps
            acc = torch.sum(q.to(torch.int64) * diffs.to(torch.int64),
                            dim=1)
            main_val = _trunc(((half + acc) >> sh) + res.to(torch.int64)
                              + base.to(torch.int64), nmask, sbit)
            main = i >= ord_eff + 1
            residual = res
            s0 = torch.sign(res)
            walk_vals = torch.take_along_dim(window, pn_col, dim=1)
            for t in range(max_order):
                active = (residual * s0 > 0) & walk_live[:, t] & main
                steps = int(active.sum())
                if stats is not None:
                    stats["walk_steps"] = stats.get("walk_steps", 0) + steps
                if not steps:
                    break       # a row once inactive stays inactive
                val = base - walk_vals[:, t]
                sgn = s0 * torch.sign(val)
                col = pn_col[:, t]
                q[rows, col] = torch.where(active, q[rows, col] - sgn,
                                           q[rows, col])
                delta = ((val * sgn) >> sh32) * (t + 1)
                residual = torch.where(active, residual - delta, residual)
            val_out = torch.where(i <= ord_eff, diff_val,
                                  main_val).to(torch.int32)
        out[:, i] = val_out
        window = torch.cat([val_out[:, None], window[:, :kw]], dim=1)
    return out


def synthesize(residuals, qlp, order, shift, sample_size,
               max_order=MAX_ORDER, rows=None):
    """inverts the sign-adaptive predictors for a batch of subframes

    Same contract as synthesize_plain.  rows: the kernel's row grouping
    (``group_rows`` of the orders, as an int32 tensor on the device of
    the other arguments), which the caller builds on the host; None
    builds it from a host copy of ``order``, which waits for the card
    (tests only: the decoder passes it).  A CPU tensor runs the plain
    version; a CUDA tensor launches the hand-written kernel
    (csrc/alac_synth.cu) on the current stream and counts the launch
    in ``synthesize.launches``.  The card's caller checks the value
    ranges on the host (``_check_values``); out of them the kernel's
    output is undefined, its memory accesses stay in bounds.  Any
    other device raises."""
    if residuals.device.type == "cpu":
        if rows is not None:
            _check_rows(rows, residuals, values=True)
        return synthesize_plain(residuals, qlp, order, shift, sample_size,
                                max_order)
    if residuals.device.type != "cuda":
        raise ValueError("synthesize: unsupported device %s"
                         % (residuals.device,))
    if rows is None:
        rows = torch.as_tensor(group_rows(order.cpu().numpy()),
                               device=residuals.device)
    return _launch(residuals, qlp, order, shift, sample_size, max_order,
                   rows)


def _launch(residuals, qlp, order, shift, sample_size, max_order, rows):
    """the card's branch of synthesize, after its row grouping is
    known: checks the arguments' forms, reads nothing back from the
    device, and launches the kernel"""
    _check_args(residuals, qlp, order, shift, sample_size, max_order)
    _check_rows(rows, residuals, values=False)
    from .. import kernels
    args = [t.contiguous() for t in (residuals, qlp, order, shift,
                                     sample_size, rows)]
    out = torch.empty(residuals.shape, dtype=torch.int32,
                      device=residuals.device)
    if out.numel():
        kernels.alac_synth(*args, max_order, out)
        with COUNT_LOCK:
            synthesize.launches += 1
    return out


synthesize.launches = 0


def decorrelate(ch0, ch1, lweight, ishift):
    """undoes the interlaced-stereo correlation of channel pairs

    ch0, ch1: int32 [G, n]; lweight, ishift: int32 [G] (lweight 0 = an
    uncorrelated pair, passed through).  Returns (left, right), int32
    [G, n], with numpy's int64 arithmetic narrowed to int32."""
    lw = lweight.to(torch.int64)[:, None]
    sh = ishift.to(torch.int64)[:, None]
    c0 = ch0.to(torch.int64)
    c1 = ch1.to(torch.int64)
    right = c0 - ((c1 * lw) >> sh)
    left = c1 + right
    live = (lweight != 0)[:, None]
    return (torch.where(live, left, c0).to(torch.int32),
            torch.where(live, right, c1).to(torch.int32))


def merge_lsbs(samples, lsbs, lsb_bits):
    """re-attaches the uncompressed low bytes after decorrelation

    samples, lsbs: int32 [G, n] (lsbs zero where a pair has none);
    lsb_bits: int32 [G] (0 = no low bytes)"""
    ls = lsb_bits.to(torch.int64)[:, None]
    merged = (samples.to(torch.int64) << ls) | lsbs.to(torch.int64)
    return merged.to(torch.int32)
