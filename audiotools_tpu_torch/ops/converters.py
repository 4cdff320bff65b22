"""The converter suite's device programs, as functions on tensors.

The port's counterparts of the reference's ``ops/converters.py``: each
runs on the device of its tensors (the CPU in the tests, a card
otherwise) and is held to the host C++ twin in ``_native``.

* **Resampler FIR** (``resample_fir``, ``resample_banded``): the
  windowed-sinc sum ``out[m, c] = sum_t bank[q[m], t] * hist[starts[m]
  + t, c]`` in float64.  For a rational step num/den with a bank row a
  phase, output k*den + r has phase (r*num) mod den and starts at
  k*num + floor(r*num/den), so a block of outputs is one product of
  the input windows at stride num with a banded bank
  (``polyphase_band``); a quantised bank gathers a window an output.
  Both bound their memory by slabs, at any read size.
* **ReplayGain equal-loudness analysis** (``rg_window_sums``): the
  10th-order Yulewalk and 2nd-order Butterworth IIR cascade is linear
  and its impulse response decays below 1e-13 of its peak within
  8,000 samples at every supported rate, so the recurrence becomes one
  causal float64 FIR (``rg_combined_fir``, built by the host IIR) by
  overlap-save FFTs, then squares and 50 ms window sums.  float64
  throughout: a card runs float32 products as TF32.
* **AccurateRip V1/V2** (``accuraterip_sums``): exact int64 products of
  a frame's value and its index, and their windowed sums of the low and
  high 32-bit words.

``rg_window_sums_host`` is the reference's host analysis over the port's
C++ IIR, kept to check and time the device form against.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from .. import _native
from .replaygain_coeffs import BUTTER, YULE

# bytes a slab of gathered or unfolded windows may take
SLAB_BYTES = 64 << 20
# bytes a banded bank may take; a larger one gathers instead
BAND_BYTES = 256 << 20


# ---------------------------------------------------------------------------
# Resampler FIR


def resample_fir(hist, starts, q, bank):
    """``out[m, c] = sum_t bank[q[m], t] * hist[starts[m] + t, c]``

    hist: float64 [L, ch]; starts, q: int64 [M]; bank: float64 [D,
    taps]; all on one device.  Returns float64 [M, ch].  The windows are
    selected a slab of outputs at a time, SLAB_BYTES at most, from the
    channel-major history's windows at stride 1, whole windows at a
    time (indexing the [L, ch] history by [S, taps] positions gathers 16
    bytes at a time and runs some 50 times slower on a card)."""
    (ch, taps) = (hist.shape[1], bank.shape[1])
    M = starts.shape[0]
    out = torch.empty((M, ch), dtype=torch.float64, device=hist.device)
    windows = hist.T.contiguous().unfold(1, taps, 1)     # [ch, L', taps]
    slab = max(1, SLAB_BYTES // (taps * ch * 8))
    for s0 in range(0, M, slab):
        win = windows[:, starts[s0:s0 + slab]]             # [ch, S, taps]
        win *= bank[q[s0:s0 + slab]]
        out[s0:s0 + slab] = win.sum(dim=2).T
    return out


def to_int(samples, bits_per_sample):
    """float64 samples in [-1, 1) as int32 at ``bits_per_sample``:
    truncated toward zero, then clamped to the sample range (the
    reference's ``FloatFrameList.to_int``), on the samples' device"""
    adjustment = 1 << (bits_per_sample - 1)
    return torch.trunc(samples * adjustment).clamp_(
        -adjustment, adjustment - 1).to(torch.int32)


def band_group(taps, num):
    """the periods a banded block spans: enough that its window stride
    (group * num) reaches the taps, so a window is at most about twice
    the samples it advances"""
    return max(1, -(-taps // num))


def polyphase_band(bank, num, den, group):
    """the banded bank of ``group`` periods of the step num/den: row r
    (output r of a block of group * den) holds ``bank[(r * num) % den]``
    from column ``(r * num) // den``; float64 [group * den, taps +
    group * num - 1] on the bank's device"""
    taps = bank.shape[1]
    r = torch.arange(group * den, device=bank.device)
    band = torch.zeros((group * den, taps + group * num - 1),
                       dtype=torch.float64, device=bank.device)
    cols = (r * num // den)[:, None] + torch.arange(taps,
                                                    device=bank.device)
    return band.scatter_(1, cols, bank[r * num % den])


def band_bytes(taps, num, den):
    """the bytes of ``polyphase_band`` for the step num/den"""
    group = band_group(taps, num)
    return group * den * (taps + group * num - 1) * 8


def resample_banded(span, blocks, band, stride):
    """the outputs of ``blocks`` consecutive blocks of a banded bank:
    block k's window is ``span[k * stride:k * stride + width]``

    span: float64 [(blocks - 1) * stride + width, ch]; band: float64
    [rows, width] (``polyphase_band``).  Returns float64 [blocks * rows,
    ch], block after block.  The windows are unfolded a slab of blocks
    at a time, SLAB_BYTES at most."""
    (rows, width) = band.shape
    ch = span.shape[1]
    out = torch.empty((blocks, rows, ch), dtype=torch.float64,
                      device=span.device)
    windows = span.T.unfold(1, width, stride)            # [ch, blocks, width]
    slab = max(1, SLAB_BYTES // (ch * width * 8))
    for k0 in range(0, blocks, slab):
        part = torch.matmul(windows[:, k0:k0 + slab], band.T)
        out[k0:k0 + slab] = part.permute(1, 2, 0)
    return out.reshape(blocks * rows, ch)


# ---------------------------------------------------------------------------
# ReplayGain equal-loudness analysis


# impulse-response tail threshold (the reference's): truncating where
# the combined response falls below this keeps the windowed-RMS
# relative error orders of magnitude under the 0.01 dB histogram bin
_H_TOL = 1e-13
# sample rate -> its read-only response; threads that miss at once each
# build the same one and one store wins, so it needs no lock
_fir_cache = {}


def rg_combined_fir(sample_rate):
    """the combined Yulewalk and Butterworth impulse response, truncated
    where |h| stays below _H_TOL * max|h| for good; float64, read-only,
    built once per rate with the host IIR (``_native.iir``), as the
    reference builds it"""
    if sample_rate not in _fir_cache:
        (yb, ya) = YULE[sample_rate]
        (bb, ba) = BUTTER[sample_rate]
        impulse = np.zeros(1 << 15, dtype=np.float64)
        impulse[0] = 1.0
        (step1, _z) = _native.iir(yb, ya, impulse, np.zeros(10))
        (h, _z) = _native.iir(bb, ba, step1, np.zeros(2))
        mag = np.abs(h)
        keep = np.nonzero(mag > _H_TOL * mag.max())[0]
        h = np.ascontiguousarray(h[:int(keep[-1]) + 1 if len(keep) else 1])
        h.flags.writeable = False
        _fir_cache[sample_rate] = h
    return _fir_cache[sample_rate]


def rg_window_sums(left, right, h, window_samples, segment=1 << 20):
    """the sums of each full window of ``window_samples`` of y_L^2 + y_R^2,
    where y is the causal FIR h over each channel from silence

    left, right: float64 [n]; h: float64 [L]; all on one device.
    Returns float64 [n // window_samples]: the trailing partial window
    is dropped.  The FIR runs as overlap-save FFTs of ``segment`` samples
    (fewer for a short title), each carrying L - 1 samples of the one
    before, a few segments at a time, so that memory stays bounded at
    any length."""
    nwin = left.shape[0] // window_samples
    n = nwin * window_samples
    out_sq = torch.empty(n, dtype=torch.float64, device=left.device)
    if n == 0:
        return out_sq
    L = h.shape[0]
    size = min(segment, 1 << (n + L - 2).bit_length())
    if size <= L - 1:
        raise ValueError("segment must exceed the FIR's length")
    step = size - (L - 1)
    nseg = -(-n // step)
    H = torch.fft.rfft(h, size)
    padded = F.pad(torch.stack([left[:n], right[:n]]),
                   (L - 1, nseg * step - n))
    segments = padded.unfold(1, size, step)             # [2, nseg, size]
    group = max(1, SLAB_BYTES // (2 * size * 8))
    for g0 in range(0, nseg, group):
        spec = torch.fft.rfft(segments[:, g0:g0 + group], dim=-1) * H
        y = torch.fft.irfft(spec, n=size, dim=-1)[..., L - 1:]
        sq = (y[0] * y[0] + y[1] * y[1]).reshape(-1)
        start = g0 * step
        out_sq[start:start + sq.shape[0]] = sq[:n - start]
    return out_sq.view(nwin, window_samples).sum(dim=1)


def rg_window_sums_host(left, right, sample_rate, window_samples):
    """``rg_window_sums`` as the reference's host analysis computes it:
    the Yulewalk and Butterworth IIRs over each channel from zero state
    (``_native.iir``), then each full window's sum; numpy float64"""
    (yb, ya) = YULE[sample_rate]
    (bb, ba) = BUTTER[sample_rate]
    squared = 0.0
    for x in (left, right):
        (stepped, _z) = _native.iir(yb, ya, x, np.zeros(10))
        (out, _z) = _native.iir(bb, ba, stepped, np.zeros(2))
        squared = squared + out * out
    nwin = len(left) // window_samples
    return np.array([squared[w * window_samples:(w + 1) * window_samples]
                     .sum() for w in range(nwin)], dtype=np.float64)


# ---------------------------------------------------------------------------
# AccurateRip V1/V2


def accuraterip_sums(samples, first_index, start_offset, end_offset):
    """the windowed sums (low, high) of ``p & 0xFFFFFFFF`` and ``p >> 32``
    over the frames whose index lies in [start_offset, end_offset],
    where frame i has index first_index + i, value ``(R & 0xFFFF) << 16 |
    (L & 0xFFFF)`` and ``p = value * index``

    samples: int32 or int64 [n, 2] on any device; returns two int64
    0-d tensors there.  Exact: raises ValueError when an index reaches
    2^31, past which p could overflow int64."""
    n = samples.shape[0]
    if first_index + n > 1 << 31:
        raise ValueError("AccurateRip frame index past 2^31 - 1")
    i0 = max(0, start_offset - first_index)
    i1 = min(n, end_offset - first_index + 1)
    s = samples[i0:max(i0, i1)].to(torch.int64)
    value = ((s[:, 1] & 0xFFFF) << 16) | (s[:, 0] & 0xFFFF)
    index = torch.arange(first_index + i0, first_index + i0 + s.shape[0],
                         dtype=torch.int64, device=samples.device)
    p = value * index
    return ((p & 0xFFFFFFFF).sum(), (p >> 32).sum())
