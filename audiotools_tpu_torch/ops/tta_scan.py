"""Batched TTA encode analysis in torch + CUDA: the channel
decorrelation, the fixed predictor and the sign-adaptive hybrid filter.

Port of ``audiotools_tpu/ops/tta_scan.py``.  Decorrelation and the
fixed predictor are elementwise torch ops over a batch of frames.  The
hybrid filter is a true recurrence per lane (one channel of one TTA
frame): on a CUDA tensor ``hybrid_filter`` launches the hand-written
kernel ``csrc/tta_filter.cu`` (one thread a lane), which replaces the
reference's ``lax.scan``; on a CPU tensor it runs
``hybrid_filter_plain``, a loop over sample positions with every lane
advancing together, in int64 with explicit wraps to int32.  The
residuals are bit-identical to the reference's numpy form
(``hybrid_filter(np, ...)``); the byte-serial tail (adaptive Rice and
CRC-32) stays on the host (``_native.tta_pack_frames``).

The filter is defined mod 2^32 (the reference runs it in wrapping
int32).  The fixed predictor's ``(prev << shift) - prev`` can pass
int32 for 24-bit input, so it runs in int64, exactly, where the
reference takes a float64 floor.
"""

from __future__ import annotations

import torch

from .tta_synth import _shift_state, filter_shift_for, shift_for, wrap32
from .._device import COUNT_LOCK


def correlate(samples):
    """the encoder's channel decorrelation

    samples: int32 [F, n, ch]; returns int32 [F, n, ch]"""
    ch = samples.shape[2]
    if ch == 1:
        return samples
    diffs = samples[:, :, 1:] - samples[:, :, :-1]      # [F, n, ch-1]
    half = torch.div(diffs[:, :, -1], 2, rounding_mode="trunc")
    last = samples[:, :, -1] - half
    return torch.cat([diffs, last[:, :, None]], dim=2)


def fixed_predict(correlated, bps):
    """the fixed predictor over the sample axis:
    out[i] = c[i] - (((c[i-1] << s) - c[i-1]) >> s), out[0] = c[0]

    correlated: int32 [F, n, ch]; returns int32 [F, n, ch]"""
    shift = shift_for(bps)
    c = correlated.to(torch.int64)
    prev = c[:, :-1]
    pred = ((prev << shift) - prev) >> shift
    return torch.cat([c[:, :1], c[:, 1:] - pred], dim=1).to(torch.int32)


def _check_args(predicted, bps):
    if predicted.dim() != 2:
        raise ValueError("predicted must be 2-D [lanes, n]")
    if predicted.dtype != torch.int32:
        raise TypeError("predicted must be int32")
    if bps not in (8, 16, 24):
        raise ValueError("bits per sample %r unsupported" % (bps,))


def hybrid_filter_plain(predicted, bps):
    """plain torch version, on any device: the hybrid filter of [L, n]
    int32 lanes -> [L, n] int32 residuals

    Per lane, from the all-zero state (qm, dx, dl of 8, the previous
    residual):
      qm += sign(previous residual) * dx
      res = p - ((round + sum(dl * qm)) >> fshift),  round = 2^(fshift-1)
    then dx and dl rotate with the input p (tta_synth._shift_state).
    At step 0 the sign is 0 and the sum is round, so res = p, as the
    reference's special case has it."""
    _check_args(predicted, bps)
    fshift = filter_shift_for(bps)
    round_v = 1 << (fshift - 1)
    (L, n) = predicted.shape
    dev = predicted.device
    p64 = predicted.to(torch.int64)
    zeros = torch.zeros((L, 8), dtype=torch.int64, device=dev)
    (qm, dx, dl) = (zeros, zeros, zeros)
    prev_res = torch.zeros(L, dtype=torch.int64, device=dev)
    out = torch.empty((L, n), dtype=torch.int32, device=dev)
    for i in range(n):
        p = p64[:, i]
        qm = wrap32(qm + torch.sign(prev_res)[:, None] * dx)
        acc = wrap32(round_v + torch.sum(wrap32(dl * qm), dim=1))
        prev_res = wrap32(p - (acc >> fshift))
        out[:, i] = prev_res.to(torch.int32)
        (dx, dl) = _shift_state(dx, dl, p)
    return out


def hybrid_filter(predicted, bps):
    """the hybrid filter of a batch of lanes

    Same contract as hybrid_filter_plain.  A CPU tensor runs the plain
    version; a CUDA tensor launches the hand-written kernel
    (csrc/tta_filter.cu) on the current stream, without synchronising,
    and counts the launch in ``hybrid_filter.launches``.  Any other
    device raises."""
    if predicted.device.type == "cpu":
        return hybrid_filter_plain(predicted, bps)
    if predicted.device.type != "cuda":
        raise ValueError("hybrid_filter: unsupported device %s"
                         % (predicted.device,))
    _check_args(predicted, bps)
    from .. import kernels
    predicted = predicted.contiguous()
    out = torch.empty(predicted.shape, dtype=torch.int32,
                      device=predicted.device)
    if out.numel():
        kernels.tta_filter(predicted, filter_shift_for(bps), out)
        with COUNT_LOCK:
            hybrid_filter.launches += 1
    return out


hybrid_filter.launches = 0


def analyze_frames(samples, bps):
    """the whole TTA encode analysis for a batch of frames

    samples: int32 [F, n, ch] PCM (a short final frame zero-padded: the
    filter is causal, so a prefix of the padded result equals the
    unpadded run); returns residuals int32 [F, n, ch] on the samples'
    device"""
    (F, n, ch) = samples.shape
    predicted = fixed_predict(correlate(samples.to(torch.int32)), bps)
    lanes = predicted.permute(0, 2, 1).reshape(F * ch, n)
    res = hybrid_filter(lanes, bps)
    return res.view(F, ch, n).permute(0, 2, 1)
