"""Batched TTA decode synthesis: the inverse hybrid filter and inverse
fixed predictor, and the inverse channel decorrelation, in torch +
CUDA.

Port of ``audiotools_tpu/ops/tta_synth.py`` (with ``shift_for``,
``filter_shift_for`` and the state rotation ``_shift_state`` of
``ops/tta_scan.py``).  Each lane (one channel of one TTA frame)
inverts the sign-adaptive 8-tap hybrid filter, whose state (qm, dx,
dl) is defined mod 2^32, and the fixed predictor
``x = p + prev + ((-prev) >> shift)`` (see ``csrc/tta_synth.cu`` for
the recurrence, step for step).  The port is held to the reference's
numpy form (``inverse_filter_predict(np, ...)``).

On a CUDA tensor ``inverse_filter_predict`` launches the hand-written
kernel (one thread per lane, lanes staged through shared memory, the
state in registers renamed step by step); on a CPU tensor it runs
``inverse_filter_predict_plain``, a loop over sample positions with
every lane advancing together, in int64 with explicit wraps to int32.
``decorrelate_inverse`` and ``synthesize`` are plain torch around it.
"""

from __future__ import annotations

import torch

from .._device import COUNT_LOCK


def shift_for(bps):
    """the fixed predictor's shift"""
    return {8: 4, 16: 5, 24: 5}[bps]


def filter_shift_for(bps):
    """the hybrid filter's shift"""
    return {8: 10, 16: 9, 24: 10}[bps]


def wrap32(v):
    """int64 values -> the int32 they wrap to, kept int64"""
    return ((v + (1 << 31)) & 0xFFFFFFFF) - (1 << 31)


def _shift_state(dx, dl, p):
    """the dx/dl state rotation: the new dx[4..7] take their signs from
    the old dl[4..7]; dx, dl: int64 [L, 8] (int32 values), p: int64
    [L]"""
    signs = torch.where(dl[:, 4:8] >= 0, 1, -1) * torch.tensor(
        [1, 2, 2, 4], dtype=torch.int64, device=dl.device)
    d7 = wrap32(p - dl[:, 7])
    d6 = wrap32(d7 - dl[:, 6])
    d5 = wrap32(d6 - dl[:, 5])
    new_dx = torch.cat([dx[:, 1:5], signs], dim=1)
    new_dl = torch.cat([dl[:, 1:5], torch.stack([d5, d6, d7, p], dim=1)],
                       dim=1)
    return (new_dx, new_dl)


def _check_args(residuals, bps):
    if residuals.dim() != 2:
        raise ValueError("residuals must be 2-D [lanes, n]")
    if residuals.dtype != torch.int32:
        raise TypeError("residuals must be int32")
    if bps not in (8, 16, 24):
        raise ValueError("bits per sample %r unsupported" % (bps,))


def inverse_filter_predict_plain(residuals, bps):
    """plain torch version, on any device: [L, n] int32 residual lanes
    -> [L, n] int32 samples before the inverse decorrelation"""
    _check_args(residuals, bps)
    fshift = filter_shift_for(bps)
    shift = shift_for(bps)
    round_v = 1 << (fshift - 1)
    (L, n) = residuals.shape
    dev = residuals.device
    res64 = residuals.to(torch.int64)
    zeros = torch.zeros((L, 8), dtype=torch.int64, device=dev)
    (qm, dx, dl) = (zeros, zeros, zeros)
    prev_out = torch.zeros(L, dtype=torch.int64, device=dev)
    out = torch.empty((L, n), dtype=torch.int32, device=dev)
    for i in range(n):
        res = res64[:, i]
        if i == 0:
            p = wrap32(res - (round_v >> fshift))
        else:
            sign = torch.sign(res64[:, i - 1])[:, None]
            qm = wrap32(qm + sign * dx)
            acc = wrap32(round_v + torch.sum(wrap32(dl * qm), dim=1))
            p = wrap32(res + (acc >> fshift))
        (dx, dl) = _shift_state(dx, dl, p)
        if i == 0:
            x = p
        else:
            x = wrap32(p + wrap32(prev_out + (wrap32(-prev_out) >> shift)))
        prev_out = x
        out[:, i] = x.to(torch.int32)
    return out


def inverse_filter_predict(residuals, bps):
    """inverts the hybrid filter and the fixed predictor of a batch of
    lanes

    Same contract as inverse_filter_predict_plain.  A CPU tensor runs
    the plain version; a CUDA tensor launches the hand-written kernel
    (csrc/tta_synth.cu) on the current stream, without synchronising,
    and counts the launch in ``inverse_filter_predict.launches``.  Any
    other device raises."""
    if residuals.device.type == "cpu":
        return inverse_filter_predict_plain(residuals, bps)
    if residuals.device.type != "cuda":
        raise ValueError("inverse_filter_predict: unsupported device %s"
                         % (residuals.device,))
    _check_args(residuals, bps)
    from .. import kernels
    residuals = residuals.contiguous()
    out = torch.empty(residuals.shape, dtype=torch.int32,
                      device=residuals.device)
    if out.numel():
        kernels.tta_synth(residuals, filter_shift_for(bps), shift_for(bps),
                          out)
        with COUNT_LOCK:
            inverse_filter_predict.launches += 1
    return out


inverse_filter_predict.launches = 0


def decorrelate_inverse(samples):
    """undoes the encoder's channel decorrelation, per sample

    samples: int32 [F, n, ch]; returns int32 [F, n, ch]"""
    ch = samples.shape[2]
    if ch == 1:
        return samples
    prev = samples[:, :, ch - 2]
    half = torch.sign(prev) * torch.div(torch.abs(prev), 2,
                                        rounding_mode="floor")
    outs = [None] * ch
    outs[ch - 1] = samples[:, :, ch - 1] + half
    for c in range(ch - 2, -1, -1):
        outs[c] = outs[c + 1] - samples[:, :, c]
    return torch.stack(outs, dim=2)


def synthesize(residuals, bps):
    """full TTA decode synthesis: int32 [F, n, ch] residuals -> samples"""
    (F, n, ch) = residuals.shape
    lanes = residuals.permute(0, 2, 1).reshape(F * ch, n)
    x = inverse_filter_predict(lanes, bps)
    return decorrelate_inverse(x.view(F, ch, n).permute(0, 2, 1))
