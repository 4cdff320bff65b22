"""Batched Shorten encode analysis: the zero flag, wasted bits, diff
order and energy of every (block, channel), in torch.

Port of ``audiotools_tpu/ops/shn_scan.py`` (``analyze_blocks``) and of
the stream-level decision code of ``audiotools_tpu/codecs/shn.py``
(``_device_decisions``).  The reference Shorten encoder decides per
block and channel, sample by sample: whether the block is all zero
(FN_ZERO), how many low bits every sample shares (wasted bits), which
of the delta levels 1-3 has the smallest absolute sum over the block
(with the previous block's last three shifted samples as warm-up) and
the Rice "energy" of that sum.  Here all of a stream's blocks run
together as reductions over the sample axis.  The C++ emitter
(``_native.shn_encode(..., decisions=...)``) re-derives the residuals
from the host PCM, so the analysis only steers it.

Exact on every device: the sums are int64 (|delta3| <= 8 * 2^16, so a
block's sum is far below 2^63), where the reference combines int32
chunk sums in float64.

Decision layout per (block, channel), int32:
  [0] zero flag   [1] wasted bits   [2] diff order (1-3)   [3] energy
"""

from __future__ import annotations

import torch


def _wasted_bits(adj):
    """[NB, m, ch] int32 -> (zero [NB, ch] bool, wasted [NB, ch] int32):
    the trailing zero bits that every sample of a block shares, the
    position of the lowest set bit of the OR of its samples, which is
    the smallest lowest set bit of any sample (0 for an all-zero
    block)"""
    v = adj.to(torch.int64)
    low = (v & -v).masked_fill_(v == 0, 1 << 32).amin(dim=1)   # [NB, ch]
    zero = low == (1 << 32)
    wasted = torch.zeros(low.shape, dtype=torch.int32, device=v.device)
    for k in range(1, 32):
        wasted += (low >= (1 << k)).to(torch.int32)
    return (zero, torch.where(zero, 0, wasted))


def analyze_blocks(blocks, sign_adjustment, prev3_in=None):
    """decision analysis for uniform-size SHN blocks

    blocks: int32 [NB, m, ch] raw samples (NOT sign-adjusted);
    sign_adjustment: int added to every sample first.  Block 0's
    warm-up history is ``prev3_in`` (int32 [3, ch] on the blocks'
    device; None = zeros, the stream start); later blocks take the
    previous block's last three shifted samples, zeros where the
    previous block was FN_ZERO: the emitter's history rule.
    Returns int32 [NB, ch, 4] (layout above) on the blocks' device."""
    (NB, m, ch) = blocks.shape
    dev = blocks.device
    adj = blocks.to(torch.int32) + sign_adjustment      # [NB, m, ch]
    (zero, wasted) = _wasted_bits(adj)
    shifted = adj >> wasted[:, None, :]                 # [NB, m, ch]

    if m >= 3:
        last3 = shifted[:, m - 3:, :]                   # [NB, 3, ch]
    else:
        last3 = torch.cat([torch.zeros((NB, 3 - m, ch), dtype=torch.int32,
                                       device=dev), shifted], dim=1)
    first3 = (torch.zeros((1, 3, ch), dtype=torch.int32, device=dev)
              if prev3_in is None else prev3_in.to(torch.int32)[None])
    prev3 = torch.cat([first3, last3[:NB - 1]], dim=0)  # [NB, 3, ch]

    full = torch.cat([prev3, shifted], dim=1)           # [NB, m+3, ch]
    d1 = full[:, 1:] - full[:, :-1]                     # [NB, m+2, ch]
    d2 = d1[:, 1:] - d1[:, :-1]                         # [NB, m+1, ch]
    d3 = d2[:, 1:] - d2[:, :-1]                         # [NB, m, ch]
    # absolute sums over the block-length suffix of each delta level
    s1 = d1[:, 2:].abs().sum(dim=1, dtype=torch.int64)
    s2 = d2[:, 1:].abs().sum(dim=1, dtype=torch.int64)
    s3 = d3.abs().sum(dim=1, dtype=torch.int64)         # [NB, ch]

    diff = torch.where((s1 < s2) & (s1 < s3), 1,
                       torch.where(s2 < s3, 2, 3)).to(torch.int32)
    abs_sum = torch.where(diff == 1, s1, torch.where(diff == 2, s2, s3))
    # the smallest e with (m << e) >= abs_sum: the count of e in 0..31
    # with (m << e) < abs_sum
    energy = torch.zeros(abs_sum.shape, dtype=torch.int32, device=dev)
    for e in range(32):
        energy += ((m << e) < abs_sum).to(torch.int32)

    return torch.stack([zero.to(torch.int32), wasted, diff, energy],
                       dim=2)                           # [NB, ch, 4]


def stream_decisions(samples, bps, signed_samples, block_size):
    """the decision array of a whole stream, for the emitter

    samples: int32 [n, ch] PCM on the analysis device (n > 0).  The
    full blocks run as one batch; a final partial block, of another
    length, runs as a batch of its own with the last full block's
    shifted tail as its warm-up.  Returns int32 [ceil(n / block_size),
    ch, 4] on the samples' device."""
    (n, ch) = samples.shape
    sign_adjustment = 0 if signed_samples else 1 << (bps - 1)
    nfull = n // block_size
    parts = []
    prev3 = None
    if nfull:
        full = samples[:nfull * block_size].reshape(nfull, block_size, ch)
        parts.append(analyze_blocks(full, sign_adjustment))
        if n != nfull * block_size:
            last = full[-1].to(torch.int32) + sign_adjustment   # [m, ch]
            shifted = last >> parts[0][-1, :, 1][None, :]
            prev3 = shifted[-3:]
            if prev3.shape[0] < 3:
                prev3 = torch.cat([torch.zeros(
                    (3 - prev3.shape[0], ch), dtype=torch.int32,
                    device=samples.device), prev3])
    if n != nfull * block_size:
        parts.append(analyze_blocks(samples[nfull * block_size:][None],
                                    sign_adjustment, prev3_in=prev3))
    return torch.cat(parts) if len(parts) > 1 else parts[0]
