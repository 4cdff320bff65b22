"""Batched Shorten decode synthesis in torch: the diff predictors
inverted as cumulative sums with closed-form warm-up terms, and the
rows interleaved into frames.

Port of ``audiotools_tpu/ops/shn_synth.py`` (``synthesize``) and of the
row-to-frame loop of ``audiotools_tpu/codecs/shn.py`` (``_decode_jax``).
A DIFFk block satisfies ``D^k x = r`` (its k-th finite difference is
the residual row), so it inverts as the k-fold inclusive cumulative sum
of the residuals plus an affine function of the three warm-up samples:

  DIFF1: x[i] = w1 + C1[i]
  DIFF2: x[i] = w1 + (i+1)*(w1-w2) + C2[i]
  DIFF3: x[i] = w1 + (i+1)*a1 + T(i)*a2 + C3[i]
         a1 = w1-w2, a2 = w1-2*w2+w3, T(i) = (i+1)(i+2)/2

with Ck the k-fold cumsum of the residual row and w1, w2, w3 the last
three decoded (pre-shift) samples of the channel's previous block,
which the host computes from the same closed forms
(``_native.shn_warm_chain``).  Every block therefore decodes on its
own.  DIFF0 (no means) and ZERO rows are direct fills; QLPC and
DIFF0-with-means streams take the host decoder (the scan refuses
them).

C3 reaches ~n^2 * |r| (~2^33 at n = 1024, 16-bit), so the sums run in
int64 and only the final samples narrow to int32.  The cumsums are
library calls, as ``jnp.cumsum`` is in the reference: no hand kernel.
"""

from __future__ import annotations

import torch

CMD_DIFF0 = 0
CMD_DIFF1 = 1
CMD_DIFF2 = 2
CMD_DIFF3 = 3
CMD_ZERO = 8


def synthesize(res, cmd, warm, shift, sign_adjustment):
    """decodes [R, n] residual rows into [R, n] output samples

    res:   int32 [R, n] residuals (zero-padded past block length)
    cmd:   int32 [R] Shorten command (CMD_*)
    warm:  int64 [R, 3] previous block's last three pre-shift samples,
           warm[:, 0] = x[-1]
    shift: int32 [R] left shift applied after prediction
    sign_adjustment: int subtracted from shifted samples

    returns int32 [R, n] on the inputs' device (columns past the row's
    block length are garbage; the caller trims)"""
    (_R, n) = res.shape
    r64 = res.to(torch.int64)
    c1 = torch.cumsum(r64, dim=1)
    c2 = torch.cumsum(c1, dim=1)
    c3 = torch.cumsum(c2, dim=1)
    i1 = torch.arange(1, n + 1, dtype=torch.int64, device=res.device)[None]
    tri = (i1 * (i1 + 1)) // 2                          # T(i)
    w = warm.to(torch.int64)
    (w1, w2, w3) = (w[:, 0:1], w[:, 1:2], w[:, 2:3])
    a1 = w1 - w2
    a2 = w1 - 2 * w2 + w3
    cmd_c = cmd[:, None]
    x = torch.where(cmd_c == CMD_ZERO, 0, r64)
    x = torch.where(cmd_c == CMD_DIFF1, w1 + c1, x)
    x = torch.where(cmd_c == CMD_DIFF2, w1 + i1 * a1 + c2, x)
    x = torch.where(cmd_c == CMD_DIFF3, w1 + i1 * a1 + tri * a2 + c3, x)
    v = (x << shift[:, None].to(torch.int64)) - sign_adjustment
    return v.to(torch.int32)


def interleave(planes, block_len, chan, channels, total_frames):
    """decoded rows -> interleaved int32 [total_frames, channels]

    planes: int32 [R, n] samples, row r holding block_len[r] samples of
    channel chan[r] (int32 [R] each), rows in stream order.  A row's
    first frame is the sum of the lengths of the channel's earlier rows
    (an exclusive cumsum per channel); samples at or past total_frames
    (only whole channel sets count) are dropped.  Index arithmetic and
    one scatter on the rows' device, nothing read back."""
    (R, n) = planes.shape
    dev = planes.device
    lens = block_len.to(torch.int64)
    own = chan.to(torch.int64)[:, None] == torch.arange(channels,
                                                        device=dev)[None]
    per_chan = torch.where(own, lens[:, None], 0)       # [R, channels]
    start = (torch.cumsum(per_chan, dim=0) - per_chan).gather(
        1, chan.to(torch.int64)[:, None])               # [R, 1]
    col = torch.arange(n, dtype=torch.int64, device=dev)[None]
    frame = start + col                                 # [R, n]
    keep = (col < lens[:, None]) & (frame < total_frames)
    # everything dropped lands in one spare slot past the output
    dest = torch.where(keep, frame * channels + chan.to(torch.int64)[:, None],
                       total_frames * channels)
    out = torch.zeros(total_frames * channels + 1, dtype=torch.int32,
                      device=dev)
    out.scatter_(0, dest.reshape(-1), planes.reshape(-1))
    return out[:-1].view(total_frames, channels)
