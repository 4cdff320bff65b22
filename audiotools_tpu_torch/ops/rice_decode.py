"""Batched Rice decoding of FLAC residual partitions, in torch + CUDA.

Port of ``audiotools_tpu/ops/rice_decode.py``.  The host scan
(``_native.flac_scan``) records every residual partition's bit span
and parameters as a record; ``decode_partitions`` decodes a bucket of
records from the frame bytes, carried as big-endian 32-bit words.  A
record is a Rice run (parameter ``k >= 0``) or a raw run (``raw_bits >=
0``: escape partitions and VERBATIM subframes).

On a CUDA tensor ``decode_partitions`` launches the hand-written
kernel in ``csrc/rice_decode.cu`` (one thread per record, serving any
bucket: the decoder's buckets up to W = 64 from words staged in shared
memory, the catch-all straight from device memory); on a CPU tensor it
runs ``decode_partitions_plain``, the reference's lock-step scan form
(``decode_partitions_scan``): every record advances one code per step,
the unary quotient found by a CLZ of the current word or, past it, of
the next nonzero word.  Both
follow the reference's clamps exactly: bit positions clamp to
``32 * W - 1``, window words to the buffer's last word.

Words are int32 bit patterns at the boundary (``bytes_to_words``);
the plain version carries them as int64 in [0, 2^32), since CPU torch
has no uint32 shifts.
"""

from __future__ import annotations

import numpy as np
import torch

from .bits import U32_MASK, u32_to_i32
from .._device import COUNT_LOCK


def bytes_to_words(data):
    """frame bytes -> big-endian 32-bit words as an int32 CPU tensor of
    bit patterns (zero-padded to a whole word)"""
    buf = np.frombuffer(data, dtype=np.uint8)
    pad = (-len(buf)) % 4
    if pad:
        buf = np.concatenate([buf, np.zeros(pad, dtype=np.uint8)])
    return torch.from_numpy(buf.view(">u4").astype(np.uint32)
                            .view(np.int32))


def _bit_length(v):
    """bit length of int64 values in [0, 2^32) (0 -> 0), exact: frexp
    of the (exact) float64 value gives its binary exponent"""
    (_mantissa, exponent) = torch.frexp(v.to(torch.float64))
    return exponent.to(torch.int64)


def _check_args(words, word_base, base_bits, k, raw_bits, count, W, C):
    records = (word_base, base_bits, k, raw_bits, count)
    if words.dim() != 1 or any(r.dim() != 1 or r.shape != word_base.shape
                               for r in records):
        raise ValueError("words and the record arrays must be 1-D, the "
                         "record arrays of one length")
    if any(t.dtype != torch.int32 for t in (words,) + records):
        raise TypeError("words and the record arrays must be int32")
    if any(t.device != words.device for t in records):
        raise ValueError("words and the record arrays lie on different "
                         "devices")
    if words.shape[0] == 0:
        raise ValueError("words must not be empty")
    if not (1 <= W <= (1 << 20) and 1 <= C <= (1 << 20)):
        raise ValueError("bucket sizes out of range: W=%d, C=%d" % (W, C))


def decode_partitions_plain(words, word_base, base_bits, k, raw_bits,
                            count, W, C):
    """plain torch version of the bucket decode, on any device

    words: int32 [Wtot] big-endian word bit patterns; word_base,
    base_bits, k (-1 = raw), raw_bits (-1 = Rice), count: int32 [P];
    W, C: the bucket's window words and code capacity.  Returns int32
    [P, C]: residuals (zigzag undone; raw runs sign-extended), 0 at
    positions >= count."""
    _check_args(words, word_base, base_bits, k, raw_bits, count, W, C)
    dev = words.device
    P = word_base.shape[0]
    N = W * 32
    Wtot = words.shape[0]
    out = torch.zeros((P, C), dtype=torch.int32, device=dev)
    steps = min(C, int(count.max())) if P else 0
    if steps <= 0:
        return out

    # window of W words plus one spare for straddling reads, clamped
    # into the buffer
    widx = word_base.to(torch.int64)[:, None] + torch.arange(
        W + 1, device=dev)[None, :]
    win = words.to(torch.int64)[torch.clamp(widx, 0, Wtot - 1)] & U32_MASK
    # next-nonzero-word table: smallest w' >= w with win[w'] != 0, else
    # W (a reverse running minimum)
    wpos = torch.arange(W, device=dev)[None, :].expand(P, W)
    masked = torch.where(win[:, :W] != 0, wpos, W)
    nzw = torch.flip(torch.cummin(torch.flip(masked, [1]), dim=1).values,
                     [1])

    is_raw = raw_bits >= 0
    kc = torch.clamp(k.to(torch.int64), min=0)
    rc = torch.clamp(raw_bits.to(torch.int64), min=0)
    nbits = torch.where(is_raw, rc, kc)
    nb_safe = torch.clamp(nbits, 1, 32)
    sbit = torch.where(nbits > 0, torch.ones_like(nbits) << (nb_safe - 1),
                       0)

    def row(tab, idx):
        return torch.gather(tab, 1, idx[:, None])[:, 0]

    cur = base_bits.to(torch.int64)
    for j in range(steps):
        st = torch.clamp(cur, max=N - 1)
        wi = st >> 5
        rem = (row(win, wi) << (st & 31)) & U32_MASK
        # next set bit at or after st: in the current word by CLZ, else
        # the first set bit of the next nonzero word (none past the
        # window: position N - 1)
        wnext = torch.where(wi + 1 >= W, W,
                            row(nzw, torch.clamp(wi + 1, max=W - 1)))
        w_far = row(win, torch.clamp(wnext, max=W))
        t_in = st + 32 - _bit_length(rem)
        t_far = torch.where(wnext >= W, N - 1,
                            (wnext << 5) + 32 - _bit_length(w_far))
        qpos = torch.clamp(torch.where(rem != 0, t_in, t_far), max=N - 1)
        q = qpos - st
        off = torch.where(is_raw, st, qpos + 1)
        wi2 = torch.clamp(off >> 5, max=W - 1)
        w0 = row(win, wi2)
        w1 = row(win, wi2 + 1)
        sh = off & 31
        hi = torch.where(sh == 0, w0,
                         ((w0 << sh) | (w1 >> (32 - sh))) & U32_MASK)
        lsb = torch.where(nbits <= 0, 0, hi >> (32 - nb_safe))
        u = ((q << kc) | lsb) & U32_MASK
        res_rice = (u >> 1) ^ ((-(u & 1)) & U32_MASK)
        res_raw = ((lsb ^ sbit) - sbit) & U32_MASK
        res = u32_to_i32(torch.where(is_raw, res_raw, res_rice))
        out[:, j] = torch.where(j < count, res, 0)
        cur = torch.clamp(torch.where(is_raw, st + rc, qpos + 1 + kc),
                          max=N - 1)
    return out


def decode_partitions(words, word_base, base_bits, k, raw_bits, count,
                      W, C):
    """decodes a bucket of residual partition records

    Same contract as decode_partitions_plain.  A CPU tensor runs the
    plain version; a CUDA tensor launches the hand-written kernel
    (csrc/rice_decode.cu) on the current stream, without
    synchronising, and counts the launch in
    ``decode_partitions.launches``.  Any other device raises."""
    if words.device.type == "cpu":
        return decode_partitions_plain(words, word_base, base_bits, k,
                                       raw_bits, count, W, C)
    if words.device.type != "cuda":
        raise ValueError("decode_partitions: unsupported device %s"
                         % (words.device,))
    _check_args(words, word_base, base_bits, k, raw_bits, count, W, C)
    from .. import kernels
    args = [t.contiguous() for t in (words, word_base, base_bits, k,
                                     raw_bits, count)]
    out = torch.empty((word_base.shape[0], C), dtype=torch.int32,
                      device=words.device)
    if word_base.shape[0]:
        kernels.rice_decode(*args, W, out)
        with COUNT_LOCK:
            decode_partitions.launches += 1
    return out


decode_partitions.launches = 0
