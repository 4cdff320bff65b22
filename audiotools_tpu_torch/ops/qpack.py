"""The quantized upload wire of the FLAC and ALAC encodes, in torch.

Port of ``audiotools_tpu/ops/qpack.py``.  The analysis only steers the
encode's decisions: the C++ emitters re-derive every residual from the
exact host PCM, so the analysis may run on a coarser view of the
samples.  The spec is

* per (block, channel) a shift ``t`` (``plan_t``), and the analysis
  input ``(x >> t) << t`` (``quantize``);
* an exact sideband per (block, variant): the OR of the samples and the
  is-constant flag (``variant_sideband``), the two decisions that must
  come from exact data (wasted bits, CONSTANT subframes).

The transport is bit packing, not part of the spec: the zigzag first
differences of the quantized samples at the batch's width ``k``
(``pack``), or at a narrower base width with the wider values as
(position, value) exceptions (``pack_patched``).  ``unpack`` rebuilds
the quantized samples on the device with torch ops (gathers, shifts, a
scatter of the exceptions and an int32 cumsum); the C++ scans of
``_native`` (``flac_qpack``, ``flac_qpack_patched``) write the same
words as ``pack`` and ``pack_patched``.  The gates and tuning knobs
read the reference's environment variables, so both packages encode
alike under any setting.
"""

from __future__ import annotations

import os

import numpy as np
import torch

_DEFAULT_GUARD = 0
_DEFAULT_CAP_MARGIN = 6
_DEFAULT_NOISE_EXTRA = 2

# the wire widths a batch rounds up to; 31 is the two-word format's
# ceiling (a value straddles at most two uint32 words)
K_GRID = (2, 3, 4, 6, 8, 10, 12, 16, 21, 26, 31)

# exception slots per (block, channel) of the patched-base wire
E_GRID = (8, 32, 128)


def enabled():
    """whether the FLAC quantized upload is on (ATPU_FLAC_QPACK, default
    on)"""
    return os.environ.get("ATPU_FLAC_QPACK", "1") != "0"


def alac_enabled():
    """whether the ALAC quantized upload is on (ATPU_ALAC_QPACK, default
    on)"""
    return os.environ.get("ATPU_ALAC_QPACK", "1") != "0"


def patch_enabled():
    """whether the FLAC wire may take the patched-base form
    (ATPU_QPACK_PATCH, default on)"""
    return os.environ.get("ATPU_QPACK_PATCH", "1") != "0"


def guard_bits():
    """how many bits below the residual scale the quantization step
    sits (ATPU_QPACK_GUARD, default 0)"""
    return int(os.environ.get("ATPU_QPACK_GUARD", str(_DEFAULT_GUARD)))


def cap_margin():
    """the significant bits the analysis always keeps: t <= bps -
    cap_margin (ATPU_QPACK_CAP, default 6)"""
    return int(os.environ.get("ATPU_QPACK_CAP", str(_DEFAULT_CAP_MARGIN)))


def noise_extra():
    """the extra shift of noise-dominated blocks, whose mean |second
    difference| is at least 1.6 times their mean |first difference|
    (ATPU_QPACK_NOISE_EXTRA, default 2; 0 turns it off)"""
    return int(os.environ.get("ATPU_QPACK_NOISE_EXTRA",
                              str(_DEFAULT_NOISE_EXTRA)))


def plan_t(blocks, bps, guard=None, margin=None, extra=None):
    """the quantization shift t of each (block, channel)

    blocks: int [B, n, ch] exact samples; returns int32 [B, ch].  With
    sum1 and sum2 the exact sums of |first| and |second differences|,
    m = sum2 // (n - 2) and s = max(0, bps - 26):
      noise = m > 0 and 5 * (sum2 >> s) * (n - 1) >= 8 * (sum1 >> s) * (n - 2)
      t = clamp(bit_length(m) - 1 - guard + (extra if noise else 0),
                0, bps - (max(margin - 2, 0) if noise else margin))
    (0 for n <= 2)."""
    if guard is None:
        guard = guard_bits()
    if margin is None:
        margin = cap_margin()
    if extra is None:
        extra = noise_extra()
    blocks = np.asarray(blocks)
    (B, n, ch) = blocks.shape
    if n <= 2:
        return np.zeros((B, ch), dtype=np.int32)
    x = blocks.astype(np.int64)
    sum1 = np.abs(x[:, 1:, :] - x[:, :-1, :]).sum(axis=1)
    sum2 = np.abs(x[:, 2:, :] - 2 * x[:, 1:-1, :] + x[:, :-2, :]).sum(axis=1)
    m = sum2 // (n - 2)
    s = max(0, int(bps) - 26)
    noise = (m > 0) & (5 * (sum2 >> s) * (n - 1) >=
                       8 * (sum1 >> s) * (n - 2))
    if extra <= 0:
        noise = np.zeros_like(noise)
    bl = np.zeros_like(m)
    mm = m.copy()
    while (mm > 0).any():
        bl += mm > 0
        mm >>= 1
    cap = np.where(noise, max(int(bps) - max(int(margin) - 2, 0), 0),
                   max(int(bps) - int(margin), 0))
    t = bl - 1 - guard + np.where(noise, int(extra), 0)
    return np.clip(t, 0, cap).astype(np.int32)


def quantize(blocks, t):
    """the analysis input (x >> t) << t of each (block, channel)

    blocks: int [B, n, ch] (numpy or torch); t: int32 [B, ch]; returns
    int32 [B, n, ch] of the same kind"""
    if isinstance(blocks, torch.Tensor):
        tt = torch.as_tensor(t, dtype=torch.int32,
                             device=blocks.device)[:, None, :]
        return (blocks.to(torch.int32) >> tt) << tt
    tt = np.asarray(t, dtype=np.int32)[:, None, :]
    return (np.asarray(blocks).astype(np.int32) >> tt) << tt


def variant_sideband(blocks, stereo_trial):
    """the exact OR-of-samples and is-constant flag of each (block,
    variant), variants ordered as flac_frames.build_variants orders
    them ([left, right, mid, side] under stereo trials)

    returns (or_vals int32 [B, V], const_flags bool [B, V])"""
    blocks = np.asarray(blocks)
    ch = blocks.shape[2]
    if stereo_trial:
        left = blocks[:, :, 0].astype(np.int32)
        right = blocks[:, :, 1].astype(np.int32)
        variants = [left, right, (left + right) >> 1, left - right]
    else:
        variants = [blocks[:, :, c].astype(np.int32) for c in range(ch)]
    or_vals = np.stack([np.bitwise_or.reduce(v, axis=1) for v in variants],
                       axis=1)
    const_flags = np.stack([(v == v[:, :1]).all(axis=1) for v in variants],
                           axis=1)
    return (or_vals.astype(np.int32), const_flags)


def round_k(k):
    """the wire width k rounded up to K_GRID; raises ValueError past the
    format's 31 bits"""
    if k > 31:
        raise ValueError(
            "qpack wire width k=%d exceeds the 31-bit two-word format "
            "limit (disable qpack for this stream)" % (k,))
    for g in K_GRID:
        if k <= g:
            return g
    raise AssertionError("unreachable: K_GRID covers 1..31")


def _zigzag_diffs(blocks, t):
    """[B*ch, n-1] uint64 zigzag first differences of the quantized
    samples"""
    (B, n, ch) = blocks.shape
    xq = blocks.astype(np.int32) >> np.asarray(t)[:, None, :]
    d = (xq[:, 1:, :] - xq[:, :-1, :]).astype(np.int64)
    u = ((d << 1) ^ (d >> 63)).astype(np.uint64)
    return np.moveaxis(u, 1, 2).reshape(B * ch, n - 1)


def _pack_tokens(flat, k):
    """token rows [R, m] (each < 2^k) packed at width k into uint32 words
    [R, ceil(m * k / 32) + 1], little-endian, with one pad word"""
    (R, m) = flat.shape
    W = (m * k + 31) // 32 + 1
    packed = np.zeros((R, W), dtype=np.uint32)
    bit = np.arange(m, dtype=np.int64) * k
    wi = bit >> 5
    off = (bit & 31).astype(np.uint64)
    lo = ((flat << off) & 0xFFFFFFFF).astype(np.uint32)
    hi = np.where(off == 0, 0,
                  flat >> (np.uint64(32) - off)).astype(np.uint32)
    np.bitwise_or.at(packed, (slice(None), wi), lo)
    np.bitwise_or.at(packed, (slice(None), wi + 1), hi)
    return packed


def pack(blocks, t):
    """the plain wire (numpy form of ``_native.flac_qpack``'s words)

    blocks: int [B, n, ch]; t: int32 [B, ch]; returns (packed uint32
    [B, ch, W], k, x0 int32 [B, ch]) with x0 the exact first samples
    and W = ceil((n - 1) * k / 32) + 1"""
    blocks = np.asarray(blocks)
    (B, n, ch) = blocks.shape
    x0 = blocks[:, 0, :].astype(np.int32)
    if n <= 1:
        return (np.zeros((B, ch, 1), dtype=np.uint32), 1, x0)
    flat = _zigzag_diffs(blocks, t)
    k = round_k(max(int(flat.max()).bit_length(), 1) if flat.size else 1)
    return (_pack_tokens(flat, k).reshape(B, ch, -1), k, x0)


def pack_patched(blocks, t, k_base, E):
    """the patched-base wire (numpy form of
    ``_native.flac_qpack_patched``): every difference packed at
    ``k_base`` bits, the values that need more carried whole as at most
    ``E`` (position, value) exceptions per (block, channel); unused
    slots hold (0, the true value at 0)

    returns (packed uint32 [B, ch, W], exc_pos int32 [B, ch, E],
    exc_val uint32 [B, ch, E], max_exc); max_exc > E means the pack
    lost exceptions and must not be used"""
    blocks = np.asarray(blocks)
    (B, n, ch) = blocks.shape
    if n <= 1:
        raise ValueError("patched wire requires n > 1")
    flat = _zigzag_diffs(blocks, t)
    exc = (flat >> np.uint64(k_base)) != 0
    counts = exc.sum(axis=1)
    max_exc = int(counts.max()) if counts.size else 0
    exc_pos = np.zeros((B * ch, E), dtype=np.int32)
    exc_val = np.tile(flat[:, :1].astype(np.uint32), (1, E))
    for r in range(B * ch):
        idx = np.nonzero(exc[r])[0][:E]
        exc_pos[r, :len(idx)] = idx
        exc_val[r, :len(idx)] = flat[r, idx].astype(np.uint32)
    masked = np.where(exc, flat & np.uint64((1 << k_base) - 1), flat)
    packed = _pack_tokens(masked, k_base).reshape(B, ch, -1)
    return (packed, exc_pos.reshape(B, ch, E), exc_val.reshape(B, ch, E),
            max_exc)


def unpack(packed, k, t, x0, n, exc_pos=None, exc_val=None):
    """the quantized analysis input rebuilt from the wire, with torch ops
    on the tensors' device

    packed: int32 [B, ch, W] (the uint32 words' bit patterns); k: the
    wire width; t, x0: int32 [B, ch]; exc_pos/exc_val: int32 [B, ch, E]
    of the patched-base wire, or None.  Returns int32 [B, n, ch] equal
    to quantize(blocks, t)."""
    (B, ch, W) = packed.shape
    dev = packed.device
    t = t.to(torch.int32)
    x0q = x0.to(torch.int32) >> t                          # [B, ch]
    if n <= 1:
        return (x0q[:, None, :] << t[:, None, :])[:, :n, :]
    bit = torch.arange(n - 1, dtype=torch.int64, device=dev) * k
    wi = bit >> 5
    off = bit & 31
    words = packed.to(torch.int64) & 0xFFFFFFFF
    pair = words[:, :, wi] | (words[:, :, wi + 1] << 32)  # [B, ch, n-1]
    u = ((pair >> off) & ((1 << k) - 1)).to(torch.int32)
    if exc_pos is not None:
        # pads re-set position 0 to its true value, a no-op
        u = u.scatter(2, exc_pos.to(torch.int64), exc_val.to(torch.int32))
    d = (u >> 1) ^ -(u & 1)                                # un-zigzag
    xq = x0q[:, :, None] + torch.cumsum(d, dim=2, dtype=torch.int32)
    full = torch.cat([x0q[:, :, None], xq], dim=2)         # [B, ch, n]
    return full.transpose(1, 2) << t[:, None, :]


def wire_columns(ch, W, E, V):
    """the column count of a consolidated wire row: ch * W packed words,
    2 * ch * E exception columns, then t and x0 (ch each) and the V
    or-values and V constant flags"""
    return ch * W + 2 * ch * E + 2 * ch + 2 * V


def assemble_wire(qwords, t, x0, or_vals=None, const_flags=None,
                  exc_pos=None, exc_val=None):
    """one uint32 [B, wire_columns] host array per batch: the packed
    words, the exceptions (patched wire), then the int32 sideband
    [t, x0, or_vals, const_flags] as bit patterns"""
    B = qwords.shape[0]
    parts = [qwords.reshape(B, -1).astype(np.uint32)]
    if exc_pos is not None:
        parts.append(exc_pos.reshape(B, -1).astype(np.int32).view(np.uint32))
        parts.append(exc_val.reshape(B, -1).astype(np.uint32))
    meta = [t, x0]
    if or_vals is not None:
        meta += [or_vals, np.asarray(const_flags).astype(np.int32)]
    parts.append(np.concatenate(meta, axis=1).astype(np.int32)
                 .view(np.uint32))
    return np.concatenate(parts, axis=1)


def unpack_wire(wire, k, W, ch, n, E=0, V=0):
    """a consolidated wire on the device -> (quantized blocks int32
    [B, n, ch], or_vals int32 [B, V] or None, const_flags bool [B, V] or
    None)

    wire: int32 [B, wire_columns(ch, W, E, V)] (assemble_wire's words as
    int32 bit patterns)"""
    B = wire.shape[0]
    qwords = wire[:, :ch * W].reshape(B, ch, W)
    off = ch * W
    (exc_pos, exc_val) = (None, None)
    if E:
        exc_pos = wire[:, off:off + ch * E].reshape(B, ch, E)
        exc_val = wire[:, off + ch * E:off + 2 * ch * E].reshape(B, ch, E)
        off += 2 * ch * E
    t = wire[:, off:off + ch]
    x0 = wire[:, off + ch:off + 2 * ch]
    blocks = unpack(qwords, k, t, x0, n, exc_pos, exc_val)
    if not V:
        return (blocks, None, None)
    off += 2 * ch
    return (blocks, wire[:, off:off + V], wire[:, off + V:off + 2 * V] != 0)
