"""Device-side parallel FLAC residual bit-packing, in torch + CUDA.

Port of ``audiotools_tpu/ops/pallas_bitpack.py``.  The serial Rice
bit writer becomes a parallel program.  Its plain version is the
reference's:

1. ``tokenize``: every bit-field of a residual partition block (the
   method/porder header, the per-partition Rice parameters, one Rice
   code per residual) becomes a token of total length ``l`` whose
   trailing ``c`` bits are its payload; a prefix sum of the lengths
   places each token at an absolute bit offset;
2. ``split_contributions``: each payload lands in one or two 32-bit
   words of the MSB-first stream, as (word index, value) pairs;
3. ``scatter_words_plain``: the pairs are summed into the word rows.
   Payload bit ranges are disjoint, so add equals or.

``pack_rows`` is the whole of it for a batch of subframe rows, with
the capacity and clip sideband of ``pack_chosen_residuals``: on a CUDA
tensor it launches the hand-written kernel in ``csrc/pack_rows.cu``,
one block a row that tokenizes, scans and writes whole words, so that
no token or contribution reaches device memory; on a CPU tensor it
runs ``pack_rows_plain``, steps 1-3 above.

u32 values are carried as int64 in [0, 2^32) (torch has no uint32
arithmetic on the CPU) and become int32 bit patterns only at a kernel
boundary: the word rows are int32.
"""

from __future__ import annotations

import torch

from . import flac_frames as ff
from .bits import U32_MASK, i32_to_u32, u32_to_i32
from .._device import COUNT_LOCK


def residual_words_capacity(n, bps, max_parts):
    """output width (u32 words) per CHOSEN coded subframe

    A coded (FIXED/LPC) choice implies the whole subframe costs less
    than VERBATIM, so its residual partition block is bounded by
    ~bps_subframe * n bits; bps + 2 covers the +1-bit side channel with
    a margin, plus the method/porder header and parameter fields."""
    bits = n * (bps + 2) + max_parts * 5 + 96
    return (bits + 31) // 32


def tokenize(res, orders, porders, params, n, max_parts):
    """token model of a batch of residual partition blocks

    res: int [S, n] residuals at absolute positions (warm-up entries
    below the order are zero); orders, porders: int [S]; params: int
    [S, max_parts].  Returns (ends, payload, widths, total_bits), all
    int64: ends/payload/widths [S, T] with T = 1 + max_parts + n, and
    total_bits [S].  Stream layout per subframe:
    ``[method(2) porder(4)] ([param(4|5)] [rice codes...]) * parts``."""
    S = res.shape[0]
    T = 1 + max_parts + n
    dev = res.device
    res = res.to(torch.int64)
    orders = orders.to(torch.int64)
    porders = porders.to(torch.int64)
    params = params.to(torch.int64)

    u = torch.where(res >= 0, res << 1, (-res << 1) - 1) & U32_MASK
    parts = torch.ones_like(porders) << porders
    psize = torch.full_like(porders, n) >> porders

    # coding method 1 when any USED partition's parameter exceeds 14
    pidx = torch.arange(max_parts, device=dev)
    used = pidx[None, :] < parts[:, None]
    method = torch.any(torch.where(used, params, 0) > 14,
                       dim=1).to(torch.int64)
    plen = torch.where(method == 1, 5, 4)                  # [S]

    # token j: 0 -> header; else g = j - 1, group p = g // (psize+1),
    # within == 0 -> parameter token, else residual p*psize + within-1
    j = torch.arange(T, device=dev)
    g = torch.clamp(j - 1, min=0)
    group = g[None, :] // (psize + 1)[:, None]             # [S, T]
    within = g[None, :] % (psize + 1)[:, None]
    is_header = (j == 0)[None, :].expand(S, T)
    live = group < parts[:, None]
    is_param = (~is_header) & live & (within == 0)
    res_pos = torch.clamp(group * psize[:, None] + within - 1, 0, n - 1)
    is_res = (~is_header) & live & (within > 0)

    r = torch.take_along_dim(params, torch.clamp(group, 0, max_parts - 1),
                             dim=1)                        # [S, T]
    uj = torch.take_along_dim(u, res_pos, dim=1)
    warmup = is_res & (res_pos < orders[:, None])
    coded = is_res & ~warmup

    header_val = (method << 4) | porders                  # [S]
    stop = torch.ones_like(r) << r
    res_payload = stop | (uj & (stop - 1))
    res_len = (uj >> r) + 1 + r

    zero = torch.zeros_like(r)
    lengths = torch.where(
        is_header, 6,
        torch.where(is_param, plen[:, None],
                    torch.where(coded, res_len, zero)))
    payload = torch.where(
        is_header, header_val[:, None],
        torch.where(is_param, r, torch.where(coded, res_payload, zero)))
    widths = torch.where(
        is_header, 6,
        torch.where(is_param, plen[:, None],
                    torch.where(coded, 1 + r, zero)))

    ends = torch.cumsum(lengths, dim=1)
    return (ends, payload, widths, ends[:, -1])


def split_contributions(ends, payload, widths):
    """splits tokens into per-word contributions

    A payload occupies stream bits [e - c, e), MSB-first, and lands in
    word q1 = (e - 1) >> 5 and, when it straddles, q0 = q1 - 1.
    Returns (idx int64 [S, 2T], val int64 [S, 2T] in [0, 2^32));
    zero-width tokens give zero contributions at a harmless index."""
    e = ends
    c = widths
    q1 = torch.clamp((e - 1) >> 5, min=0)
    lo_bits = torch.clamp(e - (q1 << 5), 0, 32)            # in [1, 32]
    take = torch.minimum(lo_bits, c)                       # <= 31
    mask = (torch.ones_like(take) << take) - 1
    lo_val = ((payload & mask) << (32 - lo_bits)) & U32_MASK
    hi_val = torch.where(c > take, payload >> take, 0)
    q0 = torch.clamp(q1 - 1, min=0)
    lo_val = torch.where(c == 0, 0, lo_val)
    return (torch.cat([q1, q0], dim=1), torch.cat([lo_val, hi_val], dim=1))


def _check_scatter_args(idx, val, n_words):
    if idx.dim() != 2 or idx.shape != val.shape:
        raise ValueError("idx and val must be 2-D of one shape, got %s "
                         "and %s" % (tuple(idx.shape), tuple(val.shape)))
    if idx.dtype != torch.int32 or val.dtype != torch.int32:
        raise TypeError("idx and val must be int32 (val as u32 bit "
                        "patterns), got %s and %s" % (idx.dtype, val.dtype))
    if idx.device != val.device:
        raise ValueError("idx and val lie on different devices")
    if not (idx.is_contiguous() and val.is_contiguous()):
        raise ValueError("idx and val must be contiguous")
    if n_words < 0 or n_words >= (1 << 31):
        raise ValueError("n_words out of range: %d" % (n_words,))


def scatter_words_plain(idx, val, n_words):
    """plain torch version of the scatter, on any device

    idx int32 [S, M] word indices; val int32 [S, M] u32 bit patterns.
    Returns int32 [S, n_words] u32 bit patterns.  Contributions whose
    idx falls outside [0, n_words) are dropped, as the Pallas kernel
    drops them by slicing its padded output."""
    _check_scatter_args(idx, val, n_words)
    S = idx.shape[0]
    idx = idx.to(torch.int64)
    inside = (idx >= 0) & (idx < n_words)
    rows = torch.arange(S, device=idx.device)[:, None] * n_words
    flat = torch.where(inside, rows + idx, 0).reshape(-1)
    vals = torch.where(inside, i32_to_u32(val), 0).reshape(-1)
    out = torch.zeros(max(S * n_words, 1), dtype=torch.int64,
                      device=idx.device)
    out.scatter_add_(0, flat, vals)
    return u32_to_i32(out[:S * n_words].reshape(S, n_words) & U32_MASK)


def contributions(res, orders, porders, params, choice, n_words):
    """the plain scatter's inputs for a batch of subframe rows

    res: int32 [S, n]; orders, porders, choice: int32 [S]; params:
    int32 [S, max_parts].  Returns (idx int32 [S, 2T], val int32 [S, 2T]
    u32 bit patterns, total_bits int64 [S], coded bool [S]).  Indices
    past the words are clamped to n_words, where the scatter drops them.
    CONSTANT/VERBATIM rows may carry arbitrary analysis residuals: their
    contributions are zeroed, so nothing of theirs scatters."""
    (S, n) = res.shape
    coded = (choice == ff.CHOICE_FIXED) | (choice == ff.CHOICE_LPC)
    (ends, payload, widths, total) = tokenize(
        res, orders, porders, params, n, params.shape[1])
    (idx, val) = split_contributions(ends, payload, widths)
    del ends, payload, widths
    idx = torch.where(coded[:, None], torch.clamp(idx, max=n_words), 0)
    val = u32_to_i32(torch.where(coded[:, None], val, 0))
    return (idx.to(torch.int32), val, total, coded)


def _check_pack_args(res, orders, porders, params, choice, n_words,
                     max_bps):
    S = res.shape[0] if res.dim() == 2 else -1
    if not (res.dim() == 2 and res.shape[1] >= 1 and params.dim() == 2
            and params.shape[0] == S and params.shape[1] >= 1
            and orders.shape == porders.shape == choice.shape == (S,)):
        raise ValueError(
            "want res [S, n >= 1], orders, porders and choice [S], params "
            "[S, max_parts >= 1]; got %s" % ([tuple(t.shape) for t in (
                res, orders, porders, params, choice)],))
    for x in (res, orders, porders, params, choice):
        if x.dtype != torch.int32:
            raise TypeError("the pack's inputs must be int32, got %s"
                            % (x.dtype,))
        if x.device != res.device:
            raise ValueError("the pack's inputs lie on different devices")
        if not x.is_contiguous():
            raise ValueError("the pack's inputs must be contiguous")
    if n_words < 0 or n_words >= (1 << 31):
        raise ValueError("n_words out of range: %d" % (n_words,))
    if max_bps < 0 or max_bps > 26:
        raise ValueError("max_bps out of range: %d" % (max_bps,))


def pack_rows_plain(res, orders, porders, params, choice, n_words,
                    max_bps):
    """plain torch version of the pack, on any device

    res: int32 [S, n] residuals at absolute positions; orders, porders,
    choice: int32 [S]; params: int32 [S, max_parts] Rice parameters.
    Returns (words int32 [S, n_words] u32 bit patterns, bits int32 [S],
    row_ok bool [S]).  CONSTANT/VERBATIM rows get zero words, 0 bits and
    ok.  Bits past 32 * n_words are dropped; a coded row whose block
    needs more is not ok, nor an LPC row with a residual of magnitude
    2^(max_bps + 4) or more (the analysis clip bound: such a residual is
    not the exact one).  The bit count is the int64 total narrowed to
    int32."""
    _check_pack_args(res, orders, porders, params, choice, n_words,
                     max_bps)
    (idx, val, total, coded) = contributions(res, orders, porders,
                                             params, choice, n_words)
    words = scatter_words_plain(idx, val, n_words)
    clip = 1 << (max_bps + 4)
    clipped = (choice == ff.CHOICE_LPC) & torch.any(torch.abs(res) >= clip,
                                                    dim=1)
    row_ok = (~coded) | ((total <= 32 * n_words) & ~clipped)
    return (words, torch.where(coded, total, 0).to(torch.int32), row_ok)


def pack_rows(res, orders, porders, params, choice, n_words, max_bps):
    """packs the residual partition blocks of a batch of subframe rows

    Same contract as pack_rows_plain.  A CPU tensor runs the plain
    version; a CUDA tensor launches the hand-written kernel
    (csrc/pack_rows.cu) on the current stream, without synchronising,
    and counts the launch in ``pack_rows.launches``.  Any other device
    raises."""
    if res.device.type == "cpu":
        return pack_rows_plain(res, orders, porders, params, choice,
                               n_words, max_bps)
    if res.device.type != "cuda":
        raise ValueError("pack_rows: unsupported device %s" % (res.device,))
    _check_pack_args(res, orders, porders, params, choice, n_words,
                     max_bps)
    from .. import kernels
    S = res.shape[0]
    words = torch.empty((S, n_words), dtype=torch.int32, device=res.device)
    bits = torch.empty(S, dtype=torch.int32, device=res.device)
    ok = torch.empty(S, dtype=torch.bool, device=res.device)
    if S:
        kernels.pack_rows(res, orders, porders, choice, params, max_bps,
                          words, bits, ok)
        with COUNT_LOCK:
            pack_rows.launches += 1
    return (words, bits, ok)


pack_rows.launches = 0


def chosen_rows(chosen, n, max_parts):
    """the pack's row inputs from the CHOSEN subframes of a batch

    chosen: the dict from flac_frames.analyze_frames_packed(...,
    return_chosen=True).  Returns (res [S, n], orders, porders, params
    [S, max_parts], choice), contiguous int32, with S = B *
    max_subframes rows in frame-major order (the emit splice's row
    layout)."""
    res3 = chosen["residual"]                    # [B, max_sub, n]
    S = res3.shape[0] * res3.shape[1]
    return tuple(t.reshape(shape).to(torch.int32).contiguous()
                 for (t, shape) in ((res3, (S, n)), (chosen["order"], (S,)),
                                    (chosen["porder"], (S,)),
                                    (chosen["rice_params"], (S, max_parts)),
                                    (chosen["choice"], (S,))))


def pack_chosen_residuals(chosen, n, bps, stereo_trial, max_parts,
                          n_words):
    """packs the CHOSEN subframes' residual partition blocks on device

    chosen: the dict from flac_frames.analyze_frames_packed(...,
    return_chosen=True).  Returns (words int32 [S, n_words] u32 bit
    patterns, bits int32 [S], ok bool 0-d tensor) with S = B *
    max_subframes rows.  CONSTANT/VERBATIM rows contribute nothing and
    report 0 bits.  ``ok`` is False when a coded row overflows the
    capacity or its LPC residuals touched the analysis clip bound; the
    caller then emits the batch without the packed bits."""
    max_bps = bps + 1 if stereo_trial else bps
    (words, bits, row_ok) = pack_rows(*chosen_rows(chosen, n, max_parts),
                                      n_words, max_bps)
    return (words, bits, torch.all(row_ok))
