"""Batched FLAC subframe analysis and decisions, in torch.

Port of ``audiotools_tpu/ops/flac_frames.py``: subframe trials, LPC
order sweeps and Rice partition searches as argmins over candidate
axes of ``[subframes, block_size]`` tensors.  The decision arrays it
returns are bit-identical to the reference's numpy path; the C++
emitter reads them unchanged.

Only the default ``"estimate"`` Rice search is ported.  The reference's
``ATPU_DEVICE_RICE=exact`` ladder raises NotImplementedError here.

Differences in form from the reference (values are the same):

* integer sums run in int64 in one pass (``exact_sum``) instead of
  int32 partial sums over chunks then f64: every total is an exact
  integer either way;
* wasted bits are counted as trailing zeros by mask tests, since
  torch has no popcount.
"""

from __future__ import annotations

import os

import torch

from . import lpc as lpc_ops
from .bits import exact_exp2

(CHOICE_CONSTANT, CHOICE_VERBATIM, CHOICE_FIXED, CHOICE_LPC) = range(4)

# packed decision row layout (int32), per subframe:
#   [choice, wasted, order, porder, shift, sub_bits, qlp*K, rice*P]
# full row: [assignment] + max_subframes * W where W = 6 + K + P
PACKED_SCALARS = 6


def compact_width(max_lpc_order, max_parts):
    """per-subframe width of the COMPACT decision layout (the wire
    format for device->host decision downloads): one bit-packed
    scalar word [choice(4b) | wasted<<4 (6b) | order<<10 (6b) |
    porder<<16 (4b) | shift<<20 (5b)], qlp coefficients as int16
    pairs, Rice parameters as u8 quads"""
    Kp = max(max_lpc_order, 1)
    return 1 + (Kp + 1) // 2 + (max_parts + 3) // 4


def valid_partition_orders(block_size, max_porder, max_pred_order):
    """the contiguous list of partition orders the search visits

    stops at the first porder where block_size stops dividing evenly
    or where the first partition would go non-positive"""
    porders = []
    for porder in range(0, max_porder + 1):
        if block_size % (1 << porder):
            break
        if (porder > 0) and ((block_size >> porder) <= max_pred_order):
            break
        porders.append(porder)
    return porders


def _check_rice_mode():
    mode = os.environ.get("ATPU_DEVICE_RICE", "estimate")
    if mode == "exact":
        raise NotImplementedError(
            "ATPU_DEVICE_RICE=exact is not ported to audiotools_tpu_torch "
            "yet; only the default \"estimate\" Rice search is")


def _pad_last(x, right):
    """zero-pads the last axis on the right"""
    return torch.nn.functional.pad(x, (0, right)) if right else x


def compact_decisions(packed, max_subframes, max_lpc_order, max_parts):
    """[B, 1 + S*W] standard decision rows -> the compact wire layout
    [B, 1 + S*CW] the C++ emitter reads with compact=1 (see the
    reference's compact_width)"""
    Kp = max(max_lpc_order, 1)
    P = max_parts
    W = PACKED_SCALARS + Kp + P
    B = packed.shape[0]
    rows = packed[:, 1:].reshape(B, max_subframes, W)
    (choice, wasted, order, porder, shift) = (
        rows[:, :, c] for c in range(5))
    w0 = (choice | (wasted << 4) | (order << 10) | (porder << 16) |
          (shift << 20))
    qlp = _pad_last(rows[:, :, PACKED_SCALARS:PACKED_SCALARS + Kp] & 0xFFFF,
                    Kp % 2)
    qpair = qlp[:, :, 0::2] | (qlp[:, :, 1::2] << 16)
    rice = _pad_last(rows[:, :, PACKED_SCALARS + Kp:] & 0xFF, (-P) % 4)
    rquad = (rice[:, :, 0::4] | (rice[:, :, 1::4] << 8) |
             (rice[:, :, 2::4] << 16) | (rice[:, :, 3::4] << 24))
    per_sub = torch.cat([w0[:, :, None], qpair, rquad], dim=2)
    return torch.cat([packed[:, :1], per_sub.reshape(B, -1)],
                     dim=1).to(torch.int32)


def build_variants(blocks, stereo_trial, bps):
    """[B, n, ch] blocks -> (X int32 [B*V, n], bps_vec int32 [B*V]);
    stereo trials give [left, right, mid, side] per frame"""
    (B, n, ch) = blocks.shape
    dev = blocks.device
    if stereo_trial:
        left = blocks[:, :, 0].to(torch.int32)
        right = blocks[:, :, 1].to(torch.int32)
        X = torch.stack([left, right, (left + right) >> 1, left - right],
                        dim=1)                             # [B, 4, n]
        bps_vec = torch.tensor([bps, bps, bps, bps + 1], dtype=torch.int32,
                               device=dev).repeat(B)
        V = 4
    else:
        X = blocks.transpose(1, 2).to(torch.int32)         # [B, ch, n]
        bps_vec = torch.full((B * ch,), bps, dtype=torch.int32, device=dev)
        V = ch
    return (X.reshape(B * V, n), bps_vec)


def exact_sum(x):
    """exact float64 sum of integer values along the last axis (int64
    accumulation; totals stay far below 2^53)"""
    return torch.sum(x, dim=-1, dtype=torch.int64).to(torch.float64)


def trailing_zeros(v):
    """trailing zero count of the 32-bit patterns of an integer tensor
    (32 for 0), int32"""
    v = v.to(torch.int64) & 0xFFFFFFFF
    out = torch.zeros(v.shape, dtype=torch.int32, device=v.device)
    for k in range(32):
        out += ((v & ((2 << k) - 1)) == 0).to(torch.int32)
    return out


def _gather(x, idx, dim):
    return torch.take_along_dim(x, idx.to(torch.int64), dim=dim)


def analyze_subframes(X, bps, n, max_lpc_order, qlp_precision, porders,
                      max_rice, exhaustive, window, max_bps=25):
    """runs all subframe trials for a batch of channels

    X: int32 [S, n] exact samples; bps: int32 [S]; window: (hi, lo)
    f64 pair from lpc.window_to_torch; max_bps: static bound on bits of
    |X|.  Returns the reference's dict of [S]-leading tensors."""
    _check_rice_mode()
    S = X.shape[0]
    K = max_lpc_order
    dev = X.device
    X = X.to(torch.int32)
    bps = torch.as_tensor(bps, dtype=torch.int32, device=dev)
    bps_f = bps.to(torch.float64)

    # ---- constant detection and wasted bits ----------------------------
    const_flag = torch.all(X == X[:, :1], dim=1)
    const_val = X[:, 0]
    or_all = X
    while or_all.shape[1] > 1:
        half = (or_all.shape[1] + 1) // 2
        or_all = _pad_last(or_all, 2 * half - or_all.shape[1])
        or_all = or_all[:, :half] | or_all[:, half:]
    or_all = or_all[:, 0]
    wasted = torch.where((or_all == 0) | const_flag, 0,
                         trailing_zeros(or_all))
    Xs = X >> wasted[:, None]

    # ---- FIXED order selection ----------------------------------------
    diffs = [Xs]
    for _ in range(4):
        diffs.append(diffs[-1][:, 1:] - diffs[-1][:, :-1])
    fixed_res_all = torch.stack(
        [torch.nn.functional.pad(diffs[o], (o, 0)) for o in range(5)],
        dim=1)                                             # [S, 5, n]
    total_error = exact_sum(torch.abs(fixed_res_all[:, :, 4:]))  # [S, 5]
    # first order o in 0..3 with err[o] < min(err[o+1:]), else 4
    suffix_min = total_error[:, 4]
    conds = []
    for o in range(3, -1, -1):
        conds.append(total_error[:, o] < suffix_min)
        suffix_min = torch.minimum(suffix_min, total_error[:, o])
    conds = torch.stack(conds[::-1], dim=1).to(torch.int32)  # [S, 4]
    fixed_order = torch.where(conds.any(dim=1),
                              torch.argmax(conds, dim=1).to(torch.int32),
                              4)
    if n <= 4:
        fixed_order = torch.zeros(S, dtype=torch.int32, device=dev)
    fixed_res = _gather(fixed_res_all, fixed_order[:, None, None],
                        1)[:, 0]                           # [S, n]

    # ---- LPC analysis --------------------------------------------------
    use_lpc = K > 0 and n > K + 1
    if use_lpc:
        autocorr = lpc_ops.windowed_autocorr_df(Xs, window, K)
        degenerate = torch.all(autocorr[0] == 0.0, dim=1)
        (coeffs, errors) = lpc_ops.levinson_df(autocorr, K)
        (qlp, shifts) = lpc_ops.quantize_all_orders(coeffs, qlp_precision)
        qlp = torch.where(degenerate[:, None, None], 0, qlp)
        shifts = torch.where(degenerate[:, None], 0, shifts)
        lpc_res = lpc_ops.lpc_residuals(Xs, qlp, shifts, max_bps,
                                        qlp_precision,
                                        clip_bits=max_bps + 4)
        cand_res = torch.cat([fixed_res[:, None, :], lpc_res], dim=1)
        del lpc_res
        cand_orders = torch.cat(
            [fixed_order[:, None],
             torch.arange(1, K + 1, dtype=torch.int32,
                          device=dev).expand(S, K)], dim=1)  # [S, C]
    else:
        degenerate = torch.ones(S, dtype=torch.bool, device=dev)
        Kq = max(K, 1)
        qlp = torch.zeros((S, Kq, Kq), dtype=torch.int32, device=dev)
        shifts = torch.zeros((S, Kq), dtype=torch.int32, device=dev)
        cand_res = fixed_res[:, None, :]
        cand_orders = fixed_order[:, None]
    C = cand_res.shape[1]

    # ---- Rice partition search ("estimate" mode) ----------------------
    orders_f = cand_orders.to(torch.float64)
    pmax = porders[-1]
    parts_max = 1 << pmax
    seg_abs_by_p = [None] * (pmax + 1)
    seg_abs_by_p[pmax] = exact_sum(
        torch.abs(cand_res).reshape(S, C, parts_max, n >> pmax))
    for p in range(pmax - 1, -1, -1):
        fine = seg_abs_by_p[p + 1]
        seg_abs_by_p[p] = fine[:, :, 0::2] + fine[:, :, 1::2]

    rice_totals = []        # per porder: [S, C] f64
    rice_params_by_p = []   # per porder: [S, C, parts] int32
    for porder in porders:
        parts = 1 << porder
        psize = n >> porder
        seg_abs = seg_abs_by_p[porder]                     # [S,C,parts]
        counts = torch.full((S, C, parts), float(psize),
                            dtype=torch.float64, device=dev)
        counts[:, :, 0] = psize - orders_f
        # r = min(smallest r with count*2^r >= sum, max_rice)
        r = torch.zeros((S, C, parts), dtype=torch.int32, device=dev)
        for rr in range(max_rice):
            r += ((counts * float(1 << rr)) < seg_abs).to(torch.int32)
        est_msb = torch.floor(seg_abs * 2.0 * exact_exp2(-r))
        part_bits = 4.0 + est_msb + counts * (1.0 + r.to(torch.float64))
        rice_totals.append(torch.sum(part_bits, dim=2))
        rice_params_by_p.append(r)
    rice_totals = torch.stack(rice_totals, dim=2)          # [S, C, P]
    best_porder_idx = torch.argmin(rice_totals, dim=2)     # first min
    rice_bits = torch.amin(rice_totals, dim=2)             # [S, C]

    padded_params = torch.stack(
        [_pad_last(p, parts_max - p.shape[2]) for p in rice_params_by_p],
        dim=2)                                             # [S,C,P,maxp]
    chosen_params = _gather(padded_params,
                            best_porder_idx[:, :, None, None], 2)[:, :, 0]
    chosen_porder = torch.tensor(porders, dtype=torch.int32,
                                 device=dev)[best_porder_idx]
    method1 = torch.any(chosen_params > 14, dim=2)         # [S, C]
    rice_bits = rice_bits + torch.where(method1, exact_exp2(chosen_porder),
                                        0.0)

    # ---- candidate subframe sizes -------------------------------------
    wasted_f = wasted.to(torch.float64)
    wb = 1.0 + torch.where(wasted > 0, wasted_f, 0.0)      # [S]
    ebps = bps_f - wasted_f
    fixed_bits = (1 + 3 + 3 + wb + orders_f[:, 0] * ebps +
                  rice_bits[:, 0] + 2 + 4)
    if use_lpc:
        lpc_orders = orders_f[:, 1:]                       # [S, K]
        lpc_bits = (1 + 1 + 5 + wb[:, None] +
                    lpc_orders * ebps[:, None] +
                    4 + 5 + lpc_orders * qlp_precision +
                    rice_bits[:, 1:] + 2 + 4)              # [S, K]
        if exhaustive:
            lpc_choice = torch.argmin(lpc_bits, dim=1).to(torch.int32)
        else:
            est = lpc_ops.estimate_best_lpc_order(
                errors, n, bps_f, qlp_precision, K)
            lpc_choice = (torch.clamp(est, min=1) - 1).to(torch.int32)
        lpc_choice = torch.where(degenerate, 0, lpc_choice)
        lpc_best_bits = _gather(lpc_bits, lpc_choice[:, None], 1)[:, 0]
        lpc_order_sel = lpc_choice + 1                     # [S] int32
    else:
        lpc_best_bits = torch.full((S,), 1e30, dtype=torch.float64,
                                   device=dev)
        lpc_choice = torch.zeros(S, dtype=torch.int32, device=dev)
        lpc_order_sel = torch.ones(S, dtype=torch.int32, device=dev)

    verbatim_estimate = bps_f * n
    verbatim_actual = 1 + 6 + wb + ebps * n
    min_coded = torch.minimum(fixed_bits, lpc_best_bits)

    choice = torch.where(
        const_flag, CHOICE_CONSTANT,
        torch.where(verbatim_estimate < min_coded, CHOICE_VERBATIM,
                    torch.where(fixed_bits < lpc_best_bits,
                                CHOICE_FIXED, CHOICE_LPC))).to(torch.int32)
    sub_bits = torch.where(
        choice == CHOICE_CONSTANT, 8.0 + bps_f,
        torch.where(choice == CHOICE_VERBATIM, verbatim_actual,
                    torch.where(choice == CHOICE_FIXED, fixed_bits,
                                lpc_best_bits)))

    # ---- gather chosen candidate data ---------------------------------
    cand_idx = torch.where(choice == CHOICE_LPC, 1 + lpc_choice, 0)
    chosen_res = _gather(cand_res, cand_idx[:, None, None], 1)[:, 0]
    chosen_order = torch.where(choice == CHOICE_LPC, lpc_order_sel,
                               cand_orders[:, 0]).to(torch.int32)
    chosen_rice = _gather(chosen_params, cand_idx[:, None, None], 1)[:, 0]
    chosen_porder2 = _gather(chosen_porder, cand_idx[:, None], 1)[:, 0]
    qlp_row = torch.clamp(lpc_order_sel - 1, min=0)
    chosen_qlp = _gather(qlp, qlp_row[:, None, None], 1)[:, 0]
    chosen_shift = _gather(shifts, qlp_row[:, None], 1)[:, 0]

    return {
        "choice": choice,
        "wasted": wasted.to(torch.int32),
        "const_val": const_val.to(torch.int32),
        "order": chosen_order,
        "porder": chosen_porder2.to(torch.int32),
        "rice_params": chosen_rice.to(torch.int32),
        "residual": chosen_res.to(torch.int32),
        "qlp": chosen_qlp.to(torch.int32),
        "shift": chosen_shift.to(torch.int32),
        "samples": Xs.to(torch.int32),
        "sub_bits": sub_bits,
    }


def choose_assignment(lb, rb, ab, db, mid_side):
    """the reference's stereo assignment chain; per-frame bit totals
    -> codes [B] int32: 1 (L/R), 8 (L/S), 9 (S/R), 10 (M/S)"""
    lr = lb + rb
    if mid_side:
        take_lr = lr < torch.minimum(torch.minimum(lb + db, db + rb),
                                     ab + db)
        take_ls = lb < torch.minimum(rb, db)
        take_sr = rb < ab
        out = torch.where(take_lr, 1,
                          torch.where(take_ls, 8,
                                      torch.where(take_sr, 9, 10)))
    else:
        out = torch.where(lr < (ab + db), 1, 10)
    return out.to(torch.int32)


def analyze_frames_packed(blocks, stereo_trial, bps, n, max_lpc_order,
                          qlp_precision, porders, max_rice, exhaustive,
                          mid_side, window, return_chosen=False):
    """full per-frame analysis: variants, subframe trials, channel
    assignment and decision packing

    blocks: int [B, n, ch] exact samples on the target device.
    Returns packed int32 [B, 1 + max_subframes * W] (the reference's
    layout), and with return_chosen=True also the chosen subframes'
    analysis data for bitpack.pack_chosen_residuals."""
    (B, _n, ch) = blocks.shape
    K = max_lpc_order
    P = 1 << porders[-1]
    dev = blocks.device

    (X, bps_vec) = build_variants(blocks, stereo_trial, bps)
    out = analyze_subframes(X, bps_vec, n, K, qlp_precision, list(porders),
                            max_rice, exhaustive, window,
                            max_bps=bps + 1 if stereo_trial else bps)

    V = 4 if stereo_trial else ch
    sub_bits = out["sub_bits"].reshape(B, V)
    if stereo_trial:
        a = choose_assignment(sub_bits[:, 0], sub_bits[:, 1],
                              sub_bits[:, 2], sub_bits[:, 3], mid_side)
        var0 = torch.where(a == 9, 3, torch.where(a == 10, 2, 0))
        var1 = torch.where((a == 1) | (a == 9), 1, 3)
        pairs = torch.stack([var0, var1], dim=1)           # [B, 2]
        max_subframes = 2
    else:
        a = torch.full((B,), ch - 1, dtype=torch.int32, device=dev)
        pairs = torch.arange(V, dtype=torch.int32, device=dev).expand(B, V)
        max_subframes = V

    def gather(name, extra):
        arr = out[name].reshape((B, V) + extra)
        idx = pairs.reshape((B, max_subframes) + (1,) * len(extra))
        return _gather(arr, idx, 1)

    scalars = torch.stack([
        gather("choice", ()),
        gather("wasted", ()),
        gather("order", ()),
        gather("porder", ()),
        gather("shift", ()),
        _gather(sub_bits, pairs, 1).to(torch.int32),
    ], dim=2)                                   # [B, max_subframes, 6]
    Kp = max(K, 1)
    qlp = gather("qlp", (out["qlp"].shape[-1],))
    qlp = _pad_last(qlp, Kp - qlp.shape[-1])
    rice = gather("rice_params", (out["rice_params"].shape[-1],))
    rice = _pad_last(rice, P - rice.shape[-1])

    per_sub = torch.cat([scalars, qlp, rice], dim=2)
    packed = torch.cat([a[:, None],
                        per_sub.reshape(B, max_subframes * per_sub.shape[2])],
                       dim=1).to(torch.int32)
    if not return_chosen:
        return packed
    chosen = {
        "residual": gather("residual", (n,)),  # [B, max_sub, n]
        "choice": gather("choice", ()),
        "order": gather("order", ()),
        "porder": gather("porder", ()),
        "rice_params": rice,                   # [B, max_sub, P]
        "max_subframes": max_subframes,
    }
    return (packed, chosen)
