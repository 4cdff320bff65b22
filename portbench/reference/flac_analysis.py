"""Scalar FLAC subframe analysis: the reference encoder's decisions.

A frozen copy, trimmed to what ``analyze_frame`` calls, with the
original's ``ATPU_*`` switches pinned to their defaults.  One subframe at a time: wasted bits,
CONSTANT/VERBATIM/FIXED/LPC choice, Rice partition search and stereo
channel assignment, including the quantized-analysis spec (``plan_t``,
``quantize_block``, the floor retry) that the reference's scalar
encoder applies, so that a tail frame encodes byte for byte as the
reference encodes it.
"""

from __future__ import annotations

import numpy as np

from . import scalar_lpc

(CHOICE_CONSTANT, CHOICE_VERBATIM, CHOICE_FIXED, CHOICE_LPC) = range(4)


FIXED_COEFFS = {0: [], 1: [1], 2: [2, -1], 3: [3, -3, 1],
                4: [4, -6, 4, -1]}


ASSIGNMENT_VARIANTS = {1: (0, 1), 8: (0, 3), 9: (3, 1), 10: (2, 3)}


def valid_partition_orders(block_size, max_porder, max_pred_order):
    """the contiguous list of partition orders the search visits

    stops at the first porder where block_size stops dividing evenly
    (reference src/encoders/flac.c:1389-1393) or where the first
    partition would go non-positive"""
    porders = []
    for porder in range(0, max_porder + 1):
        if block_size % (1 << porder):
            break
        if (porder > 0) and ((block_size >> porder) <= max_pred_order):
            break
        porders.append(porder)
    return porders


def qpack_enabled():
    """the quantized-analysis spec (pinned on)"""
    return True


def qpack_guard():
    return 0


def qpack_cap_margin():
    return 6


def qpack_noise_extra():
    return 2


def plan_t(samples, bps, extra=None):
    """per-channel quantization shift t for one block

    samples: int [n, ch] exact; returns list of ch ints.  Spec (pure
    integer, mirrors ops/qpack.plan_t): with sum1/sum2 the exact
    |first|/|second| difference sums, m = sum2 // (n - 2) and the
    static pre-shift s = max(0, bps - 26) (which keeps the int64
    cross-multiply exact at every admitted bps; s == 0 below 27
    bits), a block is noise-dominated when m > 0 and
    5*(sum2>>s)*(n-1) >= 8*(sum1>>s)*(n-2)
    (mean |d2| >= 1.6x mean |d1|); such blocks add noise_extra bits
    to t and release the cap by 2, others keep
    t = clamp(bit_length(m) - 1 - guard, 0, max(bps - cap_margin,
    0)).  extra=0 yields the BASE plan (the floor-retry probe's
    threshold reference)."""
    guard = qpack_guard()
    margin = qpack_cap_margin()
    if extra is None:
        extra = qpack_noise_extra()
    (n, ch) = samples.shape
    out = []
    for c in range(ch):
        if n <= 2:
            out.append(0)
            continue
        x = samples[:, c].astype(np.int64)
        sum1 = int(np.abs(x[1:] - x[:-1]).sum())
        d2 = np.abs(x[2:] - 2 * x[1:-1] + x[:-2])
        sum2 = int(d2.sum())
        m = sum2 // (n - 2)
        s = max(0, int(bps) - 26)
        e = 0
        marg = margin
        if (extra > 0 and m > 0 and
                5 * (sum2 >> s) * (n - 1) >= 8 * (sum1 >> s) * (n - 2)):
            e = extra
            marg = max(margin - 2, 0)
        cap = max(int(bps) - marg, 0)
        out.append(min(max(m.bit_length() - 1 - guard + e, 0), cap))
    return out


def quantize_block(samples, t):
    """the spec'd analysis input: (x >> t) << t per channel

    samples: int [n, ch]; t: list of ch ints"""
    out = samples.astype(np.int64).copy()
    for (c, tc) in enumerate(t):
        out[:, c] = (out[:, c] >> tc) << tc
    return out


def build_variants(samples, stereo_trial):
    """the candidate channel stack for one block

    samples: int [n, ch]; returns list of int64 [n] arrays —
    [L, R, mid, side] under stereo trials (mid = floor((L+R)/2),
    side = L-R), else the channels themselves"""
    x = samples.astype(np.int64)
    if stereo_trial:
        left = x[:, 0]
        right = x[:, 1]
        return [left, right, (left + right) >> 1, left - right]
    return [x[:, c] for c in range(x.shape[1])]


def variant_sideband(samples, stereo_trial):
    """exact per-variant OR-of-samples and is-constant flags"""
    variants = build_variants(samples, stereo_trial)
    or_vals = [int(np.bitwise_or.reduce(v)) for v in variants]
    const_flags = [bool((v == v[0]).all()) for v in variants]
    return (or_vals, const_flags)


def rice_search_mode():
    """the analysis-stage Rice search flavor (pinned to "estimate": one
    per-partition parameter from the abs-sum threshold loop; the final
    parameters are re-searched exactly at emit time)"""
    return "estimate"


def _rice_search_estimate(res_aligned, order, n, porders, max_rice):
    """estimate-mode Rice partition search (see rice_search_mode)

    res_aligned: int64 [n] with warm-up positions (< order) zero.
    returns (porder, params list, bits); first-minimum over the
    contiguous porder list (strict <).

    msb bits are ESTIMATED as floor(2 * seg / 2^r) from the partition
    |residual| sums alone (mirrors ops/flac_frames' estimate branch:
    no pass over the residual plane at all — emit re-searches the
    final parameters exactly)."""
    absr = np.abs(res_aligned)
    best = None
    for porder in porders:
        parts = 1 << porder
        psize = n >> porder
        seg = absr.reshape(parts, psize).sum(axis=1)
        counts = np.full(parts, float(psize))
        counts[0] = float(psize - order)
        # r = min(smallest r with count*2^r >= sum, max_rice)
        r = np.zeros(parts, dtype=np.int64)
        for rr in range(max_rice):
            r += (counts * float(1 << rr) < seg)
        est_msb = np.floor(seg.astype(np.float64) * 2.0 *
                           np.exp2(-r.astype(np.float64)))
        part_bits = 4.0 + est_msb + counts * (1.0 + r)
        total = float(part_bits.sum())
        if best is None or total < best[2]:
            best = (porder, [int(v) for v in r], total)
    (porder, params, bits) = best
    if max(params) > 14:
        bits += float(1 << porder)
    return (porder, params, bits)


def _rice_search(res_aligned, order, n, porders, max_rice):
    """Rice partition search for one candidate's residuals
    (dispatches on rice_search_mode; the exact body below mirrors the
    device bit-plane ladder)

    res_aligned: int64 [n] with warm-up positions (< order) zero.
    returns (porder, params list, bits) — bits includes the
    coding-method-1 5-bit parameter correction.  First-minimum over
    the contiguous porder list (strict <)."""
    if rice_search_mode() != "exact":
        return _rice_search_estimate(res_aligned, order, n, porders,
                                     max_rice)
    u = np.where(res_aligned >= 0,
                 res_aligned << 1,
                 ((-res_aligned - 1) << 1) | 1).astype(np.int64)
    best = None
    for porder in porders:
        parts = 1 << porder
        psize = n >> porder
        useg = u.reshape(parts, psize)
        counts = np.full(parts, float(psize))
        counts[0] = float(psize - order)
        # EXACT parameter search per partition (same spec as the
        # batched kernel): bits(r) = count*(1+r) + sum(u >> r),
        # first minimum over r in 0..max_rice
        cand = np.stack(
            [(useg >> rr).sum(axis=1) + counts * (1.0 + rr)
             for rr in range(max_rice + 1)], axis=1)    # [parts, R]
        r = np.argmin(cand, axis=1).astype(np.int64)
        part_bits = 4.0 + cand[np.arange(parts), r]
        total = float(part_bits.sum())
        if best is None or total < best[2]:
            best = (porder, [int(v) for v in r], total)
    (porder, params, bits) = best
    if max(params) > 14:
        bits += float(1 << porder)
    return (porder, params, bits)


def analyze_subframe(x, bps, n, max_lpc_order, qlp_precision, porders,
                     max_rice, exhaustive, window, or_all, const_flag,
                     max_bps, single=False):
    """all encoding trials for one subframe; returns the decision dict

    x: int64 [n] (possibly quantized) analysis samples;
    or_all / const_flag: the EXACT sideband (losslessness depends on
    these two decisions, so they always come from exact data);
    max_bps: static bound on bits of |x| (bps + 1 for side channels) —
    sizes the degenerate-candidate residual clip, part of the spec."""
    K = max_lpc_order

    # ---- wasted bits (trailing zeros of the exact OR) ----
    if const_flag:
        wasted = 0
    elif or_all == 0:
        wasted = 0
    else:
        wasted = (or_all & -or_all).bit_length() - 1
    xs = x >> wasted

    # ---- FIXED order selection ----
    diffs = [xs]
    for _ in range(4):
        diffs.append(diffs[-1][1:] - diffs[-1][:-1])
    aligned = []
    for o in range(5):
        a = np.zeros(n, dtype=np.int64)
        a[o:] = diffs[o]
        aligned.append(a)
    # error sums skip the first 4 positions so every order competes
    # over the same n-4 values (reference py_encoders/flac.py:449-469)
    total_error = [int(np.abs(a[4:]).sum()) for a in aligned]
    fixed_order = 4
    for o in range(4):
        if total_error[o] < min(total_error[o + 1:]):
            fixed_order = o
            break
    if n <= 4:
        fixed_order = 0
    fixed_res = aligned[fixed_order]

    # ---- LPC candidates ----
    use_lpc = K > 0 and n > K + 1
    clip_bits = max_bps + 4
    lpc_cands = []          # (order, qlp, shift, res_aligned)
    errors = None
    degenerate = True
    if use_lpc:
        ac = scalar_lpc.windowed_autocorr(xs, window, K)
        # hi == 0 implies the exact value is 0 (integer sums scaled
        # by exact powers of two, far above the f32 underflow band)
        degenerate = all(hi == 0.0 for (hi, _lo) in ac)
        if single:
            (rows, errors) = scalar_lpc.levinson_f32(ac, K)
        else:
            (rows, errors) = scalar_lpc.levinson(ac, K)
        for order in range(1, K + 1):
            (qlp, shift) = scalar_lpc.quantize_coefficients(
                rows[order - 1][:order], qlp_precision)
            if degenerate:
                (qlp, shift) = ([0] * order, 0)
            res = scalar_lpc.lpc_residuals_aligned(
                xs, qlp, shift, clip_bits)
            lpc_cands.append((order, qlp, shift, res))

    # ---- Rice searches ----
    bound = 1 << clip_bits
    (f_porder, f_params, f_rice_bits) = _rice_search(
        np.clip(fixed_res, -bound, bound), fixed_order, n, porders,
        max_rice)
    lpc_rice = [_rice_search(res, order, n, porders, max_rice)
                for (order, _q, _s, res) in lpc_cands]

    # ---- candidate subframe sizes ----
    wb = 1.0 + (wasted if wasted > 0 else 0)
    ebps = float(bps - wasted)
    fixed_bits = (1 + 3 + 3 + wb + fixed_order * ebps +
                  f_rice_bits + 2 + 4)
    if use_lpc:
        lpc_bits = [(1 + 1 + 5 + wb + order * ebps +
                     4 + 5 + order * qlp_precision +
                     rice_bits + 2 + 4)
                    for ((order, _q, _s, _r), (_p, _pp, rice_bits))
                    in zip(lpc_cands, lpc_rice)]
        if exhaustive:
            lpc_choice = 0
            for i in range(1, K):
                if lpc_bits[i] < lpc_bits[lpc_choice]:
                    lpc_choice = i
        else:
            est = scalar_lpc.estimate_best_lpc_order(
                errors, n, float(bps), qlp_precision, K)
            lpc_choice = max(est, 1) - 1
        if degenerate:
            lpc_choice = 0
        lpc_best_bits = lpc_bits[lpc_choice]
    else:
        lpc_best_bits = 1e30
        lpc_choice = 0

    verbatim_estimate = float(bps) * n
    min_coded = min(fixed_bits, lpc_best_bits)

    if const_flag:
        choice = CHOICE_CONSTANT
    elif verbatim_estimate < min_coded:
        choice = CHOICE_VERBATIM
    elif fixed_bits < lpc_best_bits:
        choice = CHOICE_FIXED
    else:
        choice = CHOICE_LPC

    if choice == CHOICE_CONSTANT:
        sub_bits = 8.0 + bps
    elif choice == CHOICE_VERBATIM:
        sub_bits = 1 + 6 + wb + ebps * n
    elif choice == CHOICE_FIXED:
        sub_bits = fixed_bits
    else:
        sub_bits = lpc_best_bits

    out = {"choice": choice, "wasted": wasted, "sub_bits": sub_bits}
    if choice == CHOICE_FIXED:
        out.update(order=fixed_order, porder=f_porder,
                   rice=f_params, qlp=[], shift=0)
    elif choice == CHOICE_LPC:
        (order, qlp, shift, _res) = lpc_cands[lpc_choice]
        (porder, params, _bits) = lpc_rice[lpc_choice]
        out.update(order=order, porder=porder, rice=params,
                   qlp=qlp, shift=shift)
    else:
        out.update(order=0, porder=0, rice=[], qlp=[], shift=0)
    return out


def choose_assignment(lb, rb, ab, db, mid_side):
    """the reference's stereo assignment chain
    (py_encoders/flac.py:196-226); inputs are per-variant bit totals

    returns 1 (L/R), 8 (L/S), 9 (S/R) or 10 (M/S)"""
    lr = lb + rb
    if mid_side:
        if lr < min(lb + db, db + rb, ab + db):
            return 1
        if lb < min(rb, db):
            return 8
        if rb < ab:
            return 9
        return 10
    return 1 if lr < (ab + db) else 10


def analyze_frame(samples, bps, options, single=False):
    """full scalar analysis of one frame

    samples: int [n, ch] EXACT samples; applies the quantized-analysis
    spec when active, the exact or/const sideband always; single=True
    runs the Levinson recursion in plain float32 (the control).  Returns
    (assignment, [decision dicts], [exact int64 variant arrays])."""
    (n, ch) = samples.shape
    stereo_trial = (ch == 2) and (options.mid_side or
                                  options.adaptive_mid_side)
    K = options.max_lpc_order
    porders = valid_partition_orders(
        n, options.max_residual_partition_order, max(K, 4))
    window = scalar_lpc.tukey_window(n)
    max_bps = bps + 1 if stereo_trial else bps

    (or_vals, const_flags) = variant_sideband(samples, stereo_trial)

    def run(analysis_samples):
        analysis_variants = build_variants(analysis_samples,
                                           stereo_trial)
        decisions = []
        for (v, xv) in enumerate(analysis_variants):
            v_bps = bps + 1 if (stereo_trial and v == 3) else bps
            decisions.append(analyze_subframe(
                xv, v_bps, n, K, options.qlp_precision, porders,
                options.max_rice_parameter,
                options.exhaustive_model_search, window,
                or_vals[v], const_flags[v], max_bps, single))
        if stereo_trial:
            assignment = choose_assignment(
                decisions[0]["sub_bits"], decisions[1]["sub_bits"],
                decisions[2]["sub_bits"], decisions[3]["sub_bits"],
                options.mid_side)
            (v0, v1) = ASSIGNMENT_VARIANTS[assignment]
            return (assignment, [decisions[v0], decisions[v1]])
        return (ch - 1, decisions)

    use_qpack = qpack_enabled() and (bps + 2 <= 31)
    if use_qpack:
        t = plan_t(samples, bps)
        (assignment, chosen) = run(quantize_block(samples, t))
        # quantization-floor retry (same spec as the batched path,
        # codecs/flac_enc_fast._floor_limited).  Stage 1: a coded
        # subframe whose EVERY used Rice parameter sits at or below
        # the block's quantization shift + 1 may have analyzed mostly
        # quantization noise (noise at step 2^t codes at r in
        # {t-1, t, t+1}, and tonal frames land in the same band), so
        # stage 2 probes the EXACT samples through the quantized-fit
        # predictor: tonal frames collapse far below the quantization
        # step (mean-|residual| bits <= t - 2) and re-analyze exactly;
        # noise stays at the step's scale and keeps the fast decisions
        t_frame = int(max(t))
        # the stage-2 probe threshold references the BASE plan
        # (noise-adaptive extra removed): a noise-classified block's
        # coarser step deliberately sits above its LPC-residual
        # scale, which is incompressible noise, not a buried tone
        t_base = int(max(plan_t(samples, bps, extra=0)))
        candidates = [
            dec for dec in chosen
            if (dec["choice"] in (CHOICE_FIXED, CHOICE_LPC) and
                max(dec["rice"]) <= t_frame + 1 and t_frame > 0)]
        floor_limited = False
        if candidates:
            exact_chosen = build_variants(samples.astype(np.int64),
                                          stereo_trial)
            if stereo_trial:
                (v0, v1) = ASSIGNMENT_VARIANTS[assignment]
                sub_x = [exact_chosen[v0], exact_chosen[v1]]
            else:
                sub_x = exact_chosen
            for (s, dec) in enumerate(chosen):
                if dec["choice"] not in (CHOICE_FIXED, CHOICE_LPC):
                    continue
                x = np.asarray(sub_x[s],
                               dtype=np.int64) >> dec["wasted"]
                o = dec["order"]
                if dec["choice"] == CHOICE_FIXED:
                    q = np.asarray(FIXED_COEFFS[o], dtype=np.int64)
                    sh = 0
                else:
                    q = np.asarray(dec["qlp"][:o], dtype=np.int64)
                    sh = dec["shift"]
                pred = np.zeros(n - o, dtype=np.int64)
                for j in range(o):
                    pred += q[j] * x[o - 1 - j:n - 1 - j]
                res = x[o:] - (pred >> sh)
                m = int(np.abs(res).sum()) // max(n - o, 1)
                if m.bit_length() <= t_base - 2:
                    floor_limited = True
                    break
        if floor_limited:
            (assignment, chosen) = run(samples.astype(np.int64))
    else:
        (assignment, chosen) = run(samples.astype(np.int64))

    exact_variants = build_variants(samples, stereo_trial)
    if stereo_trial:
        (v0, v1) = ASSIGNMENT_VARIANTS[assignment]
        return (assignment, chosen,
                [exact_variants[v0], exact_variants[v1]])
    return (assignment, chosen, exact_variants)
