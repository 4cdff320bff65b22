"""The PyTorch port's residual bit-pack (audiotools_tpu_torch/ops/
bitpack.py) against the reference (ops/pallas_bitpack.py).

On the CPU the port's pack is its plain version (tokenize, split,
scatter); it is held equal to the reference's numpy token model, to
the reference's Pallas kernel in interpret mode (the JAX package's own
CPU route) and to the serial writer ``ref/flac_enc.write_residual_block``.
``kernel_model`` below redoes the arithmetic of the CUDA kernel
(csrc/pack_rows.cu) step by step in numpy, and is held to the same
references.  The kernel itself is compared with the plain version by
the ``cuda``-marked tests, which skip where no card is present (and by
chip_smoke.py on the card).
"""

import numpy as np
import pytest
import torch

from audiotools_tpu.ops import flac_frames as ref_ff
from audiotools_tpu.ops import pallas_bitpack as ref
from audiotools_tpu_torch.ops import bitpack as port
from audiotools_tpu_torch.ops import flac_frames as port_ff
from test_pallas_bitpack import batch_cases, serial_block

torch.set_num_threads(1)

(FIXED, LPC) = (ref_ff.CHOICE_FIXED, ref_ff.CHOICE_LPC)
(CONSTANT, VERBATIM) = (ref_ff.CHOICE_CONSTANT, ref_ff.CHOICE_VERBATIM)
THREADS = 256       # csrc/pack_rows.cu: threads a row


def t(a):
    return torch.as_tensor(np.asarray(a))


def port_pack(res, orders, porders, params, n_words):
    """the port's tokenize + split + plain scatter; returns (words as
    uint32 numpy, total bits, idx, val)"""
    (S, n) = res.shape
    (ends, payload, widths, total) = port.tokenize(
        t(res), t(orders), t(porders), t(params), n, params.shape[1])
    (idx, val) = port.split_contributions(ends, payload, widths)
    words = port.scatter_words_plain(idx.to(torch.int32),
                                     port.u32_to_i32(val), n_words)
    return (words.numpy().view(np.uint32), total.numpy(), idx, val)


@pytest.mark.parametrize("seed,n,S", [(1, 256, 6), (7, 4096, 4)])
def test_tokens_and_words_match_reference(seed, n, S):
    (orders, porders, params, res) = batch_cases(seed=seed, n=n, S=S)
    n_words = ref.words_needed(n, 16, params.shape[1])
    (ends, payload, widths, total) = ref.tokenize(
        np, res, orders, porders, params, n, params.shape[1])
    (idx, val) = ref.split_contributions(np, ends, payload, widths)

    (ends_t, payload_t, widths_t, total_t) = port.tokenize(
        t(res), t(orders), t(porders), t(params), n, params.shape[1])
    assert np.array_equal(ends_t.numpy(), ends)
    assert np.array_equal(payload_t.numpy(), payload.astype(np.int64))
    assert np.array_equal(widths_t.numpy(), widths)
    assert np.array_equal(total_t.numpy(), total)
    (idx_t, val_t) = port.split_contributions(ends_t, payload_t, widths_t)
    assert np.array_equal(idx_t.numpy(), idx)
    assert np.array_equal(val_t.numpy(), val.astype(np.int64))

    (words, bits, _i, _v) = port_pack(res, orders, porders, params,
                                      n_words)
    assert np.array_equal(words, ref.scatter_words_xla(np, idx, val,
                                                       n_words))
    for s in range(S):
        assert (ref.words_to_bytes(words[s], bits[s]) ==
                serial_block(n, int(orders[s]), int(porders[s]),
                             params[s], res[s]))


def test_plain_scatter_matches_pallas_interpret():
    (orders, porders, params, res) = batch_cases(seed=1, n=256, S=6)
    n_words = ref.words_needed(256, 16, params.shape[1])
    (words, _bits, idx, val) = port_pack(res, orders, porders, params,
                                         n_words)
    want = ref.scatter_words_pallas(idx.numpy().astype(np.int32),
                                    val.numpy().astype(np.uint32),
                                    n_words, interpret=True)
    assert np.array_equal(words, np.asarray(want))


def test_method1_large_parameters():
    """24-bit-scale residuals force coding method 1 (5-bit params)"""
    rng = np.random.default_rng(3)
    n = 256
    res = rng.integers(-(1 << 22), 1 << 22, n).astype(np.int64)[None]
    params = np.full((1, 4), 20, dtype=np.int32)
    orders = np.array([0], np.int32)
    porders = np.array([2], np.int32)
    (words, bits, _i, _v) = port_pack(res, orders, porders, params,
                                      ref.words_needed(n, 26, 4))
    assert (ref.words_to_bytes(words[0], bits[0]) ==
            serial_block(n, 0, 2, params[0], res[0]))


# ---- the kernel's arithmetic, step by step -------------------------------

def kernel_model(res, orders, porders, params, choice, n_words, max_bps,
                 tile_words=None):
    """csrc/pack_rows.cu in numpy: (words int32 [S, n_words], bits int32
    [S], row_ok bool [S])

    Per row, as one block of THREADS threads: each thread's contiguous
    run of ceil(n / THREADS) residuals, their zigzag values and 64-bit
    code lengths, the threads' sums scanned as the kernel scans them
    (shuffles up within each warp of 32, then the warp totals), each
    field's end bit 6 + (p + 1) * plen + prefix + len, and the fields
    ORed into a tile of words, a window of tile_words words at a time,
    the tile starting (row * n_words + w0) % 4 words in, bits past the
    window dropped."""
    (S, n) = res.shape
    max_parts = params.shape[1]
    words = np.zeros((S, n_words), dtype=np.uint32)
    bits = np.zeros(S, dtype=np.int32)
    row_ok = np.ones(S, dtype=bool)
    run = -(-n // THREADS)
    start = np.minimum(np.arange(THREADS) * run, n)
    i = start[:, None] + np.arange(run)[None, :]           # [threads, run]
    in_run = i < np.minimum(start + run, n)[:, None]
    i = np.minimum(i, n - 1)
    if tile_words is None:
        tile_words = max(4, -(-n_words // 4) * 4)
    for s in range(S):
        if choice[s] not in (FIXED, LPC):
            continue
        # 1. the row's parameters
        porder = min(max(int(porders[s]), 0), 15)
        parts = 1 << porder
        psize = max(n >> porder, 1)
        prm = params[s].astype(np.int64)
        method1 = bool(np.any(prm[:min(parts, max_parts)] > 14))
        plen = 5 if method1 else 4
        # 2. code lengths of each thread's run
        x = res[s].astype(np.int32)[i].astype(np.int64)
        u = ((x << 1) ^ (x >> 31)) & 0xFFFFFFFF
        p = i // psize
        r = prm[np.minimum(p, max_parts - 1)]
        live = in_run & (i >= orders[s]) & (p < parts)
        length = np.where(live, (u >> r) + 1 + r, 0)
        sums = length.sum(axis=1)
        # 3. exclusive scan: __shfl_up_sync in each warp, then the warps
        incl = sums.reshape(THREADS // 32, 32)
        for d in (1, 2, 4, 8, 16):
            up = np.zeros_like(incl)
            up[:, d:] = incl[:, :-d]
            incl = incl + up
        warp_sums = incl[:, 31]
        before = np.cumsum(warp_sums) - warp_sums
        excl = (before[:, None] + incl).reshape(THREADS) - sums
        total = 6 + parts * plen + int(warp_sums.sum())
        # the sideband: |x| in int32, so -2^31 stays negative
        mag = np.abs(res[s].astype(np.int32)).astype(np.int64)
        clipped = choice[s] == LPC and bool(np.any(mag >= 1 << (max_bps + 4)))
        bits[s] = np.array([total & 0xFFFFFFFF], np.uint32).view(np.int32)[0]
        row_ok[s] = total <= 32 * n_words and not clipped
        # the fields (end bit, value): header, parameters, codes
        base = (6 + (p + 1) * plen +
                excl[:, None] + np.cumsum(length, axis=1) - length)
        first = in_run & (i % psize == 0) & (p < parts)
        ends = np.concatenate([[6], base[first], (base + length)[live]])
        vals = np.concatenate([
            [(int(method1) << 4) | porder],
            prm[np.minimum(p, max_parts - 1)][first],
            ((1 << r) | (u & ((1 << r) - 1)))[live]])
        wide = vals << (31 - ((ends - 1) & 31))
        q1 = (ends - 1) >> 5
        q = np.concatenate([q1 - 1, q1])
        val = np.concatenate([wide >> 32, wide & 0xFFFFFFFF])
        # 4-5. the tile, a window at a time
        for w0 in range(0, n_words, tile_words):
            w1 = min(w0 + tile_words, n_words)
            lead = (s * n_words + w0) & 3
            tile = np.zeros(-(-(lead + w1 - w0) // 4) * 4, dtype=np.int64)
            inside = (val != 0) & (q >= w0) & (q < w1)
            np.bitwise_or.at(tile, q[inside] - w0 + lead, val[inside])
            words[s, w0:w1] = tile[lead:lead + w1 - w0]
    return (words.view(np.int32), bits, row_ok)


def row_params(res, order, porder, max_parts):
    """Rice parameters for a row, by make_case's rule"""
    n = res.shape[0]
    psize = n >> porder
    params = np.zeros(max_parts, dtype=np.int32)
    for p in range(1 << porder):
        seg = np.abs(res[max(p * psize, order if p == 0 else 0):
                         (p + 1) * psize]).sum()
        cnt = max(psize - (order if p == 0 else 0), 1)
        r = 0
        while (cnt << r) < seg and r < 30:
            r += 1
        params[p] = r
    return params


def largest_porder(n):
    return port_ff.valid_partition_orders(n, 8, 4)[-1]


def model_batch(n, seed=1):
    """rows at block size n: batch_cases's (seed, 6 rows), then for each
    partition order from 0 to the largest valid one a row of warm-up
    order 32 (or below n's first partition) with nonzero warm-up
    residuals, a method-1 row of 24-bit-scale residuals, a row whose
    parameters reach 28-30, and CONSTANT and VERBATIM rows whose
    residuals would overflow any capacity.  Coded rows alternate FIXED
    and LPC.  Returns (res int32, orders, porders, params, choice)."""
    max_parts = 1 << largest_porder(n)
    (orders, porders, params, res) = batch_cases(seed=seed, n=n, S=6,
                                                 max_parts=max_parts)
    rows = [(res[s], orders[s], porders[s], params[s]) for s in range(6)]
    rng = np.random.default_rng(seed + 100)
    for porder in range(largest_porder(n) + 1):
        order = min(32, (n >> porder) - 1)
        r = rng.integers(-300 << porder, 300 << porder, n)
        rows.append((r, order, porder, row_params(r, order, porder,
                                                  max_parts)))
    for (scale, porder) in ((1 << 22, 2), (1 << 29, 0)):
        r = rng.integers(-scale, scale, n)
        rows.append((r, 3, porder, row_params(r, 3, porder, max_parts)))
    res = np.stack([r for (r, _o, _p, _q) in rows]).astype(np.int32)
    orders = np.array([o for (_r, o, _p, _q) in rows], np.int32)
    porders = np.array([p for (_r, _o, p, _q) in rows], np.int32)
    params = np.stack([q for (_r, _o, _p, q) in rows]).astype(np.int32)
    choice = np.where(np.arange(len(rows)) % 2, LPC, FIXED)
    # CONSTANT and VERBATIM rows: huge residuals, parameter 0, porder 15
    wild = rng.integers(-(1 << 31), (1 << 31) - 1, (2, n)).astype(np.int32)
    res = np.concatenate([res, wild])
    orders = np.concatenate([orders, [0, 5]]).astype(np.int32)
    porders = np.concatenate([porders, [15, 15]]).astype(np.int32)
    params = np.concatenate([params, np.zeros((2, max_parts), np.int32)])
    choice = np.concatenate([choice, [CONSTANT, VERBATIM]]).astype(np.int32)
    return (res, orders, porders, params, choice)


def reference_pack(batch, n_words, max_bps, backend):
    """ref.pack_chosen_residuals on the rows of `batch` (one subframe a
    frame); backend "numpy" or "pallas" (interpret mode)"""
    (res, orders, porders, params, choice) = batch
    (S, n) = res.shape
    chosen = {"residual": res.reshape(S, 1, n), "choice": choice[:, None],
              "order": orders[:, None], "porder": porders[:, None],
              "rice_params": params[:, None, :]}
    if backend == "numpy":
        xp = np
    else:
        import jax.numpy as xp
        chosen = {k: xp.asarray(v) for (k, v) in chosen.items()}
    out = ref.pack_chosen_residuals(xp, chosen, n, max_bps, False,
                                    params.shape[1], n_words,
                                    backend=backend, interpret=True)
    return tuple(np.asarray(o) for o in out)


# max_bps 26: the clip bound 2^30 lies above every coded row's residuals
MODEL_BPS = 26


@pytest.mark.parametrize("n", [256, 1152, 4096, 4608])
def test_kernel_model_matches_reference(n):
    """the kernel's arithmetic gives the reference's words and bits,
    through both of its routes, and each coded row its serial bytes"""
    batch = model_batch(n)
    max_parts = batch[3].shape[1]
    n_words = ref.words_needed(n, MODEL_BPS, max_parts)
    (words, bits, row_ok) = kernel_model(*batch, n_words, MODEL_BPS)
    assert row_ok.all()
    for backend in ("numpy", "pallas"):
        (want_words, want_bits, want_ok) = reference_pack(
            batch, n_words, MODEL_BPS, backend)
        assert np.array_equal(words.view(np.uint32), want_words)
        assert np.array_equal(bits, want_bits)
        assert bool(want_ok)
    (res, orders, porders, params, choice) = batch
    for s in np.flatnonzero((choice == FIXED) | (choice == LPC)):
        aligned = res[s].astype(np.int64)
        aligned[:orders[s]] = 0
        assert (ref.words_to_bytes(words[s].view(np.uint32), bits[s]) ==
                serial_block(n, int(orders[s]), int(porders[s]), params[s],
                             aligned))


@pytest.mark.parametrize("n", [256, 1152, 4096, 4608])
def test_pack_rows_cpu_is_plain_and_matches_model(n):
    """pack_rows on CPU tensors runs the plain version, launches
    nothing, and agrees with the kernel's arithmetic row for row"""
    batch = model_batch(n, seed=5)
    n_words = ref.words_needed(n, MODEL_BPS, batch[3].shape[1])
    (res, orders, porders, params, choice) = (t(a) for a in batch)
    port.pack_rows.launches = 0
    got = port.pack_rows(res, orders, porders, params, choice, n_words,
                         MODEL_BPS)
    assert port.pack_rows.launches == 0
    plain = port.pack_rows_plain(res, orders, porders, params, choice,
                                 n_words, MODEL_BPS)
    want = kernel_model(*batch, n_words, MODEL_BPS)
    for (g, p, w) in zip(got, plain, want):
        assert torch.equal(g, p)
        assert np.array_equal(g.numpy(), w)


@pytest.mark.parametrize("tile_words", [4, 8, 60, 1000])
def test_kernel_model_windows(tile_words):
    """writing each row in windows of the tile's size, each starting at
    its own lead offset, gives the words of one whole tile"""
    batch = model_batch(1152, seed=2)
    n_words = ref.words_needed(1152, MODEL_BPS, batch[3].shape[1])
    assert n_words % 4 != 0
    whole = kernel_model(*batch, n_words, MODEL_BPS)
    windowed = kernel_model(*batch, n_words, MODEL_BPS, tile_words)
    for (a, b) in zip(whole, windowed):
        assert np.array_equal(a, b)


def test_kernel_model_drops_words_past_capacity():
    """with the words cut to half, the bits past them are dropped, as
    the reference drops its contributions there, and the rows that
    needed them are not ok (the reference's numpy scatter cannot drop:
    its Pallas route slices them off)"""
    batch = model_batch(4096, seed=7)
    n_words = ref.words_needed(4096, MODEL_BPS, batch[3].shape[1]) // 2
    (words, bits, row_ok) = kernel_model(*batch, n_words, MODEL_BPS)
    (want_words, want_bits, want_ok) = reference_pack(
        batch, n_words, MODEL_BPS, "pallas")
    assert np.array_equal(words.view(np.uint32), want_words)
    assert np.array_equal(bits, want_bits)
    assert not row_ok.all() and not bool(want_ok)
    assert np.array_equal(row_ok, bits <= 32 * n_words)


def chosen_batch(overflow_row=None, clip_row=None, min_row=None):
    """a chosen-subframe dict of 3 frames x 2 subframes, one row per
    choice kind; optionally one coded row whose Rice codes overflow
    the capacity (parameter 0 on large residuals), an LPC row with a
    residual at the 16-bit stereo clip bound (2^21), or a row with a
    residual of -2^31 (parameter 30), which torch.abs leaves negative:
    never clipped"""
    n = 256
    max_parts = 4
    (orders, porders, params, res) = batch_cases(seed=11, n=n, S=6,
                                                 max_parts=max_parts)
    choice = np.array([FIXED, LPC, CONSTANT, VERBATIM, LPC, FIXED],
                      dtype=np.int32)
    res = res.astype(np.int32)
    if overflow_row is not None:
        res[overflow_row, orders[overflow_row]:] = 3000
        params[overflow_row] = 0
    if clip_row is not None:
        res[clip_row, -1] = 1 << 21
    if min_row is not None:
        res[min_row, -1] = -(1 << 31)
        params[min_row] = 30
    chosen = {"residual": res.reshape(3, 2, n),
              "choice": choice.reshape(3, 2),
              "order": orders.reshape(3, 2),
              "porder": porders.reshape(3, 2),
              "rice_params": params.reshape(3, 2, max_parts)}
    return (chosen, n, max_parts)


@pytest.mark.parametrize("overflow_row,clip_row,ok", [
    (None, None, True), (0, None, False), (None, 4, False),
    (3, None, True), (None, 5, True)])
def test_pack_chosen_residuals_matches_reference(overflow_row, clip_row,
                                                 ok):
    """words, bits and ok agree with the reference's Pallas route and
    with the kernel's arithmetic; contributions past capacity are
    dropped (row 0 overflows), a clip on an LPC row (row 4) clears ok,
    and an overflow on a VERBATIM row (row 3) or the clip value on a
    FIXED row (row 5) is ignored"""
    import jax.numpy as jnp
    (chosen, n, max_parts) = chosen_batch(overflow_row, clip_row)
    n_words = ref.residual_words_capacity(n, 17, max_parts)
    want = ref.pack_chosen_residuals(
        jnp, {k: jnp.asarray(v) for (k, v) in chosen.items()}, n, 16,
        True, max_parts, n_words, backend="pallas", interpret=True)
    port.pack_rows.launches = 0
    got = port.pack_chosen_residuals(
        {k: t(v) for (k, v) in chosen.items()}, n, 16, True, max_parts,
        n_words)
    assert np.array_equal(got[0].numpy().view(np.uint32),
                          np.asarray(want[0]))
    assert np.array_equal(got[1].numpy(), np.asarray(want[1]))
    assert bool(got[2]) == bool(want[2]) == ok
    assert port.pack_rows.launches == 0     # CPU: plain version
    model = kernel_model(*(x.numpy() for x in port.chosen_rows(
        {k: t(v) for (k, v) in chosen.items()}, n, max_parts)), n_words, 17)
    assert np.array_equal(model[0], got[0].numpy())
    assert np.array_equal(model[1], got[1].numpy())
    assert bool(model[2].all()) == ok


@pytest.mark.parametrize("choice", [FIXED, LPC])
def test_int32_min_residual_is_not_clipped(choice):
    """torch.abs and jnp.abs leave -2^31 negative, so neither route
    counts it against the clip bound; the kernel's arithmetic agrees"""
    import jax.numpy as jnp
    (chosen, n, max_parts) = chosen_batch(min_row=5)
    chosen["choice"][2, 1] = choice
    n_words = ref.words_needed(n, MODEL_BPS, max_parts)
    want = ref.pack_chosen_residuals(
        jnp, {k: jnp.asarray(v) for (k, v) in chosen.items()}, n, 16,
        True, max_parts, n_words, backend="pallas", interpret=True)
    got = port.pack_chosen_residuals(
        {k: t(v) for (k, v) in chosen.items()}, n, 16, True, max_parts,
        n_words)
    assert np.array_equal(got[0].numpy().view(np.uint32),
                          np.asarray(want[0]))
    assert np.array_equal(got[1].numpy(), np.asarray(want[1]))
    assert bool(got[2]) and bool(want[2])
    model = kernel_model(*(x.numpy() for x in port.chosen_rows(
        {k: t(v) for (k, v) in chosen.items()}, n, max_parts)), n_words, 17)
    assert np.array_equal(model[0], got[0].numpy())
    assert model[2].all()


def test_scatter_drops_out_of_range_indices():
    idx = torch.tensor([[0, 1, 2, -1, 5], [4, 4, 0, 9, 1]],
                       dtype=torch.int32)
    val = port.u32_to_i32(torch.tensor([[1, 2, 4, 8, 16],
                                        [1 << 31, 1, 3, 7, 0]]))
    out = port.scatter_words_plain(idx, val, 5).numpy().view(np.uint32)
    assert out.tolist() == [[1, 2, 4, 0, 0], [3, 0, 0, 0, (1 << 31) | 1]]


def test_scatter_rejects_bad_arguments():
    idx = torch.zeros((2, 3), dtype=torch.int32)
    with pytest.raises(TypeError):
        port.scatter_words_plain(idx, idx.to(torch.int64), 4)
    with pytest.raises(ValueError):
        port.scatter_words_plain(idx, idx[:1], 4)
    with pytest.raises(ValueError):
        port.scatter_words_plain(idx.t(), idx.t(), 4)


def test_pack_rows_rejects_bad_arguments():
    (res, orders, porders, params, choice) = (
        t(a) for a in model_batch(256))
    good = (res, orders, porders, params, choice)
    with pytest.raises(TypeError):
        port.pack_rows(res.to(torch.int64), *good[1:], 100, 16)
    with pytest.raises(ValueError):
        port.pack_rows(res, orders[:1], *good[2:], 100, 16)
    with pytest.raises(ValueError):
        port.pack_rows(res, orders, porders, params[:, :0], choice, 100, 16)
    with pytest.raises(ValueError):
        port.pack_rows(res.t().contiguous().t(), *good[1:], 100, 16)
    with pytest.raises(ValueError):
        port.pack_rows(*good, -1, 16)
    with pytest.raises(ValueError):
        port.pack_rows(*good, 100, 27)
    with pytest.raises(ValueError):
        port.pack_rows(res.to("meta"), *good[1:], 100, 16)


# ---- the kernel on the card -----------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def cuda_case(name):
    """(batch, n_words, max_bps) for a card test"""
    if name == "overflow_drop":
        # a capacity short enough that the last words' bits are dropped
        (orders, porders, params, res) = batch_cases(seed=7, n=4096, S=4)
        choice = np.full(4, FIXED, np.int32)
        batch = (res.astype(np.int32), orders, porders, params, choice)
        return (batch, ref.words_needed(4096, 16, params.shape[1]) // 2, 17)
    if name in ("n1152", "n4608"):
        n = {"n1152": 1152, "n4608": 4608}[name]
        batch = model_batch(n, seed=3)
        return (batch, ref.words_needed(n, MODEL_BPS, batch[3].shape[1]),
                MODEL_BPS)
    rng = np.random.default_rng(13)
    if name == "r30":
        # 24-bit-scale and larger residuals: parameters up to 30
        n = 4096
        scales = (1 << 22, 1 << 28, 1 << 29)
        res = np.stack([rng.integers(-s, s, n) for s in scales] + [
            rng.choice([-1, 1], n) * rng.integers(3 << 28, 1 << 30, n)])
    elif name == "large_row":
        # a tile above the default 48 KB of shared memory
        n = 16384
        res = rng.integers(-(1 << 22), 1 << 22, (2, n))
    else:
        # "windowed": codes beyond what one block's tile may hold at all
        n = 65536
        res = rng.integers(-(1 << 27), 1 << 27, (2, n))
    S = res.shape[0]
    orders = np.full(S, 8, np.int32)
    porders = np.zeros(S, np.int32)
    porders[1:] = 3
    params = np.stack([row_params(res[s], 8, int(porders[s]), 8)
                       for s in range(S)]).astype(np.int32)
    if name == "r30":
        assert params.max() == 30
    choice = np.full(S, FIXED, np.int32)
    batch = (res.astype(np.int32), orders, porders, params, choice)
    if name == "windowed":
        n_words = ref.words_needed(n, 24, 8)
        assert n_words * 4 > 232448
    elif name == "r30":
        n_words = ref.words_needed(n, MODEL_BPS, 8)
    else:
        n_words = ref.residual_words_capacity(n, MODEL_BPS, 8)
    if name == "large_row":
        assert n_words * 4 > 48 * 1024
    return (batch, n_words, MODEL_BPS)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["overflow_drop", "n1152", "n4608", "r30",
                                  "large_row", "windowed"])
def test_cuda_kernel_matches_plain(cuda_device, case):
    """the hand-written kernel equals the plain version on the card and
    on the CPU, and the kernel's arithmetic, with one launch"""
    (batch, n_words, max_bps) = cuda_case(case)
    cpu = [t(a).to(torch.int32).contiguous() for a in batch]
    want = port.pack_rows_plain(*cpu, n_words, max_bps)
    on_card = [x.to(cuda_device) for x in cpu]
    before = port.pack_rows.launches
    got = port.pack_rows(*on_card, n_words, max_bps)
    assert port.pack_rows.launches == before + 1
    plain_on_card = port.pack_rows_plain(*on_card, n_words, max_bps)
    torch.cuda.synchronize()
    model = kernel_model(*batch, n_words, max_bps)
    for (g, p, w, m) in zip(got, plain_on_card, want, model):
        assert torch.equal(g, p)
        assert torch.equal(g.cpu(), w)
        assert np.array_equal(g.cpu().numpy(), m)
