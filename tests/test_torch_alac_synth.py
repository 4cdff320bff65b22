"""The port's ALAC synthesis (``ops/alac_synth``): the plain version
must give exactly the reference's numpy form
(``alac_synth.synthesize(np, ...)``), the scalar oracle's
``decode_subframe``, and the reference's Pallas kernel in interpret
mode where its guard admits the rows; it must also hold on 24-bit
rows and on coefficients that drift out of what the reference's guard
checked.  ``decorrelate`` and ``merge_lsbs`` must
equal the reference's.  A numpy model of the card kernel's arithmetic
(row groups by order, static-order instances with a register ring, the
narrow and wide sums, the branch-free walk) must give the plain
version's samples.  On a card the kernel must equal the plain
version."""

import numpy as np
import pytest
import torch

from audiotools_tpu.ops import alac_synth as ref
from audiotools_tpu.ref.alac import ALACDecoder
from audiotools_tpu_torch.ops import alac_synth as port

torch.set_num_threads(1)


def t(a):
    return torch.as_tensor(np.asarray(a, dtype=np.int32))


def rows(seed, S, n, orders, shifts, sample_sizes, qmax=2000, rmax=500):
    rng = np.random.default_rng(seed)
    residuals = rng.integers(-rmax, rmax, (S, n)).astype(np.int32)
    qlp = np.zeros((S, ref.K), dtype=np.int32)
    for (s, o) in enumerate(orders):
        if o < 31:
            qlp[s, :o] = rng.integers(-qmax, qmax, o)
    return (residuals, qlp, np.asarray(orders, dtype=np.int32),
            np.asarray(shifts, dtype=np.int32),
            np.asarray(sample_sizes, dtype=np.int32))


def plain(residuals, qlp, order, shift, sample_size, kw=None, max_order=8):
    if kw is not None:
        qlp = qlp[:, :kw]
    return port.synthesize_plain(t(residuals), t(qlp), t(order), t(shift),
                                 t(sample_size), max_order).numpy()


def numpy_form(residuals, qlp, order, shift, sample_size, max_order=8):
    return ref.synthesize(np, residuals, qlp, order, shift, sample_size,
                          residuals.shape[1], max_order=max_order)


def test_matches_oracle_subframe():
    """the adversarial rows of the reference's own oracle test: zero
    runs, positive-heavy residuals, shifts 7..12"""
    rng = np.random.default_rng(17)
    (S, n) = (6, 256)
    orders = [1, 2, 4, 8, 4, 8]
    shift = np.array([9, 9, 7, 9, 12, 9], dtype=np.int32)
    sample_size = np.full(S, 17, dtype=np.int32)
    residuals = rng.integers(-1500, 1500, (S, n)).astype(np.int32)
    residuals[2, :16] = 0
    residuals[3] = np.abs(residuals[3])
    qlp = np.zeros((S, ref.K), dtype=np.int32)
    for (s, o) in enumerate(orders):
        qlp[s, :o] = rng.integers(-2000, 2000, o)
    order = np.asarray(orders, dtype=np.int32)
    want = np.stack([ALACDecoder.decode_subframe(
        None, int(shift[s]), [int(v) for v in qlp[s, :orders[s]]],
        int(sample_size[s]), [int(v) for v in residuals[s]])
        for s in range(S)]).astype(np.int32)
    assert np.array_equal(numpy_form(residuals, qlp, order, shift,
                                     sample_size), want)
    assert np.array_equal(plain(residuals, qlp, order, shift, sample_size),
                          want)
    assert np.array_equal(plain(residuals, qlp, order, shift, sample_size,
                                kw=8), want)


def test_difference_chain_and_order_zero():
    """order >= 31 rows (the pure difference chain), order 0 and shift
    0 rows"""
    args = rows(3, 6, 128, [31, 31, 0, 0, 3, 5], [9, 9, 9, 0, 0, 9],
                [17, 16, 16, 17, 16, 24])
    assert np.array_equal(plain(*args), numpy_form(*args))
    want = ALACDecoder.decode_subframe(
        None, 9, [0] * 31, 17, [int(v) for v in args[0][0]])
    assert np.array_equal(plain(*args)[0], want)


@pytest.mark.parametrize("seed,S,n,order_hi", [
    (1, 8, 64, 4),
    (2, 16, 128, 8),
])
def test_matches_pallas_interpret(seed, S, n, order_hi):
    """the reference's Pallas kernel in interpret mode, at the shapes of
    its own test, on rows its guard admits"""
    import jax.numpy as jnp
    rng = np.random.default_rng(seed)
    residuals = rng.integers(-500, 500, (S, n)).astype(np.int32)
    order = rng.integers(1, order_hi + 1, S).astype(np.int32)
    qlp = np.zeros((S, ref.K), dtype=np.int32)
    for s in range(S):
        qlp[s, :order[s]] = rng.integers(-2000, 2000, order[s])
    shift = rng.integers(6, 13, S).astype(np.int32)
    sample_size = np.full(S, 16, dtype=np.int32)
    assert ref.pallas_synthesis_safe(qlp, shift, sample_size, order)
    want = np.asarray(ref._synthesize_pallas(
        jnp.asarray(residuals), jnp.asarray(qlp), jnp.asarray(order),
        jnp.asarray(shift), jnp.asarray(sample_size), n, 8))
    assert np.array_equal(plain(residuals, qlp, order, shift, sample_size),
                          want)


@pytest.mark.parametrize("sample_size", [17, 25])
def test_24bit_rows(sample_size):
    """24-bit content: sample size 17 (the coded part of a stereo pair
    with one low byte bypassed) and 25 (a pair coded whole), with wide
    coefficients and residuals"""
    rng = np.random.default_rng(sample_size)
    S = 12
    args = rows(sample_size, S, 300, rng.integers(1, 9, S),
                rng.integers(9, 16, S), np.full(S, sample_size),
                qmax=30000, rmax=1 << (sample_size - 4))
    assert np.array_equal(plain(*args), numpy_form(*args))


def test_guard_drift_rows():
    """the reference's guard-drift fault: sample sizes 25..30, shifts
    above 11, small initial coefficients that the reference's int32
    guard (pallas_synthesis_safe) admits, and one-signed unit residuals
    that keep the adaptation walk running at every sample, so that the
    coefficients drift by most of n, out of what the guard checked"""
    rng = np.random.default_rng(41)
    (S, n) = (16, 1024)
    args = rows(41, S, n, rng.integers(1, 9, S), rng.integers(12, 16, S),
                rng.integers(25, 31, S), qmax=4)
    residuals = args[0]
    residuals[:] = np.where(np.arange(S) % 2, -1, 1)[:, None]
    (qlp, order, shift, sample_size) = args[1:]
    assert ref.pallas_synthesis_safe(qlp, shift, sample_size, order)
    drifted = drifted_qlp(*args)
    assert np.abs(drifted - qlp).max() > n // 2
    assert not ref.pallas_synthesis_safe(drifted, shift, sample_size, order)
    assert np.array_equal(plain(*args), numpy_form(*args))


def drifted_qlp(residuals, qlp, order, shift, sample_size):
    """the coefficients after the scalar oracle's walk over each row"""
    out = np.array(qlp, copy=True)
    for s in range(residuals.shape[0]):
        coeffs = [int(v) for v in qlp[s, :order[s]]]
        ALACDecoder.decode_subframe(None, int(shift[s]), coeffs,
                                    int(sample_size[s]),
                                    [int(v) for v in residuals[s]])
        out[s, :order[s]] = coeffs
    return out


def test_orders_above_8_and_a_short_walk():
    """orders 9..30 with the reference's 8-step walk, and a 3-step
    walk"""
    rng = np.random.default_rng(8)
    S = 10
    args = rows(8, S, 200, rng.integers(9, 31, S), np.full(S, 9),
                np.full(S, 17))
    assert np.array_equal(plain(*args), numpy_form(*args))
    args = rows(9, S, 200, rng.integers(1, 9, S), np.full(S, 9),
                np.full(S, 17))
    assert np.array_equal(plain(*args, max_order=3),
                          numpy_form(*args, max_order=3))


def test_argument_checks():
    args = [t(a) for a in rows(1, 4, 16, [4, 4, 4, 4], [9] * 4, [16] * 4)]
    with pytest.raises(ValueError, match="columns"):
        port.synthesize_plain(args[0], args[1][:, :2], *args[2:])
    with pytest.raises(ValueError, match="shift"):
        port.synthesize(args[0], args[1], args[2], t([9, 9, 40, 9]),
                        args[4])
    with pytest.raises(TypeError):
        port.synthesize(args[0].to(torch.int64), *args[1:])
    with pytest.raises(ValueError, match="unsupported device"):
        port.synthesize(*[a.to("meta") for a in args])


# the kernel's samples a tile (csrc/row_tiles.cuh kTile)
TILE = 32
M32 = 1 << 32
INT_MIN = -(1 << 31)


def wrap32(x):
    return ((x + (1 << 31)) % M32) - (1 << 31)


def ring_len(order):
    return next(r for r in (1, 2, 4, 8, 16) if r >= order + 1)


def kernel_model(residuals, qlp, order, shift, sample_size, max_order,
                 rows):
    """numpy int64 model of csrc/alac_synth.cu, step for step: warps of
    WARP_ROWS entries of ``rows``; a warp of one order 0-8 (walking at
    least that many steps) runs the static instance (static_order_model);
    a warp of orders >= 31 runs the difference chain; any other warp the
    generic loop, which is the plain recurrence one sample at a time"""
    (S, n) = residuals.shape
    kw = qlp.shape[1]
    width = -(-n // TILE) * TILE
    res_all = np.zeros((S, width), dtype=np.int64)
    res_all[:, :n] = residuals
    out = np.zeros((S, n), dtype=np.int32)
    plain_out = None
    for g in range(0, len(rows), port.WARP_ROWS):
        sel = rows[g:g + port.WARP_ROWS]
        sel = sel[(sel >= 0) & (sel < S)]
        if not len(sel):
            continue
        o = order[sel].astype(np.int64)
        sh = np.clip(shift[sel], 0, 31).astype(np.int64)
        ss = np.clip(sample_size[sel], 1, 30).astype(np.int64)
        nmask = (1 << ss) - 1
        sbit = 1 << (ss - 1)
        half = np.where(sh > 0, 1 << np.clip(sh - 1, 0, 30), 0)

        def trunc(v):
            return ((v & nmask) ^ sbit) - sbit

        res = res_all[sel]
        vals = np.zeros((len(sel), width), dtype=np.int64)
        if o.min() >= 31:
            prev = np.zeros(len(sel), dtype=np.int64)
            for i in range(width):
                prev = res[:, i] if i == 0 else trunc(prev + res[:, i])
                vals[:, i] = prev
        elif o.min() == o.max() <= 8 and max_order >= o.max():
            vals = static_order_model(res, qlp[sel], int(o[0]), sh, half,
                                      trunc, not ((sh + ss) <= 32).all())
        else:
            if plain_out is None:
                plain_out = plain(residuals, qlp, order, shift, sample_size,
                                  max_order=max_order)
            vals[:, :n] = plain_out[sel]
        out[sel] = vals[:, :n].astype(np.int32)
    return out


def static_order_model(res, qlp, order, sh, half, trunc, wide):
    """the static instance of ``order`` on a warp's rows (res: int64
    [rows, width]): the last samples in a ring of R slots (slot i % R),
    each row's two threads h with their walk steps (thread 1 t = 0 ..
    A-1, A = order // 2, thread 0 the rest, j = 0 last) and the
    coefficients of those (q[h][u]; coefficient 0 in q0, held by both);
    the sum of each thread's share exchanged, modulo 2^32 when narrow
    (q0 * out[i-1] entering last, after -q0 * base) and exact in int64
    when wide; the walk as running sums of deltas (val * sgn as |val| *
    s0) with a sticky live mask, thread 0's residual starting after
    thread 1's deltas and its steps live only if all of thread 1's were;
    q moving by s0 where val has a sign"""
    (S, width) = res.shape
    kw = qlp.shape[1]
    R = ring_len(order)
    L = order - order // 2
    A = order // 2
    odd = order % 2 == 1
    q = np.zeros((2, S, max(L, 1)), dtype=np.int64)
    for u in range(L):
        for (h, j) in ((0, L - 1 - u if u < L - 1 else -1),
                       (1, order - 1 - u if u < A else -1)):
            if 0 <= j < kw:
                q[h][:, u] = qlp[:, j]
    q0 = qlp[:, 0].astype(np.int64) if order else np.zeros(S, np.int64)
    hist = np.zeros((R, S), dtype=np.int64)
    vals = np.zeros((S, width), dtype=np.int64)
    s0 = np.sign(res)
    for i in range(width):
        r = res[:, i]
        if i == 0:
            v = r
        elif i <= order:
            v = trunc(hist[(i - 1) % R] + r)
        else:
            w = [hist[(i - 1 - j) % R] for j in range(order + 1)]
            (base, w0) = (w[order], w[0])
            wv = [[w[L - 1 - u] for u in range(L)],
                  [w[order - 1 - u] for u in range(L)]]
            part = []
            for h in (0, 1):
                acc = np.zeros(S, dtype=np.int64)
                for u in range(L - 1 if odd else L):
                    wd = base if (u == L - 1 and h == 0) else wv[h][u]
                    acc = acc + q[h][:, u] * wrap32(wd - base)
                part.append(acc)
            if wide:
                acc = half + part[0] + part[1] + q0 * wrap32(w0 - base)
                x = (acc >> sh) % M32
            else:
                acc = (half + part[0] % M32 + part[1] % M32) % M32
                acc = (acc - q0 * base) % M32
                acc = (acc + q0 * w0) % M32
                x = acc >> sh
            v = trunc(x + r + base)
            if order:
                s = s0[:, i]
                val = [[wrap32(base - wv[h][u]) for u in range(L)]
                       for h in (0, 1)]
                spent = [[np.zeros(S, dtype=np.int64)] for _ in (0, 1)]
                for h in (0, 1):
                    for u in range(L):
                        d = 0 if (odd and u == L - 1) else wrap32(
                            (wrap32(wrap32(np.abs(val[h][u])) * s) >> sh)
                            * ((0 if h else A) + u + 1))
                        spent[h].append(wrap32(spent[h][u] + d))
                before = [spent[1][L], np.zeros(S, dtype=np.int64)]
                live = [[], []]
                for h in (0, 1):
                    all_ = np.ones(S, dtype=bool)
                    for u in range(L):
                        c = wrap32(wrap32(r - before[h] - spent[h][u]) * s) > 0
                        if odd and u == L - 1 and h == 1:
                            c = np.ones(S, dtype=bool)
                        all_ = all_ & c
                        live[h].append(all_)
                live_in = [live[1][L - 1], np.ones(S, dtype=bool)]
                live0 = live_in[0] & live[0][L - 1]
                for h in (0, 1):
                    for u in range(L):
                        keep = u < L - 1 or (not odd and h == 1)
                        act = keep & live_in[h] & live[h][u]
                        q[h][:, u] = np.where(act & (val[h][u] > 0),
                                              wrap32(q[h][:, u] - s),
                                              q[h][:, u])
                        q[h][:, u] = np.where(act & (val[h][u] < 0),
                                              wrap32(q[h][:, u] + s),
                                              q[h][:, u])
                val0 = wrap32(base - w0)
                q0 = np.where(live0 & (val0 > 0), wrap32(q0 - s), q0)
                q0 = np.where(live0 & (val0 < 0), wrap32(q0 + s), q0)
        hist[i % R] = v
        vals[:, i] = v
    return vals


def edge_rows(seed, S, n, orders, shifts, sample_sizes, qmax=2000,
              rmax=500):
    """rows() with residuals at INT_MIN, -1 and +1 on a few positions
    of every row, among them each row's first"""
    args = rows(seed, S, n, orders, shifts, sample_sizes, qmax, rmax)
    rng = np.random.default_rng(seed + 1000)
    residuals = args[0]
    for (s, v) in zip(range(S), [INT_MIN, -1, 1] * S):
        residuals[s, rng.integers(0, n, 3)] = [INT_MIN, -1, 1]
        residuals[s, 0] = v
    return args


EDGE_NS = [1, TILE - 1, TILE, TILE + 1, 100]
EVERY_ORDER = list(range(9)) + [31, 40, 13]


@pytest.mark.parametrize("n", EDGE_NS)
@pytest.mark.parametrize("kind", ["16bit", "wide", "mixed_warps"])
def test_kernel_model_orders(kind, n):
    """orders 0-8, the difference chain and one of 9-30, three rows
    each: grouped by order (warps part full), 16-bit rows with every
    shift up to 16 (narrow sums), shifts to 31 and sample sizes 16, 24
    and 30 (wide sums), and the rows in their own order (orders mixed
    within 32 rows: the generic loop)"""
    orders = np.repeat(EVERY_ORDER, 3)
    S = len(orders)
    rng = np.random.default_rng(n)
    if kind == "16bit":
        (shifts, sizes) = (rng.integers(0, 17, S), np.full(S, 16))
    else:
        (shifts, sizes) = (np.arange(S) % 32, np.resize([16, 24, 30], S))
    args = edge_rows(n + 3, S, n, orders, shifts, sizes, qmax=30000)
    if kind == "16bit":
        assert ((args[3] + args[4]) <= 32).all()
    grouping = (np.resize(np.append(np.arange(S), [-1] * 32), 32 * (
        -(-S // 32))).astype(np.int32) if kind == "mixed_warps"
                else port.group_rows(args[2]))
    want = plain(*args)
    assert np.array_equal(want, numpy_form(*args))
    assert np.array_equal(kernel_model(*args, 8, grouping), want)


@pytest.mark.parametrize("case", ["decoder", "drift", "short_walk"])
def test_kernel_model_long_rows(case):
    """4096-sample rows at the decoder's orders 4 and 8 (40 rows: two
    warps of one, one of the other, one part full), the guard-drift
    rows (one-signed unit residuals walking every step, 30-bit sizes,
    the coefficients drifting by most of n), and a 3-step walk"""
    rng = np.random.default_rng(6)
    if case == "decoder":
        (S, n) = (40, 4096)
        args = edge_rows(6, S, n, np.where(np.arange(S) < 25, 8, 4),
                         rng.integers(9, 13, S), np.full(S, 16))
    else:
        (S, n) = (16, 1024)
        args = rows(41, S, n, rng.integers(1, 9, S), rng.integers(12, 16, S),
                    rng.integers(25, 31, S), qmax=4)
        args[0][:] = np.where(np.arange(S) % 2, -1, 1)[:, None]
    max_order = 3 if case == "short_walk" else 8
    want = plain(*args, max_order=max_order)
    got = kernel_model(*args, max_order, port.group_rows(args[2]))
    assert np.array_equal(got, want)
    if case == "drift":
        assert np.abs(drifted_qlp(*args) - args[1]).max() > n // 2


def test_group_rows():
    """every row once, each group of WARP_ROWS one order (orders >= 31 as
    one), -1 padding; the orders ascending"""
    order = np.array([8, 4, 8, 31, 40, 0] + [4] * 40, dtype=np.int32)
    got = port.group_rows(order)
    assert got.dtype == np.int32 and len(got) % port.WARP_ROWS == 0
    assert sorted(got[got >= 0].tolist()) == list(range(len(order)))
    keys = []
    for g in range(0, len(got), port.WARP_ROWS):
        sel = got[g:g + port.WARP_ROWS]
        sel = sel[sel >= 0]
        assert len(set(np.minimum(order[sel], 31).tolist())) == 1
        keys.append(min(int(order[sel[0]]), 31))
    assert keys == [0, 4, 4, 4, 8, 31]
    assert len(port.group_rows(np.zeros(0, dtype=np.int32))) == 0


def test_rows_argument_checks():
    """a bad grouping raises on every device; on the CPU a valid one
    changes nothing"""
    args = [t(a) for a in rows(1, 4, 32, [1, 2, 8, 31], [9] * 4, [16] * 4)]
    good = t(port.group_rows(args[2].numpy()))
    assert torch.equal(port.synthesize(*args, rows=good),
                       port.synthesize_plain(*args))
    bad = [good.to(torch.int64), good[:31], good[None, :],
           torch.full((32,), -1, dtype=torch.int32),
           t(np.r_[[0, 0, 1, 2, 3], [-1] * 27]),
           t(np.r_[[0, 1, 2, 3, 4], [-1] * 27]),
           t(np.r_[[0, 1, 2, 3, -2], [-1] * 27])]
    for rows_arg in bad:
        with pytest.raises(ValueError, match="rows"):
            port.synthesize(*args, rows=rows_arg)


def test_decode_path_reads_nothing_back(monkeypatch):
    """the decoder hands synthesize its row grouping, built on the host;
    given it, the card's branch reads no tensor back (every way a tensor
    reaches the host raises here)"""
    from audiotools_tpu_torch import kernels
    from audiotools_tpu_torch.codecs import alac_dec
    scan_rows = rows(2, 6, 64, [8, 4, 8, 0, 31, 4], [9] * 6, [16] * 6)
    (residuals, qlp, order, shift, sample_size) = scan_rows
    arrays = {"residuals": residuals, "qlp": qlp[:, :8],
              "sub": np.stack([order, shift, sample_size, np.zeros(6)]),
              "rows": port.group_rows(order)}
    tensors = {k: t(v) for (k, v) in arrays.items()}
    seen = []
    monkeypatch.setattr(port, "synthesize",
                        lambda *a, **k: seen.append((a, k)) or a[0])
    alac_dec.synthesize_batch(tensors)
    ((a, k),) = seen
    assert (a[6] if len(a) > 6 else k["rows"]) is tensors["rows"]
    monkeypatch.undo()

    launched = []
    monkeypatch.setattr(kernels, "alac_synth",
                        lambda *a: launched.append(a))

    def no_read(*_a, **_k):
        raise AssertionError("read a tensor back to the host")

    for name in ("item", "tolist", "numpy", "cpu", "__int__", "__bool__",
                 "__index__", "__float__"):
        monkeypatch.setattr(torch.Tensor, name, no_read)
    sub = tensors["sub"]
    port._launch(tensors["residuals"], tensors["qlp"], sub[0], sub[1],
                 sub[2], 8, tensors["rows"])
    assert len(launched) == 1
    assert torch.equal(launched[0][5], tensors["rows"])


def test_cpu_dispatch_runs_the_plain_version():
    args = [t(a) for a in rows(4, 4, 64, [1, 4, 8, 31], [9] * 4, [16] * 4)]
    before = port.synthesize.launches
    assert torch.equal(port.synthesize(*args), port.synthesize_plain(*args))
    assert port.synthesize.launches == before


@pytest.mark.parametrize("lw,ishift,lsb_bytes", [
    (0, 2, 0), (3, 2, 0), (4, 1, 1), (2, 3, 2)])
def test_decorrelate_and_merge_lsbs(lw, ishift, lsb_bytes):
    rng = np.random.default_rng(lw + ishift)
    G = 5
    ch0 = rng.integers(-(1 << 17), 1 << 17, (G, 64)).astype(np.int32)
    ch1 = rng.integers(-(1 << 17), 1 << 17, (G, 64)).astype(np.int32)
    lweight = np.full(G, lw, dtype=np.int32)
    lweight[0] = 0
    shift = np.full(G, ishift, dtype=np.int32)
    want = ref.decorrelate(np, ch0, ch1, lweight, shift)
    got = port.decorrelate(t(ch0), t(ch1), t(lweight), t(shift))
    for (g, w) in zip(got, want):
        assert np.array_equal(g.numpy(), w)
    bits = np.full(G, 8 * lsb_bytes, dtype=np.int32)
    lsbs = rng.integers(0, 1 << (8 * lsb_bytes), (G, 64)).astype(np.int32)
    assert np.array_equal(
        port.merge_lsbs(got[0], t(lsbs), t(bits)).numpy(),
        ref.merge_lsbs(np, want[0], lsbs, bits))


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["16bit", "24bit", "drift", "wide",
                                  "chain"])
def test_cuda_kernel_matches_plain(case):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    rng = np.random.default_rng(5)
    S = 64
    if case == "16bit":
        args = rows(1, S, 512, rng.integers(0, 9, S), rng.integers(1, 16, S),
                    np.full(S, 16))
    elif case == "24bit":
        args = rows(2, S, 512, rng.integers(1, 9, S),
                    rng.integers(9, 16, S), rng.choice([17, 25], S),
                    qmax=30000, rmax=1 << 20)
    elif case == "drift":
        args = rows(3, S, 1024, rng.integers(1, 9, S),
                    rng.integers(12, 16, S), rng.integers(25, 31, S), qmax=4)
        args[0][:] = np.where(np.arange(S) % 2, -1, 1)[:, None]
    elif case == "wide":
        args = rows(4, S, 256, rng.integers(9, 31, S), np.full(S, 9),
                    np.full(S, 17))
    else:
        args = rows(5, S, 256, [31] * (S // 2) + [2] * (S // 2),
                    np.full(S, 9), np.full(S, 17))
    tensors = [t(a).cuda() for a in args]
    before = port.synthesize.launches
    got = port.synthesize(*tensors)
    torch.cuda.synchronize()
    assert port.synthesize.launches == before + 1
    assert torch.equal(got, port.synthesize_plain(*tensors))
    assert np.array_equal(got.cpu().numpy(), numpy_form(*args))


@pytest.mark.cuda
@pytest.mark.parametrize("n", EDGE_NS + [4096])
@pytest.mark.parametrize("kind", ["16bit", "wide", "mixed_warps"])
def test_cuda_kernel_edges(kind, n):
    """the kernel model's rows on the card: 36 rows (not a multiple of
    16 or 32) of every static order, the chain and one generic order,
    at the tile edges (n not a multiple of 4 takes 4-byte copies),
    grouped by order or mixed within 32 rows, narrow and wide sums"""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    orders = np.repeat(EVERY_ORDER, 3)
    S = len(orders)
    rng = np.random.default_rng(n)
    if kind == "16bit":
        (shifts, sizes) = (rng.integers(0, 17, S), np.full(S, 16))
    else:
        (shifts, sizes) = (np.arange(S) % 32, np.resize([16, 24, 30], S))
    args = edge_rows(n + 3, S, n, orders, shifts, sizes, qmax=30000)
    grouping = (np.resize(np.append(np.arange(S), [-1] * 32), 64)
                if kind == "mixed_warps" else port.group_rows(args[2]))
    tensors = [t(a).cuda() for a in args]
    before = port.synthesize.launches
    got = port.synthesize(*tensors, rows=t(grouping).cuda())
    torch.cuda.synchronize()
    assert port.synthesize.launches == before + 1
    assert torch.equal(got, port.synthesize_plain(*tensors))
