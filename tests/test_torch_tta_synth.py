"""The port's TTA synthesis (``ops/tta_synth``): the plain version of
the inverse hybrid filter and fixed predictor must give exactly the
reference's numpy form (``tta_synth.inverse_filter_predict(np, ...)``)
and its Pallas kernel in interpret mode, for 8-, 16- and 24-bit
streams, including residuals large enough that the filter's int32
arithmetic wraps; ``decorrelate_inverse`` and ``synthesize`` must
equal the reference's.  A numpy uint32 model of the card kernel's
restructured step (acc = C + p * Q, the state in rings renamed by the
step) must give the reference's samples too.  On a card the kernel
must equal the plain version."""

import numpy as np
import pytest
import torch

from audiotools_tpu.ops import tta_scan as ref_scan
from audiotools_tpu.ops import tta_synth as ref
from audiotools_tpu_torch.ops import tta_synth as port

torch.set_num_threads(1)

# residual magnitudes: real 16-bit content, then values that wrap the
# filter's int32 sums and the fixed predictor
MAGNITUDES = [400, 1 << 20, 1 << 30]


def residuals(seed, L, n, lim):
    rng = np.random.default_rng(seed)
    return rng.integers(-lim, lim, (L, n)).astype(np.int32)


def wraps(res, bps):
    """whether the filter's accumulator leaves int32 on these lanes in
    their first 64 samples: the state is followed in int64 until the
    first sum that int32 cannot hold"""
    fshift = ref_scan.filter_shift_for(bps)
    qm = np.zeros((res.shape[0], 8), dtype=np.int64)
    dx = np.zeros_like(qm)
    dl = np.zeros_like(qm)
    for i in range(min(res.shape[1], 64)):
        if i:
            qm = qm + np.sign(res[:, i - 1])[:, None] * dx
            total = (1 << (fshift - 1)) + (dl * qm).sum(axis=1)
            if (np.abs(total) >= 1 << 31).any():
                return True
            p = res[:, i].astype(np.int64) + (total >> fshift)
        else:
            p = res[:, i].astype(np.int64)
        (dx, dl) = ref_scan._shift_state(np, dx, dl, p)
    return False


@pytest.mark.parametrize("bps", [8, 16, 24])
@pytest.mark.parametrize("lim", MAGNITUDES)
def test_matches_numpy_form(bps, lim):
    res = residuals(bps + lim % 97, 6, 1024, lim)
    got = port.inverse_filter_predict_plain(torch.from_numpy(res), bps)
    assert np.array_equal(got.numpy(), ref.inverse_filter_predict(np, res,
                                                                   bps))


@pytest.mark.parametrize("bps", [8, 16, 24])
def test_wrap_cases_do_wrap(bps):
    """the largest magnitude does drive the filter's sum out of int32"""
    assert wraps(residuals(bps, 4, 64, MAGNITUDES[-1]), bps)
    assert not wraps(residuals(bps, 4, 64, MAGNITUDES[0]), bps)


@pytest.mark.parametrize("bps", [8, 16, 24])
@pytest.mark.parametrize("lim", [400, 1 << 30])
def test_matches_pallas_interpret(bps, lim):
    """the reference's Pallas kernel in interpret mode, at the shape of
    its own test"""
    import jax.numpy as jnp
    res = residuals(bps, 8, 64, lim)
    want = np.asarray(ref._inverse_pallas(jnp.asarray(res), bps))
    got = port.inverse_filter_predict_plain(torch.from_numpy(res), bps)
    assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("channels", [1, 2, 3])
@pytest.mark.parametrize("bps", [8, 16, 24])
def test_decorrelate_and_synthesize(channels, bps):
    rng = np.random.default_rng(channels * bps)
    lim = 1 << (bps + 1)
    samples = rng.integers(-lim, lim, (3, 200, channels)).astype(np.int32)
    assert np.array_equal(
        port.decorrelate_inverse(torch.from_numpy(samples)).numpy(),
        ref.decorrelate_inverse(np, samples))
    res = rng.integers(-3000, 3000, (3, 200, channels)).astype(np.int32)
    assert np.array_equal(port.synthesize(torch.from_numpy(res), bps).numpy(),
                          ref.synthesize(np, res, bps))


def test_copied_shifts_match_the_reference():
    for bps in (8, 16, 24):
        assert port.shift_for(bps) == ref_scan.shift_for(bps)
        assert port.filter_shift_for(bps) == ref_scan.filter_shift_for(bps)


def test_shift_state_matches_the_reference():
    rng = np.random.default_rng(6)
    dx = rng.integers(-4, 5, (16, 8)).astype(np.int32)
    dl = rng.integers(-(1 << 31), 1 << 31, (16, 8)).astype(np.int32)
    p = rng.integers(-(1 << 31), 1 << 31, 16).astype(np.int32)
    with np.errstate(over="ignore"):
        want = ref_scan._shift_state(np, dx, dl, p)
    got = port._shift_state(*(torch.from_numpy(a.astype(np.int64))
                              for a in (dx, dl, p)))
    for (g, w) in zip(got, want):
        assert np.array_equal(g.numpy(), w)


def test_argument_checks_and_cpu_dispatch():
    res = torch.from_numpy(residuals(1, 2, 16, 100))
    with pytest.raises(ValueError, match="bits per sample"):
        port.inverse_filter_predict(res, 12)
    with pytest.raises(TypeError):
        port.inverse_filter_predict(res.to(torch.int64), 16)
    with pytest.raises(ValueError, match="unsupported device"):
        port.inverse_filter_predict(res.to("meta"), 16)
    before = port.inverse_filter_predict.launches
    assert torch.equal(port.inverse_filter_predict(res, 16),
                       port.inverse_filter_predict_plain(res, 16))
    assert port.inverse_filter_predict.launches == before


def kernel_model(res, bps):
    """numpy uint32 model of csrc/tta_synth.cu, step for step: qm, and
    the d5, d6, d7 and p of each step with the signs dx takes from
    them in rings of 8 (slot step % 8); acc = C + p[i-1] * Q with C
    and Q free of p[i-1]; d6 and d5 as one subtract from p; signs from
    sign masks; the all-zero state with the signs of step -1 set, and
    no case for step 0"""
    fshift = port.filter_shift_for(bps)
    shift = port.shift_for(bps)
    (L, n) = res.shape
    u32 = np.uint32
    ring = {name: np.zeros((8, L), dtype=u32)
            for name in ("d5", "d6", "d7", "p", "g4", "g5", "g6", "g7")}
    for (name, v) in (("g4", 1), ("g5", 2), ("g6", 2), ("g7", 4)):
        ring[name][7] = v
    qm = np.zeros((8, L), dtype=u32)
    prev_res = np.zeros(L, dtype=np.int32)
    prev_x = np.zeros(L, dtype=u32)
    round_v = u32(1 << (fshift - 1))
    out = np.empty((L, n), dtype=np.int32)

    def at(name, back):
        return ring[name][(i - back) % 8]

    def sign_mask(v):
        return (v.view(np.int32) >> 31).view(u32)

    for i in range(n):
        sgn = sign_mask(prev_res.view(u32)) | ((u32(0) - prev_res.view(u32))
                                               >> u32(31))
        dx = [at("g4", 6 - j) for j in range(5)] + [
            at("g5", 2), at("g6", 2), at("g7", 2)]
        for j in range(8):
            qm[j] += sgn * dx[j]
        a2 = qm[4] + qm[5]
        a3 = a2 + qm[6]
        qsum = a3 + qm[7]
        c_part = (round_v + at("d5", 5) * qm[0] + at("d5", 4) * qm[1]
                  + at("d5", 3) * qm[2] + at("d5", 2) * qm[3]
                  - at("p", 2) * a3 - at("d7", 2) * a2 - at("d6", 2) * qm[4])
        acc = c_part + at("p", 1) * qsum
        p = res[:, i].view(u32) + (acc.view(np.int32) >> fshift).view(u32)
        k2 = at("p", 1) + at("d7", 1)
        d7 = p - at("p", 1)
        d6 = p - k2
        d5 = p - (k2 + at("d6", 1))
        for (name, v) in (("p", p), ("d7", d7), ("d6", d6), ("d5", d5)):
            ring[name][i % 8] = v
        for (name, v, mag) in (("g4", d5, 1), ("g5", d6, 2), ("g6", d7, 2),
                               ("g7", p, 4)):
            ring[name][i % 8] = (sign_mask(v) & u32((1 << 32) - 2 * mag)) + mag
        x = p + prev_x + ((u32(0) - prev_x).view(np.int32) >> shift).view(u32)
        prev_x = x
        prev_res = res[:, i]
        out[:, i] = x.view(np.int32)
    return out


@pytest.mark.parametrize("bps", [8, 16, 24])
@pytest.mark.parametrize("lim", MAGNITUDES)
def test_kernel_model_matches_numpy_form(bps, lim):
    """including the magnitudes that wrap the filter's sums"""
    res = residuals(bps * 3 + lim % 89, 6, 1024, lim)
    assert np.array_equal(kernel_model(res, bps),
                          ref.inverse_filter_predict(np, res, bps))


# the kernel's samples a tile (csrc/row_tiles.cuh kTile)
TILE = 32


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, TILE - 1, TILE, TILE + 1, 192, 700, 4608])
@pytest.mark.parametrize("bps", [8, 16, 24])
@pytest.mark.parametrize("lim", MAGNITUDES)
def test_cuda_kernel_matches_plain(bps, lim, n):
    """45 lanes (not a multiple of the 32 a warp) at the tile edges"""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    res = torch.from_numpy(residuals(bps, 45, n, lim)).cuda()
    before = port.inverse_filter_predict.launches
    got = port.inverse_filter_predict(res, bps)
    torch.cuda.synchronize()
    assert port.inverse_filter_predict.launches == before + 1
    assert torch.equal(got, port.inverse_filter_predict_plain(res, bps))
