"""The port's TTA synthesis (``ops/tta_synth``): the plain version of
the inverse hybrid filter and fixed predictor must give exactly the
reference's numpy form (``tta_synth.inverse_filter_predict(np, ...)``)
and its Pallas kernel in interpret mode, for 8-, 16- and 24-bit
streams, including residuals large enough that the filter's int32
arithmetic wraps; ``decorrelate_inverse`` and ``synthesize`` must
equal the reference's.  On a card the kernel must equal the plain
version."""

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


@pytest.mark.cuda
@pytest.mark.parametrize("bps", [8, 16, 24])
@pytest.mark.parametrize("lim", MAGNITUDES)
def test_cuda_kernel_matches_plain(bps, lim):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    res = torch.from_numpy(residuals(bps, 64, 700, lim)).cuda()
    before = port.inverse_filter_predict.launches
    got = port.inverse_filter_predict(res, bps)
    torch.cuda.synchronize()
    assert port.inverse_filter_predict.launches == before + 1
    assert torch.equal(got, port.inverse_filter_predict_plain(res, bps))
