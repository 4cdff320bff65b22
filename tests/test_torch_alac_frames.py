"""The port's ALAC analysis (``ops/alac_frames``): the packed LPC
candidates of every (block, group, leftweight, channel) must equal the
reference's numpy form (``alac_frames.analyze_framesets_packed(np,
...)``) bit for bit, for every frameset layout the tests reach and
for 16- and 24-bit streams."""

import numpy as np
import pytest
import torch

from audiotools_tpu.ops import alac_frames as ref
from audiotools_tpu.ops import lpc as ref_lpc
from audiotools_tpu.ref.alac import FRAMESET_LAYOUT as REF_LAYOUT
from audiotools_tpu_torch.ops import alac_frames as port
from audiotools_tpu_torch.ops import lpc
from audiotools_tpu_torch.ref.alac import FRAMESET_LAYOUT, WAVE_ORDER

torch.set_num_threads(1)


def blocks_for(seed, B, n, channels, bps):
    """B blocks of tones and noise, one silent block (the degenerate
    flag) and one block of full-scale noise"""
    rng = np.random.default_rng(seed)
    t = np.arange(B * n)
    amp = 1 << (bps - 3)
    x = np.stack([(amp * np.sin(2 * np.pi * (300 + 70 * c) * t / 44100))
                  .astype(np.int64) + rng.integers(-amp // 30, amp // 30,
                                                   B * n)
                  for c in range(channels)], axis=1)
    blocks = x.reshape(B, n, channels)
    blocks[1] = 0
    lim = 1 << (bps - 1)
    blocks[2] = rng.integers(-lim, lim, (n, channels))
    return blocks.astype(np.int32)


def check(blocks, bps, min_lw=0, max_lw=4, shift=2):
    (B, n, channels) = blocks.shape
    lsb = bps - 16 if bps > 16 else 0
    want = ref.analyze_framesets_packed(
        np, blocks, REF_LAYOUT[channels], bps, lsb, shift, min_lw, max_lw,
        ref_lpc.tukey_window_df(n))
    dtype = np.int16 if bps <= 16 else np.int32
    got = port.analyze_framesets_packed(
        torch.from_numpy(blocks.astype(dtype)), FRAMESET_LAYOUT[channels],
        lsb, shift, min_lw, max_lw, lpc.tukey_window(n, "cpu"))
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("channels", [1, 2, 4, 6])
@pytest.mark.parametrize("bps", [16, 24])
def test_matches_reference(channels, bps):
    check(blocks_for(channels + bps, 4, 4096, channels, bps), bps)


@pytest.mark.parametrize("n", [9, 10, 16, 1152])
def test_short_blocks(n):
    """blocks too short for an order-8 estimate (count <= 0) and a
    small block size"""
    check(blocks_for(n, 3, n, 2, 16), 16)


def test_leftweight_range():
    check(blocks_for(5, 3, 2048, 2, 16), 16, min_lw=1, max_lw=3, shift=3)


def test_copied_tables_match_the_reference():
    from audiotools_tpu.ref import alac as ref_alac
    assert FRAMESET_LAYOUT == ref_alac.FRAMESET_LAYOUT
    assert WAVE_ORDER == ref_alac.WAVE_ORDER
    for name in ("QLP_SHIFT_NEEDED", "N_LEFTWEIGHTS", "PACKED_COLS"):
        assert getattr(port, name) == getattr(ref, name)


def test_quantize_and_estimate_match_the_reference():
    rng = np.random.default_rng(2)
    coeffs = rng.normal(0, 40, (64, 8)).astype(np.float32).astype(
        np.float64)
    assert np.array_equal(port.alac_quantize(torch.from_numpy(coeffs))
                          .numpy(), ref.alac_quantize(np, coeffs))
    X = rng.integers(-(1 << 16), 1 << 16, (8, 300)).astype(np.int32)
    qlp = rng.integers(-(1 << 15), 1 << 15, (8, 8)).astype(np.int32)
    for order in (4, 8):
        assert np.array_equal(
            port.residual_estimate(torch.from_numpy(X),
                                   torch.from_numpy(qlp[:, :order]),
                                   order).numpy(),
            ref.residual_estimate(np, X, qlp[:, :order], order))
