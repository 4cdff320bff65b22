"""The PyTorch port's frame analysis (audiotools_tpu_torch/ops/
flac_frames.py) against the reference: packed decision rows, the
compact wire layout and the chosen-subframe data for the device pack
must be equal exactly, to the reference's jax path under jit (one
small shape) and to its numpy path over the codec matrix of
tests/test_jax_matrix.py at reduced lengths.
"""

import zlib

import numpy as np
import pytest
import torch

from audiotools_tpu.ops import flac_frames as ref
from audiotools_tpu.ops import lpc as ref_lpc
from audiotools_tpu_torch.ops import flac_frames as port
from audiotools_tpu_torch.ops import lpc as port_lpc

torch.set_num_threads(1)

SR = 44100


def matrix_blocks(kind, bps, channels, B, n):
    """[B, n, channels] int32 blocks shaped like test_jax_matrix's
    make_reader signals; the first block of the tone is constant and
    the noise row carries wasted low bits"""
    rng = np.random.default_rng(zlib.crc32(f"{kind}/{bps}/{channels}".encode()))
    t = np.arange(B * n)
    amp = 1 << (bps - 3)
    if kind == "tone":
        base = amp * np.sin(2 * np.pi * 441 * t / SR)
        base[:n] = 1234
    elif kind == "noise":
        base = rng.integers(-amp, amp, B * n).astype(np.float64) * 4
    else:
        base = np.where((t // 512) % 3 == 1,
                        amp * np.sin(2 * np.pi * 997 * t / SR), 0.0)
    chs = [np.roll(base, 37 * i) for i in range(channels)]
    arr = np.stack(chs, 1).astype(np.int64).astype(np.int32)
    return arr.reshape(B, n, channels)


def compare(got, want):
    got = got.numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    assert got.shape == want.shape
    assert np.array_equal(got, want.astype(got.dtype))


def run_both(xp, blocks, bps, n, K, porder, exhaustive, jit=False):
    ch = blocks.shape[2]
    stereo = ch == 2
    porders = ref.valid_partition_orders(n, porder, max(K, 4))
    P = 1 << porders[-1]
    max_rice = 14 if bps <= 16 else 30
    window = ref_lpc.tukey_window_df(n)
    max_sub = 2 if stereo else ch

    def ref_run(blocks, window):
        (packed, chosen) = ref.analyze_frames_packed(
            xp, blocks, stereo, bps, n, K, 12, porders, max_rice,
            exhaustive, True, window, return_chosen=True)
        compact = ref.compact_decisions(xp, packed, max_sub, K, P)
        del chosen["max_subframes"]
        return (packed, compact, chosen)

    if jit:
        import jax
        (packed, compact, chosen) = jax.jit(ref_run)(blocks, window)
    else:
        (packed, compact, chosen) = ref_run(blocks, window)

    (packed_t, chosen_t) = port.analyze_frames_packed(
        torch.as_tensor(blocks), stereo, bps, n, K, 12, porders, max_rice,
        exhaustive, True, port_lpc.window_to_torch(window, "cpu"),
        return_chosen=True)
    compare(packed_t, packed)
    compare(port.compact_decisions(packed_t, max_sub, K, P), compact)
    assert chosen_t.pop("max_subframes") == max_sub
    assert sorted(chosen_t) == sorted(chosen)
    for key in chosen:
        compare(chosen_t[key], chosen[key])


def test_matches_jax_under_jit():
    import jax
    jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp
    blocks = matrix_blocks("tone", 16, 2, 4, 256)
    run_both(jnp, blocks, 16, 256, 4, 2, exhaustive=True, jit=True)


@pytest.mark.parametrize("kind", ["tone", "noise", "transient"])
@pytest.mark.parametrize("bps,channels", [(16, 2), (24, 2), (16, 1)])
@pytest.mark.parametrize("exhaustive", [True, False])
def test_matches_numpy_matrix(kind, bps, channels, exhaustive):
    blocks = matrix_blocks(kind, bps, channels, 3, 1024)
    run_both(np, blocks, bps, 1024, 8, 4, exhaustive)


def test_wasted_bits_and_constants():
    """rows whose samples share trailing zero bits, including the
    sign-bit-only pattern, and constant rows"""
    n = 256
    rng = np.random.default_rng(3)
    blocks = rng.integers(-3000, 3000, (4, n, 2)).astype(np.int32)
    blocks[0] <<= 3
    blocks[1, :, 0] = -(1 << 15)
    blocks[2] = 0
    blocks[3, :, 1] = 5
    run_both(np, blocks, 16, n, 4, 2, exhaustive=True)


def test_trailing_zeros():
    vals = np.array([0, 1, 2, 12, -4, -(1 << 31), 1 << 30, 96],
                    dtype=np.int32)
    got = port.trailing_zeros(torch.as_tensor(vals)).numpy()
    assert got.tolist() == [32, 0, 1, 2, 2, 31, 30, 5]


@pytest.mark.parametrize("kind", ["tone", "noise", "transient"])
@pytest.mark.parametrize("bps,channels", [(16, 2), (24, 2), (16, 1)])
def test_exact_rice_mode_matches_numpy(monkeypatch, kind, bps, channels):
    """ATPU_DEVICE_RICE=exact: the exact ladder (rice_planes and the
    descent) against the reference's numpy path"""
    monkeypatch.setenv("ATPU_DEVICE_RICE", "exact")
    blocks = matrix_blocks(kind, bps, channels, 3, 1024)
    run_both(np, blocks, bps, 1024, 8, 4, exhaustive=True)


def test_exact_rice_mode_matches_jax_under_jit(monkeypatch):
    monkeypatch.setenv("ATPU_DEVICE_RICE", "exact")
    import jax
    jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp
    blocks = matrix_blocks("noise", 16, 2, 4, 256)
    run_both(jnp, blocks, 16, 256, 4, 2, exhaustive=True, jit=True)


@pytest.mark.parametrize("bps,channels", [(16, 2), (24, 1)])
def test_quantized_input_with_exact_sideband(bps, channels):
    """quantized blocks with the exact or/constant sideband: wasted
    bits and CONSTANT choices come from the sideband, as in the
    reference"""
    from audiotools_tpu.ops import qpack as ref_qpack
    blocks = matrix_blocks("tone", bps, channels, 4, 512)
    blocks[1] <<= 2
    t = ref_qpack.plan_t(blocks, bps)
    quantized = ref_qpack.quantize(np, blocks, t)
    stereo = channels == 2
    (orv, cf) = ref_qpack.variant_sideband(blocks, stereo)
    porders = ref.valid_partition_orders(512, 3, 8)
    window = ref_lpc.tukey_window_df(512)
    max_rice = 14 if bps <= 16 else 30
    want = ref.analyze_frames_packed(
        np, quantized, stereo, bps, 512, 8, 12, porders, max_rice, True,
        True, window, or_vals=orv, const_flags=cf)
    got = port.analyze_frames_packed(
        torch.as_tensor(quantized), stereo, bps, 512, 8, 12, porders,
        max_rice, True, True, port_lpc.window_to_torch(window, "cpu"),
        or_vals=torch.as_tensor(orv), const_flags=torch.as_tensor(cf))
    compare(got, want)
