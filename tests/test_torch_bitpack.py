"""The PyTorch port's residual bit-pack (audiotools_tpu_torch/ops/
bitpack.py) against the reference (ops/pallas_bitpack.py).

On the CPU the port's scatter is its plain version; it is held equal
to the reference's numpy token model, to the reference's Pallas kernel
in interpret mode (the JAX package's own CPU route) and to the serial
writer ``ref/flac_enc.write_residual_block``.  The CUDA kernel itself
is compared with the plain version by the ``cuda``-marked test, which
skips where no card is present (and by chip_smoke.py on the card).
"""

import numpy as np
import pytest
import torch

from audiotools_tpu.ops import flac_frames as ref_ff
from audiotools_tpu.ops import pallas_bitpack as ref
from audiotools_tpu_torch.ops import bitpack as port
from test_pallas_bitpack import batch_cases, serial_block

torch.set_num_threads(1)


def t(a):
    return torch.as_tensor(np.asarray(a))


def port_pack(res, orders, porders, params, n_words):
    """the port's tokenize + split + plain scatter; returns (words as
    uint32 numpy, total bits, idx, val)"""
    (S, n) = res.shape
    (ends, payload, widths, total) = port.tokenize(
        t(res), t(orders), t(porders), t(params), n, params.shape[1])
    (idx, val) = port.split_contributions(ends, payload, widths)
    words = port.scatter_words(idx.to(torch.int32),
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


def chosen_batch(overflow_row=None, clip_row=None):
    """a chosen-subframe dict of 3 frames x 2 subframes, one row per
    choice kind; optionally one coded row whose Rice codes overflow
    the capacity (parameter 0 on large residuals) or an LPC row with a
    residual at the 16-bit stereo clip bound (2^21)"""
    n = 256
    max_parts = 4
    (orders, porders, params, res) = batch_cases(seed=11, n=n, S=6,
                                                 max_parts=max_parts)
    choice = np.array([ref_ff.CHOICE_FIXED, ref_ff.CHOICE_LPC,
                       ref_ff.CHOICE_CONSTANT, ref_ff.CHOICE_VERBATIM,
                       ref_ff.CHOICE_LPC, ref_ff.CHOICE_FIXED],
                      dtype=np.int32)
    res = res.astype(np.int32)
    if overflow_row is not None:
        res[overflow_row, orders[overflow_row]:] = 3000
        params[overflow_row] = 0
    if clip_row is not None:
        res[clip_row, -1] = 1 << 21
    chosen = {"residual": res.reshape(3, 2, n),
              "choice": choice.reshape(3, 2),
              "order": orders.reshape(3, 2),
              "porder": porders.reshape(3, 2),
              "rice_params": params.reshape(3, 2, max_parts)}
    return (chosen, n, max_parts)


@pytest.mark.parametrize("overflow_row,clip_row,ok", [
    (None, None, True), (0, None, False), (None, 4, False),
    (3, None, True)])
def test_pack_chosen_residuals_matches_reference(overflow_row, clip_row,
                                                 ok):
    """words, bits and ok agree with the reference's Pallas route;
    contributions past capacity are dropped (row 0 overflows), a clip
    on an LPC row (row 4) clears ok, and an overflow on a VERBATIM row
    (row 3) is ignored"""
    import jax.numpy as jnp
    (chosen, n, max_parts) = chosen_batch(overflow_row, clip_row)
    n_words = ref.residual_words_capacity(n, 17, max_parts)
    want = ref.pack_chosen_residuals(
        jnp, {k: jnp.asarray(v) for (k, v) in chosen.items()}, n, 16,
        True, max_parts, n_words, backend="pallas", interpret=True)
    port.scatter_words.launches = 0
    got = port.pack_chosen_residuals(
        {k: t(v) for (k, v) in chosen.items()}, n, 16, True, max_parts,
        n_words)
    assert np.array_equal(got[0].numpy().view(np.uint32),
                          np.asarray(want[0]))
    assert np.array_equal(got[1].numpy(), np.asarray(want[1]))
    assert bool(got[2]) == bool(want[2]) == ok
    assert port.scatter_words.launches == 0     # CPU: plain version


def test_scatter_drops_out_of_range_indices():
    idx = torch.tensor([[0, 1, 2, -1, 5], [4, 4, 0, 9, 1]],
                       dtype=torch.int32)
    val = port.u32_to_i32(torch.tensor([[1, 2, 4, 8, 16],
                                        [1 << 31, 1, 3, 7, 0]]))
    out = port.scatter_words(idx, val, 5).numpy().view(np.uint32)
    assert out.tolist() == [[1, 2, 4, 0, 0], [3, 0, 0, 0, (1 << 31) | 1]]


def test_scatter_rejects_bad_arguments():
    idx = torch.zeros((2, 3), dtype=torch.int32)
    with pytest.raises(TypeError):
        port.scatter_words(idx, idx.to(torch.int64), 4)
    with pytest.raises(ValueError):
        port.scatter_words(idx, idx[:1], 4)
    with pytest.raises(ValueError):
        port.scatter_words(idx.t(), idx.t(), 4)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.cuda
def test_cuda_kernel_matches_plain(cuda_device):
    """the hand-written kernel equals the plain version on the card
    and on the CPU, with a capacity short enough that the last words'
    contributions must be dropped"""
    (orders, porders, params, res) = batch_cases(seed=7, n=4096, S=4)
    n_words = ref.words_needed(4096, 16, params.shape[1]) // 2
    (_w, _b, idx, val) = port_pack(res, orders, porders, params, 1)
    idx = idx.to(torch.int32)
    val = port.u32_to_i32(val)
    want = port.scatter_words_plain(idx, val, n_words)
    before = port.scatter_words.launches
    got = port.scatter_words(idx.to(cuda_device), val.to(cuda_device),
                             n_words)
    assert port.scatter_words.launches == before + 1
    on_card = port.scatter_words_plain(idx.to(cuda_device),
                                       val.to(cuda_device), n_words)
    torch.cuda.synchronize()
    assert torch.equal(got, on_card)
    assert torch.equal(got.cpu(), want)
