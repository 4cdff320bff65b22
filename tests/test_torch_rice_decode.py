"""The port's Rice partition decode (``ops/rice_decode``): its plain
torch version must give exactly the reference's numpy forms, the
lock-step scan (``decode_partitions_scan``) and pointer doubling
(``decode_partitions``), on random buckets, every Rice parameter and
raw width, long unary quotients and padded rows.  On a card the
kernel must equal the plain version."""

import numpy as np
import pytest
import torch

from audiotools_tpu.ops import rice_decode as ref
from audiotools_tpu_torch.ops import rice_decode as port
from test_flac_dec_jax import _bits_to_words, _encode_raw, _encode_rice
from test_pallas_rice import _random_bucket

torch.set_num_threads(1)


def as_records(words, word_base, base_bits, k, raw, count, device="cpu"):
    """numpy bucket arrays -> the port's int32 tensors"""
    words = np.ascontiguousarray(words, dtype=np.uint32).view(np.int32)
    return [torch.as_tensor(np.asarray(a, dtype=np.int32), device=device)
            for a in (words, word_base, base_bits, k, raw, count)]


def check(words, word_base, base_bits, k, raw, count, W, C,
          pointer_doubling=True):
    """the port's plain version against the reference's numpy forms;
    returns the decoded [P, C] array"""
    args = [np.asarray(a, dtype=np.int32)
            for a in (word_base, base_bits, k, raw, count)]
    words = np.asarray(words, dtype=np.uint32)
    want = ref.decode_partitions_scan(np, words, *args, W, C)
    if pointer_doubling:
        assert np.array_equal(
            ref.decode_partitions(np, words, *args, W, C), want)
    got = port.decode_partitions_plain(
        *as_records(words, *args), W, C).numpy()
    assert got.dtype == np.int32 and got.shape == want.shape
    assert np.array_equal(got, want)
    return got


def single(bits, metas, W, C):
    """records (bit_off, k, raw, count) over one shared bit list"""
    words = _bits_to_words(bits)
    return check(words, [m[0] >> 5 for m in metas],
                 [m[0] & 31 for m in metas], [m[1] for m in metas],
                 [m[2] for m in metas], [m[3] for m in metas], W, C)


@pytest.mark.parametrize("seed,P,W,C", [
    (1, 8, 4, 8),
    (2, 16, 8, 16),
    (3, 32, 16, 32),
    (4, 2, 2048, 4096),     # the catch-all bucket
])
def test_random_bucket(seed, P, W, C):
    check(*_random_bucket(seed, P, W, C), W, C)


@pytest.mark.parametrize("k", range(15))
def test_rice_parameter(k):
    rng = np.random.default_rng(100 + k)
    values = rng.integers(-(1 << (k + 2)), 1 << (k + 2), 64).tolist()
    bits = [1, 0, 1] + _encode_rice(values, k)     # odd start offset
    got = single(bits, [(3, k, -1, 64)], 2048, 64)
    assert got[0].tolist() == values


@pytest.mark.parametrize("width", range(1, 33))
def test_raw_width(width):
    rng = np.random.default_rng(200 + width)
    values = rng.integers(-(1 << (width - 1)), 1 << (width - 1),
                          40).tolist()
    bits = [0] * 7 + _encode_raw(values, width)
    got = single(bits, [(7, -1, width, 40)], 64, 64)
    assert got[0, :40].tolist() == values


def test_long_unary_quotient_crosses_words():
    """quotients of hundreds of zero bits, ending in a later word and
    on a word boundary"""
    values = [1000, -3, 7, 15 * 32, -(31 * 16)]
    bits = _encode_rice(values, 0)
    got = single(bits, [(0, 0, -1, len(values))], 2048, 64)
    assert got[0, :len(values)].tolist() == values
    # the same codes through a window too small to hold them: the
    # quotient runs off the window and clamps as the reference's does
    single(bits, [(0, 0, -1, len(values))], 8, 64)


def test_padded_rows_and_buffer_end():
    """count-0 padding rows (word_base 0), a record at the buffer's
    last word and a record past it read nothing out of bounds and
    decode as the reference's clamped forms do"""
    rng = np.random.default_rng(5)
    values = rng.integers(-50, 50, 30).tolist()
    bits = _encode_rice(values, 3)
    words = _bits_to_words(bits)
    last = len(words) - 1
    got = check(words, [0, 0, last, last + 3, 0],
                [0, 0, 17, 0, 0], [3, -1, 2, 5, 3], [-1, 0, -1, -1, -1],
                [30, 0, 10, 4, 0], 16, 32)
    assert got[0, :30].tolist() == values
    assert not got[1].any() and not got[4].any()


def test_empty_bucket():
    out = port.decode_partitions_plain(
        *as_records(np.zeros(4), [], [], [], [], []), 8, 64)
    assert out.shape == (0, 64)


def test_bytes_to_words():
    data = bytes(range(1, 11))
    words = port.bytes_to_words(data)
    assert words.dtype == torch.int32
    assert np.array_equal(words.numpy().view(np.uint32),
                          ref.bytes_to_words(data))


def test_dispatch():
    """a CPU tensor runs the plain version; other devices raise"""
    args = _random_bucket(2, 16, 8, 16)
    records = as_records(*args)
    before = port.decode_partitions.launches
    assert torch.equal(port.decode_partitions(*records, 8, 16),
                       port.decode_partitions_plain(*records, 8, 16))
    assert port.decode_partitions.launches == before
    with pytest.raises(ValueError, match="device"):
        port.decode_partitions(*[r.to("meta") for r in records], 8, 16)
    with pytest.raises(TypeError):
        port.decode_partitions(records[0].to(torch.int64), *records[1:],
                               8, 16)


@pytest.mark.cuda
@pytest.mark.parametrize("seed,P,W,C", [
    (1, 8, 4, 8), (3, 32, 16, 32), (4, 2, 2048, 4096), (6, 5000, 64, 64)])
def test_cuda_kernel_matches_plain(seed, P, W, C):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    records = as_records(*_random_bucket(seed, P, W, C), device="cuda")
    got = port.decode_partitions(*records, W, C)
    torch.cuda.synchronize()
    assert torch.equal(got, port.decode_partitions_plain(*records, W, C))
