"""The port's Rice partition decode (``ops/rice_decode``): its plain
torch version must give exactly the reference's numpy forms, the
lock-step scan (``decode_partitions_scan``) and pointer doubling
(``decode_partitions``), on random buckets, every Rice parameter and
raw width, long unary quotients and padded rows.  A model of the card
kernel's staged path (a block's words in shared memory, the register
reader with its fast and exact paths, the swizzled output tile) must
give the reference's values too.  On a card the kernel must equal the
plain version."""

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


# csrc/rice_decode.cu: records a block, the joint span it copies whole,
# the columns of a warp's output tile, the buckets the staged kernel
# takes
BLOCK = 128
SPAN_WORDS = 4096
PART = 32
M64 = (1 << 64) - 1


def staged(W, C):
    return W <= 64 and C % PART == 0 and C <= 64


def model_record(win, W, bits, k, raw, codes, stats):
    """csrc/rice_decode.cu's Reader, with Python ints: the window
    words at the position in a 64-bit buffer, the next one read ahead;
    the fast path where a Rice code lies in the buffer inside the first
    W words, else the reference's arithmetic on the window"""
    n_last = W * 32 - 1
    is_raw = raw >= 0
    kc = max(k, 0)
    rc = max(raw, 0)
    nbits = rc if is_raw else kc
    nb_safe = min(max(nbits, 1), 32)
    sbit = 1 << (nb_safe - 1) if nbits > 0 else 0
    st = min(max(bits, 0), n_last)
    cw = st >> 5
    buf = (win[cw] << 32) | win[cw + 1]
    nxt = win[min(cw + 2, W)]
    vals = []
    for _ in range(codes):
        o = st & 31
        x = (buf << o) & M64
        if is_raw:
            lsb = x >> (64 - nb_safe) if nbits > 0 else 0
            res = ((lsb ^ sbit) - sbit) & 0xFFFFFFFF
            nxt_pos = st + rc
        else:
            q = 64 - x.bit_length()
            if cw + 1 < W and q + 1 + kc <= 64 - o:
                stats["fast"] += 1
                lsb = ((x << (q + 1)) & M64) >> (64 - nb_safe) if kc else 0
                nxt_pos = st + q + 1 + kc
            else:
                stats["exact"] += 1
                wi = st >> 5
                rem = (win[wi] << (st & 31)) & 0xFFFFFFFF
                if rem:
                    qpos = st + 32 - rem.bit_length()
                else:
                    wn = wi + 1
                    while wn < W and win[wn] == 0:
                        wn += 1
                    qpos = (n_last if wn >= W
                            else (wn << 5) + 32 - win[wn].bit_length())
                qpos = min(qpos, n_last)
                q = qpos - st
                off = qpos + 1
                wi2 = min(off >> 5, W - 1)
                sh = off & 31
                hi = (win[wi2] if sh == 0 else
                      ((win[wi2] << sh) | (win[wi2 + 1] >> (32 - sh)))
                      & 0xFFFFFFFF)
                lsb = hi >> (32 - nb_safe) if kc > 0 else 0
                nxt_pos = qpos + 1 + kc
            u = ((q << kc) if kc < 32 else 0) & 0xFFFFFFFF | lsb
            res = (u >> 1) ^ ((-(u & 1)) & 0xFFFFFFFF)
        vals.append(res - (1 << 32) if res >= 1 << 31 else res)
        st = min(nxt_pos, n_last)
        ncw = st >> 5
        if ncw == cw + 1:
            buf = ((buf << 32) & M64) | nxt
            nxt = win[min(ncw + 2, W)]
        elif ncw != cw:
            buf = (win[ncw] << 32) | win[ncw + 1]
            nxt = win[min(ncw + 2, W)]
        cw = ncw
    return vals


def kernel_model(words, word_base, base_bits, k, raw, count, W, C,
                 span_cap=None, stats=None):
    """csrc/rice_decode.cu's staged kernel: blocks of BLOCK records; the
    windows of the records that decode anything copied as one span
    when it fits span_cap words (the kernel's: the larger of
    SPAN_WORDS and BLOCK * (W + 1)), else each record's own W + 1
    words, every word clamped into the buffer; each warp's rows
    written PART columns at a time through a tile swizzled as the
    kernel's (word j of row r at column j ^ r), zeros past each count"""
    assert staged(W, C)
    words = [int(v) for v in np.asarray(words, dtype=np.uint32)]
    last = len(words) - 1
    P = len(word_base)
    stats = {} if stats is None else stats
    for key in ("fast", "exact", "joint", "own"):
        stats.setdefault(key, 0)
    if span_cap is None:
        span_cap = max(SPAN_WORDS, BLOCK * (W + 1))
    out = np.zeros((P, C), dtype=np.int32)
    for b0 in range(0, P, BLOCK):
        recs = range(b0, min(b0 + BLOCK, P))
        codes = {p: min(max(int(count[p]), 0), C) for p in recs}
        reading = [p for p in recs if codes[p] > 0]
        lo = min((int(word_base[p]) for p in reading), default=0)
        hi = max((int(word_base[p]) for p in reading), default=-1)
        span = hi - lo + W + 1 if reading else 0
        joint = span <= span_cap
        stats["joint" if joint else "own"] += 1
        if joint:
            smem = [words[min(max(lo + e, 0), last)] for e in range(span)]
        else:
            smem = [words[min(max((int(word_base[b0 + r]) if b0 + r < P
                                   else 0) + j, 0), last)]
                    for r in range(BLOCK) for j in range(W + 1)]
        for w0 in range(b0, b0 + BLOCK, 32):
            vals = {}
            for r in range(32):
                p = w0 + r
                if p >= P or not codes[p]:
                    continue
                start = (int(word_base[p]) - lo if joint
                         else (p - b0) * (W + 1))
                win = smem[start:start + W + 1]
                assert len(win) == W + 1
                vals[r] = model_record(win, W, int(base_bits[p]), int(k[p]),
                                       int(raw[p]), codes[p], stats)
            for j0 in range(0, C, PART):
                tile = [0] * (32 * PART)
                for (r, v) in vals.items():
                    for (jj, x) in enumerate(v[j0:j0 + PART]):
                        tile[r * PART + (jj ^ r)] = x
                for r in range(min(32, P - w0)):
                    out[w0 + r, j0:j0 + PART] = [tile[r * PART + (col ^ r)]
                                                 for col in range(PART)]
    return out


def stream_bucket(seed, P, W, C, long_codes=True):
    """P records laid end to end in one stream, as a bucket of the
    decoder holds them: Rice runs of every parameter 0-14 and raw runs
    up to 32 bits, a few long unary quotients across words, some count-0
    records (word_base 0, as padding), the last record ending in the
    buffer's last word; each record's span fits W words"""
    rng = np.random.default_rng(seed)
    bits = [1, 0, 1]
    metas = []
    for p in range(P):
        if p % 17 == 5:
            metas.append((0, 3, -1, 0))
            continue
        count = int(rng.integers(1, C + 1))
        start = len(bits)
        if p % 5 == 0:
            width = int(rng.choice([1, 8, 17, 31, 32]))
            values = rng.integers(-(1 << (width - 1)), 1 << (width - 1),
                                  count).tolist()
            body = _encode_raw(values, width)
            meta = (start, -1, width, count)
        else:
            kk = int(rng.integers(0, 15))
            values = rng.integers(-(1 << (kk + 1)), 1 << (kk + 1),
                                  count).tolist()
            if long_codes and p % 7 == 3:
                values[rng.integers(0, count)] = (40 << kk) + 1
            body = _encode_rice(values, kk)
            meta = (start, kk, -1, count)
        while (start & 31) + len(body) > 32 * W:
            body = body[:len(body) // 2]
        bits.extend(body)
        metas.append(meta)
    words = _bits_to_words(bits)
    return (words, [m[0] >> 5 for m in metas], [m[0] & 31 for m in metas],
            [m[1] for m in metas], [m[2] for m in metas],
            [m[3] for m in metas])


def check_model(args, W, C, **kw):
    """the kernel model against the reference's scan form"""
    stats = {}
    got = kernel_model(*args, W, C, stats=stats, **kw)
    want = ref.decode_partitions_scan(
        np, np.asarray(args[0], dtype=np.uint32),
        *[np.asarray(a, dtype=np.int32) for a in args[1:]], W, C)
    assert np.array_equal(got, want)
    return stats


@pytest.mark.parametrize("seed,P,W,C", [
    (1, 200, 16, 32),
    (2, 300, 32, 64),
    (3, 130, 64, 64),
])
def test_kernel_model_random_bucket(seed, P, W, C):
    """one window of W words a record, end to end: every block's span
    fits its copy (128 * (W + 1) words, at least SPAN_WORDS)"""
    stats = check_model(_random_bucket(seed, P, W, C), W, C)
    assert stats["fast"] and stats["exact"]
    assert stats["joint"] == -(-P // BLOCK)


@pytest.mark.parametrize("span_cap", [None, 64])
@pytest.mark.parametrize("W,C", [(8, 64), (32, 64), (64, 64), (16, 32)])
def test_kernel_model_stream_bucket(W, C, span_cap):
    """records end to end, as the decoder's buckets: the joint span, and
    a budget too small for it (each record's own window)"""
    args = stream_bucket(W + C, 300, W, C)
    assert args[1][-1] + W > len(args[0]) - 1     # reaches the last word
    stats = check_model(args, W, C, span_cap=span_cap)
    assert stats["fast"] > stats["exact"] > 0
    assert stats["joint" if span_cap is None else "own"] == 3


def test_kernel_model_edges():
    """a long unary code across words, a quotient that runs off the
    window, a raw 32-bit run, count 0, a record at the buffer's last
    word, one past it and one before its first"""
    values = [1000, -3, 7, 15 * 32, -(31 * 16)]
    bits = _encode_rice(values, 0)
    for W in (64, 8):
        args = (_bits_to_words(bits), [0], [0], [0], [-1], [len(values)])
        check_model(args, W, 64)
    rng = np.random.default_rng(32)
    raw32 = rng.integers(-(1 << 31), 1 << 31, 40).tolist()
    args = (_bits_to_words([0] * 7 + _encode_raw(raw32, 32)), [0], [7],
            [-1], [32], [40])
    assert check_model(args, 64, 64) is not None
    values = rng.integers(-50, 50, 30).tolist()
    words = _bits_to_words(_encode_rice(values, 3))
    last = len(words) - 1
    check_model((words, [0, 0, last, last + 3, 0, -2], [0, 0, 17, 0, 0, 5],
                 [3, -1, 2, 5, 3, 2], [-1, 0, -1, -1, -1, -1],
                 [30, 0, 10, 4, 0, 3]), 16, 32)


@pytest.mark.cuda
@pytest.mark.parametrize("apart", [False, True])
@pytest.mark.parametrize("W,C", [(8, 64), (16, 32), (32, 64), (64, 64)])
def test_cuda_stream_bucket(W, C, apart):
    """the stream buckets on the card; with ``apart`` every other record
    reads a second copy of the stream 9000 words on, so that no block's
    span fits and each record copies its own window"""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    (words, word_base, *rest) = stream_bucket(W + C, 300, W, C)
    if apart:
        far = len(words) + 9000
        words = np.concatenate([words, np.zeros(9000, dtype=np.uint32),
                                words])
        word_base = [b + far * (i % 2) for (i, b) in enumerate(word_base)]
    records = as_records(words, word_base, *rest, device="cuda")
    got = port.decode_partitions(*records, W, C)
    torch.cuda.synchronize()
    assert torch.equal(got, port.decode_partitions_plain(*records, W, C))


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
