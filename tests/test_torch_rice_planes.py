"""The arithmetic of the exact Rice ladder's Hopper kernel
(``audiotools_tpu_torch/csrc/rice_planes.cu``), modelled in numpy on the
CPU and held against ``rice_planes_plain``.

The kernel cannot run here, so these tests check what it computes: the
five-stage butterfly bit transpose across a warp's 32 lanes (a shuffle,
a rotation and a select a stage; lane r ends with plane r, its bits in
some order) followed by one population count a lane, the seed taken from the plane counts (sum(u >> J0) equals
sum_{r >= J0} count_r << (r - J0) modulo 2^32, as the plain version's
int32 cast wraps it), and the walk of a persistent grid's warps over
groups of rows with the next step loaded ahead and the counts staged
and stored a group at a time.  ``test_torch_qpack.py`` holds
``rice_planes_plain`` against the reference's stacked form, and its
card test holds the kernel against ``rice_planes_plain``.
"""

import numpy as np
import pytest
import torch

from audiotools_tpu_torch.ops import flac_frames

LANES = np.arange(32)
STAGES = (16, 8, 4, 2, 1)
# the kernel's rows a warp (kRows)
K_ROWS = 8
INT32_MIN = -(1 << 31)
INT32_MAX = (1 << 31) - 1


def low_half(d):
    """the bit positions p with p & d == 0, as the kernel's low_half"""
    return 0xFFFFFFFF // ((1 << d) + 1)


def zigzag32(x):
    """int32 residuals -> the kernel's uint32 u = (x << 1) ^ (x >> 31)"""
    x = np.asarray(x, dtype=np.int32)
    return (x.astype(np.uint32) << np.uint32(1)) ^ (x >> 31).astype(
        np.uint32)


def warp_transpose(u):
    """the kernel's five butterfly stages on uint32 [..., 32] (lane
    last), d = 16, 8, 4, 2, 1: lane l keeps low_half(d) of its word
    (lane bit d clear) or the rest (set) and takes the other bits from
    lane l ^ d's word rotated left by d.  Lane r ends with plane r of
    the 32 words, its bits in some order."""
    x = np.array(u, dtype=np.uint32)
    for d in STAGES:
        upper = (LANES & d) != 0
        keep = np.where(upper, ~np.uint32(low_half(d)),
                        np.uint32(low_half(d))).astype(np.uint32)
        y = x[..., LANES ^ d]
        rotated = (y << np.uint32(d)) | (y >> np.uint32(32 - d))
        x = (x & keep) | (rotated & ~keep)
    return x


def seed_from_counts(counts, j0):
    """the kernel's seed: the lanes r >= j0 of ``counts`` (uint32
    [..., 32], lane r plane r's count) summed as count_r << (r - j0),
    modulo 2^32 (one __reduce_add_sync)"""
    shift = (LANES - j0).clip(0).astype(np.uint32)
    terms = np.where(LANES >= j0, counts << shift, np.uint32(0))
    return terms.astype(np.uint64).sum(axis=-1) & 0xFFFFFFFF


def kernel_model(res, psize, j0, warps):
    """the kernel's walk on int32 residual rows [rows * psize] with
    ``warps`` warps in the grid: each warp strides over groups of
    K_ROWS rows, loads a step (32 residuals of each row) ahead of the
    one it counts, and stages and stores a group's (J0 + 1)-wide rows
    once the group's last step is counted.  Returns int64 [rows, j0 +
    1]; a word written twice or never fails the model."""
    flat = np.asarray(res, dtype=np.int32).reshape(-1)
    rows = flat.size // psize
    width = j0 + 1
    groups = -(-rows // K_ROWS)
    out = np.full(rows * width, -1, dtype=np.int64)

    def load(g, base):
        # instance kTail = 0 (psize % 32 == 0) does not mask by psize
        r = g * K_ROWS + np.arange(K_ROWS)[:, None]
        i = base + LANES[None, :]
        ok = (r < rows) & ((i < psize) | (psize % 32 == 0))
        index = np.where(ok, r * psize + i, 0)
        assert (index < flat.size).all(), "a load past the residuals"
        return np.where(ok, flat[index], 0)

    def store(g, acc):
        seed = seed_from_counts(acc, j0)
        stage = np.where(LANES[None, :width] < j0, acc[:, :width],
                         seed[:, None]).reshape(-1)
        row0 = g * K_ROWS
        words = min(K_ROWS, rows - row0) * width
        dst = out[row0 * width:row0 * width + words]
        assert (dst == -1).all(), "a count written twice"
        dst[:] = stage[:words].astype(np.uint32).view(np.int32)

    for warp in range(warps):
        (g, base) = (warp, 0)
        if g >= groups:
            continue
        acc = np.zeros((K_ROWS, 32), dtype=np.uint32)
        cur = load(g, base)
        while True:
            (g_next, base_next) = (g, base + 32)
            if base_next >= psize:
                (g_next, base_next) = (g + warps, 0)
            more = g_next < groups
            if more:
                ahead = load(g_next, base_next)
            acc += np.bitwise_count(warp_transpose(zigzag32(cur))).astype(
                np.uint32)
            if base_next == 0:
                store(g, acc)
                acc[:] = 0
            if not more:
                break
            (cur, g, base) = (ahead, g_next, base_next)
    assert (out != -1).all(), "a count never written"
    return out.reshape(rows, width)


def residuals(rng, shape, extremes=True):
    """seeded int32 residuals over the whole range, with INT32_MIN
    (u = 0xFFFFFFFF), INT32_MAX (u = 0xFFFFFFFE), -1, 0 and 1 mixed
    in"""
    res = rng.integers(INT32_MIN, INT32_MAX, shape, endpoint=True,
                       dtype=np.int64)
    small = rng.integers(-(1 << 12), 1 << 12, shape)
    res = np.where(rng.random(shape) < 0.5, small, res)
    if extremes:
        picks = np.array([INT32_MIN, INT32_MAX, -1, 0, 1])
        res = np.where(rng.random(shape) < 0.2,
                       picks[rng.integers(0, 5, shape)], res)
    return res.astype(np.int32)


def test_the_stages_route_each_plane_to_its_lane():
    """the stages are linear over GF(2): on each of the 32 x 32 one-bit
    words (bit r of lane l) exactly one bit comes out, in lane r, and
    the 32 lanes' bit r land on 32 different positions there"""
    positions = {}
    for lane in range(32):
        for r in range(32):
            u = np.zeros(32, dtype=np.uint32)
            u[lane] = np.uint32(1) << np.uint32(r)
            t = warp_transpose(u)
            assert list(np.nonzero(t)[0]) == [r]
            assert np.bitwise_count(t[r]) == 1
            positions.setdefault(r, set()).add(int(t[r]))
    assert all(len(p) == 32 for p in positions.values())
    rng = np.random.default_rng(1)
    u = rng.integers(0, 1 << 32, (200, 32), dtype=np.uint64).astype(
        np.uint32)
    u[0] = 0xFFFFFFFF
    u[1] = 0
    # linearity: a random warp's words are the XOR of its one-bit parts
    t = warp_transpose(u)
    assert np.array_equal(t[0], np.full(32, 0xFFFFFFFF, dtype=np.uint32))
    assert not t[1].any()
    parts = np.zeros_like(t[2:6])
    for lane in range(32):
        v = np.zeros_like(u[2:6])
        v[:, lane] = u[2:6, lane]
        parts ^= warp_transpose(v)
    assert np.array_equal(parts, t[2:6])


@pytest.mark.parametrize("seed", [2, 3])
def test_a_population_count_a_lane_counts_its_plane(seed):
    rng = np.random.default_rng(seed)
    res = residuals(rng, (300, 32))
    u = zigzag32(res)
    counts = np.bitwise_count(warp_transpose(u))
    planes = ((u[:, :, None] >> LANES.astype(np.uint32)) & 1).sum(axis=1)
    assert np.array_equal(counts, planes)


@pytest.mark.parametrize("j0", [0, 1, 14, 30, 31])
@pytest.mark.parametrize("fill", ["random", "INT32_MIN", "INT32_MAX"])
def test_the_seed_comes_from_the_counts(j0, fill):
    """sum(u >> j0) modulo 2^32 from the plane counts; a partition of
    4096 INT32_MIN residuals sums 4096 * (2^32 - 1) >> j0, which wraps
    for small j0"""
    rng = np.random.default_rng(j0)
    if fill == "random":
        res = residuals(rng, (4, 4096))
    else:
        res = np.full((4, 4096), INT32_MIN if fill == "INT32_MIN"
                      else INT32_MAX, dtype=np.int32)
        res[1, ::7] = 0
    u = zigzag32(res).astype(np.uint64)
    counts = ((u[:, :, None] >> LANES.astype(np.uint64)) & 1).sum(
        axis=1).astype(np.uint32)
    want = ((u >> np.uint64(j0)).sum(axis=1) & 0xFFFFFFFF)
    assert np.array_equal(seed_from_counts(counts, j0), want)
    plain = flac_frames.rice_planes_plain(torch.from_numpy(res[:, None, :]),
                                          1, j0)[:, 0, 0, j0].numpy()
    assert np.array_equal(want.astype(np.uint32).view(np.int32), plain)


@pytest.mark.parametrize("j0", [0, 14, 31])
@pytest.mark.parametrize("psize,rows,warps", [
    (1, 45, 2),          # one residual a row, 31 lanes masked
    (18, 53, 3),         # FLAC levels 0-2: 1152 >> 6
    (31, 29, 2),
    (32, 40, 2),         # a whole group a stride, no tail group
    (33, 37, 2),
    (64, 203, 5),        # the bench batch's partitions, several strides
    (96, 19, 1),
    (4096, 11, 2),
])
def test_the_kernel_walk_matches_plain(psize, rows, warps, j0):
    """every count and seed of the model's walk (a tail group of rows,
    several strides of the grid, rows a step does not fill) equals
    rice_planes_plain"""
    rng = np.random.default_rng(psize * 100 + j0)
    res = residuals(rng, (rows, 1, psize))
    want = flac_frames.rice_planes_plain(torch.from_numpy(res), 1, j0)
    got = kernel_model(res, psize, j0, warps)
    assert np.array_equal(got, want.reshape(rows, j0 + 1).numpy())


def test_the_bench_partitioning_matches_plain():
    """[S, C, n] rows cut into 64 partitions of 64, as the bench batch
    is (J0 14), with few warps so that each takes many groups"""
    rng = np.random.default_rng(64)
    res = residuals(rng, (3, 13, 4096), extremes=False)
    res[0, 0, :64] = INT32_MIN
    want = flac_frames.rice_planes_plain(torch.from_numpy(res), 64, 14)
    got = kernel_model(res, 64, 14, warps=7)
    assert np.array_equal(got, want.reshape(-1, 15).numpy())
