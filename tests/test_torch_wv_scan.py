"""The port's WavPack pass chains on the CPU, held exactly to the
reference: ``run_pass_chain_plain`` and ``run_dec_chain_plain`` against
the reference's numpy forms (``wv_scan.run_pass_chain(np, ...)`` and
``run_dec_chain(np, ...)``) and against the host C++ passes, for every
term, deltas 0-7, block lengths at the warm-up edges, weights near and
past +-1024, and 8- to 32-bit magnitudes; the encoder's 5, 10 and
16-pass recipes as whole chains; a ragged batch of blocks with mixed
channel counts, lengths and chains in one call; two chains against the
reference's jitted JAX form.  On a card the kernels equal their plain
versions."""

import numpy as np
import pytest
import torch

from audiotools_tpu.ops import wv_scan as ref_scan
from audiotools_tpu.ref import wavpack as ref_wv
from audiotools_tpu_torch import _native
from audiotools_tpu_torch.ops import wv_scan

torch.set_num_threads(1)

REF_TERMS = (18, 17, 8, 5, 3, 2, 1, -1, -2, -3)
KEYS = ("x", "meta", "chain", "weights", "samples")


def random_block(rng, chain, cc, n, bits):
    """(x [cc, n], chain, weights [P, cc], samples) with samples of
    ``bits`` magnitude and weights up to 1100 in size"""
    x = rng.integers(-(1 << (bits - 1)), 1 << (bits - 1), (cc, n))
    w = rng.integers(-1100, 1101, (len(chain), cc))
    w[:, 0] = np.where(rng.random(len(chain)) < 0.3, 1024, w[:, 0])
    s = [rng.integers(-(1 << 15), 1 << 15, (cc, wv_scan.span(t)))
         for (t, _d) in chain]
    return (x, list(chain), w, s)


def tensors(blocks):
    batch = wv_scan.pack_blocks(blocks)
    return (batch, [torch.as_tensor(batch[k]) for k in KEYS])


def ref_chain(fn, block):
    (x, chain, w, s) = block
    return fn(np, np.asarray(x, dtype=np.int64), tuple(chain),
              np.asarray(w, dtype=np.int64),
              tuple(np.asarray(v, dtype=np.int64) for v in s))


def term_blocks(term, seed):
    """one block for each delta 0-7, length at the term's warm-up edges
    and 500, and magnitude of 8, 16, 24 and 32 bits"""
    rng = np.random.default_rng(seed)
    span = wv_scan.span(term)
    blocks = []
    for delta in range(8):
        for n in (1, span, span + 1, 500):
            for bits in (8, 16, 24, 32):
                cc = 2 if term < 0 else 1 + (n + bits + delta) % 2
                blocks.append(random_block(rng, [(term, delta)], cc, n,
                                           bits))
    return blocks


@pytest.mark.parametrize("term", REF_TERMS)
def test_pass_chain_plain_matches_reference(term):
    blocks = term_blocks(term, seed=term + 50)
    (batch, args) = tensors(blocks)
    (out, w_out, s_out) = wv_scan.run_pass_chain_plain(*args)
    outs = wv_scan.unpack(out.numpy(), batch["meta"])
    span = wv_scan.span(term)
    for (b, block) in enumerate(blocks):
        (x, _chain, w, s) = block
        (cc, n) = x.shape
        (ref_out, ref_w, ref_s) = ref_chain(ref_scan.run_pass_chain, block)
        assert np.array_equal(outs[b], ref_out)
        assert np.array_equal(w_out[b, 0, :cc].numpy(), ref_w[0])
        assert np.array_equal(s_out[b, 1:].numpy(),
                              batch["samples"][b, 1:])
        # the host C++ pass: the same outputs, weights and samples
        (chs, ws, ss) = _native.wv_correlate(list(x), term, _chain[0][1],
                                             list(w[0]), list(s[0]))
        assert np.array_equal(np.stack(chs), outs[b])
        assert ws == w_out[b, 0, :cc].tolist()
        got_s = s_out[b, 0, :cc, :span].numpy()
        if term > 0:
            assert np.array_equal(np.stack(ss), got_s)
        else:
            assert np.array_equal(got_s, s[0])
        if n >= span:
            # the reference's numpy form takes no block shorter than its
            # span (its JAX route sends those to the host)
            assert np.array_equal(np.asarray(ref_s[0]), got_s)


@pytest.mark.parametrize("term", REF_TERMS)
def test_dec_chain_plain_matches_reference(term):
    blocks = term_blocks(term, seed=term + 90)
    (batch, args) = tensors(blocks)
    outs = wv_scan.unpack(wv_scan.run_dec_chain_plain(*args).numpy(),
                          batch["meta"])
    for (b, block) in enumerate(blocks):
        (x, chain, w, s) = block
        assert np.array_equal(outs[b], ref_chain(ref_scan.run_dec_chain,
                                                 block))
        got = _native.wv_decorrelate(list(x), term, chain[0][1], list(w[0]),
                                     list(s[0]))
        assert np.array_equal(np.stack(got), outs[b])


@pytest.mark.parametrize("passes", [5, 10, 16])
def test_recipes_as_whole_chains(passes):
    """each recipe's chain on a stereo and a mono block, the encode's
    output decoded back through the same stored state"""
    rng = np.random.default_rng(passes)
    blocks = [random_block(rng, ref_wv._PASS_RECIPES_2CH[passes], 2, 700,
                           17),
              random_block(rng, ref_wv._PASS_RECIPES_1CH[passes], 1, 333,
                           24)]
    (batch, args) = tensors(blocks)
    (out, w_out, s_out) = wv_scan.run_pass_chain_plain(*args)
    outs = wv_scan.unpack(out.numpy(), batch["meta"])
    for (b, block) in enumerate(blocks):
        P = len(block[1])
        cc = block[0].shape[0]
        (ref_out, ref_w, ref_s) = ref_chain(ref_scan.run_pass_chain, block)
        assert np.array_equal(outs[b], ref_out)
        assert np.array_equal(w_out[b, :P, :cc].numpy(), ref_w)
        for (p, (t, _d)) in enumerate(block[1]):
            assert np.array_equal(
                s_out[b, p, :cc, :wv_scan.span(t)].numpy(), ref_s[p])
    # the decode chain runs the passes backwards: reversed chain, the
    # same stored state, gives the input back
    back = []
    for (b, (x, chain, w, s)) in enumerate(blocks):
        back.append((outs[b], chain[::-1], w[::-1], s[::-1]))
    (bbatch, bargs) = tensors(back)
    dec = wv_scan.unpack(wv_scan.run_dec_chain_plain(*bargs).numpy(),
                         bbatch["meta"])
    for (b, block) in enumerate(blocks):
        assert np.array_equal(dec[b], block[0])
        assert np.array_equal(dec[b], ref_chain(ref_scan.run_dec_chain,
                                                back[b]))


def ragged_blocks(seed):
    """blocks of mixed channel counts, lengths and chains"""
    rng = np.random.default_rng(seed)
    pos = [t for t in wv_scan.TERMS if t > 0]
    blocks = []
    for k in range(12):
        cc = 1 + k % 2
        n = int(rng.integers(1, 400))
        terms = pos if cc == 1 else list(wv_scan.TERMS)
        P = int(rng.integers(1, wv_scan.MAX_PASSES + 1))
        chain = [(int(rng.choice(terms)), int(rng.integers(0, 8)))
                 for _ in range(P)]
        blocks.append(random_block(rng, chain, cc, n, 8 + 4 * (k % 5)))
    return blocks


def encoded(blocks):
    """the decode blocks of encode blocks: each block's residuals (the
    host C++ passes) with its chain, weights and samples reversed;
    their decode gives the encode's input back"""
    out = []
    for (x, chain, w, s) in blocks:
        cur = list(x)
        for (p, (t, d)) in enumerate(chain):
            cur = _native.wv_correlate(cur, t, d, list(w[p]), list(s[p]))[0]
        out.append((np.stack(cur), chain[::-1], w[::-1], s[::-1]))
    return out


def test_ragged_decode_batch():
    sources = ragged_blocks(7)
    blocks = encoded(sources)
    (batch, args) = tensors(blocks)
    outs = wv_scan.unpack(wv_scan.run_dec_chain_plain(*args).numpy(),
                          batch["meta"])
    for (b, block) in enumerate(blocks):
        assert np.array_equal(outs[b], sources[b][0])
        assert np.array_equal(outs[b], ref_chain(ref_scan.run_dec_chain,
                                                 block))


def test_ragged_encode_batch():
    blocks = ragged_blocks(8)
    (batch, args) = tensors(blocks)
    (out, w_out, s_out) = wv_scan.run_pass_chain_plain(*args)
    outs = wv_scan.unpack(out.numpy(), batch["meta"])
    for (b, (x, chain, w, s)) in enumerate(blocks):
        cur = list(x)
        for (p, (t, d)) in enumerate(chain):
            (cur, ws, ss) = _native.wv_correlate(cur, t, d, list(w[p]),
                                                 list(s[p]))
            assert ws == w_out[b, p, :len(cur)].tolist()
            want = ss if t > 0 else s[p]
            assert np.array_equal(
                np.stack(want), s_out[b, p, :len(cur), :wv_scan.span(t)])
        assert np.array_equal(np.stack(cur), outs[b])


@pytest.mark.parametrize("chain", [((18, 2), (-2, 3), (5, 1)),
                                   ((17, 2), (-1, 7), (-3, 0), (2, 4))])
def test_chains_match_jitted_reference(chain):
    """the reference's jnp form, jitted on the CPU, as
    test_wavpack_jax.py::test_wv_scan_numpy_vs_jax runs it"""
    jnp = pytest.importorskip("jax.numpy")
    import jax
    jax.config.update("jax_enable_x64", True)
    rng = np.random.default_rng(len(chain))
    block = random_block(rng, chain, 2, 300, 20)
    (x, _c, w, s) = block
    (batch, args) = tensors([block])
    (out, w_out, s_out) = wv_scan.run_pass_chain_plain(*args)
    enc = jax.jit(lambda x, w, s: ref_scan.run_pass_chain(jnp, x, chain, w,
                                                          s))
    (j_out, j_w, j_s) = enc(jnp.asarray(x), jnp.asarray(w),
                            tuple(jnp.asarray(v) for v in s))
    assert np.array_equal(out.numpy().reshape(2, -1), np.asarray(j_out))
    assert np.array_equal(w_out[0, :len(chain)].numpy(), np.asarray(j_w))
    for (p, (t, _d)) in enumerate(chain):
        assert np.array_equal(s_out[0, p, :, :wv_scan.span(t)].numpy(),
                              np.asarray(j_s[p]))
    dec = jax.jit(lambda x, w, s: ref_scan.run_dec_chain(jnp, x, chain, w,
                                                         s))
    want = np.asarray(dec(jnp.asarray(x), jnp.asarray(w),
                          tuple(jnp.asarray(v) for v in s)))
    assert np.array_equal(wv_scan.run_dec_chain_plain(*args).numpy()
                          .reshape(2, -1), want)


# the card's kernels hand chunks of 8 to 64 samples from pass to pass
# (csrc/wv_chain.cu, WV_CHUNK): lengths at 1-3 chunks and one either side
CHUNK_EDGES = sorted({m * k + d for k in (8, 16, 32, 64) for m in (1, 2, 3)
                      for d in (-1, 0, 1)})
EDGE_KINDS = ("short", "chunk_edges", "negative_places", "ragged_mix",
              "wide_sources", "weight_ends")
# int32's ends and just past them
WIDE = (2**31 - 1, -(2**31 - 1), -2**31, 2**31, -2**31 - 1, 2**31 + 1)


def random_chain(rng, passes, cc):
    terms = [t for t in wv_scan.TERMS if cc == 2 or t > 0]
    return [(int(rng.choice(terms)), int(rng.integers(0, 8)))
            for _ in range(passes)]


def edge_blocks(kind, seed):
    """blocks at the edges of the card kernels' pipeline, each kind a
    batch"""
    rng = np.random.default_rng(seed)
    if kind == "short":
        # shorter than a chunk, and than the fill of 16 passes
        return [random_block(rng, random_chain(rng, P, cc), cc, n, 16)
                for n in (1, 2, 5, 8, 9, 31) for (P, cc) in
                ((1, 1), (5, 2), (16, 2), (16, 1))]
    if kind == "chunk_edges":
        return [random_block(rng, random_chain(rng, 1 + k % 16, 1 + k % 2),
                             1 + k % 2, n, 20)
                for (k, n) in enumerate(CHUNK_EDGES)]
    if kind == "negative_places":
        # 16 passes with the negative terms first, last, adjacent, only
        pos = [(t, 1 + t % 7) for t in (1, 2, 3, 4, 5, 6, 7, 8, 17, 18)]
        neg = [(-1, 3), (-2, 5), (-3, 2)]
        chains = [neg + pos + pos[:3], pos + pos[:3] + neg,
                  pos[:6] + neg + neg[::-1] + pos[6:7], (neg * 6)[:16]]
        return [random_block(rng, chain, 2, n, 18)
                for chain in chains for n in (1, 40, 130)]
    if kind == "ragged_mix":
        return [random_block(rng, random_chain(rng, P, cc), cc,
                             int(rng.integers(1, 300)), 8 + 2 * k)
                for (k, (P, cc)) in enumerate(
                    [(1, 1), (16, 2), (16, 1), (1, 2)] * 3)]
    if kind == "wide_sources":
        blocks = []
        for (k, cc) in enumerate((2, 1, 2, 1)):
            n = 70 + 13 * k
            x = rng.integers(-2**31, 2**31, (cc, n))
            x.flat[rng.choice(cc * n, 24, replace=False)] = np.repeat(WIDE,
                                                                        4)
            (_x, chain, w, s) = random_block(
                rng, random_chain(rng, 1 + k, cc), cc, n, 16)
            s = [np.where(rng.random(v.shape) < 0.5, v,
                          rng.choice(WIDE, v.shape)) for v in s]
            blocks.append((x, chain, w, s))
        return blocks
    assert kind == "weight_ends"
    blocks = []
    for (k, term) in enumerate(wv_scan.TERMS):
        cc = 2 if term < 0 else 1 + k % 2
        (x, chain, w, s) = random_block(rng, [(term, 7 - k % 3)], cc, 100,
                                        8)
        ends = (2**31 - 1, -(2**31 - 1), -2**31, 1024, -1024, 0)
        w = np.array([[ends[k % 6], ends[(k + 1) % 6]][:cc]])
        blocks.append((x, chain, w, s))
    return blocks


@pytest.mark.parametrize("kind", EDGE_KINDS)
def test_edge_blocks_encode(kind):
    """the plain encode on the pipeline's edge blocks against the
    reference's numpy form and the host C++ passes"""
    blocks = edge_blocks(kind, seed=len(kind))
    (batch, args) = tensors(blocks)
    (out, w_out, s_out) = wv_scan.run_pass_chain_plain(*args)
    outs = wv_scan.unpack(out.numpy(), batch["meta"])
    for (b, block) in enumerate(blocks):
        (x, chain, w, s) = block
        (cc, n) = x.shape
        (ref_out, ref_w, ref_s) = ref_chain(ref_scan.run_pass_chain, block)
        assert np.array_equal(outs[b], ref_out)
        assert np.array_equal(w_out[b, :len(chain), :cc].numpy(), ref_w)
        cur = list(x)
        for (p, (t, d)) in enumerate(chain):
            span = wv_scan.span(t)
            got_s = s_out[b, p, :cc, :span].numpy()
            if n >= span:
                assert np.array_equal(got_s, np.asarray(ref_s[p]))
            (cur, ws, ss) = _native.wv_correlate(cur, t, d, list(w[p]),
                                                 list(s[p]))
            assert ws == w_out[b, p, :cc].tolist()
            assert np.array_equal(got_s, np.stack(ss) if t > 0 else s[p])
        assert np.array_equal(np.stack(cur), outs[b])
        # passes past the block's count keep their state
        assert np.array_equal(w_out[b, len(chain):].numpy(),
                              batch["weights"][b, len(chain):])
        assert np.array_equal(s_out[b, len(chain):].numpy(),
                              batch["samples"][b, len(chain):])


@pytest.mark.parametrize("kind", EDGE_KINDS)
def test_edge_blocks_decode(kind):
    """the plain decode of the edge blocks' residuals against the
    reference's numpy form, and back to the encode's input"""
    sources = edge_blocks(kind, seed=len(kind) + 100)
    blocks = encoded(sources)
    (batch, args) = tensors(blocks)
    outs = wv_scan.unpack(wv_scan.run_dec_chain_plain(*args).numpy(),
                          batch["meta"])
    for (b, block) in enumerate(blocks):
        assert np.array_equal(outs[b], sources[b][0])
        assert np.array_equal(outs[b], ref_chain(ref_scan.run_dec_chain,
                                                 block))


def test_cpu_tensors_launch_nothing():
    (_batch, args) = tensors(ragged_blocks(3)[:4])
    before = (wv_scan.run_pass_chain.launches, wv_scan.run_dec_chain.launches)
    got = wv_scan.run_pass_chain(*args)
    want = wv_scan.run_pass_chain_plain(*args)
    assert all(torch.equal(g, w) for (g, w) in zip(got, want))
    assert torch.equal(wv_scan.run_dec_chain(*args),
                       wv_scan.run_dec_chain_plain(*args))
    assert (wv_scan.run_pass_chain.launches,
            wv_scan.run_dec_chain.launches) == before


def test_argument_checks():
    rng = np.random.default_rng(0)
    good = random_block(rng, [(18, 2)], 2, 10, 16)
    with pytest.raises(ValueError, match="unsupported term"):
        wv_scan.pack_blocks([random_block(rng, [(9, 2)], 1, 10, 16)])
    with pytest.raises(ValueError, match="unsupported term"):
        x = rng.integers(0, 9, (1, 10))
        wv_scan.pack_blocks([(x, [(-1, 2)], [[0]], [[[0]]])])
    with pytest.raises(ValueError, match="stores"):
        wv_scan.pack_blocks([(good[0], [(3, 2)], [[0, 0]],
                              [[[0, 0], [0, 0]]])])
    with pytest.raises(ValueError, match="passes"):
        wv_scan.pack_blocks([random_block(rng, [(1, 1)] * 17, 1, 10, 16)])
    with pytest.raises(ValueError, match="n >= 1"):
        wv_scan.pack_blocks([(np.zeros((2, 0)), [], [], [])])
    (_batch, args) = tensors([good])
    with pytest.raises(TypeError, match="int64"):
        wv_scan.run_dec_chain(args[0].to(torch.int32), *args[1:])
    with pytest.raises(ValueError, match="meta"):
        wv_scan.run_dec_chain(args[0], args[1][:, :3], *args[2:])
    with pytest.raises(ValueError, match="unsupported device"):
        wv_scan.run_dec_chain(*(a.to("meta") for a in args))


@pytest.mark.cuda
@pytest.mark.parametrize("seed", [1, 2, 3])
def test_cuda_kernels_match_plain(seed):
    """every term at the warm-up edges, a ragged batch and the pipeline's
    edge blocks, each kernel once a call"""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    blocks = ragged_blocks(seed) + [
        block for term in wv_scan.TERMS
        for block in term_blocks(term, seed)[::7]] + [
        block for kind in EDGE_KINDS for block in edge_blocks(kind, seed)]
    (_batch, args) = tensors(blocks)
    (_dbatch, dargs) = tensors(encoded(blocks))
    before = (wv_scan.run_pass_chain.launches, wv_scan.run_dec_chain.launches)
    got = wv_scan.run_pass_chain(*(a.cuda() for a in args))
    dec = wv_scan.run_dec_chain(*(a.cuda() for a in dargs))
    torch.cuda.synchronize()
    assert (wv_scan.run_pass_chain.launches,
            wv_scan.run_dec_chain.launches) == (before[0] + 1, before[1] + 1)
    want = wv_scan.run_pass_chain_plain(*args)
    assert all(torch.equal(g.cpu(), w) for (g, w) in zip(got, want))
    assert torch.equal(dec.cpu(), wv_scan.run_dec_chain_plain(*dargs))
