"""WavPack's decorrelation pass chains, encode and decode, on a torch
device, for a ragged batch of blocks.

Port of ``audiotools_tpu/ops/wv_scan.py`` (``run_pass_chain`` and
``run_dec_chain``, ``lax.scan`` recurrences with no Pallas form).  A
block of 1 or 2 channels runs up to MAX_PASSES passes in order, each
pass's output the next one's input.  A pass of term t and delta d keeps
a weight w for each channel and, sample by sample,

    encode:  r = x - ((w * s + 512) >> 10)       w += update(s, r)
    decode:  y = ((w * s + 512) >> 10) + x       w += update(s, x)

with update(s, v) = 0 when s or v is 0, else +d when their signs agree
and -d when they differ, and w clamped to [-1024, 1024] after every
step of a negative term only.  The source s is, for terms 1-8, the
series t samples back; for 17 and 18, 2 * s1 - s2 and (3 * s1 - s2) >>
1 of the two latest samples; for the negative terms, which need two
channels, the other channel's series: one sample back for both
channels under -3, the current sample for channel 1 under -1 and for
channel 0 under -2, one sample back for the other channel.  The series
is the pass input when encoding and its output when decoding, and
before the block starts it is the pass's stored samples: terms 1-8
store t samples a channel, oldest first; 17 and 18 store [s0, s1], the
newer first; negative terms store one sample a channel, and a channel's
chain starts from the other channel's stored sample.  Encoding returns
each pass's final weights and new stored samples: for terms 1-8 the
last t and for 17/18 the last two (newest first) of the stored samples
followed by the pass outputs; negative terms keep the samples they were
given (the reference's ``ref/wavpack.py`` and its C++
``atpu_wv_correlate``).  All arithmetic is int64, exactly.

The batch (``pack_blocks``) is five int64 arrays: ``x`` [total], every
block's channels one after the other (channel c of block b at
``offset + c * n``); ``meta`` [B, 4] of (offset, n, cc, passes);
``chain`` [B, MAX_PASSES, 2] of (term, delta); ``weights`` [B,
MAX_PASSES, 2]; ``samples`` [B, MAX_PASSES, 2, MAX_SAMPLES], each
zero-padded.  Blocks of different lengths, channel counts and chains
share one batch.

``run_pass_chain`` and ``run_dec_chain`` launch the hand-written CUDA
kernels ``csrc/wv_chain.cu`` on a CUDA tensor and count the launches:
a CUDA block a block, a warp a pass with a lane a channel, the passes
pipelined through rings of chunks in shared memory, so that a block's
passes run side by side and its series between passes stay on the
chip.  On a CPU tensor they run ``run_pass_chain_plain`` and
``run_dec_chain_plain``, loops over sample positions in which every
lane (a channel of a block) advances together, on any device.
"""

from __future__ import annotations

import numpy as np
import torch

from .._device import COUNT_LOCK

MAX_PASSES = 16
MAX_SAMPLES = 8
TERMS = (1, 2, 3, 4, 5, 6, 7, 8, 17, 18, -1, -2, -3)
# the clamp bound of positive terms: none
_NO_CLAMP = 1 << 62


def span(term):
    """the samples a pass of this term stores a channel"""
    if term in (17, 18):
        return 2
    return term if 1 <= term <= 8 else 1


def pack_blocks(blocks):
    """the batch arrays of a list of blocks

    each block is (x, chain, weights, samples): x int [cc, n], cc 1 or
    2 and n >= 1; chain a sequence of at most MAX_PASSES (term, delta);
    weights [passes][cc]; samples [passes][cc][span(term)].  Returns a
    dict of int64 numpy arrays x, meta, chain, weights and samples
    (module docstring).  Raises ValueError on a term outside TERMS, a
    negative term in a one-channel block, or a shape that does not
    fit."""
    B = len(blocks)
    meta = np.zeros((B, 4), dtype=np.int64)
    chain = np.zeros((B, MAX_PASSES, 2), dtype=np.int64)
    weights = np.zeros((B, MAX_PASSES, 2), dtype=np.int64)
    samples = np.zeros((B, MAX_PASSES, 2, MAX_SAMPLES), dtype=np.int64)
    xs = []
    offset = 0
    for (b, (x, blk_chain, blk_w, blk_s)) in enumerate(blocks):
        x = np.asarray(x, dtype=np.int64)
        if x.ndim != 2 or x.shape[0] not in (1, 2) or x.shape[1] < 1:
            raise ValueError("a block's samples must be [1 or 2, n >= 1]")
        (cc, n) = x.shape
        P = len(blk_chain)
        if P > MAX_PASSES:
            raise ValueError("more than %d passes" % (MAX_PASSES,))
        for (p, (term, delta)) in enumerate(blk_chain):
            if term not in TERMS or (term < 0 and cc != 2):
                raise ValueError("unsupported term %r for %d channel(s)"
                                 % (term, cc))
            chain[b, p] = (term, delta)
            weights[b, p, :cc] = [int(v) for v in blk_w[p][:cc]]
            for c in range(cc):
                stored = [int(v) for v in blk_s[p][c]]
                if len(stored) != span(term):
                    raise ValueError("term %d stores %d samples, not %d"
                                     % (term, span(term), len(stored)))
                samples[b, p, c, :len(stored)] = stored
        meta[b] = (offset, n, cc, P)
        xs.append(x.reshape(-1))
        offset += cc * n
    return {"x": (np.concatenate(xs) if xs
                  else np.zeros(0, dtype=np.int64)),
            "meta": meta, "chain": chain, "weights": weights,
            "samples": samples}


def unpack(out, meta):
    """the flat output of a batch as a list of [cc, n] numpy arrays"""
    out = np.asarray(out)
    return [out[o:o + c * n].reshape(c, n)
            for (o, n, c, _p) in np.asarray(meta).tolist()]


def _check_args(x, meta, chain, weights, samples):
    if x.dim() != 1:
        raise ValueError("x must be 1-D")
    B = meta.shape[0]
    for (name, t, shape) in (
            ("meta", meta, (B, 4)), ("chain", chain, (B, MAX_PASSES, 2)),
            ("weights", weights, (B, MAX_PASSES, 2)),
            ("samples", samples, (B, MAX_PASSES, 2, MAX_SAMPLES))):
        if tuple(t.shape) != shape:
            raise ValueError("%s must be %s" % (name, list(shape)))
    for t in (x, meta, chain, weights, samples):
        if t.dtype != torch.int64:
            raise TypeError("the batch arrays must be int64")
        if t.device != x.device:
            raise ValueError("the batch arrays must share one device")


class _Lanes:
    """the batch as time-major lanes: values [N, B, 2], N the longest
    block, channel 1 of a one-channel block and the samples past a
    block's end padded"""

    def __init__(self, x, meta):
        dev = x.device
        (offset, n, cc) = (meta[:, 0], meta[:, 1], meta[:, 2])
        self.B = meta.shape[0]
        self.N = int(n.max()) if self.B else 0
        i = torch.arange(self.N, device=dev)[:, None, None]
        c = torch.arange(2, device=dev)[None, None, :]
        self.index = offset[None, :, None] + c * n[None, :, None] + i
        self.valid = (i < n[None, :, None]) & (c < cc[None, :, None])
        self.n = n
        self.passes = meta[:, 3]

    def gather(self, x):
        idx = torch.where(self.valid, self.index, 0)
        return torch.where(self.valid, x[idx], 0)

    def scatter(self, x, values):
        out = x.clone()
        out[self.index[self.valid]] = values[self.valid]
        return out


def _pass_setup(lanes, chain, samples, p):
    """a pass's constants for each lane: term, delta and active [B];
    the series' stored prefix [B, 2, 8] (prefix[k] the sample 8 - k
    back); ka [B, 2], how many samples back the source reads (in the
    other channel's series for negative terms, 0 being the same step);
    the 17/18 coefficients, s = (coef_a * s1 - coef_b * s2) >> shift;
    the weight's clamp bounds lo and hi"""
    term = chain[:, p, 0]
    delta = chain[:, p, 1]
    active = p < lanes.passes
    neg = term < 0
    t1718 = (term == 17) | (term == 18)
    s_p = samples[:, p]                                   # [B, 2, 8]
    k = torch.arange(MAX_SAMPLES, device=term.device)[None, None, :]
    t = term[:, None, None]
    # terms 1-8: prefix[k] = stored[k - 8 + t]; 17/18: prefix[7] = s0,
    # prefix[6] = s1; negative: prefix[7] = the other channel's sample
    j = torch.where(t1718[:, None, None], 7 - k, k - MAX_SAMPLES + t)
    j = torch.where(neg[:, None, None], 0, j)
    ok = torch.where(neg[:, None, None], k == MAX_SAMPLES - 1,
                     (j >= 0) & (j < MAX_SAMPLES))
    src = torch.where(neg[:, None, None], s_p.flip(1), s_p)
    prefix = torch.where(ok, src.gather(2, j.clamp(0, MAX_SAMPLES - 1)
                                        .expand(-1, 2, -1)), 0)
    c = torch.arange(2, device=term.device)[None, :]
    ka = torch.where(t1718, 1, term)[:, None].expand(-1, 2).clone()
    ka = torch.where(((term == -1)[:, None] & (c == 1)) |
                     ((term == -2)[:, None] & (c == 0)), 0, ka)
    ka = torch.where(neg[:, None], torch.where(ka == 0, 0, 1), ka)
    coef_a = torch.where(term == 17, 2, torch.where(term == 18, 3, 1))
    coef_b = t1718.to(torch.int64)
    shift = (term == 18).to(torch.int64)
    big = torch.where(neg & active, 1024, _NO_CLAMP)[:, None].expand(-1, 2)
    return dict(term=term, delta=delta, active=active, neg=neg,
                t1718=t1718, prefix=prefix, ka=ka, coef_a=coef_a,
                coef_b=coef_b, shift=shift, lo=-big, hi=big)


def _source(ext, setup, N):
    """the encode source series [N, B, 2] from ext [B, 2, 8 + N], the
    pass input after its stored prefix"""
    B = ext.shape[0]
    dev = ext.device
    i = torch.arange(N, device=dev)[:, None, None]
    chan = torch.arange(2, device=dev)[None, None, :]
    other = torch.where(setup["neg"][None, :, None], 1 - chan, chan)
    b = torch.arange(B, device=dev)[None, :, None]
    a = ext[b, other, MAX_SAMPLES + i - setup["ka"][None]]
    if not bool(setup["t1718"].any()):
        return a
    older = ext[b, chan, MAX_SAMPLES - 2 + i]
    s = (setup["coef_a"][None, :, None] * a -
         setup["coef_b"][None, :, None] * older)
    return s >> setup["shift"][None, :, None]


def run_pass_chain_plain(x, meta, chain, weights, samples):
    """plain torch version, on any device: the encode pass chains of a
    batch (pack_blocks); returns (out int64 [total] in x's layout, the
    final weights [B, MAX_PASSES, 2] and the new stored samples [B,
    MAX_PASSES, 2, MAX_SAMPLES]; passes past a block's count keep
    their inputs)"""
    _check_args(x, meta, chain, weights, samples)
    lanes = _Lanes(x, meta)
    (B, N) = (lanes.B, lanes.N)
    cur = lanes.gather(x)                                  # [N, B, 2]
    w_out = weights.clone()
    s_out = samples.clone()
    steps = torch.arange(N, device=x.device)[:, None, None]
    live = steps < lanes.n[None, :, None]
    c512 = torch.full((B, 2), 512, dtype=torch.int64, device=x.device)
    P = int(lanes.passes.max()) if B else 0
    for p in range(P):
        st = _pass_setup(lanes, chain, samples, p)
        ext = torch.cat([st["prefix"], cur.permute(1, 2, 0)], dim=2)
        src = _source(ext, st, N).contiguous()
        ds = torch.where(live & st["active"][None, :, None],
                         st["delta"][None, :, None] * torch.sign(src), 0)
        w = weights[:, p].clone()
        res = torch.empty_like(cur)
        clamp = bool((st["neg"] & st["active"]).any())
        for i in range(N):
            r = torch.addcmul(c512, w, src[i])
            r >>= 10
            torch.sub(cur[i], r, out=res[i])
            w.addcmul_(ds[i], torch.sign(res[i]))
            if clamp:
                torch.clamp(w, st["lo"], st["hi"], out=w)
        act = st["active"]
        cur = torch.where(act[None, :, None], res, cur)
        w_out[:, p] = torch.where(act[:, None], w, weights[:, p])
        # the new stored samples: the last span(term) of the stored
        # samples followed by the outputs, newest first for 17/18
        own = torch.where(st["neg"][:, None, None], 0, st["prefix"])
        seq = torch.cat([own, res.permute(1, 2, 0)], dim=2)
        k = torch.arange(MAX_SAMPLES, device=x.device)[None, None, :]
        n = lanes.n[:, None, None]
        t = st["term"][:, None, None]
        t1718 = st["t1718"][:, None, None]
        pos = torch.where(t1718, MAX_SAMPLES + n - 1 - k,
                          MAX_SAMPLES + n - t + k)
        keep = torch.where(t1718, k < 2, k < t)
        new = torch.where(keep, seq.gather(2, pos.clamp(0, MAX_SAMPLES + N - 1)
                                           .expand(-1, 2, -1)), 0)
        upd = (act & ~st["neg"])[:, None, None]
        s_out[:, p] = torch.where(upd, new, samples[:, p])
    return (lanes.scatter(x, cur), w_out, s_out)


def run_dec_chain_plain(x, meta, chain, weights, samples):
    """plain torch version, on any device: the decode pass chains of a
    batch (pack_blocks); returns out int64 [total] in x's layout"""
    _check_args(x, meta, chain, weights, samples)
    lanes = _Lanes(x, meta)
    (B, N) = (lanes.B, lanes.N)
    dev = x.device
    cur = lanes.gather(x)                                  # [N, B, 2]
    steps = torch.arange(N, device=dev)[:, None, None]
    live = steps < lanes.n[None, :, None]
    c512 = torch.full((B, 2), 512, dtype=torch.int64, device=dev)
    b = torch.arange(B, device=dev)[:, None]
    chan = torch.arange(2, device=dev)[None, :]
    P = int(lanes.passes.max()) if B else 0
    width = MAX_SAMPLES + N
    for p in range(P):
        st = _pass_setup(lanes, chain, samples, p)
        # the outputs after their stored prefix, filled as they come
        ext = torch.zeros((B, 2, width), dtype=torch.int64, device=dev)
        ext[:, :, :MAX_SAMPLES] = st["prefix"]
        flat = ext.view(-1)
        other = torch.where(st["neg"][:, None], 1 - chan, chan)
        idx_a = ((b * 2 + other) * width + MAX_SAMPLES
                 - st["ka"])[None] + steps[:, :, :1]
        idx_b = ((b * 2 + chan) * width + MAX_SAMPLES - 2)[None] + \
            steps[:, :, :1]
        dx = torch.where(live & st["active"][None, :, None],
                         st["delta"][None, :, None] * torch.sign(cur), 0)
        w = weights[:, p].clone()
        # lanes whose source is the other channel's output of this step
        second = st["neg"][:, None] & (st["ka"] == 0)
        has_second = bool(second.any())
        has_1718 = bool(st["t1718"].any())
        clamp = bool((st["neg"] & st["active"]).any())
        coef_a = st["coef_a"][:, None].expand(-1, 2)
        coef_b = st["coef_b"][:, None].expand(-1, 2)
        shift = st["shift"][:, None].expand(-1, 2)
        column = ext[:, :, MAX_SAMPLES:]
        for i in range(N):
            src = torch.take(flat, idx_a[i])
            if has_1718:
                src = (coef_a * src - coef_b * torch.take(flat, idx_b[i])
                       ) >> shift
            y = torch.addcmul(c512, w, src)
            y >>= 10
            y += cur[i]
            if has_second:
                src = torch.where(second, y.flip(1), src)
                y2 = torch.addcmul(c512, w, src)
                y2 >>= 10
                y2 += cur[i]
                y = torch.where(second, y2, y)
            w.addcmul_(dx[i], torch.sign(src))
            if clamp:
                torch.clamp(w, st["lo"], st["hi"], out=w)
            column[:, :, i] = y
        cur = torch.where(st["active"][None, :, None],
                          column.permute(2, 0, 1), cur)
    return lanes.scatter(x, cur)


def _launch(name, kernel_fn, x, meta, chain, weights, samples, *outs):
    if x.device.type != "cuda":
        raise ValueError("%s: unsupported device %s" % (name, x.device))
    _check_args(x, meta, chain, weights, samples)
    if meta.shape[0]:
        kernel_fn(x.contiguous(), meta.contiguous(), chain.contiguous(),
                  weights.contiguous(), samples.contiguous(), *outs)
        return True
    return False


def run_pass_chain(x, meta, chain, weights, samples):
    """the encode pass chains of a batch

    Same contract as run_pass_chain_plain.  A CPU tensor runs the plain
    version; a CUDA tensor launches the hand-written kernel
    (csrc/wv_chain.cu, a warp a pass) on the current stream,
    without synchronising, and counts the launch in
    ``run_pass_chain.launches``.  Any other device raises."""
    if x.device.type == "cpu":
        return run_pass_chain_plain(x, meta, chain, weights, samples)
    from .. import kernels
    out = torch.empty_like(x)
    w_out = torch.empty_like(weights)
    s_out = torch.empty_like(samples)
    if _launch("run_pass_chain", kernels.wv_corr, x, meta, chain, weights,
               samples, out, w_out, s_out):
        with COUNT_LOCK:
            run_pass_chain.launches += 1
    return (out, w_out, s_out)


run_pass_chain.launches = 0


def run_dec_chain(x, meta, chain, weights, samples):
    """the decode pass chains of a batch

    Same contract as run_dec_chain_plain.  A CPU tensor runs the plain
    version; a CUDA tensor launches the hand-written kernel
    (csrc/wv_chain.cu, a warp a pass) on the current stream,
    without synchronising, and counts the launch in
    ``run_dec_chain.launches``.  Any other device raises."""
    if x.device.type == "cpu":
        return run_dec_chain_plain(x, meta, chain, weights, samples)
    from .. import kernels
    out = torch.empty_like(x)
    if _launch("run_dec_chain", kernels.wv_decorr, x, meta, chain, weights,
               samples, out):
        with COUNT_LOCK:
            run_dec_chain.launches += 1
    return out


run_dec_chain.launches = 0
