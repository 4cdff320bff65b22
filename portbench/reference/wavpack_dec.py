"""Plain WavPack 4 block decoder (Python integers and NumPy), beside the
plain encoder in ``wavpack_enc``: one lossless integer block of 1-2
channels decoded from its own bytes alone, since a block stores the
state it starts from.  The sub-block walk, the entropy decoder, the
decorrelation passes undone in reverse order (positive terms), joint
stereo, the sample CRC, the wasted low bits and false stereo.  It
favours clarity over speed.  ``check_run`` is the benchmark's check of a
run of an encoded stream's blocks against the plain encoder and this
decoder, in the reference's worker processes.
"""

from __future__ import annotations

import struct

import numpy as np

from . import wavpack_enc as enc
from .wavpack_enc import (BITSTREAM, INT32_INFO, header, sample_crc,
                          stored_state, sub_blocks)

# what a block the reference cannot read raises
MALFORMED = (ValueError, KeyError, IndexError, struct.error)


class BitReader:
    """an LSB-first bit reader over bytes"""

    def __init__(self, data):
        self.data = bytes(data)
        self.end = 8 * len(self.data)
        self.pos = 0

    def bits(self, count):
        if count == 0:
            return 0
        at = self.pos
        if at + count > self.end:
            raise ValueError("read past the end of the bitstream")
        first = at >> 3
        chunk = int.from_bytes(self.data[first:((at + count + 7) >> 3)],
                               "little")
        self.pos = at + count
        return (chunk >> (at & 7)) & ((1 << count) - 1)

    def ones(self):
        """the count of 1 bits before the next 0 bit"""
        count = 0
        while True:
            at = self.pos
            if at >= self.end:
                raise ValueError("unterminated unary code")
            first = at >> 3
            chunk = int.from_bytes(self.data[first:first + 8], "little") \
                >> (at & 7)
            avail = min(self.end - at, 64 - (at & 7))
            run = (chunk ^ (chunk + 1)).bit_length() - 1
            if run < avail:
                self.pos = at + run + 1
                return count + run
            count += avail
            self.pos = at + avail

    def gamma(self):
        t = self.ones()
        return (1 << (t - 1)) + self.bits(t - 1) if t > 1 else t


def read_residual(reader, last_u, med):
    """one residual against the medians ``med`` (adapted in place) and
    its unary prefix, None where it had none"""
    if last_u is None or last_u % 2 == 1:
        u = reader.ones()
        if u == 16:
            u += reader.gamma()
        m = u // 2 + (0 if last_u is None else 1)
    else:
        (u, m) = (None, 0)
    (m0, m1, m2) = ((med[0] >> 4) + 1, (med[1] >> 4) + 1,
                    (med[2] >> 4) + 1)
    if m == 0:
        (base, span_) = (0, m0 - 1)
        med[0] -= ((med[0] + 126) >> 7) * 2
    else:
        med[0] += ((med[0] + 128) >> 7) * 5
        if m == 1:
            (base, span_) = (m0, m1 - 1)
            med[1] -= ((med[1] + 62) >> 6) * 2
        else:
            med[1] += ((med[1] + 64) >> 6) * 5
            (base, span_) = (m0 + m1 + (m - 2) * m2, m2 - 1)
            if m == 2:
                med[2] -= ((med[2] + 30) >> 5) * 2
            else:
                med[2] += ((med[2] + 32) >> 5) * 5
    if span_:
        p = span_.bit_length() - 1
        e = (1 << (p + 1)) - span_ - 1
        r = reader.bits(p)
        value = base + (r if r < e else 2 * r - e + reader.bits(1))
    else:
        value = base
    return (-value - 1 if reader.bits(1) else value, u)


def read_residuals(data, n, cc, medians):
    """the residuals of a bitstream sub-block, n a channel"""
    reader = BitReader(data)
    out = [[] for _ in range(cc)]
    u = None
    i = 0
    total = n * cc
    while i < total:
        if u is None and medians[0][0] < 2 and medians[1][0] < 2:
            zeros = reader.gamma()
            if zeros:
                for _ in range(min(zeros, total - i)):
                    out[i % cc].append(0)
                    i += 1
                medians[0][:] = [0, 0, 0]
                medians[1][:] = [0, 0, 0]
            if i >= total:
                break
        (r, u) = read_residual(reader, u, medians[i % cc])
        out[i % cc].append(r)
        i += 1
    return out


def undo_pass(res, term, delta, weight, start):
    """a pass of ``term`` undone over one channel's residuals"""
    out = []
    push = out.append
    if term in (17, 18):
        (s1, s2) = start
        for r in res:
            pred = 2 * s1 - s2 if term == 17 else (3 * s1 - s2) >> 1
            v = ((weight * pred + 512) >> 10) + r
            push(v)
            if pred and r:
                weight += delta if (pred ^ r) >= 0 else -delta
            (s1, s2) = (v, s1)
        return out
    history = list(start)
    for (i, r) in enumerate(res):
        s = history[i]
        v = ((weight * s + 512) >> 10) + r
        push(v)
        history.append(v)
        if s and r:
            weight += delta if (s ^ r) >= 0 else -delta
    return out


def decode_block(block):
    """a block's samples, int64 [n, channels]; ValueError where its CRC
    or its layout is wrong"""
    h = header(block)
    n = h["samples"]
    channels = 1 if h["mono"] else 2
    (cc, passes, medians) = stored_state(block)
    medians = [list(m) for m in medians] + [[0, 0, 0]] * (2 - cc)
    subs = sub_blocks(block)
    if BITSTREAM not in subs:
        raise ValueError("no bitstream sub-block")
    x = read_residuals(subs[BITSTREAM], n, cc, medians)
    for (term, delta, weights, start) in reversed(passes):
        x = [undo_pass(x[c], term, delta, weights[c], start[c])
             for c in range(cc)]
    if cc == 2 and h["joint"]:
        right = [side - (mid >> 1) for (mid, side) in zip(*x)]
        x = [[mid + r for (mid, r) in zip(x[0], right)], right]
    if sample_crc(x) != h["crc"]:
        raise ValueError("block CRC mismatch")
    wasted = subs[INT32_INFO][1] if h["wasted"] else 0
    out = np.asarray(x, dtype=np.int64).T << wasted
    if h["false_stereo"] or (cc == 1 and channels == 2):
        out = np.repeat(out, 2, axis=1)
    return out


def check_run(job):
    """the plain reference's check of a run of a stream's blocks s..j:
    each encoded again from the state the stream stores in block s (the
    initial state where s is the stream's first) and compared byte for
    byte, the state the reference ends block j in compared with the one
    the block after it stores, and each of those blocks decoded and
    compared with the input.  ``job`` is (the input's int frames of the
    blocks, the blocks s..j, the block after j or None, whether s is the
    stream's first, the stream's frames, the sample rate, the bits, the
    passes); returns the counts"""
    (samples, run, after, fresh, total, rate, bits, recipe) = job
    samples = np.asarray(samples, dtype=np.int64)
    out = dict(blocks_checked=0, blocks_differing=0, states_checked=0,
               states_differing=0, samples_checked=0, samples_wrong=0)
    base = header(run[0])["index"]
    try:
        state = enc.new_state() if fresh else enc.resume(run[0])
    except MALFORMED:
        state = None
    for block in run:
        h = header(block)
        at = h["index"] - base
        out["blocks_checked"] += 1
        if state is None:
            out["blocks_differing"] += 1
            continue
        mine = enc.encode_block(samples[at:at + h["samples"]], state,
                                h["index"], total, rate, bits, recipe,
                                first=h["index"] == 0)
        out["blocks_differing"] += mine != block
    if after is not None:
        out["states_checked"] += 1
        try:
            stored = enc.stored_state(after)
        except MALFORMED:
            stored = None
        out["states_differing"] += state is None or \
            enc.state_value(state) != stored
    for block in run + ([after] if after is not None else []):
        h = header(block)
        at = h["index"] - base
        want = samples[at:at + h["samples"]]
        out["samples_checked"] += want.size
        try:
            got = decode_block(block)
        except MALFORMED:
            out["samples_wrong"] += want.size
            continue
        out["samples_wrong"] += int(np.count_nonzero(got != want)) \
            if got.shape == want.shape else want.size
    return out
