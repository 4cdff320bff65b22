"""Plain WavPack 4 encoder (Python integers and NumPy) for the lossless
``standard`` mode of 1-2 channel integer PCM: 44,100-frame blocks, five
decorrelation passes, written from David Bryant's "WavPack 4 File /
Block Format" and the semantics of Python Audio Tools' pure-Python
encoder (``py_encoders/wavpack.py``).  It favours clarity over speed
and is frozen: the program is never pointed at it.

A block: the false-stereo, wasted-bits and joint-stereo decisions and
the sample CRC; each pass a sign-LMS filter (term, delta, a weight a
channel and the samples it starts from); the adaptive Golomb-style
entropy coder over the interleaved residuals; the sub-blocks that
store the state each block starts from (terms, weights, samples,
entropy medians).  State carries from block to block, rounded through
its stored form, so that a block can be encoded again from what the
stream stores in it (``resume``).

Where the encoder chooses what the block format leaves open, or goes
its own way, it follows the reference encoder:

* a pass's samples for the next block are the last outputs of the pass
  (its residuals), newest first for terms 17 and 18, not its last
  inputs; any decoder reads them back, since both sides start a block
  from the stored values;
* the decorrelation terms sub-block lists the passes in the order they
  are applied, the weights and samples sub-blocks likewise;
* the CRC is taken over the samples after the false-stereo and
  wasted-bits reductions and before joint stereo; the maximum
  magnitude before the wasted-bits shift;
* the zero-run mode of the entropy coder is entered only when the first
  median of both channels is below 2, in a one-channel block too;
* a pass's parameters start afresh (weights and samples 0) when the
  coded channel count changes (a false-stereo block after a stereo one,
  or back); the entropy medians carry on;
* the RIFF header of the first block holds the stream's final sizes.

Only the passes of the positive terms (1-8, 17, 18) are written here,
which are all that the ``standard`` recipe uses; 8- to 16-bit PCM at a
standard sample rate, one or two channels.
"""

from __future__ import annotations

import struct

import numpy as np

WAVE_HEADER, TERMS, WEIGHTS, SAMPLES, ENTROPY, MD5 = 0x1, 0x2, 0x3, 0x4, \
    0x5, 0x6
INT32_INFO, BITSTREAM = 0x9, 0xA
NONDECODER = 0x20

SAMPLE_RATES = (6000, 8000, 9600, 11025, 12000, 16000, 22050, 24000, 32000,
                44100, 48000, 64000, 88200, 96000, 192000)

# the standard mode's passes, (term, delta), in the order they run
STANDARD = ((3, 2), (17, 2), (2, 2), (18, 2), (18, 2))

# the format's exponential and logarithm curves, 8 fractional bits
EXP2 = [int(v) for v in np.round(256.0 * np.exp2(np.arange(256) / 256.0))]
LOG2 = [int(v) for v in np.round(256.0 * np.log2(1.0 + np.arange(256)
                                                 / 256.0))]


def exp2(v):
    """a stored log-domain value as a linear one"""
    if v < 0:
        return -exp2(-v)
    (whole, frac) = (v >> 8, v & 0xFF)
    return EXP2[frac] >> (9 - whole) if whole <= 9 else \
        EXP2[frac] << (whole - 9)


def log2(v):
    """a linear value as a log-domain one (signed)"""
    if v == 0:
        return 0
    a = abs(v)
    a += a >> 9
    c = a.bit_length()
    frac = (a << (9 - c)) if c <= 9 else (a >> (c - 9))
    out = (c << 8) + LOG2[frac & 0xFF]
    return out if v > 0 else -out


def store_weight(w):
    """a weight as its stored signed byte"""
    w = min(max(w, -1024), 1024)
    if w > 0:
        w -= (w + 64) >> 7
    return (w + 4) >> 3


def restore_weight(b):
    """a stored signed byte as a weight"""
    w = b << 3
    return w + ((w + 64) >> 7) if b > 0 else w


def round_sample(v):
    """a sample as its stored form gives it back"""
    return exp2(log2(v))


def span(term):
    """the samples a pass of this term starts from, a channel"""
    return 2 if term in (17, 18) else term


class BitWriter:
    """an LSB-first bit writer"""

    def __init__(self):
        self.out = bytearray()
        self.acc = 0
        self.n = 0

    def bits(self, count, value):
        self.acc |= value << self.n
        self.n += count
        while self.n >= 8:
            self.out.append(self.acc & 0xFF)
            self.acc >>= 8
            self.n -= 8

    def ones(self, count):
        """``count`` 1 bits then a 0"""
        while count >= 24:
            self.bits(24, 0xFFFFFF)
            count -= 24
        self.bits(count + 1, (1 << count) - 1)

    def gamma(self, v):
        """an Elias gamma code: the bit length in unary, then the bits
        below the top one"""
        if v <= 1:
            self.ones(v)
        else:
            t = v.bit_length()
            self.ones(t)
            self.bits(t - 1, v & ((1 << (t - 1)) - 1))

    def data(self):
        return bytes(self.out) + (bytes([self.acc]) if self.n else b"")


def correlate(x, term, delta, weight, start):
    """one pass of ``term`` over one channel's series ``x``, from
    ``weight`` and the samples ``start``; returns (the residuals, the
    final weight, the samples for the next block before rounding)"""
    out = []
    push = out.append
    if term in (17, 18):
        (s1, s2) = start          # the newest sample first
        for v in x:
            pred = 2 * s1 - s2 if term == 17 else (3 * s1 - s2) >> 1
            r = v - ((weight * pred + 512) >> 10)
            push(r)
            if pred and r:
                weight += delta if (pred ^ r) >= 0 else -delta
            (s1, s2) = (v, s1)
        return (out, weight, out[::-1][:2])
    history = list(start) + list(x)     # oldest first
    for (i, v) in enumerate(x):
        s = history[i]
        r = v - ((weight * s + 512) >> 10)
        push(r)
        if s and r:
            weight += delta if (s ^ r) >= 0 else -delta
    return (out, weight, out[-term:])


class Coder:
    """the entropy coder of one block: the interleaved residuals of 1-2
    channels against each channel's three adaptive medians"""

    def __init__(self, medians):
        self.w = BitWriter()
        self.medians = medians
        # the residual not yet written, [zeros before it or None, its
        # bucket m (None for a zero run), offset, span, sign], or None
        self.held = None
        self.u_prev = None      # the unary prefix written before it

    @staticmethod
    def bucket(u, med):
        """the residual magnitude ``u``'s bucket m, its offset and span
        in the bucket, with the medians ``med`` adapted"""
        (m0, m1, m2) = ((med[0] >> 4) + 1, (med[1] >> 4) + 1,
                        (med[2] >> 4) + 1)
        if u < m0:
            med[0] -= ((med[0] + 126) >> 7) * 2
            return (0, u, m0 - 1)
        med[0] += ((med[0] + 128) >> 7) * 5
        if u - m0 < m1:
            med[1] -= ((med[1] + 62) >> 6) * 2
            return (1, u - m0, m1 - 1)
        med[1] += ((med[1] + 64) >> 6) * 5
        if u - m0 - m1 < m2:
            med[2] -= ((med[2] + 30) >> 5) * 2
            return (2, u - m0 - m1, m2 - 1)
        med[2] += ((med[2] + 32) >> 5) * 5
        m = (u - m0 - m1) // m2 + 2
        return (m, u - m0 - m1 - (m - 2) * m2, m2 - 1)

    def flush(self, m_next):
        """writes the held residual, now that the next one's bucket
        ``m_next`` (0 at the end or before a zero run) is known; its
        unary prefix, or None when the held one had none"""
        held = self.held
        w = self.w
        if held is None:
            return None
        (zeros, m, offset, span_, sign) = held
        if zeros is not None:
            w.gamma(zeros)
        if m is None:
            return None
        even_prev = self.u_prev is not None and self.u_prev % 2 == 0
        odd_prev = self.u_prev is not None and self.u_prev % 2 == 1
        if m > 0:
            u = 2 * m + (1 if m_next > 0 else 0) if not odd_prev else \
                2 * m - (1 if m_next > 0 else 2)
        else:
            u = (1 if m_next > 0 else 0) if not even_prev else None
        if u is not None:
            if u < 16:
                w.ones(u)
            else:
                w.ones(16)
                w.gamma(u - 16)
        if span_ > 0:
            p = span_.bit_length() - 1
            e = (1 << (p + 1)) - span_ - 1
            if offset < e:
                w.bits(p, offset)
            else:
                w.bits(p, (offset + e) >> 1)
                w.bits(1, (offset + e) & 1)
        w.bits(1, sign)
        return u

    def code(self, r, med):
        """the held residual's tuple for residual ``r``"""
        (u, sign) = (r, 0) if r >= 0 else (-r - 1, 1)
        (m, offset, span_) = self.bucket(u, med)
        return [None, m, offset, span_, sign]

    def encode(self, channels):
        medians = self.medians
        cc = len(channels)
        n = len(channels[0])
        for i in range(n * cc):
            c = i % cc
            r = channels[c][i // cc]
            held = self.held
            run_mode = (medians[0][0] < 2 and medians[1][0] < 2 and
                        (held is None or held[1] is None or
                         (held[1] == 0 and self.u_prev is not None and
                          self.u_prev % 2 == 0)))
            if run_mode and held is not None and held[1] is None and \
                    held[0] is not None:
                # inside a run of zeros
                if r == 0:
                    held[0] += 1
                else:
                    new = self.code(r, medians[c])
                    new[0] = held[0]
                    self.held = new
            elif run_mode and r == 0:
                self.u_prev = self.flush(0)
                medians[0][:] = [0, 0, 0]
                medians[1][:] = [0, 0, 0]
                self.held = [1, None, None, None, None]
            else:
                new = self.code(r, medians[c])
                new[0] = 0 if run_mode else None
                self.u_prev = self.flush(new[1])
                self.held = new
        self.flush(0)
        return self.w.data()


def sub_block(function, data, nondecoder=False):
    """a metadata sub-block: its id byte, its size in 16-bit words (one
    byte, or three past 255 words) and its data padded to a word"""
    odd = len(data) % 2
    words = (len(data) + odd) // 2
    head = function | (NONDECODER if nondecoder else 0) | (odd << 6)
    size = bytes([words]) if len(data) <= 510 else words.to_bytes(3, "little")
    if len(data) > 510:
        head |= 0x80
    return bytes([head]) + size + bytes(data) + (b"\0" if odd else b"")


def block_header(body_size, total, index, samples, bits, mono, joint,
                 wasted, magnitude, rate, false_stereo, crc):
    flags = ((bits // 8 - 1) | (mono << 2) | (joint << 4) |
             ((1 if wasted else 0) << 8) | (1 << 11) | (1 << 12) |
             (magnitude << 18) | (SAMPLE_RATES.index(rate) << 23) |
             (false_stereo << 30))
    return struct.pack("<4sIHBBIIIII", b"wvpk", body_size + 24, 0x410, 0, 0,
                       total, index, samples, flags, crc)


def riff_header(channels, rate, bits, frames):
    """the RIFF WAVE header of a stream of ``frames`` frames: its fmt
    chunk (plain PCM) and the data chunk's head"""
    align = channels * (bits // 8)
    fmt = struct.pack("<HHIIHH", 1, channels, rate, rate * align, align, bits)
    data = frames * align
    return (b"RIFF" + struct.pack("<I", 4 + 8 + len(fmt) + 8 + data) +
            b"WAVE" + b"fmt " + struct.pack("<I", len(fmt)) + fmt + b"data" +
            struct.pack("<I", data))


def new_state():
    """the encoder's state before the first block: no passes made yet
    (coded channel count 0), the entropy medians 0"""
    return {"coded": 0, "passes": [], "medians": [[0, 0, 0], [0, 0, 0]]}


def sample_crc(channels):
    crc = 0xFFFFFFFF
    for frame in zip(*channels):
        for s in frame:
            crc = (3 * crc + s) & 0xFFFFFFFF
    return crc


def encode_block(samples, state, index, total, rate, bits, recipe=STANDARD,
                 first=False):
    """one block of int ``samples`` [n, channels] from ``state`` (changed
    in place to the state after it): its bytes.  ``index`` is the
    block's first frame in the stream, ``total`` the stream's frames;
    the stream's first block (``first``) stores the RIFF header"""
    samples = np.asarray(samples, dtype=np.int64)
    (n, channels) = samples.shape
    if channels not in (1, 2) or bits > 16 or rate not in SAMPLE_RATES:
        raise ValueError("not a stream this encoder writes")
    cols = [samples[:, c] for c in range(channels)]
    false_stereo = channels == 2 and bool(np.array_equal(cols[0], cols[1]))
    coded = cols[:1] if channels == 1 or false_stereo else cols
    magnitude = max(int(np.abs(a).max()).bit_length() for a in coded)
    nonzero = np.concatenate([a[a != 0] for a in coded])
    wasted = 0
    if nonzero.size:
        low = int(np.bitwise_or.reduce(nonzero))
        wasted = (low & -low).bit_length() - 1
    shifted = [(a >> wasted).tolist() for a in coded]
    crc = sample_crc(shifted)
    if len(shifted) == 2:
        x = [[a - b for (a, b) in zip(*shifted)],
             [(a + b) >> 1 for (a, b) in zip(*shifted)]]
    else:
        x = shifted
    cc = len(x)
    if state["coded"] != cc:
        state["coded"] = cc
        state["passes"] = [[t, d, [0] * cc,
                            [[0] * span(t) for _c in range(cc)]]
                           for (t, d) in recipe]
    passes = state["passes"]
    medians = state["medians"]

    body = bytearray()
    if first:
        body += sub_block(WAVE_HEADER, riff_header(channels, rate, bits,
                                                   total), True)
    if passes:
        body += sub_block(TERMS, bytes((t + 5) | (d << 5)
                                       for (t, d, _w, _s) in passes))
        body += sub_block(WEIGHTS, bytes(store_weight(w) & 0xFF
                                         for p in passes for w in p[2]))
        values = []
        for (t, _d, _w, start) in passes:
            if t in (17, 18):
                values += [v for c in range(cc) for v in start[c]]
            else:
                values += [start[c][k] for k in range(t) for c in range(cc)]
        body += sub_block(SAMPLES, struct.pack("<%dh" % len(values),
                                               *[log2(v) for v in values]))
    if wasted:
        body += sub_block(INT32_INFO, bytes([0, wasted, 0, 0]))
    body += sub_block(ENTROPY, struct.pack(
        "<%dH" % (3 * cc), *[log2(e) & 0xFFFF
                             for ch in medians[:cc] for e in ch]))

    for p in passes:
        (term, delta, weights, start) = p
        after = []
        for c in range(cc):
            (x[c], weights[c], tail) = correlate(x[c], term, delta,
                                                 weights[c], start[c])
            after.append([round_sample(v) for v in tail])
        p[2] = [restore_weight(store_weight(w)) for w in weights]
        p[3] = after
    body += sub_block(BITSTREAM, Coder(medians).encode(x))
    state["medians"] = [[round_sample(e) for e in ch] for ch in medians]
    return block_header(len(body), total, index, n, bits, 2 - channels,
                        int(cc == 2), wasted, magnitude, rate,
                        int(false_stereo), crc) + bytes(body)


def final_block(md5, total, rate, bits):
    """the stream's last block: no samples, the MD5 sub-block of the PCM
    (little-endian, signed above 8 bits)"""
    body = sub_block(MD5, md5, True)
    return block_header(len(body), total, 0xFFFFFFFF, 0, bits, 1, 0, 0, 0,
                        rate, 0, 0xFFFFFFFF) + body


def encode_stream(samples, rate, bits, block_size=44100, recipe=STANDARD):
    """a whole stream's bytes, for the tests: every block from the
    initial state, then the MD5 block"""
    import hashlib
    samples = np.asarray(samples)
    total = samples.shape[0]
    state = new_state()
    out = bytearray()
    for at in range(0, total, block_size):
        out += encode_block(samples[at:at + block_size], state, at, total,
                            rate, bits, recipe, first=at == 0)
    out += final_block(hashlib.md5(pcm_bytes(samples, bits)).digest(),
                       total, rate, bits)
    return bytes(out)


def pcm_bytes(samples, bits):
    """PCM as the MD5 sub-block sums it: interleaved little-endian,
    unsigned at 8 bits"""
    samples = np.asarray(samples, dtype=np.int64)
    if bits == 8:
        return (samples + 128).astype(np.uint8).tobytes()
    width = bits // 8
    flat = samples.reshape(-1) & ((1 << bits) - 1)
    out = np.zeros((flat.size, width), dtype=np.uint8)
    for k in range(width):
        out[:, k] = (flat >> (8 * k)) & 0xFF
    return out.tobytes()


# ---------------------------------------------------------------------------
# reading what a stream stores

def split_blocks(data):
    """a stream's blocks as a list of bytes"""
    out = []
    at = 0
    while at < len(data):
        if data[at:at + 4] != b"wvpk":
            raise ValueError("no block at byte %d" % (at,))
        size = struct.unpack_from("<I", data, at + 4)[0] + 8
        out.append(bytes(data[at:at + size]))
        at += size
    return out


def header(block):
    """the block header's fields that the check and the decoder read"""
    (_id, _size, _version, _track, _index, _total, index, samples, flags,
     crc) = struct.unpack_from("<4sIHBBIIIII", block, 0)
    return {"index": index, "samples": samples, "crc": crc,
            "mono": (flags >> 2) & 1, "joint": (flags >> 4) & 1,
            "wasted": (flags >> 8) & 1, "false_stereo": (flags >> 30) & 1}


def sub_blocks(block):
    """{id: data} of a block's sub-blocks, the id a function with the
    nondecoder flag (0x20) where it is set"""
    out = {}
    at = 32
    while at < len(block):
        head = block[at]
        if head & 0x80:
            words = int.from_bytes(block[at + 1:at + 4], "little")
            at += 4
        else:
            words = block[at + 1]
            at += 2
        size = 2 * words - ((head >> 6) & 1)
        out[head & 0x3F] = bytes(block[at:at + size])
        at += 2 * words
    return out


def stored_state(block):
    """the state a block stores, as a value to compare: its coded
    channel count, each pass's (term, delta, weights, samples) as the
    decoder restores them, and the coded channels' medians"""
    h = header(block)
    cc = 1 if h["mono"] or h["false_stereo"] else 2
    subs = sub_blocks(block)
    codes = subs.get(TERMS, b"")
    terms = [((b & 0x1F) - 5, b >> 5) for b in codes]
    raw_w = [b - 256 if b >= 128 else b for b in subs.get(WEIGHTS, b"")]
    logs = list(struct.unpack("<%dh" % (len(subs.get(SAMPLES, b"")) // 2),
                              subs.get(SAMPLES, b"")))
    passes = []
    for (k, (t, d)) in enumerate(terms):
        weights = [restore_weight(v) for v in raw_w[k * cc:(k + 1) * cc]]
        if t in (17, 18):
            take = [exp2(v) for v in logs[:2 * cc]]
            start = [take[2 * c:2 * c + 2] for c in range(cc)]
            logs = logs[2 * cc:]
        elif 1 <= t <= 8:
            take = [exp2(v) for v in logs[:t * cc]]
            start = [take[c::cc] for c in range(cc)]
            logs = logs[t * cc:]
        else:
            raise ValueError("a term this encoder does not write")
        passes.append((t, d, weights, start))
    ent = struct.unpack("<%dh" % (3 * cc), subs[ENTROPY][:6 * cc])
    medians = [[exp2(v) for v in ent[3 * c:3 * c + 3]] for c in range(cc)]
    return (cc, passes, medians)


def resumable(block):
    """whether a block stores the whole state the encoder starts it
    from: not where a stereo stream's block is coded as one channel
    (false stereo), which leaves the other channel's medians unstored"""
    h = header(block)
    return not h["false_stereo"]


def resume(block):
    """the encoder's state at the start of a resumable block, from what
    the block stores"""
    (cc, passes, medians) = stored_state(block)
    return {"coded": cc,
            "passes": [[t, d, list(w), [list(s) for s in start]]
                       for (t, d, w, start) in passes],
            "medians": [list(m) for m in medians] +
            [[0, 0, 0]] * (2 - len(medians))}


def state_value(state):
    """an encoder state as ``stored_state`` gives it"""
    cc = state["coded"]
    return (cc, [(t, d, list(w), [list(s) for s in start])
                 for (t, d, w, start) in state["passes"]],
            [list(m) for m in state["medians"][:cc]])
