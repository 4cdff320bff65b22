"""Plain FLAC decoder (Python integers and NumPy), written from the
public FLAC format: metadata blocks, the frame header with its CRC-8,
CONSTANT, VERBATIM, FIXED and LPC subframes, wasted bits, Rice
residuals with escape partitions, the stereo decorrelations and the
frame's CRC-16.  It favours clarity over speed.

``decode_frame(..., single=True)`` is the benchmark's control for the
decode cells: the same decoder with its LPC prediction summed in plain
float32, as a lower-precision synthesis would.
"""

from __future__ import annotations

import numpy as np

from .crc import crc8, crc16

STREAMINFO, SEEKTABLE = 0, 3

FIXED_COEFFS = {0: [], 1: [1], 2: [2, -1], 3: [3, -3, 1],
                4: [4, -6, 4, -1]}
SAMPLE_RATES = {1: 88200, 2: 176400, 3: 192000, 4: 8000, 5: 16000,
                6: 22050, 7: 24000, 8: 32000, 9: 44100, 10: 48000,
                11: 96000}
SAMPLE_SIZES = {1: 8, 2: 12, 4: 16, 5: 20, 6: 24, 7: 32}


class Bits:
    """an MSB-first bit reader over bytes"""

    def __init__(self, data):
        self.data = bytes(data)
        self.text = "".join(format(b, "08b") for b in self.data)
        self.pos = 0

    def read(self, n):
        if n == 0:
            return 0
        end = self.pos + n
        if end > len(self.text):
            raise ValueError("read past the end of the frame")
        value = int(self.text[self.pos:end], 2)
        self.pos = end
        return value

    def signed(self, n):
        value = self.read(n)
        return value - (1 << n) if n and value >> (n - 1) else value

    def unary(self):
        """the count of 0 bits before the next 1 bit"""
        one = self.text.find("1", self.pos)
        if one < 0:
            raise ValueError("unterminated unary code")
        count = one - self.pos
        self.pos = one + 1
        return count

    def align(self):
        self.pos = (self.pos + 7) & ~7




def parse_metadata(data):
    """(streaminfo dict, seektable list, offset of the first frame)"""
    if bytes(data[:4]) != b"fLaC":
        raise ValueError("no 'fLaC' marker")
    pos = 4
    info = None
    seektable = []
    last = False
    while not last:
        header = int.from_bytes(data[pos:pos + 4], "big")
        (last, kind, length) = (header >> 31, (header >> 24) & 0x7F,
                                header & 0xFFFFFF)
        body = bytes(data[pos + 4:pos + 4 + length])
        if kind == STREAMINFO:
            b = Bits(body)
            info = dict(minimum_block_size=b.read(16),
                        maximum_block_size=b.read(16),
                        minimum_frame_size=b.read(24),
                        maximum_frame_size=b.read(24),
                        sample_rate=b.read(20), channels=b.read(3) + 1,
                        bits_per_sample=b.read(5) + 1,
                        total_frames=b.read(36), md5=body[18:34])
        elif kind == SEEKTABLE:
            for i in range(0, length - length % 18, 18):
                seektable.append((int.from_bytes(body[i:i + 8], "big"),
                                  int.from_bytes(body[i + 8:i + 16], "big"),
                                  int.from_bytes(body[i + 16:i + 18], "big")))
        pos += 4 + length
    if info is None:
        raise ValueError("no STREAMINFO block")
    return (info, seektable, pos)


def _utf8(bits):
    first = bits.read(8)
    if first < 0x80:
        return first
    extra = 0
    mask = 0x40
    while first & mask:
        extra += 1
        mask >>= 1
    value = first & (mask - 1)
    for _ in range(extra):
        value = (value << 6) | (bits.read(8) & 0x3F)
    return value


def _residuals(bits, order, n):
    method = bits.read(2)
    if method > 1:
        raise ValueError("reserved residual coding method")
    (pbits, escape) = (4, 15) if method == 0 else (5, 31)
    porder = bits.read(4)
    out = []
    psize = n >> porder
    for p in range(1 << porder):
        count = psize - order if p == 0 else psize
        k = bits.read(pbits)
        if k == escape:
            width = bits.read(5)
            out.extend(bits.signed(width) for _ in range(count))
            continue
        for _ in range(count):
            u = (bits.unary() << k) | bits.read(k)
            out.append((u >> 1) ^ -(u & 1))
    return out


def _restore(warmup, residuals, coeffs, shift, single):
    """warmup followed by the residuals run through the predictor"""
    s = list(warmup)
    order = len(coeffs)
    if single:
        q32 = [np.float32(c) for c in coeffs]
        scale = np.float32(2.0 ** -shift)
        for r in residuals:
            acc = np.float32(0.0)
            for j in range(order):
                acc = np.float32(acc + q32[j] * np.float32(s[-1 - j]))
            s.append(r + int(np.floor(acc * scale)))
        return s
    for r in residuals:
        pred = 0
        for j in range(order):
            pred += coeffs[j] * s[-1 - j]
        s.append(r + (pred >> shift))
    return s


def _subframe(bits, n, bps, single):
    if bits.read(1):
        raise ValueError("subframe padding bit set")
    kind = bits.read(6)
    wasted = 0
    if bits.read(1):
        wasted = bits.unary() + 1
    bps -= wasted
    if kind == 0:
        samples = [bits.signed(bps)] * n
    elif kind == 1:
        samples = [bits.signed(bps) for _ in range(n)]
    elif 8 <= kind <= 12:
        order = kind - 8
        warmup = [bits.signed(bps) for _ in range(order)]
        samples = _restore(warmup, _residuals(bits, order, n),
                           FIXED_COEFFS[order], 0, False)
    elif kind >= 32:
        order = kind - 31
        warmup = [bits.signed(bps) for _ in range(order)]
        precision = bits.read(4) + 1
        shift = bits.signed(5)
        if shift < 0:
            raise ValueError("negative LPC shift")
        coeffs = [bits.signed(precision) for _ in range(order)]
        samples = _restore(warmup, _residuals(bits, order, n), coeffs,
                           shift, single)
    else:
        raise ValueError("reserved subframe type %d" % (kind,))
    out = np.asarray(samples, dtype=np.int64)
    return out << wasted if wasted else out


def decode_frame(data, offset, info, single=False):
    """decodes the frame at ``offset`` of ``data``; returns (frame
    number, int64 samples [n, channels], offset of the next frame).
    Raises ValueError on a bad sync code or CRC, or a frame that does
    not parse."""
    try:
        return _decode_frame(data, offset, info, single)
    except (OverflowError, IndexError) as err:
        raise ValueError("corrupt frame at byte %d: %s" % (offset, err))


def frame_header(window, info):
    """the frame header at the start of ``window`` (bytes): (frame
    number, block size, channel assignment, bits a sample, the header's
    length in bytes with its CRC-8).  Raises ValueError on a bad sync
    code or CRC-8, or a reserved code."""
    bits = Bits(window)
    if bits.read(14) != 0x3FFE or bits.read(1):
        raise ValueError("bad frame sync")
    bits.read(1)                                   # blocking strategy
    (size_code, rate_code) = (bits.read(4), bits.read(4))
    assignment = bits.read(4)
    size_bits = bits.read(3)
    bits.read(1)
    number = _utf8(bits)
    if size_code == 1:
        n = 192
    elif 2 <= size_code <= 5:
        n = 576 << (size_code - 2)
    elif size_code == 6:
        n = bits.read(8) + 1
    elif size_code == 7:
        n = bits.read(16) + 1
    elif size_code >= 8:
        n = 256 << (size_code - 8)
    else:
        raise ValueError("reserved block size code")
    if rate_code == 12:
        bits.read(8)
    elif rate_code in (13, 14):
        bits.read(16)
    bps = SAMPLE_SIZES.get(size_bits, info["bits_per_sample"])
    header_end = bits.pos // 8
    if bits.read(8) != crc8(window[:header_end]):
        raise ValueError("frame header CRC-8 mismatch")
    return (number, n, assignment, bps, header_end + 1)


def _decode_frame(data, offset, info, single):
    window = bytes(data[offset:offset + 16 + (info["maximum_block_size"]
                                               * info["channels"] * 5)])
    try:
        (number, n, assignment, bps, length) = frame_header(window, info)
    except IndexError:
        raise ValueError("bad frame header at byte %d" % (offset,))
    bits = Bits(window)
    bits.pos = length * 8
    if assignment <= 7:
        channels = [_subframe(bits, n, bps, single)
                    for _ in range(assignment + 1)]
    elif assignment <= 10:
        side_first = assignment == 9
        a = _subframe(bits, n, bps + (1 if side_first else 0), single)
        b = _subframe(bits, n, bps + (0 if side_first else 1), single)
        if assignment == 8:
            channels = [a, a - b]
        elif assignment == 9:
            channels = [a + b, b]
        else:
            mid = (a << 1) | (b & 1)
            channels = [(mid + b) >> 1, (mid - b) >> 1]
    else:
        raise ValueError("reserved channel assignment")
    bits.align()
    end = bits.pos // 8
    if bits.read(16) != crc16(window[:end]):
        raise ValueError("frame CRC-16 mismatch")
    return (number, np.stack(channels, axis=1), offset + end + 2)


def find_frame(data, first, seektable, info, number):
    """the byte offset of frame ``number`` of a stream of fixed block
    size (``first`` the offset of its first frame): from the last
    seekpoint at or before the frame, the first frame sync whose header
    holds its CRC-8 and codes that number.  A sync pattern inside a
    frame that passes both would fail the frame's CRC-16 when decoded."""
    target = number * info["maximum_block_size"]
    at = first
    for (sample, offset, _n) in seektable:
        if sample <= target and sample != 0xFFFFFFFFFFFFFFFF:
            at = first + offset
    data = bytes(data)
    while True:
        at = data.find(b"\xff\xf8", at)
        if at < 0:
            raise ValueError("frame %d not found" % (number,))
        try:
            if frame_header(data[at:at + 16], info)[0] == number:
                return at
        except (ValueError, IndexError):
            pass
        at += 1


def decode_run(job):
    """(path, first frame number, frames, single): that many frames of
    the FLAC file from that frame on, as int64 samples [n, channels];
    a top-level function, so that worker processes can run it"""
    (path, number, count, single) = job
    with open(path, "rb") as f:
        data = f.read()
    (info, seektable, first) = parse_metadata(data)
    at = find_frame(data, first, seektable, info, number)
    pieces = []
    for _ in range(count):
        if at >= len(data):
            break
        (_number, samples, at) = decode_frame(data, at, info, single)
        pieces.append(samples)
    return np.concatenate(pieces, axis=0)


def decode_stream(data, single=False):
    """every frame of a FLAC stream in bytes: (streaminfo, int64
    samples [frames, channels])"""
    (info, _seektable, offset) = parse_metadata(data)
    pieces = []
    while offset < len(data):
        (_number, samples, offset) = decode_frame(data, offset, info,
                                                  single)
        pieces.append(samples)
    if not pieces:
        return (info, np.zeros((0, info["channels"]), dtype=np.int64))
    return (info, np.concatenate(pieces, axis=0))


def pcm_md5(samples, bits_per_sample):
    """FLAC's MD5 of int samples [frames, channels]: little-endian
    signed bytes of bits_per_sample // 8 each, interleaved"""
    import hashlib
    width = bits_per_sample // 8
    x = np.ascontiguousarray(samples, dtype="<i4").view(np.uint8)
    x = x.reshape(-1, 4)[:, :width]
    return hashlib.md5(np.ascontiguousarray(x).tobytes()).digest()
