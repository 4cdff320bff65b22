"""The port's bitstream API against the reference's
(``audiotools_tpu.bitstream``), bit for bit.

Random programs of writes, made from a numpy seed, run on both
packages' ``BitstreamRecorder``, ``BitstreamWriter`` and
``BitstreamAccumulator`` in both bit orders: unsigned, signed and wide
values, unary codes with either stop bit, Huffman codes, bytes, aligns
and ``build``, with per-byte callbacks that record what they see.  The
bytes, the bit counts and the callbacks' bytes must be equal.  The same
programs then read back on both packages' ``BitstreamReader`` (reads,
``read_huffman_code``, ``unary``, ``limited_unary``, ``skip``,
``skip_unary``, ``unread``, ``getpos``/``setpos``, marks, ``parse``,
``substream_append``, callbacks pushed and popped) must give the same
values.  Following the reference's ``tests/test_bitstream.py`` and
``test_bitstream_edges.py``: ``HuffmanTree``'s errors, a code that is no
code of the tree, ``format_size`` and ``format_byte_size``, the
recorder's ``split`` and ``swap``, the writer's ``seek``, ``close`` and
context manager.
"""

import io

import numpy as np
import pytest

from audiotools_tpu import bitstream as ref_bs
from audiotools_tpu_torch import bitstream

PACKAGES = (ref_bs, bitstream)

CODES = [([1], "a"), ([0, 1], "b"), ([0, 0, 1], "c"), ([0, 0, 0, 0], "d"),
         ([0, 0, 0, 1], "e")]


def program(seed, steps=60):
    """a list of write operations with their values"""
    rng = np.random.default_rng(seed)
    ops = []
    for _ in range(steps):
        kind = rng.integers(0, 8)
        if kind == 0:
            bits = int(rng.integers(0, 33))
            ops.append(("write", bits, int(rng.integers(0, 1 << bits))
                        if bits else 0))
        elif kind == 1:
            bits = int(rng.integers(1, 33))
            ops.append(("write_signed", bits,
                        int(rng.integers(-(1 << (bits - 1)),
                                         1 << (bits - 1)))))
        elif kind == 2:
            ops.append(("unary", int(rng.integers(0, 2)),
                        int(rng.integers(0, 70))))
        elif kind == 3:
            ops.append(("huffman", CODES[int(rng.integers(0, 5))][1]))
        elif kind == 4:
            ops.append(("bytes", rng.integers(0, 256, int(rng.integers(
                0, 6)), dtype=np.uint8).tobytes()))
        elif kind == 5:
            ops.append(("align",))
        elif kind == 6:
            bits = int(rng.integers(33, 70))
            ops.append(("write_64", bits,
                        int(rng.integers(0, 1 << min(bits, 62)))))
        else:
            ops.append(("build", "3u 2s 4p 1u", [int(rng.integers(0, 8)),
                                                 int(rng.integers(-2, 2)),
                                                 1]))
    return ops


def run_writes(bs, writer, ops, little_endian):
    tree = bs.HuffmanTree(CODES, little_endian)
    seen = []
    writer.add_callback(seen.append)
    for (i, op) in enumerate(ops):
        if op[0] == "write":
            writer.write(op[1], op[2])
        elif op[0] == "write_signed":
            writer.write_signed(op[1], op[2])
        elif op[0] == "unary":
            writer.unary(op[1], op[2])
        elif op[0] == "huffman":
            writer.write_huffman_code(tree, op[1])
        elif op[0] == "bytes":
            writer.write_bytes(op[1])
        elif op[0] == "align":
            writer.byte_align()
        elif op[0] == "write_64":
            writer.write_64(op[1], op[2])
        else:
            writer.build(op[1], op[2])
        if i == len(ops) // 2:
            writer.pop_callback()
        elif i == 3 * len(ops) // 4:
            writer.push_callback()
    writer.byte_align()
    return seen


@pytest.mark.parametrize("little_endian", [False, True])
@pytest.mark.parametrize("seed", range(8))
def test_recorded_bits_are_the_references(seed, little_endian):
    ops = program(seed)
    results = []
    for bs in PACKAGES:
        recorder = bs.BitstreamRecorder(little_endian)
        seen = run_writes(bs, recorder, ops, little_endian)
        counter = bs.BitstreamAccumulator(little_endian)
        run_writes(bs, counter, ops, little_endian)
        f = io.BytesIO()
        with bs.BitstreamWriter(f, little_endian) as writer:
            writer_seen = run_writes(bs, writer, ops, little_endian)
        results.append((recorder.data(), recorder.bits(), recorder.bytes(),
                        recorder.byte_aligned(), seen, counter.bits(),
                        counter.bytes(), f.getvalue(), writer_seen))
    assert results[0] == results[1]


def read_program(bs, data, ops, little_endian):
    tree = bs.HuffmanTree(CODES, little_endian)
    reader = bs.BitstreamReader(io.BytesIO(data), little_endian)
    seen = []
    out = []
    reader.add_callback(seen.append)
    try:
        read_ops(reader, tree, ops, out)
    except IOError as err:
        # a limited unary code that stops early leaves the reads out of
        # step with the writes, to the stream's end
        out.append(("end", str(err)))
    return (out, seen)


def read_ops(reader, tree, ops, out):
    for (i, op) in enumerate(ops):
        if op[0] in ("write", "write_64"):
            out.append(reader.read(op[1]))
        elif op[0] == "write_signed":
            out.append(reader.read_signed_64(op[1]))
        elif op[0] == "unary":
            if i % 3 == 0:
                reader.skip_unary(op[1])
            elif i % 3 == 1:
                out.append(reader.limited_unary(op[1], 40))
            else:
                out.append(reader.unary(op[1]))
        elif op[0] == "huffman":
            out.append(reader.read_huffman_code(tree))
        elif op[0] == "bytes":
            out.append(reader.read_bytes(len(op[1])))
        elif op[0] == "align":
            out.append(reader.byte_aligned())
            reader.byte_align()
        else:
            out.append(reader.parse(op[1]))
        if i % 7 == 3:
            pos = reader.getpos()
            out.append(reader.read(5) if reader.state_bits else None)
            reader.setpos(pos)
        if i % 11 == 5 and reader.state_bits and reader.state_bits < 8:
            bit = reader.read(1)
            reader.unread(bit)
        if i == len(ops) // 3:
            reader.pop_callback()
        elif i == len(ops) // 2:
            reader.push_callback()


@pytest.mark.parametrize("little_endian", [False, True])
@pytest.mark.parametrize("seed", range(8))
def test_reads_are_the_references(seed, little_endian):
    ops = program(seed)
    recorder = ref_bs.BitstreamRecorder(little_endian)
    run_writes(ref_bs, recorder, ops, little_endian)
    data = recorder.data()
    results = [read_program(bs, data, ops, little_endian)
               for bs in PACKAGES]
    assert results[0] == results[1]


def outcome(fn):
    try:
        return ("ok", fn())
    except Exception as err:
        return ("raise", type(err).__name__, str(err))


def same(fn):
    (a, b) = (outcome(lambda: fn(bs)) for bs in PACKAGES)
    assert a == b
    return a


@pytest.mark.parametrize("codes", [
    [([1], 0), ([0, 1], 1), ([0, 0], 2)],
    [[1], 0, [0, 1], 1, [0, 0], 2],
    [([1], 0), ([1], 1)],                      # a code twice
    [([1, 0], 0), ([1], 1)],                   # a prefix after its code
    [([1], 0), ([1, 0], 1)],                   # a code after its prefix
    [([0], "zero"), ([1, 1, 1], "seven")],     # no code starts 10
])
@pytest.mark.parametrize("data", [b"\x00\xff", b"\xb6\xdb", b"\x80"])
def test_huffman_trees_and_reads_are_the_references(codes, data):
    def run(bs):
        tree = (bs.HuffmanTree(codes, False) if isinstance(codes[0], tuple)
                else bs.HuffmanTree(codes))
        reader = bs.BitstreamReader(data, False)
        return [reader.read_huffman_code(tree) for _ in range(4)]
    same(run)


@pytest.mark.parametrize("fmt", ["8u", "3u 5s", "4*8u", "2b 3P", "1u a 4p",
                                 "2*3u a", "16u 16u 24u 36U 16b", "", "7u a"])
def test_format_sizes_are_the_references(fmt):
    same(lambda bs: (bs.format_size(fmt), bs.format_byte_size(fmt)))


@pytest.mark.parametrize("little_endian", [False, True])
@pytest.mark.parametrize("count", [0, 2, 5, 9])
def test_recorder_split_and_swap_are_the_references(little_endian, count):
    def run(bs):
        rec = bs.BitstreamRecorder(little_endian)
        rec.build("8u 8u 8u 8u 8u 3u", [1, 2, 3, 4, 5, 6])
        (head, tail) = (bs.BitstreamRecorder(little_endian),
                        bs.BitstreamRecorder(little_endian))
        n = rec.split(head, tail, count)
        other = bs.BitstreamRecorder(little_endian)
        other.write(12, 0xABC)
        rec.swap(other)
        return (n, head.data(), tail.data(), rec.data(), rec.bits(),
                other.data(), other.bits(), rec.split(None, None, 1))
    same(run)


@pytest.mark.parametrize("little_endian", [False, True])
def test_substream_append_and_marks_are_the_references(little_endian):
    data = bytes(range(1, 30))

    def run(bs):
        reader = bs.BitstreamReader(io.BytesIO(data), little_endian)
        sub = reader.substream(3)
        reader.substream_append(sub, 4)
        values = [sub.read(8) for _ in range(7)]
        reader.mark()
        values.append(reader.read(13))
        reader.rewind()
        values.append(reader.read(13))
        reader.unmark()
        reader.set_endianness(not little_endian)
        values.append(reader.read(9))
        reader.skip(3)
        reader.skip_bytes(2)
        values.append(reader.parse("4u 4s 1b"))
        values.append(outcome(lambda: reader.read_bytes(100)))
        return values
    same(run)


@pytest.mark.parametrize("case", [
    ("unread past a byte", lambda bs: bs.BitstreamReader(b"\x01").unread(1)),
    ("unread a two", lambda bs: bs.BitstreamReader(b"\x01").unread(2)),
    ("unary stop", lambda bs: bs.BitstreamReader(b"\x01").unary(2)),
    ("limited none", lambda bs: bs.BitstreamReader(
        b"\x00\x00").limited_unary(1, 9)),
    ("read past end", lambda bs: bs.BitstreamReader(b"\x01").read(9)),
    ("write too wide", lambda bs: bs.BitstreamRecorder().write(3, 8)),
    ("write negative", lambda bs: bs.BitstreamRecorder().write(3, -1)),
    ("signed too wide", lambda bs: bs.BitstreamRecorder().write_signed(
        3, 4)),
    ("no code", lambda bs: bs.BitstreamRecorder().write_huffman_code(
        bs.HuffmanTree(CODES, False), "z")),
    ("unary negative", lambda bs: bs.BitstreamRecorder().unary(0, -1)),
    ("accumulator", lambda bs: _accumulate(bs)),
    ("writer seek", lambda bs: _writer_seek(bs)),
])
def test_edges_are_the_references(case):
    same(case[1])


def _accumulate(bs):
    acc = bs.BitstreamAccumulator(False)
    acc.write(5, 3)
    acc.write_signed(4, -2)
    acc.write_bytes(b"abc")
    acc.byte_align()
    bits = acc.bits()
    acc.set_endianness(True)
    return (bits, acc.bytes(), acc.bits())


def _writer_seek(bs):
    f = io.BytesIO()
    writer = bs.BitstreamWriter(f, False)
    writer.write(16, 0xFFFF)
    writer.seek(0)
    writer.write(8, 1)
    writer.set_endianness(True)
    writer.write(4, 3)
    writer.flush()
    data = f.getvalue()
    writer.close()
    return (data, f.closed)
