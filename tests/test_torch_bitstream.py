"""The port's bitstream in both byte orders against the reference's.

``audiotools_tpu_torch/bitstream.py`` takes the reference's
``little_endian`` argument, False (big-endian) by default as the
reference's is.  The cases beside ``tests/test_bitstream.py``: the
4-byte fixture read and written in each order, signed values, unary
codes, parse and build, marks, substreams and recorders copied into
writers; and seeded random fields, whose bytes and values must equal
the reference's exactly (no tolerance: these are integers).
"""

import io

import numpy as np
import pytest

from audiotools_tpu import bitstream as ref_bitstream
from audiotools_tpu_torch import bitstream

DATA = b"\xB1\xED\x3B\xC1"
ORDERS = [False, True]


def test_the_default_is_big_endian_as_the_references():
    for cls in (bitstream.BitstreamRecorder, ref_bitstream.BitstreamRecorder):
        rec = cls()
        rec.write(3, 5)
        rec.byte_align()
        assert rec.data() == b"\xa0"
    assert bitstream.BitstreamReader(DATA).read(2) == \
        ref_bitstream.BitstreamReader(DATA).read(2) == 2
    out = io.BytesIO()
    writer = bitstream.BitstreamWriter(out)
    writer.write(2, 2)
    writer.byte_align()
    writer.flush()
    assert out.getvalue() == b"\x80"


@pytest.mark.parametrize("little_endian", ORDERS)
def test_fixture_reads_as_the_references(little_endian):
    widths = [2, 3, 5, 3, 19]
    (port, ref) = (bitstream.BitstreamReader(DATA, little_endian),
                   ref_bitstream.BitstreamReader(DATA, little_endian))
    assert [port.read(w) for w in widths] == [ref.read(w) for w in widths]
    (port, ref) = (bitstream.BitstreamReader(DATA, little_endian),
                   ref_bitstream.BitstreamReader(DATA, little_endian))
    assert [port.read_signed(w) for w in widths] == \
        [ref.read_signed(w) for w in widths]
    for stop in (0, 1):
        (port, ref) = (bitstream.BitstreamReader(DATA, little_endian),
                       ref_bitstream.BitstreamReader(DATA, little_endian))
        assert [port.unary(stop) for _ in range(4)] == \
            [ref.unary(stop) for _ in range(4)]


def test_big_endian_fixture_values():
    """the values tests/test_bitstream.py reads from the fixture"""
    r = bitstream.BitstreamReader(DATA, False)
    assert [r.read(w) for w in (2, 3, 5, 3, 19)] == [2, 6, 7, 5, 0x53BC1]
    r = bitstream.BitstreamReader(DATA, False)
    assert [r.read_signed(w) for w in (2, 3, 5, 3, 19)] == \
        [-2, -2, 7, -3, -181311]
    out = io.BytesIO()
    w = bitstream.BitstreamWriter(out, False)
    for (bits, value) in ((2, 2), (3, 6), (5, 7), (3, 5), (19, 0x53BC1)):
        w.write(bits, value)
    w.flush()
    assert out.getvalue() == DATA


@pytest.mark.parametrize("little_endian", ORDERS)
def test_random_fields_equal_the_references(little_endian):
    """200 seeded fields of 1-64 bits, signed values, a format string
    and bytes, recorded, copied into a writer mid-byte, and read back
    (plain, marked and rewound, through parse, and from a substream)"""
    rng = np.random.default_rng(19 + little_endian)
    fields = [(int(b), int(rng.integers(0, 1 << int(b), dtype=np.uint64)))
              for b in rng.integers(1, 65, 200)]
    rec = bitstream.BitstreamRecorder(little_endian)
    ref_rec = ref_bitstream.BitstreamRecorder(little_endian)
    for w in (rec, ref_rec):
        for (bits, value) in fields:
            w.write(bits, value)
        w.write_signed(16, -1234)
        w.build("5u 1u 1u 2p 8u 3s", (17, 1, 0, 200, -3))
        w.write_bytes(b"ID3")
        w.write(3, 5)
    assert (rec.data(), rec.bytes()) == (ref_rec.data(), ref_rec.bytes())
    out = io.BytesIO()
    writer = bitstream.BitstreamWriter(out, little_endian)
    writer.write(5, 21)
    rec.copy(writer)
    writer.byte_align()
    writer.flush()
    ref_out = io.BytesIO()
    ref_writer = ref_bitstream.BitstreamWriter(ref_out, little_endian)
    ref_writer.write(5, 21)
    ref_rec.copy(ref_writer)
    ref_writer.byte_align()
    ref_writer.flush()
    data = out.getvalue()
    assert data == ref_out.getvalue()
    reader = bitstream.BitstreamReader(io.BytesIO(data), little_endian)
    assert reader.read(5) == 21
    assert [reader.read(b) for (b, _v) in fields] == [v for (_b, v) in fields]
    reader.mark()
    assert reader.read_signed(16) == -1234
    reader.rewind()
    reader.unmark()
    assert reader.parse("16s 5u 1u 1u 2p 8u 3s 3b") == [
        -1234, 17, 1, 0, 200, -3, b"ID3"]
    reader.seek(1)
    assert reader.substream(3).read_bytes(3) == data[1:4]
    sub = bitstream.BitstreamReader(data, little_endian).substream(4)
    ref_sub = ref_bitstream.BitstreamReader(data, little_endian).substream(4)
    assert [sub.read(7) for _ in range(4)] == [ref_sub.read(7)
                                               for _ in range(4)]
    with pytest.raises(IOError):
        reader.read_bytes(len(data))


@pytest.mark.parametrize("little_endian", ORDERS)
def test_writes_that_do_not_fit_raise(little_endian):
    for w in (bitstream.BitstreamRecorder(little_endian),
              ref_bitstream.BitstreamRecorder(little_endian)):
        with pytest.raises(ValueError):
            w.write(3, 8)
        with pytest.raises(ValueError):
            w.write_signed(3, 4)
        with pytest.raises(ValueError):
            w.write(3, -1)
