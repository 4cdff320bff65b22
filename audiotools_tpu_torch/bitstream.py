"""Bit readers and writers, for the WavPack container and ID3 tags.

A copy of the parts of the reference's ``audiotools_tpu/bitstream.py``
that its WavPack reader and writer (``ref/wavpack.py``) and its ID3
tags (``meta/id3.py``) reach: ``BitstreamReader`` with ``read``,
``read_signed``, ``read_bytes``, ``skip_bytes``, ``parse``,
``substream``, ``unary``, marks and ``seek``, and ``BitstreamWriter`` /
``BitstreamRecorder`` with ``write``, ``write_signed``, ``write_bytes``,
``build``, ``byte_align``, ``flush``, ``copy``, ``bytes`` and ``data``.
Each takes the reference's ``little_endian`` argument, False by
default.  Big-endian: bits are packed most significant first, and in a
multi-bit value the bits read first are the most significant.
Little-endian (WavPack's): bits are packed least significant first, and
in a multi-bit value the bits read first are the least significant.
Huffman codes and callbacks are not ported.

``parse`` and ``build`` take the reference's format language: tokens
``Nu`` (unsigned), ``Ns`` (signed), ``Np`` (skip bits), ``NP`` (skip
bytes), ``Nb`` (bytes) and ``a`` (align), each optionally after an
``N*`` multiplier.
"""

from __future__ import annotations

import io


def parse_format(format_string):
    """yields (times, size, instruction) triples of a format string"""
    i = 0
    n = len(format_string)
    multiplier = 1
    while i < n:
        while i < n and format_string[i].isspace():
            i += 1
        if i == n:
            return
        argument = 0
        while i < n and format_string[i].isdigit():
            argument = argument * 10 + int(format_string[i])
            i += 1
        if i == n:
            return
        c = format_string[i]
        i += 1
        if c == "*":
            multiplier *= argument
            continue
        if c == "a":
            yield (multiplier, 0, "a")
        elif c in "usUSpPb":
            yield (multiplier, argument, c)
        else:
            return
        multiplier = 1


class BitstreamReader:
    """reads bit fields from a binary file or bytes"""

    def __init__(self, source, little_endian=False):
        if isinstance(source, (bytes, bytearray, memoryview)):
            source = io.BytesIO(bytes(source))
        self.source = source
        self.little_endian = bool(little_endian)
        self.state = 0          # the unread bits of the current byte
        self.state_bits = 0
        self.marks = []

    def _next_byte(self):
        b = self.source.read(1)
        if len(b) == 0:
            raise IOError("I/O error reading stream")
        return b[0]

    def read(self, bits):
        """an unsigned value of the given number of bits"""
        if bits < 0:
            raise ValueError("bit count must be >= 0")
        value = 0
        shift = 0
        while bits > 0:
            if self.state_bits == 0:
                self.state = self._next_byte()
                self.state_bits = 8
            take = min(bits, self.state_bits)
            if self.little_endian:
                value |= (self.state & ((1 << take) - 1)) << shift
                self.state >>= take
                shift += take
            else:
                # the unread bits are the low state_bits of the state
                value = (value << take) | (
                    self.state >> (self.state_bits - take))
                self.state &= (1 << (self.state_bits - take)) - 1
            self.state_bits -= take
            bits -= take
        return value

    def read_signed(self, bits):
        """a two's-complement value of the given number of bits"""
        if bits < 1:
            raise ValueError("signed reads need at least 1 bit")
        value = self.read(bits)
        return value - (1 << bits) if value & (1 << (bits - 1)) else value

    def unary(self, stop_bit):
        """the count of bits before the next stop bit (0 or 1)"""
        if stop_bit not in (0, 1):
            raise ValueError("stop bit must be 0 or 1")
        count = 0
        while self.read(1) != stop_bit:
            count += 1
        return count

    def read_bytes(self, byte_count):
        """the next byte_count bytes"""
        if self.state_bits:
            return bytes(self.read(8) for _ in range(byte_count))
        data = self.source.read(byte_count)
        if len(data) != byte_count:
            raise IOError("I/O error reading stream")
        return data

    def skip_bytes(self, byte_count):
        if self.state_bits:
            self.read_bytes(byte_count)
        else:
            self.source.seek(self.source.tell() + byte_count)

    def parse(self, format_string):
        """reads the fields of a format string; returns their values"""
        values = []
        for (times, size, inst) in parse_format(format_string):
            for _ in range(times):
                if inst in "uU":
                    values.append(self.read(size))
                elif inst in "sS":
                    values.append(self.read_signed(size))
                elif inst == "p":
                    self.read(size)
                elif inst == "P":
                    self.skip_bytes(size)
                elif inst == "b":
                    values.append(self.read_bytes(size))
                else:
                    self.byte_align()
        return values

    def substream(self, byte_count):
        """a reader over the next byte_count bytes"""
        return BitstreamReader(self.read_bytes(byte_count),
                               self.little_endian)

    def byte_align(self):
        self.state = 0
        self.state_bits = 0

    def mark(self):
        """pushes the current position onto the mark stack"""
        self.marks.append((self.source.tell(), self.state, self.state_bits))

    def rewind(self):
        """returns to the most recent mark, which stays on the stack"""
        (pos, self.state, self.state_bits) = self.marks[-1]
        self.source.seek(pos)

    def unmark(self):
        self.marks.pop()

    def seek(self, position, whence=0):
        """seeks to a byte position of the source, as file.seek does"""
        self.source.seek(position, whence)
        self.byte_align()

    def close(self):
        self.source.close()


class _Writer:
    """the bit accumulator shared by the writer and the recorder"""

    def __init__(self, little_endian):
        self.little_endian = bool(little_endian)
        self.state = 0
        self.state_bits = 0
        self._bits_written = 0

    def write(self, bits, value):
        """writes an unsigned value of the given number of bits"""
        if bits < 0:
            raise ValueError("bit count must be >= 0")
        if value < 0:
            raise ValueError("value must be unsigned")
        if bits < 64 and value >= (1 << bits):
            raise ValueError("value does not fit in bit count")
        self._bits_written += bits
        while bits > 0:
            take = min(bits, 8 - self.state_bits)
            if self.little_endian:
                self.state |= (value & ((1 << take) - 1)) << self.state_bits
                value >>= take
            else:
                self.state = (self.state << take) | (
                    (value >> (bits - take)) & ((1 << take) - 1))
            self.state_bits += take
            bits -= take
            if self.state_bits == 8:
                self._emit_bytes(bytes((self.state,)))
                self.state = 0
                self.state_bits = 0

    def write_signed(self, bits, value):
        """writes a two's-complement value of the given number of bits"""
        if bits < 1:
            raise ValueError("signed writes need at least 1 bit")
        limit = 1 << (bits - 1)
        if not (-limit <= value < limit):
            raise ValueError("value does not fit in bit count")
        self.write(bits, value + (1 << bits) if value < 0 else value)

    def write_bytes(self, data):
        if self.state_bits:
            for byte in data:
                self.write(8, byte)
        else:
            self._bits_written += 8 * len(data)
            self._emit_bytes(bytes(data))

    def byte_align(self):
        """pads with 0 bits to the next byte boundary"""
        if self.state_bits:
            self.write(8 - self.state_bits, 0)

    def build(self, format_string, values):
        """writes the fields of a format string from the values"""
        values = list(values)
        values.reverse()
        for (times, size, inst) in parse_format(format_string):
            for _ in range(times):
                if inst in "uU":
                    self.write(size, values.pop())
                elif inst in "sS":
                    self.write_signed(size, values.pop())
                elif inst == "p":
                    self.write(size, 0)
                elif inst == "P":
                    self.write_bytes(b"\x00" * size)
                elif inst == "b":
                    self.write_bytes(values.pop())
                else:
                    self.byte_align()


class BitstreamWriter(_Writer):
    """writes bit fields to a binary file"""

    def __init__(self, file, little_endian=False):
        super().__init__(little_endian)
        self.file = file
        self._pending = bytearray()

    def _emit_bytes(self, data):
        self._pending.extend(data)
        if len(self._pending) >= 4096:
            self.file.write(bytes(self._pending))
            self._pending.clear()

    def flush(self):
        """writes the pending whole bytes to the file"""
        if self._pending:
            self.file.write(bytes(self._pending))
            self._pending.clear()
        self.file.flush()


class BitstreamRecorder(_Writer):
    """records bit fields in memory, to be copied to another writer"""

    def __init__(self, little_endian=False):
        super().__init__(little_endian)
        self._bytes = bytearray()

    def _emit_bytes(self, data):
        self._bytes.extend(data)

    def bytes(self):
        """the number of whole bytes written so far"""
        return self._bits_written // 8

    def data(self):
        """the recorded whole bytes"""
        return bytes(self._bytes)

    def reset(self):
        self._bytes.clear()
        self.state = 0
        self.state_bits = 0
        self._bits_written = 0

    def copy(self, writer):
        """writes the recorded bits to another writer"""
        writer.write_bytes(bytes(self._bytes))
        if self.state_bits:
            writer.write(self.state_bits, self.state)
