"""Bit readers and writers: the port's copy of the reference's
``bitstream`` API.

``BitstreamReader`` (reads, ``parse``, unary and Huffman codes,
substreams, marks, ``getpos``/``setpos``, per-byte callbacks),
``BitstreamWriter``, ``BitstreamRecorder`` and ``BitstreamAccumulator``
(writes, ``build``, unary and Huffman codes, callbacks), ``HuffmanTree``
and the format language's ``parse_format``, ``format_size`` and
``format_byte_size``.  Each reader and writer takes the reference's
``little_endian`` argument, False by default.  Big-endian: bits are
packed most significant first, and in a multi-bit value the bits read
first are the most significant.  Little-endian (WavPack's): bits are
packed least significant first, and in a multi-bit value the bits read
first are the least significant.

The WavPack decoder parses its blocks on this reader, so a read costs
nothing for callbacks while none is registered: registering one swaps
in a byte source that calls them.

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


def format_size(format_string):
    """the size of a format string in bits"""
    total = 0
    for (times, size, inst) in parse_format(format_string):
        if inst in "usUSp":
            total += times * size
        elif inst in "Pb":
            total += times * size * 8
        elif inst == "a" and total % 8:
            total += 8 - (total % 8)
    return total


def format_byte_size(format_string):
    """the size of a format string in whole bytes"""
    return format_size(format_string) // 8


class HuffmanTree:
    """a Huffman code table for ``read_huffman_code`` and
    ``write_huffman_code``

    Built from (bit list, value) pairs, ``HuffmanTree([([1], 0), ([0, 1],
    1), ([0, 0], 2)])``, or from the flat form ``HuffmanTree([[1], 0,
    [0, 1], 1, [0, 0], 2], False)``.  A code that is a prefix of
    another, or that repeats one, raises ValueError."""

    def __init__(self, *args):
        if len(args) == 2 and isinstance(args[0], (list, tuple)):
            (entries, little_endian) = args
        else:
            entries = args[0]
            little_endian = False
        entries = list(entries)
        if (len(entries) and not
                (isinstance(entries[0], (list, tuple)) and
                 len(entries[0]) == 2 and
                 isinstance(entries[0][0], (list, tuple)))):
            items = [(list(entries[i]), entries[i + 1])
                     for i in range(0, len(entries), 2)]
        else:
            items = [(list(bits), value) for (bits, value) in entries]

        self.little_endian = bool(little_endian)
        self.root = {}
        for (bits, value) in items:
            node = self.root
            for bit in bits[:-1]:
                node = node.setdefault(bit, {})
                if not isinstance(node, dict):
                    raise ValueError("Huffman code prefix collision")
            last = bits[-1]
            if last in node:
                raise ValueError("duplicate Huffman code")
            node[last] = ("leaf", value)


class BitstreamReader:
    """reads bit fields from a binary file or bytes"""

    def __init__(self, source, little_endian=False, buffer_size=4096):
        if isinstance(source, (bytes, bytearray, memoryview)):
            source = io.BytesIO(bytes(source))
        self.source = source
        self.little_endian = bool(little_endian)
        self.state = 0          # the unread bits of the current byte
        self.state_bits = 0
        self.marks = []
        self.callbacks = []
        self.callbacks_popped = []

    def _next_byte(self):
        b = self.source.read(1)
        if len(b) == 0:
            raise IOError("I/O error reading stream")
        return b[0]

    def _next_byte_called_back(self):
        byte = BitstreamReader._next_byte(self)
        for callback in self.callbacks:
            callback(byte)
        return byte

    def _callbacks_changed(self):
        # the byte source with callbacks only while there are any
        if self.callbacks:
            self._next_byte = self._next_byte_called_back
        else:
            self.__dict__.pop("_next_byte", None)

    def set_endianness(self, little_endian):
        """sets the bit order; the rest of the current byte is dropped"""
        self.little_endian = bool(little_endian)
        self.byte_align()

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

    # Python ints have no width: the wide reads are the same reads
    read_64 = read
    read_signed_64 = read_signed
    read_bigint = read
    read_signed_bigint = read_signed

    def skip(self, bits):
        """skips the given number of bits"""
        self.read(bits)

    def _read_bit(self):
        if self.state_bits == 0:
            self.state = self._next_byte()
            self.state_bits = 8
        self.state_bits -= 1
        if self.little_endian:
            bit = self.state & 1
            self.state >>= 1
        else:
            bit = self.state >> self.state_bits
            self.state &= (1 << self.state_bits) - 1
        return bit

    def unary(self, stop_bit):
        """the count of bits before the next stop bit (0 or 1)"""
        if stop_bit not in (0, 1):
            raise ValueError("stop bit must be 0 or 1")
        count = 0
        while self.read(1) != stop_bit:
            count += 1
        return count

    def skip_unary(self, stop_bit):
        """skips the bits up to and including the next stop bit"""
        self.unary(stop_bit)

    def limited_unary(self, stop_bit, maximum_bits):
        """the count of bits before the next stop bit, or None when
        ``maximum_bits`` pass without one"""
        if stop_bit not in (0, 1):
            raise ValueError("stop bit must be 0 or 1")
        count = 0
        while count < maximum_bits:
            if self._read_bit() == stop_bit:
                return count
            count += 1
        return None

    def read_huffman_code(self, tree):
        """the value of the next code of a HuffmanTree; ValueError when
        the bits are no code of it"""
        node = tree.root
        while True:
            try:
                node = node[self._read_bit()]
            except KeyError:
                raise ValueError("invalid Huffman code in stream")
            if not isinstance(node, dict):
                return node[1]

    def read_bytes(self, byte_count):
        """the next byte_count bytes"""
        if self.state_bits:
            return bytes(self.read(8) for _ in range(byte_count))
        data = self.source.read(byte_count)
        if len(data) != byte_count:
            raise IOError("I/O error reading stream")
        for callback in self.callbacks:
            for byte in data:
                callback(byte)
        return data

    def skip_bytes(self, byte_count):
        """skips the given number of bytes (reading them, where a
        callback must see them)"""
        if self.state_bits or self.callbacks:
            while byte_count > 0:
                n = min(byte_count, 0x10000)
                self.read_bytes(n)
                byte_count -= n
        else:
            self.source.seek(self.source.tell() + byte_count)

    def unread(self, bit):
        """pushes one bit back, to be the next bit read; only while fewer
        than 8 bits of the current byte are left"""
        if bit not in (0, 1):
            raise ValueError("unread bit must be 0 or 1")
        if self.state_bits >= 8:
            raise IOError("maximum unread bits reached")
        if self.little_endian:
            self.state = (self.state << 1) | bit
        else:
            self.state |= bit << self.state_bits
        self.state_bits += 1

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

    def substream_append(self, substream, byte_count):
        """appends the next byte_count bytes to the end of a substream"""
        data = self.read_bytes(byte_count)
        source = substream.source
        position = source.tell()
        source.seek(0, 2)
        source.write(data)
        source.seek(position, 0)

    def byte_align(self):
        self.state = 0
        self.state_bits = 0

    def byte_aligned(self):
        """True at a byte boundary"""
        return self.state_bits == 0

    def add_callback(self, callback):
        """calls ``callback(byte)`` with each byte read from now on"""
        self.callbacks.append(callback)
        self._callbacks_changed()

    def pop_callback(self):
        """removes and returns the newest callback"""
        callback = self.callbacks.pop()
        self.callbacks_popped.append(callback)
        self._callbacks_changed()
        return callback

    def push_callback(self, callback=None):
        """adds ``callback``, or the one popped last, back"""
        if callback is None:
            callback = self.callbacks_popped.pop()
        self.callbacks.append(callback)
        self._callbacks_changed()

    def call_callbacks(self, byte):
        """passes ``byte`` to every callback"""
        for callback in self.callbacks:
            callback(byte)

    def mark(self):
        """pushes the current position onto the mark stack"""
        self.marks.append(self.getpos())

    def rewind(self):
        """returns to the most recent mark, which stays on the stack"""
        self.setpos(self.marks[-1])

    def unmark(self):
        self.marks.pop()

    def getpos(self):
        """the current position, for ``setpos``"""
        return (self.source.tell(), self.state, self.state_bits)

    def setpos(self, pos):
        """returns to a position from ``getpos``"""
        (position, self.state, self.state_bits) = pos
        self.source.seek(position, 0)

    def seek(self, position, whence=0):
        """seeks to a byte position of the source, as file.seek does"""
        self.source.seek(position, whence)
        self.byte_align()

    def close(self):
        self.source.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class _Writer:
    """the bit accumulator shared by the writers and the recorder"""

    def __init__(self, little_endian):
        self.little_endian = bool(little_endian)
        self.state = 0
        self.state_bits = 0
        self._bits_written = 0
        self.callbacks = []
        self.callbacks_popped = []

    def _emit_byte(self, byte):
        if self.callbacks:
            for callback in self.callbacks:
                callback(byte)
        self._emit_bytes(bytes((byte,)))

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
                self._emit_byte(self.state)
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

    def write_64(self, bits, value):
        self.write(bits, value)

    def write_signed_64(self, bits, value):
        self.write_signed(bits, value)

    def write_bigint(self, bits, value):
        self.write(bits, value)

    def write_signed_bigint(self, bits, value):
        self.write_signed(bits, value)

    def unary(self, stop_bit, value):
        """writes ``value`` bits other than the stop bit, then it"""
        if stop_bit not in (0, 1):
            raise ValueError("stop bit must be 0 or 1")
        if value < 0:
            raise ValueError("unary value must be >= 0")
        if stop_bit:
            while value >= 32:
                self.write(32, 0)
                value -= 32
            self.write(value + 1, 1 << value if self.little_endian else 1)
        else:
            while value >= 32:
                self.write(32, 0xFFFFFFFF)
                value -= 32
            self.write(value + 1, (1 << value) - 1 if self.little_endian
                       else ((1 << value) - 1) << 1)

    def write_huffman_code(self, tree, value):
        """writes the code of ``value`` in a HuffmanTree"""
        def find(node, path):
            if not isinstance(node, dict):
                return path if node[1] == value else None
            for (bit, child) in node.items():
                result = find(child, path + [bit])
                if result is not None:
                    return result
            return None
        path = find(tree.root, [])
        if path is None:
            raise ValueError("value has no Huffman code")
        for bit in path:
            self.write(1, bit)

    def write_bytes(self, data):
        if isinstance(data, str):
            data = data.encode("ascii")
        if self.state_bits:
            for byte in data:
                self.write(8, byte)
        else:
            for callback in self.callbacks:
                for byte in data:
                    callback(byte)
            self._bits_written += 8 * len(data)
            self._emit_bytes(bytes(data))

    def byte_align(self):
        """pads with 0 bits to the next byte boundary"""
        if self.state_bits:
            self.write(8 - self.state_bits, 0)

    def byte_aligned(self):
        """True at a byte boundary"""
        return self.state_bits == 0

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

    def add_callback(self, callback):
        """calls ``callback(byte)`` with each whole byte written"""
        self.callbacks.append(callback)

    def pop_callback(self):
        """removes and returns the newest callback"""
        callback = self.callbacks.pop()
        self.callbacks_popped.append(callback)
        return callback

    def push_callback(self, callback=None):
        """adds ``callback``, or the one popped last, back"""
        if callback is None:
            callback = self.callbacks_popped.pop()
        self.callbacks.append(callback)

    def call_callbacks(self, byte):
        """passes ``byte`` to every callback"""
        for callback in self.callbacks:
            callback(byte)


class BitstreamWriter(_Writer):
    """writes bit fields to a binary file"""

    def __init__(self, file, little_endian=False, buffer_size=4096):
        super().__init__(little_endian)
        self.file = file
        self._pending = bytearray()

    def _emit_bytes(self, data):
        self._pending.extend(data)
        if len(self._pending) >= 4096:
            self.file.write(bytes(self._pending))
            self._pending.clear()

    def set_endianness(self, little_endian):
        """pads to a byte boundary, then sets the bit order"""
        self.byte_align()
        self.little_endian = bool(little_endian)

    def flush(self):
        """writes the pending whole bytes to the file"""
        if self._pending:
            self.file.write(bytes(self._pending))
            self._pending.clear()
        try:
            self.file.flush()
        except AttributeError:
            pass

    def seek(self, position, whence=0):
        """flushes, then seeks the file"""
        self.flush()
        self.file.seek(position, whence)

    def close(self):
        """pads to a byte boundary, flushes and closes the file"""
        self.byte_align()
        self.flush()
        self.file.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.byte_align()
        self.flush()


class BitstreamRecorder(_Writer):
    """records bit fields in memory, to be copied to another writer"""

    def __init__(self, little_endian=False):
        super().__init__(little_endian)
        self._bytes = bytearray()

    def _emit_bytes(self, data):
        self._bytes.extend(data)

    def bits(self):
        """the number of bits written so far"""
        return self._bits_written

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

    def split(self, target, remainder, byte_count):
        """writes the first ``byte_count`` recorded bytes to ``target``
        and the rest to ``remainder`` (either may be None); returns the
        count written to ``target``"""
        head = bytes(self._bytes[:byte_count])
        if target is not None:
            target.write_bytes(head)
        if remainder is not None:
            remainder.write_bytes(bytes(self._bytes[byte_count:]))
        return len(head)

    def set_endianness(self, little_endian):
        """sets the bit order and drops what was recorded"""
        self.little_endian = bool(little_endian)
        self.reset()

    def swap(self, other):
        """swaps the recorded contents with another recorder's"""
        (self._bytes, other._bytes) = (other._bytes, self._bytes)
        (self.state, other.state) = (other.state, self.state)
        (self.state_bits, other.state_bits) = (other.state_bits,
                                               self.state_bits)
        (self._bits_written, other._bits_written) = (other._bits_written,
                                                     self._bits_written)

    def close(self):
        pass


class BitstreamAccumulator(_Writer):
    """a writer that only counts the bits written"""

    def __init__(self, little_endian=False):
        super().__init__(little_endian)

    def _emit_bytes(self, data):
        pass

    def write(self, bits, value):
        if bits < 0:
            raise ValueError("bit count must be >= 0")
        if value < 0:
            raise ValueError("value must be unsigned")
        self._bits_written += bits
        self.state_bits = (self.state_bits + bits) % 8

    def write_signed(self, bits, value):
        limit = 1 << (bits - 1)
        if not (-limit <= value < limit):
            raise ValueError("value does not fit in bit count")
        self._bits_written += bits
        self.state_bits = (self.state_bits + bits) % 8

    def write_bytes(self, data):
        self._bits_written += 8 * len(data)

    def byte_align(self):
        if self.state_bits:
            self._bits_written += 8 - self.state_bits
            self.state_bits = 0

    def bits(self):
        return self._bits_written

    def bytes(self):
        return self._bits_written // 8

    def reset(self):
        self._bits_written = 0
        self.state_bits = 0

    def set_endianness(self, little_endian):
        self.little_endian = bool(little_endian)
        self.reset()

    def close(self):
        pass
