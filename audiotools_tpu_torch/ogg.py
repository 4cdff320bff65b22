"""The Ogg container: pages, packets, and the pages of packets.

A copy of the reference's ``audiotools_tpu/ogg.py`` (RFC 3533): a page
is the "OggS" capture pattern, version 0, the header-type flags
(continued packet, beginning and end of stream), a 64-bit granule
position, the stream's serial number, the page's sequence number, a
CRC-32 of the whole page with its CRC field zeroed
(``_native.ogg_crc``), and up to 255 lacing segments of up to 255
bytes.  A packet is a run of segments ended by one shorter than 255
bytes.  ``PageReader`` and ``PacketReader`` read them from a binary
file, ``PageWriter`` writes pages, and ``packet_to_pages`` and
``packets_to_pages`` lay packets out on pages.
"""

from __future__ import annotations

import struct

from . import _native, text


def ogg_crc(data, initial=0):
    """the Ogg page CRC-32 of ``data``, continuing from ``initial``"""
    return _native.ogg_crc(data, initial)

# the page header before its lacing values
_HEADER = struct.Struct("<4sBBqIIIB")


class Page:
    """one Ogg page: its header fields and segments"""

    def __init__(self, packet_continuation, stream_beginning, stream_end,
                 granule_position, bitstream_serial_number, sequence_number,
                 segments):
        self.packet_continuation = bool(packet_continuation)
        self.stream_beginning = bool(stream_beginning)
        self.stream_end = bool(stream_end)
        self.granule_position = granule_position
        self.bitstream_serial_number = bitstream_serial_number
        self.sequence_number = sequence_number
        self.segments = list(segments)

    def __repr__(self):
        return ("Page(seq=%d, granule=%d, segments=%d, size=%d)" %
                (self.sequence_number, self.granule_position,
                 len(self.segments), self.size()))

    def __len__(self):
        return len(self.segments)

    def __getitem__(self, i):
        return self.segments[i]

    def append(self, segment):
        """adds a segment of at most 255 bytes; ValueError when the page
        holds 255 already"""
        if len(self.segments) >= 255:
            raise ValueError("page full")
        if len(segment) > 255:
            raise ValueError("segment too large")
        self.segments.append(bytes(segment))

    def full(self):
        """True when no further segment fits on the page"""
        return len(self.segments) >= 255

    def size(self):
        """the page's bytes: its header, lacing values and segments"""
        return 27 + len(self.segments) + sum(len(s) for s in self.segments)

    def header_type(self):
        return ((0x01 if self.packet_continuation else 0) |
                (0x02 if self.stream_beginning else 0) |
                (0x04 if self.stream_end else 0))

    def build(self):
        """the page's bytes, its CRC filled in"""
        header = _HEADER.pack(b"OggS", 0, self.header_type(),
                              self.granule_position,
                              self.bitstream_serial_number & 0xFFFFFFFF,
                              self.sequence_number & 0xFFFFFFFF, 0,
                              len(self.segments))
        rest = bytes(len(s) for s in self.segments) + b"".join(self.segments)
        crc = _native.ogg_crc(header + rest)
        return header[:22] + struct.pack("<I", crc) + header[26:] + rest

    @classmethod
    def parse(cls, data, verify_crc=True):
        """(the page at the start of ``data``, its size in bytes); raises
        IOError when the bytes end inside the page, ValueError for a
        bad capture pattern, version or (with ``verify_crc``) CRC"""
        if len(data) < 27:
            raise IOError("truncated Ogg page")
        (magic, version, header_type, granule, serial, sequence, crc,
         n_segments) = _HEADER.unpack(data[:27])
        if magic != b"OggS":
            raise ValueError(text.ERR_OGG_INVALID_PAGE)
        if version != 0:
            raise ValueError("unsupported Ogg page version")
        lacing = data[27:27 + n_segments]
        if len(lacing) < n_segments:
            raise IOError("truncated Ogg page")
        total = 27 + n_segments + sum(lacing)
        if len(data) < total:
            raise IOError("truncated Ogg page")
        if verify_crc and _native.ogg_crc(
                data[:22] + b"\x00" * 4 + data[26:total]) != crc:
            raise ValueError(text.ERR_OGG_CHECKSUM_MISMATCH)
        segments = []
        pos = 27 + n_segments
        for length in lacing:
            segments.append(bytes(data[pos:pos + length]))
            pos += length
        return (cls(header_type & 0x01, header_type & 0x02,
                    header_type & 0x04, granule, serial, sequence, segments),
                total)


class PageReader:
    """reads Pages from a binary file"""

    def __init__(self, file, verify_crc=True):
        self.file = file
        self.verify_crc = verify_crc

    def read(self):
        """the next Page; IOError at the end of the file"""
        header = self.file.read(27)
        if len(header) < 27:
            raise IOError("end of Ogg stream")
        if header[:4] != b"OggS":
            raise ValueError(text.ERR_OGG_INVALID_PAGE)
        lacing = self.file.read(header[26])
        if len(lacing) < header[26]:
            raise IOError("truncated Ogg page")
        body = self.file.read(sum(lacing))
        return Page.parse(header + lacing + body, self.verify_crc)[0]

    def close(self):
        self.file.close()


class PageWriter:
    """writes Pages to a binary file"""

    def __init__(self, file):
        self.file = file

    def write(self, page):
        self.file.write(page.build())

    def close(self):
        self.file.close()


class PacketReader:
    """assembles packets from a PageReader's pages; ``page`` is the page
    the last segment read came from"""

    def __init__(self, pagereader):
        self.pagereader = pagereader
        self.page = None
        self.segment_index = 0

    def read_segment(self):
        while (self.page is None or
               self.segment_index >= len(self.page.segments)):
            self.page = self.pagereader.read()
            self.segment_index = 0
        segment = self.page.segments[self.segment_index]
        self.segment_index += 1
        return segment

    def read_packet(self):
        """the next whole packet's bytes; IOError past the last page"""
        segments = [self.read_segment()]
        while len(segments[-1]) == 255:
            segments.append(self.read_segment())
        return b"".join(segments)

    def current_granule(self):
        return self.page.granule_position if self.page else 0

    def close(self):
        self.pagereader.close()


def packet_to_segments(packet):
    """yields the lacing segments of one packet: 255-byte pieces, then a
    shorter one (empty when the packet's length is a multiple of 255)"""
    while len(packet) >= 255:
        yield packet[0:255]
        packet = packet[255:]
    yield packet


def packet_to_pages(packet, bitstream_serial_number,
                    starting_sequence_number=0):
    """yields the Pages of one packet, each after the first flagged as
    a continued packet"""
    page = Page(False, False, False, 0, bitstream_serial_number,
                starting_sequence_number, [])
    for segment in packet_to_segments(packet):
        if page.full():
            yield page
            starting_sequence_number += 1
            page = Page(True, False, False, 0, bitstream_serial_number,
                        starting_sequence_number, [])
        page.append(segment)
    yield page


def packets_to_pages(packets, bitstream_serial_number,
                     starting_sequence_number=0):
    """yields Pages holding many packets, each page filled with as many
    segments as it holds"""
    page = Page(False, False, False, 0, bitstream_serial_number,
                starting_sequence_number, [])
    for packet in packets:
        for segment in packet_to_segments(packet):
            if page.full():
                yield page
                starting_sequence_number += 1
                page = Page(len(page.segments[-1]) == 255, False, False, 0,
                            bitstream_serial_number,
                            starting_sequence_number, [])
            page.append(segment)
    yield page
