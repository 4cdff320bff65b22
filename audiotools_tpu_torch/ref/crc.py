"""CRC primitives for FLAC (CRC-8 poly 0x07, CRC-16 poly 0x8005) and
TTA (CRC-32), table-driven, the tables generated from the polynomials.

Copy of the reference package's ``ref/crc.py``: the tables and the
streaming ``CRC8``/``CRC16`` callbacks of the scalar FLAC decoder.
"""

from __future__ import annotations

import numpy as np


def _make_table(poly, width):
    table = np.zeros(256, dtype=np.uint32)
    top = 1 << (width - 1)
    mask = (1 << width) - 1
    for byte in range(256):
        crc = byte << (width - 8)
        for _ in range(8):
            if crc & top:
                crc = ((crc << 1) ^ poly) & mask
            else:
                crc = (crc << 1) & mask
        table[byte] = crc
    return table


CRC8_TABLE = _make_table(0x07, 8)
CRC16_TABLE = _make_table(0x8005, 16)


def _make_crc32_table():
    # reflected CRC-32 (poly 0xEDB88320), zlib-compatible, used by TTA
    table = np.zeros(256, dtype=np.uint32)
    for byte in range(256):
        crc = byte
        for _ in range(8):
            if crc & 1:
                crc = (crc >> 1) ^ 0xEDB88320
            else:
                crc >>= 1
        table[byte] = crc
    return table


CRC32_TABLE = _make_crc32_table()


class CRC8:
    """a streaming CRC-8 (poly 0x07), usable as a bitstream callback"""

    def __init__(self):
        self.value = 0

    def __int__(self):
        return int(self.value)

    def update(self, byte):
        self.value = int(CRC8_TABLE[self.value ^ byte])


class CRC16:
    """a streaming CRC-16 (poly 0x8005), usable as a bitstream callback"""

    def __init__(self):
        self.value = 0

    def __int__(self):
        return int(self.value)

    def update(self, byte):
        self.value = int(CRC16_TABLE[(self.value >> 8) ^ byte] ^
                         ((self.value << 8) & 0xFFFF))
