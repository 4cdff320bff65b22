"""FLAC's CRCs: the frame header's CRC-8 (poly 0x07) and the frame's
CRC-16 (poly 0x8005), table-driven, the tables generated from the
polynomials."""

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


def crc8(data):
    value = 0
    for byte in data:
        value = int(CRC8_TABLE[value ^ byte])
    return value


def crc16(data):
    value = 0
    for byte in data:
        value = int(CRC16_TABLE[(value >> 8) ^ byte] ^ ((value << 8) & 0xFFFF))
    return value
