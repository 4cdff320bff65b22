"""CRC tables for FLAC (CRC-8 poly 0x07, CRC-16 poly 0x8005),
generated from the polynomials.

Copy of the FLAC part of the reference package's ``ref/crc.py``.
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
