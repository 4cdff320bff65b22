"""The WAVE fmt chunk, as the Shorten writer embeds it.

A copy of ``build_fmt`` of the reference's ``audiotools_tpu/formats/wav.py``
with its constants.  The WAVE container itself is not ported.
"""

from __future__ import annotations

import struct

WAVE_FORMAT_PCM = 0x0001
WAVE_FORMAT_EXTENSIBLE = 0xFFFE
EXTENSIBLE_GUID = (b"\x00\x00\x00\x00\x10\x00\x80\x00"
                   b"\x00\xaa\x00\x38\x9b\x71")


def build_fmt(channels, sample_rate, bits_per_sample, channel_mask):
    """returns a fmt chunk body from the given stream attributes

    uses plain PCM for 1-2 channel streams and WAVEFORMATEXTENSIBLE
    for anything else"""
    block_align = channels * (bits_per_sample // 8)
    bytes_per_second = sample_rate * block_align
    if (channels <= 2) and (bits_per_sample <= 16):
        return struct.pack("<HHIIHH",
                           WAVE_FORMAT_PCM, channels, sample_rate,
                           bytes_per_second, block_align, bits_per_sample)
    return (struct.pack("<HHIIHHHHI",
                        WAVE_FORMAT_EXTENSIBLE, channels, sample_rate,
                        bytes_per_second, block_align, bits_per_sample,
                        22, bits_per_sample, int(channel_mask)) +
            b"\x01\x00" + EXTENSIBLE_GUID)
