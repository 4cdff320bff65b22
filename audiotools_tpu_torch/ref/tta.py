"""What the port's TTA paths need of the reference's TTA oracle
(``audiotools_tpu/ref/tta.py``): the frame size, the CRC-32, and the
header and seektable parse of its ``TTADecoder``.

TTA's CRC-32 is the reflected polynomial 0xEDB88320 with initial value
and final xor 0xFFFFFFFF, which is zlib's ``crc32``.
"""

from __future__ import annotations

import struct
import zlib


def div_ceil(n, d):
    return n // d + (1 if (n % d) else 0)


def block_size_for(sample_rate):
    """PCM frames per TTA frame (about 1.045 s)"""
    return (sample_rate * 256) // 245


def crc32(data):
    return zlib.crc32(data)


def read_tta_header(file):
    """parses a TTA1 stream's header and seektable from a binary file
    at the stream's start, leaving it at the first frame

    Returns a dict: channels, bits_per_sample, sample_rate,
    total_pcm_frames, channel_mask, block_size, total_tta_frames and
    frame_lengths (bytes per TTA frame, from the seektable).  Raises
    ValueError on a bad signature or format, a short read, or a header
    or seektable CRC that does not match."""
    header = file.read(22)
    if len(header) < 22 or header[:4] != b"TTA1":
        raise ValueError("invalid TTA signature")
    (format_, channels, bits_per_sample, sample_rate,
     total_pcm_frames) = struct.unpack("<HHHII", header[4:18])
    if format_ != 1:
        raise ValueError("invalid TTA format")
    if struct.unpack("<I", header[18:22])[0] != crc32(header[:18]):
        raise ValueError("invalid TTA header CRC")
    if not channels or not sample_rate:
        raise ValueError("invalid TTA header")
    total_tta_frames = div_ceil(total_pcm_frames * 245, sample_rate * 256)
    table = file.read(total_tta_frames * 4 + 4)
    if len(table) < total_tta_frames * 4 + 4:
        raise ValueError("truncated TTA seektable")
    if (struct.unpack("<I", table[-4:])[0] !=
            crc32(table[:total_tta_frames * 4])):
        raise ValueError("invalid TTA seektable CRC")
    return dict(channels=channels, bits_per_sample=bits_per_sample,
                sample_rate=sample_rate, total_pcm_frames=total_pcm_frames,
                channel_mask={1: 0x4, 2: 0x3}.get(channels, 0),
                block_size=block_size_for(sample_rate),
                total_tta_frames=total_tta_frames,
                frame_lengths=list(struct.unpack(
                    "<%dI" % (total_tta_frames,),
                    table[:total_tta_frames * 4])))
