"""The TTA container writer.

Port of the write path of the reference's ``TrueAudio.from_pcm``
(``audiotools_tpu/formats/tta.py``): the TTA1 header with its CRC, the
seektable of frame lengths with its CRC, then the frames that
``codecs.tta.encode_tta`` writes, with the filters on a torch device.
ID3 tags are not ported.
"""

from __future__ import annotations

import contextlib
import io
import struct

from ..codecs.tta import encode_tta
from ..pcm import CounterPCMReader
from ..ref.tta import crc32, div_ceil


def build_header(channels, bits_per_sample, sample_rate, total_pcm_frames):
    """the 22-byte TTA1 header including its CRC"""
    data = b"TTA1" + struct.pack("<HHHII", 1, channels, bits_per_sample,
                                 sample_rate, total_pcm_frames)
    return data + crc32(data).to_bytes(4, "little")


def build_seektable(frame_sizes):
    """the seektable bytes (32-bit little-endian lengths and a CRC)"""
    data = b"".join(struct.pack("<I", size) for size in frame_sizes)
    return data + crc32(data).to_bytes(4, "little")


def write_tta(file_or_path, pcmreader, total_pcm_frames=None, device="cuda",
              timings=None):
    """encodes a TTA file from a PCMReader

    file_or_path: a path or a writable, seekable binary file.  With
    total_pcm_frames the header and a zeroed seektable are written
    first and the seektable is filled in at the end, as the reference
    does (ValueError when the reader gives another count); without it
    the frames are encoded first.  device and timings as in
    ``codecs.tta.encode_tta``.  The reader is closed at the end.

    returns the frame lengths in bytes"""
    counter = CounterPCMReader(pcmreader)
    if isinstance(file_or_path, str):
        opened = open(file_or_path, "wb")
    else:
        opened = contextlib.nullcontext(file_or_path)
    try:
        with opened as f:
            if total_pcm_frames is not None:
                total_tta_frames = div_ceil(total_pcm_frames * 245,
                                            pcmreader.sample_rate * 256)
                f.write(build_header(pcmreader.channels,
                                     pcmreader.bits_per_sample,
                                     pcmreader.sample_rate,
                                     total_pcm_frames))
                seektable_offset = f.tell()
                f.write(build_seektable([0] * total_tta_frames))
                frame_sizes = encode_tta(f, counter, device=device,
                                         timings=timings)
                if counter.frames_written != total_pcm_frames:
                    raise ValueError("total PCM frames mismatch")
                end = f.tell()
                f.seek(seektable_offset, 0)
                f.write(build_seektable(frame_sizes))
                f.seek(end, 0)
            else:
                frames = io.BytesIO()
                frame_sizes = encode_tta(frames, counter, device=device,
                                         timings=timings)
                f.write(build_header(pcmreader.channels,
                                     pcmreader.bits_per_sample,
                                     pcmreader.sample_rate,
                                     counter.frames_written))
                f.write(build_seektable(frame_sizes))
                f.write(frames.getbuffer())
        return frame_sizes
    finally:
        pcmreader.close()
