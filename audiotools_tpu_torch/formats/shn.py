"""The Shorten file writer.

Port of the write path of the reference's ``ShortenAudio.from_pcm``
(``audiotools_tpu/formats/shn.py``): a minimal RIFF/WAVE header in the
leading VERBATIM chunk, then the stream that ``codecs.shn.encode_shn``
writes (``encode_samples``, its form for samples in hand).  8- and
16-bit PCM only, 8-bit stored unsigned as WAVE has it.  Metadata and
the AIFF writer are not ported.
"""

from __future__ import annotations

import struct

from ..codecs.shn import encode_samples
from ..pcm import read_all
from .wav import build_fmt


def wave_header(channels, sample_rate, bits_per_sample, channel_mask,
                data_size):
    """the RIFF/WAVE header of a PCM stream of data_size bytes: the fmt
    chunk and the data chunk's header"""
    fmt = build_fmt(channels, sample_rate, bits_per_sample, channel_mask)
    return (b"RIFF" + struct.pack("<I", 4 + 8 + len(fmt) + 8 + data_size) +
            b"WAVE" + b"fmt " + struct.pack("<I", len(fmt)) + fmt +
            b"data" + struct.pack("<I", data_size))


def write_shn(file_or_path, pcmreader, total_pcm_frames=None, block_size=256,
              device="cuda", timings=None):
    """encodes a Shorten file from a PCMReader

    file_or_path: a path or a writable binary file.  The PCM is read
    whole first (the WAVE header carries its length); with
    total_pcm_frames, a reader that gives another count raises
    ValueError and nothing is written.  device and timings as in
    ``codecs.shn.encode_shn``.  The reader is closed at the end."""
    try:
        bps = pcmreader.bits_per_sample
        if bps not in (8, 16):
            raise ValueError("Shorten takes 8- or 16-bit PCM, not %r"
                             % (bps,))
        samples = read_all(pcmreader)
        frames = samples.shape[0]
        if total_pcm_frames is not None and frames != total_pcm_frames:
            raise ValueError("total PCM frames mismatch")
        header = wave_header(pcmreader.channels, pcmreader.sample_rate, bps,
                             pcmreader.channel_mask,
                             frames * pcmreader.channels * (bps // 8))
        encode_samples(file_or_path, samples, bps, is_big_endian=False,
                       signed_samples=(bps != 8), header_data=header,
                       block_size=block_size, device=device, timings=timings)
    finally:
        pcmreader.close()
