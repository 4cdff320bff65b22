"""PCM in and out around the port's encoder.

The reader and the FLAC frame decoder are the reference's host layers
(``audiotools_tpu.pcm``, ``pcmstream`` and the ``_native`` C++
decoder), which load without jax.  They are re-exported here so that a
caller of the port names no module of the reference package.
"""

from __future__ import annotations

import io

import numpy as np

from audiotools_tpu import _native
from audiotools_tpu.pcm import FrameList
from audiotools_tpu.pcmstream import PCMReader

# channel masks of the WAVE/FLAC default layouts, by channel count
_CHANNEL_MASKS = {1: 0x4, 2: 0x3}


def reader_from_array(samples, bits_per_sample, sample_rate=44100):
    """a PCMReader over int32 ``samples`` [frames, channels]"""
    samples = np.asarray(samples, dtype=np.int32)
    channels = samples.shape[1]
    data = FrameList._wrap(samples, bits_per_sample).to_bytes(False, True)
    return PCMReader(io.BytesIO(data), sample_rate, channels,
                     _CHANNEL_MASKS.get(channels, 0), bits_per_sample)


def streaminfo(data):
    """(sample_rate, channels, bits_per_sample, total_frames,
    first_frame_offset) of a FLAC stream's bytes

    raises ValueError when the bytes do not start with a FLAC header
    and a STREAMINFO block"""
    if data[:4] != b"fLaC" or len(data) < 42 or data[4] & 0x7F != 0:
        raise ValueError("not a FLAC stream with a leading STREAMINFO")
    info = int.from_bytes(data[18:26], "big")
    sample_rate = info >> 44
    channels = ((info >> 41) & 0x7) + 1
    bits_per_sample = ((info >> 36) & 0x1F) + 1
    total_frames = info & ((1 << 36) - 1)
    offset = 4
    while True:
        last = data[offset] >> 7
        offset += 4 + int.from_bytes(data[offset + 1:offset + 4], "big")
        if last:
            break
    return (sample_rate, channels, bits_per_sample, total_frames, offset)


def decode_flac(data):
    """a whole FLAC stream's bytes -> int32 samples [frames, channels]

    every frame's CRC and the stream's MD5 are checked; raises
    ValueError when the frames hold fewer samples than STREAMINFO
    announces or their MD5 is not the one it records"""
    (_rate, channels, bps, total, offset) = streaminfo(data)
    md5 = _native.MD5()
    (samples, _consumed) = _native.flac_decode(data[offset:], bps,
                                                channels, total, md5=md5)
    if samples.shape[0] != total:
        raise ValueError("decoded %d of %d frames"
                         % (samples.shape[0], total))
    if md5.digest() != bytes(data[26:42]):
        raise ValueError("decoded samples do not match the stream's MD5")
    return samples
