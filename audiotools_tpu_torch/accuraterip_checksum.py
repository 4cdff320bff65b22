"""AccurateRip track checksums (V1 and V2) on a device, and their NumPy
oracles.

The port's counterpart of the reference's ``accuraterip_checksum.py``:
offset-windowed multiply-accumulate sums over CD-format PCM, in exact
int64 (``ops.converters.accuraterip_sums``).  The running sums stay on
the device, so feeding a chunk never waits for it; ``checksums()``
fetches them.  ``ChecksumV1`` and ``ChecksumV2`` are the reference's
NumPy oracles, copied: FrameList in, int64 products masked to 32 bits,
for holding ``AccurateRipCRC`` to on the host.
"""

from __future__ import annotations

import numpy as np
import torch

from ._device import StageMarks, resolve_device
from .codecs.flac_dec import upload_arrays
from .ops import converters


class _ChecksumBase:
    """the NumPy oracles' window: the first track skips the first 5 CD
    frames' worth of samples; the last track stops 5 CD frames early"""

    def __init__(self, is_first, is_last, sample_rate,
                 total_pcm_frames):
        if sample_rate <= 0:
            raise ValueError("sample rate must be > 0")
        if total_pcm_frames <= 0:
            raise ValueError("total PCM frames must be > 0")
        self.track_index = 1
        self.checksum_value = 0
        if is_first:
            self.start_offset = (sample_rate // 75) * 5
        else:
            self.start_offset = 0
        if is_last:
            self.end_offset = total_pcm_frames - (sample_rate // 75) * 5
        else:
            self.end_offset = total_pcm_frames

    def _values_and_indices(self, framelist):
        if framelist.channels != 2:
            raise ValueError("FrameList must be 2 channels")
        if framelist.bits_per_sample != 16:
            raise ValueError("FrameList must be 16 bits per sample")
        samples = framelist.samples.astype(np.int64)
        left_u = np.where(samples[:, 0] >= 0, samples[:, 0],
                          (1 << 16) + samples[:, 0])
        right_u = np.where(samples[:, 1] >= 0, samples[:, 1],
                           (1 << 16) + samples[:, 1])
        values = (right_u << 16) | left_u
        indices = np.arange(self.track_index,
                            self.track_index + framelist.frames,
                            dtype=np.int64)
        self.track_index += framelist.frames
        mask = ((indices >= self.start_offset) &
                (indices <= self.end_offset))
        return (values[mask], indices[mask])

    def checksum(self):
        """returns the current checksum as a 32-bit unsigned int"""
        return self.checksum_value & 0xFFFFFFFF


class ChecksumV1(_ChecksumBase):
    """the AccurateRip version-1 checksum"""

    def update(self, framelist):
        """processes a 2-channel, 16-bit FrameList"""
        (values, indices) = self._values_and_indices(framelist)
        products = (values * indices) & 0xFFFFFFFF
        self.checksum_value = (self.checksum_value +
                               int(products.sum())) & 0xFFFFFFFF


class ChecksumV2(_ChecksumBase):
    """the AccurateRip version-2 checksum (adds the high-order bits)"""

    def update(self, framelist):
        (values, indices) = self._values_and_indices(framelist)
        products = values * indices          # exact in int64
        low = products & 0xFFFFFFFF
        high = products >> 32
        self.checksum_value = (self.checksum_value +
                               int(low.sum()) +
                               int(high.sum())) & 0xFFFFFFFF


class AccurateRipCRC:
    """V1 and V2 in one pass, on ``device``

    the checksum window (the reference's ``_ChecksumBase``): the first
    track skips its first 5 CD frames' worth of samples, the last track
    stops 5 CD frames early.  Feed int32 [n, 2] sample arrays (16-bit
    range) to ``update_array`` in stream order; ``timings`` accumulates
    the seconds of the chunks' uploads and sums (CUDA-event spans on a
    card), read by ``checksums()``."""

    def __init__(self, is_first, is_last, sample_rate, total_pcm_frames,
                 device="cuda"):
        if sample_rate <= 0:
            raise ValueError("sample rate must be > 0")
        if total_pcm_frames <= 0:
            raise ValueError("total PCM frames must be > 0")
        self.track_index = 1
        self.start_offset = (sample_rate // 75) * 5 if is_first else 0
        self.end_offset = (total_pcm_frames - (sample_rate // 75) * 5
                           if is_last else total_pcm_frames)
        self.device = resolve_device(device)
        self.v1 = torch.zeros((), dtype=torch.int64, device=self.device)
        self.v2 = torch.zeros((), dtype=torch.int64, device=self.device)
        self.marks = []
        self.timings = {"upload": 0.0, "sums": 0.0}

    def update_array(self, samples):
        """samples: int32 [n, 2] in 16-bit range"""
        samples = np.asarray(samples)
        if samples.ndim != 2 or samples.shape[1] != 2:
            raise ValueError("samples must be [n, 2]")
        marks = StageMarks(self.device)
        marks.mark()
        x = upload_arrays({"x": samples}, self.device)["x"]
        marks.mark()
        (low, high) = converters.accuraterip_sums(
            x, self.track_index, self.start_offset, self.end_offset)
        self.v1 = (self.v1 + low) & 0xFFFFFFFF
        self.v2 = (self.v2 + low + high) & 0xFFFFFFFF
        marks.mark()
        self.marks.append(marks)
        self.track_index += samples.shape[0]

    # the single checksum of the reference's one-version classes, which
    # this two-version class never sets: checksum() is 0, as there
    checksum_value = 0

    def checksum(self):
        return self.checksum_value & 0xFFFFFFFF

    def checksums(self):
        """(v1, v2), each a 32-bit unsigned int"""
        for marks in self.marks:
            for (name, seconds) in zip(("upload", "sums"), marks.seconds()):
                self.timings[name] += seconds
        self.marks = []
        return (int(self.v1), int(self.v2))


def accuraterip_checksums(pcmreader, total_pcm_frames, is_first=False,
                          is_last=False, sample_rate=44100, device="cuda"):
    """(v1, v2) of a whole PCMReader of 2-channel 16-bit PCM"""
    crc = AccurateRipCRC(is_first, is_last, sample_rate, total_pcm_frames,
                         device)
    frame = pcmreader.read(1 << 16)
    while frame.frames > 0:
        if frame.channels != 2:
            raise ValueError("FrameList must be 2 channels")
        if frame.bits_per_sample != 16:
            raise ValueError("FrameList must be 16 bits per sample")
        crc.update_array(frame.samples)
        frame = pcmreader.read(1 << 16)
    return crc.checksums()
