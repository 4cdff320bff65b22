"""TTA encode and decode with the per-sample filters on a torch device.

Port of the reference's ``audiotools_tpu/codecs/tta.py``:

* ``encode_tta`` (the reference's ``ATPU_TTA_BACKEND=jax`` branch): per
  batch of ENC_BATCH_FRAMES TTA frames, the PCM goes up, the device
  runs the channel decorrelation, the fixed predictor and the hybrid
  filter (``ops/tta_scan.analyze_frames``, the filter a hand-written
  kernel, one lane per frame and channel), and the residuals come back
  for the host's adaptive Rice coder and CRC-32
  (``_native.tta_pack_frames``).  The port's all-host C++ encoder
  (``_native.tta_encode_frames``) is kept as the tests' independent
  check; no entry point falls back to it;
* ``FastTTADecoder``: the C++ frame decoder, one TTA frame per read,
  with seeking through the seektable;
* ``TorchTTADecoder`` (the reference's ``JaxTTADecoder``): per group
  of DEC_GROUP_FRAMES frames, the host unpacks the adaptive Rice codes
  (``_native.tta_scan_residuals``, CRC-checked), the device inverts the
  hybrid filter and the fixed predictor
  (``tta_synth.inverse_filter_predict``, one lane per frame and
  channel) and undoes the channel decorrelation; 8- and 16-bit
  streams come back as int16.
"""

from __future__ import annotations

import io
import time

import numpy as np
import torch

from .. import _native, pcm
from .._device import StageMarks, fetch_async, resolve_device
from ..ops import tta_scan, tta_synth
from ..ref import tta as oracle
from .flac_dec import upload_arrays

# TTA frames per device decode group: the frames are independent lanes
# (the filter state starts afresh in each), so the group sets only the
# kernel's parallelism (one thread a lane) and the memory a group
# holds; the output does not depend on it.  256 frames of 44.1 kHz
# stereo are 512 lanes of 46,080 samples, 94 MB of residual planes
# (about 4.5 minutes of audio); the reference's 32 would give the
# kernel 64 threads.
DEC_GROUP_FRAMES = 256

# TTA frames per device encode batch, for the same reason: 512 lanes
# for the filter kernel; the output does not depend on it
ENC_BATCH_FRAMES = DEC_GROUP_FRAMES

# per-stage seconds accumulated in TorchTTADecoder.timings: the host
# Rice unpack, then the device stages (CUDA-event spans on a card)
STAGES = ("scan", "upload", "synth", "finish", "fetch")

# per-stage seconds accumulated by encode_tta(timings=...): the device
# stages, then the host Rice coder
ENCODE_STAGES = ("upload", "analysis", "fetch", "pack")


def encode_tta(file, pcmreader, device="cuda", timings=None):
    """writes TTA frames from a PCMReader to a binary file, with the
    filters on a torch device

    device: "cuda" (raises when no card is usable) or "cpu" (the plain
    versions, for tests).  timings: optional dict that receives seconds
    per ENCODE_STAGES.  Returns the frame lengths in bytes."""
    dev = resolve_device(device)
    block_size = oracle.block_size_for(pcmreader.sample_rate)
    bps = pcmreader.bits_per_sample
    channels = pcmreader.channels
    reader = pcm.BufferedPCMReader(pcmreader)
    frame_sizes = []
    while True:
        samples = reader.read(block_size * ENC_BATCH_FRAMES).samples
        total = samples.shape[0]
        if total == 0:
            break
        F = -(-total // block_size)
        sizes = np.full(F, block_size, dtype=np.int32)
        sizes[-1] = total - block_size * (F - 1)
        if total != F * block_size:
            # the final frame zero-padded: the filter is causal, so its
            # residuals are a prefix of the padded lane's
            padded = np.zeros((F * block_size, channels), dtype=np.int32)
            padded[:total] = samples
            samples = padded
        marks = StageMarks(dev)
        marks.mark()
        batch = upload_arrays(
            {"samples": samples.reshape(F, block_size, channels)},
            dev)["samples"]
        marks.mark()
        res = tta_scan.analyze_frames(batch, bps).contiguous()
        marks.mark()
        res = fetch_async(res)
        marks.mark()
        t = marks.seconds()
        t0 = time.perf_counter()
        (data, lens) = _native.tta_pack_frames(
            res.numpy().reshape(-1, channels)[:total], sizes, channels)
        t.append(time.perf_counter() - t0)
        if timings is not None:
            for (stage, seconds) in zip(ENCODE_STAGES, t):
                timings[stage] = timings.get(stage, 0.0) + seconds
        file.write(data)
        frame_sizes.extend(int(v) for v in lens)
    return frame_sizes


class FastTTADecoder:
    """a PCMReader decoding a TTA stream on the host, one TTA frame per
    read

    file_or_path: a path or a binary file positioned at the stream's
    header."""

    def __init__(self, file_or_path):
        if isinstance(file_or_path, str):
            self.file = open(file_or_path, "rb")
        else:
            self.file = file_or_path
        try:
            header = oracle.read_tta_header(self.file)
        except ValueError:
            if isinstance(file_or_path, str):
                self.file.close()
            raise
        for (key, value) in header.items():
            setattr(self, key, value)
        self.frames_offset = self.file.tell()
        self.remaining = self.total_pcm_frames
        self.closed = False

    def _frame_index(self):
        """the TTA frame the next read starts in"""
        return self.total_tta_frames - oracle.div_ceil(self.remaining,
                                                       self.block_size)

    def read(self, pcm_frames):
        if self.closed:
            raise ValueError("stream is closed")
        if self.remaining <= 0:
            return pcm.empty_framelist(self.channels, self.bits_per_sample)
        n = min(self.block_size, self.remaining)
        length = self.frame_lengths[self._frame_index()]
        data = self.file.read(length)
        if len(data) < length:
            raise IOError("I/O error reading stream")
        (samples, _consumed) = _native.tta_decode_frame(
            data, n, self.channels, self.bits_per_sample)
        self.remaining -= n
        return pcm.FrameList(samples, self.bits_per_sample)

    def seekable(self):
        return True

    def seek(self, pcm_frame):
        """seeks to the TTA frame holding the given PCM frame; returns
        the position actually seeked to (at or before the requested
        one)"""
        target = max(min(int(pcm_frame), self.total_pcm_frames), 0)
        index = (min(target // self.block_size, self.total_tta_frames - 1)
                 if self.total_tta_frames else 0)
        self.file.seek(self.frames_offset + sum(self.frame_lengths[:index]))
        position = index * self.block_size
        self.remaining = self.total_pcm_frames - position
        self._after_seek()
        return position

    def _after_seek(self):
        pass

    def close(self):
        self.closed = True
        self.file.close()


class TorchTTADecoder(FastTTADecoder):
    """a PCMReader decoding a TTA stream on a torch device

    device: "cuda" (raises when no card is usable) or "cpu" (the plain
    versions, for tests).  read() decodes DEC_GROUP_FRAMES TTA frames
    at a time and serves the caller from the decoded PCM, never more
    frames than asked.  ``timings`` accumulates seconds per STAGES."""

    def __init__(self, file_or_path, device="cuda"):
        self.device = resolve_device(device)
        FastTTADecoder.__init__(self, file_or_path)
        self.timings = dict.fromkeys(STAGES, 0.0)
        self._pcm = None
        self._pcm_off = 0

    def _after_seek(self):
        self._pcm = None
        self._pcm_off = 0

    def read(self, pcm_frames):
        if self.closed:
            raise ValueError("stream is closed")
        if self.remaining <= 0:
            return pcm.empty_framelist(self.channels, self.bits_per_sample)
        if self._pcm is None or self._pcm_off >= self._pcm.shape[0]:
            self._pcm = self._decode_group(self._frame_index())
            self._pcm_off = 0
        take = min(self._pcm.shape[0] - self._pcm_off,
                   max(int(pcm_frames), 1))
        chunk = self._pcm[self._pcm_off:self._pcm_off + take]
        self._pcm_off += take
        self.remaining -= take
        return pcm.FrameList(chunk, self.bits_per_sample)

    def _decode_group(self, g0):
        """decodes TTA frames [g0, g0 + DEC_GROUP_FRAMES) from the file;
        returns their PCM, int32 [frames, channels]"""
        (planes, total) = self.scan_group(g0)
        out = self._synthesize(planes)
        return out.reshape(-1, self.channels)[:total]

    def scan_group(self, g0):
        """the host half of a group: reads TTA frames [g0, g0 +
        DEC_GROUP_FRAMES) and unpacks their Rice codes (checking each
        frame's CRC); returns (residuals int32 [frames, block_size,
        channels], the group's PCM frame count), the stream's last
        frame zero-padded to a whole block (the filter is causal).
        Leaves the file after the group."""
        t0 = time.perf_counter()
        lens = np.asarray(self.frame_lengths, dtype=np.int64)
        g1 = min(g0 + DEC_GROUP_FRAMES, self.total_tta_frames)
        self.file.seek(self.frames_offset + int(lens[:g0].sum()))
        data = self.file.read(int(lens[g0:g1].sum()))
        if len(data) < int(lens[g0:g1].sum()):
            raise IOError("I/O error reading stream")
        (n, ch) = (self.block_size, self.channels)
        sizes = np.full(g1 - g0, n, dtype=np.int32)
        if g1 == self.total_tta_frames:
            sizes[-1] = self.total_pcm_frames - (g1 - 1) * n
        res = _native.tta_scan_residuals(data, lens[g0:g1], sizes, ch)
        total = res.shape[0]
        planes = np.zeros(((g1 - g0) * n, ch), dtype=np.int32)
        planes[:total] = res
        self.timings["scan"] += time.perf_counter() - t0
        return (planes.reshape(g1 - g0, n, ch), total)

    def _synthesize(self, planes):
        """the device stages of one group: int32 [F, n, ch] residuals ->
        int32 [F, n, ch] samples, as numpy"""
        marks = StageMarks(self.device)
        marks.mark()
        res = upload_arrays({"residuals": planes}, self.device)["residuals"]
        marks.mark()
        (F, n, ch) = planes.shape
        lanes = res.permute(0, 2, 1).reshape(F * ch, n)
        x = tta_synth.inverse_filter_predict(lanes, self.bits_per_sample)
        marks.mark()
        samples = tta_synth.decorrelate_inverse(
            x.view(F, ch, n).permute(0, 2, 1))
        out = torch.empty(samples.shape, device=samples.device,
                          dtype=torch.int16 if self.bits_per_sample <= 16
                          else torch.int32)
        out.copy_(samples)
        marks.mark()
        out = fetch_async(out)
        marks.mark()
        for (stage, t) in zip(STAGES[1:], marks.seconds()):
            self.timings[stage] += t
        return out.numpy().astype(np.int32)


def decode_tta(data, device="cuda"):
    """a whole TTA file's bytes -> int32 samples [frames, channels],
    decoded by TorchTTADecoder on ``device``"""
    dec = TorchTTADecoder(io.BytesIO(data), device=device)
    pieces = []
    try:
        while True:
            framelist = dec.read(DEC_GROUP_FRAMES * dec.block_size)
            if framelist.frames == 0:
                break
            pieces.append(framelist.samples)
    finally:
        dec.close()
    if not pieces:
        return np.zeros((0, dec.channels), dtype=np.int32)
    return np.concatenate(pieces, axis=0)
