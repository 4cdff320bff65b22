"""ALAC encode on a torch device, and the host ALAC decoder.

Port of the reference's ``audiotools_tpu/codecs/alac_fast.py``.
ALAC's residual filter and its Rice variant adapt per sample, so each
frameset is emitted on the host by the port's copy of the reference's
C++ emitter (``_native.alac_emit_framesets``); the batchable front
half, the LPC candidates of every (block, group, leftweight, channel),
runs on the device (``ops/alac_frames.py``).  Per batch of blocks:

1. the blocks go up as int16 (bps <= 16) or int32 through a pinned
   host buffer, on a side CUDA stream;
2. ``alac_frames.analyze_framesets_packed`` runs on the device and its
   packed candidate rows come back to pinned host memory;
3. the emitter picks each group's leftweight and order from the
   candidates' estimates and writes the framesets.

Batch i+1 is submitted before batch i is emitted, so the card works
on batch i+1 while the host emits batch i.  The device sees the exact
samples: the reference's quantized upload (its ``ATPU_ALAC_QPACK``
wire and floor retry) is not ported, so the output equals the
reference's with ``ATPU_ALAC_QPACK=0``.  A short final block is
zero-padded to a whole block for the analysis and emitted at its true
length, as in the reference.

``FastALACDecoder`` is the reference's host decoder: the atom parse
(``ref/alac.read_m4a_header``), frameset decode in C++
(``_native.alac_decode``) and seeking through the stsz table.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from .. import _native, pcm
from .._device import resolve_device
from ..ops import alac_frames, lpc as lpc_ops
from ..ref import alac as oracle

# blocks per device batch: 1024 stereo 4096-sample blocks are 16 MB of
# int16 upload and about 10 GB of analysis temporaries on the card
BATCH_FRAMES = 1024

# per-stage seconds reported through encode_mdat_fast(timings=...)
STAGES = ("upload", "analysis", "fetch", "emit")


class _Batch:
    """one submitted batch: its host blocks and their true lengths, the
    packed candidates on their way to host memory, and what times its
    device stages"""

    def __init__(self, blocks, ns):
        self.blocks = blocks
        self.ns = ns
        self.host = None        # packed candidates
        self.events = None      # CUDA: stage boundary events
        self.cpu_times = None   # CPU: (upload, analysis, fetch) s


def encode_mdat_fast(file, pcmreader,
                     block_size=4096,
                     initial_history=10,
                     history_multiplier=40,
                     maximum_k=14,
                     interlacing_shift=2,
                     min_interlacing_leftweight=0,
                     max_interlacing_leftweight=4,
                     batch_frames=BATCH_FRAMES,
                     device="cuda",
                     timings=None):
    """writes an mdat atom from a PCMReader's data to a binary file,
    with the analysis on a torch device

    device: "cuda" (raises when no card is usable) or "cpu" (the plain
    versions, for tests).  timings: optional dict that receives seconds
    per stage (STAGES; on a card the device stages are timed with CUDA
    events).

    returns (frame_byte_sizes, total_pcm_frames)"""
    dev = resolve_device(device)
    on_cuda = dev.type == "cuda"
    channels = pcmreader.channels
    bps = pcmreader.bits_per_sample
    layout = oracle.FRAMESET_LAYOUT.get(channels)
    if layout is None:
        raise ValueError("unsupported channel count")
    if bps > 16 and (bps - 16) % 8:
        # the low bits bypass the coder in whole bytes
        raise ValueError("bits_per_sample %d unsupported: bps - 16 must "
                         "be a multiple of 8" % (bps,))
    lsb_shift = (bps - 16) if bps > 16 else 0
    window = lpc_ops.tukey_window(block_size, dev)
    (np_upload, upload_dtype) = ((np.int16, torch.int16) if bps <= 16
                                 else (np.int32, torch.int32))
    copy_stream = torch.cuda.Stream(dev) if on_cuda else None
    stage_seconds = dict.fromkeys(STAGES, 0.0)

    def submit(blocks, ns):
        """enqueues one batch's upload, analysis and fetch; returns
        without waiting for the device"""
        batch = _Batch(blocks, ns)
        t0 = time.perf_counter()
        if on_cuda:
            host = torch.empty(blocks.shape, dtype=upload_dtype,
                               pin_memory=True)
            np.copyto(host.numpy(), blocks, casting="unsafe")
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(5)]
            with torch.cuda.stream(copy_stream):
                ev[0].record()
                dev_blocks = host.to(dev, non_blocking=True)
                ev[1].record()
            compute = torch.cuda.current_stream(dev)
            compute.wait_stream(copy_stream)
            dev_blocks.record_stream(compute)
            ev[2].record()
        else:
            dev_blocks = torch.from_numpy(blocks.astype(np_upload))
        t1 = time.perf_counter()
        packed = alac_frames.analyze_framesets_packed(
            dev_blocks, layout, lsb_shift, interlacing_shift,
            min_interlacing_leftweight, max_interlacing_leftweight, window)
        t2 = time.perf_counter()
        if on_cuda:
            ev[3].record()
            batch.host = torch.empty(packed.shape, dtype=packed.dtype,
                                     pin_memory=True)
            batch.host.copy_(packed, non_blocking=True)
            ev[4].record()
            batch.events = ev
        else:
            batch.host = packed
            batch.cpu_times = (t1 - t0, t2 - t1, 0.0)
        return batch

    total_pcm_frames = 0
    frame_byte_sizes = []
    mdat_start = file.tell()
    file.write(b"\x00" * 4 + b"mdat")

    def emit(batch):
        """waits for one batch's candidates and emits its framesets"""
        if on_cuda:
            ev = batch.events
            ev[4].synchronize()
            ms = (ev[0].elapsed_time(ev[1]), ev[2].elapsed_time(ev[3]),
                  ev[3].elapsed_time(ev[4]))
            for (stage, t) in zip(STAGES, ms):
                stage_seconds[stage] += t / 1e3
        else:
            for (stage, t) in zip(STAGES, batch.cpu_times):
                stage_seconds[stage] += t
        t0 = time.perf_counter()
        (data, lens) = _native.alac_emit_framesets(
            batch.blocks, batch.ns, layout, batch.host.numpy(), block_size,
            initial_history, history_multiplier, maximum_k,
            interlacing_shift, min_interlacing_leftweight,
            max_interlacing_leftweight, bps)
        file.write(data)
        frame_byte_sizes.extend(int(v) for v in lens)
        stage_seconds["emit"] += time.perf_counter() - t0

    reader = pcm.BufferedPCMReader(pcmreader)
    pending = None
    while True:
        framelist = reader.read(block_size * batch_frames)
        if framelist.frames == 0:
            break
        total_pcm_frames += framelist.frames
        samples = framelist.samples
        n_full = samples.shape[0] // block_size
        tail = samples[n_full * block_size:]
        if n_full:
            blocks = np.ascontiguousarray(samples[:n_full * block_size]
                                          .reshape(n_full, block_size,
                                                   channels))
            ns = np.full(n_full, block_size, dtype=np.int32)
        else:
            blocks = np.zeros((0, block_size, channels), dtype=np.int32)
            ns = np.zeros(0, dtype=np.int32)
        if tail.shape[0]:
            # zero-padded to a whole block for the analysis; the emitter
            # codes only the true count
            padded = np.zeros((1, block_size, channels), dtype=np.int32)
            padded[0, :tail.shape[0]] = tail
            blocks = np.concatenate([blocks, padded])
            ns = np.concatenate([ns, [tail.shape[0]]]).astype(np.int32)
        batch = submit(blocks, ns)
        # the device works on this batch while the host emits the
        # previous one
        if pending is not None:
            emit(pending)
        pending = batch
    if pending is not None:
        emit(pending)

    end = file.tell()
    file.seek(mdat_start)
    file.write((sum(frame_byte_sizes) + 8).to_bytes(4, "big"))
    file.seek(end)
    if timings is not None:
        for (stage, t) in stage_seconds.items():
            timings[stage] = timings.get(stage, 0.0) + t
    return (frame_byte_sizes, total_pcm_frames)


class FastALACDecoder:
    """a PCMReader decoding the ALAC stream of an M4A file on the host

    Reads CHUNK_BYTES of frameset data at a time and decodes whole
    framesets with the C++ decoder; seek() uses the stsz table."""

    CHUNK_BYTES = 0x200000

    def __init__(self, file_or_path):
        if isinstance(file_or_path, str):
            self.file = open(file_or_path, "rb")
        else:
            self.file = file_or_path
        try:
            header = oracle.read_m4a_header(self.file)
        except ValueError:
            if isinstance(file_or_path, str):
                self.file.close()
            raise
        for (key, value) in header.items():
            setattr(self, key, value)
        self.file.seek(self.mdat_offset)
        self._buffer = b""
        self._remaining = self.total_pcm_frames
        self._eof = False

    def seekable(self):
        return True

    def seek(self, pcm_frame):
        """seeks to the frameset holding the given PCM frame; returns
        the position actually seeked to (at or before the requested
        one)"""
        sizes = self.frame_sizes
        target = max(min(int(pcm_frame), self.total_pcm_frames), 0)
        index = (min(target // self.samples_per_frame,
                     max(len(sizes) - 1, 0)) if sizes else 0)
        self.file.seek(self.mdat_offset + sum(sizes[:index]))
        self._buffer = b""
        self._eof = False
        position = index * self.samples_per_frame
        self._remaining = self.total_pcm_frames - position
        self._after_seek()
        return position

    def _after_seek(self):
        pass

    def _fill(self, size):
        """tops the buffer up to ``size`` bytes unless the file ends"""
        while len(self._buffer) < size and not self._eof:
            chunk = self.file.read(size - len(self._buffer))
            if not chunk:
                self._eof = True
                break
            self._buffer += chunk

    def read(self, pcm_frames):
        if self._remaining <= 0:
            return pcm.empty_framelist(self.channels, self.bits_per_sample)
        self._fill(self.CHUNK_BYTES)
        want = min(max(pcm_frames, self.samples_per_frame), self._remaining)
        (samples, consumed) = _native.alac_decode(
            self._buffer, self.bits_per_sample, self.channels,
            self.samples_per_frame, self.initial_history,
            self.history_multiplier, self.maximum_k, want)
        if samples.shape[0] == 0 and self._eof and consumed == 0:
            raise IOError("truncated ALAC stream")
        self._buffer = self._buffer[consumed:]
        self._remaining -= samples.shape[0]
        return pcm.FrameList(np.ascontiguousarray(samples),
                             self.bits_per_sample)

    def close(self):
        self.file.close()
