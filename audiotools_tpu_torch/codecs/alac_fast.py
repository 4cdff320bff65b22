"""ALAC encode on a torch device, and the host ALAC decoder.

Port of the reference's ``audiotools_tpu/codecs/alac_fast.py``.
ALAC's residual filter and its Rice variant adapt per sample, so each
frameset is emitted on the host by the port's copy of the reference's
C++ emitter (``_native.alac_emit_framesets``); the batchable front
half, the LPC candidates of every (block, group, leftweight, channel),
runs on the device (``ops/alac_frames.py``).  Per batch of blocks:

1. the quantized upload wire, as in the reference (``ATPU_ALAC_QPACK``
   unset or not "0", and block_size > 2): the LSB shift of a > 16-bit
   stream runs on the host first, then one C++ scan
   (``_native.flac_qpack``) plans each (block, channel)'s shift t and
   packs the zigzag first differences of the shifted samples; the wire
   goes up in one pinned upload on a side CUDA stream and
   ``qpack.unpack_wire`` rebuilds ``(x >> t) << t`` on the device.
   With the wire off the blocks go up as int16 (bps <= 16) or int32;
2. ``alac_frames.analyze_framesets_packed`` runs on the device and its
   packed candidate rows come back to pinned host memory;
3. on the wire, the quantization-floor retry (``_floor_retry``): a
   group whose chosen estimate sits at or above the quantization band
   is analysed again from the exact samples on the device, and keeps
   whichever candidate set scores lower;
4. the emitter picks each group's leftweight and order from the
   candidates' estimates and writes the framesets.

Batch i+1 is submitted before batch i is emitted, so the card works
on batch i+1 while the host emits batch i.  A short final block is
zero-padded to a whole block for the analysis (and its plan) and
emitted at its true length, as in the reference.

``FastALACDecoder`` is the reference's host decoder: the atom parse
(``ref/alac.read_m4a_header``), frameset decode in C++
(``_native.alac_decode``) and seeking through the stsz table.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from .. import _native, pcm
from .._device import COUNT_LOCK, resolve_device
from ..ops import alac_frames, lpc as lpc_ops, qpack
from ..ref import alac as oracle

# blocks per device batch: 1024 stereo 4096-sample blocks are 16 MB of
# int16 upload and about 10 GB of analysis temporaries on the card
BATCH_FRAMES = 1024

# process-wide counts for reports, added to under _device.COUNT_LOCK:
# wire batches, and (block, group)s the floor retry analysed again
wire_batches = 0
floor_groups = 0

# per-stage seconds reported through encode_mdat_fast(timings=...):
# qpack (the host scan and wire), the device stages, floor (the floor
# retry's exact re-analysis) and emit
STAGES = ("qpack", "upload", "analysis", "fetch", "floor", "emit")


class _Batch:
    """one submitted batch: its host blocks and their true lengths, the
    wire's t (or None), the packed candidates on their way to host
    memory, and what times its device stages"""

    def __init__(self, blocks, ns, t):
        self.blocks = blocks
        self.ns = ns
        self.t = t
        self.host = None        # packed candidates
        self.events = None      # CUDA: stage boundary events
        self.cpu_times = None   # CPU: (upload, analysis, fetch) s


def _bit_length(v):
    """bit_length of each value of a non-negative int64 array"""
    v = np.asarray(v, dtype=np.int64).copy()
    bl = np.zeros_like(v)
    while (v > 0).any():
        bl += v > 0
        v >>= 1
    return bl


def _pick_scores(rows, min_lw, max_lw, width):
    """(order [B, width], est [B, width], group score [B]) of packed
    candidate rows [B, N_LEFTWEIGHTS, 2, COLS]: the emitter's choice of
    leftweight (lowest summed min(est4, est8), ties to the lowest) and
    of each channel's order (ref.alac.pick_candidate), batched"""
    B = rows.shape[0]
    if width == 1:
        ch_rows = rows[:, 0, 0:1]                # [B, 1, COLS]
    else:
        ests = rows[:, min_lw:max_lw + 1, :, 13:15].astype(np.int64)
        score = ests.min(axis=3).sum(axis=2)     # [B, L]
        lw_idx = score.argmin(axis=1) + min_lw
        ch_rows = rows[np.arange(B), lw_idx]     # [B, 2, COLS]
    deg = ch_rows[..., 12] != 0
    est4 = ch_rows[..., 13].astype(np.int64)
    est8 = ch_rows[..., 14].astype(np.int64)
    order = np.where(deg | (est4 <= est8), 4, 8)
    est = np.where(order == 4, est4, est8)
    return (order, est, est.sum(axis=1))


def _floor_retry(packed, blocks, t_arr, layout, bps, lsb_shift,
                 interlacing_shift, min_lw, max_lw, block_size, exact):
    """the quantization-floor retry of a fetched batch
    (ref.alac.floor_limited and group_score, batched): the groups
    flagged are analysed again by ``exact(blocks, group)`` (packed
    candidates [b, 1, ...] of the exact samples) and take those rows
    where they score lower.  Returns (packed, groups re-analysed)."""
    B = blocks.shape[0]
    cap = max(bps - lsb_shift - qpack.cap_margin(), 0)
    retried = 0
    for (g, (off, width)) in enumerate(layout):
        tg = t_arr[:B, off:off + width].max(axis=1).astype(np.int64)
        live = (tg > 0) & (tg < cap)
        if not live.any():
            continue
        (order, est, score_q) = _pick_scores(packed[:B, g], min_lw, max_lw,
                                             width)
        count = block_size - 1 - order
        safe = count > 0
        m_q = np.where(safe, (est * 64) // np.maximum(count, 1), 0)
        cand = ((_bit_length(m_q) >= tg[:, None] + 2) & safe &
                live[:, None]).any(axis=1)
        idx = np.nonzero(cand)[0]
        if not len(idx):
            continue
        retried += len(idx)
        rows = exact(np.ascontiguousarray(blocks[idx]), (off, width))[:, 0]
        (_o, _e, score_e) = _pick_scores(rows, min_lw, max_lw, width)
        better = score_e < score_q[idx]
        if better.any():
            packed = np.array(packed)
            packed[idx[better], g] = rows[better]
    return (packed, retried)


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
    bps_eff = bps - lsb_shift
    use_wire = qpack.alac_enabled() and block_size > 2
    window = lpc_ops.tukey_window(block_size, dev)
    (np_upload, upload_dtype) = ((np.int16, torch.int16) if bps <= 16
                                 else (np.int32, torch.int32))
    copy_stream = torch.cuda.Stream(dev) if on_cuda else None
    stage_seconds = dict.fromkeys(STAGES, 0.0)
    lw = (interlacing_shift, min_interlacing_leftweight,
          max_interlacing_leftweight)

    def exact(blocks, group):
        """packed candidates of ``blocks``'s exact samples for one
        group, analysed on the device"""
        up = torch.from_numpy(blocks.astype(np_upload)).to(dev)
        return alac_frames.analyze_framesets_packed(
            up, [group], lsb_shift, *lw, window).cpu().numpy()

    def submit(blocks, ns):
        """enqueues one batch's upload, analysis and fetch; returns
        without waiting for the device"""
        global wire_batches
        t0 = time.perf_counter()
        t = wire_shape = None
        if use_wire:
            shifted = blocks.astype(np.int32) >> lsb_shift
            (qwords, k, t, x0, _orv, _cf) = _native.flac_qpack(
                shifted, bps_eff, qpack.guard_bits(), False)
            rows = qpack.assemble_wire(qwords, t, x0).view(np.int32)
            wire_shape = (k, qwords.shape[2])
            with COUNT_LOCK:
                wire_batches += 1
        else:
            rows = blocks.astype(np_upload)
        stage_seconds["qpack"] += time.perf_counter() - t0
        batch = _Batch(blocks, ns, t)
        t0 = time.perf_counter()
        if on_cuda:
            host = torch.from_numpy(rows).pin_memory()
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(5)]
            with torch.cuda.stream(copy_stream):
                ev[0].record()
                up = host.to(dev, non_blocking=True)
                ev[1].record()
            compute = torch.cuda.current_stream(dev)
            compute.wait_stream(copy_stream)
            up.record_stream(compute)
            ev[2].record()
        else:
            up = torch.from_numpy(rows)
        t1 = time.perf_counter()
        if use_wire:
            (qblocks, _o, _c) = qpack.unpack_wire(
                up, wire_shape[0], wire_shape[1], channels, block_size)
            packed = alac_frames.analyze_framesets_packed(
                qblocks, layout, 0, *lw, window)
        else:
            packed = alac_frames.analyze_framesets_packed(
                up, layout, lsb_shift, *lw, window)
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
        global floor_groups
        if on_cuda:
            ev = batch.events
            ev[4].synchronize()
            ms = (ev[0].elapsed_time(ev[1]), ev[2].elapsed_time(ev[3]),
                  ev[3].elapsed_time(ev[4]))
            for (stage, t) in zip(("upload", "analysis", "fetch"), ms):
                stage_seconds[stage] += t / 1e3
        else:
            for (stage, t) in zip(("upload", "analysis", "fetch"),
                                  batch.cpu_times):
                stage_seconds[stage] += t
        packed = batch.host.numpy()
        if batch.t is not None:
            t0 = time.perf_counter()
            (packed, retried) = _floor_retry(
                packed, batch.blocks, batch.t, layout, bps, lsb_shift,
                interlacing_shift, min_interlacing_leftweight,
                max_interlacing_leftweight, block_size, exact)
            with COUNT_LOCK:
                floor_groups += retried
            stage_seconds["floor"] += time.perf_counter() - t0
        t0 = time.perf_counter()
        (data, lens) = _native.alac_emit_framesets(
            batch.blocks, batch.ns, layout, packed, block_size,
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
