"""Batched FLAC decoder on a torch device: Rice decode and predictor
synthesis on the device, the structural scan on the host.

Port of the reference's device decode path
(``audiotools_tpu/codecs/flac_dec_jax.py``, ``JaxFlacDecoder``, and its
base ``flac_dec_fast.FastFlacDecoder``).  Per batch of up to
MAX_BATCH_FRAMES frames:

1. host: ``_native.flac_scan`` walks the frames (checking CRC-8/16)
   and records each residual run, cut into records of at most
   CHUNK_CODES codes that never cross a CHUNK_CODES-aligned output
   slot, with its bit span; the records are sorted into BUCKETS by
   window words and code count;
2. device: the frame bytes and the batch's arrays go up in one copy
   from pinned memory; ``rice_decode.decode_partitions`` decodes each
   bucket; the records are added into their slots of the residual
   planes (records may share a slot, as partitions need not fill one,
   so the rows add); ``flac_synth.synthesize`` inverts the
   predictors; CONSTANT rows are filled; ``reconstruct_frames``
   restores wasted bits and stereo and interleaves; 16-bit streams
   narrow to int16;
3. host: the PCM comes back to pinned memory, is trimmed per frame
   and folded into the stream MD5 in stream order.

The device stages run on the CUDA stream that was current when the
decoder was made (a farm worker's own stream), whichever thread reads.
Batch i+1 is scanned and enqueued before batch i is fetched, so the
card works on batch i+1 while the host trims and hashes batch i.  A
chunk whose first frame exceeds the scan's capacity, or a record no
bucket holds, is decoded by the host C++ decoder instead and counted
in ``host_chunks``.  On the CPU every stage runs the plain versions.
"""

from __future__ import annotations

import io
import time

import numpy as np
import torch

from .. import _native, pcm
from .._device import COUNT_LOCK, StageMarks, fetch_async, resolve_device
from ..ops import flac_synth, rice_decode

# frames per device batch
MAX_BATCH_FRAMES = 1024
# codes per scan record; records break at destination multiples of it
CHUNK_CODES = 64
# partition records a batch may hold: 8 channels x 4096 / CHUNK_CODES
# records per subframe at the -8 block size, plus one alignment break
MAX_PARTS = MAX_BATCH_FRAMES * 8 * 66
# (window words, max codes): a record lands in the first bucket that
# holds both its bit span and its code count; the last is the
# catch-all for raw 32-bit runs and long unary codes
BUCKETS = ((8, 64), (16, 64), (32, 64), (64, 64), (2048, 4096))
# compressed bytes buffered per device batch: a 1024-frame batch of
# 16-bit stereo at block 4096 holds up to 16 MB
DEVICE_CHUNK_BYTES = 0x1000000
# compressed bytes per host-decoder read
HOST_CHUNK_BYTES = 0x200000

# per-stage seconds accumulated in TorchFlacDecoder.timings: the host
# scan, the host preparation of its arrays (HostBatch), the device
# stages, and the stream MD5.  On a card the device stages are
# CUDA-event spans, which include the host's time to enqueue their
# kernels
STAGES = ("scan", "prep", "upload", "rice", "assemble", "synth",
          "reconstruct", "fetch", "md5")

# chunks decoded by the host C++ decoder instead of the device
# (process-wide count, for reports; added to under _device.COUNT_LOCK)
host_chunks = 0


class _OverflowsBuckets(Exception):
    """a partition record exceeded the largest bucket"""


class HostBatch:
    """one scanned batch, prepared on the host: its shape, and int32
    arrays named for the device (``arrays``, in upload order)"""

    def __init__(self, scan, data, channels, bits_per_sample):
        frame_meta = scan["frame_meta"]
        sub_meta = scan["sub_meta"]
        part_meta = scan["part_meta"]
        self.F = frame_meta.shape[0]
        self.S = sub_meta.shape[0]
        self.ch = channels
        self.n = int(frame_meta[:, 0].max())
        self.block_sizes = frame_meta[:, 0].copy()
        # int16 fetch when every decoded sample fits (bps + wasted <=
        # 16 on every subframe of a <= 16-bit stream)
        self.narrow = bool(bits_per_sample <= 16 and
                           int(frame_meta[:, 2].max()) <= 16)
        # coefficient columns on the {8, 16, 32} grid (order <= 12 at -8)
        max_order = int(sub_meta[:, 2].max()) if self.S else 0
        Kw = 8
        while Kw < max_order:
            Kw <<= 1
        Kw = min(Kw, flac_synth.K)

        arrays = {"words": rice_decode.bytes_to_words(
            data[:scan["consumed_bytes"]]).numpy()}
        arrays["warmup"] = np.ascontiguousarray(scan["warmup"][:, :Kw])
        arrays["qlp"] = np.ascontiguousarray(
            flac_synth.fill_fixed_qlp(sub_meta, scan["qlp"])[:, :Kw])
        # the columns the synthesis kernel multiplies (12 at -8)
        self.taps = flac_synth.nonzero_columns(arrays["qlp"])
        # shift, order, wasted, constant value, is-constant
        arrays["sub"] = np.stack([sub_meta[:, 4], sub_meta[:, 2],
                                  sub_meta[:, 3], sub_meta[:, 6],
                                  (sub_meta[:, 1] == 0).astype(np.int32)])
        arrays["assignment"] = frame_meta[:, 1].copy()

        bit_off = part_meta[:, 5]
        count = part_meta[:, 2]
        base_bits = bit_off & 31
        w_need = (base_bits + part_meta[:, 6] + 31) >> 5
        assigned = np.zeros(part_meta.shape[0], dtype=bool)
        self.buckets = []
        for (W, C) in BUCKETS:
            sel = (~assigned) & (w_need <= W) & (count <= C)
            assigned |= sel
            rows = np.nonzero(sel)[0]
            if len(rows):
                pm = part_meta[rows]
                # word_base, base_bits, k, raw_bits, count, subframe,
                # destination offset
                arrays["bucket%d" % len(self.buckets)] = np.stack([
                    bit_off[rows] >> 5, base_bits[rows], pm[:, 3],
                    pm[:, 4], pm[:, 2], pm[:, 0], pm[:, 1]])
                self.buckets.append((W, C))
        if not assigned.all():
            raise _OverflowsBuckets()
        self.arrays = {k: np.ascontiguousarray(v, dtype=np.int32)
                       for (k, v) in arrays.items()}


def upload_arrays(arrays, dev, dtype=torch.int32):
    """a dict of numpy arrays on ``dev`` as a dict of ``dtype`` (int32
    by default) tensors: one copy of one buffer, from pinned memory on a
    card (asynchronous)"""
    sizes = [a.size for a in arrays.values()]
    flat = torch.empty(sum(sizes), dtype=dtype,
                       pin_memory=dev.type == "cuda")
    np.concatenate([a.reshape(-1) for a in arrays.values()],
                   out=flat.numpy())
    if dev.type == "cuda":
        flat = flat.to(dev, non_blocking=True)
    out = {}
    start = 0
    for ((name, a), size) in zip(arrays.items(), sizes):
        out[name] = flat[start:start + size].view(a.shape)
        start += size
    return out


def upload_batch(batch, dev):
    """the batch's arrays on ``dev`` (``upload_arrays``)"""
    return upload_arrays(batch.arrays, dev)


def decode_residuals(batch, tensors):
    """the Rice stage: [P, C] residual records per bucket"""
    words = tensors["words"]
    vals = []
    for (b, (W, C)) in enumerate(batch.buckets):
        (word_base, base_bits, k, raw_bits, count) = \
            tensors["bucket%d" % b][:5]
        vals.append(rice_decode.decode_partitions(
            words, word_base, base_bits, k, raw_bits, count, W, C))
    return vals


def assemble_residuals(batch, tensors, vals):
    """adds the decoded records into their CHUNK_CODES-wide slots of the
    residual planes; returns int32 [S, n] (positions no record covers,
    the warm-up samples', stay 0)"""
    CH = CHUNK_CODES
    slots = -(-batch.n // CH)
    dev = tensors["words"].device
    rows_total = batch.S * slots
    plane = torch.zeros((rows_total + 1, CH), dtype=torch.int32,
                        device=dev)
    cidx = torch.arange(CH, device=dev)[None, :]
    for (b, v) in enumerate(vals):
        (count, sub_idx, dest) = tensors["bucket%d" % b][4:7]
        off = (dest % CH)[:, None]
        src = torch.clamp(cidx - off, 0, CH - 1)
        row = torch.where((cidx >= off) & (cidx < off + count[:, None]),
                          torch.take_along_dim(v[:, :CH], src, dim=1), 0)
        # empty records go to the spare last row
        slot = torch.where(count > 0, sub_idx * slots + dest // CH,
                           rows_total)
        plane.index_add_(0, slot, row)
    return plane[:rows_total].reshape(batch.S, slots * CH)[:, :batch.n]


def reconstruct_batch(batch, tensors, samples):
    """CONSTANT fill, wasted bits, stereo and interleave: [F, n, ch],
    int16 when the batch narrows, else int32"""
    (_shift, _order, wasted, const_val, is_const) = tensors["sub"]
    samples = torch.where(is_const[:, None] != 0, const_val[:, None],
                          samples)
    out = flac_synth.reconstruct_frames(samples, wasted,
                                        tensors["assignment"], batch.ch)
    fetched = torch.empty(out.shape, device=out.device,
                          dtype=torch.int16 if batch.narrow else torch.int32)
    return fetched.copy_(out)


class _Inflight:
    """one enqueued batch: its PCM on its way to host memory, and the
    StageMarks between its device stages"""

    def __init__(self, batch, host, marks):
        self.batch = batch
        self.host = host            # [F, n, ch] (pinned on a card)
        self.marks = marks


class TorchFlacDecoder:
    """a PCMReader decoding FLAC on a torch device

    device: "cuda" (raises when no card is usable) or "cpu" (the plain
    versions, for tests).  read() decodes MAX_BATCH_FRAMES-deep
    batches and serves the caller from the decoded PCM, never more
    frames than asked; the stream MD5 is checked at the end (not
    after a seek).  ``timings`` accumulates seconds per STAGES."""

    def __init__(self, file_or_path, channel_mask=None, device="cuda"):
        self.device = resolve_device(device)
        # the stream every device stage of this decoder is enqueued on
        self.stream = (torch.cuda.current_stream(self.device)
                       if self.device.type == "cuda" else None)
        if isinstance(file_or_path, str):
            self.file = open(file_or_path, "rb")
        else:
            self.file = file_or_path
        try:
            meta = pcm.read_flac_metadata(self.file)
        except ValueError:
            if isinstance(file_or_path, str):
                self.file.close()
            raise
        self.minimum_block_size = meta["minimum_block_size"]
        self.maximum_block_size = meta["maximum_block_size"]
        self.sample_rate = meta["sample_rate"]
        self.channels = meta["channels"]
        self.bits_per_sample = meta["bits_per_sample"]
        self.total_frames = meta["total_frames"]
        self.md5sum = meta["md5sum"]
        self.seektable = meta["seektable"]
        self.frames_offset = self.file.tell()
        self.channel_mask = (channel_mask if channel_mask else
                             pcm.CHANNEL_MASKS.get(self.channels, 0))

        self.buffer = bytearray()
        self.buf_off = 0          # consumed prefix of self.buffer
        self.current_md5 = _native.MD5()
        self.decoded_frames = 0
        self.eof = False
        self.closed = False
        self.timings = dict.fromkeys(STAGES, 0.0)
        self._pcm_buf = None
        self._pcm_off = 0
        self._inflight = None

    # ---- PCMReader protocol ------------------------------------------
    def read(self, pcm_frames):
        if self.closed:
            raise ValueError("stream is closed")
        if self._pcm_buf is None or self._pcm_off >= self._pcm_buf.shape[0]:
            if self.eof:
                return self._empty()
            served = self._fill_pcm_buffer(pcm_frames)
            if served is not None:
                return served       # host-path or end-of-stream frames
            if (self._pcm_buf is None or
                    self._pcm_off >= self._pcm_buf.shape[0]):
                return self._empty()
        buf = self._pcm_buf
        take = min(buf.shape[0] - self._pcm_off, max(int(pcm_frames), 1))
        chunk = buf[self._pcm_off:self._pcm_off + take]
        self._pcm_off += take
        self.decoded_frames += take
        if (self._pcm_off >= buf.shape[0] and self.total_frames and
                self.decoded_frames >= self.total_frames):
            self._finish()
        return pcm.FrameList(chunk, self.bits_per_sample)

    def seekable(self):
        return not self.closed

    def seek(self, pcm_frame):
        """seeks to the given PCM frame position in the stream

        returns the position actually seeked to, at or before the
        requested one (the nearest prior seekpoint, then whole frames
        decoded and discarded).  The in-flight batch is dropped, and
        the end-of-stream MD5 check is disabled."""
        if self.closed:
            raise ValueError("stream is closed")
        self._pcm_buf = None
        self._pcm_off = 0
        self._inflight = None
        pcm_frame = max(int(pcm_frame), 0)
        best = (0, 0)       # (sample_number, byte_offset)
        for (sample_number, byte_offset, _frame_count) in self.seektable:
            if best[0] <= sample_number <= pcm_frame:
                best = (sample_number, byte_offset)
        self.file.seek(self.frames_offset + best[1], 0)
        self.buffer = bytearray()
        self.buf_off = 0
        self.eof = False
        self.decoded_frames = best[0]
        self.md5sum = b"\x00" * 16
        remaining = pcm_frame - best[0]
        block = self.maximum_block_size or 4096
        while remaining >= block:
            framelist = self.read(block)
            if framelist.frames == 0:
                break
            remaining -= framelist.frames
        return self.decoded_frames

    def close(self):
        self.closed = True
        self._inflight = None
        self.file.close()

    # ---- internals -----------------------------------------------------
    def _empty(self):
        return pcm.empty_framelist(self.channels, self.bits_per_sample)

    def _finish(self):
        if not self.eof:
            self.eof = True
            if (self.md5sum != b"\x00" * 16 and
                    self.current_md5.digest() != self.md5sum):
                raise ValueError("MD5 mismatch at end of stream")

    def _top_up(self, size):
        """tops the compressed buffer up to ``size`` bytes past its
        consumed prefix; returns True when the file is exhausted"""
        if len(self.buffer) - self.buf_off >= size:
            return False
        if self.buf_off:
            del self.buffer[:self.buf_off]
            self.buf_off = 0
        while len(self.buffer) < size:
            chunk = self.file.read(size)
            if not chunk:
                return True
            self.buffer += chunk
        return False

    def _host_read(self, pcm_frames):
        """decodes whole frames of the buffered bytes with the host C++
        decoder (the reference's FastFlacDecoder.read)"""
        exhausted = self._top_up(HOST_CHUNK_BYTES)
        if self.buf_off >= len(self.buffer):
            self._finish()
            return self._empty()
        max_samples = max(pcm_frames, self.maximum_block_size or 65536)
        (samples, consumed) = _native.flac_decode(
            memoryview(self.buffer)[self.buf_off:], self.bits_per_sample,
            self.channels, max_samples, md5=self.current_md5)
        if consumed == 0:
            if not exhausted:
                chunk = self.file.read(HOST_CHUNK_BYTES)
                if chunk:
                    self.buffer += chunk
                    return self._host_read(pcm_frames)
            self._check_leftover()
            self._finish()
            return self._empty()
        self.buf_off += consumed
        self.decoded_frames += samples.shape[0]
        if self.total_frames and self.decoded_frames >= self.total_frames:
            self._finish()
        return pcm.FrameList(samples, self.bits_per_sample)

    def _check_leftover(self):
        """bytes that hold no complete frame must not pass for the end
        of the stream: for a stream whose STREAMINFO MD5 is zero the
        MD5 check would never catch the truncation.  The host decoder
        runs over them first, so that a frame cut short raises its
        error, as the reference's decoder does"""
        if (len(self.buffer) - self.buf_off > 0 and
                (not self.total_frames or
                 self.decoded_frames < self.total_frames)):
            _native.flac_decode(
                bytes(self.buffer[self.buf_off:]), self.bits_per_sample,
                self.channels, self.maximum_block_size or 65536)
            raise ValueError("corrupt FLAC stream: undecodable bytes at "
                             "frame %d" % (self.decoded_frames,))

    def _fill_pcm_buffer(self, pcm_frames):
        """decodes one device batch into the PCM buffer; returns None,
        or frames to serve when the host path served the request or the
        stream ended.  One batch stays in flight: the next one is
        scanned and enqueued before the in-flight one is fetched, and
        the MD5 folds at fetch, in stream order.  The host path and the
        end of the stream are handled only with no batch in flight."""
        if self._inflight is None:
            started = self._start_batch(pcm_frames, allow_terminal=True)
            if not isinstance(started, _Inflight):
                return started
            self._inflight = started
        nxt = self._start_batch(pcm_frames, allow_terminal=False)
        samples = self._fetch(self._inflight)
        self._inflight = nxt if isinstance(nxt, _Inflight) else None
        t0 = time.perf_counter()
        self.current_md5.update_pcm(samples, self.bits_per_sample)
        self.timings["md5"] += time.perf_counter() - t0
        self._pcm_buf = samples
        self._pcm_off = 0
        return None

    def _start_batch(self, pcm_frames, allow_terminal):
        """scans and enqueues one batch and returns its _Inflight.
        With allow_terminal it may instead return frames to serve
        (host path, end of stream); without, such conditions return
        None and consume nothing, to be met on the next fill."""
        global host_chunks
        t0 = time.perf_counter()
        exhausted = self._top_up(DEVICE_CHUNK_BYTES)
        if self.buf_off >= len(self.buffer):
            if not allow_terminal:
                return None
            self._finish()
            return self._empty()
        # the memoryviews below are temporaries: the buffer cannot be
        # resized while one is alive (so the host path runs after the
        # except clause, whose traceback holds them)
        host = False
        try:
            scan = _native.flac_scan(
                memoryview(self.buffer)[self.buf_off:],
                self.bits_per_sample, self.channels,
                max_samples=MAX_BATCH_FRAMES * max(
                    self.maximum_block_size or 65536, 4096),
                max_frames=MAX_BATCH_FRAMES, max_parts=MAX_PARTS,
                chunk_codes=CHUNK_CODES)
            t1 = time.perf_counter()
            batch = (HostBatch(scan, memoryview(self.buffer)[self.buf_off:],
                               self.channels, self.bits_per_sample)
                     if scan["consumed_bytes"] else None)
        except (_native.CapacityError, _OverflowsBuckets):
            host = True
        if host:
            if not allow_terminal:
                return None
            with COUNT_LOCK:
                host_chunks += 1
            return self._host_read(pcm_frames)
        if batch is None:
            if not allow_terminal:
                return None
            if not exhausted:
                chunk = self.file.read(DEVICE_CHUNK_BYTES)
                if chunk:
                    self.buffer += chunk
                    return self._start_batch(pcm_frames, True)
            self._check_leftover()
            self._finish()
            return self._empty()
        self.buf_off += scan["consumed_bytes"]
        self.timings["scan"] += t1 - t0
        self.timings["prep"] += time.perf_counter() - t1
        if self.stream is None:
            return self._enqueue(batch)
        with torch.cuda.stream(self.stream):
            return self._enqueue(batch)

    def _enqueue(self, batch):
        """enqueues one batch's device stages and the fetch of its PCM;
        on a card returns without waiting for the device"""
        marks = StageMarks(self.device)
        marks.mark()
        tensors = upload_batch(batch, self.device)
        marks.mark()
        vals = decode_residuals(batch, tensors)
        marks.mark()
        planes = assemble_residuals(batch, tensors, vals)
        marks.mark()
        (shift, order) = tensors["sub"][:2]
        samples = flac_synth.synthesize(planes, tensors["warmup"],
                                        tensors["qlp"], shift, order,
                                        taps=batch.taps)
        marks.mark()
        host = reconstruct_batch(batch, tensors, samples)
        marks.mark()
        host = fetch_async(host)
        marks.mark()
        return _Inflight(batch, host, marks)

    def _fetch(self, inflight):
        """waits for a batch's PCM in host memory; returns it trimmed
        per frame as int32 [frames, channels]"""
        for (stage, t) in zip(STAGES[2:], inflight.marks.seconds()):
            self.timings[stage] += t
        batch = inflight.batch
        out = inflight.host.numpy().astype(np.int32)
        if (batch.block_sizes == batch.n).all():
            return out.reshape(batch.F * batch.n, batch.ch)
        return np.concatenate([out[f, :batch.block_sizes[f]]
                               for f in range(batch.F)], axis=0)


def decode_flac(data, device="cuda"):
    """a whole FLAC stream's bytes -> int32 samples [frames, channels],
    decoded by TorchFlacDecoder on ``device`` (the stream MD5 checked)"""
    dec = TorchFlacDecoder(io.BytesIO(data), device=device)
    pieces = []
    try:
        while True:
            framelist = dec.read(pcm.FRAMELIST_SIZE)
            if framelist.frames == 0:
                break
            pieces.append(framelist.samples)
    finally:
        dec.close()
    if not pieces:
        return np.zeros((0, dec.channels), dtype=np.int32)
    return np.concatenate(pieces, axis=0)
