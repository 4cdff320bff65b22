"""Batched FLAC encoder on a torch device: analysis and residual
packing on the device, frame emit in the port's copy of the
reference's C++ host kernel (``_native``).

Port of the reference's device-pack configuration
(``audiotools_tpu/codecs/flac_enc_fast.py`` with ``ATPU_PALLAS=1``):
per batch of full blocks,

1. the stream MD5 folds in the exact samples (host, C++);
2. the blocks go up as int16 (bps <= 16) or int32 through a pinned
   host buffer, on a side CUDA stream of the call's own;
3. ``flac_frames.analyze_frames_packed``, ``compact_decisions`` and
   ``bitpack.pack_chosen_residuals`` run on the device;
4. ``(compact decisions, words, bits, ok)`` come back to pinned host
   memory;
5. ``_native.flac_emit_frames2`` emits the frames, splicing the
   device-packed residual bits into FIXED/LPC subframes.

The device stages run on the caller's current CUDA stream (the compute
stream): every event, fetch and wait is recorded against it, so
threads that each set a stream of their own (``parallel.farm``) never
meet on one.  Batch i+1 is submitted to the device before batch i is
emitted, so the card runs whatever of batch i+1 is still queued while
the host emits batch i.  One host thread both enqueues the analysis's kernels and
emits, so when enqueueing is what limits the card (it is, at bench
shape) the two host stages add rather than overlap.  The short tail
block goes through the scalar oracle encoder (the port's copy in
``ref/``), as in the reference.

The device sees exact samples, so there is no quantized upload wire
here.  When a batch's pack reports ``ok = False`` (a row over capacity
or an LPC residual at the clip bound) the batch is emitted from the
same device decisions by the non-splice emitter, which re-derives the
residuals on the host; ``fallback_batches`` counts such batches.
"""

from __future__ import annotations

import contextlib
import time

import numpy as np
import torch

from .. import _native
from .._device import COUNT_LOCK, resolve_device
from ..ops import bitpack, flac_frames, lpc as lpc_ops
from ..pcm import BufferedPCMReader
from ..ref import flac_enc as oracle

# batches whose device pack reported ok=False and were emitted without
# the packed bits (process-wide count, for reports; added to under
# _device.COUNT_LOCK)
fallback_batches = 0

# per-stage seconds reported through encode_flac_fast(timings=...)
STAGES = ("upload", "analysis", "pack", "fetch", "emit")


class _Batch:
    """one submitted batch: its host blocks, its results on their way
    to host memory, and what times its device stages"""

    def __init__(self, blocks, first_frame):
        self.blocks = blocks
        self.first_frame = first_frame
        self.host = None        # [compact] or [compact, words, bits, ok]
        self.events = None      # CUDA: stage boundary events
        self.ready = None       # CUDA: results are in host memory
        self.cpu_times = None   # CPU: (upload, analysis, pack, fetch) s


def encode_flac_fast(file_or_path,
                     pcmreader,
                     block_size=4096,
                     max_lpc_order=8,
                     min_residual_partition_order=0,
                     max_residual_partition_order=5,
                     mid_side=True,
                     adaptive_mid_side=False,
                     exhaustive_model_search=False,
                     disable_verbatim_subframes=False,
                     disable_constant_subframes=False,
                     disable_fixed_subframes=False,
                     disable_lpc_subframes=False,
                     padding_size=4096,
                     batch_frames=1024,
                     device="cuda",
                     pack=True,
                     timings=None):
    """encodes a FLAC file from a PCMReader on a torch device

    Takes the reference's keyword options.  The reference's batched
    path accepts the disable_* flags without applying them; here a
    True one raises NotImplementedError.  device: "cuda" (raises when no card is usable) or "cpu" (the plain
    versions, for tests).  pack: pack the chosen residuals on the
    device and splice them at emit (the default); False fetches only
    the decisions and leaves the Rice serialization to the host
    emitter.  timings: optional dict that receives seconds per stage
    (STAGES; on a card the device stages are timed with CUDA events).

    returns a list of (byte_offset, pcm_frames) pairs per FLAC frame"""
    disabled = [name for (name, flag) in (
        ("disable_verbatim_subframes", disable_verbatim_subframes),
        ("disable_constant_subframes", disable_constant_subframes),
        ("disable_fixed_subframes", disable_fixed_subframes),
        ("disable_lpc_subframes", disable_lpc_subframes)) if flag]
    if disabled:
        raise NotImplementedError("not applied by the batched encoder: "
                                  + ", ".join(disabled))
    dev = resolve_device(device)
    if isinstance(file_or_path, str):
        opened = open(file_or_path, "wb")
    else:
        opened = contextlib.nullcontext(file_or_path)
    with opened as output_file:
        return _encode(output_file, pcmreader, dev, block_size,
                       max_lpc_order, min_residual_partition_order,
                       max_residual_partition_order, mid_side,
                       adaptive_mid_side, exhaustive_model_search,
                       padding_size, batch_frames, pack, timings)


def _encode(output_file, pcmreader, dev, block_size, max_lpc_order,
            min_residual_partition_order, max_residual_partition_order,
            mid_side, adaptive_mid_side, exhaustive_model_search,
            padding_size, batch_frames, pack, timings):
    on_cuda = dev.type == "cuda"

    bps = pcmreader.bits_per_sample
    channels = pcmreader.channels
    sample_rate = pcmreader.sample_rate
    max_rice = 14 if bps <= 16 else 30
    options = oracle.EncodingOptions(
        block_size, max_lpc_order,
        adaptive_mid_side, mid_side, exhaustive_model_search,
        min_residual_partition_order, max_residual_partition_order,
        max_rice)
    precision = options.qlp_precision

    stereo_trial = (channels == 2) and (mid_side or adaptive_mid_side)
    max_subframes = 2 if stereo_trial else channels
    porders = flac_frames.valid_partition_orders(
        block_size, max_residual_partition_order, max(max_lpc_order, 4))
    Kp = max(max_lpc_order, 1)
    P = 1 << porders[-1]
    compact_row_width = 1 + max_subframes * flac_frames.compact_width(
        max_lpc_order, P)
    rb_stride = bitpack.residual_words_capacity(
        block_size, bps + (1 if stereo_trial else 0), P)
    window = lpc_ops.tukey_window(block_size, dev)
    (np_upload, upload_dtype) = ((np.int16, torch.int16) if bps <= 16
                                 else (np.int32, torch.int32))
    # the caller's current stream runs the device stages; the uploads
    # run on a side stream of this call's own
    compute = torch.cuda.current_stream(dev) if on_cuda else None
    copy_stream = torch.cuda.Stream(dev) if on_cuda else None
    stage_seconds = dict.fromkeys(STAGES, 0.0)

    def submit(blocks, first_frame):
        """enqueues one batch's upload, analysis, pack and fetch;
        returns without waiting for the device"""
        batch = _Batch(blocks, first_frame)
        t0 = time.perf_counter()
        if on_cuda:
            host = torch.empty(blocks.shape, dtype=upload_dtype,
                               pin_memory=True)
            np.copyto(host.numpy(), blocks, casting="unsafe")
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(5)]
            with torch.cuda.stream(copy_stream):
                ev[0].record(copy_stream)
                dev_blocks = host.to(dev, non_blocking=True)
                ev[1].record(copy_stream)
            compute.wait_stream(copy_stream)
            dev_blocks.record_stream(compute)
            ev[2].record(compute)   # analysis starts once the upload landed
        else:
            dev_blocks = torch.from_numpy(blocks.astype(np_upload))
        t1 = time.perf_counter()

        result = flac_frames.analyze_frames_packed(
            dev_blocks, stereo_trial, bps, block_size, max_lpc_order,
            precision, porders, max_rice, exhaustive_model_search,
            mid_side, window, return_chosen=pack)
        (packed, chosen) = result if pack else (result, None)
        outs = [flac_frames.compact_decisions(packed, max_subframes,
                                              max_lpc_order, P)]
        if on_cuda:
            ev[3].record(compute)
        t2 = time.perf_counter()
        if pack:
            outs.extend(bitpack.pack_chosen_residuals(
                chosen, block_size, bps, stereo_trial, P, rb_stride))
        del chosen
        t3 = time.perf_counter()
        if on_cuda:
            ev[4].record(compute)
            batch.host = [torch.empty(o.shape, dtype=o.dtype,
                                      pin_memory=True) for o in outs]
            for (dst, src) in zip(batch.host, outs):
                dst.copy_(src, non_blocking=True)
            batch.ready = torch.cuda.Event(enable_timing=True)
            batch.ready.record(compute)
            batch.events = ev
        else:
            batch.host = outs
            batch.cpu_times = (t1 - t0, t2 - t1, t3 - t2, 0.0)
        return batch

    # ---- metadata headers (placeholder STREAMINFO) --------------------
    output_file.write(b"fLaC")
    header = oracle.TokenStream()
    header.write(1, 1 if padding_size is None else 0)
    header.write(7, 0)
    header.write(24, 34)
    output_file.write(header.to_bytes())
    streaminfo_offset = output_file.tell()
    output_file.write(b"\x00" * 34)
    if padding_size is not None:
        pad = oracle.TokenStream()
        pad.write(1, 1)
        pad.write(7, 1)
        pad.write(24, padding_size)
        output_file.write(pad.to_bytes())
        output_file.write(b"\x00" * padding_size)

    reader = BufferedPCMReader(pcmreader)
    stream_md5 = _native.MD5()
    total_pcm_frames = 0
    frame_offsets = []
    frame_sizes = []

    def write_frames(frame_bytes, lens, pcm_frames):
        output_file.write(frame_bytes)
        offset = frame_offsets[-1][0] + frame_sizes[-1] if frame_offsets \
            else 0
        for length in lens:
            frame_offsets.append((offset, pcm_frames))
            frame_sizes.append(int(length))
            offset += int(length)

    def emit(batch):
        """waits for one batch's results and emits its frames"""
        global fallback_batches
        if on_cuda:
            batch.ready.synchronize()
            ev = batch.events
            ms = (ev[0].elapsed_time(ev[1]), ev[2].elapsed_time(ev[3]),
                  ev[3].elapsed_time(ev[4]),
                  ev[4].elapsed_time(batch.ready))
            for (stage, t) in zip(STAGES, ms):
                stage_seconds[stage] += t / 1e3
        else:
            for (stage, t) in zip(STAGES, batch.cpu_times):
                stage_seconds[stage] += t
        t0 = time.perf_counter()
        blocks = batch.blocks
        B = blocks.shape[0]
        compact = batch.host[0].numpy().reshape(B, compact_row_width)
        splice = {}
        if pack:
            (words, bits, ok) = batch.host[1:]
            if bool(ok):
                splice = {"rb_words": words.numpy().view(np.uint32),
                          "rb_bits": bits.numpy()}
            else:
                with COUNT_LOCK:
                    fallback_batches += 1
        (frame_bytes, lens) = _native.flac_emit_frames2(
            blocks,
            np.arange(batch.first_frame, batch.first_frame + B,
                      dtype=np.int64),
            np.full(B, block_size, dtype=np.int32),
            compact, max_subframes, Kp, P, sample_rate, bps, channels,
            precision, compact=True, **splice)
        write_frames(frame_bytes, lens, block_size)
        stage_seconds["emit"] += time.perf_counter() - t0

    pending = None
    submitted_frames = 0
    while True:
        framelist = reader.read(block_size * batch_frames)
        if framelist.frames == 0:
            break
        total_pcm_frames += framelist.frames
        samples = framelist.samples              # int32 [frames, ch]
        n_full = samples.shape[0] // block_size
        full = samples[:n_full * block_size]
        tail = samples[n_full * block_size:]

        if n_full:
            stream_md5.update_pcm(full, bps)
            batch = submit(np.ascontiguousarray(
                full.reshape(n_full, block_size, channels)),
                submitted_frames)
            submitted_frames += n_full
            # the device works on this batch while the host emits the
            # previous one
            if pending is not None:
                emit(pending)
            pending = batch
        if tail.shape[0]:
            stream_md5.update_pcm(tail, bps)
            if pending is not None:
                emit(pending)
                pending = None
            frame_bytes = oracle.encode_frame(
                reader, options, submitted_frames, tail.astype(np.int64))
            submitted_frames += 1
            write_frames(frame_bytes, [len(frame_bytes)], tail.shape[0])
    if pending is not None:
        emit(pending)

    if frame_sizes:
        (min_frame, max_frame) = (min(frame_sizes), max(frame_sizes))
    else:
        (min_frame, max_frame) = ((1 << 24) - 1, 0)
    output_file.seek(streaminfo_offset, 0)
    output_file.write(oracle.build_streaminfo(
        block_size, block_size, min_frame, max_frame,
        sample_rate, channels, bps, total_pcm_frames,
        stream_md5.digest()))
    output_file.seek(0, 2)
    if timings is not None:
        for (stage, t) in stage_seconds.items():
            timings[stage] = timings.get(stage, 0.0) + t
    return frame_offsets
