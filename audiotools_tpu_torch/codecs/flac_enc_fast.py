"""Batched FLAC encoder on torch devices: the analysis on the devices,
frame emit in the port's copy of the reference's C++ host kernel
(``_native``).

Port of the reference's ``audiotools_tpu/codecs/flac_enc_fast.py``.
Per batch of full blocks the encode takes one of three routes, chosen
as the reference chooses them (``pack=None``):

* **the quantized upload wire** (the reference's default, and the
  default here: ``ATPU_FLAC_QPACK`` unset or not "0", bps + 2 <= 31).
  One C++ scan of the samples (``_native.flac_qpack`` or
  ``flac_qpack_patched``) plans each (block, channel)'s shift t, takes
  the exact or-value and constant sideband, folds the stream MD5 and
  packs the zigzag first differences of ``(x >> t)``; the plain or the
  patched-base wire is chosen with the reference's (k_base, E) state
  and probes.  The consolidated wire goes up in one pinned upload on a
  side stream; ``qpack.unpack_wire`` rebuilds ``(x >> t) << t`` on the
  device, and ``flac_frames.analyze_frames_packed`` (with the
  sideband) and ``compact_decisions`` run there.  The non-splice
  emitter re-derives every residual from the exact host samples, so
  the stream stays lossless whatever the decisions.  Two retries keep
  the reference's bytes: the quantization-floor retry (stage 1 from
  the decisions, stage 2 the emitter's probe of the exact residuals)
  re-analyses the flagged frames exactly on the device and splices
  their frames over the batch's, and a batch whose emit overflows
  (``_native.EmitOverflow``) is re-analysed exactly and emitted again;
* **device pack** (``ATPU_PALLAS=1``, or ``pack=True``): exact uploads
  as int16 (bps <= 16) or int32, the analysis and
  ``bitpack.pack_chosen_residuals`` on the device, and the emitter
  splicing the device-packed residual bits into FIXED/LPC subframes.
  A batch whose pack reports ``ok = False`` (a row over capacity or an
  LPC residual at the clip bound) is emitted from the same decisions
  without the packed bits; ``fallback_batches`` counts such batches;
* **exact uploads without pack** (``pack=False``, or the wire gated
  off): the analysis of the exact samples and the non-splice emitter.

A batch's rows are split over ``devices`` with ``parallel.mesh.Split``
(rows padded with zero rows to a multiple of the device count, the pad
rows dropped after the fetch).  On one device the stages run on the
caller's current CUDA stream, so threads that each set a stream of
their own (``parallel.farm``) never meet on one.  Batch i+1 is
submitted to the devices before batch i is emitted.  The short tail
block goes through the scalar oracle encoder (the port's copy in
``ref/``), which applies the same quantization spec, as in the
reference.
"""

from __future__ import annotations

import contextlib
import os
import time

import numpy as np
import torch

from .. import _native
from .._device import COUNT_LOCK, resolve_device
from ..ops import bitpack, flac_frames, lpc as lpc_ops, qpack
from ..parallel.mesh import Split, cuda_devices
from ..pcm import BufferedPCMReader
from ..ref import flac_enc as oracle
from ..utils import profiling
from ..utils.profiling import span

# process-wide counts for reports, added to under _device.COUNT_LOCK:
# device-pack batches emitted without their packed bits
fallback_batches = 0
# wire batches, and those of them sent on the patched-base wire
wire_batches = 0
patched_batches = 0
# frames re-analysed exactly by the quantization-floor retry
floor_frames = 0
# batches re-analysed exactly after an emit overflow
overflow_batches = 0

# per-stage seconds reported through encode_flac_fast(timings=...), a
# view of the encode's stage sink (utils/profiling): qpack (the host
# scan of a batch: the wire, or the MD5 and the upload cast), the device
# stages (CUDA-event spans on a card), emit (a batch's emit, its floor
# retry left out), floor (the exact re-analysis and re-emit of the floor
# retry and of overflowed batches), enqueue (the host's enqueue of the
# wire's unpack, the analysis and compact_decisions, the upload left
# out) and enqueue_cpu (its thread CPU seconds), wait (the host blocked
# on a batch's results), floor_analysis (the floor's exact re-analysis
# on the device, upload to fetch, within floor) and tail (the scalar
# encoder's tail block)
STAGES = ("qpack", "upload", "analysis", "pack", "fetch", "emit", "floor",
          "enqueue", "enqueue_cpu", "wait", "floor_analysis", "tail")

# the patched wire probes one K_GRID step lower every this many batches
PATCH_PROBE_EVERY = 16


def n_devices():
    """the devices one encode spreads its batches over when
    ``devices`` is None (ATPU_DEVICES, default 1)"""
    return max(int(os.environ.get("ATPU_DEVICES", "1")), 1)


def pallas_enabled():
    """the reference's device-pack switch (ATPU_PALLAS=1)"""
    return os.environ.get("ATPU_PALLAS", "0") == "1"


def choose_route(pack, bps):
    """the batch route: "pack", "wire" or "exact" (see the module
    docstring); pack None follows the reference's gate"""
    if pack is None:
        if pallas_enabled():
            return "pack"
        if qpack.enabled() and bps + 2 <= 31:
            return "wire"
        return "exact"
    return "pack" if pack else "exact"


def resolve_encode_devices(device, devices):
    """the encode's device list: ``devices`` as given, else ``device``
    alone, or n_devices() of them (``cuda:0``.. on a card, raising when
    fewer exist)"""
    if devices is not None:
        return [resolve_device(d) for d in devices]
    dev = resolve_device(device)
    count = n_devices()
    if count == 1:
        return [dev]
    if dev.type == "cuda":
        return cuda_devices(count)
    return [dev] * count


class _Batch:
    """one submitted batch: its host blocks, the wire's t (or None), its
    pending results and what times its stages"""

    def __init__(self, blocks, first_frame, t):
        self.blocks = blocks
        self.first_frame = first_frame
        self.t = t
        self.pending = None     # Split.submit's slices
        self.events = []        # CUDA: each slice's stage events
        self.cpu_times = [0.0] * 3   # CPU: upload, analysis, pack s


class _WirePlanner:
    """the reference's choice between the plain and the patched-base
    wire, batch by batch: the patched wire starts one K_GRID step below
    the plain width, grows E (then the base width) when exceptions
    overflow, is kept while its saving beats its exception columns, and
    is probed a step lower every PATCH_PROBE_EVERY batches"""

    def __init__(self, bps, stereo_trial):
        self.bps = bps
        self.stereo_trial = stereo_trial
        self.guard = qpack.guard_bits()
        self.patch = qpack.patch_enabled()
        self.kb = None
        self.E = qpack.E_GRID[0]
        self.since = 0
        self.plain = False

    def wire(self, blocks, md5):
        """one batch's wire, the MD5 folded into the first scan: returns
        (wire uint32 [B, cols], k, W, E, t, V, patched)"""
        n_rows = blocks.shape[1]
        self.since += 1
        probe = self.since >= PATCH_PROBE_EVERY or self.kb is None
        if probe:
            self.since = 0
        folded = [md5]

        def md5_once():
            (m, folded[0]) = (folded[0], None)
            return m

        if self.patch and n_rows > 1 and (not self.plain or probe):
            kb_known = self.kb
            kb_req = kb_known
            if kb_req is not None and probe:
                below = [g for g in qpack.K_GRID if g < kb_req]
                if below:
                    kb_req = below[-1]
            res = self._attempt(blocks, kb_req, self.E, md5_once)
            if (not res[0] and probe and kb_known is not None and
                    kb_req != kb_known and not self.plain):
                # an unprofitable probe: the known-good width may still
                # win this batch
                res = self._attempt(blocks, kb_known, self.E, md5_once)
            (ok, qwords, k_full, t, x0, orv, cflags, epos, evals, kb, W,
             E) = res
            if ok:
                (self.kb, self.E, self.plain) = (kb, E, False)
                wire = qpack.assemble_wire(qwords, t, x0, orv, cflags,
                                           epos, evals)
                return (wire, kb, W, E, t, orv.shape[1], True)
            (self.kb, self.E, self.plain) = (k_full, qpack.E_GRID[0], True)
        (qwords, k, t, x0, orv, cflags) = _native.flac_qpack(
            blocks, self.bps, self.guard, self.stereo_trial, md5=md5_once())
        wire = qpack.assemble_wire(qwords, t, x0, orv, cflags)
        return (wire, k, qwords.shape[2], 0, t, orv.shape[1], False)

    def _attempt(self, blocks, kb_req, E, md5_once):
        """one patched-base attempt with its overflow retries; the first
        item says whether the wire is valid and worth its exceptions"""
        n_rows = blocks.shape[1]
        for _ in range(4):
            (qwords, k_full, t, x0, orv, cflags, epos, evals, mexc,
             kb) = _native.flac_qpack_patched(
                blocks, self.bps, self.guard, self.stereo_trial, kb_req, E,
                md5=md5_once())
            if mexc <= E:
                break
            bigger = [e for e in qpack.E_GRID if e > E]
            if bigger:
                E = bigger[0]
            else:
                E = qpack.E_GRID[0]
                above = [g for g in qpack.K_GRID
                         if g > (kb if kb_req is None else kb_req)]
                kb_req = above[0] if above else k_full
        W_plain = ((n_rows - 1) * k_full + 31) // 32 + 1
        W = qwords.shape[2]
        ok = mexc <= E and (W_plain - W) > 2 * E and kb < k_full
        return (ok, qwords, k_full, t, x0, orv, cflags, epos, evals, kb, W,
                E)


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
                     pack=None,
                     devices=None,
                     timings=None):
    """encodes a FLAC file from a PCMReader on torch devices

    Takes the reference's keyword options.  The reference's batched
    path accepts the disable_* flags without applying them; here a True
    one raises NotImplementedError.  device: "cuda" (raises when no
    card is usable) or "cpu" (the plain versions, for tests).  pack:
    None takes the reference's route (module docstring), True the
    device pack, False exact uploads without pack.  devices: the
    devices a batch's rows are split over (a device may repeat); None
    is ``device``, or ATPU_DEVICES of them.  timings: optional dict
    that receives seconds per stage (STAGES; on a card the device
    stages are timed with CUDA events, summed over the devices).

    returns a list of (byte_offset, pcm_frames) pairs per FLAC frame"""
    disabled = [name for (name, flag) in (
        ("disable_verbatim_subframes", disable_verbatim_subframes),
        ("disable_constant_subframes", disable_constant_subframes),
        ("disable_fixed_subframes", disable_fixed_subframes),
        ("disable_lpc_subframes", disable_lpc_subframes)) if flag]
    if disabled:
        raise NotImplementedError("not applied by the batched encoder: "
                                  + ", ".join(disabled))
    devs = resolve_encode_devices(device, devices)
    if isinstance(file_or_path, str):
        opened = open(file_or_path, "wb")
    else:
        opened = contextlib.nullcontext(file_or_path)
    stages = profiling.stage_timer("flac_enc_fast[torch]", "flac_enc")
    with opened as output_file, profiling.collect(stages):
        offsets = _encode(output_file, pcmreader, devs, block_size,
                          max_lpc_order, min_residual_partition_order,
                          max_residual_partition_order, mid_side,
                          adaptive_mid_side, exhaustive_model_search,
                          padding_size, batch_frames, pack, stages)
    if timings is not None:
        for (stage, t) in timing_view(stages).items():
            timings[stage] = timings.get(stage, 0.0) + t
    return offsets


def timing_view(stages):
    """the ``timings`` of an encode's stage sink: STAGES' seconds, emit
    without the floor retry that its span holds, and the enqueue's
    thread CPU seconds"""
    out = stages.view(STAGES)
    out["emit"] -= out["floor"]
    out["enqueue_cpu"] = stages.cpu.get("enqueue", 0.0)
    return out


def _encode(output_file, pcmreader, devs, block_size, max_lpc_order,
            min_residual_partition_order, max_residual_partition_order,
            mid_side, adaptive_mid_side, exhaustive_model_search,
            padding_size, batch_frames, pack, stages):
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
    route = choose_route(pack, bps)

    stereo_trial = (channels == 2) and (mid_side or adaptive_mid_side)
    max_subframes = 2 if stereo_trial else channels
    porders = flac_frames.valid_partition_orders(
        block_size, max_residual_partition_order, max(max_lpc_order, 4))
    Kp = max(max_lpc_order, 1)
    P = 1 << porders[-1]
    CW = flac_frames.compact_width(max_lpc_order, P)
    compact_row_width = 1 + max_subframes * CW
    rb_stride = bitpack.residual_words_capacity(
        block_size, bps + (1 if stereo_trial else 0), P)
    (np_upload, upload_dtype) = ((np.int16, torch.int16) if bps <= 16
                                 else (np.int32, torch.int32))
    windows = {d: lpc_ops.tukey_window(block_size, d) for d in set(devs)}
    copy_streams = {d: torch.cuda.Stream(d) for d in set(devs)
                    if d.type == "cuda"}
    # one device: the caller's current stream runs the device stages
    streams = ([torch.cuda.current_stream(devs[0])
                if devs[0].type == "cuda" else None]
               if len(devs) == 1 else None)
    planner = _WirePlanner(bps, stereo_trial)
    submitting = []             # the batch whose slices compute() runs

    def analyze(dev_blocks, or_vals=None, const_flags=None,
                return_chosen=False):
        return flac_frames.analyze_frames_packed(
            dev_blocks, stereo_trial, bps, block_size, max_lpc_order,
            precision, porders, max_rice, exhaustive_model_search,
            mid_side, windows[dev_blocks.device], or_vals=or_vals,
            const_flags=const_flags, return_chosen=return_chosen)

    def compute(dev, rows, wire_shape):
        """one slice of a batch on ``dev``: the upload on the device's
        side stream, then the analysis (and pack) on the current
        stream; returns the device outputs"""
        batch = submitting[0]
        t0 = time.perf_counter()
        if dev.type == "cuda":
            host = torch.from_numpy(rows).pin_memory()
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(5)]
            compute_stream = torch.cuda.current_stream(dev)
            copy = copy_streams[dev]
            with torch.cuda.stream(copy):
                ev[0].record(copy)
                up = host.to(dev, non_blocking=True)
                ev[1].record(copy)
            compute_stream.wait_stream(copy)
            up.record_stream(compute_stream)
            ev[2].record(compute_stream)
        else:
            ev = None
            up = torch.from_numpy(rows)
        t1 = time.perf_counter()
        chosen = None
        with span("enqueue"):
            if route == "wire":
                (k, W, E, V) = wire_shape
                (qblocks, orv, cflags) = qpack.unpack_wire(
                    up, k, W, channels, block_size, E, V)
                packed = analyze(qblocks, orv, cflags)
            elif route == "pack":
                (packed, chosen) = analyze(up, return_chosen=True)
            else:
                packed = analyze(up)
            outs = {"compact": flac_frames.compact_decisions(
                packed, max_subframes, max_lpc_order, P)}
        if ev is not None:
            ev[3].record(torch.cuda.current_stream(dev))
        t2 = time.perf_counter()
        if chosen is not None:
            (words, bits, ok) = bitpack.pack_chosen_residuals(
                chosen, block_size, bps, stereo_trial, P, rb_stride)
            outs.update(words=words, bits=bits, ok=ok.reshape(1))
        del chosen
        t3 = time.perf_counter()
        if ev is not None:
            ev[4].record(torch.cuda.current_stream(dev))
            batch.events.append(ev)
        else:
            for (i, dt) in enumerate((t1 - t0, t2 - t1, t3 - t2)):
                batch.cpu_times[i] += dt
        return outs

    split = Split(devs, compute, streams=streams, upload=False)
    D = len(devs)

    def pad_rows(arr):
        extra = (-arr.shape[0]) % D
        if not extra:
            return arr
        return np.concatenate(
            [arr, np.zeros((extra,) + arr.shape[1:], dtype=arr.dtype)])

    def submit(blocks, first_frame):
        """prepares one batch on the host and enqueues its device work;
        returns without waiting for the devices"""
        global wire_batches, patched_batches
        wire_shape = None
        t = None
        with span("qpack"):
            if route == "wire":
                (wire, k, W, E, t, V, patched) = planner.wire(blocks,
                                                              stream_md5)
                rows = pad_rows(wire.view(np.int32))
                wire_shape = (k, W, E, V)
                with COUNT_LOCK:
                    wire_batches += 1
                    patched_batches += int(patched)
            else:
                with span("md5"):
                    stream_md5.update_pcm(blocks.reshape(-1, channels), bps)
                rows = pad_rows(blocks.astype(np_upload))
        batch = _Batch(blocks, first_frame, t)
        submitting[:] = [batch]
        with span("submit"):
            batch.pending = split.submit([rows], (wire_shape,))
        return batch

    def exact_packed(blocks):
        """standard decision rows of an exact analysis of ``blocks`` on
        the encode's first device (the floor and overflow retries)"""
        dev = devs[0]
        with span("floor_analysis"):
            up = torch.from_numpy(blocks.astype(np_upload)).to(dev)
            with (torch.cuda.device(dev) if dev.type == "cuda"
                  else contextlib.nullcontext()):
                return analyze(up).cpu().numpy()

    def sub_fields(compact, s):
        """(choice, porder, rice [B, P]) of subframe s of compact rows"""
        B = compact.shape[0]
        base = 1 + s * CW
        w0 = compact[:, base].astype(np.uint32)
        rw = compact[:, base + 1 + (Kp + 1) // 2:base + CW].astype(
            np.uint32)
        rice = np.stack([(rw >> (8 * b)) & 0xFF for b in range(4)],
                        axis=2).reshape(B, -1)[:, :P].astype(np.int32)
        return ((w0 & 0xF).astype(np.int32),
                ((w0 >> 16) & 0xF).astype(np.int32), rice)

    def floor_stage1(compact, t_arr, blocks):
        """the floor retry's first stage: frames with a coded subframe
        whose used Rice parameters all sit at or below the frame's
        shift + 1 get the probe threshold t_base - 2 (t_base the plan
        without the noise extra), the rest -1; None when no frame
        qualifies"""
        t_frame = t_arr.max(axis=1)
        t_base = (t_frame if qpack.noise_extra() == 0 else
                  _native.flac_qplan_t(blocks, bps, noise_extra=0)
                  .max(axis=1))
        pidx = np.arange(P, dtype=np.int32)[None, :]
        cand = np.zeros(compact.shape[0], dtype=bool)
        for s in range(max_subframes):
            (choice, porder, rice) = sub_fields(compact, s)
            rmax = np.where(pidx < (1 << porder)[:, None], rice, -1).max(
                axis=1)
            coded = (choice == flac_frames.CHOICE_FIXED) | (
                choice == flac_frames.CHOICE_LPC)
            cand |= coded & (rmax <= t_frame + 1) & (t_frame > 0)
        if not cand.any():
            return None
        return np.where(cand, t_base - 2, -1).astype(np.int32)

    def emit_rows(blocks, first, packed, compact, **kw):
        B = blocks.shape[0]
        return _native.flac_emit_frames2(
            blocks, np.arange(first, first + B, dtype=np.int64),
            np.full(B, block_size, dtype=np.int32), packed, max_subframes,
            Kp, P, sample_rate, bps, channels, precision, compact=compact,
            **kw)

    def restitch_floor(blocks, flags, first_frame, frame_bytes, lens):
        """re-analyses the probe-flagged frames exactly, re-emits them and
        splices their bytes over the batch's"""
        idx = np.nonzero(flags)[0]
        sub = np.ascontiguousarray(blocks[idx])
        exact = exact_packed(sub)
        with span("floor_emit"):
            (bytes_b, lens_b) = _native.flac_emit_frames2(
                sub, (first_frame + idx).astype(np.int64),
                np.full(len(idx), block_size, dtype=np.int32), exact,
                max_subframes, Kp, P, sample_rate, bps, channels, precision)
            pieces = []
            out_lens = np.empty(len(lens), dtype=np.int64)
            (oa, ob, ib) = (0, 0, 0)
            for f in range(len(lens)):
                if flags[f]:
                    ln = int(lens_b[ib])
                    ib += 1
                    pieces.append(bytes_b[ob:ob + ln])
                    ob += ln
                    oa += int(lens[f])
                else:
                    ln = int(lens[f])
                    pieces.append(frame_bytes[oa:oa + ln])
                    oa += ln
                out_lens[f] = ln
            return (b"".join(pieces), out_lens)

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
        with span("wait"):
            outs = split.collect(batch.pending)
        for ev in batch.events:
            for (stage, (a, b)) in zip(("upload", "analysis", "pack"),
                                       ((0, 1), (2, 3), (3, 4))):
                stages.add(stage, ev[a].elapsed_time(ev[b]) / 1e3)
        for (pend, ev) in zip((p for p in batch.pending
                               if p[1] is not None), batch.events):
            stages.add("fetch", ev[4].elapsed_time(pend[1]) / 1e3)
        for (stage, dt) in zip(("upload", "analysis", "pack"),
                               batch.cpu_times):
            stages.add(stage, dt)
        with span("emit"):
            emit_batch(batch, outs)

    def emit_batch(batch, outs):
        """a collected batch's frames, its floor and overflow retries,
        written"""
        global fallback_batches, floor_frames, overflow_batches
        blocks = batch.blocks
        B = blocks.shape[0]
        compact = outs["compact"][:B]
        splice = {}
        if route == "pack":
            if bool(outs["ok"].all()):
                S = B * max_subframes
                splice = {"rb_words": outs["words"][:S].view(np.uint32),
                          "rb_bits": outs["bits"][:S]}
            else:
                with COUNT_LOCK:
                    fallback_batches += 1
        probe_thr = probe_out = None
        if batch.t is not None:
            probe_thr = floor_stage1(compact, batch.t, blocks)
            if probe_thr is not None:
                probe_out = np.zeros(B, dtype=np.uint8)
        try:
            (frame_bytes, lens) = emit_rows(
                blocks, batch.first_frame, compact, True,
                probe_thr=probe_thr, probe_out=probe_out, **splice)
            if probe_out is not None and probe_out.any():
                with span("floor"):
                    (frame_bytes, lens) = restitch_floor(
                        blocks, probe_out.astype(bool), batch.first_frame,
                        frame_bytes, lens)
                with COUNT_LOCK:
                    floor_frames += int(np.count_nonzero(probe_out))
        except _native.EmitOverflow:
            # decisions from the quantized analysis implied unsafe Rice
            # parameters: the whole batch again from an exact analysis
            with span("floor"):
                exact = exact_packed(blocks)
                with span("floor_emit"):
                    (frame_bytes, lens) = emit_rows(
                        blocks, batch.first_frame, exact, False)
            with COUNT_LOCK:
                overflow_batches += 1
        with span("write"):
            write_frames(frame_bytes, lens, block_size)

    pending = None
    submitted_frames = 0
    while True:
        with span("read"):
            framelist = reader.read(block_size * batch_frames)
        if framelist.frames == 0:
            break
        total_pcm_frames += framelist.frames
        samples = framelist.samples              # int32 [frames, ch]
        n_full = samples.shape[0] // block_size
        full = samples[:n_full * block_size]
        tail = samples[n_full * block_size:]

        if n_full:
            batch = submit(np.ascontiguousarray(
                full.reshape(n_full, block_size, channels)),
                submitted_frames)
            submitted_frames += n_full
            # the devices work on this batch while the host emits the
            # previous one
            if pending is not None:
                emit(pending)
            pending = batch
        if tail.shape[0]:
            with span("md5"):
                stream_md5.update_pcm(tail, bps)
            if pending is not None:
                emit(pending)
                pending = None
            with span("tail"):
                frame_bytes = oracle.encode_frame(
                    reader, options, submitted_frames,
                    tail.astype(np.int64))
            submitted_frames += 1
            with span("write"):
                write_frames(frame_bytes, [len(frame_bytes)],
                             tail.shape[0])
    if pending is not None:
        emit(pending)
    stages.report(extra="(%d frames)" % len(frame_sizes))

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
    return frame_offsets
