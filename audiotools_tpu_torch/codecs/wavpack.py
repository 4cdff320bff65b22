"""WavPack encode and decode with the decorrelation passes on a torch
device.

Port of the reference's ``audiotools_tpu/codecs/wavpack_jax.py``:

* ``encode_wavpack``: the host (``ref/wavpack.encode_wavpack``) reads
  the PCM, takes each block's false-stereo, wasted-bits and joint-stereo
  decisions and writes its sub-blocks, the adaptive residual coder and
  the CRC (C++); each frame's correlation passes, for all of its channel
  groups at once, run on the device (``ops/wv_scan.run_pass_chain``,
  the kernel ``csrc/wv_chain.cu``), and the final weights and stored
  samples come back for the host to quantize into the next block's
  state: one launch and one fetch a frame, whatever the blocks'
  lengths;
* ``TorchWavPackDecoder``: parses ``batch_blocks`` blocks ahead (the
  sub-block walk and the C++ entropy decode), runs the decode pass
  chains of all of them in one launch (``ops/wv_scan.run_dec_chain``,
  ragged: each block its own length, channel count and chain), and
  finishes each block on the host: joint stereo, the CRC, extended
  integers, the stream MD5.  Blocks the device path does not take
  (``device_inputs`` returns None) run the host C++ passes and are
  counted in ``host_blocks``.
"""

from __future__ import annotations

import io
import time

import numpy as np
import torch

from .._device import StageMarks, fetch_async, resolve_device
from ..ops import wv_scan
from ..ref import wavpack as oracle
from .flac_dec import upload_arrays

# blocks a device decode batch holds at most (whole block groups): the
# blocks are independent, a CUDA block each, so the batch sets the
# kernel's parallelism and the memory a batch holds; the output does
# not depend on it.  The reference's default (ATPU_WV_DEC_BATCH).
DEC_BATCH_BLOCKS = 32

# per-stage seconds accumulated by encode_wavpack(timings=...): the
# device stages of the correlation (CUDA-event spans on a card), and the
# rest of the encode on the host (PCM reads, decisions, sub-blocks, the
# residual coder, the CRC and the MD5)
ENCODE_STAGES = ("upload", "corr", "fetch", "host")

# per-stage seconds accumulated in TorchWavPackDecoder.timings: the
# host parse and entropy decode, the device stages, the host finish
# (joint stereo, CRC, extended integers) and the stream MD5
DECODE_STAGES = ("parse", "upload", "decorr", "fetch", "finish", "md5")

_BATCH_KEYS = ("x", "meta", "chain", "weights", "samples")


def _run_batch(fn, blocks, dev, timings, stage):
    """packs the blocks, uploads them, runs fn on the batch tensors and
    fetches its outputs; returns (the batch's host arrays, the outputs
    as numpy arrays), adding the stages' seconds to timings"""
    batch = wv_scan.pack_blocks(blocks)
    marks = StageMarks(dev)
    marks.mark()
    tensors = upload_arrays(batch, dev, dtype=torch.int64)
    marks.mark()
    outs = fn(*(tensors[k] for k in _BATCH_KEYS))
    outs = outs if isinstance(outs, tuple) else (outs,)
    marks.mark()
    outs = [fetch_async(t) for t in outs]
    marks.mark()
    for (name, seconds) in zip(("upload", stage, "fetch"), marks.seconds()):
        timings[name] = timings.get(name, 0.0) + seconds
    return (batch, [t.numpy() for t in outs])


class DeviceCorrelate:
    """the encoder's ``correlate`` (see ref/wavpack.encode_wavpack) on
    a torch device: the chains of a frame's blocks in one launch"""

    def __init__(self, device, timings):
        self.device = device
        self.timings = timings

    def __call__(self, jobs):
        blocks = [(np.stack(uncorrelated[:cc]),
                   [(p.term, p.delta) for p in params],
                   [p.weights for p in params],
                   [p.samples for p in params])
                  for (uncorrelated, params, cc) in jobs]
        (batch, (out, w_out, s_out)) = _run_batch(
            wv_scan.run_pass_chain, blocks, self.device, self.timings,
            "corr")
        results = []
        for (b, ((_u, params, cc), x)) in enumerate(
                zip(jobs, wv_scan.unpack(out, batch["meta"]))):
            for (p_i, p) in enumerate(params):
                p.update_weights(w_out[b, p_i, :cc].tolist())
                p.update_samples(s_out[b, p_i, :cc, :wv_scan.span(p.term)]
                                 .tolist())
            results.append(list(x))
        return results


def encode_wavpack(file_or_path, pcmreader, block_size, correlation_passes=0,
                   total_pcm_frames=0, device="cuda", timings=None,
                   wave_header=None, wave_footer=None):
    """encodes a WavPack stream from a PCMReader, with the correlation
    passes on a torch device

    device: "cuda" (raises when no card is usable) or "cpu" (the plain
    versions, for tests).  timings: optional dict that receives seconds
    per ENCODE_STAGES.  wave_header, wave_footer: the RIFF bytes to
    store in place of the built header (as ``ref/wavpack.encode_wavpack``
    takes them).  The bytes are the reference encoder's."""
    dev = resolve_device(device)
    stages = {}
    correlate = DeviceCorrelate(dev, stages)
    t0 = time.perf_counter()
    oracle.encode_wavpack(file_or_path, pcmreader, block_size,
                          total_pcm_frames=total_pcm_frames,
                          correlation_passes=correlation_passes,
                          correlate=correlate, wave_header=wave_header,
                          wave_footer=wave_footer)
    wall = time.perf_counter() - t0
    if timings is not None:
        stages["host"] = wall - sum(stages.values())
        for stage in ENCODE_STAGES:
            timings[stage] = timings.get(stage, 0.0) + stages.get(stage, 0.0)


def device_inputs(parsed):
    """a parsed block (ref/wavpack.parse_block) as a block of
    ops/wv_scan.pack_blocks, (x [cc, n], chain, weights, samples); None
    when it takes the host passes: no passes or no samples, cc not 1 or
    2, a term outside 1-8, 17, 18 and (two channels) -1 to -3, or a
    pass's stored samples fewer than its term needs"""
    residuals = parsed["residuals"]
    terms = parsed["terms"]
    cc = len(residuals)
    if cc not in (1, 2) or not terms or len(residuals[0]) == 0:
        return None
    for term in terms:
        if not (1 <= term <= 8 or term in (17, 18) or
                (-3 <= term <= -1 and cc == 2)):
            return None
    samples = []
    for (term, stored) in zip(terms, parsed["samples"]):
        if len(stored) < cc or any(len(stored[c]) != wv_scan.span(term)
                                   for c in range(cc)):
            return None
        samples.append(stored[:cc])
    return (np.stack([np.asarray(r, dtype=np.int64) for r in residuals]),
            list(zip(terms, parsed["deltas"])),
            [w[:cc] for w in parsed["weights"]], samples)


class TorchWavPackDecoder(oracle.WavPackDecoder):
    """a PCMReader decoding a WavPack stream with the decorrelation
    passes on a torch device

    device: "cuda" (raises when no card is usable) or "cpu" (the plain
    versions, for tests).  read() returns one block group (every channel
    of one block index) at a time, decoding batch_blocks blocks ahead;
    ``timings`` accumulates seconds per DECODE_STAGES and
    ``host_blocks`` counts the blocks that ran the host passes."""

    def __init__(self, file_or_path, device="cuda",
                 batch_blocks=DEC_BATCH_BLOCKS):
        self.device = resolve_device(device)
        oracle.WavPackDecoder.__init__(self, file_or_path)
        self.batch_blocks = batch_blocks
        self.timings = dict.fromkeys(DECODE_STAGES, 0.0)
        self.host_blocks = 0
        self._queue = []

    def read(self, pcm_frames):
        if self._queue:
            return self._queue.pop(0)
        if self.pcm_finished:
            return oracle.WavPackDecoder.read(self, pcm_frames)
        t0 = time.perf_counter()
        groups = []
        count = 0
        while not self.pcm_finished and count < self.batch_blocks:
            (group, ok) = self.read_group()
            if not ok:
                # a group cut short at the stream's end is dropped, as
                # the host decoder drops it
                self.pcm_finished = True
                break
            groups.append([(header, oracle.parse_block(header, sub_blocks))
                           for (header, sub_blocks) in group])
            count += len(group)
            self.group_done(group[-1][0])
        self.timings["parse"] += time.perf_counter() - t0
        if not groups:
            return oracle.WavPackDecoder.read(self, pcm_frames)
        decorrelated = iter(self._decorrelate(
            [parsed for group in groups for (_h, parsed) in group]))
        for group in groups:
            t0 = time.perf_counter()
            channels = []
            for (header, parsed) in group:
                channels.extend(oracle.finish_block(header, parsed,
                                                    next(decorrelated)))
            t1 = time.perf_counter()
            self._queue.append(self.framelist(channels))
            self.timings["finish"] += t1 - t0
            self.timings["md5"] += time.perf_counter() - t1
        return self._queue.pop(0)

    def _decorrelate(self, parsed_blocks):
        """the decorrelated channels of each parsed block: one device
        launch for those device_inputs takes, the host passes for the
        rest"""
        results = [None] * len(parsed_blocks)
        blocks = []
        on_device = []
        for (k, parsed) in enumerate(parsed_blocks):
            block = device_inputs(parsed)
            if block is not None:
                blocks.append(block)
                on_device.append(k)
            elif parsed["terms"]:
                results[k] = oracle.decorrelate_host(parsed)
                self.host_blocks += 1
            else:
                results[k] = parsed["residuals"]
        if blocks:
            (batch, (out,)) = _run_batch(wv_scan.run_dec_chain, blocks,
                                         self.device, self.timings, "decorr")
            for (k, x) in zip(on_device, wv_scan.unpack(out, batch["meta"])):
                results[k] = list(x)
        return results

    def seek(self, pcm_frame):
        self._queue = []
        return oracle.WavPackDecoder.seek(self, pcm_frame)


def decode_wavpack(data, device="cuda"):
    """a whole WavPack stream's bytes -> int32 samples [frames, channels],
    decoded by TorchWavPackDecoder on ``device``, the stream MD5 checked
    (ValueError when it differs)"""
    dec = TorchWavPackDecoder(io.BytesIO(data), device=device)
    pieces = []
    try:
        while True:
            framelist = dec.read(1 << 20)
            if framelist.frames == 0:
                break
            pieces.append(framelist.samples)
    finally:
        dec.close()
    if not pieces:
        return np.zeros((0, dec.channels), dtype=np.int32)
    return np.concatenate(pieces, axis=0)
