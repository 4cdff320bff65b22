"""Batched ALAC decoder on a torch device: the entropy scan on the
host, the sign-adaptive predictor on the device.

Port of the reference's device decode path
(``audiotools_tpu/codecs/alac_dec_jax.py``, ``JaxALACDecoder``).  Per
batch of up to MAX_BATCH_FRAMESETS framesets:

1. host: ``_native.alac_scan`` decodes ALAC's history-adaptive Rice
   codes (their bit positions depend on the decoded values) into
   residual planes, with each subframe's predictor and each channel
   pair's interlacing and low-byte parameters;
2. device: the arrays go up in one copy from pinned memory;
   ``alac_synth.synthesize`` inverts the predictors; uncompressed
   rows take their residual row as is; ``decorrelate`` and
   ``merge_lsbs`` restore the pairs; one index gather puts the
   channels in wave order; 16-bit streams narrow to int16;
3. host: the PCM comes back to pinned memory and is trimmed to each
   frameset's sample count.

A batch holding a subframe of order above MAX_ORDER, or a compressed
subframe with a shift below 1 (both legal ALAC that this project's
encoder never writes), is decoded by the host C++ decoder instead, as
in the reference, and counted in ``host_chunks``.  On the CPU every
stage runs the plain versions.
"""

from __future__ import annotations

import io
import time

import numpy as np
import torch

from .. import _native, pcm
from .._device import COUNT_LOCK, StageMarks, fetch_async, resolve_device
from ..ops import alac_synth
from ..ref.alac import WAVE_ORDER
from .alac_fast import FastALACDecoder
from .flac_dec import upload_arrays

# framesets per device batch
MAX_BATCH_FRAMESETS = 1024
# largest predictor order the device path takes (the reference's)
MAX_ORDER = 8

# per-stage seconds accumulated in TorchALACDecoder.timings: the host
# scan and array preparation, then the device stages (CUDA-event spans
# on a card, which include the host's time to enqueue their kernels)
STAGES = ("scan", "prep", "upload", "synth", "finish", "fetch")

# batches decoded by the host C++ decoder instead of the device
# (process-wide count, for reports; added to under _device.COUNT_LOCK)
host_chunks = 0


def prepare_batch(scan, channels):
    """the device arrays of one scanned batch, int32 numpy, in upload
    order: residuals [S, spf], qlp [S, MAX_ORDER], sub (order, shift,
    sample size, is-raw) [4, S], rows (the synthesis kernel's row
    grouping by order, alac_synth.group_rows), pairs (row of channel
    0, row of channel 1, leftweight, interlacing shift, low bits) [5,
    G], wave
    (the [F * channels] rows of the decoded pairs, left rows then
    right rows, that make each frameset's wave-order channels) and,
    when a pair carries low bytes, lsbs [G, spf, 2]"""
    sub_meta = scan["sub_meta"]
    pair_meta = scan["pair_meta"]
    G = pair_meta.shape[0]
    F = scan["fs_count"].shape[0]
    width = pair_meta[:, 1]
    row0 = np.cumsum(width) - width
    arrays = {
        "residuals": scan["residuals"],
        "qlp": scan["qlp"][:, :MAX_ORDER],
        "sub": np.stack([sub_meta[:, 2], np.maximum(sub_meta[:, 3], 1),
                         np.maximum(sub_meta[:, 4], 1), sub_meta[:, 6]]),
        "rows": alac_synth.group_rows(sub_meta[:, 2]),
        "pairs": np.stack([row0, row0 + (width == 2),
                           pair_meta[:, 4], np.maximum(pair_meta[:, 3], 1),
                           pair_meta[:, 2] * 8]),
    }
    # pair g's left channel sits at ALAC channel fs * channels + base,
    # its right one (width 2) next to it
    alac_src = np.full(F * channels, -1, dtype=np.int64)
    dest = pair_meta[:, 6].astype(np.int64) * channels + pair_meta[:, 0]
    alac_src[dest] = np.arange(G)
    two = width == 2
    alac_src[dest[two] + 1] = G + np.nonzero(two)[0]
    wave = alac_src.reshape(F, channels)[:, WAVE_ORDER[channels]]
    if (wave < 0).any():
        raise ValueError("corrupt ALAC stream: a frameset lacks a channel")
    arrays["wave"] = wave.reshape(-1)
    if (pair_meta[:, 2] > 0).any():
        arrays["lsbs"] = scan["lsbs"]
    return {k: np.ascontiguousarray(v, dtype=np.int32)
            for (k, v) in arrays.items()}


def synthesize_batch(tensors):
    """the predictor inversion of one batch: int32 [S, spf], raw rows
    taken as is"""
    residuals = tensors["residuals"]
    (order, shift, sample_size, is_raw) = tensors["sub"]
    synth = alac_synth.synthesize(residuals, tensors["qlp"], order, shift,
                                  sample_size, MAX_ORDER, tensors["rows"])
    return torch.where(is_raw[:, None] != 0, residuals, synth)


def finish_batch(tensors, samples, channels, narrow):
    """decorrelation, low-byte merge and the wave-order gather:
    [F, spf, channels], int16 when ``narrow``, else int32"""
    (row0, row1, lweight, ishift, lsb_bits) = tensors["pairs"]
    (left, right) = alac_synth.decorrelate(samples[row0], samples[row1],
                                           lweight, ishift)
    if "lsbs" in tensors:
        lsbs = tensors["lsbs"]
        left = alac_synth.merge_lsbs(left, lsbs[:, :, 0], lsb_bits)
        right = alac_synth.merge_lsbs(right, lsbs[:, :, 1], lsb_bits)
    spf = samples.shape[1]
    planes = torch.cat([left, right]).index_select(0, tensors["wave"])
    out = planes.view(-1, channels, spf).transpose(1, 2)
    fetched = torch.empty(out.shape, device=out.device,
                          dtype=torch.int16 if narrow else torch.int32)
    return fetched.copy_(out)


class TorchALACDecoder(FastALACDecoder):
    """a PCMReader decoding the ALAC stream of an M4A file on a torch
    device

    device: "cuda" (raises when no card is usable) or "cpu" (the plain
    versions, for tests).  read() decodes MAX_BATCH_FRAMESETS-deep
    batches and serves the caller from the decoded PCM, never more
    frames than asked; seek() is the host decoder's (stsz table).
    ``timings`` accumulates seconds per STAGES."""

    def __init__(self, file_or_path, device="cuda"):
        self.device = resolve_device(device)
        FastALACDecoder.__init__(self, file_or_path)
        self.timings = dict.fromkeys(STAGES, 0.0)
        # an upper bound on the bytes of one frameset
        self._frameset_bytes = (self.samples_per_frame * self.channels *
                                -(-self.bits_per_sample // 8) +
                                16 * self.channels + 16)
        self._pcm = None
        self._pcm_off = 0

    def _after_seek(self):
        self._pcm = None
        self._pcm_off = 0

    def read(self, pcm_frames):
        if self._pcm is None or self._pcm_off >= self._pcm.shape[0]:
            if self._remaining <= 0:
                return pcm.empty_framelist(self.channels,
                                           self.bits_per_sample)
            served = self._decode_batch(pcm_frames)
            if served is not None:
                return served       # the host decoder's frames
        take = min(self._pcm.shape[0] - self._pcm_off,
                   max(int(pcm_frames), 1))
        chunk = self._pcm[self._pcm_off:self._pcm_off + take]
        self._pcm_off += take
        return pcm.FrameList._wrap(chunk, self.bits_per_sample)

    def _decode_batch(self, pcm_frames):
        """decodes up to MAX_BATCH_FRAMESETS framesets into the PCM
        buffer; returns None, or the host decoder's frames when the
        batch takes the host route"""
        global host_chunks
        spf = self.samples_per_frame
        framesets = min(MAX_BATCH_FRAMESETS, -(-self._remaining // spf))
        t0 = time.perf_counter()
        self._fill(max(self.CHUNK_BYTES, framesets * self._frameset_bytes))
        try:
            scan = _native.alac_scan(
                self._buffer, self.bits_per_sample, self.channels, spf,
                self.initial_history, self.history_multiplier,
                self.maximum_k, framesets * spf,
                framesets * self.channels + self.channels)
            sub_meta = scan["sub_meta"]
        except ValueError:
            scan = None     # a corrupt frameset: the host decoder's error
        if (scan is None or scan["total_frames"] <= 0 or
                (sub_meta[:, 2] > MAX_ORDER).any() or
                ((sub_meta[:, 6] == 0) & (sub_meta[:, 3] < 1)).any()):
            # nothing scanned (a truncated tail), a corrupt frameset, an
            # order above MAX_ORDER or a shift below 1: the host
            # decoder's
            with COUNT_LOCK:
                host_chunks += 1
            return FastALACDecoder.read(self, pcm_frames)
        t1 = time.perf_counter()
        narrow = self.bits_per_sample <= 16
        arrays = prepare_batch(scan, self.channels)
        t2 = time.perf_counter()
        samples = self._decode_on_device(arrays, narrow)
        self.timings["scan"] += t1 - t0
        self.timings["prep"] += t2 - t1
        counts = scan["fs_count"]
        if (counts == spf).all():
            samples = samples.reshape(-1, self.channels)
        else:
            samples = np.concatenate([samples[f, :counts[f]]
                                      for f in range(len(counts))])
        self._buffer = self._buffer[scan["consumed_bytes"]:]
        self._pcm = samples[:self._remaining]
        self._pcm_off = 0
        self._remaining -= self._pcm.shape[0]
        return None

    def _decode_on_device(self, arrays, narrow):
        """uploads one batch, runs its device stages and returns its PCM
        [F, spf, channels] as int32 numpy"""
        marks = StageMarks(self.device)
        marks.mark()
        tensors = upload_arrays(arrays, self.device)
        marks.mark()
        samples = synthesize_batch(tensors)
        marks.mark()
        out = finish_batch(tensors, samples, self.channels, narrow)
        marks.mark()
        out = fetch_async(out)
        marks.mark()
        for (stage, t) in zip(STAGES[2:], marks.seconds()):
            self.timings[stage] += t
        return out.numpy().astype(np.int32)


def decode_alac(data, device="cuda"):
    """a whole ALAC M4A file's bytes -> int32 samples [frames,
    channels], decoded by TorchALACDecoder on ``device``"""
    dec = TorchALACDecoder(io.BytesIO(data), device=device)
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
