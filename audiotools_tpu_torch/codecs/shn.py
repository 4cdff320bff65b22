"""Shorten encode and decode with the batchable halves on a torch
device.

Port of the reference's ``audiotools_tpu/codecs/shn.py``:

* ``encode_shn``: the reference's ``ATPU_SHN_BACKEND=jax`` branch.  The
  PCM goes up once, ``ops/shn_scan.stream_decisions`` computes every
  (block, channel)'s zero flag, wasted bits, diff order and energy on
  the device, and the decisions come back to steer the C++ emitter
  (``_native.shn_encode``), which re-derives the residuals from the
  host PCM;
* ``TorchSHNDecoder`` (the reference's ``_decode_jax`` behind
  ``FastSHNDecoder`` with ``ATPU_SHN_DEC_BACKEND=jax``): the host scans
  the entropy codes into residual rows (``_native.shn_scan``) and
  chains the rows' warm-up samples (``_native.shn_warm_chain``); the
  device inverts the predictors (``ops/shn_synth.synthesize``) and
  interleaves the rows into frames (``ops/shn_synth.interleave``);
* ``FastSHNDecoder``: the C++ host decoder (``_native.shn_decode``);
* with ``ATPU_SHN_ORACLE=1``, read at each call, the reference's scalar
  encoder and decoder (``ref/shn``) on the host in place of both
  (``encode_shn``/``encode_samples``, ``decoder_for_file``): the same
  bytes and samples, no kernel launched and no card touched.  Only the
  variable selects them; a card path that fails raises.

Streams outside the device decode's coverage (QLPC, DIFF0 with means,
energy above 30: the scan raises ShnDeviceUnsupported) are a format
rule, not a device failure: ``TorchSHNDecoder`` decodes them on the
host, as the reference does, and says so in ``host_fallback``.

Sample rate and channel mask come from the VERBATIM chunk that the
stream starts with (an embedded WAVE fmt or AIFF COMM chunk), else
44100 Hz and the default mask, as in the reference's
``ref/shn.SHNDecoder``, which reads the first command only
(``_native.shn_header``; ``_native.shn_split`` would walk every code of
the stream for it).
"""

from __future__ import annotations

import io
import os
import struct
import time

import numpy as np
import torch

from .. import _native, pcm
from .._device import StageMarks, fetch_async, resolve_device
from ..formats.aiff import parse_comm
from ..formats.wav import (EXTENSIBLE_GUID, WAVE_FORMAT_EXTENSIBLE,
                           WAVE_FORMAT_PCM)
from ..ops import shn_scan, shn_synth
from ..ref import shn as oracle
from .flac_dec import upload_arrays

# per-stage seconds accumulated by encode_shn(timings=...) and in
# TorchSHNDecoder.timings; device stages are CUDA-event spans on a card
ENCODE_STAGES = ("upload", "analysis", "fetch", "emit")
DECODE_STAGES = ("scan", "warm", "upload", "synth", "interleave", "fetch")

# the reference decoder's channel masks where the header names none
_DEFAULT_MASKS = {1: 0x4, 2: 0x3}


def _use_oracle():
    """True when ATPU_SHN_ORACLE is 1"""
    return os.environ.get("ATPU_SHN_ORACLE", "0") == "1"


def _add(timings, stage, seconds):
    if timings is not None:
        timings[stage] = timings.get(stage, 0.0) + seconds


def encode_shn(file_or_path, pcmreader, is_big_endian, signed_samples,
               header_data, footer_data=b"", block_size=256, device="cuda",
               timings=None):
    """encodes a Shorten stream from a PCMReader, with the decision
    analysis on a torch device

    file_or_path: a path or a writable binary file.  header_data and
    footer_data go into VERBATIM chunks before and after the audio.
    device: "cuda" (raises when no card is usable) or "cpu" (the plain
    versions, for tests).  timings: optional dict that receives seconds
    per ENCODE_STAGES.  Under ATPU_SHN_ORACLE=1 the reference's scalar
    encoder writes the stream on the host (no timings)."""
    if _use_oracle():
        oracle.encode_shn(file_or_path, pcmreader, is_big_endian,
                          signed_samples, header_data, footer_data,
                          block_size)
        return
    encode_samples(file_or_path, pcm.read_all(pcmreader),
                   pcmreader.bits_per_sample, is_big_endian, signed_samples,
                   header_data, footer_data, block_size, device, timings)


def encode_samples(file_or_path, samples, bps, is_big_endian, signed_samples,
                   header_data, footer_data=b"", block_size=256,
                   device="cuda", timings=None):
    """encode_shn of int32 PCM samples [frames, channels] of ``bps``
    bits"""
    if _use_oracle():
        oracle.encode_shn(file_or_path, pcm.reader_from_array(samples, bps),
                          is_big_endian, signed_samples, header_data,
                          footer_data, block_size)
        return
    dev = resolve_device(device)
    decisions = None
    if samples.shape[0]:
        marks = StageMarks(dev)
        marks.mark()
        on_dev = upload_arrays({"samples": samples}, dev)["samples"]
        marks.mark()
        dec = shn_scan.stream_decisions(on_dev, bps, signed_samples,
                                        block_size)
        marks.mark()
        dec = fetch_async(dec)
        marks.mark()
        for (stage, t) in zip(ENCODE_STAGES, marks.seconds()):
            _add(timings, stage, t)
        decisions = dec.numpy()
    t0 = time.perf_counter()
    data = _native.shn_encode(samples, bps, signed_samples, is_big_endian,
                              header_data, footer_data, block_size,
                              decisions=decisions)
    _add(timings, "emit", time.perf_counter() - t0)
    if isinstance(file_or_path, str):
        with open(file_or_path, "wb") as f:
            f.write(data)
    else:
        file_or_path.write(data)


def stream_params(head, channels):
    """(sample_rate, channel_mask) from the bytes of a stream's leading
    VERBATIM chunk: an embedded WAVE fmt chunk or AIFF COMM chunk, else
    44100 and the default mask for the channel count"""
    default = (44100, _DEFAULT_MASKS.get(channels, 0))
    if head[0:4] == b"RIFF" and head[8:12] == b"WAVE":
        (order, want) = ("<", b"fmt ")
    elif head[0:4] == b"FORM" and head[8:12] == b"AIFF":
        (order, want) = (">", b"COMM")
    else:
        return default
    pos = 12
    while pos + 8 <= len(head):
        (chunk_id, size) = struct.unpack(order + "4sI", head[pos:pos + 8])
        pos += 8
        body = head[pos:pos + size]
        if chunk_id == want:
            return _wave_params(body, default) if want == b"fmt " else \
                _aiff_params(body)
        pos += size + (size % 2)
    return default


def _wave_params(fmt, default):
    """the reference's parse_fmt: a plain PCM chunk has the default
    mask of 1-2 channels (0 for more), an extensible one its own; any
    other chunk leaves the defaults"""
    if len(fmt) < 16:
        return default
    (compression, channels, sample_rate) = struct.unpack("<HHI", fmt[:8])
    if compression == WAVE_FORMAT_PCM:
        return (sample_rate, _DEFAULT_MASKS.get(channels, 0))
    if (compression == WAVE_FORMAT_EXTENSIBLE and len(fmt) >= 40 and
            fmt[24:26] == b"\x01\x00" and fmt[26:40] == EXTENSIBLE_GUID):
        return (sample_rate, struct.unpack("<I", fmt[20:24])[0])
    return default


def _aiff_params(comm):
    """the reference's parse_comm: the 80-bit IEEE extended sample rate
    and the default mask of 1-2 channels"""
    (_channels, _frames, _bps, rate, mask) = parse_comm(comm)
    return (rate, mask)


class FastSHNDecoder:
    """a PCMReader decoding a whole Shorten stream on the host (C++) at
    the first read

    file_or_path: a path, or a binary file positioned at the stream."""

    def __init__(self, file_or_path):
        if isinstance(file_or_path, str):
            with open(file_or_path, "rb") as f:
                self.data = f.read()
        else:
            self.data = file_or_path.read()
        header = _native.shn_header(self.data)
        self.file_type = header["file_type"]
        self.channels = header["channels"]
        if self.file_type in (1, 2):
            self.bits_per_sample = 8
        elif self.file_type in (3, 4, 5, 6):
            self.bits_per_sample = 16
        else:
            raise ValueError("unsupported Shorten file type")
        self.signed_samples = self.file_type in (1, 3, 5)
        (self.sample_rate, self.channel_mask) = stream_params(
            header["head"], self.channels)
        self.decoded = None
        self.offset = 0
        self.closed = False

    def _decode(self):
        """the whole stream as int32 [frames, channels]"""
        # residuals cost >= ~2 bits each, so the frame count is bounded
        # by the stream size
        max_frames = ((len(self.data) * 4) // self.channels) + 1024
        (samples, _ftype, _bps) = _native.shn_decode(self.data, max_frames,
                                                     self.channels)
        return samples

    def read(self, pcm_frames):
        """up to max(pcm_frames, 1) frames; empty at the end"""
        if self.closed:
            raise ValueError("stream is closed")
        if self.decoded is None:
            self.decoded = self._decode()
        chunk = self.decoded[self.offset:self.offset + max(int(pcm_frames),
                                                           1)]
        self.offset += chunk.shape[0]
        return pcm.FrameList._wrap(np.ascontiguousarray(chunk, dtype=np.int32),
                             self.bits_per_sample)

    def seekable(self):
        return True

    def seek(self, pcm_frame):
        """seeks within the decoded stream; returns the position"""
        if self.decoded is None:
            self.decoded = self._decode()
        self.offset = max(min(int(pcm_frame), self.decoded.shape[0]), 0)
        return self.offset

    def close(self):
        self.closed = True


class TorchSHNDecoder(FastSHNDecoder):
    """a PCMReader decoding a Shorten stream with the synthesis on a
    torch device

    device: "cuda" (raises when no card is usable) or "cpu" (the plain
    torch ops, for tests).  The whole stream decodes at the first read.
    ``host_fallback`` turns True when the stream is outside the device
    decode's coverage and was decoded on the host; ``timings``
    accumulates seconds per DECODE_STAGES."""

    def __init__(self, file_or_path, device="cuda"):
        self.device = resolve_device(device)
        FastSHNDecoder.__init__(self, file_or_path)
        self.host_fallback = False
        self.timings = dict.fromkeys(DECODE_STAGES, 0.0)

    def _decode(self):
        t0 = time.perf_counter()
        try:
            (res, row_meta, info) = _native.shn_scan(self.data)
        except _native.ShnDeviceUnsupported:
            self.host_fallback = True
            return FastSHNDecoder._decode(self)
        t1 = time.perf_counter()
        warm = _native.shn_warm_chain(res, row_meta, info["channels"])
        self.timings["scan"] += t1 - t0
        self.timings["warm"] += time.perf_counter() - t1
        if res.shape[0] == 0:
            return np.zeros((0, info["channels"]), dtype=np.int32)
        marks = StageMarks(self.device)
        marks.mark()
        # warm first, so that its int32 halves start 8-byte aligned
        up = upload_arrays({"warm": warm.view(np.int32), "res": res,
                            "meta": row_meta}, self.device)
        marks.mark()
        meta = up["meta"]
        planes = shn_synth.synthesize(up["res"], meta[:, 0],
                                      up["warm"].view(torch.int64),
                                      meta[:, 2], info["sign_adjustment"])
        marks.mark()
        out = shn_synth.interleave(planes, meta[:, 1], meta[:, 3],
                                   info["channels"], info["total_frames"])
        marks.mark()
        out = fetch_async(out)
        marks.mark()
        for (stage, t) in zip(DECODE_STAGES[2:], marks.seconds()):
            self.timings[stage] += t
        return out.numpy()


def decode_shn(data, device="cuda"):
    """a whole Shorten stream's bytes -> int32 samples [frames,
    channels], decoded by TorchSHNDecoder on ``device``"""
    dec = TorchSHNDecoder(io.BytesIO(data), device=device)
    dec.seek(0)
    return dec.decoded


def decoder_for_file(file_or_path, device="cuda"):
    """a PCMReader decoding a Shorten path or binary file:
    TorchSHNDecoder on ``device``, or the scalar SHNDecoder on the host
    under ATPU_SHN_ORACLE=1"""
    if _use_oracle():
        return oracle.SHNDecoder(file_or_path)
    return TorchSHNDecoder(file_or_path, device=device)


def split_stream(data):
    """(head, tail): the VERBATIM bytes before and after a Shorten
    stream's PCM (``_native.shn_split``; the scalar decoder's
    ``pcm_split`` under ATPU_SHN_ORACLE=1)"""
    if _use_oracle():
        return oracle.SHNDecoder(io.BytesIO(data)).pcm_split()
    return _native.shn_split(data)
