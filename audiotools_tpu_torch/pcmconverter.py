"""PCM converters: channel mixing, resampling and bit-depth changes.

The port's copy of the reference's ``pcmconverter.py``.  ``Averager``,
``Downmixer`` and ``BPSConverter`` are the reference's, on the host in
numpy.  ``Resampler`` keeps the reference's rational index arithmetic,
history trimming, end-of-stream count and Kaiser-sinc bank (512 taps,
beta 16; a dense 8192-phase bank where the step's denominator exceeds
8192), and runs its FIR and the conversion to integers on ``device``:
the history and the bank live there, and each read fetches its int32
output once.
"""

from __future__ import annotations

import os
from fractions import Fraction
from math import gcd

import numpy as np
import torch
import torch.nn.functional as F

from . import pcm
from ._device import StageMarks, fetch_async, resolve_device
from .codecs.flac_dec import upload_arrays
from .ops import converters


class Averager:
    """averages a multi-channel stream into one channel, truncating
    toward zero as C's integer division does"""

    def __init__(self, pcmreader):
        self.pcmreader = pcmreader
        self.sample_rate = pcmreader.sample_rate
        self.channels = 1
        self.channel_mask = 0x4
        self.bits_per_sample = pcmreader.bits_per_sample

    def read(self, pcm_frames):
        frame = self.pcmreader.read(pcm_frames)
        acc = frame.samples.astype(np.int64).sum(axis=1)
        out = (np.sign(acc) *
               (np.abs(acc) // frame.channels)).astype(np.int32)
        return pcm.FrameList(out.reshape(-1, 1), self.bits_per_sample)

    def close(self):
        self.pcmreader.close()


class Downmixer:
    """downmixes a 3-6 channel stream to stereo (0.7 centre gain, 0.6
    rear gain, C's round)"""

    REAR_GAIN = 0.6
    CENTER_GAIN = 0.7

    def __init__(self, pcmreader):
        self.pcmreader = pcmreader
        self.sample_rate = pcmreader.sample_rate
        self.channels = 2
        self.channel_mask = 0x3
        self.bits_per_sample = pcmreader.bits_per_sample

    def read(self, pcm_frames):
        frame = self.pcmreader.read(pcm_frames)
        input_mask = int(self.pcmreader.channel_mask)
        if input_mask == 0:
            input_mask = {0: 0x0, 1: 0x4, 2: 0x3, 3: 0x7, 4: 0x33,
                          5: 0x37, 6: 0x3F}.get(
                              self.pcmreader.channels, 0x3F)

        # the source channels in the 6 standard slots
        six = np.zeros((frame.frames, 6), dtype=np.float64)
        channel = 0
        for (slot, mask) in enumerate([0x1, 0x2, 0x4, 0x8, 0x10, 0x20]):
            if mask & input_mask:
                if channel < frame.channels:
                    six[:, slot] = frame.samples[:, channel]
                channel += 1

        sample_min = -(1 << (self.bits_per_sample - 1))
        sample_max = (1 << (self.bits_per_sample - 1)) - 1
        mono_rear = 0.7 * (six[:, 4] + six[:, 5])
        left = (six[:, 0] + self.REAR_GAIN * mono_rear +
                self.CENTER_GAIN * six[:, 2])
        right = (six[:, 1] - self.REAR_GAIN * mono_rear +
                 self.CENTER_GAIN * six[:, 2])

        def c_round(x):
            """C's round(): half away from zero"""
            return np.sign(x) * np.floor(np.abs(x) + 0.5)

        out = np.stack([
            np.clip(c_round(left), sample_min, sample_max),
            np.clip(c_round(right), sample_min, sample_max)],
            axis=1).astype(np.int32)
        return pcm.FrameList(out, self.bits_per_sample)

    def close(self):
        self.pcmreader.close()


def _kaiser_sinc_kernel(phase, taps, cutoff, beta=14.0):
    """the Kaiser-windowed sinc kernel at each fractional phase;
    float64 [len(phase), taps]"""
    half = taps // 2
    k = np.arange(-half + 1, half + 1, dtype=np.float64)
    x = k[None, :] - phase[:, None]
    sinc = cutoff * np.sinc(cutoff * x)
    w_arg = np.clip(x / half, -1.0, 1.0)
    window = np.i0(beta * np.sqrt(1.0 - w_arg * w_arg)) / np.i0(beta)
    return sinc * window


class Resampler:
    """a PCMReader converting the wrapped reader's sample rate

    polyphase windowed-sinc interpolation with streaming overlap, on
    ``device``.  For a step num/den (input over output rate, reduced)
    with den <= 8192 the bank has a row a phase and a read is one banded
    product (``converters.resample_banded``) of blocks of
    ``group * den`` outputs; above 8192 the bank is quantised to 8192
    phases and each output gathers its window
    (``converters.resample_fir``), as does a step whose banded bank
    would pass ``converters.BAND_BYTES``.  ``timings`` accumulates the
    seconds of each read's upload, FIR and fetch (CUDA-event spans on a
    card)."""

    TAPS = 512
    BETA = 16.0

    def __init__(self, pcmreader, sample_rate, device="cuda"):
        self.device = resolve_device(device)
        self.pcmreader = pcmreader
        self.sample_rate = sample_rate
        self.channels = pcmreader.channels
        self.channel_mask = pcmreader.channel_mask
        self.bits_per_sample = pcmreader.bits_per_sample
        self.input_rate = pcmreader.sample_rate
        self.cutoff = min(1.0, sample_rate / self.input_rate) * 0.9475
        self.half = self.TAPS // 2

        # the trailing input (float64 [frames, channels] on the device)
        # from input frame `consumed`
        self.history = torch.zeros((0, self.channels), dtype=torch.float64,
                                   device=self.device)
        self.consumed = 0
        self.next_out = 0
        self.eof = False
        self.timings = {"upload": 0.0, "fir": 0.0, "fetch": 0.0}

        g = gcd(self.input_rate, sample_rate)
        (self.step_num, self.step_den) = (self.input_rate // g,
                                          sample_rate // g)
        self.bank_den = min(self.step_den, 8192)
        phases = np.arange(self.bank_den, dtype=np.float64) / self.bank_den
        # the reference's bank, on the host for the tests
        self.__bank__ = _kaiser_sinc_kernel(phases, self.TAPS, self.cutoff,
                                            beta=self.BETA)
        bank = torch.as_tensor(self.__bank__, device=self.device)
        if (self.bank_den == self.step_den and
                converters.band_bytes(self.TAPS, self.step_num,
                                      self.step_den) <= converters.BAND_BYTES):
            self.group = converters.band_group(self.TAPS, self.step_num)
            self.band = converters.polyphase_band(
                bank, self.step_num, self.step_den, self.group)
            self.bank = None
        else:
            (self.group, self.band, self.bank) = (None, None, bank)

    def _append(self, samples):
        """the samples of one read of the wrapped reader, scaled to
        [-1, 1), onto the history"""
        x = upload_arrays({"x": np.asarray(samples)}, self.device)["x"]
        scale = 1 << (self.bits_per_sample - 1)
        self.history = torch.cat(
            [self.history, x.to(torch.float64) / scale], dim=0)

    def _span(self, start, length):
        """input frames [start, start + length) of the history, zeros
        where they lie outside it (the stream's head and, at the end,
        its tail)"""
        lo = start - self.consumed
        hi = lo + length
        part = self.history[max(lo, 0):max(min(hi, len(self.history)), 0)]
        left = min(max(-lo, 0), length)
        return F.pad(part, (0, 0, left, length - left - part.shape[0]))

    def _fir(self, m0, m1):
        """outputs [m0, m1) as float64 [m1 - m0, channels] on the
        device"""
        (num, den, half) = (self.step_num, self.step_den, self.half)
        if self.band is not None:
            rows = self.group * den
            stride = self.group * num
            (k0, k1) = (m0 // rows, -(-m1 // rows))
            span = self._span(k0 * stride - half + 1,
                              (k1 - k0 - 1) * stride + self.band.shape[1])
            out = converters.resample_banded(span, k1 - k0, self.band,
                                             stride)
            return out[m0 - k0 * rows:m1 - k0 * rows]
        m = torch.arange(m0, m1, dtype=torch.int64, device=self.device)
        scaled = m * num
        base = scaled // den
        phase_num = scaled - base * den
        q = ((phase_num * self.bank_den + den // 2) // den) % self.bank_den
        first = m0 * num // den - half + 1
        last = (m1 - 1) * num // den - half + 1
        span = self._span(first, last - first + self.TAPS)
        return converters.resample_fir(span, base - half + 1 - first, q,
                                       self.bank)

    def read(self, pcm_frames):
        step = Fraction(self.input_rate, self.sample_rate)
        marks = StageMarks(self.device)
        marks.mark()
        # pull enough input to produce pcm_frames outputs
        needed_end = (self.next_out + max(pcm_frames, 1)) * step
        while (not self.eof and
               self.consumed + len(self.history) <
               int(needed_end) + self.half + 2):
            chunk = self.pcmreader.read(max(pcm_frames, 4096))
            if chunk.frames == 0:
                self.eof = True
                break
            self._append(chunk.samples)
        marks.mark()

        available = self.consumed + len(self.history)
        if self.eof:
            # total outputs = floor(total input * out / in)
            total_out = int(available * Fraction(self.sample_rate,
                                                 self.input_rate))
            max_out = min(self.next_out + pcm_frames, total_out)
        else:
            max_out = self.next_out + pcm_frames
        if max_out <= self.next_out:
            return pcm.empty_framelist(self.channels, self.bits_per_sample)

        out = converters.to_int(self._fir(self.next_out, max_out),
                                self.bits_per_sample)
        marks.mark()
        out = fetch_async(out)
        marks.mark()
        # seconds() waits for the last mark, so for the fetch
        for (name, seconds) in zip(("upload", "fir", "fetch"),
                                   marks.seconds()):
            self.timings[name] += seconds

        # drop the history no later output needs
        keep_from = (self.next_out * self.step_num // self.step_den -
                     self.half - 2 - self.consumed)
        if keep_from > 0:
            self.history = self.history[keep_from:]
            self.consumed += keep_from
        self.next_out = max_out
        return pcm.FrameList(out.numpy(), self.bits_per_sample)

    def close(self):
        self.pcmreader.close()


class BPSConverter:
    """a PCMReader converting bits per sample by shifts; a reduction
    XORs a 1-bit white dither into the LSB"""

    def __init__(self, pcmreader, bits_per_sample):
        self.pcmreader = pcmreader
        self.sample_rate = pcmreader.sample_rate
        self.channels = pcmreader.channels
        self.channel_mask = pcmreader.channel_mask
        self.bits_per_sample = bits_per_sample

    def read(self, pcm_frames):
        frame = self.pcmreader.read(pcm_frames)
        old = self.pcmreader.bits_per_sample
        new = self.bits_per_sample
        if new < old:
            dither_bytes = np.frombuffer(
                os.urandom(frame.samples.size), dtype=np.uint8)
            dither = (dither_bytes & 1).astype(np.int32).reshape(
                frame.samples.shape)
            out = (frame.samples >> (old - new)) ^ dither
        elif new > old:
            out = frame.samples << (new - old)
        else:
            out = frame.samples
        return pcm.FrameList(out.astype(np.int32), new)

    def close(self):
        self.pcmreader.close()
