"""ReplayGain loudness analysis on a device.

The port's counterpart of the reference's ``replaygain.py`` (the
ReplayGain 1.0 analysis): the equal-loudness filter, 50 ms RMS windows,
a 0.01 dB histogram and the 95th-percentile statistic against the
pink-noise reference level.  A title's channels, scaled to the 16-bit
domain, are buffered on the host and analysed at the title's end in one
upload: the filter runs as one float64 FIR on ``device``
(``ops.converters.rg_window_sums``), and only the window sums come back,
to be binned on the host with the reference's own expression.  Peaks
stay on the host, in the original bit depth.

``ReplayGainReader`` (a PCMReader that applies a gain while playing)
and ``applicable_replay_gain`` are host numpy, as the reference's are.
"""

from __future__ import annotations

import os
from bisect import bisect

import numpy as np
import torch

from . import pcm
from ._device import StageMarks, resolve_device
from .codecs.flac_dec import upload_arrays
from .ops import converters
from .ops.replaygain_coeffs import BUTTER, SAMPLE_RATES, YULE  # noqa: F401

# the filters' highest order (the Yule-Walker filter's)
MAX_ORDER = 10

RMS_WINDOW_TIME = 0.05
STEPS_PER_DB = 100.0
MAX_DB = 120.0
RMS_PERCENTILE = 0.95
PINK_REF = 64.82


class ReplayGain:
    """ReplayGain analysis over PCMReaders at one sample rate

    >>> rg = ReplayGain(44100)
    >>> (gain, peak) = rg.title_gain(pcmreader)
    >>> (gain, peak) = rg.album_gain()

    ``timings`` accumulates the seconds of each title's upload, filter
    (with the window sums) and fetch (CUDA-event spans on a card)."""

    def __init__(self, sample_rate, device="cuda"):
        if sample_rate not in YULE:
            raise ValueError("unsupported sample rate")
        self.device = resolve_device(device)
        self.sample_rate = sample_rate
        self.window_samples = int(np.ceil(sample_rate * RMS_WINDOW_TIME))
        self.fir = torch.tensor(converters.rg_combined_fir(sample_rate),
                                device=self.device)
        bins = int(STEPS_PER_DB * MAX_DB)
        self.title_histogram = np.zeros(bins, dtype=np.int64)
        self.album_histogram = np.zeros(bins, dtype=np.int64)
        self.album_peak = 0.0
        self.title_peak = 0.0
        self.pending = []
        self.timings = {"upload": 0.0, "filter": 0.0, "fetch": 0.0}

    def title_gain(self, pcmreader):
        """analyses a whole PCMReader as one title: returns (gain_dB,
        peak), and adds the title to the album"""
        if pcmreader.sample_rate != self.sample_rate:
            raise ValueError("pcmreader's sample rate doesn't match")
        if pcmreader.channels > 2:
            raise ValueError("channel count must be 1 or 2")
        frame = pcmreader.read(4096)
        while frame.frames > 0:
            self.analyze_framelist(frame)
            frame = pcmreader.read(4096)
        self._flush_title()
        gain = _analyze_histogram(self.title_histogram)
        peak = self.title_peak
        self.album_histogram += self.title_histogram
        self.title_histogram[:] = 0
        self.title_peak = 0.0
        return (gain, peak)

    def analyze_framelist(self, framelist):
        """adds one frame list to the title: its peak now, its samples
        (as int16 pairs in the 16-bit domain) to the title's buffer"""
        samples = framelist.samples
        bps = framelist.bits_per_sample
        peak = (float(np.max(np.abs(samples.astype(np.float64)))) /
                (1 << (bps - 1)) if samples.size else 0.0)
        self.title_peak = max(self.title_peak, peak)
        self.album_peak = max(self.album_peak, peak)

        # the 16-bit domain: x 256 for 8 bits, an arithmetic shift (the
        # reference's floor division) above 16
        if bps == 8:
            scaled = samples.astype(np.int32) << 8
        elif bps >= 16:
            scaled = samples.astype(np.int32) >> (bps - 16)
        else:
            raise ValueError("bits per sample must be 8 or at least 16")
        pair = scaled[:, [0, 0]] if framelist.channels == 1 else scaled[:, :2]
        self.pending.append(pair.astype(np.int16))

    def _flush_title(self):
        """the buffered title's windows into the title histogram"""
        if not self.pending:
            return
        pairs = np.concatenate(self.pending)
        self.pending = []
        marks = StageMarks(self.device)
        marks.mark()
        x = upload_arrays({"x": pairs}, self.device,
                          dtype=torch.int16)["x"].to(torch.float64)
        marks.mark()
        sums = converters.rg_window_sums(x[:, 0], x[:, 1], self.fir,
                                         self.window_samples)
        marks.mark()
        sums = sums.cpu().numpy()
        marks.mark()
        for (name, seconds) in zip(("upload", "filter", "fetch"),
                                   marks.seconds()):
            self.timings[name] += seconds
        if len(sums) == 0:
            return
        values = (STEPS_PER_DB * 10.0 *
                  np.log10(sums / self.window_samples * 0.5 + 1e-37))
        ivals = np.clip(values.astype(np.int64), 0,
                        len(self.title_histogram) - 1)
        np.add.at(self.title_histogram, ivals, 1)

    def album_gain(self):
        """(gain_dB, peak) of every title analysed so far"""
        return (_analyze_histogram(self.album_histogram), self.album_peak)


def _analyze_histogram(histogram):
    """the 95th-percentile loudness statistic"""
    elems = int(histogram.sum())
    if elems == 0:
        return PINK_REF
    upper = int(np.ceil(elems * (1.0 - RMS_PERCENTILE)))
    i = len(histogram)
    while i > 0:
        i -= 1
        upper -= int(histogram[i])
        if upper <= 0:
            break
    return float(PINK_REF - i / STEPS_PER_DB)


def calculate_replay_gain_values(tracks, progress=None, device="cuda"):
    """yields (track, gain, peak, album_gain, album_peak) for each track

    tracks need ``to_pcm()``, ``sample_rate()`` and ``total_frames()``.
    All are analysed at their most common rate (the next supported rate
    up), resampled and brought to 1 or 2 channels by
    ``pcm.PCMConverter`` on ``device``; ``progress(current, total)`` is
    called after each read."""
    if len(tracks) == 0:
        return
    rates = sorted(SAMPLE_RATES)
    counts = {}
    for track in tracks:
        counts[track.sample_rate()] = counts.get(track.sample_rate(), 0) + 1
    most_common = max(counts, key=lambda r: counts[r])
    target_rate = ([rates[0]] + rates)[bisect(rates, most_common)]
    total_frames = sum(pcm.resampled_frame_count(
        track.total_frames(), track.sample_rate(), target_rate)
        for track in tracks)
    current_frames = 0

    rg = ReplayGain(target_rate, device)
    gains = []
    for track in tracks:
        reader = track.to_pcm()
        if reader.channels > 2:
            (output_channels, output_mask) = (2, 0x3)
        else:
            (output_channels, output_mask) = (reader.channels,
                                              reader.channel_mask)
        if (reader.channels != output_channels or
                reader.channel_mask != output_mask or
                reader.sample_rate != target_rate):
            reader = pcm.PCMConverter(reader, target_rate, output_channels,
                                      output_mask, reader.bits_per_sample,
                                      device)
        if progress is not None:
            reader = pcm.PCMReaderProgress(reader, total_frames, progress,
                                           current_frames=current_frames)
        (gain, peak) = rg.title_gain(reader)
        reader.close()
        current_frames += track.total_frames()
        gains.append((track, gain, peak))

    (album_gain, album_peak) = rg.album_gain()
    for (track, gain, peak) in gains:
        yield (track, gain, peak, album_gain, album_peak)


class ReplayGainReader:
    """a PCMReader applying ``replaygain`` dB to its reader's samples,
    held below full scale by ``peak`` (the largest sample as a fraction
    of full scale): each sample scaled, rounded, clipped, and its lowest
    bit XORed with a random bit, the reference's 1-bit white dither"""

    def __init__(self, pcmreader, replaygain, peak):
        self.pcmreader = pcmreader
        self.sample_rate = pcmreader.sample_rate
        self.channels = pcmreader.channels
        self.channel_mask = pcmreader.channel_mask
        self.bits_per_sample = pcmreader.bits_per_sample
        multiplier = 10.0 ** (replaygain / 20.0)
        if peak > 0 and (multiplier * peak) > 1.0:
            multiplier = 1.0 / peak
        self.multiplier = multiplier

    def read(self, pcm_frames):
        frame = self.pcmreader.read(pcm_frames)
        max_value = (1 << (self.bits_per_sample - 1)) - 1
        min_value = -(1 << (self.bits_per_sample - 1))
        scaled = np.rint(np.asarray(frame.samples).astype(np.float64) *
                         self.multiplier)
        clipped = np.clip(scaled, min_value, max_value).astype(np.int32)
        dither = (np.frombuffer(os.urandom(clipped.size), dtype=np.uint8) &
                  1).astype(np.int32).reshape(clipped.shape)
        return pcm.FrameList._wrap(clipped ^ dither, self.bits_per_sample)

    def close(self):
        self.pcmreader.close()


def applicable_replay_gain(tracks):
    """True when ReplayGain can be computed over ``tracks`` together:
    one sample rate the analysis supports, and one channel count, 1 or 2
    (the reference's ``applicable_replay_gain``)"""
    sample_rates = {track.sample_rate() for track in tracks}
    if len(sample_rates) != 1 or sample_rates.pop() not in (
            48000, 44100, 32000, 24000, 22050, 16000, 12000, 11025,
            8000, 18900, 37800, 56000, 64000, 88200, 96000, 112000,
            128000, 144000, 176400, 192000):
        return False
    channels = {track.channels() for track in tracks}
    return len(channels) == 1 and channels.pop() in (1, 2)
