"""Deterministic test-signal PCMReaders.

The port's copy of the reference's ``sines``: two-tone sine mixes by bit
depth and channel count (``Sine_Mono``, ``Sine_Stereo``), single and
N-channel sines (``Sine_Simple``, ``Simple_Sine``), full-scale
deflection patterns (``PatternReader``, ``fsd8``/``fsd16``/``fsd24``,
``scale_pattern``), a wasted-bits stream (``WastedBPS16``), an MD5 tap
(``MD5Reader``), a reader over a fixed array (``FrameListReader``) and
one that fails mid-stream (``ERROR_PCM_Reader``).  Each follows the
PCMReader protocol over the port's ``pcm`` and yields the reference's
frames, bit for bit, so a round trip through any codec has an exact
oracle.
"""

from __future__ import annotations

import numpy as np

from . import pcm


class _GeneratedPCMReader:
    """base: generates int32 [frames, channels] lazily in read()"""

    def __init__(self, total_frames, sample_rate, channels,
                 channel_mask, bits_per_sample):
        self.total_frames = total_frames
        self.sample_rate = sample_rate
        self.channels = channels
        self.channel_mask = channel_mask
        self.bits_per_sample = bits_per_sample
        self.position = 0

    def _generate(self, start, count):
        raise NotImplementedError()

    def read(self, pcm_frames):
        count = min(max(pcm_frames, 1),
                    self.total_frames - self.position)
        if count <= 0:
            return pcm.empty_framelist(self.channels,
                                       self.bits_per_sample)
        samples = self._generate(self.position, count)
        self.position += count
        return pcm.FrameList._wrap(
            np.ascontiguousarray(samples.astype(np.int32)),
            self.bits_per_sample)

    def seek(self, pcm_frame):
        self.position = max(min(int(pcm_frame), self.total_frames), 0)
        return self.position

    def reset(self):
        self.position = 0

    def close(self):
        self.position = self.total_frames


class Sine_Mono(_GeneratedPCMReader):
    """a mono two-tone sine mix"""

    def __init__(self, bits_per_sample, total_frames, sample_rate,
                 f1, a1, f2, a2):
        _GeneratedPCMReader.__init__(self, total_frames, sample_rate,
                                     1, 0x4, bits_per_sample)
        self.f1 = f1
        self.a1 = a1
        self.f2 = f2
        self.a2 = a2
        full_scale = (1 << (bits_per_sample - 1)) - 1
        self.scale = full_scale

    def _generate(self, start, count):
        i = np.arange(start, start + count, dtype=np.float64)
        value = (self.a1 * np.sin(2 * np.pi * self.f1 * i /
                                  self.sample_rate) +
                 self.a2 * np.sin(2 * np.pi * self.f2 * i /
                                  self.sample_rate))
        return (value * self.scale).astype(np.int64)[:, None]


class Sine_Stereo(_GeneratedPCMReader):
    """a stereo two-tone mix with inter-channel phase/level offsets"""

    def __init__(self, bits_per_sample, total_frames, sample_rate,
                 f1, a1, f2, a2, fmult=1.0):
        _GeneratedPCMReader.__init__(self, total_frames, sample_rate,
                                     2, 0x3, bits_per_sample)
        self.f1 = f1
        self.a1 = a1
        self.f2 = f2
        self.a2 = a2
        self.fmult = fmult
        self.scale = (1 << (bits_per_sample - 1)) - 1

    def _generate(self, start, count):
        i = np.arange(start, start + count, dtype=np.float64)
        left = (self.a1 * np.sin(2 * np.pi * self.f1 * i /
                                 self.sample_rate) +
                self.a2 * np.sin(2 * np.pi * self.f2 * i /
                                 self.sample_rate))
        right = (self.a1 * np.sin(2 * np.pi * self.f1 * self.fmult *
                                  i / self.sample_rate + 0.5) +
                 self.a2 * np.sin(2 * np.pi * self.f2 * self.fmult *
                                  i / self.sample_rate + 1.0))
        return np.stack([(left * self.scale).astype(np.int64),
                         (right * self.scale).astype(np.int64)],
                        axis=1)


class Sine_Simple(_GeneratedPCMReader):
    """a single mono sine at (max_value, f)"""

    def __init__(self, total_frames, sample_rate, max_value,
                 frequency, bits_per_sample=16):
        _GeneratedPCMReader.__init__(self, total_frames, sample_rate,
                                     1, 0x4, bits_per_sample)
        self.max_value = max_value
        self.frequency = frequency

    def _generate(self, start, count):
        i = np.arange(start, start + count, dtype=np.float64)
        value = self.max_value * np.sin(
            2 * np.pi * self.frequency * i / self.sample_rate)
        return value.astype(np.int64)[:, None]


class Simple_Sine(_GeneratedPCMReader):
    """an N-channel bank of independent sines; each channel is a
    (max_value, frequency) pair"""

    def __init__(self, total_frames, sample_rate, channel_mask,
                 bits_per_sample, *channel_specs):
        _GeneratedPCMReader.__init__(self, total_frames, sample_rate,
                                     len(channel_specs), channel_mask,
                                     bits_per_sample)
        self.channel_specs = channel_specs

    def _generate(self, start, count):
        i = np.arange(start, start + count, dtype=np.float64)
        cols = []
        for (max_value, frequency) in self.channel_specs:
            cols.append((max_value * np.sin(
                2 * np.pi * frequency * i /
                self.sample_rate)).astype(np.int64))
        return np.stack(cols, axis=1)


class PatternReader(_GeneratedPCMReader):
    """repeats a fixed mono pattern (the fsd* full-scale-deflection
    fixtures)"""

    def __init__(self, bits_per_sample, pattern, times,
                 sample_rate=44100):
        _GeneratedPCMReader.__init__(self, len(pattern) * times,
                                     sample_rate, 1, 0x4,
                                     bits_per_sample)
        self.pattern = np.asarray(pattern, dtype=np.int64)

    def _generate(self, start, count):
        idx = (np.arange(start, start + count) % len(self.pattern))
        return self.pattern[idx][:, None]


def fsd8(pattern, times):
    """full-scale 8-bit deflection pattern reader"""
    return PatternReader(8, pattern, times)


def fsd16(pattern, times):
    return PatternReader(16, pattern, times)


def fsd24(pattern, times):
    return PatternReader(24, pattern, times)


# canonical full-scale patterns
PATTERN01 = [0x7F, -0x80]
PATTERN02 = [0x7F, -0x80, 0x7F]
PATTERN03 = [0x7F, -0x80, -0x80, 0x7F]
PATTERN04 = [0x7F, -0x80, 0x7F, -0x80]
PATTERN05 = [0x7F, -0x80, 0x7F, -0x80, 0x7F]
PATTERN06 = [0x7F, -0x80, 0x7F, -0x80, 0x7F, -0x80]
PATTERN07 = [0x00, 0x7F, 0x00, -0x80]


def scale_pattern(pattern, bits_per_sample):
    """scales an 8-bit pattern to the given bit depth"""
    shift = bits_per_sample - 8
    return [v << shift for v in pattern]


class WastedBPS16(_GeneratedPCMReader):
    """a 16-bit stream whose low bits are always zero"""

    def __init__(self, total_frames, sample_rate=44100):
        _GeneratedPCMReader.__init__(self, total_frames, sample_rate,
                                     2, 0x3, 16)

    def _generate(self, start, count):
        i = np.arange(start, start + count, dtype=np.int64)
        left = (i % 2000) << 2
        right = (i % 1000) << 3
        return np.stack([left - 2000, right - 1000], axis=1)


class MD5Reader:
    """wraps a PCMReader, hashing the PCM that flows through it"""

    def __init__(self, pcmreader):
        from hashlib import md5
        self.pcmreader = pcmreader
        self.sample_rate = pcmreader.sample_rate
        self.channels = pcmreader.channels
        self.channel_mask = pcmreader.channel_mask
        self.bits_per_sample = pcmreader.bits_per_sample
        self.md5 = md5()

    def read(self, pcm_frames):
        framelist = self.pcmreader.read(pcm_frames)
        self.md5.update(framelist.to_bytes(
            False, self.bits_per_sample > 8))
        return framelist

    def hexdigest(self):
        return self.md5.hexdigest()

    def close(self):
        self.pcmreader.close()


class FrameListReader:
    """a PCMReader over a fixed int32 [frames, channels] array"""

    def __init__(self, samples, sample_rate, channels, channel_mask,
                 bits_per_sample):
        self.samples = np.asarray(samples, dtype=np.int32)
        if self.samples.ndim == 1:
            self.samples = self.samples.reshape(-1, channels)
        self.sample_rate = sample_rate
        self.channels = channels
        self.channel_mask = channel_mask
        self.bits_per_sample = bits_per_sample
        self.position = 0

    def read(self, pcm_frames):
        count = min(max(pcm_frames, 1),
                    self.samples.shape[0] - self.position)
        if count <= 0:
            return pcm.empty_framelist(self.channels,
                                       self.bits_per_sample)
        chunk = self.samples[self.position:self.position + count]
        self.position += count
        return pcm.FrameList._wrap(np.ascontiguousarray(chunk),
                                   self.bits_per_sample)

    def close(self):
        self.position = self.samples.shape[0]


class ERROR_PCM_Reader:
    """a PCMReader which raises mid-stream, for error-injection tests"""

    def __init__(self, error, sample_rate=44100, channels=2,
                 channel_mask=0x3, bits_per_sample=16,
                 failure_chance=0.0, minimum_successes=2):
        self.error = error
        self.sample_rate = sample_rate
        self.channels = channels
        self.channel_mask = channel_mask
        self.bits_per_sample = bits_per_sample
        self.successes = minimum_successes

    def read(self, pcm_frames):
        if self.successes > 0:
            self.successes -= 1
            rng = np.random.default_rng(self.successes)
            samples = rng.integers(-100, 100,
                                   (4096, self.channels))
            return pcm.FrameList._wrap(samples.astype(np.int32),
                                       self.bits_per_sample)
        raise self.error

    def close(self):
        pass
