"""The port's test signals (``audiotools_tpu_torch.sines``) against the
reference's (``audiotools_tpu.sines``).

Every reader is read with the same run of read sizes, made from a numpy
seed, in both packages: each read's frame list must be the reference's,
frame for frame, with its bits per sample, and an ``MD5Reader`` over
each must give the reference's digest.  The generated readers' ``seek``,
``reset`` and ``close``, ``scale_pattern`` and the patterns, and
``ERROR_PCM_Reader``'s reads and error are held to the reference's too.
"""

import numpy as np
import pytest

from audiotools_tpu import sines as ref_sines
from audiotools_tpu_torch import sines

PACKAGES = (ref_sines, sines)

READERS = {
    "mono8": lambda s: s.Sine_Mono(8, 2000, 8000, 441.0, 0.5, 882.0, 0.3),
    "mono16": lambda s: s.Sine_Mono(16, 3001, 44100, 441.0, 0.61, 661.5,
                                    0.37),
    "mono24": lambda s: s.Sine_Mono(24, 2500, 96000, 1000.0, 0.4, 37.0,
                                    0.2),
    "stereo8": lambda s: s.Sine_Stereo(8, 2000, 8000, 441.0, 0.5, 882.0,
                                       0.3),
    "stereo16": lambda s: s.Sine_Stereo(16, 3001, 44100, 441.0, 0.5,
                                        882.0, 0.3, 1.0),
    "stereo24": lambda s: s.Sine_Stereo(24, 2777, 96000, 440.0, 0.45,
                                        220.0, 0.45, 0.5),
    "simple": lambda s: s.Sine_Simple(1999, 44100, 25000, 300.0),
    "simple24": lambda s: s.Sine_Simple(1500, 48000, 5000000, 50.0, 24),
    "simple6": lambda s: s.Simple_Sine(2100, 44100, 0x3F, 16,
                                       (6000, 441), (8000, 661),
                                       (10000, 882), (12000, 1323),
                                       (14000, 1764), (16000, 2205)),
    "simple2": lambda s: s.Simple_Sine(999, 22050, 0x3, 24, (7000000, 440),
                                       (3000000, 1000)),
    "fsd8": lambda s: s.fsd8(s.PATTERN03, 300),
    "fsd16": lambda s: s.fsd16(s.scale_pattern(s.PATTERN05, 16), 201),
    "fsd24": lambda s: s.fsd24(s.scale_pattern(s.PATTERN07, 24), 123),
    "pattern": lambda s: s.PatternReader(16, [5, -7, 900, 0], 77, 32000),
    "wasted": lambda s: s.WastedBPS16(5000),
    "framelist": lambda s: s.FrameListReader(
        np.arange(-300, 300, dtype=np.int32), 44100, 3, 0x7, 16),
}


def read_sizes(seed):
    rng = np.random.default_rng(seed)
    return [int(n) for n in rng.integers(0, 1500, 12)]


def frames_of(reader, sizes):
    out = []
    for size in sizes:
        framelist = reader.read(size)
        out.append((np.asarray(framelist.samples).tolist(),
                    framelist.bits_per_sample, framelist.channels))
    return out


@pytest.mark.parametrize("name", sorted(READERS))
@pytest.mark.parametrize("seed", [1, 2])
def test_every_reader_gives_the_references_frames(name, seed):
    sizes = read_sizes(seed)
    results = []
    for s in PACKAGES:
        reader = READERS[name](s)
        attrs = (reader.sample_rate, reader.channels,
                 int(reader.channel_mask), reader.bits_per_sample)
        results.append((attrs, frames_of(reader, sizes)))
    assert results[0] == results[1]


@pytest.mark.parametrize("name", sorted(READERS))
def test_every_reader_gives_the_references_md5(name):
    digests = []
    for s in PACKAGES:
        reader = s.MD5Reader(READERS[name](s))
        while reader.read(4096).frames:
            pass
        digests.append(reader.hexdigest())
        reader.close()
    assert digests[0] == digests[1]


@pytest.mark.parametrize("name", [n for n in sorted(READERS)
                                  if n != "framelist"])
@pytest.mark.parametrize("moves", [[("seek", 100)], [("seek", -5)],
                                   [("seek", 10 ** 6)],
                                   [("reset",), ("seek", 33)],
                                   [("close",)]])
def test_seek_reset_and_close_are_the_references(name, moves):
    results = []
    for s in PACKAGES:
        reader = READERS[name](s)
        reader.read(700)
        out = []
        for move in moves:
            out.append(getattr(reader, move[0])(*move[1:]))
            out.append(frames_of(reader, [50]))
        results.append(out)
    assert results[0] == results[1]


def test_the_patterns_are_the_references():
    for n in range(1, 8):
        name = "PATTERN%02d" % (n,)
        assert getattr(sines, name) == getattr(ref_sines, name)
        for bps in (8, 16, 24):
            assert (sines.scale_pattern(getattr(sines, name), bps) ==
                    ref_sines.scale_pattern(getattr(ref_sines, name), bps))


def test_the_error_reader_is_the_references():
    results = []
    for s in PACKAGES:
        reader = s.ERROR_PCM_Reader(ValueError("bad stream"), channels=2,
                                    minimum_successes=3)
        out = frames_of(reader, [10, 10, 10])
        try:
            reader.read(10)
            out.append(None)
        except ValueError as err:
            out.append(str(err))
        reader.close()
        results.append(out)
    assert results[0] == results[1]
