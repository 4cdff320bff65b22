"""The port's FrameList, FloatFrameList, ChannelMask and PCMReader seeks
against the reference's (``audiotools_tpu.pcm`` and ``pcmstream``).

Each case runs one operation on the same inputs, made from a numpy seed,
through both packages: the results must be equal, or both must raise
the same exception with the same message.  The cases follow the
reference's ``tests/test_pcm.py``, ``test_pcmstream.py`` and
``test_pcmstream_edges.py``: construction from packed bytes of 8, 16
and 24 bits in both byte orders and both signs, and from sample
lists; ``frame``, ``channel``, ``split``, ``frame_count``,
``to_float``, ``+``, ``*``, ``==``, indexing, iteration and ``len``;
``FloatFrameList`` and the ``from_*`` builders; every ChannelMask
member, ``str()`` among them; ``PCMReader.seek`` and
``LimitedFileReader.seek`` with their clamping and errors; and the
closed and finished reads of ``PCMCat``, ``BufferedPCMReader`` and
``LimitedPCMReader``.
"""

import io

import numpy as np
import pytest

from audiotools_tpu import pcm as ref_pcm
from audiotools_tpu import pcmstream as ref_stream
from audiotools_tpu_torch import pcm, pcmstream

PACKAGES = ((ref_pcm, ref_stream), (pcm, pcmstream))


def normal(value):
    """a value both packages' objects compare by"""
    if hasattr(value, "samples"):
        return (type(value).__name__, np.asarray(value.samples).tolist(),
                getattr(value, "bits_per_sample", None))
    if isinstance(value, tuple):
        return tuple(normal(v) for v in value)
    if isinstance(value, list):
        return [normal(v) for v in value]
    return value


def outcome(fn, *args):
    try:
        return ("ok", normal(fn(*args)))
    except Exception as err:
        return ("raise", type(err).__name__, str(err))


def same(fn):
    """fn(pcm_module, pcmstream_module) gives the same outcome in both"""
    (a, b) = (outcome(fn, *package) for package in PACKAGES)
    assert a == b
    return a


def random_samples(seed, frames, channels, bps):
    rng = np.random.default_rng(seed)
    return rng.integers(-(1 << (bps - 1)), 1 << (bps - 1),
                        (frames, channels)).astype(np.int32)


# ---- FrameList construction ----------------------------------------------

@pytest.mark.parametrize("bps", [8, 16, 24])
@pytest.mark.parametrize("big_endian", [False, True])
@pytest.mark.parametrize("signed", [False, True])
@pytest.mark.parametrize("channels", [1, 2, 3])
def test_framelists_of_bytes_are_the_references(bps, big_endian, signed,
                                                channels):
    rng = np.random.default_rng(bps * 7 + channels)
    data = rng.integers(0, 256, 5 * channels * (bps // 8),
                        dtype=np.uint8).tobytes()
    result = same(lambda m, s: m.FrameList(data, channels, bps, big_endian,
                                           signed))
    assert result[0] == "ok"
    # and back to the same bytes
    same(lambda m, s: m.FrameList(data, channels, bps, big_endian,
                                  signed).to_bytes(big_endian, signed))


@pytest.mark.parametrize("args", [
    (b"\x00\x01\x02", 2, 16),          # a partial frame
    (b"\x00\x01", 1, 12),              # no 12-bit packing
    (b"\x00\x01", 0, 16),              # no channels
    ([1, 2, 3], 2, 16),                # samples no channel count divides
    ([[1, 2], [3, 4]], 3, 16),         # an array of other width
    ([1, 2, 3, 4], 2, 20),             # no 20-bit lists
    ([1, 2, 3, 4], 2, 8),
    (np.arange(12).reshape(6, 2), 2, 24),
    (b"", 2, 16),
])
def test_framelist_arguments_are_checked_as_the_references(args):
    same(lambda m, s: m.FrameList(*args))


def framelists(m, seed=3, frames=7, channels=2, bps=16):
    arr = random_samples(seed, frames, channels, bps)
    return m.FrameList(arr.reshape(-1).tolist(), channels, bps)


@pytest.mark.parametrize("op", [
    ("frames", lambda f: f.frames),
    ("channels", lambda f: f.channels),
    ("len", len),
    ("bool", bool),
    ("iter", list),
    ("index", lambda f: [f[i] for i in (0, 5, -1, -14)]),
    ("slice", lambda f: f[2:9:3]),
    ("out of range", lambda f: f[14]),
    ("frame", lambda f: f.frame(3)),
    ("last frame", lambda f: f.frame(6)),
    ("bad frame", lambda f: f.frame(7)),
    ("channel", lambda f: f.channel(1)),
    ("bad channel", lambda f: f.channel(2)),
    ("split", lambda f: f.split(4)),
    ("split past", lambda f: f.split(40)),
    ("split negative", lambda f: f.split(-1)),
    ("frame_count", lambda f: [f.frame_count(n) for n in (0, 3, 4, 401)]),
    ("to_float", lambda f: f.to_float()),
    ("to_bytes", lambda f: [f.to_bytes(b, s) for b in (False, True)
                            for s in (False, True)]),
    ("repeat", lambda f: f * 3),
    ("repeat none", lambda f: f * 0),
    ("concat", lambda f: f + f.split(2)[0]),
    ("concat other", lambda f: f + [1, 2]),
    ("equal", lambda f: (f == f.split(7)[0], f == f.split(6)[0],
                         f != f.split(6)[0], f == 3)),
    ("hash", hash),
    ("float len", lambda f: len(f.to_float())),
    ("float index", lambda f: [f.to_float()[i] for i in (0, -1)]),
    ("float frame", lambda f: f.to_float().frame(2)),
    ("float channel", lambda f: f.to_float().channel(0)),
    ("float split", lambda f: f.to_float().split(3)),
    ("float concat", lambda f: f.to_float() + f.to_float()),
    ("float repeat", lambda f: f.to_float() * 2),
    ("float equal", lambda f: f.to_float() == f.to_float()),
    ("float back", lambda f: [f.to_float().to_int(b) for b in (8, 16, 24)]),
])
@pytest.mark.parametrize("bps", [8, 16, 24])
def test_framelist_members_are_the_references(op, bps):
    same(lambda m, s: op[1](framelists(m, bps=bps)))


def test_an_empty_framelist_is_false_in_both():
    for (m, s) in PACKAGES:
        empty = m.empty_framelist(2, 16)
        assert not empty
        assert len(empty) == 0
        assert empty == m.FrameList(b"", 2, 16)


@pytest.mark.parametrize("case", [
    ("from_list", lambda m: m.from_list([1, -2, 3, 4], 2, 16, True)),
    ("from_list unsigned", lambda m: m.from_list([0, 255, 128, 7], 1, 8,
                                                 False)),
    ("from_list odd", lambda m: m.from_list([1, 2, 3], 2, 16, True)),
    ("from_list no channels", lambda m: m.from_list([1], 0, 16, True)),
    ("from_frames", lambda m: m.from_frames(
        [framelists(m).frame(i) for i in (4, 1, 1)])),
    ("from_frames empty", lambda m: m.from_frames([])),
    ("from_frames wide", lambda m: m.from_frames(
        [framelists(m).split(2)[0]])),
    ("from_channels", lambda m: m.from_channels(
        [framelists(m).channel(c) for c in (1, 0, 1)])),
    ("from_channels mixed", lambda m: m.from_channels(
        [framelists(m).channel(0), framelists(m, bps=24).channel(0)])),
    ("from_float_frames", lambda m: m.from_float_frames(
        [framelists(m).to_float().frame(i) for i in (0, 6)])),
    ("from_float_channels", lambda m: m.from_float_channels(
        [framelists(m).to_float().channel(c) for c in (1, 0)])),
    ("from_float_channels empty", lambda m: m.from_float_channels([])),
    ("FloatFrameList", lambda m: m.FloatFrameList([0.5, -1.0, 0.25, 2.0],
                                                  2).to_int(16)),
    ("FloatFrameList odd", lambda m: m.FloatFrameList([0.5], 2)),
    ("empty", lambda m: m.empty_framelist(3, 24)),
])
def test_the_builders_are_the_references(case):
    same(lambda m, s: case[1](m))


# ---- ChannelMask -----------------------------------------------------------

MASKS = [0, 0x1, 0x2, 0x3, 0x4, 0x7, 0x33, 0x37, 0x3F, 0x13F, 0x63F,
         0x3FFFF, 0x40003, 0x80000]


@pytest.mark.parametrize("mask", MASKS)
@pytest.mark.parametrize("member", [
    ("int", int), ("str", str), ("repr", repr), ("len", len),
    ("bool", bool), ("hash", hash), ("channels", lambda c: c.channels()),
    ("defined", lambda c: c.defined()),
    ("undefined", lambda c: c.undefined()),
    ("speakers", lambda c: [getattr(c, name) for name in
                            sorted(c.SPEAKER_TO_MASK)]),
    ("index", lambda c: [c.index(name) for name in c.channels()]),
    ("index missing", lambda c: c.index("top_back_right")),
    ("equal", lambda c: (c == int(c), c == int(c) + 1, c != int(c))),
    ("format", lambda c: ("%d %s" % (c, c), "{}".format(c))),
])
def test_channel_masks_are_the_references(mask, member):
    same(lambda m, s: member[1](s.ChannelMask(mask)))


@pytest.mark.parametrize("fields", [
    {}, {"front_left": True, "front_right": True},
    {"front_center": True, "low_frequency": 1, "back_left": False},
    {"side_left": True, "top_back_right": True}, {"middle": True}])
def test_channel_masks_from_fields_are_the_references(fields):
    same(lambda m, s: int(s.ChannelMask.from_fields(**fields)))


@pytest.mark.parametrize("count", [0, 1, 2, 3, 6])
def test_channel_masks_from_channels_are_the_references(count):
    same(lambda m, s: str(s.ChannelMask.from_channels(count)))


def test_the_speaker_tables_are_the_references():
    assert (pcmstream.ChannelMask.SPEAKER_TO_MASK ==
            ref_stream.ChannelMask.SPEAKER_TO_MASK)
    assert (pcmstream.ChannelMask.MASK_TO_SPEAKER ==
            ref_stream.ChannelMask.MASK_TO_SPEAKER)


# ---- seeks ---------------------------------------------------------------

def raw_reader(s, data, seekable=True, channels=2, bps=16):
    source = io.BytesIO(data)
    if not seekable:
        source.seek = None              # no seek method to call
    return s.PCMReader(source, 44100, channels, 0x3, bps)


@pytest.mark.parametrize("positions", [[0], [5], [3, 0, 9], [-4], [1000],
                                       [7, 7], [20, 2]])
@pytest.mark.parametrize("bps", [8, 16, 24])
def test_pcmreader_seeks_are_the_references(positions, bps):
    arr = random_samples(11, 20, 2, bps)
    data = pcm.FrameList._wrap(arr, bps).to_bytes(False, True)

    def run(m, s):
        reader = raw_reader(s, data, bps=bps)
        out = []
        for position in positions:
            out.append(reader.seek(position))
            out.append(normal(reader.read(4)))
        return out
    same(run)


def test_an_unseekable_pcmreader_raises_as_the_references():
    same(lambda m, s: raw_reader(s, b"\x00" * 8, seekable=False).seek(1))


@pytest.mark.parametrize("offsets", [[0], [3], [2, 9], [-5], [99], [10]])
def test_limited_file_reader_seeks_are_the_references(offsets):
    data = bytes(range(40))

    def run(m, s):
        f = io.BytesIO(data)
        f.seek(6)
        reader = s.LimitedFileReader(f, 10)
        out = []
        for offset in offsets:
            out.append(reader.seek(offset))
            out.append(reader.read(4))
            out.append(reader.read(100))
        return out
    same(run)


def test_an_unseekable_limited_file_reader_raises_as_the_references():
    class Pipe:
        def read(self, size):
            return b""

    same(lambda m, s: s.LimitedFileReader(Pipe(), 10).seek(2))


def sample_reader(s, values):
    fl = ref_pcm.from_list(values, 1, 16, True)
    return s.PCMReader(io.BytesIO(fl.to_bytes(False, True)), 44100, 1,
                       0x4, 16)


@pytest.mark.parametrize("name", ["PCMCat", "BufferedPCMReader",
                                  "LimitedPCMReader"])
def test_closed_and_finished_reads_are_the_references(name):
    def make(s):
        if name == "PCMCat":
            return s.PCMCat([sample_reader(s, [1, 2]),
                             sample_reader(s, [3])])
        if name == "BufferedPCMReader":
            return s.BufferedPCMReader(sample_reader(s, [1, 2, 3]))
        return s.LimitedPCMReader(
            s.BufferedPCMReader(sample_reader(s, [1, 2, 3])), 2)

    def run(m, s):
        reader = make(s)
        out = [normal(reader.read(2)), normal(reader.read(5)),
               normal(reader.read(5))]
        if hasattr(reader, "read_finished"):
            out.append(normal(reader.read_finished(3)))
        reader.close()
        out.append(outcome(reader.read, 1))
        out.append(outcome(reader.read_closed, 1))
        return out
    same(run)
