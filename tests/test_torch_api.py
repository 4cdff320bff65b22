"""The port's package root against the reference's.

Every public name of ``audiotools_tpu`` (``dir()`` less private names and
submodules) must exist in ``audiotools_tpu_torch``; none is left out.
The helpers must give the reference's results; the window readers
(``PCMReaderWindow``, ``PCMReaderHead``, ``PCMReaderDeHead``) the
reference's frames, read for read, over readers of random samples from a
numpy seed that serve random read sizes, and over the cases of
``tests/test_pcmstream_edges.py``; ``pcm_cmp``, ``stripped_pcm_cmp`` and
the transfer helpers the reference's answers; ``ExecProgressQueue`` the
reference's results in queue order, serially and in threads, and a
failing job the reference's exception.
"""

import io
import os
import subprocess
import sys
import time
import types

import numpy as np
import pytest

import audiotools_tpu as ref
import audiotools_tpu_torch as port
from audiotools_tpu import pcm as ref_pcm
from audiotools_tpu_torch import pcm

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# public names of the reference's root that the port leaves out, with
# the reason
LEFT_OUT = {}


def reference_names():
    return sorted(n for n in dir(ref) if not n.startswith("_") and
                  not isinstance(getattr(ref, n), types.ModuleType))


@pytest.mark.parametrize("name", reference_names())
def test_every_reference_name_is_in_the_root(name):
    if name in LEFT_OUT:
        pytest.fail("%s is left out: %s" % (name, LEFT_OUT[name]))
    assert hasattr(port, name)
    # a class or function is the port's own, never the reference's
    obj = getattr(port, name)
    module = getattr(obj, "__module__", None) or ""
    assert not (module == "audiotools_tpu" or
                module.startswith("audiotools_tpu."))


def test_the_root_names_the_objects_the_port_uses():
    from audiotools_tpu_torch import audiofile, dispatch, pcm as pcm_mod
    assert port.EncodingError is audiofile.EncodingError
    assert port.InvalidFile is audiofile.InvalidFile
    assert port.UnsupportedFile is audiofile.UnsupportedFile
    assert issubclass(port.UnsupportedBitsPerSample, port.EncodingError)
    assert port.open is dispatch.open
    assert port.TYPE_MAP is dispatch.TYPE_MAP
    assert port.PCMReader is pcm_mod.PCMReader
    assert port.ReplayGain is audiofile.ReplayGain
    assert port.VERSION == ref.VERSION
    assert callable(port.resolve_device)


def test_the_exceptions_read_as_the_references():
    for (name, args) in (("EncodingError", ("bad",)),
                         ("DecodingError", ("bad",)),
                         ("UnsupportedBitsPerSample", ("f", 12)),
                         ("UnsupportedChannelCount", ("f", 9)),
                         ("UnsupportedChannelMask", ("f", 0x7)),
                         ("DuplicateFile", ("a.wav",)),
                         ("DuplicateOutputFile", ("a.wav",)),
                         ("OutputFileIsInput", ("a.wav",))):
        (a, b) = (getattr(port, name)(*args), getattr(ref, name)(*args))
        assert (str(a), a.args) == (str(b), b.args)


def test_import_loads_no_jax_and_makes_no_cuda_context():
    code = ("import sys, torch\n"
            "import audiotools_tpu_torch as audiotools\n"
            "bad = [m for m in sys.modules if m == 'jax' or "
            "m.startswith('jax.') or m == 'audiotools_tpu' or "
            "m.startswith('audiotools_tpu.')]\n"
            "assert not bad, bad\n"
            "assert not torch.cuda.is_initialized()\n"
            "print(len(dir(audiotools)))\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    env.pop("JAX_PLATFORMS", None)
    result = subprocess.run([sys.executable, "-c", code], capture_output=True,
                            text=True, env=env, timeout=300)
    assert result.returncode == 0, result.stderr


@pytest.mark.parametrize("hz", [8000, 11025, 22050, 32000, 44100, 48000,
                                88200, 96000, 176400, 192000, 999, 1050])
def test_khz_is_the_references(hz):
    assert port.khz(hz) == ref.khz(hz)


@pytest.mark.parametrize("total,per", [(10, 3), (9, 3), (0, 4), (4, 5),
                                       (1, 1)])
def test_at_a_time_is_the_references(total, per):
    assert list(port.at_a_time(total, per)) == list(ref.at_a_time(total,
                                                                  per))


@pytest.mark.parametrize("items", [[], [1], [1, 2, 3], "abc"])
def test_iter_first_and_last_are_the_references(items):
    assert list(port.iter_first(items)) == list(ref.iter_first(items))
    assert list(port.iter_last(items)) == list(ref.iter_last(items))


@pytest.mark.parametrize("items", [[], [1], [1, 2], [1, 2, 2, 3],
                                   ["a", "b", "a"]])
def test_most_numerous_is_the_references(items):
    assert (port.most_numerous(items, "empty", "differ") ==
            ref.most_numerous(items, "empty", "differ"))


def test_get_umask_and_output_progress_are_the_references():
    assert port.get_umask() == ref.get_umask()
    for (current, total) in ((1, 1), (3, 12), (12, 12)):
        assert (port.output_progress("x", current, total) ==
                ref.output_progress("x", current, total))


def test_output_table_and_text_are_the_references():
    lines = []
    for package in (ref, port):
        table = package.output_table()
        row = table.row()
        row.add_column("left")
        row.add_column("right", "right")
        table.divider_row()
        row = table.row()
        row.add_column("a much longer cell")
        row.add_column("1", "center")
        table.blank_row()
        text = package.output_text("中文 wide", fg_color="red",
                                   style="bold")
        lines.append((list(table.format()), len(text), str(text.head(3)),
                      str(text.tail(4)), text.format(True),
                      package.output_list(["a", text]).format(False)))
    assert lines[0] == lines[1]


def test_filename_and_group_tracks_are_the_references(tmp_path):
    path = str(tmp_path / "a.wav")
    with open(path, "wb") as f:
        f.write(b"x")
    (a, b) = (port.Filename(path), ref.Filename(path))
    assert (tuple(a), str(a), a.disk_file()) == (tuple(b), str(b),
                                                 b.disk_file())
    assert port.Filename(path) == port.Filename(str(tmp_path / "." / "a.wav"))
    assert port.Filename("nowhere") != port.Filename(path)

    class Track:
        def __init__(self, metadata):
            self.metadata = metadata

        def get_metadata(self):
            return self.metadata

    for package in (ref, port):
        md = package.MetaData
        tracks = [Track(md(album_name="B", album_number=1)), Track(None),
                  Track(md(album_name="A")), Track(md(album_name="B",
                                                      album_number=1))]
        groups = [[tracks.index(t) for t in group]
                  for group in package.group_tracks(tracks)]
        assert groups == [[1], [2], [0, 3]]
        album = package.AlbumMetaData([md(track_number=1, album_name="X"),
                                       md(track_number=2, album_name="X")])
        assert sorted(album) == [1, 2]
        assert album.metadata().album_name == "X"
        assert album.metadata().track_number is None
        dummy = package.DummyAudioFile(150, md(track_name="t"))
        assert (dummy.total_frames(), dummy.cd_frames()) == (88200, 150)
    for name in ("a.flac", "a.wv", "a.nosuch"):
        try:
            expected = ref.filename_to_type(name).NAME
        except ref.UnknownAudioType:
            expected = None
        try:
            got = port.filename_to_type(name).NAME
        except port.UnknownAudioType:
            got = None
        assert got == expected


def test_applicable_replay_gain_is_the_references():
    class Track:
        def __init__(self, rate, channels):
            (self.rate, self.count) = (rate, channels)

        def sample_rate(self):
            return self.rate

        def channels(self):
            return self.count

    for tracks in ([Track(44100, 2)], [Track(44100, 2), Track(48000, 2)],
                   [Track(44100, 6)], [Track(44100, 1), Track(44100, 2)],
                   [Track(12345, 2)], [Track(96000, 1), Track(96000, 1)]):
        assert (port.applicable_replay_gain(tracks) ==
                ref.applicable_replay_gain(tracks))


# ---- the window readers ------------------------------------------------

class ChunkReader:
    """a PCMReader over int32 ``samples`` that serves each read at most
    the next of ``sizes`` frames (cycling), its FrameLists made by
    ``wrap(samples, bits_per_sample)``"""

    def __init__(self, samples, bps, sizes, wrap):
        self.samples = samples
        self.sample_rate = 44100
        self.channels = samples.shape[1]
        self.channel_mask = 0x3 if self.channels == 2 else 0x4
        self.bits_per_sample = bps
        self.sizes = list(sizes)
        self.wrap = wrap
        self.position = 0
        self.reads = 0
        self.closed = False

    def read(self, pcm_frames):
        size = min(max(int(pcm_frames), 1),
                   self.sizes[self.reads % len(self.sizes)])
        self.reads += 1
        chunk = self.samples[self.position:self.position + size]
        self.position += chunk.shape[0]
        return self.wrap(chunk, self.bits_per_sample)

    def close(self):
        self.closed = True


def read_all(reader, sizes):
    """each read's samples, with ``sizes`` the requests (cycled), until
    an empty one"""
    out = []
    for i in range(10000):
        framelist = reader.read(sizes[i % len(sizes)])
        samples = np.array(framelist.samples, dtype=np.int32).reshape(
            -1, reader.channels)
        out.append(samples)
        if samples.shape[0] == 0:
            return out
    raise AssertionError("the reader never ended")


def both(make, samples, bps, served, requests):
    """``make(package, reader)`` over each package's ChunkReader: both
    sides' reads"""
    results = []
    for (package, wrap) in ((ref, ref_pcm.FrameList._wrap),
                            (port, pcm.FrameList._wrap)):
        source = ChunkReader(samples, bps, served, wrap)
        reader = make(package, source)
        results.append(read_all(reader, requests))
        reader.close()
        assert source.closed
    return results


WINDOWS = [
    ("window", lambda p, r, a, b: p.PCMReaderWindow(r, a, b)),
    ("window-no-pad", lambda p, r, a, b: p.PCMReaderWindow(r, a, b,
                                                           pad_end=False)),
    ("head", lambda p, r, a, b: p.PCMReaderHead(r, abs(b))),
    ("dehead", lambda p, r, a, b: p.PCMReaderDeHead(r, a)),
]


@pytest.mark.parametrize("kind", [w[0] for w in WINDOWS])
@pytest.mark.parametrize("seed", range(12))
def test_window_readers_are_the_references(kind, seed):
    make = dict(WINDOWS)[kind]
    rng = np.random.default_rng(seed)
    frames = int(rng.integers(0, 3000))
    channels = int(rng.integers(1, 3))
    bps = int(rng.choice([8, 16, 24]))
    samples = rng.integers(-(1 << (bps - 1)), 1 << (bps - 1),
                           (frames, channels)).astype(np.int32)
    offset = int(rng.integers(-frames - 500, frames + 500))
    length = int(rng.integers(0, frames + 1000))
    served = [int(s) for s in rng.integers(1, 900, 5)]
    requests = [int(s) for s in rng.integers(1, 1200, 4)]
    (a, b) = both(lambda p, r: make(p, r, offset, length), samples, bps,
                  served, requests)
    assert [x.shape[0] for x in a] == [x.shape[0] for x in b]
    assert all(np.array_equal(x, y) for (x, y) in zip(a, b))


EDGES = [
    # (values, channels, wrapper, expected) from test_pcmstream_edges.py
    (range(10), 1, lambda p, r: p.PCMReaderHead(r, 4), [0, 1, 2, 3]),
    ([5, 6], 1, lambda p, r: p.PCMReaderHead(r, 5), [5, 6, 0, 0, 0]),
    ([1, 2, 3], 1, lambda p, r: p.PCMReaderHead(r, 0), []),
    (range(10), 1, lambda p, r: p.PCMReaderDeHead(r, 3), list(range(3, 10))),
    ([1, 2, 3], 1, lambda p, r: p.PCMReaderDeHead(r, -2), [0, 0, 1, 2, 3]),
    (range(10), 1, lambda p, r: p.PCMReaderDeHead(r, 99), []),
    (range(10), 2, lambda p, r: p.PCMReaderWindow(r, 1, 2), [2, 3, 4, 5]),
    (range(10), 1, lambda p, r: p.PCMReaderWindow(r, 2, 5), [2, 3, 4, 5, 6]),
    ([5, 6, 7], 1, lambda p, r: p.PCMReaderWindow(r, -2, 5), [0, 0, 5, 6, 7]),
    ([1, 2], 1, lambda p, r: p.PCMReaderWindow(r, 0, 4), [1, 2, 0, 0]),
]


@pytest.mark.parametrize("case", range(len(EDGES)))
def test_window_edge_cases_are_the_references(case):
    (values, channels, make, expected) = EDGES[case]
    samples = np.array(list(values), np.int32).reshape(-1, channels)
    (a, b) = both(make, samples, 16, [4096], [4096])
    assert [x.shape[0] for x in a] == [x.shape[0] for x in b]
    assert np.concatenate(a).reshape(-1).tolist() == expected
    assert np.concatenate(b).reshape(-1).tolist() == expected


def test_window_readers_raise_as_the_references():
    with pytest.raises(ValueError):
        port.PCMReaderHead(pcm.reader_from_array(np.zeros((3, 1), np.int32),
                                                 16), -1)
    for make in (lambda p, r: p.PCMReaderWindow(r, 0, 100),
                 lambda p, r: p.PCMReaderHead(r, 100),
                 lambda p, r: p.PCMReaderDeHead(r, 10)):
        for package in (ref, port):
            reader = make(package, package.PCMReaderError(
                "injected", 44100, 2, 3, 16))
            with pytest.raises(ValueError, match="injected"):
                reader.read(4096)


# ---- comparisons and transfers --------------------------------------------

def reader_pair(samples, bps, rate=44100, served=(4096,)):
    return (ChunkReader(samples, bps, served, ref_pcm.FrameList._wrap),
            ChunkReader(samples, bps, served, pcm.FrameList._wrap))


COMPARISONS = [
    ("same", lambda a: a, {}),
    ("one sample", lambda a: np.where(np.arange(a.size).reshape(a.shape) ==
                                      777, a + 1, a), {}),
    ("shorter", lambda a: a[:-5], {}),
    ("longer", lambda a: np.concatenate([a, a[:3]]), {}),
    ("padded", lambda a: np.concatenate([np.zeros((9, 2), np.int32), a,
                                         np.zeros((4, 2), np.int32)]), {}),
    ("rate", lambda a: a, {"sample_rate": 48000}),
    ("bps", lambda a: a, {"bits_per_sample": 24}),
]


@pytest.mark.parametrize("case", [c[0] for c in COMPARISONS])
@pytest.mark.parametrize("served", [(4096,), (100, 333)])
def test_pcm_comparisons_are_the_references(case, served):
    (_name, change, attrs) = [c for c in COMPARISONS if c[0] == case][0]
    rng = np.random.default_rng(3)
    a = rng.integers(-1000, 1000, (2000, 2)).astype(np.int32)
    a[0] = a[-1] = 5
    b = change(a)
    answers = []
    for fn in ("pcm_cmp", "stripped_pcm_cmp", "pcm_frame_cmp"):
        for side in (0, 1):
            (x, y) = (reader_pair(a, 16, served=served)[side],
                      reader_pair(b, 16, served=served)[side])
            for (key, value) in attrs.items():
                setattr(y, key, value)
            answers.append(getattr((ref, port)[side], fn)(x, y))
    assert answers[0::2] == answers[1::2]


@pytest.mark.parametrize("signed,big_endian", [(True, False), (False, True)])
@pytest.mark.parametrize("bps", [8, 16, 24])
def test_transfers_are_the_references(bps, signed, big_endian):
    rng = np.random.default_rng(bps)
    samples = rng.integers(-(1 << (bps - 1)), 1 << (bps - 1),
                           (70000, 2)).astype(np.int32)
    outs = []
    for (side, reader) in enumerate(reader_pair(samples, bps,
                                                served=(30000, 5000))):
        chunks = []
        (ref, port)[side].threaded_transfer_framelist_data(
            reader, chunks.append, signed, big_endian)
        outs.append(b"".join(chunks))
    assert outs[0] == outs[1]
    for package in (ref, port):
        source = io.BytesIO(outs[0])
        sink = io.BytesIO()
        package.transfer_data(source.read, sink.write)
        assert sink.getvalue() == outs[0]
    assert port.BUFFER_SIZE == ref.BUFFER_SIZE
    assert port.FRAMELIST_SIZE == ref.FRAMELIST_SIZE


# ---- ExecProgressQueue ----------------------------------------------------

def quiet_display(package):
    class Options:
        verbosity = "quiet"
    return package.ProgressDisplay(package.Messenger("test", Options()))


def double(value, progress=None):
    if progress is not None:
        for i in range(4):
            progress(i, 4)
    time.sleep(0.01 * (5 - value))
    return value * 2


def failing(value, progress=None):
    if value == 2:
        raise ValueError("job %d exploded" % (value,))
    time.sleep(0.05)
    return value


def run_queue(package, function, jobs, processes, texts=True, completion=None):
    queue = package.ExecProgressQueue(quiet_display(package))
    for i in range(jobs):
        queue.execute(function, ("job %d" % (i,)) if texts else None,
                      completion, value=i)
    return queue.run(processes)


@pytest.mark.parametrize("processes", [1, 2, 3])
@pytest.mark.parametrize("texts", [True, False])
def test_queue_results_are_the_references(processes, texts):
    results = [run_queue(package, double, 5, processes, texts)
               for package in (ref, port)]
    assert results[0] == results[1] == [0, 2, 4, 6, 8]


@pytest.mark.parametrize("processes", [1, 3])
def test_queue_completion_lines_are_the_references(capsys, processes):
    outputs = []
    for package in (ref, port):
        run_queue(package, double, 3, processes,
                  completion=lambda result: "done %d" % (result,))
        outputs.append(sorted(capsys.readouterr().out.splitlines()))
    assert outputs[0] == outputs[1] == ["done 0", "done 2", "done 4"]


@pytest.mark.parametrize("processes", [1, 2])
def test_a_failing_job_raises_the_references_error(processes):
    errors = []
    for package in (ref, port):
        with pytest.raises(Exception) as info:
            run_queue(package, failing, 4, processes)
        errors.append((type(info.value), str(info.value)))
    assert errors[0] == errors[1] == (ValueError, "job 2 exploded")


def test_the_threaded_queue_runs_jobs_in_threads():
    """two jobs run at once, in this process"""
    import threading
    seen = set()

    def job(value, progress=None):
        seen.add((os.getpid(), threading.get_ident()))
        time.sleep(0.05)
        return value

    queue = port.ExecProgressQueue(quiet_display(port))
    for i in range(4):
        queue.execute(job, "job %d" % (i,), None, value=i)
    t0 = time.perf_counter()
    assert queue.run(2) == [0, 1, 2, 3]
    assert time.perf_counter() - t0 < 0.19
    assert {pid for (pid, _t) in seen} == {os.getpid()}
    assert len(seen) == 2
    assert queue.queued_jobs == []
