"""The port's transcode farm on the CPU against the reference's farm:
``parallel.farm.transcode`` of WAVE tracks to FLAC -8 with
``devices=["cpu"]`` writes the reference farm's files, ``verify_flac``
gives the reference's samples and AccurateRip sums, and failures stay
with their job.

The reference runs its numpy backend with exact uploads and without
the emit-stage Rice re-search (ATPU_FLAC_QPACK=0, ATPU_EMIT_EXACT_RICE=0),
the configuration the port's encoder follows.
"""

import os
import threading

import numpy as np
import pytest
import torch

from audiotools_tpu.formats.flac import FlacAudio as RefFlacAudio
from audiotools_tpu.parallel import farm as ref_farm
from audiotools_tpu_torch import pcm
from audiotools_tpu_torch.accuraterip_checksum import accuraterip_checksums
from audiotools_tpu_torch.formats.flac import FlacAudio
from audiotools_tpu_torch.formats.wav import WaveAudio
from audiotools_tpu_torch.parallel import farm

torch.set_num_threads(1)

SR = 44100
CPU = ["cpu"]


def track(seed, frames=None):
    """a short stereo track whose length is no multiple of 4096"""
    rng = np.random.default_rng(seed)
    n = frames or 20000 + 1371 * seed
    t = np.arange(n)
    base = 7000.0 * np.sin(2 * np.pi * (300 + 40 * seed) * t / SR)
    arr = np.stack([base + rng.integers(-300, 300, n), 0.6 * base], axis=1)
    return np.clip(arr, -32768, 32767).astype(np.int32)


def write_tracks(directory, count):
    """(paths, arrays) of ``count`` WAVE tracks in ``directory``"""
    paths = []
    arrays = []
    for i in range(count):
        arr = track(i)
        path = os.path.join(str(directory), "src%d.wav" % i)
        WaveAudio.from_pcm(path, pcm.reader_from_array(arr, 16, SR))
        paths.append(path)
        arrays.append(arr)
    return (paths, arrays)


def read_bytes(path):
    with open(path, "rb") as f:
        return f.read()


@pytest.fixture
def exact_reference(monkeypatch):
    monkeypatch.setenv("ATPU_FLAC_BACKEND", "numpy")
    monkeypatch.setenv("ATPU_FLAC_QPACK", "0")
    monkeypatch.setenv("ATPU_EMIT_EXACT_RICE", "0")
    monkeypatch.delenv("ATPU_FARM_DEVICE_SHARD", raising=False)


def port_farm(sources, out_dir, workers, tag, post=None, progress=None):
    jobs = [farm.FarmJob(src, os.path.join(str(out_dir),
                                           "%s%d.flac" % (tag, i)),
                         FlacAudio, compression="8", post=post)
            for (i, src) in enumerate(sources)]
    return farm.transcode(jobs, workers=workers, progress=progress,
                          devices=CPU)


@pytest.mark.parametrize("workers", [1, 3])
def test_farm_files_match_the_reference_farm(tmp_path, exact_reference,
                                             workers):
    (sources, arrays) = write_tracks(tmp_path, 4)
    ref_jobs = [ref_farm.FarmJob(src, str(tmp_path / ("ref%d.flac" % i)),
                                 RefFlacAudio, compression="8")
                for (i, src) in enumerate(sources)]
    ref_results = ref_farm.transcode(ref_jobs, workers=1)
    assert all(r.ok for r in ref_results)
    seen = []
    lock = threading.Lock()

    def progress(done, total):
        with lock:
            seen.append((done, total))

    results = port_farm(sources, tmp_path, workers, "w%d_" % workers,
                        post=farm.verify_flac, progress=progress)
    assert [r.job.source for r in results] == sources
    assert sorted(seen) == [(i, 4) for i in range(1, 5)]
    for (r, ref, arr) in zip(results, ref_results, arrays):
        assert r.ok, r.error
        assert read_bytes(r.job.dest_path) == read_bytes(ref.job.dest_path)
        assert isinstance(r.dest, FlacAudio)
        assert r.dest.device == torch.device("cpu")
        assert np.array_equal(r.post, arr)


def test_a_missing_source_fails_alone(tmp_path):
    (sources, _arrays) = write_tracks(tmp_path, 3)
    good = port_farm(sources, tmp_path, 1, "good")
    sources[1] = str(tmp_path / "missing.wav")
    results = port_farm(sources, tmp_path, 2, "bad")
    assert [r.ok for r in results] == [True, False, True]
    assert isinstance(results[1].error, OSError)
    assert not os.path.exists(results[1].job.dest_path)
    for i in (0, 2):
        assert (read_bytes(results[i].job.dest_path) ==
                read_bytes(good[i].job.dest_path))


def test_a_failed_encode_leaves_no_partial_output(tmp_path):
    (sources, _arrays) = write_tracks(tmp_path, 2)

    def broken_post(dest):
        raise RuntimeError("post failed")

    results = port_farm(sources, tmp_path, 2, "p", post=broken_post)
    for r in results:
        assert not r.ok and str(r.error) == "post failed"
        assert not os.path.exists(r.job.dest_path)


@pytest.mark.parametrize("first,last", [(True, False), (False, True),
                                        (True, True)])
def test_verify_flac_matches_the_reference(tmp_path, exact_reference, first,
                                           last):
    arr = track(5, frames=SR + 123)
    path = str(tmp_path / "t.flac")
    dest = FlacAudio.from_pcm(path, pcm.reader_from_array(arr, 16, SR),
                              device="cpu")
    (samples, sums) = farm.verify_flac(dest, chunk=10000,
                                       accuraterip=(first, last))
    (ref_samples, ref_sums) = ref_farm.verify_flac(
        RefFlacAudio(path), chunk=10000, accuraterip=(first, last))
    assert np.array_equal(samples, arr)
    assert np.array_equal(samples, ref_samples)
    assert tuple(sums) == tuple(ref_sums)
    assert sums == accuraterip_checksums(pcm.reader_from_array(arr, 16),
                                         len(arr), first, last, SR,
                                         device="cpu")
    assert np.array_equal(farm.verify_flac(dest), arr)


def test_verify_flac_raises_on_a_flipped_byte(tmp_path):
    arr = track(6, frames=30000)
    path = str(tmp_path / "t.flac")
    dest = FlacAudio.from_pcm(path, pcm.reader_from_array(arr, 16, SR),
                              device="cpu")
    data = bytearray(read_bytes(path))
    data[len(data) - 3000] ^= 0x10          # inside the last frames
    with open(path, "wb") as f:
        f.write(data)
    with pytest.raises(ValueError):
        farm.verify_flac(FlacAudio(path, device="cpu"))


def test_cuda_request_raises_without_a_card(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    (sources, _arrays) = write_tracks(tmp_path, 1)
    jobs = [farm.FarmJob(sources[0], str(tmp_path / "o.flac"), FlacAudio)]
    for devices in (None, ["cuda"], ["cpu", "cuda"]):
        with pytest.raises(RuntimeError, match="cuda"):
            farm.transcode(jobs, devices=devices)
    assert not os.path.exists(str(tmp_path / "o.flac"))


def test_more_cards_than_there_are_raise(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="only 1"):
        farm.transcode([], devices=["cuda:0", "cuda:1"])


def test_metadata_is_not_ported(tmp_path):
    """named for the refusal it once checked, which is gone: a job's
    MetaData is written into its destination, as the reference farm's
    set_metadata writes it"""
    from audiotools_tpu.audiofile import MetaData as RefMetaData
    from audiotools_tpu.formats.wav import WaveAudio as RefWaveAudio
    from audiotools_tpu_torch.audiofile import MetaData
    source = str(tmp_path / "a.wav")
    WaveAudio.from_pcm(source, pcm.reader_from_array(
        np.zeros((3000, 2), dtype=np.int32), 16))
    tags = dict(track_name="Tïtle", track_number=2, album_name="Àlbum")
    [result] = farm.transcode([farm.FarmJob(
        source, str(tmp_path / "b.flac"), FlacAudio,
        metadata=MetaData(**tags))], devices=["cpu"])
    assert result.ok, result.error
    ref = RefFlacAudio.from_pcm(str(tmp_path / "r.flac"),
                                RefWaveAudio(source).to_pcm())
    ref.set_metadata(RefMetaData(**tags))
    got = result.dest.get_metadata()
    assert (got.track_name, got.track_number, got.album_name) == (
        "Tïtle", 2, "Àlbum")
    assert (got.get_block(4).comment_strings ==
            ref.get_metadata().get_block(4).comment_strings)


class _FakeStream:
    """a stand-in for torch.cuda.Stream: the worker that made it"""

    def __init__(self, device=None):
        self.device = device
        self.synchronized = False

    def synchronize(self):
        self.synchronized = True


class _Current(threading.local):
    stream = "default"


def test_workers_run_on_streams_of_their_own(tmp_path, monkeypatch):
    """on a CUDA device each worker enters torch.cuda.device and a
    stream it made, never the default stream; every job of a worker
    runs on that stream (torch.cuda faked: no card here)"""
    current = _Current()
    made = []

    class Enter:
        def __init__(self, value):
            self.value = value

        def __enter__(self):
            (self.old, current.stream) = (current.stream, self.value)

        def __exit__(self, *exc):
            current.stream = self.old

    def new_stream(device=None):
        made.append(_FakeStream(device))
        return made[-1]

    monkeypatch.setattr(farm, "resolve_devices",
                        lambda devices: [torch.device("cuda", 0)] * 2)
    monkeypatch.setattr(torch.cuda, "Stream", new_stream)
    monkeypatch.setattr(torch.cuda, "stream", Enter)
    monkeypatch.setattr(torch.cuda, "device", lambda d: Enter("device"))
    seen = []
    barrier = threading.Barrier(4, timeout=30)

    class Source:
        def to_pcm(self):
            barrier.wait()      # every worker holds a job at once
            return pcm.reader_from_array(track(1, frames=10), 16)

    class Dest:
        @classmethod
        def from_pcm(cls, path, reader, device, compression=None):
            seen.append((threading.get_ident(), current.stream, device))
            return cls()

    jobs = [farm.FarmJob(Source(), str(tmp_path / ("%d" % i)), Dest)
            for i in range(4)]
    results = farm.transcode(jobs, workers=4, devices=["cuda"])
    assert all(r.ok for r in results)
    assert len(made) == 4 and all(s.synchronized for s in made)
    streams = {t: s for (t, s, _d) in seen}
    assert len(streams) == 4
    assert all(isinstance(s, _FakeStream) for s in streams.values())
    assert len({id(s) for s in streams.values()}) == 4
    assert all(d == torch.device("cuda", 0) for (_t, _s, d) in seen)
