"""The port under several threads, as the transcode farm runs it:
the CUDA kernels and the host library are built and bound once however
many threads ask first, the process-wide counters stay exact, and a
four-worker CPU farm writes the same files every time."""

import io
import os
import sys
import threading
import time

import numpy as np
import pytest
import torch

from audiotools_tpu_torch import _native, kernels, pcm
from audiotools_tpu_torch.codecs import flac_dec
from audiotools_tpu_torch.codecs import flac_enc_fast as port_enc
from audiotools_tpu_torch.formats.flac import FlacAudio
from audiotools_tpu_torch.formats.wav import WaveAudio
from audiotools_tpu_torch.ops import bitpack
from audiotools_tpu_torch.parallel import farm

torch.set_num_threads(1)

THREADS = 8


@pytest.fixture
def short_switches():
    """a short interpreter switch interval, so that threads interleave
    inside the code under test"""
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        yield
    finally:
        sys.setswitchinterval(old)


def run_threads(target, count=THREADS):
    """runs target(i) on ``count`` threads started together; returns
    their results in order, raising the first error"""
    barrier = threading.Barrier(count, timeout=60)
    results = [None] * count
    errors = []

    def run(i):
        try:
            barrier.wait()
            results[i] = target(i)
        except BaseException as err:  # noqa: B902 - re-raised below
            errors.append(err)

    threads = [threading.Thread(target=run, args=(i,)) for i in range(count)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    assert not any(t.is_alive() for t in threads)
    if errors:
        raise errors[0]
    return results


@pytest.mark.parametrize("module,loader,builder", [
    (kernels, "load", "build"), (_native, "get_lib", "_build")])
def test_first_use_builds_once(monkeypatch, short_switches, module, loader,
                               builder):
    """8 threads reach a library first at once: one builds (a slow
    counting fake) and binds, the others wait and get the same one"""
    builds = []

    def slow_build():
        builds.append(threading.get_ident())
        time.sleep(0.2)
        return "fake.so"

    monkeypatch.setattr(module, "_lib", None)
    monkeypatch.setattr(module, builder, slow_build)
    monkeypatch.setattr(module.ctypes, "CDLL", lambda path: object())
    monkeypatch.setattr(module, "_bind", lambda lib: lib)
    libs = run_threads(lambda i: getattr(module, loader)())
    assert len(builds) == 1
    assert all(lib is libs[0] for lib in libs)


def test_temporaries_are_named_per_thread(monkeypatch, tmp_path):
    """the objects and temporary library of a CUDA build carry the pid
    and the thread, so two builds at once cannot share a path"""
    calls = []

    class Proc:
        returncode = 1

        def __init__(self, cmd, **kwargs):
            calls.append(cmd)

        def communicate(self):
            return ("", None)

    monkeypatch.setattr(kernels, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(kernels, "nvcc_path", lambda: "nvcc")
    monkeypatch.setattr(kernels.subprocess, "Popen", Proc)
    paths = run_threads(lambda i: _failed_build_objects(calls), count=2)
    assert len(paths[0]) == len(paths[1]) == len(kernels._sources())
    assert not set(paths[0]) & set(paths[1])


def _failed_build_objects(calls):
    """the object paths one (failing) kernels.build() named with this
    process's and this thread's ids"""
    before = len(calls)
    with pytest.raises(RuntimeError, match="nvcc failed"):
        kernels.build()
    me = ".%d.%d." % (os.getpid(), threading.get_ident())
    return [cmd[-1] for cmd in calls[before:] if me in cmd[-1]]


def _signal(n=4096 * 3 + 100, seed=3):
    rng = np.random.default_rng(seed)
    t = np.arange(n)
    arr = np.stack([6000 * np.sin(t * 0.02), 5000 * np.sin(t * 0.031)],
                   axis=1) + rng.integers(-200, 200, (n, 2))
    return arr.astype(np.int32)


def test_fallback_counter_is_exact(monkeypatch, short_switches):
    """8 threads whose every batch falls back add 8 x their batches"""
    arr = _signal()
    monkeypatch.setattr(bitpack, "residual_words_capacity",
                        lambda n, bps, parts: 8)
    before = port_enc.fallback_batches

    def encode(_i):
        out = io.BytesIO()
        port_enc.encode_flac_fast(out, pcm.reader_from_array(arr, 16),
                                  device="cpu", block_size=4096,
                                  max_lpc_order=4, batch_frames=1)
        return out.getvalue()

    outs = run_threads(encode)
    assert all(o == outs[0] for o in outs)
    assert port_enc.fallback_batches - before == THREADS * 3


def test_host_chunk_counter_is_exact(monkeypatch, short_switches):
    """8 threads whose every chunk takes the host route (no bucket holds
    a record) add 8 x their chunks"""
    arr = _signal()
    out = io.BytesIO()
    port_enc.encode_flac_fast(out, pcm.reader_from_array(arr, 16),
                              device="cpu", block_size=4096, batch_frames=2)
    data = out.getvalue()
    monkeypatch.setattr(flac_dec, "BUCKETS", ((1, 1),))
    before = flac_dec.host_chunks
    decoded = run_threads(lambda i: flac_dec.decode_flac(data,
                                                         device="cpu"))
    assert all(np.array_equal(d, arr) for d in decoded)
    per_decode = (flac_dec.host_chunks - before) // THREADS
    assert per_decode >= 1
    assert flac_dec.host_chunks - before == THREADS * per_decode
    flac_dec.host_chunks = before
    flac_dec.decode_flac(data, device="cpu")
    assert flac_dec.host_chunks - before == per_decode


def test_four_workers_write_the_same_files(tmp_path):
    """a CPU farm of 4 workers over 8 jobs, three times"""
    sources = []
    for i in range(8):
        path = str(tmp_path / ("s%d.wav" % i))
        WaveAudio.from_pcm(path, pcm.reader_from_array(
            _signal(n=6000 + 999 * i, seed=i), 16))
        sources.append(path)
    runs = []
    for repeat in range(3):
        jobs = [farm.FarmJob(src, str(tmp_path / ("o%d_%d.flac"
                                                  % (repeat, i))),
                             FlacAudio, compression="8")
                for (i, src) in enumerate(sources)]
        results = farm.transcode(jobs, workers=4, devices=["cpu"])
        assert all(r.ok for r in results)
        runs.append([open(r.job.dest_path, "rb").read() for r in results])
    assert runs[0] == runs[1] == runs[2]
    assert len(set(runs[0])) == 8


@pytest.mark.cuda
def test_card_farm_workers_use_their_own_streams(tmp_path):
    """on the card, each worker's jobs run on a stream of its own, not
    the default stream, and the files equal the CPU farm's"""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    sources = []
    for i in range(4):
        path = str(tmp_path / ("s%d.wav" % i))
        WaveAudio.from_pcm(path, pcm.reader_from_array(
            _signal(n=6000 + 999 * i, seed=i), 16))
        sources.append(path)

    def post(dest):
        stream = torch.cuda.current_stream()
        return (threading.get_ident(), stream.cuda_stream,
                stream == torch.cuda.default_stream())

    files = {}
    for devices in (["cpu"], ["cuda"]):
        jobs = [farm.FarmJob(src, str(tmp_path / ("%s%d.flac"
                                                  % (devices[0], i))),
                             FlacAudio, compression="8",
                             post=post if devices == ["cuda"] else None)
                for (i, src) in enumerate(sources)]
        results = farm.transcode(jobs, workers=4, devices=devices)
        assert all(r.ok for r in results), [r.error for r in results]
        files[devices[0]] = [open(r.job.dest_path, "rb").read()
                             for r in results]
    assert files["cpu"] == files["cuda"]
    posts = [r.post for r in results]
    assert not any(default for (_t, _s, default) in posts)
    by_thread = {}
    for (thread, stream, _default) in posts:
        by_thread.setdefault(thread, set()).add(stream)
    assert all(len(s) == 1 for s in by_thread.values())
    assert len({s for v in by_thread.values() for s in v}) == len(by_thread)
