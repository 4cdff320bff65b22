"""The port's stage spans (``audiotools_tpu_torch.utils.profiling``) on
the CPU: the FLAC encode's and decode's spans reach a ``torch.profiler``
trace started with ``profile_all_threads`` (as the benchmark's tracer
starts it) on the farm's worker threads, nested in their job's
``atpu.farm.job`` range; a profile changes no byte; the encode's and the
decode's ``timings`` hold their new keys with the relations between
them; a sink is bound to one thread for one call; and ``trace`` records
every thread.
"""

import io
import json
import os
import threading

import numpy as np
import pytest
import torch

from audiotools_tpu_torch.codecs import flac_dec, flac_enc_fast
from audiotools_tpu_torch.formats.flac import FlacAudio
from audiotools_tpu_torch.parallel import farm
from audiotools_tpu_torch.pcm import reader_from_array
from audiotools_tpu_torch.utils import profiling

SR = 44100
LEVEL8 = dict(FlacAudio.COMPRESSION_OPTIONS["8"], batch_frames=8)
FRAMES = 4096 * 4 + 77
RANGES = ("flac.autocorr", "flac.levinson", "flac.quantize",
          "flac.lpc_residuals", "flac.rice_search")
ENCODE_SPANS = ("read", "qpack", "submit", "enqueue", "wait", "emit",
                "floor", "floor_analysis", "floor_emit", "write", "md5",
                "tail")
DECODE_SPANS = ("scan", "prep", "enqueue", "wait", "md5", "seek")


@pytest.fixture(autouse=True)
def default_environment(monkeypatch):
    """no ATPU_* setting: the encode's default route, the quantized
    upload wire with its floor and overflow retries"""
    for key in [k for k in os.environ if k.startswith("ATPU_")]:
        monkeypatch.delenv(key)


def tones(n=FRAMES):
    """pure tones: the floor retry re-analyses some of their frames"""
    t = np.arange(n)
    return np.stack([19660 * np.sin(2 * np.pi * (1000 + 500 * c) * t / SR
                                    + c) for c in range(2)],
                    axis=1).astype(np.int32)


def glide(n=FRAMES, seed=3):
    """tones under noise: no retry"""
    rng = np.random.default_rng(seed)
    t = np.arange(n)
    return np.stack([8000 * np.sin(2 * np.pi * (300 + 200 * c) * t / SR) +
                     rng.normal(0, 300, n) for c in range(2)],
                    axis=1).astype(np.int32)


def loud_and_quiet(n=FRAMES, seed=5):
    """blocks half loud and half quiet: without the emit's Rice
    re-search the quiet halves overflow the emitter"""
    rng = np.random.default_rng(seed)
    x = rng.integers(0, 2000, (n, 2))
    for b in range(0, n, 4096):
        x[b:b + 2048] = rng.integers(-30000, 30000, (min(2048, n - b), 2))
    return x.astype(np.int32)


def encode(arr, timings=None, target=None):
    out = io.BytesIO() if target is None else target
    flac_enc_fast.encode_flac_fast(out, reader_from_array(arr, 16, SR),
                                   device="cpu", timings=timings, **LEVEL8)
    return out.getvalue() if target is None else target


def all_threads_profile():
    """a CPU profile of every thread, as the benchmark's tracer starts
    one"""
    return torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CPU],
        experimental_config=torch._C._profiler._ExperimentalConfig(
            profile_all_threads=True))


def ranges(prof):
    """the profile's events: (name, thread, start ns, end ns)"""
    return [(e.name(), e.start_thread_id(), e.start_ns(),
             e.start_ns() + e.duration_ns())
            for e in prof.profiler.kineto_results.events()]


def test_the_spans_reach_an_all_threads_trace_on_the_farms_threads(
        tmp_path):
    path = str(tmp_path / "glide.flac")
    encode(glide(), target=path)
    jobs = [("encode", tones()), ("decode", path), ("encode", tones()),
            ("seek", path)]

    def run(job, device):
        (kind, what) = job
        if kind == "encode":
            return len(encode(what))
        dec = flac_dec.TorchFlacDecoder(what, device=device)
        try:
            if kind == "seek":
                dec.seek(4096 * 2 + 10)
            while dec.read(4096).frames:
                pass
        finally:
            dec.close()
        return dec.timings

    with all_threads_profile() as prof:
        outcomes = farm.run_jobs(jobs, run, workers=2, devices=["cpu"])
    assert all(error is None for (_result, error) in outcomes)
    events = ranges(prof)
    main = threading.get_native_id()
    jobs_seen = [e for e in events if e[0] == "atpu.farm.job"]
    assert len(jobs_seen) == len(jobs)
    workers = {e[1] for e in jobs_seen}
    assert main not in workers and len(workers) == 2
    wanted = (["atpu.flac_enc." + s for s in ENCODE_SPANS] +
              ["atpu.flac_dec." + s for s in DECODE_SPANS] + list(RANGES))
    for name in wanted:
        found = [e for e in events if e[0] == name]
        assert found, name
        for (_n, thread, start, end) in found:
            assert thread in workers, name
            assert any(j[1] == thread and j[2] <= start and end <= j[3]
                       for j in jobs_seen), name


def test_a_profile_changes_no_byte():
    arr = tones()
    plain = encode(arr)
    with all_threads_profile():
        profiled = encode(arr)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        profiled_here = encode(arr)
    assert plain == profiled == profiled_here


@pytest.mark.parametrize("signal,exact_rice,retry", [
    (tones, None, "floor"), (loud_and_quiet, "0", "overflow"),
    (glide, None, None)])
def test_the_new_timings_keys(monkeypatch, signal, exact_rice, retry):
    if exact_rice is not None:
        monkeypatch.setenv("ATPU_EMIT_EXACT_RICE", exact_rice)
    before = (flac_enc_fast.floor_frames, flac_enc_fast.overflow_batches)
    timings = {}
    encode(signal(), timings)
    after = (flac_enc_fast.floor_frames, flac_enc_fast.overflow_batches)
    ran = {"floor": after[0] > before[0], "overflow": after[1] > before[1]}
    assert [kind for (kind, went) in ran.items() if went] == (
        [retry] if retry else [])
    assert {"enqueue", "enqueue_cpu", "wait", "floor_analysis",
            "tail"} <= set(flac_enc_fast.STAGES)
    assert sorted(timings) == sorted(flac_enc_fast.STAGES)
    assert all(v >= 0.0 for v in timings.values())
    assert timings["enqueue"] > 0.0 and timings["tail"] > 0.0
    assert 0.0 <= timings["enqueue_cpu"] <= timings["enqueue"] * 1.01 + 1e-4
    assert timings["floor_analysis"] <= timings["floor"]
    assert (timings["floor_analysis"] > 0.0) == (retry is not None)
    assert (timings["floor"] > 0.0) == (retry is not None)


def test_the_decoders_new_timings_keys(tmp_path):
    path = str(tmp_path / "glide.flac")
    arr = glide()
    encode(arr, target=path)
    dec = flac_dec.TorchFlacDecoder(path, device="cpu")
    pieces = []
    while True:
        framelist = dec.read(5000)
        if framelist.frames == 0:
            break
        pieces.append(framelist.samples)
    dec.close()
    assert np.array_equal(np.concatenate(pieces), arr)
    timings = dec.timings
    assert {"enqueue", "wait"} <= set(flac_dec.STAGES)
    assert sorted(timings) == sorted(flac_dec.STAGES)
    # on the CPU the device stages run inside the enqueue
    device = sum(timings[s] for s in flac_dec.DEVICE_STAGES)
    assert timings["enqueue"] >= device > 0.0
    assert timings["wait"] >= 0.0
    assert dec.stages.counts["enqueue"] == dec.stages.counts["wait"]


def test_a_span_is_the_null_context_with_nothing_to_record(monkeypatch):
    monkeypatch.delenv("ATPU_PROFILE", raising=False)
    assert profiling.span("qpack", "flac_enc") is profiling._NULL_SCOPE
    assert profiling.named_scope("flac.autocorr") is profiling._NULL_SCOPE
    sink = profiling.StageTimers("t", "flac_enc")
    with profiling.collect(sink):
        assert profiling.span("qpack") is not profiling._NULL_SCOPE
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        assert profiling.span("job", "farm") is not profiling._NULL_SCOPE


def test_a_sink_is_bound_to_one_thread_for_one_call():
    outer = profiling.StageTimers("outer", "a")
    inner = profiling.StageTimers("inner", "b")
    seen = {}

    def elsewhere():
        with profiling.span("other"):
            pass
        seen["sink"] = getattr(profiling._bound, "sink", None)

    with profiling.collect(outer):
        with profiling.span("x"):
            with profiling.collect(inner):
                with profiling.span("y"), profiling.named_scope("flac.z"):
                    thread = threading.Thread(target=elsewhere)
                    thread.start()
                    thread.join(timeout=30)
            with profiling.span("x"):
                pass
    assert not thread.is_alive() and seen["sink"] is None
    assert getattr(profiling._bound, "sink", None) is None
    assert outer.counts == {"x": 2} and inner.counts == {"y": 1,
                                                         "flac.z": 1}
    assert outer.totals["x"] >= inner.totals["y"] >= 0.0
    assert set(outer.cpu) == {"x"}


def test_ranges_take_the_sinks_component(monkeypatch):
    monkeypatch.delenv("ATPU_PROFILE", raising=False)
    sink = profiling.StageTimers("t", "flac_enc")
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with profiling.collect(sink):
            with profiling.span("qpack"), sink("emit"):
                pass
            with profiling.span("job", "farm", "job=1,worker=0"):
                pass
        with profiling.span("job", "farm", "job=2,worker=1"):
            pass
    names = [e[0] for e in ranges(prof)]
    assert names.count("atpu.flac_enc.qpack") == 1
    assert names.count("atpu.flac_enc.emit") == 1
    assert names.count("atpu.farm.job") == 2
    # a sink takes its stages under their own names, whatever component
    # names the range
    assert sink.counts == {"qpack": 1, "emit": 1, "job": 1}


def test_trace_records_the_farms_threads(monkeypatch, tmp_path):
    monkeypatch.setenv("ATPU_TORCH_TRACE", str(tmp_path))

    def run(job, device):
        with profiling.named_scope("flac.autocorr"):
            return int(torch.arange(job).sum())

    with profiling.trace("farm") as path:
        outcomes = farm.run_jobs([10, 20, 30], run, workers=2,
                                 devices=["cpu"])
    assert [r for (r, _e) in outcomes] == [45, 190, 435]
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    main = threading.get_native_id()
    threads = {e["tid"] for e in events
               if e.get("name") in ("atpu.farm.job", "flac.autocorr")}
    assert threads and main not in threads
    assert sum(e.get("name") == "flac.autocorr" for e in events) == 3
