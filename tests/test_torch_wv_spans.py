"""The WavPack encode's stage spans (component ``wv_enc``) on the CPU:
the frame loop's spans reach a sink bound to the thread, a call a frame
counted; ``encode_wavpack``'s ``timings`` are a view of its sink, its
ENCODE_STAGES kept and host the sum of its host spans; its counters
count frames, blocks and where they were correlated; the spans reach an
all-threads profile on the farm's threads; and neither a sink nor a
profile changes a byte."""

import io
import os

import numpy as np
import pytest
import torch

from audiotools_tpu_torch.codecs import wavpack
from audiotools_tpu_torch.formats import wavpack as wv_format
from audiotools_tpu_torch.parallel import farm
from audiotools_tpu_torch.pcm import reader_from_array
from audiotools_tpu_torch.ref import wavpack as oracle
from audiotools_tpu_torch.utils import profiling

torch.set_num_threads(1)

BLOCK = 1000
SPANS = ("read", "md5", "decide", "correlate", "write")


@pytest.fixture(autouse=True)
def default_environment(monkeypatch):
    for key in [k for k in os.environ if k.startswith("ATPU_")]:
        monkeypatch.delenv(key)


def tones(n, channels=2, seed=3):
    rng = np.random.default_rng(seed)
    t = np.arange(n)
    return np.stack([6000 * np.sin(t * 0.02 * (c + 1)) +
                     rng.normal(0, 40, n) for c in range(channels)],
                    axis=1).astype(np.int32)


def encode(arr, timings=None, device="cpu", passes=5):
    out = io.BytesIO()
    wavpack.encode_wavpack(out, reader_from_array(arr, 16), BLOCK,
                           correlation_passes=passes, device=device,
                           timings=timings)
    return out.getvalue()


def host_encode(arr, passes=5):
    out = io.BytesIO()
    oracle.encode_wavpack(out, reader_from_array(arr, 16), BLOCK,
                          correlation_passes=passes)
    return out.getvalue()


@pytest.mark.parametrize("frames,channels", [(BLOCK * 3 + 17, 2),
                                             (BLOCK * 2, 1), (BLOCK - 1, 6)])
def test_the_spans_reach_a_bound_sink(frames, channels):
    arr = tones(frames, channels)
    sink = profiling.StageTimers("t", "wv_enc")
    out = io.BytesIO()
    with profiling.collect(sink):
        oracle.encode_wavpack(out, reader_from_array(arr, 16), BLOCK,
                              correlation_passes=2)
    n = -(-frames // BLOCK)
    assert sink.counts == dict(read=n + 1, md5=n, decide=n, correlate=n,
                               write=n)
    assert all(sink.totals[s] >= 0.0 for s in SPANS)
    assert out.getvalue() == host_encode(arr, passes=2)


def test_the_timings_are_a_view_with_their_keys():
    arr = tones(BLOCK * 2 + 300)
    timings = {}
    encode(arr, timings)
    assert set(wavpack.ENCODE_STAGES) == {"upload", "corr", "fetch", "host"}
    assert sorted(timings) == sorted(wavpack.ENCODE_STAGES +
                                     wavpack.SPAN_STAGES)
    assert timings["host"] == pytest.approx(
        sum(timings[s] for s in wavpack.HOST_STAGES))
    # on the CPU the device stages are host-clock marks inside correlate
    device = timings["upload"] + timings["corr"] + timings["fetch"]
    assert 0.0 < device <= timings["correlate"]
    again = dict(timings)
    encode(arr, timings)
    assert all(timings[k] > again[k] for k in ("corr", "correlate", "md5"))


def test_a_sink_changes_no_byte():
    arr = tones(BLOCK * 2 + 5)
    timings = {}
    assert encode(arr, timings) == encode(arr) == host_encode(arr)


@pytest.mark.parametrize("oracle_route", [False, True])
def test_the_counters(monkeypatch, oracle_route):
    if oracle_route:
        monkeypatch.setenv("ATPU_WV_ORACLE", "1")
    arr = tones(BLOCK * 2 + 1, 3)
    names = ("frames_encoded", "blocks_encoded", "device_frames",
             "host_frames")
    before = {k: getattr(wavpack, k) for k in names}
    data = encode(arr, {})
    got = {k: getattr(wavpack, k) - before[k] for k in names}
    # three frames of two block groups (2 + 1 channels)
    assert got["frames_encoded"] == 3 and got["blocks_encoded"] == 6
    assert (got["device_frames"], got["host_frames"]) == (
        (0, 3) if oracle_route else (3, 0))
    assert data == host_encode(arr)


def test_the_profile_report(monkeypatch, capsys):
    monkeypatch.setenv("ATPU_PROFILE", "1")
    encode(tones(BLOCK + 1))
    err = capsys.readouterr().err
    assert "[ATPU_PROFILE] wavpack_enc[torch]" in err and "(2 frames)" in err
    for stage in SPANS:
        assert stage in err


def test_the_spans_reach_an_all_threads_trace_on_the_farms_threads():
    arrs = [tones(BLOCK + 7, seed=s) for s in range(3)]

    def run(job, device):
        out = io.BytesIO()
        wv_format.write_wavpack(out, reader_from_array(job, 16),
                                "standard", device=device)
        return out.getvalue()

    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU],
            experimental_config=torch._C._profiler._ExperimentalConfig(
                profile_all_threads=True)) as prof:
        outcomes = farm.run_jobs(arrs, run, workers=2, devices=["cpu"])
    assert all(error is None for (_r, error) in outcomes)
    events = [(e.name(), e.start_thread_id())
              for e in prof.profiler.kineto_results.events()]
    jobs = {t for (name, t) in events if name == "atpu.farm.job"}
    assert len(jobs) == 2
    for stage in SPANS:
        found = [t for (name, t) in events if name == "atpu.wv_enc." + stage]
        assert found and set(found) <= jobs, stage
    for (arr, (data, _e)) in zip(arrs, outcomes):
        plain = io.BytesIO()
        wv_format.write_wavpack(plain, reader_from_array(arr, 16),
                                "standard", device="cpu")
        assert data == plain.getvalue()
