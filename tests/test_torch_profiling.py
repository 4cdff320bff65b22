"""The port's stage profiler (``audiotools_tpu_torch.utils.profiling``)
against the reference's (``audiotools_tpu.utils.profiling``), on the CPU.

``StageTimers.report`` must print the reference's ``[ATPU_PROFILE]``
lines for the same stages and clock readings; ``stage_timer`` must give
a sink that times its stages either way and whose report prints, as the
reference's does, only when ``ATPU_PROFILE`` is set; ``named_scope``
must be the null context unless the variable is set, a sink is bound or
a torch profiler records, and a CPU ``torch.profiler`` trace of one FLAC
analysis must hold the five ``flac.*`` ranges; ``trace`` must write
``<dir>/<label>.json`` only when ``ATPU_TORCH_TRACE`` names a directory.
The FLAC encode writes the same bytes with ``ATPU_PROFILE`` set and
unset, the reference's bytes, and reports its stages once: its spans'
and the device stages' (the five ranges among them).
"""

import io
import json

import numpy as np
import pytest
import torch

from audiotools_tpu.codecs.flac_enc_fast import (
    encode_flac_fast as reference_encode)
from audiotools_tpu.utils import profiling as ref_profiling
from audiotools_tpu_torch.codecs import flac_enc_fast
from audiotools_tpu_torch.ops import flac_frames, lpc
from audiotools_tpu_torch.utils import profiling

RANGES = ("flac.autocorr", "flac.levinson", "flac.quantize",
          "flac.lpc_residuals", "flac.rice_search")


class Clock:
    """a clock that moves a fixed step a reading"""

    def __init__(self, step):
        self.now = 0.0
        self.step = step

    def __call__(self):
        self.now += self.step
        return self.now


def fixed_clocks(monkeypatch):
    monkeypatch.setattr("time.perf_counter", Clock(0.00125))
    monkeypatch.setattr("time.process_time", Clock(0.0005))
    monkeypatch.setattr("time.thread_time", Clock(0.00025))


@pytest.mark.parametrize("stages", [
    [], ["read"], ["read", "qpack", "read", "emit", "emit", "emit"],
    ["fetch"] * 5 + ["write", "md5", "submit", "floor"]])
@pytest.mark.parametrize("extra", ["", "(12 frames)"])
def test_the_report_is_the_references(monkeypatch, stages, extra):
    outputs = []
    for module in (ref_profiling, profiling):
        fixed_clocks(monkeypatch)
        timers = module.StageTimers("flac_enc_fast[test]")
        for stage in stages:
            with timers(stage):
                pass
        timers.add("added", 0.0042)
        stream = io.StringIO()
        timers.report(stream=stream, extra=extra)
        outputs.append(stream.getvalue())
    assert outputs[0] == outputs[1]
    assert outputs[1].startswith("[ATPU_PROFILE] flac_enc_fast[test]: wall ")


@pytest.mark.parametrize("value,enabled", [(None, False), ("", False),
                                           ("0", False), ("1", True),
                                           ("yes", True)])
def test_stage_timer_follows_the_variable_as_the_references(
        monkeypatch, value, enabled, capsys):
    if value is None:
        monkeypatch.delenv("ATPU_PROFILE", raising=False)
    else:
        monkeypatch.setenv("ATPU_PROFILE", value)
    assert profiling.profiling_enabled() == enabled
    assert ref_profiling.profiling_enabled() == enabled
    ref_profiling.stage_timer("x").report()
    ref_err = capsys.readouterr().err
    timers = profiling.stage_timer("x")
    # one accumulator either way: the stages are timed, and the report
    # alone follows the variable
    assert isinstance(timers, profiling.StageTimers)
    with timers("read"):
        pass
    timers.add("read", 1.0)
    assert timers.counts == {"read": 2} and timers.totals["read"] >= 1.0
    timers.report()
    err = capsys.readouterr().err
    assert err.startswith("[ATPU_PROFILE] x:") == enabled
    assert ref_err.startswith("[ATPU_PROFILE] x:") == enabled
    if not enabled:
        assert err == ref_err == ""


def analysis_inputs(seed=4, rows=3, n=256):
    rng = np.random.default_rng(seed)
    t = np.arange(n)
    X = np.stack([(3000 * np.sin(2 * np.pi * (200 + 90 * r) * t / 44100) +
                   rng.integers(-40, 40, n)) for r in range(rows)])
    return (torch.from_numpy(X.astype(np.int32)),
            torch.full((rows,), 16, dtype=torch.int32),
            lpc.tukey_window(n, torch.device("cpu")))


def analyse():
    (X, bps, window) = analysis_inputs()
    return flac_frames.analyze_subframes(X, bps, X.shape[1], 8, 12,
                                         [0, 1, 2], 14, False, window)


def test_a_scope_is_the_null_context_when_off(monkeypatch):
    monkeypatch.delenv("ATPU_PROFILE", raising=False)
    assert profiling.named_scope("flac.autocorr") is profiling._NULL_SCOPE
    monkeypatch.setenv("ATPU_PROFILE", "1")
    assert profiling.named_scope("flac.autocorr") is not \
        profiling._NULL_SCOPE


@pytest.mark.parametrize("profile_variable", [None, "1"])
def test_a_profile_of_one_analysis_holds_the_five_ranges(
        monkeypatch, profile_variable):
    if profile_variable is None:
        monkeypatch.delenv("ATPU_PROFILE", raising=False)
    else:
        monkeypatch.setenv("ATPU_PROFILE", profile_variable)
    plain = analyse()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        scoped = analyse()
    names = {event.key for event in prof.key_averages()}
    assert set(RANGES) <= names
    for key in plain:
        assert torch.equal(plain[key], scoped[key])


def test_trace_writes_a_file_only_when_asked(monkeypatch, tmp_path):
    monkeypatch.delenv("ATPU_TORCH_TRACE", raising=False)
    with profiling.trace("off") as path:
        analyse()
    assert path is None
    assert list(tmp_path.iterdir()) == []
    target = tmp_path / "traces"
    monkeypatch.setenv("ATPU_TORCH_TRACE", str(target))
    with profiling.trace("flac_enc") as path:
        analyse()
    assert path == str(target / "flac_enc.json")
    assert sorted(p.name for p in target.iterdir()) == ["flac_enc.json"]
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    names = {event.get("name") for event in events}
    assert set(RANGES) <= names


OPTS = dict(block_size=1024, max_lpc_order=8, exhaustive_model_search=False,
            max_residual_partition_order=4, batch_frames=4)


def encode_signal(seed=6, n=1024 * 9 + 300):
    rng = np.random.default_rng(seed)
    t = np.arange(n)
    return np.stack([(4000 * np.sin(2 * np.pi * (300 + 200 * c) * t /
                                    44100)).astype(np.int64) +
                     rng.integers(-60, 60, n) for c in range(2)],
                    axis=1).astype(np.int32)


def stream_reader(arr):
    from audiotools_tpu_torch import pcm
    return pcm.reader_from_array(arr, 16, 44100)


@pytest.mark.parametrize("pack", [True, False])
def test_profiled_and_unprofiled_encodes_write_the_references_bytes(
        monkeypatch, capsys, pack):
    monkeypatch.setenv("ATPU_FLAC_QPACK", "0")
    monkeypatch.setenv("ATPU_EMIT_EXACT_RICE", "0")
    arr = encode_signal()
    outputs = []
    reports = []
    for value in ("0", "1"):
        monkeypatch.setenv("ATPU_PROFILE", value)
        buf = io.BytesIO()
        flac_enc_fast.encode_flac_fast(buf, stream_reader(arr),
                                       device="cpu", pack=pack,
                                       mid_side=True, **OPTS)
        outputs.append(buf.getvalue())
        reports.append(capsys.readouterr().err)
    monkeypatch.setenv("ATPU_PROFILE", "0")
    buf = io.BytesIO()
    reference_encode(buf, stream_reader(arr), backend="numpy",
                     mid_side=True, **OPTS)
    assert outputs[0] == outputs[1] == buf.getvalue()
    assert "[ATPU_PROFILE]" not in reports[0]
    lines = reports[1].splitlines()
    assert [line for line in lines if "[ATPU_PROFILE]" in line] == [
        line for line in lines if line.startswith(
            "[ATPU_PROFILE] flac_enc_fast[torch]: wall ")]
    assert len([line for line in lines if "[ATPU_PROFILE]" in line]) == 1
    stages = {line.split()[0] for line in lines
              if line.startswith("  ") and "ms wall" in line}
    # the exact routes on the CPU: no floor retry, no CUDA-event fetch
    assert {"read", "qpack", "md5", "submit", "enqueue", "wait", "emit",
            "write", "tail", "upload", "analysis", "pack"} | set(
                RANGES) == stages
    # the report names the frames written: 10 FLAC frames
    assert lines[0].endswith("(10 frames)")
