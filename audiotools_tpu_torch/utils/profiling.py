"""Pipeline stage timing and torch profiler hooks.

The port's counterpart of the reference's ``utils/profiling``:

* ``stage_timer(name)``: wall-clock and thread-CPU accumulators around
  the host stages of a codec pipeline (read, qpack, md5, submit, fetch,
  emit, floor, write), when ``ATPU_PROFILE`` is set; the pipeline
  prints the split once at its end (``StageTimers.report``).  Unset, it
  returns a null object whose scopes do nothing.
* ``named_scope(name)``: a ``torch.profiler.record_function`` range,
  also an NVTX range where the card is in use, around a device stage
  (``flac.autocorr``, ``flac.levinson``, ...), so a profile names the
  kernels' stages.  It is a null context unless ``ATPU_PROFILE`` is set
  or a torch profiler is recording.
* ``trace(label)``: a ``torch.profiler.profile`` capture around a block,
  written as a Chrome trace to ``<dir>/<label>.json`` when
  ``ATPU_TORCH_TRACE=<dir>`` is set (view it in chrome://tracing or
  Perfetto); nothing otherwise.
"""

from __future__ import annotations

import contextlib
import os
import sys
import time


def profiling_enabled():
    return os.environ.get("ATPU_PROFILE", "") not in ("", "0")


class StageTimers:
    """wall-clock and thread-CPU accumulators for named pipeline stages

    A stage is timed from one thread at a time and ``report`` runs once
    the pipeline is done.  Thread CPU (``time.thread_time``) tells a
    stage that works the host's cores from one that waits (for the
    card, or behind another thread)."""

    def __init__(self, name):
        self.name = name
        self.totals = {}
        self.cpu = {}
        self.counts = {}
        self.t0 = time.perf_counter()
        self.c0 = time.process_time()

    @contextlib.contextmanager
    def __call__(self, stage):
        start = time.perf_counter()
        cstart = time.thread_time()
        try:
            yield
        finally:
            dt = time.perf_counter() - start
            dc = time.thread_time() - cstart
            self.totals[stage] = self.totals.get(stage, 0.0) + dt
            self.cpu[stage] = self.cpu.get(stage, 0.0) + dc
            self.counts[stage] = self.counts.get(stage, 0) + 1

    def add(self, stage, dt):
        self.totals[stage] = self.totals.get(stage, 0.0) + dt
        self.counts[stage] = self.counts.get(stage, 0) + 1

    def report(self, stream=None, extra=""):
        stream = stream or sys.stderr
        wall = time.perf_counter() - self.t0
        cpu = time.process_time() - self.c0
        lines = ["[ATPU_PROFILE] %s: wall %.1f ms, process CPU "
                 "%.1f ms %s" % (self.name, wall * 1e3, cpu * 1e3,
                                 extra)]
        for stage in sorted(self.totals, key=self.totals.get,
                            reverse=True):
            n = self.counts[stage]
            tot = self.totals[stage] * 1e3
            c = self.cpu.get(stage, 0.0) * 1e3
            lines.append("  %-24s %9.1f ms wall %9.1f ms cpu"
                         "  (%4d calls, %6.2f/%6.2f ms/call)"
                         % (stage, tot, c, n, tot / max(n, 1),
                            c / max(n, 1)))
        print("\n".join(lines), file=stream, flush=True)


class _NullTimers:
    name = None

    def __call__(self, stage):
        return _NULL_SCOPE

    def add(self, stage, dt):
        pass

    def report(self, stream=None, extra=""):
        pass


_NULL_SCOPE = contextlib.nullcontext()
_NULL = _NullTimers()


def stage_timer(name):
    """a StageTimers when ATPU_PROFILE is set, else a null object"""
    return StageTimers(name) if profiling_enabled() else _NULL


def _profiler_recording():
    """True while a torch profiler records on this thread"""
    import torch
    return torch._C._autograd._profiler_enabled()


class _Range:
    """a record_function range, and an NVTX range when CUDA is in use"""

    __slots__ = ("name", "record", "nvtx")

    def __init__(self, name):
        self.name = name

    def __enter__(self):
        import torch
        self.record = torch.profiler.record_function(self.name)
        self.record.__enter__()
        self.nvtx = torch.cuda.is_initialized()
        if self.nvtx:
            torch.cuda.nvtx.range_push(self.name)
        return self

    def __exit__(self, *exc):
        import torch
        if self.nvtx:
            torch.cuda.nvtx.range_pop()
        self.record.__exit__(*exc)
        return False


def named_scope(name):
    """a profiler range named ``name`` around a device stage while
    ATPU_PROFILE is set or a torch profiler records, else a null
    context"""
    if profiling_enabled() or _profiler_recording():
        return _Range(name)
    return _NULL_SCOPE


@contextlib.contextmanager
def trace(label="atpu"):
    """captures a torch profiler trace of the block (the CPU, and the
    card where CUDA is available) into ``<dir>/<label>.json`` when
    ATPU_TORCH_TRACE=<dir> is set; yields the path, or None"""
    directory = os.environ.get("ATPU_TORCH_TRACE", "")
    if not directory:
        yield None
        return
    import torch
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(directory, exist_ok=True)
    path = os.path.join(directory, label + ".json")
    with torch.profiler.profile(activities=activities) as prof:
        yield path
    prof.export_chrome_trace(path)
