"""Pipeline stage spans and torch profiler hooks.

The port's counterpart of the reference's ``utils/profiling``, with one
span API for every stage the port times:

* ``span(stage)``: the wall-clock seconds (``time.perf_counter``), the
  thread CPU seconds (``time.thread_time``) and a call count of a stage,
  added to the stage sink bound to the current thread (``collect(sink)``,
  for the length of a codec call).  While a torch profiler records, on
  any thread (a profile of all threads too), the span is also a
  ``torch.profiler.record_function`` range named
  ``atpu.<component>.<stage>``, so a trace puts the program's stages on
  the clock of the card's kernels; under ``ATPU_PROFILE`` it is also an
  NVTX range where the card is in use.  With no sink bound, no profile
  recording and ``ATPU_PROFILE`` unset, a span is the null context.
* ``named_scope(name)``: the same span with its range named ``name``,
  around a device stage (``flac.autocorr``, ``flac.levinson``, ...).
* ``StageTimers(name, component)``: the sink.  ``add(stage, seconds)``
  takes a stage timed another way (CUDA events), ``view(stages)`` gives
  the seconds of some stages (the codecs' ``timings``), and ``report``
  prints the reference's ``[ATPU_PROFILE]`` lines; ``stage_timer`` makes
  a sink whose report prints only when ``ATPU_PROFILE`` is set.
* ``trace(label)``: a ``torch.profiler.profile`` capture of every thread
  around a block, written as a Chrome trace to ``<dir>/<label>.json``
  when ``ATPU_TORCH_TRACE=<dir>`` is set (view it in chrome://tracing or
  Perfetto); nothing otherwise.
"""

from __future__ import annotations

import contextlib
import os
import sys
import threading
import time

# the sink of the current thread's codec call
_bound = threading.local()


def profiling_enabled():
    return os.environ.get("ATPU_PROFILE", "") not in ("", "0")


def _recording():
    """True while a torch profiler records, on any thread: the flag
    torch's Python side sets as a profile starts.  (The autograd check,
    ``torch._C._autograd._profiler_enabled()``, reads False on every
    thread of a profile started with ``profile_all_threads``.)"""
    module = sys.modules.get("torch.autograd.profiler")
    return module is not None and getattr(module, "_is_profiler_enabled",
                                          False)


class StageTimers:
    """a stage sink: wall-clock seconds, thread CPU seconds and calls of
    named pipeline stages

    A sink is added to from one thread at a time and ``report`` runs
    once the pipeline is done.  Thread CPU (``time.thread_time``) tells
    a stage that works the host's cores from one that waits (for the
    card, the interpreter lock, or behind another thread).  ``component``
    names the sink's spans' ranges, ``atpu.<component>.<stage>``; a
    ``quiet`` sink's report prints nothing.  Its spans push NVTX ranges
    when ATPU_PROFILE was set as it was made."""

    def __init__(self, name, component=None, quiet=False):
        self.name = name
        self.component = component
        self.quiet = quiet
        self.nvtx = profiling_enabled()
        self.totals = {}
        self.cpu = {}
        self.counts = {}
        self.t0 = time.perf_counter()
        self.c0 = time.process_time()

    def __call__(self, stage):
        """a span of ``stage`` added to this sink, whichever sink the
        thread has bound"""
        return _Span(stage, _range_name(self.component, stage), None, self)

    def add(self, stage, dt, cpu=0.0):
        self.totals[stage] = self.totals.get(stage, 0.0) + dt
        self.cpu[stage] = self.cpu.get(stage, 0.0) + cpu
        self.counts[stage] = self.counts.get(stage, 0) + 1

    def view(self, stages):
        """the wall-clock seconds of ``stages``, 0.0 for those never
        timed"""
        return {stage: self.totals.get(stage, 0.0) for stage in stages}

    def report(self, stream=None, extra=""):
        if self.quiet:
            return
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


def stage_timer(name, component=None):
    """a sink whose report prints only when ATPU_PROFILE is set"""
    return StageTimers(name, component, quiet=not profiling_enabled())


class collect:
    """binds ``sink`` to the current thread for the block: the spans the
    thread opens in it add to ``sink``; the binding before is restored
    after it"""

    __slots__ = ("sink", "previous")

    def __init__(self, sink):
        self.sink = sink

    def __enter__(self):
        self.previous = getattr(_bound, "sink", None)
        _bound.sink = self.sink
        return self.sink

    def __exit__(self, *exc):
        _bound.sink = self.previous
        return False


def _range_name(component, stage):
    return ("atpu.%s.%s" % (component, stage) if component
            else "atpu." + stage)


class _Span:
    """a stage's clocks into a sink, and its ranges while a profiler
    records or ATPU_PROFILE is set"""

    __slots__ = ("stage", "name", "args", "sink", "start", "cpu", "record",
                 "nvtx")

    def __init__(self, stage, name, args, sink):
        self.stage = stage
        self.name = name
        self.args = args
        self.sink = sink

    def __enter__(self):
        self.record = self.nvtx = None
        if _recording():
            import torch
            self.record = torch.profiler.record_function(self.name,
                                                         self.args)
            self.record.__enter__()
        if (self.sink.nvtx if self.sink is not None
                else profiling_enabled()):
            import torch
            if torch.cuda.is_initialized():
                self.nvtx = torch.cuda.nvtx
                self.nvtx.range_push(self.name)
        if self.sink is not None:
            self.start = time.perf_counter()
            self.cpu = time.thread_time()
        return self

    def __exit__(self, *exc):
        if self.sink is not None:
            dt = time.perf_counter() - self.start
            self.sink.add(self.stage, dt, time.thread_time() - self.cpu)
        if self.nvtx is not None:
            self.nvtx.range_pop()
        if self.record is not None:
            self.record.__exit__(*exc)
        return False


_NULL_SCOPE = contextlib.nullcontext()


def span(stage, component=None, args=None):
    """a span of ``stage`` (module docstring): its range is named
    ``atpu.<component>.<stage>``, the component the bound sink's unless
    given; ``args``, a string, goes to the range"""
    sink = getattr(_bound, "sink", None)
    if sink is None and not _recording() and not profiling_enabled():
        return _NULL_SCOPE
    if component is None and sink is not None:
        component = sink.component
    return _Span(stage, _range_name(component, stage), args, sink)


def named_scope(name):
    """a span around a device stage, its range and its stage named
    ``name``"""
    sink = getattr(_bound, "sink", None)
    if sink is None and not _recording() and not profiling_enabled():
        return _NULL_SCOPE
    return _Span(name, name, None, sink)


@contextlib.contextmanager
def trace(label="atpu"):
    """captures a torch profiler trace of the block (the CPU of every
    thread where torch can profile them all, and the card where CUDA is
    available) into ``<dir>/<label>.json`` when ATPU_TORCH_TRACE=<dir> is
    set; yields the path, or None"""
    directory = os.environ.get("ATPU_TORCH_TRACE", "")
    if not directory:
        yield None
        return
    import torch
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    kwargs = {}
    try:
        kwargs["experimental_config"] = (
            torch._C._profiler._ExperimentalConfig(profile_all_threads=True))
    except (AttributeError, TypeError):
        pass        # an older torch: the calling thread alone
    os.makedirs(directory, exist_ok=True)
    path = os.path.join(directory, label + ".json")
    with torch.profiler.profile(activities=activities, **kwargs) as prof:
        yield path
    prof.export_chrome_trace(path)
