"""The traced run's reading of the device: a ``torch.profiler`` trace of
the window, reduced to the seconds in which an operation ran on the
card, the device operations that took most time, the longest idle gaps
named by what the host was doing (the benchmark's own spans and the
port's ``named_scope`` ranges), and each kernel's device time.  Also the
counting of the bytes each launch of a kernel moves, for the kernels
whose roofline share a metric reports."""

from __future__ import annotations

import threading
import time
import weakref

# gaps on the device shorter than this are summed under one name in the
# breakdown; of the longer ones, the NAMED longest are named by the host
MIN_GAP_S = 1e-4
NAMED = 400
# entries in each list of the breakdown
TOP = 10


def _device_op(e, cuda):
    """whether a profiler event is an operation on the card (a kernel, a
    copy or a fill), not an annotation or a host call"""
    if e.device_type() != cuda or e.is_user_annotation():
        return False
    kind = str(e.activity_type()).lower() if hasattr(
        e, "activity_type") else ""
    return "annotation" not in kind


def union_seconds(intervals):
    """the length of the union of (start, end) intervals, and the
    merged intervals, in the intervals' unit"""
    merged = []
    for (a, b) in sorted(intervals):
        if merged and a <= merged[-1][1]:
            if b > merged[-1][1]:
                merged[-1][1] = b
        else:
            merged.append([a, b])
    return (sum(b - a for (a, b) in merged), merged)


def gaps(merged, start, end):
    """the idle intervals of [start, end] between merged busy intervals"""
    out = []
    at = start
    for (a, b) in merged:
        if a > at:
            out.append((at, min(a, end)))
        at = max(at, b)
    if at < end:
        out.append((at, end))
    return [(a, b) for (a, b) in out if b > a]


class HostSpans:
    """the host's spans of the trace (the benchmark's and the port's
    ranges, and the torch operations under them), each thread's kept
    apart, to name what the host was doing over a gap on the device"""

    def __init__(self, spans):
        import numpy as np
        self.np = np
        rows_by_thread = {}
        for (name, a, b, thread, annotation) in spans:
            rows_by_thread.setdefault(thread, []).append(
                (a, b, name, annotation))
        self.threads = [
            (np.array([r[0] for r in rows], dtype=np.int64),
             np.array([r[1] for r in rows], dtype=np.int64),
             [r[2] for r in rows],
             np.array([r[3] for r in rows], dtype=bool))
            for rows in rows_by_thread.values()]

    def name(self, gap):
        """each thread's innermost range over the gap's midpoint, with
        the innermost operation under it ("range: op"); the threads'
        names joined by " | " """
        np = self.np
        never = np.iinfo(np.int64).max
        mid = (gap[0] + gap[1]) // 2
        labels = set()
        for (starts, ends, names, annotation) in self.threads:
            length = np.where((starts <= mid) & (ends >= mid),
                              ends - starts, never)
            parts = []
            for kind in (annotation, ~annotation):
                pick = np.where(kind, length, never)
                i = int(np.argmin(pick))
                if pick[i] != never:
                    parts.append(names[i])
            if parts:
                labels.add(": ".join(parts))
        return " | ".join(sorted(labels)) if labels else "no host span"


def reduce_events(events, cuda, start_ns, end_ns):
    """a trace's events, clipped to [start_ns, end_ns]: the summary the
    per-layer readers and the breakdown take"""
    busy = []
    by_name = {}
    spans = []
    for e in events:
        a = e.start_ns()
        b = a + e.duration_ns()
        if b <= start_ns or a >= end_ns:
            continue
        if _device_op(e, cuda):
            (a, b) = (max(a, start_ns), min(b, end_ns))
            busy.append((a, b))
            (count, secs) = by_name.get(e.name(), (0, 0.0))
            by_name[e.name()] = (count + 1, secs + (b - a) / 1e9)
        elif e.device_type() != cuda:
            spans.append((e.name(), a, b, e.start_thread_id(),
                          bool(e.is_user_annotation())))
    (busy_ns, merged) = union_seconds(busy)
    idle = gaps(merged, start_ns, end_ns)
    short = [g for g in idle if g[1] - g[0] < MIN_GAP_S * 1e9]
    longer = sorted((g for g in idle if g[1] - g[0] >= MIN_GAP_S * 1e9),
                    key=lambda g: g[0] - g[1])
    host = HostSpans(spans)
    named = {}
    for g in longer[:NAMED]:
        name = host.name(g)
        named[name] = named.get(name, 0.0) + (g[1] - g[0]) / 1e9
    for (label, group) in (("gaps under %g ms" % (MIN_GAP_S * 1e3), short),
                           ("shorter gaps, not named", longer[NAMED:])):
        if group:
            named[label] = sum(b - a for (a, b) in group) / 1e9
    top_ops = sorted(((name, secs) for (name, (_n, secs)) in
                      by_name.items()), key=lambda x: -x[1])[:TOP]
    top_gaps = sorted(named.items(), key=lambda x: -x[1])[:TOP]
    return dict(window_s=(end_ns - start_ns) / 1e9, busy_s=busy_ns / 1e9,
                kernels={name: dict(count=n, seconds=s)
                         for (name, (n, s)) in by_name.items()},
                breakdown=dict(device_ops=[[n[:200], s] for (n, s) in
                                           top_ops],
                               idle_gaps=[[n[:200], s] for (n, s) in
                                          top_gaps]))


def _is_copy(name):
    low = name.lower()
    return low.startswith("memcpy") or low.startswith("memset")


def kernel_launches(kernels):
    """kernel launches among the trace's device operations (copies and
    fills left out)"""
    return sum(v["count"] for (name, v) in kernels.items()
               if not _is_copy(name))


class Tracer:
    """a profiler over the window: ``start`` and ``stop`` from the
    thread that runs the cell, ``summary`` after the stop"""

    def __init__(self, torch):
        self.torch = torch
        self.prof = None
        self.start_ns = self.end_ns = None

    def start(self):
        from torch.profiler import ProfilerActivity, profile
        torch = self.torch
        kwargs = {}
        try:
            kwargs["experimental_config"] = (
                torch._C._profiler._ExperimentalConfig(
                    profile_all_threads=True))
        except (AttributeError, TypeError):
            pass        # an older torch: spans of the main thread only
        self.prof = profile(activities=[ProfilerActivity.CPU,
                                        ProfilerActivity.CUDA], **kwargs)
        self.prof.start()
        self.start_ns = time.time_ns()

    def stop(self):
        self.torch.cuda.synchronize()
        self.end_ns = time.time_ns()
        self.prof.stop()

    def summary(self):
        cuda = self.torch._C._autograd.DeviceType.CUDA
        events = self.prof.profiler.kineto_results.events()
        out = reduce_events(events, cuda, self.start_ns, self.end_ns)
        out["launches"] = kernel_launches(out["kernels"])
        self.prof = None
        return out


class KernelBytes:
    """counts the bytes each launch of some kernel bindings must move:
    each input byte read once and each output byte written once, from
    the launch's tensors.  ``counted`` maps a binding's name to (its
    module, the function that counts a launch's bytes); the roofline
    metrics' files name them.  Installed over the bindings for the
    traced window only, and taken away after it."""

    def __init__(self, counted):
        self.counted = counted
        self.saved = {}
        self.bytes = dict.fromkeys(counted, 0)
        self.lock = threading.Lock()

    def install(self):
        for (name, (module, count)) in self.counted.items():
            original = getattr(module, name)
            self.saved[name] = (module, original)
            setattr(module, name, self._wrap(name, original, count))

    def remove(self):
        for (name, (module, original)) in self.saved.items():
            setattr(module, name, original)
        self.saved = {}

    def _wrap(self, name, original, count):
        # tensors a launch shares with an earlier one (a batch's words,
        # read by every bucket's launch) are counted once
        seen = weakref.WeakValueDictionary()

        def launch(*args):
            n = count(args, seen)
            with self.lock:
                self.bytes[name] += n
            return original(*args)
        return launch
