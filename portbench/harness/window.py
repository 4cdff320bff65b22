"""The measured window and the arithmetic of its end-to-end metrics."""

from __future__ import annotations

import statistics
import threading
import time

# seconds a thread waits for the others at the window's opening before
# the run is given up as stuck
WAIT_S = 900.0


class Window:
    """the window's clock, shared by the driver's threads: each worker
    warms up, then ``arrive``s; the thread that runs the cell ``open``s
    the window once all have arrived (running ``on_open`` first, while
    every worker waits), and ``due`` says whether a new job or request
    may still start.  Jobs started while it is due finish and count."""

    def __init__(self, seconds, parties, on_open=None):
        self.seconds = seconds
        self.ready = threading.Barrier(parties + 1, timeout=WAIT_S)
        self.go = threading.Event()
        self.on_open = on_open
        self.start = None

    def arrive(self):
        """a worker's: waits until the window opens"""
        self.ready.wait()
        if not self.go.wait(WAIT_S):
            raise RuntimeError("the window never opened")

    def fail(self):
        """a worker's, when its warm-up raised: no window will open"""
        self.ready.abort()

    def open(self):
        self.ready.wait()
        if self.on_open is not None:
            self.on_open()
        self.start = time.perf_counter()
        self.go.set()

    def due(self):
        """whether a job may start: the window is open and its seconds
        have not passed"""
        return (self.start is not None and
                time.perf_counter() - self.start < self.seconds)


def rate(records, start, unit=1e6):
    """work over time: the sum of the records' ``work`` over the time from
    the window's start to the end of the last record, in ``unit``s a
    second; None with no record"""
    if not records:
        return None
    end = max(r["end"] for r in records)
    return sum(r["work"] for r in records) / (end - start) / unit


def percentile(values, q):
    """the q-th percentile (0-100) of all values, by linear
    interpolation between the closest ranks"""
    if not values:
        return None
    if len(values) == 1:
        return float(values[0])
    return statistics.quantiles(values, n=100, method="inclusive")[q - 1]

