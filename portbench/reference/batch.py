"""The plain reference over many frames at once: ``run(fn, jobs,
processes)`` maps a top-level function of the reference over the jobs in
that many worker processes, started fresh (``spawn``: they import the
reference and NumPy, nothing of the program or of torch) and each
limited to one thread of arithmetic.  The pool is shut down, and every
worker waited for, before it returns."""

from __future__ import annotations

import multiprocessing
import os
from concurrent.futures import ProcessPoolExecutor

# the libraries' thread counts, held at one in each worker
THREAD_VARS = ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS", "MKL_NUM_THREADS")


def run(fn, jobs, processes):
    """[fn(job) for job in jobs], in ``processes`` workers where that is
    more than one"""
    jobs = list(jobs)
    if processes <= 1 or len(jobs) < 2:
        return [fn(job) for job in jobs]
    saved = {k: os.environ.get(k) for k in THREAD_VARS}
    os.environ.update(dict.fromkeys(THREAD_VARS, "1"))
    try:
        context = multiprocessing.get_context("spawn")
        with ProcessPoolExecutor(min(processes, len(jobs)),
                                 mp_context=context) as pool:
            return list(pool.map(fn, jobs, chunksize=max(
                1, len(jobs) // (4 * processes))))
    finally:
        for (k, v) in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
