"""Threaded transcode farm: many tracks through one process's cards.

The port of the reference's ``audiotools_tpu/parallel/farm.py``.  A
small pool of threads (``run_jobs``, which the command line's tools
run too) takes jobs from one queue; each ``transcode`` job encodes a
source track into a destination file of any of the port's device
classes and may run a ``post`` hook in its worker thread, typically
``verify_track``: the new file decoded once, its checksums checked
(``trackverify``'s lossless check), its AccurateRip sums taken in the
same pass.  The host stages (WAVE
reads, FLAC emit, the decode scan and MD5) are C++ calls that release
the interpreter lock, so they can run while another worker's thread
enqueues its kernels.

Worker ``w`` runs on ``devices[w % len(devices)]``.  On a CUDA device
it runs every job inside ``torch.cuda.device(d)`` and
``torch.cuda.stream(s)``, where ``s`` is a stream the worker made for
itself, so two workers never queue behind one another on the default
stream.  The device reaches ``dispatch.open``, the destination's
``from_pcm`` and the decode as their ``device`` argument.
"""

from __future__ import annotations

import os
import queue as queue_mod
import threading

import numpy as np
import torch

from .. import dispatch
from .._device import resolve_devices

# farm width when the caller gives none: chosen from chip_smoke.py
# phase 20's rates and peak card memory at 1, 2, 4 and 6 workers on
# one card (PERF.md)
DEFAULT_WORKERS = 2


class FarmJob:
    """one transcode task: source -> destination file

    source      : an audio file object (with ``to_pcm()``), or a path
                  opened with ``dispatch.open`` on the worker's device
    dest_path   : output filename
    dest_class  : the class to encode as; its ``from_pcm`` takes
                  ``device=`` (FlacAudio, ALACAudio, TrueAudio,
                  ShortenAudio or WavPackAudio)
    compression : compression level string, or None for the default
    post        : optional callable(dest) run in the worker thread after
                  a successful encode; its return value lands in
                  FarmResult.post
    metadata    : optional MetaData written into the destination with
                  ``set_metadata`` after the encode"""

    def __init__(self, source, dest_path, dest_class,
                 compression=None, post=None, metadata=None):
        self.source = source
        self.dest_path = dest_path
        self.dest_class = dest_class
        self.compression = compression
        self.post = post
        self.metadata = metadata


class FarmResult:
    def __init__(self, job, dest=None, error=None, post=None):
        self.job = job
        self.dest = dest          # destination audio file (on success)
        self.error = error        # exception (on failure)
        self.post = post          # post hook's return value

    @property
    def ok(self):
        return self.error is None


def _run_job(job, device):
    source = job.source
    if isinstance(source, str):
        source = dispatch.open(source, device=device)
    reader = source.to_pcm()
    try:
        kwargs = {}
        if job.compression is not None:
            kwargs["compression"] = job.compression
        dest = job.dest_class.from_pcm(job.dest_path, reader, device=device,
                                       **kwargs)
    finally:
        reader.close()
    if job.metadata is not None:
        dest.set_metadata(job.metadata)
    post = job.post(dest) if job.post is not None else None
    return FarmResult(job, dest=dest, post=post)


def run_jobs(jobs, run, workers=None, devices=None, done=None,
             stop_on_error=False):
    """runs ``run(job, device)`` for each job in a pool of worker
    threads; returns a (result, error) pair for each job, in job order

    Worker ``w`` runs on ``devices[w % len(devices)]`` (resolved before
    any job runs: ``[torch.device("cuda")]`` when None; a card that is
    absent, or an index past the cards there are, raises), inside a CUDA
    stream of its own on a card.  A job that raises has its exception
    as its error, and its partial output, ``job.dest_path`` when it has
    one, is removed.  ``done(index, result, error)`` is called under a
    lock as each job ends, from the worker threads.  With
    ``stop_on_error`` no job starts after one has failed; those never
    run have (None, None).  workers: DEFAULT_WORKERS when None, at most
    one a job."""
    devices = resolve_devices(devices)
    jobs = list(jobs)
    if workers is None:
        workers = DEFAULT_WORKERS
    workers = max(min(workers, len(jobs)), 1)

    outcomes = [(None, None)] * len(jobs)
    work = queue_mod.Queue()
    for item in enumerate(jobs):
        work.put(item)
    lock = threading.Lock()
    failed = threading.Event()
    failures = []

    def run_queue(device):
        while not (stop_on_error and failed.is_set()):
            try:
                (idx, job) = work.get_nowait()
            except queue_mod.Empty:
                return
            try:
                outcome = (run(job, device), None)
            except Exception as err:  # noqa: BLE001 - reported per job
                dest_path = getattr(job, "dest_path", None)
                if dest_path is not None:
                    try:
                        os.unlink(dest_path)   # no partial outputs
                    except OSError:
                        pass
                outcome = (None, err)
                failed.set()
            outcomes[idx] = outcome
            if done is not None:
                with lock:
                    done(idx, *outcome)

    def worker(w):
        device = devices[w % len(devices)]
        try:
            if device.type != "cuda":
                run_queue(device)
                return
            with torch.cuda.device(device):
                stream = torch.cuda.Stream(device)
                with torch.cuda.stream(stream):
                    run_queue(device)
                stream.synchronize()
        except BaseException as err:  # noqa: B902 - re-raised by run_jobs
            failures.append(err)

    threads = [threading.Thread(target=worker, args=(w,), daemon=True)
               for w in range(workers)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if failures:
        raise failures[0]
    return outcomes


def transcode(jobs, workers=None, progress=None, devices=None):
    """runs FarmJobs through ``run_jobs``' pool of worker threads;
    returns their FarmResults in job order

    A failed job carries its exception in ``.error`` and its partial
    output is removed; the other jobs still run.  ``progress(done,
    total)`` is called under a lock after each job, from the worker
    threads.  workers and devices as in ``run_jobs``.  The encode gets
    no frame count ahead, as the reference farm's does."""
    jobs = list(jobs)
    count = [0]

    def done(_index, _result, _error):
        if progress is not None:
            count[0] += 1
            progress(count[0], len(jobs))

    outcomes = run_jobs(jobs, _run_job, workers, devices, done)
    return [result if error is None else FarmResult(job, error=error)
            for (job, (result, error)) in zip(jobs, outcomes)]


def verify_track(dest, chunk=65536, accuraterip=None):
    """decodes a freshly written file of any of the port's device
    classes once, on its device

    returns the samples as int32 [frames, channels]; raises on any
    stream error or checksum mismatch, and ValueError when the frame
    count is not the header's.  accuraterip: optional (is_first,
    is_last) pair; the AccurateRip V1 and V2 sums of the decoded
    samples are then taken in the same pass, on the same device, and
    the return value is (samples, (v1, v2))."""
    crc = None
    if accuraterip is not None:
        from ..accuraterip_checksum import AccurateRipCRC
        (is_first, is_last) = accuraterip
        crc = AccurateRipCRC(is_first, is_last, dest.sample_rate(),
                             dest.total_frames(), device=dest.device)
    reader = dest.to_pcm()
    out = []
    try:
        while True:
            framelist = reader.read(chunk)
            if framelist.frames == 0:
                break
            out.append(framelist.samples)
            if crc is not None:
                crc.update_array(framelist.samples)
    finally:
        reader.close()
    if out:
        samples = np.concatenate(out)
    else:
        samples = np.zeros((0, dest.channels()), dtype=np.int32)
    if samples.shape[0] != dest.total_frames():
        raise ValueError("incorrect PCM frame count")
    if crc is not None:
        return (samples, crc.checksums())
    return samples


# the FLAC name of verify_track, from when the farm wrote FLAC alone
verify_flac = verify_track
