"""Threaded transcode farm: many tracks through one process's cards.

The port of the reference's ``audiotools_tpu/parallel/farm.py``.  A
small pool of threads takes jobs from one queue; each job encodes a
source track into a destination file and may run a ``post`` hook in
its worker thread, typically ``verify_flac``: the new file decoded
once, its STREAMINFO MD5 checked (``trackverify``'s lossless check),
its AccurateRip sums taken in the same pass.  The host stages (WAVE
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
                  ``device=`` (``formats.flac.FlacAudio``)
    compression : compression level string, or None for the default
    post        : optional callable(dest) run in the worker thread after
                  a successful encode; its return value lands in
                  FarmResult.post
    metadata    : must be None: metadata (``meta/``) is not ported"""

    def __init__(self, source, dest_path, dest_class,
                 compression=None, post=None, metadata=None):
        if metadata is not None:
            raise NotImplementedError(
                "FarmJob(metadata=...): the reference's meta/ (MetaData "
                "and set_metadata) is not ported to audiotools_tpu_torch")
        self.source = source
        self.dest_path = dest_path
        self.dest_class = dest_class
        self.compression = compression
        self.post = post
        self.metadata = None


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
    post = job.post(dest) if job.post is not None else None
    return FarmResult(job, dest=dest, post=post)


def transcode(jobs, workers=None, progress=None, devices=None):
    """runs FarmJobs through a pool of worker threads; returns their
    FarmResults in job order

    A failed job carries its exception in ``.error`` and its partial
    output is removed; the other jobs still run.  ``progress(done,
    total)`` is called under a lock after each job, from the worker
    threads.  workers: DEFAULT_WORKERS when None, at most one a job.
    devices: the devices to spread the workers over,
    ``[torch.device("cuda")]`` when None; a card that is absent, or an
    index past the cards there are, raises before any job runs."""
    devices = resolve_devices(devices)
    jobs = list(jobs)
    if workers is None:
        workers = DEFAULT_WORKERS
    workers = max(min(workers, len(jobs)), 1)

    results = [None] * len(jobs)
    work = queue_mod.Queue()
    for item in enumerate(jobs):
        work.put(item)
    done = [0]
    lock = threading.Lock()
    failures = []

    def run_queue(device):
        while True:
            try:
                (idx, job) = work.get_nowait()
            except queue_mod.Empty:
                return
            try:
                results[idx] = _run_job(job, device)
            except Exception as err:  # noqa: BLE001 - reported per job
                try:
                    os.unlink(job.dest_path)   # no partial outputs
                except OSError:
                    pass
                results[idx] = FarmResult(job, error=err)
            if progress is not None:
                with lock:
                    done[0] += 1
                    progress(done[0], len(jobs))

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
        except BaseException as err:  # noqa: B902 - re-raised by transcode
            failures.append(err)

    threads = [threading.Thread(target=worker, args=(w,), daemon=True)
               for w in range(workers)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if failures:
        raise failures[0]
    return results


def verify_flac(dest, chunk=65536, accuraterip=None):
    """decodes a freshly written FlacAudio once, on its device

    returns the samples as int32 [frames, channels]; raises on any
    stream error or STREAMINFO MD5 mismatch.  accuraterip: optional
    (is_first, is_last) pair; the AccurateRip V1 and V2 sums of the
    decoded samples are then taken in the same pass, on the same
    device, and the return value is (samples, (v1, v2))."""
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
    if crc is not None:
        return (samples, crc.checksums())
    return samples
