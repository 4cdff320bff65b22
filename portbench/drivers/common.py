"""What the drivers share: the album, its FLAC files, the farm's jobs
run in a thread beside the window, and the record of one job."""

from __future__ import annotations

import os
import threading
import time

import numpy as np

from ..harness.album import make_album, seed_bits

# passes of the album a run may ask for: far more than any window holds
MAX_PASSES = 1000


def album(env):
    """the album for the run's seed: the configuration's shape, or the
    mix's where it gives one"""
    t0 = now()
    out = make_album(env.torch, env.config, env.seed, env.device,
                     album=env.album_shape or env.mix.get("album"))
    env.notes["album_s"] = now() - t0
    return out


def warm_frames(env, album_):
    """a warm-up track's frames: the mix's full and partial batches of
    blocks and a short tail block, cut from the album's start (the whole
    album where it is shorter)"""
    block = env.config["encode"]["block_size"]
    want = sum(env.mix["warm_blocks"]) * block + block // 3
    return album_.samples[:min(want, album_.samples.shape[0])]


def play_order(n):
    """the album's track indices pass after pass, each pass reversed from
    the last, so that the same track never runs twice in a row"""
    out = []
    for p in range(MAX_PASSES):
        out.extend(range(n) if p % 2 == 0 else range(n - 1, -1, -1))
    return out


def reader(samples, config):
    from audiotools_tpu_torch import pcm
    return pcm.reader_from_array(samples, config["bits_per_sample"],
                                 config["sample_rate"])


def write_flac_files(env, album_, workers, warm=True):
    """the album's tracks, and with ``warm`` a warm-up track, written as
    FLAC files by the port's ``FlacAudio.from_pcm`` (level 8, with its
    SEEKTABLE) under the run's work directory on ``workers`` farm
    workers; returns (the tracks' paths, the warm-up file's path)"""
    t0 = now()
    from audiotools_tpu_torch.formats.flac import FlacAudio
    from audiotools_tpu_torch.parallel import farm
    paths = [os.path.join(env.workdir, "track%02d.flac" % i)
             for i in range(len(album_))]
    jobs = [(paths[i], album_.track(i)) for i in range(len(album_))]
    warm_path = None
    if warm:
        warm_path = os.path.join(env.workdir, "warm.flac")
        jobs.append((warm_path, warm_frames(env, album_)))

    def run(job, device):
        (path, samples) = job
        FlacAudio.from_pcm(path, reader(samples, env.config),
                           compression=env.config["level"],
                           total_pcm_frames=samples.shape[0],
                           device=device)
    for (_result, error) in farm.run_jobs(jobs, run, workers=workers,
                                          devices=[env.device]):
        if error is not None:
            raise error
    env.notes["write_files_s"] = now() - t0
    env.notes["files_bytes"] = sum(os.path.getsize(p) for p in paths)
    return (paths, warm_path)


def run_farm(jobs, run, workers, device, window):
    """``farm.run_jobs`` over ``jobs`` in a thread of its own while this
    thread opens the window; returns its (result, error) pairs"""
    from audiotools_tpu_torch.parallel import farm
    out = {}

    def target():
        try:
            out["outcomes"] = farm.run_jobs(jobs, run, workers=workers,
                                            devices=[device])
        except BaseException as err:   # noqa: B902 - re-raised below
            out["error"] = err
            window.fail()

    thread = threading.Thread(target=target, daemon=True)
    thread.start()
    try:
        window.open()
    except threading.BrokenBarrierError:
        thread.join()
        # a warm-up raised: its error is the one to report
        for (_result, error) in out.get("outcomes", []):
            if error is not None and not isinstance(
                    error, threading.BrokenBarrierError):
                raise error
        raise
    thread.join()
    if "error" in out:
        raise out["error"]
    return out["outcomes"]


def warm_then_arrive(window, warm):
    """a worker's warm-up, then its wait for the window.  A warm-up that
    fails is the program's failure: the worker still arrives, so that the
    window opens, and the error is raised after it, to be counted among
    the run's failures"""
    error = None
    try:
        warm()
    except Exception as err:  # noqa: BLE001 - raised after the arrival
        error = err
    except BaseException:
        window.fail()
        raise
    window.arrive()
    if error is not None:
        raise error


def decode_counters():
    """the decoder's counters, read before and after the window: device
    batches (one ``flac_synth`` launch each), host chunks and
    ``rice_decode`` launches"""
    from audiotools_tpu_torch.codecs import flac_dec
    from audiotools_tpu_torch.ops import flac_synth, rice_decode
    return {"decode_batches": getattr(flac_synth.synthesize, "launches", 0),
            "host_chunks": flac_dec.host_chunks,
            "rice_decode_launches": getattr(
                rice_decode.decode_partitions, "launches", 0)}


def job_rng(env, k):
    """the generator of job k's checks, from the run's seed"""
    return np.random.default_rng(seed_bits(env.seed, 100 + k))


def now():
    return time.perf_counter()
