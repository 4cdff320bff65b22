"""The encode driver: the album encoded to FLAC again and again through
the port's farm (``parallel/farm.run_jobs``, a CUDA stream a worker),
each job ``codecs/flac_enc_fast.encode_flac_fast`` with the
configuration's options, from an in-memory PCM reader into an in-memory
sink that the worker reuses.  Nothing goes to disk.

Each job keeps, for the check after the window, its STREAMINFO and the
bytes of frames that the card's analysis decided, drawn from the seed:
some of the final partial batch and a stripe across the full batches,
a dozen a track; and apart from those the short tail block, which the
program encodes on the host.
"""

from __future__ import annotations

import io
import threading

from ..harness.window import rate
from ..reference import batch, flac_decode, flac_enc
from . import common

WARM = "warm"


class EncodeDriver:
    """end-to-end metric: encode_Msamples_s"""

    def __init__(self, env):
        self.env = env
        self.config = env.config
        self.mix = env.mix
        self.options = dict(env.config["encode"])
        self.workers = env.mix["workers"]
        # the threads that warm up and then wait for the window to open
        self.parties = self.workers
        # the program's own batch depth unless a test sets a smaller one
        self.batch_frames = env.batch_frames

    def setup(self):
        import inspect

        from audiotools_tpu_torch.codecs import flac_enc_fast
        self.encode = flac_enc_fast.encode_flac_fast
        if self.batch_frames is None:
            self.batch_frames = inspect.signature(self.encode).parameters[
                "batch_frames"].default
        else:
            self.options["batch_frames"] = self.batch_frames
        self.album = common.album(self.env)
        self.warm = common.warm_frames(self.env, self.album)

    def _encode(self, samples, sink, device, timings=None):
        sink.seek(0)
        sink.truncate()
        return self.encode(sink, common.reader(samples, self.config),
                           device=device, timings=timings, **self.options)

    def run(self, window):
        env = self.env
        torch = env.torch
        sinks = threading.local()
        order = common.play_order(len(self.album))
        jobs = [WARM] * self.workers + list(enumerate(order))

        def sink():
            if not hasattr(sinks, "sink"):
                sinks.sink = io.BytesIO()
            return sinks.sink

        def run(job, device):
            if job == WARM:
                common.warm_then_arrive(
                    window, lambda: self._encode(self.warm, sink(), device))
                return None
            if not window.due():
                return None
            (k, i) = job
            samples = self.album.track(i)
            timings = {}
            start = common.now()
            with torch.profiler.record_function("portbench.encode_track"):
                offsets = self._encode(samples, sink(), device, timings)
            end = common.now()
            with sink().getbuffer() as buf:
                kept = self._keep(buf, offsets, common.job_rng(env, k))
            return dict(track=i, start=start, end=end, work=samples.size,
                        timings=timings, **kept)

        outcomes = common.run_farm(jobs, run, self.workers, env.device,
                                   window)
        records = [r for (r, e) in outcomes if r is not None]
        errors = [e for (_r, e) in outcomes if e is not None]
        return (records, errors)

    def _keep(self, buf, offsets, rng):
        """a finished job's STREAMINFO, its drawn frames [(index,
        bytes)] and its tail block (index, bytes)"""
        (info, _seektable, start) = flac_decode.parse_metadata(buf)
        n = len(offsets)
        ends = [o for (o, _f) in offsets[1:]] + [len(buf) - start]

        def frame(j):
            return (j, bytes(buf[start + offsets[j][0]:start + ends[j]]))
        (picks, tail) = self.picks(n, rng)
        return dict(info=info, frames=[frame(j) for j in picks],
                    tail=frame(tail))

    def picks(self, n, rng):
        """the frames of an n-frame stream that a job keeps for the check
        (the mix's ``check_partial_frames`` of its final partial batch
        and ``check_stripe_frames`` across its full batches), and its
        tail block"""
        return pick_frames(n, self.batch_frames, rng,
                           self.mix["check_partial_frames"],
                           self.mix["check_stripe_frames"])

    def end_to_end(self, records, start):
        return {"encode_Msamples_s": rate(records, start)}

    def layer_context(self, records):
        timings = {}
        for r in records:
            for (stage, secs) in r["timings"].items():
                timings[stage] = timings.get(stage, 0.0) + secs
        return {"encode_timings": timings}

    def release(self):
        self.warm = None

    def counters(self):
        """the encoder's counters, read before and after the window"""
        from audiotools_tpu_torch.codecs import flac_enc_fast
        return {"encode_batches": flac_enc_fast.wire_batches,
                "patched_batches": flac_enc_fast.patched_batches,
                "floor_frames": flac_enc_fast.floor_frames,
                "overflow_batches": flac_enc_fast.overflow_batches}

    def expected_info(self, track):
        """the STREAMINFO fields that track ``track``'s stream must hold"""
        config = self.config
        samples = self.album.track(track)
        block = self.options["block_size"]
        return dict(minimum_block_size=block, maximum_block_size=block,
                    sample_rate=config["sample_rate"],
                    channels=config["channels"],
                    bits_per_sample=config["bits_per_sample"],
                    total_frames=samples.shape[0],
                    md5=flac_decode.pcm_md5(samples,
                                            config["bits_per_sample"]))

    def reference_frames(self, wanted, single=False):
        """the reference encoder's bytes of the frames ``wanted``, [(track,
        frame index)], in the env's worker processes"""
        config = self.config
        stream = (config["sample_rate"], config["bits_per_sample"],
                  config["channels"])
        options = reference_option_fields(config)
        block = self.options["block_size"]
        jobs = [(stream, options, j,
                 self.album.track(i)[j * block:(j + 1) * block].astype(
                     "int64"), single) for (i, j) in wanted]
        return batch.run(flac_enc.encode_frame_job, jobs,
                         self.env.processes)

    def check(self, records):
        """the number compared: ``mismatches``, the kept frames (the
        card's and the tail blocks) whose bytes differ from the reference
        encoder's, and the STREAMINFOs that differ from the input's"""
        infos = {}
        wanted = []
        for r in records:
            if r["track"] not in infos:
                infos[r["track"]] = self.expected_info(r["track"])
            wanted.extend((r["track"], j) for (j, _d) in r["frames"])
            wanted.append((r["track"], r["tail"][0]))
        want = iter(self.reference_frames(wanted))
        frames = differing = tail_differing = info_differing = 0
        for r in records:
            info_differing += any(r["info"][k] != v for (k, v) in
                                  infos[r["track"]].items())
            for (_j, data) in r["frames"]:
                frames += 1
                differing += data != next(want)
            tail_differing += r["tail"][1] != next(want)
        return ([("mismatches", differing + tail_differing + info_differing,
                  0)],
                {"card_frames_checked": frames,
                 "card_frames_differing": differing,
                 "tail_frames_checked": len(records),
                 "tail_frames_differing": tail_differing,
                 "streaminfo_differing": info_differing})

    def control(self, jobs):
        """the records of the window's first ``jobs`` jobs as the control
        makes them: the frames a run keeps, encoded by the reference with
        its LPC analysis in plain float32 in the program's place (the
        STREAMINFO as it must be)"""
        order = common.play_order(len(self.album))
        block = self.options["block_size"]
        kept = []
        for k in range(jobs):
            i = order[k]
            n = -(-self.album.track(i).shape[0] // block)
            (picks, tail) = self.picks(n, common.job_rng(self.env, k))
            kept.append((i, picks + [tail]))
        made = iter(self.reference_frames(
            [(i, j) for (i, js) in kept for j in js], single=True))
        records = []
        for (i, js) in kept:
            frames = [(j, next(made)) for j in js]
            records.append(dict(track=i, info=self.expected_info(i),
                                frames=frames[:-1], tail=frames[-1]))
        return records


def pick_frames(n, batch_frames, rng, partial, stripe):
    """the frames of an n-frame stream kept for the check, drawn from
    ``rng``: ``partial`` of the final partial batch's and ``stripe``
    spaced evenly across the full batches from a drawn offset, each
    decided by the card's analysis; and the short tail block apart"""
    full = n - 1
    last_batch = (full // batch_frames) * batch_frames
    picks = set()
    if full > last_batch:
        span = full - last_batch
        picks.update((last_batch + rng.choice(
            span, min(partial, span), replace=False)).tolist())
    if last_batch:
        step = last_batch / stripe
        offset = rng.random() * step
        picks.update(min(int(offset + s * step), last_batch - 1)
                     for s in range(stripe))
    return (sorted(int(j) for j in picks), full)


def reference_option_fields(config):
    """the reference encoder's options for a configuration, as
    EncodingOptions' first fields: its FLAC options, and Rice
    parameters up to 14 (4-bit) at 16 bits or fewer, 30 (5-bit) above,
    as the format codes them"""
    e = config["encode"]
    return (e["block_size"], e["max_lpc_order"], False, e["mid_side"],
            e["exhaustive_model_search"], e["min_residual_partition_order"],
            e["max_residual_partition_order"],
            14 if config["bits_per_sample"] <= 16 else 30)


Driver = EncodeDriver
