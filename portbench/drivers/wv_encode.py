"""The WavPack encode driver: the album encoded to WavPack again and
again through the port's farm (``parallel/farm.run_jobs``, a CUDA stream
a worker), each job ``formats/wavpack.write_wavpack`` (what
``WavPackAudio.from_pcm`` calls) at the configuration's compression,
from an in-memory PCM reader into an in-memory sink that the worker
reuses.  Nothing goes to disk.

Each job keeps, for the check after the window, blocks drawn from the
seed: its first block, which starts from the encoder's initial state;
the mix's ``check_stripe_blocks`` spaced across the track, each to be
encoded again from the state the stream stores in it; its final short
block; the block after each of those, whose stored state must be the
state the reference ends the block in; and the stream's MD5 block.
"""

from __future__ import annotations

import hashlib
import io
import threading

from ..harness.window import rate
from ..reference import batch, wavpack_dec, wavpack_enc
from . import common

WARM = "warm"
# the plain reference's passes for the configuration's pass count
RECIPES = {5: wavpack_enc.STANDARD}


class WvEncodeDriver:
    """end-to-end metric: encode_Msamples_s"""

    def __init__(self, env):
        self.env = env
        self.config = env.config
        self.mix = env.mix
        self.workers = env.mix["workers"]
        # the threads that warm up and then wait for the window to open
        self.parties = self.workers
        self.recipe = RECIPES[env.config["encode"]["correlation_passes"]]

    def setup(self):
        from audiotools_tpu_torch.formats import wavpack
        self.write = wavpack.write_wavpack
        self.album = common.album(self.env)
        self.warm = common.warm_frames(self.env, self.album)

    def _encode(self, samples, sink, device, timings=None):
        sink.seek(0)
        sink.truncate()
        self.write(sink, common.reader(samples, self.config),
                   compression=self.config["level"],
                   total_pcm_frames=samples.shape[0], device=device,
                   timings=timings)

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
            with torch.profiler.record_function("portbench.wv_encode_track"):
                self._encode(samples, sink(), device, timings)
            end = common.now()
            with sink().getbuffer() as buf:
                kept = self._keep(buf, common.job_rng(env, k))
            return dict(track=i, start=start, end=end, work=samples.size,
                        timings=timings, **kept)

        outcomes = common.run_farm(jobs, run, self.workers, env.device,
                                   window)
        records = [r for (r, e) in outcomes if r is not None]
        errors = [e for (_r, e) in outcomes if e is not None]
        return (records, errors)

    def _keep(self, buf, rng):
        """a finished job's kept blocks {index: bytes}, the indices to
        check, its block count and its MD5 block"""
        blocks = wavpack_enc.split_blocks(buf)
        audio = len(blocks) - 1
        checked = self.picks(audio, rng)
        keep = set()
        for j in checked:
            keep.update(range(self.resume_from(blocks, j), j + 2))
        return dict(blocks={j: blocks[j] for j in sorted(keep)
                            if j < audio},
                    checked=checked, audio_blocks=audio,
                    md5_block=blocks[-1])

    def picks(self, n, rng):
        """the blocks of an n-block stream checked: its first, the mix's
        ``check_stripe_blocks`` spaced evenly over its inner blocks from
        a drawn offset, and its last"""
        inner = n - 2
        stripe = min(self.mix["check_stripe_blocks"], max(inner, 0))
        picks = {0, n - 1}
        if stripe:
            step = inner / stripe
            offset = rng.random() * step
            picks.update(1 + min(int(offset + s * step), inner - 1)
                         for s in range(stripe))
        return sorted(picks)

    @staticmethod
    def resume_from(blocks, j):
        """the block the reference starts from to check block j: j
        itself where it stores the whole state, else the latest one
        before it that does (the first block always starts afresh)"""
        while j > 0 and not wavpack_enc.resumable(blocks[j]):
            j -= 1
        return j

    def end_to_end(self, records, start):
        return {"encode_Msamples_s": rate(records, start)}

    def layer_context(self, records):
        timings = {}
        for r in records:
            for (stage, secs) in r["timings"].items():
                timings[stage] = timings.get(stage, 0.0) + secs
        return {"wv_encode_timings": timings}

    def release(self):
        self.warm = None

    def counters(self):
        """the encoder's counters, read before and after the window: the
        frames and blocks encoded, the frames correlated on the device
        and on the host, and wv_corr's launches (a program without one
        leaves it out)"""
        from audiotools_tpu_torch.codecs import wavpack
        from audiotools_tpu_torch.ops import wv_scan
        out = {"wv_corr_launches": getattr(wv_scan.run_pass_chain,
                                           "launches", 0)}
        for name in ("frames_encoded", "blocks_encoded", "device_frames",
                     "host_frames"):
            if hasattr(wavpack, name):
                out["wv_" + name] = getattr(wavpack, name)
        return out

    def check_jobs(self, records):
        """the plain reference's jobs for the records' checked blocks:
        (the album's frames of blocks s..j and of the block after j, the
        stream's blocks s..j, the block after j or None, whether s is the
        stream's first, the stream's frames, the sample rate, the bits,
        the passes), s the block the reference starts from"""
        config = self.config
        jobs = []
        for r in records:
            samples = self.album.track(r["track"])
            for j in r["checked"]:
                s = self.resume_from(r["blocks"], j)
                run = [r["blocks"][k] for k in range(s, j + 1)]
                after = r["blocks"].get(j + 1)
                first = wavpack_enc.header(run[0])["index"]
                last = wavpack_enc.header(after or run[-1])
                end = last["index"] + last["samples"]
                jobs.append((samples[first:end], run, after, s == 0,
                             samples.shape[0], config["sample_rate"],
                             config["bits_per_sample"], self.recipe))
        return jobs

    def check(self, records):
        """the numbers compared: ``mismatches``, the checked blocks whose
        bytes differ from the plain reference encoder's, whose first frame
        or length is not the configuration's block size's, the states stored in the next blocks
        that differ from the reference's, and the MD5 blocks that differ
        from the input's; ``samples_wrong``, the checked blocks' samples
        that the plain decoder does not give back as the album's"""
        out = batch.run(wavpack_dec.check_run, self.check_jobs(records),
                        self.env.processes)
        counts = dict.fromkeys(("blocks_checked", "blocks_differing",
                                "states_checked", "states_differing",
                                "samples_checked", "samples_wrong"), 0)
        for result in out:
            for (key, value) in result.items():
                counts[key] += value
        block = self.config["encode"]["block_size"]
        layout = 0
        md5_differing = 0
        md5s = {}
        for r in records:
            for (j, data) in r["blocks"].items():
                h = wavpack_enc.header(data)
                n = h["samples"]
                layout += h["index"] != j * block or (
                    n != block if j < r["audio_blocks"] - 1
                    else not 0 < n <= block)
            i = r["track"]
            if i not in md5s:
                samples = self.album.track(i)
                md5s[i] = wavpack_enc.final_block(
                    hashlib.md5(wavpack_enc.pcm_bytes(
                        samples, self.config["bits_per_sample"])).digest(),
                    samples.shape[0], self.config["sample_rate"],
                    self.config["bits_per_sample"])
            md5_differing += r["md5_block"] != md5s[i]
        counts["block_layouts_differing"] = layout
        counts["md5_blocks_differing"] = md5_differing
        mismatches = (counts["blocks_differing"] + counts["states_differing"]
                      + layout + md5_differing)
        return ([("mismatches", mismatches, 0),
                 ("samples_wrong", counts["samples_wrong"], 0)], counts)

    def control(self, jobs):
        """the records of the window's first ``jobs`` jobs as the control
        makes them: the program's own encode with one step of the format
        broken, each pass's weights carried to the next block unrounded
        (``CorrelationParameters.update_weights`` without store_weight
        and restore_weight), on this thread"""
        from audiotools_tpu_torch.ref import wavpack as program_ref
        params = program_ref.CorrelationParameters
        rounded = params.update_weights

        def unrounded(self_, weights):
            self_.weights = [int(w) for w in weights]
        params.update_weights = unrounded
        try:
            order = common.play_order(len(self.album))
            sink = io.BytesIO()
            records = []
            for k in range(jobs):
                i = order[k]
                samples = self.album.track(i)
                self._encode(samples, sink, self.env.device)
                with sink.getbuffer() as buf:
                    kept = self._keep(buf, common.job_rng(self.env, k))
                records.append(dict(track=i, **kept))
            return records
        finally:
            params.update_weights = rounded


Driver = WvEncodeDriver
