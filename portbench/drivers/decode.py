"""The decode driver: the album's FLAC files, written once in set-up by
the port's ``FlacAudio.from_pcm``, each decoded whole through
``codecs/flac_dec.TorchFlacDecoder.read`` on the port's farm workers, as
``trackverify`` runs it; the decoder checks each file's MD5 at its end.

Each job keeps, for the check after the window, the frames it decoded
and a copy of the reads that cover positions drawn from the seed."""

from __future__ import annotations

import numpy as np

from ..harness.window import rate
from ..reference import batch, flac_decode
from . import common

WARM = "warm"


class DecodeDriver:
    """end-to-end metric: decode_Msamples_s"""

    def __init__(self, env):
        self.env = env
        self.config = env.config
        self.mix = env.mix
        self.workers = env.mix["workers"]
        self.parties = self.workers

    def setup(self):
        from audiotools_tpu_torch.codecs.flac_dec import TorchFlacDecoder
        self.decoder = TorchFlacDecoder
        self.album = common.album(self.env)
        (self.paths, self.warm_path) = common.write_flac_files(
            self.env, self.album, self.workers)

    def _decode(self, path, device, keep=()):
        """decodes a file whole; returns (frames, kept reads, timings)"""
        dec = self.decoder(path, device=device)
        kept = []
        at = 0
        keep = sorted(keep)
        try:
            while True:
                frames = dec.read(self.mix["read_frames"])
                n = frames.frames
                if n == 0:
                    break
                if keep and keep[0] < at + n:
                    kept.append((at, np.array(frames.samples)))
                    keep = [p for p in keep if p >= at + n]
                at += n
        finally:
            dec.close()
        return (at, kept, dec.timings)

    def _positions(self, k, track):
        """the frames whose reads job k keeps for the check, drawn from
        the seed"""
        length = self.album.bounds[track][1] - self.album.bounds[track][0]
        return common.job_rng(self.env, k).integers(
            0, length, self.mix["check_reads_per_track"])

    def run(self, window):
        env = self.env
        torch = env.torch
        order = common.play_order(len(self.album))
        jobs = [WARM] * self.workers + list(enumerate(order))

        def run(job, device):
            if job == WARM:
                common.warm_then_arrive(
                    window, lambda: self._decode(self.warm_path, device))
                return None
            if not window.due():
                return None
            (k, i) = job
            keep = self._positions(k, i)
            start = common.now()
            with torch.profiler.record_function("portbench.decode_track"):
                (frames, kept, timings) = self._decode(self.paths[i], device,
                                                       keep)
            end = common.now()
            return dict(track=i, start=start, end=end,
                        work=frames * self.config["channels"],
                        frames=frames, reads=kept, timings=timings)

        outcomes = common.run_farm(jobs, run, self.workers, env.device,
                                   window)
        records = [r for (r, e) in outcomes if r is not None]
        errors = [e for (_r, e) in outcomes if e is not None]
        return (records, errors)

    def end_to_end(self, records, start):
        return {"decode_Msamples_s": rate(records, start)}

    def layer_context(self, records):
        timings = {}
        for r in records:
            for (stage, secs) in r["timings"].items():
                timings[stage] = timings.get(stage, 0.0) + secs
        return {"decode_timings": timings}

    def counters(self):
        return common.decode_counters()

    def release(self):
        pass

    def check(self, records):
        """the number compared: ``samples_wrong``, the samples of the kept
        reads that differ from the album the benchmark made, and the
        samples a track decoded short or long lacks or adds"""
        differing = missing = samples = 0
        channels = self.config["channels"]
        for r in records:
            track = self.album.track(r["track"])
            missing += abs(r["frames"] - track.shape[0]) * channels
            for (at, got) in r["reads"]:
                want = track[at:at + got.shape[0]]
                samples += got.size
                if want.shape != got.shape:
                    differing += got.size
                else:
                    differing += int(np.count_nonzero(want != got))
        return ([("samples_wrong", differing + missing, 0)],
                {"samples_checked": samples, "samples_differing": differing,
                 "samples_missing": missing, "tracks_checked": len(records)})

    def control(self, jobs):
        """the records of the window's first ``jobs`` jobs as the control
        makes them: each kept read decoded by the plain decoder with its
        synthesis summed in float32, in the program's place, from the
        album's files; a whole track's length"""
        order = common.play_order(len(self.album))
        n = self.mix["read_frames"]
        block = self.config["encode"]["block_size"]
        kept = []
        for k in range(jobs):
            i = order[k]
            starts = sorted({int(p) // n * n for p in self._positions(k, i)})
            kept.append((i, starts))
        made = iter(batch.run(flac_decode.decode_run, [
            (self.paths[i], at // block, -(-n // block), True)
            for (i, starts) in kept for at in starts], self.env.processes))
        records = []
        for (i, starts) in kept:
            reads = [(at, next(made)[:n]) for at in starts]
            records.append(dict(track=i, frames=self.album.track(i).shape[0],
                                reads=reads))
        return records


Driver = DecodeDriver
