"""The seek driver: a closed loop of clients over the album's FLAC files
(written once in set-up by the port's ``FlacAudio.from_pcm``), each
client a thread with its own CUDA stream and its own open
``TorchFlacDecoder`` for every track.  A request is a seek to a uniform
frame of a uniform track, then reads until ``read_frames`` frames are in
host memory; it is timed from the seek's call to its last frame.  The
requests are one fixed sequence, the same set for every seed: the seed
only orders each block of them, and the clients take the next request
from the sequence as they finish one.  Every request's frames are kept
for the check after the window."""

from __future__ import annotations

import contextlib
import threading

import numpy as np

from ..harness.album import seed_bits
from ..harness.window import percentile
from ..reference import batch, flac_decode
from . import common

# the generator seed of the fixed request sequence
REQUEST_SEED = 31415
# requests in the sequence before it repeats, and in a block the seed
# orders
REQUESTS = 1 << 14
BLOCK = 64


class SeekDriver:
    """end-to-end metric: seek_p95_ms"""

    def __init__(self, env):
        self.env = env
        self.config = env.config
        self.mix = env.mix
        self.clients = env.mix["clients"]
        self.parties = self.clients

    def setup(self):
        from audiotools_tpu_torch.codecs.flac_dec import TorchFlacDecoder
        self.decoder = TorchFlacDecoder
        self.album = common.album(self.env)
        (self.paths, _warm) = common.write_flac_files(
            self.env, self.album, self.mix["write_workers"], warm=False)

    def _request(self, decoders, track, pos):
        """one seek and its reads: (landed frame, frames [n, ch])"""
        dec = decoders[track]
        landed = dec.seek(pos)
        want = self.mix["read_frames"]
        pieces = []
        have = 0
        while have < want:
            frames = dec.read(want - have)
            if frames.frames == 0:
                break
            pieces.append(np.array(frames.samples))
            have += frames.frames
        return (landed, np.concatenate(pieces, axis=0) if pieces else
                np.zeros((0, self.config["channels"]), dtype=np.int32))

    def run(self, window):
        env = self.env
        torch = env.torch
        device = env.device
        lengths = [b - a for (a, b) in self.album.bounds]
        want = self.mix["read_frames"]
        results = [None] * self.clients

        sequence = request_sequence(lengths, want, env.seed)
        taken = [0]
        lock = threading.Lock()

        def draw():
            with lock:
                k = taken[0]
                taken[0] += 1
            return sequence[k % len(sequence)]

        def client(c):
            records = []
            errors = []
            decoders = []
            on_card = getattr(device, "type", device) == "cuda"
            stream = torch.cuda.Stream(device) if on_card else None
            with (torch.cuda.stream(stream) if on_card
                  else contextlib.nullcontext()):
                try:
                    def warm():
                        decoders.extend(self.decoder(p, device=device)
                                        for p in self.paths)
                        for _ in range(self.mix["warm_seeks"]):
                            self._request(decoders, *draw())
                    try:
                        common.warm_then_arrive(window, warm)
                    except Exception as err:  # noqa: BLE001 - counted
                        errors.append(err)
                    while window.due() and not errors:
                        (i, pos) = draw()
                        start = common.now()
                        try:
                            with torch.profiler.record_function(
                                    "portbench.seek"):
                                (landed, got) = self._request(decoders, i,
                                                              pos)
                        except Exception as err:  # noqa: BLE001 - counted
                            errors.append(err)
                            continue
                        end = common.now()
                        records.append(dict(track=i, pos=pos,
                                            landed=landed, frames=got,
                                            start=start, end=end))
                finally:
                    for dec in decoders:
                        dec.close()
                    if stream is not None:
                        stream.synchronize()
            results[c] = (records, errors)

        threads = [threading.Thread(target=self._guard(client, results),
                                    args=(c,), daemon=True)
                   for c in range(self.clients)]
        for t in threads:
            t.start()
        try:
            window.open()
        except threading.BrokenBarrierError:
            pass                # a client's warm-up raised: reported below
        for t in threads:
            t.join()
        failures = [r for r in results if isinstance(r, BaseException)]
        failures.sort(key=lambda e: isinstance(e, threading.BrokenBarrierError))
        if failures:
            raise failures[0]
        records = [r for (rs, _e) in results for r in rs]
        errors = [e for (_r, es) in results for e in es]
        return (records, errors)

    @staticmethod
    def _guard(client, results):
        def run(c):
            try:
                client(c)
            except BaseException as err:   # noqa: B902 - re-raised by run
                results[c] = err
        return run

    def end_to_end(self, records, start):
        return {"seek_p95_ms": percentile(
            [(r["end"] - r["start"]) * 1e3 for r in records], 95)}

    def layer_context(self, records):
        return {}

    def counters(self):
        return common.decode_counters()

    def release(self):
        pass

    def check(self, records):
        """the number compared: ``samples_wrong``, the served samples that
        differ from the album at the frame each seek landed on, and every
        sample of a seek that landed after the frame asked for or a
        block or more before it"""
        block = self.config["encode"]["block_size"]
        want = self.mix["read_frames"]
        differing = misplaced = 0
        for r in records:
            track = self.album.track(r["track"])
            got = r["frames"]
            misplaced += not (r["pos"] - block < r["landed"] <= r["pos"])
            ref = track[r["landed"]:r["landed"] + want]
            if ref.shape != got.shape:
                differing += max(got.size, ref.size)
            else:
                differing += int(np.count_nonzero(ref != got))
        wrong = differing + misplaced * want * self.config["channels"]
        return ([("samples_wrong", wrong, 0)],
                {"seeks_checked": len(records), "samples_differing": differing,
                 "seeks_misplaced": misplaced})


    def control(self, requests):
        """the records of the window's first ``requests`` requests as the
        control makes them: the frames from the block holding each
        frame asked for, decoded by the plain decoder with its synthesis
        summed in float32, in the program's place, from the album's
        files"""
        lengths = [b - a for (a, b) in self.album.bounds]
        want = self.mix["read_frames"]
        block = self.config["encode"]["block_size"]
        asked = request_sequence(lengths, want, self.env.seed)[:requests]
        made = batch.run(flac_decode.decode_run, [
            (self.paths[i], pos // block,
             -(-(pos % block + want) // block), True)
            for (i, pos) in asked], self.env.processes)
        return [dict(track=i, pos=pos, landed=pos // block * block,
                     frames=got[:want])
                for ((i, pos), got) in zip(asked, made)]


def request_sequence(lengths, want, seed):
    """the fixed requests [(track, frame)], uniform over tracks and over
    each track's frames but the last ``want``, each BLOCK of them put in
    the seed's order"""
    rng = np.random.default_rng(REQUEST_SEED)
    tracks = rng.integers(0, len(lengths), REQUESTS)
    frames = [int(rng.integers(0, max(lengths[t] - want, 1)))
              for t in tracks.tolist()]
    order = np.random.default_rng(seed_bits(seed, 200))
    out = []
    for b in range(0, REQUESTS, BLOCK):
        for i in (b + order.permutation(BLOCK)).tolist():
            out.append((int(tracks[i]), frames[i]))
    return out


Driver = SeekDriver
