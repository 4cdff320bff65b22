"""A cell shrunk until the port's plain CPU versions run it in seconds:
for the tests only, never for a measurement."""

from __future__ import annotations

import os

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
ALBUM = {"tracks": 2, "median_s": 0.6, "sigma": 0.3, "min_s": 0.3,
         "max_s": 2.0}
MIX = {"warm_blocks": [4, 2], "check_partial_frames": 2,
       "check_stripe_frames": 2, "check_reads_per_track": 2,
       "read_frames": 4096, "warm_seeks": 1}
BATCH_FRAMES = 4
WORKLOADS = ("flac8_cd16.album_encode", "flac8_hires24.album_encode",
             "flac8_cd16.album_decode", "flac8_cd16.seek")


# the plain reference in the test's own process
PROCESSES = 1
OVERRIDES = dict(album_shape=ALBUM, batch_frames=BATCH_FRAMES, mix=MIX,
                 processes=PROCESSES)


def run(workload, seed=5, seconds=0.3):
    """one run of ``workload`` on the CPU at the tiny size: (result,
    notes)"""
    from portbench.harness import core
    return core.run_cell(ROOT, workload, seed, seconds, False, device="cpu",
                         **OVERRIDES)
