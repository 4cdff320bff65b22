"""The controls at a size a test run holds, on the CPU: the plain
reference in float32 put in the program's place (the encoder's LPC
analysis, the decoder's synthesis) makes records that each cell's own
check finds not correct."""

from __future__ import annotations

import pytest

from portbench import controls
from portbench.tests import tiny


@pytest.mark.parametrize("workload,jobs", [
    ("flac8_cd16.album_encode", 2),
    ("flac8_hires24.album_encode", 2),
    ("flac8_cd16.album_decode", 8),
    ("flac8_cd16.seek", 8),
])
def test_the_control_is_not_correct(workload, jobs):
    # seed 6: both tracks of the tiny album are loud (see the reference's
    # tests)
    (checks, counts) = controls.control_reading(
        tiny.ROOT, workload, 6, jobs, "cpu", **tiny.OVERRIDES)
    assert any(value > limit for (_n, value, limit) in checks), counts
