"""The WavPack cell and the 24/96 decode cell run on the card as the
benchmark's command runs them, with short windows: each exits 0 and its
last line says correct; traced, the WavPack cell reports its four
per-layer metrics, its roofline share above 0 and under 100 %.  Skips
where there is no card (decided in the fixture)."""

from __future__ import annotations

import json
import subprocess
import sys

import pytest

from portbench.tests import tiny

WV = "wavpack_std_cd16.wv_album_encode"
METRICS = ("host_ms_per_frame.wv_encode", "correlate_ms_per_frame.wv_encode",
           "wv_corr_roofline.wv_encode", "device_idle.wv_encode")


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


def run(workload, trace):
    proc = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", workload,
         "--seed", "2147483649", "--seconds", "2", "--trace", str(trace)],
        cwd=tiny.ROOT, capture_output=True, text=True, timeout=1200)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


@pytest.mark.cuda
@pytest.mark.parametrize("workload", [WV, "flac8_hires24.album_decode"])
def test_a_short_run_on_the_card_is_correct(card, workload):
    result = run(workload, 0)
    assert result["correct"] and result["device"]["platform"] == "gpu"


@pytest.mark.cuda
def test_a_traced_run_reports_the_wavpack_metrics(card):
    result = run(WV, 1)
    assert result["correct"]
    assert set(METRICS) <= set(result["metrics"])
    assert 0 < result["metrics"]["wv_corr_roofline.wv_encode"]["value"] < 100
