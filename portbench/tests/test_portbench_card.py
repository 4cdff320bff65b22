"""Each cell run on the card as the benchmark's command runs it, with a
short window: it exits 0 and its last line says correct.  Skips where
there is no card (decided in the fixture)."""

from __future__ import annotations

import json
import subprocess
import sys

import pytest

from portbench.tests import tiny


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.cuda
@pytest.mark.parametrize("workload", tiny.WORKLOADS)
def test_a_short_run_on_the_card_is_correct(card, workload):
    proc = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", workload,
         "--seed", "2147483647", "--seconds", "2", "--trace", "0"],
        cwd=tiny.ROOT, capture_output=True, text=True, timeout=1200)
    assert proc.returncode == 0, proc.stderr[-3000:]
    result = json.loads(proc.stdout.strip().splitlines()[-1])
    assert result["correct"] and result["device"]["platform"] == "gpu"
