"""The port's per-device steps (``parallel.mesh``) on the CPU against
the reference's numpy analysis, its dry run, and a two-process farm
joined over ``torch.distributed`` with gloo."""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

from audiotools_tpu.formats.flac import FlacAudio as RefFlacAudio
from audiotools_tpu.formats.wav import WaveAudio as RefWaveAudio
from audiotools_tpu.ops import flac_frames as ref_ff
from audiotools_tpu.ops import lpc as ref_lpc
from audiotools_tpu_torch import pcm
from audiotools_tpu_torch.formats.wav import WaveAudio
from audiotools_tpu_torch.ops import flac_frames
from audiotools_tpu_torch.ops import lpc as lpc_ops
from audiotools_tpu_torch.parallel import dryrun, mesh

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TWO_CPUS = ["cpu", "cpu"]
N = 256
K = 4


def porders():
    return flac_frames.valid_partition_orders(N, 2, max(K, 4))


def test_window_copy_matches_the_reference():
    for (a, b) in zip(lpc_ops.tukey_window_df(N), ref_lpc.tukey_window_df(N)):
        assert np.array_equal(a, b)


def test_packed_step_matches_the_reference():
    blocks = dryrun.signal(8, N, seed=3)
    window = lpc_ops.tukey_window_df(N)
    step = mesh.sharded_packed_encode_step(TWO_CPUS, N, K, 10, porders(),
                                           14, True, bps=16, mid_side=True)
    (packed, total_bits) = step(blocks, window)
    want = np.asarray(ref_ff.analyze_frames_packed(
        np, blocks, True, 16, N, K, 10, porders(), 14, True, True, window))
    assert packed.shape == want.shape and np.array_equal(packed, want)
    W = ref_ff.packed_width(K, 1 << porders()[-1])
    assert total_bits == sum(want[:, 1 + s * W + 5].astype(np.float64).sum()
                             for s in range(2))


@pytest.mark.parametrize("which", ["analyze", "encode_step"])
def test_subframe_steps_match_the_reference(which):
    blocks = dryrun.signal(3, N, seed=5)
    X = np.ascontiguousarray(np.concatenate(
        [blocks[:, :, 0], blocks[:, :, 1],
         (blocks[:, :, 0] - blocks[:, :, 1]) >> 1, np.zeros((3, N))]),
        dtype=np.int32)                           # 12 rows, a constant 3
    bps = np.array([16] * 6 + [17] * 3 + [16] * 3, dtype=np.int32)
    window = lpc_ops.tukey_window_df(N)
    args = (TWO_CPUS, N, K, 10, porders(), 14, True)
    want = ref_ff.analyze_subframes(np, X, bps, N, K, 10, porders(), 14,
                                    True, window)
    if which == "analyze":
        got = mesh.sharded_analyze(*args)(X, bps, window)
    else:
        (got, total_bits) = mesh.sharded_encode_step(*args)(X, bps, window)
        assert total_bits == np.asarray(want["sub_bits"]).astype(
            np.float64).sum()
    assert sorted(got) == sorted(want)
    for key in want:
        assert np.array_equal(got[key], np.asarray(want[key])), key


def test_a_row_count_that_does_not_divide_raises():
    step = mesh.sharded_packed_encode_step(["cpu"] * 3, N, K, 10, porders(),
                                           14, True)
    with pytest.raises(ValueError, match="do not split"):
        step(dryrun.signal(4, N), lpc_ops.tukey_window_df(N))


@pytest.mark.parametrize("count", [1, 2])
def test_dryrun(count):
    dryrun.dryrun_multichip(["cpu"] * count)


def test_cuda_requests_raise_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        mesh.cuda_devices()
    with pytest.raises(RuntimeError, match="cuda"):
        mesh.sharded_analyze(["cuda"], N, K, 10, porders(), 14, True)
    with pytest.raises(RuntimeError, match="cuda"):
        dryrun.dryrun_multichip(["cpu", "cuda"])


def test_more_cards_than_there_are_raise(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="only 1"):
        mesh.cuda_devices(2)
    with pytest.raises(ValueError, match="only 1"):
        mesh.sharded_packed_encode_step(["cuda:0", "cuda:1"], N, K, 10,
                                        porders(), 14, True)


WORKER = r"""
import os, sys
import numpy as np
import torch
torch.set_num_threads(1)
(rank, address, workdir) = (int(sys.argv[1]), sys.argv[2], sys.argv[3])
from audiotools_tpu_torch.formats.flac import FlacAudio
from audiotools_tpu_torch.parallel import farm, mesh

mesh.init_distributed(address, 2, rank)
sources = sorted(f for f in os.listdir(workdir) if f.endswith(".wav"))
jobs = [farm.FarmJob(os.path.join(workdir, name),
                     os.path.join(workdir, name[:-4] + ".flac"),
                     FlacAudio, compression="8")
        for (i, name) in enumerate(sources) if i % 2 == rank]
results = farm.transcode(jobs, workers=2, devices=["cpu"])
assert all(r.ok for r in results), [str(r.error) for r in results]
mine = sum(os.path.getsize(r.job.dest_path) for r in results)
total = torch.tensor([mine], dtype=torch.int64)
torch.distributed.all_reduce(total)
gathered = mesh.host_local_to_global(np.array([[mine, rank]]))
assert gathered[:, 1].tolist() == [0, 1]
assert mesh.global_to_host_local(gathered).tolist() == [[mine, rank]]
torch.distributed.destroy_process_group()
bad = sorted(m for m in sys.modules if m == "jax" or m.startswith("jax.")
             or m == "audiotools_tpu" or m.startswith("audiotools_tpu."))
assert not bad, bad
print("OK %d %d %d %d" % (rank, mine, int(total), int(gathered[:, 0].sum())))
"""


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_two_process_farm_over_gloo(tmp_path, monkeypatch):
    """two processes, each importing only the port, farm their halves
    of 4 tracks; the all_reduce of their byte counts equals the sum of
    the files, and every file equals the reference's"""
    monkeypatch.setenv("ATPU_FLAC_BACKEND", "numpy")
    monkeypatch.setenv("ATPU_FLAC_QPACK", "0")
    monkeypatch.setenv("ATPU_EMIT_EXACT_RICE", "0")
    arrays = []
    for i in range(4):
        arr = dryrun.signal(1, 9000 + 1234 * i, seed=i)[0]
        WaveAudio.from_pcm(str(tmp_path / ("t%d.wav" % i)),
                           pcm.reader_from_array(arr, 16))
        arrays.append(arr)
    address = "tcp://127.0.0.1:%d" % (_free_port(),)
    env = dict(os.environ, PYTHONPATH=REPO)
    procs = [subprocess.Popen(
        [sys.executable, "-c", WORKER, str(rank), address, str(tmp_path)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env,
        cwd=str(tmp_path)) for rank in range(2)]
    outs = []
    try:
        for proc in procs:
            outs.append(proc.communicate(timeout=120))
    finally:
        for proc in procs:
            proc.kill()
            proc.wait()
    lines = []
    for (proc, (out, err)) in zip(procs, outs):
        assert proc.returncode == 0, err[-3000:]
        lines.append([int(v) for v in out.split()[-4:]])
    sizes = [os.path.getsize(str(tmp_path / ("t%d.flac" % i)))
             for i in range(4)]
    assert [ln[0] for ln in lines] == [0, 1]
    assert [ln[1] for ln in lines] == [sizes[0] + sizes[2],
                                       sizes[1] + sizes[3]]
    assert all(ln[2] == sum(sizes) and ln[3] == sum(sizes) for ln in lines)
    for i in range(4):
        ref_path = str(tmp_path / ("ref%d.flac" % i))
        source = RefWaveAudio(str(tmp_path / ("t%d.wav" % i)))
        RefFlacAudio.from_pcm(ref_path, source.to_pcm(), compression="8")
        with open(ref_path, "rb") as f, \
                open(str(tmp_path / ("t%d.flac" % i)), "rb") as g:
            assert f.read() == g.read()
