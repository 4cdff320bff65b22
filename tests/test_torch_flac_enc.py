"""The whole slice of the PyTorch port on the CPU: its
``encode_flac_fast(device="cpu")`` must write a .flac byte-identical
to the reference's, for the device-pack configuration (pack=True,
packed residual bits spliced at emit) and for host Rice serialization
(pack=False), and the file must decode bit-exactly.

The reference runs with exact uploads (ATPU_FLAC_QPACK=0) and without
the emit-stage Rice re-search (ATPU_EMIT_EXACT_RICE=0), the
configuration in which its numpy backend and its ATPU_PALLAS=1 device
path agree (tests/test_pallas_bitpack.py).
"""

import io
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from audiotools_tpu import pcm
from audiotools_tpu.codecs.flac_enc_fast import (
    encode_flac_fast as reference_encode)
from audiotools_tpu.pcmstream import PCMReader
from audiotools_tpu_torch.codecs import flac_enc_fast as port
from test_jax_matrix import flac_decode_all
from test_pallas_bitpack import _encode_bytes

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# test_pallas_encode_path_byte_identity's options
OPTS = dict(block_size=4096, max_lpc_order=8,
            exhaustive_model_search=False,
            max_residual_partition_order=4, batch_frames=8)


def signal(bps, ch, n=4096 * 9 + 1000):
    """test_pallas_encode_path_byte_identity's signal: tones + noise
    with a constant first block, a padded partial batch and a tail"""
    rng = np.random.default_rng(9)
    t = np.arange(n)
    amp = 1 << (bps - 3)
    arr = np.stack([(amp * np.sin(2 * np.pi * (300 + 200 * c) * t
                                  / 44100)).astype(np.int64)
                    + rng.integers(-amp // 64, amp // 64, n)
                    for c in range(ch)], axis=1).astype(np.int32)
    arr[:4096] = 1234
    return arr


def reader(arr, bps):
    fl = pcm.FrameList._wrap(arr, bps)
    return PCMReader(io.BytesIO(fl.to_bytes(False, True)), 44100,
                     arr.shape[1], {1: 4, 2: 3}[arr.shape[1]], bps)


def port_bytes(arr, bps, pack, device="cpu"):
    buf = io.BytesIO()
    port.encode_flac_fast(buf, reader(arr, bps), device=device, pack=pack,
                          mid_side=arr.shape[1] == 2, **OPTS)
    return buf.getvalue()


@pytest.fixture
def exact_reference(monkeypatch):
    monkeypatch.setenv("ATPU_FLAC_QPACK", "0")
    monkeypatch.setenv("ATPU_EMIT_EXACT_RICE", "0")


@pytest.mark.parametrize("pack", [True, False])
@pytest.mark.parametrize("bps,ch", [(16, 2), (16, 1), (24, 2)])
def test_bytes_match_numpy_reference(exact_reference, bps, ch, pack):
    arr = signal(bps, ch)
    buf = io.BytesIO()
    reference_encode(buf, reader(arr, bps), backend="numpy",
                     mid_side=ch == 2, **OPTS)
    data = port_bytes(arr, bps, pack)
    assert data == buf.getvalue()
    assert np.array_equal(flac_decode_all(data, bps, ch, len(arr)), arr)


def test_bytes_match_jax_pallas_reference(monkeypatch):
    """against the reference's JAX backend with ATPU_PALLAS=1, its
    Pallas kernel in interpret mode (one jit compile)"""
    arr = signal(16, 2)
    want = _encode_bytes(arr, 16, "jax", monkeypatch, pallas=True)
    assert port_bytes(arr, 16, True) == want


def test_pack_overflow_emits_without_splice(exact_reference, monkeypatch):
    """a batch whose pack reports ok=False is emitted from the same
    decisions by the non-splice emitter: the bytes do not change and
    the batch is counted"""
    from audiotools_tpu_torch.ops import bitpack
    arr = signal(16, 2)
    want = port_bytes(arr, 16, True)
    monkeypatch.setattr(bitpack, "residual_words_capacity",
                        lambda n, bps, parts: 8)
    before = port.fallback_batches
    assert port_bytes(arr, 16, True) == want
    assert port.fallback_batches == before + 2


def test_timings_and_frame_offsets():
    arr = signal(16, 2, n=4096 * 3 + 5)
    timings = {}
    buf = io.BytesIO()
    offsets = port.encode_flac_fast(buf, reader(arr, 16), device="cpu",
                                    timings=timings, **OPTS)
    assert sorted(timings) == sorted(port.STAGES)
    assert all(v >= 0.0 for v in timings.values())
    assert [f for (_o, f) in offsets] == [4096, 4096, 4096, 5]
    assert [o for (o, _f) in offsets] == sorted(o for (o, _f) in offsets)


def test_cuda_request_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        port_bytes(signal(16, 2, n=5000), 16, True, device="cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("bps,ch", [(16, 2), (16, 1), (24, 2)])
def test_cuda_bytes_match_numpy_reference(exact_reference, bps, ch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    arr = signal(bps, ch)
    buf = io.BytesIO()
    reference_encode(buf, reader(arr, bps), backend="numpy",
                     mid_side=ch == 2, **OPTS)
    for pack in (True, False):
        assert port_bytes(arr, bps, pack, device="cuda") == buf.getvalue()


@pytest.mark.parametrize("flag", [
    "disable_verbatim_subframes", "disable_constant_subframes",
    "disable_fixed_subframes", "disable_lpc_subframes"])
def test_disable_flags_raise(flag):
    """the batched encoder cannot honour a disable_* flag, so a set
    one is refused instead of being ignored"""
    with pytest.raises(NotImplementedError, match=flag):
        port.encode_flac_fast(io.BytesIO(), reader(signal(16, 2, n=5000),
                                                   16),
                              device="cpu", **{flag: True})


def test_port_never_imports_jax():
    """a fresh interpreter encodes through the port without jax"""
    code = (
        "import io, sys\n"
        "import numpy as np\n"
        "from audiotools_tpu_torch.codecs.flac_enc_fast import "
        "encode_flac_fast\n"
        "from audiotools_tpu_torch.pcm import decode_flac, "
        "reader_from_array\n"
        "arr = (np.arange(9000 * 2) % 300 - 150).astype(np.int32)"
        ".reshape(-1, 2)\n"
        "out = io.BytesIO()\n"
        "encode_flac_fast(out, reader_from_array(arr, 16), device='cpu',"
        " block_size=1024, batch_frames=4)\n"
        "assert np.array_equal(decode_flac(out.getvalue()), arr)\n"
        "assert 'jax' not in sys.modules, sorted(m for m in sys.modules"
        " if m.startswith('jax'))\n"
        "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"
