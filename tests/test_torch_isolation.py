"""The port stands alone: none of its modules and nothing of
``chip_smoke.py`` imports jax or the reference package
``audiotools_tpu``, and its own copies of the host C++ library, the
scalar oracle and the ops helpers give what the reference's give."""

import glob
import io
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from audiotools_tpu import _native as ref_native
from audiotools_tpu_torch import _native, pcm
from audiotools_tpu_torch.codecs import flac_enc_fast as port_enc

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "audiotools_tpu_torch")


def port_sources():
    return sorted(glob.glob(os.path.join(PORT, "**", "*.py"),
                            recursive=True))


def port_modules():
    names = []
    for path in port_sources():
        rel = os.path.relpath(path, REPO)[:-3].replace(os.sep, ".")
        names.append(rel[:-len(".__init__")] if rel.endswith("__init__")
                     else rel)
    return names


def test_no_source_imports_the_reference():
    """a static scan of every port module and chip_smoke.py"""
    pattern = re.compile(
        r"^\s*(from\s+audiotools_tpu(\.[\w.]+)?\s+import|"
        r"import\s+audiotools_tpu(\.|\s|,|$))", re.M)
    jax = re.compile(r"^\s*(from|import)\s+jax\b", re.M)
    offenders = []
    for path in port_sources() + [os.path.join(REPO, "chip_smoke.py")]:
        with open(path) as f:
            text = f.read()
        if pattern.search(text) or jax.search(text):
            offenders.append(os.path.relpath(path, REPO))
    assert not offenders


def test_port_loads_nothing_of_the_reference():
    """a fresh interpreter imports every port module and chip_smoke,
    encodes and decodes FLAC, Shorten and TTA, runs ReplayGain,
    AccurateRip and a resampling PCMConverter through the port on the
    CPU, then trackcat --cue, tracksplit, tracktag and tracklint,
    track2track to AIFF and on to Ogg FLAC and to each lossy type whose
    library is found (then tracktag and verify on it), and holds no
    module of jax or of the reference"""
    code = (
        "import importlib, io, sys\n"
        "import numpy as np\n"
        "for name in %r:\n"
        "    importlib.import_module(name)\n"
        "import chip_smoke\n"
        "from audiotools_tpu_torch import pcm\n"
        "from audiotools_tpu_torch.codecs import flac_dec, flac_enc_fast\n"
        "arr = (np.arange(5000 * 2) %% 300 - 150).astype(np.int32)"
        ".reshape(-1, 2)\n"
        "for pack in (True, False):\n"
        "    out = io.BytesIO()\n"
        "    flac_enc_fast.encode_flac_fast(out, pcm.reader_from_array("
        "arr, 16), device='cpu', block_size=1024, batch_frames=4, "
        "pack=pack)\n"
        "    assert np.array_equal(flac_dec.decode_flac(out.getvalue(), "
        "device='cpu'), arr)\n"
        "from audiotools_tpu_torch.codecs import shn, tta\n"
        "from audiotools_tpu_torch.formats import shn as shn_format\n"
        "from audiotools_tpu_torch.formats import tta as tta_format\n"
        "out = io.BytesIO()\n"
        "shn_format.write_shn(out, pcm.reader_from_array(arr, 16), "
        "device='cpu')\n"
        "assert np.array_equal(shn.decode_shn(out.getvalue(), "
        "device='cpu'), arr)\n"
        "out = io.BytesIO()\n"
        "tta_format.write_tta(out, pcm.reader_from_array(arr[:300], 16), "
        "device='cpu')\n"
        "assert np.array_equal(tta.decode_tta(out.getvalue(), "
        "device='cpu'), arr[:300])\n"
        "from audiotools_tpu_torch import accuraterip_checksum, replaygain\n"
        "(gain, peak) = replaygain.ReplayGain(44100, device='cpu')"
        ".title_gain(pcm.reader_from_array(arr, 16))\n"
        "assert 0 < peak < 1\n"
        "assert accuraterip_checksum.accuraterip_checksums("
        "pcm.reader_from_array(arr, 16), len(arr), device='cpu')[0] > 0\n"
        "resampled = pcm.read_all(pcm.PCMConverter(pcm.reader_from_array("
        "arr, 16), 48000, 1, 0x4, 16, device='cpu'))\n"
        "assert resampled.shape == (len(arr) * 48000 // 44100, 1)\n"
        "import os, tempfile\n"
        "from audiotools_tpu_torch.formats.wav import WaveAudio\n"
        "from audiotools_tpu_torch.cli import (trackcat, tracklint, "
        "tracksplit, tracktag)\n"
        "work = tempfile.mkdtemp()\n"
        "wav = os.path.join(work, 'a.wav')\n"
        "WaveAudio.from_pcm(wav, pcm.reader_from_array(arr, 16))\n"
        "sheet = os.path.join(work, 'a.cue')\n"
        "open(sheet, 'w').write('FILE \"a.wav\" WAVE\\n  TRACK 01 AUDIO\\n"
        "    INDEX 01 00:00:00\\n  TRACK 02 AUDIO\\n    INDEX 01 00:00:03\\n')\n"
        "cat = os.path.join(work, 'cat.flac')\n"
        "cpu = ['--devices', 'cpu', '-V', 'silent']\n"
        "assert trackcat.main(['-t', 'flac', '--cue', sheet, '-o', cat, wav,"
        " wav] + cpu) == 0\n"
        "out = os.path.join(work, 'out')\n"
        "assert tracksplit.main(['-t', 'flac', '-d', out, cat] + cpu) == 0\n"
        "tracks = sorted(os.path.join(out, f) for f in os.listdir(out))\n"
        "assert len(tracks) == 2\n"
        "assert tracktag.main(['--album', ' x ', '--replay-gain'] + tracks +"
        " cpu) == 0\n"
        "assert tracklint.main(['--fix', '--db', os.path.join(work, 'u.db')]"
        " + tracks + cpu) == 0\n"
        "from audiotools_tpu_torch.cli import track2track\n"
        "assert track2track.main(['-t', 'aiff', '-o', os.path.join(work, "
        "'a.aiff'), wav] + cpu) == 0\n"
        "assert track2track.main(['-t', 'oggflac', '-q', '0', '-o', "
        "os.path.join(work, 'a.oga'), os.path.join(work, 'a.aiff')] + cpu)"
        " == 0\n"
        "from audiotools_tpu_torch import dispatch\n"
        "assert np.array_equal(pcm.read_all(dispatch.open(os.path.join("
        "work, 'a.oga'), device='cpu').to_pcm()), arr)\n"
        "for name in ('mp3', 'mp2', 'vorbis', 'opus'):\n"
        "    if name in dispatch.TYPE_MAP:\n"
        "        dest = os.path.join(work, 'lossy.' + "
        "dispatch.TYPE_MAP[name].SUFFIX)\n"
        "        assert track2track.main(['-t', name, '-o', dest, "
        "os.path.join(work, 'a.aiff')] + cpu) == 0\n"
        "        assert tracktag.main(['--name', 'x', dest] + cpu) == 0\n"
        "        assert dispatch.open(dest, device='cpu').verify()\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or "
        "m.startswith('jax.') or m == 'audiotools_tpu' or "
        "m.startswith('audiotools_tpu.'))\n"
        "assert not bad, bad\n"
        "print('ok')\n") % (port_modules(),)
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_native_copy_matches_the_reference():
    """the port's host library builds, and its MD5, flac_decode and
    flac_scan equal the reference's on one stream"""
    rng = np.random.default_rng(4)
    arr = np.cumsum(rng.integers(-500, 501, (4096 * 3 + 100, 2)),
                    axis=0).clip(-32768, 32767).astype(np.int32)
    arr[4096:4200] = rng.integers(-32768, 32767, (104, 2))
    out = io.BytesIO()
    port_enc.encode_flac_fast(out, pcm.reader_from_array(arr, 16),
                              device="cpu", block_size=4096,
                              max_lpc_order=12, batch_frames=2)
    data = out.getvalue()
    frames = data[pcm.streaminfo(data)[4]:]

    (md5, ref_md5) = (_native.MD5(), ref_native.MD5())
    for h in (md5, ref_md5):
        h.update(b"FLAC")
        h.update_pcm(arr, 16)
    assert md5.digest() == ref_md5.digest()

    (got, used) = _native.flac_decode(frames, 16, 2, arr.shape[0])
    (want, ref_used) = ref_native.flac_decode(frames, 16, 2, arr.shape[0])
    assert used == ref_used and np.array_equal(got, want)
    assert np.array_equal(got, arr)

    args = (frames, 16, 2, 1 << 30, 64, 8192)
    scan = _native.flac_scan(*args, chunk_codes=64)
    ref_scan = ref_native.flac_scan(*args, chunk_codes=64)
    assert sorted(scan) == sorted(ref_scan)
    for key in scan:
        assert np.array_equal(scan[key], ref_scan[key]), key


def test_copied_helpers_match_the_reference():
    """the constants and helpers the port copied from the reference's
    ops modules give the same values"""
    from audiotools_tpu.ops import flac_frames as ref_ff
    from audiotools_tpu.ops import pallas_bitpack as ref_bp
    from audiotools_tpu_torch.ops import bitpack, flac_frames
    for name in ("CHOICE_CONSTANT", "CHOICE_VERBATIM", "CHOICE_FIXED",
                 "CHOICE_LPC", "PACKED_SCALARS"):
        assert getattr(flac_frames, name) == getattr(ref_ff, name)
    for n in (192, 576, 1000, 4096, 4608):
        for porder in range(9):
            for order in (0, 4, 8, 12, 32):
                assert (flac_frames.valid_partition_orders(n, porder, order)
                        == ref_ff.valid_partition_orders(n, porder, order))
        for bps in (8, 16, 17, 24, 25):
            assert (bitpack.residual_words_capacity(n, bps, 64) ==
                    ref_bp.residual_words_capacity(n, bps, 64))
    for order in range(33):
        for parts in (1, 2, 7, 64, 256):
            assert (flac_frames.compact_width(order, parts) ==
                    ref_ff.compact_width(order, parts))


@pytest.mark.parametrize("qpack", ["1", "0"])
@pytest.mark.parametrize("bps,ch", [(16, 2), (24, 1)])
def test_oracle_copy_matches_the_reference(monkeypatch, qpack, bps, ch):
    """the port's copy of the scalar oracle encodes a tail frame and a
    STREAMINFO block byte for byte as the reference's does, with and
    without its quantized-analysis spec"""
    from audiotools_tpu.ref import flac_enc as ref_oracle
    from audiotools_tpu_torch.ref import flac_enc as oracle
    monkeypatch.setenv("ATPU_FLAC_QPACK", qpack)
    rng = np.random.default_rng(bps + ch)
    t = np.arange(1000)
    amp = 1 << (bps - 3)
    samples = np.stack([(amp * np.sin(2 * np.pi * (500 + 90 * c) * t
                                      / 44100)).astype(np.int64)
                        + rng.integers(-amp // 50, amp // 50, 1000)
                        for c in range(ch)], axis=1)
    reader = pcm.reader_from_array(samples, bps)
    for (block_size, order) in ((4096, 12), (1152, 8)):
        args = dict(block_size=block_size, max_lpc_order=order,
                    exhaustive_model_search=True,
                    max_residual_partition_order=6,
                    max_rice_parameter=14 if bps <= 16 else 30)
        assert (oracle.encode_frame(reader, oracle.EncodingOptions(**args),
                                    77, samples) ==
                ref_oracle.encode_frame(
                    reader, ref_oracle.EncodingOptions(**args), 77,
                    samples))
    info = (4096, 4096, 14, 9000, 44100, ch, bps, 123456789, bytes(16))
    assert oracle.build_streaminfo(*info) == ref_oracle.build_streaminfo(
        *info)
