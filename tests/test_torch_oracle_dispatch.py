"""The oracle escape hatches in the port, against its default path and
the reference.

The port's twin of ``tests/test_oracle_dispatch.py``, for FLAC, Ogg
FLAC, ALAC, Shorten, TTA and WavPack: with each codec's
``ATPU_<CODEC>_ORACLE=1`` its file class writes the bytes its default
path writes and the reference writes, and decodes to the same samples
as the default decoder and the input; with the switch set no kernel
wrapper (and no Shorten device op) is called, and the dispatchers need
no card; and a card path whose module fails to import or whose kernels
fail to build raises: only the variable selects the oracle.  The
default path runs on the CPU through the kernels' plain versions.
Inputs are made from a numpy seed, at the reference test's size."""

import importlib
import io
import sys

import numpy as np
import pytest
import torch

from audiotools_tpu import pcm as ref_pcm
from audiotools_tpu.pcmstream import PCMReader as RefPCMReader
from audiotools_tpu_torch import kernels, pcm
from audiotools_tpu_torch.ops import (alac_synth, bitpack, flac_frames,
                                      flac_synth, rice_decode, shn_scan,
                                      shn_synth, tta_scan, tta_synth, wv_scan)

torch.set_num_threads(1)

SR = 44100
N = 4096 * 3 + 333

SWITCHES = ("ATPU_FLAC_ORACLE", "ATPU_ALAC_ORACLE", "ATPU_SHN_ORACLE",
            "ATPU_TTA_ORACLE", "ATPU_WV_ORACLE")

# (kind, switch, "module.Class" of the file class in formats/ of both
# packages, the wrappers the default path calls: encode, decode)
CASES = [
    ("flac", "ATPU_FLAC_ORACLE", "flac.FlacAudio", (),
     ("rice_decode", "flac_synth")),
    ("oggflac", "ATPU_FLAC_ORACLE", "flac.OggFlacAudio", (),
     ("rice_decode", "flac_synth")),
    ("alac", "ATPU_ALAC_ORACLE", "m4a.ALACAudio", (), ("alac_synth",)),
    ("shn", "ATPU_SHN_ORACLE", "shn.ShortenAudio", ("shn_decisions",),
     ("shn_synth",)),
    ("tta", "ATPU_TTA_ORACLE", "tta.TrueAudio", ("tta_filter",),
     ("tta_synth",)),
    ("wavpack", "ATPU_WV_ORACLE", "wavpack.WavPackAudio", ("wv_corr",),
     ("wv_decorr",)),
]
KINDS = [case[0] for case in CASES]
BY_KIND = {case[0]: case for case in CASES}

# the nine kernel wrappers by the kernels line's names, and the two
# Shorten device ops (Shorten has no hand kernel): (module, attribute)
WRAPPERS = {"pack_rows": (bitpack, "pack_rows"),
            "rice_planes": (flac_frames, "rice_planes"),
            "rice_decode": (rice_decode, "decode_partitions"),
            "flac_synth": (flac_synth, "synthesize"),
            "alac_synth": (alac_synth, "synthesize"),
            "tta_synth": (tta_synth, "inverse_filter_predict"),
            "tta_filter": (tta_scan, "hybrid_filter"),
            "wv_corr": (wv_scan, "run_pass_chain"),
            "wv_decorr": (wv_scan, "run_dec_chain"),
            "shn_decisions": (shn_scan, "stream_decisions"),
            "shn_synth": (shn_synth, "synthesize")}

# the modules of the card encoder and decoder that the FLAC and ALAC
# dispatchers import when they are called (the other codecs' card paths
# are in their dispatchers' own modules)
CARD_MODULES = {"flac": ("flac_enc_fast", "flac_dec"),
                "oggflac": ("flac_enc_fast", "flac_dec"),
                "alac": ("alac_fast", "alac_dec")}


@pytest.fixture(autouse=True)
def no_switch(monkeypatch):
    for name in SWITCHES:
        monkeypatch.delenv(name, raising=False)


def make_samples():
    rng = np.random.default_rng(13)
    t = np.arange(N)
    return np.clip(np.stack([
        5000 * np.sin(2 * np.pi * 440 * t / SR) + rng.normal(0, 300, N),
        4500 * np.sin(2 * np.pi * 550 * t / SR)], 1),
        -32768, 32767).astype(np.int32)


SAMPLES = make_samples()


def port_class(kind):
    (module, name) = BY_KIND[kind][2].split(".")
    return getattr(importlib.import_module(
        "audiotools_tpu_torch.formats." + module), name)


def ref_class(kind):
    (module, name) = BY_KIND[kind][2].split(".")
    return getattr(importlib.import_module(
        "audiotools_tpu.formats." + module), name)


def port_encode(kind, path):
    port_class(kind).from_pcm(str(path), pcm.reader_from_array(SAMPLES, 16),
                              device="cpu")
    with open(path, "rb") as f:
        return f.read()


def ref_encode(kind, path):
    fl = ref_pcm.FrameList._wrap(SAMPLES, 16)
    ref_class(kind).from_pcm(str(path), RefPCMReader(
        io.BytesIO(fl.to_bytes(False, True)), SR, 2, 3, 16))
    with open(path, "rb") as f:
        return f.read()


def comparable(kind, data):
    """the bytes compared: an M4A's from its mdat on (the moov holds a
    creation date)"""
    return data[data.find(b"mdat"):] if kind == "alac" else data


def decode(kind, path, device="cpu"):
    reader = port_class(kind)(str(path), device).to_pcm()
    try:
        return pcm.read_all(reader)
    finally:
        reader.close()


class Counting:
    """each wrapper of WRAPPERS replaced by one that counts its calls
    and calls the original"""

    def __init__(self, monkeypatch):
        self.calls = dict.fromkeys(WRAPPERS, 0)
        for (name, (module, attr)) in WRAPPERS.items():
            monkeypatch.setattr(module, attr,
                                self._counted(name, getattr(module, attr)))

    def _counted(self, name, original):
        def wrapper(*args, **kwargs):
            self.calls[name] += 1
            return original(*args, **kwargs)
        return wrapper

    def take(self):
        calls = dict(self.calls)
        for name in self.calls:
            self.calls[name] = 0
        return calls


@pytest.mark.parametrize("kind", KINDS)
def test_oracle_bytes_equal_the_default_and_the_reference(kind, tmp_path,
                                                          monkeypatch):
    switch = BY_KIND[kind][1]
    default = port_encode(kind, tmp_path / ("default." + kind))
    reference = ref_encode(kind, tmp_path / ("reference." + kind))
    monkeypatch.setenv(switch, "1")
    oracle = port_encode(kind, tmp_path / ("oracle." + kind))
    assert comparable(kind, oracle) == comparable(kind, default)
    assert comparable(kind, oracle) == comparable(kind, reference)


@pytest.mark.parametrize("kind", KINDS)
def test_oracle_decoder_equals_the_default_and_the_input(kind, tmp_path,
                                                         monkeypatch):
    switch = BY_KIND[kind][1]
    path = tmp_path / ("file." + port_class(kind).SUFFIX)
    port_encode(kind, path)
    default = decode(kind, path)
    monkeypatch.setenv(switch, "1")
    reader = port_class(kind)(str(path), "cpu").to_pcm()
    assert type(reader).__module__.startswith(
        ("audiotools_tpu_torch.ref.", "audiotools_tpu_torch.formats.flac"))
    reader.close()
    oracle = decode(kind, path)
    assert np.array_equal(oracle, default)
    assert np.array_equal(oracle, SAMPLES)


@pytest.mark.parametrize("kind", KINDS)
def test_a_switch_calls_no_kernel_wrapper(kind, tmp_path, monkeypatch):
    (_kind, switch, _cls, enc_ops, dec_ops) = BY_KIND[kind]
    counting = Counting(monkeypatch)
    path = tmp_path / ("default." + port_class(kind).SUFFIX)
    port_encode(kind, path)
    encoded = counting.take()
    decode(kind, path)
    decoded = counting.take()
    assert all(encoded[op] > 0 for op in enc_ops)
    assert all(decoded[op] > 0 for op in dec_ops)
    monkeypatch.setenv(switch, "1")
    oracle_path = tmp_path / ("oracle." + port_class(kind).SUFFIX)
    port_encode(kind, oracle_path)
    assert np.array_equal(decode(kind, oracle_path), SAMPLES)
    assert np.array_equal(decode(kind, path), SAMPLES)
    assert counting.take() == dict.fromkeys(WRAPPERS, 0)


def codec_round_trip(kind, device):
    """an encode and a decode through the codec's dispatchers alone, on
    ``device``; the decoded samples"""
    reader = pcm.reader_from_array(SAMPLES, 16)
    buf = io.BytesIO()
    if kind in ("flac", "oggflac"):
        from audiotools_tpu_torch.codecs import flac
        flac.encode_flac(buf, reader, device=device)
        buf.seek(0)
        decoder = flac.decoder_for_file(buf, device=device)
    elif kind == "alac":
        from audiotools_tpu_torch.formats import m4a
        m4a.write_m4a(buf, reader, device=device)
        buf.seek(0)
        from audiotools_tpu_torch.codecs import alac
        decoder = alac.decoder_for_file(buf, device=device)
    elif kind == "shn":
        from audiotools_tpu_torch.codecs import shn
        from audiotools_tpu_torch.formats.shn import wave_header
        shn.encode_shn(buf, reader, False, True,
                       wave_header(2, SR, 16, 3, SAMPLES.size * 2),
                       device=device)
        buf.seek(0)
        decoder = shn.decoder_for_file(buf, device=device)
    elif kind == "tta":
        from audiotools_tpu_torch.formats import tta
        tta.write_tta(buf, reader, device=device)
        buf.seek(0)
        from audiotools_tpu_torch.codecs import tta as tta_codec
        decoder = tta_codec.decoder_for_file(buf, device=device)
    else:
        from audiotools_tpu_torch.codecs import wavpack
        from audiotools_tpu_torch.formats.wavpack import write_wavpack
        write_wavpack(buf, reader, device=device)
        buf.seek(0)
        decoder = wavpack.decoder_for_file(buf, device=device)
    return pcm.read_all(decoder)


@pytest.mark.parametrize("kind", KINDS)
def test_a_switched_dispatcher_needs_no_card(kind, monkeypatch):
    """under the switch a "cuda" device is never resolved: the codec
    runs here, where there may be no card"""
    monkeypatch.setenv(BY_KIND[kind][1], "1")

    def no_card(device):
        raise AssertionError("the oracle path resolved %r" % (device,))

    for module in ("codecs.flac_enc_fast", "codecs.flac_dec",
                   "codecs.alac_fast", "codecs.alac_dec", "codecs.shn",
                   "codecs.tta", "codecs.wavpack"):
        mod = importlib.import_module("audiotools_tpu_torch." + module)
        monkeypatch.setattr(mod, "resolve_device", no_card)
    assert np.array_equal(codec_round_trip(kind, "cuda"), SAMPLES)


def break_card_path(monkeypatch):
    """every wrapper of WRAPPERS made to load the kernel library, whose
    build fails, as a card without nvcc would"""
    def failed_build():
        raise RuntimeError("nvcc failed (1): no CUDA toolkit")

    monkeypatch.setattr(kernels, "build", failed_build)
    monkeypatch.setattr(kernels, "_lib", None)
    for (module, attr) in WRAPPERS.values():
        monkeypatch.setattr(module, attr,
                            lambda *args, **kwargs: kernels.load())


@pytest.mark.parametrize("kind", KINDS)
def test_a_failed_kernel_build_raises_and_never_falls_back(kind, tmp_path,
                                                          monkeypatch):
    """with the kernels' build failing, the default path raises where it
    launches one (a decode, and the TTA, WavPack and Shorten encodes),
    and the same calls under the switch still run"""
    (_kind, switch, _cls, enc_ops, _dec_ops) = BY_KIND[kind]
    good = tmp_path / ("good." + port_class(kind).SUFFIX)
    port_encode(kind, good)
    break_card_path(monkeypatch)
    with pytest.raises(RuntimeError, match="nvcc failed"):
        decode(kind, good)
    if enc_ops:
        with pytest.raises(RuntimeError, match="nvcc failed"):
            port_encode(kind, tmp_path / ("bad." + port_class(kind).SUFFIX))
    monkeypatch.setenv(switch, "1")
    oracle = tmp_path / ("oracle." + port_class(kind).SUFFIX)
    port_encode(kind, oracle)
    assert np.array_equal(decode(kind, oracle), SAMPLES)
    assert np.array_equal(decode(kind, good), SAMPLES)


@pytest.mark.parametrize("kind", sorted(CARD_MODULES))
@pytest.mark.parametrize("side", ["encode", "decode"])
def test_a_card_module_that_fails_to_import_raises(kind, side, tmp_path,
                                                   monkeypatch):
    """the reference's FLAC and ALAC dispatchers fell back to the
    oracle on an ImportError; the port's raise it"""
    good = tmp_path / ("good." + port_class(kind).SUFFIX)
    port_encode(kind, good)
    module = CARD_MODULES[kind][0 if side == "encode" else 1]
    monkeypatch.setitem(sys.modules, "audiotools_tpu_torch.codecs." + module,
                        None)
    with pytest.raises(ImportError):
        if side == "encode":
            port_encode(kind, tmp_path / ("bad." + port_class(kind).SUFFIX))
        else:
            decode(kind, good)
    monkeypatch.setenv(BY_KIND[kind][1], "1")
    if side == "encode":
        port_encode(kind, tmp_path / ("oracle." + port_class(kind).SUFFIX))
    else:
        assert np.array_equal(decode(kind, good), SAMPLES)


def test_the_switches_are_read_at_each_call(tmp_path, monkeypatch):
    """a class made before the switch is set takes the oracle after"""
    from audiotools_tpu_torch.formats.flac import FlacAudio
    from audiotools_tpu_torch.ref.flac_dec import FlacDecoder
    path = tmp_path / "file.flac"
    port_encode("flac", path)
    track = FlacAudio(str(path), "cpu")
    reader = track.to_pcm()
    assert not isinstance(reader, FlacDecoder)
    reader.close()
    monkeypatch.setenv("ATPU_FLAC_ORACLE", "1")
    reader = track.to_pcm()
    assert isinstance(reader, FlacDecoder)
    reader.close()
    monkeypatch.setenv("ATPU_FLAC_ORACLE", "0")
    reader = track.to_pcm()
    assert not isinstance(reader, FlacDecoder)
    reader.close()
