"""The port's scalar oracles against the reference's, module by module.

``ref.flac_enc.encode_flac`` and ``ref.flac_dec.FlacDecoder``,
``ref.alac.encode_mdat`` and ``ALACDecoder``, ``ref.shn.encode_shn``
and ``SHNDecoder`` (its reads, ``pcm_split`` and ``pcm_head``),
``ref.tta.encode_tta`` and ``TTADecoder``, ``ref.wavpack``'s scalar
CRC, correlation and decorrelation passes, residual writer and reader
and its whole encoder and decoder under ATPU_WV_ORACLE=1,
``accuraterip_checksum.ChecksumV1``/``V2`` and
``formats.flac.OggFlacDecoder``: each run on the same inputs as the
reference's, at 8, 16 and 24 bits, mono, stereo and 6 channels where
the format takes them, on silence and with a final block of 1-3
frames; every output equal.  Two repairs are tested as differences
from the reference: the WavPack residual writer's ``_write_egc`` on a
numpy integer, and the Shorten scalar decoder on blocks of 1 and 2
samples.  Inputs are made from a numpy seed."""

import io

import numpy as np
import pytest
import torch

from audiotools_tpu import accuraterip_checksum as ref_ar
from audiotools_tpu import pcm as ref_pcm
from audiotools_tpu.formats.flac import OggFlacDecoder as RefOggFlacDecoder
from audiotools_tpu.formats.wavpack import WavPackAudio as RefWavPackAudio
from audiotools_tpu.ref import alac as ref_alac
from audiotools_tpu.ref import flac_dec as ref_flac_dec
from audiotools_tpu.ref import flac_enc as ref_flac_enc
from audiotools_tpu.ref import shn as ref_shn
from audiotools_tpu.ref import tta as ref_tta
from audiotools_tpu.ref import wavpack as ref_wv
from audiotools_tpu_torch import accuraterip_checksum as ar
from audiotools_tpu_torch import pcm
from audiotools_tpu_torch.codecs.shn import FastSHNDecoder
from audiotools_tpu_torch.formats.flac import OggFlacAudio, OggFlacDecoder
from audiotools_tpu_torch.formats.m4a import write_m4a
from audiotools_tpu_torch.formats.shn import wave_header
from audiotools_tpu_torch.formats.tta import write_tta
from audiotools_tpu_torch.formats.wavpack import WavPackAudio
from audiotools_tpu_torch.ref import alac, flac_dec, flac_enc, shn, tta
from audiotools_tpu_torch.ref import wavpack as wv

torch.set_num_threads(1)

MASKS = {1: 0x4, 2: 0x3, 6: 0x3F}
FLAC_8 = dict(block_size=4096, max_lpc_order=12,
              min_residual_partition_order=0,
              max_residual_partition_order=6, mid_side=True,
              adaptive_mid_side=False, exhaustive_model_search=False)


class ArrayReader:
    """a PCMReader of a fixed int32 [frames, channels] array, giving
    FrameLists of the package ``module`` (the port's pcm or the
    reference's)"""

    def __init__(self, module, samples, bps, rate=44100):
        self.module = module
        self.samples = samples
        self.bits_per_sample = bps
        self.sample_rate = rate
        self.channels = samples.shape[1]
        self.channel_mask = MASKS.get(self.channels, 0)
        self.position = 0

    def read(self, pcm_frames):
        chunk = self.samples[self.position:self.position + max(pcm_frames,
                                                               1)]
        self.position += chunk.shape[0]
        return self.module.FrameList._wrap(np.ascontiguousarray(chunk),
                                           self.bits_per_sample)

    def close(self):
        pass


def readers(samples, bps, rate=44100):
    """(the port's reader, the reference's reader) of the same samples"""
    return (ArrayReader(pcm, samples, bps, rate),
            ArrayReader(ref_pcm, samples, bps, rate))


def signal(kind, frames):
    """a seeded signal: (int32 samples [frames, channels], bps, rate)"""
    rng = np.random.default_rng(sum(map(ord, kind)) + frames)
    t = np.arange(frames)
    if kind == "silence":
        return (np.zeros((frames, 2), dtype=np.int32), 16, 44100)
    (channels, bps, rate) = {"mono8": (1, 8, 44100),
                             "stereo16": (2, 16, 44100),
                             "stereo24": (2, 24, 96000),
                             "ch6": (6, 16, 44100)}[kind]
    top = (1 << (bps - 1)) - 1
    tones = np.stack([
        0.4 * np.sin(2 * np.pi * (331 + 110 * c) * t / rate + c) +
        0.2 * np.sin(2 * np.pi * (1201 + 37 * c) * t / rate)
        for c in range(channels)], axis=1)
    noise = rng.normal(0, 0.01, (frames, channels))
    return (np.clip(np.round((tones + noise) * top), -top - 1,
                    top).astype(np.int32), bps, rate)


def drain(reader):
    """every sample of a PCMReader of either package, int32"""
    pieces = []
    while True:
        framelist = reader.read(4096)
        if framelist.frames == 0:
            break
        pieces.append(np.asarray(framelist.samples, dtype=np.int32))
    return (np.concatenate(pieces) if pieces else
            np.zeros((0, reader.channels), dtype=np.int32))


# (signal kind, frames): the edge titles; "tail" cases are lengths with
# a final block of 1-3 frames for the block size the test gives
EDGES = [("mono8", 3000), ("stereo16", 5000), ("stereo24", 3000),
         ("ch6", 2000), ("silence", 2000)]


def with_tail(block, edges=EDGES, takes=(8, 16, 24)):
    cases = [(kind, frames) for (kind, frames) in edges
             if signal(kind, 8)[1] in takes]
    return cases + [("stereo16", 2 * block + 1), ("stereo16", 2 * block + 3)]


# ---- FLAC -----------------------------------------------------------------

@pytest.mark.parametrize("kind,frames", with_tail(4096))
def test_flac_encoder_and_decoder_equal_the_references(kind, frames):
    (samples, bps, rate) = signal(kind, frames)
    (mine, theirs) = readers(samples, bps, rate)
    (buf, ref_buf) = (io.BytesIO(), io.BytesIO())
    offsets = flac_enc.encode_flac(buf, mine, padding_bytes=4096, **FLAC_8)
    ref_offsets = ref_flac_enc.encode_flac(ref_buf, theirs,
                                           padding_bytes=4096, **FLAC_8)
    assert buf.getvalue() == ref_buf.getvalue()
    assert offsets == ref_offsets
    got = drain(flac_dec.FlacDecoder(io.BytesIO(buf.getvalue())))
    want = drain(ref_flac_dec.FlacDecoder(io.BytesIO(buf.getvalue())))
    assert np.array_equal(got, want)
    assert np.array_equal(got, samples)


def test_flac_decoder_checks_the_md5_as_the_reference():
    (samples, bps, rate) = signal("stereo16", 3000)
    buf = io.BytesIO()
    flac_enc.encode_flac(buf, ArrayReader(pcm, samples, bps, rate),
                         padding_bytes=None, **FLAC_8)
    data = bytearray(buf.getvalue())
    data[8 + 18] ^= 0xFF            # a byte of STREAMINFO's MD5
    for decoder in (flac_dec.FlacDecoder, ref_flac_dec.FlacDecoder):
        with pytest.raises(ValueError, match="MD5"):
            drain(decoder(io.BytesIO(bytes(data))))


# ---- Ogg FLAC ---------------------------------------------------------------

@pytest.mark.parametrize("kind,frames", EDGES)
def test_ogg_flac_decoder_equals_the_references(kind, frames, tmp_path):
    (samples, bps, rate) = signal(kind, frames)
    path = str(tmp_path / "file.oga")
    OggFlacAudio.from_pcm(path, ArrayReader(pcm, samples, bps, rate), "8",
                          device="cpu")
    decoder = OggFlacDecoder(path)
    ref_decoder = RefOggFlacDecoder(path)
    for attr in ("sample_rate", "channels", "bits_per_sample"):
        assert getattr(decoder, attr) == getattr(ref_decoder, attr)
    assert decoder.channel_mask == int(ref_decoder.channel_mask)
    got = drain(decoder)
    decoder.close()
    want = drain(ref_decoder)
    ref_decoder.close()
    assert np.array_equal(got, want)
    assert np.array_equal(got, samples)


# ---- ALAC -------------------------------------------------------------------

@pytest.mark.parametrize("kind,frames", with_tail(4096, takes=(16, 24)))
def test_alac_encoder_and_decoder_equal_the_references(kind, frames,
                                                       monkeypatch):
    (samples, bps, rate) = signal(kind, frames)
    (mine, theirs) = readers(samples, bps, rate)
    (buf, ref_buf) = (io.BytesIO(), io.BytesIO())
    sizes = alac.encode_mdat(buf, mine)
    ref_sizes = ref_alac.encode_mdat(ref_buf, theirs)
    assert buf.getvalue() == ref_buf.getvalue()
    assert sizes == ref_sizes
    monkeypatch.setenv("ATPU_ALAC_ORACLE", "1")
    m4a = io.BytesIO()
    write_m4a(m4a, ArrayReader(pcm, samples, bps, rate),
              create_date=3786825600)
    got = drain(alac.ALACDecoder(io.BytesIO(m4a.getvalue())))
    want = drain(ref_alac.ALACDecoder(io.BytesIO(m4a.getvalue())))
    assert np.array_equal(got, want)
    assert np.array_equal(got, samples)


# ---- Shorten ----------------------------------------------------------------

def shn_streams(samples, bps, rate, block_size=256):
    """(the port's stream, the reference's) of the scalar encoders, a
    WAVE header and a footer in VERBATIM chunks, 8-bit unsigned"""
    channels = samples.shape[1]
    header = wave_header(channels, rate, bps, MASKS.get(channels, 0),
                         samples.size * (bps // 8))
    footer = b"LIST\x04\x00\x00\x00abcd"
    (mine, theirs) = readers(samples, bps, rate)
    (buf, ref_buf) = (io.BytesIO(), io.BytesIO())
    shn.encode_shn(buf, mine, False, bps != 8, header, footer, block_size)
    ref_shn.encode_shn(ref_buf, theirs, False, bps != 8, header, footer,
                       block_size)
    return (buf.getvalue(), ref_buf.getvalue(), header, footer)


@pytest.mark.parametrize("kind,frames", with_tail(256, takes=(8, 16)))
def test_shorten_encoder_and_decoder_equal_the_references(kind, frames):
    (samples, bps, rate) = signal(kind, frames)
    (data, ref_data, header, footer) = shn_streams(samples, bps, rate)
    assert data == ref_data
    decoder = shn.SHNDecoder(io.BytesIO(data))
    ref_decoder = ref_shn.SHNDecoder(io.BytesIO(data))
    for attr in ("sample_rate", "channels", "bits_per_sample",
                 "channel_mask"):
        assert getattr(decoder, attr) == getattr(ref_decoder, attr)
    got = drain(decoder)
    assert np.array_equal(got, drain(ref_decoder))
    assert np.array_equal(got, samples)
    assert shn.SHNDecoder(io.BytesIO(data)).pcm_split() == \
        ref_shn.SHNDecoder(io.BytesIO(data)).pcm_split() == (header, footer)
    assert shn.SHNDecoder(io.BytesIO(data)).pcm_head() == \
        ref_shn.SHNDecoder(io.BytesIO(data)).pcm_head() == header


@pytest.mark.parametrize("block_size", [1, 2])
def test_shorten_short_blocks_decode_as_the_cxx_decoder(block_size):
    """a difference from the reference: its scalar decoder raises
    IndexError on a DIFF block after a block of 1 or 2 samples; the
    port's keeps the older samples, as the C++ decoder does, and the
    two agree (the encoders' bytes stay the reference's)"""
    (samples, bps, rate) = signal("stereo16", 301)
    (data, ref_data, _h, _f) = shn_streams(samples, bps, rate, block_size)
    assert data == ref_data
    with pytest.raises(IndexError):
        drain(ref_shn.SHNDecoder(io.BytesIO(data)))
    got = drain(shn.SHNDecoder(io.BytesIO(data)))
    want = drain(FastSHNDecoder(io.BytesIO(data)))
    assert got.shape == samples.shape
    assert np.array_equal(got, want)


@pytest.mark.parametrize("block_size", [3, 256])
def test_shorten_blocks_of_three_and_up_decode_to_the_input(block_size):
    (samples, bps, rate) = signal("stereo16", 2 * block_size + 1)
    (data, _ref, _h, _f) = shn_streams(samples, bps, rate, block_size)
    assert np.array_equal(drain(shn.SHNDecoder(io.BytesIO(data))), samples)
    assert np.array_equal(drain(ref_shn.SHNDecoder(io.BytesIO(data))),
                          samples)


# ---- TTA --------------------------------------------------------------------

@pytest.mark.parametrize("kind,frames", with_tail(8359))
def test_tta_encoder_and_decoder_equal_the_references(kind, frames,
                                                      monkeypatch):
    (samples, bps, _rate) = signal(kind, frames)
    rate = 8000            # 8359-frame TTA frames: the plain loops stay short
    (mine, theirs) = readers(samples, bps, rate)
    (buf, ref_buf) = (io.BytesIO(), io.BytesIO())
    sizes = tta.encode_tta(buf, pcm.BufferedPCMReader(mine))
    from audiotools_tpu.pcmstream import BufferedPCMReader
    ref_sizes = ref_tta.encode_tta(ref_buf, BufferedPCMReader(theirs))
    assert buf.getvalue() == ref_buf.getvalue()
    assert sizes == ref_sizes
    monkeypatch.setenv("ATPU_TTA_ORACLE", "1")
    stream = io.BytesIO()
    write_tta(stream, ArrayReader(pcm, samples, bps, rate))
    got = drain(tta.TTADecoder(io.BytesIO(stream.getvalue())))
    want = drain(ref_tta.TTADecoder(io.BytesIO(stream.getvalue())))
    assert np.array_equal(got, want)
    assert np.array_equal(got, samples)


def test_tta_crc_classes_equal_the_references():
    data = np.random.default_rng(5).integers(0, 256, 5000,
                                             dtype=np.uint8).tobytes()
    (crc, ref_crc) = (tta.CRC32(), ref_tta.CRC32())
    for byte in data:
        crc.update(byte)
        ref_crc.update(byte)
    assert int(crc) == int(ref_crc) == tta.crc32(data) == ref_tta.crc32(data)


# ---- WavPack ----------------------------------------------------------------

TERMS = [18, 17, 1, 2, 3, 4, 5, 6, 7, 8, -1, -2, -3]


def wv_channels(rng, n, amplitude):
    t = np.arange(n)
    return [np.round(amplitude * np.sin(2 * np.pi * (300 + 170 * c) * t /
                                        44100) +
                     rng.normal(0, amplitude / 20, n)).astype(np.int64)
            for c in range(2)]


@pytest.fixture
def scalar_reference(monkeypatch):
    """both packages' WavPack modules on their scalar branches"""
    monkeypatch.setenv("ATPU_WV_ORACLE", "1")


@pytest.mark.parametrize("term", TERMS)
def test_wavpack_passes_equal_the_references(term, scalar_reference):
    rng = np.random.default_rng(100 + term)
    channels = wv_channels(rng, 1500, 3000)
    span = 2 if term >= 17 else (term if term > 0 else 1)
    samples = [rng.integers(-500, 500, span).tolist() for _ in range(2)]
    weights = [int(w) for w in rng.integers(-600, 600, 2)]
    if term > 0:
        got = wv.correlation_pass_1ch(channels[0].tolist(), term, 2,
                                      weights[0], samples[0])
        want = ref_wv.correlation_pass_1ch(channels[0].tolist(), term, 2,
                                           weights[0], samples[0])
        assert got == want
        back = wv._decorrelation_pass_1ch(got[0], term, 2, weights[0],
                                          samples[0])
        assert back == ref_wv._decorrelation_pass_1ch(
            got[0], term, 2, weights[0], samples[0])
        assert back == channels[0].tolist()
    lists = [c.tolist() for c in channels]
    got = wv.correlation_pass_2ch(lists, term, 2, weights, samples)
    want = ref_wv.correlation_pass_2ch(lists, term, 2, weights, samples)
    assert got == want
    back = wv._decorrelation_pass_2ch(got[0], term, 2, weights, samples)
    assert back == ref_wv._decorrelation_pass_2ch(got[0], term, 2, weights,
                                                  samples)
    assert back == lists


def test_wavpack_crc_equals_the_references_and_the_cxx(monkeypatch):
    rng = np.random.default_rng(3)
    channels = [rng.integers(-(1 << 23), 1 << 23, 3000) for _ in range(2)]
    native = wv.calculate_crc(channels)
    monkeypatch.setenv("ATPU_WV_ORACLE", "1")
    for count in (1, 2):
        assert wv.calculate_crc(channels[:count]) == \
            ref_wv.calculate_crc(channels[:count])
    assert wv.calculate_crc(channels) == native


@pytest.mark.parametrize("amplitude", [0, 3, 40])
@pytest.mark.parametrize("count", [1, 2])
def test_wavpack_residual_coder_equals_the_references(amplitude, count,
                                                      monkeypatch):
    """small residuals, which the reference's scalar writer takes; the
    port's scalar reader and writer against its C++ ones too"""
    from audiotools_tpu.bitstream import BitstreamRecorder as RefRecorder
    from audiotools_tpu_torch.bitstream import (BitstreamReader,
                                                BitstreamRecorder)
    rng = np.random.default_rng(amplitude + 10 * count)
    channels = [np.round(rng.normal(0, amplitude, 2000)).astype(np.int64)
                for _ in range(count)]
    entropies = [[0, 0, 0], [0, 0, 0]]
    native = BitstreamRecorder(little_endian=True)
    native_entropies = [list(e) for e in entropies]
    wv.write_bitstream(native, channels, native_entropies)
    monkeypatch.setenv("ATPU_WV_ORACLE", "1")
    (mine, theirs) = (BitstreamRecorder(little_endian=True),
                      RefRecorder(True))
    (mine_e, theirs_e) = ([list(e) for e in entropies],
                          [list(e) for e in entropies])
    wv.write_bitstream(mine, channels, mine_e)
    ref_wv.write_bitstream(theirs, [c.tolist() for c in channels], theirs_e)
    mine.byte_align()
    theirs.byte_align()
    native.byte_align()
    assert mine.data() == theirs.data() == native.data()
    assert mine_e == theirs_e == native_entropies
    data = mine.data()
    got = wv.read_bitstream(BitstreamReader(data, little_endian=True), data,
                            2000, count, [list(e) for e in entropies])
    assert [list(map(int, c)) for c in got] == [c.tolist() for c in channels]


def test_wavpack_write_egc_takes_numpy_integers(tmp_path, monkeypatch):
    """a difference from the reference: with ATPU_WV_ORACLE=1 its
    encoder raises AttributeError at the first escape code (a numpy
    integer's bit_length); the port's writes the card path's bytes"""
    from audiotools_tpu.pcmstream import PCMReader as RefPCMReader
    (samples, bps, rate) = signal("stereo16", 12000)
    default = io.BytesIO()
    from audiotools_tpu_torch.formats.wavpack import write_wavpack
    write_wavpack(default, ArrayReader(pcm, samples, bps, rate),
                  device="cpu")
    monkeypatch.setenv("ATPU_WV_ORACLE", "1")
    oracle = io.BytesIO()
    write_wavpack(oracle, ArrayReader(pcm, samples, bps, rate),
                  device="cpu")
    assert oracle.getvalue() == default.getvalue()
    fl = ref_pcm.FrameList._wrap(samples, 16)
    with pytest.raises(Exception) as raised:
        RefWavPackAudio.from_pcm(str(tmp_path / "ref.wv"), RefPCMReader(
            io.BytesIO(fl.to_bytes(False, True)), rate, 2, 3, 16))
    text = repr(raised.value) + repr(raised.value.__context__)
    assert "bit_length" in text


@pytest.mark.parametrize("kind,frames", with_tail(1000))
def test_wavpack_oracle_equals_the_references(kind, frames, monkeypatch):
    """the reference's encoder on its C++ branches (its scalar writer
    raises on these signals), the port's on its scalar ones; both
    decoders scalar"""
    (samples, bps, rate) = signal(kind, frames)
    (mine, theirs) = readers(samples, bps, rate)
    ref_buf = io.BytesIO()
    ref_wv.encode_wavpack(ref_buf, theirs, 1000, correlation_passes=5)
    monkeypatch.setenv("ATPU_WV_ORACLE", "1")
    buf = io.BytesIO()
    wv.encode_wavpack(buf, mine, 1000, correlation_passes=5)
    assert buf.getvalue() == ref_buf.getvalue()
    got = drain(wv.WavPackDecoder(io.BytesIO(buf.getvalue())))
    want = drain(ref_wv.WavPackDecoder(io.BytesIO(buf.getvalue())))
    assert np.array_equal(got, want)
    assert np.array_equal(got, samples)


def test_wavpack_file_class_takes_the_oracle(tmp_path, monkeypatch):
    (samples, bps, rate) = signal("ch6", 3000)
    monkeypatch.setenv("ATPU_WV_ORACLE", "1")
    path = str(tmp_path / "file.wv")
    WavPackAudio.from_pcm(path, ArrayReader(pcm, samples, bps, rate),
                          device="cpu")
    reader = WavPackAudio(path, "cpu").to_pcm()
    assert isinstance(reader, wv.WavPackDecoder)
    assert np.array_equal(drain(reader), samples)


# ---- AccurateRip ------------------------------------------------------------

@pytest.mark.parametrize("first,last", [(False, False), (True, False),
                                        (False, True), (True, True)])
def test_checksums_equal_the_references_and_accuraterip_crc(first, last):
    rng = np.random.default_rng(int(first) * 2 + int(last))
    samples = rng.integers(-32768, 32768, (30000, 2)).astype(np.int32)
    sums = [ar.ChecksumV1(first, last, 44100, len(samples)),
            ar.ChecksumV2(first, last, 44100, len(samples))]
    ref_sums = [ref_ar.ChecksumV1(first, last, 44100, len(samples)),
                ref_ar.ChecksumV2(first, last, 44100, len(samples))]
    crc = ar.AccurateRipCRC(first, last, 44100, len(samples), device="cpu")
    for a in range(0, len(samples), 7001):
        chunk = samples[a:a + 7001]
        for s in sums:
            s.update(pcm.FrameList._wrap(chunk, 16))
        for s in ref_sums:
            s.update(ref_pcm.FrameList._wrap(chunk, 16))
        crc.update_array(chunk)
    got = [s.checksum() for s in sums]
    assert got == [s.checksum() for s in ref_sums]
    assert tuple(got) == tuple(crc.checksums())


def test_checksums_refuse_what_the_references_refuse():
    for module in (ar, ref_ar):
        with pytest.raises(ValueError):
            module.ChecksumV1(False, False, 0, 10)
        with pytest.raises(ValueError):
            module.ChecksumV2(False, False, 44100, 0)
    check = ar.ChecksumV1(False, False, 44100, 10)
    with pytest.raises(ValueError):
        check.update(pcm.FrameList._wrap(np.zeros((4, 1), np.int32), 16))
    with pytest.raises(ValueError):
        check.update(pcm.FrameList._wrap(np.zeros((4, 2), np.int32), 24))
