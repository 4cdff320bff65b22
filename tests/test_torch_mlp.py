"""The port's MLP decoders against the reference's: the port's host C++
decoder (``_native.MLPDecoderHandle``) and its scalar oracle
(``ref.mlp.MLPDecoder``) decode the streams that the reference's
``MLPEncoder`` and ``MLPEncoderMulti`` write, over the whole feature
matrix (codebooks 0-3, FIR and IIR filters, matrices with noise,
output shifts, quant step sizes, 24-bit, mono, 96 kHz, 3-6 channels),
sample for sample with the reference's decoders and the input; they
refuse corrupt checkdata and a frame before the major sync with the
reference's errors, and consume a partial buffer as the reference's
does.  The port's encoders write the reference's bytes."""

import numpy as np
import pytest

from audiotools_tpu import _native as ref_native
from audiotools_tpu.ref import mlp as ref_mlp
from audiotools_tpu_torch import _native
from audiotools_tpu_torch.ref import mlp

MATRICES = [dict(out_channel=0, coeff=[1 << 14, 1 << 12, 5 << 6, 0],
                 lsb_bypass=1),
            dict(out_channel=1, coeff=[-(1 << 12), 1 << 14, 0, 9 << 6],
                 lsb_bypass=1)]

# (name, encoder options, channels, amplitude)
CASES = [
    ("codebook0", dict(codebook=0, huffman_lsbs=16), 2, 6000),
    ("codebook1", dict(codebook=1, huffman_lsbs=16), 2, 6000),
    ("codebook2", dict(codebook=2, huffman_lsbs=16), 2, 6000),
    ("codebook3", dict(codebook=3, huffman_lsbs=16), 2, 6000),
    ("fir", dict(codebook=1, huffman_lsbs=16, fir_coeff=[256, -128],
                 filter_shift=8), 2, 6000),
    ("iir", dict(codebook=2, huffman_lsbs=16, iir_coeff=[64],
                 filter_shift=8), 2, 6000),
    ("matrices-noise", dict(codebook=3, huffman_lsbs=18, matrices=MATRICES,
                            fir_coeff=[300, -100, 25], iir_coeff=[40],
                            filter_shift=9, noise_shift=2), 2, 12000),
    ("quant-step", dict(codebook=1, huffman_lsbs=16,
                        quant_step_size=[2, 2]), 2, 6000),
    ("output-shift", dict(codebook=1, huffman_lsbs=14,
                          output_shift=[2, 2]), 2, 6000),
    ("mono", dict(codebook=2, huffman_lsbs=16), 1, 6000),
    ("24-bit", dict(bits_per_sample=24, codebook=1, huffman_lsbs=22), 2,
     4_000_000),
    ("24-bit-mono", dict(bits_per_sample=24, codebook=3, huffman_lsbs=22,
                         fir_coeff=[200, -90], filter_shift=8), 1,
     3_000_000),
    ("96k", dict(sample_rate=96000, codebook=2, huffman_lsbs=16), 2, 6000),
    ("no-checkdata", dict(codebook=0, huffman_lsbs=16, checkdata=False), 2,
     6000),
    ("3ch", dict(codebook=1, huffman_lsbs=15, fir_coeff=[200, -90],
                 filter_shift=8), 3, 6000),
    ("4ch", dict(codebook=1, huffman_lsbs=15, fir_coeff=[200, -90],
                 filter_shift=8), 4, 6000),
    ("5ch", dict(codebook=2, huffman_lsbs=15, iir_coeff=[40],
                 filter_shift=8), 5, 6000),
    ("6ch", dict(codebook=1, huffman_lsbs=15, fir_coeff=[200, -90],
                 filter_shift=8), 6, 6000),
]
FRAME = 160
FRAMES = 3


def case_data(options, channels, amp, seed=7):
    rng = np.random.RandomState(seed)
    data = rng.randint(-amp, amp, size=(FRAME * FRAMES, channels)).astype(
        np.int64)
    shift = max(options.get("quant_step_size") or
                options.get("output_shift") or [0])
    return (data >> shift) << shift


def encode(package, options, channels, data):
    """the stream of ``data`` from ``package``'s MLP encoder"""
    options = dict(options)
    if channels > 2:
        enc = package.MLPEncoderMulti(channels=channels, **options)
    else:
        enc = package.MLPEncoder(channels=channels, block_size=40,
                                 **options)
    return b"".join(enc.encode_frame(data[i * FRAME:(i + 1) * FRAME])
                    for i in range(FRAMES))


def oracle_decode(package, stream):
    (frames, leftover) = package.split_frames(stream)
    assert not leftover
    dec = package.MLPDecoder()
    return np.concatenate([dec.decode_frame(f) for f in frames])


def native_decode(handle_class, stream):
    handle = handle_class()
    (samples, consumed) = handle.decode(stream)
    attrs = (handle.sample_rate, handle.channels, handle.bits_per_sample)
    handle.close()
    return (samples, consumed, attrs)


@pytest.fixture(scope="module")
def streams():
    out = {}
    for (name, options, channels, amp) in CASES:
        data = case_data(options, channels, amp)
        out[name] = (data, encode(ref_mlp, options, channels, data))
    return out


@pytest.mark.parametrize("name", [c[0] for c in CASES])
def test_decoders_give_the_references_samples(streams, name):
    (data, stream) = streams[name]
    (port, consumed, attrs) = native_decode(_native.MLPDecoderHandle, stream)
    (ref, ref_consumed, ref_attrs) = native_decode(
        ref_native.MLPDecoderHandle, stream)
    assert port.dtype == ref.dtype == np.int32
    assert np.array_equal(port, ref) and np.array_equal(port, data)
    assert (consumed, attrs) == (ref_consumed, ref_attrs)
    assert consumed == len(stream)
    assert attrs[1] == data.shape[1]
    oracle = oracle_decode(mlp, stream)
    assert np.array_equal(oracle, oracle_decode(ref_mlp, stream))
    assert np.array_equal(oracle, data)


@pytest.mark.parametrize("name", [c[0] for c in CASES])
def test_encoders_write_the_references_bytes(streams, name):
    (options, channels) = [(c[1], c[2]) for c in CASES if c[0] == name][0]
    (data, stream) = streams[name]
    assert encode(mlp, options, channels, data) == stream


def errors(fn):
    try:
        fn()
    except Exception as err:  # noqa: BLE001 - compared below
        return (type(err).__name__, str(err))
    return None


@pytest.mark.parametrize("offset,bit", [(40, 0x10), (60, 0x01), (-3, 0x80)])
def test_corrupt_checkdata_is_refused_as_the_reference_refuses_it(
        streams, offset, bit):
    stream = bytearray(streams["codebook0"][1])
    stream[offset] ^= bit
    stream = bytes(stream)
    port = errors(lambda: native_decode(_native.MLPDecoderHandle, stream))
    ref = errors(lambda: native_decode(ref_native.MLPDecoderHandle, stream))
    assert port == ref and port is not None
    (frames, _leftover) = mlp.split_frames(stream)

    def decode_all(package):
        dec = package.MLPDecoder()
        for f in frames:
            dec.decode_frame(f)

    assert errors(lambda: decode_all(mlp)) == errors(
        lambda: decode_all(ref_mlp))
    assert errors(lambda: decode_all(mlp)) is not None


def test_a_frame_before_the_sync_is_refused_as_the_reference_refuses_it(
        streams):
    stream = streams["fir"][1]
    (frames, _leftover) = mlp.split_frames(stream)
    port = errors(lambda: mlp.MLPDecoder().decode_frame(frames[1]))
    assert port == errors(lambda: ref_mlp.MLPDecoder().decode_frame(
        frames[1]))
    assert port[0] == "ValueError"
    # the native decoders given the stream from its second frame on
    rest = stream[len(stream) - sum(len(f) + 4 for f in frames[1:]):]
    port = errors(lambda: native_decode(_native.MLPDecoderHandle, rest))
    assert port == errors(lambda: native_decode(
        ref_native.MLPDecoderHandle, rest))


@pytest.mark.parametrize("cut", [1, 3, 7, 50])
def test_partial_buffers_are_consumed_as_the_reference_consumes_them(
        streams, cut):
    stream = streams["codebook1"][1]
    port = _native.MLPDecoderHandle()
    ref = ref_native.MLPDecoderHandle()
    (out, consumed) = port.decode(stream[:-cut])
    (ref_out, ref_consumed) = ref.decode(stream[:-cut])
    assert consumed == ref_consumed < len(stream) - cut
    assert np.array_equal(out, ref_out)
    (out2, consumed2) = port.decode(stream[consumed:])
    (ref_out2, ref_consumed2) = ref.decode(stream[ref_consumed:])
    assert consumed2 == ref_consumed2 == len(stream) - consumed
    assert np.array_equal(np.concatenate([out, out2]),
                          streams["codebook1"][0])
    assert np.array_equal(out2, ref_out2)
    port.close()
    ref.close()


def test_split_frames_and_tables_are_the_references(streams):
    stream = streams["6ch"][1]
    for cut in (0, 5, 9):
        data = stream[:len(stream) - cut]
        (frames, leftover) = mlp.split_frames(data)
        (ref_frames, ref_leftover) = ref_mlp.split_frames(data)
        assert (frames, leftover) == (ref_frames, ref_leftover)
    assert list(mlp.CRC8_TABLE) == list(ref_mlp.CRC8_TABLE)
    assert mlp.CHANNEL_COUNT == ref_mlp.CHANNEL_COUNT
