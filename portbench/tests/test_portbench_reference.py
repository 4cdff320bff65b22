"""The plain reference on the CPU: it decodes the port's streams to their
input, its encoder gives the port's frames, and its float32 controls
fail where the cells' checks must see them fail."""

from __future__ import annotations

import io

import numpy as np
import pytest
import torch

from portbench.drivers.encode import reference_option_fields
from portbench.harness import album, cells
from portbench.reference import batch, flac_decode, flac_enc
from portbench.tests import tiny


def config(name):
    return cells.load_json("configs", name + ".json")


def port_stream(samples, cfg):
    """the port's FLAC -8 stream of ``samples`` on the CPU (its plain
    versions), made by the port's own encoder"""
    from audiotools_tpu_torch import pcm
    from audiotools_tpu_torch.codecs.flac_enc_fast import encode_flac_fast
    sink = io.BytesIO()
    encode_flac_fast(sink, pcm.reader_from_array(
        samples, cfg["bits_per_sample"], cfg["sample_rate"]), device="cpu",
        batch_frames=tiny.BATCH_FRAMES, **cfg["encode"])
    return sink.getvalue()


def options(cfg):
    return flac_enc.EncodingOptions(*reference_option_fields(cfg))


def Format(cfg):
    return flac_enc.Stream(cfg["sample_rate"], cfg["bits_per_sample"],
                           cfg["channels"])


@pytest.fixture(scope="module", params=["flac8_cd16", "flac8_hires24"])
def made(request):
    cfg = config(request.param)
    # a seed whose tracks are loud: a float32 sum of products of 12-bit
    # coefficients and 16-bit samples rounds only past 2^24
    a = album.make_album(torch, cfg, 6, "cpu", album=tiny.ALBUM)
    samples = max((a.track(i) for i in range(len(a))),
                  key=lambda x: int(np.abs(x).max()))
    return (cfg, samples, port_stream(samples, cfg))


def test_the_reference_decodes_the_ports_stream_to_its_input(made):
    (cfg, samples, data) = made
    (info, decoded) = flac_decode.decode_stream(data)
    assert np.array_equal(decoded, samples)
    assert info["total_frames"] == samples.shape[0]
    assert info["md5"] == flac_decode.pcm_md5(samples,
                                              cfg["bits_per_sample"])


def test_the_reference_encoder_gives_the_ports_frames(made):
    (cfg, samples, data) = made
    (info, _seektable, offset) = flac_decode.parse_metadata(data)
    block = cfg["encode"]["block_size"]
    j = 0
    while offset < len(data):
        (number, _s, end) = flac_decode.decode_frame(data, offset, info)
        want = flac_enc.encode_frame(
            Format(cfg), options(cfg), j,
            samples[j * block:(j + 1) * block].astype(np.int64))
        assert number == j and bytes(data[offset:end]) == want
        (offset, j) = (end, j + 1)


def test_a_corrupt_frame_is_refused(made):
    (_cfg, _samples, data) = made
    (info, _seektable, offset) = flac_decode.parse_metadata(data)
    bad = bytearray(data)
    bad[offset + 40] ^= 0x10
    with pytest.raises(ValueError):
        flac_decode.decode_frame(bytes(bad), offset, info)


def test_the_float32_analysis_changes_frames(made):
    (cfg, samples, _data) = made
    block = cfg["encode"]["block_size"]
    frames = samples.shape[0] // block
    differ = sum(
        flac_enc.encode_frame(Format(cfg), options(cfg), j, x) !=
        flac_enc.encode_frame(Format(cfg), options(cfg), j, x, single=True)
        for j in range(frames)
        for x in [samples[j * block:(j + 1) * block].astype(np.int64)])
    assert differ > 0


def test_frames_are_found_and_decoded_from_any_frame_on(made, tmp_path):
    (cfg, samples, data) = made
    path = tmp_path / "x.flac"
    path.write_bytes(data)
    (info, seektable, first) = flac_decode.parse_metadata(data)
    block = cfg["encode"]["block_size"]
    frames = -(-samples.shape[0] // block)
    offsets = []
    offset = first
    while offset < len(data):
        offsets.append(offset)
        offset = flac_decode.decode_frame(data, offset, info)[2]
    for j in range(frames):
        assert flac_decode.find_frame(data, first, seektable, info, j) == \
            offsets[j]
    got = flac_decode.decode_run((str(path), 1, 2, False))
    assert np.array_equal(got, samples[block:3 * block])
    with pytest.raises(ValueError):
        flac_decode.find_frame(data, first, seektable, info, frames)


def test_worker_processes_give_what_one_process_gives(made):
    (cfg, samples, _data) = made
    block = cfg["encode"]["block_size"]
    stream = (cfg["sample_rate"], cfg["bits_per_sample"], cfg["channels"])
    jobs = [(stream, reference_option_fields(cfg), j,
             samples[j * block:(j + 1) * block].astype(np.int64), False)
            for j in range(2)]
    assert batch.run(flac_enc.encode_frame_job, jobs, 2) == \
        batch.run(flac_enc.encode_frame_job, jobs, 1)


def test_the_float32_synthesis_changes_samples(made):
    (_cfg, samples, data) = made
    (_info, decoded) = flac_decode.decode_stream(data, single=True)
    assert decoded.shape == samples.shape
    assert np.count_nonzero(decoded != samples) > 0
