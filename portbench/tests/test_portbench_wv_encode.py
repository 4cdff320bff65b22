"""The WavPack cell on the CPU: the plain reference encoder's bytes are
the port's (its ``encode_wavpack`` on the CPU and its all-host route
under ATPU_WV_ORACLE=1) on short seeded streams; the plain decoder gives
back the input; a block is encoded again from the state the stream
stores in it; the cell's driver passes its own check on a small album
and its control fails it; the new metrics' readers on fabricated
contexts.  The cell's 44,100-frame blocks are cut to 4,410 here, in the
configuration and the program's ``standard`` options alike, so that the
port's plain per-sample chains run in seconds: for the tests only."""

from __future__ import annotations

import io

import numpy as np
import pytest
import torch

from portbench import controls
from portbench.harness import cells, core
from portbench.reference import wavpack_dec, wavpack_enc
from portbench.tests import tiny

WORKLOAD = "wavpack_std_cd16.wv_album_encode"
BLOCK = 4410
# blocks of the streams compared with the program, short enough for its
# plain chains
SHORT = 1000
OVERRIDES = dict(album_shape=tiny.ALBUM, mix={"warm_blocks": [1]},
                 processes=tiny.PROCESSES)


def tone(n, channels=2, seed=7, level=8000.0, noise=30.0):
    rng = np.random.default_rng(seed)
    t = np.arange(n)
    x = np.stack([level * np.sin(t * 0.011 * (c + 1) + c) +
                  rng.normal(0, noise, n) for c in range(channels)], axis=1)
    return np.clip(np.round(x), -32768, 32767).astype(np.int32)


STREAMS = {
    "joint_stereo": lambda: tone(2 * SHORT + 321),
    "mono": lambda: tone(2 * SHORT + 17, channels=1),
    "false_stereo": lambda: np.repeat(tone(2 * SHORT + 5, channels=1), 2,
                                      axis=1),
    "silence": lambda: np.zeros((2 * SHORT + 3, 2), dtype=np.int32),
    "wasted_bits": lambda: tone(2 * SHORT + 9) & ~7,
    "stereo_false_stereo_stereo": lambda: np.concatenate([
        tone(SHORT), np.repeat(tone(SHORT, channels=1, seed=8), 2, axis=1),
        tone(SHORT // 3, seed=9)]),
    "loud_noise": lambda: np.random.default_rng(3).integers(
        -32768, 32768, (SHORT + 1, 2)).astype(np.int32),
    "one_frame_tail": lambda: tone(SHORT + 1),
    "stereo_then_silence": lambda: np.concatenate([
        tone(SHORT), np.zeros((SHORT + 2, 2), dtype=np.int32)]),
}
# streams whose blocks do not all decode: a one-channel block after a
# two-channel one is coded with channel 1's medians carried over, where
# a decoder starts them at 0, and in silence channel 0's median falls
# below 2, where the two choose the zero-run mode differently (the
# program's coder and the reference's alike; ROADMAP, Queue 3)
UNDECODABLE = {"stereo_then_silence"}


def program_stream(samples, device="cpu", block=SHORT):
    from audiotools_tpu_torch import pcm
    from audiotools_tpu_torch.codecs import wavpack
    sink = io.BytesIO()
    wavpack.encode_wavpack(sink, pcm.reader_from_array(samples, 16), block,
                           correlation_passes=5,
                           total_pcm_frames=samples.shape[0], device=device)
    return sink.getvalue()


@pytest.mark.parametrize("name", sorted(STREAMS))
def test_the_reference_encoder_gives_the_programs_bytes(name, monkeypatch):
    samples = STREAMS[name]()
    mine = wavpack_enc.encode_stream(samples, 44100, 16, SHORT)
    assert mine == program_stream(samples)
    monkeypatch.setenv("ATPU_WV_ORACLE", "1")
    assert mine == program_stream(samples)


@pytest.mark.parametrize("name", sorted(set(STREAMS) - {"silence"} -
                                        UNDECODABLE))
def test_the_plain_decoder_gives_back_the_input(name):
    samples = STREAMS[name]()
    blocks = wavpack_enc.split_blocks(
        wavpack_enc.encode_stream(samples, 44100, 16, SHORT))
    got = np.concatenate([wavpack_dec.decode_block(b) for b in blocks[:-1]])
    assert np.array_equal(got, samples)


def test_silence_decodes_to_silence():
    samples = STREAMS["silence"]()
    blocks = wavpack_enc.split_blocks(
        wavpack_enc.encode_stream(samples, 44100, 16, SHORT))
    assert all(wavpack_enc.header(b)["false_stereo"] for b in blocks[:-1])
    got = np.concatenate([wavpack_dec.decode_block(b) for b in blocks[:-1]])
    assert not got.any() and got.shape == samples.shape


def test_a_corrupt_block_does_not_decode():
    blocks = wavpack_enc.split_blocks(
        wavpack_enc.encode_stream(tone(SHORT), 44100, 16, SHORT))
    block = bytearray(blocks[0])
    block[-20] ^= 0x10
    with pytest.raises(wavpack_dec.MALFORMED):
        wavpack_dec.decode_block(bytes(block))


@pytest.mark.parametrize("name", ["joint_stereo", "mono", "wasted_bits"])
def test_a_block_is_encoded_again_from_its_stored_state(name):
    samples = STREAMS[name]()
    blocks = wavpack_enc.split_blocks(
        wavpack_enc.encode_stream(samples, 44100, 16, SHORT))
    for j in range(1, len(blocks) - 1):
        assert wavpack_enc.resumable(blocks[j])
        job = (samples[j * SHORT:(j + 2) * SHORT], [blocks[j]],
               blocks[j + 1] if j + 1 < len(blocks) - 1 else None, False,
               samples.shape[0], 44100, 16, wavpack_enc.STANDARD)
        counts = wavpack_dec.check_run(job)
        assert counts["blocks_checked"] == 1
        assert counts["blocks_differing"] == counts["states_differing"] == \
            counts["samples_wrong"] == 0


def test_a_false_stereo_block_of_a_stereo_stream_is_not_resumed():
    samples = STREAMS["stereo_false_stereo_stereo"]()
    blocks = wavpack_enc.split_blocks(
        wavpack_enc.encode_stream(samples, 44100, 16, SHORT))
    assert [wavpack_enc.resumable(b) for b in blocks[:-1]] == \
        [True, False, True]
    from portbench.drivers.wv_encode import WvEncodeDriver
    assert WvEncodeDriver.resume_from(blocks, 1) == 0
    assert WvEncodeDriver.resume_from(blocks, 2) == 2


def test_a_changed_block_fails_the_check():
    samples = tone(3 * SHORT)
    blocks = wavpack_enc.split_blocks(
        wavpack_enc.encode_stream(samples, 44100, 16, SHORT))
    other = wavpack_enc.split_blocks(wavpack_enc.encode_stream(
        samples ^ 1, 44100, 16, SHORT))
    job = (samples[SHORT:3 * SHORT], [other[1]], blocks[2], False,
           samples.shape[0], 44100, 16, wavpack_enc.STANDARD)
    counts = wavpack_dec.check_run(job)
    assert counts["blocks_differing"] == 1 and counts["samples_wrong"] > 0


@pytest.fixture
def small_blocks(monkeypatch):
    """the configuration's block and the program's standard block cut to
    BLOCK frames"""
    from audiotools_tpu_torch.formats import wavpack
    monkeypatch.setitem(wavpack.OPTIONS, "standard", dict(
        wavpack.OPTIONS["standard"], block_size=BLOCK))
    load = cells.load_json

    def load_json(*parts):
        out = load(*parts)
        if parts[-1] == "wavpack_std_cd16.json":
            out = dict(out, encode=dict(out["encode"], block_size=BLOCK))
        return out
    monkeypatch.setattr(cells, "load_json", load_json)
    torch.set_num_threads(1)


def test_the_driver_passes_its_check_on_the_cpu(small_blocks):
    (result, notes) = core.run_cell(tiny.ROOT, WORKLOAD, 2 ** 31 + 5, 0.3,
                                    False, device="cpu", **OVERRIDES)
    assert result["correct"], notes
    assert result["metrics"]["encode_Msamples_s"]["value"] > 0
    assert notes["blocks_checked"] >= 6 and notes["states_checked"] >= 4
    assert notes["counters"]["wv_frames_encoded"] == \
        notes["counters"]["wv_device_frames"] > 0
    assert notes["counters"]["wv_host_frames"] == 0
    timings = notes["timings"]["wv_encode_timings"]
    assert {"read", "md5", "decide", "correlate", "write", "host"} <= \
        set(timings)


def test_the_control_fails_the_check(small_blocks):
    (checks, counts) = controls.control_reading(
        tiny.ROOT, WORKLOAD, 6, 2, "cpu", **OVERRIDES)
    assert any(value > limit for (_n, value, limit) in checks), counts
    from audiotools_tpu_torch.ref import wavpack as program_ref
    # the program's rounding is back
    p = program_ref.CorrelationParameters(18, 2, [0], [[0, 0]])
    p.update_weights([1001])
    assert p.weights == [program_ref.restore_weight(
        program_ref.store_weight(1001))]


def ctx(driver="wv_encode", frames=10, trace=True, **timings):
    t = dict(read=0.01, md5=0.02, decide=0.03, write=0.04, correlate=0.05,
             upload=0.001, corr=0.03, fetch=0.001, host=0.1)
    t.update(timings)
    return dict(driver=driver, peak_bytes=1e8, peak_bytes_per_s=3.35e12,
                counters={"wv_frames_encoded": frames},
                wv_encode_timings=t,
                trace=dict(busy_s=1.0, window_s=4.0, launches=10, kernels={
                    "void (anonymous namespace)::wv_chain_kernel<true>("
                    "long const*)": dict(count=10, seconds=0.02),
                    "void (anonymous namespace)::wv_chain_kernel<false>("
                    "long const*)": dict(count=3, seconds=0.5)})
                if trace else None,
                kernel_bytes={"wv_corr": 0.011 * 3.35e12})


def read(name):
    return cells.metric_module(name).read


METRICS = ("host_ms_per_frame.wv_encode", "correlate_ms_per_frame.wv_encode",
           "wv_corr_roofline.wv_encode", "device_idle.wv_encode")


def test_the_metrics_values():
    c = ctx()
    assert read("host_ms_per_frame.wv_encode")(c) == pytest.approx(10.0)
    assert read("correlate_ms_per_frame.wv_encode")(c) == pytest.approx(5.0)
    assert read("wv_corr_roofline.wv_encode")(c) == pytest.approx(55.0)
    assert read("device_idle.wv_encode")(c) == pytest.approx(75.0)


@pytest.mark.parametrize("name", METRICS)
def test_no_metric_in_another_drivers_cell(name):
    assert read(name)(ctx(driver="encode")) is None


@pytest.mark.parametrize("name", METRICS[:2])
def test_nothing_from_a_program_without_the_spans(name):
    c = ctx()
    c["wv_encode_timings"] = dict(upload=0.1, corr=0.2, fetch=0.1, host=1.0)
    c["counters"] = {}
    assert read(name)(c) is None


def test_the_roofline_bound_of_a_standard_block():
    module = cells.metric_module("wv_corr_roofline.wv_encode")
    meta = [(0, 44100, 2, 5)]
    # PERF.md section 6: 1.352 ms, the slowest pass's chain plus the fill
    assert module.serial_floor_s(meta, 16) == pytest.approx(1.352e-3,
                                                             rel=1e-3)
    x = torch.zeros(88200, dtype=torch.int64)
    args = (x, torch.tensor(meta, dtype=torch.int64),
            torch.zeros((1, 16, 2), dtype=torch.int64),
            torch.zeros((1, 16, 2), dtype=torch.int64),
            torch.zeros((1, 16, 2, 8), dtype=torch.int64),
            torch.zeros_like(x), torch.zeros((1, 16, 2), dtype=torch.int64),
            torch.zeros((1, 16, 2, 8), dtype=torch.int64))
    moved = module.launch_bytes_moved(args)
    assert moved == pytest.approx(1.41e6, rel=0.01)
    assert module.launch_bytes(args, {}) == pytest.approx(
        module.serial_floor_s(meta, module.chunk_samples()) * 3.35e12)


def test_the_wavpack_reference_loads_nothing_of_the_program():
    import json
    import subprocess
    import sys
    proc = subprocess.run(
        [sys.executable, "-c",
         "import json, sys\n"
         "sys.path.insert(0, %r)\n"
         "import portbench.reference.wavpack_enc, "
         "portbench.reference.wavpack_dec\n"
         "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))"
         % (tiny.ROOT,)], cwd=tiny.ROOT, capture_output=True, text=True,
        timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    top = json.loads(proc.stdout.strip().splitlines()[-1])
    for name in ("audiotools_tpu_torch", "audiotools_tpu", "jax", "jaxlib",
                 "flax", "torch"):
        assert name not in top
