"""The harness on the CPU: cells found by name, inputs made from the seed,
the byte counts behind the roofline shares, the metric arithmetic and
the trace's reduction."""

from __future__ import annotations

import json
import os

import numpy as np
import pytest
import torch

from portbench.harness import album, cells, trace, window
from portbench.tests import tiny


def bench():
    return cells.load_benchmark(tiny.ROOT)


@pytest.mark.parametrize("workload", tiny.WORKLOADS)
def test_cells_find_their_files_by_name(workload):
    cell = cells.Cell(bench(), workload)
    assert cell.config["name"] == cell.entry["config"]
    driver = cells.driver_class(cell.mix["driver"])
    for method in ("setup", "run", "end_to_end", "layer_context",
                   "counters", "release", "check", "control"):
        assert callable(getattr(driver, method))
    assert any(m["name"] == "setup_s" for m in cell.end_to_end)
    assert len(cell.end_to_end) >= 2 and cell.per_layer
    moved = {m["name"] for m in cell.end_to_end}
    for m in cell.per_layer:
        assert m["moves"] in moved
        assert callable(cells.metric_module(m["name"]).read)


def test_every_named_file_exists():
    b = bench()
    for c in b["configs"]:
        assert os.path.exists(os.path.join(tiny.ROOT, c["file"]))
        with open(os.path.join(tiny.ROOT, c["file"])) as f:
            assert json.load(f)["source"] == c["source"]
    for w in b["workloads"]:
        assert os.path.exists(os.path.join(
            cells.BENCH_DIR, "traffic", w["traffic"] + ".json"))
    for m in b["per_layer"]:
        assert os.path.exists(os.path.join(cells.BENCH_DIR, "metrics",
                                           m["name"] + ".py"))


def test_an_unknown_workload_is_refused():
    with pytest.raises(KeyError):
        cells.Cell(bench(), "no_such.cell")


def test_a_driver_is_found_by_its_name(monkeypatch):
    import sys
    import types
    probe = types.ModuleType("portbench.drivers.probe")
    probe.Driver = object
    monkeypatch.setitem(sys.modules, "portbench.drivers.probe", probe)
    assert cells.driver_class("probe") is object
    for name in ("common", "../run", "no_such_driver"):
        with pytest.raises((ValueError, ImportError)):
            cells.driver_class(name)


def test_frames_kept_for_the_check_span_the_card_path():
    from portbench.drivers.encode import pick_frames
    rng = np.random.default_rng(1)
    # 2,600 frames: two full batches of 1,024, a partial batch of 551
    # and the tail block
    (picks, tail) = pick_frames(2600, 1024, rng, 4, 8)
    assert tail == 2599 and tail not in picks
    assert len([j for j in picks if 2048 <= j < 2599]) == 4
    stripe = [j for j in picks if j < 2048]
    assert len(stripe) == 8 and max(np.diff(stripe)) <= 257
    # a stream shorter than a batch: its partial batch alone
    (picks, tail) = pick_frames(3, 1024, rng, 4, 8)
    assert (picks, tail) == ([0, 1], 2)


def small_album(seed, config="flac8_cd16"):
    cfg = cells.load_json("configs", config + ".json")
    return album.make_album(torch, cfg, seed, "cpu", album=tiny.ALBUM)


@pytest.mark.parametrize("config", ["flac8_cd16", "flac8_hires24"])
def test_the_album_is_the_seeds(config):
    (a, b, c) = (small_album(7, config), small_album(7, config),
                 small_album(8, config))
    assert np.array_equal(a.samples, b.samples) and a.bounds == b.bounds
    assert not np.array_equal(a.samples, c.samples)
    # every seed asks for the same work: the same lengths in one order
    assert a.bounds == c.bounds
    bits = a.bits
    assert a.samples.max() < (1 << (bits - 1))
    assert a.samples.min() >= -(1 << (bits - 1))


def test_the_album_has_no_wasted_bits_and_a_full_width_floor():
    a = small_album(3, "flac8_hires24")
    for i in range(len(a)):
        for block in np.array_split(a.track(i), 8):
            assert np.bitwise_or.reduce(block, axis=0).min() & 1
    # a 24-bit floor, never a 16-bit signal padded
    assert np.count_nonzero(a.samples & 0xFF) > 0.9 * a.samples.size


def test_track_lengths_follow_the_album_shape():
    shape = {"tracks": 12, "median_s": 240.0, "sigma": 0.5, "min_s": 60.0,
             "max_s": 600.0}
    frames = album.track_frames(shape, 44100, 4096)
    secs = [f / 44100 for f in frames]
    assert len(frames) == 12 and secs == sorted(secs)
    assert all(60 <= s <= 600 for s in secs)
    assert abs(np.median(secs) - 240) < 25
    assert all(f % 4096 for f in frames)


def test_the_seek_requests_are_the_seeds():
    def draws(seed):
        rng = np.random.default_rng(album.seed_bits(seed, 200))
        return rng.integers(0, 1 << 30, 50).tolist()
    assert draws(2147483647) == draws(2147483647)
    assert draws(2147483647) != draws(2147483646)
    assert album.seed_bits(-5, 1) >= 0


def test_rates_are_all_work_over_all_time():
    records = [dict(work=10e6, end=1.5), dict(work=30e6, end=3.0),
               dict(work=20e6, end=2.0)]
    assert window.rate(records, 1.0) == pytest.approx(60e6 / 2.0 / 1e6)
    assert window.rate([], 0.0) is None


def test_the_p95_is_over_every_seek():
    values = list(range(1, 101))
    assert window.percentile(values, 95) == pytest.approx(95.05)
    assert window.percentile([7.0], 95) == 7.0


def test_rice_decode_bytes_count_the_words_once_a_batch():
    count = cells.metric_module("rice_decode_roofline.decode").launch_bytes
    words = torch.zeros(1000, dtype=torch.int32)
    recs = [torch.zeros(10, dtype=torch.int32) for _ in range(5)]
    out = torch.zeros((10, 64), dtype=torch.int32)
    import weakref
    seen = weakref.WeakValueDictionary()
    first = count((words, *recs, 8, out), seen)
    again = count((words, *recs, 8, out), seen)
    assert first == 4000 + 5 * 40 + 10 * 64 * 4
    assert again == first - 4000


def test_flac_synth_bytes_count_the_taps_in_use():
    count = cells.metric_module("flac_synth_roofline.decode").launch_bytes
    S, n, K = 6, 4096, 32
    t = torch.zeros
    args = (t((S, n), dtype=torch.int32), t((S, K), dtype=torch.int32),
            t((S, K), dtype=torch.int32), t(S, dtype=torch.int32),
            t(S, dtype=torch.int32), 12, t((S, n), dtype=torch.int32))
    assert count(args, None) == (
        2 * S * n * 4 + S * K * 4 + 2 * S * 4 + S * 12 * 4)


def test_the_byte_counter_wraps_the_bindings_the_metrics_name(monkeypatch):
    import types
    from portbench.harness import core
    readers = {m: cells.metric_module(m) for m in (
        "rice_decode_roofline.decode", "flac_synth_roofline.decode",
        "device_idle.decode")}
    fake = types.ModuleType("fake_kernels")
    fake.rice_decode = fake.flac_synth = lambda *a: "launched"
    monkeypatch.setattr(core.importlib, "import_module", lambda name: fake)
    counter = core.kernel_bytes(readers)
    assert sorted(counter.counted) == ["flac_synth", "rice_decode"]
    original = fake.flac_synth
    counter.install()
    S, n = 2, 8
    t = torch.zeros
    args = (t((S, n), dtype=torch.int32), t((S, 4), dtype=torch.int32),
            t((S, 4), dtype=torch.int32), t(S, dtype=torch.int32),
            t(S, dtype=torch.int32), 4, t((S, n), dtype=torch.int32))
    assert fake.flac_synth(*args) == "launched"
    counter.remove()
    assert fake.flac_synth is original
    # residuals and samples, warm-up, shifts and orders, 4 taps a row
    assert counter.bytes == {"flac_synth": 2 * S * n * 4 + S * 4 * 4
                             + 2 * S * 4 + S * 4 * 4, "rice_decode": 0}
    assert core.kernel_bytes({"m": readers["device_idle.decode"]}) is None


class FakeEvent:
    def __init__(self, name, start, dur, device=True, annotation=False,
                 thread=1):
        (self._name, self._start, self._dur) = (name, start, dur)
        (self.device, self.annotation) = (device, annotation)
        self.thread = thread

    def start_thread_id(self):
        return self.thread

    def name(self):
        return self._name

    def start_ns(self):
        return self._start

    def duration_ns(self):
        return self._dur

    def device_type(self):
        return "cuda" if self.device else "cpu"

    def is_user_annotation(self):
        return self.annotation

    def activity_type(self):
        return "kernel"


def test_the_trace_reduces_to_busy_idle_and_named_gaps():
    ms = 1_000_000
    events = [FakeEvent("k1", 0, 2 * ms), FakeEvent("k2", 1 * ms, 2 * ms),
              FakeEvent("Memcpy HtoD", 5 * ms, 1 * ms),
              FakeEvent("k1", 9 * ms, 4 * ms),
              FakeEvent("portbench.encode_track", 0, 10 * ms, False, True),
              FakeEvent("flac.autocorr", 3 * ms, 2 * ms, False, True),
              FakeEvent("aten::mul", 3 * ms, 1.5 * ms, False, False),
              FakeEvent("portbench.encode_track", 0, 10 * ms, False, True,
                        thread=2)]
    out = trace.reduce_events(events, "cuda", 0, 10 * ms)
    assert out["window_s"] == pytest.approx(0.010)
    assert out["busy_s"] == pytest.approx(0.005)      # 0-3, 5-6, 9-10
    assert out["kernels"]["k1"] == {"count": 2, "seconds": 0.003}
    assert trace.kernel_launches(out["kernels"]) == 3
    gaps = dict(out["breakdown"]["idle_gaps"])
    assert gaps["flac.autocorr: aten::mul | portbench.encode_track"] == \
        pytest.approx(0.002)
    assert gaps["portbench.encode_track"] == pytest.approx(0.003)
    assert out["breakdown"]["device_ops"][0][0] == "k1"


def test_metric_readers_answer_only_in_their_cells():
    ctx = dict(driver="decode", peak_bytes=5e9, peak_bytes_per_s=3.35e12,
               counters={"encode_batches": 0, "decode_batches": 4},
               decode_timings={"scan": 0.2, "prep": 0.1, "md5": 0.1},
               trace={"busy_s": 0.5, "window_s": 2.0, "launches": 40,
                      "kernels": {"flac_synth_kernel<8>": {
                          "count": 4, "seconds": 0.001}}},
               kernel_bytes={"flac_synth": 335e6, "rice_decode": 0})
    def read(name):
        return cells.metric_module(name).read
    assert read("device_idle.decode")(ctx) == pytest.approx(75.0)
    assert read("device_idle.encode")(ctx) is None
    assert read("host_ms_per_batch.decode")(ctx) == pytest.approx(100.0)
    assert read("flac_synth_roofline.decode")(ctx) == pytest.approx(10.0)
    assert read("rice_decode_roofline.decode")(ctx) is None
    assert read("launches_per_batch.encode")(ctx) is None
    assert read("peak_mem_GB.encode")(ctx) is None
