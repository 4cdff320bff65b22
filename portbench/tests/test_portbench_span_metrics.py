"""The readers of the per-layer metrics that read the program's spans
(the enqueue, its time off the CPU and the floor's re-analysis), on
fabricated contexts: the value, nothing in another driver's cell,
nothing without batches, and nothing from a program without the span."""

from __future__ import annotations

import pytest

from portbench.harness import cells

ENCODE = ("enqueue_ms_per_batch.encode", "enqueue_offcpu_share.encode",
          "floor_analysis_ms_per_batch.encode")
DECODE = ("enqueue_ms_per_batch.decode",)


def read(name):
    return cells.metric_module(name).read


def encode_ctx(batches=4, **timings):
    t = dict(qpack=0.4, emit=0.3, floor=0.9, analysis=2.0, enqueue=2.4,
             enqueue_cpu=0.6, floor_analysis=0.8, tail=0.1, wait=0.2)
    t.update(timings)
    return dict(driver="encode", peak_bytes=5e9, peak_bytes_per_s=3.35e12,
                counters={"encode_batches": batches, "decode_batches": 0},
                encode_timings=t)


def decode_ctx(batches=4, **timings):
    t = dict(scan=0.2, prep=0.1, md5=0.1, enqueue=0.12, wait=0.05)
    t.update(timings)
    return dict(driver="decode", peak_bytes=5e8, peak_bytes_per_s=3.35e12,
                counters={"encode_batches": 0, "decode_batches": batches},
                decode_timings=t)


def test_the_values():
    ctx = encode_ctx()
    assert read("enqueue_ms_per_batch.encode")(ctx) == pytest.approx(600.0)
    assert read("enqueue_offcpu_share.encode")(ctx) == pytest.approx(75.0)
    assert read("floor_analysis_ms_per_batch.encode")(ctx) == \
        pytest.approx(200.0)
    assert read("enqueue_ms_per_batch.decode")(decode_ctx()) == \
        pytest.approx(30.0)


def test_a_share_on_the_cpu_throughout_is_0():
    ctx = encode_ctx(enqueue=1.5, enqueue_cpu=1.5)
    assert read("enqueue_offcpu_share.encode")(ctx) == pytest.approx(0.0)


def test_no_floor_retry_reads_0():
    ctx = encode_ctx(floor=0.0, floor_analysis=0.0)
    assert read("floor_analysis_ms_per_batch.encode")(ctx) == 0.0


@pytest.mark.parametrize("name", ENCODE + DECODE)
def test_nothing_in_another_drivers_cell(name):
    ctx = decode_ctx() if name in ENCODE else encode_ctx()
    assert read(name)(ctx) is None
    seek = dict(driver="seek", peak_bytes=2e8, peak_bytes_per_s=3.35e12,
                counters={})
    assert read(name)(seek) is None


@pytest.mark.parametrize("name", ENCODE + DECODE)
def test_nothing_without_batches(name):
    ctx = encode_ctx(batches=0) if name in ENCODE else decode_ctx(batches=0)
    assert read(name)(ctx) is None


@pytest.mark.parametrize("name,key", [
    ("enqueue_ms_per_batch.encode", "enqueue"),
    ("enqueue_offcpu_share.encode", "enqueue"),
    ("enqueue_offcpu_share.encode", "enqueue_cpu"),
    ("floor_analysis_ms_per_batch.encode", "floor_analysis"),
    ("enqueue_ms_per_batch.decode", "enqueue")])
def test_nothing_from_a_program_without_the_span(name, key):
    ctx = encode_ctx() if name in ENCODE else decode_ctx()
    del ctx["encode_timings" if name in ENCODE else "decode_timings"][key]
    assert read(name)(ctx) is None


def test_the_benchmark_lists_each_reader_in_its_cells():
    bench = cells.load_benchmark(cells.BENCH_DIR + "/..")
    entries = {m["name"]: m for m in bench["per_layer"]}
    for name in ENCODE + DECODE:
        entry = entries[name]
        assert entry["source"] == "program_span"
        for workload in entry["workloads"]:
            cell = cells.Cell(bench, workload)
            assert name in [m["name"] for m in cell.per_layer]
            assert cell.mix["driver"] == name.rsplit(".", 1)[1]
