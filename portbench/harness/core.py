"""One run of one cell: set-up, the measured window, the traced reading
(``--trace 1``), the check of what the window produced against the
plain reference, and the result's line."""

from __future__ import annotations

import importlib
import os
import shutil
import statistics
import sys
import tempfile
import time

from . import cells, trace as trace_mod
from .window import Window

# whole top-level module names that no run may load: JAX, its libraries,
# Flax and the JAX package (the port's name begins with its name, so
# names are compared whole)
FORBIDDEN = ("jax", "jaxlib", "flax", "audiotools_tpu")
# the card's peak memory bandwidth (NVIDIA's H100 SXM data sheet), bytes
# a second: the roofline shares' bound
PEAK_BYTES_PER_S = 3.35e12
# worker processes of the plain reference after the window
REFERENCE_PROCESSES = 6


def forbidden_modules():
    """the loaded modules whose top-level name is forbidden"""
    return sorted(name for name in list(sys.modules)
                  if name.split(".")[0] in FORBIDDEN)


class Env:
    """what a driver is given: torch, the cell's configuration and mix,
    the seed, the device, a work directory, the plain reference's worker
    processes, and the test-only overrides (a smaller album, a shallower
    batch, mix parameters)"""

    def __init__(self, torch, cell, seed, device, workdir, album_shape=None,
                 batch_frames=None, mix=None, notes=None,
                 processes=REFERENCE_PROCESSES):
        self.torch = torch
        self.notes = {} if notes is None else notes
        self.config = cell.config
        self.mix = dict(cell.mix, **(mix or {}))
        self.seed = seed
        self.device = device
        self.workdir = workdir
        self.album_shape = album_shape
        self.batch_frames = batch_frames
        self.processes = processes


def make_driver(env):
    """the driver the cell's mix names, found by name"""
    return cells.driver_class(env.mix["driver"])(env)


def kernel_bytes(readers):
    """the byte counter over the kernel bindings that the cell's roofline
    metrics name, or None where none does"""
    counted = {}
    for module in readers.values():
        if hasattr(module, "KERNEL"):
            (where, name) = module.KERNEL
            counted.setdefault(name, (importlib.import_module(where),
                                      module.launch_bytes))
    return trace_mod.KernelBytes(counted) if counted else None


def log(message):
    print("portbench: " + message, file=sys.stderr, flush=True)


def prepare_caches(root):
    """fixed cache directories inside the checkout, so that a second run
    there finds what the first built"""
    base = os.path.join(root, ".portbench_cache")
    for (var, sub) in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                       ("TRITON_CACHE_DIR", "triton"),
                       ("CUDA_CACHE_PATH", "cuda")):
        path = os.path.join(base, sub)
        os.makedirs(path, exist_ok=True)
        os.environ[var] = path


def build_program(root):
    """loads the port's host library (g++, built when the package's
    ``_native`` is first imported) and CUDA kernels (nvcc), building what
    the checkout's build directory lacks; returns each one's seconds and
    whether its library was there before"""
    import glob
    build = os.path.join(root, "audiotools_tpu_torch", "build")
    out = {"host_library_found": bool(glob.glob(os.path.join(
        build, "libatpu_host-*.so")))}
    t0 = time.perf_counter()
    from audiotools_tpu_torch import _native
    _native.get_lib()
    out["host_library_s"] = time.perf_counter() - t0
    from audiotools_tpu_torch import kernels
    out["kernels_found"] = os.path.exists(kernels.library_path())
    t0 = time.perf_counter()
    kernels.load()
    out["kernels_s"] = time.perf_counter() - t0
    return out


def run_cell(root, workload, seed, seconds, traced, device="cuda", t0=None,
             album_shape=None, batch_frames=None, mix=None,
             processes=REFERENCE_PROCESSES):
    """one run; returns the result's fields (correct, attempted, failed,
    metrics, device, breakdown, checks) and a dict of notes for stderr"""
    t0 = time.perf_counter() if t0 is None else t0
    import torch
    bench = cells.load_benchmark(root)
    cell = cells.Cell(bench, workload)
    on_card = device == "cuda"
    notes = {}
    if on_card:
        notes.update(build_program(root))
        device = torch.device("cuda", 0)
    else:
        device = torch.device(device)
    workdir = tempfile.mkdtemp(prefix="portbench-")
    try:
        env = Env(torch, cell, seed, device, workdir, album_shape,
                  batch_frames, mix, notes, processes)
        driver = make_driver(env)
        driver.setup()
        seconds = min(seconds, env.mix["trace_seconds"]) if traced \
            else seconds
        readers = ({m["name"]: cells.metric_module(m["name"])
                    for m in cell.per_layer} if traced else {})
        tracer = trace_mod.Tracer(torch) if traced and on_card else None
        kbytes = kernel_bytes(readers) if traced and on_card else None
        before = {}

        def on_open():
            before.update(driver.counters())
            if on_card:
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
            if kbytes is not None:
                kbytes.install()
            if tracer is not None:
                tracer.start()

        window = Window(seconds, driver.parties, on_open)
        (records, errors) = driver.run(window)
        if tracer is not None:
            tracer.stop()
        if kbytes is not None:
            kbytes.remove()
        after = driver.counters()
        setup_s = window.start - t0
        peak = torch.cuda.max_memory_allocated() if on_card else 0
        attempted = len(records) + len(errors)
        if errors:
            notes["first_error"] = repr(errors[0])[:500]
        values = driver.end_to_end(records, window.start)
        values["setup_s"] = setup_s
        notes["end_to_end"] = values
        if len(records) >= 2:
            notes["job_s_quartiles"] = statistics.quantiles(
                [r["end"] - r["start"] for r in records], n=4)
            notes["window_closed_s"] = max(r["end"] for r in records) - \
                window.start
        metrics = {}
        ctx = dict(driver=env.mix["driver"], peak_bytes=peak,
                   counters={k: after[k] - before[k] for k in after},
                   peak_bytes_per_s=PEAK_BYTES_PER_S,
                   **driver.layer_context(records))
        notes["counters"] = ctx["counters"]
        notes["timings"] = {k: v for (k, v) in ctx.items()
                            if k.endswith("_timings")}
        if traced:
            t_read = time.perf_counter()
            summary = tracer.summary() if tracer is not None else None
            notes["trace_read_s"] = time.perf_counter() - t_read
            ctx["trace"] = summary
            ctx["kernel_bytes"] = dict(kbytes.bytes) if kbytes else None
            for m in cell.per_layer:
                value = readers[m["name"]].read(ctx)
                if value is not None:
                    metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        else:
            for m in cell.end_to_end:
                value = values.get(m["name"])
                if value is None:
                    if not errors:
                        raise RuntimeError("the window gave no %s"
                                           % (m["name"],))
                    value = 0.0     # nothing finished: the run is failed
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        dev = {"platform": "gpu" if on_card else "cpu",
               "kind": (torch.cuda.get_device_name(0) if on_card
                        else "cpu"),
               "count": cell.chips if on_card else 1,
               "memory_peak_bytes": peak}
        result = {}
        if traced and on_card:
            dev["busy_s"] = summary["busy_s"]
            dev["window_s"] = summary["window_s"]
            result["breakdown"] = summary["breakdown"]
            notes["kernels"] = dict(sorted(
                summary["kernels"].items(),
                key=lambda kv: -kv[1]["seconds"])[:25])
            notes["launches"] = summary["launches"]
        driver.release()
        if on_card:
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
        t_check = time.perf_counter()
        (checks, counts) = driver.check(records)
        notes["check_s"] = time.perf_counter() - t_check
        notes.update(counts)
        notes["window_records"] = len(records)
        correct = (attempted > 0 and not errors and
                   all(value <= limit for (_n, value, limit) in checks))
        out = {"correct": bool(correct), "attempted": attempted,
               "failed": len(errors), "metrics": metrics, "device": dev}
        out.update(result)
        out["checks"] = {name: {"value": value, "limit": limit}
                         for (name, value, limit) in checks}
        return (out, notes)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
