#!/usr/bin/env python
"""Where the PyTorch port's FLAC -8 encode spends its time on a card.

At chip_smoke.py's bench-shaped options (block 4096, LPC order 12,
partition order 6, exhaustive search, mid/side, 1024-frame batches) it
prints one JSON line per measurement:

- analysis_batch: one batch's analysis + compact + pack, alone, as the
  mean of 3 runs: host wall time, the host's time to enqueue it, and a
  CUDA-event span per analysis function (a span also covers the host's
  enqueue time inside it, so it reads high when the host is the limit);
- profiler_kernels: torch.profiler over one such batch: the count of
  device kernels and their summed device time, plus the top ops;
- encode_profiled: a traced whole encode: wall time, the stage sums,
  and the device's busy time (union of kernel intervals) in the span
  from its first kernel to its last;
- encode_run: untraced whole encodes, for the spread.

Usage:  python tools_dev/profile_torch_encode.py [batches] [repeats]
        (defaults 4 and 3; needs one CUDA card)
"""

import functools
import io
import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

from audiotools_tpu_torch.codecs import flac_enc_fast as enc
from audiotools_tpu_torch.ops import bitpack, flac_frames, lpc
from audiotools_tpu_torch.pcm import reader_from_array
from chip_smoke import OPTS, program_signal

SPANS = {lpc: ("windowed_autocorr_df", "levinson_df",
               "quantize_all_orders", "lpc_residuals"),
         flac_frames: ("build_variants", "analyze_subframes",
                       "compact_decisions"),
         bitpack: ("pack_rows", "pack_chosen_residuals")}


def emit(tag, **fields):
    print("%s %s" % (tag, json.dumps(fields)), flush=True)


def span_functions(spans):
    """wraps each function of SPANS in a pair of CUDA events, appended
    to spans[name] per call; returns what restore_functions takes"""
    saved = []
    for (module, names) in SPANS.items():
        for name in names:
            fn = getattr(module, name)
            saved.append((module, name, fn))

            @functools.wraps(fn)    # keeps attributes: pack_rows.launches
            def timed(*args, _fn=fn, _name=name, **kwargs):
                start = torch.cuda.Event(enable_timing=True)
                stop = torch.cuda.Event(enable_timing=True)
                start.record()
                out = _fn(*args, **kwargs)
                stop.record()
                spans.setdefault(_name, []).append((start, stop))
                return out
            setattr(module, name, timed)
    return saved


def restore_functions(saved):
    for (module, name, fn) in saved:
        setattr(module, name, fn)


def device_busy_ms(prof):
    """(busy ms, span ms, kernel count) of the CUDA events in a trace"""
    intervals = sorted(
        (e.time_range.start, e.time_range.end) for e in prof.events()
        if str(getattr(e, "device_type", "")).endswith("CUDA"))
    busy = 0
    cur = None
    for (s, e) in intervals:
        if cur is None or s > cur[1]:
            if cur is not None:
                busy += cur[1] - cur[0]
            cur = [s, e]
        else:
            cur[1] = max(cur[1], e)
    if cur is not None:
        busy += cur[1] - cur[0]
    span = intervals[-1][1] - intervals[0][0] if intervals else 0
    return (busy / 1e3, span / 1e3, len(intervals))


def main():
    batches = int(sys.argv[1]) if len(sys.argv) > 1 else 4
    repeats = int(sys.argv[2]) if len(sys.argv) > 2 else 3
    if not torch.cuda.is_available():
        sys.exit("profile_torch_encode: needs a CUDA card")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    dev = torch.device("cuda", 0)
    n = OPTS["block_size"]
    K = OPTS["max_lpc_order"]
    frames = OPTS["batch_frames"]
    porders = flac_frames.valid_partition_orders(
        n, OPTS["max_residual_partition_order"], max(K, 4))
    P = 1 << porders[-1]
    n_words = bitpack.residual_words_capacity(n, 17, P)
    blocks = torch.as_tensor(program_signal(n * frames).reshape(
        frames, n, 2).astype(np.int16), device=dev)
    window = lpc.tukey_window(n, dev)

    def analysis():
        (packed, chosen) = flac_frames.analyze_frames_packed(
            blocks, True, 16, n, K, 12, porders, 14, True, True, window,
            return_chosen=True)
        flac_frames.compact_decisions(packed, 2, K, P)
        bitpack.pack_chosen_residuals(chosen, n, 16, True, P, n_words)

    analysis()
    torch.cuda.synchronize()
    spans = {}
    saved = span_functions(spans)
    runs = 3
    t0 = time.perf_counter()
    for _ in range(runs):
        t1 = time.perf_counter()
        analysis()
        enqueue = time.perf_counter() - t1
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) / runs
    restore_functions(saved)
    emit("analysis_batch", wall_ms=wall * 1e3,
         host_enqueue_ms_last=enqueue * 1e3,
         span_ms={k: sum(s.elapsed_time(e) for (s, e) in v) / runs
                  for (k, v) in spans.items()})

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        analysis()
        torch.cuda.synchronize()
    (busy, span, count) = device_busy_ms(prof)
    top = sorted(((getattr(e, "device_time_total", 0), e.key, e.count)
                  for e in prof.key_averages()), reverse=True)[:15]
    emit("profiler_kernels", kernels=count, kernel_ms=busy, span_ms=span,
         top=[(t / 1e3, k[:70], c) for (t, k, c) in top])

    sig = program_signal(n * frames * batches)
    enc.encode_flac_fast(io.BytesIO(), reader_from_array(
        program_signal(n * frames), 16), device="cuda", **OPTS)
    reader = reader_from_array(sig, 16)
    timings = {}
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        enc.encode_flac_fast(io.BytesIO(), reader, device="cuda",
                             timings=timings, **OPTS)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    (busy, span, count) = device_busy_ms(prof)
    emit("encode_profiled", batches=batches, wall_s=wall, stage_s=timings,
         device_busy_ms=busy, device_span_ms=span, kernels=count)

    for i in range(repeats):
        reader = reader_from_array(sig, 16)
        timings = {}
        t0 = time.perf_counter()
        enc.encode_flac_fast(io.BytesIO(), reader, device="cuda",
                             timings=timings, **OPTS)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        emit("encode_run", run=i, batches=batches, wall_s=wall,
             Msamples_per_s=sig.shape[0] * 2 / wall / 1e6, stage_s=timings)


if __name__ == "__main__":
    main()
