#!/usr/bin/env python
"""On-card smoke test of the PyTorch/CUDA port (audiotools_tpu_torch).

Drives the port's main path, bit-exact FLAC -8 encode of 44.1 kHz
stereo with device analysis and device residual packing, on one CUDA
card, in phases that each print one line:

1. device: requires torch.cuda.is_available(); prints the card's name
   and power limit as nvidia-smi reports them;
2. build: compiles the CUDA kernels from csrc/ (timed);
3. kernel vs plain: scatter_words on the card against
   scatter_words_plain on the card, on contributions made by the
   port's own analysis and tokenizer from bench-shaped input; must be
   equal; both timed with CUDA events (median of several runs);
4. slice identity: a short encode at the main path's options on the
   card, with the device pack and without it, must give the bytes the
   port's plain versions give on the CPU (which the tests hold byte
   for byte against the reference encoder), and decode bit-exactly;
5. throughput: bench.py's encode (its signal and options, 16 batches
   of 1024 frames, 12.7 minutes of audio), repeated, each run
   decode-verified bit-exactly, with the launch counter reset just
   before each run and read just after.

Then it prints one JSON line describing each kernel and, last, the
result line {"ok": true, "device": {...}}.  Any failure raises: the
script exits nonzero without the result line.  Usage:

    python3 chip_smoke.py
"""

import io
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
SAMPLE_RATE = 44100
# bench.py's FLAC -8 options and run length
OPTS = dict(block_size=4096, max_lpc_order=12, mid_side=True,
            exhaustive_model_search=True, max_residual_partition_order=6,
            batch_frames=1024)
THROUGHPUT_BATCHES = 16
THROUGHPUT_RUNS = 3
TIMING_RUNS = 15


def line(phase, **fields):
    print("%s: %s" % (phase, json.dumps(fields)), flush=True)


def median_ms(fn, runs=TIMING_RUNS):
    """median CUDA-event time of fn() over `runs` calls, after one
    warm-up call"""
    fn()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop))
    return float(np.median(times))


def program_signal(n_frames, seed=7):
    """bench.py's synthetic stereo program material (tones + noise),
    int32 [n_frames, 2]"""
    rng = np.random.default_rng(seed)
    t = np.arange(n_frames)
    left = (9000 * np.sin(2 * np.pi * 441 * t / SAMPLE_RATE) +
            4000 * np.sin(2 * np.pi * 881 * t / SAMPLE_RATE) +
            2000 * np.sin(2 * np.pi * 0.25 * t / SAMPLE_RATE) *
            np.sin(2 * np.pi * 1327 * t / SAMPLE_RATE))
    right = (8000 * np.sin(2 * np.pi * 599 * t / SAMPLE_RATE + 0.4) +
             3000 * np.sin(2 * np.pi * 1201 * t / SAMPLE_RATE))
    noise = rng.normal(0, 600, (n_frames, 2))
    out = np.stack([left, right], axis=1) + noise
    return np.clip(out, -32768, 32767).astype(np.int32)


def main():
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: torch.cuda.is_available() is False; this "
                 "script needs one CUDA card")
    sys.path.insert(0, ROOT)
    from audiotools_tpu_torch import kernels
    from audiotools_tpu_torch.codecs import flac_enc_fast as port_enc
    from audiotools_tpu_torch.pcm import decode_flac, reader_from_array
    from audiotools_tpu_torch.ops import bitpack, flac_frames
    from audiotools_tpu_torch.ops import lpc as lpc_ops

    dev = torch.device("cuda", 0)

    # ---- 1. device -----------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)
    name = torch.cuda.get_device_name(0)
    line("device", name=name, nvidia_smi=smi,
         count=torch.cuda.device_count(), torch=torch.__version__,
         cuda=torch.version.cuda)

    # ---- 2. build ------------------------------------------------------
    t0 = time.perf_counter()
    kernels.load()
    line("build", seconds=time.perf_counter() - t0,
         library=os.path.relpath(kernels.library_path(), ROOT),
         ptxas=[l for l in kernels.build_log.splitlines()
                if "registers" in l or "spill" in l])

    # ---- 3. kernel vs plain at the main path's shapes ------------------
    opts = OPTS
    n = opts["block_size"]
    K = opts["max_lpc_order"]
    porders = flac_frames.valid_partition_orders(
        n, opts["max_residual_partition_order"], max(K, 4))
    P = 1 << porders[-1]
    frames = opts["batch_frames"]
    blocks = torch.as_tensor(program_signal(n * frames).reshape(
        frames, n, 2).astype(np.int16), device=dev)
    window = lpc_ops.tukey_window(n, dev)
    (_packed, chosen) = flac_frames.analyze_frames_packed(
        blocks, True, 16, n, K, 12, porders, 14,
        opts["exhaustive_model_search"], opts["mid_side"], window,
        return_chosen=True)
    (idx, val, _total, _coded) = bitpack.chosen_contributions(chosen, n, P)
    n_words = bitpack.residual_words_capacity(n, 17, P)
    del chosen, _packed
    got = bitpack.scatter_words(idx, val, n_words)
    want = bitpack.scatter_words_plain(idx, val, n_words)
    torch.cuda.synchronize()
    err = int((got.to(torch.int64) - want.to(torch.int64)).abs().max())
    if not torch.equal(got, want):
        raise AssertionError("scatter_words kernel != plain version "
                             "(max abs err %d)" % (err,))
    # interleaved plain, kernel, kernel, plain
    plain_ms = [median_ms(lambda: bitpack.scatter_words_plain(
        idx, val, n_words))]
    kernel_ms = [median_ms(lambda: bitpack.scatter_words(idx, val, n_words))
                 for _ in range(2)]
    plain_ms.append(median_ms(lambda: bitpack.scatter_words_plain(
        idx, val, n_words)))
    ms = float(np.median(kernel_ms))
    pms = float(np.median(plain_ms))
    line("kernel_vs_plain", kernel="scatter_words",
         shape=[int(idx.shape[0]), int(idx.shape[1]), n_words],
         equal=True, max_abs_err=err, ms=ms, plain_ms=pms,
         ms_runs=kernel_ms, plain_ms_runs=plain_ms)
    del idx, val, got, want, blocks

    # ---- 4. slice identity against the plain versions ------------------
    rng = np.random.default_rng(9)
    m = n * 16 + 1000
    t = np.arange(m)
    arr = np.stack([(8192 * np.sin(2 * np.pi * (300 + 200 * c) * t
                                   / SAMPLE_RATE)).astype(np.int64)
                    + rng.integers(-128, 128, m)
                    for c in range(2)], axis=1).astype(np.int32)
    arr[:n] = 1234                      # a CONSTANT stretch
    arr[n:2 * n] = rng.integers(-32768, 32767, (n, 2))   # VERBATIM
    small = dict(opts, batch_frames=8)
    plain = io.BytesIO()
    port_enc.encode_flac_fast(plain, reader_from_array(arr, 16),
                              device="cpu", **small)
    plain = plain.getvalue()
    bitpack.scatter_words.launches = 0
    for pack in (True, False):
        buf = io.BytesIO()
        port_enc.encode_flac_fast(buf, reader_from_array(arr, 16),
                                  device="cuda", pack=pack, **small)
        if buf.getvalue() != plain:
            raise AssertionError("card encode (pack=%s) bytes differ from "
                                 "the plain versions' on the CPU" % (pack,))
    slice_launches = bitpack.scatter_words.launches
    if slice_launches <= 0:
        raise AssertionError("slice encode never launched scatter_words")
    if not np.array_equal(decode_flac(plain), arr):
        raise AssertionError("slice encode does not decode bit-exactly")
    line("slice_identity", frames=m, bytes=len(plain), identical=True,
         bit_exact=True, scatter_words_launches=slice_launches)

    # ---- 5. bench-shaped throughput on the main path -------------------
    port_enc.encode_flac_fast(
        io.BytesIO(), reader_from_array(program_signal(n * frames), 16),
        device="cuda", **opts)
    sig = program_signal(n * frames * THROUGHPUT_BATCHES)
    n_frames = sig.shape[0]
    runs = []
    for _ in range(THROUGHPUT_RUNS):
        reader = reader_from_array(sig, 16)
        fallback0 = port_enc.fallback_batches
        timings = {}
        out = io.BytesIO()
        torch.cuda.reset_peak_memory_stats(dev)
        bitpack.scatter_words.launches = 0
        t0 = time.perf_counter()
        port_enc.encode_flac_fast(out, reader, device="cuda",
                                  timings=timings, **opts)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = bitpack.scatter_words.launches
        data = out.getvalue()
        if launches <= 0:
            raise AssertionError("main path never launched scatter_words")
        if not np.array_equal(decode_flac(data), sig):
            raise AssertionError("bench-shaped encode does not decode "
                                 "bit-exactly")
        runs.append(dict(
            wall_s=wall, Msamples_per_s=n_frames * 2 / wall / 1e6,
            ratio=len(data) / (sig.size * 2), stage_s=timings,
            fallback_batches=port_enc.fallback_batches - fallback0,
            peak_mem_GB=torch.cuda.max_memory_allocated(dev) / 1e9,
            scatter_words_launches=launches))
        del out, data
    rates = [r["Msamples_per_s"] for r in runs]
    rate = float(np.median(rates))
    launches = runs[0]["scatter_words_launches"]
    line("throughput", audio_seconds=n_frames / SAMPLE_RATE,
         batches=THROUGHPUT_BATCHES, batch_frames=frames,
         Msamples_per_s=rate, Msamples_per_s_runs=rates,
         realtime=rate * 1e6 / 2 / SAMPLE_RATE, bit_exact=True,
         runs=runs)

    if "jax" in sys.modules:
        raise AssertionError("the port pulled in jax")
    print(json.dumps({"kernels": [{
        "name": "scatter_words", "route": "cuda",
        "source": "audiotools_tpu_torch/csrc/scatter_words.cu",
        "replaces": "audiotools_tpu/ops/pallas_bitpack.py:195",
        "launches": launches, "max_abs_err": err, "ms": ms,
        "plain_ms": pms}]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
