#!/usr/bin/env python
"""On-card smoke test of the PyTorch/CUDA port (audiotools_tpu_torch).

Drives the port's main paths on one CUDA card: bit-exact FLAC -8
encode of 44.1 kHz stereo with device analysis and device residual
packing, FLAC decode with device Rice decoding and synthesis, ALAC
encode with device analysis and ALAC decode with device synthesis,
TTA encode with the device filter and decode with device filter
inversion, Shorten encode with device analysis and decode with device
synthesis, WavPack encode and decode with the decorrelation passes
on the card, the converters (ReplayGain, AccurateRip, the
resampler), and a collection of tracks through the transcode farm.
Its phases each print one line:

1. device: requires torch.cuda.is_available(); prints the card's name
   and power limit as nvidia-smi reports them, and its SM clock and
   largest SM clock (MHz), so that a kernel's time a serial step can be
   read in cycles;
2. build: compiles the CUDA kernels from csrc/ (timed), with each
   kernel's registers, stack frame and spill stores as ptxas reports
   them, and beside them tools_dev/int_op_cycles.py's instruction
   timings;
3. kernel vs plain: pack_rows on the card against pack_rows_plain on
   the card (the eager tokenize, split and scatter chain), on the
   chosen subframes of the port's own analysis of bench-shaped input;
   words, bits and ok flags must be equal; both timed with CUDA events
   (median of several runs), the kernel also with the card's time alone
   (device_ms, as in phase 6), beside scatter_add_ on the same rows'
   word contributions;
4. slice identity: a short encode at the main path's options on the
   card on each route (the default quantized upload wire, the device
   pack, exact uploads without pack) must give the bytes the port's
   plain versions give on the CPU on that route (which the tests hold
   byte for byte against the reference encoder), and decode
   bit-exactly;
5. throughput: bench.py's encode (its signal and options, 16 batches
   of 1024 frames, 12.7 minutes of audio) on the device-pack route
   (pack=True), repeated, each run decode-verified bit-exactly, with
   the launch counter reset just before each run and read just after,
   and each run's pack stage seconds;
6. decode kernels vs plain: rice_decode and flac_synth on the card
   against their plain versions on the card, on the records (one row
   per non-empty bucket) and subframe arrays of the port's scan of a
   1024-frame bench-shaped stream; must be equal; timed with CUDA
   events, and with the card's time alone (device_ms: the call enqueued
   behind a spin kernel); rice_decode with its time a code, flac_synth
   with its time a serial step;
7. decode identity: phase 4's stream decoded on the card equals its
   input and the port's plain decode on the CPU, its MD5 checked;
8. decode throughput: phase 5's stream decoded on the card, repeated,
   each run bit-exact with its MD5 checked, no chunk on the host path,
   the launch counters reset just before each run and read just after;
9. ALAC kernel vs plain: alac_synth on the card against its plain
   version on the card, on the rows of the port's scan of a
   1024-frameset stereo ALAC stream of bench.py's signal (2048 x
   4096), with the row grouping its decoder builds on the host; must
   be equal; timed as phase 6 (the plain version once), with its time a
   serial step;
10. ALAC identity: phase 4's signal encoded on the card gives the mdat
    bytes, frame sizes and whole M4A file (creation time pinned) that
    the port's plain versions give on the CPU (which the tests hold
    byte for byte against the reference), and decodes on the card to
    its input and to the CPU decode, through the kernel, with no batch
    on the host route;
11. ALAC throughput: bench.py's signal in 1024-frameset batches (4
    batches, 6.3 minutes of audio) encoded (the default route, the
    quantized upload wire, with its batches and floor retries counted)
    and decoded on the card, repeated, every run bit-exact, with stage
    timings and launch counts, no batch on the host route;
12. TTA kernel vs plain: tta_synth on the card against its plain
    version on the card, on the first decode group (256 frames, 512
    lanes x 46080) of phase 11's signal encoded on the card as a TTA
    stream; must be equal; timed (the plain version once), and with the
    card's time alone (device_ms), with its time a serial step;
13. TTA identity and throughput: the card's encoder writes the same
    file whether the length is known up front or not, and it decodes
    back on the host; that short stream decodes on the card to its
    input and to the CPU decode; then phase 12's stream is decoded on
    the card, repeated, every run bit-exact, through the kernel;
14. TTA encode kernel vs plain: tta_filter (the encoder's hybrid
    filter) on the card against its plain version on the card, on the
    first encode batch of phase 11's signal (256 frames, 512 lanes x
    46080 of the fixed predictor's output); must be equal; timed as
    phase 12, and with the card's time alone (device_ms), beside its
    serial floor: n steps of its step-to-step chain, and of the loop
    of the kernel before it, both measured in this run on one warp
    (tools_dev/int_op_cycles.py's TTA_FILTER_CASE and
    TTA_FILTER_OLD_CASE);
15. TTA encode identity and throughput: phase 11's signal written on
    the card, repeated, each run's file equal to the one the port's
    all-host C++ encoder gives (timed once beside it), with stage
    seconds and tta_filter's launches counted from 0 in each run; a
    short stream gives the same file on the card, on the CPU (the plain
    versions) and on the host;
16. Shorten identity and throughput: phase 11's signal written on the
    card (the device analysis steering the emitter) equals the
    emitter's own decisions' file byte for byte, and decodes on the
    card (host scan and warm-up chain, device synthesis) to the signal
    bit for bit without the host route, each repeated, the all-host
    encode and decode timed once beside them; a short stream gives the
    same file and PCM on the card and on the CPU;
17. WavPack kernels vs plain: wv_decorr (the decode pass chains) on
    the main path's first batch, the first 32 blocks of 44,100 stereo
    samples of phase 18's standard stream (5 passes, terms 17 and 18
    among them), and on a batch of 8 such blocks of a 16-pass
    (veryhigh) stream of phase 11's signal, with terms -1 and -2; and
    wv_corr (the encode chains) on the third block of a standard, a
    veryhigh and a mono standard encode, each with the state the
    encode reached there; each equal to its plain version on the CPU
    and to the port's host C++ passes, pass by pass (outputs, final
    weights, stored samples); each input timed as phase 14, its plain
    version on the same input once, with its time a serial step and a
    step of the critical path (a sample), beside its bounds: the bytes,
    the pipelined form's critical path (n steps of the slowest pass's
    chain plus the fill of one chunk a pass) and the older floor of
    one pass after another, both from the step's dependent chain
    measured in this run on one warp (tools_dev/int_op_cycles.py's
    int64 encode and term-18 decode links; the kernels line's rows are
    the standard batch and block);
18. WavPack identity and throughput: phase 11's signal written on the
    card at standard (one wv_corr launch a 44,100-sample block) equals
    the port's all-host C++ encode byte for byte, and decodes on the
    card (wv_decorr, 32-block batches) bit for bit with its MD5
    checked (one wv_decorr launch a 32-block batch), each repeated
    with the launch counters reset before each run, no decode block on
    the host route, the all-host encode (run
    before phase 17) and decode timed once beside them; a short
    veryhigh stream and a short 6-channel (mask 0x3F) one give the
    same file and PCM on the card and on the CPU;
19. converters, on phase 11's signal: ReplayGain on the card over the
    signal cut into an album of four 95.1 s titles (title and album
    gains, peaks) against the port's host C++ IIR analysis of the same
    titles (peaks equal, at most one window moved between bins a
    title, gains within 0.011 dB); AccurateRip of the same four cuts
    as a CD's tracks (the first track's skip, the last track's stop),
    fed in 65,536-frame chunks, equal to the port's C++ sums; the
    resampler, 44.1 -> 48 kHz through PCMConverter at reads of 4096
    and of 1 << 20 frames, 44.1 -> 44.099 kHz on 60 s (the quantised
    8192-phase bank) and 96 -> 44.1 kHz on 60 s of 24-bit, against the
    port's C++ FIR over every output's window (at most 1
    LSB apart, on under 1e-4 of the samples), with the card's peak
    memory at 1 << 20-frame reads; each converter three times (the 60
    s streams once), with its median rate in Msamples/s of input PCM
    and its stages, the host twin timed once beside it, and the forms
    not taken timed on the same inputs (the ReplayGain FIR as float64
    conv1d, a title's reads streamed to the card, the resampler's
    gather for a bank with a row a phase, the quantised bank's windows
    gathered by advanced indexing); and short cases (an 8-bit
    mono title, a 24-bit title, a 2-frame final AccurateRip chunk)
    that agree between the card and the CPU;
20. the transcode farm, on phase 5's signal cut into an album of 8
    WAVE tracks (every cut off a 4096-frame boundary): the port's
    ``parallel.farm.transcode`` to FLAC -8 on the card at 1, 2, 4 and 6
    workers (each a CUDA stream of its own), every job checked by
    ``farm.verify_flac`` (decoded once, MD5 checked, samples equal to
    the source, AccurateRip equal to the port's C++ sums), no decode
    chunk on the host route (the encodes take the default quantized
    wire, so rice_decode and flac_synth must launch and pack_rows is
    only counted), every run's files equal to the first
    1-worker run's; three runs at 1 worker and at the best count, one
    at the others, each with its wall, Msamples/s of input PCM,
    speedup over 1 worker, peak card memory (allocated and reserved),
    the caching allocator's retries and its launches of
    pack_rows, rice_decode and flac_synth (counted from 0 each run),
    beside phase 5's encode and phase 8's decode rates; a run at 4
    workers with the interpreter's switch interval at 0.2 ms; the same
    files from the farm over ``[cuda:0, cuda:0]`` (the per-device code
    on one card, not a measurement of several cards); a short album
    farmed on the card and on the CPU to the same files; and
    ``parallel.dryrun.dryrun_multichip`` over ``[cuda:0, cuda:0]`` (and
    over every card where there are several);
21. the command line, on phase 19's album (four 95.1 s WAVE tracks):
    for each of FLAC -8, ALAC, TTA, Shorten and WavPack (standard),
    ``track2track -j 2`` in-process on the card, then ``trackverify
    --accuraterip`` over its outputs (every file OK, its sums equal to
    the port's C++ sums of its source) and ``trackcmp`` of each output
    against its input (every pair OK); each output equal to the file
    the same class's ``from_pcm`` writes on the card with the same
    frame count (the ALAC creation time pinned); a line a type with
    the wall time and Msamples/s of input PCM of each tool, the
    launches of each of the eight kernels (counted from 0 before the
    type's track2track run, read after its trackcmp run) and the
    card's peak memory; then ``track2track -t flac --replay-gain`` on
    the album (peaks equal to the tracks', gains finite) and
    ``--sample-rate 48000`` on one track (the card's file decoded
    within 1 LSB of the CPU's PCMConverter on under 1e-4 of the
    samples).  Every kernel of the tools' default routes must have
    launched during the phase (all but pack_rows and rice_planes);
22. tags and foreign chunks through the command line, on phase 19's
    album: its tracks written on the card as FLAC -8, ALAC, TTA and
    WavPack (standard) and each tagged with every field (non-ASCII
    text) and a PNG front cover; ``track2track -j 2`` of the mixed album
    with the default name template to each of phase 21's five types
    (the names the tags give; each file equal to the class's
    ``from_pcm`` on the card followed by ``set_metadata`` of the
    source's tags; every field the class holds and the cover equal to
    the source's, Shorten none); track 1 as a WAVE with a LIST chunk
    before its data and a chunk after it, to FLAC, WavPack and Shorten
    and each back to WAVE byte for byte, and to ALAC (equal to
    ``from_pcm``'s, the chunks dropped); ``--replay-gain`` to WavPack
    and to FLAC (WavPack's four APEv2 items, its peaks the FLAC run's,
    its gains within 0.011 dB of them); ``trackinfo`` (plain, ``-L``,
    ``-C``) and ``tracklength`` over the outputs.  A line with the
    phase's wall, each target's input Msamples/s and ``set_metadata``
    seconds across the album, the launches of each kernel over the
    phase (every one of the default routes must launch) and the card's
    peak memory;
23. the default encode routes, on phase 5's signal at bench shape: the
    FLAC -8 default route (the quantized upload wire), three runs each
    decoded bit-exactly, with Msamples/s, the stages (qpack, upload,
    analysis, fetch, emit, floor), the wire and patched-wire batches,
    the frames the floor retry re-analysed and the overflow retries,
    beside phase 5's device-pack runs and phase 11's ALAC wire runs;
    the card's default-route bytes equal to the CPU's on an 8-block
    slice; one 1024-block batch with ATPU_DEVICE_RICE=exact, decoded
    bit-exactly, rice_planes counted from 0 across it, then held
    element for element against rice_planes_plain on the residuals
    of that run (captured there) and timed as phase 6, beside its
    bound; and an encode split over ``[cuda:0, cuda:0]`` whose bytes
    equal one device's.

Then it prints one JSON line describing each kernel and, last, the
result line {"ok": true, "device": {...}}.  Any failure raises: the
script exits nonzero without the result line.  It imports nothing of
jax or of the reference package, and checks so at the end.  Usage:

    python3 chip_smoke.py
"""

import contextlib
import importlib
import io
import json
import os
import re
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
# ALAC and TTA run length: 4 batches of 1024 framesets (6.3 minutes)
ALAC_BATCHES = 4
# a fixed M4A creation time (QuickTime seconds), for byte comparisons
CREATE_DATE = 3786825600
THROUGHPUT_RUNS = 3
TIMING_RUNS = 15
PLAIN_SYNTH_RUNS = 3
# a spin kernel of ~1 ms at 1.98 GHz, longer than the host takes to
# enqueue one kernel call, so that device_ms times the card alone
SPIN_CYCLES = 2_000_000
# H100 SXM peaks (NVIDIA data sheet): device memory bandwidth, and the
# float32 rate outside the tensor cores, the nearest listed rate for
# the kernels' scalar integer arithmetic
PEAK_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = 67e12
# WavPack: the writer's block, and phase 17's batch of veryhigh blocks
WV_BLOCK = 44100
WV_DEC_BLOCKS = 8
WV_KEYS = ("x", "meta", "chain", "weights", "samples")


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


def device_ms(fn, runs=TIMING_RUNS):
    """median CUDA-event time of fn() over `runs` calls, after one
    warm-up call, each call enqueued behind a spin kernel: the card's
    time for fn's work alone, where median_ms also holds the host's
    time to enqueue it"""
    fn()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SPIN_CYCLES)
        start.record()
        fn()
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop))
    return float(np.median(times))


def bound(n_bytes, n_ops):
    """(bound_ms, bound_by): the least time the card could take, the
    larger of the bytes over its memory rate and the operations over
    its peak rate"""
    (by_bytes, by_ops) = (n_bytes / PEAK_BYTES_PER_S * 1e3,
                          n_ops / PEAK_OPS_PER_S * 1e3)
    return ((by_bytes, "bytes") if by_bytes >= by_ops
            else (by_ops, "operations"))


def ptxas_summary(build_log):
    """each kernel's registers, stack frame and spill stores from nvcc's
    -Xptxas -v output, its template arguments (flac_synth's taps) in
    brackets"""
    out = []
    for m in re.finditer(r"Compiling entry function '([^']+)'.*?(\d+) bytes "
                         r"stack frame, (\d+) bytes spill stores.*?Used "
                         r"(\d+) registers", build_log, re.S):
        name = re.search(r"\d+((?:[a-z]+_)+kernel)(I(?:Li\d+E)+E)?",
                         m.group(1))
        args = re.findall(r"Li(\d+)E", name.group(2) or "")
        out.append(dict(kernel=name.group(1) + (
            "<%s>" % ",".join(args) if args else ""),
            registers=int(m.group(4)), stack_frame=int(m.group(2)),
            spill_stores=int(m.group(3))))
    return out


def loaded_forbidden_modules():
    """modules of jax or of the reference package in this process
    (audiotools_tpu_torch is the port, not the reference)"""
    return sorted(m for m in sys.modules
                  if m in ("jax", "audiotools_tpu") or
                  m.startswith(("jax.", "audiotools_tpu.")))


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


def wv_serial_bounds(meta, chain, encode, chunk, step, max_sm_mhz):
    """(critical path ms, the one-pass-after-another floor ms) of a
    batch of WavPack blocks at the largest SM clock, for a step's
    dependent chain of ``step`` cycles: the longest block's n samples of
    the slowest pass's chain plus the pipeline's fill of (P - 1) chunks
    of ``chunk`` samples, against P * n chains when the passes run one
    after another.  A decode pass of -1 or -2 chains the two channels'
    steps: two steps a sample"""
    (path, floor) = (0.0, 0.0)
    for (b, (_o, n, _cc, passes)) in enumerate(meta.tolist()):
        links = [2 if not encode and t in (-1, -2) else 1
                 for t in chain[b, :passes, 0].tolist()]
        if links:
            path = max(path, n * max(links) * step +
                       (passes - 1) * chunk * step)
            floor = max(floor, n * sum(links) * step)
    return (path / (max_sm_mhz * 1e3), floor / (max_sm_mhz * 1e3))


SERIAL_KEYS = ("step_chain_cycles", "critical_path_ms", "bytes_ms",
               "serial_bound_ms", "old_serial_floor_ms")


def serial_fields(n_bytes, step, path_ms, old_ms):
    """a WavPack kernel's bounds by its recurrence, from its step's
    dependent chain (cycles, measured in this run): the critical path
    and the bytes (each at its peak), the larger of the two, and the
    one-pass-after-another floor of the old structure"""
    bytes_ms = n_bytes / PEAK_BYTES_PER_S * 1e3
    return dict(step_chain_cycles=step, critical_path_ms=path_ms,
                bytes_ms=bytes_ms,
                serial_bound_ms=max(path_ms, bytes_ms),
                old_serial_floor_ms=old_ms)


def wv_tensors(blocks, device):
    """blocks of ops/wv_scan.pack_blocks as its batch (numpy) and the
    batch's tensors on ``device``, in WV_KEYS order"""
    from audiotools_tpu_torch.ops import wv_scan
    batch = wv_scan.pack_blocks(blocks)
    return (batch, [torch.as_tensor(batch[k], device=device)
                    for k in WV_KEYS])


def wv_encode_blocks(signal, passes, frame):
    """the blocks (ops/wv_scan.pack_blocks) that the given frame of an
    all-host WavPack encode of ``signal`` correlates, with their passes'
    state at the frame's start"""
    from audiotools_tpu_torch.pcm import reader_from_array
    from audiotools_tpu_torch.ref import wavpack as wv_oracle
    seen = []

    def capture(jobs):
        seen.append([(np.stack(u[:cc]), [(p.term, p.delta) for p in ps],
                      [list(p.weights) for p in ps],
                      [[list(c) for c in p.samples] for p in ps])
                     for (u, ps, cc) in jobs])
        return wv_oracle.correlate_host(jobs)

    wv_oracle.encode_wavpack(
        io.BytesIO(), reader_from_array(signal[:(frame + 1) * WV_BLOCK], 16),
        WV_BLOCK, correlation_passes=passes, correlate=capture)
    return seen[frame]


def wv_decode_blocks(data, count):
    """the first ``count`` blocks of a stereo WavPack stream as the
    decoder parses them (ops/wv_scan.pack_blocks blocks), and the host
    C++ passes' output of each"""
    from audiotools_tpu_torch.codecs import wavpack
    from audiotools_tpu_torch.ref import wavpack as wv_oracle
    dec = wv_oracle.WavPackDecoder(io.BytesIO(data))
    blocks = []
    host = []
    while len(blocks) < count:
        ((header, sub_blocks),) = dec.read_group()[0]
        parsed = wv_oracle.parse_block(header, sub_blocks)
        blocks.append(wavpack.device_inputs(parsed))
        host.append(np.stack(wv_oracle.decorrelate_host(parsed)))
    dec.close()
    return (blocks, host)


def wv_veryhigh_file(signal):
    """a 16-pass (veryhigh) all-host WavPack encode of the first
    WV_DEC_BLOCKS blocks of ``signal``: phase 17's veryhigh decode
    batch, with the terms -1 and -2"""
    from audiotools_tpu_torch.pcm import reader_from_array
    from audiotools_tpu_torch.ref import wavpack as wv_oracle
    out = io.BytesIO()
    wv_oracle.encode_wavpack(out, reader_from_array(
        signal[:WV_DEC_BLOCKS * WV_BLOCK], 16), WV_BLOCK,
        correlation_passes=16)
    return out.getvalue()


# phase 17's wv_corr blocks: the third block of each encode (signal
# columns, passes)
WV_CORR_CASES = (("standard", slice(None), 5), ("veryhigh", slice(None), 16),
                 ("standard_mono", slice(0, 1), 5))


def wv_corr_blocks(signal):
    """phase 17's wv_corr inputs: {name: block} of WV_CORR_CASES"""
    return {name: wv_encode_blocks(signal[:, cols], passes, 2)[0]
            for (name, cols, passes) in WV_CORR_CASES}


def wv_kernel_inputs():
    """phase 17's inputs of wv_corr and wv_decorr, from phase 11's
    signal: {name: (encode, blocks)}, the wv_corr blocks of
    WV_CORR_CASES, the first 32 blocks of the standard stream and the
    veryhigh batch (a standard encode of the first 32 blocks gives the
    decoder the same blocks as the whole stream's)"""
    from audiotools_tpu_torch.pcm import reader_from_array
    from audiotools_tpu_torch.ref import wavpack as wv_oracle
    signal = program_signal(4096 * 1024 * ALAC_BATCHES)
    standard = io.BytesIO()
    wv_oracle.encode_wavpack(
        standard, reader_from_array(signal[:32 * WV_BLOCK], 16), WV_BLOCK,
        correlation_passes=5)
    inputs = {"corr_" + name: (True, [block]) for (name, block) in
              wv_corr_blocks(signal).items()}
    inputs["decorr_standard_32"] = (
        False, wv_decode_blocks(standard.getvalue(), 32)[0])
    inputs["decorr_veryhigh_%d" % WV_DEC_BLOCKS] = (
        False, wv_decode_blocks(wv_veryhigh_file(signal), WV_DEC_BLOCKS)[0])
    return inputs


def wavpack_phases(dev, alac_sig, max_sm_mhz, cycles_lib):
    """phases 17 and 18 on ``alac_sig``, phase 11's signal, with
    ``cycles_lib`` tools_dev/int_op_cycles.py's build; returns the
    kernels line's rows of wv_corr and wv_decorr and phase 18's encode
    and decode runs"""
    from tools_dev import int_op_cycles
    from audiotools_tpu_torch import _native, kernels
    from audiotools_tpu_torch.codecs import wavpack
    from audiotools_tpu_torch.formats import wavpack as wv_format
    from audiotools_tpu_torch.ops import wv_scan
    from audiotools_tpu_torch.pcm import read_all, reader_from_array
    from audiotools_tpu_torch.ref import wavpack as wv_oracle
    a_frames = alac_sig.shape[0]
    chunk = kernels.wv_chain_config()[0]

    # ---- 17. WavPack kernels vs plain at full width -------------------
    # the dependent chain of one int64 step, encoding and decoding term
    # 18 (the slowest decode term), on one warp of this card: the
    # critical paths below are read from these
    (enc_step, dec_step) = (
        int_op_cycles.cycles(cycles_lib, kind)
        for kind in (int_op_cycles.WV_ENCODE_CASE,
                     int_op_cycles.WV_DECODE_CASE))
    # the all-host encode of phase 18's stream, timed once: phase 17
    # checks wv_decorr on the first decode batch of this file
    t0 = time.perf_counter()
    host_wv = io.BytesIO()
    wv_oracle.encode_wavpack(host_wv, reader_from_array(alac_sig, 16),
                             WV_BLOCK, correlation_passes=5)
    host_wv = host_wv.getvalue()
    host_wv_s = time.perf_counter() - t0

    def dec_check(data, count, tag):
        """the first ``count`` blocks of a stereo stream, as the decoder
        parses them, decorrelated on the card and held to the plain
        version on the CPU and to the host C++ passes; returns the
        batch, its card tensors, the max abs error and the plain ms"""
        (blocks, host) = wv_decode_blocks(data, count)
        (batch, card) = wv_tensors(blocks, dev)
        (_, cpu) = wv_tensors(blocks, "cpu")
        got = wv_scan.run_dec_chain(*card).cpu()
        t0 = time.perf_counter()
        want = wv_scan.run_dec_chain_plain(*cpu)
        plain_ms = (time.perf_counter() - t0) * 1e3
        err = int((got - want).abs().max())
        if not torch.equal(got, want):
            raise AssertionError("wv_decorr kernel != plain version (%s, "
                                 "max abs err %d)" % (tag, err))
        if not all(np.array_equal(a, b) for (a, b) in zip(
                wv_scan.unpack(got.numpy(), batch["meta"]), host)):
            raise AssertionError("wv_decorr kernel != the host C++ passes "
                                 "(%s)" % (tag,))
        return (batch, card, err, plain_ms)

    def dec_timing(batch, card, err, plain_ms):
        """wv_decorr's times on a batch checked by dec_check, its serial
        step, and its bound"""
        passes = int(batch["meta"][:, 3].max())
        steps = WV_BLOCK * passes
        total = int(batch["x"].size)
        # residuals read and samples written once, 8 bytes each (the
        # per-block chains, weights and stored samples: 1.4 KB a
        # block); a channel's step: a 64-bit multiply (3 IMADs), 2
        # adds, a shift, 2 compares, a select and an add
        n_bytes = 2 * total * 8 + len(batch["meta"]) * 1440
        (b_ms, b_by) = bound(n_bytes, 10 * int((batch["meta"][:, 1] *
                                                batch["meta"][:, 2] *
                                                batch["meta"][:, 3]).sum()))
        (path_ms, old_ms) = wv_serial_bounds(batch["meta"], batch["chain"],
                                             False, chunk, dec_step,
                                             max_sm_mhz)
        ms = median_ms(lambda: wv_scan.run_dec_chain(*card), 5)
        return dict(
            max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
            bound_by=b_by,
            device_ms=device_ms(lambda: wv_scan.run_dec_chain(*card), 5),
            ns_per_step=ms * 1e6 / steps,
            cycles_per_step_at_max_sm=ms * 1e3 * max_sm_mhz / steps,
            cycles_per_critical_step_at_max_sm=ms * 1e3 * max_sm_mhz /
            WV_BLOCK,
            **serial_fields(n_bytes, dec_step, path_ms, old_ms))

    # the main path's batch: the first 32 blocks of the standard stream
    (d_batch, d_card, d_err, d_plain) = dec_check(
        host_wv, wavpack.DEC_BATCH_BLOCKS, "standard")
    std_dec = dec_timing(d_batch, d_card, d_err, d_plain)
    del d_card
    # veryhigh blocks: 16 passes, with the negative terms -1 and -2
    (v_batch, v_card, v_err, v_plain) = dec_check(
        wv_veryhigh_file(alac_sig), WV_DEC_BLOCKS, "veryhigh")
    if any(not {-1, -2} <= set(v_batch["chain"][b, :p, 0].tolist())
           for (b, p) in enumerate(v_batch["meta"][:, 3].tolist())):
        raise AssertionError("veryhigh blocks without terms -1 and -2")
    vh_dec = dec_timing(v_batch, v_card, v_err, v_plain)
    del v_card
    line("kernel_vs_plain", kernel="wv_decorr", equal=True,
         equal_host_cpp=True, plain_on="cpu",
         blocks={"standard": dict(shape=[wavpack.DEC_BATCH_BLOCKS, 2,
                                         WV_BLOCK, 5], **std_dec),
                 "veryhigh": dict(shape=[WV_DEC_BLOCKS, 2, WV_BLOCK, 16],
                                  **vh_dec)})
    decorr_row = dict(max_abs_err=max(d_err, v_err), ms=std_dec["ms"],
                      plain_ms=std_dec["plain_ms"],
                      bound_ms=std_dec["bound_ms"],
                      bound_by=std_dec["bound_by"], library_ms=None,
                      **{k: std_dec[k] for k in SERIAL_KEYS})

    # a mono block beside the stereo ones: one chain a step instead of two
    corr_jobs = wv_corr_blocks(alac_sig)
    corr_rows = {}
    for (name, block) in corr_jobs.items():
        # each block's plain run alone: the same input as its card time
        (c_batch, c_cpu) = wv_tensors([block], "cpu")
        t0 = time.perf_counter()
        want = wv_scan.run_pass_chain_plain(*c_cpu)
        plain_ms = (time.perf_counter() - t0) * 1e3
        (_, c_card) = wv_tensors([block], dev)
        got = [t.cpu() for t in wv_scan.run_pass_chain(*c_card)]
        err = int((got[0] - want[0]).abs().max())
        if not all(torch.equal(g, w) for (g, w) in zip(got, want)):
            raise AssertionError("wv_corr kernel != plain version (%s, max "
                                 "abs err %d)" % (name, err))
        (x, chain, w, s) = block
        cc = x.shape[0]
        cur = list(x)
        for (p, (t, d)) in enumerate(chain):
            (cur, ws, ss) = _native.wv_correlate(cur, t, d, w[p], s[p])
            if ws != got[1][0, p, :cc].tolist() or (
                    t > 0 and not np.array_equal(
                        np.stack(ss), got[2][0, p, :cc, :wv_scan.span(t)])):
                raise AssertionError("wv_corr state != the host C++ pass "
                                     "(%s, pass %d)" % (name, p))
        if not np.array_equal(np.stack(cur),
                              wv_scan.unpack(got[0], c_batch["meta"])[0]):
            raise AssertionError("wv_corr kernel != the host C++ passes "
                                 "(%s)" % (name,))
        steps = WV_BLOCK * len(chain)
        n_bytes = 2 * x.size * 8 + 1440
        (c_bound, c_bound_by) = bound(n_bytes, 10 * x.size * len(chain))
        (path_ms, old_ms) = wv_serial_bounds(
            c_batch["meta"], c_batch["chain"], True, chunk, enc_step,
            max_sm_mhz)
        c_ms = median_ms(lambda: wv_scan.run_pass_chain(*c_card), 5)
        corr_rows[name] = dict(
            passes=len(chain), max_abs_err=err, ms=c_ms,
            device_ms=device_ms(lambda: wv_scan.run_pass_chain(*c_card), 5),
            plain_ms=plain_ms, ns_per_step=c_ms * 1e6 / steps,
            cycles_per_step_at_max_sm=c_ms * 1e3 * max_sm_mhz / steps,
            cycles_per_critical_step_at_max_sm=c_ms * 1e3 * max_sm_mhz /
            WV_BLOCK,
            bound_ms=c_bound, bound_by=c_bound_by,
            **serial_fields(n_bytes, enc_step, path_ms, old_ms))
        del c_card, got
    line("kernel_vs_plain", kernel="wv_corr", shape=[1, 2, WV_BLOCK],
         equal=True, equal_host_cpp=True, plain_on="cpu", blocks=corr_rows)
    std = corr_rows["standard"]
    corr_row = dict(max_abs_err=max(r["max_abs_err"]
                                    for r in corr_rows.values()),
                    ms=std["ms"], plain_ms=std["plain_ms"],
                    bound_ms=std["bound_ms"], bound_by=std["bound_by"],
                    library_ms=None, **{k: std[k] for k in SERIAL_KEYS})

    # ---- 18. WavPack identity and throughput ---------------------------
    for (tag, short_w, channels, compression) in (
            ("veryhigh", program_signal(5000, seed=19), 2, "veryhigh"),
            ("6ch", np.concatenate([program_signal(3000, seed=23)] * 3,
                                   axis=1), 6, "standard")):
        files = []
        for device in ("cpu", dev):
            out = io.BytesIO()
            wv_format.write_wavpack(out, reader_from_array(short_w, 16),
                                    compression, device=device)
            files.append(out.getvalue())
            if not np.array_equal(wavpack.decode_wavpack(files[-1],
                                                         device=device),
                                  short_w):
                raise AssertionError("short WavPack stream (%s) does not "
                                     "decode on %s" % (tag, device))
        if files[0] != files[1]:
            raise AssertionError("short WavPack files (%s) differ between "
                                 "the card and the CPU" % (tag,))
    t0 = time.perf_counter()
    if not np.array_equal(read_all(wv_oracle.WavPackDecoder(
            io.BytesIO(host_wv))), alac_sig):
        raise AssertionError("host WavPack decode is not bit-exact")
    host_wv_dec_s = time.perf_counter() - t0
    wv_enc_runs = []
    wv_dec_runs = []
    # the stream's blocks: a wv_corr launch each, a wv_decorr launch a
    # batch of DEC_BATCH_BLOCKS
    wv_blocks = -(-a_frames // WV_BLOCK)
    for _ in range(THROUGHPUT_RUNS):
        timings = {}
        out = io.BytesIO()
        wv_scan.run_pass_chain.launches = 0
        t0 = time.perf_counter()
        wv_format.write_wavpack(out, reader_from_array(alac_sig, 16),
                                "standard", device=dev, timings=timings)
        wall = time.perf_counter() - t0
        c_launches = wv_scan.run_pass_chain.launches
        if c_launches != wv_blocks:
            raise AssertionError("main WavPack encode: %d launches of "
                                 "wv_corr, not one a block" % (c_launches,))
        if out.getvalue() != host_wv:
            raise AssertionError("card WavPack encode differs from the "
                                 "all-host encode")
        wv_enc_runs.append(dict(
            wall_s=wall, Msamples_per_s=a_frames * 2 / wall / 1e6,
            ratio=len(host_wv) / (alac_sig.size * 2), stage_s=timings,
            wv_corr_launches=c_launches))
        del out
        wv_scan.run_dec_chain.launches = 0
        t0 = time.perf_counter()
        dec = wavpack.TorchWavPackDecoder(io.BytesIO(host_wv), device=dev)
        samples = read_all(dec)
        wall = time.perf_counter() - t0
        d_launches = wv_scan.run_dec_chain.launches
        if (d_launches != -(-wv_blocks // wavpack.DEC_BATCH_BLOCKS) or
                dec.host_blocks or not dec.md5_checked):
            raise AssertionError("main WavPack decode: %d launches of "
                                 "wv_decorr, not one a %d-block batch, %d "
                                 "host blocks, MD5 checked: %s"
                                 % (d_launches, wavpack.DEC_BATCH_BLOCKS,
                                    dec.host_blocks,
                                    dec.md5_checked))
        if not np.array_equal(samples, alac_sig):
            raise AssertionError("card WavPack decode is not bit-exact")
        wv_dec_runs.append(dict(
            wall_s=wall, Msamples_per_s=a_frames * 2 / wall / 1e6,
            stage_s=dict(dec.timings), wv_decorr_launches=d_launches,
            host_blocks=0, md5_checked=True))
        del dec, samples
    we_rates = [r["Msamples_per_s"] for r in wv_enc_runs]
    wd_rates = [r["Msamples_per_s"] for r in wv_dec_runs]
    line("wavpack_identity_throughput", identical=True, bit_exact=True,
         md5_checked=True, decode_host_blocks=0,
         audio_seconds=a_frames / SAMPLE_RATE, compression="standard",
         encode_Msamples_per_s=float(np.median(we_rates)),
         encode_Msamples_per_s_runs=we_rates,
         decode_Msamples_per_s=float(np.median(wd_rates)),
         decode_Msamples_per_s_runs=wd_rates,
         host_encode_Msamples_per_s=a_frames * 2 / host_wv_s / 1e6,
         host_decode_Msamples_per_s=a_frames * 2 / host_wv_dec_s / 1e6,
         encode_runs=wv_enc_runs, decode_runs=wv_dec_runs)

    return (corr_row, decorr_row, wv_enc_runs, wv_dec_runs)


# phase 19: ReplayGain's titles and AccurateRip's tracks (an album of
# four cut from phase 11's signal), and the resampler's read sizes
RG_TITLES = 4
RESAMPLE_READS = (4096, 1 << 20)


def sync(dev):
    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize()


def stage_runs(runs, in_samples):
    """the median run's wall and stage seconds (host: the wall less the
    stages), with every run's rate in Msamples/s of input PCM"""
    rates = [in_samples / r["wall_s"] / 1e6 for r in runs]
    median = runs[int(np.argsort(rates)[len(rates) // 2])]
    stages = dict(median["stage_s"])
    stages["host"] = median["wall_s"] - sum(stages.values())
    return dict(Msamples_per_s=float(np.median(rates)),
                Msamples_per_s_runs=rates, wall_s=median["wall_s"],
                stage_s=stages)


def rg_window_sums_conv1d(left, right, h, window_samples, segment=1 << 16):
    """ops.converters.rg_window_sums with the FIR as float64 F.conv1d in
    segments of ``segment`` samples (each with L - 1 samples of the one
    before), phase 19's timed alternative to the overlap-save FFT"""
    import torch.nn.functional as F
    n = left.shape[0] // window_samples * window_samples
    L = h.shape[0]
    x = F.pad(torch.stack([left[:n], right[:n]])[:, None, :], (L - 1, 0))
    kernel = h.flip(0)[None, None, :]
    sq = torch.empty(n, dtype=torch.float64, device=left.device)
    for s0 in range(0, n, segment):
        y = F.conv1d(x[:, :, s0:s0 + segment + L - 1], kernel)[:, 0, :]
        sq[s0:s0 + y.shape[1]] = y[0] * y[0] + y[1] * y[1]
    return sq.view(-1, window_samples).sum(dim=1)


def resample_fir_indexed(hist, starts, q, bank):
    """ops.converters.resample_fir with each slab's windows gathered by
    advanced indexing of the [L, ch] history and summed as one batched
    matmul (1 x taps by taps x channels an output), phase 19's timed
    alternative to its selection of whole windows"""
    from audiotools_tpu_torch.ops import converters
    (ch, taps) = (hist.shape[1], bank.shape[1])
    out = torch.empty((starts.shape[0], ch), dtype=torch.float64,
                      device=hist.device)
    t = torch.arange(taps, device=hist.device)
    slab = max(1, converters.SLAB_BYTES // (taps * ch * 8))
    for s0 in range(0, starts.shape[0], slab):
        win = hist[starts[s0:s0 + slab, None] + t]
        coef = bank[q[s0:s0 + slab]]
        out[s0:s0 + slab] = torch.bmm(coef[:, None, :], win)[:, 0, :]
    return out


def converter_phase(dev, alac_sig):
    """phase 19 on ``alac_sig``, phase 11's signal: the converters on
    ``dev`` against the port's host C++ twins, timed; returns its line's
    fields"""
    from audiotools_tpu_torch import _native, pcmconverter, replaygain
    from audiotools_tpu_torch import accuraterip_checksum as ar
    from audiotools_tpu_torch.codecs.flac_dec import upload_arrays
    from audiotools_tpu_torch.ops import converters
    from audiotools_tpu_torch.pcm import PCMConverter, reader_from_array
    _native.get_lib()
    a_frames = alac_sig.shape[0]
    in_samples = alac_sig.size
    per = a_frames // RG_TITLES
    titles = [alac_sig[k * per:(k + 1) * per] for k in range(RG_TITLES)]
    out = {}

    # ---- ReplayGain: the album on the card, the host IIR beside it -----
    win = int(np.ceil(SAMPLE_RATE * replaygain.RMS_WINDOW_TIME))
    t0 = time.perf_counter()
    host_hists = []
    for title in titles:
        x = title.astype(np.float64)
        sums = converters.rg_window_sums_host(x[:, 0], x[:, 1],
                                              SAMPLE_RATE, win)
        hist = np.zeros(12000, dtype=np.int64)
        values = 1000.0 * np.log10(sums / win * 0.5 + 1e-37)
        np.add.at(hist, np.clip(values.astype(np.int64), 0, 11999), 1)
        host_hists.append(hist)
    host_rg_s = time.perf_counter() - t0
    host_gains = [replaygain._analyze_histogram(h) for h in host_hists]
    host_peaks = [float(np.abs(t).max()) / 32768 for t in titles]
    rg_runs = []
    for _ in range(THROUGHPUT_RUNS):
        rg = replaygain.ReplayGain(SAMPLE_RATE, device=dev)
        sync(dev)
        t0 = time.perf_counter()
        results = [rg.title_gain(reader_from_array(t, 16)) for t in titles]
        album = rg.album_gain()
        wall = time.perf_counter() - t0
        rg_runs.append(dict(wall_s=wall, stage_s=dict(rg.timings)))
    # each title's histogram: the album's growth over the title (last run)
    moved = []
    for (k, title) in enumerate(titles):
        rg_k = replaygain.ReplayGain(SAMPLE_RATE, device=dev)
        rg_k.title_gain(reader_from_array(title, 16))
        moved.append(int(np.abs(rg_k.album_histogram -
                                host_hists[k]).sum()))
    gains = [g for (g, _p) in results]
    if [p for (_g, p) in results] != host_peaks or album[1] != max(host_peaks):
        raise AssertionError("ReplayGain peaks differ from the host's")
    album_host = replaygain._analyze_histogram(sum(host_hists))
    gain_err = max(abs(g - h) for (g, h) in zip(gains + [album[0]],
                                               host_gains + [album_host]))
    if max(moved) > 2 or gain_err > 0.011:
        raise AssertionError("ReplayGain differs from the host IIR: windows "
                             "moved %s, gain error %r dB" % (moved, gain_err))
    # the alternatives: the FIR as float64 conv1d, and the title's reads
    # streamed into a card buffer in place of one upload at its end
    title = titles[0]
    x = torch.as_tensor(title, device=dev).to(torch.float64)
    h = torch.tensor(converters.rg_combined_fir(SAMPLE_RATE), device=dev)
    fft_ms = median_ms(lambda: converters.rg_window_sums(
        x[:, 0], x[:, 1], h, win), 3)
    conv_ms = median_ms(lambda: rg_window_sums_conv1d(
        x[:, 0], x[:, 1], h, win), 3)
    conv_sums = rg_window_sums_conv1d(x[:, 0], x[:, 1], h, win).cpu().numpy()
    values = 1000.0 * np.log10(conv_sums / win * 0.5 + 1e-37)
    conv_hist = np.zeros(12000, dtype=np.int64)
    np.add.at(conv_hist, np.clip(values.astype(np.int64), 0, 11999), 1)
    pieces = [title[a:a + 4096].astype(np.int16)
              for a in range(0, per, 4096)]
    sync(dev)
    t0 = time.perf_counter()
    upload_arrays({"x": np.concatenate(pieces)}, torch.device(dev),
                  dtype=torch.int16)
    sync(dev)
    flush_upload_s = time.perf_counter() - t0
    buf = torch.empty((per, 2), dtype=torch.int16, device=dev)
    t0 = time.perf_counter()
    for (k, piece) in enumerate(pieces):
        buf[k * 4096:k * 4096 + len(piece)] = upload_arrays(
            {"x": piece}, torch.device(dev), dtype=torch.int16)["x"]
    sync(dev)
    streamed_upload_s = time.perf_counter() - t0
    del x, buf
    out["replaygain"] = dict(
        titles=RG_TITLES, title_seconds=per / SAMPLE_RATE, gains=gains,
        album_gain=album[0], host_gains=host_gains, album_host=album_host,
        peaks_equal=True, windows_moved=moved, max_gain_error_db=gain_err,
        fir_taps=int(h.shape[0]), host_iir_s=host_rg_s,
        host_Msamples_per_s=in_samples / host_rg_s / 1e6,
        fft_title_ms=fft_ms, conv1d_title_ms=conv_ms,
        conv1d_windows_moved=int(np.abs(conv_hist - host_hists[0]).sum()),
        flush_upload_s=flush_upload_s, streamed_upload_s=streamed_upload_s,
        **stage_runs(rg_runs, in_samples))

    # ---- AccurateRip: a four-track CD, 65,536-frame chunks -------------
    tracks = [(titles[k], k == 0, k == RG_TITLES - 1)
              for k in range(RG_TITLES)]
    t0 = time.perf_counter()
    host_sums = []
    for (track, first, last) in tracks:
        window = ar.AccurateRipCRC(first, last, SAMPLE_RATE, len(track),
                                   device="cpu")
        host_sums.append(_native.accuraterip_update(
            track, 1, window.start_offset, window.end_offset, 0, 0))
    host_ar_s = time.perf_counter() - t0
    ar_runs = []
    for _ in range(THROUGHPUT_RUNS):
        sync(dev)
        t0 = time.perf_counter()
        sums = [ar.accuraterip_checksums(reader_from_array(track, 16),
                                         len(track), first, last,
                                         device=dev)
                for (track, first, last) in tracks]
        wall = time.perf_counter() - t0
        if sums != host_sums:
            raise AssertionError("AccurateRip differs from the host's: %s, "
                                 "%s" % (sums, host_sums))
        ar_runs.append(dict(wall_s=wall, stage_s={}))
    # the stages of one more run, by AccurateRipCRC's own timings
    stage_s = {"upload": 0.0, "sums": 0.0}
    for (track, first, last) in tracks:
        crc = ar.AccurateRipCRC(first, last, SAMPLE_RATE, len(track),
                                device=dev)
        for a in range(0, len(track), 1 << 16):
            crc.update_array(track[a:a + (1 << 16)])
        crc.checksums()
        for key in stage_s:
            stage_s[key] += crc.timings[key]
    ar_summary = stage_runs(ar_runs, in_samples)
    ar_summary["stage_s"] = dict(stage_s, host=ar_summary["wall_s"] -
                                 sum(stage_s.values()))
    out["accuraterip"] = dict(
        tracks=RG_TITLES, chunk_frames=1 << 16, checksums=sums, equal=True,
        host_s=host_ar_s, host_Msamples_per_s=in_samples / host_ar_s / 1e6,
        **ar_summary)

    # ---- Resampler: 44.1 -> 48 kHz (track2track -r 48000) --------------
    def host_resample(sig, bps, src, dst):
        """the port's C++ FIR over every output's window, one shot;
        (int outputs, seconds of the FIR)"""
        r = pcmconverter.Resampler(reader_from_array(sig[:1], bps, src),
                                   dst, device="cpu")
        (num, den, half) = (r.step_num, r.step_den, r.half)
        total = sig.shape[0] * dst // src
        m = np.arange(total, dtype=np.int64)
        hist = np.zeros((sig.shape[0] + 2 * r.TAPS, sig.shape[1]))
        hist[half:half + sig.shape[0]] = sig / float(1 << (bps - 1))
        starts = m * num // den + 1
        q = m * num % den
        if r.bank_den != den:
            q = (q * r.bank_den + den // 2) // den % r.bank_den
        t0 = time.perf_counter()
        fir = _native.resample_fir(hist, starts, q, r.__bank__)
        seconds = time.perf_counter() - t0
        return (np.clip(np.trunc(fir * (1 << (bps - 1))), -(1 << (bps - 1)),
                        (1 << (bps - 1)) - 1).astype(np.int32), seconds)

    def card_resample(sig, bps, src, dst, size):
        reader = PCMConverter(reader_from_array(sig, bps, src), dst, 2, 0x3,
                              bps, device=dev)
        sync(dev)
        t0 = time.perf_counter()
        got = read_all_of(reader, size)
        wall = time.perf_counter() - t0
        return (got, dict(wall_s=wall, stage_s=dict(reader.timings)))

    def read_all_of(reader, size):
        pieces = []
        while True:
            frame = reader.read(size)
            if frame.frames == 0:
                return np.concatenate(pieces)
            pieces.append(frame.samples)

    def lsb_check(got, want, what):
        if got.shape != want.shape:
            raise AssertionError("%s: %s outputs, host %s"
                                 % (what, got.shape, want.shape))
        diff = np.abs(got.astype(np.int64) - want)
        share = float((diff != 0).mean())
        if diff.max() > 1 or share >= 1e-4:
            raise AssertionError("%s: max diff %d LSB, share %r"
                                 % (what, diff.max(), share))
        return (int(diff.max()), share)

    (want, host_fir_s) = host_resample(alac_sig, 16, SAMPLE_RATE, 48000)
    resample = dict(pair=[SAMPLE_RATE, 48000], outputs=int(want.shape[0]),
                    host_fir_s=host_fir_s,
                    host_Msamples_per_s=in_samples / host_fir_s / 1e6)
    outputs = {}
    for size in RESAMPLE_READS:
        runs = []
        for _ in range(THROUGHPUT_RUNS):
            if torch.device(dev).type == "cuda":
                torch.cuda.reset_peak_memory_stats()
            (got, run) = card_resample(alac_sig, 16, SAMPLE_RATE, 48000,
                                       size)
            runs.append(run)
        if torch.device(dev).type == "cuda":
            resample["peak_mem_GB_%d" % size] = (
                torch.cuda.max_memory_allocated() / 1e9)
        (resample["max_diff_lsb_%d" % size],
         resample["share_differing_%d" % size]) = lsb_check(
            got, want, "44.1 -> 48 kHz, reads of %d" % size)
        outputs[size] = got
        resample["reads_%d" % size] = stage_runs(runs, in_samples)
    resample["read_sizes_differing"] = int(
        (outputs[RESAMPLE_READS[0]] != outputs[RESAMPLE_READS[1]]).sum())
    del outputs, want
    # the alternative form of the exact bank: the gather, on the windows
    # of one read of 1 << 20 outputs
    r = pcmconverter.Resampler(reader_from_array(alac_sig, 16), 48000,
                               device=dev)
    r._append(alac_sig[:(4096 + (1 << 20)) * 147 // 160 + 1024])
    banded_ms = median_ms(lambda: r._fir(4096, 4096 + (1 << 20)), 5)
    (band, r.band) = (r.band, None)
    r.bank = torch.as_tensor(r.__bank__, device=dev)
    gather_ms = median_ms(lambda: r._fir(4096, 4096 + (1 << 20)), 5)
    resample.update(banded_read_ms=banded_ms, gather_read_ms=gather_ms,
                    band_shape=list(band.shape))
    del r, band
    # the quantised bank (44.1 -> 44.099 kHz, den 44,099 > 8192) on 60 s,
    # and its gather by advanced indexing on one read's windows
    sixty = alac_sig[:SAMPLE_RATE * 60]
    (want, q_fir_s) = host_resample(sixty, 16, SAMPLE_RATE, 44099)
    (got, run) = card_resample(sixty, 16, SAMPLE_RATE, 44099, 1 << 20)
    (resample["quantised_max_diff_lsb"],
     resample["quantised_share_differing"]) = lsb_check(
        got, want, "44.1 -> 44.099 kHz, reads of %d" % (1 << 20))
    r = pcmconverter.Resampler(reader_from_array(sixty, 16), 44099,
                               device=dev)
    r._append(sixty[:(1 << 20) + 1024])
    quantised_ms = median_ms(lambda: r._fir(0, 1 << 20), 5)
    fir_impl = converters.resample_fir
    converters.resample_fir = resample_fir_indexed
    try:
        indexed_ms = median_ms(lambda: r._fir(0, 1 << 20), 3)
    finally:
        converters.resample_fir = fir_impl
    resample.update(quantised=stage_runs([run], sixty.size),
                    quantised_host_fir_s=q_fir_s,
                    quantised_gather_read_ms=quantised_ms,
                    quantised_indexed_read_ms=indexed_ms)
    del r, got, want
    # 96 -> 44.1 kHz on a 60 s 24-bit stream of the same seed
    hi = program_signal(96000 * 60) << 8
    (want, hi_fir_s) = host_resample(hi, 24, 96000, SAMPLE_RATE)
    for size in RESAMPLE_READS:
        (got, run) = card_resample(hi, 24, 96000, SAMPLE_RATE, size)
        resample["96k_max_diff_lsb_%d" % size], resample[
            "96k_share_differing_%d" % size] = lsb_check(
            got, want, "96 -> 44.1 kHz, reads of %d" % size)
        resample["96k_reads_%d" % size] = stage_runs([run], hi.size)
    resample["96k_host_fir_s"] = hi_fir_s
    out["resampler"] = resample

    # ---- short cases on the card and the CPU ---------------------------
    short = program_signal(SAMPLE_RATE * 3, seed=3)
    cases = {}
    for device in (dev, "cpu"):
        rg = replaygain.ReplayGain(SAMPLE_RATE, device=device)
        cases[str(device)] = dict(
            title8=rg.title_gain(reader_from_array(short[:, :1] >> 8, 8)),
            title24=rg.title_gain(reader_from_array(short << 8, 24)),
            hist=rg.album_histogram,
            ar=ar.accuraterip_checksums(
                reader_from_array(short[:2 * 65536 + 2], 16),
                2 * 65536 + 2, False, True, device=device))
    (c, h) = (cases[str(dev)], cases["cpu"])
    for key in ("title8", "title24"):
        if c[key][1] != h[key][1] or abs(c[key][0] - h[key][0]) > 0.011:
            raise AssertionError("short %s differs between %s and the CPU"
                                 % (key, dev))
    if c["ar"] != h["ar"] or np.abs(c["hist"] - h["hist"]).sum() > 4:
        raise AssertionError("short cases differ between %s and the CPU"
                             % (dev,))
    out["short_cases_equal"] = dict(
        gains_equal=all(c[k] == h[k] for k in ("title8", "title24")),
        windows_moved=int(np.abs(c["hist"] - h["hist"]).sum()),
        ar_final_chunk_frames=2, ar_equal=True)
    return out


# phase 20: the album cut from phase 5's signal, the worker counts
# farmed, and the short album's tracks (seconds)
FARM_TRACKS = 8
FARM_WORKERS = (1, 2, 4, 6)
SHORT_SECONDS = (3.1, 4.7)
# the interpreter switch interval of phase 20's probe (default 5 ms)
SHORT_SWITCH_S = 0.0002


def album_cuts(n_frames, tracks):
    """track boundaries of ``n_frames`` cut into ``tracks``: none but the
    ends on a 4096-frame boundary, so that every track but the last
    ends in a short block"""
    cuts = [0] + [k * (n_frames // tracks) + 777 * k + 131
                  for k in range(1, tracks)] + [n_frames]
    assert all(c % 4096 for c in cuts[1:-1])
    return cuts


def farm_phase(dev, sig, enc_rate=None, dec_rate=None):
    """phase 20 on ``sig``, phase 5's signal: an album of FARM_TRACKS
    WAVE tracks transcoded to FLAC -8 on ``dev`` by the port's farm at
    each of FARM_WORKERS, each job decode-verified with its AccurateRip
    sums (``farm.verify_flac``); returns its line's fields.  On a CPU
    ``dev`` (a rehearsal with a short signal) the card's counters and
    memory are not read."""
    import functools
    import tempfile
    from audiotools_tpu_torch import _native
    from audiotools_tpu_torch import accuraterip_checksum as ar
    from audiotools_tpu_torch.codecs import flac_dec
    from audiotools_tpu_torch.codecs import flac_enc_fast as port_enc
    from audiotools_tpu_torch.formats.flac import FlacAudio
    from audiotools_tpu_torch.formats.wav import WaveAudio
    from audiotools_tpu_torch.ops import bitpack, flac_synth, rice_decode
    from audiotools_tpu_torch.parallel import dryrun, farm, mesh
    from audiotools_tpu_torch.pcm import reader_from_array
    dev = torch.device(dev)
    on_cuda = dev.type == "cuda"
    if on_cuda:
        torch.cuda.init()       # the memory statistics need a context
    counters = (bitpack.pack_rows, rice_decode.decode_partitions,
                flac_synth.synthesize)
    cuts = album_cuts(sig.shape[0], FARM_TRACKS)
    tracks = [sig[a:b] for (a, b) in zip(cuts, cuts[1:])]
    in_samples = sig.size
    out = dict(tracks=FARM_TRACKS, track_frames=[len(t) for t in tracks],
               audio_seconds=sig.shape[0] / SAMPLE_RATE)
    with tempfile.TemporaryDirectory(prefix="farm-") as work:
        t0 = time.perf_counter()
        sources = []
        for (i, track) in enumerate(tracks):
            path = os.path.join(work, "track%02d.wav" % i)
            WaveAudio.from_pcm(path, reader_from_array(track, 16))
            sources.append(path)
        out["wav_write_s"] = time.perf_counter() - t0
        sums = []
        for (i, track) in enumerate(tracks):
            window = ar.AccurateRipCRC(i == 0, i == len(tracks) - 1,
                                       SAMPLE_RATE, len(track),
                                       device="cpu")
            sums.append(_native.accuraterip_update(
                track, 1, window.start_offset, window.end_offset, 0, 0))

        def farm_run(workers, devices, tag, sources=sources, tracks=tracks,
                     sums=sums):
            """one transcode of the album; checks every job and returns
            (files, the run's fields)"""
            last = len(sources) - 1
            jobs = [farm.FarmJob(src, os.path.join(work, "%s%02d.flac"
                                                   % (tag, i)),
                                 FlacAudio, compression="8",
                                 post=functools.partial(
                                     farm.verify_flac,
                                     accuraterip=(i == 0, i == last)))
                    for (i, src) in enumerate(sources)]
            (host0, fallback0) = (flac_dec.host_chunks,
                                  port_enc.fallback_batches)
            for fn in counters:
                fn.launches = 0
            retries0 = (torch.cuda.memory_stats(dev).get(
                "num_alloc_retries", 0) if on_cuda else 0)
            t0 = time.perf_counter()
            results = farm.transcode(jobs, workers=workers, devices=devices)
            sync(dev)
            wall = time.perf_counter() - t0
            launches = [fn.launches for fn in counters]
            # the caching allocator's retries: an allocation that found
            # no free cached block, so that the cache was emptied (a
            # synchronising cudaFree) before cudaMalloc was tried again
            retries = (torch.cuda.memory_stats(dev).get(
                "num_alloc_retries", 0) - retries0 if on_cuda else None)
            for r in results:
                if not r.ok:
                    raise AssertionError("farm job %s failed: %r"
                                         % (r.job.dest_path, r.error))
            for (r, track, want) in zip(results, tracks, sums):
                (samples, got) = r.post
                if not np.array_equal(samples, track):
                    raise AssertionError("%s does not decode to its source"
                                         % (r.job.dest_path,))
                if tuple(got) != tuple(want):
                    raise AssertionError("%s: AccurateRip %s != the host's "
                                         "%s" % (r.job.dest_path, got, want))
            if flac_dec.host_chunks != host0:
                raise AssertionError("farm decodes sent %d chunks to the "
                                     "host route"
                                     % (flac_dec.host_chunks - host0))
            # the default FLAC route (the quantized upload wire) packs
            # no residuals on the card: pack_rows is off its path
            if (any(torch.device(d).type == "cuda" for d in devices) and
                    min(launches[1:]) <= 0):
                raise AssertionError("farm run never launched a kernel of "
                                     "its path: %s" % (launches,))
            files = []
            for r in results:
                with open(r.job.dest_path, "rb") as f:
                    files.append(f.read())
                os.unlink(r.job.dest_path)
            return (files, dict(
                wall_s=wall, Msamples_per_s=in_samples / wall / 1e6,
                pack_rows_launches=launches[0],
                rice_decode_launches=launches[1],
                flac_synth_launches=launches[2],
                fallback_batches=port_enc.fallback_batches - fallback0,
                alloc_retries=retries))

        runs = {w: [] for w in FARM_WORKERS}
        peak = {}
        first = None

        def counted(workers):
            nonlocal first
            if on_cuda and not runs[workers]:
                torch.cuda.reset_peak_memory_stats(dev)
            (files, fields) = farm_run(workers, [dev], "w%d_" % workers)
            if first is None:
                first = files
            elif files != first:
                raise AssertionError("the %d-worker farm's files differ "
                                     "from the first 1-worker run's"
                                     % (workers,))
            runs[workers].append(fields)
            if on_cuda:
                (allocated, reserved) = peak.get(workers, (0.0, 0.0))
                peak[workers] = (
                    max(allocated,
                        torch.cuda.max_memory_allocated(dev) / 1e9),
                    max(reserved, torch.cuda.max_memory_reserved(dev) / 1e9))

        for workers in FARM_WORKERS:
            counted(workers)
        best = max(FARM_WORKERS[1:],
                   key=lambda w: runs[w][0]["Msamples_per_s"])
        for _ in range(THROUGHPUT_RUNS - 1):
            counted(1)
            counted(best)
        base = float(np.median([r["Msamples_per_s"] for r in runs[1]]))
        out["workers"] = []
        for w in FARM_WORKERS:
            rates = [r["Msamples_per_s"] for r in runs[w]]
            out["workers"].append(dict(
                workers=w, Msamples_per_s=float(np.median(rates)),
                Msamples_per_s_runs=rates,
                wall_s_runs=[r["wall_s"] for r in runs[w]],
                speedup=float(np.median(rates)) / base,
                peak_mem_GB=peak.get(w, (None, None))[0],
                peak_reserved_GB=peak.get(w, (None, None))[1],
                runs=runs[w]))
        out["best_workers"] = best
        out["identical_files"] = True

        # the interpreter's switch interval cut from 5 ms to 0.2 ms, at 4
        # workers: does a worker that gives up the lock around each
        # launch wait out another's interval to get it back?
        old = sys.getswitchinterval()
        sys.setswitchinterval(SHORT_SWITCH_S)
        try:
            (files, fields) = farm_run(4, [dev], "si")
        finally:
            sys.setswitchinterval(old)
        if files != first:
            raise AssertionError("the switch-interval probe wrote other "
                                 "files")
        out["switch_interval_probe"] = dict(
            workers=4, switch_interval_s=SHORT_SWITCH_S, default_s=old,
            **fields)

        # the per-device code, with the one card listed twice
        (files, fields) = farm_run(4, [dev, dev], "pd")
        if files != first:
            raise AssertionError("the farm over [dev, dev] wrote other "
                                 "files")
        out["per_device_code"] = dict(
            devices=[str(dev)] * 2, workers=4, identical_files=True,
            note="the per-device code on one card listed twice; not a "
                 "measurement of several cards", **fields)

        # a short album on the card and on the CPU (the plain versions)
        short = [program_signal(int(s * SAMPLE_RATE), seed=20 + k)
                 for (k, s) in enumerate(SHORT_SECONDS)]
        short_sources = []
        for (i, track) in enumerate(short):
            path = os.path.join(work, "short%d.wav" % i)
            WaveAudio.from_pcm(path, reader_from_array(track, 16))
            short_sources.append(path)
        short_sums = [ar.accuraterip_checksums(
            reader_from_array(t, 16), len(t), i == 0, i == len(short) - 1,
            device="cpu") for (i, t) in enumerate(short)]
        (on_dev, _f) = farm_run(2, [dev], "sd", short_sources, short,
                                short_sums)
        (on_cpu, _f) = farm_run(2, ["cpu"], "sc", short_sources, short,
                                short_sums)
        if on_dev != on_cpu:
            raise AssertionError("the short album's files differ between "
                                 "the card and the CPU")
        out["short_album"] = dict(seconds=list(SHORT_SECONDS),
                                  identical_to_cpu=True)

    t0 = time.perf_counter()
    dryrun.dryrun_multichip([dev, dev])
    out["dryrun"] = dict(devices=[str(dev)] * 2, ok=True)
    if on_cuda and torch.cuda.device_count() > 1:
        every = mesh.cuda_devices()
        dryrun.dryrun_multichip(every)
        out["dryrun_every_card"] = dict(devices=[str(d) for d in every],
                                        ok=True)
    out["dryrun"]["seconds"] = time.perf_counter() - t0
    out["phase5_encode_Msamples_per_s"] = enc_rate
    out["phase8_decode_Msamples_per_s"] = dec_rate
    return out


# phase 21: track2track's types and qualities, in the order run
CLI_TYPES = (("flac", "8"), ("alac", None), ("tta", None), ("shn", None),
             ("wavpack", "standard"))
# the clock ALAC's creation time is read from during phase 21 (seconds
# since 1970), so that the command line's files and from_pcm's compare
CLI_CLOCK = 1.7e9
CLI_FORMAT = ["--format", "%(basename)s.%(suffix)s"]


# kernels that the tools' default routes do not run: FLAC's default
# encode takes the quantized upload wire (no device pack) and the
# estimate Rice search (no bit-plane ladder)
OFF_CLI_PATH = ("pack_rows", "rice_planes")


def kernel_counters():
    """the nine kernel wrappers, whose ``launches`` count their launches,
    by the kernels line's names"""
    from audiotools_tpu_torch.ops import (alac_synth, bitpack, flac_frames,
                                          flac_synth, rice_decode, tta_scan,
                                          tta_synth, wv_scan)
    return {"pack_rows": bitpack.pack_rows,
            "rice_planes": flac_frames.rice_planes,
            "rice_decode": rice_decode.decode_partitions,
            "flac_synth": flac_synth.synthesize,
            "alac_synth": alac_synth.synthesize,
            "tta_synth": tta_synth.inverse_filter_predict,
            "tta_filter": tta_scan.hybrid_filter,
            "wv_corr": wv_scan.run_pass_chain,
            "wv_decorr": wv_scan.run_dec_chain}


def run_cli(tool, args):
    """a port tool's main(args) run in-process: (exit code, the lines it
    printed)"""
    module = importlib.import_module("audiotools_tpu_torch.cli." + tool)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        code = module.main(list(args))
    return (code, out.getvalue().splitlines())


def cli_phase(dev, alac_sig):
    """phase 21 on ``alac_sig``, phase 11's signal cut as phase 19 cuts
    it: the command line on ``dev``; returns its line's fields and each
    kernel's launches over the phase.  On a CPU ``dev`` (a rehearsal
    with a short signal) the card's memory is not read and no launch is
    required."""
    import tempfile
    from audiotools_tpu_torch import _native, dispatch
    from audiotools_tpu_torch.formats.flac import FlacAudio
    from audiotools_tpu_torch.formats.wav import WaveAudio
    from audiotools_tpu_torch.pcm import (PCMConverter, read_all,
                                          reader_from_array)
    dev = torch.device(dev)
    on_cuda = dev.type == "cuda"
    counters = kernel_counters()
    per = alac_sig.shape[0] // RG_TITLES
    tracks = [alac_sig[k * per:(k + 1) * per] for k in range(RG_TITLES)]
    in_samples = sum(t.size for t in tracks)
    on_card = ["--devices", str(dev)]
    total = dict.fromkeys(counters, 0)
    out = dict(tracks=len(tracks), track_seconds=per / SAMPLE_RATE,
               workers=2, types=[])
    wall_clock = time.time
    with tempfile.TemporaryDirectory(prefix="cli-") as work:
        wavs = []
        for (i, track) in enumerate(tracks):
            wavs.append(os.path.join(work, "track%d.wav" % i))
            WaveAudio.from_pcm(wavs[-1], reader_from_array(track, 16))
        sums = [_native.accuraterip_update(t, 1, 0, len(t), 0, 0)
                for t in tracks]
        time.time = lambda: CLI_CLOCK
        try:
            for (type_name, quality) in CLI_TYPES:
                cls = dispatch.TYPE_MAP[type_name]
                dest = os.path.join(work, type_name)
                outputs = [os.path.join(dest, "track%d.%s" % (i, cls.SUFFIX))
                           for i in range(len(wavs))]
                for fn in counters.values():
                    fn.launches = 0
                if on_cuda:
                    torch.cuda.reset_peak_memory_stats(dev)
                walls = {}
                t0 = time.perf_counter()
                (code, lines) = run_cli("track2track", [
                    "-t", type_name] + (["-q", quality] if quality else []) +
                    ["-d", dest, "-j", "2"] + CLI_FORMAT + on_card + wavs)
                sync(dev)
                walls["encode"] = time.perf_counter() - t0
                if code != 0 or sorted(lines) != sorted(
                        "%s -> %s" % pair for pair in zip(wavs, outputs)):
                    raise AssertionError("track2track -t %s exited %r: %s"
                                         % (type_name, code, lines))
                t0 = time.perf_counter()
                (code, lines) = run_cli("trackverify", [
                    "--accuraterip", "-j", "2"] + on_card + outputs)
                walls["verify"] = time.perf_counter() - t0
                want = ["%s : OK (AccurateRip v1=%08X v2=%08X)" % (
                    path, v1, v2) for (path, (v1, v2)) in zip(outputs, sums)]
                if code != 0 or sorted(lines[:len(want)]) != sorted(want):
                    raise AssertionError("trackverify of the %s files "
                                         "exited %r: %s"
                                         % (type_name, code, lines))
                t0 = time.perf_counter()
                (code, lines) = run_cli("trackcmp", ["-j", "2"] + on_card + [
                    path for pair in zip(wavs, outputs) for path in pair])
                walls["compare"] = time.perf_counter() - t0
                if code != 0 or sorted(lines[:len(wavs)]) != sorted(
                        "%s <> %s : OK" % pair
                        for pair in zip(wavs, outputs)):
                    raise AssertionError("trackcmp of the %s files exited "
                                         "%r: %s" % (type_name, code, lines))
                launches = {k: fn.launches for (k, fn) in counters.items()}
                peak = (torch.cuda.max_memory_allocated(dev) / 1e9
                        if on_cuda else None)
                for (k, n) in launches.items():
                    total[k] += n
                # each file is the one from_pcm writes with the frame count
                again = os.path.join(work, "again." + cls.SUFFIX)
                for (wav, output, track) in zip(wavs, outputs, tracks):
                    cls.from_pcm(again, WaveAudio(wav).to_pcm(), quality,
                                 total_pcm_frames=len(track), device=dev)
                    with open(again, "rb") as a, open(output, "rb") as b:
                        if a.read() != b.read():
                            raise AssertionError(
                                "%s differs from %s.from_pcm's file"
                                % (output, cls.__name__))
                    os.unlink(again)
                fields = dict(type=type_name, quality=quality,
                              identical_to_from_pcm=True, launches=launches,
                              peak_mem_GB=peak)
                for (tool, wall) in walls.items():
                    fields["%s_s" % tool] = wall
                    fields["%s_Msamples_per_s" % tool] = (in_samples / wall
                                                          / 1e6)
                line("cli_" + type_name, **fields)
                out["types"].append(fields)
        finally:
            time.time = wall_clock

        # the album's ReplayGain, FLAC
        dest = os.path.join(work, "replay_gain")
        t0 = time.perf_counter()
        (code, lines) = run_cli("track2track", [
            "-t", "flac", "--replay-gain", "-d", dest, "-j", "2"] +
            CLI_FORMAT + on_card + wavs)
        rg_s = time.perf_counter() - t0
        if code != 0:
            raise AssertionError("track2track --replay-gain exited %r"
                                 % (code,))
        gains = []
        peaks = [float("%1.8f" % (np.abs(t).max() / 32768)) for t in tracks]
        for (i, peak) in enumerate(peaks):
            rg = FlacAudio(os.path.join(dest, "track%d.flac" % i),
                           device=dev).replay_gain()
            if (rg is None or rg.track_peak != peak or
                    rg.album_peak != max(peaks) or
                    not np.isfinite([rg.track_gain, rg.album_gain]).all()):
                raise AssertionError("track%d's ReplayGain is %r, its peak "
                                     "%r" % (i, rg, peak))
            gains.append(rg.track_gain)
        out["replay_gain"] = dict(seconds=rg_s, track_gains_dB=gains,
                                  album_gain_dB=rg.album_gain, peaks=peaks)

        # one track resampled to 48 kHz
        dest = os.path.join(work, "resampled")
        t0 = time.perf_counter()
        (code, lines) = run_cli("track2track", [
            "-t", "flac", "--sample-rate", "48000", "-d", dest, "-j", "1"] +
            CLI_FORMAT + on_card + wavs[:1])
        sr_s = time.perf_counter() - t0
        got = FlacAudio(os.path.join(dest, "track0.flac"), device=dev)
        if code != 0 or got.sample_rate() != 48000:
            raise AssertionError("track2track --sample-rate 48000 exited "
                                 "%r" % (code,))
        got = read_all(got.to_pcm())
        want = read_all(PCMConverter(reader_from_array(tracks[0], 16), 48000,
                                     2, 0x3, 16, device="cpu"))
        if got.shape != want.shape:
            raise AssertionError("resampled track: %s frames, the CPU's %s"
                                 % (got.shape, want.shape))
        diff = np.abs(got.astype(np.int64) - want)
        if diff.max() > 1 or np.count_nonzero(diff) >= 1e-4 * diff.size:
            raise AssertionError("resampled track: %d samples off, by up "
                                 "to %d" % (np.count_nonzero(diff),
                                            diff.max()))
        out["sample_rate"] = dict(seconds=sr_s, frames=int(got.shape[0]),
                                  samples_off_by_1=int(np.count_nonzero(diff)))
    idle = [k for (k, n) in total.items()
            if n <= 0 and k not in OFF_CLI_PATH]
    if on_cuda and idle:
        raise AssertionError("the command line never launched %s" % (idle,))
    out["launches"] = total
    return (out, total)


# phase 22: the album's classes, in track order (and their qualities),
# the targets track2track writes the mixed album to, and the PNG cover
TAG_SOURCES = (("flac", "8"), ("alac", None), ("tta", None),
               ("wavpack", "standard"))
TAG_TARGETS = CLI_TYPES
# the formats that keep a WAVE's foreign chunks (their from_wave)
CHUNK_CARRIERS = ("flac", "wavpack", "shn")
# PERF.md section 2's ReplayGain bound, dB
RG_GAIN_DB = 0.011


def png_cover(width, height):
    """the bytes of a black RGB PNG of width x height pixels"""
    import struct
    import zlib

    def chunk(kind, body):
        return (struct.pack(">I", len(body)) + kind + body +
                struct.pack(">I", zlib.crc32(kind + body)))
    rows = b"".join(b"\x00" * (1 + 3 * width) for _ in range(height))
    return (b"\x89PNG\r\n\x1a\n" +
            chunk(b"IHDR", struct.pack(">IIBBBBB", width, height, 8, 2, 0,
                                       0, 0)) +
            chunk(b"IDAT", zlib.compress(rows)) + chunk(b"IEND", b""))


def album_metadata(number):
    """track ``number``'s tags: every text field with non-ASCII letters
    (a "/" in the title), numbers of 4 and 1, a front cover"""
    from audiotools_tpu_torch.audiofile import Image, MetaData
    return MetaData(
        track_name="Sóng %d/Ä" % (number,), track_number=number,
        track_total=4, album_name="Àlbum Ünïcode", artist_name="Ärtïst",
        performer_name="Pérformer", composer_name="Cömposer",
        conductor_name="Cönductor", media="CD",
        ISRC="USRC1760783%d" % (number,), catalog="Çat-001",
        copyright="© 2026 Lïbel", publisher="Püblisher", year="2026",
        date="2026-10-17", album_number=1, album_total=1,
        comment="Cömment ∞",
        images=[Image.new(png_cover(16 + number, 16), "cövér", 0)])


def riff_wave(path, samples):
    """a WAVE of 16-bit stereo ``samples`` with a LIST chunk before its
    data chunk and an odd-sized chunk (with its pad byte) after it"""
    import struct
    data = samples.astype("<i2").tobytes()
    fmt = struct.pack("<HHIIHH", 1, 2, SAMPLE_RATE, SAMPLE_RATE * 4, 4, 16)
    info = b"INFO" + b"ISFT" + struct.pack("<I", 5) + b"tpu!\x00\x00"
    chunks = (b"fmt " + struct.pack("<I", len(fmt)) + fmt +
              b"LIST" + struct.pack("<I", len(info)) + info +
              b"data" + struct.pack("<I", len(data)) + data +
              b"note" + struct.pack("<I", 5) + b"hello\x00")
    with open(path, "wb") as f:
        f.write(b"RIFF" + struct.pack("<I", 4 + len(chunks)) + b"WAVE" +
                chunks)


def read_bytes(path):
    with open(path, "rb") as f:
        return f.read()


def tags_phase(dev, alac_sig):
    """phase 22 on ``alac_sig``, phase 11's signal cut as phase 19 cuts
    it: tags and foreign chunks through the command line on ``dev``;
    returns its line's fields and each kernel's launches in the
    phase's tool runs.  The counts are set to 0 just before each run of
    a tool and read just after it, so the launches of the checks
    (from_pcm, set_metadata, the readers) are not among them.  On a CPU
    ``dev`` (a rehearsal with a short signal) the card's memory is not
    read and no launch is required."""
    import tempfile
    from audiotools_tpu_torch import dispatch
    from audiotools_tpu_torch.pcm import reader_from_array
    dev = torch.device(dev)
    on_cuda = dev.type == "cuda"
    counters = kernel_counters()
    per = alac_sig.shape[0] // RG_TITLES
    tracks = [alac_sig[k * per:(k + 1) * per] for k in range(RG_TITLES)]
    in_samples = sum(t.size for t in tracks)
    on_card = ["--devices", str(dev)]
    out = dict(tracks=len(tracks), track_seconds=per / SAMPLE_RATE,
               workers=2, types={})
    launches = dict.fromkeys(counters, 0)

    def tool(name, args):
        """run_cli(name, args) with the counts set to 0 just before it
        and added to ``launches`` just after it: (exit code, lines,
        this run's launches)"""
        for fn in counters.values():
            fn.launches = 0
        (code, lines) = run_cli(name, args)
        run = {k: fn.launches for (k, fn) in counters.items()}
        for (k, n) in run.items():
            launches[k] += n
        return (code, lines, run)

    if on_cuda:
        torch.cuda.init()
        torch.cuda.reset_peak_memory_stats(dev)
    wall_clock = time.time
    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="tags-") as work:
        time.time = lambda: CLI_CLOCK
        try:
            # 1. the album written and tagged on the card
            sources = []
            tag_s = {}
            for (i, ((type_name, quality), track)) in enumerate(
                    zip(TAG_SOURCES, tracks)):
                cls = dispatch.TYPE_MAP[type_name]
                path = os.path.join(work, "src", "track%d.%s" % (
                    i, cls.SUFFIX))
                os.makedirs(os.path.dirname(path), exist_ok=True)
                source = cls.from_pcm(path, reader_from_array(track, 16),
                                      quality, total_pcm_frames=len(track),
                                      device=dev)
                t0 = time.perf_counter()
                source.set_metadata(album_metadata(i + 1))
                tag_s[type_name] = time.perf_counter() - t0
                sources.append(source)
            out["tag_s"] = tag_s
            source_tags = [s.get_metadata() for s in sources]
            titles = [m.track_name for m in source_tags]

            # 2. the mixed album to each class, checked against
            # from_pcm followed by set_metadata
            for (type_name, quality) in TAG_TARGETS:
                cls = dispatch.TYPE_MAP[type_name]
                dest = os.path.join(work, type_name)
                outputs = [os.path.join(dest, "%02d - %s.%s" % (
                    i + 1, titles[i].replace("/", "-"), cls.SUFFIX))
                    for i in range(len(sources))]
                t0 = time.perf_counter()
                (code, lines, run) = tool("track2track", [
                    "-t", type_name] + (["-q", quality] if quality else []) +
                    ["-d", dest, "-j", "2"] + on_card +
                    [s.filename for s in sources])
                sync(dev)
                wall = time.perf_counter() - t0
                if code != 0 or sorted(lines) != sorted(
                        "%s -> %s" % (s.filename, o)
                        for (s, o) in zip(sources, outputs)):
                    raise AssertionError("track2track -t %s of the tagged "
                                         "album exited %r: %s"
                                         % (type_name, code, lines))
                set_s = 0.0
                again = os.path.join(work, "again." + cls.SUFFIX)
                for (track, output, tags) in zip(tracks, outputs,
                                                 source_tags):
                    made = cls.from_pcm(again, reader_from_array(track, 16),
                                        quality, total_pcm_frames=len(track),
                                        device=dev)
                    t0 = time.perf_counter()
                    made.set_metadata(tags)
                    set_s += time.perf_counter() - t0
                    if read_bytes(again) != read_bytes(output):
                        raise AssertionError(
                            "%s differs from %s.from_pcm's file with the "
                            "source's tags" % (output, cls.__name__))
                    os.unlink(again)
                    check_carried(dispatch.open(output, device=dev), tags)
                out["types"][type_name] = dict(
                    quality=quality, seconds=wall,
                    input_Msamples_per_s=in_samples / wall / 1e6,
                    set_metadata_album_s=set_s, launches=run)

            # 3. foreign chunks: track 1 as a WAVE with a LIST chunk
            # before its data and a chunk after it
            riff = os.path.join(work, "riff", "riff.wav")
            os.makedirs(os.path.dirname(riff))
            riff_wave(riff, tracks[0])
            t0 = time.perf_counter()
            for type_name in CHUNK_CARRIERS + ("alac",):
                cls = dispatch.TYPE_MAP[type_name]
                dest = os.path.join(work, "riff-" + type_name)
                (code, _lines, _run) = tool("track2track", [
                    "-t", type_name, "-d", dest, "-j", "1"] + CLI_FORMAT +
                    on_card + [riff])
                converted = os.path.join(dest, "riff." + cls.SUFFIX)
                if code != 0:
                    raise AssertionError("track2track -t %s of the "
                                         "foreign-chunk WAVE exited %r"
                                         % (type_name, code))
                if type_name == "alac":
                    again = os.path.join(work, "again.m4a")
                    cls.from_pcm(again, reader_from_array(tracks[0], 16),
                                 total_pcm_frames=len(tracks[0]), device=dev)
                    if read_bytes(again) != read_bytes(converted):
                        raise AssertionError("the foreign-chunk WAVE's ALAC "
                                             "file is not from_pcm's")
                    continue
                back = os.path.join(work, "back-" + type_name)
                (code, _lines, _run) = tool("track2track", [
                    "-t", "wav", "-d", back, "-j", "1"] + CLI_FORMAT +
                    on_card + [converted])
                if code != 0 or read_bytes(os.path.join(
                        back, "riff.wav")) != read_bytes(riff):
                    raise AssertionError("the foreign-chunk WAVE did not "
                                         "come back through %s" % (type_name,))
            out["foreign_chunks_s"] = time.perf_counter() - t0

            # 4. ReplayGain: WavPack's APEv2 items beside FLAC's comments
            gains = {}
            for type_name in ("flac", "wavpack"):
                dest = os.path.join(work, "rg-" + type_name)
                t0 = time.perf_counter()
                (code, _lines, _run) = tool("track2track", [
                    "-t", type_name, "--replay-gain", "-d", dest, "-j",
                    "2"] + CLI_FORMAT + on_card +
                    [s.filename for s in sources])
                if code != 0:
                    raise AssertionError("track2track -t %s --replay-gain "
                                         "exited %r" % (type_name, code))
                out["replay_gain_%s_s" % (type_name,)] = (
                    time.perf_counter() - t0)
                gains[type_name] = [dispatch.open(os.path.join(
                    dest, os.path.splitext(os.path.basename(s.filename))[0]
                    + "." + dispatch.TYPE_MAP[type_name].SUFFIX),
                    device=dev) for s in sources]
            peaks = [np.abs(t).max() / 32768 for t in tracks]
            out["replay_gain"] = []
            for (peak, flac, wv) in zip(peaks, gains["flac"],
                                        gains["wavpack"]):
                items = {key: str(wv.get_metadata()[key]) for key in (
                    "replaygain_track_gain", "replaygain_track_peak",
                    "replaygain_album_gain", "replaygain_album_peak")}
                (f_rg, w_rg) = (flac.replay_gain(), wv.replay_gain())
                if (items["replaygain_track_peak"] != "%1.6f" % (peak,) or
                        items["replaygain_album_peak"] !=
                        "%1.6f" % (max(peaks),) or
                        f_rg.track_peak != float("%1.8f" % (peak,)) or
                        f_rg.album_peak != float("%1.8f" % (max(peaks),)) or
                        abs(w_rg.track_gain - f_rg.track_gain) > RG_GAIN_DB or
                        abs(w_rg.album_gain - f_rg.album_gain) > RG_GAIN_DB):
                    raise AssertionError("%s's ReplayGain %r, FLAC's %r, "
                                         "the peak %r"
                                         % (wv.filename, items, f_rg, peak))
                out["replay_gain"].append(dict(wavpack=items, flac=vars(f_rg)))

            # 5. the read-only tools over the outputs
            listed = [os.path.join(work, t, f) for (t, _q) in TAG_TARGETS
                      for f in sorted(os.listdir(os.path.join(work, t)))]
            for flags in ([], ["-L"], ["-C"]):
                (code, lines, _run) = tool("trackinfo", flags + on_card +
                                           listed)
                text_out = "\n".join(lines)
                if code != 0 or (flags != ["-C"] and not all(
                        title in text_out for title in titles)):
                    raise AssertionError("trackinfo %s exited %r: %s"
                                         % (flags, code, lines[:8]))
            (code, lines, _run) = tool("tracklength", on_card + [
                os.path.join(work, t) for (t, _q) in TAG_TARGETS])
            want = len(TAG_TARGETS) * len(tracks) * per / SAMPLE_RATE
            if code != 0 or lines != ["%d:%02d:%02d" % (
                    int(want) // 3600, (int(want) // 60) % 60,
                    int(round(want)) % 60)]:
                raise AssertionError("tracklength exited %r: %s"
                                     % (code, lines))
        finally:
            time.time = wall_clock
    idle = [k for (k, n) in launches.items()
            if n <= 0 and k not in OFF_CLI_PATH]
    if on_cuda and idle:
        raise AssertionError("phase 22 never launched %s" % (idle,))
    out["launches"] = launches
    out["peak_mem_GB"] = (torch.cuda.max_memory_allocated(dev) / 1e9
                          if on_cuda else None)
    out["seconds"] = time.perf_counter() - t_phase
    return (out, launches)


def check_carried(output, tags):
    """``output``'s tags hold ``tags`` on every field its class holds
    (Shorten none), and each cover's bytes"""
    from audiotools_tpu_torch.audiofile import MetaData
    got = output.get_metadata()
    if output.NAME == "shn":
        if got is not None:
            raise AssertionError("%s holds tags" % (output.filename,))
        return
    # the fields the class holds: those a full MetaData keeps through it
    held = type(got).converted(MetaData(**{
        f: (1 if f in MetaData.INTEGER_FIELDS else "x")
        for f in MetaData.FIELDS}))
    for field in MetaData.FIELDS:
        want = getattr(tags, field) if getattr(held, field) else None
        if getattr(got, field) != want:
            raise AssertionError("%s: %s is %r, the source's %r"
                                 % (output.filename, field,
                                    getattr(got, field), want))
    if [i.data for i in got.images()] != [i.data for i in tags.images()]:
        raise AssertionError("%s's cover is not the source's"
                             % (output.filename,))


class CaptureFirst:
    """stands in for a kernel wrapper ``fn`` (a module attribute) and
    keeps a copy of the tensor arguments of its first call; its
    ``launches`` is ``fn``'s, so the wrapper's own count, which names
    the module attribute, still lands on ``fn``"""

    def __init__(self, fn):
        self.fn = fn
        self.first = None

    launches = property(lambda self: self.fn.launches,
                        lambda self, value: setattr(self.fn, "launches",
                                                    value))

    def __call__(self, *args):
        if self.first is None:
            self.first = tuple(a.clone() if isinstance(a, torch.Tensor)
                               else a for a in args)
        return self.fn(*args)


def default_route_phase(dev, sig, pack_runs, alac_runs):
    """phase 23: the FLAC encode's default route, the quantized upload
    wire, at bench shape on ``sig`` (phase 5's signal), three runs each
    decoded bit for bit, beside phase 5's device-pack runs
    (``pack_runs``) and phase 11's ALAC encodes (``alac_runs``, whose
    default route is the ALAC wire); the card's default-route bytes
    against the CPU's on a short slice; one bench batch with
    ATPU_DEVICE_RICE=exact, rice_planes counted from 0 across it, then
    held against its plain version on the residuals of that run; and a
    two-slice encode over [dev, dev] against one device.  Returns (its
    line's fields, the kernels line's rice_planes row and launches).
    On a CPU ``dev`` (a rehearsal with a short signal, ``median_ms``
    and ``device_ms`` replaced by host timers) the card's memory is not
    read and no launch is required."""
    from audiotools_tpu_torch.codecs import flac_enc_fast as port_enc
    from audiotools_tpu_torch.ops import flac_frames
    from audiotools_tpu_torch.pcm import decode_flac, reader_from_array
    dev = torch.device(dev)
    on_cuda = dev.type == "cuda"
    opts = OPTS
    (n, frames) = (opts["block_size"], opts["batch_frames"])
    counted = ("wire_batches", "patched_batches", "floor_frames",
               "overflow_batches")
    out = dict(audio_seconds=sig.shape[0] / SAMPLE_RATE,
               batch_frames=frames)

    # ---- the default route's throughput --------------------------------
    runs = []
    for _ in range(THROUGHPUT_RUNS):
        counts0 = [getattr(port_enc, c) for c in counted]
        timings = {}
        buf = io.BytesIO()
        if on_cuda:
            torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        port_enc.encode_flac_fast(buf, reader_from_array(sig, 16),
                                  device=dev, timings=timings, **opts)
        sync(dev)
        wall = time.perf_counter() - t0
        data = buf.getvalue()
        if not np.array_equal(decode_flac(data), sig):
            raise AssertionError("default-route encode does not decode "
                                 "bit-exactly")
        run = dict(wall_s=wall, Msamples_per_s=sig.size / wall / 1e6,
                   ratio=len(data) / (sig.size * 2), bytes=len(data),
                   stage_s=timings,
                   peak_mem_GB=(torch.cuda.max_memory_allocated(dev) / 1e9
                                if on_cuda else None))
        for (c, c0) in zip(counted, counts0):
            run[c] = getattr(port_enc, c) - c0
        if run["wire_batches"] <= 0:
            raise AssertionError("the default route never took the wire")
        runs.append(run)
        del buf, data
    rates = [r["Msamples_per_s"] for r in runs]
    pack_rates = [r["Msamples_per_s"] for r in pack_runs]
    alac_rates = [r["Msamples_per_s"] for r in alac_runs]
    out.update(Msamples_per_s=float(np.median(rates)),
               Msamples_per_s_runs=rates, bit_exact=True,
               pack_route_Msamples_per_s=float(np.median(pack_rates)),
               pack_route_ratio=pack_runs[0]["ratio"],
               alac_Msamples_per_s=float(np.median(alac_rates)),
               alac_wire_batches=alac_runs[0]["wire_batches"],
               alac_floor_groups=alac_runs[0]["floor_groups"],
               alac_stage_s=alac_runs[0]["stage_s"], runs=runs)

    # ---- the card's default-route bytes against the CPU's -------------
    short = sig[:n * 8 + 1000]
    small = dict(opts, batch_frames=4)
    outs = []
    for device in ("cpu", dev):
        buf = io.BytesIO()
        port_enc.encode_flac_fast(buf, reader_from_array(short, 16),
                                  device=device, **small)
        outs.append(buf.getvalue())
    if outs[1] != outs[0]:
        raise AssertionError("card default-route bytes differ from the "
                             "CPU's")
    out["slice"] = dict(frames=int(short.shape[0]), bytes=len(outs[0]),
                        identical_to_cpu=True)

    # ---- one encode split over two devices -----------------------------
    batch_sig = sig[:n * frames + 1000]
    outs = []
    for devices in (None, [dev, dev]):
        buf = io.BytesIO()
        t0 = time.perf_counter()
        port_enc.encode_flac_fast(buf, reader_from_array(batch_sig, 16),
                                  device=dev, devices=devices, **opts)
        sync(dev)
        outs.append((buf.getvalue(), time.perf_counter() - t0))
    if outs[1][0] != outs[0][0]:
        raise AssertionError("the two-slice encode's bytes differ from "
                             "one device's")
    out["two_slices"] = dict(devices=[str(dev)] * 2, identical=True,
                             one_device_s=outs[0][1],
                             two_slices_s=outs[1][1])

    # ---- the exact Rice ladder on one bench batch ----------------------
    kernel = flac_frames.rice_planes
    capture = CaptureFirst(kernel)
    batch_sig = sig[:n * frames]
    os.environ["ATPU_DEVICE_RICE"] = "exact"
    flac_frames.rice_planes = capture
    try:
        buf = io.BytesIO()
        kernel.launches = 0
        t0 = time.perf_counter()
        port_enc.encode_flac_fast(buf, reader_from_array(batch_sig, 16),
                                  device=dev, **opts)
        sync(dev)
        exact_s = time.perf_counter() - t0
        launches = kernel.launches
    finally:
        flac_frames.rice_planes = kernel
        del os.environ["ATPU_DEVICE_RICE"]
    data = buf.getvalue()
    if on_cuda and launches <= 0:
        raise AssertionError("the exact Rice search never launched "
                             "rice_planes")
    if not np.array_equal(decode_flac(data), batch_sig):
        raise AssertionError("the exact-search encode does not decode "
                             "bit-exactly")
    (res, parts, j0) = capture.first
    del capture
    got = kernel(res, parts, j0)
    want = flac_frames.rice_planes_plain(res, parts, j0)
    sync(dev)
    err = int((got.to(torch.int64) - want.to(torch.int64)).abs().max())
    if not torch.equal(got, want):
        raise AssertionError("rice_planes kernel != plain version (max abs "
                             "err %d)" % (err,))
    del got, want
    ms = median_ms(lambda: kernel(res, parts, j0))
    card_ms = device_ms(lambda: kernel(res, parts, j0))
    plain_ms = median_ms(lambda: flac_frames.rice_planes_plain(
        res, parts, j0), PLAIN_SYNTH_RUNS)
    (S, C, nn) = res.shape
    # residuals read once, counts written once; the zigzag, a bit test
    # and an add a plane, the seed's shift and add: 2 * j0 + 4 integer
    # operations a residual
    (b_ms, b_by) = bound(S * C * nn * 4 + S * C * parts * (j0 + 1) * 4,
                         S * C * nn * (2 * j0 + 4))
    row = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
               bound_by=b_by, library_ms=None)
    out["exact_rice"] = dict(frames=int(batch_sig.shape[0]),
                             bytes=len(data), bit_exact=True,
                             encode_s=exact_s, launches=launches,
                             shape=[S, C, nn, parts, j0 + 1],
                             device_ms=card_ms, equal=True, **row)
    del res
    return (out, row, launches)


def main():
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: torch.cuda.is_available() is False; this "
                 "script needs one CUDA card")
    sys.path.insert(0, ROOT)
    from audiotools_tpu_torch import _native, kernels
    from audiotools_tpu_torch.codecs import alac_dec, alac_fast, flac_dec, tta
    from audiotools_tpu_torch.codecs import flac_enc_fast as port_enc
    from audiotools_tpu_torch.codecs import shn
    from audiotools_tpu_torch.formats import m4a
    from audiotools_tpu_torch.formats import shn as shn_format
    from audiotools_tpu_torch.formats import tta as tta_format
    from audiotools_tpu_torch.pcm import (decode_flac, reader_from_array,
                                          streaminfo)
    from audiotools_tpu_torch.ops import alac_synth, tta_scan, tta_synth
    from audiotools_tpu_torch.ops import bitpack, flac_frames, flac_synth
    from audiotools_tpu_torch.ops import lpc as lpc_ops
    from audiotools_tpu_torch.ops import rice_decode
    from audiotools_tpu_torch.ref.alac import read_m4a_header

    dev = torch.device("cuda", 0)

    # ---- 1. device -----------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)
    clocks = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm",
         "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True).stdout.strip()
    (sm_mhz, max_sm_mhz) = (int(v) for v in
                            clocks.splitlines()[0].split(","))
    name = torch.cuda.get_device_name(0)
    line("device", name=name, nvidia_smi=smi,
         count=torch.cuda.device_count(), torch=torch.__version__,
         cuda=torch.version.cuda,
         clocks={"sm": sm_mhz, "max.sm": max_sm_mhz})

    # ---- 2. build ------------------------------------------------------
    t0 = time.perf_counter()
    # tools_dev/int_op_cycles.py's instruction timings, compiled beside
    # the kernels: phases 14 and 17 read the TTA and WavPack step chains
    # from them
    from tools_dev import int_op_cycles
    cycles_build = int_op_cycles.start_build(kernels)
    kernels.load()
    cycles_lib = int_op_cycles.finish_build(cycles_build)
    line("build", seconds=time.perf_counter() - t0,
         library=os.path.relpath(kernels.library_path(), ROOT),
         ptxas=ptxas_summary(kernels.build_log))

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
    rows = bitpack.chosen_rows(chosen, n, P)
    n_words = bitpack.residual_words_capacity(n, 17, P)
    del chosen, _packed
    got = bitpack.pack_rows(*rows, n_words, 17)
    want = bitpack.pack_rows_plain(*rows, n_words, 17)
    torch.cuda.synchronize()
    err = max(int((g.to(torch.int64) - w.to(torch.int64)).abs().max())
              for (g, w) in zip(got, want))
    if not all(torch.equal(g, w) for (g, w) in zip(got, want)):
        raise AssertionError("pack_rows kernel != plain version (max abs "
                             "err %d)" % (err,))
    # interleaved plain, kernel, kernel, plain
    plain_ms = [median_ms(lambda: bitpack.pack_rows_plain(
        *rows, n_words, 17))]
    kernel_ms = [median_ms(lambda: bitpack.pack_rows(*rows, n_words, 17))
                 for _ in range(2)]
    plain_ms.append(median_ms(lambda: bitpack.pack_rows_plain(
        *rows, n_words, 17)))
    ms = float(np.median(kernel_ms))
    pms = float(np.median(plain_ms))
    pack_dev = device_ms(lambda: bitpack.pack_rows(*rows, n_words, 17))
    # one library call for the reference kernel's own part, the scatter:
    # the payload bits are disjoint, so adding the rows' word
    # contributions equals or-ing them (those past the words masked)
    (idx, val, _total, _coded) = bitpack.contributions(*rows, n_words)
    inside = idx < n_words
    idx64 = torch.where(inside, idx, 0).to(torch.int64)
    val_in = torch.where(inside, val, 0)
    scatter_add = (lambda: torch.zeros_like(want[0]).scatter_add_(
        1, idx64, val_in))
    if not torch.equal(scatter_add(), want[0]):
        raise AssertionError("scatter_add_ != the plain pack's words")
    lib_ms = median_ms(scatter_add)
    S = int(rows[0].shape[0])
    # residuals, parameters and the three per-row fields read once; words,
    # bits and ok flags written once; ~20 integer operations a code
    (pk_bound, pk_bound_by) = bound(
        S * n * 4 + S * P * 4 + 3 * S * 4 + S * n_words * 4 + S * 4 + S,
        20 * S * n)
    line("kernel_vs_plain", kernel="pack_rows", shape=[S, n, P, n_words],
         equal=True, max_abs_err=err, ms=ms, device_ms=pack_dev,
         plain_ms=pms, ms_runs=kernel_ms, plain_ms_runs=plain_ms,
         library_ms=lib_ms, contributions=int(idx.shape[1]),
         bound_ms=pk_bound)
    pack_row = dict(max_abs_err=err, ms=ms, plain_ms=pms,
                    bound_ms=pk_bound, bound_by=pk_bound_by,
                    library_ms=lib_ms)
    del rows, idx, idx64, val, val_in, inside, got, want, blocks

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
    route_bytes = {}
    bitpack.pack_rows.launches = 0
    # each route (None: the default, the quantized upload wire) on the
    # card against the same route's plain versions on the CPU
    for pack in (None, True, False):
        outs = []
        for device in ("cpu", "cuda"):
            buf = io.BytesIO()
            port_enc.encode_flac_fast(buf, reader_from_array(arr, 16),
                                      device=device, pack=pack, **small)
            outs.append(buf.getvalue())
        if outs[1] != outs[0]:
            raise AssertionError("card encode (pack=%s) bytes differ from "
                                 "the plain versions' on the CPU" % (pack,))
        if not np.array_equal(decode_flac(outs[0]), arr):
            raise AssertionError("slice encode (pack=%s) does not decode "
                                 "bit-exactly" % (pack,))
        route_bytes[str(pack)] = len(outs[0])
    plain = outs[0]
    slice_launches = bitpack.pack_rows.launches
    if slice_launches <= 0:
        raise AssertionError("slice encode never launched pack_rows")
    line("slice_identity", frames=m, bytes=route_bytes, identical=True,
         bit_exact=True, pack_rows_launches=slice_launches)

    # ---- 5. bench-shaped throughput on the main path -------------------
    one_batch = io.BytesIO()
    port_enc.encode_flac_fast(
        one_batch, reader_from_array(program_signal(n * frames), 16),
        device="cuda", pack=True, **opts)
    one_batch = one_batch.getvalue()
    sig = program_signal(n * frames * THROUGHPUT_BATCHES)
    n_frames = sig.shape[0]
    runs = []
    for _ in range(THROUGHPUT_RUNS):
        reader = reader_from_array(sig, 16)
        fallback0 = port_enc.fallback_batches
        timings = {}
        out = io.BytesIO()
        torch.cuda.reset_peak_memory_stats(dev)
        bitpack.pack_rows.launches = 0
        t0 = time.perf_counter()
        port_enc.encode_flac_fast(out, reader, device="cuda", pack=True,
                                  timings=timings, **opts)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = bitpack.pack_rows.launches
        data = out.getvalue()
        if launches <= 0:
            raise AssertionError("main path never launched pack_rows")
        if not np.array_equal(decode_flac(data), sig):
            raise AssertionError("bench-shaped encode does not decode "
                                 "bit-exactly")
        bench_stream = data
        runs.append(dict(
            wall_s=wall, Msamples_per_s=n_frames * 2 / wall / 1e6,
            ratio=len(data) / (sig.size * 2), stage_s=timings,
            pack_s=timings["pack"],
            fallback_batches=port_enc.fallback_batches - fallback0,
            peak_mem_GB=torch.cuda.max_memory_allocated(dev) / 1e9,
            pack_rows_launches=launches))
        del out
    rates = [r["Msamples_per_s"] for r in runs]
    rate = float(np.median(rates))
    launches = runs[0]["pack_rows_launches"]
    line("throughput", audio_seconds=n_frames / SAMPLE_RATE,
         batches=THROUGHPUT_BATCHES, batch_frames=frames,
         Msamples_per_s=rate, Msamples_per_s_runs=rates,
         realtime=rate * 1e6 / 2 / SAMPLE_RATE, bit_exact=True,
         runs=runs)

    # ---- 6. decode kernels vs plain at the main path's shapes ----------
    frame_bytes = one_batch[streaminfo(one_batch)[4]:]
    scan = _native.flac_scan(
        frame_bytes, 16, 2, max_samples=frames * n, max_frames=frames,
        max_parts=flac_dec.MAX_PARTS, chunk_codes=flac_dec.CHUNK_CODES)
    if scan["frame_meta"].shape[0] != frames:
        raise AssertionError("scan found %d of %d frames"
                             % (scan["frame_meta"].shape[0], frames))
    batch = flac_dec.HostBatch(scan, frame_bytes, 2, 16)
    # the words each bucket's records span (HostBatch's bucket rule)
    part_meta = scan["part_meta"]
    w_need = ((part_meta[:, 5] & 31) + part_meta[:, 6] + 31) >> 5
    assigned = np.zeros(len(part_meta), dtype=bool)
    span_words = []
    for (W, C) in flac_dec.BUCKETS:
        sel = (~assigned) & (w_need <= W) & (part_meta[:, 2] <= C)
        assigned |= sel
        if sel.any():
            span_words.append(int(w_need[sel].sum()))
    tensors = flac_dec.upload_batch(batch, dev)
    torch.cuda.synchronize()
    rice_rows = []
    vals = []
    for (b, (W, C)) in enumerate(batch.buckets):
        args = ([tensors["words"]] + list(tensors["bucket%d" % b][:5])
                + [W, C])
        got = rice_decode.decode_partitions(*args)
        want = rice_decode.decode_partitions_plain(*args)
        torch.cuda.synchronize()
        b_err = int((got.to(torch.int64) - want.to(torch.int64))
                    .abs().max())
        if not torch.equal(got, want):
            raise AssertionError("rice_decode kernel != plain version in "
                                 "bucket (%d, %d) (max abs err %d)"
                                 % (W, C, b_err))
        P = int(got.shape[0])
        codes = int(np.minimum(batch.arrays["bucket%d" % b][4], C).sum())
        # inputs read once (the records' word spans, five int32 fields
        # a record), the [P, C] output written once; ~30 integer
        # operations a code
        (b_bound, b_bound_by) = bound(
            span_words[b] * 4 + P * 5 * 4 + P * C * 4, 30 * codes)
        b_ms = median_ms(lambda: rice_decode.decode_partitions(*args))
        b_dev = device_ms(lambda: rice_decode.decode_partitions(*args))
        rice_rows.append(dict(
            bucket=[W, C], records=P, codes=codes, max_abs_err=b_err,
            ms=b_ms, device_ms=b_dev,
            ns_per_code=b_ms * 1e6 / max(codes, 1),
            plain_ms=median_ms(
                lambda: rice_decode.decode_partitions_plain(*args), 3),
            bound_ms=b_bound, bound_by=b_bound_by))
        vals.append(got)
        del want
    line("kernel_vs_plain", kernel="rice_decode", frames=frames,
         buckets=rice_rows, equal=True,
         device_ms=sum(r["device_ms"] for r in rice_rows))
    rice_row = dict(
        max_abs_err=max(r["max_abs_err"] for r in rice_rows),
        ms=sum(r["ms"] for r in rice_rows),
        plain_ms=sum(r["plain_ms"] for r in rice_rows),
        bound_ms=sum(r["bound_ms"] for r in rice_rows),
        bound_by="bytes" if all(r["bound_by"] == "bytes"
                                for r in rice_rows) else "operations",
        library_ms=None)

    planes = flac_dec.assemble_residuals(batch, tensors, vals)
    synth_args = [planes.contiguous(), tensors["warmup"], tensors["qlp"],
                  tensors["sub"][0], tensors["sub"][1]]

    def synth():
        return flac_synth.synthesize(*synth_args, taps=batch.taps)

    got = synth()
    want = flac_synth.synthesize_plain(*synth_args)
    torch.cuda.synchronize()
    s_err = int((got.to(torch.int64) - want.to(torch.int64)).abs().max())
    if not torch.equal(got, want):
        raise AssertionError("flac_synth kernel != plain version (max abs "
                             "err %d)" % (s_err,))
    (S, nn) = planes.shape
    Kw = int(tensors["qlp"].shape[1])
    # residuals read and samples written once, warmup/qlp/shift/order
    # read once; a multiply and an add per nonzero coefficient column
    # (taps) a sample
    (s_bound, s_bound_by) = bound(
        2 * S * nn * 4 + 2 * S * Kw * 4 + 2 * S * 4,
        2 * S * nn * batch.taps)
    s_ms = median_ms(synth)
    synth_row = dict(
        max_abs_err=s_err, ms=s_ms,
        plain_ms=median_ms(lambda: flac_synth.synthesize_plain(*synth_args),
                           PLAIN_SYNTH_RUNS),
        bound_ms=s_bound, bound_by=s_bound_by, library_ms=None)
    line("kernel_vs_plain", kernel="flac_synth", shape=[S, nn, Kw],
         taps=batch.taps, equal=True, device_ms=device_ms(synth),
         ns_per_step=s_ms * 1e6 / nn,
         cycles_per_step_at_max_sm=s_ms * 1e3 * max_sm_mhz / nn,
         **synth_row)
    del batch, tensors, vals, planes, synth_args, got, want

    # ---- 7. decode identity --------------------------------------------
    rice_decode.decode_partitions.launches = 0
    flac_synth.synthesize.launches = 0
    on_card = flac_dec.decode_flac(plain, device="cuda")
    id_launches = (rice_decode.decode_partitions.launches,
                   flac_synth.synthesize.launches)
    if min(id_launches) <= 0:
        raise AssertionError("card decode never launched its kernels")
    if not np.array_equal(on_card, arr):
        raise AssertionError("card decode differs from the input")
    if not np.array_equal(on_card, flac_dec.decode_flac(plain,
                                                        device="cpu")):
        raise AssertionError("card decode differs from the plain versions' "
                             "on the CPU")
    line("decode_identity", frames=int(arr.shape[0]), bit_exact=True,
         md5_checked=True, rice_decode_launches=id_launches[0],
         flac_synth_launches=id_launches[1])

    # ---- 8. bench-shaped decode throughput on the main path ------------
    dec_runs = []
    for _ in range(THROUGHPUT_RUNS):
        host0 = flac_dec.host_chunks
        rice_decode.decode_partitions.launches = 0
        flac_synth.synthesize.launches = 0
        t0 = time.perf_counter()
        dec = flac_dec.TorchFlacDecoder(io.BytesIO(bench_stream),
                                        device="cuda")
        pieces = []
        while True:
            framelist = dec.read(frames * n)
            if framelist.frames == 0:
                break
            pieces.append(framelist.samples)
        wall = time.perf_counter() - t0
        dec_launches = (rice_decode.decode_partitions.launches,
                        flac_synth.synthesize.launches)
        if min(dec_launches) <= 0:
            raise AssertionError("main decode path never launched its "
                                 "kernels")
        if flac_dec.host_chunks != host0:
            raise AssertionError("main decode path sent %d chunks to the "
                                 "host decoder"
                                 % (flac_dec.host_chunks - host0))
        if not np.array_equal(np.concatenate(pieces), sig):
            raise AssertionError("bench-shaped decode is not bit-exact")
        dec_runs.append(dict(
            wall_s=wall, Msamples_per_s=n_frames * 2 / wall / 1e6,
            stage_s=dict(dec.timings), host_chunks=0,
            rice_decode_launches=dec_launches[0],
            flac_synth_launches=dec_launches[1]))
        del dec, pieces
    dec_rates = [r["Msamples_per_s"] for r in dec_runs]
    dec_rate = float(np.median(dec_rates))
    line("decode_throughput", audio_seconds=n_frames / SAMPLE_RATE,
         batch_frames=flac_dec.MAX_BATCH_FRAMES, Msamples_per_s=dec_rate,
         Msamples_per_s_runs=dec_rates,
         realtime=dec_rate * 1e6 / 2 / SAMPLE_RATE, bit_exact=True,
         md5_checked=True, runs=dec_runs)

    # ---- 9. ALAC kernel vs plain at the main path's shapes -------------
    alac_sig = program_signal(n * frames * ALAC_BATCHES)
    one_alac = io.BytesIO()
    m4a.write_m4a(one_alac, reader_from_array(alac_sig[:n * frames], 16),
                  device="cuda")
    one_alac = one_alac.getvalue()
    header = read_m4a_header(io.BytesIO(one_alac))
    scan = _native.alac_scan(
        one_alac[header["mdat_offset"]:], 16, 2, n,
        header["initial_history"], header["history_multiplier"],
        header["maximum_k"], n * frames, frames * 2 + 2)
    if scan["fs_count"].shape[0] != frames:
        raise AssertionError("ALAC scan found %d of %d framesets"
                             % (scan["fs_count"].shape[0], frames))
    sub_meta = scan["sub_meta"]
    tensors = flac_dec.upload_arrays(alac_dec.prepare_batch(scan, 2), dev)
    a_args = (tensors["residuals"], tensors["qlp"]) + tuple(
        tensors["sub"][:3])
    a_rows = tensors["rows"]
    got = alac_synth.synthesize(*a_args, rows=a_rows)
    walk = {}
    (start, stop) = (torch.cuda.Event(enable_timing=True),
                     torch.cuda.Event(enable_timing=True))
    start.record()
    want = alac_synth.synthesize_plain(*a_args, stats=walk)
    stop.record()
    stop.synchronize()
    a_plain_ms = start.elapsed_time(stop)
    a_err = int((got.to(torch.int64) - want.to(torch.int64)).abs().max())
    if not torch.equal(got, want):
        raise AssertionError("alac_synth kernel != plain version (max abs "
                             "err %d)" % (a_err,))
    (S_a, n_a) = got.shape
    orders = sub_meta[:, 2].astype(np.int64)
    raw = sub_meta[:, 6] != 0
    ord_eff = np.where(orders >= 31, n_a, orders)
    chain = np.where(raw, 0, np.minimum(ord_eff, n_a - 1))
    main = np.where(raw | (orders >= 31), 0,
                    np.maximum(n_a - 1 - ord_eff, 0))
    # a difference-chain sample: an add and the truncation (4
    # operations); a predicted sample: a subtract, a multiply and an
    # add per coefficient and 8 for the rounding, shift, adds and
    # truncation; a step of the adaptation walk: 8
    a_ops = int(4 * chain.sum() + ((3 * orders + 8) * main).sum()
                + 8 * walk["walk_steps"])
    # residuals read and samples written once, qlp and the three
    # per-row parameters read once
    (a_bound, a_bound_by) = bound(
        2 * S_a * n_a * 4 + S_a * (tensors["qlp"].shape[1] + 3) * 4, a_ops)
    a_ms = median_ms(lambda: alac_synth.synthesize(*a_args, rows=a_rows))
    a_dev = device_ms(lambda: alac_synth.synthesize(*a_args, rows=a_rows))
    alac_row = dict(
        max_abs_err=a_err, ms=a_ms, plain_ms=a_plain_ms, bound_ms=a_bound,
        bound_by=a_bound_by, library_ms=None)
    line("kernel_vs_plain", kernel="alac_synth", shape=[S_a, n_a],
         orders=sorted(set(orders.tolist())), walk_steps=walk["walk_steps"],
         operations=a_ops, equal=True, device_ms=a_dev,
         ns_per_step=a_ms * 1e6 / n_a,
         cycles_per_step_at_max_sm=a_ms * 1e3 * max_sm_mhz / n_a,
         **alac_row)
    del scan, tensors, a_args, a_rows, got, want

    # ---- 10. ALAC identity ---------------------------------------------
    mdats = []
    for device in ("cpu", "cuda"):
        out = io.BytesIO()
        sizes = alac_fast.encode_mdat_fast(out, reader_from_array(arr, 16),
                                           device=device, batch_frames=8)
        mdats.append((out.getvalue(), sizes))
    if mdats[0] != mdats[1]:
        raise AssertionError("card ALAC mdat differs from the plain "
                             "versions' on the CPU")
    files = []
    for device in ("cpu", "cuda"):
        out = io.BytesIO()
        m4a.write_m4a(out, reader_from_array(arr, 16), device=device,
                      create_date=CREATE_DATE)
        files.append(out.getvalue())
    if files[0] != files[1]:
        raise AssertionError("card M4A file differs from the plain "
                             "versions' on the CPU")
    host0 = alac_dec.host_chunks
    alac_synth.synthesize.launches = 0
    on_card = alac_dec.decode_alac(files[1], device="cuda")
    a_id_launches = alac_synth.synthesize.launches
    if a_id_launches <= 0:
        raise AssertionError("card ALAC decode never launched alac_synth")
    if alac_dec.host_chunks != host0:
        raise AssertionError("card ALAC decode took the host route")
    if not np.array_equal(on_card, arr):
        raise AssertionError("card ALAC decode differs from the input")
    if not np.array_equal(on_card, alac_dec.decode_alac(files[1],
                                                        device="cpu")):
        raise AssertionError("card ALAC decode differs from the plain "
                             "versions' on the CPU")
    line("alac_identity", frames=int(arr.shape[0]),
         mdat_bytes=len(mdats[0][0]), file_bytes=len(files[0]),
         identical=True, bit_exact=True, alac_synth_launches=a_id_launches,
         host_chunks=0)

    # ---- 11. ALAC throughput on the main path --------------------------
    a_frames = alac_sig.shape[0]
    alac_enc_runs = []
    alac_dec_runs = []
    for _ in range(THROUGHPUT_RUNS):
        timings = {}
        out = io.BytesIO()
        torch.cuda.reset_peak_memory_stats(dev)
        counts0 = (alac_fast.wire_batches, alac_fast.floor_groups)
        t0 = time.perf_counter()
        m4a.write_m4a(out, reader_from_array(alac_sig, 16), device="cuda",
                      timings=timings)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        data = out.getvalue()
        alac_enc_runs.append(dict(
            wall_s=wall, Msamples_per_s=a_frames * 2 / wall / 1e6,
            ratio=len(data) / (alac_sig.size * 2), stage_s=timings,
            wire_batches=alac_fast.wire_batches - counts0[0],
            floor_groups=alac_fast.floor_groups - counts0[1],
            peak_mem_GB=torch.cuda.max_memory_allocated(dev) / 1e9))
        host0 = alac_dec.host_chunks
        alac_synth.synthesize.launches = 0
        t0 = time.perf_counter()
        dec = alac_dec.TorchALACDecoder(io.BytesIO(data), device="cuda")
        pieces = []
        while True:
            framelist = dec.read(frames * n)
            if framelist.frames == 0:
                break
            pieces.append(framelist.samples)
        wall = time.perf_counter() - t0
        a_launches = alac_synth.synthesize.launches
        if a_launches <= 0:
            raise AssertionError("main ALAC decode never launched "
                                 "alac_synth")
        if alac_dec.host_chunks != host0:
            raise AssertionError("main ALAC decode sent %d batches to the "
                                 "host decoder"
                                 % (alac_dec.host_chunks - host0))
        if not np.array_equal(np.concatenate(pieces), alac_sig):
            raise AssertionError("ALAC encode/decode is not bit-exact")
        alac_dec_runs.append(dict(
            wall_s=wall, Msamples_per_s=a_frames * 2 / wall / 1e6,
            stage_s=dict(dec.timings), host_chunks=0,
            alac_synth_launches=a_launches))
        del dec, pieces
    enc_rates = [r["Msamples_per_s"] for r in alac_enc_runs]
    dec_rates = [r["Msamples_per_s"] for r in alac_dec_runs]
    line("alac_throughput", audio_seconds=a_frames / SAMPLE_RATE,
         batches=ALAC_BATCHES, batch_framesets=alac_fast.BATCH_FRAMES,
         encode_Msamples_per_s=float(np.median(enc_rates)),
         encode_Msamples_per_s_runs=enc_rates,
         decode_Msamples_per_s=float(np.median(dec_rates)),
         decode_Msamples_per_s_runs=dec_rates, bit_exact=True,
         encode_runs=alac_enc_runs, decode_runs=alac_dec_runs)

    # ---- 12. TTA kernel vs plain on one decode group -------------------
    t0 = time.perf_counter()
    tta_file = io.BytesIO()
    tta_format.write_tta(tta_file, reader_from_array(alac_sig, 16),
                         device="cuda")
    tta_encode_s = time.perf_counter() - t0
    tta_bytes = tta_file.getvalue()
    dec = tta.TorchTTADecoder(io.BytesIO(tta_bytes), device="cuda")
    (planes, _total) = dec.scan_group(0)
    dec.close()
    (F_t, n_t, ch_t) = planes.shape
    lanes = torch.as_tensor(planes, device=dev).permute(0, 2, 1).reshape(
        F_t * ch_t, n_t).contiguous()
    got = tta_synth.inverse_filter_predict(lanes, 16)
    start.record()
    want = tta_synth.inverse_filter_predict_plain(lanes, 16)
    stop.record()
    stop.synchronize()
    t_plain_ms = start.elapsed_time(stop)
    t_err = int((got.to(torch.int64) - want.to(torch.int64)).abs().max())
    if not torch.equal(got, want):
        raise AssertionError("tta_synth kernel != plain version (max abs "
                             "err %d)" % (t_err,))
    (L_t, _) = lanes.shape
    # residuals read and samples written once; a sample takes 46
    # integer operations (qm update and dot product 32, the prediction
    # 3, the state rotation 7, the fixed predictor 4)
    (t_bound, t_bound_by) = bound(2 * L_t * n_t * 4, 46 * L_t * n_t)
    tta_row = dict(
        max_abs_err=t_err,
        ms=median_ms(lambda: tta_synth.inverse_filter_predict(lanes, 16)),
        plain_ms=t_plain_ms, bound_ms=t_bound, bound_by=t_bound_by,
        library_ms=None)
    t_dev = device_ms(lambda: tta_synth.inverse_filter_predict(lanes, 16))
    line("kernel_vs_plain", kernel="tta_synth", shape=[L_t, n_t],
         frames=F_t, equal=True, device_ms=t_dev,
         ns_per_step=tta_row["ms"] * 1e6 / n_t,
         cycles_per_step_at_max_sm=tta_row["ms"] * 1e3 * max_sm_mhz / n_t,
         **tta_row)
    del planes, lanes, got, want

    # ---- 13. TTA identity and throughput -------------------------------
    short = program_signal(2 * n_t + 5000, seed=11)
    encoded = []
    for known in (None, short.shape[0]):
        out = io.BytesIO()
        tta_format.write_tta(out, reader_from_array(short, 16),
                             total_pcm_frames=known, device="cuda")
        encoded.append(out.getvalue())
    if encoded[0] != encoded[1]:
        raise AssertionError("TTA files differ with and without the length "
                             "known up front")
    host = tta.FastTTADecoder(io.BytesIO(encoded[0]))
    host_pcm = np.concatenate([host.read(n_t).samples for _ in range(3)])
    host.close()
    if not np.array_equal(host_pcm, short):
        raise AssertionError("TTA host decode differs from the input")
    tta_synth.inverse_filter_predict.launches = 0
    on_card = tta.decode_tta(encoded[0], device="cuda")
    t_id_launches = tta_synth.inverse_filter_predict.launches
    if t_id_launches <= 0:
        raise AssertionError("card TTA decode never launched tta_synth")
    if not np.array_equal(on_card, short):
        raise AssertionError("card TTA decode differs from the input")
    if not np.array_equal(on_card, tta.decode_tta(encoded[0], device="cpu")):
        raise AssertionError("card TTA decode differs from the plain "
                             "versions' on the CPU")
    tta_runs = []
    for _ in range(THROUGHPUT_RUNS):
        tta_synth.inverse_filter_predict.launches = 0
        t0 = time.perf_counter()
        dec = tta.TorchTTADecoder(io.BytesIO(tta_bytes), device="cuda")
        pieces = []
        while True:
            framelist = dec.read(tta.DEC_GROUP_FRAMES * n_t)
            if framelist.frames == 0:
                break
            pieces.append(framelist.samples)
        wall = time.perf_counter() - t0
        t_launches = tta_synth.inverse_filter_predict.launches
        if t_launches <= 0:
            raise AssertionError("main TTA decode never launched tta_synth")
        if not np.array_equal(np.concatenate(pieces), alac_sig):
            raise AssertionError("TTA decode is not bit-exact")
        tta_runs.append(dict(
            wall_s=wall, Msamples_per_s=a_frames * 2 / wall / 1e6,
            stage_s=dict(dec.timings), tta_synth_launches=t_launches))
        del dec, pieces
    t_rates = [r["Msamples_per_s"] for r in tta_runs]
    line("tta_identity_throughput", identity_frames=int(short.shape[0]),
         identical=True, bit_exact=True,
         identity_tta_synth_launches=t_id_launches,
         audio_seconds=a_frames / SAMPLE_RATE,
         group_frames=tta.DEC_GROUP_FRAMES, encode_s=tta_encode_s,
         ratio=len(tta_bytes) / (alac_sig.size * 2),
         decode_Msamples_per_s=float(np.median(t_rates)),
         decode_Msamples_per_s_runs=t_rates, runs=tta_runs)

    # ---- 14. TTA encode kernel vs plain on one encode batch ------------
    F_e = tta.ENC_BATCH_FRAMES
    first = torch.as_tensor(alac_sig[:F_e * n_t].reshape(F_e, n_t, 2),
                            device=dev)
    predicted = tta_scan.fixed_predict(tta_scan.correlate(first), 16)
    lanes = predicted.permute(0, 2, 1).reshape(F_e * 2, n_t).contiguous()
    del first, predicted
    got = tta_scan.hybrid_filter(lanes, 16)
    start.record()
    want = tta_scan.hybrid_filter_plain(lanes, 16)
    stop.record()
    stop.synchronize()
    f_plain_ms = start.elapsed_time(stop)
    f_err = int((got.to(torch.int64) - want.to(torch.int64)).abs().max())
    if not torch.equal(got, want):
        raise AssertionError("tta_filter kernel != plain version (max abs "
                             "err %d)" % (f_err,))
    (L_f, _) = lanes.shape
    # inputs read and residuals written once; a sample takes 42 integer
    # operations (qm update 16, dot product 16, sign, shift and subtract
    # 3, the state rotation 7)
    (f_bound, f_bound_by) = bound(2 * L_f * n_t * 4, 42 * L_f * n_t)
    # the serial floor: n steps of the loop from one step to the next,
    # measured in this run on one warp at the largest SM clock (the
    # kernel's chain, and the qm -> dot product -> acc loop of the
    # kernel before it)
    (f_step, f_old_step) = (
        int_op_cycles.cycles(cycles_lib, kind)
        for kind in (int_op_cycles.TTA_FILTER_CASE,
                     int_op_cycles.TTA_FILTER_OLD_CASE))
    f_card_ms = device_ms(lambda: tta_scan.hybrid_filter(lanes, 16))
    filter_row = dict(
        max_abs_err=f_err,
        ms=median_ms(lambda: tta_scan.hybrid_filter(lanes, 16)),
        plain_ms=f_plain_ms, bound_ms=f_bound, bound_by=f_bound_by,
        library_ms=None, device_ms=f_card_ms, step_chain_cycles=f_step,
        serial_floor_ms=n_t * f_step / (max_sm_mhz * 1e3),
        old_loop_cycles=f_old_step,
        old_loop_ms=n_t * f_old_step / (max_sm_mhz * 1e3))
    line("kernel_vs_plain", kernel="tta_filter", shape=[L_f, n_t],
         frames=F_e, equal=True,
         ns_per_step=filter_row["ms"] * 1e6 / n_t,
         cycles_per_step_at_max_sm=filter_row["ms"] * 1e3 * max_sm_mhz / n_t,
         device_cycles_per_step_at_max_sm=f_card_ms * 1e3 * max_sm_mhz / n_t,
         **filter_row)
    del lanes, got, want

    # ---- 15. TTA encode identity and throughput ------------------------
    def host_tta_file(samples):
        """the file the port's all-host C++ encoder gives"""
        count = -(-samples.shape[0] // n_t)
        sizes = np.full(count, n_t, dtype=np.int32)
        sizes[-1] = samples.shape[0] - n_t * (count - 1)
        (data, lens) = _native.tta_encode_frames(samples, sizes, 2, 16)
        return (tta_format.build_header(2, 16, SAMPLE_RATE,
                                        samples.shape[0]) +
                tta_format.build_seektable([int(v) for v in lens]) + data)

    short_t = program_signal(5000, seed=13)
    short_files = []
    for device in ("cpu", "cuda"):
        out = io.BytesIO()
        tta_format.write_tta(out, reader_from_array(short_t, 16),
                             device=device)
        short_files.append(out.getvalue())
    if short_files != [host_tta_file(short_t)] * 2:
        raise AssertionError("short TTA files differ between the card, the "
                             "CPU and the host encoder")
    t0 = time.perf_counter()
    host_file = host_tta_file(alac_sig)
    host_tta_s = time.perf_counter() - t0
    if tta_bytes != host_file:
        raise AssertionError("card TTA encode differs from the host encoder")
    tta_enc_runs = []
    for _ in range(THROUGHPUT_RUNS):
        timings = {}
        out = io.BytesIO()
        tta_scan.hybrid_filter.launches = 0
        t0 = time.perf_counter()
        tta_format.write_tta(out, reader_from_array(alac_sig, 16),
                             device="cuda", timings=timings)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        f_launches = tta_scan.hybrid_filter.launches
        if f_launches <= 0:
            raise AssertionError("main TTA encode never launched tta_filter")
        if out.getvalue() != host_file:
            raise AssertionError("card TTA encode differs from the host "
                                 "encoder")
        tta_enc_runs.append(dict(
            wall_s=wall, Msamples_per_s=a_frames * 2 / wall / 1e6,
            stage_s=timings, tta_filter_launches=f_launches))
        del out
    te_rates = [r["Msamples_per_s"] for r in tta_enc_runs]
    line("tta_encode_identity_throughput",
         identity_frames=int(short_t.shape[0]), identical=True,
         audio_seconds=a_frames / SAMPLE_RATE,
         batch_frames=tta.ENC_BATCH_FRAMES,
         encode_Msamples_per_s=float(np.median(te_rates)),
         encode_Msamples_per_s_runs=te_rates,
         host_encode_Msamples_per_s=a_frames * 2 / host_tta_s / 1e6,
         runs=tta_enc_runs)

    # ---- 16. Shorten identity and throughput ---------------------------
    short_s = program_signal(3001, seed=17)
    short_shn = []
    for device in ("cpu", "cuda"):
        out = io.BytesIO()
        shn_format.write_shn(out, reader_from_array(short_s, 16),
                             device=device)
        short_shn.append(out.getvalue())
        if not np.array_equal(shn.decode_shn(short_shn[-1], device=device),
                              short_s):
            raise AssertionError("short Shorten stream does not decode on "
                                 "%s" % (device,))
    if short_shn[0] != short_shn[1]:
        raise AssertionError("short Shorten files differ between the card "
                             "and the CPU")
    header = shn_format.wave_header(2, SAMPLE_RATE, 16, 0x3,
                                    alac_sig.size * 2)
    t0 = time.perf_counter()
    host_shn = _native.shn_encode(alac_sig, 16, True, False, header)
    host_shn_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    host_dec = shn.FastSHNDecoder(io.BytesIO(host_shn))
    if not np.array_equal(host_dec.read(a_frames).samples, alac_sig):
        raise AssertionError("host Shorten decode is not bit-exact")
    host_shn_dec_s = time.perf_counter() - t0
    del host_dec
    shn_enc_runs = []
    shn_dec_runs = []
    for _ in range(THROUGHPUT_RUNS):
        timings = {}
        out = io.BytesIO()
        t0 = time.perf_counter()
        shn_format.write_shn(out, reader_from_array(alac_sig, 16),
                             device="cuda", timings=timings)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        if out.getvalue() != host_shn:
            raise AssertionError("card Shorten encode differs from the "
                                 "emitter's own decisions")
        shn_enc_runs.append(dict(
            wall_s=wall, Msamples_per_s=a_frames * 2 / wall / 1e6,
            ratio=len(host_shn) / (alac_sig.size * 2), stage_s=timings))
        del out
        t0 = time.perf_counter()
        dec = shn.TorchSHNDecoder(io.BytesIO(host_shn), device="cuda")
        pieces = []
        while True:
            framelist = dec.read(1 << 20)
            if framelist.frames == 0:
                break
            pieces.append(framelist.samples)
        wall = time.perf_counter() - t0
        if dec.host_fallback:
            raise AssertionError("card Shorten decode took the host route")
        if not np.array_equal(np.concatenate(pieces), alac_sig):
            raise AssertionError("card Shorten decode is not bit-exact")
        shn_dec_runs.append(dict(
            wall_s=wall, Msamples_per_s=a_frames * 2 / wall / 1e6,
            stage_s=dict(dec.timings), host_fallback=False))
        del dec, pieces
    se_rates = [r["Msamples_per_s"] for r in shn_enc_runs]
    sd_rates = [r["Msamples_per_s"] for r in shn_dec_runs]
    line("shn_identity_throughput", identity_frames=int(short_s.shape[0]),
         identical=True, bit_exact=True, host_fallback=False,
         audio_seconds=a_frames / SAMPLE_RATE, block_size=256,
         encode_Msamples_per_s=float(np.median(se_rates)),
         encode_Msamples_per_s_runs=se_rates,
         decode_Msamples_per_s=float(np.median(sd_rates)),
         decode_Msamples_per_s_runs=sd_rates,
         host_encode_Msamples_per_s=a_frames * 2 / host_shn_s / 1e6,
         host_decode_Msamples_per_s=a_frames * 2 / host_shn_dec_s / 1e6,
         encode_runs=shn_enc_runs, decode_runs=shn_dec_runs)

    (corr_row, decorr_row, wv_enc_runs, wv_dec_runs) = wavpack_phases(
        dev, alac_sig, max_sm_mhz, cycles_lib)

    # ---- 19. the converters --------------------------------------------
    t0 = time.perf_counter()
    fields = converter_phase(dev, alac_sig)
    line("converters", seconds=time.perf_counter() - t0, **fields)

    # ---- 20. the transcode farm ------------------------------------------
    t0 = time.perf_counter()
    fields = farm_phase(dev, sig, rate, dec_rate)
    line("farm", seconds=time.perf_counter() - t0, nvidia_smi=smi, **fields)

    # ---- 21. the command line --------------------------------------------
    t0 = time.perf_counter()
    (fields, cli_launches) = cli_phase(dev, alac_sig)
    line("cli", seconds=time.perf_counter() - t0, nvidia_smi=smi, **fields)

    # ---- 22. tags and foreign chunks through the command line --------------
    (fields, tags_launches) = tags_phase(dev, alac_sig)
    line("tags", nvidia_smi=smi, **fields)

    # ---- 23. the default encode routes and the exact Rice search ---------
    t0 = time.perf_counter()
    (fields, planes_row, planes_launches) = default_route_phase(
        dev, sig, runs, alac_enc_runs)
    line("default_route", seconds=time.perf_counter() - t0,
         nvidia_smi=smi, **fields)

    forbidden = loaded_forbidden_modules()
    if forbidden:
        raise AssertionError("the port loaded jax or the reference: %s"
                             % (forbidden,))
    kernels_line = []
    for (kname, source, replaces, kl, row) in (
            ("pack_rows", "pack_rows.cu", "pallas_bitpack.py:195",
             launches, pack_row),
            ("rice_decode", "rice_decode.cu", "rice_decode.py:309",
             dec_runs[0]["rice_decode_launches"], rice_row),
            ("flac_synth", "flac_synth.cu", "flac_synth.py:96",
             dec_runs[0]["flac_synth_launches"], synth_row),
            ("alac_synth", "alac_synth.cu", "alac_synth.py:233",
             alac_dec_runs[0]["alac_synth_launches"], alac_row),
            ("tta_synth", "tta_synth.cu", "tta_synth.py:107",
             tta_runs[0]["tta_synth_launches"], tta_row),
            ("tta_filter", "tta_filter.cu", "tta_scan.py:70",
             tta_enc_runs[0]["tta_filter_launches"], filter_row),
            ("wv_corr", "wv_chain.cu", "wv_scan.py:268",
             wv_enc_runs[0]["wv_corr_launches"], corr_row),
            ("wv_decorr", "wv_chain.cu", "wv_scan.py:249",
             wv_dec_runs[0]["wv_decorr_launches"], decorr_row),
            ("rice_planes", "rice_planes.cu", "flac_frames.py:508",
             planes_launches, planes_row)):
        kernels_line.append(dict(
            name=kname, route="cuda",
            source="audiotools_tpu_torch/csrc/" + source,
            replaces="audiotools_tpu/ops/" + replaces, launches=kl,
            cli_launches=cli_launches[kname],
            tags_launches=tags_launches[kname], **row))
    print(json.dumps({"kernels": kernels_line}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
