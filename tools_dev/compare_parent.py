#!/usr/bin/env python
"""Times this tree's FLAC encode pack and its rice_decode, alac_synth,
wv_corr and wv_decorr kernels against those of another checkout of the
port (an earlier commit, unpacked with `git archive` into a directory,
or another arrangement of these kernels), in one process on one CUDA
card, on the inputs of chip_smoke.py's phases 3, 6, 9 and 17: the
chosen subframes of a 1024-frame FLAC -8 batch of bench.py's signal
(2048 rows of 4096), the records of the largest bucket of that batch's
stream, the subframe rows of a 1024-frameset ALAC batch (2048 x 4096),
and the WavPack blocks of chip_smoke.wv_kernel_inputs (wv_corr: a
standard, a veryhigh and a mono block; wv_decorr: 32 standard blocks
and 8 veryhigh ones).

The pack is each tree's whole ops/bitpack.pack_chosen_residuals, the
encoder's pack stage (the other tree's package loaded under another
name, building its kernels into its own build directory).  Each
kernel is called through its binding in kernels.py (no wrapper
checks; alac_synth with the row grouping of each tree's own
ops/alac_synth.group_rows, or with the width of the row-per-thread
kernel that came before it).  Both trees run on the same tensors, in
the order other, this, this, other; each time is the median of
chip_smoke's median_ms (the host's enqueue included) and device_ms
(the card alone).  Both outputs must be equal.  Prints the card's name
and power limit, then one JSON line per comparison.  With --wavpack
only the WavPack kernels are compared.

With --tta only tta_filter is compared, on chip_smoke.py's phase 14
input (the fixed predictor's output of the first 256-frame encode
batch of bench.py's signal, 512 lanes x 46080); then one JSON line per
tree gives the innermost loops of its tta_filter_kernel's SASS
(cuobjdump -sass), largest first, with their instructions and opcodes
counted, and --sass DIR also writes each tree's kernel SASS into DIR.

With --rice only rice_planes is compared, on phase 23's input: the
residuals of the first exact Rice search of one 1024-block FLAC -8
batch of bench.py's signal under ATPU_DEVICE_RICE=exact (4096 variants
x 13 candidates x 4096, 64 partitions, J0 14), both outputs also equal
to rice_planes_plain; the line adds the bound, each tree's ptxas
registers and spills, and the span of the ladder's torch descent after
the counts (chip_smoke.rice_descent_ms).  Then one JSON line per
rice_planes kernel of each tree gives its innermost SASS loops as
--tta does, and --sass DIR writes their SASS into DIR.

With --parse only the WavPack decode is compared: phase 18's stream
(380.4 s of bench.py's signal at "standard", written by this tree)
decoded whole by each tree's TorchWavPackDecoder, in the order other,
this, this, other, after a short stream through each; the line gives
each tree's stage seconds (its bitstream parse among them) and walls,
the decodes equal.
Usage:

    python3 tools_dev/compare_parent.py OTHER_DIR [--wavpack | --tta
        [--sass DIR] | --rice [--sass DIR] | --parse]
"""

import importlib.util
import inspect
import io
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def load_module(tree, rel, name):
    """the module at `rel` in `tree`'s port package as module `name`"""
    path = os.path.join(tree, "audiotools_tpu_torch", *rel.split("/"))
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def load_package(tree, name):
    """`tree`'s port package as package `name`, so that its modules'
    relative imports stay inside it"""
    init = os.path.join(tree, "audiotools_tpu_torch", "__init__.py")
    spec = importlib.util.spec_from_file_location(
        name, init, submodule_search_locations=[os.path.dirname(init)])
    module = importlib.util.module_from_spec(spec)
    sys.modules[name] = module
    spec.loader.exec_module(module)
    return module


def load_kernels(tree, name):
    """the kernels.py of `tree` as module `name`, building into its own
    build directory"""
    module = load_module(tree, "kernels.py", name)
    module.load()
    return module


def alac_call(tree, kernels, args, order, max_ord, dev):
    """fn(out) launching `tree`'s alac_synth on `args`"""
    if "rows" in inspect.signature(kernels.alac_synth).parameters:
        ops = load_module(tree, "ops/alac_synth.py",
                          kernels.__name__ + "_alac_ops")
        rows = torch.as_tensor(ops.group_rows(order), device=dev)
        return lambda out: kernels.alac_synth(*args, rows, 8, out)
    kmax = 8 if max_ord <= 8 else 32
    return lambda out: kernels.alac_synth(*args, 8, kmax, out)


def flac_chosen(dev):
    """the chosen subframes of one bench-shaped FLAC batch, and the
    pack's arguments after them (n, bps, stereo_trial, max_parts,
    n_words)"""
    from audiotools_tpu_torch.ops import bitpack, flac_frames, lpc
    from chip_smoke import OPTS, program_signal
    (n, K, frames) = (OPTS["block_size"], OPTS["max_lpc_order"],
                      OPTS["batch_frames"])
    porders = flac_frames.valid_partition_orders(
        n, OPTS["max_residual_partition_order"], max(K, 4))
    P = 1 << porders[-1]
    blocks = torch.as_tensor(program_signal(n * frames).reshape(
        frames, n, 2).astype(np.int16), device=dev)
    (_packed, chosen) = flac_frames.analyze_frames_packed(
        blocks, True, 16, n, K, 12, porders, 14,
        OPTS["exhaustive_model_search"], OPTS["mid_side"],
        lpc.tukey_window(n, dev), return_chosen=True)
    return (chosen, (n, 16, True, P,
                     bitpack.residual_words_capacity(n, 17, P)))


def flac_bucket(dev):
    """the records of the largest bucket of one bench-shaped batch"""
    from audiotools_tpu_torch import _native
    from audiotools_tpu_torch.codecs import flac_dec
    from audiotools_tpu_torch.codecs import flac_enc_fast as port_enc
    from audiotools_tpu_torch.pcm import reader_from_array, streaminfo
    from chip_smoke import OPTS, program_signal
    (n, frames) = (OPTS["block_size"], OPTS["batch_frames"])
    out = io.BytesIO()
    port_enc.encode_flac_fast(out, reader_from_array(
        program_signal(n * frames), 16), device="cuda", **OPTS)
    data = out.getvalue()
    frame_bytes = data[streaminfo(data)[4]:]
    scan = _native.flac_scan(
        frame_bytes, 16, 2, max_samples=frames * n, max_frames=frames,
        max_parts=flac_dec.MAX_PARTS, chunk_codes=flac_dec.CHUNK_CODES)
    batch = flac_dec.HostBatch(scan, frame_bytes, 2, 16)
    tensors = flac_dec.upload_batch(batch, dev)
    b = int(np.argmax([batch.arrays["bucket%d" % i].shape[1]
                       for i in range(len(batch.buckets))]))
    (W, C) = batch.buckets[b]
    records = [t.contiguous() for t in tensors["bucket%d" % b][:5]]
    return ([tensors["words"]] + records, W, C)


def alac_rows(dev):
    """the subframe rows of one 1024-frameset ALAC batch"""
    from audiotools_tpu_torch import _native
    from audiotools_tpu_torch.codecs import alac_dec
    from audiotools_tpu_torch.codecs.flac_dec import upload_arrays
    from audiotools_tpu_torch.formats import m4a
    from audiotools_tpu_torch.pcm import reader_from_array
    from audiotools_tpu_torch.ref.alac import read_m4a_header
    from chip_smoke import program_signal
    (n, frames) = (4096, 1024)
    out = io.BytesIO()
    m4a.write_m4a(out, reader_from_array(program_signal(n * frames), 16),
                  device="cuda")
    data = out.getvalue()
    header = read_m4a_header(io.BytesIO(data))
    scan = _native.alac_scan(
        data[header["mdat_offset"]:], 16, 2, n, header["initial_history"],
        header["history_multiplier"], header["maximum_k"], n * frames,
        frames * 2 + 2)
    tensors = upload_arrays(alac_dec.prepare_batch(scan, 2), dev)
    args = [tensors["residuals"], tensors["qlp"]] + [
        t.contiguous() for t in tensors["sub"][:3]]
    return (args, scan["sub_meta"][:, 2])


def in_turns(run_other, run_mine):
    """{"other": [...], "this": [...]} of (median_ms, device_ms), timed
    in the order other, this, this, other"""
    from chip_smoke import device_ms, median_ms
    times = {"other": [], "this": []}
    for who in ("other", "this", "this", "other"):
        fn = run_other if who == "other" else run_mine
        times[who].append((median_ms(fn), device_ms(fn)))
    return times


def summary(name, shape, equal, times):
    return json.dumps({
        "kernel": name, "shape": list(shape), "equal": equal,
        "other_ms": float(np.median([t[0] for t in times["other"]])),
        "other_device_ms": float(np.median([t[1] for t in times["other"]])),
        "this_ms": float(np.median([t[0] for t in times["this"]])),
        "this_device_ms": float(np.median([t[1] for t in times["this"]])),
        "runs": times})


def compare_wavpack(other, mine, dev):
    """wv_corr and wv_decorr of both trees on phase 17's blocks"""
    from chip_smoke import wv_kernel_inputs, wv_tensors
    for (name, (encode, blocks)) in wv_kernel_inputs().items():
        (batch, args) = wv_tensors(blocks, dev)
        n_outs = 3 if encode else 1
        outs = [[torch.empty_like(args[k]) for k in (0, 3, 4)[:n_outs]]
                for _ in range(2)]
        kname = "wv_corr" if encode else "wv_decorr"
        (run_other, run_mine) = (
            (lambda m=m, o=o: getattr(m, kname)(*args, *o))
            for (m, o) in zip((other, mine), outs))
        run_other()
        run_mine()
        torch.cuda.synchronize()
        equal = all(bool(torch.equal(a, b))
                    for (a, b) in zip(outs[0], outs[1]))
        shape = [len(blocks), int(batch["meta"][:, 1].max()),
                 int(batch["meta"][:, 3].max())]
        print(summary("%s (%s)" % (kname, name), shape, equal,
                      in_turns(run_other, run_mine)), flush=True)


def compare_parse(other_dir, dev):
    """phase 18's WavPack decode, whole, with each tree's decoder"""
    from chip_smoke import ALAC_BATCHES, OPTS, program_signal
    from audiotools_tpu_torch.codecs import wavpack as my_wavpack
    from audiotools_tpu_torch.formats.wavpack import write_wavpack
    from audiotools_tpu_torch.pcm import read_all, reader_from_array
    other_wavpack = importlib.import_module(
        load_package(other_dir, "other_port").__name__ + ".codecs.wavpack")
    sig = program_signal(OPTS["block_size"] * 1024 * ALAC_BATCHES)
    out = io.BytesIO()
    write_wavpack(out, reader_from_array(sig, 16), "standard", device=dev)
    data = out.getvalue()
    # a short stream through each tree first: its kernels' first use
    # (their build or load) outside the timed runs
    warm = io.BytesIO()
    write_wavpack(warm, reader_from_array(sig[:1 << 18], 16), "standard",
                  device=dev)
    for module in (other_wavpack, my_wavpack):
        read_all(module.TorchWavPackDecoder(io.BytesIO(warm.getvalue()),
                                            device=dev))
    runs = {"other": [], "this": []}
    equal = True
    for who in ("other", "this", "this", "other"):
        module = other_wavpack if who == "other" else my_wavpack
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        decoder = module.TorchWavPackDecoder(io.BytesIO(data), device=dev)
        samples = read_all(decoder)
        wall = time.perf_counter() - t0
        equal = equal and bool(np.array_equal(samples, sig))
        runs[who].append(dict(wall_s=wall, stage_s=dict(decoder.timings)))
    print(json.dumps({
        "compare": "WavPack decode (TorchWavPackDecoder)",
        "frames": int(sig.shape[0]), "equal": equal,
        "other_parse_s": float(np.median(
            [r["stage_s"]["parse"] for r in runs["other"]])),
        "this_parse_s": float(np.median(
            [r["stage_s"]["parse"] for r in runs["this"]])),
        "other_wall_s": float(np.median([r["wall_s"]
                                         for r in runs["other"]])),
        "this_wall_s": float(np.median([r["wall_s"] for r in runs["this"]])),
        "runs": runs}), flush=True)


def tta_lanes(dev):
    """phase 14's input: the fixed predictor's output of the first
    256-frame encode batch of bench.py's signal (seed 7), [512, 46080]"""
    from audiotools_tpu_torch.codecs import tta
    from audiotools_tpu_torch.ops import tta_scan
    from chip_smoke import SAMPLE_RATE, program_signal
    (F, n) = (tta.ENC_BATCH_FRAMES, tta.oracle.block_size_for(SAMPLE_RATE))
    first = torch.as_tensor(program_signal(F * n).reshape(F, n, 2),
                            device=dev)
    predicted = tta_scan.fixed_predict(tta_scan.correlate(first), 16)
    return predicted.permute(0, 2, 1).reshape(F * 2, n).contiguous()


def sass_functions(kernels, lib_path):
    """{mangled name: SASS body} of every kernel in the library at
    `lib_path` (cuobjdump -sass)"""
    import re
    cuobjdump = os.path.join(os.path.dirname(kernels.nvcc_path()),
                             "cuobjdump")
    dump = subprocess.run([cuobjdump, "-sass", lib_path], check=True,
                          capture_output=True, text=True).stdout
    return {sec.split("\n", 1)[0].strip(): sec
            for sec in re.split(r"\n\s*Function : ", dump)[1:]}


def sass_loops(kernels, lib_path, name, dump_path=None):
    """the innermost loops of kernel `name`'s SASS in the library at
    `lib_path` (cuobjdump -sass), largest first: each loop's first and
    last address, its instructions, and their opcodes counted (the
    IMAD family together under "IMAD*"); with `dump_path` the kernel's
    SASS is written there"""
    body = next(sec for (fname, sec) in
                sass_functions(kernels, lib_path).items() if name in fname)
    return body_loops(body, dump_path)


def body_loops(body, dump_path=None):
    """sass_loops of one kernel's SASS `body`"""
    import re
    if dump_path:
        with open(dump_path, "w") as f:
            f.write("Function : " + body)
    (insns, labels) = ([], {})
    pending = []
    for text in body.split("\n"):
        label = re.match(r"\s*(\.L_x_\d+):", text)
        if label:
            pending.append(label.group(1))
            continue
        m = re.search(r"/\*([0-9a-f]{4,})\*/\s+(.+?)\s*;", text)
        if m:
            addr = int(m.group(1), 16)
            for lb in pending:
                labels[lb] = addr
            pending = []
            insns.append((addr, m.group(2)))
    loops = []
    for (addr, text) in insns:
        m = re.search(r"\bBRA\b.*?(0x[0-9a-f]+|\.L_x_\d+)", text)
        if m:
            target = (int(m.group(1), 16) if m.group(1).startswith("0x")
                      else labels[m.group(1)])
            if target < addr:
                loops.append((target, addr))
    inner = [(a, b) for (a, b) in loops
             if not any(a <= c and d <= b and (c, d) != (a, b)
                        for (c, d) in loops)]
    out = []
    for (a, b) in inner:
        ops = {}
        body_insns = [t for (addr, t) in insns if a <= addr <= b]
        for t in body_insns:
            op = re.sub(r"^@!?U?P\w+\s+", "", t).split()[0]
            op = "IMAD*" if op.startswith("IMAD") else op.split(".")[0]
            ops[op] = ops.get(op, 0) + 1
        out.append(dict(first=hex(a), last=hex(b),
                        instructions=len(body_insns), imad=ops.get("IMAD*", 0),
                        ops=dict(sorted(ops.items(), key=lambda kv: -kv[1]))))
    return sorted(out, key=lambda d: -d["instructions"])


def compare_tta(other, mine, dev, sass_dir):
    """tta_filter of both trees on phase 14's lanes, and the innermost
    loops of each build's SASS"""
    from audiotools_tpu_torch.ops.tta_synth import filter_shift_for
    lanes = tta_lanes(dev)
    fshift = filter_shift_for(16)
    outs = [torch.empty_like(lanes) for _ in range(2)]
    (run_other, run_mine) = (
        (lambda m=m, o=o: m.tta_filter(lanes, fshift, o))
        for (m, o) in zip((other, mine), outs))
    run_other()
    run_mine()
    torch.cuda.synchronize()
    equal = bool(torch.equal(outs[0], outs[1]))
    print(summary("tta_filter", lanes.shape, equal,
                  in_turns(run_other, run_mine)), flush=True)
    for (who, module) in (("other", other), ("this", mine)):
        dump = (os.path.join(sass_dir, "tta_filter_%s.sass" % who)
                if sass_dir else None)
        print(json.dumps({"sass": who, "kernel": "tta_filter_kernel",
                          "innermost_loops": sass_loops(
                              mine, module.library_path(),
                              "tta_filter_kernel", dump)}), flush=True)
    if not equal:
        sys.exit("tta_filter outputs differ")


def compare_rice(other, mine, dev, sass_dir):
    """rice_planes of both trees on phase 23's residuals, the descent
    after it, and the innermost loops of each build's SASS"""
    from audiotools_tpu_torch.ops import flac_frames
    from chip_smoke import (OPTS, bound, exact_rice_batch, program_signal,
                            ptxas_summary, rice_descent_ms)
    (n, frames) = (OPTS["block_size"], OPTS["batch_frames"])
    (_data, _launches, _s, (res, parts, j0), search) = exact_rice_batch(
        dev, program_signal(n * frames))
    (S, C, nn) = res.shape
    (rows, psize) = (S * C * parts, nn // parts)
    want = flac_frames.rice_planes_plain(res, parts, j0)
    outs = [torch.empty_like(want) for _ in range(2)]
    (run_other, run_mine) = (
        (lambda m=m, o=o: m.rice_planes(res, rows, psize, j0, o))
        for (m, o) in zip((other, mine), outs))
    run_other()
    run_mine()
    torch.cuda.synchronize()
    equal = all(bool(torch.equal(o, want)) for o in outs)
    line = json.loads(summary("rice_planes", [S, C, nn, parts, j0 + 1],
                              equal, in_turns(run_other, run_mine)))
    (line["bound_ms"], line["bound_by"]) = bound(
        S * C * nn * 4 + rows * (j0 + 1) * 4, S * C * nn * (2 * j0 + 4))
    for (who, module) in (("other", other), ("this", mine)):
        line[who + "_ptxas"] = [
            k for k in ptxas_summary(module.build_log)
            if k["kernel"].startswith("rice_planes")]
    (line["descent_ms"], line["descent_device_ms"]) = rice_descent_ms(
        search, want)
    print(json.dumps(line), flush=True)
    for (who, module) in (("other", other), ("this", mine)):
        functions = sass_functions(mine, module.library_path())
        for (fname, body) in functions.items():
            if "rice_planes_kernel" not in fname:
                continue
            dump = (os.path.join(sass_dir, "rice_planes_%s_%s.sass"
                                 % (who, fname)) if sass_dir else None)
            print(json.dumps({"sass": who, "kernel": fname,
                              "innermost_loops": body_loops(body, dump)}),
                  flush=True)
    if not equal:
        sys.exit("rice_planes outputs differ")


def main():
    argv = sys.argv[1:]
    sass_dir = None
    if "--sass" in argv:
        k = argv.index("--sass")
        sass_dir = argv[k + 1]
        argv = argv[:k] + argv[k + 2:]
    args = [a for a in argv
            if a not in ("--wavpack", "--tta", "--rice", "--parse")]
    if len(args) != 1 or not torch.cuda.is_available():
        sys.exit("usage: compare_parent.py OTHER_DIR [--wavpack | --tta "
                 "[--sass DIR] | --rice [--sass DIR] | --parse] (needs a "
                 "CUDA card)")
    from audiotools_tpu_torch import kernels as mine
    from chip_smoke import device_ms, median_ms
    other_dir = os.path.abspath(args[0])
    other = load_kernels(other_dir, "other_kernels")
    mine.load()
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip())
    dev = torch.device("cuda", 0)
    if "--parse" in argv:
        compare_parse(other_dir, dev)
        return
    if "--wavpack" in argv:
        compare_wavpack(other, mine, dev)
        return
    if sass_dir:
        os.makedirs(sass_dir, exist_ok=True)
    if "--tta" in argv:
        compare_tta(other, mine, dev, sass_dir)
        return
    if "--rice" in argv:
        compare_rice(other, mine, dev, sass_dir)
        return

    from audiotools_tpu_torch.ops import bitpack as my_bitpack
    other_bitpack = importlib.import_module(
        load_package(other_dir, "other_port").__name__
        + ".ops.bitpack")
    (chosen, pack_args) = flac_chosen(dev)
    (rice_args, W, C) = flac_bucket(dev)
    P = rice_args[1].shape[0]
    (a_args, order) = alac_rows(dev)
    max_ord = int(order[order < 31].max(initial=0))

    runs = {}
    pack_outs = {}
    for (who, module) in (("other", other_bitpack), ("this", my_bitpack),
                          ("this", my_bitpack), ("other", other_bitpack)):
        fn = (lambda m=module: m.pack_chosen_residuals(chosen, *pack_args))
        pack_outs[who] = fn()
        runs.setdefault(who, []).append((median_ms(fn), device_ms(fn)))
    torch.cuda.synchronize()
    print(json.dumps({
        "kernel": "pack (pack_chosen_residuals)",
        "shape": [int(pack_outs["this"][0].shape[0]),
                  pack_args[0], pack_args[4]],
        "equal": all(bool(torch.equal(a, b)) for (a, b) in
                     zip(pack_outs["other"], pack_outs["this"])),
        "other_ms": float(np.median([t[0] for t in runs["other"]])),
        "other_device_ms": float(np.median([t[1] for t in runs["other"]])),
        "this_ms": float(np.median([t[0] for t in runs["this"]])),
        "this_device_ms": float(np.median([t[1] for t in runs["this"]])),
        "runs": runs}), flush=True)
    del chosen, pack_outs

    calls = {
        "rice_decode": (
            (P, C),
            lambda out: other.rice_decode(*rice_args, W, out),
            lambda out: mine.rice_decode(*rice_args, W, out)),
        "alac_synth": (
            tuple(a_args[0].shape),
            alac_call(other_dir, other, a_args, order, max_ord, dev),
            alac_call(ROOT, mine, a_args, order, max_ord, dev)),
    }
    for (name, (shape, run_other, run_mine)) in calls.items():
        outs = [torch.empty(shape, dtype=torch.int32, device=dev)
                for _ in range(2)]
        run_other(outs[0])
        run_mine(outs[1])
        torch.cuda.synchronize()
        times = in_turns(lambda: run_other(outs[0]), lambda: run_mine(outs[1]))
        print(summary(name, shape, bool(torch.equal(outs[0], outs[1])),
                      times), flush=True)
    compare_wavpack(other, mine, dev)


if __name__ == "__main__":
    main()
