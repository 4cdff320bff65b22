#!/usr/bin/env python
"""Times builds of audiotools_tpu_torch/csrc/wv_chain.cu that differ in
their -D choices, on one CUDA card: WV_CHUNK, the samples a chunk hands
from one pass to the next; WV_STAGES, the depth of the rings of chunks;
WV_DEC_SHFL, the decoder's negative terms (-1, -2, -3) with both
channels on one lane (0) or a lane a channel, each step's outputs
passed across by a warp shuffle (1).

The inputs are chip_smoke.py's phase 17's: the third block of a
standard, a veryhigh and a standard mono encode of phase 11's signal
(wv_corr), and the first 32 blocks of its standard stream and 8 blocks
of a veryhigh one (wv_decorr).  Each build goes into
audiotools_tpu_torch/build/wv_variants/ (the compiles started
together), is loaded with ctypes, and must give, output for output,
what the package's own build gives (which chip_smoke.py holds to the
plain versions).  Times are the card's alone (chip_smoke.device_ms:
each call behind a spin kernel), the median of two turns, one in the
order of the builds and one in reverse.  Prints the card's name and
power limit, then one JSON line per build with its registers and spills
as ptxas reports them.  Usage:

    python3 tools_dev/wv_chain_variants.py
"""

import ctypes
import json
import os
import subprocess
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

# the package's build first
VARIANTS = (
    dict(WV_CHUNK=16, WV_STAGES=4, WV_DEC_SHFL=0),
    dict(WV_CHUNK=16, WV_STAGES=4, WV_DEC_SHFL=1),
    dict(WV_CHUNK=32, WV_STAGES=4, WV_DEC_SHFL=0),
    dict(WV_CHUNK=8, WV_STAGES=4, WV_DEC_SHFL=0),
    dict(WV_CHUNK=16, WV_STAGES=2, WV_DEC_SHFL=0),
    dict(WV_CHUNK=16, WV_STAGES=3, WV_DEC_SHFL=0),
    dict(WV_CHUNK=16, WV_STAGES=8, WV_DEC_SHFL=0),
)
TURN_RUNS = 5


def build_all(kernels, variants=VARIANTS):
    """compiles each variant (a dict of -D values), all at once; returns
    [(library path, build log)]"""
    out_dir = os.path.join(kernels.BUILD_DIR, "wv_variants")
    os.makedirs(out_dir, exist_ok=True)
    src = os.path.join(kernels.SOURCE_DIR, "wv_chain.cu")
    procs = []
    for v in variants:
        tag = "_".join("%s%d" % (k, val) for (k, val) in sorted(v.items()))
        lib = os.path.join(out_dir, "libwv_%s.so" % tag)
        cmd = ([kernels.nvcc_path()] + kernels.NVCC_FLAGS +
               ["-D%s=%d" % kv for kv in sorted(v.items())] +
               ["-shared", "-o", lib, src])
        procs.append((lib, cmd, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    built = []
    for (lib, cmd, proc) in procs:
        log = proc.communicate()[0]
        if proc.returncode != 0:
            sys.exit("nvcc failed (%d): %s\n%s" % (proc.returncode,
                                                  " ".join(cmd), log))
        built.append((lib, log))
    return built


def bind(path):
    lib = ctypes.CDLL(path)
    lib.atpu_wv_corr.argtypes = (
        [ctypes.c_void_p] * 5 + [ctypes.c_int] + [ctypes.c_void_p] * 4)
    lib.atpu_wv_corr.restype = ctypes.c_int
    lib.atpu_wv_decorr.argtypes = (
        [ctypes.c_void_p] * 5 + [ctypes.c_int] + [ctypes.c_void_p] * 2)
    lib.atpu_wv_decorr.restype = ctypes.c_int
    return lib


def caller(lib, encode, args, outs):
    """fn() launching lib's kernel on the card tensors args into outs"""
    ptrs = [ctypes.c_void_p(t.data_ptr()) for t in args]
    optrs = [ctypes.c_void_p(t.data_ptr()) for t in outs]
    blocks = args[1].shape[0]
    fn = lib.atpu_wv_corr if encode else lib.atpu_wv_decorr

    def run():
        stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
        rc = fn(*ptrs, blocks, *optrs, stream)
        if rc != 0:
            raise RuntimeError("launch failed: CUDA error %d" % rc)
    return run


def main():
    if not torch.cuda.is_available():
        sys.exit("wv_chain_variants: needs a CUDA card")
    from audiotools_tpu_torch import kernels
    import chip_smoke as smoke
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip(),
        flush=True)
    if kernels.wv_chain_config() != tuple(
            VARIANTS[0][k] for k in ("WV_CHUNK", "WV_STAGES", "WV_DEC_SHFL")):
        sys.exit("wv_chain_variants: VARIANTS[0] is not the package's "
                 "build %s" % (kernels.wv_chain_config(),))
    built = build_all(kernels)
    dev = torch.device("cuda", 0)

    inputs = smoke.wv_kernel_inputs()
    cases = {}
    for (name, (encode, blocks)) in inputs.items():
        (_batch, args) = smoke.wv_tensors(blocks, dev)
        if encode:
            want = [torch.empty_like(args[0]), torch.empty_like(args[3]),
                    torch.empty_like(args[4])]
            kernels.wv_corr(*args, *want)
        else:
            want = [torch.empty_like(args[0])]
            kernels.wv_decorr(*args, *want)
        cases[name] = (encode, args, want)
    torch.cuda.synchronize()

    libs = [bind(path) for (path, _log) in built]
    results = [dict(defines=v, equal=True, device_ms={})
               for v in VARIANTS]
    for (name, (encode, args, want)) in cases.items():
        outs = [[torch.empty_like(t) for t in want] for _ in libs]
        fns = [caller(lib, encode, args, o) for (lib, o) in zip(libs, outs)]
        for fn in fns:
            fn()
        torch.cuda.synchronize()
        for (k, o) in enumerate(outs):
            if not all(torch.equal(a, b) for (a, b) in zip(o, want)):
                results[k]["equal"] = False
        times = [[] for _ in fns]
        order = list(range(len(fns)))
        for turn in (order, order[::-1]):
            for k in turn:
                times[k].append(smoke.device_ms(fns[k], TURN_RUNS))
        for (k, t) in enumerate(times):
            results[k]["device_ms"][name] = float(np.median(t))
            results[k].setdefault("turns", {})[name] = t
    for (res, (path, log)) in zip(results, built):
        res["library"] = os.path.relpath(path, ROOT)
        res["ptxas"] = smoke.ptxas_summary(log)
        print(json.dumps(res), flush=True)
    if not all(r["equal"] for r in results):
        sys.exit("wv_chain_variants: a build differs from the package's")


if __name__ == "__main__":
    main()
