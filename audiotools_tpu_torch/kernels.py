"""Build and bind the hand-written CUDA kernels in ``csrc/``.

The sources compile with ``nvcc`` into one shared library with a plain
C interface, loaded through ctypes.  The build runs on first use, from
the package's own sources, into ``build/`` beside this file: one
``nvcc -c`` per source, all started together, then one link.  The
library's name carries a hash of the sources and flags, so an edited
source builds anew and an unchanged one is reused.  Nothing here runs
at import time: the CPU-only test hosts have no ``nvcc``.

Each binding takes torch CUDA tensors, launches on the current stream
without synchronising, and raises if the launch reports an error.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import threading

_HERE = os.path.dirname(os.path.abspath(__file__))
SOURCE_DIR = os.path.join(_HERE, "csrc")
BUILD_DIR = os.path.join(_HERE, "build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lib = None
build_log = ""
# one thread builds and binds the library; the others wait for it
_load_lock = threading.Lock()


def nvcc_path():
    """the CUDA compiler: $CUDA_HOME/bin/nvcc, else nvcc on PATH, else
    the toolkit's default install location"""
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(os.path.join(os.environ["CUDA_HOME"], "bin",
                                       "nvcc"))
    on_path = shutil.which("nvcc")
    if on_path:
        candidates.append(on_path)
    candidates.append("/usr/local/cuda/bin/nvcc")
    for path in candidates:
        if os.path.isfile(path):
            return path
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on "
                       "PATH); the CUDA kernels cannot be built")


def _sources():
    return sorted(glob.glob(os.path.join(SOURCE_DIR, "*.cu")))


def _headers():
    return sorted(glob.glob(os.path.join(SOURCE_DIR, "*.cuh")))


def library_path():
    """where the library for the current sources and flags lives"""
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in _sources() + _headers():
        digest.update(os.path.basename(path).encode())
        with open(path, "rb") as f:
            digest.update(f.read())
    return os.path.join(BUILD_DIR,
                        "libatpu_kernels-%s.so" % digest.hexdigest()[:16])


def build():
    """compiles csrc/*.cu unless the library for these sources exists;
    returns its path.  Raises RuntimeError with the compiler's output
    if nvcc fails."""
    global build_log
    so_path = library_path()
    if os.path.exists(so_path):
        return so_path
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = nvcc_path()
    # temporaries named for this process and thread: another process
    # may be building the same library at once
    stem = "%s.%d.%d" % (so_path, os.getpid(), threading.get_ident())
    objects = ["%s.%s.o" % (stem, os.path.basename(src))
               for src in _sources()]
    compiles = [(cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True))
                for cmd in ([nvcc] + NVCC_FLAGS + ["-c", src, "-o", obj]
                            for (src, obj) in zip(_sources(), objects))]
    logs = []
    failed = None
    for (cmd, proc) in compiles:
        logs.append(proc.communicate()[0])
        if proc.returncode != 0 and failed is None:
            failed = (cmd, proc.returncode)
    tmp = stem + ".tmp"
    if failed is None:
        cmd = [nvcc, "-shared", "-o", tmp] + objects
        proc = subprocess.run(cmd, capture_output=True, text=True)
        logs.append(proc.stdout + proc.stderr)
        if proc.returncode != 0:
            failed = (cmd, proc.returncode)
    for obj in objects:
        if os.path.exists(obj):
            os.remove(obj)
    build_log = "".join(logs)
    if failed is not None:
        raise RuntimeError("nvcc failed (%d):\n%s\n%s" % (
            failed[1], " ".join(failed[0]), build_log))
    os.replace(tmp, so_path)
    return so_path


def load():
    """builds on first use and returns the bound ctypes library; safe to
    call from several threads at once (one builds, the rest wait)"""
    global _lib
    if _lib is not None:
        return _lib
    with _load_lock:
        if _lib is None:
            _lib = _bind(ctypes.CDLL(build()))
    return _lib


def _bind(lib):
    """declares the argument and result types of the library's entry
    points; returns it"""
    lib.atpu_pack_rows.argtypes = (
        [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 +
        [ctypes.c_void_p] * 4)
    lib.atpu_pack_rows.restype = ctypes.c_int
    lib.atpu_rice_decode.argtypes = (
        [ctypes.c_void_p] * 6 +
        [ctypes.c_int, ctypes.c_int64, ctypes.c_int, ctypes.c_int,
         ctypes.c_void_p, ctypes.c_void_p])
    lib.atpu_rice_decode.restype = ctypes.c_int
    lib.atpu_flac_synth.argtypes = (
        [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 +
        [ctypes.c_void_p, ctypes.c_void_p])
    lib.atpu_flac_synth.restype = ctypes.c_int
    lib.atpu_alac_synth.argtypes = (
        [ctypes.c_void_p] * 6 +
        [ctypes.c_int] * 5 + [ctypes.c_void_p, ctypes.c_void_p])
    lib.atpu_alac_synth.restype = ctypes.c_int
    lib.atpu_tta_synth.argtypes = (
        [ctypes.c_void_p] + [ctypes.c_int] * 4 +
        [ctypes.c_void_p, ctypes.c_void_p])
    lib.atpu_tta_synth.restype = ctypes.c_int
    lib.atpu_tta_filter.argtypes = (
        [ctypes.c_void_p] + [ctypes.c_int] * 3 +
        [ctypes.c_void_p, ctypes.c_void_p])
    lib.atpu_tta_filter.restype = ctypes.c_int
    lib.atpu_wv_corr.argtypes = (
        [ctypes.c_void_p] * 5 + [ctypes.c_int] + [ctypes.c_void_p] * 4)
    lib.atpu_wv_corr.restype = ctypes.c_int
    lib.atpu_wv_decorr.argtypes = (
        [ctypes.c_void_p] * 5 + [ctypes.c_int] + [ctypes.c_void_p] * 2)
    lib.atpu_wv_decorr.restype = ctypes.c_int
    lib.atpu_wv_chain_config.argtypes = [ctypes.c_void_p] * 3
    lib.atpu_wv_chain_config.restype = None
    lib.atpu_rice_planes.argtypes = [
        ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_void_p]
    lib.atpu_rice_planes.restype = ctypes.c_int
    return lib


def _stream_ptr(device):
    import torch
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def _ptr(t):
    return ctypes.c_void_p(t.data_ptr())


def pack_rows(res, orders, porders, choice, params, max_bps, words, bits,
              ok):
    """launches csrc/pack_rows.cu: packs the residual partition blocks
    of the rows of ``res`` [S, n] into ``words`` [S, n_words], their bit
    counts into ``bits`` [S] and their ok flags into ``ok`` [S]

    int32 inputs and outputs but ``ok`` (bool), all contiguous CUDA
    tensors on one device.  The caller (ops/bitpack.pack_rows) validates
    the arguments."""
    import torch
    lib = load()
    (S, n) = res.shape
    with torch.cuda.device(res.device):
        rc = lib.atpu_pack_rows(
            _ptr(res), _ptr(orders), _ptr(porders), _ptr(choice),
            _ptr(params), S, n, params.shape[1], words.shape[1], max_bps,
            _ptr(words), _ptr(bits), _ptr(ok),
            _stream_ptr(res.device))
    if rc != 0:
        raise RuntimeError("pack_rows kernel launch failed: CUDA error %d"
                           % (rc,))


def rice_decode(words, word_base, base_bits, k, raw_bits, count, W, out):
    """launches csrc/rice_decode.cu: decodes the records (word_base,
    base_bits, k, raw_bits, count) of a bucket with W window words
    from ``words`` into ``out`` [P, C]

    All contiguous int32 CUDA tensors on one device; the caller
    (ops/rice_decode.decode_partitions) validates the arguments."""
    import torch
    lib = load()
    (P, C) = out.shape
    with torch.cuda.device(words.device):
        rc = lib.atpu_rice_decode(
            _ptr(words), _ptr(word_base), _ptr(base_bits), _ptr(k),
            _ptr(raw_bits), _ptr(count), P, words.shape[0], W, C,
            _ptr(out), _stream_ptr(words.device))
    if rc != 0:
        raise RuntimeError("rice_decode kernel launch failed: CUDA "
                           "error %d" % (rc,))


def flac_synth(residuals, warmup, qlp, shift, order, taps, out):
    """launches csrc/flac_synth.cu: inverts the predictors of the rows
    of ``residuals`` [S, n] into ``out`` [S, n], multiplying the first
    ``taps`` coefficient columns (the rest must be 0)

    All contiguous int32 CUDA tensors on one device; the caller
    (ops/flac_synth.synthesize) validates the arguments."""
    import torch
    lib = load()
    (S, n) = residuals.shape
    with torch.cuda.device(residuals.device):
        rc = lib.atpu_flac_synth(
            _ptr(residuals), _ptr(warmup), _ptr(qlp), _ptr(shift),
            _ptr(order), S, n, qlp.shape[1], taps, _ptr(out),
            _stream_ptr(residuals.device))
    if rc != 0:
        raise RuntimeError("flac_synth kernel launch failed: CUDA "
                           "error %d" % (rc,))


def alac_synth(residuals, qlp, order, shift, sample_size, rows, max_order,
               out):
    """launches csrc/alac_synth.cu: inverts the sign-adaptive
    predictors of the rows of ``residuals`` [S, n] into ``out`` [S, n],
    a warp for each 16 entries of ``rows`` (the grouping)

    All contiguous int32 CUDA tensors on one device; the caller
    (ops/alac_synth.synthesize) validates the arguments."""
    import torch
    lib = load()
    (S, n) = residuals.shape
    with torch.cuda.device(residuals.device):
        rc = lib.atpu_alac_synth(
            _ptr(residuals), _ptr(qlp), _ptr(order), _ptr(shift),
            _ptr(sample_size), _ptr(rows), S, n, qlp.shape[1], max_order,
            rows.shape[0], _ptr(out), _stream_ptr(residuals.device))
    if rc != 0:
        raise RuntimeError("alac_synth kernel launch failed: CUDA "
                           "error %d" % (rc,))


def tta_synth(residuals, fshift, shift, out):
    """launches csrc/tta_synth.cu: inverts the hybrid filter and the
    fixed predictor of the lanes of ``residuals`` [L, n] into ``out``
    [L, n]

    Contiguous int32 CUDA tensors on one device; the caller
    (ops/tta_synth.inverse_filter_predict) validates the arguments."""
    import torch
    lib = load()
    (L, n) = residuals.shape
    with torch.cuda.device(residuals.device):
        rc = lib.atpu_tta_synth(
            _ptr(residuals), L, n, fshift, shift, _ptr(out),
            _stream_ptr(residuals.device))
    if rc != 0:
        raise RuntimeError("tta_synth kernel launch failed: CUDA "
                           "error %d" % (rc,))


def tta_filter(predicted, fshift, out):
    """launches csrc/tta_filter.cu: the TTA encoder's hybrid filter of
    the lanes of ``predicted`` [L, n] into ``out`` [L, n]

    Contiguous int32 CUDA tensors on one device; the caller
    (ops/tta_scan.hybrid_filter) validates the arguments."""
    import torch
    lib = load()
    (L, n) = predicted.shape
    with torch.cuda.device(predicted.device):
        rc = lib.atpu_tta_filter(_ptr(predicted), L, n, fshift, _ptr(out),
                                 _stream_ptr(predicted.device))
    if rc != 0:
        raise RuntimeError("tta_filter kernel launch failed: CUDA error %d"
                           % (rc,))


def wv_corr(x, meta, chain, weights, samples, out, w_out, s_out):
    """launches csrc/wv_chain.cu's encoder: the WavPack encode pass
    chains of the batch's blocks (a CUDA block each, a warp a pass) into
    ``out``, with
    each pass's final weights in ``w_out`` and new stored samples in
    ``s_out``

    Contiguous int64 CUDA tensors on one device, laid out as
    ops/wv_scan.pack_blocks gives them; the caller
    (ops/wv_scan.run_pass_chain) validates the arguments."""
    import torch
    lib = load()
    with torch.cuda.device(x.device):
        rc = lib.atpu_wv_corr(
            _ptr(x), _ptr(meta), _ptr(chain), _ptr(weights), _ptr(samples),
            meta.shape[0], _ptr(out), _ptr(w_out), _ptr(s_out),
            _stream_ptr(x.device))
    if rc != 0:
        raise RuntimeError("wv_corr kernel launch failed: CUDA error %d"
                           % (rc,))


def wv_decorr(x, meta, chain, weights, samples, out):
    """launches csrc/wv_chain.cu's decoder: the WavPack decode pass
    chains of the batch's blocks (a CUDA block each, a warp a pass) into
    ``out``

    Contiguous int64 CUDA tensors on one device, laid out as
    ops/wv_scan.pack_blocks gives them; the caller
    (ops/wv_scan.run_dec_chain) validates the arguments."""
    import torch
    lib = load()
    with torch.cuda.device(x.device):
        rc = lib.atpu_wv_decorr(
            _ptr(x), _ptr(meta), _ptr(chain), _ptr(weights), _ptr(samples),
            meta.shape[0], _ptr(out), _stream_ptr(x.device))
    if rc != 0:
        raise RuntimeError("wv_decorr kernel launch failed: CUDA error %d"
                           % (rc,))


def wv_chain_config():
    """csrc/wv_chain.cu's pipeline as built: (chunk samples, ring
    stages, 1 when the decoder's negative terms run a lane a channel
    with shuffles and 0 when one lane runs both channels)"""
    lib = load()
    vals = [ctypes.c_int() for _ in range(3)]
    lib.atpu_wv_chain_config(*(ctypes.byref(v) for v in vals))
    return tuple(v.value for v in vals)


def rice_planes(res, rows, psize, j0, out):
    """launches csrc/rice_planes.cu: the bit-plane counts and seed sum
    of the exact Rice ladder for the ``rows`` partitions of ``psize``
    residuals each in ``res`` into ``out`` [rows, j0 + 1]

    Contiguous int32 CUDA tensors on one device; the caller
    (ops/flac_frames.rice_planes) validates the arguments."""
    import torch
    lib = load()
    with torch.cuda.device(res.device):
        rc = lib.atpu_rice_planes(_ptr(res), rows, psize, j0, _ptr(out),
                                  _stream_ptr(res.device))
    if rc != 0:
        raise RuntimeError("rice_planes kernel launch failed: CUDA error %d"
                           % (rc,))
