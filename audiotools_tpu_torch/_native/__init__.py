"""The port's host C++ library: FLAC, ALAC, TTA, Shorten and WavPack host
kernels, the quantized upload wire's scans (``flac_qpack``,
``flac_qpack_patched``, ``flac_qplan_t``), the converters' host twins,
and MD5.

``hostkernels.cpp`` beside this file is a copy of the FLAC, ALAC, TTA,
Shorten, WavPack, converter, CRC and MD5 parts of the reference
package's host library; the wrappers here are the reference's (``audiotools_tpu/_native``),
for the entry points the port calls, with the port's own ``shn_header``
and ``shn_warm_chain``.  The ``wv_*`` wrappers hold the ctypes calls that
the reference makes inline in its ``ref/wavpack.py``.  The library compiles with g++ on
first use into the package's ``build/`` directory; its name carries a
hash of the source, and it is written to a temporary file first and
renamed into place, so that several processes may build it at once.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "hostkernels.cpp")
BUILD_DIR = os.path.join(os.path.dirname(_HERE), "build")
GXX_FLAGS = ["-O3", "-march=native", "-funroll-loops", "-shared", "-fPIC",
             "-std=c++17", "-fno-exceptions"]

_lib = None
# one thread builds and binds the library; the others wait for it
_load_lock = threading.Lock()

_I32 = ctypes.POINTER(ctypes.c_int32)
_I64 = ctypes.POINTER(ctypes.c_int64)
_U8 = ctypes.POINTER(ctypes.c_uint8)
_U32 = ctypes.POINTER(ctypes.c_uint32)
_F64 = ctypes.POINTER(ctypes.c_double)


class CapacityError(ValueError):
    """a single FLAC frame exceeded the scan's partition capacity;
    the caller decodes that stream on the host path instead"""


class EmitOverflow(ValueError):
    """the decision array implied more output bytes than the emitter's
    worst-case buffer"""


def _build():
    with open(_SRC, "rb") as f:
        digest = hashlib.sha256(f.read())
    digest.update(" ".join(GXX_FLAGS).encode())
    so_path = os.path.join(BUILD_DIR, "libatpu_host-%s.so"
                           % digest.hexdigest()[:16])
    if os.path.exists(so_path):
        return so_path
    os.makedirs(BUILD_DIR, exist_ok=True)
    # named for this process and thread: another process may be
    # building the same library at once
    tmp_path = "%s.%d.%d.tmp" % (so_path, os.getpid(),
                                 threading.get_ident())
    flags = GXX_FLAGS
    proc = subprocess.run(["g++"] + flags + ["-o", tmp_path, _SRC],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        # targets g++ cannot tune for
        flags = [f for f in flags if f != "-march=native"]
        proc = subprocess.run(["g++"] + flags + ["-o", tmp_path, _SRC],
                              capture_output=True, text=True)
    if proc.returncode != 0:
        raise ImportError("failed to build the port's host library:\n"
                          + proc.stderr)
    os.replace(tmp_path, so_path)
    return so_path


def get_lib():
    """the loaded host library, built on first use; safe to call from
    several threads at once (one builds, the rest wait)"""
    global _lib
    if _lib is not None:
        return _lib
    with _load_lock:
        if _lib is None:
            _lib = _bind(ctypes.CDLL(_build()))
    return _lib


def _bind(lib):
    """declares the argument and result types of the library's entry
    points; returns it"""

    lib.atpu_flac_decode.restype = ctypes.c_int64
    lib.atpu_flac_decode.argtypes = [
        _U8,                # data
        ctypes.c_int64,     # data_len
        ctypes.c_int32,     # stream_bps
        ctypes.c_int32,     # stream_channels
        ctypes.c_int64,     # max_samples
        _I32,               # out_samples
        _I64,               # consumed_bytes
        ctypes.c_int32,     # verify_crc
        _U8,                # md5_state (nullable)
    ]

    lib.atpu_flac_scan.restype = ctypes.c_int64
    lib.atpu_flac_scan.argtypes = [
        _U8,                # data
        ctypes.c_int64,     # data_len
        ctypes.c_int32,     # stream_bps
        ctypes.c_int32,     # stream_channels
        ctypes.c_int64,     # max_samples
        ctypes.c_int32,     # max_frames
        ctypes.c_int32,     # max_parts
        ctypes.c_int32,     # verify_crc
        ctypes.c_int32,     # chunk_codes
        _I32,               # frame_meta [max_frames, 4]
        _I32,               # sub_meta [max_frames*8, 8]
        _I32,               # warmup [max_frames*8, 32]
        _I32,               # qlp [max_frames*8, 32]
        _I32,               # part_meta [max_parts, 8]
        _I64,               # counts [6]
    ]

    emit_args = [
        _I32,               # blocks [F, max_block, ch]
        _I64,               # frame_numbers
        _I32,               # block_sizes
        _I32,               # packed decisions
        ctypes.c_int64,     # n_frames
        ctypes.c_int32,     # max_subframes
        ctypes.c_int32,     # max_order
        ctypes.c_int32,     # max_partitions
        ctypes.c_int32,     # max_block
        ctypes.c_int32,     # sample_rate
        ctypes.c_int32,     # stream_bps
        ctypes.c_int32,     # stream_channels
        ctypes.c_int32,     # qlp_precision
        ctypes.c_int32,     # compact row layout flag
    ]
    lib.atpu_flac_emit_frames2.restype = ctypes.c_int64
    lib.atpu_flac_emit_frames2.argtypes = emit_args + [
        ctypes.c_int32,     # emit_max_rice (-1 = off)
        _I32,               # probe_thr [F] (nullable)
        _U8,                # probe_out [F] (nullable)
        _U8,                # out
        _I64,               # out_lens (cumulative ends)
        ctypes.c_int64,     # out_capacity
    ]
    lib.atpu_flac_emit_frames2rb.restype = ctypes.c_int64
    lib.atpu_flac_emit_frames2rb.argtypes = emit_args + [
        _U8,                # out
        _I64,               # out_lens (cumulative ends)
        ctypes.c_int64,     # out_capacity
        _U32,               # rb_words
        _I64,               # rb_bits
        ctypes.c_int64,     # rb_stride
    ]

    lib.atpu_alac_emit_framesets.restype = ctypes.c_int64
    lib.atpu_alac_emit_framesets.argtypes = [
        ctypes.POINTER(ctypes.c_int32),   # blocks [B, max_n, ch]
        ctypes.POINTER(ctypes.c_int32),   # ns [B]
        ctypes.c_int64,                   # n_blocks
        ctypes.POINTER(ctypes.c_int32),   # layout_off [G]
        ctypes.POINTER(ctypes.c_int32),   # layout_w [G]
        ctypes.c_int32,                   # n_groups
        ctypes.POINTER(ctypes.c_int32),   # packed [B,G,5,2,15]
        ctypes.c_int32,                   # ch_total
        ctypes.c_int32,                   # max_n
        ctypes.c_int32,                   # block_size
        ctypes.c_int32,                   # initial_history
        ctypes.c_int32,                   # history_multiplier
        ctypes.c_int32,                   # maximum_k
        ctypes.c_int32,                   # interlacing_shift
        ctypes.c_int32,                   # min_lw
        ctypes.c_int32,                   # max_lw
        ctypes.c_int32,                   # bps
        ctypes.POINTER(ctypes.c_uint8),   # out
        ctypes.POINTER(ctypes.c_int64),   # out_ends
    ]

    lib.atpu_alac_decode.restype = ctypes.c_int64
    lib.atpu_alac_decode.argtypes = [
        ctypes.POINTER(ctypes.c_uint8),   # data
        ctypes.c_int64,                   # len
        ctypes.c_int32,                   # bps
        ctypes.c_int32,                   # channels
        ctypes.c_int32,                   # samples_per_frame
        ctypes.c_int32,                   # initial_history
        ctypes.c_int32,                   # history_multiplier
        ctypes.c_int32,                   # maximum_k
        ctypes.c_int64,                   # max_frames
        ctypes.POINTER(ctypes.c_int32),   # out
        ctypes.POINTER(ctypes.c_int64),   # consumed
    ]

    lib.atpu_alac_scan.restype = ctypes.c_int64
    lib.atpu_alac_scan.argtypes = [
        ctypes.POINTER(ctypes.c_uint8),   # data
        ctypes.c_int64,                   # len
        ctypes.c_int32,                   # bps
        ctypes.c_int32,                   # channels
        ctypes.c_int32,                   # samples_per_frame
        ctypes.c_int32,                   # initial_history
        ctypes.c_int32,                   # history_multiplier
        ctypes.c_int32,                   # maximum_k
        ctypes.c_int64,                   # max_frames
        ctypes.c_int64,                   # max_subs
        ctypes.POINTER(ctypes.c_int32),   # res_out
        ctypes.POINTER(ctypes.c_int32),   # sub_meta
        ctypes.POINTER(ctypes.c_int32),   # qlp_out
        ctypes.POINTER(ctypes.c_int32),   # pair_meta
        ctypes.POINTER(ctypes.c_int32),   # lsb_out
        ctypes.POINTER(ctypes.c_int32),   # fs_count
        ctypes.POINTER(ctypes.c_int64),   # info
    ]

    lib.atpu_tta_encode_frames.restype = ctypes.c_int64
    lib.atpu_tta_encode_frames.argtypes = [
        ctypes.POINTER(ctypes.c_int32),   # samples [total, ch]
        ctypes.POINTER(ctypes.c_int32),   # frame_sizes
        ctypes.c_int64,                   # n_tta_frames
        ctypes.c_int32,                   # channels
        ctypes.c_int32,                   # bps
        ctypes.POINTER(ctypes.c_uint8),   # out
        ctypes.c_int64,                   # out_cap
        ctypes.POINTER(ctypes.c_int64),   # out_ends
    ]

    lib.atpu_tta_pack_frames.restype = ctypes.c_int64
    lib.atpu_tta_pack_frames.argtypes = [
        ctypes.POINTER(ctypes.c_int32),   # residuals [total, ch]
        ctypes.POINTER(ctypes.c_int32),   # frame_sizes
        ctypes.c_int64,                   # n_tta_frames
        ctypes.c_int32,                   # channels
        ctypes.POINTER(ctypes.c_uint8),   # out
        ctypes.c_int64,                   # out_cap
        ctypes.POINTER(ctypes.c_int64),   # out_ends
    ]

    lib.atpu_tta_decode_frame.restype = ctypes.c_int64
    lib.atpu_tta_decode_frame.argtypes = [
        ctypes.POINTER(ctypes.c_uint8),   # data
        ctypes.c_int64,                   # len
        ctypes.c_int64,                   # n
        ctypes.c_int32,                   # channels
        ctypes.c_int32,                   # bps
        ctypes.POINTER(ctypes.c_int32),   # out
        ctypes.c_int32,                   # verify_crc
    ]

    lib.atpu_tta_scan_residuals.restype = ctypes.c_int64
    lib.atpu_tta_scan_residuals.argtypes = [
        ctypes.POINTER(ctypes.c_uint8),   # data (concatenated frames)
        ctypes.c_int64,                   # len
        ctypes.POINTER(ctypes.c_int64),   # frame_lens
        ctypes.POINTER(ctypes.c_int32),   # frame_sizes
        ctypes.c_int64,                   # n_tta_frames
        ctypes.c_int32,                   # channels
        ctypes.POINTER(ctypes.c_int32),   # out [total, ch]
        ctypes.c_int32,                   # verify_crc
    ]

    lib.atpu_shn_encode2.restype = ctypes.c_int64
    lib.atpu_shn_encode2.argtypes = [
        _I32,               # samples [n, ch]
        ctypes.c_int64,     # n
        ctypes.c_int32,     # channels
        ctypes.c_int32,     # bps
        ctypes.c_int32,     # signed_samples
        ctypes.c_int32,     # is_big_endian
        _U8, ctypes.c_int64,    # header_data, header_len
        _U8, ctypes.c_int64,    # footer_data, footer_len
        ctypes.c_int32,     # block_size
        _I32,               # decisions [nblocks, ch, 4] (nullable)
        _U8,                # out
    ]
    lib.atpu_shn_decode.restype = ctypes.c_int64
    lib.atpu_shn_decode.argtypes = [_U8, ctypes.c_int64, ctypes.c_int64,
                                    _I32, _I64]
    lib.atpu_shn_header.restype = ctypes.c_int64
    lib.atpu_shn_header.argtypes = [_U8, ctypes.c_int64, _I64, _U8,
                                    ctypes.c_int64]
    lib.atpu_shn_scan.restype = ctypes.c_int64
    lib.atpu_shn_scan.argtypes = [
        _U8, ctypes.c_int64,    # data, len
        ctypes.c_int64,     # max_rows
        ctypes.c_int64,     # max_block
        _I32,               # residuals [max_rows, max_block]
        _I32,               # row_meta [max_rows, 4]
        _I64,               # info [5]
    ]
    lib.atpu_shn_split.restype = ctypes.c_int64
    lib.atpu_shn_split.argtypes = [_U8, ctypes.c_int64, _U8, ctypes.c_int64,
                                   _U8, ctypes.c_int64, _I64]
    lib.atpu_shn_warm_chain.restype = ctypes.c_int64
    lib.atpu_shn_warm_chain.argtypes = [
        _I32,               # residuals [rows, width]
        _I32,               # row_meta [rows, 4]
        ctypes.c_int64,     # rows
        ctypes.c_int64,     # width
        ctypes.c_int32,     # channels
        _I64,               # warm [rows, 3]
    ]

    lib.atpu_wv_crc.restype = ctypes.c_uint32
    lib.atpu_wv_crc.argtypes = [_I32, ctypes.c_int64]
    wv_pass_args = (
        [_I64] * 2 +        # ch0, ch1 (in/out)
        [ctypes.c_int64, ctypes.c_int32, ctypes.c_int32,
         ctypes.c_int32] +  # n, channel_count, term, delta
        [_I64] * 3)         # weights, per-channel samples
    lib.atpu_wv_correlate.restype = ctypes.c_int32
    lib.atpu_wv_correlate.argtypes = wv_pass_args
    lib.atpu_wv_decorrelate.restype = ctypes.c_int32
    lib.atpu_wv_decorrelate.argtypes = wv_pass_args
    lib.atpu_wv_write_bitstream.restype = ctypes.c_int64
    lib.atpu_wv_write_bitstream.argtypes = [
        _I64, _I64, ctypes.c_int64, ctypes.c_int32, _I64, _U8,
        ctypes.c_int64]
    lib.atpu_wv_read_bitstream.restype = ctypes.c_int64
    lib.atpu_wv_read_bitstream.argtypes = [
        _U8, ctypes.c_int64, ctypes.c_int64, ctypes.c_int32, _I64, _I64,
        _I64]

    lib.atpu_resample_fir.restype = None
    lib.atpu_resample_fir.argtypes = [
        _F64, ctypes.c_int64, ctypes.c_int32, _I64, _I32, _F64,
        ctypes.c_int32, ctypes.c_int64, _F64]
    lib.atpu_accuraterip_update.restype = None
    lib.atpu_accuraterip_update.argtypes = [
        _I32, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_int64, _U32, _U32]
    lib.atpu_iir.restype = None
    lib.atpu_iir.argtypes = [_F64, _F64, ctypes.c_int32, _F64, _F64,
                             ctypes.c_int64, _F64]

    lib.atpu_md5_init.restype = None
    lib.atpu_md5_init.argtypes = [_U8]
    lib.atpu_md5_update.restype = None
    lib.atpu_md5_update.argtypes = [_U8, _U8, ctypes.c_int64]
    lib.atpu_md5_update_pcm.restype = None
    lib.atpu_md5_update_pcm.argtypes = [_U8, _I32, ctypes.c_int64,
                                        ctypes.c_int32, ctypes.c_int32]
    lib.atpu_md5_final.restype = None
    lib.atpu_md5_final.argtypes = [_U8, _U8]

    lib.atpu_flac_qplan.restype = ctypes.c_int32
    lib.atpu_flac_qplan.argtypes = [
        _I32,               # blocks [B, n, ch]
        ctypes.c_int64,     # B
        ctypes.c_int64,     # n
        ctypes.c_int64,     # ch
        ctypes.c_int32,     # bps
        ctypes.c_int32,     # guard
        ctypes.c_int32,     # cap_margin
        ctypes.c_int32,     # noise_extra
        ctypes.c_int32,     # stereo_trial
        _I32,               # t_out [B, ch]
        _I32,               # x0_out [B, ch]
        _I32,               # or_out [B, V]
        _U8,                # const_out [B, V]
        _U8,                # md5_state (nullable)
    ]
    lib.atpu_flac_qpack_bits.restype = None
    lib.atpu_flac_qpack_bits.argtypes = [
        _I32, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
        _I32,               # t [B, ch]
        ctypes.c_int32,     # k
        _U32,               # packed [B, ch, W]
        ctypes.c_int64,     # W
    ]
    lib.atpu_flac_qpack_bits2.restype = ctypes.c_int32
    lib.atpu_flac_qpack_bits2.argtypes = [
        _I32, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
        _I32,               # t [B, ch]
        ctypes.c_int32,     # k_base
        _U32,               # packed [B, ch, W]
        ctypes.c_int64,     # W
        ctypes.c_int32,     # E
        _I32,               # exc_pos [B, ch, E]
        _U32,               # exc_val [B, ch, E]
    ]

    return lib


def _as_ptr(array, ctype):
    return array.ctypes.data_as(ctypes.POINTER(ctype))


def flac_emit_frames2(blocks, frame_numbers, block_sizes, packed,
                      max_subframes, max_order, max_partitions,
                      sample_rate, stream_bps, stream_channels,
                      qlp_precision, compact=False,
                      rb_words=None, rb_bits=None,
                      emit_max_rice=None, probe_thr=None, probe_out=None):
    """emits FLAC frames from raw PCM blocks + packed decision rows

    blocks: int32 [n_frames, max_block, channels] interleaved PCM
    packed: int32 decision rows (the compact layout with compact=True)
    rb_words/rb_bits: optional device-packed residual partition blocks,
            uint32 [n_frames * max_subframes, rb_stride] big-endian
            word rows + exact bit lengths: FIXED/LPC subframes splice
            these bits instead of re-deriving residuals on the host
    emit_max_rice: emit-stage exact Rice re-search bound; None derives
            14/30 from stream_bps when ATPU_EMIT_EXACT_RICE is active
            (the default), -1 disables.  Ignored on the splice path.
    probe_thr/probe_out: optional int32 [n_frames] / uint8 [n_frames],
            the quantization-floor retry's second stage, read off the
            exact residuals the emitter derives: a frame with
            probe_thr >= 0 and a coded subframe whose mean |residual|
            bit length is <= probe_thr gets probe_out 1 (the caller
            zeroes probe_out).  Ignored on the splice path.
    returns (frame bytes, per-frame byte lengths int64 array)"""
    lib = get_lib()
    if emit_max_rice is None:
        from ..ref.flac_enc import emit_exact_rice_enabled
        emit_max_rice = ((14 if stream_bps <= 16 else 30)
                         if emit_exact_rice_enabled() else -1)

    blocks = np.ascontiguousarray(blocks, dtype=np.int32)
    frame_numbers = np.ascontiguousarray(frame_numbers, dtype=np.int64)
    block_sizes = np.ascontiguousarray(block_sizes, dtype=np.int32)
    packed = np.ascontiguousarray(packed, dtype=np.int32)
    n_frames = len(frame_numbers)
    max_block = blocks.shape[1]

    worst = int(n_frames) * (max_block * max_subframes * 5 + 1024)
    out = np.empty(worst, dtype=np.uint8)
    out_ends = np.empty(n_frames, dtype=np.int64)
    common = (_as_ptr(blocks, ctypes.c_int32),
              _as_ptr(frame_numbers, ctypes.c_int64),
              _as_ptr(block_sizes, ctypes.c_int32),
              _as_ptr(packed, ctypes.c_int32),
              n_frames, max_subframes, max_order, max_partitions,
              max_block, sample_rate, stream_bps, stream_channels,
              qlp_precision, 1 if compact else 0)

    if rb_words is not None:
        rb_words = np.ascontiguousarray(rb_words, dtype=np.uint32)
        rb_bits = np.ascontiguousarray(rb_bits, dtype=np.int64)
        if rb_words.shape[0] != n_frames * max_subframes:
            raise ValueError("rb_words row count mismatch")
        total = lib.atpu_flac_emit_frames2rb(
            *common, _as_ptr(out, ctypes.c_uint8),
            _as_ptr(out_ends, ctypes.c_int64), worst,
            _as_ptr(rb_words, ctypes.c_uint32),
            _as_ptr(rb_bits, ctypes.c_int64), rb_words.shape[1])
    else:
        if probe_thr is not None:
            probe_thr = np.ascontiguousarray(probe_thr, dtype=np.int32)
        total = lib.atpu_flac_emit_frames2(
            *common, int(emit_max_rice),
            None if probe_thr is None else _as_ptr(probe_thr,
                                                   ctypes.c_int32),
            None if probe_out is None else _as_ptr(probe_out,
                                                   ctypes.c_uint8),
            _as_ptr(out, ctypes.c_uint8),
            _as_ptr(out_ends, ctypes.c_int64), worst)
    if total == -31:
        raise EmitOverflow(
            "frame emit overflow: decision array implies more than "
            "%d bytes (analysis produced unsafe Rice parameters)"
            % (worst,))
    if total < 0:
        raise ValueError("frame emit error (code %d)" % (total,))
    lens = np.diff(np.concatenate([[0], out_ends]))
    return (out[:total].tobytes(), lens)


def _qplan(blocks, bps, guard, cap_margin, noise_extra, stereo_trial,
           md5):
    """the plan scan: (blocks int32 [B, n, ch], raw wire width, t, x0,
    or_vals, const_flags)"""
    from ..ops import qpack
    if guard is None:
        guard = qpack.guard_bits()
    if cap_margin is None:
        cap_margin = qpack.cap_margin()
    if noise_extra is None:
        noise_extra = qpack.noise_extra()
    lib = get_lib()
    blocks = np.ascontiguousarray(blocks, dtype=np.int32)
    (B, n, ch) = blocks.shape
    stereo = bool(stereo_trial and ch == 2)
    V = 4 if stereo else ch
    t = np.empty((B, ch), dtype=np.int32)
    x0 = np.empty((B, ch), dtype=np.int32)
    or_vals = np.empty((B, V), dtype=np.int32)
    const_flags = np.empty((B, V), dtype=np.uint8)
    k = lib.atpu_flac_qplan(
        _as_ptr(blocks, ctypes.c_int32), B, n, ch, int(bps), int(guard),
        int(cap_margin), int(noise_extra), 1 if stereo else 0,
        _as_ptr(t, ctypes.c_int32), _as_ptr(x0, ctypes.c_int32),
        _as_ptr(or_vals, ctypes.c_int32),
        _as_ptr(const_flags, ctypes.c_uint8),
        None if md5 is None else _as_ptr(md5._state, ctypes.c_uint8))
    return (blocks, int(k), t, x0, or_vals, const_flags.astype(bool))


def flac_qpack(blocks, bps, guard, stereo_trial, cap_margin=None,
               md5=None, noise_extra=None):
    """plans and bit-packs the plain quantized upload wire
    (ops/qpack.py) in one scan of the samples

    blocks: int32 [B, n, ch] exact samples; md5: an MD5 that the stream
    hash of these samples is folded into during the scan, or None;
    cap_margin, noise_extra: ops/qpack's settings when None.  Returns
    (packed uint32 [B, ch, W], k, t int32 [B, ch], x0 int32 [B, ch],
    or_vals int32 [B, V], const_flags bool [B, V]), the words those of
    ops/qpack.pack"""
    from ..ops import qpack
    (blocks, k, t, x0, or_vals, const_flags) = _qplan(
        blocks, bps, guard, cap_margin, noise_extra, stereo_trial, md5)
    (B, n, ch) = blocks.shape
    if n > 1:
        k = qpack.round_k(k)
    W = ((n - 1) * k + 31) // 32 + 1 if n > 1 else 1
    packed = np.zeros((B, ch, W), dtype=np.uint32)
    if n > 1:
        get_lib().atpu_flac_qpack_bits(
            _as_ptr(blocks, ctypes.c_int32), B, n, ch,
            _as_ptr(t, ctypes.c_int32), int(k),
            _as_ptr(packed, ctypes.c_uint32), W)
    return (packed, int(k), t, x0, or_vals, const_flags)


def flac_qpack_patched(blocks, bps, guard, stereo_trial, k_base, E,
                       cap_margin=None, md5=None, noise_extra=None):
    """flac_qpack's scan with the patched-base wire: every difference
    packed at ``k_base`` (None: one K_GRID step below the plain width),
    the wider values as at most ``E`` (position, value) exceptions per
    (block, channel); n must exceed 1

    returns (packed uint32 [B, ch, W], k_full, t, x0, or_vals,
    const_flags, exc_pos int32 [B, ch, E], exc_val uint32 [B, ch, E],
    max_exc, kb): k_full the plain wire's width, kb the base width
    used.  max_exc > E means the words and exceptions are not valid."""
    from ..ops import qpack
    (blocks, k_raw, t, x0, or_vals, const_flags) = _qplan(
        blocks, bps, guard, cap_margin, noise_extra, stereo_trial, md5)
    (B, n, ch) = blocks.shape
    if n <= 1:
        raise ValueError("patched qpack wire requires n > 1")
    k_full = qpack.round_k(k_raw)
    if k_base is None:
        below = [g for g in qpack.K_GRID if g < k_full]
        k_base = below[-1] if below else k_full
    kb = min(int(k_base), k_full)
    W = ((n - 1) * kb + 31) // 32 + 1
    packed = np.zeros((B, ch, W), dtype=np.uint32)
    exc_pos = np.empty((B, ch, E), dtype=np.int32)
    exc_val = np.empty((B, ch, E), dtype=np.uint32)
    max_exc = get_lib().atpu_flac_qpack_bits2(
        _as_ptr(blocks, ctypes.c_int32), B, n, ch,
        _as_ptr(t, ctypes.c_int32), kb,
        _as_ptr(packed, ctypes.c_uint32), W, int(E),
        _as_ptr(exc_pos, ctypes.c_int32), _as_ptr(exc_val, ctypes.c_uint32))
    return (packed, k_full, t, x0, or_vals, const_flags, exc_pos, exc_val,
            int(max_exc), kb)


def flac_qplan_t(blocks, bps, guard=None, cap_margin=None, noise_extra=0):
    """the quantization shift t of each (block, channel) alone, from the
    plan scan (ops/qpack.plan_t's spec); noise_extra=0 gives the base
    plan the floor retry's first stage compares against"""
    return _qplan(blocks, bps, guard, cap_margin, noise_extra, False,
                  None)[2]


def flac_decode(data, stream_bps, stream_channels, max_samples,
                verify_crc=True, md5=None):
    """decodes FLAC frame data

    md5: optional MD5 instance; when given, the decoded samples are
    folded into it inside the native loop

    returns (samples int32 [frames, channels], consumed_bytes)"""
    lib = get_lib()
    buf = np.frombuffer(data, dtype=np.uint8)
    out = np.empty(max_samples * stream_channels, dtype=np.int32)
    consumed = ctypes.c_int64(0)
    decoded = lib.atpu_flac_decode(
        _as_ptr(buf, ctypes.c_uint8), len(buf), stream_bps,
        stream_channels, max_samples, _as_ptr(out, ctypes.c_int32),
        ctypes.byref(consumed), 1 if verify_crc else 0,
        (_as_ptr(md5._state, ctypes.c_uint8) if md5 is not None
         else None))
    if decoded < 0:
        raise ValueError("truncated or corrupt FLAC stream "
                         "(native code %d)" % (decoded,))
    return (out[:decoded * stream_channels].reshape(-1, stream_channels),
            consumed.value)


def flac_scan(data, stream_bps, stream_channels, max_samples,
              max_frames, max_parts, verify_crc=True, chunk_codes=0):
    """structural scan of FLAC frame data for the device decode path

    Parses frames (validating CRC-8/16) and records predictor metadata
    and residual-partition bit spans without extracting residuals.
    chunk_codes > 0 splits every residual run into records of at most
    chunk_codes codes with exact bit offsets, breaking at destination
    multiples of chunk_codes.

    returns a dict of numpy arrays:
      frame_meta [F, 4]  {block_size, assignment, bps, byte_len}
      sub_meta   [S, 8]  {frame_idx, type, order, wasted, shift, ebps,
                          const_val, porder}
      warmup     [S, 32], qlp [S, 32]
      part_meta  [P, 8]  {sub_idx, dest_off, count, rice_k, raw_bits,
                          bit_off, bit_len, 0}
      consumed_bytes, total_pcm_frames
    raises CapacityError when the first frame exceeds max_parts and
    ValueError on a corrupt stream"""
    lib = get_lib()
    buf = np.frombuffer(data, dtype=np.uint8)
    frame_meta = np.zeros((max_frames, 4), dtype=np.int32)
    sub_meta = np.zeros((max_frames * 8, 8), dtype=np.int32)
    warmup = np.zeros((max_frames * 8, 32), dtype=np.int32)
    qlp = np.zeros((max_frames * 8, 32), dtype=np.int32)
    part_meta = np.zeros((max_parts, 8), dtype=np.int32)
    counts = np.zeros(6, dtype=np.int64)
    rc = lib.atpu_flac_scan(
        _as_ptr(buf, ctypes.c_uint8), len(buf),
        stream_bps, stream_channels, max_samples,
        max_frames, max_parts, 1 if verify_crc else 0, int(chunk_codes),
        _as_ptr(frame_meta, ctypes.c_int32),
        _as_ptr(sub_meta, ctypes.c_int32),
        _as_ptr(warmup, ctypes.c_int32),
        _as_ptr(qlp, ctypes.c_int32),
        _as_ptr(part_meta, ctypes.c_int32),
        _as_ptr(counts, ctypes.c_int64))
    if rc == -30:
        raise CapacityError("frame exceeds scan partition capacity")
    if rc < 0:
        raise ValueError("truncated or corrupt FLAC stream "
                         "(native code %d)" % (rc,))
    (n_frames, n_subs, n_parts, consumed, total_pcm, _) = counts
    return {
        "frame_meta": frame_meta[:n_frames],
        "sub_meta": sub_meta[:n_subs],
        "warmup": warmup[:n_subs],
        "qlp": qlp[:n_subs],
        "part_meta": part_meta[:n_parts],
        "consumed_bytes": int(consumed),
        "total_pcm_frames": int(total_pcm),
    }


def alac_emit_framesets(blocks, ns, layout, packed,
                        block_size, initial_history,
                        history_multiplier, maximum_k,
                        interlacing_shift, min_lw, max_lw, bps):
    """emits ALAC framesets from raw PCM + packed LPC candidates

    blocks: int32 [B, max_n, ch] wave-order PCM
    packed: int32 [B, G, 5, 2, 15] LPC candidate rows (device output)
    returns (frameset bytes, per-frameset byte sizes int64 array)"""

    lib = get_lib()
    blocks = np.ascontiguousarray(blocks, dtype=np.int32)
    ns = np.ascontiguousarray(ns, dtype=np.int32)
    packed = np.ascontiguousarray(packed, dtype=np.int32)
    (B, max_n, ch) = blocks.shape
    layout_off = np.asarray([off for (off, _w) in layout],
                            dtype=np.int32)
    layout_w = np.asarray([w for (_off, w) in layout], dtype=np.int32)

    worst = int(B) * (max_n * ch * ((bps // 8) + 2) + 256)
    out = np.empty(worst, dtype=np.uint8)
    out_ends = np.empty(B, dtype=np.int64)

    total = lib.atpu_alac_emit_framesets(
        _as_ptr(blocks, ctypes.c_int32),
        _as_ptr(ns, ctypes.c_int32),
        B,
        _as_ptr(layout_off, ctypes.c_int32),
        _as_ptr(layout_w, ctypes.c_int32),
        len(layout),
        _as_ptr(packed, ctypes.c_int32),
        ch, max_n, block_size, initial_history, history_multiplier,
        maximum_k, interlacing_shift, min_lw, max_lw, bps,
        _as_ptr(out, ctypes.c_uint8),
        _as_ptr(out_ends, ctypes.c_int64))
    if total < 0:
        raise ValueError("ALAC emit error (code %d)" % (total,))
    lens = np.diff(np.concatenate([[0], out_ends]))
    return (out[:total].tobytes(), lens)


def alac_decode(data, bps, channels, samples_per_frame,
                initial_history, history_multiplier, maximum_k,
                max_frames):
    """decodes ALAC framesets into int32 [frames, channels] wave order

    returns (samples, consumed_bytes)"""

    lib = get_lib()
    buf = np.frombuffer(data, dtype=np.uint8)
    out = np.empty(max_frames * channels, dtype=np.int32)
    consumed = ctypes.c_int64(0)
    decoded = lib.atpu_alac_decode(
        _as_ptr(buf, ctypes.c_uint8), len(buf),
        bps, channels, samples_per_frame,
        initial_history, history_multiplier, maximum_k,
        max_frames,
        _as_ptr(out, ctypes.c_int32),
        ctypes.byref(consumed))
    if decoded < 0:
        raise ValueError("truncated or corrupt ALAC stream "
                         "(native code %d)" % (decoded,))
    return (out[:decoded * channels].reshape(-1, channels),
            consumed.value)


def alac_scan(data, bps, channels, samples_per_frame,
              initial_history, history_multiplier, maximum_k,
              max_frames, max_subs):
    """structural scan for the device ALAC decode path

    returns a dict of numpy arrays (see atpu_alac_scan's layout doc):
    residuals [n_subs, spf], sub_meta [n_subs, 8], qlp [n_subs, 32],
    pair_meta [n_pairs, 8], lsbs [n_pairs, spf, 2],
    fs_count [n_fs], total_frames, consumed_bytes"""

    lib = get_lib()
    buf = np.frombuffer(data, dtype=np.uint8)
    spf = samples_per_frame
    res = np.zeros((max_subs, spf), dtype=np.int32)
    sub_meta = np.zeros((max_subs, 8), dtype=np.int32)
    qlp = np.zeros((max_subs, 32), dtype=np.int32)
    max_pairs = max_subs
    pair_meta = np.zeros((max_pairs, 8), dtype=np.int32)
    lsbs = np.zeros((max_pairs, spf, 2), dtype=np.int32)
    fs_count = np.zeros(max_subs, dtype=np.int32)
    info = np.zeros(5, dtype=np.int64)
    rc = lib.atpu_alac_scan(
        _as_ptr(buf, ctypes.c_uint8), len(buf),
        bps, channels, samples_per_frame,
        initial_history, history_multiplier, maximum_k,
        max_frames, max_subs,
        _as_ptr(res, ctypes.c_int32),
        _as_ptr(sub_meta, ctypes.c_int32),
        _as_ptr(qlp, ctypes.c_int32),
        _as_ptr(pair_meta, ctypes.c_int32),
        _as_ptr(lsbs, ctypes.c_int32),
        _as_ptr(fs_count, ctypes.c_int32),
        _as_ptr(info, ctypes.c_int64))
    if rc < 0:
        raise ValueError("truncated or corrupt ALAC stream "
                         "(native scan code %d)" % (rc,))
    (n_subs, n_pairs, n_fs, total, consumed) = (
        int(info[0]), int(info[1]), int(info[2]), int(info[3]),
        int(info[4]))
    return {
        "residuals": res[:n_subs],
        "sub_meta": sub_meta[:n_subs],
        "qlp": qlp[:n_subs],
        "pair_meta": pair_meta[:n_pairs],
        "lsbs": lsbs[:n_pairs],
        "fs_count": fs_count[:n_fs],
        "total_frames": total,
        "consumed_bytes": consumed,
    }


def tta_scan_residuals(data, frame_lens, frame_sizes, channels,
                       verify_crc=True):
    """entropy-unpacks concatenated TTA frames (adaptive Rice +
    CRC-32) WITHOUT the filter chain — the device decode path's host
    half (ops/tta_synth.py inverts the filters)

    returns int32 [total, channels] residuals"""
    lib = get_lib()
    buf = np.frombuffer(bytes(data), dtype=np.uint8)
    frame_lens = np.ascontiguousarray(frame_lens, dtype=np.int64)
    frame_sizes = np.ascontiguousarray(frame_sizes, dtype=np.int32)
    total = int(frame_sizes.sum())
    out = np.empty((total, channels), dtype=np.int32)
    rc = lib.atpu_tta_scan_residuals(
        _as_ptr(buf, ctypes.c_uint8), len(buf),
        _as_ptr(frame_lens, ctypes.c_int64),
        _as_ptr(frame_sizes, ctypes.c_int32),
        len(frame_sizes), channels,
        _as_ptr(out, ctypes.c_int32),
        1 if verify_crc else 0)
    if rc < 0:
        raise ValueError("truncated or corrupt TTA stream "
                         "(native code %d)" % (rc,))
    return out


def _tta_frames_call(fn, values, frame_sizes, first_cap):
    """runs a TTA frame writer, doubling the output buffer while it
    reports -54 (too small); returns (bytes, per-frame byte sizes)"""
    values = np.ascontiguousarray(values, dtype=np.int32)
    frame_sizes = np.ascontiguousarray(frame_sizes, dtype=np.int32)
    F = len(frame_sizes)
    cap = first_cap + 64 * F + 1024
    out_ends = np.empty(F, dtype=np.int64)
    while True:
        out = np.empty(cap, dtype=np.uint8)
        total = fn(_as_ptr(values, ctypes.c_int32),
                   _as_ptr(frame_sizes, ctypes.c_int32), F,
                   _as_ptr(out, ctypes.c_uint8), cap,
                   _as_ptr(out_ends, ctypes.c_int64))
        if total != -54:
            break
        cap *= 2
    if total < 0:
        raise ValueError("TTA encode error (code %d)" % (total,))
    lens = np.diff(np.concatenate([[0], out_ends]))
    return (out[:total].tobytes(), lens)


def tta_encode_frames(samples, frame_sizes, channels, bps):
    """encodes TTA frames from int32 [total, ch] PCM

    returns (bytes, per-frame byte sizes int64 array)"""
    lib = get_lib()
    return _tta_frames_call(
        lambda v, s, F, out, cap, ends: lib.atpu_tta_encode_frames(
            v, s, F, channels, bps, out, cap, ends),
        samples, frame_sizes, np.size(samples) * ((bps // 8) + 2))


def tta_pack_frames(residuals, frame_sizes, channels):
    """packs precomputed TTA filter residuals (the back half of the
    device encode, ops/tta_scan.analyze_frames) with the adaptive Rice
    coder + per-frame CRC-32

    residuals: int32 [total, ch]; returns (bytes, per-frame sizes)"""
    lib = get_lib()
    return _tta_frames_call(
        lambda v, s, F, out, cap, ends: lib.atpu_tta_pack_frames(
            v, s, F, channels, out, cap, ends),
        residuals, frame_sizes, np.size(residuals) * 6)


def tta_decode_frame(data, n, channels, bps, verify_crc=True):
    """decodes one TTA frame of n PCM frames

    returns (samples int32 [n, ch], consumed_bytes)"""
    lib = get_lib()
    buf = np.frombuffer(bytes(data), dtype=np.uint8)
    out = np.empty(n * channels, dtype=np.int32)
    consumed = lib.atpu_tta_decode_frame(
        _as_ptr(buf, ctypes.c_uint8), len(buf), n, channels, bps,
        _as_ptr(out, ctypes.c_int32), 1 if verify_crc else 0)
    if consumed < 0:
        raise ValueError("truncated or corrupt TTA stream "
                         "(native code %d)" % (consumed,))
    return (out.reshape(n, channels), consumed)


def shn_encode(samples, bps, signed_samples, is_big_endian,
               header_data, footer_data=b"", block_size=256,
               decisions=None):
    """encodes a complete Shorten stream from int32 [n, ch] PCM

    decisions: optional int32 [nblocks, ch, 4] analysis steering
    (ops/shn_scan.py layout); None computes decisions in C++"""
    lib = get_lib()
    samples = np.ascontiguousarray(samples, dtype=np.int32)
    (n, ch) = samples.shape
    header = np.frombuffer(bytes(header_data), dtype=np.uint8)
    footer = np.frombuffer(bytes(footer_data), dtype=np.uint8)
    worst = (samples.size * ((bps // 8) + 2) +
             8 * (len(header) + len(footer)) + 4096)
    out = np.empty(worst, dtype=np.uint8)
    if decisions is not None:
        decisions = np.ascontiguousarray(decisions, dtype=np.int32)
        nblocks = -(-n // block_size) if block_size else 0
        if decisions.shape != (nblocks, ch, 4):
            raise ValueError("decision array shape mismatch")
        dec_ptr = _as_ptr(decisions, ctypes.c_int32)
    else:
        dec_ptr = ctypes.POINTER(ctypes.c_int32)()
    total = lib.atpu_shn_encode2(
        _as_ptr(samples, ctypes.c_int32), n, ch, bps,
        1 if signed_samples else 0,
        1 if is_big_endian else 0,
        _as_ptr(header, ctypes.c_uint8), len(header),
        _as_ptr(footer, ctypes.c_uint8), len(footer),
        block_size,
        dec_ptr,
        _as_ptr(out, ctypes.c_uint8))
    if total < 0:
        raise ValueError("Shorten encode error (code %d)" % (total,))
    return out[:total].tobytes()


def shn_decode(data, max_frames, channels):
    """decodes a complete Shorten stream

    returns (samples int32 [frames, channels], file_type, bps)"""
    lib = get_lib()
    buf = np.frombuffer(bytes(data), dtype=np.uint8)
    info = np.zeros(4, dtype=np.int64)
    out = np.empty(max_frames * channels, dtype=np.int32)
    frames = lib.atpu_shn_decode(
        _as_ptr(buf, ctypes.c_uint8), len(buf), max_frames,
        _as_ptr(out, ctypes.c_int32),
        _as_ptr(info, ctypes.c_int64))
    if frames < 0:
        raise ValueError("truncated or corrupt Shorten stream "
                         "(native code %d)" % (frames,))
    channels = int(info[0])
    return (out[:frames * channels].reshape(-1, channels),
            int(info[1]), int(info[3]))


class ShnDeviceUnsupported(ValueError):
    """the Shorten stream uses features (QLPC, DIFF0-with-means,
    energy > 30) the device decode path does not cover; callers
    decode on the host path instead"""


def shn_header(data):
    """a Shorten stream's header fields and leading container bytes:
    dict of file_type, channels, block_size, max_lpc, n_means and head,
    the bytes of the stream's first command when that is a VERBATIM
    chunk (else b""); ValueError when the bytes are not a Shorten v2
    stream or end inside that much"""
    lib = get_lib()
    buf = np.frombuffer(bytes(data), dtype=np.uint8)
    info = np.zeros(6, dtype=np.int64)
    head = np.empty(1 << 16, dtype=np.uint8)
    while True:
        rc = lib.atpu_shn_header(_as_ptr(buf, ctypes.c_uint8), len(buf),
                                 _as_ptr(info, ctypes.c_int64),
                                 _as_ptr(head, ctypes.c_uint8), len(head))
        if rc < 0:
            raise ValueError("invalid Shorten header (native code %d)"
                             % (rc,))
        if info[5] <= len(head):
            break
        head = np.empty(int(info[5]), dtype=np.uint8)
    out = dict(zip(("file_type", "channels", "block_size", "max_lpc",
                    "n_means"), (int(v) for v in info[:5])))
    out["head"] = head[:max(int(info[5]), 0)].tobytes()
    return out


def shn_scan(data, max_rows=None, max_block=None):
    """residual-only entropy scan for the SHN device decode path

    returns (residuals int32 [rows, max_block],
             row_meta int32 [rows, 4] {cmd, block_len, shift, chan},
             info dict) or raises ShnDeviceUnsupported"""
    lib = get_lib()
    buf = np.frombuffer(bytes(data), dtype=np.uint8)
    if max_block is None or max_rows is None:
        # size the row planes from the header's block_size (a
        # mid-stream FN_BLOCKSIZE beyond it returns -81 -> host path)
        hdr_block = max(shn_header(data)["block_size"], 1)
        if max_block is None:
            max_block = hdr_block
        if max_rows is None:
            # every residual costs >= 1 bit, so the stream length
            # bounds rows at 8*len/block (+ slack for short blocks);
            # FN_ZERO blocks cost only ~3 bits though, so -81
            # capacity overflows retry below with 8x more rows (up
            # to a ~512 MB residual-plane cap) before giving up
            max_rows = (len(buf) * 8) // hdr_block + 256
    row_cap = max((1 << 27) // max(max_block, 1), 1024)
    while True:
        residuals = np.empty((max_rows, max_block), dtype=np.int32)
        row_meta = np.empty((max_rows, 4), dtype=np.int32)
        info = np.zeros(5, dtype=np.int64)
        rows = lib.atpu_shn_scan(
            _as_ptr(buf, ctypes.c_uint8), len(buf),
            max_rows, max_block,
            _as_ptr(residuals, ctypes.c_int32),
            _as_ptr(row_meta, ctypes.c_int32),
            _as_ptr(info, ctypes.c_int64))
        if rows == -81 and max_rows < row_cap:
            max_rows = min(max_rows * 8, row_cap)
            continue
        break
    if rows == -80 or rows == -81:
        raise ShnDeviceUnsupported(
            "stream outside device decode coverage (code %d)"
            % (rows,))
    if rows < 0:
        raise ValueError("truncated or corrupt Shorten stream "
                         "(native code %d)" % (rows,))
    return (residuals[:rows], row_meta[:rows], {
        "channels": int(info[0]),
        "file_type": int(info[1]),
        "bps": int(info[2]),
        "sign_adjustment": int(info[3]),
        "total_frames": int(info[4]),
    })


def shn_warm_chain(res, row_meta, channels):
    """the device decode's warm-up chain: int64 [rows, 3], for each row
    of ``shn_scan``'s output the previous same-channel block's last
    three pre-shift samples, newest first (see atpu_shn_warm_chain)"""
    lib = get_lib()
    res = np.ascontiguousarray(res, dtype=np.int32)
    row_meta = np.ascontiguousarray(row_meta, dtype=np.int32)
    (rows, width) = res.shape
    if row_meta.shape != (rows, 4):
        raise ValueError("row_meta must be [rows, 4]")
    warm = np.empty((rows, 3), dtype=np.int64)
    rc = lib.atpu_shn_warm_chain(
        _as_ptr(res, ctypes.c_int32), _as_ptr(row_meta, ctypes.c_int32),
        rows, width, channels, _as_ptr(warm, ctypes.c_int64))
    if rc < 0:
        raise ValueError("row_meta names a channel or a block length out "
                         "of range")
    return warm


def shn_split(data):
    """returns the (head, tail) VERBATIM container bytes of a
    Shorten stream without decoding samples"""
    lib = get_lib()
    buf = np.frombuffer(bytes(data), dtype=np.uint8)
    cap = max(len(buf), 1 << 16)
    head = np.empty(cap, dtype=np.uint8)
    tail = np.empty(cap, dtype=np.uint8)
    sizes = np.zeros(2, dtype=np.int64)
    rc = lib.atpu_shn_split(
        _as_ptr(buf, ctypes.c_uint8), len(buf),
        _as_ptr(head, ctypes.c_uint8), cap,
        _as_ptr(tail, ctypes.c_uint8), cap,
        _as_ptr(sizes, ctypes.c_int64))
    if rc < 0:
        raise ValueError("truncated or corrupt Shorten stream "
                         "(native code %d)" % (rc,))
    return (head[:sizes[0]].tobytes(), tail[:sizes[1]].tobytes())


def wv_crc(channels):
    """the WavPack block CRC of 1 or 2 channels of samples"""
    flat = np.ascontiguousarray(
        np.stack([np.asarray(c, dtype=np.int64) for c in channels],
                 axis=1).reshape(-1).astype(np.int32))
    return int(get_lib().atpu_wv_crc(_as_ptr(flat, ctypes.c_int32),
                                     flat.size))


def _wv_pass(fn, channels, term, delta, weights, samples):
    """runs one WavPack decorrelation pass (encode or decode direction)
    over copies of 1 or 2 channels; returns (channels, weights,
    samples), the last two as the C++ leaves them"""
    cc = len(channels)
    c0 = np.array(channels[0], dtype=np.int64)
    c1 = (np.array(channels[1], dtype=np.int64) if cc == 2
          else np.zeros(1, dtype=np.int64))
    w = np.asarray(list(weights) + [0] * (2 - len(weights)),
                   dtype=np.int64)
    h0 = np.array(samples[0], dtype=np.int64)
    h1 = (np.array(samples[1], dtype=np.int64)
          if (cc == 2 and len(samples) > 1)
          else np.zeros(max(len(h0), 1), dtype=np.int64))
    rc = fn(_as_ptr(c0, ctypes.c_int64), _as_ptr(c1, ctypes.c_int64),
            len(c0), cc, term, delta, _as_ptr(w, ctypes.c_int64),
            _as_ptr(h0, ctypes.c_int64), _as_ptr(h1, ctypes.c_int64))
    if rc != 0:
        raise ValueError("decorrelation error (code %d)" % (rc,))
    return ([c0, c1][:cc], [int(v) for v in w[:cc]], [h0, h1][:cc])


def wv_correlate(channels, term, delta, weights, samples):
    """one WavPack encode decorrelation pass (atpu_wv_correlate) over
    1 or 2 int64 channels with their weights and stored samples (terms
    17/18: [2], newest first; 1-8: [term], oldest first; negative
    terms, two channels only: [1]); returns (correlated channels, final
    weights, new stored samples), the inputs left as they were"""
    return _wv_pass(get_lib().atpu_wv_correlate, channels, term, delta,
                    weights, samples)


def wv_decorrelate(channels, term, delta, weights, samples):
    """one WavPack decode decorrelation pass (atpu_wv_decorrelate),
    with the layouts of wv_correlate; returns the decorrelated
    channels"""
    return _wv_pass(get_lib().atpu_wv_decorrelate, channels, term, delta,
                    weights, samples)[0]


def wv_write_bitstream(channels, entropies):
    """the WavPack adaptive-medians residual coder over 1 or 2 int64
    channels; entropies, [[3], [3]], are updated in place; returns the
    coded bytes"""
    cc = len(channels)
    c0 = np.ascontiguousarray(channels[0], dtype=np.int64)
    c1 = (np.ascontiguousarray(channels[1], dtype=np.int64) if cc == 2
          else np.zeros(1, dtype=np.int64))
    ent = np.asarray(list(entropies[0]) + list(entropies[1]),
                     dtype=np.int64)
    cap = len(c0) * 64 * cc + 1024
    out = np.empty(cap, dtype=np.uint8)
    total = get_lib().atpu_wv_write_bitstream(
        _as_ptr(c0, ctypes.c_int64), _as_ptr(c1, ctypes.c_int64), len(c0),
        cc, _as_ptr(ent, ctypes.c_int64), _as_ptr(out, ctypes.c_uint8),
        cap)
    if total < 0:
        raise ValueError("bitstream error (code %d)" % (total,))
    entropies[0][0:3] = [int(v) for v in ent[0:3]]
    entropies[1][0:3] = [int(v) for v in ent[3:6]]
    return out[:total].tobytes()


def wv_read_bitstream(data, n, channel_count, entropies):
    """reads n residuals a channel of a WavPack bitstream sub-block;
    entropies, [[3], [3]], are updated in place; returns a list of
    channel_count int64 arrays"""
    buf = np.frombuffer(bytes(data), dtype=np.uint8)
    ent = np.asarray(list(entropies[0]) + list(entropies[1]),
                     dtype=np.int64)
    out0 = np.zeros(n, dtype=np.int64)
    out1 = np.zeros(n if channel_count == 2 else 1, dtype=np.int64)
    consumed = get_lib().atpu_wv_read_bitstream(
        _as_ptr(buf, ctypes.c_uint8), len(buf), n, channel_count,
        _as_ptr(ent, ctypes.c_int64), _as_ptr(out0, ctypes.c_int64),
        _as_ptr(out1, ctypes.c_int64))
    if consumed < 0:
        raise ValueError("bitstream error (code %d)" % (consumed,))
    entropies[0][0:3] = [int(v) for v in ent[0:3]]
    entropies[1][0:3] = [int(v) for v in ent[3:6]]
    return [out0, out1][:channel_count]


def resample_fir(hist, starts, q, bank):
    """polyphase FIR: out[m] = bank[q[m]] . hist[starts[m]:+taps]

    hist: float64 [n, ch]; starts: int64 [M]; q: int32 [M];
    bank: float64 [n_phases, taps].  Returns float64 [M, ch].  Raises
    ValueError when a window or a phase lies outside its array."""
    hist = np.ascontiguousarray(hist, dtype=np.float64)
    starts = np.ascontiguousarray(starts, dtype=np.int64)
    q = np.ascontiguousarray(q, dtype=np.int32)
    bank = np.ascontiguousarray(bank, dtype=np.float64)
    (n, ch) = hist.shape
    (n_phases, taps) = bank.shape
    m_count = starts.shape[0]
    if q.shape != (m_count,):
        raise ValueError("starts and q differ in length")
    if m_count and (starts.min() < 0 or starts.max() + taps > n or
                    q.min() < 0 or q.max() >= n_phases):
        raise ValueError("a window or a phase lies outside its array")
    out = np.empty((m_count, ch), dtype=np.float64)
    get_lib().atpu_resample_fir(
        _as_ptr(hist, ctypes.c_double), n, ch,
        _as_ptr(starts, ctypes.c_int64), _as_ptr(q, ctypes.c_int32),
        _as_ptr(bank, ctypes.c_double), taps, m_count,
        _as_ptr(out, ctypes.c_double))
    return out


def accuraterip_update(samples, first_index, start_offset, end_offset,
                       v1, v2):
    """folds int32 [n, 2] samples into AccurateRip V1/V2 accumulators;
    samples[0] is the track's frame ``first_index`` (from 1), and frames
    in [start_offset, end_offset] count

    returns the updated (v1, v2) 32-bit values"""
    samples = np.ascontiguousarray(samples, dtype=np.int32)
    if samples.ndim != 2 or samples.shape[1] != 2:
        raise ValueError("samples must be int32 [n, 2]")
    c1 = ctypes.c_uint32(v1)
    c2 = ctypes.c_uint32(v2)
    get_lib().atpu_accuraterip_update(
        _as_ptr(samples, ctypes.c_int32), samples.shape[0], first_index,
        start_offset, end_offset, ctypes.byref(c1), ctypes.byref(c2))
    return (c1.value, c2.value)


def iir(b, a, x, zi):
    """the IIR filter (b, a) over x from state zi, direct form II
    transposed: returns (y, zf), float64

    b and a hold the same number n >= 2 of coefficients, a[0] == 1;
    zi holds n - 1 values"""
    b = np.ascontiguousarray(b, dtype=np.float64)
    a = np.ascontiguousarray(a, dtype=np.float64)
    x = np.ascontiguousarray(x, dtype=np.float64)
    z = np.array(zi, dtype=np.float64)
    if len(b) < 2 or a.shape != b.shape or z.shape != (len(b) - 1,):
        raise ValueError("b and a need n >= 2 coefficients, zi n - 1")
    y = np.empty_like(x)
    get_lib().atpu_iir(_as_ptr(b, ctypes.c_double),
                       _as_ptr(a, ctypes.c_double), len(b),
                       _as_ptr(x, ctypes.c_double),
                       _as_ptr(y, ctypes.c_double), len(x),
                       _as_ptr(z, ctypes.c_double))
    return (y, z)


class MD5:
    """a hashlib-like MD5 which hashes int32 PCM without byte copies"""

    def __init__(self):
        self._state = np.zeros(128, dtype=np.uint8)
        self._lib = get_lib()
        self._lib.atpu_md5_init(_as_ptr(self._state, ctypes.c_uint8))

    def update(self, data):
        buf = np.frombuffer(data, dtype=np.uint8)
        self._lib.atpu_md5_update(
            _as_ptr(self._state, ctypes.c_uint8),
            _as_ptr(buf, ctypes.c_uint8), len(buf))

    def update_pcm(self, samples, bits_per_sample, is_signed=True):
        """hashes int32 samples as packed little-endian PCM"""
        samples = np.ascontiguousarray(samples, dtype=np.int32)
        self._lib.atpu_md5_update_pcm(
            _as_ptr(self._state, ctypes.c_uint8),
            _as_ptr(samples, ctypes.c_int32),
            samples.size, bits_per_sample // 8,
            1 if is_signed else 0)

    def digest(self):
        out = np.zeros(16, dtype=np.uint8)
        self._lib.atpu_md5_final(
            _as_ptr(self._state, ctypes.c_uint8),
            _as_ptr(out, ctypes.c_uint8))
        return out.tobytes()
