"""A dry run of the per-device steps over a list of devices.

The port's counterpart of the reference's
``__graft_entry__.dryrun_multichip`` and its two helpers: the packed
FLAC encode step on 4 frames a device, the ALAC frameset analysis, and
the FLAC decode's Rice decode and predictor synthesis, each with its
rows split over the devices (``mesh.Split``) and held element for
element against the port's plain versions on the CPU.  The
reference's full quantized-upload encode split over its mesh has no
counterpart: one encode's batches stay on one device in the port.

    python3 -c "import torch; from audiotools_tpu_torch.parallel import \\
        dryrun; dryrun.dryrun_multichip([torch.device('cuda', 0)] * 2)"
"""

from __future__ import annotations

import numpy as np
import torch

from .._device import resolve_devices
from ..ops import alac_frames, flac_frames, flac_synth, rice_decode
from ..ops import lpc as lpc_ops
from ..ref.flac_enc import TokenStream
from . import mesh

CPU = torch.device("cpu")


def signal(n_blocks, n, seed=0):
    """int32 [n_blocks, n, 2]: two correlated tones and noise"""
    rng = np.random.default_rng(seed)
    t = np.arange(n_blocks * n)
    base = (8000.0 * np.sin(t * 0.01) +
            3000.0 * np.sin(t * 0.037 + 0.5))
    left = base + rng.integers(-100, 100, n_blocks * n)
    right = 0.7 * base + rng.integers(-100, 100, n_blocks * n)
    out = np.stack([left, right], axis=1)
    return np.clip(out, -32768, 32767).astype(
        np.int32).reshape(n_blocks, n, 2)


def dryrun_multichip(devices):
    """runs each step once on tiny shapes with its rows split over
    ``devices`` and checks it against the plain versions on the CPU;
    raises AssertionError on any difference"""
    devices = resolve_devices(devices)
    D = len(devices)
    n = 256
    K = 4
    porders = flac_frames.valid_partition_orders(n, 2, max(K, 4))
    window = lpc_ops.tukey_window_df(n)

    step = mesh.sharded_packed_encode_step(
        devices, n, K, 10, porders, 14, True, bps=16, mid_side=True)
    blocks = signal(D * 4, n, seed=3)          # 4 frames a device
    (packed, total_bits) = step(blocks, window)
    host = flac_frames.analyze_frames_packed(
        torch.from_numpy(blocks), True, 16, n, K, 10, porders, 14, True,
        True, lpc_ops.window_to_torch(window, CPU)).numpy()
    if packed.shape != host.shape or not np.array_equal(packed, host):
        raise AssertionError("per-device packed decisions diverge")
    W = flac_frames.PACKED_SCALARS + K + (1 << porders[-1])
    sub_bits = sum(host[:, 1 + s * W + 5].astype(np.float64).sum()
                   for s in range(2))
    if not total_bits > 0 or total_bits != sub_bits:
        raise AssertionError("total_bits %r != the sub-bit columns' sum %r"
                             % (total_bits, sub_bits))

    _dryrun_alac(devices)
    _dryrun_decode(devices)


def _dryrun_alac(devices):
    """the ALAC frameset analysis (correlations and LPC candidates for
    every leftweight), blocks split over the devices"""
    n = 256
    blocks = signal(len(devices) * 2, n, seed=11)
    window = lpc_ops.tukey_window_df(n)
    layout = [(0, 2)]

    def compute(dev, blocks, window):
        return alac_frames.analyze_framesets_packed(
            blocks, layout, 0, 2, 0, 4, window)

    got = mesh.Split(devices, compute)([blocks], [tuple(window)])
    host = compute(CPU, torch.from_numpy(blocks),
                   lpc_ops.window_to_torch(window, CPU)).numpy()
    if not np.array_equal(got, host):
        raise AssertionError("per-device ALAC analysis diverges")


def _dryrun_decode(devices):
    """the FLAC decode's Rice decode (partition records split) and
    predictor synthesis (subframe rows split) over the devices"""
    rng = np.random.default_rng(13)
    n = 256
    S = len(devices) * 2
    k = 6

    # a Rice bitstream of S single-partition rows
    res = rng.integers(-300, 300, (S, n)).astype(np.int64)
    ts = TokenStream()
    offsets = []
    for s in range(S):
        offsets.append(ts.bits())
        for v in res[s]:
            u = int((v << 1) ^ (v >> 63)) & 0xFFFFFFFF
            ts.unary(u >> k)
            ts.write(k, u & ((1 << k) - 1))
    offsets.append(ts.bits())
    words = rice_decode.bytes_to_words(ts.to_bytes()).numpy()
    bit_off = np.asarray(offsets, dtype=np.int64)
    word_base = (bit_off[:-1] >> 5).astype(np.int32)
    base_bits = (bit_off[:-1] & 31).astype(np.int32)
    W = int(((base_bits + np.diff(bit_off) + 31) >> 5).max())
    kv = np.full(S, k, dtype=np.int32)
    raw = np.full(S, -1, dtype=np.int32)
    count = np.full(S, n, dtype=np.int32)

    def decode(dev, word_base, base_bits, kv, raw, count, words):
        return rice_decode.decode_partitions(
            words, word_base, base_bits, kv, raw, count, W, n)

    records = [word_base, base_bits, kv, raw, count]
    got = mesh.Split(devices, decode)(records, [words])
    host = decode(CPU, *[torch.from_numpy(a) for a in records],
                  torch.from_numpy(words)).numpy()
    if not np.array_equal(got, host):
        raise AssertionError("per-device Rice decode diverges")
    if not np.array_equal(got, res.astype(np.int32)):
        raise AssertionError("Rice decode gives wrong values")

    warmup = rng.integers(-500, 500, (S, flac_synth.K)).astype(np.int32)
    qlp = np.zeros((S, flac_synth.K), dtype=np.int32)
    qlp[:, 0] = 3
    qlp[:, 1] = -2
    shift = np.full(S, 1, dtype=np.int32)
    order = np.full(S, 2, dtype=np.int32)

    def synth(dev, planes, warmup, qlp, shift, order):
        return flac_synth.synthesize(planes, warmup, qlp, shift, order)

    rows = [got, warmup, qlp, shift, order]
    got2 = mesh.Split(devices, synth)(rows)
    host2 = synth(CPU, *[torch.from_numpy(a) for a in rows]).numpy()
    if not np.array_equal(got2, host2):
        raise AssertionError("per-device synthesis diverges")
