"""Per-device batch steps for codec work spread over several devices.

The port of the reference's ``audiotools_tpu/parallel/mesh.py``.  There
the FLAC analysis is jitted with its row axis sharded over a 1-D device
mesh.  FLAC frames never talk to each other, so here each sharded step
is per-device batches, not SPMD: the returned function splits the row
axis into ``len(devices)`` equal slices (a row count that does not
divide raises, as the reference's sharding does), enqueues every slice
on its own device and stream before it fetches any result, and returns
the rows in order, the one reduction (``total_bits``) summed on the
host in float64.  Several processes join through ``torch.distributed``
(``init_distributed``), with rows gathered across them in rank order
(``host_local_to_global``) and sliced back (``global_to_host_local``).

``Split`` is also how ``codecs/flac_enc_fast.encode_flac_fast(...,
devices=)`` spreads one encode's batches over several devices.
Devices are an explicit list (``cuda_devices`` lists the cards); a
device may appear more than once.  A CPU device runs the plain
versions.
"""

from __future__ import annotations

import numpy as np
import torch

from .._device import fetch_async, resolve_device, resolve_devices
from ..ops import flac_frames


def cuda_devices(max_devices=None):
    """the CUDA cards, ``cuda:0`` first, at most ``max_devices`` of
    them; raises when there is no card, or when ``max_devices`` asks
    for more cards than there are"""
    resolve_device(torch.device("cuda", 0))
    count = torch.cuda.device_count()
    if max_devices is None:
        max_devices = count
    if max_devices > count:
        raise ValueError("requested %d CUDA devices but only %d exist"
                         % (max_devices, count))
    return [torch.device("cuda", i) for i in range(max_devices)]


def init_distributed(address, num_processes, process_id, backend="gloo"):
    """joins this process to a group of ``num_processes`` processes
    over ``torch.distributed``: ``address`` is the rendezvous
    (``tcp://host:port``), ``process_id`` this process's rank"""
    torch.distributed.init_process_group(
        backend, init_method=address, world_size=num_processes,
        rank=process_id)


def host_local_to_global(local_array):
    """every process's rows of ``local_array`` (equal shapes across the
    processes), concatenated in rank order: an ``all_gather`` over the
    default process group"""
    local = torch.from_numpy(np.ascontiguousarray(local_array))
    parts = [torch.empty_like(local)
             for _ in range(torch.distributed.get_world_size())]
    torch.distributed.all_gather(parts, local)
    return torch.cat(parts).numpy()


def global_to_host_local(global_array):
    """this process's rows of a global array laid out in rank order
    (the inverse of ``host_local_to_global``)"""
    size = torch.distributed.get_world_size()
    rows = global_array.shape[0]
    if rows % size:
        raise ValueError("%d rows do not split over %d processes"
                         % (rows, size))
    per = rows // size
    rank = torch.distributed.get_rank()
    return global_array[rank * per:(rank + 1) * per]


def _to_device(value, dev):
    """a numpy array (or a tuple of them) as tensors on ``dev``, from
    pinned memory on a card (asynchronous, on the current stream)"""
    if isinstance(value, tuple):
        return tuple(_to_device(v, dev) for v in value)
    tensor = torch.from_numpy(np.ascontiguousarray(value))
    if dev.type != "cuda":
        return tensor
    return tensor.pin_memory().to(dev, non_blocking=True)


class Split:
    """runs ``compute(device, *row_slices, *shared)`` on each device's
    equal slice of the rows of ``arrays``, with ``shared`` (arrays, or
    tuples of them) whole on every device: every slice is uploaded,
    computed and its outputs' fetch enqueued, each on its device's own
    stream, before any is waited for.  Outputs (a tensor or a dict of
    them) come back as numpy arrays, concatenated in row order.

    ``streams``: one per device (a CUDA stream, or None for a CPU
    device); a new stream for each CUDA device when None.  With
    ``upload=False`` compute receives the host (numpy) slices and
    ``shared`` as given, and moves them itself.  ``submit`` enqueues
    and returns at once; ``collect`` waits for what it enqueued."""

    def __init__(self, devices, compute, streams=None, upload=True):
        self.devices = resolve_devices(devices)
        self.compute = compute
        self.upload = upload
        if streams is None:
            streams = [torch.cuda.Stream(d) if d.type == "cuda" else None
                       for d in self.devices]
        self.streams = list(streams)

    def _place(self, value, dev):
        return _to_device(value, dev) if self.upload else value

    def submit(self, arrays, shared=()):
        """enqueues every slice; returns the pending list that
        ``collect`` takes: (outputs, done event or None) a slice"""
        arrays = [np.asarray(a) for a in arrays]
        rows = arrays[0].shape[0]
        D = len(self.devices)
        if rows % D or any(a.shape[0] != rows for a in arrays):
            raise ValueError("%d rows do not split over %d devices"
                             % (rows, D))
        per = rows // D
        pending = []
        for (i, (dev, stream)) in enumerate(zip(self.devices,
                                                self.streams)):
            parts = tuple(a[i * per:(i + 1) * per] for a in arrays)
            if stream is None:
                out = self.compute(dev, *self._place(parts, dev),
                                   *self._place(tuple(shared), dev))
                pending.append((out, None))
                continue
            with torch.cuda.device(dev), torch.cuda.stream(stream):
                out = self.compute(dev, *self._place(parts, dev),
                                   *self._place(tuple(shared), dev))
                out = ({k: fetch_async(v) for (k, v) in out.items()}
                       if isinstance(out, dict) else fetch_async(out))
                done = torch.cuda.Event(enable_timing=True)
                done.record(stream)
            pending.append((out, done))
        return pending

    @staticmethod
    def collect(pending):
        """waits for submit's slices; their outputs concatenated in row
        order as numpy arrays"""
        outs = []
        for (out, done) in pending:
            if done is not None:
                done.synchronize()
            outs.append(out)
        if isinstance(outs[0], dict):
            return {k: np.concatenate([o[k].numpy() for o in outs])
                    for k in outs[0]}
        return np.concatenate([o.numpy() for o in outs])

    def __call__(self, arrays, shared=()):
        return self.collect(self.submit(arrays, shared))


def sharded_analyze(devices, n, max_lpc_order, qlp_precision, porders,
                    max_rice, exhaustive):
    """FLAC subframe analysis with its rows split over ``devices``

    returns fn(X [S, n] int32, bps [S] int32, window) -> the dict of
    ``flac_frames.analyze_subframes`` as [S]-leading numpy arrays, S
    divisible by len(devices); window is ``lpc.tukey_window_df(n)``"""
    def compute(dev, X, bps, window):
        return flac_frames.analyze_subframes(
            X, bps, n, max_lpc_order, qlp_precision, list(porders),
            max_rice, exhaustive, window)

    split = Split(devices, compute)
    return lambda X, bps, window: split([X, bps], [tuple(window)])


def sharded_packed_encode_step(devices, n, max_lpc_order, qlp_precision,
                               porders, max_rice, exhaustive, bps=16,
                               mid_side=True, stereo_trial=True):
    """the encode step over packed decisions, frames split over
    ``devices``

    returns fn(blocks [B, n, ch] int, window) -> (packed [B, row]
    int32, total_bits), B divisible by len(devices); total_bits is the
    float64 sum of the sub-bit columns, the step's one reduction"""
    def compute(dev, blocks, window):
        return flac_frames.analyze_frames_packed(
            blocks, stereo_trial, bps, n, max_lpc_order, qlp_precision,
            list(porders), max_rice, exhaustive, mid_side, window)

    split = Split(devices, compute)
    W = flac_frames.PACKED_SCALARS + max(max_lpc_order, 1) + \
        (1 << porders[-1])

    def step(blocks, window):
        packed = split([blocks], [tuple(window)])
        max_subframes = (packed.shape[1] - 1) // W
        total_bits = sum(packed[:, 1 + s * W + 5].astype(np.float64).sum()
                         for s in range(max_subframes))
        return (packed, float(total_bits))

    return step


def sharded_encode_step(devices, n, max_lpc_order, qlp_precision, porders,
                        max_rice, exhaustive):
    """the analysis of ``sharded_analyze`` with the stream statistic the
    serializer needs

    returns fn(X, bps, window) -> (the analysis dict, total_bits), the
    float64 sum of every row's sub_bits"""
    analyze = sharded_analyze(devices, n, max_lpc_order, qlp_precision,
                              porders, max_rice, exhaustive)

    def step(X, bps, window):
        out = analyze(X, bps, window)
        return (out, float(out["sub_bits"].astype(np.float64).sum()))

    return step
