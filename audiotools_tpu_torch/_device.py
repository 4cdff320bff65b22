"""Device selection for the PyTorch port.

Every entry point takes an explicit ``device``.  A request for CUDA on
a host without a usable card raises: the port never moves work to the
CPU behind the caller's back.  The CPU is reached only when the caller
names it (the unit tests do, to run the kernels' plain versions).
"""

from __future__ import annotations

import threading
import time

import torch

# guards the process-wide counters (each kernel wrapper's launches, the
# FLAC encoder's fallback batches, the decoders' host chunks): a bare
# += from several threads can lose an update
COUNT_LOCK = threading.Lock()


def resolve_device(device):
    """``device`` (str or torch.device) -> torch.device

    raises RuntimeError for CUDA when torch.cuda.is_available() is
    False, ValueError for a missing or unsupported device type"""
    if device is None:
        raise ValueError("device must be given explicitly "
                         "(\"cuda\" or \"cpu\")")
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "device %r requested but torch.cuda.is_available() is "
                "False" % (str(device),))
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        return device
    if device.type == "cpu":
        return device
    raise ValueError("unsupported device type %r" % (device.type,))


def resolve_devices(devices):
    """a list of devices (str or torch.device) -> a list of
    torch.device, ``[torch.device("cuda")]`` when None

    each is resolved by ``resolve_device``; a CUDA index past
    torch.cuda.device_count() raises ValueError (a device may appear
    more than once)"""
    if devices is None:
        devices = [torch.device("cuda")]
    out = [resolve_device(d) for d in devices]
    if not out:
        raise ValueError("no devices given")
    for d in out:
        if d.type == "cuda" and d.index >= torch.cuda.device_count():
            raise ValueError("device %s requested but only %d CUDA "
                             "devices exist"
                             % (d, torch.cuda.device_count()))
    return out


class StageMarks:
    """marks between a batch's device stages: CUDA events recorded on
    the current stream on a card, host clock readings on the CPU"""

    def __init__(self, device):
        self.on_cuda = device.type == "cuda"
        self.marks = []

    def mark(self):
        if self.on_cuda:
            event = torch.cuda.Event(enable_timing=True)
            event.record()
            self.marks.append(event)
        else:
            self.marks.append(time.perf_counter())

    def seconds(self):
        """the spans between consecutive marks, in seconds; on a card
        this waits for the last mark"""
        if not self.on_cuda:
            return [b - a for (a, b) in zip(self.marks, self.marks[1:])]
        self.marks[-1].synchronize()
        return [a.elapsed_time(b) / 1e3
                for (a, b) in zip(self.marks, self.marks[1:])]


def fetch_async(tensor):
    """a CUDA tensor's copy into pinned host memory, enqueued on the
    current stream (valid once the stream reaches it); a CPU tensor as
    it is"""
    if tensor.device.type != "cuda":
        return tensor
    pinned = torch.empty(tensor.shape, dtype=tensor.dtype, pin_memory=True)
    return pinned.copy_(tensor, non_blocking=True)
