"""Device selection for the PyTorch port.

Every entry point takes an explicit ``device``.  A request for CUDA on
a host without a usable card raises: the port never moves work to the
CPU behind the caller's back.  The CPU is reached only when the caller
names it (the unit tests do, to run the kernels' plain versions).
"""

from __future__ import annotations

import torch


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
