"""Bit-level helpers the reference gets from jax.lax.

Torch has no usable uint32 arithmetic on the CPU (shifts, adds and
compares raise), so the port carries u32 values as int64 in
[0, 2^32) and converts to int32 bit patterns only at a kernel
boundary.  ``exact_exp2`` builds powers of two from their IEEE-754
bit pattern, as the reference's ``ops/lpc.exact_exp2`` does with
``bitcast_convert_type``.
"""

from __future__ import annotations

import torch

U32_MASK = 0xFFFFFFFF


def exact_exp2(e):
    """exact 2^e (float64) for an integer-valued tensor; exponents
    clamp to the normal range [-1022, 1023]"""
    e = torch.clamp(e.to(torch.int64), -1022, 1023)
    return ((e + 1023) << 52).view(torch.float64)


def u32_to_i32(x):
    """int64 values in [0, 2^32) -> int32 with the same bit pattern"""
    return torch.where(x >= (1 << 31), x - (1 << 32), x).to(torch.int32)


def i32_to_u32(x):
    """int32 bit patterns -> int64 values in [0, 2^32)"""
    return x.to(torch.int64) & U32_MASK
