"""Deterministic double-f32 arithmetic (~45-bit precision), in torch.

Port of ``audiotools_tpu/ops/df.py``, which states the numeric spec:
a value is an (hi, lo) pair of f32-valued float64 tensors, and every
primitive is built only from a single f64 add/mul/div on f32-valued
operands followed by an immediate f32 re-round.  Those steps are part
of the spec, so they are kept one for one rather than replaced by
plain f64 arithmetic: the decisions must equal the reference's numpy
path bit for bit.

Each torch elementwise op rounds once, as numpy does.  Fused ops
(``addcmul``, ``lerp``) and ``torch.compile`` would contract a multiply
into an add and are not used here.
"""

from __future__ import annotations

import torch


def _R(x):
    """round f64 -> f32 precision, staying f64-typed"""
    return x.to(torch.float32).to(torch.float64)


def split(x):
    """exact f64 value (<= 47 significant bits) -> df pair"""
    hi = _R(x)
    lo = _R(x - hi)
    return (hi, lo)


def fast_two_sum(a, b):
    """exact renormalization of a + b for f32-valued a, b
    (magnitude-ordered Fast2Sum; see the reference for the proof)"""
    swap = torch.abs(a) < torch.abs(b)
    big = torch.where(swap, b, a)
    small = torch.where(swap, a, b)
    s = _R(big + small)
    z = s - big
    e = _R(small - z)
    return (s, e)


def add(a, b):
    """df + df"""
    (ah, al) = a
    (bh, bl) = b
    (sh, se) = fast_two_sum(ah, bh)
    t = _R(_R(se + al) + bl)
    return fast_two_sum(sh, t)


def neg(a):
    return (-a[0], -a[1])


def sub(a, b):
    return add(a, neg(b))


def mul(a, b):
    """df * df"""
    (ah, al) = a
    (bh, bl) = b
    p = ah * bh              # exact: 48-bit product of two f32s
    ph = _R(p)
    pe = p - ph              # exact, f32-valued
    cross = _R(_R(ah * bl) + _R(al * bh))
    t = _R(pe + cross)
    return fast_two_sum(ph, t)


def mul1(a, b):
    """df * f32-valued tensor"""
    (ah, al) = a
    p = ah * b               # exact
    ph = _R(p)
    pe = p - ph
    t = _R(pe + _R(al * b))
    return fast_two_sum(ph, t)


def div(a, b):
    """df / df via one Newton-style correction step (~2^-45 relative);
    a zero denominator yields 0"""
    (ah, al) = a
    (bh, bl) = b
    zero = bh == 0.0
    safe = torch.where(zero, 1.0, bh)
    q1 = _R(ah / safe)
    r = sub((ah, al), mul1((bh, bl), q1))
    q2 = _R(r[0] / safe)
    out = fast_two_sum(q1, q2)
    return (torch.where(zero, 0.0, out[0]), torch.where(zero, 0.0, out[1]))


def to_f32(a):
    """df -> f32-valued f64 (exact hi + lo, then one f32 rounding)"""
    return _R(a[0] + a[1])


def from_parts(*terms):
    """exact f64 terms -> df pair (summed hi-first, renormalized after
    each term)"""
    acc = split(terms[0])
    for t in terms[1:]:
        acc = add(acc, split(t))
    return acc
