# -*- coding: utf-8 -*-
"""Double-float32 (two-float) elementwise arithmetic.

This module provides f64-accurate (~2^-48 relative) elementwise arithmetic built
from error-free transformations on float32 pairs (Dekker splitting + Knuth
two-sum; no FMA required), which XLA fuses like any other f32 elementwise
graph.

A value x is represented as ``(hi, lo)`` with ``x ~= hi + lo``,
``|lo| <= ulp(hi)/2``.  Used by ``mode='ozaki'`` for the geometry field
pipeline (det/inv/weight products); the Ozaki-split contraction (sumfac)
consumes the results.  The transformations hold only where the compiler
does not contract or reassociate them: on the CPU (fast-math off, see
:func:`pyiga_jax.config.use_x64`), not on the GPU, where they raise
(:func:`pyiga_jax.config.require_twofloat_platform`).

Range limit: Dekker splitting scales by 4097, so |x| must stay below
~2^128/4097 ~= 8.3e34 (and below f32's ~3.4e38 for the pair encoding
itself); larger magnitudes — valid in plain f64 — overflow to inf/NaN.
Well-scaled PDE data is far inside this; rescale pathological inputs
before using the pair fast path (``mode='exact'`` has no such limit).

Reference: Dekker (1971), "A floating-point technique for extending the
available precision"; the classic double-double algorithms (Hida-Li-Bailey).
"""

import jax.numpy as jnp

from .. import config

# 2^12 + 1 for f32 Dekker splitting
_SPLIT = 4097.0


def _split(a):
    config.require_twofloat_platform('two-float arithmetic')
    c = _SPLIT * a
    hi = c - (c - a)
    return hi, a - hi


def two_sum(a, b):
    """Knuth: s + err == a + b exactly (f32)."""
    config.require_twofloat_platform('two-float arithmetic')
    s = a + b
    bb = s - a
    err = (a - (s - bb)) + (b - bb)
    return s, err


def quick_two_sum(a, b):
    """Dekker: requires |a| >= |b|; s + err == a + b exactly."""
    config.require_twofloat_platform('two-float arithmetic')
    s = a + b
    return s, b - (s - a)


def two_prod(a, b):
    """p + err == a * b exactly (f32, Dekker splitting, no FMA)."""
    p = a * b
    ah, al = _split(a)
    bh, bl = _split(b)
    err = ((ah * bh - p) + ah * bl + al * bh) + al * bl
    return p, err


def df(hi, lo=None):
    """Build a two-float value."""
    return (hi, jnp.zeros_like(hi) if lo is None else lo)


def df_from_f64(x):
    """Split an f64 array into a two-float f32 pair (exact to f32-pair
    precision)."""
    hi = x.astype(jnp.float32)
    lo = (x - hi.astype(jnp.float64)).astype(jnp.float32)
    return hi, lo


def df_to_f64(a):
    return a[0].astype(jnp.float64) + a[1].astype(jnp.float64)


def df_neg(a):
    return -a[0], -a[1]


def df_abs(a):
    m = a[0] < 0
    return jnp.where(m, -a[0], a[0]), jnp.where(m, -a[1], a[1])


def df_add(a, b):
    """Accurate two-float addition (IEEE-style, safe under cancellation)."""
    s1, s2 = two_sum(a[0], b[0])
    t1, t2 = two_sum(a[1], b[1])
    s2 = s2 + t1
    s1, s2 = quick_two_sum(s1, s2)
    s2 = s2 + t2
    return quick_two_sum(s1, s2)


def df_sub(a, b):
    return df_add(a, df_neg(b))


def df_mul(a, b):
    p, e = two_prod(a[0], b[0])
    e = e + (a[0] * b[1] + a[1] * b[0])
    return quick_two_sum(p, e)


def df_div(a, b):
    """Two-float division: f32 quotient + one Newton correction step.

    Built strictly from the pair-level operations (df_mul/df_add): reusing
    raw EFT intermediates across operation boundaries invites XLA's
    multiply-add contraction to break the error-free identities (observed
    on the CPU backend under jit: 1e-14 -> 6e-8)."""
    q1 = a[0] / b[0]
    # accurate remainder r = a - q1*b
    r = df_add(a, df_neg(df_mul((q1, jnp.zeros_like(q1)), b)))
    q2 = (r[0] + r[1]) / b[0]
    return quick_two_sum(q1, q2)


def df_sum(values):
    """Sum a sequence of two-float values."""
    acc = values[0]
    for v in values[1:]:
        acc = df_add(acc, v)
    return acc


def df_sum_axis(a, axis=-1):
    """Compensated tree sum of a two-float array pair along `axis`.

    Pure f32: the axis is padded to a power of two with exact zeros and
    halved with :func:`df_add` (each level accurate to pair precision, so
    the result carries ~depth * 2^-47 relative error).  The reduced axis
    is removed.  This is the summation kernel behind the two-float dense
    matvec (ops/mg.py), as plain fusable f32."""
    hi, lo = a
    hi = jnp.moveaxis(hi, axis, -1)
    lo = jnp.moveaxis(lo, axis, -1)
    n = hi.shape[-1]
    if n == 0:
        z = jnp.zeros(hi.shape[:-1], hi.dtype)
        return z, z
    full = 1 << (n - 1).bit_length()
    if full != n:
        pad = [(0, 0)] * (hi.ndim - 1) + [(0, full - n)]
        hi, lo = jnp.pad(hi, pad), jnp.pad(lo, pad)
        n = full
    while n > 1:
        m = n // 2
        hi, lo = df_add((hi[..., :m], lo[..., :m]),
                        (hi[..., m:], lo[..., m:]))
        n = m
    return hi[..., 0], lo[..., 0]


def df_sqrt(a):
    """Two-float square root: f32 sqrt + one Newton step in pair
    arithmetic (relative accuracy ~2^-46; zero maps to zero)."""
    x = jnp.sqrt(a[0])
    r = df_add(a, df_neg(df_mul((x, jnp.zeros_like(x)), (x, jnp.zeros_like(x)))))
    denom = jnp.where(x > 0, 2.0 * x, jnp.ones_like(x))
    corr = jnp.where(x > 0, (r[0] + r[1]) / denom, jnp.zeros_like(x))
    return quick_two_sum(x, corr)


class DF:
    """Two-float value with operator overloading, so whole expression trees
    (the vform language's ``Expr.eval``) evaluate in fused f32 pair
    arithmetic with no emulated-f64 elementwise ops — the f64 fast path for
    *generic* compiled vforms (see compile.PairAsmContext; the reference
    gives every form the same fast-kernel treatment through codegen,
    /root/reference/pyiga/codegen/cython.py:673).

    Wraps an ``(hi, lo)`` pair; arithmetic delegates to the df_* functions.
    Python-float operands are split exactly; the literals 0.0/1.0 (pruned
    basis seeds) short-circuit so they do not inflate the traced graph."""

    __slots__ = ('hi', 'lo')
    __array_priority__ = 1000

    def __init__(self, hi, lo=None):
        self.hi = hi
        self.lo = jnp.zeros_like(hi) if lo is None else lo

    @property
    def pair(self):
        return (self.hi, self.lo)

    def __add__(self, other):
        if isinstance(other, (int, float)) and float(other) == 0.0:
            return self
        return DF(*df_add(self.pair, as_df(other).pair))

    __radd__ = __add__

    def __sub__(self, other):
        if isinstance(other, (int, float)) and float(other) == 0.0:
            return self
        return DF(*df_sub(self.pair, as_df(other).pair))

    def __rsub__(self, other):
        if isinstance(other, (int, float)) and float(other) == 0.0:
            return DF(*df_neg(self.pair))
        return DF(*df_sub(as_df(other).pair, self.pair))

    def __mul__(self, other):
        if isinstance(other, (int, float)):
            if float(other) == 0.0:
                return 0.0
            if float(other) == 1.0:
                return self
        return DF(*df_mul(self.pair, as_df(other).pair))

    __rmul__ = __mul__

    def __truediv__(self, other):
        if isinstance(other, (int, float)) and float(other) == 1.0:
            return self
        return DF(*df_div(self.pair, as_df(other).pair))

    def __rtruediv__(self, other):
        if isinstance(other, (int, float)) and float(other) == 0.0:
            return 0.0
        return DF(*df_div(as_df(other).pair, self.pair))

    def __neg__(self):
        return DF(*df_neg(self.pair))

    def __pos__(self):
        return self

    def __abs__(self):
        return DF(*df_abs(self.pair))


def as_df(x):
    """Promote a value to :class:`DF`: Python scalars split exactly at trace
    time (host floats, no device ops); f64 arrays split with
    :func:`df_from_f64`; f32 arrays get a zero low part."""
    if isinstance(x, DF):
        return x
    if isinstance(x, (int, float)):
        import numpy as np
        hi = np.float32(x)
        lo = np.float32(float(x) - float(hi))
        return DF(hi, lo)
    x = jnp.asarray(x)
    if x.dtype == jnp.float64:
        return DF(*df_from_f64(x))
    return DF(x.astype(jnp.float32))
