# -*- coding: utf-8 -*-
"""A small convenience wrapper for scalar 1D spline functions (API parity
with the reference's `Spline` class)."""

import numpy as np

from . import bspline


def _derivative_data(kv, coeffs):
    """Knot vector and coefficients of the exact first derivative: for a
    degree-p spline, d/dx sum_i c_i B_{i,p} = sum_i d_i B_{i,p-1} over the
    knots with the two outermost entries dropped, where
    ``d_i = p (c_{i+1} - c_i) / (t_{i+p+1} - t_{i+1})``."""
    p = kv.p
    knots = kv.kv
    span = knots[p + 1:-1] - knots[1:-(p + 1)]
    return (bspline.KnotVector(knots[1:-1], p - 1),
            p * np.diff(coeffs) / span)


class Spline:
    """Scalar spline curve over a 1D knot vector.

    Attributes:
        kv: the :class:`~pyiga_jax.bspline.KnotVector`.
        coeffs: coefficient vector of length ``kv.numdofs``.
    """

    def __init__(self, kv, coeffs):
        coeffs = np.asarray(coeffs)
        if coeffs.shape != (kv.numdofs,):
            raise ValueError('expected %d coefficients, got shape %s'
                             % (kv.numdofs, coeffs.shape))
        self.kv = kv
        self.coeffs = coeffs

    def eval(self, x):
        """Values of the spline at the points `x`."""
        return bspline.ev(self.kv, self.coeffs, x)

    def deriv(self, x, deriv=1):
        """Values of the `deriv`-th derivative at the points `x`."""
        return bspline.deriv(self.kv, self.coeffs, deriv, x)

    def derivative(self):
        """The exact first derivative as a new degree-(p-1) :class:`Spline`."""
        return Spline(*_derivative_data(self.kv, self.coeffs))
