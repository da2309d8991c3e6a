# -*- coding: utf-8 -*-
"""Dense per-axis basis tables for device-side evaluation.

The reference stores per-point active-function tables and loops over joint
supports (assemble_tools.py:7, compute_values_derivs).  The formulation here
instead builds small *dense* per-axis tables ``B[d, n, Q]`` (derivative order,
basis function, Gauss point); all downstream consumers are then plain gathers
and matmuls.  Tables are tiny (n x Q per axis) and computed host-side in
float64 by the vectorized Cox-de Boor kernel.
"""

import numpy as np

from .. import bspline


def dense_basis_table(kv, grid, numderiv):
    """Dense basis table ``B[d, i, q]`` = d-th derivative of B-spline `i` of
    `kv` at ``grid[q]``; shape ``(numderiv+1, numdofs, len(grid))``."""
    grid = np.asarray(grid, dtype=float)
    Q = grid.size
    ad = bspline.active_deriv(kv, grid, numderiv)       # (nd+1, p+1, Q)
    first = bspline.findspans(kv, grid) - kv.p          # (Q,)
    B = np.zeros((numderiv + 1, kv.numdofs, Q))
    cols = np.arange(Q)
    for r in range(kv.p + 1):
        B[:, first + r, cols] = ad[:, r, :]
    return B


def dense_collocation_tables(kvs, grids, numderiv):
    """Per-axis dense basis tables for a TP space over per-axis `grids`."""
    return [dense_basis_table(kv, g, numderiv) for kv, g in zip(kvs, grids)]
