# -*- coding: utf-8 -*-
"""Matrix-free application of Kronecker products.

API parity with /root/reference/pyiga/kronecker.py.  Dense operators reduce
to :func:`pyiga_jax.tensor.apply_tprod` (per-axis tensordots, which XLA maps
onto matmuls); sparse matrices and LinearOperators go through per-axis
matricized applications.
"""

import numpy as np
import scipy.sparse.linalg

from . import tensor


def apply_kronecker(ops, x):
    """Apply ``kron(ops[0], ..., ops[-1])`` to the vector or multi-vector `x`
    without forming the Kronecker product."""
    if all(isinstance(A, np.ndarray) for A in ops):
        return _apply_kronecker_dense(ops, x)
    ops = [scipy.sparse.linalg.aslinearoperator(B) for B in ops]
    return _apply_kronecker_linops(ops, x)


def _apply_kronecker_dense(ops, x):
    shape_in = tuple(op.shape[1] for op in ops)
    shape_out = (int(np.prod([op.shape[0] for op in ops])),) + x.shape[1:]
    assert x.ndim in (1, 2), 'Only vectors or matrices allowed as right-hand sides'
    if x.ndim == 2 and x.shape[1] > 1:
        shape_in = shape_in + (x.shape[1],)
    X = x.reshape(shape_in)
    return tensor.apply_tprod(ops, X).reshape(shape_out)


def _apply_kronecker_linops(ops, x):
    """Apply a Kronecker product of (possibly sparse) linear operators by
    reshaping into a tensor and applying one mode-k product per factor."""
    assert len(ops) >= 1, 'Empty Kronecker product'
    shape_in = tuple(op.shape[1] for op in ops)
    shape_out = (int(np.prod([op.shape[0] for op in ops])),) + x.shape[1:]
    assert int(np.prod(shape_in)) == x.shape[0], 'Wrong size for input vector'

    extra = x.shape[1:]
    X = np.asarray(x).reshape(shape_in + extra)
    for k, op in enumerate(ops):
        X = tensor.modek_tprod(op, k, X)
    return X.reshape(shape_out)
