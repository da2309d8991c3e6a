# -*- coding: utf-8 -*-
"""Matrix-free matvec on the compact multilevel-banded data tensor.

Replaces the serial Cython kernels ``ml_matvec_2d/3d``
(/root/reference/pyiga/mlmatrix_cy.pyx:224/295 — whose OpenMP version is
disabled because ``+=`` is not thread-safe).  Here the matvec is
data-parallel by construction:

    y[i_1..i_d] = sum_{s: i(s)=i} data[s_1..s_d] * x[j(s_1)..j(s_d)]

implemented as one gather per axis (``take``), an elementwise multiply, and
one sorted segment-sum per axis.  All steps are XLA-native and fuse well;
FLOPs = 2*nnz, bandwidth-bound as expected for a sparse matvec.
"""

import jax
import jax.numpy as jnp
import numpy as np


def ml_matvec(data, bidx, shape_out, shape_in, x, sorted_rows=None):
    """Apply the compact multilevel matrix to `x`.

    Args:
        data: compact tensor ``(nnz_1, ..., nnz_d)``.
        bidx: per-level ``(nnz_k, 2)`` integer arrays (i, j pairs), sorted by i.
        shape_out / shape_in: per-level output/input sizes.
        x: input tensor of shape `shape_in` (or raveled vector).

    Returns the output tensor of shape `shape_out`.
    """
    d = len(bidx)
    if sorted_rows is None:
        sorted_rows = [bool(np.all(np.diff(bx[:, 0].astype(np.int64)) >= 0))
                       for bx in bidx]
    x = jnp.reshape(x, tuple(shape_in))
    t = x
    for k in range(d):
        jj = jnp.asarray(bidx[k][:, 1].astype(np.int64))
        t = jnp.take(t, jj, axis=k)
    t = t * data
    for k in range(d):
        ii = jnp.asarray(bidx[k][:, 0].astype(np.int64))
        t = jnp.moveaxis(t, k, 0)
        t = jax.ops.segment_sum(t, ii, num_segments=shape_out[k],
                                indices_are_sorted=sorted_rows[k])
        t = jnp.moveaxis(t, 0, k)
    return t


class _MLMatvecOperator:
    """Operand-protocol matvec over a compact data tensor: the (large)
    data array travels as a jit ARGUMENT.  A plain closure would bake it
    into the compiled program as a constant, which bloats compile time and
    the compile cache at production sizes."""

    def __init__(self, data, bidx, shape_out, shape_in):
        self.operands = {'data': data}
        self.shape = (int(np.prod(shape_out)), int(np.prod(shape_in)))

        def apply_with_operands(operands, x):
            y = ml_matvec(operands['data'], bidx, shape_out, shape_in, x)
            return jnp.reshape(y, (-1,))

        self.apply_with_operands = apply_with_operands
        self._jit_apply = jax.jit(apply_with_operands)

    def matvec(self, x):
        return self._jit_apply(self.operands, x)

    def __call__(self, x):
        return self.matvec(x)


def make_ml_matvec(mlm):
    """Device matvec operator over an
    :class:`~pyiga_jax.mlmatrix.MLMatrix`: maps raveled vectors to raveled
    vectors (operand protocol; suitable for
    :func:`pyiga_jax.solvers.cg_jit`)."""
    S = mlm.structure
    return _MLMatvecOperator(jnp.asarray(mlm.data), S.bidx,
                             tuple(b[0] for b in S.bs),
                             tuple(b[1] for b in S.bs))
