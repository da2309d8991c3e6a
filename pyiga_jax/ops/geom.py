# -*- coding: utf-8 -*-
"""Device-side geometry fields on tensor-product Gauss grids.

The reference precomputes geometry Jacobians with numpy and then runs a
per-Gauss-point Cython kernel (``precompute_fields``, codegen/cython.py:673).
Here the whole field computation is one traced JAX function: per-axis dense
basis tables contract against the geometry coefficients (matmuls), then
pointwise det/inv/weight algebra runs vectorized over the grid.

Layout rule: all component axes come FIRST, so the grid axes are the
contiguous trailing ones: values are ``(dim, Q_1, ..., Q_d)``, Jacobians
``(dim, sdim, Q_1, ..., Q_d)``.


Internal axis convention: everything is in *level order* (axis k of the grid
corresponds to ``kvs[k]``); geometry output components are reversed from the
XYZ storage order into level order on entry so that Jacobians are square
matrices in one consistent ordering.  Determinants are invariant under the
simultaneous row/column reversal.
"""

import jax.numpy as jnp
import numpy as np

from .. import geometry
from .basis import dense_collocation_tables
from .sumfac import _dot_precision


def tp_apply(tables, coeffs, lead=0):
    """Contract per-axis tables ``T_k (Q_k, n_k)`` against axes
    ``lead..lead+d-1`` of `coeffs`; the contracted axes become the trailing
    grid axes ``(Q_1, ..., Q_d)`` in order."""
    d = len(tables)
    X = coeffs
    for k in range(d):
        X = jnp.moveaxis(jnp.tensordot(tables[k], X, axes=(1, lead + k),
                                       precision=_dot_precision(X.dtype)),
                         0, lead + k)
    return X


def geo_eval_tables(geo, grids, numderiv=1):
    """Host-side setup: dense per-axis basis tables of the geometry space on
    the given grids, plus the (homogeneous, level-ordered, component-leading)
    coefficients.

    Returns ``(tables, coeffs, is_nurbs)`` where tables[k] has shape
    ``(numderiv+1, Q_k, n_k)`` and coeffs has shape ``(C, n_1, ..., n_d)``."""
    if isinstance(geo, geometry.NurbsFunc):
        coeffs, is_nurbs = geo.coeffs, True      # homogeneous coords incl. weight
    elif isinstance(geo, geometry.BSplineFunc):
        coeffs, is_nurbs = geo.coeffs, False
        if coeffs.ndim == geo.sdim:              # scalar-valued: add axis
            coeffs = coeffs[..., None]
    else:
        return None     # unstructured function: caller falls back to host eval
    tables = [np.ascontiguousarray(B.swapaxes(-2, -1))     # (nd+1, Q, n)
              for B in dense_collocation_tables(geo.kvs, grids, numderiv)]
    # reverse vector components into level order (weight stays last for NURBS)
    if is_nurbs:
        coeffs = np.concatenate(
            (coeffs[..., -2::-1], coeffs[..., -1:]), axis=-1)
    else:
        coeffs = coeffs[..., ::-1]
    # components to the front: (C, n_1, ..., n_d)
    coeffs = np.ascontiguousarray(np.moveaxis(coeffs, -1, 0))
    return tables, coeffs, is_nurbs


def geo_jacobian_field(tables, coeffs, is_nurbs, sdim):
    """Traced: values and Jacobians of the geometry on the TP grid.

    Returns ``(val, jac)`` with shapes ``(dim,) + grid`` and
    ``(dim, sdim) + grid``; components and derivative axes in level order."""
    val_tabs = [t[0] for t in tables]
    der_tabs = [t[1] for t in tables]
    val = tp_apply(val_tabs, coeffs, lead=1)        # (C, Q...)
    jac_cols = []
    for k in range(sdim):
        ops = [der_tabs[j] if j == k else val_tabs[j] for j in range(sdim)]
        jac_cols.append(tp_apply(ops, coeffs, lead=1))
    jac = jnp.stack(jac_cols, axis=1)               # (C, sdim, Q...)

    if is_nurbs:
        V, W = val[:-1], val[-1:]
        Vj, Wj = jac[:-1], jac[-1:]
        val = V / W
        jac = (Vj * W[:, None] - V[:, None] * Wj) / (W[:, None] ** 2)
    return val, jac


def geo_hessian_field(tables, coeffs, is_nurbs, sdim):
    """Traced: parametric Hessians of the geometry on the TP grid.

    Requires tables with ``numderiv >= 2``.  Returns an array of shape
    ``(dim, sdim, sdim) + grid`` (symmetric in the two derivative axes),
    everything in level order, components leading."""
    val_tabs = [t[0] for t in tables]
    der_tabs = [t[1] for t in tables]
    d2_tabs = [t[2] for t in tables]

    def deriv_combo(D):
        ops = []
        for j in range(sdim):
            ops.append((val_tabs, der_tabs, d2_tabs)[D[j]][j])
        return tp_apply(ops, coeffs, lead=1)

    # build upper triangle, mirror symmetric entries
    H = [[None] * sdim for _ in range(sdim)]
    for i in range(sdim):
        for j in range(i, sdim):
            D = sdim * [0]
            D[i] += 1
            D[j] += 1
            H[i][j] = deriv_combo(D)        # (C, Q...)
            H[j][i] = H[i][j]
    hess = jnp.stack([jnp.stack(row, axis=1) for row in H], axis=1)
    # hess: (C, sdim, sdim, Q...)

    if not is_nurbs:
        return hess

    # NURBS: second-order quotient rule.
    val = tp_apply(val_tabs, coeffs, lead=1)
    jac = jnp.stack([deriv_1(val_tabs, der_tabs, coeffs, k, sdim)
                     for k in range(sdim)], axis=1)
    V, W = val[:-1], val[-1:]
    Vj, Wj = jac[:-1], jac[-1:]
    Nj = (Vj * W[:, None] - V[:, None] * Wj) / (W[:, None] ** 2)
    Vh, Wh = hess[:-1], hess[-1:]
    W2 = W[:, None, None]
    part1 = Vh / W2 - V[:, None, None] * Wh / (W2 ** 2)
    # sym(jac(V/W) (x) jac(W)) / W
    mat = (Nj[:, :, None] * Wj[:, None, :]) / W2
    mat = mat + jnp.swapaxes(mat, 1, 2)
    return part1 - mat


def deriv_1(val_tabs, der_tabs, coeffs, k, sdim):
    ops = [der_tabs[j] if j == k else val_tabs[j] for j in range(sdim)]
    return tp_apply(ops, coeffs, lead=1)


def det_and_inv(J):
    """Determinant and inverse of small (1x1/2x2/3x3) matrices stored
    component-leading: ``J (d, d) + grid``.  Explicit adjugate formulas (like
    the reference's unrolled kernels, assemble_tools_cy.pyx:210).

    Returns ``(det, inv)`` with shapes ``grid`` and ``(d, d) + grid``."""
    d = J.shape[0]
    if d == 1:
        det = J[0, 0]
        return det, (1.0 / det)[None, None]
    if d == 2:
        a, b = J[0, 0], J[0, 1]
        c, e = J[1, 0], J[1, 1]
        det = a * e - b * c
        inv = jnp.stack([jnp.stack([e, -b]), jnp.stack([-c, a])]) / det
        return det, inv
    if d == 3:
        c00 = J[1, 1] * J[2, 2] - J[1, 2] * J[2, 1]
        c01 = J[1, 2] * J[2, 0] - J[1, 0] * J[2, 2]
        c02 = J[1, 0] * J[2, 1] - J[1, 1] * J[2, 0]
        det = J[0, 0] * c00 + J[0, 1] * c01 + J[0, 2] * c02
        adj = jnp.stack([
            jnp.stack([c00,
                       J[0, 2] * J[2, 1] - J[0, 1] * J[2, 2],
                       J[0, 1] * J[1, 2] - J[0, 2] * J[1, 1]]),
            jnp.stack([c01,
                       J[0, 0] * J[2, 2] - J[0, 2] * J[2, 0],
                       J[0, 2] * J[1, 0] - J[0, 0] * J[1, 2]]),
            jnp.stack([c02,
                       J[0, 1] * J[2, 0] - J[0, 0] * J[2, 1],
                       J[0, 0] * J[1, 1] - J[0, 1] * J[1, 0]]),
        ])
        return det, adj / det
    raise NotImplementedError('det_and_inv only implemented for d <= 3')


def gauss_weight_field(weights):
    """Outer product of per-axis Gauss weight vectors over the TP grid."""
    W = jnp.asarray(weights[0])
    for w in weights[1:]:
        W = W[..., None] * jnp.asarray(w)
    return W


def host_jacobian_levelorder(geo, grids):
    """Host fallback: geometry Jacobian on the grid, level-ordered and
    component-leading: shape ``(dim, sdim) + grid``."""
    jac = np.asarray(geo.grid_jacobian(grids))[..., ::-1, ::-1]
    return np.ascontiguousarray(np.moveaxis(jac, (-2, -1), (0, 1)))


def host_eval(geo, grids):
    """Host fallback: geometry values on the grid (XYZ component order)."""
    from .. import utils
    return np.asarray(utils.grid_eval(geo, grids))


def det_and_inv_df(J):
    """Like :func:`det_and_inv` but in double-float32 arithmetic
    (:mod:`~pyiga_jax.ops.twofloat`): input f64 ``(d, d) + grid``, returns
    ``(det_df, inv_df)`` as two-float pairs (nested lists for inv), fused
    into f32 elementwise code (the field pipeline of ``mode='ozaki'``)."""
    from . import twofloat as tf
    d = J.shape[0]
    j = [[tf.df_from_f64(J[a, b]) for b in range(d)] for a in range(d)]
    return det_and_inv_df_pairs(j)


def _det3_cofactors_df(j):
    """First-column cofactors and determinant of a 3x3 two-float matrix
    (shared by the det-only and det+inverse paths; the formulas are
    sign-sensitive and must stay in exactly one place)."""
    from . import twofloat as tf
    m, sub = tf.df_mul, tf.df_sub
    c00 = sub(m(j[1][1], j[2][2]), m(j[1][2], j[2][1]))
    c01 = sub(m(j[1][2], j[2][0]), m(j[1][0], j[2][2]))
    c02 = sub(m(j[1][0], j[2][1]), m(j[1][1], j[2][0]))
    det = tf.df_sum([m(j[0][0], c00), m(j[0][1], c01), m(j[0][2], c02)])
    return (c00, c01, c02), det


def det_df_pairs(j):
    """Determinant only (two-float), for field pipelines that do not need
    the inverse (mass assembly)."""
    from . import twofloat as tf
    d = len(j)
    m, sub = tf.df_mul, tf.df_sub
    if d == 1:
        return j[0][0]
    if d == 2:
        return sub(m(j[0][0], j[1][1]), m(j[0][1], j[1][0]))
    if d == 3:
        return _det3_cofactors_df(j)[1]
    raise NotImplementedError('det_df_pairs only implemented for d <= 3')


def det_and_inv_df_pairs(j):
    """Like :func:`det_and_inv_df` but on an already-split nested pair
    matrix ``j[a][b] = (hi, lo)`` (e.g. from
    :func:`geo_jacobian_field_df`)."""
    from . import twofloat as tf
    d = len(j)

    def m(a, b):
        return tf.df_mul(a, b)

    def sub(a, b):
        return tf.df_sub(a, b)

    if d == 1:
        det = j[0][0]
        return det, [[tf.df_div(tf.df(jnp.ones_like(det[0])), det)]]
    if d == 2:
        det = sub(m(j[0][0], j[1][1]), m(j[0][1], j[1][0]))
        adj = [[j[1][1], tf.df_neg(j[0][1])],
               [tf.df_neg(j[1][0]), j[0][0]]]
        inv = [[tf.df_div(adj[a][b], det) for b in range(2)]
               for a in range(2)]
        return det, inv
    if d == 3:
        (c00, c01, c02), det = _det3_cofactors_df(j)
        adj = [
            [c00,
             sub(m(j[0][2], j[2][1]), m(j[0][1], j[2][2])),
             sub(m(j[0][1], j[1][2]), m(j[0][2], j[1][1]))],
            [c01,
             sub(m(j[0][0], j[2][2]), m(j[0][2], j[2][0])),
             sub(m(j[0][2], j[1][0]), m(j[0][0], j[1][2]))],
            [c02,
             sub(m(j[0][1], j[2][0]), m(j[0][0], j[2][1])),
             sub(m(j[0][0], j[1][1]), m(j[0][1], j[1][0]))],
        ]
        inv = [[tf.df_div(adj[a][b], det) for b in range(3)]
               for a in range(3)]
        return det, inv
    raise NotImplementedError('det_and_inv_df only implemented for d <= 3')


def tp_apply_df(tables, coeffs, lead=0, max_unroll=8):
    """Two-float version of :func:`tp_apply`: contractions over the (small)
    geometry coefficient axes are unrolled into double-float32 multiply/adds
    (:mod:`~pyiga_jax.ops.twofloat`), which fuse as f32 elementwise code —
    unlike emulated-f64 tensordots.  Falls back to the f64 tensordot (then
    splits) when an axis exceeds `max_unroll` coefficients.

    Returns a two-float pair."""
    from . import twofloat as tf
    d = len(tables)
    if any(t.shape[1] > max_unroll for t in tables):
        return tf.df_from_f64(tp_apply(tables, coeffs, lead))
    X = tf.df_from_f64(jnp.asarray(coeffs))
    for k in range(d):
        T = tables[k]                       # (Q_k, n_k), f64
        Q, n = T.shape
        ax = lead + k
        acc = None
        for j in range(n):
            # coefficient slice with axis `ax` removed, broadcast against Q
            hi = jnp.expand_dims(jnp.take(X[0], j, axis=ax), ax)
            lo = jnp.expand_dims(jnp.take(X[1], j, axis=ax), ax)
            tshape = [1] * hi.ndim
            tshape[ax] = Q
            tj = tf.df_from_f64(T[:, j].reshape(tshape))
            term = tf.df_mul(tj, (hi, lo))
            acc = term if acc is None else tf.df_add(acc, term)
        X = acc
    return X


def geo_jacobian_field_df(tables, coeffs, is_nurbs, sdim):
    """Two-float analog of :func:`geo_jacobian_field`: returns
    ``(val, jac)`` with `val` a list of per-component pairs and `jac` a
    nested ``[c][k]`` list of pairs — no emulated-f64 arithmetic (the
    geometry coefficient contractions unroll into fused f32 pair ops, the
    NURBS quotient rule runs in two-float division)."""
    from . import twofloat as tf
    val_tabs = [t[0] for t in tables]
    der_tabs = [t[1] for t in tables]
    C = coeffs.shape[0]
    valp = tp_apply_df(val_tabs, coeffs, lead=1)
    val = [(valp[0][c], valp[1][c]) for c in range(C)]
    jac = []
    for k in range(sdim):
        ops = [der_tabs[j] if j == k else val_tabs[j] for j in range(sdim)]
        colp = tp_apply_df(ops, coeffs, lead=1)
        jac.append([(colp[0][c], colp[1][c]) for c in range(C)])
    # jac[k][c] -> reorder to [c][k]
    jac = [[jac[k][c] for k in range(sdim)] for c in range(C)]

    if is_nurbs:
        W = val[-1]
        V = val[:-1]
        Wj = jac[-1]
        Vj = jac[:-1]
        val = [tf.df_div(v, W) for v in V]
        jac = [[tf.df_div(tf.df_sub(tf.df_mul(Vj[c][k], W),
                                    tf.df_mul(V[c], Wj[k])),
                          tf.df_mul(W, W)) for k in range(sdim)]
               for c in range(len(V))]
    return val, jac
