# -*- coding: utf-8 -*-
"""B-spline knot vectors, basis evaluation, collocation and prolongation.

This is the L0 layer of the framework: 1D spline machinery from which all
tensor-product structures are built.  API parity with the reference
implementation (/root/reference/pyiga/bspline.py, bspline_cy.pyx), but the
basis-evaluation kernels here are *vectorized over evaluation points*
(numpy on host; see :mod:`pyiga_jax.ops.basis` for the JAX device versions)
instead of per-point Cython loops.

Conventions shared with the reference:

* knot vectors are open (first/last knot repeated ``p+1`` times);
* ``active_deriv(kv, u, nd)`` returns shape ``(nd+1, p+1, npts)`` where the
  ``r``-th active function at point ``u`` is global index ``findspan(u)-p+r``;
* tensor-product coefficient arrays are indexed in ZYX order (axis 0 of the
  coefficient array corresponds to the *last* spatial coordinate).
"""

import numpy as np
import scipy.interpolate
import scipy.sparse
import scipy.sparse.linalg


def _parse_bdspec(bdspec, dim):
    """Normalize a boundary specification to an ``(axis, side)`` pair.

    Accepts the named sides ``'left'/'right'`` (last axis), ``'bottom'/'top'``
    (second-to-last axis) and ``'front'/'back'`` (third-to-last axis), or an
    explicit ``(axis, side)`` tuple with ``side`` in ``(0, 1)``.
    (Reference: bspline.py:13.)
    """
    names = {
        'left':   (dim - 1, 0), 'right': (dim - 1, 1),
        'bottom': (dim - 2, 0), 'top':   (dim - 2, 1),
        'front':  (dim - 3, 0), 'back':  (dim - 3, 1),
    }
    bd = names.get(bdspec, bdspec) if isinstance(bdspec, str) else bdspec
    try:
        axis, side = bd
    except Exception:
        raise ValueError('invalid bdspec %r' % (bdspec,))
    if side not in (0, 1) or not (0 <= axis < dim):
        raise ValueError('invalid bdspec %r for dimension %d' % (bdspec, dim))
    return (axis, side)


class KnotVector:
    """An open B-spline knot vector together with a spline degree.

    Attributes:
        kv (ndarray): the knots (monotonically increasing; first and last
            repeated ``p+1`` times).
        p (int): the spline degree.

    Tensor-product spline spaces are represented as tuples of
    :class:`KnotVector` instances.  (Reference: bspline.py:36.)
    """

    def __init__(self, knots, p):
        knots = np.asarray(knots, dtype=float)
        assert np.all(np.diff(knots) >= 0.0), 'knots should be increasing'
        self.kv = knots
        self.p = int(p)
        self._mesh = None
        self._knots_to_mesh = None

    # -- basic introspection ------------------------------------------------

    def __str__(self):
        return '<KnotVector p=%d sz=%d>' % (self.p, self.kv.size)

    def __repr__(self):
        return 'KnotVector(%r, %r)' % (self.kv, self.p)

    def __eq__(self, other):
        return (isinstance(other, KnotVector) and self.p == other.p
                and len(self.kv) == len(other.kv)
                and np.allclose(self.kv, other.kv, atol=1e-8, rtol=1e-8))

    def __hash__(self):
        # hash by degree + endpoint knots rounded to the __eq__ tolerance
        # grid, so allclose-equal knot vectors hash equal (values straddling
        # a rounding-grid edge may still hash apart — a benign missed cache
        # hit, never a wrong lookup)
        return hash((self.p, self.kv.size,
                     round(float(self.kv[0]), 6),
                     round(float(self.kv[-1]), 6)))

    @property
    def numknots(self):
        return self.kv.size

    @property
    def numdofs(self):
        """Dimension of the spline space over this knot vector."""
        return self.kv.size - self.p - 1

    @property
    def numspans(self):
        """Number of nonempty knot spans."""
        return self.mesh.size - 1

    def copy(self):
        return KnotVector(self.kv.copy(), self.p)

    # -- support / mesh queries ---------------------------------------------

    def support(self, j=None):
        """Support interval of the whole space or of the ``j``-th B-spline."""
        if j is None:
            return (self.kv[0], self.kv[-1])
        return (self.kv[j], self.kv[j + self.p + 1])

    def support_idx(self, j):
        """Knot indices delimiting the support of the ``j``-th B-spline."""
        return (j, j + self.p + 1)

    def _ensure_mesh(self):
        if self._knots_to_mesh is None:
            self._mesh, self._knots_to_mesh = np.unique(self.kv, return_inverse=True)

    @property
    def mesh(self):
        """The unique knots (breakpoints)."""
        self._ensure_mesh()
        return self._mesh

    def mesh_support_idx(self, j):
        """First and last mesh (breakpoint) index of the support of B-spline ``j``."""
        self._ensure_mesh()
        lo, hi = self.support_idx(j)
        return (self._knots_to_mesh[lo], self._knots_to_mesh[hi])

    def mesh_support_idx_all(self):
        """``(numdofs, 2)`` array of :func:`mesh_support_idx` for every B-spline."""
        self._ensure_mesh()
        n = self.numdofs
        idx = np.stack((np.arange(n), np.arange(self.p + 1, n + self.p + 1)), axis=1)
        return self._knots_to_mesh[idx]

    def mesh_span_indices(self):
        """Knot indices ``i`` with ``kv[i] != kv[i+1]`` (the nonempty spans)."""
        self._ensure_mesh()
        k2m = self._knots_to_mesh
        return np.where(k2m[1:] != k2m[:-1])[0]

    def findspan(self, u):
        """Largest index ``i`` with ``kv[i] <= u < kv[i+1]``, clamped so that
        ``p <= i < numknots - 1 - p`` (right boundary maps into the last span)."""
        return int(findspans(self, np.asarray([u]))[0])

    def first_active(self, k):
        """Index of the first active basis function on span ``k``."""
        return k - self.p

    def first_active_at(self, u):
        """Index of the first active basis function at parameter value ``u``."""
        return self.findspan(u) - self.p

    def greville(self):
        """Greville abscissae (knot averages) of this knot vector."""
        p = self.p
        if p == 0:
            return 0.5 * (self.kv[1:] + self.kv[:-1])
        # running average of p consecutive interior knots
        csum = np.concatenate(([0.0], np.cumsum(self.kv)))
        g = (csum[p + 1:-1] - csum[1:-p - 1]) / p
        return np.clip(g, self.kv[0], self.kv[-1])

    def refine(self, new_knots=None):
        """Insert ``new_knots`` (or bisect every span if None) and return the
        refined knot vector."""
        if new_knots is None:
            m = self.mesh
            new_knots = 0.5 * (m[1:] + m[:-1])
        return KnotVector(np.sort(np.concatenate((self.kv, new_knots))), self.p)

    def meshsize_avg(self):
        """Average knot span length."""
        return abs(self.kv[-1] - self.kv[0]) / self.numspans


def make_knots(p, a, b, n, mult=1):
    """Open knot vector of degree `p` over ``(a, b)`` with `n` knot spans and
    interior-knot multiplicity `mult`.  (Reference: bspline.py:192.)"""
    interior = np.arange(a, b, (b - a) / n)[1:]
    kv = np.concatenate((np.repeat(a, p + 1), np.repeat(interior, mult),
                         np.repeat(b, p + 1)))
    return KnotVector(kv, p)


def numdofs(kvs):
    """Total dimension of a knot vector or a tensor-product tuple of them."""
    if isinstance(kvs, KnotVector):
        return kvs.numdofs
    return int(np.prod([kv.numdofs for kv in kvs]))


################################################################################
# Basis evaluation (vectorized over points)
################################################################################

def findspans(knotvec, u):
    """Vectorized :meth:`KnotVector.findspan` for an array of points."""
    kv, p = knotvec.kv, knotvec.p
    spans = np.searchsorted(kv, np.asarray(u), side='right') - 1
    return np.clip(spans, p, kv.size - p - 2).astype(np.int64)


def active_deriv(knotvec, u, numderiv):
    """All active B-splines and their derivatives up to order `numderiv` at `u`.

    Vectorized Cox-de Boor triangle + derivative recurrence (The NURBS Book,
    algorithm A2.3); replaces the per-point Cython kernel of the reference
    (bspline_cy.pyx:42).

    Returns:
        array of shape ``(numderiv+1, p+1)`` for scalar `u`, else
        ``(numderiv+1, p+1, len(u))``.  Entry ``[k, r, j]`` is the `k`-th
        derivative of basis function ``findspan(u[j]) - p + r`` at ``u[j]``.
    """
    scalar = np.isscalar(u)
    u = np.atleast_1d(np.asarray(u, dtype=float))
    kv, p = knotvec.kv, knotvec.p
    npts = u.size
    nd = int(numderiv)

    span = findspans(knotvec, u)

    # triangular table: ndu[:, r, j] = value of r-th active function of degree j
    # lower triangle ndu[:, j, r] (j > r) holds distance-j knot differences
    ndu = np.zeros((npts, p + 1, p + 1))
    ndu[:, 0, 0] = 1.0
    # left[:, j] = u - kv[span+1-j], right[:, j] = kv[span+j] - u  (1-based j)
    left = np.zeros((npts, p + 1))
    right = np.zeros((npts, p + 1))
    for j in range(1, p + 1):
        left[:, j] = u - kv[span + 1 - j]
        right[:, j] = kv[span + j] - u
        saved = np.zeros(npts)
        for r in range(j):
            # knot difference of distance j (always > 0: spans the current span)
            ndu[:, j, r] = right[:, r + 1] + left[:, j - r]
            temp = ndu[:, r, j - 1] / ndu[:, j, r]
            ndu[:, r, j] = saved + right[:, r + 1] * temp
            saved = left[:, j - r] * temp
        ndu[:, j, j] = saved

    out = np.zeros((nd + 1, p + 1, npts))
    out[0] = ndu[:, :, p].T

    if nd > 0:
        # derivative recurrence; a holds the two alternating coefficient rows
        a = np.zeros((npts, 2, p + 1))
        for r in range(p + 1):
            a[:] = 0.0
            a[:, 0, 0] = 1.0
            s1, s2 = 0, 1
            fac = float(p)
            for k in range(1, nd + 1):
                d = np.zeros(npts)
                rk, pk = r - k, p - k
                if r >= k:
                    a[:, s2, 0] = a[:, s1, 0] / ndu[:, pk + 1, rk]
                    d = a[:, s2, 0] * ndu[:, rk, pk]
                j1 = 1 if rk >= -1 else -rk
                j2 = k - 1 if r - 1 <= pk else p - r
                for j in range(j1, j2 + 1):
                    a[:, s2, j] = (a[:, s1, j] - a[:, s1, j - 1]) / ndu[:, pk + 1, rk + j]
                    d = d + a[:, s2, j] * ndu[:, rk + j, pk]
                if r <= pk:
                    a[:, s2, k] = -a[:, s1, k - 1] / ndu[:, pk + 1, r]
                    d = d + a[:, s2, k] * ndu[:, r, pk]
                out[k, r, :] = d * fac
                fac *= pk
                s1, s2 = s2, s1

    if scalar:
        return out[:, :, 0]
    return out


def active_ev(knotvec, u):
    """All active B-spline values at the points `u`; shape ``(p+1, len(u))``."""
    if np.isscalar(u):
        return active_deriv(knotvec, u, 0)[0]
    return active_deriv(knotvec, u, 0)[0, :]


def ev(knotvec, coeffs, u):
    """Evaluate a spline with coefficients `coeffs` at all points `u`."""
    assert len(coeffs) == knotvec.numdofs, 'Wrong size of coefficient vector'
    return scipy.interpolate.splev(u, (knotvec.kv, coeffs, knotvec.p))


def deriv(knotvec, coeffs, deriv, u):
    """Evaluate the `deriv`-th derivative of a spline at all points `u`."""
    assert len(coeffs) == knotvec.numdofs, 'Wrong size of coefficient vector'
    return scipy.interpolate.splev(u, (knotvec.kv, coeffs, knotvec.p), der=deriv)


def single_ev(knotvec, i, u):
    """Evaluate the `i`-th B-spline alone at all points `u`."""
    e = np.zeros(knotvec.numdofs)
    e[i] = 1.0
    return ev(knotvec, e, u)


################################################################################
# Collocation
################################################################################

def collocation_info(kv, nodes):
    """Row-wise collocation data: per node, the index of its first active
    B-spline and the ``p+1`` active basis values.  Returns ``(indices, values)``
    with shapes ``(n,)`` and ``(n, p+1)``."""
    nodes = np.asarray(nodes, dtype=float)
    values = active_ev(kv, nodes)                   # (p+1, n)
    indices = findspans(kv, nodes) - kv.p
    return indices, np.ascontiguousarray(values.T)


def collocation_derivs_info(kv, nodes, derivs=1):
    """Like :func:`collocation_info` but with derivatives up to order `derivs`;
    second return value has shape ``(derivs+1, n, p+1)``."""
    nodes = np.asarray(nodes, dtype=float)
    values = active_deriv(kv, nodes, derivs)        # (derivs+1, p+1, n)
    indices = findspans(kv, nodes) - kv.p
    return indices, np.ascontiguousarray(values.swapaxes(-2, -1))


def _collocation_csr(kv, nodes, values, indices):
    m, n, p = len(nodes), kv.numdofs, kv.p
    I = np.repeat(np.arange(m), p + 1)
    J = (indices[:, None] + np.arange(p + 1)[None, :]).ravel()
    return scipy.sparse.coo_matrix((values.ravel(), (I, J)), shape=(m, n)).tocsr()


def collocation(kv, nodes):
    """Sparse collocation matrix ``C[i,j] = B_j(nodes[i])`` (CSR)."""
    nodes = np.asarray(nodes, dtype=float)
    indices, values = collocation_info(kv, nodes)
    return _collocation_csr(kv, nodes, values, indices)


def collocation_derivs(kv, nodes, derivs=1):
    """List of `derivs`+1 sparse collocation matrices (values, 1st, ... derivs)."""
    nodes = np.asarray(nodes, dtype=float)
    indices, values = collocation_derivs_info(kv, nodes, derivs)
    return [_collocation_csr(kv, nodes, values[d], indices)
            for d in range(derivs + 1)]


def interpolate(kv, func, nodes=None):
    """Interpolate `func` in the B-spline basis at `nodes` (Greville default)."""
    nodes = kv.greville() if nodes is None else np.asarray(nodes)
    C = collocation(kv, nodes)
    return scipy.sparse.linalg.spsolve(C.tocsc(), func(nodes))


################################################################################
# L2 products / projection
################################################################################

def load_vector(kv, f):
    """L2 inner products of all basis functions with the function `f`."""
    from .quadrature import make_iterated_quadrature
    nodes, weights = make_iterated_quadrature(kv.mesh, kv.p + 1)
    C = collocation(kv, nodes)
    return C.T.dot(weights * f(nodes))


def project_L2(kv, f):
    """B-spline coefficients of the L2 projection of `f`."""
    from .assemble import bsp_mass_1d
    M = bsp_mass_1d(kv)
    return scipy.sparse.linalg.spsolve(M.tocsc(), load_vector(kv, f))


################################################################################
# Prolongation / knot insertion
################################################################################

def prolongation(kv1, kv2):
    """Coefficient prolongation matrix from the space over `kv1` into the
    (finer) space over `kv2`, computed by collocating at the Greville points
    of `kv2` (reference: bspline.py:692).  Returns a pruned CSR matrix."""
    g = kv2.greville()
    C1 = collocation(kv1, g).toarray()
    C2 = collocation(kv2, g)
    P = scipy.sparse.linalg.spsolve(C2.tocsc(), C1)
    if scipy.sparse.issparse(P):
        P = P.toarray()
    P[np.abs(P) < 1e-15] = 0.0
    return scipy.sparse.csr_matrix(P)


def knot_insertion(kv, u):
    """Boehm single-knot-insertion: sparse ``(n+1, n)`` matrix mapping
    coefficients over `kv` to coefficients over ``kv.refine([u])``."""
    n, p, knots = kv.numdofs, kv.p, kv.kv
    k = kv.findspan(u)

    rows, cols, vals = [], [], []
    for i in range(n + 1):
        if i <= k - p:
            rows.append(i); cols.append(i); vals.append(1.0)
        elif i > k:
            rows.append(i); cols.append(i - 1); vals.append(1.0)
        else:
            a = (u - knots[i]) / (knots[i + p] - knots[i])
            rows += [i, i]; cols += [i - 1, i]; vals += [1.0 - a, a]
    return scipy.sparse.csr_matrix((vals, (rows, cols)), shape=(n + 1, n))


################################################################################
# Pointwise tensor-product evaluation (unstructured points)
################################################################################

def _tp_gather_active(kvs, coeffs, XY, derivs=1):
    """Shared setup for pointwise TP evaluation: per-axis collocation data with
    first derivatives, plus the gathered active coefficient blocks.

    Note: ``kvs[d]`` pairs with coordinate ``XY[sdim-1-d]`` (ZYX convention).
    """
    sdim = len(kvs)
    n = XY[0].size
    coll = [collocation_derivs_info(kvs[d], XY[sdim - 1 - d], derivs=derivs)
            for d in range(sdim)]
    # gather active coefficient block per point: shape (n, p0+1, ..., pd+1, ...)
    # via per-axis index arrays broadcast over the block axes
    block_idx = []
    for d in range(sdim):
        arange = np.arange(kvs[d].p + 1).reshape([1] * (1 + d) + [-1] + [1] * (sdim - d - 1))
        block_idx.append(coll[d][0].reshape([n] + [1] * sdim) + arange)
    C_active = coeffs[tuple(block_idx)]     # (n, p0+1, ..., pd+1) + output_shape
    return coll, C_active


def _tp_contract(coll, C_active, deriv_axes):
    """Contract gathered blocks with per-axis basis value (0) or derivative (1)
    vectors as selected by `deriv_axes`."""
    sdim = len(coll)
    res = C_active
    for d in range(sdim):
        vecs = coll[d][1][deriv_axes[d]]    # (n, p+1)
        # contract axis 1 (current leading block axis) against vecs
        expand = vecs.reshape(vecs.shape + (1,) * (res.ndim - 2))
        res = (res * expand).sum(axis=1)
    return res


def tp_bsp_eval_pointwise(kvs, coeffs, points):
    """Evaluate a TP B-spline function at an unstructured list of points.

    `points[i]` holds the coordinates for dimension `i` in XYZ order; all
    coordinate arrays must have the same shape.  (Reference: bspline.py:436;
    vectorized over all points instead of a Python loop.)"""
    if not all(np.shape(x) == np.shape(points[0]) for x in points):
        raise ValueError('All coordinate arrays should have the same shape')
    XY = tuple(np.asarray(points[d], dtype=float).ravel() for d in range(len(points)))
    sdim = len(XY)
    coll, C_active = _tp_gather_active(kvs, coeffs, XY, derivs=0)
    vals = _tp_contract(coll, C_active, (0,) * sdim)
    input_shape = np.shape(points[0])
    return vals.reshape(input_shape + coeffs.shape[sdim:])


def tp_bsp_jac_pointwise(kvs, coeffs, points):
    """Jacobian of a TP B-spline function at unstructured points; the last
    output axis is the derivative direction in XYZ order."""
    val, jac = tp_bsp_eval_with_jac_pointwise(kvs, coeffs, points)
    return jac


def tp_bsp_eval_with_jac_pointwise(kvs, coeffs, points):
    """Values and Jacobians of a TP B-spline function at unstructured points."""
    if not all(np.shape(x) == np.shape(points[0]) for x in points):
        raise ValueError('All coordinate arrays should have the same shape')
    XY = tuple(np.asarray(points[d], dtype=float).ravel() for d in range(len(points)))
    sdim = len(XY)
    coll, C_active = _tp_gather_active(kvs, coeffs, XY)
    vals = _tp_contract(coll, C_active, (0,) * sdim)
    jacs = []
    for i in range(sdim):   # derivative w.r.t. coefficient axis i
        da = tuple(1 if d == i else 0 for d in range(sdim))
        jacs.append(_tp_contract(coll, C_active, da))
    # components stacked in XYZ order: after the reversal the x-derivative
    # (level axis sdim-1) is the FIRST component of the Jacobian
    jac = np.stack(jacs[::-1], axis=-1)
    input_shape = np.shape(points[0])
    out_shape = coeffs.shape[sdim:]
    return (vals.reshape(input_shape + out_shape),
            jac.reshape(input_shape + out_shape + (sdim,)))


# geometry function classes live in geometry.py; re-export for API parity
def __getattr__(name):
    if name in ('BSplineFunc', 'NurbsFunc', 'PhysicalGradientFunc'):
        from . import geometry
        return getattr(geometry, name)
    raise AttributeError(name)


# star-import parity with the reference (whose bspline module defines these
# classes directly): list every public name so `from ... import *` also
# resolves the lazy re-exports through __getattr__ (PEP 562).
__all__ = [_n for _n in list(globals()) if not _n.startswith('_')] + \
          ['BSplineFunc', 'NurbsFunc', 'PhysicalGradientFunc']
