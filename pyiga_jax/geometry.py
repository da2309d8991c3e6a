# -*- coding: utf-8 -*-
"""Geometry maps: tensor-product B-spline and NURBS functions plus factories.

L2 layer, API parity with /root/reference/pyiga/geometry.py and the
BSplineFunc/PhysicalGradientFunc classes of bspline.py:820/:1125.

Conventions (identical to the reference):

* grid axes are passed in ZYX order (x axis last), point arguments in XYZ;
* Jacobians have shape ``grid_shape x dim x sdim`` with the *last* axis
  holding derivatives in XYZ order;
* Hessians store only the symmetric part, linearized as
  ``(d_xx, d_xy, d_yy)`` in 2D and ``(d_xx, d_xy, d_xz, d_yy, d_yz, d_zz)``
  in 3D.

Evaluation is per-axis collocation + :func:`pyiga_jax.tensor.apply_tprod`
(small dense/banded matmuls); the device assemblers consume these arrays as
precomputed geometry fields.
"""

import functools

import numpy as np

from . import bspline, utils
from .bspline import KnotVector, _parse_bdspec
from .tensor import apply_tprod


################################################################################
# Base classes
################################################################################

class _BaseGeoFunc:
    def __call__(self, *x):
        return self.eval(*x)

    def is_scalar(self):
        return len(self.output_shape()) == 0

    def is_vector(self):
        return len(self.output_shape()) == 1

    def bounding_box(self, grid=1):
        """Bounding box of the image; `grid` > 1 samples a finer grid
        (useful for non-convex geometries).  Returns (lower, upper) per
        dimension in XY order."""
        grd = [np.linspace(s[0], s[1], grid + 1) for s in self.support]
        X = self.grid_eval(grd).reshape(-1, self.dim)
        return tuple((X[:, d].min(), X[:, d].max()) for d in range(self.dim))

    def find_inverse(self, x, tol=1e-8):
        """Find parameter coordinates mapping to the physical point `x`
        (bounded least-squares root finding)."""
        import scipy.optimize
        supp = np.transpose(self.support)
        result = scipy.optimize.least_squares(
            lambda xi: self(*xi) - x,
            np.mean(supp, axis=0), bounds=supp,
            method='dogbox', ftol=tol, xtol=tol, gtol=1e-15)
        if result.success and np.sqrt(result.cost) < tol:
            return result.x
        raise ValueError('Could not find coordinates for desired point %s' % (x,))

    def boundary(self, bdspec):
        """One side of the boundary as a function with `sdim` reduced by 1."""
        return _BoundaryFunction(self, bdspec)


class _BaseSplineFunc(_BaseGeoFunc):
    def eval(self, *x):
        """Evaluate at a single point (arguments in XYZ order)."""
        coords = tuple(reversed(x))     # XYZ -> ZYX
        singletons = tuple(i for i in range(self.sdim) if np.isscalar(coords[i]))
        coords = tuple(np.atleast_1d(np.asanyarray(c, dtype=float)) for c in coords)
        y = self.grid_eval(coords).squeeze(axis=singletons)
        return y.item() if y.shape == () else y


def _prep_tp_coeffs(kvs, coeffs, sdim):
    """Validate/reshape a coefficient array for a TP basis; returns the array
    and the inferred output dimension."""
    N = tuple(kv.numdofs for kv in kvs)
    coeffs = np.asanyarray(coeffs)
    if coeffs.ndim == 1:
        assert coeffs.shape[0] == np.prod(N), 'Wrong length of coefficient vector'
        coeffs = coeffs.reshape(N)
    assert N == coeffs.shape[:sdim], 'Wrong shape of coefficients'
    tail = coeffs.shape[sdim:]
    if len(tail) == 0:
        dim = 1
    elif len(tail) == 1:
        dim = tail[0]
    else:
        dim = tail
    return coeffs, dim


class _ControlPointMixin:
    """Shared behavior of spline-type functions storing control points:
    support-override plumbing, boundary restriction by coefficient slicing,
    and affine control-point transforms.  Subclasses supply ``_rebuild``
    (same type from raw stored coefficients) and ``_map_points`` (same type
    with the *control points* mapped)."""

    @property
    def support(self):
        if self._support_override:
            return self._support_override
        return tuple(kv.support() for kv in self.kvs)

    @support.setter
    def support(self, new_support):
        new_support = tuple(new_support)
        assert len(new_support) == self.sdim, 'wrong number of dimensions'
        assert all(len(s) == 2 for s in new_support), \
            'entries must be (lo,hi) pairs'
        self._support_override = new_support

    def boundary(self, bdspec):
        if self._support_override:
            return _BaseGeoFunc.boundary(self, bdspec)
        axis, side = _parse_bdspec(bdspec, self.sdim)
        face = self.sdim * [slice(None)]
        face[axis] = -side              # index 0 (side 0) or -1 (side 1)
        return self._rebuild(self.kvs[:axis] + self.kvs[axis + 1:],
                             self.coeffs[tuple(face)])

    def copy(self):
        return self._rebuild(tuple(kv.copy() for kv in self.kvs),
                             self.coeffs.copy())

    def translate(self, offset):
        return self._map_points(lambda C: C + offset)

    def scale(self, factor):
        return self._map_points(lambda C: C * factor)

    def apply_matrix(self, A):
        """Apply a matrix (or per-control-point array of matrices) to each
        control point."""
        assert self.is_vector(), \
            'Can only apply matrices to vector-valued functions'

        def mapped(C):
            out = np.matmul(A, C[..., None])
            assert out.shape[-1] == 1
            return np.squeeze(out, axis=-1)

        return self._map_points(mapped)

    def rotate_2d(self, angle):
        assert self.dim == 2, 'Must be 2D vector function'
        c, s = np.cos(angle), np.sin(angle)
        return self.apply_matrix(np.array([[c, -s], [s, c]]))


################################################################################
# BSplineFunc
################################################################################

class BSplineFunc(_ControlPointMixin, _BaseSplineFunc):
    """A function in a tensor-product B-spline basis.

    `kvs` is a tuple of `d` :class:`.KnotVector`; `coeffs` has its first `d`
    axes matching the per-axis dofs, trailing axes give the output shape.
    (Reference: bspline.py:820.)
    """

    def __init__(self, kvs, coeffs):
        if isinstance(kvs, KnotVector):
            kvs = (kvs,)
        self.kvs = tuple(kvs)
        self.sdim = len(self.kvs)
        self.coeffs, self.dim = _prep_tp_coeffs(self.kvs, coeffs, self.sdim)
        self._support_override = None

    def output_shape(self):
        return self.coeffs.shape[self.sdim:]

    # -- grid evaluation ------------------------------------------------------

    def _colloc(self, gridaxes, derivs=0):
        gridaxes = _squeeze_grid(gridaxes, self.sdim)
        if derivs == 0:
            return [bspline.collocation(kv, g) for kv, g in zip(self.kvs, gridaxes)]
        return [bspline.collocation_derivs(kv, g, derivs=derivs)
                for kv, g in zip(self.kvs, gridaxes)]

    def grid_eval(self, gridaxes):
        """Evaluate on a tensor grid (axes in ZYX order)."""
        assert len(gridaxes) == self.sdim, 'Input has wrong dimension'
        return apply_tprod(self._colloc(gridaxes), self.coeffs)

    def grid_jacobian(self, gridaxes):
        """Jacobians on a tensor grid; shape ``grid x dim x sdim``
        (gradient per point for scalar functions)."""
        assert len(gridaxes) == self.sdim, 'Input has wrong dimension'
        colloc = self._colloc(gridaxes, derivs=1)
        comps = []
        for i in reversed(range(self.sdim)):    # x (last grid axis) first
            ops = [colloc[j][1 if j == i else 0] for j in range(self.sdim)]
            comps.append(apply_tprod(ops, self.coeffs))
        return np.stack(comps, axis=-1)

    def grid_hessian(self, gridaxes):
        """Symmetric-part Hessians (linearized) on a tensor grid."""
        assert np.isscalar(self.dim), \
            'Hessian only implemented for scalar and vector functions'
        assert len(gridaxes) == self.sdim, 'Input has wrong dimension'
        colloc = self._colloc(gridaxes, derivs=2)
        comps = []
        for i in reversed(range(self.sdim)):
            for j in reversed(range(i + 1)):
                D = self.sdim * [0]
                D[i] += 1
                D[j] += 1
                ops = [colloc[k][D[k]] for k in range(self.sdim)]
                comps.append(apply_tprod(ops, self.coeffs))
        return np.stack(comps, axis=-1)

    # -- pointwise evaluation --------------------------------------------------

    def pointwise_eval(self, points):
        """Evaluate at unstructured points (coordinate arrays in XYZ order)."""
        return bspline.tp_bsp_eval_pointwise(self.kvs, self.coeffs, points)

    def pointwise_jacobian(self, points):
        """Jacobians at unstructured points (``dim x sdim`` per point)."""
        return bspline.tp_bsp_jac_pointwise(self.kvs, self.coeffs, points)

    def transformed_jacobian(self, geo):
        """Function evaluating the physical gradient of this function under
        the geometry transform `geo`."""
        return PhysicalGradientFunc(self, geo)

    # -- structure (mixin hooks) ----------------------------------------------

    @staticmethod
    def _rebuild(kvs, coeffs):
        return BSplineFunc(kvs, coeffs)

    def _map_points(self, fn):
        return BSplineFunc(self.kvs, fn(self.coeffs))

    def perturb(self, noise):
        """Copy with control points randomly perturbed by the given magnitude."""
        return BSplineFunc(self.kvs, self.coeffs + 2 * noise *
                           (np.random.random_sample(self.coeffs.shape) - 0.5))

    def cylinderize(self, z0=0.0, z1=1.0, support=(0.0, 1.0)):
        """Extrude linearly along a new axis from `z0` to `z1`."""
        return tensor_product(line_segment(z0, z1, support=support), self)

    def as_nurbs(self):
        return NurbsFunc(self.kvs, self.coeffs.copy(),
                         np.ones(self.coeffs.shape[:self.sdim]))

    def as_vector(self):
        if self.is_vector():
            return self
        assert self.is_scalar()
        return BSplineFunc(self.kvs, self.coeffs[..., np.newaxis])

    def __getitem__(self, I):
        return BSplineFunc(self.kvs, self.coeffs[..., I])


def _squeeze_grid(gridaxes, sdim):
    if not all(np.ndim(ax) == 1 for ax in gridaxes):
        gridaxes = tuple(np.squeeze(ax) for ax in gridaxes)
        assert all(ax.ndim == 1 for ax in gridaxes), \
            'Grid axes should be one-dimensional'
    return tuple(np.asarray(ax, dtype=float) for ax in gridaxes)


class PhysicalGradientFunc(_BaseGeoFunc):
    """Evaluates the physical (geometry-transformed) gradient of a scalar
    function: ``J^{-T} grad_param(u)``."""

    def __init__(self, func, geo):
        assert func.dim == 1, 'Transformed gradients only implemented for scalar functions'
        self.func = func
        self.geo = geo
        self.dim = self.sdim = func.sdim
        self.support = func.support

    def output_shape(self):
        return self.func.output_shape() + (self.sdim,)

    def grid_eval(self, gridaxes):
        geojac = self.geo.grid_jacobian(gridaxes)
        geojacinvT = np.linalg.inv(geojac).swapaxes(-2, -1)
        u_grad = self.func.grid_jacobian(gridaxes)
        return np.matmul(geojacinvT, u_grad[..., None])[..., 0]


################################################################################
# NurbsFunc
################################################################################

def _nurbs_jac_from_homog(val, jac):
    """Quotient-rule Jacobian of V/W given homogeneous values and Jacobians."""
    V, W = val[..., :-1, None], val[..., -1:, None]
    Vj, Wj = jac[..., :-1, :], jac[..., -1:, :]
    return (Vj * W - V * Wj) / (W ** 2)


class NurbsFunc(_ControlPointMixin, _BaseSplineFunc):
    """A function in a tensor-product NURBS basis.

    Stores coefficients *premultiplied* by the weights, with the weights as
    the last vector component (homogeneous coordinates).
    (Reference: geometry.py:27.)
    """

    def __init__(self, kvs, coeffs, weights, premultiplied=False):
        self.kvs = (kvs,) if isinstance(kvs, KnotVector) else tuple(kvs)
        self.sdim = len(self.kvs)
        coeffs, dim = _prep_tp_coeffs(self.kvs, coeffs, self.sdim)
        assert not isinstance(dim, tuple), \
            'Tensor-valued NURBS functions not implemented'
        self._isscalar = (coeffs.ndim == self.sdim)
        homog = np.array(coeffs, dtype=float)

        if weights is None:
            # the weights ride along as the last vector component
            assert dim > 1, 'Weights must be specified in the coeffs array'
            self.dim = dim - 1
        else:
            weights = np.asanyarray(weights)
            assert weights.shape == homog.shape[:self.sdim], \
                'Wrong shape of weights array'
            join = np.stack if self._isscalar else \
                (lambda arrs, axis: np.concatenate(
                    (arrs[0], arrs[1][..., None]), axis=axis))
            homog = join((homog, weights), axis=-1)
            self.dim = dim

        if not premultiplied:
            homog[..., :-1] *= homog[..., -1:]
        self.coeffs = homog
        self._support_override = None

    def output_shape(self):
        if self._isscalar:
            return ()
        shp = list(self.coeffs.shape[self.sdim:])
        shp[-1] -= 1
        return tuple(shp)

    def _homog(self):
        return BSplineFunc(self.kvs, self.coeffs)

    def grid_eval(self, gridaxes):
        vals = self._homog().grid_eval(gridaxes)
        f = vals[..., :-1] / vals[..., -1:]
        return np.squeeze(f, -1) if self._isscalar else f

    def grid_jacobian(self, gridaxes):
        bsp = self._homog()
        J = _nurbs_jac_from_homog(bsp.grid_eval(gridaxes),
                                  bsp.grid_jacobian(gridaxes))
        return np.squeeze(J, -2) if self._isscalar else J

    def grid_hessian(self, gridaxes):
        """Hessian via the second-order quotient rule:
        ``hess(V/W) = hess(V)/W - (V/W) hess(W)/W - sym(jac(V/W) jac(W)^T)/W``."""
        bsp = self._homog()
        val = bsp.grid_eval(gridaxes)
        V, W = val[..., :-1, None], val[..., -1:, None]
        jac = bsp.grid_jacobian(gridaxes)
        Njac = _nurbs_jac_from_homog(val, jac)
        Wjac = jac[..., -1:, :]

        hess = bsp.grid_hessian(gridaxes)
        Vh, Wh = hess[..., :-1, :], hess[..., -1:, :]
        part1 = Vh / W - (V * Wh) / (W ** 2)
        mat = (Njac[..., None, :] * Wjac[..., :, None]) / W[..., None]
        mat = mat + mat.swapaxes(-1, -2)
        I, J = np.triu_indices(mat.shape[-1])
        H = part1 - mat[..., I, J]
        return np.squeeze(H, -2) if self._isscalar else H

    def pointwise_eval(self, points):
        vals = bspline.tp_bsp_eval_pointwise(self.kvs, self.coeffs, points)
        f = vals[..., :-1] / vals[..., -1:]
        return np.squeeze(f, -1) if self._isscalar else f

    def pointwise_jacobian(self, points):
        val, jac = bspline.tp_bsp_eval_with_jac_pointwise(
            self.kvs, self.coeffs, points)
        J = _nurbs_jac_from_homog(val, jac)
        return np.squeeze(J, -2) if self._isscalar else J

    # -- structure (mixin hooks) ----------------------------------------------

    @staticmethod
    def _rebuild(kvs, coeffs):
        return NurbsFunc(kvs, coeffs, weights=None, premultiplied=True)

    def _map_points(self, fn):
        C, W = self.coeffs_weights()
        return NurbsFunc(self.kvs, fn(C), W)

    def coeffs_weights(self):
        """Non-premultiplied coefficients and weights as a pair of arrays."""
        W = self.coeffs[..., -1]
        return self.coeffs[..., :-1] / W[..., None], W.copy()

    def as_nurbs(self):
        return self

    def as_vector(self):
        if self.is_vector():
            return self
        assert self.is_scalar()
        return NurbsFunc(self.kvs, self.coeffs[..., :-1],
                         self.coeffs[..., -1], premultiplied=True)

    def __getitem__(self, I):
        C = self.coeffs[..., :-1]
        return NurbsFunc(self.kvs, C[..., I], self.coeffs[..., -1],
                         premultiplied=True)


################################################################################
# User-defined / composed / boundary functions
################################################################################

class UserFunction(_BaseGeoFunc):
    """Wrap a user callable as a geometry function.  `support` is a sequence
    of (lo, hi) pairs per parameter dimension; `jac` optionally evaluates the
    Jacobian."""

    def __init__(self, f, support, dim=None, jac=None):
        self.f = f
        self.support = tuple(support)
        self.jac = jac
        if dim is None:
            x0 = tuple(lo for (lo, hi) in reversed(self.support))
            shp = np.shape(f(*x0))
            self._output_shape = shp
            dim = 1 if len(shp) == 0 else (shp[0] if len(shp) == 1 else shp)
        else:
            self._output_shape = (dim,) if np.isscalar(dim) else dim
        self.dim = dim
        self.sdim = len(self.support)

    def output_shape(self):
        return self._output_shape

    def eval(self, *x):
        return self.f(*x)

    def pointwise_eval(self, points):
        return self.eval(*points)

    def grid_eval(self, grd):
        return utils.grid_eval(self.f, grd)

    def grid_jacobian(self, grd):
        assert self.jac is not None, 'Jacobian not specified in UserFunction'
        return utils.grid_eval(self.jac, grd)


class ComposedFunction(_BaseSplineFunc):
    """Composition ``geo2(geo1(x))``."""

    def __init__(self, geo2, geo1):
        assert geo1.dim == geo2.sdim
        self.geo1, self.geo2 = geo1, geo2
        self.sdim = geo1.sdim
        self.dim = geo2.dim

    @property
    def support(self):
        return self.geo1.support

    @support.setter
    def support(self, new_support):
        self.geo1.support = new_support

    def grid_eval(self, grd):
        XY = self.geo1.grid_eval(grd)
        return self.geo2.pointwise_eval(np.rollaxis(XY, -1))

    def grid_jacobian(self, grd):
        XY = self.geo1.grid_eval(grd)
        jac1 = self.geo1.grid_jacobian(grd)
        jac2 = self.geo2.pointwise_jacobian(np.rollaxis(XY, -1))
        return np.matmul(jac2, jac1)

    def boundary(self, bdspec):
        return ComposedFunction(self.geo2, self.geo1.boundary(bdspec))


class _BoundaryFunction(_BaseGeoFunc):
    """Restriction of a function to one side of its boundary (sdim - 1)."""

    def __init__(self, f, bdspec):
        self.f = f
        axis, side = _parse_bdspec(bdspec, f.sdim)
        lohi = f.support[axis]
        self.fixed_coord = lohi[0] if side == 0 else lohi[1]
        self.axis = axis
        self.support = f.support[:axis] + f.support[axis + 1:]
        self.dim = f.dim
        self.sdim = f.sdim - 1

    def output_shape(self):
        return self.f.output_shape()

    def eval(self, *x):
        x = list(x)
        x.insert(len(x) - self.axis, self.fixed_coord)
        return self.f(*x)

    def grid_eval(self, gridaxes):
        gridaxes = list(gridaxes)
        gridaxes.insert(self.axis, np.array([self.fixed_coord]))
        return utils.grid_eval(self.f, gridaxes).squeeze(self.axis)

    def grid_jacobian(self, gridaxes, keep_normal=False):
        gridaxes = list(gridaxes)
        gridaxes.insert(self.axis, np.array([self.fixed_coord]))
        jacs = self.f.grid_jacobian(gridaxes).squeeze(self.axis)
        if not keep_normal:
            # drop the column for the normal (fixed) direction
            ax = jacs.shape[-1] - self.axis - 1
            jacs = np.concatenate((jacs[..., :ax], jacs[..., ax + 1:]), axis=-1)
        return jacs


################################################################################
# Geometry factories
################################################################################

def unit_square(num_intervals=1):
    """Unit square as a :class:`BSplineFunc`."""
    return unit_cube(dim=2, num_intervals=num_intervals)


def perturbed_square(num_intervals=5, noise=0.02):
    """Unit square with randomly perturbed control points."""
    return unit_square(num_intervals).perturb(noise)


def bspline_quarter_annulus(r1=1.0, r2=2.0):
    """B-spline (non-exact) quarter annulus in the first quadrant."""
    kvx = bspline.make_knots(1, 0.0, 1.0, 1)
    kvy = bspline.make_knots(2, 0.0, 1.0, 1)
    coeffs = np.array([
        [[r1, 0.0], [r2, 0.0]],
        [[r1, r1], [r2, r2]],
        [[0.0, r1], [0.0, r2]],
    ])
    return BSplineFunc((kvy, kvx), coeffs)


def quarter_annulus(r1=1.0, r2=2.0):
    """Exact NURBS quarter annulus in the first quadrant."""
    kvx = bspline.make_knots(1, 0.0, 1.0, 1)
    kvy = bspline.make_knots(2, 0.0, 1.0, 1)
    w = 1.0 / np.sqrt(2.0)
    coeffs = np.array([
        [[r1, 0.0, 1.0], [r2, 0.0, 1.0]],
        [[r1, r1, w], [r2, r2, w]],
        [[0.0, r1, 1.0], [0.0, r2, 1.0]],
    ])
    return NurbsFunc((kvy, kvx), coeffs, weights=None)


def _combine_boundary_curves(bottom, top, left, right):
    kvs = (left.kvs[0], bottom.kvs[0])
    coeffs = np.full((kvs[0].numdofs, kvs[1].numdofs, left.coeffs.shape[1]),
                     np.nan)
    coeffs[:, 0] = left.coeffs
    coeffs[:, -1] = right.coeffs
    coeffs[0, :] = bottom.coeffs
    coeffs[-1, :] = top.coeffs
    return kvs, coeffs


def disk(r=1.0):
    """NURBS disk (four boundary parametrization singularities)."""
    gR = circular_arc(np.pi / 2)
    gL = gR.copy()
    gL.coeffs = np.flipud(gL.coeffs)
    gL = gL.scale(-1)
    gB = gR.rotate_2d(-np.pi / 2)
    gT = gL.rotate_2d(-np.pi / 2)
    kvs, coeffs = _combine_boundary_curves(gB, gT, gL, gR)
    coeffs[1, 1] = (0.0, 0.0, 0.5)
    if r != 1.0:
        coeffs[:, :, :2] *= r
    return NurbsFunc(kvs, coeffs, None, premultiplied=True)


def unit_cube(dim=3, num_intervals=1):
    """The `dim`-dimensional unit cube."""
    return functools.reduce(
        tensor_product,
        dim * (line_segment(0.0, 1.0, intervals=num_intervals),))


def identity(extents):
    """Identity map over a box given by (min,max) pairs or KnotVectors."""
    extents = [ex.support() if isinstance(ex, KnotVector) else ex
               for ex in extents]
    return functools.reduce(
        tensor_product,
        (line_segment(ex[0], ex[1], support=ex) for ex in extents))


def twisted_box():
    """3D box with its right face twisted and bent upwards
    (gismo twistedFlatQuarterAnnulus.xml)."""
    kv1 = bspline.make_knots(1, 0.0, 1.0, 1)
    kv2 = bspline.make_knots(3, 0.0, 1.0, 1)
    coeffs = np.array([
        1, 0, 0,    2, 0, 0,
        1, 0.5, 0,  2, 1.5, 0,
        0.5, 1, 0.5, 1.5, 2, 0.5,
        0, 1, 2,    0, 2, 2,
        1, 0, 1,    2, 0, 1,
        1, 0.5, 1,  2, 1.5, 1,
        1, 1, 1.5,  1.5, 2, 1.5,
        1, 1, 2,    1, 2, 2,
    ]).reshape((2, 4, 2, 3))
    return BSplineFunc((kv1, kv2, kv1), coeffs)


def line_segment(x0, x1, support=(0.0, 1.0), intervals=1):
    """Linear spline curve between the points/vectors `x0` and `x1`."""
    if np.isscalar(x0):
        x0 = [x0]
    if np.isscalar(x1):
        x1 = [x1]
    assert len(x0) == len(x1), 'Vectors must have same dimension'
    x0 = np.asarray(x0, dtype=float).ravel()
    x1 = np.asarray(x1, dtype=float).ravel()
    S = np.linspace(0.0, 1.0, intervals + 1)[:, None]
    return BSplineFunc(bspline.make_knots(1, support[0], support[1], intervals),
                       (1 - S) * x0 + S * x1)


def circular_arc(alpha, r=1.0):
    """Circular arc of angle `alpha` starting on the positive x axis."""
    if 0.0 < alpha < np.pi:
        return circular_arc_3pt(alpha, r)
    if np.pi <= alpha <= 2 * np.pi:
        return circular_arc_7pt(alpha, r)
    raise ValueError('invalid angle {}'.format(alpha))


def circular_arc_3pt(alpha, r=1.0):
    """Circular arc via 3 control points (0 < alpha < pi)."""
    assert 0.0 < alpha < np.pi, 'Invalid angle'
    kv = bspline.make_knots(2, 0.0, 1.0, 1)
    coeffs = np.array([(np.cos(a), np.sin(a))
                       for a in np.linspace(0, alpha, 3)])
    W = [1.0, np.cos(alpha / 2), 1.0]
    return NurbsFunc(kv, r * coeffs, weights=W, premultiplied=True)


def circular_arc_5pt(alpha, r=1.0):
    """Circular arc via 5 control points."""
    kv = bspline.make_knots(2, 0.0, 1.0, 2, mult=2)
    coeffs = np.array([(np.cos(a), np.sin(a))
                       for a in np.linspace(0, alpha, 5)])
    w = np.cos(alpha / 4)
    return NurbsFunc(kv, r * coeffs, weights=[1.0, w, 1.0, w, 1.0],
                     premultiplied=True)


def circular_arc_7pt(alpha, r=1.0):
    """Circular arc via 7 control points (up to a full circle)."""
    kv = bspline.make_knots(2, 0.0, 1.0, 3, mult=2)
    coeffs = np.array([(np.cos(a), np.sin(a))
                       for a in np.linspace(0, alpha, 7)])
    w = np.cos(alpha / 6)
    return NurbsFunc(kv, r * coeffs, weights=[1, w, 1, w, 1, w, 1],
                     premultiplied=True)


def semicircle(r=1.0):
    """Semicircle in the upper half-plane."""
    return circular_arc_5pt(np.pi, r)


def circle(r=1.0):
    """Full circle of radius `r`."""
    return circular_arc_7pt(2 * np.pi, r)


################################################################################
# Combinators
################################################################################

def _outer_shapes(Cs, sdims):
    SD1, SD2 = (np.atleast_1d(C.shape[:sd]).astype(np.int64)
                for C, sd in zip(Cs, sdims))
    VD1, VD2 = (np.atleast_1d(C.shape[sd:]).astype(np.int64)
                for C, sd in zip(Cs, sdims))
    shape1 = np.concatenate((SD1, np.ones_like(SD2), VD1))
    shape2 = np.concatenate((np.ones_like(SD1), SD2, VD2))
    return np.reshape(Cs[0], shape1), np.reshape(Cs[1], shape2)


def _outer_combine(G1, G2, op):
    if isinstance(G1, NurbsFunc) or isinstance(G2, NurbsFunc):
        G1, G2 = G1.as_nurbs(), G2.as_nurbs()
        C1, W1 = G1.coeffs_weights()
        C2, W2 = G2.coeffs_weights()
        C1, C2 = _outer_shapes((C1, C2), (G1.sdim, G2.sdim))
        W1, W2 = _outer_shapes((W1, W2), (G1.sdim, G2.sdim))
        return NurbsFunc(G1.kvs + G2.kvs, op(C1, C2), W1 * W2)
    assert isinstance(G1, BSplineFunc) and isinstance(G2, BSplineFunc)
    C1, C2 = _outer_shapes((G1.coeffs, G2.coeffs), (G1.sdim, G2.sdim))
    return BSplineFunc(G1.kvs + G2.kvs, op(C1, C2))


def outer_sum(G1, G2):
    """``G(x,y) = G1(y) + G2(x)`` over the combined TP space."""
    return _outer_combine(G1, G2, lambda a, b: a + b)


def outer_product(G1, G2):
    """``G(x,y) = G1(y) * G2(x)`` (componentwise) over the combined TP space."""
    return _outer_combine(G1, G2, lambda a, b: a * b)


def tensor_product(G1, G2, *Gs):
    r"""Tensor product ``G(x,y) = G2(x) x G1(y)`` (output vectors joined);
    `sdim` and `dim` are the sums of the inputs'."""
    if Gs:
        return tensor_product(G1, tensor_product(G2, *Gs))
    if G1.is_scalar():
        G1 = G1.as_vector()
    if G2.is_scalar():
        G2 = G2.as_vector()
    assert G1.is_vector() and G2.is_vector(), \
        'only implemented for scalar- or vector-valued functions'

    nurbs = isinstance(G1, NurbsFunc) or isinstance(G2, NurbsFunc)
    if nurbs:
        G1, G2 = G1.as_nurbs(), G2.as_nurbs()
        CC1, W1 = G1.coeffs_weights()
        CC2, W2 = G2.coeffs_weights()
        Cs = (CC1, CC2)
        WW1, WW2 = _outer_shapes((W1, W2), (G1.sdim, G2.sdim))
        W = WW1 * WW2
    else:
        Cs = (G1.coeffs, G2.coeffs)

    SD1 = np.atleast_1d(Cs[0].shape[:G1.sdim])
    SD2 = np.atleast_1d(Cs[1].shape[:G2.sdim])
    VD1 = np.atleast_1d(Cs[0].shape[G1.sdim:])
    VD2 = np.atleast_1d(Cs[1].shape[G2.sdim:])
    shape1 = np.concatenate((SD1, np.ones_like(SD2), VD1))
    shape2 = np.concatenate((np.ones_like(SD1), SD2, VD2))
    tgt1 = np.concatenate((SD1, SD2, VD1))
    tgt2 = np.concatenate((SD1, SD2, VD2))
    C1 = np.broadcast_to(np.reshape(Cs[0], shape1), tgt1)
    C2 = np.broadcast_to(np.reshape(Cs[1], shape2), tgt2)
    # coefficients are in XY order but coordinate axes in YX order
    C = np.concatenate((C2, C1), axis=-1)

    if nurbs:
        return NurbsFunc(G1.kvs + G2.kvs, C, W)
    return BSplineFunc(G1.kvs + G2.kvs, C)
