# -*- coding: utf-8 -*-
"""Abstract representation of variational forms.

API parity with the reference's UFL-like form language
(/root/reference/pyiga/vform.py) — the same operators (`grad`, `inner`,
`div`, `dx`, ...), `VForm` class, predefined forms, and string parser
(`parse_vf`).

The *lowering* is fundamentally different from the reference's
Cython code generation: expressions evaluate **numerically** (to traced JAX
arrays over the Gauss grid) inside the assembly jit.  Basis functions enter
as symbolic *seeds*: the coefficient field of a derivative/component
combination ``(Du, Dv)`` is obtained by evaluating the (multi-)linear
integrand with the corresponding seed set to 1 and all others 0.  Geometry
quantities (Jacobian, inverse, measures, normals) are fields computed on
device by :mod:`pyiga_jax.ops.geom`.  The resulting per-combination
coefficient fields feed the sum-factorization contraction engine
(:mod:`pyiga_jax.ops.sumfac`), so a VForm compiles to a *contraction plan*
instead of generated source code.

Axis conventions (same as the reference): coordinate index ``k`` in the form
language refers to the ``k``-th physical coordinate in XYZ order, which
corresponds to parameter level axis ``dim-1-k``.  In space-time forms the
time axis is coordinate ``dim-1`` (the first level axis).
"""

import numbers
from enum import IntEnum
from functools import reduce
import operator

import numpy as np


class Scope(IntEnum):
    CONSTANT = 0
    FIELD = 1       # varies per quadrature point, independent of basis funs
    BASISFUN = 2    # depends on basis functions


################################################################################
# Scalar expression nodes
################################################################################

class Expr:
    """Base class for scalar expressions.  Vector/matrix quantities are
    containers of scalar expressions (:class:`VectorExpr`,
    :class:`MatrixExpr`)."""

    shape = ()
    children = ()

    # -- structure ------------------------------------------------------------

    def is_scalar(self):
        return True

    def is_vector(self):
        return False

    def is_matrix(self):
        return False

    def scope(self):
        if self.children:
            return max(c.scope() for c in self.children)
        return Scope.CONSTANT

    def depends_bfuns(self):
        """Set of basis-function names this expression depends on."""
        out = set()
        for c in self.children:
            out |= c.depends_bfuns()
        return out

    def find_vf(self):
        for c in self.children:
            vf = c.find_vf()
            if vf is not None:
                return vf
        return None

    def hash_key(self):
        return (type(self).__name__,)

    def exprhash(self):
        return hash(self.hash_key()
                    + tuple(c.exprhash() for c in self.children))

    def collect_field_keys(self, out):
        for c in self.children:
            c.collect_field_keys(out)

    def max_deriv(self):
        return max([c.max_deriv() for c in self.children], default=0)

    # -- arithmetic -------------------------------------------------------------

    def __add__(self, other):
        other = as_expr(other)
        if isinstance(other, (VectorExpr, MatrixExpr)):
            return other + self             # scalar broadcast
        return AddExpr(self, other)

    def __radd__(self, other):
        return AddExpr(as_expr(other), self)

    def __sub__(self, other):
        other = as_expr(other)
        if isinstance(other, (VectorExpr, MatrixExpr)):
            return (-other) + self          # scalar broadcast
        return AddExpr(self, NegExpr(other))

    def __rsub__(self, other):
        return AddExpr(as_expr(other), NegExpr(self))

    def __mul__(self, other):
        other = as_expr(other)
        if isinstance(other, (VectorExpr, MatrixExpr)):
            return other.scalar_mul(self)
        return MulExpr(self, other)

    def __rmul__(self, other):
        return MulExpr(as_expr(other), self)

    def __truediv__(self, other):
        other = as_expr(other)
        if other.scope() == Scope.BASISFUN:
            raise TypeError('cannot divide by basis function')
        return DivExpr(self, other)

    def __rtruediv__(self, other):
        return DivExpr(as_expr(other), self)

    def __neg__(self):
        return NegExpr(self)

    def __pos__(self):
        return self

    def __pow__(self, y):
        if isinstance(y, ConstExpr) and float(y.value).is_integer():
            y = int(y.value)
        if not isinstance(y, numbers.Integral):
            raise TypeError('only integer powers supported')
        if y < 0:
            return ConstExpr(1.0) / self ** (-y)
        if y == 0:
            return ConstExpr(1.0)
        return reduce(operator.mul, y * [self])

    def __abs__(self):
        return BuiltinFuncExpr('abs', self)

    # -- derivatives -------------------------------------------------------------

    def is_zero(self):
        return False

    def is_constant(self, val):
        return False

    def fold_constants(self):
        """Local constant folding at this node (children assumed folded)."""
        return self

    def dx(self, k, times=1, parametric=False):
        """Partial derivative along the `k`-th coordinate axis."""
        return Dx(self, k, times, parametric)

    def dt(self, times=1):
        """Time derivative (space-time forms)."""
        return Dt(self, times)

    def eval(self, ctx):
        raise NotImplementedError

    def __str__(self):
        return type(self).__name__


class ConstExpr(Expr):
    def __init__(self, value):
        self.value = float(value)

    def is_zero(self):
        return self.is_constant(0.0)

    def is_constant(self, val):
        return abs(self.value - val) < 1e-15

    def _dx_impl(self, k, times, parametric):
        return ConstExpr(0.0) if times > 0 else self

    def hash_key(self):
        return ('const', self.value)

    def eval(self, ctx):
        return self.value

    def __str__(self):
        return str(self.value)


class FieldExpr(Expr):
    """A scalar field on the Gauss grid, identified by a context key (e.g.
    ``('jacinv', m, k)``, ``('gw',)``, ``('absdet',)``, ``('normal', m)``)."""

    def __init__(self, key, name=None):
        self.key = key
        self.name = name or str(key)

    def scope(self):
        return Scope.FIELD

    def hash_key(self):
        return ('field', self.key)

    def collect_field_keys(self, out):
        out.add(self.key)

    def eval(self, ctx):
        return ctx.field(self.key)

    def __str__(self):
        return self.name


class ParamExpr(Expr):
    """A scalar component of a named constant parameter."""

    def __init__(self, param, index):
        self.param = param
        self.index = index

    def scope(self):
        return Scope.CONSTANT

    def hash_key(self):
        return ('param', self.param.name, self.index)

    def collect_field_keys(self, out):
        out.add(('param', self.param.name, self.index))

    def eval(self, ctx):
        return ctx.field(('param', self.param.name, self.index))

    def _dx_impl(self, k, times, parametric):
        # parameters are constants, so any derivative vanishes
        return ConstExpr(0.0) if times > 0 else self

    def __str__(self):
        return '%s[%s]' % (self.param.name, self.index)


class InputFieldExpr(Expr):
    """A scalar component (with optional derivatives) of a named input field.

    `D` is the derivative multi-index in XYZ coordinate order; `physical`
    marks whether the derivative is w.r.t. physical coordinates."""

    def __init__(self, inp, comp, D=None, physical=False):
        self.inp = inp
        self.comp = tuple(comp)
        self.D = tuple(D) if D is not None else inp.vform.dim * (0,)
        self.physical = physical

    def scope(self):
        return Scope.FIELD

    def find_vf(self):
        return self.inp.vform

    def hash_key(self):
        return ('input', self.inp.name, self.comp, self.D, self.physical)

    def max_deriv(self):
        return sum(self.D)

    def _dx_impl(self, k, times, parametric):
        if times == 0:
            return self
        D = list(self.D)
        D[k] += times
        if sum(self.D) > 0 and bool(parametric) == self.physical:
            raise RuntimeError('cannot mix physical and parametric derivatives')
        return InputFieldExpr(self.inp, self.comp, D, physical=not parametric)

    def collect_field_keys(self, out):
        vf = self.inp.vform
        order = sum(self.D)
        if order == 0:
            out.add(('input', self.inp.name, self.comp))
            return
        if self.inp.physical and not self.physical:
            raise RuntimeError('cannot compute parametric derivative of '
                               'physical input field')
        if self.physical and not self.inp.physical:
            # physical derivative of parametric field: expand via chain rule
            self._transformed().collect_field_keys(out)
        else:
            out.add(('input_deriv', self.inp.name, self.comp, self.D))

    def _transformed(self):
        """Physical derivative of a parametric field via the shared
        transform (jacinv chain rule; curvature terms at order 2; time
        stays parametric in space-time forms)."""
        vf = self.inp.vform
        assert sum(self.D) >= 1

        def para(D):
            return InputFieldExpr(self.inp, self.comp, tuple(D),
                                  physical=False)

        return _physical_deriv_transform(vf, self.D, para)

    def eval(self, ctx):
        if sum(self.D) == 0:
            return ctx.field(('input', self.inp.name, self.comp))
        if self.physical and not self.inp.physical:
            return self._transformed().eval(ctx)
        return ctx.field(('input_deriv', self.inp.name, self.comp, self.D))

    def __str__(self):
        s = self.inp.name + (str(list(self.comp)) if self.comp else '')
        if sum(self.D):
            s += '_d%s' % (self.D,)
        return s


class PartialDerivExpr(Expr):
    """Basis function value / partial derivative (scalar).  `D` in XYZ
    coordinate order; `physical` marks physical-coordinate derivatives."""

    def __init__(self, basisfun, D, physical=False):
        self.basisfun = basisfun
        self.D = tuple(D)
        self.physical = bool(physical)

    def scope(self):
        return Scope.BASISFUN

    def depends_bfuns(self):
        return {self.basisfun.name}

    def find_vf(self):
        return self.basisfun.vform

    def hash_key(self):
        return ('pderiv', self.basisfun.name, self.basisfun.component,
                self.D, self.physical)

    def max_deriv(self):
        return sum(self.D)

    def without_derivs(self):
        return PartialDerivExpr(self.basisfun, len(self.D) * (0,))

    def _dx_impl(self, k, times, parametric):
        if times == 0:
            return self
        Dnew = list(self.D)
        if bool(parametric) != (not self.physical) and sum(self.D) != 0:
            raise RuntimeError('cannot mix physical and parametric derivatives')
        Dnew[k] += times
        return PartialDerivExpr(self.basisfun, Dnew, physical=not parametric)

    def collect_field_keys(self, out):
        if self.physical and sum(self.D) > 0:
            self._transformed().collect_field_keys(out)

    def _seed(self, ctx, D):
        return ctx.basis_seed(self.basisfun, tuple(D))

    def _transformed(self):
        """Express the physical derivative in terms of parametric seeds and
        geometry fields (reference: vform.py replace_physical_derivs:554)."""
        vf = self.basisfun.vform
        assert sum(self.D) >= 1 and self.physical

        def para(D):
            return PartialDerivExpr(self.basisfun, tuple(D), physical=False)

        return _physical_deriv_transform(vf, self.D, para)

    def eval(self, ctx):
        if sum(self.D) == 0 or not self.physical:
            return self._seed(ctx, self.D)
        return self._transformed().eval(ctx)

    def __str__(self):
        s = self.basisfun.name
        if self.basisfun.component is not None:
            s += '[%d]' % self.basisfun.component
        if sum(self.D):
            s += '_D%s%s' % (''.join(map(str, self.D)),
                             'p' if self.physical else '')
        return s


def _geo_hess_trf_expr(vf, a, i, j):
    """Expression for the (i, j) entry of the physical Hessian of the a-th
    component of the inverse geometry map:
    ``-sum_{m,e,u} Hp(Geo_m)[e,u] Ji[a,m] Ji[e,i] Ji[u,j]``."""
    d = vf.dim
    Ji = lambda r, c: FieldExpr(('jacinv', r, c))
    terms = []
    for m in range(d):
        for e in range(d):
            for u in range(d):
                D = d * [0]
                D[e] += 1
                D[u] += 1
                terms.append(NegExpr(
                    InputFieldExpr(vf._geo_input, (m,), tuple(D))
                    * Ji(a, m) * Ji(e, i) * Ji(u, j)))
    return reduce(operator.add, terms)


def _physical_deriv_transform(vf, D, para):
    """Express a physical derivative multi-index `D` of a parametric scalar
    quantity as parametric derivatives ``para(D')`` combined with geometry
    fields (jacinv chain rule; order 2 adds the curvature terms of PetIGA
    formula (A.12) with corrected sign — reference vform.py:593,609).
    Space-time forms keep time derivatives parametric and transform only
    the space part (the spatial map is time-independent).  Shared by basis
    functions and input fields — the formulas must live in ONE place."""
    d = vf.dim
    D = tuple(D)

    if vf.spacetime:
        D_x = D[:vf.timedim] + (0,) + D[vf.timedim + 1:]
        n_space = sum(D_x)
        if n_space == 0:
            return para(D)
        if n_space == 1:
            k = D_x.index(1)
            terms = []
            for i in vf.spacedims:
                Di = list(D)
                Di[k] -= 1
                Di[i] += 1
                terms.append(FieldExpr(('jacinv', i, k)) * para(tuple(Di)))
            return reduce(operator.add, terms)
        if n_space == 2:
            # the (time-independent) spatial map commutes with the
            # parametric time derivatives, so the standard second-order
            # transform applies over the space dimensions with the time
            # part of D carried through each parametric seed.
            ij = [k for k, nk in enumerate(D_x) for _ in range(nk)]
            i, j = ij
            D_t = tuple(Dk - Dxk for Dk, Dxk in zip(D, D_x))
            terms = []
            for m in vf.spacedims:
                for n in vf.spacedims:
                    Dmn = list(D_t)
                    Dmn[m] += 1
                    Dmn[n] += 1
                    terms.append(FieldExpr(('jacinv', m, i))
                                 * FieldExpr(('jacinv', n, j))
                                 * para(tuple(Dmn)))
            for a in vf.spacedims:
                Da = list(D_t)
                Da[a] += 1
                terms.append(_geo_hess_trf_expr(vf, a, i, j)
                             * para(tuple(Da)))
            return reduce(operator.add, terms)
        raise NotImplementedError('space-time: space derivatives of '
                                  'order > 2 not supported')

    order = sum(D)
    if order == 1:
        k = D.index(1)
        terms = []
        for m in range(d):
            Dm = d * [0]
            Dm[m] = 1
            terms.append(FieldExpr(('jacinv', m, k)) * para(tuple(Dm)))
        return reduce(operator.add, terms)

    if order == 2:
        idx = [k for k, nk in enumerate(D) for _ in range(nk)]
        i, j = idx
        terms = []
        for m in range(d):
            for n in range(d):
                Dmn = d * [0]
                Dmn[m] += 1
                Dmn[n] += 1
                terms.append(FieldExpr(('jacinv', m, i))
                             * FieldExpr(('jacinv', n, j))
                             * para(tuple(Dmn)))
        for a in range(d):
            Da = d * [0]
            Da[a] = 1
            terms.append(_geo_hess_trf_expr(vf, a, i, j) * para(tuple(Da)))
        return reduce(operator.add, terms)

    raise NotImplementedError('physical derivatives of order > 2 not '
                              'implemented')


class MeasureExpr(Expr):
    """Integration measure: 'dx' (volume) or 'ds' (surface)."""

    def __init__(self, kind):
        self.kind = kind

    def scope(self):
        return Scope.FIELD

    def hash_key(self):
        return ('measure', self.kind)

    def collect_field_keys(self, out):
        out.add(('_measure', self.kind))

    def eval(self, ctx):
        return ctx.field(('_measure', self.kind))

    def __mul__(self, other):
        return MulExpr(self, as_expr(other))

    def __rmul__(self, other):
        other = as_expr(other)
        if isinstance(other, (VectorExpr, MatrixExpr)):
            return other.scalar_mul(self)
        return MulExpr(other, self)

    def __str__(self):
        return self.kind


class AddExpr(Expr):
    def __init__(self, a, b):
        if not (a.is_scalar() and b.is_scalar()):
            raise TypeError('can only add scalar expressions')
        self.children = (a, b)

    def eval(self, ctx):
        return self.children[0].eval(ctx) + self.children[1].eval(ctx)

    def _dx_impl(self, k, times, parametric):
        a, b = self.children
        return Dx(a, k, times, parametric) + Dx(b, k, times, parametric)

    def fold_constants(self):
        a, b = self.children
        if a.is_zero():
            return b
        if b.is_zero():
            return a
        if isinstance(a, ConstExpr) and isinstance(b, ConstExpr):
            return ConstExpr(a.value + b.value)
        return self

    def __str__(self):
        return '(%s + %s)' % self.children


class NegExpr(Expr):
    def __init__(self, a):
        self.children = (a,)

    def eval(self, ctx):
        return -self.children[0].eval(ctx)

    def _dx_impl(self, k, times, parametric):
        return NegExpr(Dx(self.children[0], k, times, parametric))

    def fold_constants(self):
        (a,) = self.children
        if isinstance(a, ConstExpr):
            return ConstExpr(-a.value)
        if isinstance(a, NegExpr):
            return a.children[0]
        return self

    def __str__(self):
        return '(-%s)' % self.children


class MulExpr(Expr):
    def __init__(self, a, b):
        # multiplicative linearity in each basis function
        shared = a.depends_bfuns() & b.depends_bfuns()
        if shared:
            raise TypeError('form must be linear in basis function(s) %s'
                            % sorted(shared))
        self.children = (a, b)

    def eval(self, ctx):
        return self.children[0].eval(ctx) * self.children[1].eval(ctx)

    def _dx_impl(self, k, times, parametric):
        if times == 0:
            return self
        a, b = self.children
        d = Dx(a, k, 1, parametric) * b + a * Dx(b, k, 1, parametric)
        return Dx(d, k, times - 1, parametric) if times > 1 else d

    def fold_constants(self):
        a, b = self.children
        if a.is_zero() or b.is_zero():
            return ConstExpr(0.0)
        if a.is_constant(1):
            return b
        if b.is_constant(1):
            return a
        if isinstance(a, ConstExpr) and isinstance(b, ConstExpr):
            return ConstExpr(a.value * b.value)
        return self

    def __str__(self):
        return '(%s * %s)' % self.children


class DivExpr(Expr):
    def __init__(self, a, b):
        self.children = (a, b)

    def eval(self, ctx):
        return self.children[0].eval(ctx) / self.children[1].eval(ctx)

    def _dx_impl(self, k, times, parametric):
        if times == 0:
            return self
        a, b = self.children
        d = (Dx(a, k, 1, parametric) * b - a * Dx(b, k, 1, parametric)) \
            / (b * b)
        return Dx(d, k, times - 1, parametric) if times > 1 else d

    def fold_constants(self):
        a, b = self.children
        if b.is_zero():
            raise ZeroDivisionError('division by zero in expr %s' % self)
        if a.is_zero():
            return ConstExpr(0.0)
        if b.is_constant(1):
            return a
        if isinstance(a, ConstExpr) and isinstance(b, ConstExpr):
            return ConstExpr(a.value / b.value)
        return self

    def __str__(self):
        return '(%s / %s)' % self.children


class BuiltinFuncExpr(Expr):
    FUNCS = ('sqrt', 'exp', 'log', 'sin', 'cos', 'tan', 'abs')

    def __init__(self, func, x):
        assert func in self.FUNCS
        x = as_expr(x)
        if x.scope() == Scope.BASISFUN:
            raise TypeError('cannot apply nonlinear function %r to basis '
                            'functions' % func)
        self.func = func
        self.children = (x,)

    def hash_key(self):
        return ('func', self.func)

    def eval(self, ctx):
        import jax.numpy as jnp
        x = self.children[0].eval(ctx)
        from .ops import twofloat as tf
        if isinstance(x, tf.DF):
            # two-float pair evaluation (compile.PairAsmContext): only abs
            # and sqrt have double-float implementations; forms using other
            # builtins are gated out of the pair fast path upstream
            # (VFormAssembler._supports_pair_eval)
            if self.func == 'abs':
                return abs(x)
            if self.func == 'sqrt':
                return tf.DF(*tf.df_sqrt(x.pair))
            raise NotImplementedError(
                'no two-float implementation of %r' % self.func)
        fn = {'sqrt': jnp.sqrt, 'exp': jnp.exp, 'log': jnp.log,
              'sin': jnp.sin, 'cos': jnp.cos, 'tan': jnp.tan,
              'abs': jnp.abs}[self.func]
        return fn(x)

    def _dx_impl(self, k, times, parametric):
        if times == 0:
            return self
        x = self.children[0]
        dx_ = Dx(x, k, 1, parametric)
        if self.func == 'sqrt':
            d = dx_ / (ConstExpr(2.0) * self)
        elif self.func == 'exp':
            d = self * dx_
        elif self.func == 'log':
            d = dx_ / x
        elif self.func == 'sin':
            d = BuiltinFuncExpr('cos', x) * dx_
        elif self.func == 'cos':
            d = NegExpr(BuiltinFuncExpr('sin', x)) * dx_
        elif self.func == 'tan':
            d = (ConstExpr(1.0) + self * self) * dx_
        else:
            raise TypeError('do not know how to differentiate %r' % self.func)
        return Dx(d, k, times - 1, parametric) if times > 1 else d

    def __str__(self):
        return '%s(%s)' % (self.func, self.children[0])


################################################################################
# Vector / matrix containers
################################################################################

class VectorExpr:
    """A vector of scalar expressions."""

    def __init__(self, entries):
        self.entries = tuple(as_expr(e) for e in entries)
        assert all(e.is_scalar() for e in self.entries)
        self.shape = (len(self.entries),)

    def is_scalar(self):
        return False

    def is_vector(self):
        return True

    def is_matrix(self):
        return False

    def __len__(self):
        return len(self.entries)

    def __iter__(self):
        return iter(self.entries)

    def __getitem__(self, i):
        if isinstance(i, slice) or isinstance(i, (list, tuple, range)):
            idx = (range(*i.indices(len(self))) if isinstance(i, slice)
                   else i)
            return VectorExpr([self.entries[k] for k in idx])
        return self.entries[i]

    def find_vf(self):
        for e in self.entries:
            vf = e.find_vf()
            if vf is not None:
                return vf
        return None

    def scalar_mul(self, s):
        return VectorExpr([s * e for e in self.entries])

    def __add__(self, other):
        other = as_expr(other)
        if other.is_scalar():       # scalar broadcast, as in the reference
            return VectorExpr([a + other for a in self])
        assert other.is_vector() and other.shape == self.shape
        return VectorExpr([a + b for a, b in zip(self, other)])

    def __radd__(self, other):
        return self + as_expr(other)

    def __sub__(self, other):
        other = as_expr(other)
        if other.is_scalar():
            return VectorExpr([a - other for a in self])
        assert other.is_vector() and other.shape == self.shape
        return VectorExpr([a - b for a, b in zip(self, other)])

    def __rsub__(self, other):
        return (-self) + as_expr(other)

    def __neg__(self):
        return VectorExpr([-e for e in self.entries])

    def __mul__(self, other):
        other = as_expr(other)
        if other.is_scalar():
            return self.scalar_mul(other)
        raise TypeError("use inner/dot for vector-vector products")

    def __rmul__(self, other):
        return self.scalar_mul(as_expr(other))

    def __truediv__(self, other):
        other = as_expr(other)
        assert other.is_scalar()
        return VectorExpr([e / other for e in self.entries])

    def dot(self, other):
        return dot(self, other)

    def dx(self, k, times=1, parametric=False):
        return VectorExpr([Dx(e, k, times, parametric) for e in self.entries])

    def dt(self, times=1):
        return VectorExpr([Dt(e, times) for e in self.entries])

    @property
    def children(self):
        return self.entries

    @children.setter
    def children(self, new):
        new = tuple(new)
        assert len(new) == self.shape[0], 'children length must match shape'
        self.entries = new

    def fold_constants(self):
        return self

    def hash_key(self):
        return ('vector', self.shape)

    def exprhash(self):
        return hash(self.hash_key()
                    + tuple(e.exprhash() for e in self.entries))

    @property
    def T(self):
        return self

    def ravel(self):
        return self

    def __str__(self):
        return 'vec(%s)' % ', '.join(str(e) for e in self.entries)


class MatrixExpr:
    """A matrix of scalar expressions (list of rows)."""

    def __init__(self, rows):
        rows = [list(r) for r in rows]
        self.rows = [[as_expr(e) for e in r] for r in rows]
        n = len(self.rows[0])
        assert all(len(r) == n for r in self.rows)
        self.shape = (len(self.rows), n)

    def is_scalar(self):
        return False

    def is_vector(self):
        return False

    def is_matrix(self):
        return True

    def __getitem__(self, ij):
        if not isinstance(ij, tuple):
            ij = (ij, slice(None))
        i, j = ij
        i_scalar, j_scalar = np.isscalar(i), np.isscalar(j)
        ii = ([i] if i_scalar else list(range(*i.indices(self.shape[0])))
              if isinstance(i, slice) else list(i))
        jj = ([j] if j_scalar else list(range(*j.indices(self.shape[1])))
              if isinstance(j, slice) else list(j))
        sub = [[self.rows[a][b] for b in jj] for a in ii]
        if i_scalar and j_scalar:
            return sub[0][0]
        if i_scalar:
            return VectorExpr(sub[0])
        if j_scalar:
            return VectorExpr([r[0] for r in sub])
        return MatrixExpr(sub)

    def find_vf(self):
        for r in self.rows:
            for e in r:
                vf = e.find_vf()
                if vf is not None:
                    return vf
        return None

    def scalar_mul(self, s):
        return MatrixExpr([[s * e for e in r] for r in self.rows])

    def __add__(self, other):
        other = as_expr(other)
        if other.is_scalar():       # scalar broadcast, as in the reference
            return MatrixExpr([[a + other for a in r] for r in self.rows])
        assert other.is_matrix() and other.shape == self.shape
        return MatrixExpr([[a + b for a, b in zip(r1, r2)]
                           for r1, r2 in zip(self.rows, other.rows)])

    def __radd__(self, other):
        return self + as_expr(other)

    def __sub__(self, other):
        other = as_expr(other)
        if other.is_scalar():
            return MatrixExpr([[a - other for a in r] for r in self.rows])
        assert other.is_matrix() and other.shape == self.shape
        return MatrixExpr([[a - b for a, b in zip(r1, r2)]
                           for r1, r2 in zip(self.rows, other.rows)])

    def __rsub__(self, other):
        return (-self) + as_expr(other)

    def __neg__(self):
        return MatrixExpr([[-e for e in r] for r in self.rows])

    def __mul__(self, other):
        other = as_expr(other)
        if other.is_scalar():
            return self.scalar_mul(other)
        raise TypeError('use dot() for matrix products')

    def __rmul__(self, other):
        return self.scalar_mul(as_expr(other))

    def __truediv__(self, other):
        other = as_expr(other)
        assert other.is_scalar()
        return MatrixExpr([[e / other for e in r] for r in self.rows])

    def __matmul__(self, other):
        return dot(self, as_expr(other))

    def dot(self, other):
        return dot(self, as_expr(other))

    @property
    def children(self):
        return tuple(e for r in self.rows for e in r)

    @children.setter
    def children(self, new):
        new = list(new)
        n = self.shape[1]
        assert len(new) == self.shape[0] * n, \
            'children length must match shape'
        self.rows = [new[i * n:(i + 1) * n] for i in range(self.shape[0])]

    def fold_constants(self):
        return self

    def hash_key(self):
        return ('matrix', self.shape)

    def exprhash(self):
        return hash(self.hash_key()
                    + tuple(e.exprhash() for e in self.children))

    @property
    def T(self):
        return MatrixExpr(list(map(list, zip(*self.rows))))

    def ravel(self):
        return VectorExpr([e for r in self.rows for e in r])

    def __str__(self):
        return 'mat(%s)' % self.rows


################################################################################
# Operator functions (UFL-like; reference vform.py:1518-1734)
################################################################################

def as_expr(x):
    """Coerce a number, tuple, ndarray or expression to an expression."""
    if isinstance(x, (Expr, VectorExpr, MatrixExpr)):
        return x
    if isinstance(x, numbers.Number):
        return ConstExpr(x)
    x_arr = np.asarray(x)
    if x_arr.ndim == 1:
        return VectorExpr([as_expr(v) for v in x_arr])
    if x_arr.ndim == 2:
        return MatrixExpr([[as_expr(v) for v in row] for row in x_arr])
    if isinstance(x, tuple):
        return VectorExpr([as_expr(v) for v in x])
    raise TypeError('cannot coerce %r to expression' % (x,))


def as_vector(x):
    return VectorExpr(x)


def as_matrix(x):
    return MatrixExpr(x)


#: volume integration measure
dx = MeasureExpr('dx')
#: surface integration measure
ds = MeasureExpr('ds')


def Dx(expr, k, times=1, parametric=False):
    """Partial derivative along the `k`-th coordinate axis."""
    expr = as_expr(expr)
    if hasattr(expr, '_dx_impl'):
        return expr._dx_impl(k, times, parametric)
    if expr.is_vector():
        return VectorExpr([Dx(z, k, times, parametric) for z in expr])
    if expr.is_matrix():
        return MatrixExpr([[Dx(z, k, times, parametric) for z in row]
                           for row in expr.rows])
    raise TypeError('do not know how to differentiate %s' % type(expr))


def Dt(expr, times=1):
    """Time derivative (space-time forms only)."""
    expr = as_expr(expr)
    if expr.is_vector():
        return VectorExpr([Dt(z, times) for z in expr])
    vf = expr.find_vf()
    if not vf:
        raise ValueError('could not determine ambient VForm')
    if not vf.spacetime:
        raise TypeError('can only compute time derivatives in spacetime '
                        'assemblers')
    return Dx(expr, vf.timedim, times)


def grad(expr, dims=None, parametric=False):
    """Gradient of a scalar (vector of partials) or vector (Jacobian rows)."""
    expr = as_expr(expr)
    if expr.is_scalar():
        if dims is None:
            vf = expr.find_vf()
            if not vf:
                raise ValueError('could not determine dimensions - '
                                 'please specify dims')
            dims = vf.spacedims
        return VectorExpr([Dx(expr, k, parametric=parametric) for k in dims])
    if expr.is_vector():
        return MatrixExpr([list(grad(z, dims=dims, parametric=parametric))
                           for z in expr])
    raise TypeError('cannot compute gradient of shape %s' % (expr.shape,))


def hess(expr, parametric=False):
    """Hessian matrix of a scalar expression."""
    expr = as_expr(expr)
    if expr.is_scalar():
        return grad(grad(expr, parametric=parametric), parametric=parametric)
    raise TypeError('cannot compute Hessian of shape %s' % (expr.shape,))


def div(expr, parametric=False):
    """Divergence of a vector expression."""
    expr = as_expr(expr)
    if not expr.is_vector():
        raise TypeError('can only compute divergence of vector expression')
    return tr(grad(expr, parametric=parametric))


def curl(expr):
    """Curl of a 3D vector expression."""
    expr = as_expr(expr)
    if not (expr.is_vector() and len(expr) == 3):
        raise TypeError('can only compute curl of 3D vector expression')
    return as_vector((
        expr[2].dx(1) - expr[1].dx(2),
        expr[0].dx(2) - expr[2].dx(0),
        expr[1].dx(0) - expr[0].dx(1),
    ))


def inner(x, y):
    """Componentwise inner product of vectors or matrices."""
    x, y = as_expr(x), as_expr(y)
    if not (x.is_vector() or x.is_matrix()):
        raise TypeError('inner() requires vector or matrix expressions')
    if x.shape != y.shape:
        raise ValueError('incompatible shapes in inner product')
    if x.is_vector():
        return reduce(operator.add, (a * b for a, b in zip(x, y)))
    return reduce(operator.add,
                  (x[i, j] * y[i, j]
                   for i in range(x.shape[0]) for j in range(x.shape[1])))


def dot(a, b):
    """vector.vector inner product, matrix.vector or matrix.matrix product."""
    a, b = as_expr(a), as_expr(b)
    if a.is_vector() and b.is_vector():
        return inner(a, b)
    if a.is_matrix() and b.is_vector():
        assert a.shape[1] == b.shape[0], 'incompatible shapes'
        return VectorExpr([inner(a[i, :], b) for i in range(a.shape[0])])
    if a.is_matrix() and b.is_matrix():
        assert a.shape[1] == b.shape[0], 'incompatible shapes'
        return MatrixExpr([[inner(a[i, :], b[:, j])
                            for j in range(b.shape[1])]
                           for i in range(a.shape[0])])
    raise TypeError('invalid types in dot')


def tr(A):
    """Trace of a square matrix."""
    if not A.is_matrix() or A.shape[0] != A.shape[1]:
        raise ValueError('can only compute trace of square matrices')
    return reduce(operator.add, (A[i, i] for i in range(A.shape[0])))


def minor(A, i, j):
    m, n = A.shape
    B = [[A[ii, jj] for jj in range(n) if jj != j]
         for ii in range(m) if ii != i]
    return det(as_matrix(B))


def det(A):
    """Determinant by cofactor expansion."""
    if not A.is_matrix() or A.shape[0] != A.shape[1]:
        raise ValueError('can only compute determinant of square matrices')
    n = A.shape[0]
    if n == 0:
        return ConstExpr(1)
    if n == 1:
        return A[0, 0]
    return reduce(operator.add,
                  ((-1) ** j * (A[0, j] * minor(A, 0, j)) for j in range(n)))


def inv(A):
    """Matrix inverse via the adjugate."""
    if not A.is_matrix() or A.shape[0] != A.shape[1]:
        raise ValueError('can only compute inverse of square matrices')
    n = A.shape[0]
    invdet = ConstExpr(1) / det(A)
    if n == 1:
        return as_matrix([[invdet]])
    cofacs = as_matrix([[(-1) ** (i + j) * minor(A, i, j) for i in range(n)]
                        for j in range(n)])
    return cofacs.scalar_mul(invdet)


def cross(x, y):
    """Cross product of two 3D vectors."""
    x, y = as_expr(x), as_expr(y)
    assert x.is_vector() and y.is_vector() and len(x) == len(y) == 3
    return as_vector((
        x[1] * y[2] - x[2] * y[1],
        x[2] * y[0] - x[0] * y[2],
        x[0] * y[1] - x[1] * y[0],
    ))


def outer(x, y):
    """Outer product of two vectors."""
    x, y = as_expr(x), as_expr(y)
    assert x.is_vector() and y.is_vector()
    return MatrixExpr([[a * b for b in y] for a in x])


def norm(x):
    """Euclidean norm of a vector."""
    x = as_expr(x)
    if not x.is_vector():
        raise TypeError('expression is not a vector')
    return sqrt(inner(x, x))


def sqrt(x):
    return BuiltinFuncExpr('sqrt', x)


def exp(x):
    return BuiltinFuncExpr('exp', x)


def log(x):
    return BuiltinFuncExpr('log', x)


def sin(x):
    return BuiltinFuncExpr('sin', x)


def cos(x):
    return BuiltinFuncExpr('cos', x)


def tan(x):
    return BuiltinFuncExpr('tan', x)


def _jac_to_unscaled_normal(jac):
    if jac.shape == (2, 1):     # line integral
        x = jac[:, 0]
        return as_vector((-x[1], x[0]))
    if jac.shape == (3, 2):     # surface integral
        return cross(jac[:, 0], jac[:, 1])
    raise ValueError('cannot compute normal for Jacobian shape %s'
                     % (jac.shape,))


################################################################################
# VForm
################################################################################

class BasisFun:
    def __init__(self, name, vform, numcomp=None, space=0, component=None):
        self.name = name
        self.vform = vform
        self.numcomp = numcomp
        self.space = space
        self.component = component

    def hash_key(self):
        return (self.name, self.numcomp, self.space, self.component)


class InputField:
    def __init__(self, name, shape, physical, vform, updatable):
        self.name = name
        self.shape = tuple(shape) if not np.isscalar(shape) else (shape,)
        if shape == ():
            self.shape = ()
        self.physical = physical
        self.vform = vform
        self.updatable = updatable

    def hash_key(self):
        return (self.name, self.shape, self.physical, self.updatable)


class Parameter:
    def __init__(self, name, shape):
        self.name = name
        self.shape = tuple(shape) if not np.isscalar(shape) else (shape,)
        if shape == ():
            self.shape = ()

    def hash_key(self):
        return (self.name, self.shape)


class VForm:
    """Abstract representation of a variational form.

    Args:
        dim: parameter-space dimension.
        geo_dim: dimension of the geometry image (``dim`` for volume
            integrals, ``dim + 1`` for surface integrals).
        boundary: whether this form is integrated over a boundary face.
        arity: 1 (linear functional) or 2 (bilinear form).
        spacetime: space-time form (last coordinate = time).
    """

    def __init__(self, dim, geo_dim=None, boundary=False, arity=2,
                 spacetime=False):
        self.dim = dim
        self.geo_dim = geo_dim if geo_dim is not None else dim
        self.arity = arity
        self.is_boundary = bool(boundary)
        self.vec = False
        self.spacetime = bool(spacetime)
        if self.spacetime:
            self.spacedims = tuple(range(self.dim - 1))
            self.timedim = self.dim - 1
        else:
            self.spacedims = tuple(range(self.dim))

        self.basis_funs = None
        self.inputs = []
        self.params = []
        self.vars = {}
        self.exprs = []
        self.__hash = None

        # geometry is a predefined (parametric) input field
        self._geo_input = InputField('geo', (self.geo_dim,), False, self, False)
        self.inputs.append(self._geo_input)
        if self.is_boundary:
            # register the Jac_to_boundary parameter eagerly so assembler
            # instantiation knows to expect it
            self.Jac_to_boundary

    # -- integral type ------------------------------------------------------------

    def is_volume_integral(self):
        return self.dim == self.geo_dim and not self.is_boundary

    def is_surface_integral(self):
        return self.dim == self.geo_dim - 1 and not self.is_boundary

    def is_boundary_integral(self):
        return self.is_boundary

    # -- predefined quantities -----------------------------------------------------

    @property
    def Geo(self):
        """Physical coordinates (the geometry map) as a vector."""
        return VectorExpr([InputFieldExpr(self._geo_input, (m,))
                           for m in range(self.geo_dim)])

    # alias used by parse_vf ('x')
    @property
    def x(self):
        return self.Geo

    @property
    def Jac(self):
        """Geometry Jacobian: (geo_dim x dim), physical components x
        parametric derivatives (both in XYZ coordinate order)."""
        d = self.dim
        rows = []
        for m in range(self.geo_dim):
            row = []
            for i in range(d):
                D = d * [0]
                D[i] = 1
                row.append(InputFieldExpr(self._geo_input, (m,), tuple(D)))
            rows.append(row)
        return MatrixExpr(rows)

    @property
    def JacInv(self):
        """Inverse geometry Jacobian (volume integrals only), as a field
        computed on device."""
        if not self.is_volume_integral() and not self.is_boundary_integral():
            raise ValueError('JacInv not defined for surface integrals')
        d = self.dim
        return MatrixExpr([[FieldExpr(('jacinv', m, k), 'JacInv[%d,%d]' % (m, k))
                            for k in range(d)] for m in range(d)])

    @property
    def GaussWeight(self):
        return FieldExpr(('gw',), 'GaussWeight')

    @property
    def W(self):
        """Volume integration weight: GaussWeight * |det(Jac)|."""
        if not self.is_volume_integral():
            raise ValueError('volume measure not defined for surface integral')
        return self.GaussWeight * abs(det(self.Jac))

    @property
    def Jac_to_boundary(self):
        if not self.is_boundary_integral():
            raise ValueError('Jac_to_boundary only defined for boundary '
                             'integrals')
        name = 'Jac_to_boundary'
        if not any(p.name == name for p in self.params):
            self.params.append(Parameter(name, (self.dim, self.dim - 1)))
        p = [p for p in self.params if p.name == name][0]
        return MatrixExpr([[ParamExpr(p, (i, j)) for j in range(self.dim - 1)]
                           for i in range(self.dim)])

    @property
    def BJac(self):
        """Boundary Jacobian: (k+1) x k."""
        if self.is_surface_integral():
            return self.Jac
        if self.is_boundary_integral():
            return dot(self.Jac, self.Jac_to_boundary)
        raise ValueError('BJac not defined for volume integrals')

    @property
    def SW(self):
        """Surface integration weight."""
        if self.is_volume_integral():
            raise ValueError('surface measure not defined for volume integral')
        return self.GaussWeight * norm(_jac_to_unscaled_normal(self.BJac))

    @property
    def normal(self):
        """Outward unit normal vector (surface/boundary integrals)."""
        if self.is_volume_integral():
            raise ValueError('normal not defined for volume integrals')
        un = _jac_to_unscaled_normal(self.BJac)
        return un / norm(un)

    # -- construction -----------------------------------------------------------

    def basisfuns(self, components=(None, None), spaces=(0, 0)):
        """Create expressions for the basis functions (trial, test)."""
        if self.basis_funs is not None:
            raise RuntimeError('basis functions have already been constructed')
        ar = self.arity
        if any(nc is not None for nc in components[:ar]):
            self.vec = reduce(operator.mul,
                              (nc if nc else 1 for nc in components[:ar]), 1)

        names = ('u', 'v')
        self.basis_funs = tuple(
            BasisFun(name, self, numcomp=nc, space=space)
            for name, nc, space in zip(names[:ar], components[:ar],
                                       spaces[:ar]))

        def make_expr(bf):
            derivs = self.dim * (0,)
            if bf.numcomp is not None:
                comps = [PartialDerivExpr(
                    BasisFun(bf.name, self, numcomp=bf.numcomp,
                             space=bf.space, component=k), derivs)
                    for k in range(bf.numcomp)]
                return comps[0] if len(comps) == 1 else VectorExpr(comps)
            return PartialDerivExpr(bf, derivs)

        result = tuple(make_expr(bf) for bf in self.basis_funs)
        return result[0] if ar == 1 else result

    def num_components(self):
        """Number of components per basis function space (vector forms)."""
        assert self.vec
        return tuple(bf.numcomp for bf in self.basis_funs)

    def num_spaces(self):
        return len(set(bf.space for bf in self.basis_funs))

    def input(self, name, shape=(), physical=False, updatable=False):
        """Declare a named input field; returns an expression for it."""
        inp = InputField(name, shape, physical, self, updatable)
        self.inputs.append(inp)
        return self._input_as_expr(inp)

    def _input_as_expr(self, inp):
        shp = inp.shape
        if shp == ():
            return InputFieldExpr(inp, ())
        if len(shp) == 1:
            return VectorExpr([InputFieldExpr(inp, (m,))
                               for m in range(shp[0])])
        if len(shp) == 2:
            return MatrixExpr([[InputFieldExpr(inp, (m, n))
                                for n in range(shp[1])]
                               for m in range(shp[0])])
        raise ValueError('input fields of rank > 2 not supported')

    def parameter(self, name, shape=()):
        """Declare a named constant parameter; returns an expression."""
        param = Parameter(name, shape)
        self.params.append(param)
        shp = param.shape
        if shp == ():
            return ParamExpr(param, ())
        if len(shp) == 1:
            return VectorExpr([ParamExpr(param, (m,)) for m in range(shp[0])])
        if len(shp) == 2:
            return MatrixExpr([[ParamExpr(param, (m, n))
                                for n in range(shp[1])]
                               for m in range(shp[0])])
        raise ValueError('parameters of rank > 2 not supported')

    def let(self, name, expr, symmetric=False):
        """Name a subexpression (kept for API parity; XLA CSE makes explicit
        common-subexpression handling unnecessary)."""
        self.vars[name] = expr
        return expr

    def add(self, expr):
        """Add a scalar integrand expression to the form."""
        if self.__hash is not None:
            raise RuntimeError('can no longer modify this VForm')
        if isinstance(expr, (VectorExpr, MatrixExpr)):
            raise TypeError('all expressions added to a VForm must be scalar')
        self.exprs.append(expr)

    # -- analysis ---------------------------------------------------------------

    def finalize(self, do_precompute=True):
        """Freeze the form (reference vform.py:705).

        The reference rewrites the tree here (measures -> weight functions,
        physical -> parametric derivatives) in preparation for source-code
        generation.  In this rebuild those rewrites happen numerically
        during seed-probe lowering (:mod:`pyiga_jax.compile`), so finalize
        only validates the expression trees, computes the cached hash and
        locks the form against further modification.  `do_precompute` is
        accepted for API parity."""
        if getattr(self, '_finalized', False):
            raise RuntimeError('VForm has already been finalized')
        for e in self.exprs:
            if not e.is_scalar():
                raise TypeError('all integrands must be scalar expressions')
            e.collect_field_keys(set())     # validates field references
        self.hash()
        self._finalized = True
        return self

    def hash(self):
        """Deterministic hash of the form (for plan caching)."""
        if self.__hash is None:
            self.__hash = hash((
                self.dim, self.geo_dim, self.arity, self.vec, self.spacetime,
                self.is_boundary,
                tuple(bf.hash_key() for bf in (self.basis_funs or ())),
                tuple(i.hash_key() for i in self.inputs),
                tuple(p.hash_key() for p in self.params),
                tuple(e.exprhash() for e in self.exprs)))
        return self.__hash

    def max_deriv_order(self):
        """Maximum total derivative order applied to basis functions."""
        return max([e.max_deriv() for e in self.exprs], default=0)

    def used_field_keys(self):
        """All context field keys needed to evaluate the form."""
        keys = set()
        for e in self.exprs:
            e.collect_field_keys(keys)
        return keys


################################################################################
# Predefined forms (reference vform.py:1740)
################################################################################

def mass_vf(dim):
    V = VForm(dim)
    u, v = V.basisfuns()
    V.add(u * v * dx)
    return V


def stiffness_vf(dim):
    V = VForm(dim)
    u, v = V.basisfuns()
    B = V.let('B', V.W * dot(V.JacInv, V.JacInv.T), symmetric=True)
    V.add(dot(dot(B, grad(u, parametric=True)), grad(v, parametric=True)))
    return V


def heat_st_vf(dim):
    V = VForm(dim, spacetime=True)
    u, v = V.basisfuns()
    V.add((inner(grad(u), grad(v)) + u.dt() * v) * dx)
    return V


def wave_st_vf(dim):
    V = VForm(dim, spacetime=True)
    u, v = V.basisfuns()
    V.add((u.dt(2) * v.dt() + inner(grad(u), grad(v).dt())) * dx)
    return V


def divdiv_vf(dim):
    V = VForm(dim)
    u, v = V.basisfuns(components=(dim, dim))
    V.add(div(u) * div(v) * dx)
    return V


def L2functional_vf(dim, physical=False, updatable=False):
    V = VForm(dim, arity=1)
    u = V.basisfuns()
    f = V.input('f', shape=(), physical=physical, updatable=updatable)
    V.add(f * u * dx)
    return V


################################################################################
# String parser (reference vform.py:1804)
################################################################################

def _check_input_field(kvs, f):
    """Determine (shape, physical) of an input function: geometry-function
    objects are parametric, plain callables physical."""
    from . import bspline, geometry
    if isinstance(f, geometry._BaseGeoFunc):
        return f.output_shape(), False
    supp = tuple(kv.support() for kv in kvs)
    mid = tuple((a + b) / 2 for a, b in supp)
    return np.shape(f(*mid)), True


def parse_vf(expr, kvs, args=None, bfuns=None, boundary=False, updatable=()):
    """Parse a textual variational form into a :class:`VForm`.

    Identifiers: 'u'/'v' are basis functions (arity auto-detected); names in
    `args` become input fields (callables) or parameters (constants); 'x'
    (coordinates), 'n' (normal), 'gw' (Gauss weight), 'jac' are shorthands;
    presence of 'ds' makes the form a surface/boundary integral."""
    from . import bspline
    if args is None:
        args = {}

    def is_tp_spl(x):
        return all(isinstance(y, bspline.KnotVector) for y in x)
    if is_tp_spl(kvs):
        pass
    elif is_tp_spl(kvs[0]):
        kvs = kvs[0]
    else:
        raise ValueError('expected a tensor product spline space in `kvs`')

    dim = len(kvs)
    loc = {}

    import re
    words = set(re.findall(r"[^\d\W]\w*", expr))

    if bfuns is None:
        bfuns = [(bf, 1, 0) for bf in sorted(words & {'u', 'v'})]
    else:
        norm_bfuns = []
        for bf in bfuns:
            if isinstance(bf, str):
                bf = (bf,)
            bf = tuple(bf) + ((1,) if len(bf) == 1 else ())
            bf = bf + ((0,) if len(bf) == 2 else ())
            norm_bfuns.append(bf)
        bfuns = norm_bfuns

    geo_dim = dim
    if 'ds' in words:
        if 'dx' in words:
            raise RuntimeError("got both 'dx' and 'ds' - is this a volume or "
                               "a surface integral?")
        if not boundary:
            geo_dim += 1

    arity = len(bfuns)
    if arity not in (1, 2):
        raise ValueError('arity should be 1 or 2')
    vf = VForm(dim=dim, geo_dim=geo_dim, boundary=boundary, arity=arity)

    components = tuple(bf[1] for bf in bfuns)
    if all(c == 1 for c in components):
        components = len(components) * (None,)
    spaces = tuple(bf[2] for bf in bfuns)

    if arity == 1:
        loc[bfuns[0][0]] = vf.basisfuns(components=components, spaces=spaces)
    else:
        u, v = vf.basisfuns(components=components, spaces=spaces)
        loc[bfuns[0][0]] = u
        loc[bfuns[1][0]] = v

    for inp in sorted(set(args.keys()) & words):
        upd = inp in updatable
        if callable(args[inp]):
            shp, phys = _check_input_field(kvs, args[inp])
            loc[inp] = vf.input(inp, shape=shp, physical=phys, updatable=upd)
        else:
            loc[inp] = vf.parameter(inp, shape=np.shape(args[inp]))

    if 'x' in words and 'x' not in args:
        loc['x'] = vf.Geo
    if 'n' in words and 'n' not in args:
        loc['n'] = vf.normal
    if 'gw' in words and 'gw' not in args:
        loc['gw'] = vf.GaussWeight
    if 'jac' in words and 'jac' not in args:
        loc['jac'] = vf.Jac

    vf.add(eval(expr, globals(), loc))
    return vf


# -- expression-tree utilities (reference API: vform.py iterexprs/exprhash/
# tree_print; this rebuild's expression nodes expose `children`) ------------

def iterexprs(exprs):
    """Depth-first iteration over expressions and all their children."""
    seen = set()
    stack = list(exprs)
    while stack:
        e = stack.pop()
        if id(e) in seen:
            continue
        seen.add(id(e))
        yield e
        stack.extend(e.children)


def exprhash(e):
    """Structural hash of an expression (equal trees hash equally)."""
    return e.exprhash()


def tree_print(e, indent=0, stream=None):
    """Print an expression tree with indentation."""
    import sys
    out = stream or sys.stdout
    out.write('%s%s\n' % (indent * '  ', e))
    for c in e.children:
        tree_print(c, indent + 1, stream=out)


def set_union(sets):
    """Union of an iterable of sets (reference vform.py:15)."""
    out = set()
    for s in sets:
        out |= s
    return out


def sym_index_to_seq(n, i, j):
    """Sequential index of entry (i, j) in the linearized upper triangle of
    an n x n symmetric matrix (reference vform.py:28)."""
    if i > j:
        i, j = j, i
    return sum(n - k for k in range(i)) + (j - i)


def mapexprs(exprs, fun, deep=False):
    """Replace every node `e` in the given expression trees by ``fun(e)``,
    depth first, rewriting the ``children`` tuples in place (reference
    vform.py:1432; `deep` is accepted for API parity — this rebuild's
    nodes hold no variable indirection to follow)."""
    seen = set()

    def recurse(es):
        out = []
        for e in es:
            if id(e) not in seen:
                seen.add(id(e))
                if e.children:
                    e.children = recurse(e.children)
            out.append(fun(e))
        return tuple(out)
    return recurse(tuple(exprs))


def make_applyfun(fun, type):
    """Wrap `fun` so it applies only to nodes of the given type and keeps
    other nodes (and None results) unchanged."""
    def applyfun(e):
        e2 = fun(e) if (type is None or isinstance(e, type)) else None
        return e if e2 is None else e2
    return applyfun


def transform_exprs(exprs, fun, type=None, deep=False):
    """Apply a type-filtered transformation over expression trees."""
    return mapexprs(exprs, make_applyfun(fun, type), deep=deep)


def transform_expr(expr, fun, type=None, deep=False):
    """Single-tree variant of :func:`transform_exprs`."""
    return transform_exprs((expr,), fun, type=type, deep=deep)[0]


def _to_literal_vec_mat(e):
    """Reference-API shim (vform.py uses it to lower symbolic vector/matrix
    nodes to literal containers): our vectors and matrices are *already*
    literal containers of scalars, so this is the identity."""
    return e
