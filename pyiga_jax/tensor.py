# -*- coding: utf-8 -*-
"""Low-rank tensor formats and tensor approximation algorithms.

Provides the capabilities of the reference tensor toolbox
(/root/reference/pyiga/tensor.py: mode products, HOSVD, CP/Tucker formats,
ALS and greedy approximation, Kronecker-sum operators), implemented
independently:

* mode products go through explicit matricization (`unfold @ fold`) rather
  than tensordot chains;
* the CP-ALS solver uses the Khatri-Rao / Hadamard-Gram normal equations
  (Kolda & Bader, SIAM Review 2009, Fig. 3.3);
* rank-one least-squares ALS is a single driver with a Galerkin (`spd`)
  and a normal-equations strategy sharing the per-axis Gram bookkeeping;
* the greedy Tucker methods (`gta`, `gta_ls`) share one basis-expansion
  driver;
* the tensor-format classes derive from a common mixin that centralizes
  indexing, squeezing and subtraction.

All of this is host-side numpy/scipy: these are setup/analysis tools; the
device path operates on dense arrays via :func:`apply_tprod` (which XLA maps
to matmuls when traced with jnp inputs).
"""

from functools import reduce

import numpy as np
import scipy.linalg
import scipy.sparse
import scipy.sparse.linalg


__all__ = [
    'matricize', 'modek_tprod', 'apply_tprod', 'fro_norm', 'asarray',
    'outer', 'array_outer', 'pad', 'hosvd', 'find_truncation_rank',
    'als1', 'als', 'grou', 'als1_ls', 'als1_ls_structured', 'gta', 'gta_ls',
    'CanonicalTensor', 'TuckerTensor', 'TensorSum', 'TensorProd',
    'CanonicalOperator', 'join_tucker_bases',
    # star-import parity: the reference module has no __all__, so
    # `from pyiga.tensor import *` also yields its numpy/scipy imports
    'np', 'scipy',
]


# ---------------------------------------------------------------------------
# mode products and elementary array helpers
# ---------------------------------------------------------------------------

def matricize(X, k):
    """Mode-`k` unfolding: a ``(shape[k], prod(other dims))`` matrix whose
    rows are the mode-`k` fibers, remaining axes kept in original order."""
    return np.moveaxis(X, k, 0).reshape(X.shape[k], -1)


def _fold(M, k, shape):
    """Inverse of :func:`matricize`: fold a ``(m, prod(other))`` matrix back
    into a tensor of the given shape with ``shape[k]`` replaced by `m`."""
    inter = (M.shape[0],) + tuple(shape[:k]) + tuple(shape[k + 1:])
    return np.moveaxis(np.asarray(M).reshape(inter), 0, k)


def modek_tprod(B, k, X):
    """Mode-`k` product: apply the matrix (or sparse matrix / LinearOperator)
    `B` along axis `k` of the tensor `X`."""
    return _fold(B @ matricize(X, k), k, X.shape)


def apply_tprod(ops, A):
    """Apply one operator per axis (``None`` = identity) to the tensor `A`.

    Equivalent to multiplying ``vec(A)`` by ``kron(ops[0], ops[1], ...)``.
    Axes beyond ``len(ops)`` are untouched.  Structured tensors that know how
    to apply per-axis operators to themselves (``nway_prod``) are delegated
    to."""
    if hasattr(A, 'nway_prod'):
        return A.nway_prod(ops)
    Y = np.asanyarray(A)
    for k, B in enumerate(ops):
        if B is not None:
            Y = modek_tprod(B, k, Y)
    return Y


def fro_norm(X):
    """Frobenius norm of an array or structured tensor."""
    try:
        return X.norm()
    except AttributeError:
        return np.linalg.norm(np.ravel(X))


def asarray(X):
    """Densify a structured tensor; pass numpy arrays/scalars through."""
    try:
        return X.asarray()
    except AttributeError:
        return np.asanyarray(X)


def outer(*xs):
    """Outer product of vectors: ``outer(x, y, z)[i,j,k] = x[i] y[j] z[k]``."""
    return reduce(np.multiply.outer, xs)


#: Outer product of arbitrary-dimensional arrays (axes concatenate) —
#: identical computation, kept as a named alias for reference-API parity.
array_outer = outer


def pad(X, pad_width):
    """Zero-pad `X`; `pad_width` has one ``(before, after)`` entry (or
    ``None`` for no padding) per axis.

    Works for plain arrays and for structured tensors (Tucker/canonical/
    sums), where padding acts on the per-axis factors via embedding
    operators (reference behavior: tensor.py:237)."""
    if len(pad_width) != X.ndim:
        raise ValueError('invalid length of pad_width')
    widths = [(0, 0) if w is None else tuple(w) for w in pad_width]
    if hasattr(X, 'nway_prod'):
        ops = []
        for (before, after), n in zip(widths, X.shape):
            if before == 0 and after == 0:
                ops.append(None)
            else:
                ops.append(scipy.sparse.eye(
                    n + before + after, n, k=-before, format='csr'))
        return X.nway_prod(ops)
    return np.pad(np.asanyarray(X), widths)


def _normalize_indices(I, shape):
    """Canonicalize an indexing expression over `shape`.

    Returns ``(per_axis, new_shape, singletons)`` where each `per_axis`
    entry is a ``range`` (for scalars and slices) or an integer array (for
    fancy indices), `new_shape` keeps scalar axes as length-1, and
    `singletons` lists the scalar-indexed axes (to be squeezed)."""
    idx = I if isinstance(I, tuple) else (I,)
    if len(idx) > len(shape):
        raise ValueError('got %d indices but have only %d axes'
                         % (len(idx), len(shape)))
    idx = idx + (len(shape) - len(idx)) * (slice(None),)

    per_axis, new_shape, singletons = [], [], []
    for ax, (spec, n) in enumerate(zip(idx, shape)):
        if isinstance(spec, slice):
            sel = range(n)[spec]
        elif np.isscalar(spec):
            pos = range(n)[spec]        # bounds check + negative wrap
            sel = range(pos, pos + 1)
            singletons.append(ax)
        else:
            sel = np.arange(n)[spec]
        per_axis.append(sel)
        new_shape.append(len(sel))
    return tuple(per_axis), tuple(new_shape), tuple(singletons)


def _selection_matrix(sel, n):
    """Sparse 0/1 matrix extracting the rows `sel` from a length-`n` axis."""
    m = len(sel)
    return scipy.sparse.csr_matrix(
        (np.ones(m), (np.arange(m), np.fromiter(sel, dtype=np.intp, count=m))),
        shape=(m, n))


def _multi_kron(mats):
    return reduce(lambda a, b: scipy.sparse.kron(a, b, format='csr'), mats)


# ---------------------------------------------------------------------------
# HOSVD and rank truncation
# ---------------------------------------------------------------------------

def hosvd(X):
    """Higher-order SVD: returns a :class:`TuckerTensor` with orthonormal
    per-axis bases and an all-orthogonal core; lossless at full rank."""
    Us = []
    for k in range(X.ndim):
        U, _, _ = np.linalg.svd(matricize(X, k), full_matrices=False)
        Us.append(U)
    core = apply_tprod([U.T for U in Us], X)
    return TuckerTensor(Us, core)


def find_truncation_rank(X, tol=1e-12):
    """Per-axis ranks such that truncating the (all-orthogonal) core `X` to
    them keeps the Frobenius error below `tol`.

    The error budget ``tol**2`` is split across axes; per axis the trailing
    slices whose cumulative squared norm fits the budget are discarded
    (conservative: slice norms only shrink as other axes truncate)."""
    d = X.ndim
    if X.size == 0:
        return X.shape
    budget = tol ** 2 / max(d, 1)
    ranks = []
    for k in range(d):
        s = np.einsum('ij,ij->i', *2 * (matricize(X, k),))
        tail = np.cumsum(s[::-1])[::-1]         # tail[j] = sum_{i >= j} s[i]
        significant = np.nonzero(tail > budget)[0]
        ranks.append(int(significant[-1]) + 1 if significant.size else 1)
    return tuple(ranks)


# ---------------------------------------------------------------------------
# rank-one approximation (higher-order power iteration)
# ---------------------------------------------------------------------------

def _unit_seed(n, axis):
    """Deterministic, generically-positioned start vector."""
    v = np.cos(np.arange(n) + 0.7 * axis) + 1.5
    return v / np.linalg.norm(v)


def _fiber(A, us, k):
    """Contract every axis but `k` of `A` with the vectors `us` (as rows)."""
    rows = [None if j == k else u[None, :] for j, u in enumerate(us)]
    return asarray(apply_tprod(rows, A)).reshape(-1)


def als1(A, tol=1e-15, maxiter=5000):
    """Best rank-one approximation of the tensor(-like) `A` by higher-order
    power iteration.  Returns one vector per axis whose outer product
    approximates `A` (reference behavior: tensor.py:281)."""
    us = [_unit_seed(n, k) for k, n in enumerate(A.shape)]
    sigma = None
    for _ in range(maxiter):
        for k, _n in enumerate(A.shape):
            w = _fiber(A, us, k)
            scale = np.linalg.norm(w)
            if scale == 0.0:
                us[k] = w       # exact zero tensor: return zeros
                return us
            us[k] = w / scale
        if sigma is not None and abs(scale - sigma) <= tol * abs(scale):
            break
        sigma = scale
    us[0] = us[0] * scale
    return us


def als(A, R, tol=1e-10, maxiter=10000, startval=None):
    """Rank-`R` CP approximation of the dense tensor `A` by alternating
    least squares in the Khatri-Rao / Hadamard-Gram formulation
    (Kolda & Bader 2009; reference behavior: tensor.py:313).  Structured
    tensors (Tucker/canonical/sums) are accepted and densified."""
    A = np.asarray(asarray(A))
    d = A.ndim
    if startval is None:
        rng = np.random.RandomState(51243)
        factors = [rng.standard_normal((n, R)) for n in A.shape]
    elif isinstance(startval, CanonicalTensor):
        factors = [np.array(X) for X in startval.Xs]
    else:
        factors = [np.array(X) for X in startval]
    unfolds = [matricize(A, k) for k in range(d)]
    grams = [F.T @ F for F in factors]

    for _ in range(maxiter):
        drift = 0.0
        for k in range(d):
            others = [factors[j] for j in range(d) if j != k]
            V = np.multiply.reduce([grams[j] for j in range(d) if j != k])
            W = reduce(scipy.linalg.khatri_rao, others)
            Fk = np.linalg.lstsq(V.T, (unfolds[k] @ W).T, rcond=None)[0].T
            drift = max(drift, np.linalg.norm(Fk - factors[k]))
            factors[k] = Fk
            grams[k] = Fk.T @ Fk
        if drift < tol:
            break
    return CanonicalTensor(factors)


def grou(B, R, tol=1e-12, return_errors=False):
    """Greedy rank-one updates: repeatedly subtract the best rank-one
    approximation of the residual (reference behavior: tensor.py:367)."""
    E = np.array(asarray(B), dtype=float)
    terms, errors = [], []
    for _ in range(R):
        xs = als1(E)
        terms.append(tuple(xs))
        E -= outer(*xs)
        # error history AFTER each update, absolute tolerance (reference
        # tensor.py:388-395): errors[-1] is the achieved residual
        err = np.linalg.norm(E.ravel())
        errors.append(err)
        if err < tol:
            break
    if not terms:
        terms = [tuple(np.zeros(n) for n in B.shape)]
    X = CanonicalTensor.from_terms(terms)
    return (X, errors) if return_errors else X


# ---------------------------------------------------------------------------
# rank-one ALS for Kronecker-sum linear systems
# ---------------------------------------------------------------------------

def _axis_gram_tables(A):
    """Per-axis tables of the small operator products ``A_i^T A_j`` used by
    the normal-equations strategy."""
    R, d = len(A), len(A[0])
    return [[[A[i][k].T @ A[j][k] for j in range(R)] for i in range(R)]
            for k in range(d)]


def _solve_small(M, rhs):
    if scipy.sparse.issparse(M):
        return scipy.sparse.linalg.spsolve(M.tocsc(), rhs)
    return np.linalg.solve(M, rhs)


def als1_ls(A, B, tol=1e-15, maxiter=10000, spd=False):
    """Approximate the solution of the Kronecker-sum system
    ``sum_j (A[j][0] (x) ... (x) A[j][d-1]) x = vec(B)`` by a rank-one
    tensor ``outer(*xs)``, via alternating per-axis solves.

    With ``spd=True`` the per-axis system is the Galerkin projection onto
    the current factors (valid for SPD operators); otherwise the
    least-squares normal equations are used.  `B` may be a dense array or
    any structured tensor.  (Reference behavior: tensor.py:400/444/477 —
    here one driver covers all three variants; the sparse 'structured'
    case falls out of scipy's sparse algebra.)"""
    R, d = len(A), len(A[0])
    xs = [_unit_seed(n, k) for k, n in enumerate(B.shape)]
    ys = [[A[j][k] @ xs[k] for k in range(d)] for j in range(R)]
    gram = None if spd else _axis_gram_tables(A)

    for _ in range(maxiter):
        drift = 1.0
        for k in range(d):
            if spd:
                # Galerkin: coefficients <x_l, A_j x_l> over the other axes
                w = np.array([
                    np.prod([xs[m] @ ys[j][m] for m in range(d) if m != k])
                    for j in range(R)])
                M = sum(w[j] * A[j][k] for j in range(R))
                rhs = _fiber(B, xs, k)
            else:
                # normal equations: pairwise overlaps of the mapped factors
                P = np.ones((R, R))
                for m in range(d):
                    if m != k:
                        Y = np.stack([ys[j][m] for j in range(R)])
                        P *= Y @ Y.T
                M = sum(P[i, j] * gram[k][i][j]
                        for i in range(R) for j in range(R))
                rhs = np.zeros(B.shape[k])
                for j in range(R):
                    rhs += A[j][k].T @ _fiber(B, ys[j], k)
            xk = _solve_small(M, rhs)
            drift *= np.linalg.norm(xk - xs[k])
            xs[k] = xk
            for j in range(R):
                ys[j][k] = A[j][k] @ xk
        if drift < tol:
            break
    return xs


def als1_ls_structured(A, B, tol=1e-15, maxiter=10000):
    """Sparse-structured rank-one ALS.  The unified :func:`als1_ls` driver
    already performs the per-axis Gram accumulation with sparse matrices
    (the reference kept a separate same-sparsity fast path,
    tensor.py:477)."""
    return als1_ls(A, B, tol=tol, maxiter=maxiter, spd=False)


# ---------------------------------------------------------------------------
# greedy Tucker approximation (for tensors and for linear systems)
# ---------------------------------------------------------------------------

def _expand_basis(U, v, rtol=1e-12):
    """Orthogonally extend the column basis `U` by `v` (skip if v is
    numerically inside span(U))."""
    w = v - U @ (U.T @ v)
    nw = np.linalg.norm(w)
    if nw <= rtol * max(np.linalg.norm(v), 1e-300):
        return U, False
    return np.column_stack([U, w / nw]), True


def _orthonormal_columns(vs):
    out = []
    for v in vs:
        n = np.linalg.norm(v)
        out.append((v / n if n > 0 else v)[:, None])
    return out


def gta(A, R, tol=1e-12, rtol=1e-12, return_errors=False):
    """Greedy Tucker approximation of the tensor(-like) `A`: grow one
    orthonormal basis vector per axis per step from the best rank-one
    approximation of the residual, re-projecting the core each step
    (reference behavior: tensor.py:523)."""
    norm_A = fro_norm(A)
    Us = _orthonormal_columns(als1(A))
    T = None
    errors = []
    for _ in range(R):
        core = asarray(apply_tprod([U.T for U in Us], A))
        T = TuckerTensor(Us, core)
        E = TensorSum(A, -T)
        err = fro_norm(E)
        errors.append(err)
        # reference semantics (tensor.py:558): tol is ABSOLUTE, rtol is
        # relative to ||A||
        if err <= tol or err <= rtol * norm_A:
            break
        grew = False
        for k, v in enumerate(als1(E)):
            Us[k], g = _expand_basis(Us[k], v)
            grew = grew or g
        if not grew:
            break
    return (T, errors) if return_errors else T


def gta_ls(A, F, R, tol=1e-12, verbose=0, gs=None, spd=False):
    """Greedy Tucker solver for the Kronecker-sum system ``A x = vec(F)``:
    per step, enrich the per-axis bases from a rank-one ALS solve of the
    residual system, then solve the Galerkin-projected (small, dense)
    system for the Tucker core (reference behavior: tensor.py:584; the
    optional `gs` callback runs Gauss-Seidel sweeps on the projected system
    instead of a dense solve once it grows past 500 unknowns)."""
    d = F.ndim
    rankA = len(A)
    res_ref = fro_norm(F)
    Us = _orthonormal_columns(als1_ls(A, F, tol=tol, spd=spd))
    X = np.zeros(d * (0,))
    UX = None

    for it in range(R):
        # Galerkin projection of every Kronecker term onto the bases
        small = [[Us[k].T @ (A[j][k] @ Us[k]) for k in range(d)]
                 for j in range(rankA)]
        A_U = sum(reduce(np.kron, small[j]) for j in range(rankA))
        F_U = asarray(apply_tprod([U.T for U in Us], F)).ravel()
        core_shape = tuple(U.shape[1] for U in Us)

        if gs is not None and F_U.size > 500:
            # warm-start from the previous core, padded to the new shape
            grow = tuple((0, core_shape[k] - X.shape[k]) for k in range(d))
            x0 = np.pad(X, grow).ravel()
            from .solvers import gauss_seidel
            A_gs = scipy.sparse.csr_matrix(A_U)
            # gauss_seidel updates x0 IN PLACE (returns None); `gs`
            # forward sweeps, like the reference (tensor.py:632)
            gauss_seidel(A_gs, x0, F_U, iterations=int(gs))
            X = x0.reshape(core_shape)
        else:
            X = np.linalg.solve(A_U, F_U).reshape(core_shape)

        UX = TuckerTensor([np.array(U) for U in Us], X)
        if it == R - 1:
            break

        # residual F - A(UX), kept in low-rank form
        terms = [TuckerTensor([A[j][k] @ UX.Us[k] for k in range(d)], -X)
                 for j in range(rankA)]
        Rk = TensorSum(F, *terms)
        res = fro_norm(Rk)
        if verbose >= 1:
            print('gta_ls: it %d  residual %.3e' % (it, res / res_ref))
        if res <= tol * res_ref:
            break
        grew = False
        for k, v in enumerate(als1_ls(A, Rk, tol=tol)):
            Us[k], g = _expand_basis(Us[k], v)
            grew = grew or g
        if not grew:
            break
    return UX


# ---------------------------------------------------------------------------
# tensor format classes
# ---------------------------------------------------------------------------

class _FormatBase:
    """Shared behavior of the structured tensor formats: raveling,
    subtraction, norm, indexing (via per-axis restriction) and squeezing."""

    def ravel(self):
        return self.asarray().ravel()

    def norm(self):
        return np.linalg.norm(self.ravel())

    def __sub__(self, other):
        return self + (-other)

    def _restricted(self, per_axis):
        """Same-format tensor restricted to the given per-axis index
        ranges; default goes through selection-matrix mode products."""
        sels = [_selection_matrix(sel, n)
                for sel, n in zip(per_axis, self.shape)]
        return self.nway_prod(sels)

    def __getitem__(self, I):
        per_axis, new_shape, singletons = _normalize_indices(I, self.shape)
        sub = self._restricted(per_axis)
        return sub.squeeze(axis=singletons) if singletons else sub

    def _squeeze_axes(self, axis):
        if axis is None:
            return tuple(k for k, n in enumerate(self.shape) if n == 1)
        axis = (axis,) if np.isscalar(axis) else tuple(axis)
        if any(self.shape[k] != 1 for k in axis):
            raise ValueError('all given axes must be singletons!')
        return axis


class CanonicalTensor(_FormatBase):
    """CP (canonical polyadic) format: a sum of `R` rank-one terms, stored
    as one ``(n_k, R)`` factor matrix per axis (column `r` of every factor
    belongs to term `r`).  Reference: tensor.py:689."""

    def __init__(self, Xs):
        def as_factor(X):
            X = np.asarray(X)
            return X[:, None] if X.ndim == 1 else X
        self.Xs = tuple(as_factor(X) for X in Xs)
        self.ndim = len(self.Xs)
        self.shape = tuple(X.shape[0] for X in self.Xs)
        ranks = {X.shape[1] for X in self.Xs}
        if len(ranks) != 1:
            raise ValueError('invalid matrix shape')
        self.R = ranks.pop()

    def __repr__(self):
        return 'CanonicalTensor(shape=%s, R=%d)' % (self.shape, self.R)

    # -- constructors ------------------------------------------------------

    @classmethod
    def zeros(cls, shape):
        return cls([np.zeros((n, 1)) for n in shape])

    @classmethod
    def ones(cls, shape):
        return cls([np.ones((n, 1)) for n in shape])

    @classmethod
    def from_terms(cls, terms):
        """Build from an iterable of rank-one terms (tuples of vectors)."""
        cols = list(zip(*terms))
        return cls([np.column_stack(axis_cols) for axis_cols in cols])

    @classmethod
    def from_tensor(cls, A):
        if isinstance(A, CanonicalTensor):
            return A.copy()
        if isinstance(A, TuckerTensor):
            terms = []
            for idx in np.ndindex(*A.R):
                c = A.X[idx]
                if abs(c) > 1e-15:
                    vs = [U[:, i] for U, i in zip(A.Us, idx)]
                    terms.append((c * vs[0],) + tuple(vs[1:]))
            return cls.from_terms(terms) if terms else cls.zeros(A.shape)
        raise TypeError('cannot convert %s to canonical format' % type(A))

    # -- conversions -------------------------------------------------------

    def copy(self):
        return CanonicalTensor([np.array(X) for X in self.Xs])

    def terms(self):
        """Iterate over the rank-one terms as tuples of vectors."""
        for r in range(self.R):
            yield tuple(X[:, r] for X in self.Xs)

    def asarray(self):
        out = np.zeros(self.shape)
        for vs in self.terms():
            out += outer(*vs)
        return out

    # -- algebra -----------------------------------------------------------

    def norm(self):
        # Gram trick: ||T||^2 = sum_ij prod_k <x_k^i, x_k^j>
        G = np.multiply.reduce([X.T @ X for X in self.Xs])
        return float(np.sqrt(max(G.sum(), 0.0)))

    def nway_prod(self, Bs):
        Bs = tuple(Bs)
        if len(Bs) > self.ndim:
            raise ValueError('too many operators')
        Bs = Bs + (self.ndim - len(Bs)) * (None,)
        return CanonicalTensor([X if B is None else np.asarray(B @ X)
                                for B, X in zip(Bs, self.Xs)])

    def __neg__(self):
        return CanonicalTensor((-self.Xs[0],) + self.Xs[1:])

    def __add__(self, other):
        if isinstance(other, CanonicalTensor):
            if self.shape != other.shape:
                raise ValueError('incompatible shapes')
            return CanonicalTensor(
                [np.hstack([X, Y]) for X, Y in zip(self.Xs, other.Xs)])
        if isinstance(other, TuckerTensor):
            return TuckerTensor.from_tensor(self) + other
        if isinstance(other, np.ndarray):
            return self.asarray() + other
        raise TypeError('cannot add CanonicalTensor and %s' % type(other))

    def squeeze(self, axis=None):
        axis = self._squeeze_axes(axis)
        if not axis:
            return self
        remaining = [k for k in range(self.ndim) if k not in axis]
        if not remaining:
            return self.ravel()[0]
        # fold the scalar factors of the squeezed axes into the first
        # remaining factor (columnwise)
        weights = np.multiply.reduce([self.Xs[k][0, :] for k in axis])
        Xs = [self.Xs[k] for k in remaining]
        return CanonicalTensor([Xs[0] * weights[None, :]] + Xs[1:])


class TuckerTensor(_FormatBase):
    """Tucker format: per-axis bases `Us` and a core tensor `X` (`R` is the
    core shape).  Reference: tensor.py:847."""

    def __init__(self, Us, X):
        self.Us = tuple(np.asarray(U) for U in Us)
        self.X = np.asarray(X)
        self.ndim = len(self.Us)
        if self.ndim != self.X.ndim:
            raise ValueError('Incompatible sizes')
        self.shape = tuple(U.shape[0] for U in self.Us)
        self.R = self.X.shape

    def __repr__(self):
        return 'TuckerTensor(shape=%s, R=%s)' % (self.shape, self.R)

    @classmethod
    def zeros(cls, shape):
        return cls.from_tensor(CanonicalTensor.zeros(shape))

    @classmethod
    def ones(cls, shape):
        return cls.from_tensor(CanonicalTensor.ones(shape))

    @classmethod
    def from_tensor(cls, A):
        if isinstance(A, TuckerTensor):
            return A.copy()
        if isinstance(A, CanonicalTensor):
            # superdiagonal core of size R^d
            core = np.zeros(A.ndim * (A.R,))
            core[np.diag_indices(A.R, A.ndim)] = 1.0
            return cls(A.Xs, core)
        return cls([np.eye(n) for n in np.shape(A)], asarray(A))

    def copy(self):
        return TuckerTensor([np.array(U) for U in self.Us],
                            np.array(self.X))

    def asarray(self):
        return apply_tprod(self.Us, self.X)

    def orthogonalize(self):
        """Equivalent Tucker tensor with orthonormal bases (QR of each
        basis folded into the core)."""
        Qs, Rs = zip(*(np.linalg.qr(U) for U in self.Us))
        return TuckerTensor(Qs, apply_tprod(Rs, self.X))

    def norm(self):
        return np.linalg.norm(self.orthogonalize().X.ravel())

    def truncate(self, k):
        """Keep only the first `k` (scalar or per-axis) basis vectors."""
        ks = self.ndim * (k,) if np.isscalar(k) else tuple(k)
        return TuckerTensor(
            [U[:, :r] for U, r in zip(self.Us, ks)],
            self.X[tuple(slice(r) for r in ks)])

    def compress(self, tol=1e-15, rtol=1e-15):
        """Orthogonalize and truncate to the smallest ranks keeping the
        error below ``max(tol, rtol * norm)``."""
        T = self.orthogonalize()
        eps = max(tol, rtol * np.linalg.norm(T.X.ravel()))
        return T.truncate(find_truncation_rank(T.X, eps))

    def nway_prod(self, Bs):
        Bs = tuple(Bs)
        if len(Bs) > self.ndim:
            raise ValueError('too many operators')
        Bs = Bs + (self.ndim - len(Bs)) * (None,)
        return TuckerTensor([U if B is None else np.asarray(B @ U)
                             for B, U in zip(Bs, self.Us)], self.X)

    def __neg__(self):
        return TuckerTensor(self.Us, -self.X)

    def __add__(self, other):
        if isinstance(other, CanonicalTensor):
            other = TuckerTensor.from_tensor(other)
        if isinstance(other, TuckerTensor):
            U, X1, X2 = join_tucker_bases(self, other)
            return TuckerTensor(U, X1 + X2)
        if isinstance(other, np.ndarray):
            return self.asarray() + other
        raise TypeError('cannot add TuckerTensor and %s' % type(other))

    def squeeze(self, axis=None):
        axis = self._squeeze_axes(axis)
        if not axis:
            return self
        remaining = [k for k in range(self.ndim) if k not in axis]
        if not remaining:
            return self.ravel()[0]
        # contract the squeezed axes' (1, R_k) bases into the core
        mats = [self.Us[k] if k in axis else None for k in range(self.ndim)]
        core = apply_tprod(mats, self.X).squeeze(axis=tuple(axis))
        return TuckerTensor([self.Us[k] for k in remaining], core)


def join_tucker_bases(T1, T2):
    """Common-basis representation of two Tucker tensors: returns
    ``(U, X1, X2)`` with stacked bases and zero-embedded cores such that
    ``TuckerTensor(U, Xi)`` equals `Ti`."""
    if T1.shape != T2.shape:
        raise ValueError('incompatible shapes')
    U = [np.column_stack([U1, U2]) for U1, U2 in zip(T1.Us, T2.Us)]
    X1 = pad(T1.X, [(0, r) for r in T2.R])
    X2 = pad(T2.X, [(r, 0) for r in T1.R])
    return U, X1, X2


class TensorSum(_FormatBase):
    """Lazy sum of tensors of identical shape (mixed formats allowed)."""

    def __init__(self, *Xs):
        if not Xs:
            raise ValueError('cannot form sum of empty list of tensors')
        self.Xs = tuple(Xs)
        self.ndim = self.Xs[0].ndim
        self.shape = self.Xs[0].shape
        if not all(X.shape == self.shape for X in self.Xs):
            raise ValueError('all terms of a TensorSum must have the same '
                             'shape (a mismatch would silently broadcast)')

    def __repr__(self):
        return 'TensorSum(%d terms, shape=%s)' % (len(self.Xs), self.shape)

    def asarray(self):
        return reduce(np.add, (asarray(X) for X in self.Xs))

    def nway_prod(self, Bs):
        return TensorSum(*(apply_tprod(Bs, X) for X in self.Xs))

    def __neg__(self):
        return TensorSum(*(-X for X in self.Xs))

    def __add__(self, other):
        return TensorSum(*self.Xs, other)

    def __sub__(self, other):
        return TensorSum(*self.Xs, -other)

    def __getitem__(self, I):
        parts = tuple(X[I] for X in self.Xs)
        if all(np.isscalar(p) for p in parts):
            return sum(parts)
        return TensorSum(*parts)


class TensorProd(_FormatBase):
    """Lazy outer product of tensors (axes concatenate)."""

    def __init__(self, *Xs):
        self.Xs = tuple(Xs)
        self.slices = []
        pos = 0
        for X in self.Xs:
            self.slices.append(slice(pos, pos + X.ndim))
            pos += X.ndim
        self.shape = tuple(n for X in self.Xs for n in X.shape)
        self.ndim = pos

    def __repr__(self):
        return 'TensorProd(%d factors, shape=%s)' % (len(self.Xs), self.shape)

    def asarray(self):
        return array_outer(*(asarray(X) for X in self.Xs))

    def nway_prod(self, Bs):
        Bs = tuple(Bs) + (self.ndim - len(Bs)) * (None,)
        return TensorProd(*(apply_tprod(Bs[s], X)
                            for s, X in zip(self.slices, self.Xs)))

    def __neg__(self):
        return TensorProd(-self.Xs[0], *self.Xs[1:])

    def __add__(self, other):
        return TensorSum(self, other)

    def __sub__(self, other):
        return TensorSum(self, -other)

    def __getitem__(self, I):
        idx = I if isinstance(I, tuple) else (I,)
        if len(idx) > self.ndim:
            raise ValueError('too many indices')
        idx = idx + (self.ndim - len(idx)) * (slice(None),)
        parts = tuple(X[idx[s]] for s, X in zip(self.slices, self.Xs))
        if all(np.isscalar(p) for p in parts):
            return float(np.prod(parts))
        return TensorProd(*parts)


# ---------------------------------------------------------------------------
# sum-of-Kronecker operators
# ---------------------------------------------------------------------------

class CanonicalOperator:
    """A sum of Kronecker products of per-axis matrices,
    ``sum_r A_r^(0) (x) ... (x) A_r^(d-1)``.

    Stored axis-major (one list of `R` matrices per axis) — the natural
    layout for per-axis algebra; the constructor and :attr:`terms` use the
    term-major convention of the reference (tensor.py:1158)."""

    def __init__(self, terms):
        terms = [tuple(t) for t in terms]
        if not terms:
            raise ValueError('need at least one Kronecker term')
        d = len(terms[0])
        self._axis_ops = [[t[k] for t in terms] for k in range(d)]
        self.R = len(terms)
        self.ndim = d
        for k in range(d):
            shapes = {op.shape for op in self._axis_ops[k]}
            if len(shapes) != 1:
                raise ValueError('inconsistent operator shapes on axis %d' % k)
        self.shape = (tuple(ops[0].shape[0] for ops in self._axis_ops),
                      tuple(ops[0].shape[1] for ops in self._axis_ops))

    @property
    def terms(self):
        return [tuple(self._axis_ops[k][r] for k in range(len(self._axis_ops)))
                for r in range(self.R)]

    def __repr__(self):
        return 'CanonicalOperator(R=%d, shape=%s)' % (self.R, self.shape)

    @staticmethod
    def eye(ns, format='dia'):
        return CanonicalOperator(
            [tuple(scipy.sparse.identity(n, format=format) for n in ns)])

    def asmatrix(self, format='csr'):
        M = reduce(lambda a, b: a + b,
                   (_multi_kron(t) for t in self.terms))
        return M.asformat(format)

    @property
    def T(self):
        return CanonicalOperator([tuple(op.T for op in t)
                                  for t in self.terms])

    def apply(self, X):
        if np.shape(X) != () and X.shape != self.shape[1]:
            raise ValueError('wrong shape of input tensor')
        results = (apply_tprod(t, X) for t in self.terms)
        return reduce(lambda a, b: a + b, results)

    def __matmul__(self, other):
        if isinstance(other, CanonicalOperator):
            return self * other
        return self.apply(other)

    def __add__(self, other):
        if not isinstance(other, CanonicalOperator):
            return NotImplemented
        if self.shape != other.shape:
            raise ValueError('incompatible shapes')
        return CanonicalOperator(self.terms + other.terms)

    def __neg__(self):
        return CanonicalOperator(
            [(-t[0],) + t[1:] for t in self.terms])

    def __sub__(self, other):
        return self + (-other)

    def __mul__(self, other):
        if not isinstance(other, CanonicalOperator):
            raise TypeError('can only compose with CanonicalOperator')
        if self.shape[1] != other.shape[0]:
            raise ValueError('incompatible shapes')
        return CanonicalOperator(
            [tuple(a @ b for a, b in zip(s, t))
             for s in self.terms for t in other.terms])

    def kron(self, other):
        return CanonicalOperator(
            [s + t for s in self.terms for t in other.terms])

    def slice(self, limits):
        """Restrict every axis to ``limits[k] = (start, stop)`` (both rows
        and columns)."""
        return CanonicalOperator(
            [tuple(op[lo:hi, lo:hi] for op, (lo, hi) in zip(t, limits))
             for t in self.terms])
