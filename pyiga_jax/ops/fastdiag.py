# -*- coding: utf-8 -*-
"""Device-side fast-diagonalization preconditioner [Sangalli, Tani 2016].

The parameter-domain operator ``sum_d K_d (x) M_... `` is diagonalized by
per-axis generalized eigendecompositions ``K_k U_k = M_k U_k diag(lam_k)``
(host-side, tiny 1D matrices); its inverse then applies as

    P^{-1} = (U_1 (x) ... (x) U_d) D^{-1} (U_1^T (x) ... (x) U_d^T)

— 2d dense (n_k, n_k) matmuls plus a diagonal scale.  Used as
a geometry-robust preconditioner for CG on mapped stiffness problems (the
device analog of the reference's host-side fastdiag_solver, solvers.py:17).
"""

import numpy as np
import jax
import jax.numpy as jnp
import scipy.linalg

from .. import config
from .sumfac import _dot_precision


def _build_precond(KM, full_shape, free_dofs, dirichlet, dtype, mass_shift):
    """Shared eigen-tail: per-axis restriction, eigendecomposition,
    eigenvalue-sum diagonal with singularity guard, and operator build.

    `KM` is the list of full per-axis ``(K_k, M_k)`` dense matrices.  A
    *box-shaped* `free_dofs` set (e.g. :func:`interior_dofs`) restricts the
    per-axis eigenproblems exactly — the preconditioner then IS the fast
    diagonalization of the restricted operator, and free-dof vectors map by
    plain reshape.  A non-box set falls back to extend-apply-restrict
    around the unrestricted diagonalization (approximate; combine with
    ``mass_shift`` if the unrestricted operator is singular)."""
    from .matfree import box_restriction

    if dirichlet and free_dofs is not None:
        raise ValueError('pass either dirichlet=True or free_dofs, not both')

    slices = None
    free = None
    if free_dofs is not None:
        free_np = np.asarray(free_dofs, dtype=np.int64)
        n_full = int(np.prod(full_shape))
        if free_np.size and (free_np.min() < 0 or free_np.max() >= n_full):
            raise ValueError('free_dofs out of range for the space '
                             '(did you combine it with dirichlet=True?)')
        box = box_restriction(free_np, full_shape)
        if box is not None:
            lo, box_shape = box
            slices = [slice(l, l + s) for l, s in zip(lo, box_shape)]
        else:
            free = jnp.asarray(free_np)
    if dirichlet:
        slices = [slice(1, -1)] * len(KM)

    Us, UTs, lams, ns = [], [], [], []
    for k, (K, M) in enumerate(KM):
        if slices is not None:
            K = K[slices[k], slices[k]]
            M = M[slices[k], slices[k]]
        lam, U = scipy.linalg.eigh(K, M)
        # M-orthonormal eigenvectors: U^T M U = I, U^T K U = diag(lam)
        Us.append(jnp.asarray(U, dtype=dtype))
        UTs.append(jnp.asarray(U.T, dtype=dtype))
        lams.append(lam)
        ns.append(U.shape[0])

    d = len(KM)
    diag = np.full(tuple(ns), float(mass_shift))
    for k in range(d):
        shape = [1] * d
        shape[k] = -1
        diag = diag + lams[k].reshape(shape)
    if np.min(np.abs(diag)) < 1e-12 * np.max(np.abs(diag)):
        import warnings
        warnings.warn(
            'fastdiag preconditioner is nearly singular: the pure-Neumann '
            'operator has a zero eigenvalue on an unrestricted space. Pass '
            'dirichlet=True or a box-shaped free_dofs set for a Dirichlet '
            'problem, or mass_shift>0 for an operator with a mass term.')
    inv_diag = jnp.asarray(1.0 / diag, dtype=dtype)
    ns = tuple(ns)
    return _FastDiagPrecond(Us, UTs, inv_diag, ns, int(np.prod(ns)), free)


def fastdiag_precond(kvs, free_dofs=None, dirichlet=False, dtype=None,
                     mass_shift=0.0):
    """Build a traced preconditioner function for the Laplace + (optional)
    identity operator over the TP space `kvs`.

    Args:
        kvs: knot vectors of the space.
        free_dofs: optional raveled free-dof indices.  A box-shaped set
            (e.g. :func:`interior_dofs`) restricts the per-axis
            eigenproblems exactly; other sets use extend-apply-restrict
            around the unrestricted diagonalization.
        dirichlet: eliminate the boundary dofs per axis before
            diagonalization (matches an 'all'-Dirichlet restricted system).
        mass_shift: added to the eigenvalue sum; use a positive value (e.g.
            1.0 for a Laplace + identity operator) on spaces without
            Dirichlet conditions, where the pure Neumann Laplacian is
            singular (zero eigenvalue).

    Returns a function ``precond(r) -> z`` suitable for
    :func:`pyiga_jax.solvers.cg_jit`.
    """
    from ..assemble import bsp_mass_1d, bsp_stiffness_1d

    dtype = dtype if dtype is not None else config.get_dtype()
    KM = [(bsp_stiffness_1d(kv).toarray(), bsp_mass_1d(kv).toarray())
          for kv in kvs]
    full_shape = tuple(kv.numdofs for kv in kvs)
    return _build_precond(KM, full_shape, free_dofs, dirichlet, dtype,
                          mass_shift)


class _FastDiagPrecond:
    """Callable preconditioner following the operand protocol (large arrays
    threaded through jit as arguments, see solvers.cg_jit)."""

    def __init__(self, Us, UTs, inv_diag, ns, n_total, free):
        self.operands = {'Us': Us, 'UTs': UTs, 'inv_diag': inv_diag,
                         'free': free}
        d = len(ns)

        def apply_with_operands(operands, r):
            free = operands['free']
            if free is not None:
                rf = r
                r = jnp.zeros(n_total, dtype=rf.dtype).at[free].set(rf)
            X = r.reshape(ns)
            for k in range(d):
                X = jnp.moveaxis(
                    jnp.tensordot(operands['UTs'][k], X, axes=(1, k),
                                  precision=_dot_precision(X.dtype)), 0, k)
            X = X * operands['inv_diag']
            for k in range(d):
                X = jnp.moveaxis(
                    jnp.tensordot(operands['Us'][k], X, axes=(1, k),
                                  precision=_dot_precision(X.dtype)), 0, k)
            out = X.reshape(-1)
            if free is not None:
                out = out[free]
            return out

        self.apply_with_operands = apply_with_operands
        self._jit_apply = jax.jit(apply_with_operands)

    def __call__(self, r):
        return self._jit_apply(self.operands, r)


def interior_dofs(kvs):
    """Raveled indices of the per-axis interior dofs (all-Dirichlet case)."""
    ranges = [np.arange(1, kv.numdofs - 1) for kv in kvs]
    shape = tuple(kv.numdofs for kv in kvs)
    grid = np.meshgrid(*ranges, indexing='ij')
    return np.ravel_multi_index([g.ravel() for g in grid], shape)


# jitted per-axis mean evaluators, cached per dimension (a fresh jit per
# call would re-trace; returning only the 1D coefficient vectors keeps the
# device->host transfer to a few KB instead of d+1 grid-sized pulls)
_AXIS_MEANS_JIT = {}


def _axis_means_fn(d, nslabs=1):
    fn = _AXIS_MEANS_JIT.get((d, nslabs))
    if fn is not None:
        return fn
    from ..assemblers import _geo_weight_jacinv

    def axis_means(gi):
        W, jacinv = _geo_weight_jacinv(gi)
        gw = [jnp.asarray(w) for w in gi['weights']]
        Wg = gw[0]
        for w in gw[1:]:
            Wg = jnp.multiply.outer(Wg, w)
        outs = []
        for k in range(d):
            axes = tuple(j for j in range(d) if j != k)
            Bkk = W * sum(jacinv[k][m] ** 2 for m in range(d))
            c = (Bkk / Wg).mean(axis=axes) * gw[k] if axes \
                else (Bkk / Wg) * gw[k]
            m = (W / Wg).mean(axis=axes) * gw[k] if axes \
                else (W / Wg) * gw[k]
            outs.append((c, m))
        return outs

    def axis_means_slabbed(gi):
        # big grids: the full-grid f64 Jacobian/inverse intermediates of
        # `axis_means` are O(d^2 * prod(Q_k)) and blow HBM (measured:
        # 19.6 GB at 3D n=96) for a result that is d small 1D vectors.
        # Accumulate the sums over sequential slabs of grid axis 0
        # (lax.map: one slab's intermediates live at a time).
        key = ('geo_tables_nurbs' if 'geo_tables_nurbs' in gi
               else 'geo_tables_bsp')
        T0 = jnp.asarray(gi[key][0])            # (nderiv+1, Q_0, n_0)
        w0 = jnp.asarray(gi['weights'][0])
        S = nslabs
        Q = tuple(len(w) for w in gi['weights'])
        T0s = jnp.swapaxes(
            T0.reshape(T0.shape[0], S, Q[0] // S, T0.shape[2]), 0, 1)
        w0s = w0.reshape(S, Q[0] // S)
        gw_rest = [jnp.asarray(w) for w in gi['weights'][1:]]

        def one(slab):
            T0k, w0k = slab
            gi2 = dict(gi, weights=[w0k] + list(gi['weights'][1:]))
            gi2[key] = [T0k] + list(gi[key][1:])
            W, jacinv = _geo_weight_jacinv(gi2)
            Wg = w0k
            for w in gw_rest:
                Wg = jnp.multiply.outer(Wg, w)
            outs = []
            for k in range(d):
                axes = tuple(j for j in range(d) if j != k)
                Bkk = W * sum(jacinv[k][m] ** 2 for m in range(d))
                outs.append(((Bkk / Wg).sum(axis=axes),
                             (W / Wg).sum(axis=axes)))
            return outs

        parts = jax.lax.map(one, (T0s, w0s))
        gw = [jnp.asarray(w) for w in gi['weights']]
        outs = []
        for k in range(d):
            cnt = float(np.prod([Q[j] for j in range(d) if j != k]))
            sc, sm = parts[k]
            if k == 0:
                sc, sm = sc.reshape(-1), sm.reshape(-1)   # (S, Q0/S)
            else:
                sc, sm = sc.sum(axis=0), sm.sum(axis=0)   # (S, Qk)
            outs.append(((sc / cnt) * gw[k], (sm / cnt) * gw[k]))
        return outs

    fn = _AXIS_MEANS_JIT[(d, nslabs)] = jax.jit(
        axis_means if nslabs == 1 else axis_means_slabbed)
    return fn


def fastdiag_precond_weighted(asm, free_dofs=None, dirichlet=False,
                              dtype=None, mass_shift=0.0):
    """Fast-diagonalization preconditioner with *geometry-averaged* 1D
    coefficients (cf. Montardini-Sangalli-Tani): for each axis k the 1D
    stiffness matrix is weighted by the mean of the diffusion coefficient
    field ``B_kk = W (J^-1 J^-T)_kk`` over the other axes, and the 1D mass
    matrix by the mean of the weight field ``W``.  This captures separable
    geometry variation that the parametric :func:`fastdiag_precond`
    ignores — measured on the twisted box (p=3, n=48): preconditioned CG
    57 -> 24 iterations.

    Args:
        asm: a Gauss assembler over the space (provides the geometry
            Jacobian and quadrature; e.g. ``StiffnessAssembler(kvs, geo)``).
        free_dofs / dirichlet / dtype / mass_shift: as in
            :func:`fastdiag_precond`.
    """
    dtype = dtype if dtype is not None else config.get_dtype()
    kvs = asm.kvs0
    d = asm.dim

    # averaged 1D coefficients, computed on device in ONE jit; only the
    # small per-axis vectors come back to host (f64 for the eigensolve)
    gi = jax.tree_util.tree_map(
        lambda a: jnp.asarray(np.asarray(a, np.float64))
        if np.issubdtype(np.asarray(a).dtype, np.floating)
        else jnp.asarray(np.asarray(a)), asm._geo_inputs)
    # slab the grid on big problems (HBM; see axis_means_slabbed) — gated
    # so smaller configs keep the bit-identical single-pass reduction
    qs = [len(w) for w in asm._geo_inputs['weights']]
    nslabs = 1
    if int(np.prod(qs)) > 16 * 2 ** 20 and 'jac' not in asm._geo_inputs:
        for s in (8, 6, 4, 3, 2):
            if qs[0] % s == 0:
                nslabs = s
                break
    cms = _axis_means_fn(d, nslabs)(gi)

    KM = []
    for k, kv in enumerate(kvs):
        c = np.asarray(cms[k][0], dtype=np.float64)
        m = np.asarray(cms[k][1], dtype=np.float64)
        Bt = asm.tables.trial[k]        # cached 1D basis tables (derivs>=1)
        K1 = (Bt[1] * c) @ Bt[1].T
        M1 = (Bt[0] * m) @ Bt[0].T
        KM.append((K1, M1))
    full_shape = tuple(kv.numdofs for kv in kvs)
    return _build_precond(KM, full_shape, free_dofs, dirichlet, dtype,
                          mass_shift)
