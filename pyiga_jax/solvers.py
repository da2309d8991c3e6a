# -*- coding: utf-8 -*-
"""Solvers for linear, nonlinear, and time-dependent problems.

L9 layer, API parity with /root/reference/pyiga/solvers.py: fast
diagonalization, Gauss-Seidel smoothers (native C++ kernels for exact sweep
order — iteration counts of the local multigrid solver are part of the
numerical contract), two-grid and local multigrid, Newton, and DIRK /
Rosenbrock time steppers with embedded-error adaptive step control.

Device additions: a matrix-free jitted conjugate-gradient solver
(:func:`cg_jit`) for operators given as traced matvec functions (compact
mlmatrix / Kronecker matvecs), used by the benchmark path.
"""

from functools import reduce  # noqa: F401  (star-import parity: the
#   reference's solvers module exposes it and downstream code uses it)

import numpy as np
import scipy.linalg
import scipy.sparse

from . import native, utils
from .operators import DiagonalOperator, KroneckerOperator, make_solver


def _asdense(X):
    return X.toarray() if scipy.sparse.issparse(X) else X


################################################################################
# Fast diagonalization [Sangalli, Tani 2016]
################################################################################

def fastdiag_solver(KM):
    """Fast-diagonalization inverse of ``sum_d K_d (x) M_1 ... M_d ...``:
    per-axis generalized eigendecompositions give a Kronecker eigenbasis in
    which the operator is diagonal.  Input: list of (K_i, M_i) pairs."""
    dim = len(KM)
    evs = [scipy.linalg.eigh(_asdense(K), _asdense(M)) for K, M in KM]

    # eigenvalues of the full operator: the outer sum of the per-axis
    # eigenvalues over the tensor grid (C order matches the Kronecker basis)
    lam = np.zeros(dim * (1,))
    for d, (w, _) in enumerate(evs):
        lam = lam + w.reshape((1,) * d + (-1,) + (1,) * (dim - 1 - d))

    to_eigen = KroneckerOperator(*(U.T for _, U in evs))
    from_eigen = KroneckerOperator(*(U for _, U in evs))
    return from_eigen * DiagonalOperator(1.0 / lam.ravel()) * to_eigen


################################################################################
# Matrix-free CG under jit (device path)
################################################################################

import weakref

_CG_CACHE = weakref.WeakKeyDictionary()


def _as_operand_fn(op):
    """Normalize an operator into ``(operands_pytree, fn(operands, x))``.

    Operators may expose the *operand protocol* (attributes `operands` and
    `apply_with_operands`); this keeps their large device arrays as jit
    ARGUMENTS instead of closure constants (closure constants get baked into
    the serialized HLO, which breaks remote compilation at scale)."""
    fn = getattr(op, 'apply_with_operands', None)
    if fn is not None:
        return op.operands, fn
    # weak reference: the wrapper ends up as a VALUE in the weak-key solver
    # caches, and a strong `op` capture would keep its own key alive forever
    # (leaking the compiled executable plus every array the closure holds)
    import weakref
    try:
        op_ref = weakref.ref(op)
    except TypeError:
        return None, (lambda operands, v: op(v))

    def call(operands, v):
        f = op_ref()
        if f is None:       # unreachable while the cache entry exists
            raise RuntimeError('operator was garbage-collected')
        return f(v)
    return None, call


def _op_key(op):
    """Cache-key component for an operator: the apply function object for
    operand-protocol operators (a strong reference — bound methods keep
    their owner alive, so a collected operator can never alias a new
    object's id), else the operator itself."""
    return getattr(op, 'apply_with_operands', op)


def cg_jit_traceable(matvec, tol=1e-8, maxiter=1000, precond=None):
    """The pure CG program behind :func:`cg_jit`, for composition into a
    larger jit (e.g. one fused assembly+solve dispatch).  Returns
    ``(run, mv_ops, pc_ops)`` with ``run(b, x0, mv_ops, pc_ops) ->
    (x, iterations)`` traceable."""
    import jax.numpy as jnp
    from jax import lax

    mv_ops, mv_fn = _as_operand_fn(matvec)
    if precond is None:
        pc_ops, pc_fn = None, (lambda operands, r: r)
    else:
        pc_ops, pc_fn = _as_operand_fn(precond)

    def run(b, x0, mv_ops, pc_ops):
        r0 = b - mv_fn(mv_ops, x0)
        norm0 = jnp.linalg.norm(r0)

        def body(state):
            x, r, z, p, rz, it = state
            Ap = mv_fn(mv_ops, p)
            alpha = rz / jnp.vdot(p, Ap)
            x = x + alpha * p
            r = r - alpha * Ap
            z = pc_fn(pc_ops, r)
            rz_new = jnp.vdot(r, z)
            p = z + (rz_new / rz) * p
            return (x, r, z, p, rz_new, it + 1)

        def cond(state):
            _, r, _, _, _, it = state
            return (jnp.linalg.norm(r) > tol * norm0) & (it < maxiter)

        z0 = pc_fn(pc_ops, r0)
        state = (x0, r0, z0, z0, jnp.vdot(r0, z0), jnp.array(0))
        x, r, _, _, _, it = lax.while_loop(cond, body, state)
        return x, it

    return run, mv_ops, pc_ops


def cg_jit(matvec, b, x0=None, tol=1e-8, maxiter=1000, precond=None):
    """Conjugate gradients on device: `matvec` (and optional `precond`) are
    callables on raveled vectors — either plain traced closures or operators
    following the operand protocol (e.g.
    :class:`~pyiga_jax.ops.matfree.MatrixFreeOperator`).  The whole solve is
    one ``lax.while_loop`` dispatch.

    The compiled solver is cached per (matvec, precond, tol, maxiter) so
    repeated solves with the same operator object do not re-trace.

    Returns ``(x, iterations)``; stops when ``||r|| <= tol * ||r0||``."""
    import jax
    import jax.numpy as jnp
    from jax import lax

    b = jnp.asarray(b)
    if x0 is None:
        x0 = jnp.zeros_like(b)

    try:
        per_op = _CG_CACHE.setdefault(matvec, {})
    except TypeError:           # unhashable/non-weakref-able callable
        per_op = {}
    # strong-reference keys instead of id() — see _op_key
    key = (_op_key(precond) if precond is not None else None, tol, maxiter)
    run = per_op.get(key)

    if run is None:
        body, _mv, _pc = cg_jit_traceable(matvec, tol=tol, maxiter=maxiter,
                                          precond=precond)
        run = jax.jit(body)
        per_op[key] = run
    mv_ops, _ = _as_operand_fn(matvec)
    pc_ops = None if precond is None else _as_operand_fn(precond)[0]
    return run(b, x0, mv_ops, pc_ops)


def cg_ir_traceable(op_hi, op_lo, tol=1e-8, maxiter_inner=200, max_outer=10,
                    precond_lo=None, inner_tol=1e-3):
    """The pure refinement program behind :func:`cg_ir`, for composition
    into a larger jit (e.g. one fused assembly+solve dispatch).

    Returns ``(run, hi_ops, lo_ops, pc_ops)`` where
    ``run(b, hi_ops, lo_ops, pc_ops) -> (x, packed_info)`` is traceable;
    callers may substitute freshly computed arrays into the operand
    pytrees (functional updates) before invoking `run` inside their jit.
    Decode the packed info with :func:`cg_ir_info`."""
    import jax.numpy as jnp
    from jax import lax

    hi_ops, hi_fn = _as_operand_fn(op_hi)
    lo_ops, lo_fn = _as_operand_fn(op_lo)
    if precond_lo is None:
        pc_ops, pc_fn = None, (lambda operands, r: r)
    else:
        pc_ops, pc_fn = _as_operand_fn(precond_lo)

    def run(b, hi_ops, lo_ops, pc_ops):
        norm_b = jnp.linalg.norm(b)

        def inner_cg(r64):
            b32 = jnp.asarray(r64, jnp.float32)
            r0 = b32
            norm0 = jnp.linalg.norm(r0)

            def body(state):
                x, r, z, p, rz, it = state
                Ap = lo_fn(lo_ops, p)
                alpha = rz / jnp.vdot(p, Ap)
                x = x + alpha * p
                r = r - alpha * Ap
                z = pc_fn(pc_ops, r)
                rz_new = jnp.vdot(r, z)
                p = z + (rz_new / rz) * p
                return (x, r, z, p, rz_new, it + 1)

            def cond(state):
                _, r, _, _, _, it = state
                return ((jnp.linalg.norm(r) > inner_tol * norm0)
                        & (it < maxiter_inner))

            z0 = pc_fn(pc_ops, r0)
            x0 = jnp.zeros_like(b32)
            state = (x0, r0, z0, z0, jnp.vdot(r0, z0), jnp.array(0))
            x, _, _, _, _, it = lax.while_loop(cond, body, state)
            return x, it

        def outer_body(state):
            x, r, res, outer, iters = state
            d, it = inner_cg(r)
            x = x + jnp.asarray(d, jnp.float64)
            r = b - hi_fn(hi_ops, x)
            res = jnp.linalg.norm(r)
            iters = iters.at[outer].set(it)
            return (x, r, res, outer + 1, iters)

        def outer_cond(state):
            _, _, res, outer, _ = state
            return (res > tol * norm_b) & (outer < max_outer)

        x0 = jnp.zeros_like(b)
        iters0 = jnp.zeros((max_outer,), dtype=jnp.int32)
        state = (x0, b, norm_b, jnp.array(0), iters0)
        x, _, res, outer, iters = lax.while_loop(outer_cond, outer_body,
                                                 state)
        # pack the info scalars into one array: one host fetch
        info = jnp.concatenate([
            (res / norm_b)[None], outer[None].astype(jnp.float64),
            iters.astype(jnp.float64)])
        return x, info

    return run, hi_ops, lo_ops, pc_ops


def cg_ir(op_hi, op_lo, b, tol=1e-8, maxiter_inner=200, max_outer=10,
          precond_lo=None, inner_tol=1e-3, fetch_info=True):
    """Mixed-precision CG with iterative refinement.

    The Krylov iterations run in float32, which halves the bytes of every
    bandwidth-bound matvec, and float64 accuracy is recovered through
    classical iterative refinement: the outer loop computes true float64
    residuals with `op_hi` and accumulates corrections from float32 inner
    CG solves with `op_lo`.

    Args:
        op_hi: float64 operator (operand protocol or callable).
        op_lo: float32 operator for the inner solves.
        b: float64 right-hand side.
        tol: relative residual target in float64.
        precond_lo: optional float32 preconditioner for the inner CG.
        inner_tol: residual reduction per inner solve.  The error reduction
            per outer step is capped by float32 effects (~kappa * 2^-24)
            regardless of how far the inner solve converges, so a loose
            inner tolerance is usually optimal (measured: 1e-2..1e-3 give
            the same outer count as 1e-5 on the benchmark problem).

    Returns ``(x, info)`` where info = dict(outer, inner_iters, residual).

    The whole refinement (outer float64 residual loop + inner float32 CG
    while-loops) runs as ONE jitted dispatch, with no host round-trip per
    outer step.  Compiled solvers are cached per operator triple.
    """
    import jax
    import jax.numpy as jnp

    b = jnp.asarray(b, dtype=jnp.float64)

    try:
        per_op = _CG_CACHE.setdefault(op_hi, {})
    except TypeError:
        per_op = {}
    # strong-reference keys instead of id() — see _op_key
    key = ('ir', _op_key(op_lo), _op_key(precond_lo) if precond_lo is not None
           else None, tol, maxiter_inner, max_outer, inner_tol, b.shape)
    cached = per_op.get(key)

    if cached is None:
        body, _hi, _lo, _pc = cg_ir_traceable(
            op_hi, op_lo, tol=tol, maxiter_inner=maxiter_inner,
            max_outer=max_outer, precond_lo=precond_lo, inner_tol=inner_tol)
        cached = jax.jit(body)
        per_op[key] = cached
    run = cached
    hi_ops, _ = _as_operand_fn(op_hi)
    lo_ops, _ = _as_operand_fn(op_lo)
    pc_ops = (None if precond_lo is None
              else _as_operand_fn(precond_lo)[0])

    x, info = run(b, hi_ops, lo_ops, pc_ops)
    if not fetch_info:
        # leave the packed info vector on device; decode with cg_ir_info
        return x, info
    return x, cg_ir_info(info)


def cg_ir_info(info):
    """Decode the packed device info vector of ``cg_ir(...,
    fetch_info=False)`` into the usual dict (one host fetch)."""
    info = np.asarray(info)
    outer = int(info[1])
    return {'outer': outer,
            'inner_iters': [int(i) for i in info[2:2 + outer]],
            'residual': float(info[0])}


_GMRES_CACHE = weakref.WeakKeyDictionary()


def gmres_jit(matvec, b, x0=None, tol=1e-8, restart=30, max_restarts=100,
              precond=None):
    """Right-preconditioned restarted GMRES(m) on device.

    `matvec`/`precond` follow the same conventions as :func:`cg_jit` (plain
    callables or operand-protocol operators).  Each restart cycle runs as one
    jitted computation (Arnoldi with masked modified Gram-Schmidt and Givens
    rotations); the outer restart loop runs on host on the true residual.

    Returns ``(x, iterations)`` (total inner iterations; `inf` if the target
    tolerance was not reached)."""
    import jax
    import jax.numpy as jnp

    b = jnp.asarray(b)
    n = b.shape[0]
    if x0 is None:
        x0 = jnp.zeros_like(b)

    mv_ops, mv_fn = _as_operand_fn(matvec)
    if precond is None:
        pc_ops, pc_fn = None, (lambda operands, r: r)
    else:
        pc_ops, pc_fn = _as_operand_fn(precond)

    try:
        per_op = _GMRES_CACHE.setdefault(matvec, {})
    except TypeError:
        per_op = {}
    # strong-reference key instead of id() — see _op_key (a GC'd
    # preconditioner whose id is reused must not alias another operator's
    # traced cycle)
    key = (_op_key(precond) if precond is not None else None, tol, restart,
           n, b.dtype.name)
    cycle = per_op.get(key)

    if cycle is None:
        m = restart
        eps_break = 1e-30

        @jax.jit
        def cycle(x0, b, mv_ops, pc_ops, abs_tol):
            r0 = b - mv_fn(mv_ops, x0)
            beta = jnp.linalg.norm(r0)
            V = jnp.zeros((m + 1, n), dtype=b.dtype)
            V = V.at[0].set(r0 / jnp.maximum(beta, eps_break))
            H = jnp.zeros((m + 1, m), dtype=b.dtype)
            cs = jnp.ones(m, dtype=b.dtype)
            sn = jnp.zeros(m, dtype=b.dtype)
            g = jnp.zeros(m + 1, dtype=b.dtype).at[0].set(beta)

            def body(j, state):
                V, H, cs, sn, g, done, j_eff = state
                w = mv_fn(mv_ops, pc_fn(pc_ops, V[j]))
                # masked classical Gram-Schmidt with one reorthogonalization
                # pass (CGS2, "twice is enough"): matmul-shaped like CGS but
                # with MGS-grade orthogonality in floating point
                mask = (jnp.arange(m + 1) <= j)
                h = (V @ w) * mask
                w = w - V.T @ h
                h2 = (V @ w) * mask
                w = w - V.T @ h2
                h = h + h2
                wnorm = jnp.linalg.norm(w)
                h = h.at[j + 1].set(wnorm)
                V_new = V.at[j + 1].set(w / jnp.maximum(wnorm, eps_break))

                # apply the previous Givens rotations to the new column
                def rot(i, hcol):
                    hi = cs[i] * hcol[i] + sn[i] * hcol[i + 1]
                    hi1 = -sn[i] * hcol[i] + cs[i] * hcol[i + 1]
                    sel = i < j
                    hcol = hcol.at[i].set(jnp.where(sel, hi, hcol[i]))
                    return hcol.at[i + 1].set(jnp.where(sel, hi1,
                                                        hcol[i + 1]))
                h = jax.lax.fori_loop(0, m, rot, h)

                # new rotation annihilating h[j+1]
                denom = jnp.sqrt(h[j] ** 2 + h[j + 1] ** 2)
                c_new = h[j] / jnp.maximum(denom, eps_break)
                s_new = h[j + 1] / jnp.maximum(denom, eps_break)
                h = h.at[j].set(denom).at[j + 1].set(0.0)
                g_j1 = -s_new * g[j]
                g_new = g.at[j + 1].set(g_j1).at[j].set(c_new * g[j])

                new_done = jnp.abs(g_j1) <= abs_tol
                upd = jnp.logical_not(done)
                return (jnp.where(upd, V_new, V),
                        jnp.where(upd, H.at[:, j].set(h), H),
                        jnp.where(upd, cs.at[j].set(c_new), cs),
                        jnp.where(upd, sn.at[j].set(s_new), sn),
                        jnp.where(upd, g_new, g),
                        jnp.logical_or(done, new_done),
                        jnp.where(upd, j + 1, j_eff))

            state = (V, H, cs, sn, g, beta <= abs_tol, jnp.array(0))
            V, H, cs, sn, g, done, j_eff = jax.lax.fori_loop(0, m, body,
                                                             state)

            # solve the (masked) triangular system H[:j_eff,:j_eff] y = g
            idx = jnp.arange(m)
            Hm = H[:m, :m]
            diag_fix = jnp.where(idx < j_eff, jnp.diagonal(Hm), 1.0)
            Hm = Hm.at[idx, idx].set(diag_fix)
            g_m = jnp.where(idx < j_eff, g[:m], 0.0)
            y = jax.scipy.linalg.solve_triangular(Hm, g_m, lower=False)
            x = x0 + pc_fn(pc_ops, V[:m].T @ y)
            # TRUE residual, not the Givens recurrence estimate |g[j_eff]|
            # (the estimate drifts below the true residual once
            # orthogonality degrades); packed with j_eff so the host pays
            # ONE fetch per cycle
            res_true = jnp.linalg.norm(b - mv_fn(mv_ops, x))
            return x, jnp.stack([res_true,
                                 j_eff.astype(jnp.result_type(b.dtype))])

        per_op[key] = cycle

    norm_b = float(jnp.linalg.norm(b))
    abs_tol = jnp.asarray(tol * norm_b, dtype=b.dtype)
    x = x0
    total = 0
    for _ in range(max_restarts):
        x, info = cycle(x, b, mv_ops, pc_ops, abs_tol)
        res, j_eff = np.asarray(info)
        total += int(j_eff)
        if float(res) <= tol * norm_b:
            return x, total
    return x, np.inf


################################################################################
# Smoothers
################################################################################

_SWEEP_PASSES = {'forward': (False,), 'backward': (True,),
                 'symmetric': (False, True)}


def gauss_seidel(A, x, b, iterations=1, indices=None, sweep='forward'):
    """Gauss-Seidel relaxation on ``Ax = b``, updating `x` in place.

    Sweep order is bit-compatible with the reference (relaxation_cy.pyx):
    forward/backward full sweeps, or sweeps restricted to `indices` in the
    given order.  Uses the native C++ kernel when available."""
    try:
        passes = _SWEEP_PASSES[sweep]
    except KeyError:
        raise ValueError("valid sweep directions are 'forward', 'backward',"
                         " and 'symmetric'")

    if scipy.sparse.issparse(A):
        if not scipy.sparse.isspmatrix_csr(A):
            import warnings
            warnings.warn('matrix for Gauss-Seidel is not CSR; converting '
                          '(performance warning)', RuntimeWarning)
            A = scipy.sparse.csr_matrix(A)
        for _ in range(iterations):
            for reverse in passes:
                if indices is not None:
                    native.gauss_seidel_sweep_indexed(A, x, b, indices,
                                                      reverse=reverse)
                else:
                    native.gauss_seidel_sweep(A, x, b, reverse=reverse)
        return

    # dense fallback (strictly sequential update, same visit order)
    order = list(range(A.shape[0]) if indices is None else indices)
    for _ in range(iterations):
        for reverse in passes:
            for i in (reversed(order) if reverse else order):
                diag = A[i, i]
                if diag == 0.0:         # zero diagonal: skip (reference
                    continue            # relaxation_cy.pyx:62 semantics)
                off_diag = A[i].dot(x) - diag * x[i]
                x[i] = (b[i] - off_diag) / diag


def OperatorSmoother(S):
    r"""Smoother ``u <- u + S (f - A u)`` for an arbitrary operator `S`."""
    def apply(A, u, f):
        u += S.dot(f - A.dot(u))
    return apply


def GaussSeidelSmoother(iterations=1, sweep='forward'):
    """Gauss-Seidel smoother with the given sweep direction."""
    def apply(A, u, f):
        gauss_seidel(A, u, f, iterations=iterations, sweep=sweep)
    return apply


def SequentialSmoother(smoothers):
    """Apply several smoothers in sequence."""
    def apply(A, u, f):
        for S in smoothers:
            S(A, u, f)
    return apply


################################################################################
# Multigrid
################################################################################

def twogrid(A, f, P, smoother, u0=None, tol=1e-8, smooth_steps=2, maxiter=1000):
    """Generic two-grid iteration with Galerkin coarse matrix ``P^T A P``."""
    coarse_inv = make_solver(P.T @ A @ P)
    u = np.array(u0) if u0 is not None else np.zeros(A.shape[0])
    res0 = np.linalg.norm(f - A @ u)

    for numiter in range(1, maxiter + 2):
        for _ in range(smooth_steps):
            smoother(A, u, f)
        r = f - A @ u
        res = np.linalg.norm(r)
        u += P @ (coarse_inv * (P.T @ r))
        if res < tol * res0:
            break
        if res > 20 * res0:
            print('Diverged')
            break
    else:
        print('too many iterations, aborting. reduction =', res / res0)
    print(numiter, 'iterations')
    return u


# Smoother catalog for the local MG V-cycle: sweep direction of the
# pre-smoothing and post-smoothing half of the cycle.  'exact' replaces
# smoothing by an additive exact solve on the smoothing index set.
_MG_SWEEPS = {
    'gs': ('forward', 'backward'),
    'forward_gs': ('forward', 'forward'),
    'backward_gs': ('backward', 'backward'),
    'symmetric_gs': ('symmetric', 'symmetric'),
    'exact': (None, None),
}


def local_mg_step(hs, A, f, Ps, lv_inds, smoother='symmetric_gs',
                  smooth_steps=2, relax_backend='auto'):
    """One V-cycle of the local multigrid method on the virtual hierarchy
    of the HB/THB space `hs`; smoothing is restricted to the per-level
    index sets `lv_inds`.  Returns a function ``step(x)``.

    Implemented as explicit descend/ascend passes over precomputed Galerkin
    coarse matrices; the operation order (pre-smooth, restrict, coarse
    solve, prolongate, post-smooth, with strictly sequential Gauss-Seidel
    sweeps) reproduces the reference's iteration counts exactly
    (behavioral contract: reference solvers.py:174, test_localmg).

    `relax_backend` selects the smoother kernel: 'host' runs the
    sequential CSR sweep (native C++), 'device' the order-exact
    dependency-wavefront kernel (ops/relax.py) that executes each
    smoothing application as one jitted device dispatch; 'auto' picks
    'device' on accelerator backends, 'host' on CPU."""
    if smoother not in _MG_SWEEPS:
        raise ValueError('Invalid smoother')
    pre_sweep, post_sweep = _MG_SWEEPS[smoother]
    L = hs.numlevels

    # Galerkin hierarchy: As[L-1] = A, As[lv] = P^T As[lv+1] P
    As = [None] * L
    As[L - 1] = A
    for lv in range(L - 2, -1, -1):
        As[lv] = (Ps[lv].T @ As[lv + 1] @ Ps[lv]).tocsr()

    exact_on = range(L) if smoother == 'exact' else (0,)
    direct = {lv: make_solver(As[lv][lv_inds[lv]][:, lv_inds[lv]], spd=True)
              for lv in exact_on}

    if relax_backend not in ('host', 'device', 'auto'):
        raise ValueError("relax_backend must be 'host', 'device' or 'auto'")
    if relax_backend == 'auto':
        from . import config
        relax_backend = 'device' if config.platform() == 'gpu' else 'host'

    if relax_backend == 'device' and smoother != 'exact':
        from .ops.relax import DeviceIndexedGS
        dev_gs = {(lv, sweep): DeviceIndexedGS(As[lv], lv_inds[lv],
                                               sweep=sweep,
                                               iterations=smooth_steps)
                  for lv in range(1, L)
                  for sweep in {pre_sweep, post_sweep}}

        def relax(lv, x, rhs, sweep):
            if sweep is not None:
                dev_gs[(lv, sweep)].apply(x, rhs)
    else:
        def relax(lv, x, rhs, sweep):
            if sweep is not None:
                gauss_seidel(As[lv], x, rhs, indices=lv_inds[lv],
                             iterations=smooth_steps, sweep=sweep)

    def vcycle(x, rhs):
        # descend: smooth and collect restricted residuals per level
        xs, rhss = [None] * L, [None] * L
        xs[L - 1], rhss[L - 1] = x.copy(), rhs
        for lv in range(L - 1, 0, -1):
            if smoother == 'exact':
                ind = lv_inds[lv]
                r = (rhss[lv] - As[lv] @ xs[lv])[ind]
                xs[lv][ind] += direct[lv] @ r
            else:
                relax(lv, xs[lv], rhss[lv], pre_sweep)
            rhss[lv - 1] = Ps[lv - 1].T @ (rhss[lv] - As[lv] @ xs[lv])
            xs[lv - 1] = np.zeros_like(rhss[lv - 1])

        # coarsest level: exact solve on its smoothing set
        ind0 = lv_inds[0]
        xs[0][ind0] = direct[0] @ rhss[0][ind0]

        # ascend: prolongate corrections and post-smooth
        for lv in range(1, L):
            xs[lv] += Ps[lv - 1] @ xs[lv - 1]
            relax(lv, xs[lv], rhss[lv], post_sweep)
        return xs[L - 1]

    return lambda x: vcycle(x, f)


def iterative_solve(step, A, f, x0=None, active_dofs=None, tol=1e-8,
                    maxiter=5000):
    """Run the iteration ``x <- step(x)`` until the residual of ``Ax = f``
    (restricted to `active_dofs`) is reduced by `tol`.  Returns
    ``(x, iterations)`` with ``iterations = inf`` on non-convergence."""
    sel = slice(None) if active_dofs is None else active_dofs
    x = np.zeros(A.shape[0]) if x0 is None else x0
    r = f if x0 is None else f - A @ x
    res0 = scipy.linalg.norm(r[sel])
    for it in range(1, maxiter + 1):
        x = step(x)
        res = scipy.linalg.norm((f - A @ x)[sel])
        # keep the exact comparison form: iteration counts are a contract
        if res / res0 < tol:
            return x, it
    print('Warning: iterative solver did not converge in'
          ' {} iterations'.format(maxiter))
    return x, np.inf


# fused device MG solvers, keyed by problem identity (bounded; entries pin
# their hs/A so the ids stay valid) — a repeated solve on the same system
# (warm-up + run, adaptive outer loops) skips schedule construction and
# the pack/coarse-inverse uploads
_DEVICE_MG_CACHE = {}


def _device_mg_solver(hs, A, strategy, smoother, smooth_steps):
    import hashlib
    from .ops.mg import DeviceMGSolver
    Acsr = A.tocsr()
    # key on the matrix CONTENT (not just identity): mutating A.data in
    # place between solves must not silently reuse the stale uploaded
    # hierarchy (the host path re-reads A every call)
    h = hashlib.blake2b(digest_size=16)
    for part in (Acsr.indptr, Acsr.indices, Acsr.data):
        h.update(np.ascontiguousarray(part).tobytes())
    key = (id(hs), h.digest(), strategy, smoother, smooth_steps)
    hit = _DEVICE_MG_CACHE.get(key)
    if hit is not None and hit[0] is hs:
        return hit[2]
    Ps = hs.virtual_hierarchy_prolongators()
    lv_inds = hs.indices_to_smooth(strategy)
    L = hs.numlevels
    As = [None] * L
    As[L - 1] = Acsr
    for lv in range(L - 2, -1, -1):
        As[lv] = (Ps[lv].T @ As[lv + 1] @ Ps[lv]).tocsr()
    solver = DeviceMGSolver(As, Ps, lv_inds, _MG_SWEEPS[smoother],
                            smooth_steps,
                            active_dofs=hs.non_dirichlet_dofs())
    if len(_DEVICE_MG_CACHE) >= 4:
        _DEVICE_MG_CACHE.pop(next(iter(_DEVICE_MG_CACHE)))
    _DEVICE_MG_CACHE[key] = (hs, A, solver)
    return solver


def solve_hmultigrid(hs, A, f, strategy='cell_supp', smoother='gs',
                     smooth_steps=2, tol=1e-8, maxiter=5000,
                     relax_backend='auto'):
    """Solve a scalar problem on an HB-/THB-spline space by local multigrid.

    `strategy` selects the smoothing index sets ('new', 'trunc',
    'func_supp', 'cell_supp'); `smoother` one of 'gs', 'forward_gs',
    'backward_gs', 'symmetric_gs', 'exact'; `relax_backend` as in
    :func:`local_mg_step`.  Returns ``(x, iterations)``.

    On the 'device' backend (the GPU default above ``host_solve_cutoff``)
    the ENTIRE solve — V-cycles, GS smoothing, grid transfers, coarse
    solve and the convergence loop — runs as one jitted device program
    (:class:`pyiga_jax.ops.mg.DeviceMGSolver`) instead of host round-trips
    per V-cycle.  Iteration counts match the host path exactly
    (tests/test_localmg.py)."""
    if relax_backend not in ('host', 'device', 'auto'):
        raise ValueError("relax_backend must be 'host', 'device' or 'auto'")
    if relax_backend == 'auto':
        from . import config
        cutoff = config.host_solve_cutoff()
        # tiny problems stay on the host CSR kernels, where every device
        # op is bound by dispatch latency
        relax_backend = ('device'
                         if config.platform() == 'gpu'
                         and not (cutoff and A.shape[0] <= cutoff)
                         else 'host')
    if relax_backend == 'device' and smoother != 'exact':
        solver = _device_mg_solver(hs, A, strategy, smoother, smooth_steps)
        return solver.solve(f, tol=tol, maxiter=maxiter)
    Ps = hs.virtual_hierarchy_prolongators()
    non_dir_dofs = hs.non_dirichlet_dofs()
    mg_step = local_mg_step(hs, A, f, Ps, hs.indices_to_smooth(strategy),
                            smoother, smooth_steps,
                            relax_backend=relax_backend)
    return iterative_solve(mg_step, A, f, active_dofs=non_dir_dofs, tol=tol,
                           maxiter=maxiter)


################################################################################
# Nonlinear problems
################################################################################

class NoConvergenceError(Exception):
    """Raised by :func:`newton` on non-convergence; carries the last iterate."""

    def __init__(self, method, num_iter, last_iterate):
        super().__init__('%s did not converge in %d iterations'
                         % (method, num_iter))
        self.method = method
        self.num_iter = num_iter
        self.last_iterate = last_iterate


def newton(F, J, x0, atol=1e-6, rtol=1e-6, maxiter=100, freeze_jac=1):
    """Newton iteration for ``F(x) = 0`` with optional frozen Jacobian
    (`freeze_jac` > 1 re-factorizes only every so many steps)."""
    x = np.array(x0)
    res = F(x)
    target = max(atol, rtol * np.linalg.norm(res))
    jac_inv = None
    for num_it in range(maxiter):
        if np.linalg.norm(res) < target:
            return x
        if num_it % freeze_jac == 0 or jac_inv is None:
            jac_inv = make_solver(J(x))
        x -= jac_inv.dot(res)
        res = F(x)
    raise NoConvergenceError('newton', maxiter, x)


################################################################################
# Implicit Runge-Kutta time stepping (DIRK and Rosenbrock schemes)
#
# A *scheme* object computes one step; the constant/adaptive *drivers* below
# handle step control and are shared by both families.
################################################################################

class _DIRKScheme:
    """A diagonally-implicit RK scheme from an extended Butcher array
    (`s` stage rows, then the weight row `b`, optionally the embedded
    row `b_hat`)."""

    def __init__(self, tableau):
        tableau = np.asarray(tableau)
        self.s = s = tableau.shape[1]
        self.A = tableau[:s]
        self.b = tableau[s]
        self.b_hat = tableau[s + 1] if tableau.shape[0] > s + 1 else None
        # stiffly accurate: the last stage IS the new iterate
        self.stiffly_accurate = np.allclose(self.b, self.A[s - 1])

    def truncated(self):
        """The same scheme without its embedded error estimator."""
        out = _DIRKScheme(np.vstack([self.A, self.b]))
        return out

    def _implicit_stage(self, M, F, J, tau, a_ii, rhs, x_start):
        """Solve ``M y - tau a_ii F(y) = rhs`` by Newton, returning the
        stage value and the F evaluation at it."""
        cache = {}

        def res_fn(z):
            cache['F'] = F(z)
            return M @ z - tau * a_ii * cache['F'] - rhs

        y = newton(res_fn, lambda z: M - tau * a_ii * J(z), x_start,
                   atol=1e-4, freeze_jac=2)
        return y, cache['F']

    def step(self, M, F, J, x, tau, data=None, Fx=None):
        if M is None:
            M = scipy.sparse.eye(x.shape[0])
        if data is None:
            data = {}
        A, s = self.A, self.s
        stage_vals, stage_F = [], []
        for i in range(s):
            if A[i, i] == 0:
                assert i == 0, 'explicit stage only allowed first'
                stage_vals.append(x)
                stage_F.append(Fx if Fx is not None else F(x))
                continue
            rhs = M @ x + tau * sum(A[i, j] * stage_F[j] for j in range(i))
            guess = stage_vals[-1] if stage_vals else x
            y, Fy = self._implicit_stage(M, F, J, tau, A[i, i], rhs, guess)
            stage_vals.append(y)
            stage_F.append(Fy)

        def combine(weights):
            if 'M_inv' not in data:
                data['M_inv'] = make_solver(M, spd=True)
            acc = M @ x + tau * sum(w * Fi
                                    for w, Fi in zip(weights, stage_F))
            return data['M_inv'] @ acc

        if self.stiffly_accurate:
            x_new, F_new = stage_vals[-1], stage_F[-1]
        else:
            x_new, F_new = combine(self.b), None

        if self.b_hat is not None:
            return x_new, combine(self.b_hat), F_new
        return x_new, F_new


class _RosenbrockScheme:
    """A Rosenbrock(-W) scheme: one Jacobian evaluation and one
    factorization of ``M - tau gamma J`` per step, `s` linear stage
    solves."""

    def __init__(self, A, Gamma, b, b_hat):
        self.A, self.Gamma = np.asarray(A), np.asarray(Gamma)
        self.b, self.b_hat = b, b_hat

    def truncated(self):
        return _RosenbrockScheme(self.A, self.Gamma, self.b, None)

    def step(self, M, F, J, x, tau, data=None, Fx=None):
        A, Gamma = self.A, self.Gamma
        jac = J(x)
        solve = make_solver(M - tau * Gamma[0, 0] * jac)

        ks = []
        for i in range(A.shape[0]):
            y = x + tau * sum(A[i, j] * ks[j] for j in range(i))
            rhs = F(y)
            if i > 0:
                rhs = rhs + tau * jac.dot(
                    sum(Gamma[i, j] * ks[j] for j in range(i)))
            ks.append(solve.dot(rhs))

        def combine(weights):
            return x + tau * sum(w * k for w, k in zip(weights, ks))

        if self.b_hat is not None:
            return combine(self.b), combine(self.b_hat), None
        return combine(self.b), None


def dirk_step(tableau, M, F, J, x, tau, data=None, Fx=None):
    """One step of the (embedded) DIRK method given by the extended Butcher
    array (compatibility wrapper around :class:`_DIRKScheme`)."""
    return _DIRKScheme(tableau).step(M, F, J, x, tau, data=data, Fx=Fx)


def rosenbrock_step(A, Gamma, b, b_hat, M, F, J, x, tau, data, Fx=None):
    """One Rosenbrock(-W) step (compatibility wrapper around
    :class:`_RosenbrockScheme`)."""
    return _RosenbrockScheme(A, Gamma, b, b_hat).step(M, F, J, x, tau,
                                                      data=data, Fx=Fx)


def _integrate_constant(scheme, M, F, J, x, tau, t_end, *, t0=0.0,
                        progress=False):
    """Integrate with constant steps; returns (times, solutions)."""
    times, solutions = [t0], [x]
    Fx, data = None, {}
    nsteps = int(np.ceil((t_end - t0) / tau))
    for i in utils.progress_bar(progress)(range(nsteps)):
        try:
            x, Fx = scheme.step(M, F, J, x, tau, data, Fx=Fx)
        except NoConvergenceError:
            print('Nonlinear solve failed; returning partial results')
            break
        times.append(t0 + (i + 1) * tau)
        solutions.append(x)
    return times, solutions


def _integrate_adaptive(scheme, err_order, M, F, J, x, tau0, t_end, tol, *,
                        t0=0.0, step_factor=0.9, progress=False):
    """Integrate with embedded-error adaptive step control; returns
    (times, solutions)."""
    if tol is None:
        return _integrate_constant(scheme.truncated(), M, F, J, x, tau0,
                                   t_end, t0=t0, progress=progress)
    times, solutions = [t0], [x]
    Fx, data, tau, t = None, {}, tau0, t0
    with utils.progress_bar(progress)(total=t_end - t0) as pbar:
        while t < t_end:
            try:
                xnew, xhat, Fxnew = scheme.step(M, F, J, x, tau, data, Fx=Fx)
            except NoConvergenceError:
                tau *= 0.5          # reject: halve the step and retry
                continue
            # scaled RMS error of the embedded estimate
            weight = tol + tol * abs(x)
            r = np.linalg.norm((xhat - xnew) / weight) / np.sqrt(len(x))
            r = max(r, 1e-15)
            if r <= 1:              # accept
                t += tau
                x, Fx = xnew, Fxnew
                times.append(t)
                solutions.append(x)
                pbar.update(tau)
                pbar.set_postfix({'tau': tau})
            tau *= min(5.0, max(0.2, step_factor * r ** (-1.0 / err_order)))
    return times, solutions


def _export_method(scheme, name, displayname, err_order=None):
    """Public integrator function for a scheme: constant-step when it has
    no embedded estimator, adaptive otherwise."""
    if err_order is None:
        def method(M, F, J, x, tau, t_end, *, t0=0.0, progress=False):
            return _integrate_constant(scheme, M, F, J, x, tau, t_end,
                                       t0=t0, progress=progress)
    else:
        def method(M, F, J, x, tau0, t_end, tol, *, t0=0.0,
                   step_factor=0.9, progress=False):
            return _integrate_adaptive(scheme, err_order, M, F, J, x, tau0,
                                       t_end, tol, t0=t0,
                                       step_factor=step_factor,
                                       progress=progress)
    method.__name__ = method.__qualname__ = name
    method.__doc__ = ('Solve a time-dependent problem using the %s method.'
                      % displayname)
    return method


def dirk_method(tableau, name, displayname):
    return _export_method(_DIRKScheme(tableau), name, displayname)


def adaptive_dirk_method(tableau, err_order, name, displayname):
    return _export_method(_DIRKScheme(tableau), name, displayname,
                          err_order=err_order)


# -- Butcher tableaus (published coefficients) --------------------------------

def coeffs_sdirk3():
    # Alexander 1977 / Skvortsov 2006
    gamma = 0.435866521508
    b2 = 0.25 * (5 - 20 * gamma + 6 * gamma ** 2)
    return np.array([
        [gamma, 0.0, 0.0],
        [(1 - gamma) / 2, gamma, 0.0],
        [1 - b2 - gamma, b2, gamma],
        [1 - b2 - gamma, b2, gamma],
    ])


def coeffs_sdirk3_b():
    # Norsett's three-stage, 4th-order DIRK (not stiffly accurate)
    xi = 0.128886400515
    return np.array([
        [xi, 0.0, 0.0],
        [0.5 - xi, xi, 0.0],
        [2 * xi, 1 - 4 * xi, xi],
        [1 / (6 * (2 * xi - 1) ** 2),
         2 * (6 * xi ** 2 - 6 * xi + 1) / (3 * (2 * xi - 1) ** 2),
         1 / (6 * (2 * xi - 1) ** 2)],
    ])


def coeffs_sdirk21():
    # Ellsiepen: order 2, embedded order 1
    alpha = 1 - np.sqrt(2) / 2
    alp_hat = 2 - 1.25 * np.sqrt(2)
    A = np.array([
        [alpha, 0.0],
        [1 - alpha, alpha],
        [1 - alpha, alpha],
        [1 - alp_hat, alp_hat],
    ])
    return A, 1


def coeffs_dirk34():
    # 4 stages, order 3, L-stable, stiffly accurate; embedded order 2
    a21 = a22 = a33 = a44 = 0.1558983899988677
    a32 = 1.072486270734370
    a31 = 1 - a32 - a22
    a42 = 0.7685298292769537
    a43 = 0.09666483609791597
    A = np.array([
        [0.0, 0.0, 0.0, 0.0],
        [a21, a22, 0.0, 0.0],
        [a31, a32, a33, 0.0],
        [0.0, a42, a43, a44],
        [0.0, a42, a43, a44],
        [a31, a32, a33, 0.0],
    ])
    return A, 2


def coeffs_esdirk23():
    # Jorgensen et al 2018 (arXiv:1803.01613)
    gamma = (2 - np.sqrt(2)) / 2
    return np.array([
        [0.0, 0.0, 0.0],
        [gamma, gamma, 0.0],
        [(1 - gamma) / 2, (1 - gamma) / 2, gamma],
        [(1 - gamma) / 2, (1 - gamma) / 2, gamma],
        [(6 * gamma - 1) / (12 * gamma),
         1 / (12 * gamma * (1 - 2 * gamma)),
         (1 - 3 * gamma) / (3 * (1 - 2 * gamma))],
    ]), 3


def coeffs_esdirk34():
    # Jorgensen et al 2018 (arXiv:1803.01613)
    a21 = 0.43586652150845899942
    a31 = 0.14073777472470619619
    a32 = -0.1083655513813208000
    gam = 0.43586652150845899942
    b = [0.10239940061991099768, -0.3768784522555561061,
         0.83861253012718610911, gam]
    b_hat = [0.15702489786032493710, 0.11733044137043884870,
             0.61667803039212146434, 0.10896663037711474985]
    return np.array([
        [0.0, 0.0, 0.0, 0.0],
        [a21, gam, 0.0, 0.0],
        [a31, a32, gam, 0.0],
        b, b, b_hat,
    ]), 4


crank_nicolson = dirk_method(np.array([
    [0.0, 0.0],
    [0.5, 0.5],
    [0.5, 0.5],
]), 'crank_nicolson', 'Crank-Nicolson')

sdirk3 = dirk_method(coeffs_sdirk3(), 'sdirk3', 'SDIRK3 Runge-Kutta')
sdirk3_b = dirk_method(coeffs_sdirk3_b(), 'sdirk3_b',
                       'SDIRK3 (alternate) Runge-Kutta')
sdirk21 = adaptive_dirk_method(*coeffs_sdirk21(), 'sdirk21',
                               'SDIRK21 (Ellsiepen) Runge-Kutta')
dirk34 = adaptive_dirk_method(*coeffs_dirk34(), 'dirk34', 'DIRK34 Runge-Kutta')
esdirk23 = adaptive_dirk_method(*coeffs_esdirk23(), 'esdirk23',
                                'ESDIRK23 Runge-Kutta')
esdirk34 = adaptive_dirk_method(*coeffs_esdirk34(), 'esdirk34',
                                'ESDIRK34 Runge-Kutta')


################################################################################
# Rosenbrock methods (see doi:10.1016/j.cma.2009.10.005)
################################################################################

def coeffs_ros3p():
    A = np.array([
        [0.0, 0.0, 0.0],
        [1.0, 0.0, 0.0],
        [1.0, 0.0, 0.0],
    ])
    gam = 0.7886751347
    Gamma = np.array([
        [gam, 0.0, 0.0],
        [-1.0, gam, 0.0],
        [-0.7886751347, -1.077350269, gam],
    ])
    b = np.array([2 / 3, 0, 1 / 3])
    b_hat = np.array([1 / 3, 1 / 3, 1 / 3])
    return A, Gamma, b, b_hat, 2


def coeffs_ros3pw():
    A = np.array([
        [0.0, 0.0, 0.0],
        [1.5773502691896257e+00, 0.0, 0.0],
        [0.5, 0.0, 0.0],
    ])
    gam = 7.8867513459481287e-01
    Gamma = np.array([
        [gam, 0.0, 0.0],
        [-1.5773502691896257e+00, gam, 0.0],
        [-6.7075317547305480e-01, -1.7075317547305482e-01, gam],
    ])
    b = np.array([1.0566243270259355e-01, 4.9038105676657971e-02,
                  8.4529946162074843e-01])
    b_hat = np.array([-1.7863279495408180e-01, 1 / 3, 8.4529946162074843e-01])
    return A, Gamma, b, b_hat, 2


def coeffs_rowdaind2():
    A = np.array([
        [0.0, 0.0, 0.0, 0.0],
        [0.5, 0.0, 0.0, 0.0],
        [0.28, 0.72, 0.0, 0.0],
        [0.28, 0.72, 0.0, 0.0],
    ])
    gam = 0.3
    Gamma = np.array([
        [gam, 0.0, 0.0, 0.0],
        [-1.121794871794876e-1, gam, 0.0, 0.0],
        [2.54, -3.84, gam, 0.0],
        [29.0 / 75.0, -0.72, 1.0 / 30.0, gam],
    ])
    b = np.array([2.0 / 3.0, 0.0, 1.0 / 30.0, 0.3])
    b_hat = np.array([4.799002800355166e-1, 5.176203811215082e-1,
                      2.479338842975209e-3, 0.0])
    return A, Gamma, b, b_hat, 2


def coeffs_rodasp():
    gamma = 0.25
    A = np.array([
        [0.0, 0.0, 0.0, 0.0, 0.0, 0.0],
        [0.75, 0.0, 0.0, 0.0, 0.0, 0.0],
        [8.6120400814152190e-2, 0.1238795991858478, 0.0, 0.0, 0.0, 0.0],
        [0.7749345355073236, 0.1492651549508680, -0.2941996904581916,
         0.0, 0.0, 0.0],
        [5.308746682646142, 1.330892140037269, -5.374137811655562,
         -0.2655010110278497, 0.0, 0.0],
        [-1.764437648774483, -0.4747565572063027, 2.369691846915802,
         0.6195023590649829, 0.25, 0.0],
    ])
    B = np.array([
        [0.0, 0.0, 0.0, 0.0, 0.0, 0.0],
        [0.0, 0.0, 0.0, 0.0, 0.0, 0.0],
        [-0.049392, -0.014112, 0.0, 0.0, 0.0, 0.0],
        [-0.4820494693877561, -0.1008795555555556, 0.9267290249433117,
         0.0, 0.0, 0.0],
        [-1.764437648774483, -0.4747565572063027, 2.369691846915802,
         0.6195023590649829, 0.0, 0.0],
        [-8.0368370789113464e-2, -5.6490613592447572e-2, 0.4882856300427991,
         0.5057162114816189, -0.1071428571428569, 0.0],
    ])
    np.fill_diagonal(B, gamma)
    Gamma = B - A
    b = np.array([-8.0368370789113464e-2, -5.6490613592447572e-2,
                  0.4882856300427991, 0.5057162114816189,
                  -0.1071428571428569, gamma])
    b_hat = np.array([-1.764437648774483, -0.4747565572063027,
                      2.369691846915802, 0.6195023590649829, gamma, 0])
    return A, Gamma, b, b_hat, 3


def coeffs_rosi2p1():
    A = np.array([
        [0.0, 0.0, 0.0, 0.0],
        [5.0000000000000000e-1, 0.0, 0.0, 0.0],
        [5.5729261836499822e-1, 1.9270738163500176e-1, 0.0, 0.0],
        [-3.0084516445435860e-1, 1.8995581939026787e+0,
         -5.9871302944832006e-1, 0.0],
    ])
    gam = 4.3586652150845900e-1
    Gamma = np.array([
        [gam, 0.0, 0.0, 0.0],
        [-5.0000000000000000e-1, gam, 0.0, 0.0],
        [-6.4492162993321323e-1, 6.3491801247597734e-2, gam, 0.0],
        [9.3606009252719842e-3, -2.5462058718013519e-1,
         -3.2645441930944352e-1, gam],
    ])
    b = np.array([5.2900072579103834e-2, 1.3492662311920438e+0,
                  -9.1013275270050265e-1, 5.0796644892935516e-1])
    b_hat = np.array([1.4974465479289098e-1, 7.0051069041421810e-1, 0.0,
                      1.4974465479289098e-1])
    return A, Gamma, b, b_hat, 2


def rosenbrock_method(A, Gamma, b, name, displayname):
    return _export_method(_RosenbrockScheme(A, Gamma, b, None), name,
                          displayname)


def adaptive_rosenbrock_method(A, Gamma, b, b_hat, err_order, name,
                               displayname):
    return _export_method(_RosenbrockScheme(A, Gamma, b, b_hat), name,
                          displayname, err_order=err_order)


ros3p = adaptive_rosenbrock_method(*coeffs_ros3p(), 'ros3p',
                                   'ROS3P Rosenbrock')
ros3pw = adaptive_rosenbrock_method(*coeffs_ros3pw(), 'ros3pw',
                                    'ROS3PW Rosenbrock')
rowdaind2 = adaptive_rosenbrock_method(*coeffs_rowdaind2(), 'rowdaind2',
                                       'ROWDAIND2 Rosenbrock')
rodasp = adaptive_rosenbrock_method(*coeffs_rodasp(), 'rodasp',
                                    'RODASP Rosenbrock')
rosi2p1 = adaptive_rosenbrock_method(*coeffs_rosi2p1(), 'rosi2p1',
                                     'ROSI2P1 Rosenbrock')
