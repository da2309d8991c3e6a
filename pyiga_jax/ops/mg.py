"""Fully device-resident local-multigrid V-cycle solver.

Driving the local MG solve from the host costs several device dispatches
per V-cycle for the smoother alone, while restriction/prolongation/residual
run host scipy, for a problem whose per-level arithmetic is microseconds.
Here the ENTIRE iterative solve — order-exact wavefront Gauss-Seidel
smoothing (:mod:`pyiga_jax.ops.relax`), per-level residuals and grid
transfers (padded-ELL sparse matvecs), the dense coarse inverse, and the
convergence check of :func:`pyiga_jax.solvers.iterative_solve` — runs as
ONE jitted ``lax.while_loop`` device program; the host fetches the
solution and the iteration count at the end.

The operation order reproduces the reference V-cycle exactly
(/root/reference/pyiga/solvers.py:174-241 ``local_mg_step`` +
``iterative_solve`` :243); iteration counts are the behavioral contract
(reference test/test_localmg.py) and are asserted bit-exactly in
tests/test_localmg.py for this backend too.
"""

import numpy as np

from . import twofloat as tf
from .relax import level_schedule, _pack_sweep

_SWEEP_DIRS = {'forward': (False,), 'backward': (True,),
               'symmetric': (False, True)}


def ell_pack(A, dtype=np.float64):
    """CSR matrix -> padded ELL arrays ``(cols (n, W) int32, vals (n, W))``
    with zero-padding; the matvec is ``sum(vals * x[cols], axis=-1)``."""
    import scipy.sparse
    if not scipy.sparse.isspmatrix_csr(A):
        A = scipy.sparse.csr_matrix(A)
    n = A.shape[0]
    counts = np.diff(A.indptr)
    W = max(int(counts.max()) if n else 0, 1)
    cols = np.zeros((n, W), dtype=np.int32)
    vals = np.zeros((n, W), dtype=dtype)
    for i in range(n):
        lo, hi = A.indptr[i], A.indptr[i + 1]
        cols[i, :hi - lo] = A.indices[lo:hi]
        vals[i, :hi - lo] = A.data[lo:hi]
    return cols, vals


def _ell_mv(ell, x):
    """Padded-ELL matvec (traced)."""
    cols, vals = ell
    return (vals * x[cols]).sum(axis=-1)


def _smooth(passes, iterations, x, b):
    """Order-exact wavefront GS application (traced; see ops/relax.py)."""
    import jax.numpy as jnp
    from jax import lax

    def one_pass(x, pack):
        rows, cols, vals, diag = pack

        def body(l, x):
            r = rows[l]
            z = jnp.sum(vals[l] * x[cols[l]], axis=-1)
            fi = b.at[r].get(mode='fill', fill_value=0.0)
            return x.at[r].set((fi - z) / diag[l], mode='drop')

        return lax.fori_loop(0, rows.shape[0], body, x)

    for _ in range(iterations):
        for pack in passes:
            x = one_pass(x, pack)
    return x


def _smooth_tri(passes, iterations, x, b):
    """GS sweeps as dense triangular-inverse updates with gather/scatter
    index selection (traced; see :func:`_tri_smoother_pack`)."""
    for _ in range(iterations):
        for (S, ell, T) in passes:
            r = b[S] - _ell_mv(ell, x)
            x = x.at[S].add(T @ r)
    return x


def _smooth_densemat(passes, iterations, x, b):
    """GS sweeps as pure dense matmul chains: selection and scatter ride
    0/1 one-hot matrices (exact), so the whole sweep is three matvecs
    instead of a chain of small gathers and scatters."""
    for _ in range(iterations):
        for (Asel, T, Esc) in passes:
            r = Esc.T @ b - Asel @ x
            x = x + Esc @ (T @ r)
    return x


def _df_split(M):
    """Dense f64 matrix/array -> exact two-float ``(hi, lo)`` f32 pair
    (host-side numpy; the split is exact for |M| within f32 range)."""
    M = np.asarray(M, dtype=np.float64)
    hi = M.astype(np.float32)
    lo = (M - hi.astype(np.float64)).astype(np.float32)
    return hi, lo


def _df_mv(Mpair, xpair):
    """Two-float dense matvec ``M @ x`` (pair in, pair out; traced).

    Exact elementwise products (Dekker two_prod) + compensated tree
    reduction (:func:`~pyiga_jax.ops.twofloat.df_sum_axis`) — f64-class
    (~2^-45) accuracy from pure fusable f32 arithmetic."""
    Mhi, Mlo = Mpair
    xhi, xlo = xpair
    p, e = tf.two_prod(Mhi, xhi)
    e = e + (Mhi * xlo + Mlo * (xhi + xlo))
    return tf.df_sum_axis((p, e), axis=-1)


def _onehot_mv(E, xpair):
    """Matvec of a 0/1 selection/scatter matrix with a two-float vector.

    Exact as two full-precision f32 matmuls: every row of `E` has at most
    one nonzero (a one-hot), so no rounding occurs in products or sums.
    The precision is stated: a reduced-precision (TF32) product would
    round the operand."""
    import jax
    import jax.numpy as jnp
    hi = jax.lax.Precision.HIGHEST
    return (jnp.matmul(E, xpair[0], precision=hi),
            jnp.matmul(E, xpair[1], precision=hi))


def _df_norm_masked(v, mask):
    """`||v * mask||_2` of a two-float vector (0/1 f32 `mask`; exact
    products) -> f64 scalar for the convergence comparison."""
    import jax.numpy as jnp
    hi, lo = v[0] * mask, v[1] * mask
    p, e = tf.two_prod(hi, hi)
    e = e + (2.0 * (hi * lo) + lo * lo)
    s = tf.df_sum_axis((p, e), axis=-1)
    return jnp.sqrt(s[0].astype(jnp.float64) + s[1].astype(jnp.float64))


def _smooth_df(pack, iterations, x, b):
    """GS sweeps in two-float arithmetic: per level the row block
    ``A[S, :]`` and the one-hot select/scatter matrices are shared across
    directions; each pass applies one dense triangular-inverse update
    (see :func:`_tri_inverse`)."""
    Asel, Esc, EscT, Ts = pack
    bS = _onehot_mv(EscT, b)
    for _ in range(iterations):
        for T in Ts:
            r = tf.df_sub(bS, _df_mv(Asel, x))
            dx = _df_mv(T, r)
            x = tf.df_add(x, _onehot_mv(Esc, dx))
    return x


def _tri_inverse(A_SS, reverse=False):
    """Dense inverse of the GS sweep matrix: lower (upper, for a reversed
    sweep) triangle of ``A[S][:, S]`` in sweep-order basis.  Zero-diagonal
    rows keep the reference's skip semantics (their update is zeroed and
    later rows see the old value through the zero contribution)."""
    M = np.triu(A_SS) if reverse else np.tril(A_SS)
    diag = np.diagonal(A_SS).copy()
    dead = diag == 0.0
    if dead.any():
        # skip semantics need BOTH: dx_dead = 0 (row zeroed in T below)
        # AND no coupling of later rows to the dead update (column zeroed
        # BEFORE inversion — zeroing only the T row still let rows after
        # the dead index absorb the phantom dx_dead = r_dead through the
        # forward substitution)
        M[dead, :] = 0.0
        M[:, dead] = 0.0
        M[dead, dead] = 1.0
    T = np.linalg.inv(M)
    if dead.any():
        T[dead, :] = 0.0
    return T


def _tri_smoother_pack(A, indices, reverse=False, dense=False):
    """Dense-triangular form of one GS sweep over `indices` (in order;
    reversed if `reverse`) on CSR ``A``: the sweep is algebraically
    ``x_S += M^{-1} (b - A x)_S`` with ``M`` the lower (upper, for a
    reversed sweep) triangle of ``A[S][:, S]`` *in sweep-order basis* —
    one dense (m, m) apply replaces the ~wavefront-depth sequence of tiny
    sequential gather/scatter steps.

    Zero/missing-diagonal rows keep the reference's skip semantics
    (relaxation_cy.pyx:62): their update row is zeroed (dx_i = 0), and
    later rows correctly see the old value through the zero contribution.

    Returns ``(S, ell_rows, T)`` with ``ell_rows`` the padded-ELL rows
    ``A[S, :]`` and ``T = M^{-1}`` dense; with ``dense=True`` returns
    ``(A[S, :] dense, T, E_scatter)`` for the all-matmul formulation
    (:func:`_smooth_densemat`)."""
    import scipy.sparse
    if not scipy.sparse.isspmatrix_csr(A):
        A = scipy.sparse.csr_matrix(A)
    S = np.asarray(indices, dtype=np.int64)
    A_SS = A[S][:, S].toarray()
    T = _tri_inverse(A_SS, reverse=reverse)
    if dense:
        n = A.shape[1]
        Esc = np.zeros((n, len(S)))
        Esc[S, np.arange(len(S))] = 1.0
        return np.asarray(A[S].todense()), T, Esc
    ell = ell_pack(A[S])
    return S.astype(np.int32), ell, T


class DeviceMGSolver:
    """One-dispatch local multigrid solver for a fixed hierarchy.

    Args mirror :func:`pyiga_jax.solvers.local_mg_step`: the Galerkin
    matrix hierarchy ``As`` (finest last), virtual-hierarchy prolongators
    ``Ps`` (``Ps[lv]``: level lv -> lv+1), per-level smoothing index sets
    ``lv_inds``, the GS sweep directions ``(pre, post)`` and
    ``smooth_steps``.  ``active_dofs`` masks the convergence residual
    (:func:`~pyiga_jax.solvers.iterative_solve` semantics).

    ``smoother_impl`` selects the kernel set: ``'dense'`` (default below
    ``dense_cutoff`` finest dofs) lowers the ENTIRE cycle to dense
    float64 matvecs, with one-hot selection/scatter matrices in place of
    gathers; ``'df'`` is the same structure in two-float f32 arithmetic
    (every matrix an exact f32 ``(hi, lo)`` pair, products/reductions via
    error-free transformations, :func:`_df_mv`); ``'tri'`` keeps
    padded-ELL matvecs + gather/scatter triangular smoothing (O(nnz)
    memory, for larger hierarchies); ``'wavefront'`` the order-exact
    dependency-wavefront kernel of :mod:`pyiga_jax.ops.relax`.  All
    reproduce the host path's iteration counts (tests/test_localmg.py)."""

    def __init__(self, As, Ps, lv_inds, sweeps, smooth_steps,
                 active_dofs=None, smoother_impl='auto',
                 dense_cutoff=6000, tri_block_cutoff=8192):
        import jax.numpy as jnp
        L = len(As)
        assert len(Ps) == L - 1
        pre_sweep, post_sweep = sweeps
        n = As[-1].shape[0]
        max_block = max((len(lv_inds[lv]) for lv in range(1, L)), default=0)
        if smoother_impl == 'auto':
            if n <= dense_cutoff:
                smoother_impl = 'dense'
            elif max_block <= tri_block_cutoff:
                smoother_impl = 'tri'
            else:
                # 'tri' densifies and inverts each (m, m) smoothing block:
                # O(m^3) setup / O(m^2) f64 memory is a cliff once a
                # smoothing set reaches O(n).  The wavefront kernel is
                # O(nnz) in both and stays device-resident.
                smoother_impl = 'wavefront'
        assert smoother_impl in ('df', 'dense', 'tri', 'wavefront')
        if smoother_impl == 'df':
            from .. import config
            config.require_twofloat_platform("smoother_impl='df'")

        if smoother_impl == 'df':
            self._init_df(As, Ps, lv_inds, sweeps, active_dofs)
        else:
            self._init_plain(As, Ps, lv_inds, sweeps, smoother_impl,
                             active_dofs)
        self.L = L
        self.n0 = As[0].shape[0]
        self.same_sweeps = post_sweep == pre_sweep
        self.smooth_steps = smooth_steps
        self.smoother_impl = smoother_impl

    def _init_df(self, As, Ps, lv_inds, sweeps, active_dofs):
        """Two-float parameter build: every dense matrix is an exact f32
        ``(hi, lo)`` pair (split host-side), one-hot select/scatter
        matrices a single exact f32, shared across sweep directions."""
        import jax.numpy as jnp
        L = len(As)
        pre_sweep, post_sweep = sweeps
        n = As[-1].shape[0]

        def op(M):
            return tuple(map(jnp.asarray, _df_split(M.todense())))

        params = {}
        params['A'] = [op(As[lv]) for lv in range(1, L)]
        params['Afine'] = params['A'][-1] if L > 1 else op(As[0])
        params['P'] = [op(Ps[lv]) for lv in range(L - 1)]
        params['PT'] = [op(Ps[lv].T) for lv in range(L - 1)]

        # per-level smoother data: the row block A[S, :] and the one-hot
        # select/scatter matrices are direction-independent; only the
        # triangular inverse differs per sweep direction
        shared, A_SS = {}, {}
        for lv in range(1, L):
            S = np.asarray(lv_inds[lv], dtype=np.int64)
            Alv = As[lv].tocsr()
            shared_rows = op(Alv[S])
            A_SS[lv] = Alv[S][:, S].toarray()
            Esc = np.zeros((Alv.shape[0], len(S)), dtype=np.float32)
            Esc[S, np.arange(len(S))] = 1.0
            shared[lv] = (shared_rows, jnp.asarray(Esc),
                          jnp.asarray(Esc.T.copy()))

        def op_dense(M):
            return tuple(map(jnp.asarray, _df_split(M)))

        def packs(lv, sweep):
            Ts = tuple(op_dense(_tri_inverse(A_SS[lv], reverse=reverse))
                       for reverse in _SWEEP_DIRS[sweep])
            Asel, Esc, EscT = shared[lv]
            return (Asel, Esc, EscT, Ts)

        params['pre'] = [packs(lv, pre_sweep) for lv in range(1, L)]
        params['post'] = ([] if post_sweep == pre_sweep else
                          [packs(lv, post_sweep) for lv in range(1, L)])

        ind0 = np.asarray(lv_inds[0], dtype=np.int32)
        A0 = As[0][lv_inds[0]][:, lv_inds[0]].toarray()
        params['Cinv'] = op_dense(np.linalg.inv(A0))
        E0 = np.zeros((As[0].shape[0], len(ind0)), dtype=np.float32)
        E0[ind0, np.arange(len(ind0))] = 1.0
        params['E0'] = jnp.asarray(E0)
        params['E0T'] = jnp.asarray(E0.T.copy())

        mask = np.zeros(n, dtype=np.float32)
        if active_dofs is None:
            mask[:] = 1.0
        else:
            mask[np.asarray(active_dofs)] = 1.0
        params['mask'] = jnp.asarray(mask)
        self.params = params

    def _init_plain(self, As, Ps, lv_inds, sweeps, smoother_impl,
                    active_dofs):
        import jax.numpy as jnp
        L = len(As)
        pre_sweep, post_sweep = sweeps
        n = As[-1].shape[0]
        dense = smoother_impl == 'dense'

        def op(M):
            if dense:
                return jnp.asarray(np.asarray(M.todense()))
            return tuple(map(jnp.asarray, ell_pack(M.tocsr())))

        params = {}
        params['A'] = [op(As[lv]) for lv in range(1, L)]
        params['Afine'] = params['A'][-1] if L > 1 else op(As[0])
        params['P'] = [op(Ps[lv]) for lv in range(L - 1)]
        params['PT'] = [op(Ps[lv].T) for lv in range(L - 1)]

        if smoother_impl in ('dense', 'tri'):
            def packs(lv, sweep):
                return tuple(
                    tuple(jnp.asarray(a) if not isinstance(a, tuple)
                          else tuple(map(jnp.asarray, a))
                          for a in _tri_smoother_pack(As[lv], lv_inds[lv],
                                                      reverse=reverse,
                                                      dense=dense))
                    for reverse in _SWEEP_DIRS[sweep])
        else:
            def packs(lv, sweep):
                out = []
                for reverse in _SWEEP_DIRS[sweep]:
                    order, level = level_schedule(As[lv], lv_inds[lv],
                                                  reverse=reverse)
                    out.append(tuple(jnp.asarray(a) for a in
                                     _pack_sweep(As[lv], order, level)))
                return tuple(out)

        params['pre'] = [packs(lv, pre_sweep) for lv in range(1, L)]
        params['post'] = ([] if post_sweep == pre_sweep else
                          [packs(lv, post_sweep) for lv in range(1, L)])

        # coarsest level: dense inverse of the smoothing-set block, applied
        # as a matmul (the host path's make_solver(spd=True) up to ~1e-15)
        ind0 = np.asarray(lv_inds[0], dtype=np.int32)
        A0 = As[0][lv_inds[0]][:, lv_inds[0]].toarray()
        params['Cinv'] = jnp.asarray(np.linalg.inv(A0))
        if dense:
            E0 = np.zeros((As[0].shape[0], len(ind0)))
            E0[ind0, np.arange(len(ind0))] = 1.0
            params['E0'] = jnp.asarray(E0)
        else:
            params['ind0'] = jnp.asarray(ind0)

        mask = np.zeros(n)
        if active_dofs is None:
            mask[:] = 1.0
        else:
            mask[np.asarray(active_dofs)] = 1.0
        params['mask'] = jnp.asarray(mask)
        self.params = params

    def solve(self, f, tol=1e-8, maxiter=5000):
        """Run ``x <- vcycle(x)`` until the masked residual drops by
        ``tol``; returns ``(x, iterations)`` with ``inf`` iterations on
        non-convergence (host-side semantics of ``iterative_solve``)."""
        import jax.numpy as jnp
        fn = _solve_fn(self.L, self.n0, self.smooth_steps,
                       self.same_sweeps, self.smoother_impl)
        packed = fn(self.params, jnp.asarray(f), float(tol), int(maxiter))
        x, res, res0, it = _unpack_result(packed)
        converged = res / res0 < tol
        return x, (it if converged else np.inf)


def _pack_result(x, res, res0, it):
    """Pack ``(x, res, res0, it)`` into ONE f64 array (traced), so the
    whole solve is one dispatch + one fetch."""
    import jax.numpy as jnp
    stats = jnp.stack([res.astype(jnp.float64), res0.astype(jnp.float64),
                       it.astype(jnp.float64)])
    return jnp.concatenate([x.astype(jnp.float64), stats])


def _unpack_result(packed):
    """Host-side inverse of :func:`_pack_result` (single np.asarray)."""
    packed = np.asarray(packed)
    x, (res, res0, it) = packed[:-3], packed[-3:]
    return x, float(res), float(res0), int(it)


_SOLVE_CACHE = {}


def _solve_fn(L, n0, steps, same, impl='dense'):
    """The jitted one-dispatch MG solve, cached per static configuration
    (jax.jit caches by function identity: a per-instance closure would
    re-trace/re-compile on every ``solve_hmultigrid`` call)."""
    key = (L, n0, steps, same, impl)
    fn = _SOLVE_CACHE.get(key)
    if fn is not None:
        return fn
    import jax
    import jax.numpy as jnp
    from jax import lax
    if impl == 'df':
        fn = jax.jit(_make_solve_df(L, steps, same),
                     static_argnames=('maxiter',))
        if len(_SOLVE_CACHE) > 8:
            _SOLVE_CACHE.clear()    # adaptive loops: new key per hierarchy
        _SOLVE_CACHE[key] = fn
        return fn
    smooth = {'dense': _smooth_densemat, 'tri': _smooth_tri,
              'wavefront': _smooth}[impl]

    def mv(op, x):
        return _ell_mv(op, x) if isinstance(op, tuple) else op @ x

    def vcycle(p, x, f):
        pre, post = p['pre'], (p['pre'] if same else p['post'])
        xs, rhss = [None] * L, [None] * L
        xs[L - 1], rhss[L - 1] = x, f
        for lv in range(L - 1, 0, -1):
            xs[lv] = smooth(pre[lv - 1], steps, xs[lv], rhss[lv])
            r = rhss[lv] - mv(p['A'][lv - 1], xs[lv])
            rhss[lv - 1] = mv(p['PT'][lv - 1], r)
            xs[lv - 1] = jnp.zeros_like(rhss[lv - 1])
        if impl == 'dense':
            xs[0] = p['E0'] @ (p['Cinv'] @ (p['E0'].T @ rhss[0]))
        else:
            x0 = jnp.zeros(n0, rhss[0].dtype)
            xs[0] = x0.at[p['ind0']].set(p['Cinv'] @ rhss[0][p['ind0']])
        for lv in range(1, L):
            xs[lv] = xs[lv] + mv(p['P'][lv - 1], xs[lv - 1])
            xs[lv] = smooth(post[lv - 1], steps, xs[lv], rhss[lv])
        return xs[L - 1]

    def solve(p, f, tol, maxiter):
        mask = p['mask']
        res0 = jnp.linalg.norm(f * mask)

        def cond(c):
            x, res, it = c
            # iterative_solve's exact comparison form (counts contract)
            return jnp.logical_and(jnp.logical_not(res / res0 < tol),
                                   it < maxiter)

        def body(c):
            x, _, it = c
            x = vcycle(p, x, f)
            res = jnp.linalg.norm((f - mv(p['Afine'], x)) * mask)
            return x, res, it + 1

        x = jnp.zeros_like(f)
        x, res, it = lax.while_loop(cond, body, (x, res0, 0))
        return _pack_result(x, res, res0, it)

    fn = jax.jit(solve, static_argnames=('maxiter',))
    if len(_SOLVE_CACHE) > 8:
        _SOLVE_CACHE.clear()        # adaptive loops: new key per hierarchy
    _SOLVE_CACHE[key] = fn
    return fn


def _make_solve_df(L, steps, same):
    """The two-float variant of the one-dispatch MG solve: vectors ride as
    f32 ``(hi, lo)`` pairs through the whole V-cycle; the only f64
    arithmetic is the scalar convergence comparison (which keeps
    ``iterative_solve``'s exact form — the counts contract)."""
    import jax.numpy as jnp
    from jax import lax

    def zeros_pair(m):
        z = jnp.zeros(m, jnp.float32)
        return z, z

    def vcycle(p, x, f):
        pre, post = p['pre'], (p['pre'] if same else p['post'])
        xs, rhss = [None] * L, [None] * L
        xs[L - 1], rhss[L - 1] = x, f
        for lv in range(L - 1, 0, -1):
            xs[lv] = _smooth_df(pre[lv - 1], steps, xs[lv], rhss[lv])
            r = tf.df_sub(rhss[lv], _df_mv(p['A'][lv - 1], xs[lv]))
            rhss[lv - 1] = _df_mv(p['PT'][lv - 1], r)
            xs[lv - 1] = zeros_pair(rhss[lv - 1][0].shape[0])
        c = _df_mv(p['Cinv'], _onehot_mv(p['E0T'], rhss[0]))
        xs[0] = _onehot_mv(p['E0'], c)
        for lv in range(1, L):
            xs[lv] = tf.df_add(xs[lv], _df_mv(p['P'][lv - 1], xs[lv - 1]))
            xs[lv] = _smooth_df(post[lv - 1], steps, xs[lv], rhss[lv])
        return xs[L - 1]

    def solve(p, f64, tol, maxiter):
        f = tf.df_from_f64(f64.astype(jnp.float64))
        mask = p['mask']
        res0 = _df_norm_masked(f, mask)

        def cond(c):
            xhi, xlo, res, it = c
            # iterative_solve's exact comparison form (counts contract)
            return jnp.logical_and(jnp.logical_not(res / res0 < tol),
                                   it < maxiter)

        def body(c):
            xhi, xlo, _, it = c
            x = vcycle(p, (xhi, xlo), f)
            r = tf.df_sub(f, _df_mv(p['Afine'], x))
            res = _df_norm_masked(r, mask)
            return (*x, res, it + 1)

        x0 = zeros_pair(f64.shape[0])
        xhi, xlo, res, it = lax.while_loop(cond, body, (*x0, res0, 0))
        return _pack_result(tf.df_to_f64((xhi, xlo)), res, res0, it)

    return solve
