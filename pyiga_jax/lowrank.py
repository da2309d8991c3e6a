# -*- coding: utf-8 -*-
"""Low-rank (ACA) assembling.

API parity with /root/reference/pyiga/lowrank.py and the C++ driver
fastasm.cc.  The key insight (Hofreither 2018): the *reordered* compact
matrix of an IgA operator has low rank for smooth geometries, so adaptive
cross approximation needs only O(rank * n) entry evaluations.

The twist here: the pivoting loop runs on host, but every row/column/
slice request is served by ONE device call that evaluates the whole fiber of
the compact tensor via a rank-1-restricted sum-factorization contraction
(:meth:`~pyiga_jax.compile.VFormAssembler.compact_slice`) — replacing the
reference's scalar entry callback through a C function pointer
(fastasm.cc:538 ReorderedMatrixGenerator)."""

import numpy as np

from . import native, tensor, utils


################################################################################
# Entrywise/slicewise tensor generators
################################################################################

class TensorGenerator:
    """A tensor defined by an entry function and (optionally) a fast
    slice function.

    Args:
        shape: tensor shape.
        entryfunc: maps one multi-index to the entry value.
        multientryfunc: maps a sequence of multi-indices to a value array.
        slicefunc: maps a dict ``axis -> index`` (the pinned axes) to the
            dense array over the remaining axes (fast path for ACA).
    """

    def __init__(self, shape, entryfunc=None, multientryfunc=None,
                 slicefunc=None):
        self.shape = tuple(shape)
        self.ndim = len(self.shape)
        assert entryfunc is not None or multientryfunc is not None \
            or slicefunc is not None, 'need an entry or slice function'
        if entryfunc is not None:
            self.entry = entryfunc
        if multientryfunc is not None:
            self.compute_entries = multientryfunc
        self.slicefunc = slicefunc

    @staticmethod
    def from_array(X):
        # np.array copy: basic indexing would return live views of X, and
        # ACA drivers mutate the slices they receive (pivot zeroing)
        return TensorGenerator(
            X.shape, lambda I: X[tuple(I)],
            slicefunc=lambda fixed: np.array(X[tuple(
                fixed.get(k, slice(None)) for k in range(X.ndim))]))

    def entry(self, I):
        if self.slicefunc is not None:
            return self.slicefunc(dict(enumerate(I)))
        return self.compute_entries([I])[0]

    def compute_entries(self, indices):
        indices = list(indices)
        out = np.empty(len(indices))
        for i, I in enumerate(indices):
            out[i] = self.entry(tuple(I))
        return out

    def __getitem__(self, I):
        I, shp, singl = tensor._normalize_indices(I, self.shape)
        # fast path: every axis is either pinned or taken in full
        if self.slicefunc is not None:
            fixed = {}
            full = True
            for k, ik in enumerate(I):
                if len(ik) == 1:
                    fixed[k] = ik.start if isinstance(ik, range) else int(ik[0])
                elif isinstance(ik, range) and ik == range(self.shape[k]):
                    pass
                else:
                    full = False
                    break
            if full:
                X = np.asarray(self.slicefunc(fixed))
                # re-insert pinned axes, reshape to shp, squeeze scalars
                return X.reshape(shp).squeeze(axis=singl) if singl else \
                    X.reshape(shp)
        arange = [np.arange(ik.start, ik.stop, ik.step)
                  if isinstance(ik, range) else ik for ik in I]
        indices = utils.cartesian_product(arange)
        X = self.compute_entries(indices).reshape(shp)
        return np.squeeze(X, axis=singl)

    def matrix_at(self, I, axes):
        """Generator for the 2D slice through index `I` along `axes`."""
        assert len(axes) == 2 and len(I) == len(self.shape)
        I = list(I)

        def multientryfunc(indices):
            indices = list(indices)
            for k in range(len(indices)):
                I[axes[0]], I[axes[1]] = indices[k]
                indices[k] = tuple(I)
            return self.compute_entries(indices)

        slicefunc = None
        if self.slicefunc is not None:
            def slicefunc(fixed):
                outer_fixed = {k: I[k] for k in range(self.ndim)
                               if k not in axes}
                outer_fixed.update({axes[j]: v for j, v in fixed.items()})
                return self.slicefunc(outer_fixed)

        return TensorGenerator((self.shape[axes[0]], self.shape[axes[1]]),
                               multientryfunc=multientryfunc,
                               slicefunc=slicefunc)

    def asarray(self):
        if self.slicefunc is not None:
            return np.asarray(self.slicefunc({}))
        I = utils.cartesian_product(tuple(np.arange(n) for n in self.shape))
        return self.compute_entries(I).reshape(self.shape, order='C')


class MatrixGenerator(TensorGenerator):
    """2D special case of :class:`TensorGenerator`."""

    def __init__(self, m, n, entryfunc=None, multientryfunc=None,
                 slicefunc=None):
        super().__init__((m, n), entryfunc=entryfunc,
                         multientryfunc=multientryfunc, slicefunc=slicefunc)

    @staticmethod
    def from_array(X):
        assert X.ndim == 2
        return MatrixGenerator(
            X.shape[0], X.shape[1], lambda I: X[tuple(I)],
            slicefunc=lambda fixed: X[fixed.get(0, slice(None)),
                                      fixed.get(1, slice(None))])

    def row(self, i):
        return self[i, :]

    def column(self, j):
        return self[:, j]


def rank_1_update(X, alpha, u, v):
    """In-place ``X += alpha * outer(u, v)`` (native kernel)."""
    return native.rank_1_update(X, alpha, u, v)


def aca3d_update(X, alpha, col, mat):
    """In-place ``X += alpha * col (x) mat`` for a 3D tensor."""
    X += alpha * col[:, None, None] * mat[None, :, :]
    return X


################################################################################
# Adaptive cross approximation
################################################################################


class _PivotControl:
    """Shared pivot bookkeeping of the ACA drivers: counts consecutive
    below-tolerance pivots and zero-pivot skips, enforces the iteration
    cap, and emits the reference-compatible verbose log (stopping rules of
    the reference ACA core, fastasm.cc:291-368)."""

    def __init__(self, tol, maxiter, skipcount, tolcount, verbose,
                 what='it.'):
        self.tol, self.maxiter = tol, maxiter
        self.max_skips, self.max_hits = skipcount, tolcount
        self.verbose, self.what = verbose, what
        self.it = self.skips = self.hits = 0

    def classify(self, e, where):
        """Classify a pivot magnitude: 'skip' (degenerate pivot — repivot,
        then ask :meth:`skipped_out`), 'stop', or 'take'."""
        if e < 1e-15:
            if self.verbose >= 2:
                print('skipping', where)
            return 'skip'
        if e < self.tol:
            self.hits += 1
            if self.hits >= self.max_hits:
                if self.verbose >= 1:
                    print('desired tolerance reached', self.hits,
                          'times; stopping (%d %s)' % (self.it, self.what))
                return 'stop'
        else:
            self.skips = self.hits = 0
        return 'take'

    def skipped_out(self):
        """Count one skip; True when the skip budget is exhausted."""
        self.skips += 1
        if self.skips >= self.max_skips:
            if self.verbose >= 1:
                print('maximum skip count reached; stopping (%d %s)'
                      % (self.it, self.what))
            return True
        return False

    def advance(self):
        """Count one accepted cross; True while under the iteration cap."""
        self.it += 1
        if self.it >= self.maxiter:
            if self.verbose >= 1:
                print('Maximum iteration count reached; aborting (%d %s)'
                      % (self.it, self.what))
            return False
        return True


def aca(A, tol=1e-10, maxiter=100, skipcount=3, tolcount=3, verbose=2,
        startval=None):
    """Row-pivoted adaptive cross approximation of a matrix (generator);
    returns the dense approximation.  Stopping: `tolcount` hits below `tol`
    or `skipcount` zero-pivot rows (reference lowrank.py:87 / fastasm.cc:294).
    """
    if not isinstance(A, TensorGenerator):
        A = MatrixGenerator.from_array(np.asarray(A))
    assert A.ndim == 2
    X = (np.array(startval, order='C') if startval is not None
         else np.zeros(A.shape, order='C'))
    assert X.shape == A.shape

    ctl = _PivotControl(tol, maxiter, skipcount, tolcount, verbose)
    i = A.shape[0] // 2
    while True:
        E_row = X[i, :] - A[i, :]
        j0 = abs(E_row).argmax()
        verdict = ctl.classify(abs(E_row[j0]), i)
        if verdict == 'stop':
            break
        if verdict == 'skip':
            i = np.random.randint(A.shape[0])
            if ctl.skipped_out():
                break
            continue
        if verbose >= 2:
            print(i, '\t', j0, '\t', abs(E_row[j0]))

        col = A[:, j0] - X[:, j0]
        rank_1_update(X, 1.0 / E_row[j0], col, E_row)

        col[i] = 0
        i = abs(col).argmax()
        if not ctl.advance():
            break
    return X


def aca_lr(A, tol=1e-10, maxiter=100, verbose=2):
    """ACA returning the rank-1 crosses ``(col, row)`` instead of the full
    matrix."""
    if not isinstance(A, TensorGenerator):
        A = MatrixGenerator.from_array(np.asarray(A))
    assert A.ndim == 2
    crosses = []

    def X_row(i):
        return sum((c[i] * r for c, r in crosses), np.zeros(A.shape[1]))

    def X_col(j):
        return sum((c * r[j] for c, r in crosses), np.zeros(A.shape[0]))

    ctl = _PivotControl(tol, maxiter, 3, 3, verbose)
    i = A.shape[0] // 2
    while True:
        err_i = X_row(i) - A[i, :]
        j0 = abs(err_i).argmax()
        verdict = ctl.classify(abs(err_i[j0]), i)
        if verdict == 'stop':
            break
        if verdict == 'skip':
            i = np.random.randint(A.shape[0])
            if ctl.skipped_out():
                break
            continue
        if verbose >= 2:
            print(i, '\t', j0, '\t', abs(err_i[j0]))
        c = (A[:, j0] - X_col(j0)) / err_i[j0]
        crosses.append((c, err_i))
        i = abs(c).argmax()
        if not ctl.advance():
            break
    return crosses


def aca_3d(A, tol=1e-10, maxiter=100, skipcount=3, tolcount=3, verbose=2,
           lr=False, slices='auto'):
    """Nested 3D ACA: outer pivoting over fibers, each pivot slice either
    evaluated exactly in one slice call or approximated by an inner 2D ACA
    warm-started from the current approximation (reference lowrank.py:192 /
    fastasm.cc:385).

    ``slices='materialize'`` fetches each outer pivot slice with a single
    ``slicefunc`` call instead of running the inner 2D ACA.  For the
    device-backed compact generator a whole 2D slice costs one sum-factorized
    device call — barely more than the single column the inner ACA would
    fetch per iteration, so ~25 sequential dispatches per outer step
    collapse into one (the reference's per-entry callback makes the
    opposite trade, fastasm.cc:469).  'auto' materializes whenever the
    generator has a slice function; 'aca' forces the reference algorithm."""
    if not isinstance(A, TensorGenerator):
        A = TensorGenerator.from_array(np.asarray(A))
    assert A.ndim == 3
    assert slices in ('auto', 'materialize', 'aca')
    if slices == 'auto':
        slices = 'materialize' if A.slicefunc is not None else 'aca'

    # The approximation is held as crosses (cols[r], mats[r]) with
    # X = sum_r cols[r] (x) mats[r]; residual fibers/slices are evaluated
    # from the crosses in O(R n) / O(R n^2), so the dense n^3 tensor is
    # touched only once, at the final inflation (in 'aca' mode the inner
    # 2D ACA needs the running slice anyway, so there the classic dense
    # accumulation costs nothing extra).
    cols, mats = [], []

    def X_fiber(i1, i2):
        out = np.zeros(A.shape[0])
        for c, M in zip(cols, mats):
            out += M[i1, i2] * c
        return out

    def X_slice(i0):
        out = np.zeros(A.shape[1:])
        for c, M in zip(cols, mats):
            out += c[i0] * M
        return out

    dense = (slices == 'aca') and not lr
    if dense:
        X = np.zeros(A.shape)

    ctl = _PivotControl(tol, maxiter, skipcount, tolcount, verbose,
                        what='outer it.')
    I = [m // 2 for m in A.shape]
    while True:
        E_col = A[:, I[1], I[2]] - (X[:, I[1], I[2]] if dense
                                    else X_fiber(I[1], I[2]))
        i0 = abs(E_col).argmax()
        verdict = ctl.classify(abs(E_col[i0]), I)
        if verdict == 'stop':
            break
        if verdict == 'skip':
            I[:] = [np.random.randint(m) for m in A.shape]
            if ctl.skipped_out():
                break
            continue

        I[0] = i0
        if verbose >= 2:
            print(I, '\t', abs(E_col[i0]))

        X_i0 = X[i0, :, :] if dense else X_slice(i0)
        if slices == 'materialize':
            A_mat = np.asarray(A[i0, :, :])
        else:
            A_mat = aca(A.matrix_at(I, axes=(1, 2)), startval=X_i0,
                        tol=tol, maxiter=maxiter, skipcount=skipcount,
                        tolcount=tolcount, verbose=min(verbose, 1))
        E_mat = A_mat - X_i0

        cols.append(E_col / E_col[i0])
        mats.append(E_mat.copy())
        if dense:
            aca3d_update(X, 1.0 / E_col[i0], E_col, E_mat)

        E_mat[tuple(I[1:])] = 0
        I[1:] = np.unravel_index(abs(E_mat).argmax(), E_mat.shape)
        if not ctl.advance():
            break
    if lr:
        if not cols:        # no cross accepted (e.g. zero tensor)
            return tensor.TensorSum(tensor.TensorProd(
                np.zeros(A.shape[0]), np.zeros(A.shape[1:])))
        return tensor.TensorSum(*(tensor.TensorProd(c, M)
                                  for c, M in zip(cols, mats)))
    if dense:
        return X
    if not cols:
        return np.zeros(A.shape)
    C, M = np.stack(cols), np.stack(mats)
    # BLAS dgemm instead of einsum('ri,rjk->ijk') (einsum takes the
    # non-BLAS path here; measured 3.6 s vs ~0.1 s at n=48)
    return (C.T @ M.reshape(len(cols), -1)).reshape(
        C.shape[1], *M.shape[1:])


_ACA_STEP_CACHE = {}


_ACA_CROSS_CHUNK = 32


def _masked_cross_sum(w, mats, count):
    """``sum_r w[r] * mats[r]`` over the live slot prefix, accumulated in
    32-slot chunks (``lax.fori_loop`` with a traced trip count): the f64
    scale-add over the ``(slots, n1, n2)`` cross buffer is the per-pivot
    cost floor of the device ACA, and a fixed maxiter-slot contraction
    pays for ALL slots no matter how few are live.  `w` must already be
    masked to ``arange < count`` (the partial last chunk then needs no
    extra masking).  The slot dimension must be a chunk multiple
    (buffers are rounded up at allocation) so the slices never clamp."""
    import jax.numpy as jnp
    from jax import lax

    CH = _ACA_CROSS_CHUNK
    Rp = mats.shape[0]
    if Rp % CH:
        CH = next(c for c in range(min(CH, Rp), 0, -1) if Rp % c == 0)
    nch = (count + (CH - 1)) // CH

    def body(j, acc):
        wj = lax.dynamic_slice(w, (j * CH,), (CH,))
        mj = lax.dynamic_slice(mats, (j * CH, 0, 0),
                               (CH,) + mats.shape[1:])
        return acc + jnp.tensordot(wj, mj, axes=1)

    return lax.fori_loop(0, nch, body,
                         jnp.zeros(mats.shape[1:], mats.dtype))


def _aca_device_step(fiber_fn, slice_fn, shape, R):
    """The fused ACA pivot step, jit-cached ACROSS :func:`aca_3d_device`
    invocations.  Defining the jit inside the driver rebuilt (and
    re-traced + re-compiled) it on every call, so every invocation paid
    a compile in its first loop iteration.  The cache key is by
    slice-evaluator identity, which ``VFormAssembler._slice_fn_cached``
    keeps stable per assembler."""
    import functools

    import jax
    import jax.numpy as jnp

    key = (fiber_fn, slice_fn, shape, R)
    fn = _ACA_STEP_CACHE.get(key)
    if fn is not None:
        return fn
    n0, n1, n2 = shape

    def one_pivot(cols, mats, count, I, fields, tables):
        # buffers carry R+1 slots: the speculative second pivot may write
        # at slot count+1 == R, which XLA's dynamic_update would otherwise
        # CLAMP to R-1 and silently overwrite the accepted slot
        mask = (jnp.arange(cols.shape[0]) < count).astype(cols.dtype)
        fiber = fiber_fn(fields, tables, I[1:])             # (n0,)
        w = mats[:, I[1], I[2]]                             # (R,)
        Ef = fiber - (mask * w) @ cols
        i0 = jnp.argmax(jnp.abs(Ef))
        e0 = Ef[i0]
        S = slice_fn(fields, tables, i0[None])              # (n1, n2)
        Xs = _masked_cross_sum(mask * cols[:, i0], mats, count)
        Em = S - Xs
        # append at slot `count`; the host makes it visible by bumping
        # count only when the pivot is accepted
        cols = jax.lax.dynamic_update_index_in_dim(
            cols, Ef / e0, count, 0)
        mats = jax.lax.dynamic_update_index_in_dim(mats, Em, count, 0)
        EmZ = Em.at[I[1], I[2]].set(0.0)
        flat = jnp.argmax(jnp.abs(EmZ))
        out = jnp.stack([i0.astype(cols.dtype), jnp.abs(e0),
                         (flat // n2).astype(cols.dtype),
                         (flat % n2).astype(cols.dtype)])
        return cols, mats, out

    @functools.partial(jax.jit, donate_argnums=(0, 1))
    def step(cols, mats, count, I, fields, tables):
        """TWO chained pivots per dispatch: pivot B speculates that pivot
        A is accepted (the common case — its inputs are exactly A's
        device-computed verdict packet).  The host replays the same
        per-pivot accept/skip/stop decisions in order, so the pivot
        SEQUENCE is identical to the one-pivot form: a rejected or
        discarded speculation only leaves data in slots >= the final
        accepted count, which the mask and the end-of-loop slice never
        read.  Halves the verdict-fetch round trips."""
        cols, mats, outA = one_pivot(cols, mats, count, I, fields, tables)
        I_B = outA[jnp.array([0, 2, 3])].astype(I.dtype)
        cols, mats, outB = one_pivot(cols, mats, count + 1, I_B,
                                     fields, tables)
        return cols, mats, jnp.stack([outA, outB])   # ONE verdict fetch

    if len(_ACA_STEP_CACHE) > 64:
        _ACA_STEP_CACHE.clear()
    _ACA_STEP_CACHE[key] = step
    return step


_ACA_LOOP_CACHE = {}


def _aca_device_loop(fiber_fn, slice_fn, shape, R, tol, skipcount,
                     tolcount):
    """The WHOLE outer pivot loop as one fused jit (lax.while_loop): no
    per-pivot verdict fetch at all — the host pulls a single iteration
    count afterwards.  The pivot bookkeeping replicates
    :class:`_PivotControl` in-trace (classify / skipped_out / advance,
    reference stopping rules fastasm.cc:291-368); the only divergence is
    the repivot draw after a degenerate (<1e-15) pivot, which uses the
    jax PRNG instead of np.random — pivot sequences are identical until
    a degenerate pivot occurs (none do on the bench workloads).
    Cached across invocations like :func:`_aca_device_step`."""
    import functools

    import jax
    import jax.numpy as jnp

    key = (fiber_fn, slice_fn, shape, R, float(tol), skipcount, tolcount)
    fn = _ACA_LOOP_CACHE.get(key)
    if fn is not None:
        return fn
    n0, n1, n2 = shape

    def body(state, fields, tables):
        cols, mats, count, I, hits, skips, it, done, rng = state
        mask = (jnp.arange(cols.shape[0]) < count).astype(cols.dtype)
        fiber = fiber_fn(fields, tables, I[1:])             # (n0,)
        w = mats[:, I[1], I[2]]
        Ef = fiber - (mask * w) @ cols
        i0 = jnp.argmax(jnp.abs(Ef))
        e = jnp.abs(Ef[i0])
        # classify (order matters: a degenerate pivot never counts a hit)
        skip = e < 1e-15
        below = (~skip) & (e < tol)
        hits = jnp.where(skip, hits, jnp.where(below, hits + 1, 0))
        skips_new = jnp.where(skip, skips + 1, jnp.where(below, skips, 0))
        stop_tol = below & (hits >= tolcount)
        stop_skip = skip & (skips_new >= skipcount)
        take = (~skip) & (~stop_tol)
        # evaluate + append the cross (discarded unless taken: count only
        # advances on take, and masked reads never see slots >= count)
        S = slice_fn(fields, tables, i0[None])              # (n1, n2)
        Xs = _masked_cross_sum(mask * cols[:, i0], mats, count)
        Em = S - Xs
        cols = jax.lax.dynamic_update_index_in_dim(cols, Ef / Ef[i0],
                                                   count, 0)
        mats = jax.lax.dynamic_update_index_in_dim(mats, Em, count, 0)
        count = count + take
        it = it + take
        stop_iter = take & (it >= R)
        # next pivot: argmax of the residual slice (taken), or a random
        # restart (degenerate pivot)
        EmZ = Em.at[I[1], I[2]].set(0.0)
        flat = jnp.argmax(jnp.abs(EmZ))
        I_take = jnp.stack([i0, flat // n2, flat % n2]).astype(I.dtype)
        rng, sub = jax.random.split(rng)
        I_skip = jax.random.randint(
            sub, (3,), 0, jnp.asarray(shape, I.dtype), dtype=I.dtype)
        I = jnp.where(skip, I_skip, jnp.where(take, I_take, I))
        done = stop_tol | stop_skip | stop_iter
        return (cols, mats, count, I, hits, skips_new, it, done, rng)

    @functools.partial(jax.jit, donate_argnums=(0, 1))
    def loop(cols, mats, I, seed, fields, tables):
        state = (cols, mats, jnp.int64(0), I, jnp.int64(0), jnp.int64(0),
                 jnp.int64(0), jnp.bool_(False),
                 jax.random.PRNGKey(seed))
        state = jax.lax.while_loop(
            lambda s: ~s[7], lambda s: body(s, fields, tables), state)
        return state[0], state[1], state[2]

    if len(_ACA_LOOP_CACHE) > 64:
        _ACA_LOOP_CACHE.clear()
    _ACA_LOOP_CACHE[key] = loop
    return loop


def aca_3d_device(asm, tol=1e-10, maxiter=100, skipcount=3, tolcount=3,
                  verbose=2):
    """Device-resident nested 3D ACA over an assembler's compact tensor:
    one fused jit dispatch per outer pivot.

    The materialized-slice driver (:func:`aca_3d` over
    :func:`compact_generator`) pulls every pivot slice to the host —
    ~1 MB per outer step.  This driver keeps the crosses in device
    memory: each outer step fuses the residual fiber, pivot argmax, pivot
    slice evaluation, cross append (into fixed ``maxiter``-slot buffers,
    donated across steps) and the next-pivot argmax into ONE jit
    (:func:`_aca_device_step`, cached across invocations), and fetches
    only a 4-scalar verdict packet.  The crosses are pulled once at the
    end.  Same pivoting rules and arithmetic as :func:`aca_3d` with
    ``slices='materialize'`` (reference algorithm: fastasm.cc:385).
    Returns the dense compact data tensor."""
    import jax
    import jax.numpy as jnp

    fiber_fn = asm._slice_fn_cached((1, 2))
    slice_fn = asm._slice_fn_cached((0,))
    fields, tables = asm._slice_operands()
    shape = tuple(len(bx) for bx in asm.structure.bidx)
    n0, n1, n2 = shape
    R = maxiter
    step = _aca_device_step(fiber_fn, slice_fn, shape, R)

    dtype = jnp.float64
    # +1 slot for the speculative pivot; rounded up to the cross-chunk
    # multiple so _masked_cross_sum's slices never clamp
    Rp = -(-(R + 1) // _ACA_CROSS_CHUNK) * _ACA_CROSS_CHUNK
    cols_d = jnp.zeros((Rp, n0), dtype)
    mats_d = jnp.zeros((Rp, n1, n2), dtype)
    count = 0
    I = [m // 2 for m in shape]
    if verbose == 0:
        # no pivot log wanted: run the WHOLE pivot loop as one device
        # program and fetch a single count (no per-pivot round trip)
        loop = _aca_device_loop(fiber_fn, slice_fn, shape, R, tol,
                                skipcount, tolcount)
        cols_d, mats_d, count_d = loop(
            cols_d, mats_d, jnp.asarray(np.array(I, np.int64)),
            np.random.randint(2 ** 31), fields, tables)
        count = int(count_d)
        return _aca_inflate(cols_d, mats_d, count, shape)
    ctl = _PivotControl(tol, maxiter, skipcount, tolcount, verbose,
                        what='outer it.')
    done = False
    while not done:
        cols_d, mats_d, out2 = step(cols_d, mats_d, jnp.asarray(count),
                                    jnp.asarray(np.array(I, np.int64)),
                                    fields, tables)
        # replay BOTH pivots' verdicts in order; a skip or stop on pivot
        # A discards pivot B's speculative cross (it sits in a slot >=
        # the final count, which the mask and final slice never read)
        for i0, e0, j1, j2 in np.asarray(out2):
            verdict = ctl.classify(float(e0), I)
            if verdict == 'stop':
                done = True
                break
            if verdict == 'skip':
                I[:] = [np.random.randint(m) for m in shape]
                done = ctl.skipped_out()
                break
            I[0] = int(i0)
            if verbose >= 2:
                print(I, '\t', float(e0))
            count += 1
            I[1], I[2] = int(j1), int(j2)
            if not ctl.advance():
                done = True
                break

    return _aca_inflate(cols_d, mats_d, count, shape)


def _aca_inflate(cols_d, mats_d, count, shape):
    """Pull the accepted crosses and inflate the dense compact tensor.

    Chunked pull + inflation: split the accepted crosses into row
    chunks, start ALL transfers up front (they stream back-to-back),
    and fold each chunk into the dense tensor as it
    lands — the dgemm of chunk r overlaps the transfer of chunk r+1.
    (A bulk pull + one dgemm ran serially: ~1.1 s + ~1.9 s at n=48 on
    the 1-vCPU bench host.  An async PER-STEP pull during the pivot
    loop is measured slower still — 8.3 vs 5.0 s — the copies
    serialize with the dispatches; do not move the pulls into the
    loop.)  BLAS dgemm, not einsum('ri,rjk->ijk'): the einsum form
    took the non-BLAS path here (measured 3.6 s vs ~0.1 s at n=48)."""
    from scipy.linalg import blas
    n0, n1, n2 = shape
    if count == 0:
        return np.zeros(shape)
    nflat = n1 * n2
    chunk = max(4, -(-count // 6))
    parts = []
    for r0 in range(0, count, chunk):
        c = cols_d[r0:min(r0 + chunk, count)]
        m = mats_d[r0:min(r0 + chunk, count)]
        try:
            c.copy_to_host_async()
            m.copy_to_host_async()
        except Exception:
            pass
        parts.append((c, m))
    X = np.zeros((n0, nflat))
    XT = X.T                    # F-contiguous view: dgemm writes in place
    for c, m in parts:
        cn = np.asarray(c, dtype=np.float64)
        mn = np.asarray(m, dtype=np.float64).reshape(cn.shape[0], nflat)
        # X += cn.T @ mn, computed as the transposed problem so the
        # accumulator is F-contiguous and BLAS updates it without a copy
        out = blas.dgemm(1.0, mn.T, cn, 1.0, XT, 0, 0, 1)
        if out is not XT and not np.shares_memory(out, X):
            XT, X = out, out.T      # BLAS copied after all: keep ITS buffer
    return np.ascontiguousarray(X).reshape(n0, n1, n2)


################################################################################
# Fast assembling driver (replaces fastasm.cc + fast_assemble_cy)
################################################################################

def compact_generator(asm):
    """A :class:`TensorGenerator` over the compact (reordered) data tensor of
    the given sum-factorization assembler; slices are evaluated on device."""
    S = asm.structure
    shape = tuple(len(bx) for bx in S.bidx)
    return TensorGenerator(shape, slicefunc=asm.compact_slice)


def fast_assemble(asm, kvs, tol=1e-10, maxiter=100, skipcount=3,
                  tolcount=3, verbose=2, method='auto'):
    """Assemble the matrix of `asm` by low-rank ACA over the compact
    (reordered) matrix; returns a scipy CSR matrix.

    The compact tensor IS the reordered matrix, so no reindexing or
    inflation step is needed: the ACA result is used directly as the
    MLMatrix data tensor.  On the GPU the 3D driver runs device-resident
    (:func:`aca_3d_device`: one dispatch and a 4-scalar fetch per outer
    pivot; the crosses are pulled once at the end); ``method='host'``
    forces the materialized-slice host driver."""
    from . import config

    if method not in ('auto', 'host'):
        raise ValueError("method must be 'auto' or 'host'")
    S = asm.structure
    if S.L == 2:
        X = aca(compact_generator(asm), tol=tol, maxiter=maxiter,
                skipcount=skipcount, tolcount=tolcount, verbose=verbose)
    elif S.L == 3:
        if method == 'auto' and config.platform() == 'gpu':
            X = aca_3d_device(asm, tol=tol, maxiter=maxiter,
                              skipcount=skipcount, tolcount=tolcount,
                              verbose=verbose)
        else:
            X = aca_3d(compact_generator(asm), tol=tol, maxiter=maxiter,
                       skipcount=skipcount, tolcount=tolcount,
                       verbose=verbose)
    else:
        raise NotImplementedError('fast assembling only for 2D and 3D')
    return S.make_mlmatrix(data=X).asmatrix('csr')
