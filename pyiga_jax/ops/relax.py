"""Device-resident, order-exact indexed Gauss-Seidel relaxation.

The local multigrid smoother is a *strictly sequential* Gauss-Seidel sweep
over a subset of rows in a prescribed order (reference relaxation_cy.pyx:35
``gauss_seidel_indexed``); the solver's iteration counts depend on that
order, so a naive parallel (Jacobi-like or red-black) relaxation is not an
admissible port.

The device equivalent keeps the *sequential semantics* but extracts the
available parallelism as a dependency wavefront: row ``t`` must wait for an
earlier-in-sweep row ``s`` iff ``A[t, s] != 0`` (only then does ``t`` read a
value that ``s`` writes).  The greedy longest-path level assignment over
this DAG yields levels of rows that can update simultaneously — within a
level no row reads another's output, so updating them in parallel computes
bit-identical dependencies to the sequential sweep (each row still sees
exactly the values the sequential order would give it; the only deviation
from the scalar kernel is the intra-row reduction order, whose ~1e-16
effect the iteration-count contract tolerates — validated by the exact
counts in tests/test_localmg.py).

The whole smoothing application (all ``iterations`` x sweep passes x
levels) runs as ONE jitted device call: levels are padded to a rectangle
and iterated with ``lax.fori_loop``; rows/columns stream through gathers.
This removes the per-sweep host round-trip of the host CSR kernel
(native/iga_kernels.cc) from the local MG V-cycle.
"""

import numpy as np


def level_schedule(A, indices, reverse=False):
    """Greedy wavefront levels for a Gauss-Seidel sweep over `indices` (in
    order; reversed if `reverse`) on the CSR matrix `A`.

    Returns ``(order, level)`` where ``order`` is the sweep order (row ids)
    and ``level[r]`` the wavefront level of ``order[r]``: the longest
    dependency path from any earlier sweep position whose value row
    ``order[r]`` reads."""
    import scipy.sparse
    if not scipy.sparse.isspmatrix_csr(A):
        A = scipy.sparse.csr_matrix(A)
    ind = np.asarray(indices, dtype=np.int64)
    assert len(np.unique(ind)) == len(ind), 'smoothing indices must be unique'
    order = ind[::-1] if reverse else ind
    n = A.shape[0]
    rank = np.full(n, -1, dtype=np.int64)
    rank[order] = np.arange(len(order))
    level = np.zeros(len(order), dtype=np.int64)
    indptr, cols = A.indptr, A.indices
    Acsc = A.tocsc()
    for r, i in enumerate(order):
        # flow dependency: row i reads values updated earlier in the sweep
        rs = rank[cols[indptr[i]:indptr[i + 1]]]
        rs = rs[(rs >= 0) & (rs < r)]
        lv = level[rs].max() + 1 if rs.size else 0
        # anti-dependency (WAR): earlier sweep positions whose rows READ
        # column i must see its OLD value — within a level all reads
        # precede all writes, so level[r] >= their level suffices.  For
        # structurally symmetric A this never raises the level further.
        rd = rank[Acsc.indices[Acsc.indptr[i]:Acsc.indptr[i + 1]]]
        rd = rd[(rd >= 0) & (rd < r)]
        if rd.size:
            lv = max(lv, int(level[rd].max()))
        level[r] = lv
    return order, level


def _pack_sweep(A, order, level):
    """Pad one sweep's rows into rectangular per-level arrays:
    ``rows (L, P)`` (pad = n, dropped on scatter), ``cols (L, P, W)`` /
    ``vals (L, P, W)`` (the row's off-diagonal CSR entries, zero padded)
    and ``diag (L, P)`` (pad 1)."""
    n = A.shape[0]
    indptr, cols_all, data = A.indptr, A.indices, A.data
    m = len(order)
    if m == 0:
        return (np.full((1, 1), n, np.int32), np.zeros((1, 1, 1), np.int32),
                np.zeros((1, 1, 1), np.float64), np.ones((1, 1), np.float64))
    L = int(level.max()) + 1
    counts = np.bincount(level, minlength=L)
    P = int(counts.max())
    W = int(max(indptr[i + 1] - indptr[i] for i in order))
    rows = np.full((L, P), n, dtype=np.int32)
    cols = np.zeros((L, P, W), dtype=np.int32)
    vals = np.zeros((L, P, W), dtype=np.float64)
    diag = np.ones((L, P), dtype=np.float64)
    slot = np.zeros(L, dtype=np.int64)
    for r, i in enumerate(order):
        l = level[r]
        p = slot[l]
        slot[l] += 1
        c = cols_all[indptr[i]:indptr[i + 1]]
        v = data[indptr[i]:indptr[i + 1]].copy()
        dmask = c == i
        if not dmask.any() or v[dmask][0] == 0.0:
            # zero/missing diagonal: skip the row (reference
            # relaxation_cy.pyx:62 semantics; rows[l, p] stays at the
            # padding value so the scatter drops the update)
            continue
        rows[l, p] = i
        diag[l, p] = v[dmask][0]
        v[dmask] = 0.0
        cols[l, p, :len(c)] = c
        vals[l, p, :len(c)] = v
    return rows, cols, vals, diag


_JIT_CACHE = {}


def _smooth_fn(iterations, n_passes):
    """The jitted multi-pass smoother, cached per static config."""
    key = (iterations, n_passes)
    fn = _JIT_CACHE.get(key)
    if fn is not None:
        return fn
    import jax
    import jax.numpy as jnp
    from jax import lax

    def smooth(passes, x, b):
        def one_pass(x, pack):
            rows, cols, vals, diag = pack

            def body(l, x):
                r = rows[l]
                z = jnp.sum(vals[l] * x[cols[l]], axis=-1)
                fi = b.at[r].get(mode='fill', fill_value=0.0)
                xi = (fi - z) / diag[l]
                return x.at[r].set(xi, mode='drop')

            return lax.fori_loop(0, rows.shape[0], body, x)

        for _ in range(iterations):
            for pack in passes:
                x = one_pass(x, pack)
        return x

    fn = jax.jit(smooth)
    _JIT_CACHE[key] = fn
    return fn


class DeviceIndexedGS:
    """Device-resident indexed Gauss-Seidel smoother for a fixed matrix,
    index subset, sweep direction and iteration count.

    ``apply(x, b)`` updates `x` in place (host arrays in/out; all
    relaxation arithmetic runs in one device dispatch)."""

    def __init__(self, A, indices, sweep='forward', iterations=1):
        import jax.numpy as jnp
        dirs = {'forward': (False,), 'backward': (True,),
                'symmetric': (False, True)}[sweep]
        packs = []
        for reverse in dirs:
            order, level = level_schedule(A, indices, reverse=reverse)
            packs.append(tuple(jnp.asarray(a)
                               for a in _pack_sweep(A, order, level)))
        self.passes = tuple(packs)
        self.iterations = iterations
        self._fn = _smooth_fn(iterations, len(self.passes))

    def apply(self, x, b):
        import jax.numpy as jnp
        out = self._fn(self.passes, jnp.asarray(x), jnp.asarray(b))
        x[:] = np.asarray(out)
        return x
