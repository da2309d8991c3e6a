# Order-exact device Gauss-Seidel (ops/relax.py): the dependency-wavefront
# kernel must reproduce the strictly sequential host sweep.

import numpy as np
import scipy.sparse

from pyiga_jax import solvers
from pyiga_jax.ops.relax import DeviceIndexedGS, level_schedule


def _spd(n, rng, density=0.08):
    A = scipy.sparse.random(n, n, density=density, random_state=rng)
    return (A + A.T + 10 * scipy.sparse.eye(n)).tocsr()


def test_device_gs_matches_host():
    rng = np.random.RandomState(0)
    A = _spd(80, rng)
    b = rng.rand(80)
    for sweep in ('forward', 'backward', 'symmetric'):
        for subset in (rng.permutation(80)[:37], np.arange(80)):
            x0 = rng.rand(80)
            xh = x0.copy()
            solvers.gauss_seidel(A, xh, b, iterations=3, indices=subset,
                                 sweep=sweep)
            xd = x0.copy()
            DeviceIndexedGS(A, subset, sweep=sweep, iterations=3).apply(xd, b)
            assert np.abs(xh - xd).max() < 1e-13


def test_level_schedule_respects_dependencies():
    # every row must come strictly after each earlier-in-sweep row whose
    # value it reads (A[t, s] != 0)
    rng = np.random.RandomState(1)
    A = _spd(60, rng, density=0.12)
    subset = rng.permutation(60)[:40]
    for reverse in (False, True):
        order, level = level_schedule(A, subset, reverse=reverse)
        rank = {i: r for r, i in enumerate(order)}
        Ac = A.tocsr()
        for r, i in enumerate(order):
            for j in Ac.indices[Ac.indptr[i]:Ac.indptr[i + 1]]:
                if j in rank and rank[j] < r:
                    assert level[rank[j]] < level[r]


def test_empty_subset():
    rng = np.random.RandomState(2)
    A = _spd(20, rng)
    b = rng.rand(20)
    x = rng.rand(20)
    x0 = x.copy()
    DeviceIndexedGS(A, np.array([], dtype=np.int64)).apply(x, b)
    assert np.array_equal(x, x0)


def test_device_gs_nonsymmetric_structure():
    # anti-dependency (WAR) scheduling: a row whose value is READ by an
    # earlier sweep position must not be overwritten first — structurally
    # nonsymmetric matrices exposed this in the wavefront schedule
    import scipy.sparse
    from pyiga_jax.ops.relax import DeviceIndexedGS
    from pyiga_jax.solvers import gauss_seidel

    A = scipy.sparse.csr_matrix(np.array([[2., 0, 0], [1, 2, 1], [0, 0, 2]]))
    b = np.array([1., 1, 1])
    x_host = np.array([1., 1, 1])
    gauss_seidel(A, x_host, b, indices=np.array([0, 1, 2]))
    x_dev = np.array([1., 1, 1])
    DeviceIndexedGS(A, np.array([0, 1, 2])).apply(x_dev, b)
    assert np.allclose(x_host, x_dev)


def test_gs_zero_diagonal_skipped():
    # zero/missing diagonal rows are skipped on every backend (reference
    # relaxation_cy.pyx:62 semantics) instead of inf/assert
    import scipy.sparse
    from pyiga_jax.ops.relax import DeviceIndexedGS
    from pyiga_jax.solvers import gauss_seidel

    A = scipy.sparse.csr_matrix(np.array([[2., 1, 0], [0, 0., 1],
                                          [0, 1, 2.]]))
    b = np.array([1., 1, 1])
    x_host = np.array([1., 1, 1])
    gauss_seidel(A, x_host, b, indices=np.array([0, 1, 2]))
    assert np.isfinite(x_host).all() and x_host[1] == 1.0
    x_dev = np.array([1., 1, 1])
    DeviceIndexedGS(A, np.array([0, 1, 2])).apply(x_dev, b)
    assert np.allclose(x_host, x_dev)


def test_tri_inverse_zero_diagonal_skip():
    # the dense triangular-inverse GS form must reproduce the reference
    # skip semantics EXACTLY: dx_dead = 0 AND later rows must not absorb
    # a phantom update through the forward substitution (zeroing only
    # the output row of T left the phantom dx_dead = r_dead coupled into
    # rows after the dead index)
    import scipy.sparse
    from pyiga_jax.ops.mg import _tri_inverse
    from pyiga_jax.solvers import gauss_seidel

    A = np.array([[4., 1, .5], [2, 0., 1], [1, 3, 5.]])
    b = np.array([1., 2, 3])
    for reverse in (False, True):
        x_ref = np.array([.1, .2, .3])
        gauss_seidel(scipy.sparse.csr_matrix(A), x_ref, b,
                     indices=np.array([0, 1, 2]),
                     sweep='backward' if reverse else 'forward')
        x = np.array([.1, .2, .3])
        T = _tri_inverse(A, reverse=reverse)
        x = x + T @ (b - A @ x)
        assert np.allclose(x, x_ref), (reverse, x, x_ref)
