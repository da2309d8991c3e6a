import numpy as np
import scipy.sparse
from numpy.random import rand

from pyiga_jax import utils


def test_grid_eval():
    f = lambda x, y: x * 2 + y
    grid = (np.linspace(0, 1, 4), np.linspace(0, 1, 5))   # (y, x)
    vals = utils.grid_eval(f, grid)
    assert vals.shape == (4, 5)
    # grid axes are ZYX: f receives x = grid[1], y = grid[0]
    assert np.allclose(vals, 2 * grid[1][None, :] + grid[0][:, None])

    # tuple-valued function stacks components on the last axis
    g = lambda x, y: (x, 0 * x + 3.0)
    vals = utils.grid_eval(g, grid)
    assert vals.shape == (4, 5, 2)
    assert np.allclose(vals[..., 1], 3.0)


def test_multi_kron_sparse():
    A = scipy.sparse.random(4, 5, density=0.5)
    B = scipy.sparse.random(3, 6, density=0.5)
    C = scipy.sparse.random(2, 2, density=0.8)
    K = utils.multi_kron_sparse([A, B, C])
    ref = scipy.sparse.kron(A, scipy.sparse.kron(B, C))
    assert abs(K - ref).max() == 0


def test_kron_partial():
    A = scipy.sparse.random(5, 5, density=0.4, format='csr')
    B = scipy.sparse.random(4, 4, density=0.4, format='csr')
    full = scipy.sparse.kron(A, B).toarray()
    rows = np.array([0, 3, 7, 11, 19])
    P = utils.kron_partial((A, B), rows)
    assert P.shape == full.shape
    assert np.allclose(P.toarray()[rows], full[rows])
    other = np.setdiff1d(np.arange(20), rows)
    assert np.allclose(P.toarray()[other], 0)
    # restricted variant
    Pr = utils.kron_partial((A, B), rows, restrict=True)
    assert Pr.shape == (len(rows), 20)
    assert np.allclose(Pr.toarray(), full[rows])


def test_cartesian_product():
    a, b = np.array([1, 2, 3]), np.array([4, 5])
    cp = utils.cartesian_product([a, b])
    assert cp.shape == (6, 2)
    assert list(map(tuple, cp)) == [(1, 4), (1, 5), (2, 4), (2, 5),
                                    (3, 4), (3, 5)]


def test_csr_row_helpers():
    A = scipy.sparse.random(10, 8, density=0.4, format='csr')
    x = rand(8)
    sl = utils.CSRRowSlice(A, (2, 6))
    assert np.allclose(sl.dot(x), A.toarray()[2:6] @ x)
    rows = [1, 4, 7]
    sub = utils.CSRRowSubset(A, rows)
    assert np.allclose(sub.dot(x), A.toarray()[rows] @ x)


def test_bijective_index():
    vals = [(0, 1), (2, 3), (4, 5)]
    bi = utils.BijectiveIndex(vals)
    assert len(bi) == 3
    assert bi[1] == (2, 3)
    assert bi.index((4, 5)) == 2


def test_read_sparse_matrix(tmp_path):
    p = tmp_path / 'm.mtx'
    p.write_text('3 3 2\n1 1 2.5\n3 2 -1.0\n')
    A = utils.read_sparse_matrix(str(p))
    assert A[0, 0] == 2.5 and A[2, 1] == -1.0
