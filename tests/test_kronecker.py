import numpy as np
import scipy.sparse
from numpy.random import rand

from pyiga_jax.kronecker import apply_kronecker
from pyiga_jax.tensor import apply_tprod


def _check(ops, full, n_in):
    x = rand(n_in)
    assert abs(full.dot(x) - apply_kronecker(ops, x)).max() < 1e-10
    x = rand(n_in, 1)
    assert np.allclose(full.dot(x), apply_kronecker(ops, x))
    x = rand(n_in, 7)
    assert np.allclose(full.dot(x), apply_kronecker(ops, x))


def test_kronecker_2d_dense():
    X, Y = rand(8, 8), rand(8, 8)
    _check((X, Y), np.kron(X, Y), 64)
    x = rand(64)
    assert np.allclose(np.kron(X, Y).dot(x),
                       apply_tprod((X, Y), x.reshape(8, 8)).ravel())


def test_kronecker_2d_sparse():
    n = 50
    mk = lambda: scipy.sparse.diags([rand(n - 1), rand(n), rand(n - 1)],
                                    offsets=(-1, 0, 1))
    X, Y = mk(), mk()
    _check((X, Y), scipy.sparse.kron(X, Y), n * n)


def test_kronecker_3d_dense():
    X, Y, Z = rand(6, 6), rand(6, 6), rand(6, 6)
    _check((X, Y, Z), np.kron(np.kron(X, Y), Z), 6 ** 3)


def test_kronecker_3d_sparse():
    n = 15
    mk = lambda: scipy.sparse.diags([rand(n - 1), rand(n), rand(n - 1)],
                                    offsets=(-1, 0, 1))
    X, Y, Z = mk(), mk(), mk()
    _check((X, Y, Z), scipy.sparse.kron(scipy.sparse.kron(X, Y), Z), n ** 3)


def test_kronecker_rectangular():
    X, Y = rand(5, 8), rand(7, 4)
    full = np.kron(X, Y)
    x = rand(32)
    assert np.allclose(full.dot(x), apply_kronecker((X, Y), x))
