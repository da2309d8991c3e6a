import numpy as np
import scipy.sparse
from numpy.random import rand

from pyiga_jax.operators import (
    BlockDiagonalOperator, BlockOperator, DiagonalOperator, IdentityOperator,
    KroneckerOperator, NullOperator, SubspaceOperator, make_kronecker_solver,
    make_solver,
)


def test_basic_operators():
    x = rand(7)
    assert np.allclose(NullOperator((5, 7)).dot(x), np.zeros(5))
    assert np.allclose(IdentityOperator(7).dot(x), x)
    d = rand(7)
    assert np.allclose(DiagonalOperator(d).dot(x), d * x)
    assert np.allclose(DiagonalOperator(d).T.dot(x), d * x)


def test_kronecker_operator():
    A, B = rand(4, 5), rand(6, 3)
    K = KroneckerOperator(A, B)
    x = rand(15)
    assert np.allclose(K.dot(x), np.kron(A, B) @ x)
    y = rand(24)
    assert np.allclose(K.T.dot(y), np.kron(A, B).T @ y)


def test_block_operators():
    A, B = rand(3, 3), rand(4, 4)
    D = BlockDiagonalOperator(A, B)
    x = rand(7)
    ref = np.block([[A, np.zeros((3, 4))], [np.zeros((4, 3)), B]])
    assert np.allclose(D.dot(x), ref @ x)

    C = rand(3, 4)
    Bl = BlockOperator([[A, C], [NullOperator((4, 3)), B]])
    ref = np.block([[A, C], [np.zeros((4, 3)), B]])
    assert np.allclose(Bl.dot(x), ref @ x)
    assert np.allclose(Bl.T.dot(x), ref.T @ x)


def test_subspace_operator():
    n = 10
    P1 = scipy.sparse.random(n, 4, density=0.5, format='csr')
    P2 = scipy.sparse.random(n, 6, density=0.5, format='csr')
    B1, B2 = rand(4, 4), rand(6, 6)
    S = SubspaceOperator((P1, P2), (B1, B2))
    x = rand(n)
    ref = (P1 @ B1 @ P1.T.dot(x)) + (P2 @ B2 @ P2.T.dot(x))
    assert np.allclose(S.dot(x), ref)
    refT = (P1 @ B1.T @ P1.T.dot(x)) + (P2 @ B2.T @ P2.T.dot(x))
    assert np.allclose(S.T.dot(x), refT)


def test_make_solver():
    A = rand(8, 8) + 8 * np.eye(8)
    b = rand(8)
    assert np.allclose(A @ make_solver(A).dot(b), b)
    S = A @ A.T
    assert np.allclose(S @ make_solver(S, spd=True).dot(b), b)
    Asp = scipy.sparse.csr_matrix(A)
    assert np.allclose(A @ make_solver(Asp).dot(b), b)


def test_make_kronecker_solver():
    A = rand(4, 4) + 4 * np.eye(4)
    B = rand(5, 5) + 5 * np.eye(5)
    x = rand(20)
    Kinv = make_kronecker_solver(A, B)
    assert np.allclose(np.kron(A, B) @ Kinv.dot(x), x)
