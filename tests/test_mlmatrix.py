import numpy as np
import scipy.sparse
from numpy.random import rand

from pyiga_jax.mlmatrix import (
    MLMatrix, MLStructure, compute_banded_sparsity_ij, compute_sparsity_ij,
    reorder, reindex_from_reordered, reindex_to_multilevel,
    reindex_from_multilevel, transpose_idx_for_bidx,
)
from pyiga_jax import bspline


def _random_banded(n, bw):
    return scipy.sparse.spdiags(rand(2 * bw + 1, n), np.arange(-bw, bw + 1), n, n)


def test_mlstructure():
    bs, bw = (5, 5), (2, 2)
    S = MLStructure.multi_banded(bs, bw)
    A = _random_banded(bs[0], bw[0]).tocsr()
    A2 = scipy.sparse.kron(A, A)
    assert np.array_equal(S.nonzero(), A2.nonzero())

    S = MLStructure.from_matrix(A)
    assert np.array_equal(S.nonzero(), A.nonzero())

    S = MLStructure.from_kronecker((A, A))
    assert np.array_equal(S.nonzero(), A2.nonzero())

    B = scipy.sparse.random(8, 20, density=0.1)
    S = MLStructure.from_matrix(B)
    assert np.array_equal(np.sort(S.transpose().nonzero()[0]),
                          np.sort(B.T.nonzero()[0]))

    C = scipy.sparse.random(17, 9, density=0.1)
    A2 = scipy.sparse.kron(B, C)
    S = MLStructure.from_kronecker((B, C))
    assert np.array_equal(S.nonzero(), A2.nonzero())


def test_sparsity_from_kvs():
    kv = bspline.make_knots(3, 0.0, 1.0, 8)
    S = MLStructure.from_kvs((kv,), (kv,))
    # pattern must match the actual mass matrix sparsity
    from pyiga_jax.assemble import bsp_mass_1d
    M = bsp_mass_1d(kv)
    I, J = S.nonzero()
    M2 = scipy.sparse.coo_matrix((np.ones(len(I)), (I, J)), shape=M.shape)
    assert (M2.toarray() != 0).sum() == M.nnz
    # repeated interior knots reduce overlap
    kvm = bspline.make_knots(2, 0.0, 1.0, 4, mult=2)
    S = MLStructure.from_kvs((kvm,), (kvm,))
    Mm = bsp_mass_1d(kvm)
    assert len(S.nonzero()[0]) == (Mm.toarray() != 0).sum()


def test_nonzeros_for_rows():
    A = np.array([[0, 2, 0], [3, 0, 1], [0, 7, 0]])
    B = np.array([[2, 9, 0, 0], [0, 2, 9, 0], [0, 0, 2, 9]])
    X = np.kron(A, B)
    S = MLStructure.from_kronecker((scipy.sparse.csr_matrix(A),
                                    scipy.sparse.csr_matrix(B)))
    I, J = S.nonzeros_for_rows([4, 5, 6, 7])
    IX, JX = X[4:8, :].nonzero()
    assert np.array_equal(I, IX + 4)
    assert np.array_equal(J, JX)

    I, J = S.nonzeros_for_columns([1, 2, 7])
    Xc = X.copy()
    for j in range(X.shape[1]):
        if j not in (1, 2, 7):
            Xc[:, j] = 0
    IX, JX = Xc.nonzero()
    assert np.array_equal(np.unique(np.column_stack((I, J)), axis=0),
                          np.unique(np.column_stack((IX, JX)), axis=0))


def test_mlbanded_2d():
    bs, bw = (9, 12), (2, 3)
    S = MLStructure.multi_banded(bs, bw)
    A, B = (_random_banded(n, p).toarray() for n, p in zip(bs, bw))
    vecA, vecB = (X.ravel()[np.flatnonzero(X.ravel())] for X in (A, B))
    M = MLMatrix(structure=S, data=np.outer(vecA, vecB))
    assert M.shape == (9 * 12, 9 * 12)
    assert M.nnz == vecA.size * vecB.size
    X = np.kron(A, B)
    assert np.allclose(X, M.asmatrix().toarray())
    Y = np.kron(B, A)
    assert np.allclose(Y, M.reorder((1, 0)).asmatrix().toarray())
    x = rand(M.shape[1])
    assert np.allclose(X.dot(x), M.dot(x))
    M2 = MLMatrix(structure=S, matrix=X)
    assert np.allclose(X, M2.asmatrix().toarray())


def test_mlbanded_3d():
    bs, bw = (8, 7, 6), (3, 2, 2)
    S = MLStructure.multi_banded(bs, bw)
    S12 = MLStructure.multi_banded(bs[:2], bw[:2]).join(
        MLStructure.multi_banded(bs[2:], bw[2:]))
    assert S.bs == S12.bs
    assert S.slice(0, 2).bs == S12.slice(0, 2).bs

    A, B, C = (_random_banded(n, p).toarray() for n, p in zip(bs, bw))
    vecA, vecB, vecC = (X.ravel()[np.flatnonzero(X.ravel())] for X in (A, B, C))
    M = MLMatrix(structure=S,
                 data=vecA[:, None, None] * vecB[None, :, None] * vecC[None, None, :])
    X = np.kron(np.kron(A, B), C)
    assert np.allclose(X, M.asmatrix().toarray())
    x = rand(M.shape[1])
    assert np.allclose(X.dot(x), M.dot(x))


def test_reorder():
    X = rand(6 * 5, 4 * 3)
    Y = reorder(X, 6, 4)
    assert Y.shape == (24, 15)
    # entry correspondence
    for i in (0, 5, 13, 23):
        for j in (0, 3, 7, 14):
            gi, gj = reindex_from_reordered(i, j, 6, 4, 5, 3)
            assert Y[i, j] == X[gi, gj]


def test_reindex_multilevel():
    bs = np.array([[5, 4], [3, 7]])
    for (i, j) in [(0, 0), (7, 11), (14, 27)]:
        M = reindex_to_multilevel(i, j, bs)
        assert reindex_from_multilevel(M, bs) == (i, j)


def test_transpose_idx():
    bidx = compute_banded_sparsity_ij(7, 2)
    tidx = transpose_idx_for_bidx(bidx)
    for s, (i, j) in enumerate(bidx):
        ti, tj = bidx[tidx[s]]
        assert (ti, tj) == (j, i)


def test_banded_vs_kv_sparsity():
    # for single interior knots, compute_sparsity_ij == banded pattern
    kv = bspline.make_knots(3, 0.0, 1.0, 10)
    assert np.array_equal(compute_sparsity_ij(kv, kv),
                          compute_banded_sparsity_ij(kv.numdofs, kv.p))
