import numpy as np
import scipy.sparse
from numpy.random import rand

from pyiga_jax.tensor import (
    CanonicalOperator, CanonicalTensor, TensorProd, TensorSum, TuckerTensor,
    als, als1, als1_ls, apply_tprod, array_outer, asarray, find_truncation_rank,
    fro_norm, grou, gta, gta_ls, hosvd, matricize, modek_tprod, outer, pad,
)


def _random_lowrank(shape, R):
    return CanonicalTensor.from_terms(
        [tuple(rand(n) for n in shape) for _ in range(R)])


def test_modek_and_apply_tprod():
    X = rand(4, 5, 6)
    A, B, C = rand(7, 4), rand(8, 5), rand(9, 6)
    Y = apply_tprod((A, B, C), X)
    assert Y.shape == (7, 8, 9)
    full = np.kron(np.kron(A, B), C).dot(X.ravel())
    assert np.allclose(Y.ravel(), full)
    # None = identity, trailing axes untouched
    Y2 = apply_tprod((A, None), rand(4, 5, 3))
    assert Y2.shape == (7, 5, 3)
    # sparse op
    S = scipy.sparse.csr_matrix(A)
    assert np.allclose(modek_tprod(S, 0, X), modek_tprod(A, 0, X))


def test_matricize():
    X = rand(3, 4, 5)
    M1 = matricize(X, 1)
    assert M1.shape == (4, 15)
    assert np.allclose(M1[2, :], np.moveaxis(X, 1, 0)[2].ravel())


def test_hosvd_roundtrip():
    X = rand(5, 6, 7)
    T = hosvd(X)
    assert np.allclose(T.asarray(), X)


def test_truncation():
    T = _random_lowrank((10, 11, 12), 3)
    X = T.asarray()
    H = hosvd(X)
    shp = find_truncation_rank(H.X, tol=1e-10)
    assert all(r <= 4 for r in shp)
    assert np.allclose(H.truncate(shp).asarray(), X, atol=1e-8)


def test_tucker_compress():
    T = _random_lowrank((8, 9, 10), 2)
    TT = TuckerTensor.from_tensor(T).compress(tol=1e-12)
    assert all(r <= 3 for r in TT.R)
    assert np.allclose(TT.asarray(), T.asarray(), atol=1e-8)


def test_canonical_algebra():
    A = _random_lowrank((5, 6), 2)
    B = _random_lowrank((5, 6), 3)
    assert (A + B).R == 5
    assert np.allclose((A + B).asarray(), A.asarray() + B.asarray())
    assert np.allclose((A - B).asarray(), A.asarray() - B.asarray())
    assert abs(A.norm() - np.linalg.norm(A.asarray())) < 1e-10
    # nway_prod
    ops = (rand(4, 5), rand(7, 6))
    assert np.allclose(apply_tprod(ops, A).asarray(),
                       apply_tprod(ops, A.asarray()))
    # getitem / squeeze
    assert np.allclose(asarray(A[1:3, :]), A.asarray()[1:3, :])
    assert np.allclose(A[2, 3], A.asarray()[2, 3])


def test_tucker_algebra():
    A = TuckerTensor.from_tensor(_random_lowrank((5, 6), 2))
    B = TuckerTensor.from_tensor(_random_lowrank((5, 6), 1))
    assert np.allclose((A + B).asarray(), A.asarray() + B.asarray())
    assert np.allclose((-A).asarray(), -A.asarray())
    assert abs(A.norm() - np.linalg.norm(A.asarray())) < 1e-10
    assert np.allclose(asarray(A[0, :]), A.asarray()[0, :])


def test_tensor_sum_prod():
    X, Y = rand(4, 5), rand(4, 5)
    S = TensorSum(X, Y)
    assert np.allclose(S.asarray(), X + Y)
    P = TensorProd(rand(3), rand(4))
    assert P.shape == (3, 4)
    assert np.allclose(P.asarray(), np.outer(P.Xs[0], P.Xs[1]))
    assert np.allclose(asarray(P[1, 2]), P.asarray()[1, 2])


def test_outer_pad():
    x, y, z = rand(3), rand(4), rand(5)
    assert np.allclose(outer(x, y, z), np.einsum('i,j,k->ijk', x, y, z))
    X = rand(3, 4)
    assert array_outer(X, rand(2)).shape == (3, 4, 2)
    Xp = pad(X, [(1, 2), None])
    assert Xp.shape == (6, 4)
    assert np.allclose(Xp[1:4], X)


def test_als1():
    T = outer(rand(6), rand(7), rand(8))
    xs = als1(T)
    assert np.allclose(outer(*xs), T, atol=1e-8)


def test_als():
    T = _random_lowrank((6, 7, 8), 2).asarray()
    X = als(T, 2, tol=1e-12)
    assert fro_norm(X.asarray() - T) < 1e-6 * fro_norm(T)


def test_grou():
    T = _random_lowrank((6, 7), 3).asarray()
    X, errors = grou(T, 10, tol=1e-10, return_errors=True)
    assert errors[-1] < 1e-9 * fro_norm(T) or X.R <= 10


def test_gta():
    T = _random_lowrank((6, 7, 8), 2).asarray()
    X = gta(T, 6, tol=1e-10)
    assert fro_norm(X.asarray() - T) < 1e-6 * fro_norm(T)


def _kron_operator_1():
    # simple SPD Kronecker-rank-2 operator: K (x) M + M (x) K
    n = 8
    from pyiga_jax import assemble, bspline
    kv = bspline.make_knots(2, 0.0, 1.0, n)
    K = assemble.stiffness(kv) + assemble.mass(kv)   # SPD
    M = assemble.mass(kv)
    return [(K.tocsr(), M.tocsr()), (M.tocsr(), K.tocsr())]


def test_ls():
    # 3D Laplace Kronecker system with rhs = ones (reference test_tensor:304)
    from pyiga_jax import assemble, bspline
    kv = bspline.make_knots(3, 0.0, 1.0, 10)
    K = assemble.stiffness(kv)[1:-1, 1:-1].tocsr()
    M = assemble.mass(kv)[1:-1, 1:-1].tocsr()
    A = [(K, M, M), (M, K, M), (M, M, K)]
    n = K.shape[0]
    F = CanonicalTensor.ones((n, n, n))

    X = CanonicalTensor(als1_ls(A, F))
    Y = CanonicalTensor(als1_ls(A, F, spd=True))
    assert X.shape == F.shape and Y.shape == F.shape
    assert fro_norm(X - Y) < 0.1 * fro_norm(X)

    T1 = gta_ls(A, F, 5)
    T2 = gta_ls(A, F, 5, spd=True)
    assert T1.shape == F.shape and T2.shape == F.shape
    assert fro_norm(T1 - T2) < 0.01 * fro_norm(T1)
    A_op = CanonicalOperator(A)
    assert fro_norm(A_op.apply(T2) - F) < 0.01 * fro_norm(F)


def test_canonical_operator():
    terms = _kron_operator_1()
    Op = CanonicalOperator(terms)
    assert Op.R == 2
    full = Op.asmatrix().toarray()
    ref = sum(np.kron(t[0].toarray(), t[1].toarray()) for t in terms)
    assert np.allclose(full, ref)
    X = rand(*Op.shape[1])
    assert np.allclose(Op.apply(X).ravel(), ref.dot(X.ravel()))
    assert np.allclose((Op + Op).asmatrix().toarray(), 2 * ref)
    assert np.allclose((-Op).asmatrix().toarray(), -ref)
    assert np.allclose(Op.T.asmatrix().toarray(), ref.T)
    assert np.allclose((Op * Op).asmatrix().toarray(), ref @ ref)
    E = CanonicalOperator.eye((3, 4))
    assert np.allclose(E.asmatrix().toarray(), np.eye(12))


def test_pad_structured():
    # reference test/test_tensor.py:149 — pad acts on Tucker (and
    # canonical) tensors through per-axis embedding operators.
    rng = np.random.default_rng(3)
    X = TuckerTensor(tuple(rng.random((n, 2)) for n in (3, 4, 5)),
                     rng.random((2, 2, 2)))
    Y = pad(X, [(2, 2), None, (0, 1)])
    assert Y.shape == (7, 4, 6)
    YA = asarray(Y)
    assert np.allclose(YA[2:-2, :, :-1], asarray(X))
    assert np.linalg.norm(YA[:2].ravel()) < 1e-10
    assert np.linalg.norm(YA[-2:].ravel()) < 1e-10
    assert np.linalg.norm(YA[:, :, -1:].ravel()) < 1e-10
    C = CanonicalTensor(tuple(rng.random((n, 2)) for n in (3, 4)))
    Z = pad(C, [None, (1, 0)])
    ZA = asarray(Z)
    assert np.allclose(ZA[:, 1:], asarray(C))
    assert np.linalg.norm(ZA[:, 0]) < 1e-10


def test_als_structured_input():
    # reference test/test_tensor.py:287 — als accepts canonical and
    # Tucker tensors, not just dense arrays.
    rng = np.random.default_rng(5)
    A = CanonicalTensor(tuple(rng.random((n, 2)) for n in (3, 4, 5)))
    B = als(A, R=2, maxiter=200)
    assert np.allclose(asarray(A), asarray(B), atol=1e-6)
    X = np.zeros((2, 2, 2)); X[0, 0, 0] = X[1, 1, 1] = 1.0
    T = TuckerTensor(tuple(rng.random((n, 2)) for n in (3, 4, 5)), X)
    B2 = als(T, R=2, maxiter=500)
    assert np.allclose(asarray(T), asarray(B2), atol=1e-6)


def test_gta_ls_gauss_seidel_branch():
    # the gs branch (projected core > 500 unknowns) runs in-place GS
    # sweeps; it previously rebound the in-place result (None) and crashed
    n = 12
    K = (np.diag(np.full(n, 2.0)) + np.diag(np.full(n - 1, -1.0), 1)
         + np.diag(np.full(n - 1, -1.0), -1))
    M = np.eye(n)
    A = [(K, M, M), (M, K, M), (M, M, K)]
    F = np.random.default_rng(0).random((n, n, n))
    X = gta_ls(A, F, R=9, gs=2, spd=True)     # core 9^3 = 729 > 500
    res = fro_norm(sum(apply_tprod(list(Aj), asarray(X)) for Aj in A) - F)
    X1 = gta_ls(A, F, R=1, spd=True)
    res1 = fro_norm(sum(apply_tprod(list(Aj), asarray(X1)) for Aj in A) - F)
    assert np.isfinite(res) and res < res1
