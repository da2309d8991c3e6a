# -*- coding: utf-8 -*-
"""Robust multigrid based on stable splittings of spline spaces.

Reproduces the workload of the reference's subspace-correction-mg notebook
(Hofreither & Takacs, "Robust Multigrid for Isogeometric Analysis Based on
Stable Splittings of Spline Spaces", doi:10.1137/16m1085425): a two-grid
method whose smoother is an additive subspace correction built from the
S-tilde subspace (splines with vanishing odd derivatives at the boundary,
:mod:`pyiga_jax.stilde`) and its mass-orthogonal complement.  The resulting
iteration counts stay bounded as the spline degree grows — a plain
Gauss-Seidel two-grid degrades rapidly with p.
"""

import os
import sys

import numpy as np
import scipy.linalg
import scipy.sparse
from scipy.sparse import kron as spkron

sys.path.insert(0, os.path.join(os.path.dirname(__file__), '..'))

from pyiga_jax import assemble, bspline
from pyiga_jax.operators import SubspaceOperator, make_solver
from pyiga_jax.solvers import (GaussSeidelSmoother, OperatorSmoother,
                               SequentialSmoother, twogrid)
from pyiga_jax.stilde import Stilde_basis


def stilde_splitting(kv, M):
    """S-tilde prolongator and the M-orthogonal basis of its complement."""
    P_tilde, P_compl = Stilde_basis(kv)
    P_orth = np.linalg.solve(M.toarray(), P_compl)      # M^-1 C
    return P_tilde, P_orth


def robust_smoother_1d(kv, M, K, sigma):
    """Additive subspace-correction smoother for ``sigma*M + K`` in 1D:
    a scaled mass solve on S-tilde, an exact solve on the complement."""
    P_tilde, P_orth = stilde_splitting(kv, M)
    A = sigma * M + K
    M_tilde = P_tilde.T @ (M @ P_tilde)
    A_orth = P_orth.T @ (A @ P_orth)
    return OperatorSmoother(SubspaceOperator(
        [P_tilde, P_orth],
        [make_solver((1.0 + sigma) * M_tilde), make_solver(A_orth)]))


def robust_smoother_nd(A, kv, M, K, sigma, dim, dirichlet=False):
    """The 2^dim-subspace tensor-product smoother.  Per subspace (one axis
    choice of S-tilde vs complement): pure S-tilde gets the scaled Kronecker
    mass smoother ``(1 + dim*sigma) M_tilde^(x)d``; mixed subspaces get
    Kronecker products of the unscaled 1D S-tilde mass with the complement
    restriction of the 1D reaction-diffusion matrix
    ``(1 + (dim-1) sigma) M + K``; the all-complement subspace (tiny) gets
    its exact Galerkin restriction of `A`."""
    P_tilde, P_orth = stilde_splitting(kv, M)
    B1 = (1.0 + (dim - 1) * sigma) * M.toarray() + K.toarray()
    M_tilde = P_tilde.T @ (M @ P_tilde)
    B_orth = P_orth.T @ (B1 @ P_orth)
    sl = slice(1, -1) if dirichlet else slice(None)

    subspaces, solvers_ = [], []
    for mask in range(2 ** dim):
        bits = [bool(mask & (1 << k)) for k in range(dim)]
        P_axes = [(P_orth if b else P_tilde)[sl] for b in bits]
        P_sub = P_axes[0]
        for Pk in P_axes[1:]:
            P_sub = spkron(scipy.sparse.csr_matrix(P_sub), Pk).tocsr()
        subspaces.append(P_sub)
        if not any(bits):
            # pure S-tilde: scaled Kronecker mass smoother
            B_sub = (1.0 + dim * sigma) * M_tilde
            for _ in range(dim - 1):
                B_sub = np.kron(B_sub, M_tilde)
        elif all(bits):
            # all-complement: exact Galerkin restriction (small block)
            B_sub = np.asarray(P_sub.T @ (A @ P_sub).todense()
                               if scipy.sparse.issparse(A)
                               else P_sub.T @ (A @ P_sub))
        else:
            blocks = [B_orth if b else M_tilde for b in bits]
            B_sub = blocks[0]
            for Bk in blocks[1:]:
                B_sub = np.kron(B_sub, Bk)
        solvers_.append(make_solver(B_sub))
    return OperatorSmoother(SubspaceOperator(subspaces, solvers_))


def run_1d(p=7, nspans_c=50):
    kv_c = bspline.make_knots(p, 0.0, 1.0, nspans_c)
    kv = kv_c.refine()
    h = 1.0 / kv.numspans
    M, K = assemble.mass(kv), assemble.stiffness(kv)
    A = M + K
    P = bspline.prolongation(kv_c, kv)
    print('1D p=%d: %d dofs' % (p, A.shape[0]))

    sigma = h ** -2 / 0.09
    smoother = robust_smoother_1d(kv, M, K, sigma=sigma)
    rhs = A @ np.random.rand(A.shape[1])
    twogrid(A, rhs, P, smoother)

    # Dirichlet variant: restrict the subspace prolongators to free dofs
    P_tilde, P_orth = stilde_splitting(kv, M)
    K_dir = K[1:-1, 1:-1]
    M_tilde = P_tilde.T @ (M @ P_tilde)
    A_orth = P_orth.T @ ((sigma * M + K) @ P_orth)
    smoother = OperatorSmoother(SubspaceOperator(
        [P_tilde[1:-1], P_orth[1:-1]],
        [make_solver((1.0 + sigma) * M_tilde), make_solver(A_orth)]))
    rhs = K_dir @ np.random.rand(K_dir.shape[1])
    twogrid(K_dir, rhs, P[1:-1], smoother)


def run_2d(p=4, nspans_c=12):
    kv_c = bspline.make_knots(p, 0.0, 1.0, nspans_c)
    kv = kv_c.refine()
    h = 1.0 / kv.numspans
    M, K = assemble.mass(kv), assemble.stiffness(kv)
    M2 = spkron(M, M).tocsr()
    K2 = (spkron(K, M) + spkron(M, K)).tocsr()
    A2 = M2 + K2
    P = bspline.prolongation(kv_c, kv)
    P2 = spkron(P, P).tocsr()
    print('2D p=%d: %d dofs' % (p, A2.shape[0]))

    sigma = h ** -2 / 0.16
    subsp = robust_smoother_nd(A2, kv, M, K, sigma, dim=2)
    # compose with one Gauss-Seidel sweep (the notebook's smoother3)
    smoother = SequentialSmoother((subsp, GaussSeidelSmoother()))
    rhs = A2 @ np.random.rand(A2.shape[1])
    twogrid(A2, rhs, P2, smoother)

    # homogeneous Dirichlet on the pure stiffness matrix
    sl = slice(1, -1)
    K2_D = (spkron(K[sl, sl], M[sl, sl]) + spkron(M[sl, sl], K[sl, sl])).tocsr()
    smoother = robust_smoother_nd(K2_D, kv, M, K, sigma, dim=2,
                                  dirichlet=True)
    rhs = K2_D @ np.random.rand(K2_D.shape[1])
    twogrid(K2_D, rhs, spkron(P[sl], P[sl]).tocsr(), smoother)


def main(p1=7, n1=50, p2=4, n2=12):
    np.random.seed(0)
    run_1d(p=p1, nspans_c=n1)
    run_2d(p=p2, nspans_c=n2)


if __name__ == '__main__':
    main()
