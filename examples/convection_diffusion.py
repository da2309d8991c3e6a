# -*- coding: utf-8 -*-
"""Steady convection-diffusion on a quarter annulus, solved with the jitted
device GMRES (the reference falls back to scipy for nonsymmetric systems;
pyiga_jax runs the whole Krylov iteration as one dispatch per restart).

    -eps * div(grad(u)) + b . grad(u) = 1   in Omega,   u = 0 on bd(Omega)
"""

import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), '..'))

import jax.numpy as jnp

from pyiga_jax import assemble, bspline, geometry, solvers
from pyiga_jax.ops.fastdiag import fastdiag_precond, interior_dofs


def main(p=3, n=24, eps=0.05, b=(3.0, -1.0)):
    kvs = 2 * (bspline.make_knots(p, 0.0, 1.0, n),)
    geo = geometry.quarter_annulus()
    b = np.asarray(b, dtype=float)

    A = assemble.assemble(
        '(eps * inner(grad(u), grad(v)) + dot(b, grad(u)) * v) * dx',
        kvs, geo=geo, eps=eps, b=b)
    f = assemble.assemble('v * dx', kvs, geo=geo)

    # homogeneous Dirichlet: restrict to the interior dofs
    free = interior_dofs(kvs)
    Aff = A.tocsr()[free][:, free]
    ff = np.asarray(f).ravel()[free]

    Adj = jnp.asarray(Aff.toarray())
    matvec = lambda v: Adj @ v
    # fast diagonalization of the symmetric part as right preconditioner
    P = fastdiag_precond(kvs, dirichlet=True)

    x, it = solvers.gmres_jit(matvec, jnp.asarray(ff), tol=1e-10,
                              restart=30, precond=P)
    xu, itu = solvers.gmres_jit(matvec, jnp.asarray(ff), tol=1e-10,
                                restart=30)
    res = np.linalg.norm(Aff @ np.asarray(x) - ff) / np.linalg.norm(ff)
    print('dofs: %d   GMRES iters: %s (preconditioned) vs %s (plain)'
          % (len(free), it, itu))
    print('relative residual: %.2e' % res)
    assert res < 1e-9
    assert it < itu

    u = np.zeros(A.shape[0])
    u[free] = np.asarray(x)
    umax = u.max()
    print('max u = %.5f (boundary layer at the outflow side)' % umax)
    return u.reshape(tuple(kv.numdofs for kv in kvs))


if __name__ == '__main__':
    main()
