# -*- coding: utf-8 -*-
"""3D Poisson on the twisted box — the benchmark workload, on the production
solve path:

* sum-factorization assembly of the compact stiffness tensor (symmetric
  chains folded, native float64 matmuls),
* homogeneous Dirichlet conditions via the box-restriction fast path,
* matrix-free preconditioned CG: float32 Krylov iterations with the
  geometry-weighted fast-diagonalization preconditioner (Sangalli-Tani
  with per-axis averaged coefficients), refined to full float64 accuracy
  by the device-fused iterative refinement (cg_ir).
"""

import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), '..'))

import jax.numpy as jnp

from pyiga_jax import bspline, geometry, solvers
from pyiga_jax.assemblers import StiffnessAssembler
from pyiga_jax.ops.fastdiag import (fastdiag_precond_weighted,
                                    interior_dofs)
from pyiga_jax.ops.matfree import MatrixFreeOperator


def main(n=16, p=3):
    kvs = 3 * (bspline.make_knots(p, 0.0, 1.0, n),)
    geo = geometry.twisted_box()
    ndofs = int(np.prod([kv.numdofs for kv in kvs]))
    print('dofs:', ndofs)

    asm = StiffnessAssembler(kvs, geo)
    t0 = time.perf_counter()
    K = asm.assemble()                  # compact MLMatrix (float64)
    print('assembly: %.3fs' % (time.perf_counter() - t0))

    # Dirichlet Poisson on the interior dofs, matrix-free
    free = interior_dofs(kvs)
    op64 = MatrixFreeOperator(asm, free_dofs=free, dtype=np.float64)
    op32 = MatrixFreeOperator(asm, free_dofs=free, dtype=np.float32)
    P32 = fastdiag_precond_weighted(asm, dirichlet=True,
                                    dtype=np.float32)

    b = np.ones(len(free))
    t0 = time.perf_counter()
    u, info = solvers.cg_ir(op64, op32, jnp.asarray(b), tol=1e-10,
                            precond_lo=P32)
    u = np.asarray(u)
    print('cg_ir: %d outer / %s inner iterations, %.3fs'
          % (info['outer'], info['inner_iters'], time.perf_counter() - t0))

    Kff = K.asmatrix().tocsr()[free][:, free]
    res = np.linalg.norm(Kff @ u - b) / np.linalg.norm(b)
    print('true residual: %.2e' % res)
    assert res < 1e-9
    return u


if __name__ == '__main__':
    main()
