# -*- coding: utf-8 -*-
"""Discrete shape derivatives through assembly AND solve — a capability
the reference's compiled Cython assembly kernels cannot offer.

The compliance J(c) = f^T u(c) of a Poisson problem, where A(c) u = f
and c are the geometry control points, is differentiated end to end
with ``jax.grad``: pyiga_jax's assembly is one traced JAX program
(pyiga_jax.diff.assembly_coeff_fn), and the linear solve contributes its
adjoint automatically.  A few steps of gradient descent on the control
points then *stiffen* the domain (compliance decreases monotonically) —
the core loop of IGA shape optimization.
"""

import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), '..'))


def main(p=2, n=8, steps=3, lr=2e-3):
    import jax
    import jax.numpy as jnp

    from pyiga_jax import assemble, bspline, geometry
    from pyiga_jax.assemblers import StiffnessAssembler
    from pyiga_jax.diff import assembly_coeff_fn
    from pyiga_jax.ops.fastdiag import interior_dofs

    from pyiga_jax import approx

    kvs = 2 * (bspline.make_knots(p, 0.0, 1.0, n),)
    # refine the coarse quarter-annulus control net into the discretization
    # space (exact for p >= 2) so there are interior control points to move
    coarse = geometry.bspline_quarter_annulus()
    geo = geometry.BSplineFunc(kvs, np.asarray(approx.interpolate(kvs,
                                                                  coarse)))
    asm = StiffnessAssembler(kvs, geo)
    fn, coeffs0 = assembly_coeff_fn(asm)

    # fixed unit load; homogeneous Dirichlet boundary
    free = np.asarray(interior_dofs(kvs))
    N = int(np.prod([kv.numdofs for kv in kvs]))
    I, J = asm.structure.nonzero()      # C order of the compact data tensor
    f = np.asarray(assemble.inner_products(
        kvs, lambda *x: np.ones_like(x[0]), geo=geo)).reshape(-1)[free]

    # boundary control points stay fixed: optimize interior ones only
    bmask = np.zeros(coeffs0.shape, dtype=bool)
    bmask[0, :] = bmask[-1, :] = bmask[:, 0] = bmask[:, -1] = True
    interior = jnp.asarray(~bmask)

    def compliance(coeffs):
        data = fn(coeffs)
        A = jnp.zeros((N, N), dtype=data.dtype).at[I, J].set(data.reshape(-1))
        Aff = A[np.ix_(free, free)]
        u = jnp.linalg.solve(Aff, jnp.asarray(f))
        return jnp.dot(jnp.asarray(f), u)

    val_and_grad = jax.jit(jax.value_and_grad(compliance))

    c = jnp.asarray(coeffs0, dtype=jnp.float64)
    history = []
    for k in range(steps + 1):
        Jc, g = val_and_grad(c)
        history.append(float(Jc))
        gnorm = float(jnp.linalg.norm(jnp.where(interior, g, 0.0)))
        print('step %d: compliance %.6f   |dJ/dc|_interior %.4f'
              % (k, float(Jc), gnorm))
        if k < steps:
            c = c - lr * jnp.where(interior, g, 0.0)

    assert all(b < a for a, b in zip(history, history[1:])), \
        'gradient descent should reduce compliance monotonically'
    return history


if __name__ == '__main__':
    main()
