# -*- coding: utf-8 -*-
"""Nonlinear Poisson with an automatically differentiated Jacobian.

    -div((1 + u^2) grad u) = 1   in the quarter annulus,   u = 0 on bd.

The Newton residual is the assembled functional
``(1 + w*w) * inner(grad(w), grad(v)) * dx`` (w = current iterate), and
the Jacobian is **jax.jacfwd of the assembly itself**
(pyiga_jax.diff.assembly_input_fn) — no hand-derived linearized form.
The reference requires the user to derive and assemble the linearization
as a separate vform (its Cython kernels are opaque to autodiff); here
Newton converges quadratically on the exact discrete Jacobian for free.
"""

import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), '..'))


def main(p=2, n=8, tol=1e-12):
    import jax
    import jax.numpy as jnp

    from pyiga_jax import assemble, bspline, geometry, solvers
    from pyiga_jax.diff import assembly_input_fn
    from pyiga_jax.ops.fastdiag import interior_dofs

    kvs = 2 * (bspline.make_knots(p, 0.0, 1.0, n),)
    geo = geometry.quarter_annulus()
    N = int(np.prod([kv.numdofs for kv in kvs]))
    free = np.asarray(interior_dofs(kvs))

    # residual R(c) = A(c) c - f, assembled as one nonlinear functional
    w0 = geometry.BSplineFunc(kvs, np.zeros([kv.numdofs for kv in kvs]))
    asm = assemble.instantiate_assembler(
        '(1 + w*w) * inner(grad(w), grad(v)) * dx', kvs,
        {'geo': geo, 'w': w0}, None, None)
    resid_fn, c0 = assembly_input_fn(asm, 'w')
    f = np.asarray(assemble.inner_products(
        kvs, lambda *x: np.ones_like(x[0]), geo=geo)).reshape(-1)

    shape = c0.shape

    def F_free(xf):
        c = jnp.zeros(N).at[free].set(jnp.asarray(xf)).reshape(shape)
        return np.asarray(resid_fn(c)).reshape(-1)[free] - f[free]

    jac = jax.jit(jax.jacfwd(
        lambda c: resid_fn(c.reshape(shape)).reshape(-1)))

    def J_free(xf):
        c = jnp.zeros(N).at[free].set(jnp.asarray(xf))
        return np.asarray(jac(c))[np.ix_(free, free)]

    # quadratic convergence from the exact discrete Jacobian
    norms = []

    def F_logged(xf):
        r = F_free(xf)
        norms.append(float(np.linalg.norm(r)))
        return r

    u_free = solvers.newton(F_logged, J_free, np.zeros(len(free)),
                            atol=tol, rtol=0.0, maxiter=25)
    res_norm = float(np.linalg.norm(F_free(u_free)))
    print('newton residual norms:',
          ' '.join('%.2e' % r for r in norms + [res_norm]))
    assert res_norm < tol

    u = np.zeros(N)
    u[free] = u_free
    ufun = geometry.BSplineFunc(kvs, u.reshape(shape))
    umax = float(np.abs(ufun.grid_eval(2 * (np.linspace(0, 1, 30),))).max())
    print('max |u| = %.6f' % umax)
    assert 0.01 < umax < 1.0
    return norms, umax


if __name__ == '__main__':
    main()
