# integration test: full 2D Poisson Dirichlet solve (reference test_solve.py)
import numpy as np

from pyiga_jax import approx, assemble, bspline, geometry, solvers


def test_poisson_2d():
    kvs = 2 * (bspline.make_knots(3, 0.0, 1.0, 10),)
    geo = geometry.quarter_annulus()

    def g(x, y):    # exact solution / boundary data
        return np.cos(x + y) + np.exp(y - x)

    def f(x, y):    # right-hand side (-Laplace of g)
        return 2 * (np.cos(x + y) - np.exp(y - x))

    bcs = assemble.compute_dirichlet_bcs(kvs, geo, ('all', g))
    rhs = assemble.inner_products(kvs, f, f_physical=True, geo=geo).ravel()
    A = assemble.stiffness(kvs, geo=geo)
    LS = assemble.RestrictedLinearSystem(A, rhs, bcs)

    u_sol = solvers.make_solver(LS.A, spd=True).dot(LS.b)
    u = LS.complete(u_sol)
    u_ex = approx.project_L2(kvs, g, f_physical=True, geo=geo).ravel()

    rms_err = np.sqrt(np.mean((u - u_ex) ** 2))
    assert rms_err < 5e-5       # reference: about 4.83e-05
