from functools import reduce

import numpy as np
import scipy.sparse

from pyiga_jax import assemble, bspline
from pyiga_jax.solvers import (
    GaussSeidelSmoother, OperatorSmoother, SequentialSmoother, cg_jit,
    crank_nicolson, esdirk34, fastdiag_solver, gauss_seidel, newton, ros3p,
    rodasp, sdirk3, twogrid,
)


def test_fastdiag_solver():
    kvs = [bspline.make_knots(4, 0.0, 1.0, 3),
           bspline.make_knots(3, 0.0, 1.0, 4),
           bspline.make_knots(2, 0.0, 1.0, 5)]
    KM = [(assemble.stiffness(kv)[1:-1, 1:-1].toarray(),
           assemble.mass(kv)[1:-1, 1:-1].toarray()) for kv in kvs]
    solver = fastdiag_solver(KM)

    def multikron(*Xs):
        return reduce(np.kron, Xs)
    A = (multikron(KM[0][0], KM[1][1], KM[2][1])
         + multikron(KM[0][1], KM[1][0], KM[2][1])
         + multikron(KM[0][1], KM[1][1], KM[2][0]))
    f = np.random.rand(A.shape[0])
    assert np.allclose(f, solver.dot(A.dot(f)))


def test_gauss_seidel():
    A = np.abs(np.random.rand(10, 10)) + np.eye(10)
    b = np.random.rand(10)
    for sweep in ('forward', 'backward', 'symmetric'):
        x1 = np.random.rand(10)
        x2 = x1.copy()
        gauss_seidel(scipy.sparse.csr_matrix(A), x1, b, iterations=2, sweep=sweep)
        gauss_seidel(A, x2, b, iterations=2, sweep=sweep)
        assert abs(x1 - x2).max() < 1e-12


def test_gauss_seidel_indexed():
    A = np.abs(np.random.rand(10, 10)) + np.eye(10)
    b = np.random.rand(10)
    indices = [3, 6, 9]
    for sweep in ('forward', 'backward', 'symmetric'):
        x1 = np.random.rand(10)
        x2 = x1.copy()
        gauss_seidel(scipy.sparse.csr_matrix(A), x1, b, iterations=2,
                     indices=indices, sweep=sweep)
        gauss_seidel(A, x2, b, iterations=2, indices=indices, sweep=sweep)
        assert abs(x1 - x2).max() < 1e-12


def test_twogrid():
    kv_c = bspline.make_knots(3, 0.0, 1.0, 50)
    kv = kv_c.refine()
    P = bspline.prolongation(kv_c, kv)
    A = assemble.mass(kv) + assemble.stiffness(kv)
    f = bspline.load_vector(kv, lambda x: 1.0)
    S = SequentialSmoother((GaussSeidelSmoother(),
                            OperatorSmoother(1e-6 * np.eye(len(f)))))
    x = twogrid(A, f, P, S)
    assert np.linalg.norm(f - A.dot(x)) < 1e-6


def test_newton():
    x = newton(lambda x: np.array([np.sin(x[0]) - 0.5]),
               lambda x: np.array([[np.cos(x[0])]]), [0.0])
    assert np.allclose(x, np.pi / 6)


def test_ode():
    A = np.array([[0.0, 1.0], [-1000.0, -1001.0]])
    M = np.eye(2)
    F = lambda x: A.dot(x)
    J = lambda x: A
    x0 = np.array([1.0, 0.0])
    exsol = lambda t: -1 / 999 * np.exp(-1000 * t) + 1000 / 999 * np.exp(-t)
    t_end = 1.0
    sol_1 = exsol(t_end)

    sols = crank_nicolson(M, F, J, x0, 1e-2, t_end)
    assert np.isclose(sols[1][-1][0], sol_1, rtol=1e-4)

    sols = sdirk3(M, F, J, x0, 1e-2, t_end)
    assert np.isclose(sols[1][-1][0], sol_1, rtol=1e-4)

    sols = ros3p(M, F, J, x0, 1e-2, t_end, tol=None)
    assert np.isclose(sols[1][-1][0], sol_1, rtol=1e-4)

    sols = rodasp(M, F, J, x0, 1e-2, t_end, tol=None)
    assert np.isclose(sols[1][-1][0], sol_1, rtol=1e-3)

    ts, xs = esdirk34(M, F, J, x0, 1e-2, t_end, tol=1e-5)
    assert ts[-2] <= t_end <= ts[-1]
    from scipy.interpolate import interp1d
    x_end = interp1d(ts, xs, kind='cubic', axis=0)(t_end)
    assert np.isclose(x_end[0], sol_1, rtol=1e-4)


def test_cg_jit_mlmatvec():
    # matrix-free CG on the compact mlmatrix representation of a 2D problem
    import jax.numpy as jnp
    from pyiga_jax import geometry
    from pyiga_jax.assemblers import StiffnessAssembler, MassAssembler
    from pyiga_jax.ops.mlmatvec import make_ml_matvec

    kvs = 2 * (bspline.make_knots(2, 0.0, 1.0, 8),)
    geo = geometry.quarter_annulus()
    K = StiffnessAssembler(kvs, geo).assemble()
    M = MassAssembler(kvs, geo).assemble()

    # matvec parity with expanded sparse matrix
    x = np.random.rand(K.shape[1])
    mv = make_ml_matvec(K)
    y_dev = np.asarray(mv(jnp.asarray(x)))
    y_ref = K.asmatrix().dot(x)
    assert np.allclose(y_dev, y_ref, atol=1e-12)

    # CG solve of (K + M) u = b matrix-free on device
    mvM = make_ml_matvec(M)
    matvec = lambda v: mv(v) + mvM(v)
    b = np.random.rand(K.shape[1])
    u, it = cg_jit(matvec, jnp.asarray(b), tol=1e-10, maxiter=2000)
    A_full = (K.asmatrix() + M.asmatrix())
    assert np.linalg.norm(A_full.dot(np.asarray(u)) - b) < 1e-8 * np.linalg.norm(b)
    assert it < 2000


def test_cg_ir():
    import jax.numpy as jnp
    from pyiga_jax import geometry
    from pyiga_jax.assemblers import StiffnessAssembler
    from pyiga_jax.ops.fastdiag import fastdiag_precond, interior_dofs
    from pyiga_jax.ops.matfree import MatrixFreeOperator
    from pyiga_jax.solvers import cg_ir

    kvs = 3 * (bspline.make_knots(2, 0.0, 1.0, 6),)
    geo = geometry.twisted_box()
    asm = StiffnessAssembler(kvs, geo)
    free = interior_dofs(kvs)
    op64 = MatrixFreeOperator(asm, free_dofs=free, dtype=np.float64)
    op32 = MatrixFreeOperator(asm, free_dofs=free, dtype=np.float32)
    P32 = fastdiag_precond(kvs, dirichlet=True, dtype=np.float32)
    b = np.random.rand(len(free))
    x, info = cg_ir(op64, op32, jnp.asarray(b), tol=1e-10, precond_lo=P32)
    assert info['residual'] < 1e-10
    K = asm.assemble().asmatrix()[free][:, free]
    r = np.linalg.norm(K @ np.asarray(x) - b) / np.linalg.norm(b)
    assert r < 1e-9


def test_gmres():
    # nonsymmetric convection-diffusion system: CG is inapplicable, GMRES
    # (reference solvers rely on scipy for this; here it runs on device).
    import jax.numpy as jnp
    from pyiga_jax import assemble, geometry
    from pyiga_jax.ops.fastdiag import fastdiag_precond
    from pyiga_jax.solvers import gmres_jit

    kvs = 2 * (bspline.make_knots(2, 0.0, 1.0, 10),)
    geo = geometry.bspline_quarter_annulus()
    A = assemble.assemble(
        '(inner(grad(u), grad(v)) + dot(b, grad(u)) * v + u * v) * dx',
        kvs, geo=geo, b=np.array([3.0, -2.0]))
    rhs = np.random.RandomState(1).rand(A.shape[0])
    Adj = jnp.asarray(A.toarray())
    matvec = lambda v: Adj @ v

    x, it = gmres_jit(matvec, jnp.asarray(rhs), tol=1e-10, restart=30)
    r = np.linalg.norm(A @ np.asarray(x) - rhs) / np.linalg.norm(rhs)
    assert r < 1e-9

    # fastdiag-preconditioned: the full (unrestricted) space needs a mass
    # shift since the pure-Neumann Laplacian eigenvalue sum hits zero
    P = fastdiag_precond(kvs, mass_shift=1.0)
    xp, itp = gmres_jit(matvec, jnp.asarray(rhs), tol=1e-10, restart=30,
                        precond=P)
    rp = np.linalg.norm(A @ np.asarray(xp) - rhs) / np.linalg.norm(rhs)
    assert rp < 1e-9
    assert itp < it    # preconditioning must pay off


def test_gmres_cache_key_not_id():
    # Regression (round-2 advisory): the compiled-cycle cache must key the
    # preconditioner by strong reference (_op_key), never by id() — an id
    # can be reused after GC, silently aliasing another operator's traced
    # cycle.  Asserts (a) the cache key holds the operator itself and (b) a
    # rebuilt preconditioner gets its own cycle and a correct solve.
    import jax.numpy as jnp
    from pyiga_jax import solvers

    n = 8
    A = np.diag(np.arange(1.0, n + 1))
    Adj = jnp.asarray(A)
    matvec = lambda v: Adj @ v
    rhs = np.ones(n)
    d1 = jnp.asarray(1.0 / np.arange(1.0, n + 1))

    p1 = lambda r: d1 * r
    x1, _ = solvers.gmres_jit(matvec, jnp.asarray(rhs), precond=p1,
                              restart=n)
    per_op = solvers._GMRES_CACHE[matvec]
    assert any(k[0] is p1 for k in per_op), \
        'cache key must strong-reference the preconditioner, not its id'
    assert np.allclose(A @ np.asarray(x1), rhs, atol=1e-8)

    del p1
    p2 = lambda r: 2.0 * (d1 * r)
    x2, _ = solvers.gmres_jit(matvec, jnp.asarray(rhs), precond=p2,
                              restart=n)
    assert len(per_op) == 2, 'rebuilt preconditioner must get its own cycle'
    assert np.allclose(A @ np.asarray(x2), rhs, atol=1e-8)


def test_solver_cache_evicts_plain_callables():
    # the fallback matvec wrapper must hold the operator weakly: a strong
    # capture keeps the weak-key cache entry (and the operator's device
    # arrays) alive forever
    import gc
    import weakref
    from pyiga_jax.solvers import cg_jit

    import jax.numpy as jnp
    n = 40
    A = np.diag(np.arange(1.0, n + 1))
    Ad = jnp.asarray(A)
    mv = lambda v: Ad @ v
    b = jnp.asarray(np.ones(n))
    x, _ = cg_jit(mv, b, tol=1e-10)
    assert np.linalg.norm(A @ np.asarray(x) - 1.0) < 1e-8
    ref = weakref.ref(mv)
    del mv, x
    gc.collect()
    assert ref() is None


def test_gauss_seidel_noncontiguous_x():
    # non-contiguous / non-f64 x must still be updated (the native kernel
    # works on a converted buffer and copies back)
    import scipy.sparse
    from pyiga_jax.solvers import gauss_seidel

    n = 30
    rng = np.random.default_rng(0)
    A = scipy.sparse.csr_matrix(np.diag(np.full(n, 4.0))
                                + scipy.sparse.random(n, n, 0.1,
                                                      random_state=0))
    b = rng.random(n)
    x_ref = np.zeros(n)
    gauss_seidel(A, x_ref, b, iterations=5)
    X = np.zeros((n, 2))
    gauss_seidel(A, X[:, 0], b, iterations=5)
    assert np.array_equal(X[:, 0], x_ref)
    x32 = np.zeros(n, dtype=np.float32)
    gauss_seidel(A, x32, b, iterations=5)
    assert np.allclose(x32, x_ref, atol=1e-6)
