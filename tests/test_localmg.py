# Exact iteration-count regression for the local multigrid solver
# (BASELINE config 5: counts must be identical to the reference,
# test/test_localmg.py:88-98).

import pytest
import numpy as np
import scipy.linalg
import scipy.sparse.linalg

from pyiga_jax import assemble, geometry, solvers, vform
from pyiga_jax.hierarchical import HDiscretization

from test_hierarchical import create_example_hspace


def num_iterations(step, sol, tol=1e-8):
    x = np.zeros_like(sol)
    for it in range(1, 20000):
        x = step(x)
        if scipy.linalg.norm(x - sol) < tol:
            return it
    return np.inf


def run_local_multigrid(p, dim, n0, disparity, smoother, smooth_steps,
                        strategy, tol, relax_backend='host'):
    hs = create_example_hspace(p, dim, n0, disparity, num_levels=3)
    dir_dofs = hs.dirichlet_dofs()
    params = {'geo': geometry.unit_square(), 'f': lambda *x: 1.0}

    iters = []
    for truncate in (False, True):
        hs.truncate = truncate
        hd = HDiscretization(hs, vform.stiffness_vf(dim=2), params)
        A = hd.assemble_matrix()
        f = hd.assemble_rhs()
        P = hs.virtual_hierarchy_prolongators()
        LS = assemble.RestrictedLinearSystem(
            A, f, (dir_dofs, np.zeros_like(dir_dofs)))
        u0 = LS.complete(scipy.sparse.linalg.spsolve(LS.A.tocsc(), LS.b))
        inds = hs.indices_to_smooth(strategy)
        iters.append(num_iterations(
            solvers.local_mg_step(hs, A, f, P, inds, smoother, smooth_steps,
                                  relax_backend=relax_backend),
            u0, tol=tol))
    return tuple(iters)


@pytest.mark.slow
def test_localmg():
    tol, dim, n0, p = 1e-8, 2, 6, 3
    smoother, smooth_steps = 'symmetric_gs', 1

    results = dict()
    for disparity in (np.inf, 1):
        results[disparity] = [
            run_local_multigrid(p, dim, n0, disparity, smoother,
                                smooth_steps, strategy, tol)
            for strategy in ('new', 'trunc', 'func_supp', 'cell_supp')]

    # exact integers from the reference test suite
    assert np.array_equal(results[np.inf],
                          [(107, 118), (49, 19), (49, 15), (41, 15)])
    assert np.array_equal(results[1],
                          [(105, 104), (59, 23), (59, 23), (61, 22)])


@pytest.mark.slow
def test_solve_hmultigrid():
    hs = create_example_hspace(p=3, dim=2, n0=10, disparity=1, num_levels=3)
    for truncate in (False, True):
        hs.truncate = truncate
        hd = HDiscretization(hs, vform.stiffness_vf(dim=2),
                             {'geo': geometry.unit_square(),
                              'f': lambda *x: 1.0})
        A = hd.assemble_matrix()
        f = hd.assemble_rhs()
        dir_dofs = hs.dirichlet_dofs()
        LS = assemble.RestrictedLinearSystem(
            A, f, (dir_dofs, np.zeros_like(dir_dofs)))
        u0 = LS.complete(scipy.sparse.linalg.spsolve(LS.A.tocsc(), LS.b))
        u_mg, iters = solvers.solve_hmultigrid(hs, A, f, tol=1e-8)
        assert np.allclose(u0, u_mg)


def test_solve_hmultigrid_device_fused():
    # the one-dispatch device MG solver (ops/mg.py DeviceMGSolver) must
    # reproduce the host path's iteration counts and solution exactly —
    # same V-cycle operation order, same convergence comparison
    # (the whole solve in one device program)
    hs = create_example_hspace(p=3, dim=2, n0=6, disparity=1, num_levels=3)
    for truncate in (False, True):
        hs.truncate = truncate
        hd = HDiscretization(hs, vform.stiffness_vf(dim=2),
                             {'geo': geometry.unit_square(),
                              'f': lambda *x: 1.0})
        A = hd.assemble_matrix()
        f = hd.assemble_rhs()
        u_h, it_h = solvers.solve_hmultigrid(hs, A, f, tol=1e-8,
                                             relax_backend='host')
        u_d, it_d = solvers.solve_hmultigrid(hs, A, f, tol=1e-8,
                                             relax_backend='device')
        assert it_d == it_h
        assert np.allclose(u_h, u_d)
        # second call on the same system reuses the cached solver
        u_d2, it_d2 = solvers.solve_hmultigrid(hs, A, f, tol=1e-8,
                                               relax_backend='device')
        assert it_d2 == it_d and np.allclose(u_d2, u_d)


def test_device_mg_auto_picks_dense():
    # native float64 on every platform: 'auto' takes the dense float64
    # cycle for small hierarchies, with the host path's exact counts
    from pyiga_jax.ops.mg import DeviceMGSolver
    hs = create_example_hspace(p=2, dim=2, n0=4, disparity=1, num_levels=2)
    hd = HDiscretization(hs, vform.stiffness_vf(dim=2),
                         {'geo': geometry.unit_square(),
                          'f': lambda *x: 1.0})
    A = hd.assemble_matrix().tocsr()
    f = hd.assemble_rhs()
    u_h, it_h = solvers.solve_hmultigrid(hs, A, f, tol=1e-8,
                                         relax_backend='host')
    Ps = hs.virtual_hierarchy_prolongators()
    lv_inds = hs.indices_to_smooth('cell_supp')
    L = hs.numlevels
    As = [None] * L
    As[L - 1] = A
    for lv in range(L - 2, -1, -1):
        As[lv] = (Ps[lv].T @ As[lv + 1] @ Ps[lv]).tocsr()
    s = DeviceMGSolver(As, Ps, lv_inds, ('forward', 'backward'), 2,
                       active_dofs=hs.non_dirichlet_dofs())
    assert s.smoother_impl == 'dense'
    u_d, it_d = s.solve(f, tol=1e-8)
    assert it_d == it_h
    assert np.allclose(u_h, u_d)


@pytest.mark.slow
def test_device_mg_smoother_impls():
    # every DeviceMGSolver kernel set ('df' two-float, 'dense' f64, 'tri'
    # ELL+triangular, 'wavefront') must reproduce the host path's
    # iteration counts and solution ('df' runs on the CPU; it is refused
    # on the GPU, see test_platform.py)
    from pyiga_jax.ops.mg import DeviceMGSolver
    hs = create_example_hspace(p=3, dim=2, n0=6, disparity=1, num_levels=3)
    hd = HDiscretization(hs, vform.stiffness_vf(dim=2),
                         {'geo': geometry.unit_square(),
                          'f': lambda *x: 1.0})
    A = hd.assemble_matrix().tocsr()
    f = hd.assemble_rhs()
    u_h, it_h = solvers.solve_hmultigrid(hs, A, f, tol=1e-8,
                                         relax_backend='host')
    Ps = hs.virtual_hierarchy_prolongators()
    lv_inds = hs.indices_to_smooth('cell_supp')
    L = hs.numlevels
    As = [None] * L
    As[L - 1] = A
    for lv in range(L - 2, -1, -1):
        As[lv] = (Ps[lv].T @ As[lv + 1] @ Ps[lv]).tocsr()
    for impl in ('df', 'dense', 'tri', 'wavefront'):
        s = DeviceMGSolver(As, Ps, lv_inds, ('forward', 'backward'), 2,
                           active_dofs=hs.non_dirichlet_dofs(),
                           smoother_impl=impl)
        u_d, it_d = s.solve(f, tol=1e-8)
        assert it_d == it_h, impl
        assert np.allclose(u_h, u_d), impl


@pytest.mark.slow
def test_localmg_device_smoother():
    # the device wavefront smoother (ops/relax.py) must reproduce the
    # reference's exact iteration counts (SURVEY checklist #6:
    # order-preserving device-resident Gauss-Seidel)
    tol, dim, n0, p = 1e-8, 2, 6, 3
    results = [
        run_local_multigrid(p, dim, n0, np.inf, 'symmetric_gs', 1,
                            strategy, tol, relax_backend='device')
        for strategy in ('new', 'trunc', 'func_supp', 'cell_supp')]
    assert np.array_equal(results,
                          [(107, 118), (49, 19), (49, 15), (41, 15)])
