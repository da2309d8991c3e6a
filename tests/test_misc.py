import matplotlib
matplotlib.use('Agg')

import numpy as np

from pyiga_jax import approx, bspline, geometry, stilde, utils, vis
from pyiga_jax.spline import Spline


def test_stilde_basis():
    for p in (2, 3, 4):
        kv = bspline.make_knots(p, 0.0, 1.0, 10)
        P_tilde, P_compl = stilde.Stilde_basis(kv)
        assert P_tilde.shape[0] == kv.numdofs
        assert P_tilde.shape[1] + P_compl.shape[1] == kv.numdofs
        # functions in S-tilde have vanishing odd derivatives at the boundary
        for j in range(P_tilde.shape[1]):
            c = P_tilde[:, j]
            for d in range(1, p, 2):
                assert abs(bspline.deriv(kv, c, d, np.array([0.0]))) < 1e-8
                assert abs(bspline.deriv(kv, c, d, np.array([1.0]))) < 1e-8


def test_spline_class():
    kv = bspline.make_knots(3, 0.0, 1.0, 8)
    coeffs = bspline.interpolate(kv, lambda x: x ** 3)
    s = Spline(kv, coeffs)
    x = np.linspace(0, 1, 30)
    assert np.allclose(s.eval(x), x ** 3)
    assert np.allclose(s.deriv(x), 3 * x ** 2)
    ds = s.derivative()
    assert np.allclose(ds.eval(x), 3 * x ** 2)


def test_approx_interpolate():
    kvs = 2 * (bspline.make_knots(3, 0.0, 1.0, 8),)
    # polynomial of degree <= p is reproduced exactly
    f = lambda x, y: x ** 3 - 2 * x * y + y ** 2
    u = approx.interpolate(kvs, f)
    grid = 2 * (np.linspace(0, 1, 17),)
    vals = geometry.BSplineFunc(kvs, u).grid_eval(grid)
    assert np.allclose(vals, f(grid[1][None, :], grid[0][:, None]))
    # physical interpolation
    geo = geometry.bspline_quarter_annulus()
    u2 = approx.interpolate(kvs, lambda x, y: x + y, geo=geo)
    pts = geo.grid_eval(grid)
    vals2 = geometry.BSplineFunc(kvs, u2).grid_eval(grid)
    assert np.allclose(vals2, pts[..., 0] + pts[..., 1])


def test_approx_project_L2():
    kvs = 2 * (bspline.make_knots(2, 0.0, 1.0, 8),)
    f = lambda x, y: x * y ** 2
    u = approx.project_L2(kvs, f)
    grid = 2 * (np.linspace(0, 1, 15),)
    vals = geometry.BSplineFunc(kvs, u).grid_eval(grid)
    assert np.allclose(vals, f(grid[1][None, :], grid[0][:, None]))


def test_vis_smoke():
    import matplotlib.pyplot as plt
    geo = geometry.quarter_annulus()
    kvs = 2 * (bspline.make_knots(2, 0.0, 1.0, 4),)
    u = approx.interpolate(kvs, lambda x, y: x + y, geo=geo)
    f = geometry.BSplineFunc(kvs, u)
    vis.plot_field(f, geo=geo)
    vis.plot_geo(geo)
    vis.plot_curve(geometry.circular_arc(1.0))
    plt.close('all')

    from tests_helpers_hier import example_hspace2
    hs = example_hspace2()
    vis.plot_hierarchical_mesh(hs)
    vis.plot_hierarchical_cells(hs, {0: set(list(hs.active_cells(0))[:2])})
    vis.plot_active_cells(hs, np.arange(hs.total_active_cells, dtype=float))
    plt.close('all')


def test_lazy_arrays():
    geo = geometry.quarter_annulus()
    grid = 2 * (np.linspace(0, 1, 16),)
    LA = utils.LazyArray(geo, grid)
    block = LA[slice(0, 4), slice(0, 8)]
    full = utils.grid_eval(geo, grid)
    assert np.allclose(block, full[0:4, 0:8])

    LCA = utils.LazyCachingArray(geo, (2,), grid, 4)
    block = LCA[slice(4, 8), slice(8, 16)]
    assert np.allclose(block, full[4:8, 8:16])


def test_profiling_helpers(tmp_path, capsys):
    import jax.numpy as jnp
    from pyiga_jax import profiling

    T = profiling.Timings()
    with T('phase', sync=None) as box:
        box['result'] = jnp.arange(10.0) * 2
    with T('phase'):
        pass
    assert len(T.records['phase']) == 2
    import io
    buf = io.StringIO()
    T.report(buf)
    assert 'phase' in buf.getvalue()

    with profiling.timed('block', verbose=True) as box:
        box['result'] = jnp.ones(5)
    out = capsys.readouterr().out
    assert 'block:' in out
    assert box['seconds'] >= 0

    with profiling.trace(tmp_path / 'prof'):
        float(jnp.sum(jnp.ones(8)))


def test_str2asm_cli(capsys):
    from pyiga_jax._cli import str2asm_main
    str2asm_main(['inner(grad(u), grad(v)) * dx', '--dim', '2', '--hlo'])
    out = capsys.readouterr().out
    assert 'assembly plan' in out
    assert 'stablehlo' in out


def test_approx_vector_matrix_valued():
    # reference test/test_approx.py:20-45 — scalar/vector/matrix-valued
    # interpolation and L2 projection reproduce BSplineFunc coefficients,
    # both from the spline function object and from a plain callable.
    kvs = [bspline.make_knots(p, 0.0, 1.0, 6 + p) for p in (2, 3)]
    N = [kv.numdofs for kv in kvs]
    rng = np.random.default_rng(42)
    for extra in ([], [3], [2, 2]):
        coeffs = rng.random(N + extra)
        func = geometry.BSplineFunc(kvs, coeffs)
        for fun in (approx.interpolate, approx.project_L2):
            assert np.allclose(coeffs, fun(kvs, func))

            def f(X, Y):
                return func.grid_eval([np.squeeze(w) for w in (Y, X)])
            assert np.allclose(coeffs, fun(kvs, f))


def test_approx_interpolate_array_nodes():
    # reference test/test_approx.py:55-63 — interpolation from a value
    # array at user-supplied nodes.
    def f(x, y):
        return (x + y) ** 2
    kvs = 2 * (bspline.make_knots(2, 0.0, 1.0, 10),)
    nodes = tuple(kv.greville() for kv in kvs)
    fvals = utils.grid_eval(f, nodes)
    coeffs = approx.interpolate(kvs, fvals, nodes=nodes)
    spl = geometry.BSplineFunc(kvs, coeffs)
    X = np.linspace(0.0, 1.0, 12)
    assert np.allclose(utils.grid_eval(f, (X, X)), spl.grid_eval((X, X)))


def test_approx_exact_poly_multiplicity():
    # reference test/test_approx.py:77-84 — L2 projection reproduces
    # polynomials exactly for every knot multiplicity.
    for p in range(1, 5):
        for mult in range(1, p + 1):
            kv = bspline.make_knots(p, 0.0, 1.0, 5, mult=mult)
            f = lambda x: (x + 1) ** p
            u = approx.project_L2(kv, f)
            x = np.linspace(0, 1, 25)
            assert np.allclose(f(x), bspline.ev(kv, u, x))


def test_approx_compare_intproj_physical():
    # reference test/test_approx.py:64-74 — interpolation and physical
    # L2 projection agree to approximation accuracy.
    f = lambda x, y: np.cos(x) * np.exp(y)
    kvs = 2 * (bspline.make_knots(3, 0.0, 1.0, 50),)
    x1 = approx.interpolate(kvs, f)
    x2 = approx.project_L2(kvs, f)
    assert abs(x1 - x2).max() < 1e-5
    geo = geometry.bspline_quarter_annulus()
    x1 = approx.interpolate(kvs, f, geo=geo)
    x2 = approx.project_L2(kvs, f, f_physical=True, geo=geo)
    assert abs(x1 - x2).max() < 1e-5
