import numpy as np

from pyiga_jax.bspline import (
    KnotVector, make_knots, numdofs, ev, deriv, single_ev, active_ev,
    collocation, collocation_derivs, interpolate, project_L2,
    prolongation, knot_insertion, findspans, tp_bsp_eval_pointwise,
    tp_bsp_jac_pointwise,
)


def test_eval_consistency():
    kv = make_knots(4, 0.0, 1.0, 25)
    coeffs = np.random.rand(kv.numdofs)
    x = np.linspace(0.0, 1.0, 100)
    by_single = sum(coeffs[j] * single_ev(kv, j, x) for j in range(kv.numdofs))
    assert np.linalg.norm(by_single - ev(kv, coeffs, x)) < 1e-10
    assert np.linalg.norm(by_single - collocation(kv, x).dot(coeffs)) < 1e-10


def test_partition_of_unity():
    kv = make_knots(3, 0.0, 1.0, 12, mult=2)
    x = np.linspace(0.0, 1.0, 57)
    vals = active_ev(kv, x)
    assert np.allclose(vals.sum(axis=0), 1.0)


def test_active_deriv_matches_splev():
    kv = KnotVector(np.array([0., 0., 0., 0., 0., 0.05, 0.12, 0.33, 0.51,
                              0.51, 0.51, 0.74, 0.88, 0.91, 1., 1., 1., 1., 1.]), 4)
    coeffs = np.random.rand(kv.numdofs)
    x = np.linspace(0.0, 1.0, 200)
    Cs = collocation_derivs(kv, x, derivs=3)
    for d in range(4):
        ref = deriv(kv, coeffs, d, x)
        assert np.linalg.norm(Cs[d].dot(coeffs) - ref, np.inf) < 1e-8 * max(
            1.0, np.abs(ref).max())


def test_findspan():
    kv = make_knots(2, 0.0, 1.0, 4)
    assert kv.findspan(0.0) == 2
    assert kv.findspan(1.0) == 5
    assert kv.findspan(0.3) == 3
    spans = findspans(kv, np.array([0.0, 0.25, 0.5, 0.99, 1.0]))
    assert list(spans) == [2, 3, 4, 5, 5]


def test_greville():
    kv = make_knots(3, 0.9, 1.0, 5)
    g = kv.greville()
    assert np.allclose(
        g, [0.9, 0.90666667, 0.92, 0.94, 0.96, 0.98, 0.99333333, 1.0])
    kv0 = make_knots(0, 0.0, 1.0, 4)
    assert np.allclose(kv0.greville(), [0.125, 0.375, 0.625, 0.875])


def test_interpolation():
    for p in (0, 3):
        kv = make_knots(p, 0.0, 1.0, 10)
        coeffs = np.random.rand(kv.numdofs)
        result = interpolate(kv, lambda x: ev(kv, coeffs, x))
        assert np.allclose(coeffs, result)


def test_eq_hash():
    kv = make_knots(4, 0.0, 1.0, 25)
    assert kv == make_knots(4, 0.0, 1.0, 25)
    assert not kv == make_knots(2, 0.0, 1.0, 25)
    assert not kv == make_knots(4, 0.1, 1.0, 25)
    assert not kv == make_knots(4, 0.0, 1.1, 25)
    assert not kv == make_knots(4, 0.0, 1.0, 50)


def test_L2_projection():
    kv = make_knots(3, 0.0, 1.0, 10)
    f = lambda x: np.sin(2 * np.pi * x ** 2)
    x = np.linspace(0.0, 1.0, 100)
    coeffs = project_L2(kv, f)
    assert np.linalg.norm(f(x) - ev(kv, coeffs, x)) / np.sqrt(len(x)) < 1e-3


def test_deriv():
    kv = make_knots(4, 0.0, 1.0, 25)
    coeffs = interpolate(kv, lambda x: 1.0 + 2.5 * x)
    x = np.linspace(0.0, 1.0, 100)
    assert np.linalg.norm(deriv(kv, coeffs, 1, x) - 2.5) < 1e-10

    coeffs = np.random.rand(kv.numdofs)
    allders = collocation_derivs(kv, x, derivs=2)
    assert np.linalg.norm(deriv(kv, coeffs, 1, x) - allders[1].dot(coeffs),
                          np.inf) < 1e-10
    assert np.linalg.norm(deriv(kv, coeffs, 2, x) - allders[2].dot(coeffs),
                          np.inf) < 1e-10


def test_refine():
    kv = make_knots(2, 0.0, 1.0, 4)
    kv2 = kv.refine([0.1])
    assert kv2.p == kv.p
    assert np.array_equal(kv2.kv, [0., 0., 0., 0.1, 0.25, 0.5, 0.75, 1., 1., 1.])
    assert np.array_equal(kv.refine().kv, make_knots(2, 0.0, 1.0, 8).kv)


def test_prolongation():
    kv = make_knots(3, 0.0, 1.0, 10)
    coeffs = np.random.rand(kv.numdofs)
    kv2 = kv.refine()
    P = prolongation(kv, kv2)
    x = np.linspace(0.0, 1.0, 100)
    assert np.linalg.norm(ev(kv, coeffs, x) - ev(kv2, P.dot(coeffs), x)) < 1e-10


def test_knot_insertion():
    kv = KnotVector(np.array([0., 0., 0., 0., 0., 0.05, 0.12, 0.33, 0.51,
                              0.51, 0.51, 0.74, 0.88, 0.91, 1., 1., 1., 1., 1.]), 4)
    u = np.random.rand(kv.numdofs)
    x = np.linspace(0, 1, 100)
    for newknot in (0.01, 0.2, 0.33, 0.44, 0.6, 0.99):
        P = knot_insertion(kv, newknot)
        kv1 = kv.refine([newknot])
        assert np.allclose(ev(kv, u, x), ev(kv1, P @ u, x))


def test_mesh_properties():
    kv = make_knots(3, 0.0, 1.0, 4)
    assert np.array_equal(kv.mesh_span_indices(), [3, 4, 5, 6])
    assert kv.numspans == 4
    assert kv.numdofs == 7
    assert numdofs((kv, kv)) == 49
    assert kv.mesh_support_idx(0) == (0, 1)
    assert kv.mesh_support_idx(3) == (0, 4)


def test_tp_pointwise():
    kvs = (make_knots(3, 0.0, 1.0, 6), make_knots(2, 0.0, 1.0, 5))
    coeffs = np.random.rand(kvs[0].numdofs, kvs[1].numdofs)
    # points in xyz order
    X = np.random.rand(40)
    Y = np.random.rand(40)
    vals = tp_bsp_eval_pointwise(kvs, coeffs, (X, Y))
    # compare against per-axis collocation (grid of one point at a time)
    from pyiga_jax.tensor import apply_tprod
    for k in range(0, 40, 7):
        Cy = collocation(kvs[0], [Y[k]]).toarray()
        Cx = collocation(kvs[1], [X[k]]).toarray()
        ref = apply_tprod([Cy, Cx], coeffs)[0, 0]
        assert abs(vals[k] - ref) < 1e-12

    # Jacobian: finite-difference check
    jac = tp_bsp_jac_pointwise(kvs, coeffs, (X, Y))
    h = 1e-7
    v_dx = (tp_bsp_eval_pointwise(kvs, coeffs, (X + h, Y)) - vals) / h
    v_dy = (tp_bsp_eval_pointwise(kvs, coeffs, (X, Y + h)) - vals) / h
    assert np.allclose(jac[:, 0], v_dx, atol=1e-5)
    assert np.allclose(jac[:, 1], v_dy, atol=1e-5)


def test_tp_pointwise_3d():
    kvs = tuple(make_knots(2, 0.0, 1.0, 4) for _ in range(3))
    shp = tuple(kv.numdofs for kv in kvs)
    coeffs = np.random.rand(*shp)
    X, Y, Z = np.random.rand(3, 20)
    vals = tp_bsp_eval_pointwise(kvs, coeffs, (X, Y, Z))
    from pyiga_jax.tensor import apply_tprod
    for k in range(0, 20, 5):
        ops = [collocation(kvs[0], [Z[k]]).toarray(),
               collocation(kvs[1], [Y[k]]).toarray(),
               collocation(kvs[2], [X[k]]).toarray()]
        ref = apply_tprod(ops, coeffs)[0, 0, 0]
        assert abs(vals[k] - ref) < 1e-12
