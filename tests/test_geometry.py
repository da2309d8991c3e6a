import numpy as np

from pyiga_jax import approx, bspline
from pyiga_jax.geometry import (
    BSplineFunc, NurbsFunc, _BoundaryFunction, bspline_quarter_annulus,
    circle, circular_arc, identity, line_segment, outer_product, outer_sum,
    perturbed_square, quarter_annulus, semicircle, tensor_product, twisted_box,
    unit_cube, unit_square,
)


def geos_roughly_equal(geo1, geo2, n=25):
    grid = tuple(np.linspace(s[0], s[1], n) for s in geo1.support)
    return np.allclose(geo1.grid_eval(grid), geo2.grid_eval(grid))


def test_creation():
    assert unit_square().sdim == unit_square().dim == 2
    assert perturbed_square(noise=0.05).dim == 2
    assert bspline_quarter_annulus().dim == 2
    assert unit_cube().dim == 3
    assert unit_cube(dim=4).sdim == 4
    assert twisted_box().dim == 3


def test_cube_identity():
    cube3 = unit_cube(dim=3)
    assert np.allclose(unit_cube(dim=2).coeffs, unit_square().coeffs)
    assert np.allclose(unit_cube(dim=4).coeffs,
                       cube3.cylinderize(0.0, 1.0).coeffs)
    geo = identity([(3.0, 4.0), (5.0, 6.0)])
    assert np.allclose(geo.eval(5, 3), (5, 3))
    assert np.allclose(geo.eval(5.87, 3.21), (5.87, 3.21))
    geo2 = identity([bspline.make_knots(3, 3.0, 4.0, 10),
                     bspline.make_knots(3, 5.0, 6.0, 5)])
    assert geos_roughly_equal(geo, geo2)


def test_evaluation_literal():
    geo = bspline_quarter_annulus()
    x = np.asarray([0.0, 0.5, 1.0])
    y = np.asarray([0.0, 0.3, 0.7, 1.0])
    values = geo.grid_eval((y, x))
    exact = np.array(
        [[[1., 0.], [1.5, 0.], [2., 0.]],
         [[0.91, 0.51], [1.365, 0.765], [1.82, 1.02]],
         [[0.51, 0.91], [0.765, 1.365], [1.02, 1.82]],
         [[0., 1.], [0., 1.5], [0., 2.]]])
    assert abs(exact - values).max() < 1e-14
    assert abs(exact[1, 1] - geo.eval(0.5, 0.3)).max() < 1e-14

    mesh_x, mesh_y = np.meshgrid(x, y, indexing='xy')
    values2 = geo.pointwise_eval((mesh_x, mesh_y))
    assert values2.shape == mesh_x.shape + (2,)
    assert np.allclose(values, values2)

    geo = quarter_annulus()
    values = geo.grid_eval((y, x))
    values2 = geo.pointwise_eval((mesh_x, mesh_y))
    assert np.allclose(values, values2)

    # mixed scalar/array arguments
    x, y, z = 0.7, [0.1, 0.33, 0.72], np.linspace(0.0, 0.5, 4)
    geo = bspline_quarter_annulus().cylinderize(0, 1)
    assert np.allclose(geo(x, y, z), geo.grid_eval((z, y, [x]))[:, :, 0])
    geo = twisted_box()
    assert np.allclose(geo(x, y, z), geo.grid_eval((z, y, [x]))[:, :, 0])


def check_jacobian(f, x, jac, delta=1e-6):
    x = np.asarray(x)
    fx = f(*x)
    for i in range(len(x)):
        xd = x.copy()
        xd[i] += delta
        assert np.allclose(jac[:, i], (f(*xd) - fx) / delta)


def test_jacobian_literal():
    geo = bspline_quarter_annulus()
    x = np.asarray([0.0, 0.3, 0.7, 1.0])
    y = np.asarray([0.75])
    jac = geo.grid_jacobian((y, x))
    exact = np.array([[[[0.4375, -1.5], [0.9375, 0.5]],
                       [[0.4375, -1.95], [0.9375, 0.65]],
                       [[0.4375, -2.55], [0.9375, 0.85]],
                       [[0.4375, -3.], [0.9375, 1.]]]])
    assert abs(exact - jac).max() < 1e-14
    check_jacobian(geo, [0.3, 0.75], jac[0, 1])
    mesh_x, mesh_y = np.meshgrid(x, y, indexing='xy')
    jac2 = geo.pointwise_jacobian((mesh_x, mesh_y))
    assert np.allclose(jac, jac2)


def test_nurbs_jacobian():
    geo = quarter_annulus()
    x = np.array([0.0, 0.3, 0.7, 1.0])
    y = np.array([0.4, 0.75])
    jac = geo.grid_jacobian((y, x))
    check_jacobian(geo, [0.7, 0.4], jac[0, 2])
    mesh_x, mesh_y = np.meshgrid(x, y, indexing='xy')
    assert np.allclose(jac, geo.pointwise_jacobian((mesh_x, mesh_y)))


def test_boundary():
    geo = twisted_box()
    bd = geo.boundary((2, 1))
    assert bd.sdim == geo.sdim - 1 and bd.dim == geo.dim
    assert np.allclose(geo.eval(1, 0.7, 0), bd.eval(0.7, 0))
    grid = 2 * (np.linspace(0, 1, 5),)
    assert isinstance(bd, BSplineFunc)
    jacs = bd.grid_jacobian(grid)
    jacs2 = _BoundaryFunction(geo, (2, 1)).grid_jacobian(grid)
    assert np.allclose(jacs, jacs2)

    geo = quarter_annulus()
    assert geos_roughly_equal(geo.boundary('left'),
                              circular_arc(np.pi / 2, 1.0))
    assert geos_roughly_equal(geo.boundary('right'),
                              circular_arc(np.pi / 2, 2.0))


def test_trf_gradient():
    geo = bspline_quarter_annulus()
    u = BSplineFunc(geo.kvs,
                    approx.interpolate(geo.kvs, lambda x, y: x - y, geo=geo))
    u_grad = u.transformed_jacobian(geo)
    grads = u_grad.grid_eval(2 * (np.linspace(0, 1, 10),))
    assert np.allclose(grads[:, :, 0], 1) and np.allclose(grads[:, :, 1], -1)


def test_nurbs_circles():
    kv = bspline.make_knots(2, 0.0, 1.0, 1)
    r = 2.0
    coeffs = np.array([[r, 0.0, 1.0],
                       [r, r, 1.0 / np.sqrt(2.0)],
                       [0.0, r, 1.0]])
    grid = (np.linspace(0.0, 1.0, 20),)
    for nurbs in (NurbsFunc((kv,), coeffs.copy(), weights=None),
                  NurbsFunc((kv,), coeffs[:, :2], weights=coeffs[:, -1])):
        vals = nurbs.grid_eval(grid)
        assert abs(r - np.linalg.norm(vals, axis=-1)).max() < 1e-12

    for arc_geo, radius in ((semicircle(1.5), 1.5), (circle(0.5), 0.5)):
        vals = arc_geo.grid_eval((np.linspace(0, 1, 30),))
        assert abs(radius - np.linalg.norm(vals, axis=-1)).max() < 1e-12

    nurbs = NurbsFunc((kv,), coeffs[:, :2], weights=coeffs[:, -1])
    assert nurbs.output_shape() == (2,) and nurbs.is_vector()
    nx = nurbs[0]
    assert nx.output_shape() == () and nx.is_scalar()
    assert nx.grid_jacobian(grid).shape[1:] == (1,)
    assert nx.grid_hessian(grid).shape[1:] == (1,)


def _num_hess(f, x, h=1e-3):
    def delta(i, di, j, dj):
        y = list(x)
        y[i] += di
        y[j] += dj
        return y

    def pd2(i, j):
        return (f(delta(i, h, j, h)) + f(delta(i, -h, j, -h))
                - f(delta(i, h, j, -h)) - f(delta(i, -h, j, h))) / (4 * h * h)
    return np.array([pd2(0, 0), pd2(1, 0), pd2(1, 1)])


def _check_hessian(geo):
    def f1(xy):
        return geo.eval(*xy)[0]

    def f2(xy):
        return geo.eval(*xy)[1]
    X = np.linspace(0, 1, 4)[1:-1]
    H = geo.grid_hessian((X, X))
    H_num = np.array([[[_num_hess(f1, (X[i], X[j])),
                        _num_hess(f2, (X[i], X[j]))]
                       for i in range(len(X))] for j in range(len(X))])
    assert np.allclose(H, H_num)


def test_bspline_hessian():
    _check_hessian(bspline_quarter_annulus())


def test_nurbs_hessian():
    _check_hessian(quarter_annulus())


def test_reduced_support():
    geo = unit_square()
    supp = ((0.2, 0.7), (0.4, 0.6))
    geo.support = supp
    assert np.allclose(geo.bounding_box(), list(reversed(supp)))
    bd = geo.boundary('right')
    assert geos_roughly_equal(
        bd, line_segment((0.6, 0.2), (0.6, 0.7), support=(0.2, 0.7)))

    geo = quarter_annulus()
    geo.support = supp
    bd = geo.boundary('top')
    assert np.allclose(bd.bounding_box(),
                       ((0.6177743988536184, 0.7060278844041353),
                        (1.2563259099935216, 1.4358010399925962)))


def test_line_segment():
    L1 = line_segment((1, 0), (4, 2), support=(1, 2))
    assert L1.sdim == 1 and L1.dim == 2
    assert np.allclose(L1.eval(1.5), (2.5, 1.0))
    assert line_segment(3, 5).dim == 1


def test_circular_arcs():
    for alpha, r in ((2. / 3. * np.pi, 2.0), (1.5 * np.pi, 0.7)):
        geo = circular_arc(alpha, r=r)
        grid = (np.linspace(0, 1, 25),)
        vals = geo.grid_eval(grid)
        assert abs(np.linalg.norm(vals, axis=-1) - r).max() < 1e-12
        # endpoints
        assert np.allclose(vals[0], (r, 0))
        assert np.allclose(vals[-1], (r * np.cos(alpha), r * np.sin(alpha)))


def test_combinators():
    # outer sum/product on scalar functions
    f1 = BSplineFunc(bspline.make_knots(2, 0.0, 1.0, 3),
                     np.random.rand(5))
    f2 = BSplineFunc(bspline.make_knots(1, 0.0, 1.0, 4),
                     np.random.rand(5))
    gs = outer_sum(f1, f2)
    gp = outer_product(f1, f2)
    y, x = np.linspace(0, 1, 6), np.linspace(0, 1, 7)
    v1 = f1.grid_eval((y,))
    v2 = f2.grid_eval((x,))
    assert np.allclose(gs.grid_eval((y, x)), v1[:, None] + v2[None, :])
    assert np.allclose(gp.grid_eval((y, x)), v1[:, None] * v2[None, :])

    # tensor_product joins output components
    tp = tensor_product(line_segment(0, 1), quarter_annulus())
    assert tp.sdim == 3 and tp.dim == 3


def test_find_inverse():
    geo = quarter_annulus()
    xi = geo.find_inverse((1.5 / np.sqrt(2), 1.5 / np.sqrt(2)))
    pt = geo.eval(*xi)
    assert np.allclose(pt, (1.5 / np.sqrt(2), 1.5 / np.sqrt(2)), atol=1e-6)


def test_as_vector_getitem():
    geo = bspline_quarter_annulus()
    gx = geo[0]
    grid = 2 * (np.linspace(0, 1, 8),)
    assert np.allclose(gx.grid_eval(grid), geo.grid_eval(grid)[..., 0])
    sc = BSplineFunc(geo.kvs, geo.coeffs[..., 0])
    assert sc.is_scalar() and sc.as_vector().is_vector()


def test_transforms():
    geo = bspline_quarter_annulus()
    grid = 2 * (np.linspace(0, 1, 8),)
    v = geo.grid_eval(grid)
    assert np.allclose(geo.translate((1, 2)).grid_eval(grid), v + [1, 2])
    assert np.allclose(geo.scale(2.0).grid_eval(grid), 2 * v)
    rot = geo.rotate_2d(np.pi / 2).grid_eval(grid)
    assert np.allclose(rot[..., 0], -v[..., 1])
    assert np.allclose(rot[..., 1], v[..., 0])

    ng = quarter_annulus()
    vn = ng.grid_eval(grid)
    assert np.allclose(ng.translate((1, 2)).grid_eval(grid), vn + [1, 2])
    assert np.allclose(ng.scale(0.5).grid_eval(grid), 0.5 * vn)
