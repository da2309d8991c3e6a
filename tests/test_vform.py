import numpy as np
import pytest
import scipy.sparse
from scipy.sparse import kron as spkron

from pyiga_jax import bspline, geometry
from pyiga_jax.approx import interpolate
from pyiga_jax.assemble import (
    Assembler, assemble, assemble_vf, bsp_mixed_deriv_biform_1d, divdiv,
    inner_products, instantiate_assembler, mass, stiffness,
)
from pyiga_jax.compile import compile_vform
from pyiga_jax.vform import (
    VForm, dx, grad, heat_st_vf, inner, mass_vf, parse_vf,
    stiffness_vf, wave_st_vf,
)


def test_mass_stiffness_vf():
    kv = bspline.make_knots(3, 0.0, 1.0, 8)
    kvs = (kv, kv)
    geo = geometry.bspline_quarter_annulus()
    M = compile_vform(mass_vf(2))(kvs, geo=geo).assemble().asmatrix()
    assert abs(M - mass(kvs, geo)).max() < 1e-14
    K = compile_vform(stiffness_vf(2))(kvs, geo=geo).assemble().asmatrix()
    assert abs(K - stiffness(kvs, geo)).max() < 1e-13


def test_assemble_vf():
    vf = VForm(2)
    u, v = vf.basisfuns()
    vf.add(inner(grad(u), grad(v)) * dx)
    kvs = 2 * (bspline.make_knots(3, 0.0, 1.0, 10),)
    geo = geometry.quarter_annulus()
    A = assemble_vf(vf, kvs, geo=geo)
    assert np.allclose(A.toarray(), stiffness(kvs, geo).toarray())

    vf_f = VForm(2, arity=1)
    f_in = vf_f.input('f')
    v = vf_f.basisfuns()
    vf_f.add(f_in * v * dx)
    f = lambda x, y: np.exp(x + y)
    f1 = assemble_vf(vf_f, kvs, geo=geo, f=f)
    assert np.allclose(f1, inner_products(kvs, f, geo=geo))


def test_heat_wave_st():
    T_end = 2.0
    geo = geometry.unit_cube(dim=1).cylinderize(0.0, T_end,
                                                support=(0.0, T_end))
    kv_t = bspline.make_knots(2, 0.0, T_end, 6)
    kv = bspline.make_knots(3, 0.0, 1.0, 8)
    kvs = (kv_t, kv)
    M, M_t, DxDx = mass(kv), mass(kv_t), stiffness(kv)

    DtD0 = bsp_mixed_deriv_biform_1d(kv_t, 1, 0)
    A_ref = (spkron(DtD0, M) + spkron(M_t, DxDx)).tocsr()
    A = compile_vform(heat_st_vf(2))(kvs, geo=geo).assemble().asmatrix()
    assert abs(A_ref - A).max() < 1e-14

    D0Dt = bsp_mixed_deriv_biform_1d(kv_t, 0, 1)
    DttDt = bsp_mixed_deriv_biform_1d(kv_t, 2, 1)
    W_ref = (spkron(DttDt, M) + spkron(D0Dt, DxDx)).tocsr()
    W = compile_vform(wave_st_vf(2))(kvs, geo=geo).assemble().asmatrix()
    assert abs(W_ref - W).max() < 1e-12


@pytest.mark.slow
def test_divdiv():
    kv = bspline.make_knots(3, 0.0, 1.0, 8)
    kvs = (kv, kv)
    geo = geometry.bspline_quarter_annulus()
    A = divdiv(kvs, geo, layout='packed', format='bsr')
    u = interpolate(kvs, lambda x, y: (x, -y), geo=geo)
    assert abs(A.dot(u.ravel())).max() < 1e-12

    A = divdiv(kvs, geo, layout='blocked')
    u_blocked = np.moveaxis(u, -1, 0)
    assert abs(A.dot(u_blocked.ravel())).max() < 1e-12


@pytest.mark.slow
def test_assemble_string():
    kvs = 2 * (bspline.make_knots(2, 0.0, 1.0, 10),)
    geo = geometry.quarter_annulus()
    A1 = assemble('inner(grad(u), grad(v)) * dx', kvs, geo=geo)
    A2 = stiffness(kvs, geo)
    assert np.allclose(A1.toarray(), A2.toarray())

    asm = Assembler('inner(grad(u), grad(v)) * dx', kvs, geo=geo,
                    symmetric=True, updatable=['geo'])
    assert np.allclose(asm.assemble().toarray(), A2.toarray())
    with pytest.raises(RuntimeError):
        asm.assemble(f=geo)
    with pytest.raises(ValueError):
        Assembler('inner(grad(u), grad(v)) * dx', kvs, geo=geo,
                  updatable=['f'])

    f = lambda x, y: x * y ** 2
    f1 = assemble('f * v * dx', kvs, geo=geo, f=f)
    assert np.allclose(f1, inner_products(kvs, f, geo=geo, f_physical=True))

    # vector-valued rhs: packed vs blocked layouts
    f1 = assemble('f * div(v) * dx', kvs, bfuns=[('v', 2)], geo=geo, f=f,
                  layout='packed')
    f2 = assemble('f * div(v) * dx', kvs, bfuns=[('v', 2)], geo=geo, f=f,
                  layout='blocked')
    assert np.allclose(f1.transpose(2, 0, 1), f2)

    # 1D problems
    geo1 = geometry.unit_cube(dim=1)
    A1 = assemble('inner(grad(u), grad(v)) * dx', kvs[:1], geo=geo1)
    assert np.allclose(A1.toarray(), stiffness(kvs[0]).toarray())
    f = lambda x: 1 + x ** 2
    f1 = assemble('f * v * dx', kvs[:1], geo=geo1, f=f)
    assert np.allclose(f1, inner_products(kvs[0], f=f, f_physical=True,
                                          geo=geo1))

    with pytest.raises(ValueError):
        assemble('inner(grad(u), grad(v)) * dx', kvs)


def test_assemble_vf_with_params():
    geo = geometry.quarter_annulus()
    kvs = 2 * (bspline.make_knots(3, 0.0, 1.0, 10),)
    f = assemble('a * inner(grad(u), b) * dx', kvs, geo=geo, a=1.8,
                 b=(-1.5, 0.7))
    f2 = assemble('1.8 * inner(grad(u), (-1.5, 0.7)) * dx', kvs, geo=geo)
    assert np.allclose(f, f2)


def test_convection_diffusion():
    kvs = 2 * (bspline.make_knots(2, 0.0, 1.0, 8),)
    # B-spline geometry: x-coordinate is exactly representable in the space
    geo = geometry.bspline_quarter_annulus()
    A = assemble('(inner(grad(u), grad(v)) + dot(b, grad(u)) * v) * dx',
                 kvs, geo=geo, b=np.array([1.0, 2.0]))
    K = stiffness(kvs, geo)
    C = A - K
    # convection part applied to constant function is zero columnsum-wise...
    # check: convection of linear function u(x,y)=x gives (b . e_x, v) = (1, v)
    ux = interpolate(kvs, lambda x, y: x, geo=geo).ravel()
    ones_v = inner_products(kvs, lambda x, y: 1.0, f_physical=True,
                            geo=geo).ravel()
    assert np.allclose(C.dot(ux), 1.0 * ones_v, atol=1e-12)


def test_assemble_surface_vf():
    vf = VForm(2, geo_dim=3, arity=1)
    v = vf.basisfuns()
    from pyiga_jax.vform import ds
    vf.add(v * ds)
    kvs = 2 * (bspline.make_knots(3, 0.0, 1.0, 10),)
    geo_3d = geometry.tensor_product(geometry.line_segment(0.0, 1.0),
                                     geometry.quarter_annulus())
    f = assemble_vf(vf, kvs, geo=geo_3d.boundary('left'))
    assert np.allclose(f.sum(), (2 * 1 * np.pi) / 4)
    f = assemble_vf(vf, kvs, geo=geo_3d.boundary('right'))
    assert np.allclose(f.sum(), (2 * 2 * np.pi) / 4)


@pytest.mark.slow
def test_assemble_boundary_vector():
    kvs = 3 * (bspline.make_knots(3, 0.0, 1.0, 3),)
    geo_3d = geometry.tensor_product(geometry.line_segment(0.0, 1.0),
                                     geometry.quarter_annulus())
    f = assemble('v * ds', kvs, geo=geo_3d, boundary='left')
    assert f.shape == (6, 6, 1)
    assert np.allclose(f.sum(), (2 * 1 * np.pi) / 4)
    assert np.allclose(assemble('v * ds', kvs, geo=geo_3d,
                                boundary='right').sum(), (2 * 2 * np.pi) / 4)
    assert np.allclose(assemble('v * ds', kvs, geo=geo_3d,
                                boundary='bottom').sum(), 1.0)
    assert np.allclose(assemble('v * ds', kvs, geo=geo_3d,
                                boundary='top').sum(), 1.0)
    assert np.allclose(assemble('v * ds', kvs, geo=geo_3d,
                                boundary='front').sum(), 3 * np.pi / 4)
    assert np.allclose(assemble('v * ds', kvs, geo=geo_3d,
                                boundary='back').sum(), 3 * np.pi / 4)

    # average normal vectors over the faces
    checks = [('left', [-1, -1, 0]), ('right', [2, 2, 0]),
              ('bottom', [0, -1, 0]), ('top', [-1, 0, 0]),
              ('front', 3 * np.pi / 4 * np.array([0, 0, -1.0])),
              ('back', 3 * np.pi / 4 * np.array([0, 0, 1.0]))]
    for bd, expected in checks:
        nv = assemble('inner(v, n) * ds', kvs, bfuns=[('v', 3)], geo=geo_3d,
                      boundary=bd, layout='packed')
        assert np.allclose(nv.sum(axis=(0, 1, 2)), expected), bd

    # 2D normal vectors
    kvs = 2 * (bspline.make_knots(3, 0.0, 1.0, 3),)
    geo = geometry.unit_square()
    for bd, expected in [('left', [-1, 0]), ('right', [1, 0]),
                         ('bottom', [0, -1]), ('top', [0, 1])]:
        nv = assemble('inner(v, n) * ds', kvs, bfuns=[('v', 2)], geo=geo,
                      boundary=bd, layout='packed')
        assert np.allclose(nv.sum(axis=(0, 1)), expected), bd


@pytest.mark.slow
def test_assemble_boundary_matrix():
    kvs = (bspline.make_knots(3, 0.0, 1.0, 3),
           bspline.make_knots(3, 0.0, 1.0, 4),
           bspline.make_knots(3, 0.0, 1.0, 5))
    geo_3d = geometry.tensor_product(geometry.line_segment(0.0, 1.0),
                                     geometry.quarter_annulus())
    A = assemble('inner(grad(u), grad(v)) * ds', kvs, geo=geo_3d,
                 boundary='left')
    assert A.shape == (6 * 7, 6 * 7)
    A = assemble('inner(grad(u), grad(v)) * ds', kvs, geo=geo_3d,
                 boundary='top')
    assert A.shape == (6 * 8, 6 * 8)
    # tangential components on the flat 'front' face = 2D Laplacian
    A = assemble('inner(cross(n, grad(u)), cross(n, grad(v))) * ds', kvs,
                 geo=geo_3d, boundary='front')
    assert A.shape == (7 * 8, 7 * 8)
    A2 = stiffness(kvs[1:], geo=geometry.quarter_annulus())
    assert np.allclose(A.toarray(), A2.toarray())


def test_assemble_nonsym_vec():
    kvs = 2 * (bspline.make_knots(2, 0.0, 1.0, 5),)
    geo = geometry.quarter_annulus()
    problem = 'inner(as_matrix([[2,1],[0,0]]).dot(u), v) * dx'
    A = assemble(problem, kvs, geo=geo, bfuns=[('u', 2), ('v', 2)],
                 layout='packed', format='bsr')
    u = interpolate(kvs, lambda x, y: (x * y, -2 * x * y), geo=geo)
    assert np.allclose(A @ u.ravel(), 0)

    asm = instantiate_assembler(problem, kvs, args={'geo': geo},
                                bfuns=[('u', 2), ('v', 2)])
    blocks = np.array(asm.multi_blocks([(0, 0), (0, 1), (2, 1)]))
    AA = A.toarray()
    assert np.allclose(blocks[0], AA[0:2, 0:2])
    assert np.allclose(blocks[1], AA[0:2, 2:4])
    assert np.allclose(blocks[2], AA[4:6, 2:4])

    A = assemble(problem, kvs, geo=geo, bfuns=[('u', 2), ('v', 2)],
                 layout='blocked')
    u_blocked = np.moveaxis(u, -1, 0)
    assert np.allclose(A @ u_blocked.ravel(), 0)


def test_updatable_assembler():
    kvs = 2 * (bspline.make_knots(2, 0.0, 1.0, 6),)
    geo = geometry.unit_square()
    asm = Assembler('c * u * v * dx', kvs, geo=geo, c=lambda x, y: 1.0 + 0 * x,
                    updatable=['c'])
    M1 = asm.assemble()
    assert np.allclose(M1.toarray(), mass(kvs, geo).toarray())
    M2 = asm.assemble(c=lambda x, y: 2.0 + 0 * x)
    assert np.allclose(M2.toarray(), 2 * M1.toarray())


def test_vform_hash():
    v1, v2 = stiffness_vf(2), stiffness_vf(2)
    assert v1.hash() == v2.hash()
    assert mass_vf(2).hash() != v1.hash()
    assert stiffness_vf(3).hash() != v1.hash()


def test_parse_vf_shorthands():
    kvs = 2 * (bspline.make_knots(2, 0.0, 1.0, 4),)
    geo = geometry.quarter_annulus()
    # x = physical coordinates
    f1 = assemble('x[0] * v * dx', kvs, geo=geo)
    f2 = inner_products(kvs, lambda x, y: x, f_physical=True, geo=geo)
    assert np.allclose(f1, f2)


@pytest.mark.slow
def test_vform_symmetry_folding():
    # probe-detected symmetric folding: stiffness folds (and is then exactly
    # symmetric); the convection part of a convection-diffusion form must
    # stay unfolded and the result match the sum of separate assemblies
    import numpy as np
    from pyiga_jax import assemble, geometry
    from pyiga_jax.bspline import make_knots
    from pyiga_jax.compile import compile_vform
    from pyiga_jax.vform import stiffness_vf

    kvs = 2 * (make_knots(2, 0.0, 1.0, 6),)
    geo = geometry.bspline_quarter_annulus()
    asm = compile_vform(stiffness_vf(2))(kvs, geo=geo)
    assert asm._fold_plan is not None
    assert sum(1 for _, m in asm._fold_plan if m) == 1
    A = asm.assemble().asmatrix()
    assert abs(A - A.T).max() == 0.0

    b = np.array([2.0, 1.0])
    B = assemble.assemble(
        '(inner(grad(u), grad(v)) + dot(b, grad(u)) * v) * dx',
        kvs, geo=geo, b=b)
    K = compile_vform(stiffness_vf(2))(kvs, geo=geo).assemble().asmatrix()
    C = assemble.assemble('dot(b, grad(u)) * v * dx', kvs, geo=geo, b=b)
    rel = abs(B - K - C).max() / abs(B).max()
    assert rel < 1e-14
    assert abs(B - B.T).max() > 1e-6      # convection not mirrored away


@pytest.mark.slow
def test_vform_ozaki_mode():
    # Ozaki-split assembly through the compiled-vform API matches exact f64
    import numpy as np
    from pyiga_jax import geometry
    from pyiga_jax.bspline import make_knots
    from pyiga_jax.compile import compile_vform
    from pyiga_jax.vform import parse_vf, stiffness_vf

    kvs = 2 * (make_knots(3, 0.0, 1.0, 6),)
    geo = geometry.quarter_annulus()
    asm = compile_vform(stiffness_vf(2))(kvs, geo=geo)
    A = asm.assemble().asmatrix()
    B = asm.assemble(mode='ozaki').asmatrix()
    assert abs(B - A).max() < 1e-12 * abs(A).max()

    b = np.array([1.5, -0.5])
    vf = parse_vf('dot(b, grad(u)) * v * dx', kvs, {'b': b})
    asm2 = compile_vform(vf)(kvs, geo=geo, b=b)
    C1 = asm2.assemble().asmatrix()
    C2 = asm2.assemble(mode='ozaki').asmatrix()
    assert abs(C2 - C1).max() < 1e-12 * abs(C1).max()


def test_prune_keeps_tiny_asymmetric_terms():
    # per-combo structural-zero detection: a term scaled by a
    # literal 1e-16 sits far below the old global 1e-13-of-max probe
    # threshold but is a genuine (asymmetric) term and must survive pruning
    # and must not be symmetry-folded
    from pyiga_jax.assemble import instantiate_assembler

    kvs = 2 * (bspline.make_knots(2, 0.0, 1.0, 5),)
    geo = geometry.bspline_quarter_annulus()
    b = np.array([2.0, 1.0])

    base = instantiate_assembler('u * v * dx', kvs, {'geo': geo}, None, None)
    multi = instantiate_assembler(
        '(u * v + 1e-16 * dot(b, grad(u)) * v) * dx',
        kvs, {'geo': geo, 'b': b}, None, None)
    # the tiny convection combos (first-derivative trial seeds) survive
    assert len(multi.combos) > len(base.combos)
    deriv_orders = {sum(su[1]) for su, sv in multi.combos}
    assert 1 in deriv_orders

    # structural zeros are still pruned: curl-free-like form with an exact
    # cancellation keeps only the genuine term
    zero = instantiate_assembler(
        '(dot(b, grad(u)) * v - dot(b, grad(u)) * v + u * v) * dx',
        kvs, {'geo': geo, 'b': b}, None, None)
    assert len(zero.combos) == len(base.combos)


@pytest.mark.slow
def test_physical_input_field_derivatives():
    # derivatives of physical-coordinate input fields (capability extension:
    # the reference's codegen rejects this case, codegen/cython.py:474-477).
    # Cross-check grad/hess of a physical field against supplying the
    # analytic gradient / Laplacian as plain (deriv-0) physical inputs.
    from pyiga_jax.vform import VForm, dot, dx, grad, hess, tr

    kvs = 2 * (bspline.make_knots(3, 0.0, 1.0, 6),)
    geo = geometry.quarter_annulus()
    f = lambda x, y: x ** 2 + 3 * x * y + y ** 3
    gradf = lambda x, y: (2 * x + 3 * y, 3 * x + 3 * y ** 2)
    lapf = lambda x, y: 2 + 6 * y

    vf1 = VForm(2)
    u, v = vf1.basisfuns()
    ff = vf1.input('f', physical=True)
    vf1.add(dot(grad(ff), grad(u)) * v * dx)
    A1 = assemble(vf1, kvs, geo=geo, f=f)

    vf2 = VForm(2)
    u, v = vf2.basisfuns()
    gf = vf2.input('gf', shape=(2,), physical=True)
    vf2.add(dot(gf, grad(u)) * v * dx)
    A2 = assemble(vf2, kvs, geo=geo, gf=gradf)
    assert abs(A1 - A2).max() < 1e-12 * abs(A2).max()

    # second derivatives (physical Hessian -> Laplacian)
    vf3 = VForm(2)
    u, v = vf3.basisfuns()
    ff = vf3.input('f', physical=True)
    vf3.add(tr(hess(ff)) * u * v * dx)
    A3 = assemble(vf3, kvs, geo=geo, f=f)
    A4 = assemble('lf * u * v * dx', kvs, geo=geo, lf=lapf)
    assert abs(A3 - A4).max() < 1e-10 * abs(A4).max()

    # finite-difference fallback for non-traceable fields
    f_nt = np.vectorize(lambda x, y: x ** 2 + 3 * x * y + y ** 3)
    A5 = assemble(vf1, kvs, geo=geo, f=f_nt)
    assert abs(A5 - A2).max() < 1e-7 * abs(A2).max()


@pytest.mark.slow
def test_spacetime_second_order_space_derivs():
    # second-order space derivatives in space-time forms (reference parity
    # hole): on a space-time cylinder the physical d^2/dx^2 must agree with
    # the plain 2D assembly of the same term over the cylinder geometry
    from pyiga_jax.vform import VForm, Dx, dx

    kv_x = bspline.make_knots(3, 0.0, 1.0, 5)
    kv_t = bspline.make_knots(2, 0.0, 1.0, 4)
    # nonlinearly parametrized 1D segment, extruded in time
    seg = geometry.BSplineFunc(
        (bspline.make_knots(2, 0.0, 1.0, 2),),
        np.array([0.0, 0.2, 0.6, 1.0]))
    cyl = seg.cylinderize(0.0, 1.0)

    def second_deriv_form(spacetime):
        vf = VForm(2, spacetime=spacetime)
        u, v = vf.basisfuns()
        vf.add(Dx(u, 0, 2) * v * dx)
        return vf

    A_st = assemble(second_deriv_form(True), (kv_t, kv_x), geo=cyl)
    A_2d = assemble(second_deriv_form(False), (kv_t, kv_x), geo=cyl)
    assert abs(A_st - A_2d).max() < 1e-12 * abs(A_2d).max()

    # mixed time/space derivatives: wave-type term with a 2nd space deriv
    vf = VForm(2, spacetime=True)
    u, v = vf.basisfuns()
    vf.add(Dx(u, 0, 2) * v.dt() * dx)
    A = assemble(vf, (kv_t, kv_x), geo=cyl)
    assert np.abs(A.toarray()).max() > 0


def test_expr_tree_utilities():
    from pyiga_jax import vform as vf_mod
    from pyiga_jax.vform import (mapexprs, set_union, stiffness_vf,
                                 sym_index_to_seq, transform_expr)

    assert set_union([{1, 2}, {2, 3}, set()]) == {1, 2, 3}
    # linearized symmetric index: row-major upper triangle
    assert [sym_index_to_seq(3, i, j)
            for i in range(3) for j in range(i, 3)] == [0, 1, 2, 3, 4, 5]
    assert sym_index_to_seq(3, 2, 1) == sym_index_to_seq(3, 1, 2)

    vf = stiffness_vf(2)
    roots = tuple(vf.exprs)
    n_nodes = sum(1 for _ in vf_mod.iterexprs(roots))

    # identity transform keeps the tree intact
    same = mapexprs(roots, lambda e: e)
    assert sum(1 for _ in vf_mod.iterexprs(same)) == n_nodes

    # type-filtered transform visits every node of the type
    hits = []
    transform_expr(roots[0], lambda e: hits.append(e) or e,
                   type=vf_mod.MulExpr)
    assert all(isinstance(e, vf_mod.MulExpr) for e in hits)
    assert hits


def test_symbolic_differentiation():
    # reference test/test_vform.py test_parameter/test_symderiv — sum,
    # product, quotient and chain rules; parameter derivatives vanish.
    from pyiga_jax.vform import (Dx, exprhash, transform_expr, cos,
                                 _to_literal_vec_mat, div, curl, as_expr)

    def simpl(e):
        e = transform_expr(e, _to_literal_vec_mat)
        return transform_expr(e, lambda x: x.fold_constants())

    def eq(e1, e2, simplify=False):
        if simplify:
            e1, e2 = simpl(e1), simpl(e2)
        assert exprhash(e1) == exprhash(e2), '%s != %s' % (e1, e2)

    vf = VForm(3, arity=1)
    u = vf.basisfuns()
    f = vf.input('f')
    G = vf.input('G', shape=(3,))
    a = vf.parameter('a')
    B = vf.parameter('B', (2, 3))
    assert Dx(a, 1).shape == ()
    eq(Dx(B[1, 2] * u, 1), B[1, 2] * Dx(u, 1), simplify=True)
    eq(grad(2 * f, parametric=True), 2 * grad(f, parametric=True),
       simplify=True)
    eq(div(G - 3, parametric=True), div(G, parametric=True), simplify=True)
    eq((f * u).dx(0, parametric=True),
       f.dx(0, parametric=True) * u + f * u.dx(0, parametric=True))
    eq((1 / f).dx(1, parametric=True),
       -f.dx(1, parametric=True) / (f * f), simplify=True)
    eq(curl(2 + grad(u)), curl(grad(u)), simplify=True)
    # powers, incl. expression exponents and reciprocals
    eq(f ** as_expr(3), f * f * f)
    eq(f ** -1, 1.0 / f)
    # finalize freezes the form
    vf2 = VForm(2, arity=1)
    v2 = vf2.basisfuns()
    g2 = vf2.input('g')
    vf2.add(cos(g2) * v2 * dx)
    vf2.finalize()
    with pytest.raises(RuntimeError):
        vf2.finalize()


def test_input_field_hessian_assembly():
    # Physical second derivatives of input fields (hess(f)): assemble the
    # Laplacian functional of an interpolated field on a curved geometry
    # and check O(h^2) convergence to the exact physical Laplacian
    # (reference vform.py:593 order-2 transform incl. curvature terms).
    from pyiga_jax import approx, assemble
    from pyiga_jax.vform import hess

    errs = []
    for n in (8, 16):
        kvs = 2 * (bspline.make_knots(3, 0.0, 1.0, n),)
        geo = geometry.quarter_annulus()
        fcoef = approx.interpolate(kvs, lambda x, y: x**2*y + y**3, geo=geo)
        ffun = geometry.BSplineFunc(kvs, fcoef)
        V = VForm(2, arity=1)
        v = V.basisfuns()
        f = V.input('f')
        H = hess(f)
        V.add((H[0, 0] + H[1, 1]) * v * dx)
        b = np.asarray(assemble.assemble(V, kvs, geo=geo, f=ffun)).ravel()
        b_ex = np.asarray(assemble.inner_products(
            kvs, lambda x, y: 8 * y, f_physical=True, geo=geo)).ravel()
        errs.append(abs(b - b_ex).max() / abs(b_ex).max())
    assert errs[1] < errs[0] / 3.0      # ~4x drop for O(h^2)
    assert errs[1] < 2e-4
