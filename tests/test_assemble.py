import os.path

import numpy as np
import scipy.sparse

from pyiga_jax import assemblers, bspline, geometry
from pyiga_jax.assemble import (
    assemble_entries, boundary_dofs, bsp_mass_1d, bsp_mass_1d_asym,
    bsp_mixed_deriv_biform_1d, bsp_mixed_deriv_biform_1d_asym,
    bsp_stiffness_1d, bsp_stiffness_1d_asym, bsp_stiffness_2d,
    bsp_stiffness_3d, compute_dirichlet_bcs,
    inner_products, integrate, mass, stiffness, RestrictedLinearSystem,
)
from pyiga_jax.approx import interpolate
from pyiga_jax.utils import read_sparse_matrix

FIXTURES = os.path.join(os.path.dirname(__file__), 'fixtures')


def fixture(name):
    return read_sparse_matrix(os.path.join(FIXTURES, name))


def _random_kv():
    return bspline.KnotVector(
        np.array([0., 0., 0., 0., 0., 0.25, 0.35, 0.45, 0.55, 0.65,
                  0.9, 0.9, 0.9, 0.9, 0.9]), 4)


def test_mass_1d_exact():
    # spot values of the p=4 nonuniform mass matrix (reference literal test)
    M = bsp_mass_1d(_random_kv()).toarray()
    assert abs(M[0, 0] - 2.77777778e-02) < 1e-10
    assert abs(M[0, 1] - 1.57607941e-02) < 1e-10
    assert abs(M[2, 4] - 7.81923076e-03) < 1e-10
    assert abs(M[4, 4] - 6.01755079e-02) < 1e-10
    assert abs(M - M.T).max() < 1e-15
    # partition of unity: sum of all entries = measure of domain (0.9)
    assert abs(M.sum() - 0.9) < 1e-12


def test_stiffness_1d_exact():
    K = bsp_stiffness_1d(_random_kv()).toarray()
    assert abs(K[0, 0] - 9.1428571429) < 1e-9
    assert abs(K[0, 1] + 5.4777176177) < 1e-9
    assert abs(K[3, 4] - 0.0527464473) < 1e-9
    assert abs(K.sum()) < 1e-10     # constants in kernel


def test_asym_1d():
    kv1 = bspline.make_knots(4, 0.0, 1.0, 10)
    kv2 = bspline.make_knots(1, 0.0, 1.0, 20)
    M12 = bsp_mass_1d_asym(kv1, kv2, quadgrid=kv2.mesh)
    assert M12.shape == (kv2.numdofs, kv1.numdofs)
    u = interpolate(kv1, lambda x: x ** 4)
    assert abs(M12.dot(u).dot(np.ones(kv2.numdofs)) - 0.2) < 1e-10

    K12 = bsp_stiffness_1d_asym(kv1, kv2, quadgrid=kv2.mesh)
    v = interpolate(kv2, lambda x: x)
    assert abs(K12.dot(u).dot(v) - 1.0) < 1e-10

    D10 = bsp_mixed_deriv_biform_1d_asym(kv1, kv2, 1, 0, quadgrid=kv2.mesh)
    vone = interpolate(kv2, lambda x: 1.0)
    assert abs(D10.dot(u).dot(vone) - 1.0) < 1e-10


def test_mixed_deriv_biform():
    kv = bspline.make_knots(4, 0.0, 1.0, 20)
    u = interpolate(kv, lambda x: x)
    assert abs(bsp_mixed_deriv_biform_1d(kv, 2, 0).dot(u)).max() < 1e-10
    assert abs(bsp_mixed_deriv_biform_1d(kv, 2, 1).dot(u)).max() < 1e-10


def test_stiffness_2d_kron_vs_geo():
    kvs = (bspline.make_knots(4, 0.0, 1.0, 10),
           bspline.make_knots(3, 0.0, 1.0, 12))
    A_kron = bsp_stiffness_2d(kvs, geo=None).toarray()
    A_geo = bsp_stiffness_2d(kvs, geo=geometry.unit_square()).toarray()
    assert np.allclose(A_kron, A_geo, rtol=0, atol=1e-14)


def test_stiffness_3d_kron_vs_geo():
    kvs = (bspline.make_knots(3, 0.0, 1.0, 4),
           bspline.make_knots(3, 0.0, 1.0, 5),
           bspline.make_knots(3, 0.0, 1.0, 6))
    A_kron = bsp_stiffness_3d(kvs, geo=None).toarray()
    A_geo = bsp_stiffness_3d(kvs, geo=geometry.unit_cube()).toarray()
    assert np.allclose(A_kron, A_geo, rtol=0, atol=1e-14)


def test_mass_geo_2d_golden():
    kv = bspline.make_knots(3, 0.0, 1.0, 15)
    geo = geometry.bspline_quarter_annulus()
    M = mass((kv, kv), geo)
    M_ref = fixture('poisson_neu_d2_p3_n15_mass.mtx.gz')
    assert abs(M - M_ref).max() < 1e-14


def test_stiffness_geo_2d_golden():
    kv = bspline.make_knots(3, 0.0, 1.0, 15)
    geo = geometry.bspline_quarter_annulus()
    A = stiffness((kv, kv), geo)
    A_ref = fixture('poisson_neu_d2_p3_n15_stiff.mtx.gz')
    assert abs(A - A_ref).max() < 1e-14


def test_mass_geo_3d_golden():
    kv = bspline.make_knots(2, 0.0, 1.0, 10)
    geo = geometry.twisted_box()
    M = mass((kv, kv, kv), geo)
    M_ref = fixture('poisson_neu_d3_p2_n10_mass.mtx.gz')
    assert abs(M - M_ref).max() < 1e-14


def test_stiffness_geo_3d_golden():
    kv = bspline.make_knots(2, 0.0, 1.0, 10)
    geo = geometry.twisted_box()
    A = stiffness((kv, kv, kv), geo)
    A_ref = fixture('poisson_neu_d3_p2_n10_stiff.mtx.gz')
    assert abs(A - A_ref).max() < 1e-14


def test_mass_nurbs_geo():
    # exact NURBS quarter annulus: total mass = area = 3/4 pi
    kv = bspline.make_knots(2, 0.0, 1.0, 8)
    geo = geometry.quarter_annulus()
    M = mass((kv, kv), geo)
    area = M.sum()
    # (Gauss rule is not exact for the rational integrand; ~2e-10 quad error)
    assert abs(area - 0.75 * np.pi) < 1e-8


def test_inner_products():
    kvs = [bspline.make_knots(p, 0.0, 1.0, 8 + p) for p in range(3, 6)]
    f = lambda x, y, z: np.cos(x) * np.exp(y) * np.sin(z)
    inp = inner_products(kvs, f)
    assert inp.shape == tuple(kv.numdofs for kv in kvs)
    inp2 = inner_products(kvs, f, geo=geometry.unit_cube())
    assert np.allclose(inp, inp2)


def test_integrate():
    kv = bspline.make_knots(3, 0.0, 1.0, 10)
    assert abs(integrate((kv, kv), lambda x, y: 1.0,
                         geo=geometry.quarter_annulus())
               - 0.75 * np.pi) < 1e-10
    assert abs(integrate((kv, kv), lambda x, y: x * y) - 0.25) < 1e-12


def test_dirichlet_restriction():
    # solve -Lap u = 0 with u = g on boundary where g is (bi)linear => exact
    kv = bspline.make_knots(2, 0.0, 1.0, 8)
    kvs = (kv, kv)
    geo = geometry.unit_square()
    A = stiffness(kvs, geo)
    g = lambda x, y: 1.0 + 2 * x + 3 * y
    bcs = compute_dirichlet_bcs(kvs, geo, ('all', g))
    rls = RestrictedLinearSystem(A, 0.0, bcs)
    import scipy.sparse.linalg as spla
    u_free = spla.spsolve(rls.A.tocsc(), rls.b)
    u = rls.complete(u_free)
    u_exact = interpolate(kvs, g, geo=geo).ravel()
    assert np.allclose(u, u_exact, atol=1e-10)


def test_boundary_dofs():
    kvs = (bspline.make_knots(2, 0.0, 1.0, 4), bspline.make_knots(2, 0.0, 1.0, 5))
    bd = boundary_dofs(kvs, 'left', ravel=True)
    N = tuple(kv.numdofs for kv in kvs)
    assert np.array_equal(bd, np.arange(N[0]) * N[1])
    bd = boundary_dofs(kvs, 'top', ravel=True)
    assert np.array_equal(bd, (N[0] - 1) * N[1] + np.arange(N[1]))


def test_assembler_positional_args():
    # reference generated assemblers take (kvs, geo, inputs...) positionally
    # (codegen/cython.py:518); our compiled classes accept the same calls.
    from pyiga_jax import assemblers
    kv_t = bspline.make_knots(2, 0.0, 2.0, 6)
    kv = bspline.make_knots(3, 0.0, 1.0, 8)
    geo = geometry.unit_cube(dim=1).cylinderize(0.0, 2.0, support=(0.0, 2.0))
    asm_pos = assemblers.HeatAssembler_ST2D((kv_t, kv), geo)
    asm_kw = assemblers.HeatAssembler_ST2D((kv_t, kv), geo=geo)
    A1 = assemble_entries(asm_pos)
    A2 = assemble_entries(asm_kw)
    assert abs(A1 - A2).max() < 1e-15


def test_assembler_positional_non_geo_input():
    # positional binding must skip the implicit 'geo' entry in vf.inputs:
    # (kvs, geo, coef) binds coef to the declared input, not to geo again
    from pyiga_jax.compile import compile_vform
    from pyiga_jax.vform import VForm, inner, grad, dx
    kvs = 2 * (bspline.make_knots(2, 0.0, 1.0, 6),)
    geo = geometry.quarter_annulus()
    V = VForm(2)
    u, v = V.basisfuns()
    coef = V.input('coef')
    V.add(coef * inner(grad(u), grad(v)) * dx)
    cls = compile_vform(V)
    cf = lambda x, y: 1.0 + x * y
    A_pos = assemble_entries(cls(kvs, geo, cf))
    A_kw = assemble_entries(cls(kvs, geo=geo, coef=cf))
    assert abs(A_pos - A_kw).max() < 1e-15


def test_restricted_system_unsorted_bcs():
    # unsorted/duplicated bc indices must assign values to the RIGHT dofs
    # (the restriction rows are always in ascending dof order)
    kv = bspline.make_knots(2, 0.0, 1.0, 6)
    A = bsp_stiffness_1d(kv) + bsp_mass_1d(kv)
    b = np.zeros(A.shape[0])
    rs_sorted = RestrictedLinearSystem(A, b, ([1, 3], [10.0, 20.0]))
    rs_unsorted = RestrictedLinearSystem(A, b, ([3, 1], [20.0, 10.0]))
    assert np.allclose(rs_sorted.b, rs_unsorted.b)
    u1 = rs_sorted.complete(np.zeros(rs_sorted.A.shape[1]))
    u2 = rs_unsorted.complete(np.zeros(rs_unsorted.A.shape[1]))
    assert np.allclose(u1, u2)
    assert u1[1] == 10.0 and u1[3] == 20.0
    # duplicates keep the first occurrence instead of crashing
    rs_dup = RestrictedLinearSystem(A, b, ([1, 3, 1], [10.0, 20.0, 99.0]))
    assert np.allclose(rs_dup.b, rs_sorted.b)


def test_vector_assembly_pruned_block():
    # a vector form touching only one component block: bmat gets explicit
    # zero blocks instead of an all-None row/column crash
    from pyiga_jax import assemble as asm_mod
    kvs = 2 * (bspline.make_knots(2, 0.0, 1.0, 5),)
    A = asm_mod.assemble('u[0] * v[0] * dx', kvs,
                         bfuns=[('u', 2), ('v', 2)],
                         geo=geometry.unit_square())
    n = (kvs[0].numdofs * kvs[1].numdofs)
    assert A.shape == (2 * n, 2 * n)
    assert abs(A[:n, :n]).max() > 0
    assert A[n:, n:].nnz == 0 or abs(A[n:, n:]).max() == 0
