import pytest
import numpy as np
from numpy.random import rand

from pyiga_jax import assemble, bspline, geometry, utils, vform
from pyiga_jax.hierarchical import HDiscretization, HSpace, HSplineFunc


def _make_hs(p=3, n=3):
    kv = bspline.make_knots(p, 0.0, 1.0, n)
    return HSpace((kv, kv))


def create_example_hspace(p, dim, n0, disparity=np.inf, truncate=False,
                          num_levels=3):
    bdspecs = ([(0, 0), (0, 1), (1, 0), (1, 1)] if dim == 2
               else [(0, 0), (0, 1)])
    hs = HSpace(dim * (bspline.make_knots(p, 0.0, 1.0, n0),),
                truncate=truncate, disparity=disparity, bdspecs=bdspecs)
    delta = 0.5
    for lv in range(num_levels):
        hs.refine_region(lv, lambda *X: min(X) > 1 - delta ** (lv + 1))
    return hs


def test_hspace():
    hs = _make_hs()
    assert hs.numlevels == 1
    assert hs.numactive == (36,)

    hs.refine({0: [(0, 0), (0, 1), (1, 0), (1, 1), (0, 2)]})
    hs.refine({1: [(0, 0), (0, 1), (2, 0), (1, 0), (1, 1)]})

    assert hs.numlevels == 3
    assert hs.numactive == (28, 21, 20)
    assert tuple(len(a) for a in hs.deactfun) == (8, 5, 0)
    assert hs.numdofs == 69
    assert hs.total_active_cells == 39

    # spot checks of the canonical order (reference literal data)
    af = hs.active_functions(flat=True)
    assert af[0] == (0, (1, 2))
    assert af[28] == (1, (0, 2))
    assert af[-1] == (2, (5, 1))
    ac = hs.active_cells(flat=True)
    assert ac[0] == (0, (1, 2))
    assert ac[4] == (1, (0, 2))
    assert ac[-1] == (2, (5, 1))

    # THB partition of unity on the fine level
    R = hs.represent_fine(truncate=True)
    assert R.shape == (225, 69)
    one = geometry.BSplineFunc(hs.mesh(2).kvs, R.dot(np.ones(R.shape[1])))
    vals = utils.grid_eval(one, 2 * (np.linspace(0.0, 1.0, 10),))
    assert np.allclose(vals, 1.0)


def test_cells():
    hs = create_example_hspace(p=3, dim=2, n0=4)

    def contains(A, B):
        return all(a[0] <= b[0] <= b[1] <= a[1] for a, b in zip(A, B))

    def area(A):
        return np.prod([b - a for a, b in A])

    for f_lv in range(hs.numlevels):
        f = sorted(hs.active_functions(lv=f_lv))[-1]
        funcs = [[] for _ in range(hs.numlevels)]
        funcs[f_lv] = [f]
        f_supp = hs.function_support(f_lv, f)
        act_cells = hs.compute_supports(funcs)
        ar = 0.0
        for lv, cells in act_cells.items():
            for c in cells:
                ext = hs.cell_extents(lv, c)
                assert contains(f_supp, ext)
                ar += area(ext)
        assert abs(area(f_supp) - ar) < 1e-10


def test_hmesh_cells():
    hs = create_example_hspace(p=3, dim=2, n0=4, num_levels=2)
    assert hs.hmesh.hmesh_cells({0: {(2, 2)}}) == \
        {1: {(4, 4), (4, 5), (5, 4), (5, 5)}}
    assert hs.hmesh.hmesh_cells({0: {(3, 3)}}) == \
        {2: set(hs.hmesh.cell_grandchildren(0, [(3, 3)], 2))}
    assert hs.hmesh.hmesh_cells({2: {(6, 5)}}) == {0: {(1, 1)}}
    assert hs.hmesh.cell_grandparent(2, [(6, 5)], 0) == {(1, 1)}


def test_thb_hb_transforms():
    hs = create_example_hspace(p=4, dim=2, n0=4)
    T = hs.thb_to_hb()
    assert np.allclose((hs.represent_fine() @ T).toarray(),
                       hs.represent_fine(truncate=True).toarray())
    T_inv = hs.hb_to_thb()
    assert np.allclose((T_inv @ T).toarray(), np.eye(hs.numdofs))
    for k in range(hs.numlevels - 1):
        Tk = hs.truncate_one_level(k)
        Tk_inv = hs.truncate_one_level(k, inverse=True)
        X = Tk_inv @ Tk
        assert np.allclose(X.toarray(), np.eye(X.shape[0]))


def test_cellextents():
    hs = _make_hs(p=2, n=2)
    hs.refine_region(0, lambda *X: True)
    assert hs.numlevels == 2
    assert np.array_equal(hs.cell_extents(0, (1, 0)), ((0.5, 1.0), (0.0, 0.5)))
    assert np.array_equal(hs.cell_extents(1, (2, 1)),
                          ((0.5, 0.75), (0.25, 0.5)))
    assert np.array_equal(hs.function_support(0, (0, 0)),
                          ((0.0, 0.5), (0.0, 0.5)))
    assert np.array_equal(hs.function_support(1, (3, 1)),
                          ((0.25, 1.0), (0.0, 0.5)))


def test_incidence():
    kv = bspline.make_knots(2, 0.0, 1.0, 4)
    hs = HSpace((kv,))
    hs.refine_region(0, lambda x: 1. / 4 < x < 3. / 4)
    hs.refine_region(1, lambda x: 3. / 8 < x < 5. / 8)
    Z = hs.incidence_matrix().toarray()
    assert np.array_equal(Z, [
        [1, 0, 0, 0, 0, 0, 0, 0],
        [1, 0, 1, 0, 1, 1, 0, 0],
        [1, 0, 1, 1, 1, 1, 1, 1],
        [0, 1, 1, 1, 1, 1, 1, 1],
        [0, 1, 0, 1, 0, 0, 1, 1],
        [0, 1, 0, 0, 0, 0, 0, 0],
        [0, 0, 1, 0, 1, 1, 1, 1],
        [0, 0, 0, 1, 1, 1, 1, 1],
        [0, 0, 0, 0, 1, 1, 1, 0],
        [0, 0, 0, 0, 0, 1, 1, 1]])


@pytest.mark.slow
def test_hierarchical_assemble():
    hs = create_example_hspace(p=4, dim=2, n0=4, disparity=1)
    geo = geometry.bspline_quarter_annulus()
    hd = HDiscretization(hs, vform.stiffness_vf(dim=2), {'geo': geo})
    A = hd.assemble_matrix(symmetric=True)
    A_fine = assemble.stiffness(hs.knotvectors(hs.numlevels - 1), geo=geo)
    I_hb = hs.represent_fine()
    assert np.allclose(A.toarray(), (I_hb.T @ A_fine @ I_hb).toarray())

    A3 = assemble.assemble(vform.stiffness_vf(dim=2), hs, geo=geo)
    assert np.allclose(A.toarray(), A3.toarray())

    f = lambda x, y: np.cos(x) * np.exp(y)
    f_hb = assemble.inner_products(hs.knotvectors(hs.numlevels - 1), f,
                                   f_physical=True, geo=geo).ravel() @ I_hb
    f2 = assemble.assemble('f * v * dx', hs, f=f, geo=geo)
    assert np.allclose(f_hb, f2)


def _convdiff_vf(dim, conv_vector):
    from pyiga_jax.vform import VForm, dx, grad, inner
    vf = VForm(dim=dim)
    u, v = vf.basisfuns()
    vf.add((inner(grad(u), grad(v)) + inner(conv_vector, grad(u)) * v) * dx)
    return vf


@pytest.mark.slow
def test_hierarchical_assemble_nonsym():
    hs = create_example_hspace(p=4, dim=2, n0=4, disparity=1, num_levels=2)
    geo = geometry.bspline_quarter_annulus()
    A = assemble.assemble(_convdiff_vf(2, (1.0, 1.0)), hs, geo=geo)
    A_fine = assemble.assemble(_convdiff_vf(2, (1.0, 1.0)),
                               hs.knotvectors(hs.numlevels - 1), geo=geo)
    I_hb = hs.represent_fine()
    assert np.allclose(A.toarray(), (I_hb.T @ A_fine @ I_hb).toarray())


def test_grid_eval():
    hs = create_example_hspace(p=3, dim=2, n0=6)
    u = rand(hs.numdofs)
    grid = 2 * (np.linspace(0, 1, 50),)
    for truncate in (False, True):
        f_fine = geometry.BSplineFunc(
            hs.knotvectors(hs.numlevels - 1),
            hs.represent_fine(truncate=truncate) @ u)
        hsf = HSplineFunc(hs, u, truncate=truncate)
        assert hsf.dim == 1 and hsf.sdim == 2
        assert hsf.support == ((0.0, 1.0), (0.0, 1.0))
        assert np.allclose(f_fine.grid_eval(grid), hsf.grid_eval(grid))
        assert np.allclose(f_fine.grid_jacobian(grid), hsf.grid_jacobian(grid))
        assert np.allclose(f_fine.grid_hessian(grid), hsf.grid_hessian(grid))
        assert np.allclose(hsf(grid[1][7], grid[0][19]),
                           hsf.grid_eval(grid)[19, 7])


def test_prolongators():
    hs = create_example_hspace(p=3, dim=2, n0=4, disparity=1, num_levels=1)
    u_tp = rand(hs.mesh(0).numbf)
    f0 = geometry.BSplineFunc(hs.knotvectors(0), u_tp)
    u_lv0 = np.concatenate((u_tp[hs.active_indices()[0]],
                            u_tp[hs.deactivated_indices()[0]]))
    X = 2 * (np.linspace(0, 1, 20),)
    for truncate in (False, True):
        hs.truncate = truncate
        u = u_lv0
        for P in hs.virtual_hierarchy_prolongators():
            u = P @ u
        f = HSplineFunc(hs, u)
        assert np.allclose(f0.grid_eval(X), f.grid_eval(X))


def test_project_L2_hspace():
    from pyiga_jax import approx
    f = lambda x, y: x ** 2 - 4 * x * y + y ** 3
    X = 2 * (np.linspace(0, 1, 20),)
    hs = create_example_hspace(p=3, dim=2, n0=4)
    u = approx.project_L2(hs, f, f_physical=True,
                          geo=geometry.unit_square())
    hsf = HSplineFunc(hs, u)
    assert np.allclose(hsf.grid_eval(X), f(X[1][None, :], X[0][:, None]),
                       atol=1e-4)


def test_hspace_boundary():
    hs = create_example_hspace(p=3, dim=2, n0=4, num_levels=2)
    bd_space, mapping = hs.boundary('left')
    assert bd_space.dim == 1
    assert len(mapping) == bd_space.numdofs


def test_subspace_relations():
    hs = create_example_hspace(p=3, dim=2, n0=4, num_levels=2)
    hs2 = hs.copy()
    assert hs.is_subspace_of(hs2)
    assert hs.spans_same_space_as(hs2)
    hs2.refine_region(2, lambda x, y: x > 0.9 and y > 0.9)
    assert hs.is_subspace_of(hs2)
    assert not hs2.is_subspace_of(hs)
    # prolongation preserves function values
    P = hs.prolongate_to(hs2)
    u = rand(hs.numdofs)
    X = 2 * (np.linspace(0, 1, 15),)
    f1 = HSplineFunc(hs, u)
    f2 = HSplineFunc(hs2, P @ u)
    assert np.allclose(f1.grid_eval(X), f2.grid_eval(X))


def test_cell_properties_multilevel():
    # the cell_* properties build virtual spaces truncated at lv+1 levels;
    # they must skip the structurally-empty deeper entries instead of
    # crashing (the reference has this bug)
    hs = HSpace(2 * (bspline.make_knots(2, 0.0, 1.0, 4),))
    hs.refine_region(0, lambda x, y: x > 0.5 and y > 0.5)
    hs.refine_region(1, lambda x, y: x > 0.75 and y > 0.75)
    for name in ('cell_new', 'cell_dirichlet', 'cell_trunc',
                 'cell_func_supp', 'cell_cell_supp', 'cell_global'):
        v = getattr(hs, name)
        assert len(v) == hs.numlevels


def test_tpmesh_lexicographic_order():
    # cells()/functions() follow the reference's lexicographic order
    from pyiga_jax.hierarchical import TPMesh
    import itertools
    msh = TPMesh(2 * (bspline.make_knots(2, 0.0, 1.0, 3),))
    assert msh.cells() == list(itertools.product(range(3), range(3)))
    assert msh.functions() == list(itertools.product(range(5), range(5)))


def test_represent_fine_cache_not_corrupted_by_truncation():
    # represent_fine results are memoized on the space cache;
    # truncate_one_level used to resize the CACHED csr in place,
    # permanently zeroing the fine-level block for every later
    # same-key caller
    hs = create_example_hspace(p=3, dim=2, n0=6, disparity=1,
                               truncate=True, num_levels=3)
    k = 0
    A1 = hs.represent_fine(lv=k + 1, rows=hs._af[k + 1],
                           truncate=False, restrict=True).toarray()
    hs.truncate_one_level(k)            # thb_to_hb/hb_to_thb path
    A2 = hs.represent_fine(lv=k + 1, rows=hs._af[k + 1],
                           truncate=False, restrict=True).toarray()
    assert np.array_equal(A1, A2)
