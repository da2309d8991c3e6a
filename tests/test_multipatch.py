import pytest
import numpy as np
import scipy.sparse
import scipy.sparse.linalg

from pyiga_jax import bspline, geometry, vform
from pyiga_jax.assemble import Multipatch, assemble


def _make_Lshape():
    kvs = 2 * (bspline.make_knots(2, 0.0, 1.0, 8),)
    squ = geometry.unit_square()
    geos = (squ, squ.translate((1, 0)), squ.scale((-1, 1)).translate((2, 1)))
    MP = Multipatch([(kvs, g) for g in geos])
    MP.join_boundaries(0, 'right', 1, 'left')
    MP.join_boundaries(1, 'top', 2, 'bottom', flip=(True,))
    MP.finalize()
    return MP


def test_multipatch():
    MP = _make_Lshape()
    assert MP.numpatches == 3
    assert MP.numdofs == 90 + 81 + 90 + 2 * 10 - 1

    idx1 = MP.patch_to_global_idx(1)
    assert idx1.size == 100
    idx1 = idx1.reshape((10, 10))
    assert np.array_equal(idx1[:-1, 1:].ravel(), 90 + np.arange(9 * 9))
    assert np.array_equal(idx1[:, 0], 90 + 81 + 90 + np.arange(10))
    assert np.array_equal(idx1[-1, 1:], 90 + 81 + 90 + 10 + np.arange(9))

    u1 = np.arange(100)
    P1 = MP.patch_to_global(1)
    assert scipy.sparse.linalg.norm(
        MP.global_to_patch(1) @ P1 - scipy.sparse.eye(100)) == 0
    ug = P1 @ u1
    u0 = (MP.global_to_patch(0) @ ug).reshape((10, 10))
    assert np.allclose(u0[:, :-1], 0)
    assert np.array_equal(u0[:, -1], np.arange(0, 100, 10))
    u2 = (MP.global_to_patch(2) @ ug).reshape((10, 10))
    assert np.allclose(u2[1:, :], 0)
    assert np.array_equal(u2[0, :], np.arange(99, 89, -1))

    bcidx, bcvals = MP.compute_dirichlet_bcs([(0, 'top', lambda x, y: 1.0)])
    assert np.array_equal(bcidx,
                          list(range(9 * 9, 10 * 9)) + [90 + 81 + 90 + 9])
    assert np.allclose(bcvals, 1.0)


def test_detect_interfaces():
    MP = _make_Lshape()
    MP2 = Multipatch(MP.patches, automatch=True)
    assert MP2.numdofs == MP.numdofs
    assert MP2.shared_per_patch == MP.shared_per_patch


@pytest.mark.slow
def test_multipatch_assemble():
    kvs = 2 * (bspline.make_knots(2, 0.0, 1.0, 8),)
    geos = [geometry.unit_square(), geometry.unit_square().translate((1, 0))]
    MP = Multipatch([(kvs, g) for g in geos], automatch=True)

    def f(x, y):
        return np.sin(2 * x) + np.exp(y)
    A, b = MP.assemble_system(vform.stiffness_vf(2),
                              vform.L2functional_vf(2, physical=True), f=f)
    # same problem as a single patch over the union domain
    knots_x = np.array(2 * [0.0] + list(np.linspace(0, 1.0, 9))
                       + list(np.linspace(1.0, 2.0, 9)) + 2 * [2.0])
    kvs2 = (kvs[0], bspline.KnotVector(knots_x, 2))
    geo2 = geometry.identity(kvs2)
    A2 = assemble(vform.stiffness_vf(2), kvs2, geo=geo2)
    b2 = assemble(vform.L2functional_vf(2, physical=True), kvs2, geo=geo2,
                  f=f)

    Ix = np.arange(b.size)
    Ix = np.hstack((
        Ix[:9 * 10].reshape((10, 9)),
        Ix[2 * 9 * 10:].reshape((10, 1)),
        Ix[9 * 10:2 * 9 * 10].reshape((10, 9)))).ravel()
    assert np.allclose(b[Ix], b2.ravel())
    assert np.allclose(A.toarray()[Ix][:, Ix], A2.toarray())
