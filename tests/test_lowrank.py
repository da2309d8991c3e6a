import pytest
import os.path

import numpy as np

from pyiga_jax import bspline, geometry
from pyiga_jax.assemble import mass_fast, stiffness_fast
from pyiga_jax.lowrank import (
    MatrixGenerator, TensorGenerator, aca, aca_3d, aca_lr,
)
from pyiga_jax.utils import read_sparse_matrix

FIXTURES = os.path.join(os.path.dirname(__file__), 'fixtures')


def _random_lowrank_matrix(m, n, r):
    return np.random.rand(m, r) @ np.random.rand(r, n)


def test_aca():
    A = _random_lowrank_matrix(60, 50, 5)
    X = aca(A, tol=1e-12, verbose=0)
    assert np.allclose(A, X, atol=1e-10)


def test_aca_generator():
    A = _random_lowrank_matrix(40, 45, 4)
    gen = MatrixGenerator.from_array(A)
    assert np.allclose(gen[3, :], A[3, :])
    assert np.allclose(gen[:, 7], A[:, 7])
    assert gen.entry((2, 3)) == A[2, 3]
    X = aca(gen, tol=1e-12, verbose=0)
    assert np.allclose(A, X, atol=1e-10)


def test_aca_lr():
    A = _random_lowrank_matrix(30, 35, 3)
    crosses = aca_lr(A, tol=1e-12, verbose=0)
    X = sum(np.outer(c, r) for c, r in crosses)
    assert np.allclose(A, X, atol=1e-10)


def test_aca_3d():
    T = sum(np.einsum('i,j,k->ijk', np.random.rand(20), np.random.rand(21),
                      np.random.rand(22)) for _ in range(3))
    X = aca_3d(T, tol=1e-12, verbose=0)
    assert np.allclose(T, X, atol=1e-9)
    # low-rank output variant
    Xlr = aca_3d(T, tol=1e-12, verbose=0, lr=True)
    assert np.allclose(T, Xlr.asarray(), atol=1e-9)


def test_tensor_generator_slices():
    T = np.random.rand(5, 6, 7)
    gen = TensorGenerator.from_array(T)
    assert np.allclose(gen[:, 2, 3], T[:, 2, 3])
    M = gen.matrix_at((0, 1, 2), axes=(1, 2))
    assert np.allclose(M[:, 4], T[0, :, 4])
    assert np.allclose(M[3, :], T[0, 3, :])


def test_fast_mass_stiffness_2d():
    kv = bspline.make_knots(3, 0.0, 1.0, 15)
    geo = geometry.bspline_quarter_annulus()
    M = mass_fast((kv, kv), geo, verbose=0)
    M_ref = read_sparse_matrix(
        os.path.join(FIXTURES, 'poisson_neu_d2_p3_n15_mass.mtx.gz'))
    assert abs(M - M_ref).max() < 1e-9
    A = stiffness_fast((kv, kv), geo, verbose=0)
    A_ref = read_sparse_matrix(
        os.path.join(FIXTURES, 'poisson_neu_d2_p3_n15_stiff.mtx.gz'))
    assert abs(A - A_ref).max() < 1e-9


@pytest.mark.slow
def test_fast_mass_stiffness_3d():
    kv = bspline.make_knots(2, 0.0, 1.0, 10)
    geo = geometry.twisted_box()
    M = mass_fast((kv, kv, kv), geo, verbose=0)
    M_ref = read_sparse_matrix(
        os.path.join(FIXTURES, 'poisson_neu_d3_p2_n10_mass.mtx.gz'))
    assert abs(M - M_ref).max() < 1e-9
    A = stiffness_fast((kv, kv, kv), geo, verbose=0)
    A_ref = read_sparse_matrix(
        os.path.join(FIXTURES, 'poisson_neu_d3_p2_n10_stiff.mtx.gz'))
    assert abs(A - A_ref).max() < 1e-9


def test_fast_no_geo_fallback():
    kv = bspline.make_knots(2, 0.0, 1.0, 6)
    from pyiga_jax.assemble import mass, stiffness
    assert abs(mass_fast((kv, kv)) - mass((kv, kv))).max() == 0
    assert abs(stiffness_fast((kv, kv)) - stiffness((kv, kv))).max() == 0


def test_aca_3d_device_matches_host():
    # device-resident outer loop (fused step jit) vs the host
    # materialized-slice driver and the full assembly
    from pyiga_jax.compile import compile_vform
    from pyiga_jax.lowrank import aca_3d_device, compact_generator, aca_3d
    from pyiga_jax.vform import stiffness_vf

    kv = bspline.make_knots(2, 0.0, 1.0, 8)
    geo = geometry.twisted_box()
    asm = compile_vform(stiffness_vf(3))((kv, kv, kv), geo=geo)

    X_dev = aca_3d_device(asm, tol=1e-10, verbose=0)
    X_host = aca_3d(compact_generator(asm), tol=1e-10, verbose=0,
                    slices='materialize')
    ref = asm.assemble().data
    scale = np.abs(ref).max()
    assert np.abs(X_dev - ref).max() / scale < 1e-9
    assert np.abs(X_host - ref).max() / scale < 1e-9

    # the fused pivot step must be jit-cached ACROSS driver invocations
    # (rebuilding it re-compiled on every call)
    from pyiga_jax import lowrank
    n_cached = len(lowrank._ACA_STEP_CACHE)
    assert n_cached >= 1
    X_dev2 = aca_3d_device(asm, tol=1e-10, verbose=0)
    assert len(lowrank._ACA_STEP_CACHE) == n_cached
    assert np.array_equal(X_dev2, X_dev)

    # ODD maxiter: the final double-pivot dispatch runs its speculative
    # second pivot at slot count+1 == maxiter — without the +1 spare
    # buffer slot XLA clamps that write to maxiter-1 and silently
    # corrupts the last ACCEPTED cross
    X3_dev = aca_3d_device(asm, tol=1e-14, maxiter=3, verbose=0)
    X3_host = aca_3d(compact_generator(asm), tol=1e-14, maxiter=3,
                     verbose=0, slices='materialize')
    scale = np.abs(X3_host).max()
    assert np.abs(X3_dev - X3_host).max() < 1e-9 * scale


def test_tensorgenerator_fancy_index():
    # reference test/test_lowrank.py:6 — fancy-index arrays mix with
    # slices and scalars in TensorGenerator.__getitem__.
    rng = np.random.default_rng(7)
    X = rng.random((3, 4, 5))
    tgen = TensorGenerator.from_array(X)
    assert np.allclose(X, tgen.asarray())
    assert np.allclose(X[1, 2, 3], tgen.entry((1, 2, 3)))
    assert np.allclose(X[1, :, 2], tgen[1, :, 2])
    assert np.allclose(X[:, [0, 2], 1:4], tgen[:, [0, 2], 1:4])
    # multiple fancy indices combine as a cartesian product (not zipped)
    assert np.allclose(X[2][np.ix_([3], [0, 4])], tgen[2, [3], [0, 4]])


def test_compact_slice_dtype_switch():
    # the slice field/table caches are keyed by the effective dtype: a
    # config switch between calls must not reuse wrong-precision operands
    import pyiga_jax
    from pyiga_jax.compile import compile_vform
    from pyiga_jax.vform import stiffness_vf

    kvs = 2 * (bspline.make_knots(2, 0.0, 1.0, 5),)
    asm = compile_vform(stiffness_vf(2))(
        kvs, geo=geometry.quarter_annulus())
    try:
        pyiga_jax.set_dtype(np.float32)
        row32 = asm.compact_slice({0: 1})
        pyiga_jax.set_dtype(np.float64)
        row64 = asm.compact_slice({0: 1})
    finally:
        pyiga_jax.set_dtype(np.float64)
    ref = compile_vform(stiffness_vf(2))(
        kvs, geo=geometry.quarter_annulus()).compact_slice({0: 1})
    # f64 after the switch must be f64-accurate, not cached f32
    assert abs(row64 - ref).max() <= 1e-12 * abs(ref).max()
    assert abs(row32 - ref).max() <= 1e-4 * abs(ref).max()
