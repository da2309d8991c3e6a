# -*- coding: utf-8 -*-
"""Differentiable/batched assembly w.r.t. geometry control points
(pyiga_jax.diff) — a JAX-native capability the reference's compiled
Cython kernels (/root/reference/pyiga/assemblers.pyx) cannot provide.

Contracts:
* assembly_coeff_fn reproduces the production assemble() bit-for-bit at
  the assembler's own coefficients,
* jax.grad through assembly matches central finite differences,
* jax.vmap assembles a family of geometries consistently with a loop.
"""

import numpy as np
import pytest

from pyiga_jax import geometry
from pyiga_jax.assemblers import MassAssembler, StiffnessAssembler
from pyiga_jax.bspline import make_knots
from pyiga_jax.diff import assembly_coeff_fn


def _kvs2(p=2, n=6):
    return 2 * (make_knots(p, 0.0, 1.0, n),)


def _weights_for(fn, coeffs0):
    """Fixed random weights: sum(w * data) is a non-degenerate scalar
    objective (the plain entry sum of a stiffness matrix is identically
    zero — it annihilates constants — so its gradient is zero too)."""
    shape = np.asarray(fn(coeffs0)).shape
    return np.random.RandomState(42).rand(*shape)


def _fd_grad_entry(fn, w, coeffs0, idx, h=1e-6):
    """Central finite difference of sum(w * fn) w.r.t. one coeff entry."""
    cp = np.array(coeffs0, dtype=float)
    cm = np.array(coeffs0, dtype=float)
    cp[idx] += h
    cm[idx] -= h
    return (float(np.sum(w * np.asarray(fn(cp))))
            - float(np.sum(w * np.asarray(fn(cm))))) / (2 * h)


@pytest.mark.parametrize('cls', [MassAssembler, StiffnessAssembler])
def test_value_matches_assemble_bspline(cls):
    kvs = _kvs2()
    geo = geometry.bspline_quarter_annulus()
    asm = cls(kvs, geo)
    fn, coeffs0 = assembly_coeff_fn(asm)
    assert coeffs0.shape == np.asarray(geo.coeffs).shape
    data = np.asarray(fn(coeffs0))
    ref = asm.assemble().data
    assert np.allclose(data, ref, rtol=0, atol=1e-14 * np.abs(ref).max())


def test_value_matches_assemble_nurbs():
    kvs = _kvs2()
    geo = geometry.quarter_annulus()       # exact NURBS
    asm = StiffnessAssembler(kvs, geo)
    fn, coeffs0 = assembly_coeff_fn(asm)
    data = np.asarray(fn(coeffs0))
    ref = asm.assemble().data
    assert np.allclose(data, ref, rtol=0, atol=1e-14 * np.abs(ref).max())


@pytest.mark.parametrize('geo_name', ['bspline', 'nurbs'])
def test_grad_matches_finite_differences(geo_name):
    import jax

    kvs = _kvs2(p=2, n=4)
    geo = (geometry.bspline_quarter_annulus() if geo_name == 'bspline'
           else geometry.quarter_annulus())
    asm = StiffnessAssembler(kvs, geo)
    fn, coeffs0 = assembly_coeff_fn(asm)

    w = _weights_for(fn, coeffs0)
    g = jax.grad(lambda c: jax.numpy.sum(jax.numpy.asarray(w) * fn(c)))(
        jax.numpy.asarray(coeffs0, dtype=jax.numpy.float64))
    g = np.asarray(g)
    assert g.shape == coeffs0.shape
    assert np.all(np.isfinite(g))
    assert np.abs(g).max() > 1e-3      # non-vacuous: assembly moves with c

    # a few representative entries (interior control point, each component)
    rng = np.random.RandomState(0)
    flat_ids = rng.choice(coeffs0.size, size=4, replace=False)
    for fid in flat_ids:
        idx = np.unravel_index(fid, coeffs0.shape)
        fd = _fd_grad_entry(fn, w, coeffs0, idx)
        assert g[idx] == pytest.approx(fd, rel=2e-5, abs=1e-8)


def test_vmap_batched_assembly():
    import jax

    kvs = _kvs2(p=2, n=4)
    geo = geometry.bspline_quarter_annulus()
    asm = MassAssembler(kvs, geo)
    fn, coeffs0 = assembly_coeff_fn(asm)

    rng = np.random.RandomState(1)
    batch = np.stack([coeffs0,
                      coeffs0 + 0.01 * rng.randn(*coeffs0.shape),
                      coeffs0 * 1.02])
    out = np.asarray(jax.vmap(fn)(jax.numpy.asarray(batch)))
    for b in range(batch.shape[0]):
        single = np.asarray(fn(batch[b]))
        assert np.allclose(out[b], single, rtol=1e-12, atol=1e-14)


def test_vform_assembler_grad():
    import jax

    kvs = _kvs2(p=2, n=4)
    geo = geometry.quarter_annulus()
    from pyiga_jax.assemble import instantiate_assembler
    asm = instantiate_assembler(
        'inner(grad(u), grad(v)) * dx', kvs, {'geo': geo}, None, None)
    fn, coeffs0 = assembly_coeff_fn(asm)

    # value parity with the production path
    data = np.asarray(fn(coeffs0))
    ref = asm.assemble().data
    assert np.allclose(data, ref, rtol=0, atol=1e-13 * np.abs(ref).max())

    # gradient vs finite differences on one entry
    w = _weights_for(fn, coeffs0)
    g = np.asarray(
        jax.grad(lambda c: jax.numpy.sum(jax.numpy.asarray(w) * fn(c)))(
            jax.numpy.asarray(coeffs0, dtype=jax.numpy.float64)))
    assert np.abs(g).max() > 1e-3      # non-vacuous
    idx = np.unravel_index(coeffs0.size // 2, coeffs0.shape)
    fd = _fd_grad_entry(fn, w, coeffs0, idx)
    assert g[idx] == pytest.approx(fd, rel=2e-5, abs=1e-8)


def test_unstructured_geometry_raises():
    kvs = _kvs2(p=2, n=4)
    geo = geometry.UserFunction(
        lambda x, y: (x + 0.1 * y * y, y), [[0, 1], [0, 1]],
        jac=lambda x, y: ((np.ones_like(x), 0.2 * y),
                          (np.zeros_like(x), np.ones_like(y))))
    asm = MassAssembler(kvs, geo)
    with pytest.raises(ValueError, match='structured geometry'):
        assembly_coeff_fn(asm)


def test_input_field_grad_diffusion():
    # topology-optimization knob: d(assembly)/d(coefficient field coeffs)
    import jax

    from pyiga_jax import approx
    from pyiga_jax.assemble import instantiate_assembler
    from pyiga_jax.diff import assembly_input_fn

    kvs = _kvs2(p=2, n=4)
    geo = geometry.quarter_annulus()
    cfun = geometry.BSplineFunc(kvs, np.asarray(
        approx.interpolate(kvs, lambda x, y: 1.0 + x * y)))
    asm = instantiate_assembler('c * inner(grad(u), grad(v)) * dx', kvs,
                                {'geo': geo, 'c': cfun}, None, None)
    fn, x0 = assembly_input_fn(asm, 'c')
    assert x0.shape == np.asarray(cfun.coeffs).shape

    # value parity with the production path
    ref = asm.assemble().data
    assert np.allclose(np.asarray(fn(x0)), ref,
                       rtol=0, atol=1e-13 * np.abs(ref).max())

    w = _weights_for(fn, x0)
    g = np.asarray(
        jax.grad(lambda c: jax.numpy.sum(jax.numpy.asarray(w) * fn(c)))(
            jax.numpy.asarray(x0, dtype=jax.numpy.float64)))
    assert np.abs(g).max() > 1e-3
    idx = np.unravel_index(x0.size // 3, x0.shape)
    fd = _fd_grad_entry(fn, w, x0, idx)
    assert g[idx] == pytest.approx(fd, rel=2e-5, abs=1e-8)


def test_input_field_grad_with_first_derivs():
    # a form using grad(c): exercises the traceable ideriv reconstruction
    import jax

    from pyiga_jax import approx
    from pyiga_jax.assemble import instantiate_assembler
    from pyiga_jax.diff import assembly_input_fn

    kvs = _kvs2(p=2, n=4)
    geo = geometry.quarter_annulus()
    cfun = geometry.BSplineFunc(kvs, np.asarray(
        approx.interpolate(kvs, lambda x, y: x * x + 0.5 * y)))
    asm = instantiate_assembler('dot(grad(c), grad(u)) * v * dx', kvs,
                                {'geo': geo, 'c': cfun}, None, None)
    fn, x0 = assembly_input_fn(asm, 'c')

    ref = asm.assemble().data
    assert np.allclose(np.asarray(fn(x0)), ref,
                       rtol=0, atol=1e-13 * np.abs(ref).max())

    w = _weights_for(fn, x0)
    g = np.asarray(
        jax.grad(lambda c: jax.numpy.sum(jax.numpy.asarray(w) * fn(c)))(
            jax.numpy.asarray(x0, dtype=jax.numpy.float64)))
    assert np.abs(g).max() > 1e-3
    idx = np.unravel_index(2 * x0.size // 3, x0.shape)
    fd = _fd_grad_entry(fn, w, x0, idx)
    assert g[idx] == pytest.approx(fd, rel=2e-5, abs=1e-8)


def test_parameter_grad():
    import jax

    from pyiga_jax.assemble import instantiate_assembler
    from pyiga_jax.diff import assembly_input_fn

    kvs = _kvs2(p=2, n=4)
    geo = geometry.quarter_annulus()
    asm = instantiate_assembler(
        '(eps * inner(grad(u), grad(v)) + u * v) * dx', kvs,
        {'geo': geo, 'eps': 0.7}, None, None)
    fn, x0 = assembly_input_fn(asm, 'eps')
    assert float(np.asarray(x0)) == 0.7

    ref = asm.assemble().data
    assert np.allclose(np.asarray(fn(x0)), ref,
                       rtol=0, atol=1e-13 * np.abs(ref).max())

    # weighted objective (the plain entry sum of the stiffness part is
    # identically zero); d/d(eps) is linear, so FD is nearly exact
    w = _weights_for(fn, x0)
    g = float(jax.grad(lambda e: jax.numpy.sum(jax.numpy.asarray(w)
                                               * fn(e)))(
        jax.numpy.float64(0.7)))
    assert abs(g) > 1e-3
    h = 1e-6
    fd = (float(np.sum(w * np.asarray(fn(0.7 + h))))
          - float(np.sum(w * np.asarray(fn(0.7 - h))))) / (2 * h)
    assert g == pytest.approx(fd, rel=1e-6, abs=1e-10)


def test_grad_3d_stiffness():
    # 3-axis contraction chains: value parity + grad vs FD on a tiny 3D case
    import jax

    kvs = 3 * (make_knots(2, 0.0, 1.0, 3),)
    geo = geometry.twisted_box()
    asm = StiffnessAssembler(kvs, geo)
    fn, coeffs0 = assembly_coeff_fn(asm)

    ref = asm.assemble().data
    assert np.allclose(np.asarray(fn(coeffs0)), ref,
                       rtol=0, atol=1e-14 * np.abs(ref).max())

    w = _weights_for(fn, coeffs0)
    g = np.asarray(
        jax.grad(lambda c: jax.numpy.sum(jax.numpy.asarray(w) * fn(c)))(
            jax.numpy.asarray(coeffs0, dtype=jax.numpy.float64)))
    assert np.abs(g).max() > 1e-3
    idx = np.unravel_index(coeffs0.size // 2, coeffs0.shape)
    fd = _fd_grad_entry(fn, w, coeffs0, idx)
    assert g[idx] == pytest.approx(fd, rel=2e-5, abs=1e-8)


def test_implicit_cg_solve_grad_matches_dense():
    # shape gradient of a compliance through an ITERATIVE solve (implicit
    # differentiation, one adjoint CG) == through a dense solve
    import jax
    import jax.numpy as jnp

    from pyiga_jax.diff import implicit_cg_solve
    from pyiga_jax.ops.fastdiag import interior_dofs

    kvs = _kvs2(p=2, n=4)
    geo = geometry.bspline_quarter_annulus()
    asm = StiffnessAssembler(kvs, geo)
    fn, coeffs0 = assembly_coeff_fn(asm)

    N = int(np.prod([kv.numdofs for kv in kvs]))
    free = np.asarray(interior_dofs(kvs))
    I, J = asm.structure.nonzero()
    f = np.random.RandomState(3).rand(len(free))

    def dense_obj(c):
        data = fn(c)
        A = jnp.zeros((N, N), dtype=data.dtype).at[I, J].set(
            data.reshape(-1))[np.ix_(free, free)]
        return jnp.dot(jnp.asarray(f), jnp.linalg.solve(A, jnp.asarray(f)))

    def cg_obj(c):
        data = fn(c)
        A = jnp.zeros((N, N), dtype=data.dtype).at[I, J].set(
            data.reshape(-1))[np.ix_(free, free)]
        u = implicit_cg_solve(lambda x: A @ x, jnp.asarray(f), tol=1e-13)
        return jnp.dot(jnp.asarray(f), u)

    c0 = jnp.asarray(coeffs0, dtype=jnp.float64)
    v_d, g_d = jax.value_and_grad(dense_obj)(c0)
    v_c, g_c = jax.value_and_grad(cg_obj)(c0)
    assert float(v_c) == pytest.approx(float(v_d), rel=1e-10)
    assert np.allclose(np.asarray(g_c), np.asarray(g_d),
                       rtol=1e-6, atol=1e-10)
    assert float(jnp.abs(g_d).max()) > 1e-4


def test_implicit_cg_solve_preconditioned():
    import jax.numpy as jnp

    from pyiga_jax.diff import implicit_cg_solve

    rng = np.random.RandomState(0)
    Q = rng.rand(30, 30)
    A = Q @ Q.T + 30 * np.eye(30)
    b = rng.rand(30)
    x = implicit_cg_solve(lambda v: jnp.asarray(A) @ v, jnp.asarray(b),
                          tol=1e-13,
                          precond=lambda r: r / jnp.asarray(np.diag(A)))
    assert np.allclose(np.asarray(x), np.linalg.solve(A, b),
                       rtol=1e-9, atol=1e-11)


def test_grad_composes_with_sharding():
    # differentiable assembly composes with multi-device sharding: grad of
    # a vmapped objective with the batch sharded over the device mesh
    # equals the unsharded gradient
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    if len(jax.devices()) < 4:
        import pytest as _pytest
        _pytest.fail('test environment must provide >= 4 devices')

    kvs = _kvs2(p=2, n=4)
    geo = geometry.bspline_quarter_annulus()
    asm = MassAssembler(kvs, geo)
    fn, coeffs0 = assembly_coeff_fn(asm)
    w = _weights_for(fn, coeffs0)

    def obj(c):
        return jnp.sum(jnp.asarray(w) * fn(c))

    rng = np.random.RandomState(7)
    batch = np.stack([coeffs0 + 0.01 * rng.randn(*coeffs0.shape)
                      for _ in range(4)])

    g_ref = np.asarray(jax.vmap(jax.grad(obj))(jnp.asarray(batch)))

    mesh = Mesh(np.array(jax.devices()[:4]), ('b',))
    sharding = NamedSharding(mesh, P('b'))
    batch_sh = jax.device_put(jnp.asarray(batch), sharding)
    g_sh = np.asarray(jax.jit(jax.vmap(jax.grad(obj)))(batch_sh))

    assert np.allclose(g_sh, g_ref, rtol=1e-12, atol=1e-14)
