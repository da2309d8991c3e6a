# Multi-device sharding tests (run on the virtual 8-device CPU mesh).
#
# These tests FAIL (not skip) when the virtual mesh cannot be built: the
# conftest provisions 8 CPU devices via xla_force_host_platform_device_count,
# so a missing mesh means the environment is misconfigured and the whole
# multi-chip suite would otherwise silently vanish green.
import numpy as np
import jax

import pytest

from pyiga_jax import geometry
from pyiga_jax.assemblers import MassAssembler, StiffnessAssembler
from pyiga_jax.bspline import make_knots


def _require_cpu_devices(n):
    devs = jax.devices('cpu')
    assert len(devs) >= n, (
        f'multi-device tests need {n} CPU devices but only {len(devs)} '
        f'exist — conftest.py must set '
        f'XLA_FLAGS=--xla_force_host_platform_device_count=8 before any '
        f'jax import')
    return devs


@pytest.mark.parametrize('ndev', [4, 8])
def test_sharded_assembly_and_cg(ndev):
    _require_cpu_devices(ndev)
    from pyiga_jax.parallel import dryrun
    data, X = dryrun(ndev, dim=2, nspans=4, p=2, cg_iters=4)
    assert np.all(np.isfinite(data)) and np.all(np.isfinite(X))

    # sharded assembly must match the single-device result exactly
    kvs = 2 * (make_knots(2, 0.0, 1.0, 4),)
    asm = StiffnessAssembler(kvs, geometry.quarter_annulus())
    ref = asm.assemble().data
    assert np.abs(data - ref).max() < 1e-12


@pytest.mark.slow
def test_sharded_3d_flagship_weak_scaling():
    """3D p=3 sum-factorization assembly + CG: 1-device vs 8-device meshes
    must agree to ~1e-12 (the driver's dryrun_multichip workload)."""
    _require_cpu_devices(8)
    from pyiga_jax.parallel import dryrun
    # check_parity=True runs the same step on a 1-device mesh and asserts
    # max |difference| <= 1e-10 for both the assembled compact data tensor
    # and the CG iterates
    data, X = dryrun(8, dim=3, nspans=4, p=3, cg_iters=4, check_parity=True)
    assert np.all(np.isfinite(data)) and np.all(np.isfinite(X))

    kvs = 3 * (make_knots(3, 0.0, 1.0, 4),)
    asm = StiffnessAssembler(kvs, geometry.twisted_box())
    ref = asm.assemble().data
    assert np.abs(data - ref).max() / np.abs(ref).max() < 1e-12


def test_make_mesh_hard_fails_when_underprovisioned():
    _require_cpu_devices(8)
    from pyiga_jax.parallel import make_mesh
    with pytest.raises(RuntimeError, match='xla_force_host_platform'):
        make_mesh(n_devices=1000)


def test_sharded_step_cg_correctness():
    _require_cpu_devices(8)
    import jax.numpy as jnp
    from pyiga_jax.parallel import make_mesh, sharded_stiffness_step

    # use the mass matrix: SPD and well-conditioned, so fixed-iteration
    # unpreconditioned CG converges (the Neumann stiffness is singular)
    kvs = 2 * (make_knots(2, 0.0, 1.0, 5),)
    asm = MassAssembler(kvs, geometry.quarter_annulus())
    mesh = make_mesh(shape=(4, 2), axis_names=('space', 'rhs'))
    step, args = sharded_stiffness_step(asm, mesh, cg_iters=60, num_rhs=2)
    with mesh:
        data, X = jax.jit(step)(*jax.tree_util.tree_map(jnp.asarray, args))
    # after enough CG iterations the residual should be small
    A = asm.assemble().asmatrix()
    B = np.asarray(args[2])
    for k in range(B.shape[0]):
        r = np.linalg.norm(A @ np.asarray(X[k]) - B[k]) / np.linalg.norm(B[k])
        assert r < 1e-6


def test_sharded_multi_rhs_axis():
    """Batched right-hand sides sharded over a dedicated 'rhs' mesh axis
    must each converge to the same solution as an unbatched solve."""
    _require_cpu_devices(8)
    import jax.numpy as jnp
    from pyiga_jax.parallel import make_mesh, sharded_stiffness_step

    kvs = 2 * (make_knots(2, 0.0, 1.0, 5),)
    asm = MassAssembler(kvs, geometry.quarter_annulus())
    mesh = make_mesh(shape=(2, 4), axis_names=('space', 'rhs'))
    step, args = sharded_stiffness_step(asm, mesh, cg_iters=60, num_rhs=4)
    with mesh:
        data, X = jax.jit(step)(*jax.tree_util.tree_map(jnp.asarray, args))
    A = asm.assemble().asmatrix()
    B = np.asarray(args[2])
    import scipy.sparse.linalg as spla
    for k in range(4):
        x_ref = spla.spsolve(A.tocsc(), B[k])
        assert np.abs(np.asarray(X[k]) - x_ref).max() < 1e-6


def test_sharded_matfree_cg():
    _require_cpu_devices(8)
    import jax.numpy as jnp
    from pyiga_jax.parallel import make_mesh, sharded_matfree_cg

    kvs = 3 * (make_knots(2, 0.0, 1.0, 5),)
    geo = geometry.twisted_box()
    asm = MassAssembler(kvs, geo)
    mesh = make_mesh(8, axis_names=('space',))
    solve, ops_ = sharded_matfree_cg(asm, mesh, tol=1e-10, maxiter=300)
    n = asm.assemble().shape[0]
    b = np.random.RandomState(0).rand(n)
    with mesh:
        x, it = jax.jit(solve)(jax.tree_util.tree_map(
            lambda a: a if a is None else jnp.asarray(a), ops_),
            jnp.asarray(b))
    M = asm.assemble().asmatrix()
    r = np.linalg.norm(M @ np.asarray(x) - b) / np.linalg.norm(b)
    assert r < 1e-8
    assert int(it) < 300


def test_sharded_multipatch_assembly():
    _require_cpu_devices(8)
    from pyiga_jax.assemble import Multipatch
    from pyiga_jax.parallel import (make_mesh, multipatch_assemble_stiffness,
                                    sharded_multipatch_data)

    kvs = 2 * (make_knots(2, 0.0, 1.0, 6),)
    squ = geometry.unit_square()
    geos = (squ, squ.translate((1, 0)), squ.scale((-1, 1)).translate((2, 1)))
    MP = Multipatch([(kvs, g) for g in geos])
    MP.join_boundaries(0, 'right', 1, 'left')
    MP.join_boundaries(1, 'top', 2, 'bottom', flip=(True,))
    MP.finalize()

    mesh = make_mesh(8, axis_names=('space',))

    # per-patch compact data matches the single-patch assembler
    asms = [StiffnessAssembler(kvs, g) for g in geos]
    data = sharded_multipatch_data(asms, mesh)
    assert data.shape[0] == 3
    for p, asm in enumerate(asms):
        ref = asm.assemble(mode='exact').data
        err = np.abs(data[p] - ref).max() / np.abs(ref).max()
        assert err < 1e-12, (p, err)

    # global matrix matches the host per-patch loop
    A = multipatch_assemble_stiffness(MP, mesh)
    from pyiga_jax import vform
    A_ref, _ = MP.assemble_system(vform.stiffness_vf(2),
                                  vform.L2functional_vf(2, physical=True),
                                  f=lambda x, y: 1.0)
    err = abs(A - A_ref).max() / abs(A_ref).max()
    assert err < 1e-12, err


def test_sharded_multipatch_generic_vform():
    # the sharded path must cover assemble_system for
    # 'mass'/'stiffness'/custom vforms, with parity vs the host loop
    # (reference assemble.py:1337-1368)
    _require_cpu_devices(8)
    from pyiga_jax.assemble import Multipatch
    from pyiga_jax.parallel import make_mesh, multipatch_assemble_system
    from pyiga_jax import vform

    kvs = 2 * (make_knots(2, 0.0, 1.0, 5),)
    squ = geometry.unit_square()
    geos = (squ, squ.translate((1, 0)), squ.scale((-1, 1)).translate((2, 1)))
    MP = Multipatch([(kvs, g) for g in geos])
    MP.join_boundaries(0, 'right', 1, 'left')
    MP.join_boundaries(1, 'top', 2, 'bottom', flip=(True,))
    MP.finalize()

    mesh = make_mesh(8, axis_names=('space',))
    rhs = vform.L2functional_vf(2, physical=True)

    # predefined mass
    A = multipatch_assemble_system(MP, mesh, 'mass')
    A_ref, _ = MP.assemble_system(vform.mass_vf(2), rhs, f=lambda x, y: 1.0)
    assert abs(A - A_ref).max() / abs(A_ref).max() < 1e-12

    # custom string form with a parameter (convection-diffusion-reaction)
    form = '(inner(grad(u), grad(v)) + dot(b, grad(u)) * v + u * v) * dx'
    b = np.array([2.0, -1.0])
    A = multipatch_assemble_system(MP, mesh, form, args={'b': b})
    A_ref, _ = MP.assemble_system(form, rhs, args={'b': b},
                                  f=lambda x, y: 1.0)
    assert abs(A - A_ref).max() / abs(A_ref).max() < 1e-12

    # vector-valued form (blocked layout scatter)
    A = multipatch_assemble_system(MP, mesh, vform.divdiv_vf(2))
    n = MP.numdofs
    import scipy.sparse
    A_ref = scipy.sparse.csr_matrix((2 * n, 2 * n))
    from pyiga_jax.assemble import assemble as assemble_fn
    for p in range(MP.numpatches):
        X = MP.patch_to_global(p)
        A_p = assemble_fn(vform.divdiv_vf(2), MP.patches[p][0],
                          geo=MP.patches[p][1])
        Xb = scipy.sparse.kron(scipy.sparse.eye(2), X, format='csr')
        A_ref = A_ref + Xb @ A_p @ Xb.T
    assert abs(A - A_ref).max() / abs(A_ref).max() < 1e-12


@pytest.mark.slow
def test_sharded_flagship_two_float_pipeline():
    """The flagship TWO-FLOAT pipeline (pair fields -> folded pair chains
    -> banded pair -> f32 CG + pair-residual refinement) sharded over an
    8-device mesh agrees with the 1-device run of the same program to
    1e-10, and the compiled SPMD program contains the expected
    collectives (halo collective-permutes from the static banded window
    shifts, all-reduces from the CG dots)."""
    _require_cpu_devices(8)
    from pyiga_jax.parallel import make_mesh
    from pyiga_jax.parallel.flagship import sharded_flagship_pipeline

    kvs = 2 * (make_knots(3, 0.0, 1.0, 12),)
    asm = StiffnessAssembler(kvs, geometry.quarter_annulus())
    mesh8 = make_mesh(8, axis_names=('space',))
    mesh1 = make_mesh(1, axis_names=('space',))
    fn8, args8 = sharded_flagship_pipeline(asm, mesh8)
    fn1, args1 = sharded_flagship_pipeline(asm, mesh1)

    compiled = jax.jit(fn8).lower(*args8).compile()
    txt = compiled.as_text()
    assert txt.count('collective-permute') > 0, 'no halo exchanges in HLO'
    assert txt.count('all-reduce') > 0, 'no reductions in HLO'

    Dh8, Dl8, u8, info8 = compiled(*args8)
    Dh1, Dl1, u1, info1 = jax.jit(fn1)(*args1)
    D8 = np.asarray(Dh8, np.float64) + np.asarray(Dl8, np.float64)
    D1 = np.asarray(Dh1, np.float64) + np.asarray(Dl1, np.float64)
    assert np.abs(D8 - D1).max() / np.abs(D1).max() < 1e-10
    assert (np.linalg.norm(np.asarray(u8) - np.asarray(u1))
            / np.linalg.norm(u1)) < 1e-6   # both solved to tol=1e-8

    # cross-check the sharded banded pair against the host exact-f64
    # assembly (absolute parity, not just sharded-vs-unsharded)
    from pyiga_jax.ops.banded import band_info, banded_from_compact
    ref = banded_from_compact(asm.assemble().data, asm.structure,
                              band_info(asm.structure))
    assert np.abs(D8 - ref).max() / np.abs(ref).max() < 5e-13
