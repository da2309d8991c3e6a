# -*- coding: utf-8 -*-
"""Multi-device (SPMD) execution over a ``jax.sharding.Mesh``.

The reference has no distributed backend (SURVEY.md section 5.8): its only
parallelism is OpenMP threads over entry chunks.  The equivalent here
shards the tensor-product axes themselves:

* **Assembly**: the Gauss-grid coefficient fields ``C(q_1, ..., q_d)`` are
  sharded along grid axis 0 over the ``'space'`` mesh axis; the
  sum-factorization contraction over the sharded axis becomes a sharded
  matmul for which XLA inserts the reduce/all-gather collectives (the
  scaling-book recipe: annotate shardings, let XLA place the collectives).
  The compact output data tensor is sharded along its first level.
* **Solvers**: dof tensors are sharded along the first TP axis; CG dot
  products become ``psum`` collectives inserted by XLA.
* A second mesh axis ``'rhs'`` data-parallelizes over batched right-hand
  sides (multiple loads / time steps).
"""

import numpy as np

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def make_mesh(n_devices=None, shape=None, axis_names=('space', 'rhs'),
              devices=None):
    """Create a device mesh.  By default uses all devices in a 1D 'space'
    axis; pass `shape` (tuple) for a 2D ('space', 'rhs') mesh.

    Raises ``RuntimeError`` (instead of silently under-provisioning or
    switching backends) when the default backend has fewer devices than
    requested; virtual CPU meshes must be provisioned *before* JAX
    initializes, via ``XLA_FLAGS=--xla_force_host_platform_device_count=<n>``
    and ``JAX_PLATFORMS=cpu`` (see ``tests/conftest.py``).
    """
    want = n_devices if n_devices is not None else (
        int(np.prod(shape)) if shape is not None else None)
    if devices is None:
        devices = jax.devices()
    if want is not None and len(devices) < want:
        raise RuntimeError(
            f"make_mesh: requested {want} devices but only {len(devices)} "
            f"are available ({[str(d) for d in devices]}); a virtual CPU "
            f"mesh needs XLA_FLAGS=--xla_force_host_platform_device_count="
            f"{want} before JAX starts.")
    if n_devices is not None:
        devices = devices[:n_devices]
    if shape is not None:
        devices = devices[:int(np.prod(shape))]
    n = len(devices)
    if shape is None:
        shape = (n, 1) if len(axis_names) == 2 else (n,)
    devs = np.array(devices).reshape(shape)
    return Mesh(devs, axis_names[:len(shape)])


def _spec(mesh, *names):
    return NamedSharding(mesh, P(*names))


def sharded_stiffness_step(asm, mesh, cg_iters=8, num_rhs=None):
    """Build a jitted multi-device step for a stiffness assembler: assemble
    the compact data tensor (grid sharded over 'space'), then run `cg_iters`
    fixed CG iterations on `num_rhs` right-hand sides (sharded over 'rhs',
    dof axis 0 over 'space').

    Returns ``(fn, args)``; ``fn(geo_inputs, term_tables, B)`` returns
    ``(data, X)``.  Used by the multichip dry run and the scaling benchmark.
    """
    from ..ops.mlmatvec import ml_matvec
    from ..ops import sumfac as sumfac_mod
    from ..ops.sumfac import assemble_terms

    S = asm.structure
    shape_dofs = tuple(b[0] for b in S.bs)
    bidx = S.bidx
    have_rhs_axis = 'rhs' in mesh.axis_names
    if num_rhs is None:
        num_rhs = (mesh.shape['rhs'] if have_rhs_axis else 1)

    field_fn = asm.field_fn
    d = asm.dim
    # host-side: which terms share a last table (merging is inert in-trace)
    last_idx = sumfac_mod.last_table_groups(asm.tables.term_tables(asm.terms))

    data_spec = _spec(mesh, 'space')            # shard compact data level 0
    dof_spec_names = ('rhs', 'space') if have_rhs_axis else (None, 'space')

    def step(geo_inputs, term_tables, B):
        # ---- assembly: fields sharded over grid axis 0 ----
        fields = field_fn(geo_inputs)
        fields = [jax.lax.with_sharding_constraint(C, _spec(mesh, 'space'))
                  for C in fields]
        data = assemble_terms(term_tables, fields, last_idx=last_idx)
        data = jax.lax.with_sharding_constraint(data, data_spec)

        # ---- fixed-iteration CG on batched rhs ----
        B = jax.lax.with_sharding_constraint(B, _spec(mesh, *dof_spec_names))

        def matvec(X):      # X: (num_rhs, n_total) raveled dof vectors
            def mv(x):
                y = ml_matvec(data, bidx, shape_dofs, shape_dofs, x)
                return y.reshape(-1)
            return jax.vmap(mv)(X)

        def body(i, state):
            X, R, Pv, rz = state
            Ap = matvec(Pv)
            alpha = rz / jnp.sum(Pv * Ap, axis=1)
            X = X + alpha[:, None] * Pv
            R = R - alpha[:, None] * Ap
            rz_new = jnp.sum(R * R, axis=1)
            Pv = R + (rz_new / rz)[:, None] * Pv
            return (X, R, Pv, rz_new)

        X0 = jnp.zeros_like(B)
        R0 = B - matvec(X0)
        state = (X0, R0, R0, jnp.sum(R0 * R0, axis=1))
        X, R, _, _ = jax.lax.fori_loop(0, cg_iters, body, state)
        return data, X

    n_total = int(np.prod(shape_dofs))
    B = np.random.RandomState(0).rand(num_rhs, n_total)
    args = (asm._geo_inputs, asm.tables.term_tables(asm.terms), B)
    return step, args


def sharded_matfree_cg(asm, mesh, free_dofs=None, precond=None,
                       tol=1e-8, maxiter=200):
    """Preconditioned CG with the production matrix-free operator, sharded
    over the mesh's ``'space'`` axis: the dof tensor and the Gauss-grid
    intermediates of the sum-factorization chains shard along their first
    axis; the per-axis basis contractions over the sharded axis become
    sharded matmuls (XLA inserts the collectives), and CG dot products
    reduce with psum.  Returns ``(solve, operands)``; ``solve(operands, b)``
    is jittable under the mesh and returns ``(x, iterations)``.
    """
    from ..ops.matfree import MatrixFreeOperator
    from ..solvers import _as_operand_fn

    op = MatrixFreeOperator(asm, free_dofs=free_dofs)
    ns = op.ns_in
    spec = _spec(mesh, 'space')
    mv_ops = op.operands
    if precond is None:
        pc_ops, pc_fn = None, (lambda operands, r: r)
    else:
        pc_ops, pc_fn = _as_operand_fn(precond)

    def constrain(v):
        if free_dofs is not None:
            return v        # restricted vectors are 1D; shard the full grid
        return jax.lax.with_sharding_constraint(
            v.reshape(ns), spec).reshape(-1)

    def matvec(operands, v):
        return constrain(op.apply_with_operands(operands['mv'], v))

    def solve(operands, b):
        b = constrain(b)
        r0 = b
        norm0 = jnp.linalg.norm(r0)

        def body(state):
            x, r, z, p, rz, it = state
            Ap = matvec(operands, p)
            alpha = rz / jnp.vdot(p, Ap)
            x = x + alpha * p
            r = r - alpha * Ap
            z = pc_fn(operands['pc'], r)
            rz_new = jnp.vdot(r, z)
            p = z + (rz_new / rz) * p
            return (x, r, z, p, rz_new, it + 1)

        def cond(state):
            _, r, _, _, _, it = state
            return (jnp.linalg.norm(r) > tol * norm0) & (it < maxiter)

        z0 = pc_fn(operands['pc'], r0)
        state = (jnp.zeros_like(b), r0, z0, z0, jnp.vdot(r0, z0),
                 jnp.array(0))
        x, _, _, _, _, it = jax.lax.while_loop(cond, body, state)
        return x, it

    return solve, {'mv': mv_ops, 'pc': pc_ops}


def sharded_multipatch_data(asms, mesh, mode='exact'):
    """Assemble the compact data tensors of MANY patches in one sharded
    device call: the per-patch geometry inputs stack along a leading patch
    axis, that axis shards over the mesh's ``'space'`` dimension, and the
    sum-factorization assembly vmaps over it — each device assembles its
    patch subset concurrently (the device form of the reference's
    sequential per-patch loop, ``assemble.py:1337``; the shared-dof scatter
    ``X A_p X^T`` stays on host where the sparse union numbering lives).

    All assemblers must share knot vectors and geometry structure (their
    `_geo_inputs` pytrees must have identical shapes).  Returns the
    ``(n_patches, nnz_1, ..., nnz_d)`` float64 array."""
    from ..ops import sumfac

    a0 = asms[0]
    tt_np = a0.tables.term_tables(a0.terms)
    last_idx = sumfac.last_table_groups(tt_np)
    tt = jax.tree_util.tree_map(jnp.asarray, tt_np)
    fold_plan, tperms = a0._fold()
    field_fn = a0.field_fn
    gis = [a._geo_inputs for a in asms]
    shapes0 = jax.tree_util.tree_map(np.shape, gis[0])
    for gi in gis[1:]:
        if jax.tree_util.tree_map(np.shape, gi) != shapes0:
            raise ValueError(
                'sharded_multipatch_data: patches must share knot vectors '
                'and geometry structure (unequal geo-input shapes)')
    stacked = jax.tree_util.tree_map(
        lambda *xs: jnp.stack([
            jnp.asarray(x, np.float64)
            if np.issubdtype(np.asarray(x).dtype, np.floating)
            else jnp.asarray(x) for x in xs]),
        *gis)
    spec = _spec(mesh, 'space')     # leading (patch) axis over devices
    plan = tuple(fold_plan) if fold_plan is not None else None
    tperms_d = ([jnp.asarray(p) for p in tperms]
                if fold_plan is not None else None)

    def run(gis_stacked, tt, tperms_d):
        gis_stacked = jax.tree_util.tree_map(
            lambda a: jax.lax.with_sharding_constraint(a, spec), gis_stacked)

        def one(gi):
            fields = field_fn(gi)
            if plan is not None:
                return sumfac.assemble_terms_folded(tt, fields, plan,
                                                    tperms_d, mode=mode,
                                                    last_idx=last_idx)
            return sumfac.assemble_terms(tt, fields, mode=mode,
                                         last_idx=last_idx)
        out = jax.vmap(one)(gis_stacked)
        return jax.lax.with_sharding_constraint(out, spec)

    with mesh:
        out = jax.jit(run)(stacked, tt, tperms_d)
        jax.block_until_ready(out)
    return np.asarray(out, dtype=np.float64)


def sharded_multipatch_vform_data(asms, mesh, mode='exact'):
    """Per-patch block data of a COMPILED VFORM for many patches in one
    sharded device call (the generalization of
    :func:`sharded_multipatch_data` beyond the fixed-form assemblers).

    The compiled assembler's traced assembly function follows the operand
    protocol (inputs pytree + term tables as arguments), so the per-patch
    inputs stack along a leading patch axis that shards over the mesh's
    ``'space'`` dimension and the assembly vmaps over it; the term tables
    depend only on the (shared) knot vectors and broadcast.

    All assemblers must come from the same compiled vform on the same knot
    vectors (equal input treedefs and combo sets).  Returns the dict of
    per-component blocks, each ``(n_patches, nnz_1, ..., nnz_d)``."""
    a0 = asms[0]
    if mode == 'ozaki':
        mode = 'exact'      # the pair path does not vmap; exact f64
    combos0 = tuple(map(repr, a0.combos))
    ops = []
    for a in asms:
        if tuple(map(repr, a.combos)) != combos0:
            raise ValueError('sharded_multipatch_vform_data: patches '
                             'pruned to different combo sets')
        # content equality, not just structure: patch 0's term tables are
        # reused for EVERY patch, so equal-sized but differently-spaced
        # knot vectors would silently assemble with the wrong quadrature
        if a.kvs != a0.kvs:
            raise ValueError('sharded_multipatch_vform_data: patches must '
                             'share knot vectors (per-patch term tables '
                             'are reused from patch 0)')
        ops.append(a._device_operands(mode))
    tds = {jax.tree_util.tree_structure(inp) for (inp, _tt, _tp) in ops}
    if len(tds) != 1:
        raise ValueError('sharded_multipatch_vform_data: patches must '
                         'share knot vectors and geometry structure')
    fn = a0._assembly_fn(mode)
    tt, tperms = ops[0][1], ops[0][2]
    stacked = jax.tree_util.tree_map(lambda *xs: jnp.stack(xs),
                                     *[inp for (inp, _tt, _tp) in ops])
    spec = _spec(mesh, 'space')

    def run(stacked, tt, tperms):
        stacked = jax.tree_util.tree_map(
            lambda a: jax.lax.with_sharding_constraint(a, spec), stacked)
        out = jax.vmap(lambda inp: fn(inp, tt, tperms))(stacked)
        return jax.tree_util.tree_map(
            lambda a: jax.lax.with_sharding_constraint(a, spec), out)

    with mesh:
        out = jax.jit(run)(stacked, tt, tperms)
        jax.block_until_ready(out)
    return {k: np.asarray(v, dtype=np.float64) for k, v in out.items()}


def multipatch_assemble_system(mp, mesh, problem='stiffness', args=None,
                               mode='exact'):
    """Global multipatch system matrix for ANY bilinear form, with
    device-parallel per-patch assembly: the sharded analog of the matrix
    part of ``Multipatch.assemble_system`` (reference assemble.py:1337-1368;
    the host accumulates ``sum_p X_p A_p X_p^T`` over the shared-dof union
    numbering, which becomes a psum over interface dofs when patch results
    live on different devices).

    `problem` is ``'stiffness'``, ``'mass'``, a :class:`~pyiga_jax.vform.VForm`,
    or a form string (parsed against the first patch); `args` are extra
    assembler inputs applied uniformly (``geo`` is set per patch).  Vector
    forms scatter with the blocked (component-major) layout."""
    import scipy.sparse

    from ..compile import compile_vform
    from .. import vform as vf_mod

    args = dict(args or {})
    kvs0, geo0 = mp.patches[0]
    dim = len(kvs0)
    if isinstance(problem, str) and problem in ('stiffness', 'mass'):
        vf = (vf_mod.stiffness_vf(dim) if problem == 'stiffness'
              else vf_mod.mass_vf(dim))
    elif isinstance(problem, vf_mod.VForm):
        vf = problem
    else:
        vf = vf_mod.parse_vf(problem, kvs0, args=dict(args, geo=geo0))
    if vf.arity != 2:
        raise ValueError('multipatch_assemble_system assembles bilinear '
                         'forms; use assemble() per patch for functionals')
    cls = compile_vform(vf)
    asms = [cls(kvs, **dict(args, geo=geo)) for (kvs, geo) in mp.patches]
    blocks = sharded_multipatch_vform_data(asms, mesh, mode=mode)

    n = mp.numdofs
    if not vf.vec:
        A = scipy.sparse.csr_matrix((n, n))
        for p, asm in enumerate(asms):
            X = mp.patch_to_global(p)
            A_p = asm.structure.make_mlmatrix(
                data=blocks[(None, None)][p]).asmatrix('csr')
            A = A + X @ A_p @ X.T
        return A

    ncu, ncv = (c or 1 for c in asms[0].vf.num_components()[:2])
    A = scipy.sparse.csr_matrix((ncv * n, ncu * n))
    zero = scipy.sparse.csr_matrix(asms[0].structure.shape)
    for p, asm in enumerate(asms):
        X = mp.patch_to_global(p)
        rows = [[(asm.structure.make_mlmatrix(
                    data=blocks[(cu, cv)][p]).asmatrix('csr')
                  if (cu, cv) in blocks else zero)
                 for cu in range(ncu)] for cv in range(ncv)]
        A_p = scipy.sparse.bmat(rows, format='csr')
        X_blk = scipy.sparse.kron(scipy.sparse.eye(ncv), X, format='csr')
        X_blk_u = scipy.sparse.kron(scipy.sparse.eye(ncu), X, format='csr')
        A = A + X_blk @ A_p @ X_blk_u.T
    return A


def multipatch_assemble_stiffness(mp, mesh, mode='exact'):
    """Global multipatch stiffness matrix with device-parallel per-patch
    assembly: all patch data tensors assemble in one sharded call
    (:func:`sharded_multipatch_data`), then the host accumulates
    ``sum_p X_p A_p X_p^T`` over the shared-dof union numbering.  Drop-in
    for the matrix part of ``Multipatch.assemble_system('stiffness', ...)``
    for same-space patches."""
    import scipy.sparse

    from ..assemblers import StiffnessAssembler

    asms = [StiffnessAssembler(kvs, geo) for (kvs, geo) in mp.patches]
    data = sharded_multipatch_data(asms, mesh, mode=mode)
    n = mp.numdofs
    A = scipy.sparse.csr_matrix((n, n))
    for p, asm in enumerate(asms):
        X = mp.patch_to_global(p)
        A_p = asm.structure.make_mlmatrix(data=data[p]).asmatrix('csr')
        A = A + X @ A_p @ X.T
    return A


def dryrun(n_devices, dim=3, nspans=4, p=3, cg_iters=4, check_parity=True):
    """Compile and execute one sharded assemble+solve step on an
    `n_devices`-device mesh with tiny shapes.  Defaults exercise the
    flagship workload (3D degree-3 stiffness sum-factorization assembly +
    matrix-free CG).  With ``check_parity``, the same step is also run
    unsharded on one device and the results are asserted to agree to 1e-10.
    Returns the result arrays."""
    from .. import geometry
    from ..assemblers import StiffnessAssembler
    from ..bspline import make_knots

    mesh = make_mesh(shape=(max(1, n_devices // 2), 2)
                     if n_devices % 2 == 0 and n_devices > 1 else (n_devices,),
                     axis_names=('space', 'rhs') if n_devices % 2 == 0
                     and n_devices > 1 else ('space',))
    kvs = dim * (make_knots(p, 0.0, 1.0, nspans),)
    geo = (geometry.quarter_annulus() if dim == 2
           else geometry.twisted_box())
    asm = StiffnessAssembler(kvs, geo)
    step, args = sharded_stiffness_step(asm, mesh, cg_iters=cg_iters)
    args = jax.tree_util.tree_map(jnp.asarray, args)

    with mesh:
        fn = jax.jit(step)
        data, X = fn(*args)
        jax.block_until_ready((data, X))

        # also compile + run the production matrix-free CG over the mesh
        # (the flagship solve path; mass system — SPD and well-conditioned)
        from ..assemblers import MassAssembler
        masm = MassAssembler(kvs, geo)
        solve, ops_ = sharded_matfree_cg(masm, mesh, tol=1e-8, maxiter=200)
        n = int(np.prod([kv.numdofs for kv in kvs]))
        b = jnp.asarray(np.random.RandomState(1).rand(n))
        x, it = jax.jit(solve)(jax.tree_util.tree_map(
            lambda a: a if a is None else jnp.asarray(a), ops_), b)
        jax.block_until_ready(x)

    data, X = np.asarray(data), np.asarray(X)
    if check_parity:
        # one-device reference: same traced step, no mesh
        mesh1 = make_mesh(n_devices=1, shape=(1,), axis_names=('space',))
        step1, args1 = sharded_stiffness_step(asm, mesh1, cg_iters=cg_iters,
                                              num_rhs=X.shape[0])
        with mesh1:
            d1, x1 = jax.jit(step1)(*jax.tree_util.tree_map(
                jnp.asarray, args1))
            jax.block_until_ready((d1, x1))
        scale = max(1.0, float(np.abs(data).max()))
        err_d = float(np.abs(data - np.asarray(d1)).max()) / scale
        err_x = float(np.abs(X - np.asarray(x1)).max()) / max(
            1.0, float(np.abs(X).max()))
        if err_d > 1e-10 or err_x > 1e-10:
            raise AssertionError(
                f"multi-device parity failed: data err {err_d:.2e}, "
                f"solution err {err_x:.2e} (tol 1e-10)")

    # the flagship TWO-FLOAT pipeline (pair fields -> folded pair chains
    # -> banded pair -> f32 CG + pair-residual refinement) over the same
    # mesh, parity-checked against its 1-device run (parallel/flagship.py)
    from .flagship import sharded_flagship_pipeline
    kvs2 = 2 * (make_knots(max(p, 2), 0.0, 1.0, 2 * nspans),)
    asm2 = StiffnessAssembler(kvs2, geometry.quarter_annulus())
    fnN, argsN = sharded_flagship_pipeline(asm2, mesh)
    DhN, DlN, uN, _ = jax.jit(fnN)(*argsN)
    jax.block_until_ready(uN)
    if check_parity:
        fn1, args1 = sharded_flagship_pipeline(
            asm2, make_mesh(n_devices=1, shape=(1,), axis_names=('space',)))
        Dh1, Dl1, u1, _ = jax.jit(fn1)(*args1)
        DN = np.asarray(DhN, np.float64) + np.asarray(DlN, np.float64)
        D1 = np.asarray(Dh1, np.float64) + np.asarray(Dl1, np.float64)
        err_D = float(np.abs(DN - D1).max()) / max(
            1.0, float(np.abs(D1).max()))
        err_u = (float(np.linalg.norm(np.asarray(uN) - np.asarray(u1)))
                 / max(1.0, float(np.linalg.norm(u1))))
        if err_D > 1e-10 or err_u > 1e-6:   # both solves reach tol=1e-8
            raise AssertionError(
                f"flagship two-float multi-device parity failed: banded "
                f"err {err_D:.2e} (tol 1e-10), solution err {err_u:.2e} "
                f"(tol 1e-6)")
    return data, X
