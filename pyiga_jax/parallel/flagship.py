# -*- coding: utf-8 -*-
"""The two-float pipeline under SPMD sharding.

The two-float form of the Poisson path (reference behavior contract:
``pyiga.assemble.stiffness`` + a preconditioned solve) is

    two-float geometry fields -> pair sum-factorization chains
    -> banded two-float pair -> f32 CG + pair-residual iterative
    refinement (:func:`pyiga_jax.solvers.cg_ir`)

This module runs that pipeline — the same pair arithmetic, the same
banded data, the same refinement loop — over a ``jax.sharding.Mesh``.
It is opt-in: the native-f64 path of :mod:`pyiga_jax.parallel` is the
default.

* the Gauss-grid axis 0 of the two-float field pairs and the first dof
  axis of vectors/banded data carry the ``'space'`` sharding
  (``with_sharding_constraint`` at the stage boundaries; XLA places the
  collectives — the scaling-book recipe),
* the banded matvecs use the STATIC-offset forms
  (:func:`pyiga_jax.ops.banded.banded_matvec_static` /
  ``banded_matvec_pair_static``): a static shifted-window read of the
  sharded padded vector lowers to a halo ``collective-permute`` of
  ``bw`` boundary rows per neighbor, not a gather,
* CG dot products reduce with ``psum`` (inserted by XLA from the
  sharded operands).

The reference has no distributed backend at all (SURVEY.md §5.8).  The
per-shard chains run as XLA pair chains.
"""

import numpy as np

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P


def _space_spec(mesh, ndim, axis=0):
    names = [None] * ndim
    names[axis] = 'space'
    return NamedSharding(mesh, P(*names))


class ShardedBandedOperatorPair:
    """Operand-protocol two-float banded operator whose matvec is
    SPMD-shardable: input/output constrained on the first dof axis, the
    window accumulation fully static (halo exchanges instead of
    gathers).  Drop-in for
    :class:`pyiga_jax.ops.banded.BandedOperatorPair` under a mesh."""

    def __init__(self, D_pair, bws, ns, mesh):
        from ..ops import twofloat as tf
        from ..ops.banded import banded_matvec_pair_static
        self.bws, self.ns = tuple(bws), tuple(ns)
        self.shape = (int(np.prod(ns)), int(np.prod(ns)))
        self.operands = {'Dh': None if D_pair is None else D_pair[0],
                         'Dl': None if D_pair is None else D_pair[1]}
        bws_t, ns_t = self.bws, self.ns
        vec_spec = _space_spec(mesh, len(ns_t))

        def apply_with_operands(operands, x):
            x = jax.lax.with_sharding_constraint(
                x.reshape(ns_t), vec_spec).reshape(-1)
            xp = tf.df_from_f64(x)
            yh, yl = banded_matvec_pair_static(
                (operands['Dh'], operands['Dl']), xp, bws_t, ns_t)
            y = tf.df_to_f64((yh, yl))
            return jax.lax.with_sharding_constraint(
                y.reshape(ns_t), vec_spec).reshape(-1)

        self.apply_with_operands = apply_with_operands

    def matvec(self, x):
        return jax.jit(self.apply_with_operands)(self.operands, x)

    def __call__(self, x):
        return self.matvec(x)


class ShardedBandedOperator:
    """Single-precision companion of :class:`ShardedBandedOperatorPair`
    (the f32 Krylov operator of the sharded cg_ir)."""

    def __init__(self, D, bws, ns, mesh):
        from ..ops.banded import banded_matvec_static
        self.bws, self.ns = tuple(bws), tuple(ns)
        self.shape = (int(np.prod(ns)), int(np.prod(ns)))
        self.operands = {'D': D}
        bws_t, ns_t = self.bws, self.ns
        vec_spec = _space_spec(mesh, len(ns_t))

        def apply_with_operands(operands, x):
            x = jax.lax.with_sharding_constraint(
                x.reshape(ns_t), vec_spec).reshape(-1)
            y = banded_matvec_static(operands['D'], x, bws_t, ns_t)
            return jax.lax.with_sharding_constraint(
                y.reshape(ns_t), vec_spec).reshape(-1)

        self.apply_with_operands = apply_with_operands

    def matvec(self, x):
        return jax.jit(self.apply_with_operands)(self.operands, x)

    def __call__(self, x):
        return self.matvec(x)


def sharded_flagship_pipeline(asm, mesh, *, dirichlet=True, tol=1e-8,
                              inner_tol=1e-3, maxiter_inner=200):
    """Build the sharded assemble+solve program of the flagship headline
    config for a stiffness Gauss assembler.

    Returns ``(fn, args)``: ``fn(*args)`` is jittable and returns
    ``(Dh, Dl, u, info)`` — the banded two-float pair (sharded on the
    first dof axis), the refined solution of ``A u = b`` on the
    homogeneous-Dirichlet interior dofs, and the packed cg_ir info
    (decode with :func:`pyiga_jax.solvers.cg_ir_info`).

    Pipeline per call (all inside one jit, all SPMD over ``'space'``):
    two-float fields (grid axis 0 sharded) -> folded pair chains ->
    compact f64 -> banded pair (first dof axis sharded) -> fastdiag-
    preconditioned f32 CG with two-float f64 residual refinement.
    """
    from .. import solvers
    from ..assemblers import stiffness_fields_df_pair
    from ..mlmatrix import transpose_idx_for_bidx
    from ..ops import sumfac
    from ..ops import twofloat as tf
    from ..ops.banded import band_info, banded_gather_maps, \
        banded_from_compact_device
    from ..ops.fastdiag import fastdiag_precond_weighted, interior_dofs
    from ..ops.matfree import RestrictedOperator

    bws = band_info(asm.structure)
    ns = tuple(b[0] for b in asm.structure.bs)
    bsz = tuple(2 * bw + 1 for bw in bws)
    d = asm.dim
    fold_plan, _ = asm._fold()
    plan = tuple(fold_plan)
    ctperms = [jnp.asarray(transpose_idx_for_bidx(bx))
               for bx in asm.structure.bidx]
    tt = jax.tree_util.tree_map(
        lambda a: jnp.asarray(np.asarray(a, np.float64)),
        asm.tables.term_tables(asm.terms))
    maps = [jnp.asarray(m) for m in banded_gather_maps(asm.structure, bws)]
    gi = jax.tree_util.tree_map(
        lambda a: jnp.asarray(np.asarray(a, np.float64))
        if np.issubdtype(np.asarray(a).dtype, np.floating)
        else jnp.asarray(np.asarray(a)), asm._geo_inputs)

    free = interior_dofs(asm.kvs) if dirichlet else None
    n_full = int(np.prod(ns))
    op_hi = ShardedBandedOperatorPair(None, bws, ns, mesh)
    op_lo = ShardedBandedOperator(None, bws, ns, mesh)
    if free is not None:
        op_hi = RestrictedOperator(op_hi, free, n_full, ns=ns)
        op_lo = RestrictedOperator(op_lo, free, n_full, ns=ns)
    pc = fastdiag_precond_weighted(asm, dirichlet=dirichlet,
                                   dtype=np.float32)
    run_ir, hi_ops0, lo_ops0, pc_ops0 = solvers.cg_ir_traceable(
        op_hi, op_lo, tol=tol, inner_tol=inner_tol,
        maxiter_inner=maxiter_inner)

    grid_spec = _space_spec(mesh, d)
    data_spec = _space_spec(mesh, d)          # compact level-0 axis
    banded_spec = _space_spec(mesh, 2 * d, axis=d)   # (b..., n...): n_1

    def fn(gi, tt, ctperms, maps, b, hi_ops, lo_ops, pc_ops):
        fields = stiffness_fields_df_pair(gi)
        fields = [tuple(
            jax.lax.with_sharding_constraint(C, grid_spec) for C in pair)
            for pair in fields]
        data = sumfac.assemble_terms_folded_pair(tt, fields, plan, ctperms)
        data = jax.lax.with_sharding_constraint(data, data_spec)
        Dh, Dl = tf.df_from_f64(
            banded_from_compact_device(data, maps, bsz, ns))
        Dh = jax.lax.with_sharding_constraint(
            Dh.reshape(bsz + ns), banded_spec)
        Dl = jax.lax.with_sharding_constraint(
            Dl.reshape(bsz + ns), banded_spec)
        if free is not None:    # RestrictedOperator nests one 'inner' level
            hi_ops = dict(hi_ops, inner=dict(hi_ops['inner'],
                                             Dh=Dh, Dl=Dl))
            lo_ops = dict(lo_ops, inner=dict(lo_ops['inner'], D=Dh))
        else:
            hi_ops = dict(hi_ops, Dh=Dh, Dl=Dl)
            lo_ops = dict(lo_ops, D=Dh)
        u, info = run_ir(b, hi_ops, lo_ops, pc_ops)
        return Dh, Dl, u, info

    nb = len(free) if free is not None else n_full
    b = jnp.asarray(np.random.RandomState(0).rand(nb))
    args = (gi, tt, ctperms, maps, b, hi_ops0, lo_ops0, pc_ops0)
    return fn, args
