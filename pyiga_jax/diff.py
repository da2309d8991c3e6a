# -*- coding: utf-8 -*-
"""Differentiable and batched assembly with respect to the geometry.

The reference's assembly kernels are opaque compiled Cython
(/root/reference/pyiga/assemblers.pyx, /root/reference/pyiga/codegen/
cython.py): derivatives of assembled matrices with respect to the
geometry control points are unobtainable there.  In this framework the
whole pipeline — control points -> per-axis collocation tables ->
Jacobians -> coefficient fields -> sum-factorized contraction
(:mod:`~pyiga_jax.ops.geom`, :mod:`~pyiga_jax.ops.sumfac`) — is one
traced JAX program, so

* ``jax.grad`` / ``jax.jacfwd`` deliver exact *shape derivatives* of any
  scalar (or tensor) function of the assembled operator, and
* ``jax.vmap`` assembles a whole family of geometries in one batched
  device dispatch (parametric studies, UQ sampling, shape optimization
  line searches).

Entry point: :func:`assembly_coeff_fn` returns a pure function mapping
user-layout geometry coefficients (the layout of ``geo.coeffs``) to the
assembled compact data tensor.  Works for the predefined Gauss
assemblers (:class:`~pyiga_jax.assemblers.MassAssembler`,
:class:`~pyiga_jax.assemblers.StiffnessAssembler`, ...) and for generic
compiled vforms (:class:`~pyiga_jax.compile.VFormAssembler`); requires a
structured geometry (:class:`~pyiga_jax.geometry.BSplineFunc` or
:class:`~pyiga_jax.geometry.NurbsFunc` — for NURBS the coefficients are
the homogeneous ones, weights as the last component, and derivatives
are taken with respect to those homogeneous coordinates).

``mode='exact'`` (the default) is recommended for derivatives: it is
native floating-point arithmetic end to end.  The accelerator fast paths
('ozaki'/pair) are built from error-free f32 transformations whose
derivatives are formally defined but meaningless at the compensation
scale.
"""

import numpy as np

__all__ = ['assembly_coeff_fn', 'assembly_input_fn', 'implicit_cg_solve',
           'user_coeffs_to_internal']


def implicit_cg_solve(matvec, b, tol=1e-12, maxiter=None, precond=None):
    """Solve ``A x = b`` (A symmetric positive definite, given as the
    traceable function `matvec`) by conjugate gradients, with gradients
    by *implicit differentiation*: ``jax.lax.custom_linear_solve``
    replaces reverse-mode through the Krylov loop by ONE adjoint solve
    with the same operator — the memory- and FLOP-correct way to
    differentiate an optimization objective through a large linear solve
    (the dense alternative in ``examples/shape_derivative.py`` is for
    small systems only).

    `matvec` may close over differentiable quantities (e.g. the
    assembled data tensor from :func:`assembly_coeff_fn`); gradients
    flow to them through the implicit function theorem.  `precond`
    (optional traceable SPD preconditioner apply) accelerates both the
    forward and the adjoint solve."""
    import jax
    import jax.numpy as jnp

    if maxiter is None:
        maxiter = 10 * b.size     # total system size, not the last axis

    def cg(mv, rhs):
        # one traceable PCG implementation for the whole library: the
        # stopping criterion (||r|| <= tol * ||rhs||, x0 = 0) coincides
        from .solvers import cg_jit_traceable
        run, mv_ops, pc_ops = cg_jit_traceable(mv, tol=tol, maxiter=maxiter,
                                               precond=precond)
        x, _it = run(rhs, jnp.zeros_like(rhs), mv_ops, pc_ops)
        return x

    return jax.lax.custom_linear_solve(matvec, b, cg, symmetric=True)


def user_coeffs_to_internal(coeffs, is_nurbs, sdim):
    """Traceable layout change from user coefficients (``geo.coeffs``:
    grid axes leading, XYZ components last, NURBS homogeneous with the
    weight as the final component) to the internal level-ordered,
    component-leading layout of :func:`pyiga_jax.ops.geom.geo_eval_tables`.
    """
    import jax.numpy as jnp
    coeffs = jnp.asarray(coeffs)
    if coeffs.ndim == sdim:         # scalar-valued: add component axis
        coeffs = coeffs[..., None]
    if is_nurbs:
        coeffs = jnp.concatenate(
            (coeffs[..., -2::-1], coeffs[..., -1:]), axis=-1)
    else:
        coeffs = coeffs[..., ::-1]
    return jnp.moveaxis(coeffs, -1, 0)


def _structured_geo(asm):
    """(is_nurbs, sdim, coeffs0) of the assembler's geometry, or raise."""
    from . import geometry
    geo = asm.geo
    if isinstance(geo, geometry.NurbsFunc):
        return True, geo.sdim, np.asarray(geo.coeffs)
    if isinstance(geo, geometry.BSplineFunc):
        return False, geo.sdim, np.asarray(geo.coeffs)
    raise ValueError(
        'assembly_coeff_fn requires a structured geometry (BSplineFunc or '
        'NurbsFunc); %r is evaluated on the host and is not traceable'
        % type(geo).__name__)


def _gauss_assembler_fn(asm, mode):
    from .ops import sumfac
    from . import config

    is_nurbs, sdim, coeffs0 = _structured_geo(asm)
    gi0 = asm._geo_inputs
    key = 'geo_tables_nurbs' if is_nurbs else 'geo_tables_bsp'
    if key not in gi0:      # pragma: no cover - guarded by _structured_geo
        raise ValueError('assembler was set up with a host-evaluated '
                         'geometry; rebuild it with a structured geometry')
    dtype = config.get_dtype()
    tables = [np.asarray(t, dtype=dtype) for t in gi0[key]]
    weights = [np.asarray(w, dtype=dtype) for w in gi0['weights']]
    term_tables = [[np.asarray(t, dtype=dtype) for t in tabs]
                   for tabs in asm.tables.term_tables(asm.terms)]
    fold_plan, tperms = asm._fold()
    plan = tuple(fold_plan) if fold_plan is not None else None
    field_fn = asm.field_fn

    last_idx = sumfac.last_table_groups(term_tables)

    def fn(coeffs):
        import jax.numpy as jnp
        ci = user_coeffs_to_internal(coeffs, is_nurbs, sdim)
        ci = jnp.asarray(ci, dtype=dtype)   # match the production paths
        gi = {'weights': weights, key: tables, 'geo_coeffs': ci}
        fields = field_fn(gi)
        if plan is not None:
            return sumfac.assemble_terms_folded(term_tables, fields, plan,
                                                tperms, mode=mode,
                                                last_idx=last_idx)
        return sumfac.assemble_terms(term_tables, fields, mode=mode,
                                     last_idx=last_idx)

    return fn, coeffs0


def _vform_assembler_fn(asm, mode):
    is_nurbs, sdim, coeffs0 = _structured_geo(asm)
    if asm._geo_tables is None:     # pragma: no cover - same guard
        raise ValueError('assembler was set up with a host-evaluated '
                         'geometry; rebuild it with a structured geometry')
    inputs0, term_tables, tperms = asm._device_operands(mode)
    afn = asm._assembly_fn(mode)
    scalar = not asm.vf.vec

    def fn(coeffs):
        import jax.numpy as jnp
        ci = user_coeffs_to_internal(coeffs, is_nurbs, sdim)
        ci = jnp.asarray(ci, dtype=inputs0['geo_coeffs'].dtype)
        inputs = dict(inputs0, geo_coeffs=ci)
        blocks = afn(inputs, term_tables, tperms)
        if scalar:                      # scalar form: the single block
            return blocks[(None, None)]
        return blocks

    return fn, coeffs0


def assembly_input_fn(asm, name, mode='exact'):
    """Return ``(fn, x0)`` where ``fn(x)`` assembles the compact data
    tensor as a traced function of the named vform input or parameter —
    the differentiable knob for material/coefficient optimization
    (e.g. ``jax.grad`` of a compliance through a diffusion coefficient:
    topology optimization).

    * If `name` is a declared *parameter*, ``x`` is its value array and
      ``x0`` the current value.
    * If `name` is an *input field* given as a scalar parametric
      :class:`~pyiga_jax.geometry.BSplineFunc`, ``x`` is its spline
      coefficient array (layout of ``f.coeffs``, level-ordered grid
      axes) and the needed Gauss-grid values/derivatives are recomputed
      traceably from per-axis collocation tables.  First derivatives of
      the input are supported; physical, vector-valued, or
      second-derivative inputs raise ``NotImplementedError``.

    Only :class:`~pyiga_jax.compile.VFormAssembler` takes named inputs;
    scalar forms return the single data tensor, vector forms the block
    dict (as in :func:`assembly_coeff_fn`)."""
    import jax.numpy as jnp
    from .compile import VFormAssembler
    from . import geometry
    from .ops.basis import dense_collocation_tables
    from .ops.geom import tp_apply

    if not isinstance(asm, VFormAssembler):
        raise TypeError('assembly_input_fn requires a VFormAssembler '
                        '(predefined Gauss assemblers take no named inputs)')
    inputs0, term_tables, tperms = asm._device_operands(mode)
    afn = asm._assembly_fn(mode)
    scalar = not asm.vf.vec

    def run(inputs):
        blocks = afn(inputs, term_tables, tperms)
        return blocks[(None, None)] if scalar else blocks

    if name in asm._param_values:
        x0 = np.asarray(asm._param_values[name], dtype=float)

        def fn(x):
            arr = jnp.asarray(x, dtype=inputs0['param:' + name].dtype)
            return run(dict(inputs0, **{'param:' + name: arr}))
        return fn, x0

    if name == 'geo':
        raise ValueError("use assembly_coeff_fn for derivatives w.r.t. the "
                         'geometry control points')
    inps = [i for i in asm.vf.inputs if i.name == name]
    if not inps:
        raise ValueError('%r is not an input or parameter of this form'
                         % name)
    inp = inps[0]
    f = asm._input_values[name]
    if inp.physical:
        raise NotImplementedError('physical input fields are evaluated at '
                                  'mapped points; not traceable in coeffs')
    if inp.shape != () or not isinstance(f, geometry.BSplineFunc) or \
            isinstance(f, geometry.NurbsFunc):
        raise NotImplementedError('only scalar parametric BSplineFunc '
                                  'inputs are supported')
    orders = {sum(key[3]) for key in asm._needed_keys
              if key[0] == 'input_deriv' and key[1] == name}
    if any(o > 1 for o in orders):
        raise NotImplementedError('input derivatives of order > 1')

    d = len(f.kvs)
    tabs = [np.ascontiguousarray(B.swapaxes(-2, -1))       # (nd+1, Q, n)
            for B in dense_collocation_tables(f.kvs, asm.grid, numderiv=1)]
    val_tabs = [t[0] for t in tabs]
    der_tabs = [t[1] for t in tabs]
    x0 = np.asarray(f.coeffs, dtype=float)

    def fn(coeffs):
        c = jnp.asarray(coeffs)
        inputs = dict(inputs0)
        inputs['input:' + name] = tp_apply(val_tabs, c)
        if 1 in orders:
            # derivative axis in XYZ order: coordinate k = level axis d-1-k
            ders = [tp_apply([der_tabs[j] if j == d - 1 - k else val_tabs[j]
                              for j in range(d)], c) for k in range(d)]
            inputs['ideriv:%s:1' % name] = jnp.stack(ders, axis=0)
        return run(inputs)

    return fn, x0


def assembly_coeff_fn(asm, mode='exact'):
    """Return ``(fn, coeffs0)`` where ``fn(coeffs)`` assembles the compact
    data tensor (:class:`~pyiga_jax.mlmatrix.MLMatrix` layout) as a traced
    function of the geometry coefficients and ``coeffs0 = geo.coeffs`` is
    the assembler's current coefficient array.

    ``fn`` is a pure JAX function of `coeffs` (layout of ``geo.coeffs``):
    compose freely with ``jax.jit``, ``jax.grad``/``jax.jacfwd`` (shape
    derivatives), and ``jax.vmap`` (one batched dispatch for a family of
    geometries).  ``fn(coeffs0)`` equals ``asm.assemble().data``.

    `asm` is a predefined Gauss assembler
    (:class:`~pyiga_jax.assemblers.BaseGaussAssembler` subclass) or a
    compiled vform assembler (:class:`~pyiga_jax.compile.VFormAssembler`;
    scalar forms return the single data tensor, vector forms the block
    dict).  Quadrature grids and basis tables are fixed at `asm`'s
    construction; only the geometry coefficients vary.

    The basis/term tables enter as closed-over constants, which is the
    convenient form for optimization loops.  (Large problems should thread
    them as jit arguments instead — see the operand protocol of
    :func:`pyiga_jax.solvers.cg_jit`.)
    """
    from .assemblers import BaseGaussAssembler
    from .compile import VFormAssembler
    if isinstance(asm, BaseGaussAssembler):
        return _gauss_assembler_fn(asm, mode)
    if isinstance(asm, VFormAssembler):
        return _vform_assembler_fn(asm, mode)
    raise TypeError('unsupported assembler type %r' % type(asm).__name__)
