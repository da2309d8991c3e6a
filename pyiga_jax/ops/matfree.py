# -*- coding: utf-8 -*-
"""Matrix-free operator application by sum factorization.

Instead of multiplying with an assembled (banded) matrix, the operator is
applied through quadrature each time:

    y = sum_t  B_test(dv_t)^T [ C_t  *  B_trial(du_t) x ]

where ``B(d) x`` evaluates the d-th derivative combination of the trial
function on the tensor Gauss grid (a chain of per-axis (Q_k, n_k)
matmuls), ``C_t`` are the precomputed coefficient fields (geometry data x
weights, resident on the device), and the transposed test chain accumulates
back to coefficients.  This is mathematically identical to the assembled
matvec (same quadrature), needs no matrix in memory, and runs entirely as
matmuls + elementwise multiplies — the canonical matrix-free FEM formulation,
replacing both the assembled CSR matvec of the reference and the compact
banded matvec for Krylov solvers.
"""

import numpy as np
import jax
import jax.numpy as jnp

from .. import config
from .sumfac import _dot_precision


def _forward_chain(tabs, X):
    """Contract coefficients (n_1..n_d) with per-axis (Q_k, n_k) tables."""
    for k in range(len(tabs)):
        X = jnp.moveaxis(jnp.tensordot(tabs[k], X, axes=(1, k),
                                       precision=_dot_precision(X.dtype)),
                         0, k)
    return X


def _backward_chain(tabs, X):
    """Adjoint: contract grid values (Q_1..Q_d) with (Q_k, n_k) tables
    transposed."""
    for k in range(len(tabs)):
        X = jnp.moveaxis(jnp.tensordot(tabs[k], X, axes=(0, k),
                                       precision=_dot_precision(X.dtype)),
                         0, k)
    return X


def box_restriction(free_dofs, ns):
    """If the raveled `free_dofs` indices form an axis-aligned box in the
    `ns` grid (e.g. the interior dofs of an 'all'-Dirichlet problem), return
    ``(los, box_shape)``; else None.  A box restriction is applied with a
    dynamic_update_slice / static slice instead of a scatter/gather."""
    free = np.asarray(free_dofs)
    if free.ndim != 1 or len(free) == 0:
        return None
    idx = np.unravel_index(free, ns)
    axes = [np.unique(ix) for ix in idx]
    shape = tuple(len(a) for a in axes)
    if len(free) != int(np.prod(shape)):
        return None
    for a in axes:
        if a[-1] - a[0] + 1 != len(a):
            return None
    grid = np.stack(np.meshgrid(*axes, indexing='ij'), 0).reshape(len(ns), -1)
    if not np.array_equal(free, np.ravel_multi_index(tuple(grid), ns)):
        return None
    return tuple(int(a[0]) for a in axes), shape


def matfree_apply(trial_tabs, test_tabs, fields, trial_of_term, test_of_term,
                  field_of_term, ns_in, ns_out, x):
    """Traced operator application.

    Args:
        trial_tabs / test_tabs: lists of per-axis table chains, one chain per
            unique derivative combination; each chain is a list of (Q_k, n_k)
            arrays.
        fields: list of coefficient-field grid arrays.
        trial_of_term / test_of_term / field_of_term: per term, the indices
            into the above lists.
        ns_in / ns_out: trial/test dof shapes.
        x: raveled input vector.
    """
    X = x.reshape(ns_in)
    # forward-evaluate each needed trial derivative combination once
    U = [None] * len(trial_tabs)
    for t in set(trial_of_term):
        U[t] = _forward_chain(trial_tabs[t], X)
    # accumulate grid-space contributions per unique test combination
    Z = [None] * len(test_tabs)
    for term in range(len(trial_of_term)):
        contrib = fields[field_of_term[term]] * U[trial_of_term[term]]
        s = test_of_term[term]
        Z[s] = contrib if Z[s] is None else Z[s] + contrib
    # adjoint test chains back to coefficients
    y = None
    for s, Zs in enumerate(Z):
        if Zs is None:
            continue
        contrib = _backward_chain(test_tabs[s], Zs)
        y = contrib if y is None else y + contrib
    return y.reshape(-1)


# jitted field evaluators per (module-level, stable) field function: a
# fresh jax.jit per operator instance would re-trace and re-compile the
# same evaluation for every operator built
_FIELDS_JIT_CACHE = {}


def _jit_fields(fn):
    g = _FIELDS_JIT_CACHE.get(fn)
    if g is None:
        g = _FIELDS_JIT_CACHE[fn] = jax.jit(fn)
    return g


class MatrixFreeOperator:
    """Device-resident matrix-free operator for a sum-factorization
    assembler (``BaseGaussAssembler`` or a compiled VForm assembler for
    scalar arity-2 forms).

    Supports Dirichlet restriction: pass `free_dofs` (raveled indices) to get
    the operator on the free dofs (zero-extension / restriction built in)."""

    def __init__(self, asm, free_dofs=None, dtype=None):
        dtype = dtype if dtype is not None else config.get_dtype()
        d = asm.dim
        if hasattr(asm, 'terms'):       # predefined Gauss assembler
            terms = asm.terms
            fields_fn = asm.field_fn
            geo_inputs = asm._geo_inputs
            self._fields = _jit_fields(fields_fn)(jax.tree_util.tree_map(
                lambda a: jnp.asarray(np.asarray(a), dtype=dtype)
                if np.issubdtype(np.asarray(a).dtype, np.floating)
                else jnp.asarray(a), geo_inputs))
        else:                           # compiled vform assembler
            assert asm.arity == 2 and not asm.vf.vec
            terms = [(tuple(reversed(su[1])), tuple(reversed(sv[1])))
                     for su, sv in asm.combos]
            self._fields = asm._device_fields(dtype=dtype)

        # unique trial/test derivative combos -> table chains (Q_k, n_k)
        trial_combos = sorted(set(du for du, dv in terms))
        test_combos = sorted(set(dv for du, dv in terms))
        tt = asm.tables

        def chain(space_tabs, combo):
            return [jnp.asarray(space_tabs[k][combo[k]].T, dtype=dtype)
                    for k in range(d)]

        self._trial_tabs = [chain(tt.trial, c) for c in trial_combos]
        self._test_tabs = [chain(tt.test, c) for c in test_combos]
        self._trial_of_term = [trial_combos.index(du) for du, dv in terms]
        self._test_of_term = [test_combos.index(dv) for du, dv in terms]
        self._field_of_term = list(range(len(terms)))
        self._fields = [jnp.asarray(C, dtype=dtype) for C in self._fields]

        self.ns_in = tuple(b[1] for b in asm.structure.bs)
        self.ns_out = tuple(b[0] for b in asm.structure.bs)
        n_in = int(np.prod(self.ns_in))
        n_out = int(np.prod(self.ns_out))
        self.shape = (n_out, n_in)

        self._free = (jnp.asarray(np.asarray(free_dofs, dtype=np.int64))
                      if free_dofs is not None else None)
        box = (box_restriction(free_dofs, self.ns_in)
               if free_dofs is not None else None)
        if free_dofs is not None:
            self.shape = (len(free_dofs), len(free_dofs))
            if box is not None:
                self._free = None       # box fast path needs no index array

        # IMPORTANT: the large arrays are *operands*, threaded through jit as
        # arguments — never closed over (closure constants get baked into the
        # serialized HLO, which breaks remote compilation for 100MB+ fields).
        self.operands = {
            'trial_tabs': self._trial_tabs,
            'test_tabs': self._test_tabs,
            'fields': self._fields,
            'free': self._free,
        }
        tot, sot, fot = (tuple(self._trial_of_term),
                         tuple(self._test_of_term),
                         tuple(self._field_of_term))
        ns_in, ns_out = self.ns_in, self.ns_out

        def apply_with_operands(operands, x):
            free = operands['free']
            if box is not None:
                los, bshape = box
                x = jax.lax.dynamic_update_slice(
                    jnp.zeros(ns_in, dtype=x.dtype), x.reshape(bshape),
                    los).reshape(-1)
            elif free is not None:
                x = jnp.zeros(n_in, dtype=x.dtype).at[free].set(x)
            y = matfree_apply(operands['trial_tabs'], operands['test_tabs'],
                              operands['fields'], tot, sot, fot,
                              ns_in, ns_out, x)
            if box is not None:
                los, bshape = box
                y = jax.lax.dynamic_slice(y.reshape(ns_out), los,
                                          bshape).reshape(-1)
            elif free is not None:
                y = y[free]
            return y

        self.apply_with_operands = apply_with_operands
        self._jit_apply = jax.jit(apply_with_operands)

    def matvec(self, x):
        return self._jit_apply(self.operands, x)

    def __call__(self, x):
        return self.matvec(x)


class RestrictedOperator:
    """Restrict any operand-protocol operator on the full TP space to a free
    dof subset (homogeneous Dirichlet elimination): the input is scattered
    into a zero full vector, the operator applied, and the free rows taken.
    Equivalent to ``A[free][:, free]`` for symmetric elimination
    (reference: assemble.py RestrictedLinearSystem restriction matrices)."""

    def __init__(self, op, free_dofs, n_full, ns=None):
        free = jnp.asarray(np.asarray(free_dofs, dtype=np.int64))
        self.shape = (len(free_dofs), len(free_dofs))
        inner_fn = op.apply_with_operands
        if ns is None:
            ns = getattr(op, 'ns', None)
        box = box_restriction(free_dofs, ns) if ns is not None else None
        if box is not None:
            free = None
        self.operands = {'inner': op.operands, 'free': free}

        def apply_with_operands(operands, x):
            if box is not None:
                los, bshape = box
                xf = jax.lax.dynamic_update_slice(
                    jnp.zeros(ns, dtype=x.dtype), x.reshape(bshape),
                    los).reshape(-1)
                y = inner_fn(operands['inner'], xf)
                return jax.lax.dynamic_slice(y.reshape(ns), los,
                                             bshape).reshape(-1)
            xf = jnp.zeros(n_full, dtype=x.dtype).at[operands['free']].set(x)
            return inner_fn(operands['inner'], xf)[operands['free']]

        self.apply_with_operands = apply_with_operands
        self._jit_apply = jax.jit(apply_with_operands)

    def matvec(self, x):
        return self._jit_apply(self.operands, x)

    def __call__(self, x):
        return self.matvec(x)
