# -*- coding: utf-8 -*-
"""Predefined Gauss assemblers (mass, stiffness, ...) built on the
sum-factorization engine.

These replace the pre-generated Cython assembler classes of the reference
(/root/reference/pyiga/assemblers.pyx: MassAssembler2D/3D:26/1158,
StiffnessAssembler2D/3D:174/1324).  Each assembler:

1. sets up the tensor Gauss rule (``nqp = max(p)+1``) and the multilevel
   banded structure over the space,
2. evaluates the geometry coefficient fields on the Gauss grid on device
   (dense per-axis basis tables -> Jacobians -> det/inv, all inside one jit),
3. contracts the fields against per-axis basis pair tables (matmuls)
   into the compact data tensor.

The assembled matrix is returned as an :class:`~pyiga_jax.mlmatrix.MLMatrix`
over the same structure/ordering as the reference, so entries match
entrywise (float64 path: <= ~1e-14 relative).
"""

import numpy as np

from . import config
from .mlmatrix import MLStructure, transpose_idx_for_bidx
from .ops import geom, sumfac
from .bspline import KnotVector


################################################################################
# Field functions (module-level for stable jit caching)
################################################################################

def _geo_weight_jacinv(geo_inputs):
    """Common geometry preprocessing: returns ``(W, jacinv)`` where
    ``W = gauss_weight * |det J|`` on the grid and `jacinv` is the
    level-ordered inverse Jacobian in component-leading layout
    ``(d, d) + grid``."""
    if 'jac' in geo_inputs:
        jac = geo_inputs['jac']
    else:
        is_nurbs = 'geo_tables_nurbs' in geo_inputs
        key = 'geo_tables_nurbs' if is_nurbs else 'geo_tables_bsp'
        tables = geo_inputs[key]
        sdim = len(tables)
        _, jac = geom.geo_jacobian_field(tables, geo_inputs['geo_coeffs'],
                                         is_nurbs, sdim)
    det, jacinv = geom.det_and_inv(jac)
    import jax.numpy as jnp
    W = geom.gauss_weight_field(geo_inputs['weights']) * jnp.abs(det)
    return W, jacinv


def mass_fields(geo_inputs):
    """Mass: single field ``W`` (reference: assemblers.pyx MassAssembler)."""
    W, _ = _geo_weight_jacinv(geo_inputs)
    return [W]


def stiffness_fields(geo_inputs):
    """Stiffness: fields ``B_ab = W * (J^-1 J^-T)_ab`` for all axis pairs
    (a, b) in level order, row-major (reference: stiffness_vf, vform.py:1746).
    Computed per (a, b) with component-leading indexing — no grid x d x d
    intermediate."""
    W, jacinv = _geo_weight_jacinv(geo_inputs)
    d = jacinv.shape[0]
    fields = []
    for a in range(d):
        for b in range(d):
            Bab = sum(jacinv[a, k] * jacinv[b, k] for k in range(d))
            fields.append(W * Bab)
    return fields


def _geo_jac_pairs(geo_inputs):
    """Two-float Jacobian of the geometry on the Gauss grid (nested
    ``[a][b]`` pair matrix); covers B-spline, NURBS, and host-evaluated
    geometries, in f32 arithmetic only."""
    from .ops import twofloat as tf
    if 'jac' in geo_inputs:
        jac = geo_inputs['jac']
        d = jac.shape[0]
        return [[tf.df_from_f64(jac[a, b]) for b in range(d)]
                for a in range(d)]
    is_nurbs = 'geo_tables_nurbs' in geo_inputs
    key = 'geo_tables_nurbs' if is_nurbs else 'geo_tables_bsp'
    tables = geo_inputs[key]
    _, jp = geom.geo_jacobian_field_df(tables, geo_inputs['geo_coeffs'],
                                       is_nurbs, len(tables))
    return jp


def mass_fields_df_pair(geo_inputs):
    """Mass coefficient field ``W = gauss_weight * |det J|`` as a two-float
    f32 pair — the fields of ``mode='ozaki'`` for :class:`MassAssembler`
    (values match :func:`mass_fields` to ~1e-13 relative)."""
    from .ops import twofloat as tf
    det = geom.det_df_pairs(_geo_jac_pairs(geo_inputs))
    gw = tf.df_from_f64(geom.gauss_weight_field(geo_inputs['weights']))
    return [tf.df_mul(gw, tf.df_abs(det))]


def stiffness_fields_df_pair(geo_inputs):
    """Stiffness coefficient fields as two-float f32 pairs
    (:mod:`~pyiga_jax.ops.twofloat`): same values as
    :func:`stiffness_fields` to ~1e-13 relative, computed entirely in fused
    f32 pair arithmetic for the pair-chained Ozaki assembly
    (:func:`~pyiga_jax.ops.sumfac.assemble_terms_folded_pair`).  The whole
    pipeline — geometry Jacobian, det/inv, weight products — runs in fused
    f32 pair arithmetic."""
    from .ops import twofloat as tf

    jp = _geo_jac_pairs(geo_inputs)
    d = len(jp)
    det, inv = geom.det_and_inv_df_pairs(jp)
    gw = tf.df_from_f64(geom.gauss_weight_field(geo_inputs['weights']))
    W = tf.df_mul(gw, tf.df_abs(det))
    fields = []
    for a in range(d):
        for b in range(d):
            Bab = tf.df_sum([tf.df_mul(inv[a][k], inv[b][k])
                             for k in range(d)])
            fields.append(tf.df_mul(W, Bab))
    return fields


################################################################################
# Assembler classes
################################################################################

def _unit(d, k):
    e = d * [0]
    e[k] = 1
    return tuple(e)


class BaseGaussAssembler:
    """Shared setup for Gauss assemblers over a TP spline space with geometry."""

    arity = 2
    numderiv = 1

    def __init__(self, kvs, geo, nqp=None):
        if isinstance(kvs, KnotVector):
            kvs = (kvs,)
        self.kvs = self.kvs0 = self.kvs1 = tuple(kvs)
        self.dim = len(self.kvs)
        self.geo = geo
        assert geo.sdim == self.dim, 'Geometry has wrong dimension'
        self.grid, self.gweights = sumfac.quadrature_for(self.kvs, nqp)
        self.structure = MLStructure.from_kvs(self.kvs0, self.kvs1)
        self.tables = sumfac.SpaceTables(self.kvs0, self.kvs1, self.grid,
                                         self.structure.bidx, self.numderiv)
        self._geo_inputs = self._make_geo_inputs()

    def _make_geo_inputs(self):
        setup = geom.geo_eval_tables(self.geo, self.grid, numderiv=1)
        inputs = {'weights': [np.asarray(w) for w in self.gweights]}
        if setup is None:
            # unstructured geometry function: evaluate Jacobian on host
            inputs['jac'] = geom.host_jacobian_levelorder(self.geo, self.grid)
        else:
            tables, coeffs, is_nurbs = setup
            key = 'geo_tables_nurbs' if is_nurbs else 'geo_tables_bsp'
            inputs[key] = [t for t in tables]
            inputs['geo_coeffs'] = coeffs
        return inputs

    # subclasses define: terms (list of (du, dv)), field_fn (module function)

    # subclasses with a symmetric coefficient field (C[du,dv] == C[dv,du])
    # set this to enable symmetric-term folding in assemble()
    symmetric_fields = False

    def _fold(self):
        if not (self.symmetric_fields and self.kvs0 == self.kvs1):
            return None, None
        plan = sumfac.symmetric_fold_plan(self.terms)
        if plan is None or all(not m for _, m in plan):
            return None, None
        tperms = [transpose_idx_for_bidx(bx) for bx in self.structure.bidx]
        return plan, tperms

    # two-float f32 field pipeline for mode='ozaki' (set by subclasses)
    pair_field_fn = None

    def assemble(self, mode=None):
        """Assemble the compact data tensor and return it as an MLMatrix.

        ``mode='ozaki'`` computes the float64 contractions from f32
        arithmetic only: two-float f32 coefficient fields and pair-chained
        Ozaki contractions (bf16 chunk products with exact f32
        accumulation), assembled accuracy ~1e-13 relative.  The default is
        :func:`~pyiga_jax.config.default_assembly_mode` (native 'exact')."""
        if mode is None:
            mode = config.default_assembly_mode()
        assert mode in ('exact', 'ozaki'), "mode must be 'exact' or 'ozaki'"
        term_tables = self.tables.term_tables(self.terms)
        fold_plan, tperms = self._fold()
        if mode == 'ozaki':
            config.require_twofloat_platform("mode='ozaki'")
        if mode == 'ozaki' and self.pair_field_fn is not None:
            data = sumfac.run_matrix_assembly_pair(
                self.pair_field_fn, self._geo_inputs, term_tables,
                fold_plan, tperms)
        else:
            data = sumfac.run_matrix_assembly(self.field_fn,
                                              self._geo_inputs,
                                              term_tables, fold_plan, tperms,
                                              mode=mode)
        return self.structure.make_mlmatrix(
            data=np.asarray(data, dtype=np.float64))

    def assemble_windowed(self):
        """Assemble via windowed pair tables — each basis pair contracts only
        the ``(p+1)*nqp`` quadrature points of its support window instead of
        the full per-axis Gauss grid (~(2p+1)x less arithmetic, at the
        price of a gather; :meth:`assemble` stays the default).  Returns an
        MLMatrix equal to :meth:`assemble` up to rounding."""
        from .ops.banded import band_info
        bws = band_info(self.structure)
        assert bws is not None, \
            'windowed assembly requires a regularly banded space'
        wtabs, fss = self.tables.windowed_term_tables(self.terms)
        fold_plan, _ = self._fold()
        tperms = None
        if fold_plan is not None:
            ns = tuple(b[0] for b in self.structure.bs)
            tperms = [sumfac.banded_transpose_perm(n, bw)
                      for n, bw in zip(ns, bws)]
        flat = sumfac.run_windowed_assembly(
            self.field_fn, self._geo_inputs, wtabs, fss, self.tables.nqps,
            fold_plan, tperms)
        # banded-flat -> compact: separable takes
        cmaps = sumfac.compact_from_banded_maps(self.structure, bws)
        data = np.asarray(flat, dtype=np.float64)[np.ix_(*cmaps)]
        return self.structure.make_mlmatrix(data=data)

    def assemble_banded(self):
        """Assemble directly into the regular banded layout and return a
        device-resident :class:`~pyiga_jax.ops.banded.BandedOperator` (the
        fast path for matrix-free solvers; data never leaves the device).
        The contractions run in the configured dtype
        (:func:`~pyiga_jax.config.get_dtype`)."""
        from .ops.banded import BandedOperator, band_info
        bws = band_info(self.structure)
        assert bws is not None, \
            'space is not regularly banded (repeated interior knots?)'
        ns = tuple(b[0] for b in self.structure.bs)
        bsz = tuple(2 * bw + 1 for bw in bws)
        tabs = self.tables.banded_term_tables(self.terms, bws)
        D = sumfac.run_banded_assembly(self.field_fn, self._geo_inputs,
                                       tabs, bsz, ns)
        return BandedOperator(D, bws, ns)


class MassAssembler(BaseGaussAssembler):
    """Mass matrix assembler: ``A[i,j] = int B_j B_i |det J| dx``."""

    field_fn = staticmethod(mass_fields)
    pair_field_fn = staticmethod(mass_fields_df_pair)

    def __init__(self, kvs, geo, nqp=None):
        super().__init__(kvs, geo, nqp)
        zero = self.dim * (0,)
        self.terms = [(zero, zero)]


class StiffnessAssembler(BaseGaussAssembler):
    """Stiffness matrix assembler:
    ``A[i,j] = int (J^-1 J^-T grad B_j) . grad B_i |det J| dx``."""

    field_fn = staticmethod(stiffness_fields)
    pair_field_fn = staticmethod(stiffness_fields_df_pair)
    symmetric_fields = True      # B = W J^-1 J^-T is symmetric

    def __init__(self, kvs, geo, nqp=None):
        super().__init__(kvs, geo, nqp)
        d = self.dim
        # order must match stiffness_fields: (a, b) row-major in level order
        self.terms = [(_unit(d, a), _unit(d, b))
                      for a in range(d) for b in range(d)]


# dimension-suffixed aliases for reference-API parity
class MassAssembler2D(MassAssembler):
    def __init__(self, kvs, geo, nqp=None):
        assert len(kvs) == 2
        super().__init__(kvs, geo, nqp)


class MassAssembler3D(MassAssembler):
    def __init__(self, kvs, geo, nqp=None):
        assert len(kvs) == 3
        super().__init__(kvs, geo, nqp)


class StiffnessAssembler2D(StiffnessAssembler):
    def __init__(self, kvs, geo, nqp=None):
        assert len(kvs) == 2
        super().__init__(kvs, geo, nqp)


class StiffnessAssembler3D(StiffnessAssembler):
    def __init__(self, kvs, geo, nqp=None):
        assert len(kvs) == 3
        super().__init__(kvs, geo, nqp)


################################################################################
# VForm-derived predefined assemblers (reference: assemblers.pyx pre-generated
# classes for the standard forms; here they are lazily compiled plans)
################################################################################

def _vform_asm_alias(vf_factory, dim):
    """Create a named assembler class for a predefined vform at a fixed dim."""
    from .compile import compile_vform

    class _Alias:
        def __new__(cls, kvs, *args, **kwargs):
            base = compile_vform(vf_factory(dim))
            return base(kvs, *args, **kwargs)

        @staticmethod
        def inputs():
            return compile_vform(vf_factory(dim)).inputs()

        @staticmethod
        def parameters():
            return compile_vform(vf_factory(dim)).parameters()

    return _Alias


def __getattr__(name):
    """Lazily provide the reference's predefined assembler names
    (HeatAssembler_ST2D, WaveAssembler_ST3D, DivDivAssembler2D,
    L2FunctionalAssembler3D, ...)."""
    from . import vform as vf_mod
    table = {
        'HeatAssembler_ST': vf_mod.heat_st_vf,
        'WaveAssembler_ST': vf_mod.wave_st_vf,
        'DivDivAssembler': vf_mod.divdiv_vf,
        'L2FunctionalAssembler': lambda d: vf_mod.L2functional_vf(d),
        'L2FunctionalAssemblerPhys':
            lambda d: vf_mod.L2functional_vf(d, physical=True),
    }
    for prefix, factory in table.items():
        if name.startswith(prefix) and name[len(prefix):] in ('1D', '2D', '3D'):
            dim = int(name[len(prefix)])
            cls = _vform_asm_alias(factory, dim)
            cls.__name__ = cls.__qualname__ = name
            # cache on the module so repeated accesses (and is-identity
            # checks) see ONE class object
            globals()[name] = cls
            return cls
    raise AttributeError(name)
