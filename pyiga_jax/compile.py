# -*- coding: utf-8 -*-
"""Lowering of variational forms to device assembly plans.

This is the replacement for the reference's Cython code generator + JIT
compiler (/root/reference/pyiga/codegen/cython.py, compile.py).  Instead of
generating source code, :func:`compile_vform` produces an assembler class
whose ``assemble()`` traces the form's integrand numerically:

1. geometry/input fields are computed on the Gauss grid inside jit
   (:mod:`pyiga_jax.ops.geom`);
2. the integrand is evaluated once per basis-derivative/component
   combination with the corresponding basis *seed* set to one (linearity of
   the form makes this exact); structurally zero combinations are pruned by
   a one-shot random probe on a tiny grid;
3. the resulting coefficient fields are contracted against per-axis basis
   pair tables by the sum-factorization engine
   (:mod:`pyiga_jax.ops.sumfac`), yielding the compact multilevel-banded
   data tensor directly.

Compiled plans are cached by ``vf.hash()`` (the analog of the reference's
in-process VForm-hash cache, compile.py:82).  Persistent cross-process
caching comes from XLA's compilation cache, wired to a disk directory at
package import (:func:`pyiga_jax.config.compile_cache_dir`, the analog of
the reference's on-disk module cache, compile.py:58-73); wipe it with
``scripts/clear_cache.py``."""

import itertools

import numpy as np

from . import utils
from .bspline import KnotVector
from .mlmatrix import MLStructure
from .ops import geom, sumfac


################################################################################
# Seed enumeration
################################################################################

def _derivs_upto(dim, order):
    """All derivative multi-indices (XYZ order) with total order <= order,
    sorted by total order then lexicographically."""
    out = []
    for total in range(order + 1):
        for D in itertools.product(range(total + 1), repeat=dim):
            if sum(D) == total:
                out.append(D)
    return out


def _seeds_for(bfun_slot, numcomp, dim, order):
    """Seed list for one basis function: (component, D) pairs."""
    comps = [None] if numcomp is None else list(range(numcomp))
    return [(c, D) for c in comps for D in _derivs_upto(dim, order)]


################################################################################
# Evaluation context
################################################################################

class AsmContext:
    """Resolves field keys and basis seeds during integrand evaluation.

    `arrays` maps string keys to (traced) grid arrays; geometry-derived
    fields are computed lazily from the raw jac/inv/hess arrays."""

    def __init__(self, vf, arrays, seed_u=None, seed_v=None):
        self.vf = vf
        self.arrays = arrays
        self.seed_u = seed_u    # (component, D) or None
        self.seed_v = seed_v
        self._cache = {}

    def basis_seed(self, bfun, D):
        slot = 0 if bfun.name == 'u' else 1
        if self.vf.arity == 1:
            seed = self.seed_v      # single function: the test function
        else:
            seed = self.seed_u if slot == 0 else self.seed_v
        if seed is None:
            return 0.0
        comp, Ds = seed
        if bfun.component is not None and bfun.component != comp:
            return 0.0
        return 1.0 if tuple(D) == tuple(Ds) else 0.0

    def field(self, key):
        val = self._cache.get(key)
        if val is None:
            val = self._compute(key)
            self._cache[key] = val
        return val

    def _compute(self, key):
        vf, arrays = self.vf, self.arrays
        kind = key[0]
        d = vf.dim
        gd = vf.geo_dim

        if kind == 'gw':
            return geom.gauss_weight_field(arrays['weights'])

        if kind == '_measure':
            if key[1] == 'dx':
                return vf.W.eval(self)
            return vf.SW.eval(self)

        if kind == 'jacinv':
            m, k = key[1], key[2]
            inv_lvl = self.field(('_jacinv_lvl',))
            return inv_lvl[d - 1 - m, d - 1 - k]

        if kind == '_jacinv_lvl':
            jac_lvl = self.field(('_jac_lvl',))
            _, inv_lvl = geom.det_and_inv(jac_lvl)
            return inv_lvl

        if kind == '_jac_lvl':
            return arrays['geo_jac_lvl']

        if kind == '_geoval_lvl':
            return arrays['geo_val_lvl']

        if kind == '_geohess_lvl':
            return arrays['geo_hess_lvl']

        if kind == 'param':
            _, name, idx = key
            arr = arrays['param:' + name]
            return arr[idx] if idx != () else arr

        if kind == 'input':
            _, name, comp = key
            if name == 'geo':
                return self.field(('_geoval_lvl',))[gd - 1 - comp[0]]
            return arrays['input:' + name][comp]

        if kind == 'input_deriv':
            _, name, comp, D = key
            order = sum(D)
            if name == 'geo':
                m = gd - 1 - comp[0]
                if order == 1:
                    i = D.index(1)
                    return self.field(('_jac_lvl',))[m, d - 1 - i]
                if order == 2:
                    idx = [k for k, nk in enumerate(D) for _ in range(nk)]
                    i, j = idx
                    H = self.field(('_geohess_lvl',))
                    return H[m, d - 1 - i, d - 1 - j]
                raise NotImplementedError('geometry derivatives of order > 2')
            arr = arrays['ideriv:%s:%d' % (name, order)]
            if order == 1:
                return arr[comp + (D.index(1),)]
            if order == 2:
                idx = [k for k, nk in enumerate(D) for _ in range(nk)]
                i, j = sorted(idx)
                # symmetric linearized index, components in XYZ order
                # matching BSplineFunc.grid_hessian: pairs (i,j), i<=j,
                # enumerated as xx, xy, xz, yy, yz, zz
                sym = _sym_index(d, i, j)
                return arr[comp + (sym,)]
            raise NotImplementedError('input derivatives of order > 2')

        raise KeyError('unknown field key %r' % (key,))


def _sym_index(d, i, j):
    """Index of (i, j), i <= j, in the linearized symmetric Hessian layout
    (xx, xy, xz, yy, yz, zz for d=3)."""
    # number of entries before row i: d + (d-1) + ... + (d-i+1)
    before = i * d - (i * (i - 1)) // 2
    return before + (j - i)


class PairAsmContext(AsmContext):
    """AsmContext whose fields are two-float f32 pairs
    (:class:`~pyiga_jax.ops.twofloat.DF`): the whole integrand evaluates in
    fused f32 pair arithmetic with **no emulated-f64 elementwise ops** — the
    f64 fast path for generic compiled vforms, matching the treatment the
    reference's codegen gives every form
    (/root/reference/pyiga/codegen/cython.py:673 precompute_fields).

    Array leaves arrive pre-split as (hi, lo) f32 pairs (see
    ``VFormAssembler._device_inputs_pair``); geometry values/Jacobians come
    from :func:`~pyiga_jax.ops.geom.geo_jacobian_field_df` and det/inv from
    :func:`~pyiga_jax.ops.geom.det_and_inv_df_pairs`.  Forms that need
    geometry Hessians or transcendental builtins are gated out upstream
    (``_supports_pair_eval``)."""

    def _compute(self, key):
        from .ops import twofloat as tf
        DF = tf.DF
        vf, arrays = self.vf, self.arrays
        kind = key[0]
        d = vf.dim
        gd = vf.geo_dim

        if kind == 'gw':
            W = DF(*arrays['weights'][0])
            for w in arrays['weights'][1:]:
                W = DF(W.hi[..., None], W.lo[..., None]) * DF(*w)
            return W

        if kind == '_measure':
            if key[1] == 'dx':
                return vf.W.eval(self)
            return vf.SW.eval(self)

        if kind == 'jacinv':
            m, k = key[1], key[2]
            inv = self.field(('_jacinv_lvl',))
            return DF(*inv[d - 1 - m][d - 1 - k])

        if kind == '_jacinv_lvl':
            _, jac = self.field(('_geo_pairs',))
            _, inv = geom.det_and_inv_df_pairs(jac)
            return inv

        if kind == '_geo_pairs':
            # (val, jac) as nested pair lists, [c] and [c][k] (level order)
            if 'geo_jac_pair' in arrays:
                return arrays.get('geo_val_pair'), arrays['geo_jac_pair']
            return geom.geo_jacobian_field_df(
                arrays['geo_tables'], arrays['geo_coeffs'],
                arrays['geo_is_nurbs'], d)

        if kind == 'param':
            _, name, idx = key
            hi, lo = arrays['param:' + name]
            return DF(hi[idx], lo[idx]) if idx != () else DF(hi, lo)

        if kind == 'input':
            _, name, comp = key
            if name == 'geo':
                val, _ = self.field(('_geo_pairs',))
                return DF(*val[gd - 1 - comp[0]])
            hi, lo = arrays['input:' + name]
            return DF(hi[comp], lo[comp])

        if kind == 'input_deriv':
            _, name, comp, D = key
            order = sum(D)
            if name == 'geo':
                m = gd - 1 - comp[0]
                if order == 1:
                    i = D.index(1)
                    _, jac = self.field(('_geo_pairs',))
                    return DF(*jac[m][d - 1 - i])
                raise NotImplementedError(
                    'geometry Hessians have no two-float path (gated by '
                    '_supports_pair_eval)')
            arr = arrays['ideriv:%s:%d' % (name, order)]
            hi, lo = arr
            if order == 1:
                idx = comp + (D.index(1),)
                return DF(hi[idx], lo[idx])
            if order == 2:
                ii = [k for k, nk in enumerate(D) for _ in range(nk)]
                i, j = sorted(ii)
                idx = comp + (_sym_index(d, i, j),)
                return DF(hi[idx], lo[idx])
            raise NotImplementedError('input derivs of order > 2')

        raise KeyError('unknown field key %r' % (key,))


def _physical_field_derivs(f, geo, grid, comp_shape, with_hessian=False):
    """Physical gradient (and optionally Hessian) of the physical-coordinate
    field `f` at the mapped Gauss points of `grid`.

    Differentiates `f` itself: with JAX forward-mode autodiff when `f`
    traces, else by central finite differences on the physical coordinates.
    Returns ``(grad, hess)`` with shapes ``grid + comp_shape + (sdim,)``
    and ``grid + comp_shape + (nsym,)`` (symmetric pairs i<=j in XYZ
    order); `hess` is None unless requested."""
    pts = np.asarray(geo.grid_eval(grid))       # grid + (sdim,), XYZ comps
    grid_shape, sdim = pts.shape[:-1], pts.shape[-1]
    flat_pts = pts.reshape(-1, sdim)

    def fd_derivs():
        coords = [flat_pts[:, k] for k in range(sdim)]
        scale = [max(1.0, float(np.abs(c).max())) for c in coords]

        def ev(shifts):
            c = [ck + dk for ck, dk in zip(coords, shifts)]
            vals = f(*c)
            if isinstance(vals, tuple):
                vals = np.stack([np.broadcast_to(v, coords[0].shape)
                                 for v in vals], axis=-1)
            return np.broadcast_to(np.asarray(vals, dtype=float),
                                   coords[0].shape + comp_shape)

        zero = sdim * (0.0,)

        def shift(k, h):
            s = list(zero)
            s[k] = h
            return s

        g = np.empty((flat_pts.shape[0],) + comp_shape + (sdim,))
        steps = [1e-6 * s for s in scale]
        for k in range(sdim):
            h = steps[k]
            g[..., k] = (ev(shift(k, h)) - ev(shift(k, -h))) / (2 * h)
        if not with_hessian:
            return g, None
        nsym = (sdim * (sdim + 1)) // 2
        H = np.empty((flat_pts.shape[0],) + comp_shape + (nsym,))
        f0 = ev(zero)
        for i in range(sdim):
            hi = 1e-4 * scale[i]        # larger step: 2nd differences
            for j in range(i, sdim):
                hj = 1e-4 * scale[j]
                if i == j:
                    val = (ev(shift(i, hi)) - 2 * f0
                           + ev(shift(i, -hi))) / hi ** 2
                else:
                    spp = [0.0] * sdim
                    spp[i], spp[j] = hi, hj
                    smm = [-v for v in spp]
                    spm = [0.0] * sdim
                    spm[i], spm[j] = hi, -hj
                    smp = [-v for v in spm]
                    val = (ev(spp) - ev(spm) - ev(smp) + ev(smm)) \
                        / (4 * hi * hj)
                H[..., _sym_index(sdim, i, j)] = val
        return g, H

    try:
        import jax
        import jax.numpy as jnp

        def f_at(p):
            vals = f(*(p[k] for k in range(sdim)))
            if isinstance(vals, tuple):
                vals = jnp.stack([jnp.asarray(v) for v in vals], axis=-1)
            return jnp.asarray(vals, dtype=jnp.float64)

        g = np.asarray(jax.vmap(jax.jacfwd(f_at))(flat_pts))
        H = None
        if with_hessian:
            Hfull = np.asarray(jax.vmap(jax.jacfwd(jax.jacfwd(f_at)))(
                flat_pts))                      # (N,) + comp + (sdim, sdim)
            pairs = [(i, j) for i in range(sdim) for j in range(i, sdim)]
            H = np.stack([0.5 * (Hfull[..., i, j] + Hfull[..., j, i])
                          for i, j in pairs], axis=-1)
    except Exception:
        g, H = fd_derivs()

    g = g.reshape(grid_shape + comp_shape + (sdim,))
    if H is not None:
        H = H.reshape(grid_shape + comp_shape + (H.shape[-1],))
    return g, H


################################################################################
# Assembler class
################################################################################

# probe results (pruned combos + symmetric-fold plan) per (form, input
# signature); the probe runs on a tiny fixed grid, so one entry serves
# every space size — repeated instantiations skip its trace+compile
_PRUNE_CACHE = {}


class VFormAssembler:
    """Assembler for a compiled :class:`~pyiga_jax.vform.VForm`.

    Subclassed per-vform by :func:`compile_vform`; instantiate with the
    spline space(s), geometry and any named inputs/parameters."""

    vf = None   # set by compile_vform

    # -- reference-API class metadata -----------------------------------------

    @classmethod
    def inputs(cls):
        return {inp.name: inp.shape for inp in cls.vf.inputs}

    @classmethod
    def parameters(cls):
        return {p.name: p.shape for p in cls.vf.params
                if p.name != 'Jac_to_boundary'}

    def __init__(self, kvs, *posargs, kvs2=None, boundary=None, bbox=None,
                 **args):
        vf = self.vf
        # call-compatibility with the reference's generated assemblers,
        # whose __init__ is fully positional: (kvs0[, kvs1], geo/inputs...,
        # params...) — see reference codegen/cython.py:518
        if posargs:
            posargs = list(posargs)
            if (kvs2 is None and len(set(bf.space for bf in vf.basis_funs))
                    == 2):
                kvs2 = posargs.pop(0)
            names = (['geo'] if 'geo' not in args else []) \
                + [inp.name for inp in vf.inputs
                   if inp.name not in args and inp.name != 'geo'] \
                + [p.name for p in vf.params
                   if p.name not in args and p.name != 'Jac_to_boundary']
            if len(posargs) > len(names):
                raise TypeError('too many positional arguments')
            args.update(zip(names, posargs))
        if isinstance(kvs, KnotVector):
            kvs = (kvs,)
        kvs = tuple(kvs)
        if kvs2 is not None:
            kvs2 = tuple(kvs2)
        self.kvs0 = kvs                     # trial space (matrix columns)
        self.kvs1 = kvs2 if kvs2 is not None else kvs   # test space (rows)
        self.kvs = (self.kvs0, self.kvs1)
        self.arity = vf.arity
        self.dim = len(self.kvs0)
        assert self.dim == vf.dim, 'space dimension mismatch'

        self.geo = args.pop('geo')
        bdspec = args.pop('boundary', boundary)
        self.bdspec = bdspec
        self.bbox = args.pop('bbox', bbox)

        # quadrature (trial-space mesh; nqp = max(p)+1 over both spaces)
        nqp = max(kv.p for kv in self.kvs0 + self.kvs1) + 1
        if self.bbox is not None:
            # on-demand mode: restrict the Gauss grid to the cell bounding box
            # (reference: codegen/cython.py:541-559).  Entries whose test
            # function is supported inside the bbox are exact; others partial.
            assert bdspec is None, 'bbox + boundary not supported'
            from .quadrature import make_tensor_quadrature
            meshes = [kv.mesh[bb[0]:bb[1] + 1]
                      for kv, bb in zip(self.kvs0, self.bbox)]
            self.grid, self.gweights = make_tensor_quadrature(meshes, nqp)
        else:
            self.grid, self.gweights = sumfac.quadrature_for(
                self.kvs0, nqp, bdspec=bdspec)

        # structure & basis tables
        self.structure = MLStructure.from_kvs(self.kvs0, self.kvs1)
        if self.bbox is not None:
            # drop per-axis dof pairs with no support inside the bbox:
            # their basis-table rows are identically zero on the restricted
            # Gauss grid, so their compact entries are structural zeros —
            # and the contraction cost scales with stored entries, while
            # hierarchical on-demand windows are small corners of large
            # levels (the reference's on-demand assemblers likewise only
            # ever evaluate requested entries, codegen/cython.py:541-559)
            def _bbox_dofs(kv, bb):
                supp = kv.mesh_support_idx_all()
                return (supp[:, 0] < bb[1]) & (supp[:, 1] > bb[0])
            bidx = []
            self._bbox_win_test = []
            for k, bx in enumerate(self.structure.bidx):
                wi = _bbox_dofs(self.kvs1[k], self.bbox[k])  # test/rows
                wj = _bbox_dofs(self.kvs0[k], self.bbox[k])  # trial/cols
                keep = wi[bx[:, 0].astype(np.intp)] \
                    & wj[bx[:, 1].astype(np.intp)]
                bidx.append(bx[keep])
                nz = np.nonzero(wi)[0]     # contiguous for B-splines
                self._bbox_win_test.append(
                    (int(nz[0]), int(nz[-1]) + 1) if nz.size else (0, 0))
            self.structure = MLStructure(self.structure.bs, bidx)
        self.maxderiv = vf.max_deriv_order()
        if bdspec is not None:
            # boundary integral: restrict the normal axis to the single
            # interpolatory boundary basis function (reference:
            # codegen/cython.py:577-592 — ndofs = 1 along that axis)
            bdax, bdside = bdspec
            bs = list(self.structure.bs)
            bidx = list(self.structure.bidx)
            bs[bdax] = (1, 1)
            bidx[bdax] = np.zeros((1, 2), dtype=np.uint32)
            self.structure = MLStructure(bs, bidx)
        self.tables = sumfac.SpaceTables(self.kvs0, self.kvs1, self.grid,
                                         self.structure.bidx, self.maxderiv)
        if bdspec is not None:
            sl = slice(0, 1) if bdspec[1] == 0 else slice(-1, None)
            shared = self.tables.test is self.tables.trial
            self.tables.trial[bdax] = self.tables.trial[bdax][:, sl, :]
            if not shared:
                self.tables.test[bdax] = self.tables.test[bdax][:, sl, :]

        # seeds & combos
        ncomp = tuple(bf.numcomp for bf in vf.basis_funs)
        if vf.arity == 2:
            seeds_u = _seeds_for(0, ncomp[0], vf.dim, self.maxderiv)
            seeds_v = _seeds_for(1, ncomp[1], vf.dim, self.maxderiv)
            self.combos = [(su, sv) for su in seeds_u for sv in seeds_v]
        else:
            seeds_v = _seeds_for(0, ncomp[0], vf.dim, self.maxderiv)
            self.combos = [(None, sv) for sv in seeds_v]

        # input/parameter arrays
        self._input_values = {}
        for inp in vf.inputs:
            if inp.name == 'geo':
                continue
            if inp.name not in args:
                raise ValueError("required input '%s' missing" % inp.name)
            self._input_values[inp.name] = args[inp.name]
        self._param_values = {}
        for p in vf.params:
            if p.name not in args:
                raise ValueError("required parameter '%s' missing" % p.name)
            self._param_values[p.name] = args[p.name]

        self._needed_keys = vf.used_field_keys()
        self._build_arrays()
        self._num_combos_total = len(self.combos)
        self._prune_combos()

    # -- array setup -------------------------------------------------------------

    def _needs_geo_hessian(self):
        for key in self._needed_keys:
            if key[0] == 'input_deriv' and key[1] == 'geo' and sum(key[3]) >= 2:
                return True
        # physical 2nd derivatives of basis functions also need it
        return self.maxderiv >= 2 and not self.vf.spacetime and \
            any(key[0] == 'jacinv' for key in self._needed_keys)

    def _build_arrays(self):
        """Host setup of all grid arrays; geometry stays as tables+coeffs so
        its fields are computed on device inside the assembly jit."""
        vf = self.vf
        arrays = {'weights': [np.asarray(w) for w in self.gweights]}

        geo_derivs = 2 if self._needs_geo_hessian() else 1
        setup = geom.geo_eval_tables(self.geo, self.grid, numderiv=geo_derivs)
        if setup is None:
            # unstructured geometry: evaluate on host
            if geo_derivs >= 2:
                # fail clearly up front instead of a KeyError mid-trace
                raise NotImplementedError(
                    'this form needs second geometry derivatives, which are '
                    'only available for spline/NURBS geometries; wrap the '
                    'geometry as a BSplineFunc/NurbsFunc (e.g. via '
                    'approx.interpolate) to use it here')
            arrays['geo_jac_lvl'] = geom.host_jacobian_levelorder(
                self.geo, self.grid)
            val = geom.host_eval(self.geo, self.grid)       # grid x dim
            arrays['geo_val_lvl'] = np.ascontiguousarray(
                np.moveaxis(val[..., ::-1], -1, 0))
            self._geo_tables = None
        else:
            self._geo_tables, self._geo_coeffs, self._geo_is_nurbs = setup

        # input fields
        for inp in vf.inputs:
            if inp.name == 'geo':
                continue
            f = self._input_values[inp.name]
            arrays.update(self._eval_input(inp, f))

        for p in vf.params:
            arrays['param:' + p.name] = np.asarray(
                self._param_values[p.name], dtype=float)

        self._host_arrays = arrays

    def _eval_input(self, inp, f):
        """Evaluate one input field (values + needed derivatives) on the
        Gauss grid; returns dict of arrays (component axes leading)."""
        out = {}
        name = inp.name
        if inp.physical:
            vals = utils.grid_eval_transformed(f, self.grid, self.geo)
        else:
            vals = utils.grid_eval(f, self.grid)
        ncomp_axes = len(inp.shape)
        if ncomp_axes:
            vals = np.moveaxis(np.asarray(vals),
                               tuple(range(-ncomp_axes, 0)),
                               tuple(range(ncomp_axes)))
        out['input:' + name] = np.asarray(vals)

        # determine needed derivative orders for this input
        orders = {sum(key[3]) for key in self._needed_keys
                  if key[0] == 'input_deriv' and key[1] == name}
        for order in sorted(orders):
            if inp.physical:
                # physical derivatives of a physical field: differentiate f
                # directly at the mapped Gauss points (JAX autodiff when f
                # is traceable, vectorized finite differences otherwise).
                # The reference's codegen rejects this case
                # (/root/reference/pyiga/codegen/cython.py:474-477); this
                # is a capability extension.
                grad, hess = _physical_field_derivs(
                    f, self.geo, self.grid, inp.shape, with_hessian=order == 2)
                arr = grad if order == 1 else hess
                if order > 2:
                    raise NotImplementedError('input derivs of order > 2')
                arr = np.moveaxis(arr, tuple(range(-(ncomp_axes + 1), 0)),
                                  tuple(range(ncomp_axes + 1)))
                out['ideriv:%s:%d' % (name, order)] = arr
                continue
            if order == 1:
                jac = np.asarray(f.grid_jacobian(self.grid))
                # shape grid x comp... x sdim, derivative axis already XYZ
                jac = np.moveaxis(jac, tuple(range(-(ncomp_axes + 1), 0)),
                                  tuple(range(ncomp_axes + 1)))
                out['ideriv:%s:1' % name] = jac
            elif order == 2:
                hessarr = np.asarray(f.grid_hessian(self.grid))
                hessarr = np.moveaxis(
                    hessarr, tuple(range(-(ncomp_axes + 1), 0)),
                    tuple(range(ncomp_axes + 1)))
                out['ideriv:%s:2' % name] = hessarr
            else:
                raise NotImplementedError('input derivs of order > 2')
        return out

    def update(self, **upd):
        """Update updatable input fields and/or parameters (including the
        geometry, which also refreshes physically-evaluated inputs)."""
        geo_changed = False
        changed_keys = set()
        for name, f in upd.items():
            if name == 'geo':
                self.geo = f
                geo_changed = True
                continue
            inp = [i for i in self.vf.inputs if i.name == name]
            if inp and inp[0].updatable:
                self._input_values[name] = f
                new = self._eval_input(inp[0], f)
                self._host_arrays.update(new)
                changed_keys.update(new)
                continue
            if name in self._param_values:
                self._param_values[name] = f
                self._host_arrays['param:' + name] = np.asarray(f, dtype=float)
                changed_keys.add('param:' + name)
                continue
            raise ValueError('%r is not an updatable input' % name)
        if geo_changed:
            self._build_arrays()
        if hasattr(self, '_full_mlm'):
            del self._full_mlm
        # the ACA slice paths cache device-resident coefficient fields and
        # term tables; they reflect the OLD inputs/geometry after an update
        self._fields_cache = None
        self._tables_cache = None
        # refresh the device-operand cache surgically when only plain input
        # arrays changed: re-uploading every operand per update was ~15% of
        # the warm hierarchical rebuild.  Geometry changes rebuild arrays
        # wholesale and the pair cache pre-splits floats — both invalidate.
        cached = getattr(self, '_operands_cache', None)
        if cached is None:
            return
        if geo_changed or cached[0][0] == 'pair':
            self._operands_cache = None
            return
        import jax.numpy as jnp
        from . import config
        dtype = config.get_dtype()
        inputs, term_tables, tperms = cached[1]
        inputs = dict(inputs)
        for k in changed_keys:
            x = self._host_arrays[k]
            inputs[k] = (jnp.asarray(x, dtype=dtype)
                         if np.issubdtype(np.asarray(x).dtype, np.floating)
                         else jnp.asarray(x))
        self._operands_cache = (cached[0], (inputs, term_tables, tperms))

    # -- evaluation -------------------------------------------------------------

    def _device_inputs(self):
        """Assemble the pytree of jit inputs."""
        inputs = dict(self._host_arrays)
        if self._geo_tables is not None:
            inputs['geo_tables'] = [np.asarray(t) for t in self._geo_tables]
            inputs['geo_coeffs'] = np.asarray(self._geo_coeffs)
        return inputs

    def _make_context(self, inputs, seed_u, seed_v):
        arrays = dict(inputs)
        if self._geo_tables is not None:
            tabs = inputs['geo_tables']
            val, jac = geom.geo_jacobian_field(
                tabs, inputs['geo_coeffs'], self._geo_is_nurbs, self.dim)
            arrays['geo_val_lvl'] = val
            arrays['geo_jac_lvl'] = jac
            if len(tabs[0]) >= 3:   # hessian tables available
                arrays['geo_hess_lvl'] = geom.geo_hessian_field(
                    tabs, inputs['geo_coeffs'], self._geo_is_nurbs, self.dim)
        return AsmContext(self.vf, arrays, seed_u, seed_v)

    def _eval_combo_fields(self, inputs, combos):
        """Traced: coefficient field for every (seed_u, seed_v) combo."""
        import jax.numpy as jnp
        grid_shape = tuple(np.shape(w)[0] for w in inputs['weights'])
        # share the FIELD-scope cache across combos: every ctx.field key is
        # seed-independent (geometry/inputs/params), so det/inv/measures
        # are computed once instead of once per combo
        shared_cache = {}
        fields = []
        for su, sv in combos:
            ctx = self._make_context(inputs, su, sv)
            ctx._cache = shared_cache
            C = 0.0
            for e in self.vf.exprs:
                C = C + e.eval(ctx)
            if not hasattr(C, 'shape') or C.shape != grid_shape:
                C = jnp.broadcast_to(jnp.asarray(C), grid_shape)
            fields.append(C)
        return fields

    def _supports_pair_eval(self):
        """Whether the two-float (emulation-free f64) fast path can evaluate
        this form: requires (a) no geometry Hessians (2nd-order geometry
        tables have no pair pipeline) and (b) no transcendental builtins
        (only abs/sqrt have double-float implementations)."""
        from . import vform as vform_mod
        if self._needs_geo_hessian():
            return False
        if self.maxderiv >= 2 and any(key[0] == 'jacinv'
                                      for key in self._needed_keys):
            # physical 2nd-order basis derivatives expand through the
            # geometry Hessian transform even in space-time forms
            return False
        for e in vform_mod.iterexprs(self.vf.exprs):
            if isinstance(e, vform_mod.BuiltinFuncExpr) and \
                    e.func not in ('abs', 'sqrt'):
                return False
        return True

    def _device_inputs_pair(self):
        """Jit-input pytree for the pair fast path: every host float array
        is pre-split into an (hi, lo) f32 pair on host (numpy — zero device
        f64 work); geometry tables/coeffs stay f64 for ops.geom's df
        pipeline, which unrolls them into pair arithmetic internally."""
        def split(a):
            a = np.asarray(a, dtype=np.float64)
            hi = a.astype(np.float32)
            lo = (a - hi.astype(np.float64)).astype(np.float32)
            return (hi, lo)

        arrays = self._host_arrays
        inputs = {'weights': [split(w) for w in arrays['weights']]}
        for key, arr in arrays.items():
            if key == 'weights':
                continue
            if key == 'geo_jac_lvl':        # host-geometry path
                dg, d = arr.shape[:2]
                inputs['geo_jac_pair'] = [[split(arr[a, b])
                                           for b in range(d)]
                                          for a in range(dg)]
            elif key == 'geo_val_lvl':
                inputs['geo_val_pair'] = [split(arr[c])
                                          for c in range(arr.shape[0])]
            else:
                inputs[key] = split(arr)
        if self._geo_tables is not None:
            inputs['geo_tables'] = [np.asarray(t) for t in self._geo_tables]
            inputs['geo_coeffs'] = np.asarray(self._geo_coeffs)
        return inputs

    def _make_pair_context(self, inputs, seed_u, seed_v):
        arrays = dict(inputs)
        if self._geo_tables is not None:
            arrays['geo_is_nurbs'] = self._geo_is_nurbs   # static flag
        return PairAsmContext(self.vf, arrays, seed_u, seed_v)

    def _eval_combo_fields_pair(self, inputs, combos):
        """Traced: two-float (hi, lo) coefficient field per combo."""
        import jax.numpy as jnp
        from .ops import twofloat as tf
        grid_shape = tuple(np.shape(w[0])[0] for w in inputs['weights'])
        # shared FIELD-scope cache (see _eval_combo_fields): the pair
        # det/inv pipeline is division-heavy — computing it once instead
        # of once per combo is a large part of the field cost
        shared_cache = {}
        fields = []
        for su, sv in combos:
            ctx = self._make_pair_context(inputs, su, sv)
            ctx._cache = shared_cache
            C = 0.0
            for e in self.vf.exprs:
                C = C + e.eval(ctx)
            if isinstance(C, tf.DF):
                hi = jnp.broadcast_to(C.hi, grid_shape)
                lo = jnp.broadcast_to(C.lo, grid_shape)
            else:       # scalar-constant integrand: exact split
                cd = tf.as_df(float(C))
                hi = jnp.broadcast_to(jnp.float32(cd.hi), grid_shape)
                lo = jnp.broadcast_to(jnp.float32(cd.lo), grid_shape)
            fields.append((hi, lo))
        return fields

    def _prune_key(self):
        """Cache key for the probe results: everything the probe values
        depend on EXCEPT the space sizes (the probe runs on a tiny fixed
        grid, so one probe serves every kvs with the same form/inputs)."""
        def sig(k, a):
            shape = tuple(np.shape(a))
            if k.startswith('param:'):
                return (k, shape)
            # grid-shaped inputs: only the leading (component) axes matter,
            # the probe replaces the grid part with a tiny fixed grid
            return (k, shape[:max(len(shape) - self.dim, 0)])

        hsig = tuple(sorted(sig(k, a) for k, a in self._host_arrays.items()
                            if k != 'weights'))
        return (self.vf.hash(), self.dim, self.vf.geo_dim, self.arity,
                bool(self.vf.vec), repr(self.bdspec), self.bbox is not None,
                self._needs_geo_hessian(), hsig, self.kvs0 == self.kvs1)

    def _prune_combos(self):
        """Drop structurally-zero seed combinations using a random probe on a
        tiny grid (one jitted evaluation).  Results are cached per
        (form, input-signature) so repeated assembler instantiations — e.g.
        the per-level builds of a hierarchical discretization — skip the
        probe's trace+compile entirely."""
        import jax
        import jax.numpy as jnp

        cache_key = self._prune_key()
        cached = _PRUNE_CACHE.get(cache_key)
        if cached is not None and len(cached[0]) == len(self.combos):
            keep, plan = cached
            self.combos = [c for c, k in zip(self.combos, keep) if k]
            self._fold_plan = self._fold_tperms = None
            if plan is not None:        # plan recorded => mirrored folding
                from .mlmatrix import transpose_idx_for_bidx
                self._fold_plan = list(plan)
                self._fold_tperms = [transpose_idx_for_bidx(bx)
                                     for bx in self.structure.bidx]
            return

        rng = np.random.RandomState(987123)
        tiny_grid = 2
        gshape = self.dim * (tiny_grid,)

        def rnd(shape):
            return rng.rand(*shape) + 0.5

        probe = {'weights': [rnd((tiny_grid,)) for _ in range(self.dim)]}
        # geometry arrays directly (host-path keys)
        probe['geo_val_lvl'] = rnd((self.vf.geo_dim,) + gshape)
        probe['geo_jac_lvl'] = rnd((self.vf.geo_dim, self.dim) + gshape)
        if self._needs_geo_hessian():
            H = rnd((self.vf.geo_dim, self.dim, self.dim) + gshape)
            probe['geo_hess_lvl'] = 0.5 * (H + H.swapaxes(1, 2))
        for key, arr in self._host_arrays.items():
            if key == 'weights':
                continue
            if key.startswith('param:'):
                probe[key] = rnd(np.shape(arr)) if np.shape(arr) else \
                    np.asarray(rng.rand() + 0.5)
            else:
                lead = arr.shape[:arr.ndim - self.dim]
                probe[key] = rnd(lead + gshape)

        geo_tables_save = self._geo_tables
        self._geo_tables = None     # force host-path keys during probe

        def probe_fn(inputs):
            fields = self._eval_combo_fields(inputs, self.combos)
            return jnp.stack([C.reshape(-1) for C in fields])

        try:
            import jax
            values = np.asarray(jax.jit(probe_fn)(probe))
            # second evaluation of the same probe in float32: a structural
            # zero is pure cancellation noise, so its f32 and f64 values
            # are uncorrelated (relative difference O(1)); a genuine term —
            # however tiny relative to the dominant term — evaluates
            # cancellation-free on random inputs, so f32 agrees with f64 to
            # ~1e-6 relative.  This makes pruning per-combo scale-free
            # instead of dropping everything below 1e-13 of the global max.
            probe32 = jax.tree_util.tree_map(
                lambda a: np.asarray(a, dtype=np.float32), probe)
            import warnings
            with warnings.catch_warnings():
                warnings.simplefilter('ignore')    # f64->f32 truncation
                with jax.enable_x64(False):        # force true f32 compute
                    values32 = np.asarray(jax.jit(probe_fn)(probe32),
                                          dtype=np.float64)
        finally:
            self._geo_tables = geo_tables_save

        maxima = np.abs(values).max(axis=1)
        scale = max(maxima.max(), 1e-300)
        keep = np.empty(len(self.combos), dtype=bool)
        for i in range(len(self.combos)):
            if maxima[i] > 1e-13 * scale:
                keep[i] = True          # clearly above cancellation noise
                continue
            v64, v32 = values[i], values32[i]
            if maxima[i] == 0.0 and np.abs(v32).max() == 0.0:
                keep[i] = False         # exact structural zero
                continue
            if not np.all(np.isfinite(v32)):
                keep[i] = True          # f32 overflow: keep conservatively
                continue
            ref = max(maxima[i], np.abs(v32).max(), 1e-300)
            keep[i] = np.abs(v64 - v32).max() < 1e-3 * ref
        self.combos = [c for c, k in zip(self.combos, keep) if k]
        if not self.combos:
            raise ValueError('variational form is identically zero')
        self._detect_symmetry(values[keep], maxima[keep])
        _PRUNE_CACHE[cache_key] = (
            tuple(bool(k) for k in keep),
            tuple(self._fold_plan) if self._fold_plan is not None else None)

    def _detect_symmetry(self, probe_values, probe_maxima):
        """Probe-based symmetric-term folding (scalar forms on a single
        space): a combo (su, sv) whose deriv-swapped partner (sv, su) has a
        *numerically equal* coefficient field on the random probe contributes
        the transpose of its partner's chain — assemble one chain of each
        pair and mirror it by the compact-layout transpose gather (same
        mechanism as the reference's symmetric entry mirroring,
        /root/reference/pyiga/codegen/cython.py:1136-1140, but detected
        automatically: probe equality on random geometry implies structural
        symmetry with probability 1)."""
        self._fold_plan = self._fold_tperms = None
        if (self.arity != 2 or self.vf.vec or self.kvs0 != self.kvs1
                or self.bdspec is not None or self.bbox is not None):
            return
        index = {c: i for i, c in enumerate(self.combos)}
        plan = []
        any_mirror = False
        for i, (su, sv) in enumerate(self.combos):
            if su == sv:
                plan.append((i, False))
                continue
            j = index.get((sv, su))
            # per-pair relative tolerance (not global-max): a tiny
            # asymmetric pair must not be folded just because both members
            # are small relative to the dominant term
            pair_scale = max(probe_maxima[i], probe_maxima[j]
                             if j is not None else 0.0, 1e-300)
            if j is not None and np.abs(
                    probe_values[i] - probe_values[j]).max() \
                    < 1e-10 * pair_scale:
                if j > i:
                    plan.append((i, True))
                    any_mirror = True
                # j < i: mirrored by its partner, skip
            else:
                plan.append((i, False))
        if any_mirror:
            from .mlmatrix import transpose_idx_for_bidx
            self._fold_plan = plan
            self._fold_tperms = [transpose_idx_for_bidx(bx)
                                 for bx in self.structure.bidx]

    # -- assembly ------------------------------------------------------------------

    def _term_tables_for(self, combos):
        """Per-combo per-axis pair tables (matrix) or test tables (vector).
        Derivative multi-indices are converted XYZ -> level order here."""
        tabs = []
        for su, sv in combos:
            Dv_lvl = tuple(reversed(sv[1]))
            if self.arity == 2:
                Du_lvl = tuple(reversed(su[1]))
                tabs.append([self.tables.pair_table(k, Du_lvl[k], Dv_lvl[k])
                             for k in range(self.dim)])
            else:
                win = getattr(self, '_bbox_win_test', None)
                tabs.append([self.tables.test[k][Dv_lvl[k]]
                             if win is None else
                             self.tables.test[k][Dv_lvl[k]]
                             [win[k][0]:win[k][1]]
                             for k in range(self.dim)])
        return tabs

    def _assembly_fn(self, mode='exact'):
        """The traced assembly function: inputs pytree + term tables ->
        dict of per-component-block data tensors.  ``mode='ozaki'`` uses the
        bf16-split f64 contraction (see sumfac.contract_chain_ozaki)."""
        combos = self.combos
        fold_plan = getattr(self, '_fold_plan', None)

        if mode == 'pair':
            # emulation-free f64: two-float field evaluation + pair-chained
            # Ozaki contraction (internal mode, selected by _run when
            # mode='ozaki' and the form supports pair evaluation)
            from .ops import twofloat as tf

            if fold_plan is not None:
                plan = tuple(fold_plan)

                def fn(inputs, term_tables, tperms):
                    pairs = self._eval_combo_fields_pair(inputs, combos)
                    Y = sumfac.assemble_terms_folded_pair(
                        term_tables, pairs, plan, tperms)
                    return {(None, None): Y}
                return fn

            def fn(inputs, term_tables, tperms):
                pairs = self._eval_combo_fields_pair(inputs, combos)
                blocks = {}
                for (su, sv), P, tabs in zip(combos, pairs, term_tables):
                    cu = su[0] if su is not None else None
                    key = (cu, sv[0])
                    Y = sumfac.contract_chain_ozaki_pair(tabs, P)
                    blocks[key] = (Y if key not in blocks
                                   else tf.df_add(blocks[key], Y))
                return {k: tf.df_to_f64(v) for k, v in blocks.items()}
            return fn

        if fold_plan is not None:
            # scalar symmetric form: folded chains + transpose gather.
            # tperms are traced arguments — the jit cache is shared across
            # space sizes, so nothing size-dependent may be closed over.
            # (last_idx is structural — which terms share a last table is
            # set by the derivative indices, identical across sizes.)
            plan = tuple(fold_plan)
            last_idx = sumfac.last_table_groups(
                self._term_tables_for(combos))

            def fn(inputs, term_tables, tperms):
                fields = self._eval_combo_fields(inputs, combos)
                Y = sumfac.assemble_terms_folded(term_tables, fields,
                                                 plan, tperms, mode=mode,
                                                 last_idx=last_idx)
                return {(None, None): Y}
            return fn

        chain = (sumfac.contract_chain_ozaki if mode == 'ozaki'
                 else sumfac.contract_chain)

        def fn(inputs, term_tables, tperms):
            fields = self._eval_combo_fields(inputs, combos)
            blocks = {}
            for (su, sv), C, tabs in zip(combos, fields, term_tables):
                cu = su[0] if su is not None else None
                cv = sv[0]
                key = (cu, cv)
                Y = chain(tabs, C)
                blocks[key] = blocks.get(key, 0.0) + Y
            return blocks
        return fn

    _JIT_CACHE = {}

    def _device_operands(self, mode):
        """Device-ready (inputs, term_tables, tperms) for the cached
        assembly jit of the given (resolved) mode.  Memoized on the
        instance (invalidated by :meth:`update`): repeated assembly —
        hierarchical levels, adaptive loops, updatable assemblers —
        skips the host->device operand transfer."""
        import jax
        import jax.numpy as jnp
        from . import config
        dtype = config.get_dtype()
        okey = (mode, np.dtype(dtype).str)
        cached = getattr(self, '_operands_cache', None)
        if cached is not None and cached[0] == okey:
            return cached[1]
        fold = getattr(self, '_fold_plan', None)
        if mode == 'pair':
            # pre-split f32 pairs stay f32; geometry tables/coeffs stay f64
            inputs = jax.tree_util.tree_map(jnp.asarray,
                                            self._device_inputs_pair())
        else:
            inputs = jax.tree_util.tree_map(
                lambda x: jnp.asarray(x, dtype=dtype)
                if np.issubdtype(np.asarray(x).dtype, np.floating)
                else jnp.asarray(x),
                self._device_inputs())
        term_tables = jax.tree_util.tree_map(
            lambda x: jnp.asarray(x, dtype=dtype),
            self._term_tables_for(self.combos))
        tperms = ([jnp.asarray(p) for p in self._fold_tperms]
                  if fold is not None else None)
        self._operands_cache = (okey, (inputs, term_tables, tperms))
        return inputs, term_tables, tperms

    def _run(self, mode='exact'):
        """Host-side assembly: :meth:`run_device` + one transfer."""
        blocks = self.run_device(mode)
        return {k: np.asarray(v, dtype=np.float64) for k, v in blocks.items()}

    def run_device(self, mode='exact'):
        """Assemble to device-resident block arrays.

        ``mode='ozaki'`` upgrades to the two-float pair path when the form
        supports it.  On the CPU the pair path runs op-by-op: the XLA:CPU
        pipeline of this JAX version miscompiles the error-free f32
        transformations when fused into one jit program (measured: pair
        fields 1e-14 -> 5e-8; same workaround as
        sumfac.run_matrix_assembly_pair)."""
        import jax
        from . import config

        fold = getattr(self, '_fold_plan', None)
        if mode == 'ozaki':
            config.require_twofloat_platform("mode='ozaki'")
        if mode == 'ozaki' and self.arity == 2 and self._supports_pair_eval():
            mode = 'pair'
        eager = mode == 'pair' and config.platform() == 'cpu'
        key = (self.vf.hash(), tuple(map(repr, self.combos)),
               tuple(fold) if fold is not None else None,
               self._geo_tables is None,
               getattr(self, '_geo_is_nurbs', None),
               self._needs_geo_hessian(), mode, eager)
        fn = VFormAssembler._JIT_CACHE.get(key)
        if fn is None:
            fn = self._assembly_fn(mode)
            if not eager:
                fn = jax.jit(fn)
            VFormAssembler._JIT_CACHE[key] = fn
        inputs, term_tables, tperms = self._device_operands(mode)
        return fn(inputs, term_tables, tperms)

    def assemble(self, mode=None):
        """Assemble and return the matrix as an MLMatrix (scalar forms) or a
        dict of (comp_u, comp_v) -> MLMatrix blocks (vector forms).

        ``mode='ozaki'`` computes the float64 result with no emulated-f64
        arithmetic: when the form supports it (no geometry Hessians, no
        transcendental builtins) the coefficient fields evaluate in fused
        two-float f32 pair arithmetic and the contractions run pair-chained
        Ozaki (bf16 chunk products with exact f32 accumulation,
        ~1e-13 relative); otherwise fields evaluate in f64 with
        Ozaki-split contractions.  The default (None) is
        :func:`pyiga_jax.config.default_assembly_mode`: native 'exact'."""
        assert self.arity == 2
        if mode is None:
            from . import config
            mode = config.default_assembly_mode()
        assert mode in ('exact', 'ozaki'), "mode must be 'exact' or 'ozaki'"
        blocks = self._run(mode)
        if not self.vf.vec:
            return self.structure.make_mlmatrix(data=blocks[(None, None)])
        return {k: self.structure.make_mlmatrix(data=v)
                for k, v in blocks.items()}

    def assemble_vector(self):
        """Assemble an arity-1 functional; shape = per-axis dofs (+ trailing
        component axis for vector-valued test functions)."""
        assert self.arity == 1
        blocks = self._run()
        win = getattr(self, '_bbox_win_test', None)
        if win is not None:
            # the bbox path assembles only the dof window per axis
            # (_term_tables_for slices the test tables); embed back into
            # the full-size vector — everything outside is exactly zero
            full = tuple(b[0] for b in self.structure.bs)
            sl = tuple(slice(w0, w1) for (w0, w1) in win)

            def embed(v):
                out = np.zeros(full + v.shape[self.dim:], dtype=np.float64)
                out[sl] = np.asarray(v, dtype=np.float64)
                return out
            blocks = {k: embed(v) for k, v in blocks.items()}
        if not self.vf.vec:
            return blocks[(None, None)]
        ncomp = self.vf.basis_funs[0].numcomp
        # components whose combos were all pruned as structural zeros
        # (e.g. f * v[0] * dx on a 2-component space) assemble to zero
        zero = None
        for c in range(ncomp):
            if (None, c) not in blocks:
                if zero is None:
                    shape = next(iter(blocks.values())).shape
                    zero = np.zeros(shape)
                blocks[(None, c)] = zero
        return np.stack([blocks[(None, c)] for c in range(ncomp)], axis=-1)

    # -- reference-compat helpers -------------------------------------------------

    # -- compact-slice evaluation (for ACA fast assembling) -----------------------

    def _device_fields(self, dtype=None):
        """Compute (once) the per-combo coefficient fields on device and keep
        them resident; used by the slice evaluator."""
        from . import config
        dtype = np.dtype(dtype if dtype is not None else config.get_dtype())
        cache = getattr(self, '_fields_cache', None)
        if cache is None or cache[0] != dtype:
            import jax
            import jax.numpy as jnp
            inputs = jax.tree_util.tree_map(
                lambda x: jnp.asarray(x, dtype=dtype)
                if np.issubdtype(np.asarray(x).dtype, np.floating)
                else jnp.asarray(x),
                self._device_inputs())
            fn = jax.jit(lambda inp: self._eval_combo_fields(inp, self.combos))
            self._fields_cache = cache = (dtype, fn(inputs))
        return cache[1]

    def _make_slice_fn(self, fixed_axes):
        """Build the traced slice evaluator for a pinned-axes pattern.

        It contracts the PINNED axes first: a pinned (1, Q) table collapses
        its grid axis immediately, so the expensive free-axis stages run on
        a fiber-thin intermediate instead of the full quadrature grid."""
        import jax
        import jax.numpy as jnp
        d = self.dim
        order = list(fixed_axes) + [k for k in range(d)
                                    if k not in fixed_axes]

        def pin(tabs, idx):
            tabs = list(tabs)
            for pos, ax in enumerate(fixed_axes):
                tabs[ax] = jax.lax.dynamic_slice(
                    tabs[ax], (idx[pos], 0), (1, tabs[ax].shape[1]))
            return tabs

        def slice_fn(fields, term_tables, idx):
            out = None
            for C, tabs in zip(fields, term_tables):
                tabs = pin(tabs, idx)
                X = C
                for k in order:
                    X = jnp.moveaxis(
                        jnp.tensordot(
                            X, tabs[k], axes=(k, 1),
                            precision=sumfac._dot_precision(X.dtype)),
                        -1, k)
                out = X if out is None else out + X
            return out.reshape([out.shape[k] for k in range(d)
                                if k not in fixed_axes])
        return jax.jit(slice_fn)

    def _slice_fn_cached(self, fixed_axes):
        """The cached jitted slice evaluator for a pinned-axes pattern."""
        fn_cache = getattr(self, '_slice_fns', None)
        if fn_cache is None:
            fn_cache = self._slice_fns = {}
        fn = fn_cache.get(fixed_axes)
        if fn is None:
            fn = self._make_slice_fn(fixed_axes)
            fn_cache[fixed_axes] = fn
        return fn

    def _slice_operands(self):
        """Device-resident (fields, term_tables) operands for the slice
        evaluators (cached; fields stay on the device across ACA pivots)."""
        import jax
        from . import config
        dtype = config.get_dtype()
        cache = getattr(self, '_tables_cache', None)
        # keyed by the dtype: a config change between slice calls must not
        # silently reuse tables of the wrong precision
        if cache is None or cache[0] != np.dtype(dtype):
            import jax.numpy as jnp
            self._tables_cache = cache = (np.dtype(dtype), jax.tree_util.tree_map(
                lambda x: jnp.asarray(x, dtype=dtype),
                self._term_tables_for(self.combos)))
        return self._device_fields(), cache[1]

    def compact_slice(self, fixed):
        """Evaluate a slice of the compact data tensor with the axes in the
        dict `fixed` (axis -> pair index s_k) pinned; returns the dense array
        over the free axes.

        This is the ACA entry callback: instead of per-entry evaluations
        through a C function pointer (reference fastasm.cc:538), whole
        rows/slices of the reordered matrix are computed by the
        sum-factorization chain with rank-1-restricted pair tables."""
        assert not self.vf.vec and self.arity == 2
        fixed_axes = tuple(sorted(fixed.keys()))
        fn = self._slice_fn_cached(fixed_axes)
        fields, tables = self._slice_operands()
        idx = np.array([fixed[ax] for ax in fixed_axes], dtype=np.int64)
        return np.asarray(fn(fields, tables, idx), dtype=np.float64)

    def num_components(self):
        """Components per basis function space (vector forms only)."""
        assert self.vf.vec
        return self.vf.num_components()

    def multi_entries(self, indices):
        """Entry lookup (i, j) -> value for a list of global index pairs
        (used by ACA and hierarchical partial assembly).  Assembles the full
        compact tensor once and gathers."""
        assert not self.vf.vec, 'use multi_blocks for vector-valued forms'
        if not hasattr(self, '_full_mlm'):
            self._full_mlm = self.assemble().asmatrix('csr')
        indices = np.asarray(indices)
        return np.asarray(
            self._full_mlm[indices[:, 0], indices[:, 1]]).ravel()

    def multi_blocks(self, indices):
        """Per-dof component blocks for a list of (i, j) global block index
        pairs; returns an array of shape (len(indices), ncv, ncu)."""
        assert self.vf.vec and self.arity == 2
        blocks = self.assemble()
        ncu, ncv = self.vf.num_components()
        # expand each component block to csr once
        mats = {k: v.asmatrix('csr') for k, v in blocks.items()}
        indices = np.asarray(indices)
        out = np.zeros((len(indices), ncv, ncu))
        for (cu, cv), mat in mats.items():
            out[:, cv, cu] = np.asarray(
                mat[indices[:, 0], indices[:, 1]]).ravel()
        return out


_COMPILE_CACHE = {}


def compile_vform(vf, on_demand=False, verbose=False):
    """Compile a VForm into an assembler class (cached by vf.hash())."""
    key = (vf.hash(), on_demand)
    cls = _COMPILE_CACHE.get(key)
    if cls is None:
        cls = type('VFormAssembler_%x' % (vf.hash() & 0xffffffff),
                   (VFormAssembler,), {'vf': vf})
        _COMPILE_CACHE[key] = cls
    return cls


def compile_vforms(vfs, verbose=False):
    """Compile several vforms at once."""
    return [compile_vform(vf, verbose=verbose) for vf in vfs]
