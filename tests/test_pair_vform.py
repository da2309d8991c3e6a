"""Emulation-free f64 fast path for *generic* compiled vforms.

``assemble(..., mode='ozaki')`` upgrades to two-float (pair) field
evaluation whenever the form supports it (compile.PairAsmContext): the
coefficient fields evaluate in fused f32 pair arithmetic and the
contractions run pair-chained Ozaki — f32 arithmetic only.  This matches the treatment the reference's codegen gives every form
(/root/reference/pyiga/codegen/cython.py:673 precompute_fields).

All cases assert <= 1e-10 entry parity against the exact-f64 path (measured
~1e-14)."""

import pytest
import numpy as np

from pyiga_jax import assemble, bspline, geometry
from pyiga_jax import vform as vf_mod
from pyiga_jax.compile import compile_vform


def _kvs(p=3, n=8, d=2):
    return d * (bspline.make_knots(p, 0.0, 1.0, n),)


def _parity(Ae, Ap, tol=1e-10):
    err = abs(Ae - Ap).max() / abs(Ae).max()
    assert err < tol, err
    return err


@pytest.mark.slow
def test_pair_vform_convdiff_nurbs():
    # a NURBS-geometry convection-diffusion
    # string form at <= 1e-10 parity via the pair path
    kvs = _kvs()
    geo = geometry.quarter_annulus()        # exact NURBS
    form = '(inner(grad(u), grad(v)) + dot(b, grad(u)) * v + u * v) * dx'
    b = np.array([3.0, -2.0])
    Ae = assemble.assemble(form, kvs, geo=geo, b=b, mode='exact')
    Ap = assemble.assemble(form, kvs, geo=geo, b=b, mode='ozaki')
    _parity(Ae, Ap)


def test_pair_vform_mass_and_fold():
    kvs = _kvs()
    geo = geometry.quarter_annulus()
    for form in ('u * v * dx', 'inner(grad(u), grad(v)) * dx'):
        Ae = assemble.assemble(form, kvs, geo=geo, mode='exact')
        Ap = assemble.assemble(form, kvs, geo=geo, mode='ozaki')
        _parity(Ae, Ap)


def test_pair_vform_geometry_values():
    # geometry *values* (the x shorthand) through the pair context
    kvs = _kvs()
    geo = geometry.quarter_annulus()
    form = '(1.0 + x[0] * x[1]) * u * v * dx'
    Ae = assemble.assemble(form, kvs, geo=geo, mode='exact')
    Ap = assemble.assemble(form, kvs, geo=geo, mode='ozaki')
    _parity(Ae, Ap)


def test_pair_vform_input_field():
    # named coefficient input evaluated on the grid, split host-side
    kvs = _kvs()
    geo = geometry.bspline_quarter_annulus()
    coef = lambda x, y: 1.0 + x * y
    Ae = assemble.assemble('c * u * v * dx', kvs, geo=geo, c=coef,
                           mode='exact')
    Ap = assemble.assemble('c * u * v * dx', kvs, geo=geo, c=coef,
                           mode='ozaki')
    _parity(Ae, Ap)


def test_pair_vform_heat_st():
    kvs = _kvs()
    geo = geometry.quarter_annulus()
    asm = compile_vform(vf_mod.heat_st_vf(2))(kvs, geo=geo)
    assert asm._supports_pair_eval()
    Ae = asm.assemble(mode='exact').asmatrix()
    Ap = asm.assemble(mode='ozaki').asmatrix()
    _parity(Ae, Ap)


def test_pair_vform_boundary_sqrt():
    # boundary integral: SW = gw * norm(...) exercises the two-float sqrt
    kvs = _kvs()
    geo = geometry.quarter_annulus()
    Ae = assemble.assemble('u * v * ds', kvs, geo=geo, boundary='left',
                           mode='exact')
    Ap = assemble.assemble('u * v * ds', kvs, geo=geo, boundary='left',
                           mode='ozaki')
    _parity(Ae, Ap)


@pytest.mark.slow
def test_pair_vform_vector_blocks():
    kvs = _kvs()
    geo = geometry.quarter_annulus()
    asm = compile_vform(vf_mod.divdiv_vf(2))(kvs, geo=geo)
    assert asm._supports_pair_eval()
    Be = asm.assemble(mode='exact')
    Bp = asm.assemble(mode='ozaki')
    for k in Be:
        e, p = Be[k].data, Bp[k].data
        err = np.abs(e - p).max() / np.abs(e).max()
        assert err < 1e-10, (k, err)


@pytest.mark.slow
def test_pair_vform_gating():
    # transcendental builtins and geometry Hessians have no two-float
    # implementation: the pair upgrade must be refused (and mode='ozaki'
    # still assemble correctly through the f64-field Ozaki path)
    kvs = _kvs(n=6)
    geo = geometry.quarter_annulus()

    asm = compile_vform(vf_mod.parse_vf('exp(x[0]) * u * v * dx', kvs,
                                        args={'geo': geo}))(kvs, geo=geo)
    assert not asm._supports_pair_eval()
    _parity(asm.assemble(mode='exact').asmatrix(),
            asm.assemble(mode='ozaki').asmatrix(), tol=1e-9)

    asm2 = compile_vform(vf_mod.parse_vf('inner(hess(u), hess(v)) * dx',
                                         kvs, args={'geo': geo}))(
        kvs, geo=geo)
    assert not asm2._supports_pair_eval()
    _parity(asm2.assemble(mode='exact').asmatrix(),
            asm2.assemble(mode='ozaki').asmatrix(), tol=1e-9)


def test_prune_probe_cached_across_instances():
    # the combo-prune/symmetry probe runs once per (form, input signature)
    # and is reused across assembler instances and space sizes — repeated
    # assembly (hierarchical levels, adaptive loops) must not re-trace it
    from pyiga_jax import compile as C
    from pyiga_jax.compile import compile_vform
    from pyiga_jax.vform import stiffness_vf

    C._PRUNE_CACHE.clear()
    kvs1 = 2 * (bspline.make_knots(2, 0.0, 1.0, 6),)
    kvs2 = 2 * (bspline.make_knots(2, 0.0, 1.0, 11),)
    geo = geometry.quarter_annulus()
    cls = compile_vform(stiffness_vf(2))
    A1 = assemble.assemble_entries(cls(kvs1, geo=geo))
    assert len(C._PRUNE_CACHE) == 1
    A2 = assemble.assemble_entries(cls(kvs2, geo=geo))
    assert len(C._PRUNE_CACHE) == 1        # second size reused the probe
    # cached-plan assembly matches a fresh-probe assembly entrywise
    C._PRUNE_CACHE.clear()
    A2b = assemble.assemble_entries(cls(kvs2, geo=geo))
    assert abs(A2 - A2b).max() < 1e-14


def test_compact_slice_fresh_after_update():
    # update() must invalidate the ACA slice caches — a stale cached field
    # set made compact_slice silently return the OLD geometry's entries
    from pyiga_jax.vform import stiffness_vf

    kvs = 2 * (bspline.make_knots(2, 0.0, 1.0, 5),)
    asm = compile_vform(stiffness_vf(2))(kvs,
                                         geo=geometry.quarter_annulus())
    row_before = asm.compact_slice({0: 1})
    asm.update(geo=geometry.bspline_quarter_annulus())
    row_after = asm.compact_slice({0: 1})
    asm2 = compile_vform(stiffness_vf(2))(
        kvs, geo=geometry.bspline_quarter_annulus())
    row_ref = asm2.compact_slice({0: 1})
    assert abs(row_after - row_ref).max() < 1e-10
    assert abs(row_after - row_before).max() > 1e-6    # geometry did change


def test_assemble_vector_pruned_component():
    # a vector functional that uses only one component: the pruned
    # component's block assembles to zeros instead of KeyError
    from pyiga_jax import assemble
    from pyiga_jax.vform import VForm, dx

    kvs = 2 * (bspline.make_knots(2, 0.0, 1.0, 5),)
    V = VForm(2, arity=1)
    v = V.basisfuns(components=(2,))
    f = V.input('f')
    V.add(f * v[0] * dx)
    b = compile_vform(V)(kvs, geo=geometry.quarter_annulus(),
                         f=lambda x, y: 1.0 + 0 * x).assemble_vector()
    assert b.shape[-1] == 2
    assert abs(b[..., 0]).max() > 0
    assert abs(b[..., 1]).max() == 0
