"""Command-line tools.

``str2asm_main`` is the analog of the reference's ``scripts/str2asm.py``
(there: expression string -> generated Cython assembler source; here the
"code" is the lowered sum-factorization contraction plan).
"""

import argparse


def str2asm_main(argv=None):
    ap = argparse.ArgumentParser(
        description='parse a variational-form expression string and dump '
                    'its lowered assembly plan')
    ap.add_argument('expr', help='variational form expression string')
    ap.add_argument('--dim', type=int, default=2, help='space dimension')
    ap.add_argument('--nspans', type=int, default=4,
                    help='knot spans per axis for the probe space')
    ap.add_argument('--degree', type=int, default=2, help='spline degree')
    ap.add_argument('--boundary', default=None,
                    help="boundary spec (e.g. 'left') for boundary integrals")
    ap.add_argument('--dumptree', action='store_true',
                    help='print the expression tree')
    ap.add_argument('--hlo', action='store_true',
                    help='print the lowered StableHLO of the assembly '
                         'kernel (the analog of dumping generated source)')
    args = ap.parse_args(argv)

    import contextlib
    import sys

    import jax
    ctx = contextlib.nullcontext()
    try:
        # scoped pin (a global jax_default_device mutation would leak the
        # CPU pin into the calling process)
        ctx = jax.default_device(jax.devices('cpu')[0])
    except RuntimeError:
        print('note: no CPU backend in this process; the plan dump runs '
              'on the default backend (use a fresh process with '
              'JAX_PLATFORMS=cpu for a cheap dump)', file=sys.stderr)
    with ctx:
        return _str2asm_body(args)


def _str2asm_body(args):
    import jax
    from pyiga_jax import bspline, geometry, vform
    from pyiga_jax.compile import compile_vform

    kvs = args.dim * (bspline.make_knots(args.degree, 0.0, 1.0, args.nspans),)
    geo = geometry.identity([kv.support() for kv in reversed(kvs)])

    vf = vform.parse_vf(args.expr, kvs, {'geo': geo},
                        boundary=bool(args.boundary))
    print('dim=%d arity=%d vec=%s max_deriv=%d hash=%x'
          % (vf.dim, vf.arity, vf.vec, vf.max_deriv_order(),
             vf.hash() & 0xffffffffffffffff))
    if args.dumptree:
        for e in vf.exprs:
            print('  expr:', e)
    print('field keys:', sorted(map(str, vf.used_field_keys())))

    cls = compile_vform(vf)
    kwargs = {'geo': geo}
    if args.boundary:
        from pyiga_jax.assemble import _Jac_to_boundary_matrix
        bdspec = bspline._parse_bdspec(args.boundary, args.dim)
        kwargs['boundary'] = bdspec
        kwargs['Jac_to_boundary'] = _Jac_to_boundary_matrix(bdspec, args.dim)
    asm = cls(kvs, **kwargs)

    print('assembly plan: %d term(s) after pruning '
          '(of %d derivative/component combinations)'
          % (len(asm.combos), asm._num_combos_total))
    for su, sv in asm.combos:
        print('  term: trial seed %s  x  test seed %s' % (su, sv))

    if args.hlo:
        import jax.numpy as jnp
        fn = asm._assembly_fn('exact')
        inputs = jax.tree_util.tree_map(
            lambda x: jnp.asarray(x), asm._device_inputs())
        tts = jax.tree_util.tree_map(
            lambda x: jnp.asarray(x), asm._term_tables_for(asm.combos))
        fold = getattr(asm, '_fold_plan', None)
        tperms = ([jnp.asarray(p) for p in asm._fold_tperms]
                  if fold is not None else None)
        print()
        print(jax.jit(fn).lower(inputs, tts, tperms).as_text())
