#!/usr/bin/env python3
"""On-card smoke test of pyiga_jax: the 3D Poisson path on one NVIDIA GPU.

    python chip_smoke.py          # every one-card phase
    python chip_smoke.py --four   # only the sharded path on four cards

Drives the 3D p=3 Poisson problem on the twisted box (sum-factorization
assembly + preconditioned CG) through the public API at n=48 and n=96 in
float64 and at n=48 in float32, plus the golden fixtures and the paths off
the main one, and checks each result against an exact float64 reference
on the CPU device of the same process.  Every result line carries the
card's name and power limit (``nvidia-smi``).  Any failed phase makes the
script exit non-zero; the last line of a passing run is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
With no GPU it fails at once and prints no result.  One process drives
the card(s); nothing else opens them.
"""

import argparse
import json
import os
import subprocess
import sys
import time
import traceback

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
CARD = '?'


def report(msg):
    print('[%s] %s' % (CARD, msg), flush=True)


def check(ok, msg):
    if not ok:
        raise AssertionError(msg)


def rel_err(a, b):
    a = a.toarray() if hasattr(a, 'toarray') else np.asarray(a, np.float64)
    b = b.toarray() if hasattr(b, 'toarray') else np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / np.abs(b).max())


def cpu_device():
    import jax
    return jax.devices('cpu')[0]


def poisson_assembler(n, p=3):
    from pyiga_jax import bspline, geometry
    from pyiga_jax.assemblers import StiffnessAssembler
    kvs = 3 * (bspline.make_knots(p, 0.0, 1.0, n),)
    return StiffnessAssembler(kvs, geometry.twisted_box()), kvs


def poisson_solve(asm, kvs, op):
    """Dirichlet Poisson on the interior dofs: f32 banded Krylov with the
    geometry-weighted fast-diagonalization preconditioner, refined to
    float64 by cg_ir against the float64 banded operator `op`."""
    import jax.numpy as jnp
    from pyiga_jax import solvers
    from pyiga_jax.ops.banded import BandedOperator
    from pyiga_jax.ops.fastdiag import (fastdiag_precond_weighted,
                                        interior_dofs)
    from pyiga_jax.ops.matfree import RestrictedOperator
    free = interior_dofs(kvs)
    N = int(np.prod(op.ns))
    op_hi = RestrictedOperator(op, free, N)
    op_lo = RestrictedOperator(
        BandedOperator(op.D.astype(jnp.float32), op.bws, op.ns), free, N)
    P = fastdiag_precond_weighted(asm, dirichlet=True, dtype=np.float32)
    b = jnp.asarray(np.random.RandomState(0).rand(len(free)))
    t0 = time.perf_counter()
    u, info = solvers.cg_ir(op_hi, op_lo, b, tol=1e-8, precond_lo=P)
    u.block_until_ready()
    t = time.perf_counter() - t0
    return u, b, free, info, t, op_hi


# ---------------------------------------------------------------- phases --

def phase_golden():
    """assemble.mass / assemble.stiffness vs the reference's golden
    matrices, on the card."""
    from pyiga_jax import assemble, bspline, geometry
    from pyiga_jax.utils import read_sparse_matrix
    cases = [(2, 3, 15, geometry.bspline_quarter_annulus()),
             (3, 2, 10, geometry.twisted_box())]
    for dim, p, n, geo in cases:
        kvs = dim * (bspline.make_knots(p, 0.0, 1.0, n),)
        for kind, fn in (('mass', assemble.mass),
                         ('stiff', assemble.stiffness)):
            name = 'poisson_neu_d%d_p%d_n%d_%s.mtx.gz' % (dim, p, n, kind)
            ref = read_sparse_matrix(os.path.join(REPO, 'tests', 'fixtures',
                                                  name))
            err = float(abs(fn(kvs, geo) - ref).max())
            report('golden %s: max abs error %r (limit 1e-13)' % (name, err))
            check(err <= 1e-13, 'golden %s: %r > 1e-13' % (name, err))


def example_hspace(n0=6, p=3):
    """The HB-spline hierarchy of tests/test_localmg.py (disparity 1)."""
    from pyiga_jax import bspline
    from pyiga_jax.hierarchical import HSpace
    hs = HSpace(2 * (bspline.make_knots(p, 0.0, 1.0, n0),), disparity=1,
                bdspecs=[(0, 0), (0, 1), (1, 0), (1, 1)])
    for lv in range(3):
        hs.refine_region(lv, lambda *X: min(X) > 1 - 0.5 ** (lv + 1))
    return hs


def phase_poisson(state, n=48, n_small=16):
    """3D p=3 float64: compact and banded assembly, 8 banded fibers vs
    exact CPU float64, cg_ir to 1e-8, true residual; at `n_small` the
    iteration counts equal the CPU's."""
    import jax
    import jax.numpy as jnp
    from bench import banded_fibers
    from pyiga_jax.ops.banded import banded_from_compact_device, \
        banded_gather_maps

    asm, kvs = poisson_assembler(n)
    t0 = time.perf_counter()
    K = asm.assemble()
    t_c = time.perf_counter() - t0
    t0 = time.perf_counter()
    op = asm.assemble_banded()
    op.D.block_until_ready()
    t_b = time.perf_counter() - t0
    report('n=%d f64: %d dofs; assemble() %r s, assemble_banded() %r s '
           '(first calls, compile included)' % (n, K.shape[0], t_c, t_b))
    bsz = tuple(2 * bw + 1 for bw in op.bws)
    maps = banded_gather_maps(K.structure, op.bws)
    DK = jax.jit(lambda d: banded_from_compact_device(d, maps, bsz, op.ns))(
        jnp.asarray(K.data))
    err_kb = rel_err(DK, op.D)
    report('n=%d f64: assemble() vs assemble_banded() rel error %r '
           '(limit 1e-12)' % (n, err_kb))
    check(err_kb <= 1e-12, 'compact vs banded %r' % err_kb)
    del DK
    err = banded_fibers(asm, op.D, nfibers=8)
    report('n=%d f64: 8 banded fibers vs exact CPU f64: rel error %r '
           '(limit 1e-12)' % (n, err))
    check(err <= 1e-12, 'fiber parity %r' % err)

    u, b, free, info, t, _ = poisson_solve(asm, kvs, op)
    Kff = K.asmatrix().tocsr()[free][:, free]
    b_np = np.asarray(b)
    res = float(np.linalg.norm(b_np - Kff @ np.asarray(u))
                / np.linalg.norm(b_np))
    report('n=%d f64: cg_ir %d outer / %s inner iterations, %r s (first '
           'call); true f64 residual %r (limit 1e-8)'
           % (n, info['outer'], info['inner_iters'], t, res))
    check(res <= 1e-8, 'residual %r' % res)
    state['asm'], state['kvs'], state['op'] = asm, kvs, op

    counts = {}
    for where in ('gpu', 'cpu'):
        ctx = (jax.default_device(cpu_device()) if where == 'cpu'
               else jax.default_device(jax.devices()[0]))
        with ctx:
            asm_s, kvs_s = poisson_assembler(n_small)
            info_s = poisson_solve(asm_s, kvs_s, asm_s.assemble_banded())[3]
        counts[where] = (info_s['outer'], tuple(info_s['inner_iters']))
    report('n=%d f64: cg_ir iterations (outer, inner) gpu %s cpu %s'
           % (n_small, counts['gpu'], counts['cpu']))
    check(counts['gpu'] == counts['cpu'], 'n=%d counts differ' % n_small)


def phase_float32(state):
    """set_dtype(float32): banded assembly vs float64, cg_jit."""
    import jax.numpy as jnp
    from pyiga_jax import config, solvers
    from pyiga_jax.ops.fastdiag import (fastdiag_precond_weighted,
                                        interior_dofs)
    from pyiga_jax.ops.matfree import RestrictedOperator
    asm, kvs, op64 = state['asm'], state['kvs'], state['op']
    n = len(kvs[0].mesh) - 1
    config.set_dtype(np.float32)
    try:
        op = asm.assemble_banded()
        check(op.D.dtype == jnp.float32, 'dtype %s' % op.D.dtype)
        err = rel_err(op.D, op64.D)
        report('n=%d f32: banded data rel error vs f64 %r (limit 1e-6)'
               % (n, err))
        check(err <= 1e-6, 'f32 assembly %r' % err)
        free = interior_dofs(kvs)
        A = RestrictedOperator(op, free, int(np.prod(op.ns)))
        P = fastdiag_precond_weighted(asm, dirichlet=True, dtype=np.float32)
        b = jnp.asarray(np.random.RandomState(0).rand(len(free)),
                        jnp.float32)
        u, it = solvers.cg_jit(A, b, tol=1e-6, maxiter=600, precond=P)
        res = float(jnp.linalg.norm(b - A.matvec(u)) / jnp.linalg.norm(b))
        # the recomputed f32 residual stops near the rounding floor of a
        # 343-term f32 matvec (~1e-5 at n=48), above the recursive 1e-6
        report('n=%d f32: cg_jit %d iterations to 1e-6, recomputed f32 '
               'residual %r (limit 1e-4)' % (n, int(it), res))
        check(int(it) < 600 and res <= 1e-4, 'f32 solve %r' % res)
    finally:
        config.set_dtype(np.float64)


def phase_poisson_large(n=96):
    """3D p=3 n=96 float64 (~970k dofs) on one card."""
    import jax
    import jax.numpy as jnp
    from bench import banded_fibers
    asm, kvs = poisson_assembler(n)
    t0 = time.perf_counter()
    op = asm.assemble_banded()
    op.D.block_until_ready()
    t_b = time.perf_counter() - t0
    err = banded_fibers(asm, op.D, nfibers=2)
    report('n=%d f64: %d dofs; assemble_banded() %r s (first call); 2 '
           'fibers rel error %r (limit 1e-12)'
           % (n, int(np.prod(op.ns)), t_b, err))
    check(err <= 1e-12, 'fiber parity %r' % err)
    u, b, free, info, t, op_hi = poisson_solve(asm, kvs, op)
    res = float(jnp.linalg.norm(b - op_hi.matvec(u)) / jnp.linalg.norm(b))
    peak = (jax.devices()[0].memory_stats() or {}).get('peak_bytes_in_use')
    report('n=%d f64: cg_ir %d outer / %s inner iterations, %r s (first '
           'call); f64 residual %r (limit 1e-8); peak_bytes_in_use %s'
           % (n, info['outer'], info['inner_iters'], t, res, peak))
    check(res <= 1e-8, 'residual %r' % res)


def phase_matvec(state):
    """Streaming rate of both XLA banded matvec forms at n=48 f64 beside
    a device copy measured in the same run."""
    import jax
    import jax.numpy as jnp
    from pyiga_jax.ops.banded import banded_matvec, banded_matvec_static
    op = state['op']
    D = op.D
    x = jnp.asarray(np.random.RandomState(1).rand(int(np.prod(op.ns))))
    reps = 50

    def rate(fn, nbytes):
        jax.block_until_ready(fn())            # compile + warm
        jax.block_until_ready(fn())
        t0 = time.perf_counter()
        for _ in range(reps):
            y = fn()
        jax.block_until_ready(y)
        t = (time.perf_counter() - t0) / reps
        return t, nbytes / t / 1e9

    copy = jax.jit(lambda a: a + 1.0)
    t_cp, gbs_cp = rate(lambda: copy(D), 2 * D.nbytes)
    report('device copy of the banded data (%d B read + written): '
           '%r ms, %r GB/s' % (D.nbytes, 1e3 * t_cp, gbs_cp))
    nbytes = D.nbytes + 2 * x.nbytes
    y_ref = None
    for name, fn in (('banded_matvec', banded_matvec),
                     ('banded_matvec_static', banded_matvec_static)):
        t, gbs = rate(lambda: fn(D, x, op.bws, op.ns), nbytes)
        y = fn(D, x, op.bws, op.ns)
        y_ref = y if y_ref is None else y_ref
        err = rel_err(y, y_ref)
        report('%s f64 (%d B data+x+y): %r ms, %r GB/s, %r of the '
               'copy rate; rel diff to banded_matvec %r'
               % (name, nbytes, 1e3 * t, gbs, gbs / gbs_cp, err))
        check(err <= 1e-13, '%s disagrees: %r' % (name, err))


def phase_off_main_path(n_aca=16, n_vf=64):
    """ACA, the string-compiled convection-diffusion form, the device
    local-MG solve, on the card."""
    import jax
    from pyiga_jax import assemble, bspline, geometry, lowrank, solvers, vform
    from pyiga_jax.compile import compile_vform
    from pyiga_jax.hierarchical import HDiscretization

    kvs = 3 * (bspline.make_knots(3, 0.0, 1.0, n_aca),)
    asm = compile_vform(vform.stiffness_vf(3))(kvs,
                                               geo=geometry.twisted_box())
    t0 = time.perf_counter()
    A_aca = lowrank.fast_assemble(asm, kvs, tol=1e-10, verbose=0)
    t = time.perf_counter() - t0
    err = rel_err(A_aca, asm.assemble().asmatrix())
    report('ACA fast_assemble 3D n=%d: rel error %r (limit 1e-9), %r s '
           '(first call)' % (n_aca, err, t))
    check(err <= 1e-9, 'ACA %r' % err)

    kvs2 = 2 * (bspline.make_knots(3, 0.0, 1.0, n_vf),)
    form = '(inner(grad(u), grad(v)) + dot(b, grad(u)) * v + u * v) * dx'
    args = dict(geo=geometry.quarter_annulus(), b=np.array([3.0, -2.0]))
    A_gpu = assemble.assemble(form, kvs2, **args)
    with jax.default_device(cpu_device()):
        A_cpu = assemble.assemble(form, kvs2, **args)
    err = rel_err(A_gpu, A_cpu)
    report('convection-diffusion vform 2D n=%d: rel error vs CPU exact %r '
           '(limit 1e-12)' % (n_vf, err))
    check(err <= 1e-12, 'vform %r' % err)

    hs = example_hspace()
    for truncate in (False, True):
        hs.truncate = truncate
        hd = HDiscretization(hs, vform.stiffness_vf(dim=2),
                             {'geo': geometry.unit_square(),
                              'f': lambda *x: 1.0})
        A = hd.assemble_matrix()
        f = hd.assemble_rhs()
        u_h, it_h = solvers.solve_hmultigrid(hs, A, f, tol=1e-8,
                                             relax_backend='host')
        u_d, it_d = solvers.solve_hmultigrid(hs, A, f, tol=1e-8,
                                             relax_backend='device')
        err = float(np.abs(u_d - u_h).max())
        report('local MG truncate=%s: device %s / host %s iterations, max '
               'solution diff %r' % (truncate, it_d, it_h, err))
        check(it_d == it_h and err <= 1e-10, 'local MG counts/solution')


def phase_twofloat(n=8):
    """The two-float modes are refused on the GPU; with the refusal
    bypassed, print how far they land from exact float64 here."""
    from unittest import mock
    import scipy.sparse
    from pyiga_jax import config, geometry, solvers, vform
    from pyiga_jax.hierarchical import HDiscretization
    from pyiga_jax.ops.mg import DeviceMGSolver

    asm, _ = poisson_assembler(n)
    refused = []
    try:
        asm.assemble(mode='ozaki')
    except NotImplementedError as e:
        refused.append(str(e))
    check(len(refused) == 1, "mode='ozaki' was not refused on the GPU")

    hs = example_hspace()
    hd = HDiscretization(hs, vform.stiffness_vf(dim=2),
                         {'geo': geometry.unit_square(),
                          'f': lambda *x: 1.0})
    A = scipy.sparse.csr_matrix(hd.assemble_matrix())
    f = hd.assemble_rhs()
    u_h, it_h = solvers.solve_hmultigrid(hs, A, f, tol=1e-8,
                                         relax_backend='host')
    Ps = hs.virtual_hierarchy_prolongators()
    L = hs.numlevels
    As = [None] * L
    As[L - 1] = A
    for lv in range(L - 2, -1, -1):
        As[lv] = (Ps[lv].T @ As[lv + 1] @ Ps[lv]).tocsr()
    mg_args = (As, Ps, hs.indices_to_smooth('cell_supp'),
               ('forward', 'backward'), 2)
    try:
        DeviceMGSolver(*mg_args, active_dofs=hs.non_dirichlet_dofs(),
                       smoother_impl='df')
    except NotImplementedError as e:
        refused.append(str(e))
    check(len(refused) == 2, "smoother_impl='df' was not refused on the GPU")
    report('two-float modes refused on the GPU: %s' % refused[0])

    with mock.patch.object(config, 'require_twofloat_platform',
                           lambda what: None):
        err = rel_err(asm.assemble(mode='ozaki').asmatrix(),
                      asm.assemble(mode='exact').asmatrix())
        s = DeviceMGSolver(*mg_args, active_dofs=hs.non_dirichlet_dofs(),
                           smoother_impl='df')
        u_d, it_d = s.solve(f, tol=1e-8)
    report("with the refusal bypassed: mode='ozaki' 3D n=%d rel error vs "
           "exact %r (needs <= 1e-10); 'df' V-cycle %s / host %s "
           "iterations, max solution diff %r"
           % (n, err, it_d, it_h, float(np.abs(u_d - u_h).max())))


def phase_four(n=48):
    """sharded_stiffness_step and sharded_matfree_cg over a one-axis
    'space' mesh of four cards vs the same programs on one card."""
    import jax
    import jax.numpy as jnp
    from pyiga_jax import parallel
    from pyiga_jax.assemblers import MassAssembler
    from pyiga_jax.ops.fastdiag import fastdiag_precond

    asm, kvs = poisson_assembler(n)
    # the mass system is SPD on the full, grid-sharded dof tensor; with a
    # dominant shift the fast-diagonalization preconditioner is the
    # inverse parameter-domain mass matrix
    masm = MassAssembler(kvs, asm.geo)
    precond = fastdiag_precond(kvs, mass_shift=1e12)
    b = jnp.asarray(np.random.RandomState(1).rand(
        int(np.prod([kv.numdofs for kv in kvs]))))
    out = {}
    for ndev in (4, 1):
        mesh = parallel.make_mesh(ndev, shape=(ndev,),
                                  axis_names=('space',))
        step, args = parallel.sharded_stiffness_step(asm, mesh, cg_iters=8)
        solve, ops = parallel.sharded_matfree_cg(masm, mesh, precond=precond,
                                                 tol=1e-8, maxiter=500)
        ops = jax.tree_util.tree_map(jnp.asarray, ops)
        with mesh:
            t0 = time.perf_counter()
            data, X = jax.block_until_ready(
                jax.jit(step)(*jax.tree_util.tree_map(jnp.asarray, args)))
            t_step = time.perf_counter() - t0
            t0 = time.perf_counter()
            x, it = jax.block_until_ready(jax.jit(solve)(ops, b))
            t_cg = time.perf_counter() - t0
        out[ndev] = (np.asarray(data), np.asarray(X), np.asarray(x), int(it))
        report('%d card(s), 3D p=3 n=%d f64: sharded_stiffness_step %r s, '
               'sharded_matfree_cg %d iterations %r s (first calls)'
               % (ndev, n, t_step, int(it), t_cg))
    errs = [rel_err(a, b_) for a, b_ in zip(out[4][:3], out[1][:3])]
    report('4 vs 1 card: rel error data %r, CG-step X %r, CG solution %r '
           '(limit 1e-10); CG iterations %d vs %d'
           % (errs[0], errs[1], errs[2], out[4][3], out[1][3]))
    check(max(errs) <= 1e-10, 'four-card parity %r' % errs)


# ------------------------------------------------------------------ main --

def main():
    global CARD
    parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    parser.add_argument('--four', action='store_true',
                        help='run only the sharded path on four cards')
    args = parser.parse_args()

    sys.path.insert(0, REPO)
    import pyiga_jax
    from pyiga_jax import config
    import jax

    devs = jax.devices()
    if devs[0].platform != 'gpu':
        print('chip_smoke: no GPU found (JAX reports %r devices)'
              % devs[0].platform, file=sys.stderr)
        return 2
    want = 4 if args.four else 1
    if len(devs) < want:
        print('chip_smoke: %d GPU(s) found, %d needed' % (len(devs), want),
              file=sys.stderr)
        return 2
    CARD = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(CARD, flush=True)
    dev = devs[0]
    report('device: platform %s, kind %s, count %d; pyiga_jax %s, jax %s'
           % (dev.platform, dev.device_kind, len(devs),
              pyiga_jax.__version__, jax.__version__))
    # every assembly runs on the card, however small
    config.set_host_assembly_cutoff(0)

    state = {}
    if args.four:
        phases = [('four cards', phase_four)]
    else:
        phases = [('golden parity', phase_golden),
                  ('poisson n=48 f64', lambda: phase_poisson(state)),
                  ('poisson n=48 f32', lambda: phase_float32(state)),
                  ('banded matvec rate', lambda: phase_matvec(state)),
                  ('poisson n=96 f64', phase_poisson_large),
                  ('off the main path', phase_off_main_path),
                  ('two-float modes', phase_twofloat)]
    failed = []
    for name, fn in phases:
        t0 = time.perf_counter()
        try:
            fn()
        except Exception:
            traceback.print_exc()
            failed.append(name)
            report('phase %s: FAILED' % name)
        else:
            report('phase %s: passed (%.1f s)'
                   % (name, time.perf_counter() - t0))
    print(CARD, flush=True)
    if failed:
        print('chip_smoke: failed phases: %s' % ', '.join(failed),
              file=sys.stderr)
        return 1
    print(json.dumps({'ok': True, 'device': {
        'platform': dev.platform, 'kind': dev.device_kind,
        'count': len(devs)}}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
