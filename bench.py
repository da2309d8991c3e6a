"""Benchmark: Poisson stiffness assembly + matrix-free CG solve, on the GPU.

Prints ONE JSON line PER CONFIG (the 3D float64 config LAST).  Each line:

  {"metric": ..., "value": dof/s, "unit": "dof/s", "vs_baseline": ...,
   "t_assembly_ms": ..., "t_solve_ms": ..., "iters": ..., "comparator": ...}

Default configs (override with PYIGA_BENCH_CONFIGS="dim,n,dtype;..."):
  2,128,float64   - 2D p=3 quarter annulus (BASELINE config-1 shape)
  3,48,float32    - 3D p=3 twisted box, float32
  3,48,float64    - 3D p=3 twisted box, entry-parity dtype

Timed on the first GPU, per phase, with ``jax.block_until_ready``:
  1. sum-factorization assembly of the compact stiffness tensor in native
     float64 (or float32): one jit of the folded contraction chains.
  2. CG to 1e-8 on the interior dofs: float64 runs float32 matrix-free
     Krylov iterations with device-fused iterative refinement whose
     float64 residuals use the banded operator; float32 runs plain
     matrix-free CG.  Both use the geometry-weighted fast-diagonalization
     preconditioner.

The run fails when JAX finds no GPU; it never falls back to the CPU.  The
device identity and the card's name and power limit are printed first.

COMPARATOR CAVEAT (vs_baseline): the reference's own CPU path (Cython
-O3 -march=native -ffast-math + OpenMP + MKL PARDISO,
/root/reference/setup.py:11, operators.py:252-262) cannot be built in
this image (no Cython/MKL), so vs_baseline is measured against the SAME
jitted computation on the host CPU backend at the SAME problem size.
JAX-on-CPU is a weaker baseline than Cython+MKL for assembly but
comparable for the Krylov solve; treat the ratio as indicative.
"""

import json
import os
import subprocess
import sys
import time

import numpy as np


def build(dim, n, p=3):
    from pyiga_jax import geometry
    from pyiga_jax.assemblers import StiffnessAssembler
    from pyiga_jax.bspline import make_knots

    kvs = dim * (make_knots(p, 0.0, 1.0, n),)
    geo = geometry.twisted_box() if dim == 3 else geometry.quarter_annulus()
    asm = StiffnessAssembler(kvs, geo)
    ndofs = int(np.prod([kv.numdofs for kv in kvs]))
    return asm, ndofs


def card_identity():
    """``(name, power limit)`` of the first card as nvidia-smi reports
    them (``--query-gpu=name,power.limit``)."""
    out = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'],
        capture_output=True, text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def require_gpu():
    """The first JAX device, which must be a GPU; exits otherwise."""
    import jax
    dev = jax.devices()[0]
    if dev.platform != 'gpu':
        sys.exit('no GPU found: JAX reports %r devices; this measurement '
                 'runs only on the GPU' % dev.platform)
    return dev


def banded_fibers(asm, D, nfibers, seed=12345):
    """Entry parity of a banded stiffness tensor: ``nfibers`` random banded
    fibers (all ``(mu_1, i_1)`` for fixed trailing ``(mu_k, i_k)``) of the
    device tensor `D` (``(b..., n...)`` layout) against an exact float64
    evaluation of the same fibers on the CPU device (per-term
    rank-1-restricted sum factorization, independent of the assembly
    under test).  Returns the max abs error over the largest exact entry."""
    import jax
    import jax.numpy as jnp
    from pyiga_jax.ops.banded import band_info

    dim = asm.dim
    bws = band_info(asm.structure)
    ns = tuple(b[0] for b in asm.structure.bs)
    bsz = tuple(2 * bw + 1 for bw in bws)
    rng = np.random.RandomState(seed)
    rows = [[int(rng.randint(b * m)) for b, m in zip(bsz[1:], ns[1:])]
            for _ in range(nfibers)]
    got = []
    for r in rows:
        mus = tuple(rk // m for rk, m in zip(r, ns[1:]))
        iis = tuple(rk % m for rk, m in zip(r, ns[1:]))
        fib = D[(slice(None),) + mus + (slice(None),) + iis]
        got.append(np.asarray(fib, dtype=np.float64).reshape(-1))

    cpu = jax.devices('cpu')[0]
    with jax.default_device(cpu):
        btabs = asm.tables.banded_term_tables(asm.terms, bws)
        gi = jax.tree_util.tree_map(
            lambda a: jnp.asarray(np.asarray(a, np.float64))
            if np.issubdtype(np.asarray(a).dtype, np.floating)
            else jnp.asarray(np.asarray(a)), asm._geo_inputs)
        fields = jax.jit(asm.field_fn)(gi)
        exact = []
        for r in rows:
            fib = 0.0
            for t, tabs in enumerate(btabs):
                C = fields[t]
                for k in range(dim - 1, 0, -1):     # contract trailing axes
                    C = jnp.tensordot(C, jnp.asarray(tabs[k][r[k - 1]]),
                                      axes=(k, 0))
                fib = fib + jnp.asarray(tabs[0]) @ C
            exact.append(np.asarray(fib))
    # global scale: a fiber whose fixed rows sit in the band padding is
    # legitimately all-zero (both sides), so normalize by the largest
    # exact entry across fibers instead of per-fiber (no 0/0)
    scale = max(max(float(np.abs(e).max()) for e in exact), 1e-300)
    return max(float(np.abs(g - e).max()) for g, e in zip(got, exact)) / scale


def run_on(device, dim, n, dtype, repeats=3, measure_split=True):
    import jax
    from pyiga_jax.ops import sumfac
    from pyiga_jax.ops.banded import (BandedOperator, band_info,
                                      banded_from_compact_device,
                                      banded_gather_maps)
    from pyiga_jax.ops.fastdiag import (fastdiag_precond_weighted,
                                        interior_dofs)
    from pyiga_jax.ops.matfree import MatrixFreeOperator, RestrictedOperator
    from pyiga_jax import solvers

    with jax.default_device(device):
        asm, ndofs = build(dim, n)
        gi = jax.tree_util.tree_map(
            lambda a: jax.device_put(
                np.asarray(a, dtype=dtype)
                if np.issubdtype(np.asarray(a).dtype, np.floating)
                else np.asarray(a), device),
            asm._geo_inputs)

        fold_plan, tperms = asm._fold()
        tperms_d = [jax.device_put(np.asarray(p), device) for p in tperms]
        tt_np = asm.tables.term_tables(asm.terms)
        li = sumfac.last_table_groups(tt_np)
        tt = jax.tree_util.tree_map(
            lambda a: jax.device_put(np.asarray(a, dtype=dtype), device),
            tt_np)
        field_fn = asm.field_fn
        jfn = jax.jit(lambda gi, tt, tp: sumfac.assemble_terms_folded(
            tt, field_fn(gi), tuple(fold_plan), tp, mode='exact',
            last_idx=li))

        def asm_fn(gi):
            return jfn(gi, tt, tperms_d)

        # homogeneous-Dirichlet solve on the interior dofs
        kvs = asm.kvs
        free = interior_dofs(kvs)
        b = jax.device_put(
            np.random.RandomState(0).rand(len(free)).astype(dtype), device)
        bws = band_info(asm.structure)
        ns = tuple(bk[0] for bk in asm.structure.bs)
        bsz = tuple(2 * bw + 1 for bw in bws)
        maps = [jax.device_put(m, device)
                for m in banded_gather_maps(asm.structure, bws)]
        to_banded = jax.jit(
            lambda d: banded_from_compact_device(d, maps, bsz, ns))
        if dtype == np.float64:
            # f32 matrix-free Krylov + f64 refinement with banded residuals
            op_hi = RestrictedOperator(BandedOperator(None, bws, ns), free,
                                       int(np.prod(ns)))
            op = MatrixFreeOperator(asm, free_dofs=free, dtype=np.float32)
            P = fastdiag_precond_weighted(asm, dirichlet=True,
                                          dtype=np.float32)

            def solve(data):
                op_hi.operands['inner']['D'] = to_banded(data)
                u, info = solvers.cg_ir(op_hi, op, b, tol=1e-8,
                                        precond_lo=P, inner_tol=3e-3,
                                        fetch_info=False)
                return u, info
        else:
            op = MatrixFreeOperator(asm, free_dofs=free)
            P = fastdiag_precond_weighted(asm, dirichlet=True)

            def solve(data):
                u, it = solvers.cg_jit(op, b, tol=1e-8, maxiter=600,
                                       precond=P)
                return u, it

        def count_iters(info):
            if hasattr(info, 'shape') and getattr(info, 'ndim', 0):
                return sum(solvers.cg_ir_info(info)['inner_iters'])
            return int(info)

        # warmup / compile
        data = jax.block_until_ready(asm_fn(gi))
        u, info = jax.block_until_ready(solve(data))
        iters = count_iters(info)

        t_tot = np.inf
        for _ in range(repeats):
            data = u = None
            t0 = time.perf_counter()
            data = asm_fn(gi)
            jax.block_until_ready(solve(data))
            t_tot = min(t_tot, time.perf_counter() - t0)

        # phase split
        t_asm = t_slv = np.inf
        for _ in range(repeats if measure_split else 0):
            data = u = None
            t0 = time.perf_counter()
            data = jax.block_until_ready(asm_fn(gi))
            t1 = time.perf_counter()
            jax.block_until_ready(solve(data))
            t2 = time.perf_counter()
            t_asm = min(t_asm, t1 - t0)
            t_slv = min(t_slv, t2 - t1)

        # entry-parity evidence for sizes with no practical CPU
        # comparator: device fibers vs exact f64 on the CPU device
        extra = {}
        if (dtype == np.float64 and device.platform == 'gpu'
                and (n >= 64 or os.environ.get('PYIGA_BENCH_SPOT'))):
            extra['parity_max_rel'] = float('%.3g' % banded_fibers(
                asm, to_banded(data), nfibers=2))
    return ndofs, t_asm, t_slv, t_tot, iters, extra


def run_aca(device, dim, n, p=3):
    """BASELINE config 3: fast low-rank (ACA) assembly of the 3D stiffness
    matrix over the reordered compact tensor (reference fastasm.cc:385).
    The host (or, on the GPU, device-resident) pivot loop fetches whole
    fibers/slices of the compact tensor, each as ONE sum-factorized device
    call (compile.compact_slice), and the approximation accumulates as
    crosses so the dense compact tensor is only inflated once at the end."""
    import jax
    from pyiga_jax import geometry, lowrank
    from pyiga_jax.bspline import make_knots
    from pyiga_jax.compile import compile_vform
    from pyiga_jax.vform import stiffness_vf

    with jax.default_device(device):
        kvs = dim * (make_knots(p, 0.0, 1.0, n),)
        geo = geometry.twisted_box() if dim == 3 else \
            geometry.quarter_annulus()
        asm = compile_vform(stiffness_vf(dim))(kvs, geo=geo)
        ndofs = int(np.prod([kv.numdofs for kv in kvs]))
        S = asm.structure
        total = int(np.prod([len(bx) for bx in S.bidx]))

        if dim == 3 and device.platform == 'gpu':
            # device-resident outer loop: the whole pivot loop as one
            # fused dispatch; crosses pulled once at the end
            import pyiga_jax.lowrank as lr

            # warm the fused-step compile outside the timing (same maxiter:
            # the cross-buffer shapes are part of the compiled signature)
            X = lr.aca_3d_device(asm, tol=1e-10, verbose=0)
            pivots, calls = [0], [0]
            t0 = time.perf_counter()
            _mk_step = lr._aca_device_step
            _mk_loop = lr._aca_device_loop
            _inflate = lr._aca_inflate

            def counting_mk(_orig):
                def mk(*a, **k):
                    fn = _orig(*a, **k)

                    def wrapped(*aa, **kk):
                        calls[0] += 1
                        return fn(*aa, **kk)
                    return wrapped
                return mk

            def counting_inflate(cols, mats, count, shp):
                # accepted crosses = outer pivots taken (the fused
                # while_loop path surfaces no per-pivot verdicts)
                pivots[0] = int(count)
                return _inflate(cols, mats, count, shp)

            lr._aca_device_step = counting_mk(_mk_step)
            lr._aca_device_loop = counting_mk(_mk_loop)
            lr._aca_inflate = counting_inflate
            try:
                X = lr.aca_3d_device(asm, tol=1e-10, verbose=0)
            finally:
                lr._aca_device_step = _mk_step
                lr._aca_device_loop = _mk_loop
                lr._aca_inflate = _inflate
            t = time.perf_counter() - t0
            # per PIVOT: one fiber + one full 2D slice evaluation (all
            # pivots run inside ONE fused while_loop dispatch on this
            # path, so dispatches != pivots — both are reported)
            frac = pivots[0] * (S.bidx[0].shape[0]
                                + total // S.bidx[0].shape[0]) / total
            del X
            return ndofs, t, calls[0], frac, pivots[0]

        count = [0, 0]

        def counting_slice(fixed, _inner=asm.compact_slice):
            out = _inner(fixed)
            count[0] += int(np.asarray(out).size)
            count[1] += 1
            return out

        gen = lowrank.TensorGenerator(tuple(len(bx) for bx in S.bidx),
                                      slicefunc=counting_slice)
        # warm the slice-pattern compile caches outside the timing
        counting_slice({0: 0})
        counting_slice({1: 0, 2: 0} if dim == 3 else {1: 0})
        count[0] = count[1] = 0
        t0 = time.perf_counter()
        if dim == 3:
            X = lowrank.aca_3d(gen, tol=1e-10, verbose=0)
        else:
            X = lowrank.aca(gen, tol=1e-10, verbose=0)
        t = time.perf_counter() - t0
        del X
    return ndofs, t, count[1], count[0] / total, None


def run_vform(device, n=128, p=3):
    """BASELINE config 2: a generic string-compiled form (convection-
    diffusion + reaction on the exact-NURBS quarter annulus) through the
    vform -> contraction-plan pipeline in native float64
    (compile.VFormAssembler).  Times the device assembly dispatch (one
    jit; the host pull of the compact tensor is excluded)."""
    import jax
    from pyiga_jax import geometry
    from pyiga_jax.assemble import instantiate_assembler
    from pyiga_jax.bspline import make_knots

    with jax.default_device(device):
        kvs = 2 * (make_knots(p, 0.0, 1.0, n),)
        geo = geometry.quarter_annulus()
        form = '(inner(grad(u), grad(v)) + dot(b, grad(u)) * v + u * v) * dx'
        asm = instantiate_assembler(form, kvs, {'geo': geo,
                                                'b': np.array([3.0, -2.0])},
                                    None, None)
        ndofs = int(np.prod([kv.numdofs for kv in kvs]))

        def run():
            jax.block_until_ready(asm.run_device('exact'))

        run()     # warm/compile
        t_best = np.inf
        for _ in range(3):
            t0 = time.perf_counter()
            run()
            t_best = min(t_best, time.perf_counter() - t0)
    return ndofs, t_best


def run_localmg(device, p=3, n0=24, disparity=1, num_levels=3):
    """BASELINE config 5: HB-spline hierarchy + local multigrid solve
    (reference test/test_localmg.py workload at a larger size).  Assembly
    through the on-demand hierarchical discretization; on the GPU the whole
    solve is one device program (ops/mg.DeviceMGSolver)."""
    import jax
    from pyiga_jax import geometry, solvers, vform
    from pyiga_jax.bspline import make_knots
    from pyiga_jax.hierarchical import HDiscretization, HSpace

    with jax.default_device(device):
        bdspecs = [(0, 0), (0, 1), (1, 0), (1, 1)]
        hs = HSpace(2 * (make_knots(p, 0.0, 1.0, n0),),
                    disparity=disparity, bdspecs=bdspecs)
        # refine towards the (1, 1) corner, like the reference hierarchies
        for lv in range(num_levels - 1):
            thr = 1.0 - 2.0 ** (-lv - 1)
            hs.refine_region(lv, lambda *X: min(X) > thr)
        ndofs = hs.numdofs

        def build():
            hd = HDiscretization(hs, vform.stiffness_vf(dim=2),
                                 {'geo': geometry.unit_square(),
                                  'f': lambda *x: 1.0})
            return hd.assemble_matrix(), hd.assemble_rhs()

        build()                         # warm the per-shape jit caches
        build()                         # second warm: lazy caches settle
        t_asm = np.inf
        for _ in range(3):              # min over repeats (variance control)
            t0 = time.perf_counter()
            A, f = build()
            t_asm = min(t_asm, time.perf_counter() - t0)

        backend = 'host' if device.platform == 'cpu' else 'device'
        # warm the smoother/jit caches outside the timing
        solvers.solve_hmultigrid(hs, A, f, tol=1e-2, relax_backend=backend)
        t_slv = np.inf
        for _ in range(2):
            t0 = time.perf_counter()
            _u, iters = solvers.solve_hmultigrid(hs, A, f, tol=1e-8,
                                                 relax_backend=backend)
            t_slv = min(t_slv, time.perf_counter() - t0)
    return ndofs, t_asm, t_slv, iters


def run_ns(device, n_el=(16, 32), p=2, tau=5e-2, t_end=1.0):
    """BASELINE config 4: instationary Navier-Stokes (mixed Taylor-Hood
    splines, ROWDAIND2 Rosenbrock DAE stepping; the reference's
    solve-navier-stokes notebook workload).  The convection blocks are
    reassembled each evaluation through updatable assemblers."""
    import importlib.util as ilu
    spec = ilu.spec_from_file_location(
        'bench_ns_example',
        os.path.join(os.path.dirname(os.path.abspath(__file__)),
                     'examples', 'navier_stokes.py'))
    mod = ilu.module_from_spec(spec)
    spec.loader.exec_module(mod)
    import jax

    with jax.default_device(device):
        ns = mod.NavierStokes(n_el=n_el, p=p, Re=20.0)
        ndofs = ns.n_u + ns.n_p
        x0 = ns.initial_state()
        # warm-up step compiles the updatable convection assemblers
        ns.integrate(x0=x0, tau=tau, t_end=tau)
        t = np.inf
        for _ in range(2):          # min over repeats (variance control)
            t0 = time.perf_counter()
            times, _states = ns.integrate(x0=x0, tau=tau, t_end=t_end)
            t = min(t, time.perf_counter() - t0)
        nsteps = len(times) - 1
    return ndofs, nsteps, t, ns.last_backend


def main():
    import pyiga_jax
    import jax

    dev = require_gpu()
    print('# bench: device %s' % json.dumps({
        'platform': dev.platform, 'kind': dev.device_kind,
        'count': len(jax.devices())}), flush=True)
    print('# bench: card %s' % card_identity(), flush=True)
    cpu = jax.devices('cpu')[0]

    spec = os.environ.get('PYIGA_BENCH_CONFIGS')
    if spec:
        configs = [(int(d), int(n), np.dtype(t).type)
                   for d, n, t in (c.split(',') for c in spec.split(';'))]
    else:
        n3 = int(os.environ.get('PYIGA_BENCH_N', '48'))
        n2 = int(os.environ.get('PYIGA_BENCH_N2', '128'))
        configs = [(3, n3, np.float64), (2, n2, np.float64),
                   (3, n3, np.float32)]

    lines = []
    for dim, n, dtype in configs:
        pyiga_jax.set_dtype(dtype)
        ndofs, t_asm, t_slv, t_tot, iters, extra = run_on(dev, dim, n, dtype)
        dofs_per_s = ndofs / t_tot

        vs_baseline = None
        if not os.environ.get('PYIGA_BENCH_NO_CPU'):
            # matched-size comparator on the host CPU backend
            _, _, _, t_cpu, _, _ = run_on(cpu, dim, n, dtype, repeats=1,
                                          measure_split=False)
            vs_baseline = round(t_cpu / t_tot, 3)

        line = json.dumps(dict({
            'metric': '%dd_p3_poisson_assembly_plus_cg[%s,n=%d,cg_iters=%d]'
                      % (dim, np.dtype(dtype).name, n, iters),
            'value': round(dofs_per_s, 1),
            'unit': 'dof/s',
            'vs_baseline': vs_baseline,
            't_assembly_ms': round(1e3 * t_asm, 1),
            't_solve_ms': round(1e3 * t_slv, 1),
            'iters': iters,
            'comparator': 'matched-size JAX-on-CPU (Cython+MKL of the '
                          'reference unavailable; see bench.py docstring)',
        }, **extra))
        lines.append(line)
        print(line, flush=True)

    if not os.environ.get('PYIGA_BENCH_NO_ACA'):
        # BASELINE config 3: low-rank fast assembling (stiffness_fast)
        pyiga_jax.set_dtype(np.float64)
        n_aca = int(os.environ.get('PYIGA_BENCH_ACA_N', '48'))
        ndofs, t, calls, frac, pivots = run_aca(dev, 3, n_aca)
        vs = None
        if not os.environ.get('PYIGA_BENCH_NO_CPU'):
            _, t_cpu, _, _, _ = run_aca(cpu, 3, n_aca)
            vs = round(t_cpu / t, 3)
        line = json.dumps({
            # device_dispatches counts EXECUTIONS of the fused device
            # programs (the whole pivot loop runs as one lax.while_loop
            # dispatch); 'pivots' is the accepted outer-pivot count
            'metric': '3d_p3_stiffness_fast_aca[float64,n=%d,'
                      'device_dispatches=%d]' % (n_aca, calls),
            'value': round(ndofs / t, 1),
            'unit': 'dof/s',
            'vs_baseline': vs,
            't_ms': round(1e3 * t, 1),
            'pivots': pivots,
            'entry_frac': round(frac, 4),
            'comparator': 'matched-size JAX-on-CPU (see bench.py '
                          'docstring)',
        })
        lines.append(line)
        print(line, flush=True)

    if not os.environ.get('PYIGA_BENCH_NO_VFORM'):
        # BASELINE config 2: generic string-compiled form
        pyiga_jax.set_dtype(np.float64)
        n_vf = int(os.environ.get('PYIGA_BENCH_VFORM_N', '128'))
        ndofs, t = run_vform(dev, n_vf)
        vs = None
        if not os.environ.get('PYIGA_BENCH_NO_CPU'):
            _, t_cpu = run_vform(cpu, n_vf)
            vs = round(t_cpu / t, 3)
        line = json.dumps({
            'metric': '2d_p3_convdiff_vform_assembly[float64,n=%d]' % n_vf,
            'value': round(ndofs / t, 1),
            'unit': 'dof/s',
            'vs_baseline': vs,
            't_ms': round(1e3 * t, 1),
            'comparator': 'matched-size JAX-on-CPU (see bench.py '
                          'docstring)',
        })
        lines.append(line)
        print(line, flush=True)

    if not os.environ.get('PYIGA_BENCH_NO_LOCALMG'):
        # BASELINE config 5: hierarchical space + local multigrid
        pyiga_jax.set_dtype(np.float64)
        ndofs, t_asm, t_slv, iters = run_localmg(dev)
        iters = int(iters) if np.isfinite(iters) else -1
        vs = None
        if not os.environ.get('PYIGA_BENCH_NO_CPU'):
            _, ta_c, ts_c, _ = run_localmg(cpu)
            vs = round((ta_c + ts_c) / (t_asm + t_slv), 3)
        line = json.dumps({
            'metric': '2d_p3_hb_localmg_solve[float64,mg_iters=%d]'
                      % iters,
            'value': round(ndofs / (t_asm + t_slv), 1),
            'unit': 'dof/s',
            'vs_baseline': vs,
            't_assembly_ms': round(1e3 * t_asm, 1),
            't_solve_ms': round(1e3 * t_slv, 1),
            'iters': iters,
            'comparator': 'matched-size JAX-on-CPU (see bench.py '
                          'docstring)',
        })
        lines.append(line)
        print(line, flush=True)

    # scale: 3D f64 at n=96 (~970k dofs, ~8x the n=48 config).  No CPU
    # comparator at this size; correctness evidence is the in-line entry
    # parity spot check against exact f64 on the CPU (parity_max_rel).
    n_large = int(os.environ.get('PYIGA_BENCH_N_LARGE', '96'))
    if n_large and not spec:
        pyiga_jax.set_dtype(np.float64)
        ndofs, t_asm, t_slv, t_tot, iters, extra = run_on(
            dev, 3, n_large, np.float64, repeats=2)
        line = json.dumps(dict({
            'metric': '3d_p3_poisson_assembly_plus_cg[float64,n=%d,'
                      'cg_iters=%d]' % (n_large, iters),
            'value': round(ndofs / t_tot, 1),
            'unit': 'dof/s',
            'vs_baseline': None,
            't_assembly_ms': round(1e3 * t_asm, 1),
            't_solve_ms': round(1e3 * t_slv, 1),
            'iters': iters,
            'comparator': 'none at this size (see parity_max_rel: '
                          'device fibers vs exact f64 on the CPU)',
        }, **extra))
        lines.append(line)
        print(line, flush=True)

    if not os.environ.get('PYIGA_BENCH_NO_NS'):
        # BASELINE config 4: instationary Navier-Stokes time stepping
        pyiga_jax.set_dtype(np.float64)
        ndofs, nsteps, t, backend = run_ns(dev)
        vs = None
        if not os.environ.get('PYIGA_BENCH_NO_CPU'):
            _, nsteps_c, t_c, _ = run_ns(cpu)
            vs = round((t_c / max(nsteps_c, 1))
                       / (t / max(nsteps, 1)), 3)
        line = json.dumps({
            'metric': '2d_navier_stokes_rosenbrock[float64,steps=%d]'
                      % nsteps,
            'value': round(ndofs * nsteps / t, 1),
            'unit': 'dof-steps/s',
            'vs_baseline': vs,
            't_per_step_ms': round(1e3 * t / max(nsteps, 1), 1),
            'backend': backend,
            'comparator': 'matched-size JAX-on-CPU (see bench.py '
                          'docstring)',
        })
        lines.append(line)
        print(line, flush=True)

    # re-print every metric line as one final block, the 3D f64 line last
    if len(lines) > 1:
        print('# bench: all metric lines (final block)', flush=True)
        headline = next((ln for ln in lines
                         if '3d_p3_poisson' in ln and 'float64' in ln), None)
        for ln in lines:
            if ln is not headline:
                print(ln, flush=True)
        if headline is not None:
            print(headline, flush=True)


if __name__ == '__main__':
    main()
