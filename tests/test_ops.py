import pytest
import numpy as np
import jax
import jax.numpy as jnp

from pyiga_jax import geometry, solvers
from pyiga_jax.assemblers import MassAssembler, StiffnessAssembler
from pyiga_jax.bspline import make_knots
from pyiga_jax.mlmatrix import MLStructure
from pyiga_jax.ops.banded import BandedOperator, band_info
from pyiga_jax.ops.matfree import MatrixFreeOperator


def _setup(p=3, n=5, d=3):
    kvs = d * (make_knots(p, 0.0, 1.0, n),)
    geo = geometry.twisted_box() if d == 3 else geometry.quarter_annulus()
    return kvs, geo


def test_banded_matvec():
    kvs, geo = _setup(p=2, n=6)
    asm = StiffnessAssembler(kvs, geo)
    K = asm.assemble()
    assert band_info(K.structure) == [2, 2, 2]
    x = np.random.rand(K.shape[1])
    y_ref = K.asmatrix() @ x

    # conversion path
    op = BandedOperator.from_mlmatrix(K)
    assert np.allclose(np.asarray(op.matvec(jnp.asarray(x))), y_ref)

    # direct banded assembly path
    op2 = asm.assemble_banded()
    assert np.allclose(np.asarray(op2.matvec(jnp.asarray(x))), y_ref)


def _dense_from_banded(D, bws, ns):
    """Plain reference: the dense matrix of a banded tensor
    ``D[mu..., i...]``, entry ``(i, j)`` with ``j_k = i_k + mu_k - bw_k``."""
    N = int(np.prod(ns))
    A = np.zeros((N, N))
    for mu in np.ndindex(*[2 * bw + 1 for bw in bws]):
        for i in np.ndindex(*ns):
            j = tuple(ik + mk - bw for ik, mk, bw in zip(i, mu, bws))
            if all(0 <= jk < n for jk, n in zip(j, ns)):
                A[np.ravel_multi_index(i, ns),
                  np.ravel_multi_index(j, ns)] = D[mu + i]
    return A


@pytest.mark.parametrize('dtype', [np.float32, np.float64])
@pytest.mark.parametrize('p', [2, 3])
@pytest.mark.parametrize('dim', [2, 3])
@pytest.mark.parametrize('form', ['fori', 'static'])
def test_banded_matvec_forms_vs_dense(form, dim, p, dtype):
    from pyiga_jax.ops.banded import banded_matvec, banded_matvec_static
    fn = banded_matvec if form == 'fori' else banded_matvec_static
    bws = dim * (p,)
    ns = (p + 4, p + 3, p + 2)[:dim]
    rng = np.random.RandomState(dim * 10 + p)
    D = rng.rand(*([2 * p + 1] * dim + list(ns))).astype(dtype)
    x = rng.rand(int(np.prod(ns))).astype(dtype)
    y = np.asarray(fn(jnp.asarray(D), jnp.asarray(x), bws, ns))
    assert y.dtype == dtype
    y_ref = _dense_from_banded(D.astype(np.float64), bws, ns) @ x
    tol = 1e-5 if dtype == np.float32 else 1e-13
    assert np.abs(y - y_ref).max() <= tol * np.abs(y_ref).max()


def test_banded_rejects_irregular():
    kvm = make_knots(2, 0.0, 1.0, 4, mult=2)
    S = MLStructure.from_kvs((kvm,), (kvm,))
    assert band_info(S) is None


def test_matfree_operator():
    kvs, geo = _setup(p=3, n=5)
    asm = StiffnessAssembler(kvs, geo)
    K = asm.assemble().asmatrix()
    op = MatrixFreeOperator(asm)
    x = np.random.rand(K.shape[1])
    y = np.asarray(op(jnp.asarray(x)))
    assert np.allclose(y, K @ x)

    # restricted operator
    free = np.arange(40, 300)
    opf = MatrixFreeOperator(asm, free_dofs=free)
    yf = np.asarray(opf(jnp.asarray(x[free])))
    assert np.allclose(yf, (K[free][:, free]) @ x[free])


def test_matfree_from_vform_assembler():
    from pyiga_jax.compile import compile_vform
    from pyiga_jax.vform import stiffness_vf
    kvs, geo = _setup(p=2, n=6, d=2)
    asm = compile_vform(stiffness_vf(2))(kvs, geo=geo)
    K = asm.assemble().asmatrix()
    op = MatrixFreeOperator(asm)
    x = np.random.rand(K.shape[1])
    assert np.allclose(np.asarray(op(jnp.asarray(x))), K @ x)


def test_matfree_cg_solve():
    kvs, geo = _setup(p=2, n=6)
    K = MatrixFreeOperator(StiffnessAssembler(kvs, geo))
    M = MatrixFreeOperator(MassAssembler(kvs, geo))
    mv = lambda v: K(v) + M(v)
    b = np.random.rand(K.shape[1])
    u, it = solvers.cg_jit(mv, jnp.asarray(b), tol=1e-10, maxiter=2000)
    A = (StiffnessAssembler(kvs, geo).assemble().asmatrix()
         + MassAssembler(kvs, geo).assemble().asmatrix())
    r = np.linalg.norm(A @ np.asarray(u) - b) / np.linalg.norm(b)
    assert r < 1e-8 and int(it) < 2000


def test_symmetric_fold():
    # folded assembly (6 of 9 chains + transpose gather) must match unfolded
    for d in (2, 3):
        kvs, geo = _setup(p=3, n=5, d=d)
        asm = StiffnessAssembler(kvs, geo)
        plan, tperms = asm._fold()
        assert plan is not None and any(m for _, m in plan)
        assert len(plan) == d * (d + 1) // 2
        A_fold = asm.assemble().asmatrix()
        try:
            StiffnessAssembler.symmetric_fields = False
            A_ref = StiffnessAssembler(kvs, geo).assemble().asmatrix()
        finally:
            StiffnessAssembler.symmetric_fields = True
        scale = np.abs(A_ref).max()
        assert np.abs(A_fold - A_ref).max() < 1e-14 * scale


def test_banded_from_compact_device():
    from pyiga_jax.ops.banded import (band_info, banded_from_compact,
                                      banded_from_compact_device,
                                      banded_gather_maps)
    kvs, geo = _setup(p=2, n=6)
    K = StiffnessAssembler(kvs, geo).assemble()
    bws = band_info(K.structure)
    bsz = tuple(2 * b + 1 for b in bws)
    ns = tuple(b[0] for b in K.structure.bs)
    D_host = banded_from_compact(K.data, K.structure, bws)
    maps = banded_gather_maps(K.structure, bws)
    D_dev = banded_from_compact_device(jnp.asarray(K.data), maps, bsz, ns)
    assert np.array_equal(np.asarray(D_dev), D_host)


def test_restricted_operator():
    from pyiga_jax.ops.banded import (BandedOperator, band_info,
                                      banded_from_compact_device,
                                      banded_gather_maps)
    from pyiga_jax.ops.fastdiag import interior_dofs
    from pyiga_jax.ops.matfree import RestrictedOperator
    kvs, geo = _setup(p=3, n=5)
    asm = StiffnessAssembler(kvs, geo)
    K = asm.assemble()
    bws = band_info(K.structure)
    bsz = tuple(2 * b + 1 for b in bws)
    ns = tuple(b[0] for b in K.structure.bs)
    maps = banded_gather_maps(K.structure, bws)
    D = banded_from_compact_device(jnp.asarray(K.data), maps, bsz, ns)
    free = interior_dofs(kvs)
    rop = RestrictedOperator(BandedOperator(D, bws, ns), free,
                             int(np.prod(ns)))
    x = np.random.rand(len(free))
    y = np.asarray(rop(jnp.asarray(x)))
    Aff = K.asmatrix().tocsr()[free][:, free]
    assert np.abs(y - Aff @ x).max() < 1e-12


@pytest.mark.slow
def test_windowed_assembly():
    # windowed pair tables (support-window contraction) match dense assembly
    for d in (2, 3):
        for p in (2, 3):
            kvs, geo = _setup(p=p, n=6, d=d)
            for Asm in (MassAssembler, StiffnessAssembler):
                a = Asm(kvs, geo)
                A_ref = a.assemble().asmatrix()
                A_win = a.assemble_windowed().asmatrix()
                rel = np.abs(A_win - A_ref).max() / np.abs(A_ref).max()
                assert rel < 1e-14


def test_box_restriction():
    from pyiga_jax.ops.fastdiag import interior_dofs
    from pyiga_jax.ops.matfree import box_restriction
    kvs, _ = _setup(p=3, n=6)
    ns = tuple(kv.numdofs for kv in kvs)
    free = interior_dofs(kvs)
    assert box_restriction(free, ns) == ((1, 1, 1), (7, 7, 7))
    # non-box sets are rejected
    assert box_restriction(np.array([0, 5, 17]), ns) is None
    sub = np.delete(free, 3)
    assert box_restriction(sub, ns) is None


@pytest.mark.slow
def test_ozaki_assembly():
    # Ozaki-split (bf16 chunk) f64 contraction matches the exact f64 chains
    # far inside the 1e-10 entry-parity target
    from pyiga_jax.ops import sumfac
    for d in (2, 3):
        kvs, geo = _setup(p=3, n=5, d=d)
        asm = StiffnessAssembler(kvs, geo)
        tt = [[jnp.asarray(t) for t in tabs]
              for tabs in asm.tables.term_tables(asm.terms)]
        gi = jax.tree_util.tree_map(lambda a: jnp.asarray(np.asarray(a)),
                                    asm._geo_inputs)
        fields = asm.field_fn(gi)
        plan, tperms = asm._fold()
        tperms = [jnp.asarray(p) for p in tperms]
        ref = sumfac.assemble_terms_folded(tt, fields, tuple(plan), tperms)
        oz = sumfac.assemble_terms_folded(tt, fields, tuple(plan), tperms,
                                          mode='ozaki')
        rel = float(jnp.max(jnp.abs(oz - ref)) / jnp.max(jnp.abs(ref)))
        assert rel < 5e-13

    # raw contraction chain on data with per-row dynamic range
    rng = np.random.RandomState(3)
    tabs = [jnp.asarray(rng.randn(20, 12) * np.exp(rng.randn(20, 1)))
            for _ in range(3)]
    X = jnp.asarray(rng.randn(12, 12, 12) * np.exp(rng.randn(12, 1, 1)))
    ref = sumfac.contract_chain(tabs, X)
    oz = sumfac.contract_chain_ozaki(tabs, X)
    assert float(jnp.max(jnp.abs(oz - ref)) / jnp.max(jnp.abs(ref))) < 1e-12


def test_twofloat():
    from pyiga_jax.ops import twofloat as tf
    rng = np.random.RandomState(0)
    x = rng.randn(20000) * np.exp(2 * rng.randn(20000))
    y = rng.randn(20000) * np.exp(2 * rng.randn(20000))
    X, Y = jnp.asarray(x), jnp.asarray(y)
    a, b = tf.df_from_f64(X), tf.df_from_f64(Y)

    def rel(v, ref):
        return float(jnp.max(jnp.abs(v - ref) / jnp.abs(ref)))
    assert rel(tf.df_to_f64(tf.df_mul(a, b)), X * Y) < 1e-13
    assert rel(tf.df_to_f64(tf.df_div(a, b)), X / Y) < 1e-13
    assert rel(tf.df_to_f64(tf.df_abs(a)), jnp.abs(X)) < 1e-14
    # addition: accuracy limited only by the 48-bit input representation
    s = tf.df_to_f64(tf.df_add(a, b))
    assert float(jnp.max(jnp.abs(s - (X + Y)) /
                         jnp.maximum(jnp.abs(X), jnp.abs(Y)))) < 1e-13


@pytest.mark.slow
def test_pair_chain_assembly():
    # pair-chained Ozaki assembly (f32 pairs end to end) matches exact f64
    from pyiga_jax.ops import sumfac, twofloat as tf
    from pyiga_jax.assemblers import (stiffness_fields,
                                      stiffness_fields_df_pair)
    for d in (2, 3):
        kvs, geo = _setup(p=3, n=5, d=d)
        asm = StiffnessAssembler(kvs, geo)
        gi = jax.tree_util.tree_map(lambda a: jnp.asarray(np.asarray(a)),
                                    asm._geo_inputs)
        tt = [[jnp.asarray(t) for t in tabs]
              for tabs in asm.tables.term_tables(asm.terms)]
        plan, tperms = asm._fold()
        tperms = [jnp.asarray(p) for p in tperms]
        ref = sumfac.assemble_terms_folded(tt, stiffness_fields(gi),
                                           tuple(plan), tperms)
        pair = sumfac.assemble_terms_folded_pair(
            tt, stiffness_fields_df_pair(gi), tuple(plan), tperms)
        rel = float(jnp.max(jnp.abs(pair - ref)) / jnp.max(jnp.abs(ref)))
        assert rel < 1e-13

    # the pair slicer reconstructs exactly on data including values whose
    # f32 rounding sits at power-of-2 boundaries (the exp2/frexp trap)
    rng = np.random.RandomState(1)
    V = jnp.asarray(np.concatenate([rng.randn(50) * np.exp(3*rng.randn(50)),
                                    [1.0, -2.0, 0.5 - 2**-30, 2**-20, 0.0]]))
    hi, lo = tf.df_from_f64(V)
    ch, s = sumfac._ozaki_slice_pair(hi[None], lo[None], 1)
    rec = sum(c.astype(jnp.float64) for c in ch) * s.astype(jnp.float64)
    err = float(jnp.max(jnp.abs(rec[0] - V)))
    assert err < 1e-14 * float(jnp.max(jnp.abs(V)))


def test_fastdiag_weighted():
    # geometry-averaged 1D coefficients must converge strictly faster than
    # the parametric fastdiag on a strongly mapped geometry, to the same
    # solution
    from pyiga_jax.ops.fastdiag import (fastdiag_precond,
                                        fastdiag_precond_weighted,
                                        interior_dofs)
    kvs, geo = _setup(p=3, n=8)
    asm = StiffnessAssembler(kvs, geo)
    free = interior_dofs(kvs)
    op = MatrixFreeOperator(asm, free_dofs=free, dtype=np.float64)
    b = np.random.RandomState(0).rand(len(free))
    P0 = fastdiag_precond(kvs, dirichlet=True)
    Pw = fastdiag_precond_weighted(asm, dirichlet=True)
    x0, it0 = solvers.cg_jit(op, jnp.asarray(b), tol=1e-10, maxiter=500,
                             precond=P0)
    xw, itw = solvers.cg_jit(op, jnp.asarray(b), tol=1e-10, maxiter=500,
                             precond=Pw)
    assert int(itw) < int(it0)
    K = asm.assemble().asmatrix().tocsr()[free][:, free]
    r = np.linalg.norm(K @ np.asarray(xw) - b) / np.linalg.norm(b)
    assert r < 1e-9


def test_twofloat_special_values():
    from pyiga_jax.ops import twofloat as tf
    vals = np.array([0.0, -0.0, 1.0, -1.0, 2.0**-30, -(2.0**30),
                     0.5 - 2.0**-30, 1.0 + 2.0**-40, np.pi, -np.e])
    X = jnp.asarray(vals)
    a = tf.df_from_f64(X)
    # representation round trip: exact to the 48-bit pair precision
    aX = tf.df_to_f64(a)
    assert float(jnp.max(jnp.abs(aX - X))) < 2.0**-47 * float(jnp.max(jnp.abs(X)))
    # values with <= 48 significant bits round-trip exactly
    assert float(jnp.max(jnp.abs(aX[:7] - X[:7]))) == 0.0
    # x * 1, x + 0, x / 1 reproduce the represented value exactly
    one = tf.df_from_f64(jnp.ones_like(X))
    zero = tf.df_from_f64(jnp.zeros_like(X))
    assert float(jnp.max(jnp.abs(tf.df_to_f64(tf.df_mul(a, one)) - aX))) == 0.0
    assert float(jnp.max(jnp.abs(tf.df_to_f64(tf.df_add(a, zero)) - aX))) == 0.0
    assert float(jnp.max(jnp.abs(tf.df_to_f64(tf.df_div(a, one)) - aX))) == 0.0
    # x - x == 0 exactly
    assert float(jnp.max(jnp.abs(tf.df_to_f64(tf.df_sub(a, a))))) == 0.0


def test_ozaki_chunk_ladder():
    # documented accuracy ladder of the pair chain vs chunk count
    from pyiga_jax.ops import sumfac, twofloat as tf
    rng = np.random.RandomState(5)
    tabs = [jnp.asarray(rng.randn(14, 12)) for _ in range(2)]
    X = jnp.asarray(rng.randn(12, 12) * np.exp(rng.randn(12, 1)))
    ref = sumfac.contract_chain(tabs, X)
    for L, tol in [(7, 1e-12), (6, 1e-10), (5, 1e-8)]:
        got = tf.df_to_f64(sumfac.contract_chain_ozaki_pair(
            tabs, tf.df_from_f64(X), L=L))
        rel = float(jnp.max(jnp.abs(got - ref)) / jnp.max(jnp.abs(ref)))
        assert rel < tol


@pytest.mark.slow
def test_ozaki_long_contraction_split():
    # contraction lengths K > 2^(24-2w) = 256 violate the exact-f32-
    # accumulation condition; the contraction must split the axis into
    # exactness-preserving blocks and keep full accuracy
    from pyiga_jax.ops import sumfac, twofloat as tf
    rng = np.random.RandomState(11)
    K = 700     # > 2 * _OZAKI_MAX_K: exercises multiple blocks
    A = jnp.asarray(rng.randn(9, K) * np.exp(rng.randn(9, 1)))
    X = jnp.asarray(rng.randn(K, 7) * np.exp(rng.randn(K, 1)))
    ref = jnp.tensordot(X, A, axes=(0, 1)).swapaxes(0, 1)
    oz = sumfac._ozaki_contract_axis(X, 0, A)
    rel = float(jnp.max(jnp.abs(oz - ref)) / jnp.max(jnp.abs(ref)))
    assert rel < 1e-12

    pr = tf.df_to_f64(sumfac._ozaki_contract_axis_pair(
        tf.df_from_f64(X), 0, A))
    rel = float(jnp.max(jnp.abs(pr - ref)) / jnp.max(jnp.abs(ref)))
    assert rel < 1e-12


@pytest.mark.slow
def test_pair_assembly_mass_and_nurbs():
    # the f64 fast path (two-float fields + pair-chained Ozaki) must cover
    # mass assembly and NURBS geometries (quarter_annulus is exact NURBS)
    from pyiga_jax.assemblers import MassAssembler, StiffnessAssembler
    from pyiga_jax import geometry
    from pyiga_jax.bspline import make_knots

    for d, geo in ((2, geometry.quarter_annulus()),
                   (3, geometry.twisted_box())):
        kvs = d * (make_knots(3, 0.0, 1.0, 4),)
        for cls in (MassAssembler, StiffnessAssembler):
            asm = cls(kvs, geo)
            exact = asm.assemble(mode='exact').data
            fast = asm.assemble(mode='ozaki').data
            rel = np.abs(fast - exact).max() / np.abs(exact).max()
            assert rel < 1e-12, (cls.__name__, d, rel)


def test_banded_pair_matvec():
    # two-float banded matvec matches the f64 banded matvec
    from pyiga_jax.ops.banded import BandedOperator, BandedOperatorPair

    kvs, geo = _setup(p=2, n=6, d=2)
    from pyiga_jax.assemblers import StiffnessAssembler
    asm = StiffnessAssembler(kvs, geo)
    mlm = asm.assemble(mode='exact')
    op = BandedOperator.from_mlmatrix(mlm)
    x = np.random.RandomState(0).rand(op.shape[1])
    y_ref = np.asarray(op.matvec(jnp.asarray(x)))
    opp = BandedOperatorPair(None, op.bws, op.ns)
    opp.set_data_f64(jnp.asarray(op.D))
    y = np.asarray(opp.matvec(jnp.asarray(x)))
    assert np.abs(y - y_ref).max() / np.abs(y_ref).max() < 1e-9


def test_cg_ir_deferred_info():
    from pyiga_jax.assemblers import MassAssembler
    from pyiga_jax.ops.matfree import MatrixFreeOperator
    kvs, geo = _setup(p=2, n=6, d=2)
    asm = MassAssembler(kvs, geo)
    op = MatrixFreeOperator(asm)
    op32 = MatrixFreeOperator(asm, dtype=np.float32)
    b = np.random.RandomState(1).rand(op.shape[0])
    x, info_dev = solvers.cg_ir(op, op32, b, tol=1e-10, fetch_info=False)
    info = solvers.cg_ir_info(info_dev)
    assert info['residual'] < 1e-10
    M = asm.assemble().asmatrix()
    r = np.linalg.norm(M @ np.asarray(x) - b) / np.linalg.norm(b)
    assert r < 1e-9
