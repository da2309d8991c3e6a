# -*- coding: utf-8 -*-
"""Sum-factorization assembly of compact multilevel-banded matrices.

This is the replacement for the reference's per-entry Gauss
assembly engine (assemblers.pyx `entry_impl`/`combine`,
/root/reference/pyiga/codegen/cython.py:325-424).  Instead of computing each
matrix entry by a scalar loop over the joint support, the *whole compact data
tensor* is computed at once as a chain of per-axis contractions:

    data[s_1, ..., s_d] = sum_q  C(q_1, ..., q_d) * prod_k P_k[s_k, q_k]

where ``s_k`` enumerates the per-axis nonzero basis pairs (the `bidx` of the
:class:`~pyiga_jax.mlmatrix.MLStructure`), ``C`` is a pointwise coefficient
field on the tensor-product Gauss grid (geometry data x quadrature weights),
and ``P_k[s_k, q_k] = D^{du_k} b_{j(s_k)}(q_k) * D^{dv_k} b_{i(s_k)}(q_k)``
are *pair tables* of trial/test basis derivatives.  Each contraction is a
matricized matmul that XLA hands to its matrix-product kernels.  A
bilinear form lowers to a small list of such terms (one per derivative
combination).

Vectors (arity 1) use the same chain with plain basis tables ``B[i_k, q_k]``.
"""

import numpy as np
import jax
import jax.numpy as jnp

from .. import config
from ..quadrature import make_tensor_quadrature, make_boundary_quadrature
from .basis import dense_basis_table


################################################################################
# Contraction chains (traced)
################################################################################

def _dot_precision(dtype):
    """Matmul precision for plain (non-Ozaki) contractions.  Without a
    stated precision an f32 product may run in a reduced-precision mode
    (TF32 on the GPU's tensor cores, ~3 decimal digits); the float32 path
    promises ~1e-7 accuracy vs f64, so f32 dots request full IEEE f32.
    float64 and the bf16 Ozaki dots are unaffected."""
    import jax
    return (jax.lax.Precision.HIGHEST
            if jnp.dtype(dtype) == jnp.float32 else None)


def contract_chain(tables, field):
    """Contract ``field (Q_1 x ... x Q_d)`` against per-axis tables
    ``tables[k] (m_k, Q_k)``; returns an ``(m_1, ..., m_d)`` tensor.

    Each step is one matricized matmul."""
    X = field
    for k in range(len(tables)):
        # contract axis k (currently holding Q_k), put result axis back at k
        X = jnp.moveaxis(jnp.tensordot(X, tables[k], axes=(k, 1),
                                       precision=_dot_precision(X.dtype)),
                         -1, k)
    return X


################################################################################
# Ozaki-split float64 contraction (bf16 chunk products, exact f32
# accumulation): splitting the operands into w-bit mantissa chunks makes
# every chunk product exact in bf16 x bf16 -> f32 (2w + log2(K) <= 24), so
# a bf16 matrix unit does the work and only the per-diagonal combines run
# in elementwise float64.  ~2e-14 relative accuracy per stage (L=7, w=8,
# K=192).  Opt-in (mode='ozaki'); native float64 is the default.
################################################################################

_OZAKI_L = 7        # chunk count: relative accuracy ~2^(-8(L-1)) per stage
_OZAKI_W = 8        # bits per chunk; 2w + log2(K) <= 24 for exact f32 acc.
_OZAKI_DHI = 2      # diagonals combined in f64; the tail sums in f32


def _ozaki_slice(V, axis, L=_OZAKI_L, w=_OZAKI_W, n_hi=3):
    """Split f64 `V` into L bf16-exact w-bit mantissa chunks aligned to the
    per-vector (along `axis`) power-of-2 scale: ``V ~= s * sum_i chunks[i]``
    with |chunks[i]| <= 2^(-w*i).  Chunks beyond `n_hi` are extracted in
    float32 (their scale is below 2^(-w*n_hi), so f32 carries them to
    ~2^-48 overall) to avoid emulated-f64 elementwise cost."""
    a = jnp.max(jnp.abs(V), axis=axis, keepdims=True)
    # exact power-of-2 scale with s >= a via frexp (a = m * 2^e, m in
    # [0.5, 1)); a rounded log2 can underestimate by one power of 2, which
    # would make the first chunk need 9 bits and silently round in bf16.
    # frexp/ldexp run in f32 (exp2 is approximate even at integer
    # inputs): f32 rounding of `a` can
    # at worst land r marginally above 1, which the trunc chunks absorb.
    a32 = jnp.where(a > 0, a, 1.0).astype(jnp.float32)
    # subnormal maxima (f64 values < ~1e-38, valid in plain f64) would give
    # a zero/denormal scale; clamping to the minimum normal only costs
    # relative accuracy on rows that are themselves below f32 range
    a32 = jnp.maximum(a32, jnp.float32(2.0 ** -126))
    _, e = jnp.frexp(a32)
    s = jnp.ldexp(jnp.ones_like(a32), e).astype(V.dtype)
    r = V / s
    chunks = []
    for i in range(min(n_hi, L)):
        scale = float(2.0 ** (w * (i + 1)))
        q = jnp.trunc(r * scale) / scale
        chunks.append(q.astype(jnp.bfloat16))
        r = r - q
    if L > n_hi:
        r32 = (r * float(2.0 ** (w * n_hi))).astype(jnp.float32)
        for i in range(n_hi, L):
            scale = float(2.0 ** (w * (i + 1 - n_hi)))
            q = jnp.trunc(r32 * scale) / scale
            chunks.append((q * float(2.0 ** (-w * n_hi))).astype(jnp.bfloat16))
            r32 = r32 - q
    return chunks, s


# Exactness of the bf16 chunk products requires 2w + log2(K) <= 24 for the
# leading-diagonal f32 accumulation (K = contraction length); beyond
# K = 2^(24-2w) = 256 the quadrature axis is split into blocks and the block
# results are summed in f64 / two-float arithmetic.
_OZAKI_MAX_K = 1 << (24 - 2 * _OZAKI_W)


def _split_axis_blocks(Q):
    nblk = -(-Q // _OZAKI_MAX_K)
    return [slice(b * _OZAKI_MAX_K, min((b + 1) * _OZAKI_MAX_K, Q))
            for b in range(nblk)]


def _ozaki_contract_axis(X, k, table, L=_OZAKI_L):
    """``tensordot(X, table, axes=(k, 1))`` with the result axis back at `k`,
    computed by the Ozaki splitting (f64-faithful)."""
    Q = table.shape[1]
    if Q > _OZAKI_MAX_K:
        # keep each block's leading f32 accumulation exact; f64 block sum
        out = None
        for sl in _split_axis_blocks(Q):
            Xb = X[(slice(None),) * k + (sl,)]
            Yb = _ozaki_contract_axis(Xb, k, table[:, sl], L)
            out = Yb if out is None else out + Yb
        return out
    Ac, sA = _ozaki_slice(table, 1, L)
    Xc, sX = _ozaki_slice(X, k, L)
    C = None
    tail = None
    for d in range(L):
        Dd = None
        for i in range(d + 1):
            Y = jnp.tensordot(Xc[d - i], Ac[i], axes=(k, 1),
                              preferred_element_type=jnp.float32)
            Dd = Y if Dd is None else Dd + Y
        if d <= _OZAKI_DHI:
            t = Dd.astype(jnp.float64)
            C = t if C is None else C + t
        else:
            tail = Dd if tail is None else tail + Dd
    if tail is not None:
        C = C + tail.astype(jnp.float64)
    # scales: result axis is last; sX loses axis k, sA contributes (m,)
    C = C * jnp.squeeze(sX, k)[..., None] * sA[:, 0]
    return jnp.moveaxis(C, -1, k)


def _ozaki_slice_pair(hi, lo, axis, L=_OZAKI_L, w=_OZAKI_W):
    """Slice a two-float value ``hi + lo`` (f32 pair, |lo| <= ulp(hi)/2)
    into bf16 chunks — float32-only arithmetic throughout: the first 24/w
    chunks consume `hi` exactly (f32 mantissa = 3 x 8 bits), the rest come
    from `lo` scaled up by 2^24.  Returns ``(chunks, s)`` with `s` an exact
    power-of-2 f32 scale."""
    n_hi = 24 // w
    a = jnp.max(jnp.abs(hi), axis=axis, keepdims=True)
    # exact power-of-2 scale with s >= a (see _ozaki_slice); subnormal
    # maxima clamp to the minimum normal so the reciprocal stays finite
    a = jnp.maximum(jnp.where(a > 0, a, 1.0), jnp.float32(2.0 ** -126))
    _, e = jnp.frexp(a)
    s = jnp.ldexp(jnp.ones_like(a), e)   # exact (f32 exp2 is approximate!)
    r = hi / s                       # exact (power-of-2 divide)
    chunks = []
    for i in range(min(n_hi, L)):
        scale = jnp.float32(2.0 ** (w * (i + 1)))
        q = jnp.trunc(r * scale) / scale
        chunks.append(q.astype(jnp.bfloat16))
        r = r - q                    # exact: q is a bit-slice of r
    if L > n_hi:
        # the tail: remaining hi bits (elements below the per-vector max
        # still have mantissa below the chunk grid) plus lo
        up = jnp.float32(2.0 ** (w * n_hi))
        r32 = (r + lo / s) * up
        for i in range(n_hi, L):
            scale = jnp.float32(2.0 ** (w * (i + 1 - n_hi)))
            q = jnp.trunc(r32 * scale) / scale
            qb = (q * jnp.float32(2.0 ** (-w * n_hi))).astype(jnp.bfloat16)
            chunks.append(qb)
            # subtract what was actually STORED: |r32| can reach ~1.5 (the
            # lo fold), making the first tail chunk 9 bits wide — bf16
            # rounds it, and subtracting the unrounded q would lose up to
            # ~2^-32 of the row scale permanently; subtracting the rounded
            # value lets the next chunk absorb the rounding
            r32 = r32 - qb.astype(jnp.float32) * up
    return chunks, s


def _ozaki_contract_axis_pair(X, k, table, L=_OZAKI_L):
    """Pair-in / pair-out Ozaki contraction of axis `k`: `X` is a two-float
    f32 pair, `table` an f64 (m, Q) array; the result axis returns to `k`.
    No f64 arithmetic anywhere — diagonals combine with two-float adds and
    the power-of-2 scales multiply exactly."""
    from . import twofloat as tf
    Q = table.shape[1]
    if Q > _OZAKI_MAX_K:
        # split the contraction axis into exactness-preserving blocks and
        # accumulate the block results with two-float adds
        acc = None
        for sl in _split_axis_blocks(Q):
            Xb = tuple(c[(slice(None),) * k + (sl,)] for c in X)
            Yb = _ozaki_contract_axis_pair(Xb, k, table[:, sl], L)
            acc = Yb if acc is None else tf.df_add(acc, Yb)
        return acc
    Ac, sA = _ozaki_slice(table, 1, L)
    Xc, sX = _ozaki_slice_pair(X[0], X[1], k, L)
    acc = None
    for d in range(L):
        Dd = None
        for i in range(d + 1):
            Y = jnp.tensordot(Xc[d - i], Ac[i], axes=(k, 1),
                              preferred_element_type=jnp.float32)
            Dd = Y if Dd is None else Dd + Y
        acc = tf.df(Dd) if acc is None else tf.df_add(acc, tf.df(Dd))
    # scales: result axis is last; sA is f64 (from the f64 table) but holds
    # exact powers of two -> exact in f32
    sfull = jnp.squeeze(sX, k)[..., None] * sA[:, 0].astype(jnp.float32)
    hi, lo = acc[0] * sfull, acc[1] * sfull
    return jnp.moveaxis(hi, -1, k), jnp.moveaxis(lo, -1, k)


def contract_chain_ozaki_pair(tables, field_pair, L=_OZAKI_L):
    """Windowless Ozaki chain with two-float intermediates: the field enters
    and every stage result stays as an f32 pair (slice -> bf16 dots ->
    two-float diagonal combine), eliminating emulated-f64 elementwise ops
    from the whole chain.  Returns an f32 pair; convert once with
    :func:`~pyiga_jax.ops.twofloat.df_to_f64`.

    `L` trades accuracy for dot count (L(L+1)/2 bf16 dots per stage):
    measured assembled accuracy L=7: 7e-15, L=6: 1e-13, L=5: 3e-11."""
    X = field_pair
    for k in range(len(tables)):
        X = _ozaki_contract_axis_pair(X, k, tables[k], L=L)
    return X


def assemble_terms_folded_pair(term_tables, field_pairs, fold_plan, tperms,
                               L=_OZAKI_L):
    """Folded sum of pair-chains (see :func:`assemble_terms_folded`); fields
    and all arithmetic are two-float f32.  Returns the f64 data tensor."""
    from . import twofloat as tf
    direct = [t for t, m in fold_plan if not m]
    mirrored = [t for t, m in fold_plan if m]

    def chain_sum(idxs):
        out = None
        for t in idxs:
            Y = contract_chain_ozaki_pair(term_tables[t], field_pairs[t], L)
            out = Y if out is None else tf.df_add(out, Y)
        return out

    out = chain_sum(direct) if direct else None
    if mirrored:
        sym = chain_sum(mirrored)
        hiT, loT = sym
        for k, p in enumerate(tperms):
            hiT = jnp.take(hiT, p, axis=k)
            loT = jnp.take(loT, p, axis=k)
        sym = tf.df_add(sym, (hiT, loT))
        out = sym if out is None else tf.df_add(out, sym)
    return tf.df_to_f64(out)


def contract_chain_ozaki(tables, field):
    """Like :func:`contract_chain` but with Ozaki-split f64 contractions
    (per-stage relative accuracy ~2e-14; compounds to ~1e-13 over a 3D
    chain — well inside the <=1e-10 entry-parity target)."""
    X = field
    for k in range(len(tables)):
        X = _ozaki_contract_axis(X, k, tables[k])
    return X


def _contract_last(X, table, mode='exact'):
    """Contract the last (quadrature) axis against `table` (m, Q)."""
    d = X.ndim - 1
    if mode == 'ozaki':
        return _ozaki_contract_axis(X, d, table)
    return jnp.moveaxis(jnp.tensordot(X, table, axes=(d, 1),
                                      precision=_dot_precision(X.dtype)),
                        -1, d)


def last_table_groups(term_tables):
    """Host-side canonical group id of each term's LAST table (by object
    identity — the pair-table cache interns shared tables).  Must be
    computed on CONCRETE tables before jit: traced pytree leaves are
    distinct tracers, so in-trace id() grouping never merges."""
    seen, out = {}, []
    for tabs in term_tables:
        out.append(seen.setdefault(id(tabs[-1]), len(seen)))
    return tuple(out)


def _sum_chains_merged(term_tables, fields, idxs, mode='exact',
                       last_idx=None):
    """Sum of chains over the term subset `idxs`, merging the final
    contraction stage across terms that share the same last-axis pair table
    (`last_idx` from :func:`last_table_groups`, computed host-side): their
    stage-(d-1) results are summed first and the most expensive contraction
    (the one producing the full compact tensor) runs once per distinct table.
    The final stage is the dominant cost (output-proportional), so merging
    3D stiffness from 6 to ~4 final stages is a direct win."""
    chain = contract_chain_ozaki if mode == 'ozaki' else contract_chain
    groups = {}
    for t in idxs:
        key = last_idx[t] if last_idx is not None else id(term_tables[t][-1])
        groups.setdefault(key, []).append(t)
    out = None
    for key, ts in groups.items():
        partial = None
        for t in ts:
            Y = chain(term_tables[t][:-1], fields[t])
            partial = Y if partial is None else partial + Y
        Y = _contract_last(partial, term_tables[ts[0]][-1], mode)
        out = Y if out is None else out + Y
    return out


def assemble_terms(term_tables, fields, mode='exact', last_idx=None):
    """Sum of contraction chains: one term per derivative combination.
    Terms sharing the last-axis pair table merge their final stage when
    `last_idx` (host-computed, :func:`last_table_groups`) is given.
    ``mode='ozaki'`` uses the bf16-split f64 contraction (see
    :func:`contract_chain_ozaki`)."""
    return _sum_chains_merged(term_tables, fields, range(len(term_tables)),
                              mode, last_idx=last_idx)


def assemble_terms_folded(term_tables, fields, fold_plan, tperms,
                          mode='exact', last_idx=None):
    """Symmetric-term folding: compute only one chain per mirrored term pair.

    For a symmetric form (e.g. stiffness, where the coefficient field
    ``C[a,b] == C[b,a]``), the term with swapped derivatives contributes the
    *transpose* of its partner's chain; in the compact multilevel layout the
    transpose is a separable per-axis index permutation (`tperms`, from
    :func:`~pyiga_jax.mlmatrix.transpose_idx_for_bidx`).  This replaces
    d*(d-1)/2 of the d^2 stiffness contraction chains by one cheap gather —
    the analog of the reference's symmetric mirroring
    (/root/reference/pyiga/codegen/cython.py:1136-1140).

    `fold_plan`: sequence of ``(term_index, mirrored)``; mirrored chains are
    summed and the transposed sum is added once.  Terms not listed (the
    mirror partners) are never computed — XLA dead-code-eliminates their
    coefficient fields."""
    direct = [t for t, m in fold_plan if not m]
    mirrored = [t for t, m in fold_plan if m]
    if mirrored and not tperms:
        raise ValueError('fold_plan has mirrored terms but no tperms — '
                         'the untransposed sum would be silently wrong')
    out = (_sum_chains_merged(term_tables, fields, direct, mode,
                              last_idx=last_idx)
           if direct else None)
    if mirrored:
        sym = _sum_chains_merged(term_tables, fields, mirrored, mode,
                                 last_idx=last_idx)
        symT = sym
        for k, p in enumerate(tperms):
            symT = jnp.take(symT, p, axis=k)
        sym = sym + symT
        out = sym if out is None else out + sym
    return out


def symmetric_fold_plan(terms):
    """Fold plan for arity-2 `terms` ``[(du, dv), ...]`` of a *symmetric*
    bilinear form (caller guarantees the coefficient fields of deriv-swapped
    terms are equal): each ``du != dv`` pair is computed once (mirrored);
    returns None if the terms are not closed under deriv swap."""
    index = {t: i for i, t in enumerate(terms)}
    plan = []
    for i, (du, dv) in enumerate(terms):
        if du == dv:
            plan.append((i, False))
        elif (dv, du) not in index:
            return None
        elif index[(dv, du)] > i:     # keep the first of each pair
            plan.append((i, True))
    return plan


def _windowed_stage(X, P, fs, nqp):
    """One windowed contraction stage: contract the leading (quadrature) axis
    of `X` against the windowed pair table `P` ``(n, b, wsz)``; the result
    axis (banded-flat, ``o*n + i``) is appended last (cyclic chaining).

    Each basis pair (i, j) is supported on at most p+1 knot spans, so only
    ``wsz = (p+1)*nqp`` of the Q quadrature points contribute per output row;
    contracting the windows instead of the dense Q axis cuts the arithmetic
    ~(2p+1)x at the price of a gather; the dense chains remain the default
    until a measurement on the card says which is faster."""
    n, b, wsz = P.shape
    pspan = wsz // nqp
    nspans = X.shape[0] // nqp
    nwin = nspans - pspan + 1
    rest = X.shape[1:]
    X4 = X.reshape((nspans, nqp) + rest)
    # all length-(p+1) span windows, stacked: (nwin, pspan, nqp, *rest)
    W = jnp.concatenate([X4[c:c + nwin][:, None] for c in range(pspan)],
                        axis=1)
    G = jnp.take(W.reshape((nwin, wsz) + rest), fs, axis=0)
    Y = jnp.einsum('iw...,iow->...oi', G, P,
                   precision=_dot_precision(X.dtype))
    return Y.reshape(rest + (b * n,))


def contract_chain_windowed(wtabs, fss, nqps, field):
    """Windowed contraction chain; returns the *banded-flat* data tensor
    ``(s_1, ..., s_d)`` with ``s_k = o_k*n_k + i_k`` (band offset major,
    zeros on the clipped-band padding)."""
    X = field
    for k in range(len(wtabs)):
        X = _windowed_stage(X, wtabs[k], fss[k], nqps[k])
    return X


def assemble_terms_windowed(wterm_tables, fss, nqps, fields, fold_plan=None,
                            tperms=None):
    """Sum of windowed chains, with optional symmetric folding (`tperms` are
    the per-axis *banded-flat* transpose permutations,
    :func:`banded_transpose_perm`)."""
    out = None
    sym = None
    plan = (fold_plan if fold_plan is not None
            else [(t, False) for t in range(len(wterm_tables))])
    for t, mirrored in plan:
        Y = contract_chain_windowed(wterm_tables[t], fss, nqps, fields[t])
        if mirrored:
            sym = Y if sym is None else sym + Y
        else:
            out = Y if out is None else out + Y
    if sym is not None:
        symT = sym
        for k, p in enumerate(tperms):
            symT = jnp.take(symT, p, axis=k)
        sym = sym + symT
        out = sym if out is None else out + sym
    return out


def banded_transpose_perm(n, bw):
    """Permutation of the banded-flat axis ``s = o*n + i`` mapping each valid
    pair (i, j=i+o-bw) to its transpose (j, i); padding entries (zero) map to
    themselves."""
    s = np.arange((2 * bw + 1) * n)
    o, i = s // n, s % n
    j = i + o - bw
    valid = (j >= 0) & (j < n)
    return np.where(valid, (2 * bw - o) * n + j, s)


def compact_from_banded_maps(structure, bws):
    """Per-level index maps: compact data position -> banded-flat position
    ``(j-i+bw)*n + i`` (separable takes convert banded-flat to compact)."""
    maps = []
    for (m, n), bidx, bw in zip(structure.bs, structure.bidx, bws):
        i = bidx[:, 0].astype(np.int64)
        j = bidx[:, 1].astype(np.int64)
        maps.append((j - i + bw) * n + i)
    return maps


def banded_reorder(data, bsz, ns):
    """Traced: reorder an assembly result over banded tables, shaped
    ``(b_1*n_1, ..., b_d*n_d)``, into ``(b_1, ..., b_d, n_1, ..., n_d)``."""
    d = len(ns)
    X = data.reshape([x for b, n in zip(bsz, ns) for x in (b, n)])
    perm = list(range(0, 2 * d, 2)) + list(range(1, 2 * d, 2))
    return jnp.transpose(X, perm)


################################################################################
# Pair tables (host setup, float64)
################################################################################

class SpaceTables:
    """Per-axis dense basis tables for a trial/test space pair on a Gauss grid,
    with cached pair tables per derivative combination."""

    def __init__(self, kvs0, kvs1, grids, bidx, numderiv):
        self.d = len(kvs0)
        self.bidx = bidx
        self.kvs0, self.kvs1 = tuple(kvs0), tuple(kvs1)
        self.nqps = tuple(len(g) // (len(kv.mesh) - 1)
                          for kv, g in zip(kvs0, grids))
        # tables[k][space] has shape (numderiv+1, n, Q)
        self.trial = [dense_basis_table(kv, g, numderiv)
                      for kv, g in zip(kvs0, grids)]
        if kvs1 is kvs0 or all(a == b for a, b in zip(kvs0, kvs1)):
            self.test = self.trial
        else:
            self.test = [dense_basis_table(kv, g, numderiv)
                         for kv, g in zip(kvs1, grids)]
        self._pair_cache = {}

    def pair_table(self, k, du, dv):
        """Pair table ``(nnz_k, Q_k)`` for axis `k`: trial deriv `du` (column
        index of the pair) times test deriv `dv` (row index)."""
        key = (k, du, dv)
        tab = self._pair_cache.get(key)
        if tab is None:
            bx = self.bidx[k]
            tab = (self.test[k][dv][bx[:, 0].astype(np.int64), :]
                   * self.trial[k][du][bx[:, 1].astype(np.int64), :])
            self._pair_cache[key] = tab
        return tab

    def term_tables(self, terms):
        """List (per term) of per-axis pair tables for derivative combos
        ``terms[t] = (du_tuple, dv_tuple)``."""
        return [[self.pair_table(k, du[k], dv[k]) for k in range(self.d)]
                for (du, dv) in terms]

    def banded_pair_table(self, k, du, dv, bw):
        """Pair table in regular banded layout: shape ``((2bw+1)*n, Q)`` with
        row ``mu*n + i`` = test-deriv(i) * trial-deriv(i + mu - bw)``
        (zero where the column index falls outside the matrix).  Assembling
        with these tables directly produces the padded banded data tensor."""
        key = ('banded', k, du, dv, bw)
        tab = self._pair_cache.get(key)
        if tab is None:
            Bt = self.test[k][dv]
            Bu = self.trial[k][du]
            n, Q = Bt.shape
            assert Bu.shape[0] == n, 'banded layout requires square blocks'
            rows = np.zeros((2 * bw + 1, n, Q))
            for mu in range(2 * bw + 1):
                off = mu - bw
                i0, i1 = max(0, -off), min(n, n - off)
                rows[mu, i0:i1] = Bt[i0:i1] * Bu[i0 + off:i1 + off]
            tab = rows.reshape((2 * bw + 1) * n, Q)
            self._pair_cache[key] = tab
        return tab

    def banded_term_tables(self, terms, bws):
        """Banded pair tables for every term (see :meth:`banded_pair_table`)."""
        return [[self.banded_pair_table(k, du[k], dv[k], bws[k])
                 for k in range(self.d)] for (du, dv) in terms]

    def windowed_pair_table(self, k, du, dv):
        """Windowed pair table ``(n, 2p+1, (p+1)*nqp)`` for axis `k` (square
        single-knot spaces only): entry ``[i, o, w]`` is the test(dv)(i) *
        trial(du)(i+o-p) product at the `w`-th quadrature point of dof i's
        (p+1)-span support window.  Returns ``(table, fs)`` with `fs` the
        per-dof window start (span index, clipped at the boundary)."""
        key = ('win', k, du, dv)
        cached = self._pair_cache.get(key)
        if cached is None:
            kv = self.kvs0[k]
            p = kv.p
            nqp = self.nqps[k]
            Bt, Bu = self.test[k][dv], self.trial[k][du]
            n, Q = Bt.shape
            assert Bu.shape[0] == n, 'windowed layout requires square blocks'
            # the (p+1)-span window is sized by the TRIAL degree; a
            # higher-degree test space would be silently truncated
            assert self.kvs1[k].p == p, \
                'windowed layout requires equal trial/test degrees'
            nspans = Q // nqp
            nwin = nspans - p
            assert nwin >= 1, 'windowed layout needs more spans than degree'
            wsz = (p + 1) * nqp
            fs = np.clip(np.arange(n) - p, 0, nwin - 1)
            tab = np.zeros((n, 2 * p + 1, wsz))
            for o in range(2 * p + 1):
                j = np.arange(n) + o - p
                for i in np.nonzero((j >= 0) & (j < n))[0]:
                    g0 = fs[i] * nqp
                    tab[i, o] = Bt[i, g0:g0+wsz] * Bu[j[i], g0:g0+wsz]
            cached = (tab, fs)
            self._pair_cache[key] = cached
        return cached

    def windowed_term_tables(self, terms):
        """Windowed pair tables for every term; returns ``(tables, fss)``."""
        tabs = [[self.windowed_pair_table(k, du[k], dv[k])[0]
                 for k in range(self.d)] for (du, dv) in terms]
        fss = [self.windowed_pair_table(k, 0, 0)[1] for k in range(self.d)]
        return tabs, fss

    def vector_term_tables(self, terms):
        """Per-axis *test* basis tables (n_k, Q_k) for arity-1 terms
        ``terms[t] = dv_tuple``."""
        return [[self.test[k][dv[k]] for k in range(self.d)] for dv in terms]


################################################################################
# Quadrature setup shared by all Gauss assemblers
################################################################################

def quadrature_for(kvs, nqp=None, bdspec=None):
    """Tensor Gauss rule over the mesh of `kvs` with the reference's
    ``nqp = max(p) + 1`` convention (assemblers.pyx:188); optionally
    restricted to a boundary face."""
    if nqp is None:
        nqp = max(kv.p for kv in kvs) + 1
    meshes = [kv.mesh for kv in kvs]
    if bdspec is None:
        return make_tensor_quadrature(meshes, nqp)
    return make_boundary_quadrature(meshes, nqp, bdspec)


################################################################################
# Jitted execution
################################################################################

_KERNEL_CACHE = {}
_BANDED_KERNEL_CACHE = {}


_WINDOWED_KERNEL_CACHE = {}


def run_windowed_assembly(field_fn, geo_inputs, wterm_tables, fss, nqps,
                          fold_plan=None, tperms=None):
    """Execute the windowed assembly under jit; returns the *banded-flat*
    data tensor as a device array (``s_k = o_k*n_k + i_k`` per axis);
    ~(2p+1)x fewer multiply-adds than the dense chains (see
    :func:`_windowed_stage` for when that pays off)."""
    key = (field_fn, 'win',
           tuple(fold_plan) if fold_plan is not None else None, tuple(nqps))
    fn = _WINDOWED_KERNEL_CACHE.get(key)
    if fn is None:
        plan = tuple(fold_plan) if fold_plan is not None else None
        nqps_t = tuple(nqps)

        def kernel(geo_inputs, wterm_tables, fss, tperms):
            return assemble_terms_windowed(wterm_tables, fss, nqps_t,
                                           field_fn(geo_inputs),
                                           plan, tperms)
        fn = jax.jit(kernel)
        _WINDOWED_KERNEL_CACHE[key] = fn

    dtype = config.get_dtype()
    geo_inputs = jax.tree_util.tree_map(
        lambda x: jnp.asarray(x, dtype=dtype)
        if np.issubdtype(np.asarray(x).dtype, np.floating)
        else jnp.asarray(x), geo_inputs)
    wterm_tables = jax.tree_util.tree_map(
        lambda x: jnp.asarray(x, dtype=dtype), wterm_tables)
    fss = [jnp.asarray(f) for f in fss]
    tperms = ([jnp.asarray(p) for p in tperms]
              if tperms is not None else None)
    return fn(geo_inputs, wterm_tables, fss, tperms)


def run_banded_assembly(field_fn, geo_inputs, banded_tables, bsz, ns):
    """Like :func:`run_matrix_assembly`, but with banded pair tables and a
    device-side reorder into ``(b..., n...)``; returns the device array
    (kept resident for the banded matvec)."""
    key = (field_fn, bsz, ns)
    fn = _BANDED_KERNEL_CACHE.get(key)
    if fn is None:
        def kernel(geo_inputs, banded_tables):
            return banded_reorder(
                assemble_terms(banded_tables, field_fn(geo_inputs)), bsz, ns)
        fn = jax.jit(kernel)
        _BANDED_KERNEL_CACHE[key] = fn

    dtype = config.get_dtype()
    geo_inputs = jax.tree_util.tree_map(
        lambda x: jnp.asarray(x, dtype=dtype)
        if np.issubdtype(np.asarray(x).dtype, np.floating)
        else jnp.asarray(x), geo_inputs)
    banded_tables = jax.tree_util.tree_map(
        lambda x: jnp.asarray(x, dtype=dtype), banded_tables)
    return fn(geo_inputs, banded_tables)


def run_matrix_assembly(field_fn, geo_inputs, term_tables, fold_plan=None,
                        tperms=None, mode='exact'):
    """Execute ``assemble_terms(term_tables, field_fn(geo_inputs))`` under jit.

    `field_fn` must be a traceable function (stable object — module/class
    level) mapping the `geo_inputs` pytree to the list of per-term coefficient
    fields on the Gauss grid.  With `fold_plan`/`tperms`, uses
    :func:`assemble_terms_folded` (symmetric mirroring).  Results come back
    as numpy float64/float32 depending on :func:`pyiga_jax.config.get_dtype`.
    """
    last_idx = last_table_groups(term_tables)   # host side: concrete tables
    key = (field_fn, tuple(fold_plan) if fold_plan is not None else None,
           mode, last_idx)
    fn = _KERNEL_CACHE.get(key)
    if fn is None:
        if fold_plan is None:
            def kernel(geo_inputs, term_tables):
                return assemble_terms(term_tables, field_fn(geo_inputs),
                                      mode, last_idx=last_idx)
        else:
            plan = tuple(fold_plan)

            def kernel(geo_inputs, term_tables, tperms):
                return assemble_terms_folded(term_tables,
                                             field_fn(geo_inputs),
                                             plan, tperms, mode,
                                             last_idx=last_idx)
        fn = jax.jit(kernel)
        _KERNEL_CACHE[key] = fn

    dtype = config.get_dtype()
    geo_inputs = jax.tree_util.tree_map(
        lambda x: jnp.asarray(x, dtype=dtype)
        if np.issubdtype(np.asarray(x).dtype, np.floating)
        else jnp.asarray(x), geo_inputs)
    term_tables = jax.tree_util.tree_map(
        lambda x: jnp.asarray(x, dtype=dtype), term_tables)
    if fold_plan is None:
        return np.asarray(fn(geo_inputs, term_tables))
    tperms = [jnp.asarray(p) for p in tperms]
    return np.asarray(fn(geo_inputs, term_tables, tperms))


def run_matrix_assembly_pair(pair_field_fn, geo_inputs, term_tables,
                             fold_plan=None, tperms=None, L=6):
    """f64 assembly from f32 arithmetic only: the coefficient fields come
    from `pair_field_fn` as two-float f32 pairs and every contraction stage
    is a pair-chained Ozaki split (bf16 chunk tiles with exact f32
    accumulation, two-float combines).  Assembled accuracy ~1e-13 relative
    at L=6 — three orders inside the 1e-10 entry-parity target.  Accepts
    ``fold_plan=None`` (no symmetric folding; e.g. the single-term mass
    assembly)."""
    if fold_plan is None:
        fold_plan = [(t, False) for t in range(len(term_tables))]
        tperms = []
    plan = tuple(fold_plan)
    # The XLA:CPU pipeline of this JAX version miscompiles the error-free
    # f32 transformations when they are fused into one jit program
    # (differently-rounded sums break the two-float invariants: 4e-14 ->
    # 6e-8 measured).  On the CPU the pair path exists only for
    # validation, so run it op-by-op.
    on_cpu = config.platform() == 'cpu'

    geo_inputs = jax.tree_util.tree_map(
        lambda x: jnp.asarray(x, dtype=jnp.float64)
        if np.issubdtype(np.asarray(x).dtype, np.floating) else jnp.asarray(x),
        geo_inputs)
    tperms = [jnp.asarray(p) for p in (tperms or [])]

    key = (pair_field_fn, plan, 'pair', L, not on_cpu)
    fn = _KERNEL_CACHE.get(key)
    if fn is None:
        def kernel(geo_inputs, term_tables, tperms):
            return assemble_terms_folded_pair(
                term_tables, pair_field_fn(geo_inputs), plan, tperms, L=L)
        fn = kernel if on_cpu else jax.jit(kernel)
        _KERNEL_CACHE[key] = fn

    term_tables = jax.tree_util.tree_map(
        lambda x: jnp.asarray(x, dtype=jnp.float64), term_tables)
    return np.asarray(fn(geo_inputs, term_tables, tperms))
