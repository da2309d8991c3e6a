# -*- coding: utf-8 -*-
"""Regular banded layout for compact multilevel matrices and its fast matvec.

For spline spaces with single interior knots, the per-axis sparsity pattern
is a clipped band of width ``2p+1``.  Padding the clipped boundary rows to
the full band gives a *regular* layout

    D[mu_1, ..., mu_d, i_1, ..., i_d],   j_k = i_k + mu_k - p_k,

(band offsets leading, dof axes trailing).  The matvec then reads the data
tensor exactly once and accumulates ``prod(2p_k+1)`` shifted windows of the
input vector:

    y[i] = sum_mu D[mu, i] * x[i + mu - p]

This replaces the gather + segment-sum path of :mod:`.mlmatvec` (which
remains as the general fallback for irregular patterns): the banded form is
bandwidth-optimal, while gathers re-read device memory per level.
"""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np


def band_info(structure):
    """If every level of the MLStructure is a clipped band over a square
    block, return the per-level bandwidths; else None."""
    bws = []
    for (m, n), bidx in zip(structure.bs, structure.bidx):
        if m != n:
            return None
        i = bidx[:, 0].astype(np.int64)
        j = bidx[:, 1].astype(np.int64)
        bw = int(np.max(np.abs(i - j))) if len(i) else 0
        # check the pattern is exactly the clipped band of width bw
        lo = np.maximum(0, np.arange(n) - bw)
        hi = np.minimum(n, np.arange(n) + bw + 1)
        if len(i) != int(np.sum(hi - lo)):
            return None
        bws.append(bw)
    return bws


def compact_to_banded_indices(structure, bws):
    """Indices mapping the flat compact data tensor into the padded banded
    tensor: returns per-level arrays ``(mu_k, i_k)`` for each nonzero."""
    out = []
    for bw, bidx in zip(bws, structure.bidx):
        i = bidx[:, 0].astype(np.int64)
        j = bidx[:, 1].astype(np.int64)
        out.append((j - i + bw, i))
    return out


def banded_from_compact(data, structure, bws):
    """Scatter the compact data tensor into the regular banded layout
    ``(b_1, ..., b_d, n_1, ..., n_d)`` (zeros on the padding).

    Host-side numpy: the mapping is separable per level, so a single
    ``np.ix_`` fancy assignment with per-axis flat indices suffices."""
    d = len(bws)
    ns = [b[0] for b in structure.bs]
    bsz = [2 * bw + 1 for bw in bws]
    idx = compact_to_banded_indices(structure, bws)
    flat = [mu * n + i for (mu, i), n in zip(idx, ns)]
    # interleaved layout (b1, n1, b2, n2, ...), flattened per level
    D = np.zeros([b * n for b, n in zip(bsz, ns)], dtype=np.asarray(data).dtype)
    D[np.ix_(*flat)] = np.asarray(data)
    D = D.reshape([x for b, n in zip(bsz, ns) for x in (b, n)])
    # move all band axes to the front: (b1, ..., bd, n1, ..., nd)
    perm = list(range(0, 2 * d, 2)) + list(range(1, 2 * d, 2))
    return np.ascontiguousarray(np.transpose(D, perm))


def banded_gather_maps(structure, bws):
    """Per-level lookup tables mapping banded flat row ``mu*n + i`` to the
    compact data index (or -1 on the clipped-band padding).  Host setup for
    :func:`banded_from_compact_device`."""
    maps = []
    for (m, n), bidx, bw in zip(structure.bs, structure.bidx, bws):
        lookup = -np.ones((2 * bw + 1) * n, dtype=np.int64)
        i = bidx[:, 0].astype(np.int64)
        mu = bidx[:, 1].astype(np.int64) - i + bw
        lookup[mu * n + i] = np.arange(len(bidx))
        maps.append(lookup)
    return maps


def banded_from_compact_device(data, maps, bsz, ns):
    """Traced compact -> banded ``(b..., n...)`` conversion: one separable
    gather per level (take along axis), zeroing the padding — the data never
    leaves the device (unlike the host-side :func:`banded_from_compact`)."""
    from .sumfac import banded_reorder
    X = data
    for k, lk in enumerate(maps):
        lk = jnp.asarray(lk)
        mask_shape = [1] * data.ndim
        mask_shape[k] = -1
        X = (jnp.take(X, jnp.maximum(lk, 0), axis=k)
             * (lk >= 0).reshape(mask_shape).astype(data.dtype))
    return banded_reorder(X, bsz, ns)


@partial(jax.jit, static_argnames=('bws', 'ns'))
def banded_matvec(D, x, bws, ns):
    """Banded matvec: `D` in ``(b_1..b_d, n_1..n_d)`` layout, `x` raveled.

    Reads `D` once; accumulates one shifted window of the zero-padded input
    per band-offset combination via a fori_loop (static trip count
    ``prod(b_k)``)."""
    d = len(ns)
    bsz = tuple(2 * bw + 1 for bw in bws)
    x = x.reshape(ns)
    xp = jnp.pad(x, [(bw, bw) for bw in bws])
    nmu = int(np.prod(bsz))

    def body(f, y):
        # unravel flat offset index f -> (mu_1, ..., mu_d)
        mus = []
        rem = f
        for k in reversed(range(d)):
            mus.append(rem % bsz[k])
            rem = rem // bsz[k]
        mus = tuple(reversed(mus))
        Dslice = jax.lax.dynamic_slice(D, mus + d * (0,),
                                       d * (1,) + tuple(ns))
        Dslice = Dslice.reshape(ns)
        xwin = jax.lax.dynamic_slice(xp, mus, tuple(ns))
        return y + Dslice * xwin

    y = jax.lax.fori_loop(
        0, nmu, body, jnp.zeros(ns, dtype=jnp.result_type(D.dtype, x.dtype)))
    return y.reshape(-1)


@partial(jax.jit, static_argnames=('bws', 'ns'))
def banded_matvec_static(D, x, bws, ns):
    """Python-unrolled variant of :func:`banded_matvec`: STATIC band
    offsets (``lax.slice`` windows instead of loop-carried dynamic
    slices).  Larger HLO (``prod(2p+1)`` slice-multiply-adds, which XLA
    fuses into one pass over `D`), and the matvec of
    :class:`BandedOperator`: on an H100 at 3D p=3 n=48 f64 it streams at
    ~2.3 TB/s against ~0.14 TB/s for the fori_loop form (measured by
    ``chip_smoke.py``, 0.81 of a device copy).  Under SPMD
    sharding static slices of the padded input lower to cheap halo
    collective-permutes on the sharded axis, while the fori_loop's
    loop-varying dynamic slices force a per-iteration all-gather.
    """
    bsz = tuple(2 * bw + 1 for bw in bws)
    x = x.reshape(ns)
    xp = jnp.pad(x, [(bw, bw) for bw in bws])
    y = jnp.zeros(ns, dtype=jnp.result_type(D.dtype, x.dtype))
    D = D.reshape(bsz + tuple(ns))
    for mus in np.ndindex(*bsz):
        xw = jax.lax.slice(xp, mus, tuple(m + n for m, n in zip(mus, ns)))
        y = y + D[mus] * xw
    return y.reshape(-1)


def banded_matvec_pair_static(D_pair, x_pair, bws, ns):
    """Static-offset (SPMD-friendly) form of :func:`banded_matvec_pair`;
    see :func:`banded_matvec_static`."""
    from . import twofloat as tf
    bsz = tuple(2 * bw + 1 for bw in bws)
    xh = x_pair[0].reshape(ns)
    xl = x_pair[1].reshape(ns)
    pad = [(bw, bw) for bw in bws]
    xph, xpl = jnp.pad(xh, pad), jnp.pad(xl, pad)
    Dh = D_pair[0].reshape(bsz + tuple(ns))
    Dl = D_pair[1].reshape(bsz + tuple(ns))
    z = jnp.zeros(ns, dtype=jnp.float32)
    y = (z, z)
    for mus in np.ndindex(*bsz):
        lim = tuple(m + n for m, n in zip(mus, ns))
        xw = (jax.lax.slice(xph, mus, lim), jax.lax.slice(xpl, mus, lim))
        y = tf.df_add(y, tf.df_mul((Dh[mus], Dl[mus]), xw))
    return y[0].reshape(-1), y[1].reshape(-1)


class BandedOperator:
    """Device-resident banded operator with a fast matvec; built from an
    :class:`~pyiga_jax.mlmatrix.MLMatrix` (or directly from banded data)."""

    def __init__(self, D, bws, ns):
        # keep D device-resident: a host numpy D would re-upload the full
        # banded tensor (~(2p+1)^d * prod(ns) * itemsize) on every matvec
        D = jax.device_put(D) if isinstance(D, np.ndarray) else D
        self.D = D
        self.bws = tuple(bws)
        self.ns = tuple(ns)
        self.shape = (int(np.prod(ns)), int(np.prod(ns)))
        # operand protocol (see solvers.cg_jit): D threaded as a jit argument
        self.operands = {'D': D}
        bws_t, ns_t = self.bws, self.ns
        self.apply_with_operands = (
            lambda operands, x: banded_matvec_static(operands['D'], x,
                                                     bws_t, ns_t))

    @staticmethod
    def from_mlmatrix(mlm, data=None):
        """Build from an MLMatrix (uses its structure; `data` may override
        the device array, e.g. to stay in float32)."""
        bws = band_info(mlm.structure)
        if bws is None:
            return None
        ns = tuple(b[0] for b in mlm.structure.bs)
        if data is None:
            data = mlm.data      # host scatter below; __init__ device_puts
        D = banded_from_compact(data, mlm.structure, bws)
        return BandedOperator(D, bws, ns)

    def matvec(self, x):
        return banded_matvec_static(self.D, x, self.bws, self.ns)

    def __call__(self, x):
        return self.matvec(x)


def banded_matvec_pair(D_pair, x_pair, bws, ns):
    """Two-float banded matvec: same window accumulation as
    :func:`banded_matvec` but in fused f32 pair arithmetic (float64-class
    accuracy from f32 operations only)."""
    from . import twofloat as tf
    d = len(ns)
    bsz = tuple(2 * bw + 1 for bw in bws)
    xh = x_pair[0].reshape(ns)
    xl = x_pair[1].reshape(ns)
    pad = [(bw, bw) for bw in bws]
    xph, xpl = jnp.pad(xh, pad), jnp.pad(xl, pad)
    nmu = int(np.prod(bsz))

    def body(f, y):
        mus = []
        rem = f
        for k in reversed(range(d)):
            mus.append(rem % bsz[k])
            rem = rem // bsz[k]
        mus = tuple(reversed(mus))
        Ds = tuple(
            jax.lax.dynamic_slice(Dc, mus + d * (0,),
                                  d * (1,) + tuple(ns)).reshape(ns)
            for Dc in D_pair)
        xw = (jax.lax.dynamic_slice(xph, mus, tuple(ns)),
              jax.lax.dynamic_slice(xpl, mus, tuple(ns)))
        return tf.df_add(y, tf.df_mul(Ds, xw))

    z = jnp.zeros(ns, dtype=jnp.float32)
    yh, yl = jax.lax.fori_loop(0, nmu, body, (z, z))
    return yh.reshape(-1), yl.reshape(-1)


class BandedOperatorPair:
    """Banded operator holding its data as a two-float f32 pair; maps f64
    vectors to f64 results at ~2^-45 relative accuracy with f32-speed
    arithmetic.  Drop-in for :class:`BandedOperator` as the high-precision
    operator of :func:`~pyiga_jax.solvers.cg_ir`."""

    def __init__(self, D_pair, bws, ns):
        from . import twofloat as tf
        self.bws = tuple(bws)
        self.ns = tuple(ns)
        self.shape = (int(np.prod(ns)), int(np.prod(ns)))
        self.operands = {'Dh': None if D_pair is None else D_pair[0],
                         'Dl': None if D_pair is None else D_pair[1]}
        bws_t, ns_t = self.bws, self.ns

        def apply_with_operands(operands, x):
            xp = tf.df_from_f64(x)
            yh, yl = banded_matvec_pair((operands['Dh'], operands['Dl']),
                                        xp, bws_t, ns_t)
            return tf.df_to_f64((yh, yl))

        self.apply_with_operands = apply_with_operands
        self._jit_apply = jax.jit(apply_with_operands)

    def set_data_f64(self, D):
        """Split a float64 banded data array into the stored pair."""
        from . import twofloat as tf
        hi, lo = tf.df_from_f64(D)
        self.operands['Dh'] = hi
        self.operands['Dl'] = lo

    def matvec(self, x):
        return self._jit_apply(self.operands, x)

    def __call__(self, x):
        return self.matvec(x)

