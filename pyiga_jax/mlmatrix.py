# -*- coding: utf-8 -*-
"""Multilevel block-structured (banded) sparse matrices in compact form.

L3 layer, API parity with /root/reference/pyiga/mlmatrix.py + mlmatrix_cy.pyx.

An IgA matrix over a tensor-product spline space has Kronecker-like sparsity:
per axis, basis pair (i_k, j_k) interacts only if the 1D functions share
support.  The matrix is therefore stored *compactly* as a dense L-way tensor
``data[s_1, ..., s_L]`` where ``s_k`` enumerates the per-level nonzero pairs
(`bidx`).  This dense tensor is exactly what the device assembler produces
via sum factorization and what lives in device memory for matrix-free matvecs
(:mod:`pyiga_jax.ops.mlmatvec`).

All index/structure computations here are host-side numpy (setup time); the
per-point Cython kernels of the reference are replaced by vectorized
broadcasting.
"""

import numpy as np
import scipy.sparse.linalg


################################################################################
# Per-level sparsity patterns
################################################################################

def compute_banded_sparsity(n, bw):
    """Raveled indices of the nonzeros of an ``n x n`` banded matrix with
    bandwidth `bw` (row-major order)."""
    IJ = compute_banded_sparsity_ij(n, bw)
    return (IJ[:, 0].astype(np.int64) * n + IJ[:, 1]).astype(np.int64)


def compute_banded_sparsity_ij(n, bw):
    """``N x 2`` array of the (i, j) nonzero positions of an ``n x n`` banded
    matrix with bandwidth `bw`, ordered row-major."""
    i = np.arange(n)
    lo = np.maximum(0, i - bw)
    hi = np.minimum(n, i + bw + 1)
    counts = hi - lo
    I = np.repeat(i, counts)
    # per row: lo[i], lo[i]+1, ..., hi[i]-1
    J = np.concatenate([np.arange(l, h) for l, h in zip(lo, hi)]) \
        if n > 0 else np.empty(0, dtype=np.int64)
    return np.column_stack((I, J)).astype(np.uint32)


def compute_sparsity_ij(kv1, kv2):
    """``N x 2`` array of pairs (i, j) such that B-spline `i` of `kv2` (rows)
    and B-spline `j` of `kv1` (columns) have overlapping support — the 1D
    stiffness sparsity pattern.  Ordered row-major."""
    ms1 = kv1.mesh_support_idx_all()    # columns
    ms2 = kv2.mesh_support_idx_all()    # rows
    n2 = ms2.shape[0]
    # for row i: columns j with ms1[j,1] > ms2[i,0] and ms1[j,0] < ms2[i,1]
    j_start = np.searchsorted(ms1[:, 1], ms2[:, 0], side='right')
    j_end = np.searchsorted(ms1[:, 0], ms2[:, 1], side='left')
    j_end = np.maximum(j_end, j_start)
    counts = j_end - j_start
    I = np.repeat(np.arange(n2), counts)
    J = np.concatenate([np.arange(a, b) for a, b in zip(j_start, j_end)]) \
        if n2 > 0 else np.empty(0, dtype=np.int64)
    return np.column_stack((I, J)).astype(np.uint32)


def compute_dense_ij(m, n):
    """All (i, j) indices of a dense ``m x n`` matrix, row-major."""
    I, J = np.divmod(np.arange(m * n), n)
    return np.column_stack((I, J)).astype(np.uint32)


def transpose_idx_for_bidx(bidx):
    """For each entry s of `bidx` (pairs over a square block), the index of
    the transposed pair (j, i) in `bidx`.  Used for symmetric mirroring.
    (Replaces mlmatrix_cy.get_transpose_idx_for_bidx.)"""
    n = int(bidx.max()) + 1 if len(bidx) else 0
    keys = bidx[:, 0].astype(np.int64) * n + bidx[:, 1]
    tkeys = bidx[:, 1].astype(np.int64) * n + bidx[:, 0]
    order = np.argsort(keys)
    pos = np.searchsorted(keys[order], tkeys)
    idx = order[pos]
    assert np.array_equal(keys[idx], tkeys), 'bidx is not structurally symmetric'
    return idx


# alias for reference-API parity
get_transpose_idx_for_bidx = transpose_idx_for_bidx


################################################################################
# Multi-level nonzero enumeration (replaces ml_nonzero_{2,3,n}d)
################################################################################

def ml_nonzero(bidx, block_sizes, lower_tri=False):
    """Global (row, col) indices of all nonzeros of a multilevel matrix,
    in C order of the compact data tensor.

    Args:
        bidx: per-level ``nnz_k x 2`` index arrays.
        block_sizes: ``L x 2`` array of per-level (rows, cols) block sizes.
        lower_tri: only return entries with ``row >= col``.
    """
    bs = np.asarray(block_sizes)
    L = len(bidx)
    I = np.zeros((), dtype=np.int64)
    J = np.zeros((), dtype=np.int64)
    for k in range(L):
        ik = bidx[k][:, 0].astype(np.int64)
        jk = bidx[k][:, 1].astype(np.int64)
        I = I[..., np.newaxis] * bs[k, 0] + ik if k > 0 else ik
        J = J[..., np.newaxis] * bs[k, 1] + jk if k > 0 else jk
    I, J = I.ravel(), J.ravel()
    if lower_tri:
        mask = I >= J
        return I[mask], J[mask]
    return I, J


################################################################################
# MLStructure
################################################################################

class MLStructure:
    """Sparsity structure of an L-level block-structured matrix (the sparsity
    of a Kronecker product of L sparse patterns).

    Args:
        bs: per-level block sizes ``((m_1, n_1), ..., (m_L, n_L))``.
        bidx: per-level ``nnz_k x 2`` arrays of nonzero (i, j) positions.
    """

    def __init__(self, bs, bidx):
        self.bs = tuple(tuple(b) for b in bs)
        self._bs_arr = np.array(self.bs)
        assert self._bs_arr.shape[1] == 2, 'invalid block sizes'
        self.bidx = tuple(bidx)
        assert len(self.bs) == len(self.bidx)
        self.L = len(self.bs)
        self.shape = (int(np.prod([b[0] for b in self.bs])),
                      int(np.prod([b[1] for b in self.bs])))

    # -- constructors ---------------------------------------------------------

    @staticmethod
    def multi_banded(bs, bw):
        """Square multi-level banded structure with sizes `bs`, bandwidths `bw`."""
        return MLStructure(
            tuple((n, n) for n in bs),
            tuple(compute_banded_sparsity_ij(n, p) for n, p in zip(bs, bw)))

    @staticmethod
    def dense(shape):
        """One-level dense structure."""
        return MLStructure((tuple(shape),), (compute_dense_ij(*shape),))

    @staticmethod
    def from_kvs(kvs0, kvs1):
        """Structure of a matrix over trial space `kvs0` / test space `kvs1`
        (rows = test functions)."""
        bs = tuple((kv1.numdofs, kv0.numdofs) for kv0, kv1 in zip(kvs0, kvs1))
        bidx = tuple(compute_sparsity_ij(kv0, kv1) for kv0, kv1 in zip(kvs0, kvs1))
        return MLStructure(bs, bidx)

    @staticmethod
    def from_matrix(A):
        """One-level structure with the sparsity pattern of `A`, in the
        matrix's natural ``nonzero()`` order (row-major for CSR; this makes
        Kronecker structures enumerate in scipy's ``kron`` COO order)."""
        I, J = A.nonzero()
        return MLStructure(
            (tuple(A.shape),),
            (np.column_stack((I, J)).astype(np.uint32),))

    @staticmethod
    def from_kronecker(As):
        """Structure of the Kronecker product of the matrices `As`."""
        S = MLStructure.from_matrix(As[0])
        for A in As[1:]:
            S = S.join(MLStructure.from_matrix(A))
        return S

    # -- structure manipulation -----------------------------------------------

    def join(self, other):
        """Concatenate the levels of two structures."""
        return MLStructure(self.bs + other.bs, self.bidx + other.bidx)

    def reorder(self, axes):
        """Permute the levels according to `axes`."""
        assert len(axes) == self.L
        return MLStructure(tuple(self.bs[j] for j in axes),
                           tuple(self.bidx[j] for j in axes))

    def slice(self, start, end=None):
        """Sub-structure for one or several consecutive levels."""
        assert 0 <= start < self.L, 'invalid slice index'
        if end is None:
            end = start + 1
        return MLStructure(self.bs[start:end], self.bidx[start:end])

    def transpose(self):
        """Structure of the transposed matrix (bidx stays in the same order)."""
        bs = tuple((b[1], b[0]) for b in self.bs)
        bidx = tuple(np.ascontiguousarray(bx[:, ::-1]) for bx in self.bidx)
        return MLStructure(bs, bidx)

    def make_mlmatrix(self, data=None, matrix=None):
        """Create an :class:`MLMatrix` over this structure."""
        return MLMatrix(structure=self, data=data, matrix=matrix)

    # -- queries ----------------------------------------------------------------

    def nonzero(self, lower_tri=False):
        """(rows, cols) arrays of all nonzeros, in C order of the data tensor."""
        if self.L == 1:
            assert not lower_tri, 'Lower triangular part not implemented in 1D'
            return (self.bidx[0][:, 0].astype(np.int64),
                    self.bidx[0][:, 1].astype(np.int64))
        return ml_nonzero(self.bidx, self._bs_arr, lower_tri=lower_tri)

    def _level_rowwise_interactions(self, k):
        """Per row index of level `k`, the array of interacting column indices."""
        num_rows = self.bs[k][0]
        bx = self.bidx[k]
        result = [[] for _ in range(num_rows)]
        for i, j in bx:
            result[i].append(j)
        return [np.array(r, dtype=np.int64) for r in result]

    def nonzeros_for_rows(self, row_indices, renumber_rows=False):
        """(I, J) arrays of the nonzeros located in the given global rows.
        With ``renumber_rows=True``, also return the positions of each entry's
        row within `row_indices`."""
        row_indices = np.asarray(row_indices, dtype=np.int64)
        if len(row_indices) == 0:
            empty = np.empty(0, dtype=np.int64)
            return (empty, empty, empty) if renumber_rows else (empty, empty)

        L = self.L
        lvia = [self._level_rowwise_interactions(k) for k in range(L)]
        bs_I = tuple(self.bs[k][0] for k in range(L))
        bs_J = np.array([self.bs[k][1] for k in range(L)], dtype=np.int64)

        ix = np.column_stack(np.unravel_index(row_indices, bs_I))

        # per row: raveled cartesian product of the per-level column sets
        Js, counts = [], []
        for r in range(len(row_indices)):
            cols = lvia[0][ix[r, 0]]
            J = cols
            for k in range(1, L):
                cols_k = lvia[k][ix[r, k]]
                J = (J[:, None] * bs_J[k] + cols_k[None, :]).ravel()
            Js.append(J)
            counts.append(len(J))

        counts = np.array(counts)
        Is = np.repeat(row_indices, counts)
        Js = np.concatenate(Js) if Js else np.empty(0, dtype=np.int64)
        if renumber_rows:
            return Is, Js, np.repeat(np.arange(len(row_indices)), counts)
        return Is, Js

    def nonzeros_for_columns(self, col_indices):
        """(I, J) arrays of the nonzeros located in the given global columns."""
        J, I = self.transpose().nonzeros_for_rows(col_indices)
        return I, J

    def sequential_bidx(self):
        """Per-level raveled nonzero indices (``i * cols + j`` — the same
        row-major convention :func:`from_seq`/:func:`reindex_from_multilevel`
        decode; raveling by the ROW count was silently wrong for non-square
        levels)."""
        return [self.bs[j][1] * self.bidx[j][:, 0].astype(np.int64)
                + self.bidx[j][:, 1] for j in range(self.L)]


################################################################################
# MLMatrix
################################################################################

class MLMatrix(scipy.sparse.linalg.LinearOperator):
    """Compact multilevel matrix: an L-way dense data tensor over an
    :class:`MLStructure`.  Acts as a scipy LinearOperator on host; the device
    matvec path operates on the same data tensor
    (see :func:`pyiga_jax.ops.mlmatvec.ml_matvec`)."""

    def __init__(self, structure, data=None, matrix=None):
        self.structure = structure
        self.L = structure.L
        self.shape = structure.shape
        self.datashape = tuple(len(bi) for bi in structure.bidx)
        self._csr_cache = None

        assert data is None or matrix is None, \
            'Can only specify one of `data` and `matrix`'
        if data is not None:
            assert data.shape == self.datashape, 'Wrong shape of data tensor'
            self._data = np.ascontiguousarray(data)
            dtype = self._data.dtype
        elif matrix is not None:
            assert matrix.shape == self.shape, 'Matrix has wrong shape'
            vals = np.asarray(matrix[self.nonzero()]).reshape(self.datashape)
            self._data = np.ascontiguousarray(vals)
            dtype = self._data.dtype
        else:
            self._data = None
            dtype = np.float64

        super().__init__(shape=self.shape, dtype=dtype)

    @property
    def nnz(self):
        return int(np.prod(self.datashape))

    @property
    def data(self):
        return self._data

    @data.setter
    def data(self, X):
        assert X.shape == self.datashape
        self._data = np.ascontiguousarray(X)
        self._csr_cache = None
        self.dtype = self._data.dtype    # keep the LinearOperator honest

    def asmatrix(self, format='csr'):
        """Expand to a scipy sparse matrix."""
        assert self._data is not None, 'matrix has no data'
        if self.L == 1:
            return scipy.sparse.coo_matrix(
                (self._data, (self.structure.bidx[0][:, 0],
                              self.structure.bidx[0][:, 1])),
                shape=self.shape).asformat(format)
        IJ = self.nonzero()
        A = scipy.sparse.csr_matrix((self._data.ravel(), IJ), shape=self.shape)
        return A.asformat(format)

    def _matvec(self, x):
        assert self._data is not None, 'matrix has no data'
        assert len(x) == self.shape[1], 'Invalid input size'
        if self._csr_cache is None:
            self._csr_cache = self.asmatrix('csr')
        return self._csr_cache.dot(x)

    def nonzero(self, lower_tri=False):
        return self.structure.nonzero(lower_tri=lower_tri)

    def reorder(self, axes):
        """Permute the levels of the matrix according to `axes`."""
        assert len(axes) == self.L
        newdata = None if self.data is None else np.transpose(self.data, axes)
        return MLMatrix(structure=self.structure.reorder(axes), data=newdata)


################################################################################
# Reordering / reindexing (Van Loan-Pitsianis)
################################################################################

def reorder(X, m1, n1):
    """Reorder a dense matrix with ``m1 x n1`` blocks of size ``m2 x n2`` so
    that each block becomes one row of the output ([Van Loan, Pitsianis 1993])."""
    M, N = X.shape
    m2, n2 = M // m1, N // n1
    assert M == m1 * m2 and N == n1 * n2, 'Invalid block size'
    return (X.reshape(m1, m2, n1, n2)
             .transpose(0, 2, 1, 3)
             .reshape(m1 * n1, m2 * n2))


def reindex_from_reordered(i, j, m1, n1, m2, n2):
    """Map an index (i, j) of ``reorder(X, m1, n1)`` back to an index of X."""
    bi0, bi1 = divmod(i, n1)
    ii0, ii1 = divmod(j, n2)
    return (bi0 * m2 + ii0, bi1 * n2 + ii1)


def from_seq(i, dims):
    """Lexicographic index -> multi-index (list)."""
    L = len(dims)
    I = L * [0]
    for k in reversed(range(L)):
        i, I[k] = divmod(i, dims[k])
    return I


def to_seq(I, dims):
    """Multi-index -> lexicographic index."""
    i = 0
    for k in range(len(dims)):
        i = i * dims[k] + I[k]
    return i


def reindex_to_multilevel(i, j, bs):
    """Global (i, j) -> per-level raveled pair indices."""
    bs = np.asarray(bs)
    I, J = from_seq(i, bs[:, 0]), from_seq(j, bs[:, 1])
    return tuple(to_seq((I[k], J[k]), bs[k, :]) for k in range(bs.shape[0]))


def reindex_from_multilevel(M, bs):
    """Per-level raveled pair indices -> global (i, j)."""
    bs = np.asarray(bs)
    IJ = np.stack([from_seq(M[k], bs[k, :]) for k in range(len(M))], axis=0)
    return tuple(to_seq(IJ[:, m], bs[:, m]) for m in range(2))


################################################################################
# Entrywise generators over the reordered (compact) matrix (for ACA)
################################################################################

def ReorderedMatrixGenerator(multiasm, structure):
    """2D compact-matrix generator backed by a multi-entry assembler callback."""
    from . import lowrank
    assert structure.L == 2
    n1, m1 = structure.bs[0]
    n2, m2 = structure.bs[1]
    sparsidx = structure.sequential_bidx()

    def multientryfunc(indices):
        return multiasm(
            [reindex_from_reordered(sparsidx[0][i], sparsidx[1][j],
                                    n1, m1, n2, m2)
             for (i, j) in indices])

    shp = tuple(len(si) for si in sparsidx)
    return lowrank.MatrixGenerator(shp[0], shp[1], multientryfunc=multientryfunc)


def ReorderedTensorGenerator(multiasm, structure):
    """L-dimensional compact-tensor generator backed by a multi-entry
    assembler callback."""
    from . import lowrank
    L = structure.L
    bs = structure._bs_arr
    sparsidx = structure.sequential_bidx()

    def multientryfunc(indices):
        converted = []
        for idx in indices:
            Ms = [sparsidx[k][idx[k]] for k in range(L)]
            converted.append(reindex_from_multilevel(Ms, bs))
        return multiasm(converted)

    shp = tuple(len(si) for si in sparsidx)
    return lowrank.TensorGenerator(shp, multientryfunc=multientryfunc)
