"""Native (C++) host kernels, compiled on demand with g++ and loaded via
ctypes.  Falls back to pure numpy implementations when no compiler is
available.  The kernels cover strictly-sequential algorithms whose update
order is part of the numerical contract (Gauss-Seidel sweeps for the local
multigrid smoother) — see iga_kernels.cc.
"""

import ctypes
import hashlib
import os
import subprocess
import sys

import numpy as np

_LIB = None
_TRIED = False

_SRC = os.path.join(os.path.dirname(__file__), 'iga_kernels.cc')


def _cache_dir():
    # build/ at the root of the checkout (listed in .gitignore); the
    # library is built with -march=native, so it is never shared between
    # hosts
    base = os.path.join(os.path.dirname(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__)))), 'build', 'native')
    os.makedirs(base, exist_ok=True)
    return base


def _build_library():
    with open(_SRC, 'rb') as f:
        src = f.read()
    tag = hashlib.sha256(src).hexdigest()[:16]
    out = os.path.join(_cache_dir(), 'libiga_%s.so' % tag)
    if not os.path.exists(out):
        tmp = out + '.tmp.%d' % os.getpid()
        cmd = ['g++', '-O3', '-march=native', '-shared', '-fPIC',
               '-o', tmp, _SRC]
        subprocess.run(cmd, check=True, capture_output=True)
        os.replace(tmp, out)
    return out


def get_lib():
    """Load (building if necessary) the native kernel library, or None."""
    global _LIB, _TRIED
    if _TRIED:
        return _LIB
    _TRIED = True
    try:
        path = _build_library()
        lib = ctypes.CDLL(path)
        i64p = ctypes.POINTER(ctypes.c_int64)
        f64p = ctypes.POINTER(ctypes.c_double)
        lib.gauss_seidel_csr.argtypes = [
            i64p, i64p, f64p, f64p, f64p,
            ctypes.c_int64, ctypes.c_int64, ctypes.c_int64]
        lib.gauss_seidel_csr_indexed.argtypes = [
            i64p, i64p, f64p, f64p, f64p, i64p,
            ctypes.c_int64, ctypes.c_int]
        lib.rank_1_update.argtypes = [
            f64p, ctypes.c_int64, ctypes.c_int64, ctypes.c_double, f64p, f64p]
        _LIB = lib
    except Exception as e:      # no compiler / build failure: numpy fallback
        print('pyiga_jax.native: falling back to numpy kernels (%s)' % e,
              file=sys.stderr)
        _LIB = None
    return _LIB


def _i64(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))


def _f64(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))


def _csr_arrays(A):
    indptr = np.asarray(A.indptr, dtype=np.int64)
    indices = np.asarray(A.indices, dtype=np.int64)
    data = np.asarray(A.data, dtype=np.float64)
    return indptr, indices, data


def _x_buffer(x):
    """A float64 C-contiguous buffer for the in-place update.  Returns
    ``(buf, writeback)``: `buf` aliases `x` when it already has the right
    dtype/layout; otherwise a converted copy that the caller must copy
    back (passing a float32 or strided buffer straight to the C kernel
    would reinterpret it as double* — heap corruption)."""
    if (isinstance(x, np.ndarray) and x.dtype == np.float64
            and x.flags.c_contiguous):
        return x, False
    return np.ascontiguousarray(x, dtype=np.float64), True


def gauss_seidel_sweep(A, x, b, reverse=False):
    """One forward/backward Gauss-Seidel sweep on CSR matrix `A`, in place
    (non-contiguous/non-f64 `x` is updated through a copy-back)."""
    indptr, indices, data = _csr_arrays(A)
    x_in = x
    x, writeback = _x_buffer(x)
    b = np.ascontiguousarray(b, dtype=np.float64)
    N = A.shape[0]
    lib = get_lib()
    if lib is not None:
        start, end, step = (N - 1, -1, -1) if reverse else (0, N, 1)
        lib.gauss_seidel_csr(_i64(indptr), _i64(indices), _f64(data),
                             _f64(x), _f64(b), start, end, step)
    else:
        rng = range(N - 1, -1, -1) if reverse else range(N)
        for i in rng:
            lo, hi = indptr[i], indptr[i + 1]
            cols = indices[lo:hi]
            vals = data[lo:hi]
            z = vals @ x[cols]
            dv = vals[cols == i]
            diag = dv[0] if len(dv) else 0.0
            if diag != 0.0:             # zero/missing diagonal: skip
                x[i] = (b[i] - (z - diag * x[i])) / diag
    if writeback:
        x_in[...] = x
        return x_in
    return x


def gauss_seidel_sweep_indexed(A, x, b, rows, reverse=False):
    """Gauss-Seidel sweep over the given row subset, in the given order
    (non-contiguous/non-f64 `x` is updated through a copy-back)."""
    indptr, indices, data = _csr_arrays(A)
    rows = np.ascontiguousarray(rows, dtype=np.int64)
    x_in = x
    x, writeback = _x_buffer(x)
    b = np.ascontiguousarray(b, dtype=np.float64)
    lib = get_lib()
    if lib is not None:
        lib.gauss_seidel_csr_indexed(_i64(indptr), _i64(indices), _f64(data),
                                     _f64(x), _f64(b), _i64(rows), len(rows),
                                     int(reverse))
    else:
        order = rows[::-1] if reverse else rows
        for i in order:
            lo, hi = indptr[i], indptr[i + 1]
            cols = indices[lo:hi]
            vals = data[lo:hi]
            z = vals @ x[cols]
            dv = vals[cols == i]
            diag = dv[0] if len(dv) else 0.0
            if diag != 0.0:             # zero/missing diagonal: skip
                x[i] = (b[i] - (z - diag * x[i])) / diag
    if writeback:
        x_in[...] = x
        return x_in
    return x


def rank_1_update(A, alpha, x, y):
    """In-place ``A += alpha * outer(x, y)`` (single-threaded native kernel)."""
    lib = get_lib()
    if lib is not None and A.flags.c_contiguous:
        lib.rank_1_update(_f64(A), A.shape[0], A.shape[1], float(alpha),
                          _f64(np.ascontiguousarray(x, dtype=np.float64)),
                          _f64(np.ascontiguousarray(y, dtype=np.float64)))
        return A
    A += alpha * np.outer(x, y)
    return A
