"""pyiga_jax: an isogeometric analysis framework in JAX, for the GPU.

A from-scratch rebuild of the capabilities of pyiga (c-f-h/pyiga):
variational forms lower to sum-factorization contraction plans executed as
batched native-float64 contractions, matrices live in device memory in a
compact multilevel-banded layout with Kronecker-structured matvecs, and
solvers run matrix-free under jit.

Host-side numpy/scipy handles the small, setup-time combinatorial structures
(knot vectors, sparsity patterns, hierarchical index sets, direct solvers).
"""

__version__ = '0.2.0'

# The default compute dtype is float64 (entry parity with the reference CPU
# implementation); enable 64-bit JAX before any tracing happens.  The float32
# path is selected via config.set_dtype(np.float32).
from .config import use_x64 as _use_x64
_use_x64()

from .config import (            # noqa: F401
    get_max_threads, set_max_threads,
    get_dtype, set_dtype,
    get_backend, set_backend,
)
