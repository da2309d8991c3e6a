"""Device-side (JAX/XLA) compute kernels for pyiga_jax.

Submodules:

* :mod:`pyiga_jax.ops.basis` — dense per-axis basis value/derivative tables.
* :mod:`pyiga_jax.ops.geom` — geometry fields (values/Jacobians, det/inv) on
  tensor-product Gauss grids, evaluated on device.
* :mod:`pyiga_jax.ops.sumfac` — sum-factorization assembly of the compact
  multilevel-banded data tensor (the replacement for the reference's
  per-entry Cython assemblers).
* :mod:`pyiga_jax.ops.mlmatvec` — matrix-free matvec on the compact tensor.
"""
