"""Global configuration for pyiga_jax.

The reference library's entire config system is a global thread count
(/root/reference/pyiga/__init__.py:10-19).  Here the analogous global
knobs are the compute dtype used on device and the backend/device
selection.  :func:`platform` is the one place that decides which path a
platform takes.
"""

import os

import numpy as np


class _State:
    # process-wide, like the reference's module-global thread count —
    # settings made on one thread must be visible to worker threads
    pass


_state = _State()

_DEFAULTS = dict(
    # dtype used for device-side assembly/solver computation.  float64 gives
    # entrywise parity with the reference CPU implementation (<= 1e-10);
    # float32 halves the bytes of every bandwidth-bound kernel.
    dtype=np.float64,
    # number of host worker threads (kept for API parity with
    # pyiga.get_max_threads / set_max_threads)
    max_threads=os.cpu_count() or 1,
    # 'auto': pick jax.default_backend(); or 'cpu'/'gpu' explicitly.
    backend="auto",
    # dof cutoff for routing tiny per-level hierarchical assemblies to the
    # host CPU backend (see host_assembly_cutoff)
    host_assembly_cutoff=40000,
    # dof cutoff for routing small local-MG solves to the host CSR kernels
    # (see host_solve_cutoff)
    host_solve_cutoff=100000,
)

# platforms the package runs on; both compute float64 natively
PLATFORMS = ("cpu", "gpu")


def _get(name):
    return getattr(_state, name, _DEFAULTS[name])


def get_dtype():
    """Return the configured device compute dtype (numpy dtype)."""
    return _get("dtype")


def set_dtype(dtype):
    """Set the device compute dtype (e.g. ``np.float32`` for the fast path)."""
    _state.dtype = np.dtype(dtype).type


def get_max_threads():
    """Number of host threads used by host-side helpers (API parity with pyiga)."""
    return _get("max_threads")


def set_max_threads(n):
    _state.max_threads = int(n)


def platform():
    """The platform computation lands on: ``'cpu'`` or ``'gpu'``.

    Honours an explicit ``jax.default_device`` pin (a CPU pin in a GPU
    process computes on the CPU).  Any other platform raises: there is no
    default path for hardware this package was not built for."""
    import jax
    pin = jax.config.jax_default_device
    if pin is None:
        name = jax.default_backend()
    else:
        name = getattr(pin, "platform", pin)
    if name not in PLATFORMS:
        raise RuntimeError(
            "pyiga_jax runs on %s; computation would land on %r"
            % (" or ".join(PLATFORMS), name))
    return name


def default_assembly_mode():
    """Default assembly mode: 'exact' (native float64 contractions) on
    every supported platform; the two-float 'ozaki' path is opt-in."""
    platform()
    return "exact"


def require_twofloat_platform(what):
    """Refuse two-float (double-float32) arithmetic where the compiler does
    not preserve its error-free transformations.  On the GPU (H100,
    measured) the pair assembly of ``mode='ozaki'`` lands at ~1e-8
    relative instead of ~1e-13, and the ``'df'`` V-cycle solution drifts
    by ~2e-9 from the host path; returning such numbers as float64 would
    be wrong, so those paths raise there.  The native float64 paths are
    the GPU's."""
    if platform() == "gpu":
        raise NotImplementedError(
            "%s uses two-float arithmetic, which the GPU compiler does not "
            "keep exact (measured ~1e-8 relative instead of ~1e-13); use "
            "the native float64 path (mode='exact')" % what)


def host_assembly_cutoff():
    """Problem-size cutoff (dofs) below which per-level hierarchical
    assemblies run on the host CPU backend in exact-f64 mode even when an
    accelerator is the default: at these sizes the per-dispatch latency
    and the compact-tensor pull dominate any device speedup.  Override
    with ``set_host_assembly_cutoff`` or the ``PYIGA_HOST_ASM_CUTOFF``
    env var; 0 disables host routing."""
    env = os.environ.get("PYIGA_HOST_ASM_CUTOFF")
    if env is not None:
        return int(env)
    return _get("host_assembly_cutoff")


def set_host_assembly_cutoff(n):
    _state.host_assembly_cutoff = int(n)


def host_solve_cutoff():
    """Problem-size cutoff (dofs) below which the local-MG solve runs the
    host CSR kernels even when an accelerator is the default.  Override
    with ``set_host_solve_cutoff`` / ``PYIGA_HOST_SOLVE_CUTOFF``; 0
    disables routing (always use the device path on accelerators)."""
    env = os.environ.get("PYIGA_HOST_SOLVE_CUTOFF")
    if env is not None:
        return int(env)
    return _get("host_solve_cutoff")


def set_host_solve_cutoff(n):
    _state.host_solve_cutoff = int(n)


def get_backend():
    return _get("backend")


def set_backend(name):
    """Select the backend consumed by :func:`default_device`: ``'auto'``
    (JAX's default backend), ``'cpu'`` or ``'gpu'``.  It does not re-route
    jit dispatch by itself; pin computation with ``jax.default_device``."""
    if name not in ("auto",) + PLATFORMS:
        raise ValueError("backend must be 'auto', 'cpu' or 'gpu'")
    _state.backend = name


def compile_cache_dir():
    """Directory of the persistent XLA compilation cache (the analog of the
    reference's on-disk compiled-module cache, compile.py:22,58-73).

    ``JAX_COMPILATION_CACHE_DIR``, when set, is used as it is (JAX reads
    it itself).  Otherwise the cache lives at the fixed path ``.jax_cache``
    at the root of the checkout: the path is part of what a later process
    must find again, so it never depends on a temporary name, a process
    id or the time."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    return os.path.join(root, ".jax_cache")


def use_x64():
    """Enable 64-bit JAX computation and the persistent compile cache.
    Called on import for correctness parity."""
    # XLA's CPU backend enables LLVM fast-math by default, which rewrites
    # the error-free transformations of the two-float pipeline
    # (ops/twofloat.py) into algebraically-equal-but-lossy code under jit
    # (measured: 1e-14 -> 6e-8).  Must be set before the CPU backend
    # initializes.
    flags = os.environ.get("XLA_FLAGS", "")
    if "--xla_cpu_enable_fast_math" not in flags:
        os.environ["XLA_FLAGS"] = \
            (flags + " --xla_cpu_enable_fast_math=false").strip()

    import jax

    jax.config.update("jax_enable_x64", True)
    # a fresh process reloads compiled executables instead of recompiling
    # (the reference persists compiled modules the same way,
    # /root/reference/pyiga/compile.py:58-73); scripts/clear_cache.py
    # wipes it
    if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        jax.config.update("jax_compilation_cache_dir", compile_cache_dir())
    _exclude_cpu_from_persistent_cache()


def _exclude_cpu_from_persistent_cache():
    """Keep XLA:CPU executables out of the persistent cache.

    Reloading an XLA:CPU executable logs a machine-feature mismatch error
    per load even on the host that compiled it (its tuning features, e.g.
    ``+prefer-no-scatter``, are not host features), and a cache copied to
    another host risks SIGILL.  JAX has no per-backend switch, so this
    gates the predicate its compiler consults; GPU entries stay cached.
    Raises if that private API has moved, rather than caching CPU code."""
    import jax._src.compilation_cache as cc
    orig = getattr(cc, "is_cache_used", None)
    if orig is None:
        raise RuntimeError(
            "jax._src.compilation_cache.is_cache_used is gone: update "
            "pyiga_jax.config._exclude_cpu_from_persistent_cache")
    if getattr(orig, "_pyiga_no_cpu", False):
        return

    def is_cache_used(backend):
        return backend.platform != "cpu" and orig(backend)

    is_cache_used._pyiga_no_cpu = True
    cc.is_cache_used = is_cache_used


def default_device():

    """The device computations should run on under the current backend setting."""
    import jax

    backend = get_backend()
    if backend == "auto":
        return jax.devices()[0]
    return jax.devices(backend)[0]
