# Stokes / instationary Navier-Stokes mixed discretization with Rosenbrock
# time stepping (BASELINE config 4; reference notebook solve-navier-stokes).

import pytest
import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), '..', 'examples'))

from navier_stokes import NavierStokes


@pytest.mark.slow
def test_stokes_initial_state():
    ns = NavierStokes(n_el=(6, 10), p=2, Re=10.0)
    x0 = ns.initial_state()
    u_p = ns.LS.complete(x0)
    # velocity is (weakly) divergence free
    assert ns.divergence_norm(x0) < 1e-10
    # inflow profile is reproduced at the outflow (fully developed channel)
    vel, _ = ns.get_components(u_p)
    y = np.linspace(0, 1, 11)
    V = vel.grid_eval((y, np.array([2.0])))     # outflow boundary x=2
    assert np.allclose(V[:, 0, 0], 4 * y * (1 - y), atol=1e-6)
    assert np.allclose(V[:, 0, 1], 0.0, atol=1e-8)


@pytest.mark.slow
def test_navier_stokes_rosenbrock():
    ns = NavierStokes(n_el=(5, 8), p=2, Re=20.0)
    times, states = ns.integrate(tau=5e-2, t_end=0.3, method='rowdaind2',
                                 tol=1e-2)
    assert len(times) >= 2 and times[-1] >= 0.3 - 1e-12
    for x in states:
        assert np.all(np.isfinite(x))
    # the flow stays divergence free throughout the integration
    assert ns.divergence_norm(states[-1]) < 1e-10
    # constant-step DIRK stepping also works on the same DAE
    times2, states2 = ns.integrate(tau=0.1, t_end=0.2, method='ros3pw',
                                   tol=None)
    assert ns.divergence_norm(states2[-1]) < 1e-10


@pytest.mark.slow
def test_navier_stokes_device_scheme_parity():
    """The device-fused Rosenbrock scheme (ops/rosw: in-trace convection
    assembly + dense two-float stage solves) reproduces the host scheme's
    adaptive step sequence and states — both the fully-fused controller
    loop (integrate backend='device': chunked lax.while_loop, one fetch
    per chunk) and the per-step fallback path.  On this CPU test platform
    large fused two-float programs may lose a few digits, so the
    tolerance is loose."""
    from pyiga_jax import solvers
    ns = NavierStokes(n_el=(5, 8), p=2, Re=20.0)
    x0 = ns.initial_state()
    th, sh = ns.integrate(x0=x0, tau=5e-2, t_end=0.25, backend='host')
    td, sd = ns.integrate(x0=x0, tau=5e-2, t_end=0.25, backend='device')
    scheme, err_order = ns._device_scheme('rowdaind2')
    tp, sp = solvers._integrate_adaptive(          # per-step device path
        scheme, err_order, ns.ns_M, ns.F, ns.J, x0, 5e-2, 0.25, 1e-2)
    assert len(th) == len(td) == len(tp)
    assert max(abs(a - b) for a, b in zip(th, td)) < 1e-9
    assert max(abs(a - b) for a, b in zip(th, tp)) < 1e-9
    for a, b, c in zip(sh, sd, sp):
        nrm = max(np.linalg.norm(a), 1e-300)
        assert np.linalg.norm(a - b) / nrm < 1e-6
        assert np.linalg.norm(a - c) / nrm < 1e-6
    # traceable F/J match the host definitions pointwise
    import jax.numpy as jnp
    F_fn, J_fn, ops = ns._traceable_ops()
    x = x0 + 0.01 * np.random.RandomState(0).rand(len(x0))
    Fd = np.asarray(F_fn(jnp.asarray(x), ops))
    Fh = ns.F(x)
    assert np.linalg.norm(Fd - Fh) / np.linalg.norm(Fh) < 1e-9
    Jd = np.asarray(J_fn(jnp.asarray(x), ops))
    Jh = ns.J(x).toarray()
    assert np.abs(Jd - Jh).max() / np.abs(Jh).max() < 1e-12


@pytest.mark.slow
def test_navier_stokes_constant_step_device():
    """Constant-step (truncated) form of the device scheme."""
    ns = NavierStokes(n_el=(5, 8), p=2, Re=20.0)
    x0 = ns.initial_state()
    th, sh = ns.integrate(x0=x0, tau=0.1, t_end=0.2, backend='host',
                          tol=None)
    td, sd = ns.integrate(x0=x0, tau=0.1, t_end=0.2, backend='device',
                          tol=None)
    assert th == td
    for a, b in zip(sh, sd):
        rel = np.linalg.norm(a - b) / max(np.linalg.norm(a), 1e-300)
        assert rel < 1e-6
