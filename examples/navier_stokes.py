# -*- coding: utf-8 -*-
"""Instationary Navier-Stokes channel flow by a mixed spline discretization
with Rosenbrock (ROWDAIND2) time stepping — the reference's Navier-Stokes
notebook workload (BASELINE config 4).

Discretization: Taylor-Hood-like spline pair (velocity degree p, 2
components; pressure degree p-1) on a channel; parabolic inflow on the left,
no-slip walls top/bottom, open outflow right.  The saddle-point DAE

    [M 0] d/dt [u]     [ nu*A + N(u)  B^T ] [u]
    [0 0]      [p]  = -[ B            0   ] [p]

is integrated by the index-2-capable ROWDAIND2 Rosenbrock method; the
convection term is reassembled each evaluation on device through updatable
Assemblers (sum-factorization, no re-tracing)."""

import os
import sys

import numpy as np
import scipy.sparse

sys.path.insert(0, os.path.join(os.path.dirname(__file__), '..'))

from pyiga_jax import assemble, bspline, geometry, solvers
from pyiga_jax.geometry import BSplineFunc


class NavierStokes:
    """Channel-flow Navier-Stokes setup (inflow left, outflow right)."""

    def __init__(self, n_el=(8, 16), p=2, Re=20.0, geo=None):
        self.Re = Re
        self.kvs_u = tuple(bspline.make_knots(p, 0.0, 1.0, n)
                           for n in n_el)
        self.kvs_p = tuple(bspline.make_knots(p - 1, 0.0, 1.0, n)
                           for n in n_el)
        self.geo = geo if geo is not None else \
            geometry.unit_square().scale([2, 1])

        self.m_u = tuple(kv.numdofs for kv in self.kvs_u)
        self.m_p = tuple(kv.numdofs for kv in self.kvs_p)
        self.n_u1 = int(np.prod(self.m_u))
        self.n_u = 2 * self.n_u1
        self.n_p = int(np.prod(self.m_p))

        # blocks
        self.A_grad = assemble.assemble(
            'inner(grad(u), grad(v)) * dx', self.kvs_u,
            bfuns=[('u', 2), ('v', 2)], geo=self.geo)
        self.M_vel = assemble.assemble(
            'inner(u, v) * dx', self.kvs_u,
            bfuns=[('u', 2), ('v', 2)], geo=self.geo)
        self.A_div = assemble.assemble(
            'div(u) * q * dx', (self.kvs_u, self.kvs_p),
            bfuns=[('u', 2, 0), ('q', 1, 1)], geo=self.geo)
        self.M_pre = assemble.assemble('u * v * dx', self.kvs_p, geo=self.geo)

        # steady Stokes operator over the full (u, p) vector
        self.A_stokes = scipy.sparse.bmat(
            [[self.A_grad / Re, self.A_div.T],
             [self.A_div, None]], format='csr')

        # updatable convection assemblers (nonlinear term and linearization)
        zero_vel = BSplineFunc(self.kvs_u,
                               np.zeros(self.m_u + (2,)))
        self.asm_nlconv = assemble.Assembler(
            'grad(vel).dot(vel).dot(v) * dx', self.kvs_u,
            bfuns=[('v', 2)], geo=self.geo, vel=zero_vel, updatable=['vel'])
        self.asm_linconv = assemble.Assembler(
            'grad(u).dot(vel).dot(v) * dx', self.kvs_u,
            bfuns=[('u', 2), ('v', 2)], geo=self.geo, vel=zero_vel,
            updatable=['vel'])

        # boundary conditions: inflow left, no-slip walls, open right
        def g_inflow(x, y):
            return (4 * y * (1 - y), 0.0 * x)

        def g_zero(x, y):
            return (0.0 * x, 0.0 * x)

        self.bcs = assemble.compute_dirichlet_bcs(
            self.kvs_u, self.geo,
            [('bottom', g_zero), ('top', g_zero), ('left', g_inflow)])

        # restricted system over the combined (u, p) vector (the BC indices
        # only touch the velocity part)
        self.LS = assemble.RestrictedLinearSystem(self.A_stokes, 0.0,
                                                  self.bcs)

        # mass matrix over the full vector (zero pressure block), restricted
        M_full = scipy.sparse.bmat(
            [[self.M_vel, None],
             [None, scipy.sparse.csr_matrix((self.n_p, self.n_p))]],
            format='csr')
        self.ns_M = self.LS.restrict_matrix(M_full).tocsc()

    # -- helpers -----------------------------------------------------------------

    def get_components(self, u_p):
        """Velocity and pressure of a full (u, p) vector as spline functions."""
        u1 = u_p[:self.n_u1].reshape(self.m_u)
        u2 = u_p[self.n_u1:self.n_u].reshape(self.m_u)
        U = np.stack((u1, u2), axis=-1)
        prs = u_p[self.n_u:].reshape(self.m_p)
        return (BSplineFunc(self.kvs_u, U), BSplineFunc(self.kvs_p, prs))

    def _apply_navier_stokes(self, u_p):
        vel, _ = self.get_components(u_p)
        z = self.asm_nlconv.assemble(vel=vel)
        nl = np.concatenate((np.asarray(z).ravel(), np.zeros(self.n_p)))
        return nl + self.A_stokes.dot(u_p)

    def _linearized_ns(self, u_p):
        vel, _ = self.get_components(u_p)
        A_lc = self.asm_linconv.assemble(vel=vel)
        return scipy.sparse.bmat(
            [[self.A_grad / self.Re + A_lc, self.A_div.T],
             [self.A_div, 1e-10 * self.M_pre]], format='csr')

    # -- DAE interface -----------------------------------------------------------

    def F(self, x):
        u_p = self.LS.complete(x)
        return -self.LS.restrict(self._apply_navier_stokes(u_p))

    def J(self, x):
        u_p = self.LS.complete(x)
        return -self.LS.restrict_matrix(self._linearized_ns(u_p))

    def initial_state(self):
        """Restricted Stokes solution as the initial value."""
        from pyiga_jax.operators import make_solver
        return make_solver(self.LS.A).dot(self.LS.b)

    # -- device-fused stepping ----------------------------------------------------

    def _traceable_ops(self):
        """Device operands + traceable ``F(x, ops)`` / ``J(x, ops)`` over
        the restricted dofs: the convection terms assemble IN-TRACE as
        functions of the velocity coefficients (collocation-table grid
        evaluation + the assembler's traced contraction), everything else
        enters as precomputed dense blocks.  See
        :class:`pyiga_jax.ops.rosw.DeviceRosenbrockScheme` for why dense."""
        import jax
        import jax.numpy as jnp
        from pyiga_jax.ops import twofloat as tf
        from pyiga_jax.ops.mg import _df_split, _df_mv
        from pyiga_jax.ops.basis import dense_collocation_tables
        from pyiga_jax.ops.geom import tp_apply

        lin, nl = self.asm_linconv.asm, self.asm_nlconv.asm
        inputs_l, tt_l, tp_l = lin._device_operands('exact')
        inputs_n, tt_n, tp_n = nl._device_operands('exact')
        afn_l = lin._assembly_fn('exact')
        afn_n = nl._assembly_fn('exact')
        lin_keys = sorted(afn_l(inputs_l, tt_l, tp_l).keys())
        d, m_u, n_u1 = len(self.kvs_u), self.m_u, self.n_u1

        # per-axis collocation tables of the velocity space on the
        # (shared) Gauss grid, value + first derivative
        assert all(len(g1) == len(g2)
                   for g1, g2 in zip(lin.grid, nl.grid))
        tabs = [np.ascontiguousarray(B.swapaxes(-2, -1))
                for B in dense_collocation_tables(self.kvs_u, lin.grid,
                                                  numderiv=1)]
        val_tabs = [t[0] for t in tabs]
        der_tabs = [t[1] for t in tabs]

        # restricted dof bookkeeping
        N = self.n_u + self.n_p
        free = np.asarray(self.LS.R_free.nonzero()[1], dtype=np.int64)
        n = len(free)
        u_elim = self.LS.complete(np.zeros(n))
        pos = np.full(N, -1, dtype=np.int64)
        pos[free] = np.arange(n)

        # scatter plan: linearized-convection block entries -> dense (n, n)
        I, J = lin.structure.nonzero()
        rr, cc, keep_idx = [], [], []
        for (cu, cv) in lin_keys:
            gr, gc = cv * n_u1 + I, cu * n_u1 + J
            keep = (pos[gr] >= 0) & (pos[gc] >= 0)
            rr.append(pos[gr[keep]])
            cc.append(pos[gc[keep]])
            keep_idx.append(np.nonzero(keep)[0])

        # fixed dense blocks
        K0 = self.LS.restrict_matrix(scipy.sparse.bmat(
            [[self.A_grad / self.Re, self.A_div.T],
             [self.A_div, 1e-10 * self.M_pre]], format='csr')).toarray()
        Ast_pair = _df_split(self.A_stokes.toarray())

        ops = {
            'inputs_l': inputs_l, 'tt_l': tt_l, 'tp_l': tp_l,
            'inputs_n': inputs_n, 'tt_n': tt_n, 'tp_n': tp_n,
            'val_tabs': [jnp.asarray(t) for t in val_tabs],
            'der_tabs': [jnp.asarray(t) for t in der_tabs],
            'K0': jnp.asarray(K0),
            'Ast': tuple(map(jnp.asarray, Ast_pair)),
            'uelim': jnp.asarray(u_elim),
            'free': jnp.asarray(free, dtype=jnp.int32),
            'rr': [jnp.asarray(a, dtype=jnp.int32) for a in rr],
            'cc': [jnp.asarray(a, dtype=jnp.int32) for a in cc],
            'keep': [jnp.asarray(a, dtype=jnp.int32) for a in keep_idx],
        }

        def vel_grid_arrays(ops, u_p, with_deriv):
            vt, dt = ops['val_tabs'], ops['der_tabs']
            comps = [u_p[c * n_u1:(c + 1) * n_u1].reshape(m_u)
                     for c in range(2)]
            vals = jnp.stack([tp_apply(vt, c) for c in comps], axis=0)
            if not with_deriv:
                return vals, None
            # derivative axis in XYZ order: coordinate k = level axis d-1-k
            ders = jnp.stack([
                jnp.stack([tp_apply([dt[j] if j == d - 1 - k else vt[j]
                                     for j in range(d)], c)
                           for k in range(d)], axis=0)
                for c in comps], axis=0)
            return vals, ders

        def complete(x, ops):
            return ops['uelim'].at[ops['free']].set(x)

        def J_fn(x, ops):
            u_p = complete(x, ops)
            vals, _ = vel_grid_arrays(ops, u_p, False)
            inp = dict(ops['inputs_l'])
            inp['input:vel'] = vals
            blocks = afn_l(inp, ops['tt_l'], ops['tp_l'])
            K = ops['K0']
            for key, rrk, cck, keepk in zip(lin_keys, ops['rr'],
                                            ops['cc'], ops['keep']):
                K = K.at[rrk, cck].add(blocks[key].ravel()[keepk])
            return -K

        def F_fn(x, ops):
            u_p = complete(x, ops)
            vals, ders = vel_grid_arrays(ops, u_p, True)
            inp = dict(ops['inputs_n'])
            inp['input:vel'] = vals
            inp['ideriv:vel:1'] = ders
            bn = afn_n(inp, ops['tt_n'], ops['tp_n'])
            nlvec = jnp.concatenate(
                [bn[(None, c)].ravel() for c in range(2)]
                + [jnp.zeros(self.n_p, u_p.dtype)])
            stokes = tf.df_to_f64(_df_mv(ops['Ast'], tf.df_from_f64(u_p)))
            return -(nlvec + stokes)[ops['free']]

        return F_fn, J_fn, ops

    def _device_scheme(self, method):
        """(scheme, err_order) for the device-fused stepper (cached)."""
        cached = getattr(self, '_dev_scheme', None)
        if cached is not None and cached[0] == method:
            return cached[1], cached[2]
        from pyiga_jax.ops.rosw import DeviceRosenbrockScheme
        A, Gamma, b, b_hat, err_order = getattr(
            solvers, 'coeffs_' + method)()
        F_fn, J_fn, ops = self._traceable_ops()
        host = solvers._RosenbrockScheme(A, Gamma, b, b_hat)
        scheme = DeviceRosenbrockScheme((A, Gamma, b, b_hat), F_fn, J_fn,
                                        self.ns_M.toarray(), ops,
                                        host_scheme=host)
        self._dev_scheme = (method, scheme, err_order)
        return scheme, err_order

    def integrate(self, x0=None, tau=5e-2, t_end=0.5, method='rowdaind2',
                  tol=1e-2, progress=False, backend='auto'):
        """Integrate; returns (times, restricted states).

        ``backend='device'`` runs every Rosenbrock step as ONE fused
        device dispatch (:mod:`pyiga_jax.ops.rosw`: in-trace convection
        assembly, dense two-float stage algebra, f32-inverse +
        Newton-Schulz preconditioning) with the host scheme as fallback;
        its dense stage algebra is O(n^2) memory.  ``'host'`` is the
        reference path (sparse LU per step).  ``'auto'`` is 'host': the
        two-float device scheme is opt-in.  Both produce the same step
        sequence to ~1e-10."""
        if x0 is None:
            x0 = self.initial_state()
        if backend == 'auto':
            backend = 'host'
        self.last_backend = backend
        if backend == 'device':
            scheme, err_order = self._device_scheme(method)
            if tol is not None:
                # the whole adaptive loop fused on device (chunks of
                # step attempts per dispatch; ~3x fewer round trips)
                return scheme.integrate_adaptive(
                    (self.ns_M, self.F, self.J), x0, tau, t_end, tol,
                    err_order, progress=progress)
            return solvers._integrate_adaptive(
                scheme, err_order, self.ns_M, self.F, self.J, x0, tau,
                t_end, tol, progress=progress)
        stepper = getattr(solvers, method)
        return stepper(self.ns_M, self.F, self.J, x0, tau, t_end, tol=tol,
                       progress=progress)

    def divergence_norm(self, x):
        u_p = self.LS.complete(x)
        return np.linalg.norm(self.A_div @ u_p[:self.n_u])


if __name__ == '__main__':
    ns = NavierStokes(n_el=(8, 16), p=2, Re=20.0)
    times, states = ns.integrate(tau=5e-2, t_end=0.5, progress=True)
    print('steps:', len(times) - 1)
    print('final divergence norm:', ns.divergence_norm(states[-1]))
    vel, pre = ns.get_components(ns.LS.complete(states[-1]))
    print('velocity magnitude range:',
          float(np.abs(vel.coeffs).max()))
