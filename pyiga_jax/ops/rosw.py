# -*- coding: utf-8 -*-
"""Device-fused Rosenbrock(-W) stepping for dense-restricted DAE systems.

Behavior contract: one step of :class:`pyiga_jax.solvers._RosenbrockScheme`
(reference: solvers.py:684-708 ``rosenbrock_step``) — one Jacobian
evaluation and one factorization-equivalent of ``W = M - tau*gamma*J`` per
step, ``s`` linear stage solves, embedded-error pair for the adaptive
controller.  The host scheme pays a sparse LU factorization (~44 ms at the
Navier-Stokes bench size) plus several assembly/matvec round trips per
step; at small-to-medium n every one of those is latency-bound on an
accelerator.

Device redesign (dense linear algebra — at these sizes dense beats sparse
on an accelerator by a wide margin):

* The ENTIRE step — Jacobian assembly (caller-supplied traceable
  ``J_fn``), ``W`` formation, all ``s`` stage right-hand sides
  (traceable ``F_fn``) and stage solves, and the embedded pair — runs as
  ONE jitted dispatch; the host fetches one packed vector.
* Stage systems solve by Richardson refinement against a cached
  approximate inverse ``P ~= W^-1``: f32 ``jnp.linalg.inv`` polished by
  two Newton-Schulz iterations in f64 matmuls — after polishing
  ``||PW - I|| ~ 1e-13`` and stage solves converge in 0-2 refinements.
* All dense MATVECS run in two-float f32 pair arithmetic
  (:func:`pyiga_jax.ops.mg._df_mv`): plain fusable f32 with f64-class
  accuracy.
* ``P`` is cached per step size tau (the controller revisits the same
  tau in steady regimes); staleness — tau drift or Jacobian drift — is
  detected by the fetched stage residual and handled by a device-side
  refresh, with the host scheme as the final fallback, so results are
  always solved to ``solve_tol`` no matter how stale the cache.

Accuracy: identical stage algebra to the host scheme with ~1e-13-class
linear solves; adaptive step decisions agree with the host path unless an
accept/reject is within ~1e-10 of the threshold.
"""

import numpy as np

from . import twofloat as tf
from .mg import _df_mv


def _pair(M64):
    """f64 array -> exact two-float f32 pair (traced)."""
    return tf.df_from_f64(M64)


def _solve_pair(Wp, Pp, b64, tol, maxiter):
    """Solve ``W k = b`` by Richardson refinement with the approximate
    inverse ``P`` (all matvecs two-float); returns ``(k64, relres)``."""
    import jax.numpy as jnp
    from jax import lax

    b = _pair(b64)
    nb = jnp.maximum(jnp.linalg.norm(b64), 1e-300)
    k = _df_mv(Pp, b)
    r = tf.df_sub(b, _df_mv(Wp, k))

    def resnorm(r):
        return jnp.linalg.norm(r[0].astype(jnp.float64)
                               + r[1].astype(jnp.float64))

    def cond(c):
        kh, kl, rh, rl, it = c
        res = resnorm((rh, rl))
        keep = jnp.logical_and(res > tol * nb, it < maxiter)
        return jnp.logical_and(keep, jnp.isfinite(res))

    def body(c):
        kh, kl, rh, rl, it = c
        k = tf.df_add((kh, kl), _df_mv(Pp, (rh, rl)))
        r = tf.df_sub(b, _df_mv(Wp, k))
        return (*k, *r, it + 1)

    kh, kl, rh, rl, _it = lax.while_loop(
        cond, body, (*k, *r, jnp.int32(0)))
    relres = resnorm((rh, rl)) / nb
    return tf.df_to_f64((kh, kl)), relres


class DeviceRosenbrockScheme:
    """Drop-in scheme object for :func:`pyiga_jax.solvers._integrate_adaptive`
    / ``_integrate_constant`` whose ``step`` runs on the accelerator.

    Args:
        coeffs: ``(A, Gamma, b, b_hat)`` Rosenbrock arrays (``b_hat`` may
            be None for the constant-step form).
        F_fn: traceable ``F_fn(x, ops) -> (n,)`` f64 (the DAE rhs on the
            restricted dofs).
        J_fn: traceable ``J_fn(x, ops) -> (n, n)`` dense f64 Jacobian.
        M: dense ``(n, n)`` f64 mass matrix (restricted).
        ops: pytree of device operands threaded into ``F_fn``/``J_fn``
            (operand protocol — nothing large may be closed over).
        host_scheme: optional fallback with the
            ``step(M, F, J, x, tau, data, Fx)`` protocol, used when the
            device solve cannot reach ``solve_tol`` (e.g. an f32-singular
            ``W``); pass the matching ``_RosenbrockScheme``.
    """

    def __init__(self, coeffs, F_fn, J_fn, M, ops, *, solve_tol=1e-11,
                 refine_maxiter=60, host_scheme=None):
        import jax
        import jax.numpy as jnp

        A, Gamma, b, b_hat = coeffs
        self.A, self.Gamma = np.asarray(A), np.asarray(Gamma)
        self.b, self.b_hat = b, b_hat
        self._coeffs = (self.A, self.Gamma, b, b_hat)
        self.solve_tol = float(solve_tol)
        self._host_scheme = host_scheme
        self._ops = ops
        self._Mdev = jnp.asarray(np.asarray(M, dtype=np.float64))
        self._P = {}                       # tau -> device P pair
        n = M.shape[0]
        s = self.A.shape[0]
        gamma = float(self.Gamma[0, 0])
        Ac, Gc = self.A, self.Gamma
        bw = np.asarray(b, dtype=np.float64)
        bhw = None if b_hat is None else np.asarray(b_hat, dtype=np.float64)

        def stages(x, tau, Wp, Jp, Pp, ops):
            """All `s` stage solves + solution/embedded combinations for
            one step against prebuilt W/J/P pairs (traceable); returns
            ``(xnew, xhat, relres_max)`` (``xhat = xnew`` when no
            embedded weights)."""
            ks = []
            relres_max = jnp.zeros((), jnp.float64)
            for i in range(s):
                y = x
                for j in range(i):
                    if Ac[i, j] != 0.0:
                        y = y + (tau * Ac[i, j]) * ks[j]
                rhs = F_fn(y, ops)
                if i > 0:
                    g = None
                    for j in range(i):
                        if Gc[i, j] != 0.0:
                            t = Gc[i, j] * ks[j]
                            g = t if g is None else g + t
                    if g is not None:
                        rhs = rhs + tau * tf.df_to_f64(
                            _df_mv(Jp, _pair(g)))
                k, relres = _solve_pair(Wp, Pp, rhs, solve_tol,
                                        refine_maxiter)
                relres_max = jnp.maximum(relres_max, relres)
                ks.append(k)
            xnew = x
            for w, k in zip(bw, ks):
                if w != 0.0:
                    xnew = xnew + (tau * w) * k
            if bhw is None:
                xhat = xnew
            else:
                xhat = x
                for w, k in zip(bhw, ks):
                    if w != 0.0:
                        xhat = xhat + (tau * w) * k
            return xnew, xhat, relres_max

        def step(x, tau, Ph, Pl, M, ops):
            J = J_fn(x, ops)
            W = M - (tau * gamma) * J
            xnew, xhat, relres_max = stages(x, tau, _pair(W), _pair(J),
                                            (Ph, Pl), ops)
            return jnp.concatenate([xnew, xhat, relres_max[None]])

        def refresh(x, tau, M, ops):
            J = J_fn(x, ops)
            W = M - (tau * gamma) * J
            P = jnp.linalg.inv(W.astype(jnp.float32)).astype(jnp.float64)
            I = jnp.eye(n, dtype=jnp.float64)
            for _ in range(2):          # Newton-Schulz: squares the error
                P = P + P @ (I - W @ P)
            return _pair(P)

        self._stepfn = jax.jit(step)
        self._refreshfn = jax.jit(refresh)
        self._stages = stages
        self._J_fn = J_fn
        self._gamma = gamma
        self._n = n
        self._chunk_cache = {}

    def truncated(self):
        """Constant-step form (no embedded estimate), as in
        :meth:`pyiga_jax.solvers._RosenbrockScheme.truncated`."""
        out = object.__new__(DeviceRosenbrockScheme)
        out.__dict__.update(self.__dict__)
        out.b_hat = None
        out._truncated_of = self
        if self._host_scheme is not None:
            out._host_scheme = self._host_scheme.truncated()
        return out

    def _chunk_jit(self, chunk):
        """Jitted fused integrator chunk: up to `chunk` adaptive-controller
        step ATTEMPTS (accepted or rejected) of
        :func:`pyiga_jax.solvers._integrate_adaptive`'s loop as ONE device
        dispatch (`lax.while_loop`).  Per attempt the approximate inverse
        is rebuilt from scratch — an f32 LU inverse polished by one f32
        residual-correction matmul kept unevaluated in the pair's low slot
        (``P = (P0, P0 @ (I - W P0))``, contraction ~1e-5 per Richardson
        refinement; the stage solves iterate to ``solve_tol`` regardless,
        so P quality is a performance knob, not a correctness one).  That
        mirrors the host scheme's factorize-every-step semantics and keeps
        the loop free of cross-step preconditioner state.

        Returns ``(packed, x_out)`` where `packed` is ONE fetchable f64
        vector ``[t, tau, n_accepted, fail, times(chunk),
        states(chunk * n)]`` (one host pull per chunk) and
        `x_out` is the device-resident current state for the next chunk.
        """
        fn = self._chunk_cache.get(chunk)
        if fn is not None:
            return fn
        import jax
        import jax.numpy as jnp
        from jax import lax

        stages, J_fn = self._stages, self._J_fn
        gamma, n, solve_tol = self._gamma, self._n, self.solve_tol
        if self.b_hat is None:
            raise ValueError('fused adaptive integration needs an '
                             'embedded estimate (b_hat)')
        sqrt_n = float(np.sqrt(n))
        highest = jax.lax.Precision.HIGHEST

        def fresh_P(Wp):
            Wh, Wl = Wp
            P0 = jnp.linalg.inv(Wh)
            E = (jnp.eye(n, dtype=Wh.dtype)
                 - (jnp.matmul(Wh, P0, precision=highest)
                    + jnp.matmul(Wl, P0, precision=highest)))
            return (P0, jnp.matmul(P0, E, precision=highest))

        def chunkfn(x, t, tau, t_end, tol, sf, inv_order, M, ops):
            times0 = jnp.zeros((chunk,), jnp.float64)
            states0 = jnp.zeros((chunk, n), jnp.float64)
            state0 = (x, jnp.float64(t), jnp.float64(tau),
                      jnp.int32(0), jnp.int32(0), jnp.bool_(False),
                      times0, states0)

            def cond(c):
                _x, t, _tau, _acc, j, fail, _ts, _xs = c
                return (j < chunk) & (t < t_end) & ~fail

            def body(c):
                x, t, tau, acc, j, fail, ts, xs = c
                J = J_fn(x, ops)
                W = M - (tau * gamma) * J
                Wp = _pair(W)
                xnew, xhat, relres = stages(x, tau, Wp, _pair(J),
                                            fresh_P(Wp), ops)
                ok = (jnp.isfinite(relres) & (relres <= 10 * solve_tol)
                      & jnp.all(jnp.isfinite(xnew))
                      & jnp.all(jnp.isfinite(xhat)))
                # scaled RMS error / accept / step-size update, the exact
                # arithmetic of solvers._integrate_adaptive
                weight = tol + tol * jnp.abs(x)
                r = jnp.linalg.norm((xhat - xnew) / weight) / sqrt_n
                r = jnp.maximum(r, 1e-15)
                accept = ok & (r <= 1.0)
                t2 = jnp.where(accept, t + tau, t)
                x2 = jnp.where(accept, xnew, x)
                ts = ts.at[acc].set(jnp.where(accept, t2, ts[acc]))
                xs = xs.at[acc].set(jnp.where(accept, x2, xs[acc]))
                acc2 = acc + accept.astype(jnp.int32)
                tau2 = jnp.where(
                    ok, tau * jnp.clip(sf * r ** (-inv_order), 0.2, 5.0),
                    tau)        # failed stage solve: host fallback retries
                return (x2, t2, tau2, acc2, j + 1, fail | ~ok, ts, xs)

            x, t, tau, acc, _j, fail, ts, xs = lax.while_loop(
                cond, body, state0)
            packed = jnp.concatenate([
                jnp.stack([t, tau, acc.astype(jnp.float64),
                           fail.astype(jnp.float64)]),
                ts, xs.reshape(-1)])
            return packed, x

        fn = jax.jit(chunkfn)
        self._chunk_cache[chunk] = fn
        return fn

    def integrate_adaptive(self, MFJ, x0, tau0, t_end, tol, err_order, *,
                           t0=0.0, step_factor=0.9, chunk=8,
                           progress=False):
        """Adaptive integration with the WHOLE controller loop fused on
        device (chunks of up to `chunk` step attempts per dispatch; the
        per-step host round-trip amortizes across the chunk).  Produces
        the same (times, solutions) as
        :func:`pyiga_jax.solvers._integrate_adaptive` over this scheme —
        on a failed stage solve the remaining interval falls back to the
        per-step path (which retries with a refreshed preconditioner and
        finally the host scheme).

        `MFJ` is the ``(M, F, J)`` triple of the host path, used only by
        that fallback.
        """
        import jax.numpy as jnp
        from .. import solvers, utils

        jfn = self._chunk_jit(int(chunk))
        n = self._n
        times, sols = [float(t0)], [np.asarray(x0, dtype=np.float64)]
        t, tau = float(t0), float(tau0)
        xd = jnp.asarray(np.asarray(x0, dtype=np.float64))
        self.n_dispatches = 0       # device round-trips this integration
        with utils.progress_bar(progress)(total=t_end - t0) as pbar:
            while t < t_end:
                self.n_dispatches += 1
                packed, xd = jfn(xd, t, tau, t_end, tol,
                                 float(step_factor),
                                 1.0 / float(err_order),
                                 self._Mdev, self._ops)
                packed = np.asarray(packed)
                t_new, tau, accf, failf = packed[:4]
                acc, fail = int(accf), bool(failf)
                times += list(packed[4:4 + acc])
                xs = packed[4 + chunk:].reshape(chunk, n)
                sols += [xs[i].copy() for i in range(acc)]
                pbar.update(t_new - t)
                pbar.set_postfix({'tau': tau})
                t = float(t_new)
                if fail:
                    ht, hs = solvers._integrate_adaptive(
                        self, err_order, *MFJ, sols[-1], float(tau),
                        t_end, tol, t0=t, step_factor=step_factor,
                        progress=progress)
                    times += ht[1:]
                    sols += hs[1:]
                    break
        return times, sols

    def _precond(self, x, tau):
        P = self._P.get(float(tau))
        if P is None:
            P = self._refreshfn(x, float(tau), self._Mdev, self._ops)
            if len(self._P) >= 8:
                self._P.pop(next(iter(self._P)))
            self._P[float(tau)] = P
        return P

    def step(self, M, F, J, x, tau, data=None, Fx=None):
        """One step; same protocol/returns as ``_RosenbrockScheme.step``
        (``M``/``F``/``J`` are only used by the host fallback)."""
        import jax.numpy as jnp
        x = np.asarray(x, dtype=np.float64)
        xd = jnp.asarray(x)
        for attempt in range(2):
            Ph, Pl = self._precond(xd, tau)
            out = np.asarray(self._stepfn(xd, float(tau), Ph, Pl,
                                          self._Mdev, self._ops))
            n = self._n
            xnew, xhat, relres = out[:n], out[n:2 * n], out[2 * n]
            ok = np.isfinite(relres) and relres <= 10 * self.solve_tol \
                and np.all(np.isfinite(xnew))
            if ok:
                if self.b_hat is None:
                    return xnew, None
                return xnew, xhat, None
            # stale/defective preconditioner: rebuild at the CURRENT state
            # and step size, then retry once
            self._P.pop(float(tau), None)
        if self._host_scheme is not None:
            return self._host_scheme.step(M, F, J, x, tau, data=data, Fx=Fx)
        raise RuntimeError('device Rosenbrock stage solve did not reach '
                           'solve_tol (relres=%g) and no host fallback '
                           'was provided' % float(relres))
