"""Batched dense interior-point method in JAX.

A device-native Mehrotra predictor-corrector for DENSE bounded LPs, designed
to vmap over instance batches: the normal-equations matrix ``A D A'`` is a
batched matmul and its factorisation a batched Cholesky.  This is the
device analog of the host solvers/ipm.py (which remains the accuracy path
for large sparse LPs): use it to barrier-solve fleets of small/medium LPs —
e.g. perturbed subproblems or OT/MCF relaxations — without leaving the chip.

Free variables are handled with a wide internal box (no augmented system on
device); fixed columns should be presolved out by the caller.  Check the
returned ``converged`` mask: a small fraction of ill-conditioned instances
may stall at loose accuracy — route those through the host IPM
(solvers/ipm.py), which carries regularised factorisations.
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp


@partial(jax.jit, static_argnames=("max_iters",))
def ipm_dense(A, b, c, l, u, tol: float = 1e-8, max_iters: int = 50,
              mu_exit: float | None = None):
    """Single-instance dense IPM (jit/vmap-compatible).

    Args:
        A: (m, n) dense equality matrix; b: (m,); c, l, u: (n,)
           (bounds may be +/-inf; fully free columns get a wide box).
        mu_exit: stop once complementarity mu falls below this, even if
            the residual test hasn't passed.  In f32 the residuals floor
            around 1e-5 while mu keeps collapsing; driving mu to 1e-8
            with 1e-5 residuals yields an OFF-CENTRAL iterate that is a
            poor warm start (solvers/ipm_fleet.py hands off here).
            Default: 1e-7 in f32, 0 in f64.

    Returns:
        dict with x, y, zl, zu, obj_val, iters, converged.
    """
    A = jnp.asarray(A)
    m, n = A.shape
    dtype = A.dtype
    if mu_exit is None:
        mu_exit = 0.0 if dtype == jnp.float64 else 1e-7
    mu_exit = jnp.asarray(mu_exit, dtype)
    b = jnp.asarray(b, dtype)
    c = jnp.asarray(c, dtype)
    scale = 1.0 + jnp.maximum(jnp.abs(b).max(), 1.0)
    wide = 1e6 * scale
    l = jnp.where(jnp.isfinite(l), l, jnp.where(jnp.isfinite(u), -wide, -wide))
    u = jnp.where(jnp.isfinite(u), u, wide)
    l = jnp.asarray(l, dtype)
    u = jnp.asarray(u, dtype)

    x0 = 0.5 * (l + u)
    p0 = x0 - l
    q0 = u - x0
    zl0 = jnp.ones(n, dtype) * (1.0 + jnp.abs(c))
    zu0 = jnp.ones(n, dtype) * (1.0 + jnp.abs(c))
    y0 = jnp.zeros(m, dtype)

    bnorm = 1.0 + jnp.linalg.norm(b)
    cnorm = 1.0 + jnp.linalg.norm(c)
    reg_base = jnp.asarray(1e-10 if dtype == jnp.float64 else 1e-6, dtype)

    def max_step(v, dv):
        neg = dv < 0
        r = jnp.where(neg, -v / jnp.where(neg, dv, -1.0), jnp.inf)
        return jnp.minimum(1.0, jnp.min(r))

    def converged(p, q, zl, zu, y):
        x = l + p
        pres = jnp.linalg.norm(b - A @ x) / bnorm
        dres = jnp.linalg.norm(c - A.T @ y - zl + zu) / cnorm
        pobj = c @ x
        dobj = b @ y + l @ zl - u @ zu
        relgap = jnp.abs(pobj - dobj) / (1 + jnp.abs(pobj) + jnp.abs(dobj))
        return (pres < tol) & (dres < tol) & (relgap < tol)

    def step(state):
        p, q, zl, zu, y, it, _, mu_prev, stall = state
        x = l + p
        r_p = b - A @ x
        r_d = c - A.T @ y - zl + zu
        gap = p @ zl + q @ zu
        mu = gap / (2 * n)
        # stall tracking: at the f32 precision floor mu stops contracting;
        # burning further Mehrotra steps there only pollutes the iterate
        stall = jnp.where(mu > 0.7 * mu_prev, stall + 1, 0)

        dinv = zl / p + zu / q
        d = 1.0 / dinv
        ADA = (A * d[None, :]) @ A.T
        ADA_reg = ADA + reg_base * (1.0 + jnp.diagonal(ADA).max()) * jnp.eye(
            m, dtype=dtype)
        cho = jax.scipy.linalg.cho_factor(ADA_reg)

        def newton(rp, rd, rcl, rcu):
            rhs_x = rd - rcl / p + rcu / q
            rhs_y = rp + A @ (d * rhs_x)
            dy = jax.scipy.linalg.cho_solve(cho, rhs_y)
            # one iterative-refinement pass: the f32 Cholesky at
            # cond(ADA) ~ 1/mu loses most of its digits mid-solve, which
            # is what stalls primal feasibility on f32 backends; the
            # refreshed residual solve recovers them at O(m^2) cost
            dy = dy + jax.scipy.linalg.cho_solve(cho, rhs_y - ADA @ dy)
            dx = d * (A.T @ dy - rhs_x)
            dzl = (rcl - zl * dx) / p
            dzu = (rcu + zu * dx) / q
            return dx, dy, dzl, dzu

        # predictor
        dx_a, dy_a, dzl_a, dzu_a = newton(r_p, r_d, -p * zl, -q * zu)
        ap = jnp.minimum(max_step(p, dx_a), max_step(q, -dx_a))
        ad = jnp.minimum(max_step(zl, dzl_a), max_step(zu, dzu_a))
        gap_aff = ((p + ap * dx_a) @ (zl + ad * dzl_a)
                   + (q - ap * dx_a) @ (zu + ad * dzu_a))
        sigma = jnp.clip((gap_aff / gap) ** 3, 0.0, 1.0)

        # corrector
        rcl = sigma * mu - p * zl - dx_a * dzl_a
        rcu = sigma * mu - q * zu + dx_a * dzu_a
        dx, dy, dzl, dzu = newton(r_p, r_d, rcl, rcu)
        ap = 0.9995 * jnp.minimum(max_step(p, dx), max_step(q, -dx))
        ad = 0.9995 * jnp.minimum(max_step(zl, dzl), max_step(zu, dzu))

        # damp the step so mu lands ON mu_exit instead of overshooting it
        # by orders of magnitude (the endgame handoff wants a CENTERED
        # iterate at the target mu, not a collapsed one); no-op when
        # mu_exit == 0
        gap_next = ((p + ap * dx) @ (zl + ad * dzl)
                    + (q - ap * dx) @ (zu + ad * dzu))
        target = 0.5 * mu_exit * (2 * n)
        t = jnp.where(gap_next < target,
                      jnp.sqrt(target / jnp.maximum(gap_next, 1e-30)),
                      1.0)
        t = jnp.clip(t, 0.05, 1.0)
        ap = ap * t
        ad = ad * t

        floor = jnp.asarray(1e-16 if dtype == jnp.float64 else 1e-8, dtype)
        p = jnp.maximum(p + ap * dx, floor)
        q = jnp.maximum(q - ap * dx, floor)
        y = y + ad * dy
        zl = jnp.maximum(zl + ad * dzl, floor)
        zu = jnp.maximum(zu + ad * dzu, floor)
        return p, q, zl, zu, y, it + 1, jnp.asarray(False), mu, stall

    def body(state):
        p, q, zl, zu, y, it, _, mu_prev, stall = state
        # exit BEFORE stepping once converged: one extra Mehrotra step past
        # convergence destroys the normal-equations conditioning (mu -> 0)
        done = converged(p, q, zl, zu, y)
        return jax.lax.cond(
            done,
            lambda s: (*s[:6], jnp.asarray(True), *s[7:]),
            step,
            (p, q, zl, zu, y, it, jnp.asarray(False), mu_prev, stall))

    def cond(state):
        p, q, zl, zu, y, it, done, mu_prev, stall = state
        return ((~done) & (it < max_iters) & (stall < 4)
                & (mu_prev > mu_exit))

    # full-f32 products: a default-precision f32 product may run in TF32
    # on the GPU, which caps residuals near 1e-3
    with jax.default_matmul_precision("highest"):
        p, q, zl, zu, y, iters, done, _, _ = jax.lax.while_loop(
            cond, body, (p0, q0, zl0, zu0, y0, jnp.asarray(0),
                         jnp.asarray(False), jnp.asarray(jnp.inf, dtype),
                         jnp.asarray(0)))
        done = done | converged(p, q, zl, zu, y)
    x = l + p
    return {"x": x, "y": y, "zl": zl, "zu": zu,
            "obj_val": c @ x, "iters": iters, "converged": done}


@partial(jax.jit, static_argnames=("max_iters",))
def ipm_dense_batched(A, b, c, l, u, tol: float = 1e-8, max_iters: int = 50,
                      mu_exit: float | None = None):
    """vmapped dense IPM over a batch: A (B, m, n), b (B, m), etc."""
    return jax.vmap(
        lambda A_, b_, c_, l_, u_: ipm_dense(A_, b_, c_, l_, u_, tol,
                                             max_iters, mu_exit=mu_exit)
    )(A, b, c, l, u)
