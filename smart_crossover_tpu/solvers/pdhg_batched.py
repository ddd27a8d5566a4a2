"""Batched device PDHG: a first-order warm-start engine for LP fleets.

Complements the batched dense IPM (solvers/ipm_batched.py): per IPM
iteration the batched Cholesky costs O(m^3) per instance, while a PDHG
iteration is two matvecs — for fleets of wider LPs (n >> m) or when only
a warm-start-quality point is needed (the host simplex finisher certifies
exactness either way), first-order is the cheaper engine.  Equality form
``min c'x s.t. Ax = b, l <= x <= u`` per instance, fixed iteration count
(a fleet runs in lockstep), the PDLP adaptive step-size rule per instance,
and PDLP-style averaging: both the last iterate and the step-weighted
average are returned; the caller keeps the better per instance.

Every matrix product runs at ``Precision.HIGHEST``
(:func:`config.full_precision_matmuls`): a default-precision float32
product may run in TF32 on the GPU (about three decimal digits).

No reference analog (the reference is single-instance and buys its
barrier from vendors; reference lp_methods/algorithms.py:38-40).
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from smart_crossover_tpu.config import full_precision_matmuls


@full_precision_matmuls
def _opnorms(A, iters: int = 30):
    """Batched power iteration for ||A_i||_2 (B, m, n) -> (B,)."""
    B, m, n = A.shape
    v = jnp.ones((B, n), A.dtype) / jnp.sqrt(jnp.asarray(n, A.dtype))

    def body(_, v):
        w = jnp.einsum("bmn,bn->bm", A, v)
        z = jnp.einsum("bmn,bm->bn", A, w)
        return z / (jnp.linalg.norm(z, axis=1, keepdims=True) + 1e-30)

    v = jax.lax.fori_loop(0, iters, body, v)
    w = jnp.einsum("bmn,bn->bm", A, v)
    return jnp.linalg.norm(w, axis=1) + 1e-12


@partial(jax.jit, static_argnames=("iters",))
@full_precision_matmuls
def _pdhg_fixed_batched(A, b, c, l, u, opnorm, x0, y0, iters: int):
    """Vmapped fixed-iteration adaptive PDHG (equality rows)."""

    def solve_one(A, b, c, l, u, opnorm, x0, y0):
        def body(k, carry):
            x, y, Ax, xs, ys, wsum, eta = carry
            x_c = jnp.clip(x - eta * (c - A.T @ y), l, u)
            Ax_c = A @ x_c
            y_c = y + eta * (b - (2.0 * Ax_c - Ax))
            dx = x_c - x
            dy = y_c - y
            curv = jnp.abs(dy @ (Ax_c - Ax))
            nz = dx @ dx + dy @ dy
            eta_bar = jnp.where(curv > 0, nz / (2.0 * curv), 1e10 / opnorm)
            accept = eta <= eta_bar
            # PDLP schedule index is k+2 for 0-based k
            k1 = (k + 2).astype(eta.dtype)
            logk1 = jnp.log(k1)
            eta_next = jnp.minimum(
                (1.0 - jnp.exp(-0.3 * logk1)) * eta_bar,
                (1.0 + jnp.exp(-0.6 * logk1)) * eta)
            eta_next = jnp.clip(eta_next, 1e-10 / opnorm, 1e10 / opnorm)
            x = jnp.where(accept, x_c, x)
            y = jnp.where(accept, y_c, y)
            Ax = jnp.where(accept, Ax_c, Ax)
            w = jnp.where(accept, eta, 0.0)
            return (x, y, Ax, xs + w * x, ys + w * y, wsum + w, eta_next)

        eta0 = 0.9 / opnorm
        init = (x0, y0, A @ x0, jnp.zeros_like(x0), jnp.zeros_like(y0),
                jnp.zeros_like(eta0), eta0)
        x, y, _, xs, ys, wsum, _ = jax.lax.fori_loop(0, iters, body, init)
        safe = jnp.where(wsum > 0, wsum, 1.0)
        return x, y, xs / safe, ys / safe

    return jax.vmap(solve_one)(A, b, c, l, u, opnorm, x0, y0)


def pdhg_dense_batched(A, b, c, l, u, iters: int = 2000):
    """Fleet PDHG warm starts: (B, m, n) equality-form LPs.

    Returns dict with x, y (last iterates), x_avg, y_avg (step-weighted
    averages, usually the better warm start), all (B, .) arrays.
    """
    A = jnp.asarray(A)
    B, m, n = A.shape
    dt = A.dtype
    b = jnp.asarray(b, dt)
    c = jnp.asarray(c, dt)
    l = jnp.asarray(l, dt)
    u = jnp.asarray(u, dt)
    opnorm = _opnorms(A)

    x0 = jnp.clip(jnp.zeros_like(c), l, u)
    y0 = jnp.zeros_like(b)
    x, y, xa, ya = _pdhg_fixed_batched(A, b, c, l, u, opnorm, x0, y0, iters)
    return {"x": x, "y": y, "x_avg": xa, "y_avg": ya,
            "opnorm": np.asarray(opnorm)}
