"""Null-space projection kernels:  v  ->  (I - Y'(YY')^+ Y) v.

The reference computes this two ways: scipy CG (apply_projector,
lp_methods/algorithms.py:183-187) and a Gurobi least-squares QP with loose
tolerance (apply_projector_qp, :240-265) — the one hard Gurobi dependency of
its perturbation path.  Here both become in-house Krylov solves:

* a host scipy path (CG / MINRES for the free-column KKT variant) used by the
  perturbation crossover on sparse LP data;
* a JAX path (jax.scipy CG, jittable) that is the framework's
  distributed projection kernel — the mesh-sharded version lives in
  smart_crossover_tpu.parallel.projector.
"""
from __future__ import annotations

import numpy as np
import scipy.sparse as sp
import scipy.sparse.linalg as spla

import jax
import jax.numpy as jnp

from smart_crossover_tpu.utils.threads import single_thread_blas as \
    _single_thread_blas


# --------------------------------------------------------------------------
# host (scipy) path
# --------------------------------------------------------------------------
# Both Krylov projectors run under a 1-thread BLAS limit: each CG/MINRES
# iteration is a couple of sparse matvecs (scipy, unthreaded) plus thin
# BLAS1 ddots/axpys where threaded OpenBLAS pays its pool sync per call —
# ~12 ms vs ~7 us per 100k ddot measured on a 4-core host, i.e. tens of
# seconds over a 1000-iteration solve.
@_single_thread_blas
def apply_projector(Y, v, tol: float = 1e-8, max_iter: int = 1000) -> np.ndarray:
    """Project v onto the null space of Y via CG on YY' (host, sparse)."""
    Y = sp.csr_matrix(Y)
    v = np.asarray(v, dtype=np.float64)
    Yv = Y @ v
    m = Y.shape[0]

    def mv(z):
        return Y @ (Y.T @ z)

    op = spla.LinearOperator((m, m), matvec=mv, dtype=np.float64)
    z, _ = spla.cg(op, Yv, rtol=tol, maxiter=max_iter)
    return v - Y.T @ z


@_single_thread_blas
def apply_projector_with_free(Y, v, A_f, tol: float = 1e-6,
                              max_iter: int = 2000) -> np.ndarray:
    """Least-squares projection with unpenalised free columns.

    Solves  min ||x - v||^2  s.t.  Y x + A_f f = 0  (f unconstrained), the
    same problem the reference poses to Gurobi's QP barrier
    (lp_methods/algorithms.py:240-265).  KKT elimination gives the symmetric
    system  [[YY', A_f], [A_f', 0]] [lam; g] = [Yv; 0]  solved matrix-free
    with MINRES; then  x = v - Y' lam.
    """
    Y = sp.csr_matrix(Y)
    A_f = sp.csr_matrix(A_f)
    v = np.asarray(v, dtype=np.float64)
    m = Y.shape[0]
    k = A_f.shape[1]

    def mv(w):
        lam, g = w[:m], w[m:]
        top = Y @ (Y.T @ lam) + A_f @ g
        bot = A_f.T @ lam
        return np.concatenate([top, bot])

    op = spla.LinearOperator((m + k, m + k), matvec=mv, dtype=np.float64)
    rhs = np.concatenate([Y @ v, np.zeros(k)])
    w, _ = spla.minres(op, rhs, rtol=tol, maxiter=max_iter)
    return v - Y.T @ w[:m]


# --------------------------------------------------------------------------
# JAX path (jittable; used by the device projection benchmarks and any dense
# problem that lives on device)
# --------------------------------------------------------------------------
def apply_projector_jax(Y, v, tol: float = 1e-8, max_iter: int = 1000):
    """Device projection of v onto null(Y) for dense Y (jit-compatible)."""
    Y = jnp.asarray(Y)
    v = jnp.asarray(v)
    Yv = Y @ v

    def mv(z):
        return Y @ (Y.T @ z)

    z, _ = jax.scipy.sparse.linalg.cg(mv, Yv, tol=tol, maxiter=max_iter)
    return v - Y.T @ z


def projector_residual(Y, x) -> float:
    """||Y x|| — how far x is from the null space (certificate helper)."""
    Y = sp.csr_matrix(Y)
    return float(np.linalg.norm(Y @ np.asarray(x)))
