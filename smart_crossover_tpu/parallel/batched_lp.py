"""Batched general-LP crossover: a fleet of small dense LPs.

Device does the barrier work (vmapped Mehrotra IPM — batched normal-equations
Cholesky on the device, solvers/ipm_batched.py); the host then crosses each
instance over to an exact vertex with the warm-started revised simplex,
threaded across cores.  No reference analog (it is single-instance,
single-solver).

Note on precision: with x64 enabled (CPU) the default tol=1e-8 converges in
8-15 IPM iterations.  On an f32 device loosen tol to ~1e-5 and lower
max_ipm_iters — the host simplex cleanup restores exactness either way.
"""
from __future__ import annotations

import concurrent.futures as cf
import os

import numpy as np

from smart_crossover_tpu.solvers.ipm_batched import ipm_dense_batched
from smart_crossover_tpu.solvers.simplex import primal_simplex
from smart_crossover_tpu.solvers.solving import _crossover_statuses


def batched_lp_crossover(A, b, c, l, u, tol: float = 1e-8,
                         max_ipm_iters: int = 60,
                         warm_engine: str = "ipm",
                         pdhg_iters: int = 4000):
    """Solve a batch of dense equality-form LPs to exact optimal vertices.

    Args:
        A: (B, m, n) dense equality constraints; b: (B, m);
        c, l, u: (B, n) (finite/infinite bounds allowed).
        warm_engine: 'ipm' (vmapped Mehrotra, O(m^3)/iter/instance),
            'ipm_refined' (same device stage + host f64 Mehrotra endgame
            per instance, solvers/ipm_fleet.py — the sharpest warm start;
            use for f32 backends where the raw device iterate sits at
            ~1e-5), or 'pdhg' (batched first-order, two matvecs/iter —
            the cheaper engine for wide fleets).

    Returns:
        dict with x (B, n) vertex solutions, obj (B,), pivots (B,),
        optimal (B,) bool, x_bar (B, n) interior points.
    """
    A = np.asarray(A, dtype=np.float64)
    B, m, n = A.shape
    b = np.asarray(b, dtype=np.float64)
    c = np.asarray(c, dtype=np.float64)
    l = np.asarray(l, dtype=np.float64)
    u = np.asarray(u, dtype=np.float64)

    if warm_engine == "pdhg":
        from smart_crossover_tpu.solvers.pdhg_batched import (
            pdhg_dense_batched)

        dev = pdhg_dense_batched(A, b, c, l, u, iters=pdhg_iters)
        x_bar = np.asarray(dev["x_avg"], dtype=np.float64)
        # a first-order point is always a usable crossover seed
        converged = np.ones(B, dtype=bool)
    elif warm_engine == "ipm_refined":
        from smart_crossover_tpu.solvers.ipm_fleet import ipm_fleet

        fleet = ipm_fleet(A, b, c, l, u, tol=tol,
                          max_device_iters=max_ipm_iters)
        x_bar = fleet.x
        converged = np.array([s == "OPTIMAL" for s in fleet.status])
    else:
        dev = ipm_dense_batched(A, b, c, l, u, tol=tol,
                                max_iters=max_ipm_iters)
        x_bar = np.asarray(dev["x"], dtype=np.float64)
        converged = np.asarray(dev["converged"])

    x_out = np.empty((B, n))
    obj = np.empty(B)
    pivots = np.zeros(B, dtype=np.int64)
    optimal = np.zeros(B, dtype=bool)

    def one(i: int) -> None:
        vst = None
        if converged[i]:
            vst = _crossover_statuses(x_bar[i], l[i], u[i])
        res = primal_simplex(A[i], b[i], c[i], l[i], u[i], vstatus=vst)
        x_out[i] = res.x
        obj[i] = res.obj_val
        pivots[i] = res.iter_count
        optimal[i] = res.status == "OPTIMAL"

    workers = min(max(os.cpu_count() or 1, 1), 8)
    if workers > 1 and B > 1:
        with cf.ThreadPoolExecutor(max_workers=workers) as pool:
            list(pool.map(one, range(B)))
    else:
        for i in range(B):
            one(i)
    return {"x": x_out, "obj": obj, "pivots": pivots, "optimal": optimal,
            "x_bar": x_bar, "ipm_converged": converged}
