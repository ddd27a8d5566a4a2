"""Batched device PDHG (fleet warm-start engine) tests.

Oracle: scipy HiGHS per instance.
"""
import numpy as np
import pytest
from scipy.optimize import linprog

from smart_crossover_tpu.parallel.batched_lp import batched_lp_crossover
from smart_crossover_tpu.solvers.pdhg_batched import pdhg_dense_batched


def make_fleet(rng, B=4, m=12, n=64):
    A = rng.standard_normal((B, m, n))
    b = np.einsum("bmn,bn->bm", A, rng.uniform(0.1, 0.9, (B, n)))
    c = rng.standard_normal((B, n))
    return A, b, c, np.zeros((B, n)), np.ones((B, n))


def test_batched_pdhg_warm_start_quality(rng):
    B, m, n = 6, 12, 64
    A, b, c, l, u = make_fleet(rng, B, m, n)
    r = pdhg_dense_batched(A, b, c, l, u, iters=6000)
    xa = np.asarray(r["x_avg"])
    for i in range(B):
        ref = linprog(c[i], A_eq=A[i], b_eq=b[i], bounds=[(0, 1)] * n,
                      method="highs")
        assert ref.status == 0
        feas = np.linalg.norm(A[i] @ xa[i] - b[i]) / (1 + np.linalg.norm(b[i]))
        gap = abs(c[i] @ xa[i] - ref.fun) / (1 + abs(ref.fun))
        # the corrected schedule gives real weight to the earliest
        # iterates (the buggy floor-eta prefix used to exclude them from
        # the ergodic average), so the fixed-horizon average is a hair
        # looser; 2e-4 still certifies a good warm start
        assert feas < 2e-4, (i, feas)
        assert gap < 1e-3, (i, gap)


def test_fleet_crossover_pdhg_engine_exact(rng):
    B, m, n = 4, 10, 40
    A, b, c, l, u = make_fleet(rng, B, m, n)
    out = batched_lp_crossover(A, b, c, l, u, warm_engine="pdhg",
                               pdhg_iters=4000)
    assert out["optimal"].all()
    for i in range(B):
        ref = linprog(c[i], A_eq=A[i], b_eq=b[i], bounds=[(0, 1)] * n,
                      method="highs")
        assert out["obj"][i] == pytest.approx(ref.fun, abs=1e-8)
