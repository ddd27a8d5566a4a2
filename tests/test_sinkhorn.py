import numpy as np
import pytest

from smart_crossover_tpu.solvers.sinkhorn import (
    plan_from_potentials,
    round_to_feasible,
    sinkhorn,
    sinkhorn_plan,
    sinkhorn_potentials,
)
from tests.conftest import random_ot


def test_sinkhorn_marginals(rng):
    ot = random_ot(rng, 10, 12)
    eps = 0.05 * ot.M.max()
    X = np.asarray(sinkhorn_plan(ot.s, ot.d, ot.M, eps, num_iters=500))
    np.testing.assert_allclose(X.sum(axis=1), ot.s, atol=1e-8)
    np.testing.assert_allclose(X.sum(axis=0), ot.d, atol=1e-8)
    assert np.all(X >= 0)


def test_sinkhorn_unrounded_marginals_converge(rng):
    ot = random_ot(rng, 8, 8)
    eps = 0.1 * ot.M.max()
    f, g = sinkhorn_potentials(ot.s, ot.d, ot.M, eps, num_iters=2000)
    X = np.asarray(plan_from_potentials(f, g, ot.M, eps))
    np.testing.assert_allclose(X.sum(axis=0), ot.d, atol=1e-10)  # last update
    np.testing.assert_allclose(X.sum(axis=1), ot.s, atol=1e-4)


def test_sinkhorn_near_optimal_cost(rng):
    # With small reg the entropic cost approaches the LP optimum.
    from scipy.optimize import linprog

    ot = random_ot(rng, 6, 7)
    mcf = ot.to_MCF()
    res = linprog(mcf.c, A_eq=mcf.A.toarray(), b_eq=mcf.b,
                  bounds=[(0, None)] * mcf.n, method="highs")
    assert res.status == 0
    x = sinkhorn(ot, reg=0.004, num_iters=4000)
    ours = float(mcf.c @ x)
    assert ours <= res.fun + 0.05 * (abs(res.fun) + 1)


def test_round_to_feasible_exact(rng):
    ot = random_ot(rng, 5, 5)
    X = rng.uniform(0.0, 1.0, (5, 5))
    Xr = np.asarray(round_to_feasible(X, ot.s, ot.d))
    np.testing.assert_allclose(Xr.sum(axis=1), ot.s, atol=1e-12)
    np.testing.assert_allclose(Xr.sum(axis=0), ot.d, atol=1e-12)
    assert np.all(Xr >= -1e-15)


def test_sinkhorn_tolerance_stopped(rng):
    from smart_crossover_tpu.solvers.sinkhorn import sinkhorn_potentials_tol

    ot = random_ot(rng, 9, 11)
    eps = 0.05 * ot.M.max()
    f, g, iters = sinkhorn_potentials_tol(ot.s, ot.d, ot.M, eps, tol=1e-8,
                                          max_iters=5000)
    X = np.asarray(plan_from_potentials(f, g, ot.M, eps))
    assert np.abs(X.sum(axis=1) - ot.s).sum() < 1e-7
    assert 0 < int(iters) < 5000


def test_sinkhorn_annealed(rng):
    from smart_crossover_tpu.solvers.sinkhorn import (
        sinkhorn_potentials_annealed,
    )

    ot = random_ot(rng, 12, 14)
    eps = 0.01 * ot.M.max()
    f, g = sinkhorn_potentials_annealed(ot.s, ot.d, ot.M, eps,
                                        num_iters=400, stages=4)
    X = np.asarray(plan_from_potentials(f, g, ot.M, eps))
    # column marginals exact after final g-update; rows near
    np.testing.assert_allclose(X.sum(axis=0), ot.d, atol=1e-8)
    assert np.abs(X.sum(axis=1) - ot.s).sum() < 0.05


def _numpy_log_sinkhorn(s, d, M, eps, iters):
    """The host reference loop of bench.cpu_reference_pipeline."""
    f = np.zeros(M.shape[0])
    g = np.zeros(M.shape[1])
    for _ in range(iters):
        t = (g[None, :] - M) / eps
        f = eps * (np.log(s) - (t.max(1) + np.log(
            np.exp(t - t.max(1)[:, None]).sum(1))))
        t2 = (f[:, None] - M) / eps
        g = eps * (np.log(d) - (t2.max(0) + np.log(
            np.exp(t2 - t2.max(0)[None, :]).sum(0))))
    return f, g


@pytest.mark.parametrize("B,S,D,eps,iters",
                         [(3, 16, 16, 0.5, 100), (2, 8, 24, 0.3, 800)])
def test_batched_sinkhorn_matches_numpy_reference(rng, B, S, D, eps, iters):
    """The vmapped XLA Sinkhorn (the batched pipeline's warm start) against
    the numpy log-domain loop, per instance."""
    import jax

    s = rng.uniform(0.5, 2.0, (B, S))
    d = rng.uniform(0.5, 2.0, (B, D))
    d *= (s.sum(axis=1) / d.sum(axis=1))[:, None]
    M = rng.uniform(0.0, 5.0, (B, S, D))
    f, g = jax.vmap(lambda a, b, c: sinkhorn_potentials(
        a, b, c, eps, num_iters=iters))(s, d, M)
    for i in range(B):
        fr, gr = _numpy_log_sinkhorn(s[i], d[i], M[i], eps, iters)
        np.testing.assert_allclose(np.asarray(f[i]), fr, rtol=1e-10,
                                   atol=1e-10)
        np.testing.assert_allclose(np.asarray(g[i]), gr, rtol=1e-10,
                                   atol=1e-10)
