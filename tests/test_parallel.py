import numpy as np
import jax
import jax.numpy as jnp
import pytest

from smart_crossover_tpu.parallel import (
    batched_tnet,
    make_mesh,
    sharded_batched_tnet,
    sharded_projector,
    sharded_sinkhorn_plan,
)
from smart_crossover_tpu.solvers.projection import apply_projector_jax
from tests.conftest import random_ot


def make_batch(rng, B=4, S=12, D=16):
    s = rng.uniform(0.5, 2.0, (B, S))
    d = rng.uniform(0.5, 2.0, (B, D))
    d *= (s.sum(axis=1) / d.sum(axis=1))[:, None]
    M = rng.uniform(0.0, 5.0, (B, S, D))
    return s, d, M


def test_batched_tnet_feasible_vertices(rng):
    s, d, M = make_batch(rng)
    X, iters, obj = batched_tnet(s, d, M, reg=0.05, sinkhorn_iters=200)
    X = np.asarray(X)
    np.testing.assert_allclose(X.sum(axis=2), s, atol=1e-7)
    np.testing.assert_allclose(X.sum(axis=1), d, atol=1e-7)
    assert np.all(X >= -1e-9)
    # vertex support: at most S + D - 1 nonzeros per instance
    for b in range(X.shape[0]):
        assert (X[b] > 1e-10).sum() <= 12 + 16 - 1
    # objective sane: between LP optimum and a crude upper bound
    np.testing.assert_allclose(np.asarray(obj),
                               (X * M).sum(axis=(1, 2)), rtol=1e-10)


def test_sharded_batched_tnet_matches_unsharded(rng):
    assert jax.device_count() >= 8, "conftest should provide 8 cpu devices"
    s, d, M = make_batch(rng, B=8)
    mesh = make_mesh(n_batch=8, n_model=1)
    Xs, iters_s, obj_s = sharded_batched_tnet(mesh, s, d, M, reg=0.05,
                                              sinkhorn_iters=100)
    Xu, iters_u, obj_u = batched_tnet(s, d, M, reg=0.05, sinkhorn_iters=100)
    np.testing.assert_allclose(np.asarray(obj_s), np.asarray(obj_u),
                               rtol=1e-9)
    np.testing.assert_allclose(np.asarray(Xs), np.asarray(Xu), atol=1e-9)


def test_sharded_projector_matches_single_device(rng):
    mesh = make_mesh(n_batch=1, n_model=8)
    m, n = 24, 64
    Y = rng.standard_normal((m, n))
    v = rng.standard_normal(n)
    got = np.asarray(sharded_projector(mesh, Y, v))
    want = np.asarray(apply_projector_jax(Y, v))
    np.testing.assert_allclose(got, want, atol=1e-7)
    # result is in the null space of Y
    assert np.linalg.norm(Y @ got) < 1e-7 * (1 + np.linalg.norm(got))


def test_sharded_sinkhorn_matches_reference(rng):
    from smart_crossover_tpu.solvers.sinkhorn import (
        plan_from_potentials,
        sinkhorn_potentials,
    )

    mesh = make_mesh(n_batch=1, n_model=8)
    ot = random_ot(rng, 10, 16)
    eps = 0.05 * ot.M.max()
    Xs = np.asarray(sharded_sinkhorn_plan(mesh, ot.s, ot.d, ot.M, eps,
                                          num_iters=300))
    f, g = sinkhorn_potentials(ot.s, ot.d, ot.M, eps, num_iters=300)
    Xr = np.asarray(plan_from_potentials(f, g, ot.M, eps))
    np.testing.assert_allclose(Xs, Xr, atol=1e-9)


def test_batched_tnet_exact_matches_highs(rng):
    from scipy.optimize import linprog

    from smart_crossover_tpu.models import OptTransport
    from smart_crossover_tpu.parallel.batched import batched_tnet_exact

    s, d, M = make_batch(rng, B=3, S=10, D=12)
    X, obj, piv, opt = batched_tnet_exact(s, d, M, reg=0.01,
                                          sinkhorn_iters=500)
    assert opt.all()
    for i in range(3):
        si = np.asarray(s[i], dtype=np.float64)
        di = np.asarray(d[i], dtype=np.float64)
        di *= si.sum() / di.sum()
        mcf = OptTransport(s=si, d=di, M=np.asarray(M[i], np.float64)).to_MCF()
        ref = linprog(mcf.c, A_eq=mcf.A.toarray(), b_eq=mcf.b,
                      bounds=[(0, None)] * mcf.n, method="highs")
        assert abs(obj[i] - ref.fun) < 1e-8
        # exact conservation
        np.testing.assert_allclose(X[i].sum(axis=1), si, atol=1e-9)


def test_sharded_pdhg_matches_highs(rng):
    from scipy.optimize import linprog

    from smart_crossover_tpu.parallel.pdhg_sharded import sharded_pdhg

    mesh = make_mesh(n_batch=1, n_model=8)
    m, n = 12, 64
    A = rng.standard_normal((m, n))
    b = A @ rng.uniform(0.2, 0.8, n)
    c = rng.standard_normal(n)
    x, y = sharded_pdhg(mesh, A, b, c, np.zeros(n), np.ones(n),
                        num_iters=40_000, restart_period=200)
    ref = linprog(c, A_eq=A, b_eq=b, bounds=[(0, 1)] * n, method="highs")
    assert ref.status == 0
    assert abs(c @ x - ref.fun) < 2e-3 * (1 + abs(ref.fun))
    assert np.linalg.norm(A @ x - b) < 1e-3 * (1 + np.linalg.norm(b))


def test_sharded_mcf_ranking_matches_single_device(rng):
    from smart_crossover_tpu.ops.ranking import mcf_flow_indicators
    from smart_crossover_tpu.parallel.ranking_sharded import (
        sharded_mcf_flow_indicators,
    )

    mesh = make_mesh(n_batch=1, n_model=8)
    m = 40
    n = 8 * 64
    tails = rng.integers(0, m, n)
    heads = (tails + rng.integers(1, m, n)) % m
    u = rng.uniform(0.5, 3.0, n)
    x = rng.uniform(-0.2, 3.5, n)
    got = np.asarray(sharded_mcf_flow_indicators(
        mesh, x, tails, heads, u, m))
    want = np.asarray(mcf_flow_indicators(x, tails, heads, u, m))
    np.testing.assert_allclose(got, want, atol=1e-9)


def test_batched_lp_crossover_fleet(rng):
    from scipy.optimize import linprog

    from smart_crossover_tpu.parallel.batched_lp import batched_lp_crossover

    B, m, n = 6, 8, 20
    As = rng.standard_normal((B, m, n))
    xs = rng.uniform(0.2, 0.8, (B, n))
    bs = np.einsum("bmn,bn->bm", As, xs)
    cs = rng.standard_normal((B, n))
    ls = np.zeros((B, n))
    us = np.ones((B, n))
    out = batched_lp_crossover(As, bs, cs, ls, us)
    assert out["optimal"].all()
    for i in range(B):
        ref = linprog(cs[i], A_eq=As[i], b_eq=bs[i], bounds=[(0, 1)] * n,
                      method="highs")
        assert abs(out["obj"][i] - ref.fun) < 1e-7
        # the warm start from the device interior point keeps pivots low
    assert out["ipm_converged"].all()


def test_sharded_tnet_single_instance(rng):
    from scipy.optimize import linprog

    from smart_crossover_tpu.parallel.tnet_sharded import sharded_tnet_single

    mesh = make_mesh(n_batch=1, n_model=8)
    for seed in (0, 3):
        ot = random_ot(np.random.default_rng(seed), 10, 16)
        X, push_n = sharded_tnet_single(mesh, ot.s, ot.d, ot.M, reg=0.02,
                                        sinkhorn_iters=300)
        # feasible vertex of the full instance
        np.testing.assert_allclose(X.sum(1), ot.s, atol=1e-8)
        np.testing.assert_allclose(X.sum(0), ot.d, atol=1e-8)
        assert X.min() >= -1e-10
        assert (X > 1e-10).sum() <= 10 + 16 - 1
        # objective sane: within a few % of the LP optimum (exactness comes
        # from the downstream simplex; the identification is near-optimal)
        mcf = ot.to_MCF()
        ref = linprog(mcf.c, A_eq=mcf.A.toarray(), b_eq=mcf.b,
                      bounds=[(0, None)] * mcf.n, method="highs")
        assert (X * ot.M).sum() <= ref.fun * 1.10 + 1e-9


def test_mcf_scenario_sweep_warm_chain(rng):
    from scipy.optimize import linprog

    from smart_crossover_tpu.data.mcf_gen import transshipment_mcf
    from smart_crossover_tpu.parallel.scenarios import mcf_scenario_sweep

    mcf = transshipment_mcf(m=60, seed=2)
    K = 6
    # smoothly drifting demand scenarios (balanced)
    bs = np.stack([mcf.b * (1.0 + 0.02 * k) for k in range(K)])
    warm = mcf_scenario_sweep(mcf, b_scenarios=bs, warm_chain=True)
    cold = mcf_scenario_sweep(mcf, b_scenarios=bs, warm_chain=False)
    assert all(s == "OPTIMAL" for s in warm["status"])
    np.testing.assert_allclose(warm["obj"], cold["obj"], rtol=1e-9)
    # chained warm starts do far less work after the first scenario
    assert warm["pivots"][1:].sum() < 0.5 * cold["pivots"][1:].sum()
    # spot-check one scenario vs HiGHS
    inst_b = bs[3]
    ref = linprog(mcf.c, A_eq=mcf.A.toarray(), b_eq=inst_b,
                  bounds=[(0, ub) for ub in mcf.u], method="highs")
    assert ref.status == 0
    assert abs(warm["obj"][3] - ref.fun) < 1e-7


def test_tnet_reduced_cost_tree_weights(rng):
    s, d, M = make_batch(rng, B=3, S=12, D=12)
    X, piv, obj = batched_tnet(s, d, M, reg=0.02, sinkhorn_iters=300,
                               tree_weights="reduced_cost")
    X = np.asarray(X)
    np.testing.assert_allclose(X.sum(axis=2), s, atol=1e-7)
    np.testing.assert_allclose(X.sum(axis=1), d, atol=1e-7)
    assert np.all(X >= -1e-9)


def test_sharded_tnet_width_equivalence(rng):
    from smart_crossover_tpu.parallel.tnet_sharded import sharded_tnet_single

    ot = random_ot(rng, 8, 16)
    results = {}
    import jax

    for w in (1, 2, 4):
        mesh = make_mesh(n_batch=1, n_model=w, devices=jax.devices()[:w])
        X, push_n = sharded_tnet_single(mesh, ot.s, ot.d, ot.M, reg=0.05,
                                        sinkhorn_iters=200)
        results[w] = ((X * ot.M).sum(), X)
    # identical pipeline, different mesh widths: objectives agree closely
    base = results[1][0]
    for w in (2, 4):
        assert abs(results[w][0] - base) < 1e-6 * (1 + abs(base))


def test_batched_tnet_exact_device_engine_matches_host(rng):
    """engine='device' (one-hot simplex, whole solve on device) must reach
    the same exact optima as the host-cleanup path."""
    import numpy as np

    from smart_crossover_tpu.parallel.batched import batched_tnet_exact

    B, S, D = 3, 10, 14
    s = rng.uniform(0.5, 2, (B, S))
    d = rng.uniform(0.5, 2, (B, D))
    d *= (s.sum(1) / d.sum(1))[:, None]
    M = rng.uniform(0, 5, (B, S, D))
    Xh, oh, _, opth = batched_tnet_exact(s, d, M, engine="host")
    Xd, od, _, optd = batched_tnet_exact(s, d, M, engine="device")
    assert opth.all() and optd.all()
    np.testing.assert_allclose(od, oh, rtol=1e-9)


def test_sharded_exact_device_simplex_certified(rng):
    """Batch-sharded exact parent-array simplex over an 8-device mesh:
    every instance optimal on device and the returned bases certify
    against the independent host f64 recomputation."""
    from smart_crossover_tpu.network_methods.certify import (
        certify_ot_basis_batch,
    )
    from smart_crossover_tpu.parallel import (
        sharded_batched_tnet_exact_device,
    )

    mesh = make_mesh(n_batch=len(jax.devices()), n_model=1)
    B = 2 * len(jax.devices())
    s, d, M = make_batch(rng, B=B, S=10, D=12)
    X, obj, push, piv, opt, Bm = sharded_batched_tnet_exact_device(
        mesh, s, d, M, reg=0.01, sinkhorn_iters=300, max_pivots=500)
    assert bool(np.all(np.asarray(opt)))
    certs = certify_ot_basis_batch(np.asarray(Bm), s, d, M)
    assert all(c.ok for c in certs), [c.reason for c in certs]
    # sharded run reaches the same optima as the unsharded host path
    from smart_crossover_tpu.parallel import batched_tnet_exact
    Xh, oh, _, opth = batched_tnet_exact(s, d, M, engine="host")
    assert opth.all()
    np.testing.assert_allclose(
        np.array([c.obj_val for c in certs]), oh, rtol=1e-9)


@pytest.mark.parametrize("S,D,accelerator,sharded,want", [
    (256, 256, True, False, "packed"),
    (784, 784, True, False, "packed"),
    (16, 1024, True, False, "packed"),
    (1025, 64, True, False, "host"),
    (256, 256, True, True, "host"),
    (256, 256, False, False, "host"),
])
def test_auto_engine_routing_table(S, D, accelerator, sharded, want):
    from smart_crossover_tpu.parallel.batched import auto_engine

    mesh = object() if sharded else None
    assert auto_engine(S, D, mesh=mesh, accelerator=accelerator) == want


def test_auto_engine_on_this_backend_is_host():
    from smart_crossover_tpu.parallel.batched import auto_engine

    assert auto_engine(256, 256) == "host"


def test_device_step_batch_matches_single_instances(rng):
    """The whole-batch vmap gives each instance the result it gets alone."""
    from smart_crossover_tpu.parallel.batched import (
        batched_tnet_exact_device,
    )

    s, d, M = make_batch(rng, B=3, S=9, D=11)
    out = batched_tnet_exact_device(s, d, M, reg=0.01, sinkhorn_iters=200,
                                    max_pivots=500)
    for i in range(3):
        one = batched_tnet_exact_device(s[i:i + 1], d[i:i + 1], M[i:i + 1],
                                        reg=0.01, sinkhorn_iters=200,
                                        max_pivots=500)
        np.testing.assert_array_equal(np.asarray(one[5])[0],
                                      np.asarray(out[5])[i])
        np.testing.assert_allclose(np.asarray(one[1])[0],
                                   np.asarray(out[1])[i], rtol=1e-12)
