"""Tests that need the card.

Each carries the ``gpu`` marker and takes the ``gpu_device`` fixture, which
skips where JAX finds no GPU.  They run on the card as phase 2 of
``python chip_smoke.py`` (``JAX_PLATFORMS=cuda pytest -m gpu``), with x64
enabled by conftest, so each compares the compiled GPU code with a host
reference at the tolerance of the dtype it runs in.
"""
import numpy as np
import pytest

pytestmark = pytest.mark.gpu


def _ot_batch(rng, B, S, D):
    s = rng.uniform(0.5, 2.0, (B, S))
    d = rng.uniform(0.5, 2.0, (B, D))
    d *= (s.sum(axis=1) / d.sum(axis=1))[:, None]
    M = rng.uniform(0.0, 5.0, (B, S, D))
    return s, d, M


def test_default_device_is_the_card(gpu_device):
    import jax

    assert jax.default_backend() == "gpu"
    assert gpu_device.memory_stats()["bytes_limit"] > 0


def test_full_precision_matmuls_keep_float32_digits(gpu_device, rng):
    """A float32 product under full_precision_matmuls agrees with the f64
    product to float32 accuracy; TF32 would leave ~1e-3 relative error."""
    import jax
    import jax.numpy as jnp

    from smart_crossover_tpu.config import full_precision_matmuls

    A = rng.standard_normal((512, 2048)).astype(np.float32)
    x = rng.standard_normal(2048).astype(np.float32)
    mv = jax.jit(full_precision_matmuls(lambda a, v: a @ v))
    got = np.asarray(mv(jnp.asarray(A), jnp.asarray(x)), dtype=np.float64)
    want = A.astype(np.float64) @ x.astype(np.float64)
    rel = np.abs(got - want).max() / np.abs(want).max()
    assert rel < 1e-5, rel


def test_sinkhorn_matches_numpy_reference_on_card(gpu_device, rng):
    from smart_crossover_tpu.solvers.sinkhorn import sinkhorn_potentials

    s, d, M = _ot_batch(rng, 1, 64, 96)
    s, d, M = s[0], d[0], M[0]
    eps, iters = 0.05 * M.max(), 200
    f, g = sinkhorn_potentials(s, d, M, eps, num_iters=iters)
    fr = np.zeros(64)
    gr = np.zeros(96)
    for _ in range(iters):
        t = (gr[None, :] - M) / eps
        fr = eps * (np.log(s) - (t.max(1) + np.log(
            np.exp(t - t.max(1)[:, None]).sum(1))))
        t2 = (fr[:, None] - M) / eps
        gr = eps * (np.log(d) - (t2.max(0) + np.log(
            np.exp(t2 - t2.max(0)[None, :]).sum(0))))
    np.testing.assert_allclose(np.asarray(f), fr, rtol=1e-9, atol=1e-9)
    np.testing.assert_allclose(np.asarray(g), gr, rtol=1e-9, atol=1e-9)


@pytest.mark.parametrize("engine", ["parent", "anc", "packed"])
def test_device_pivot_engine_certifies_on_card(gpu_device, rng, engine):
    from smart_crossover_tpu.network_methods.certify import (
        certify_ot_basis_batch,
    )
    from smart_crossover_tpu.parallel.batched import (
        batched_tnet_exact,
        batched_tnet_exact_device,
    )

    s, d, M = _ot_batch(rng, 4, 24, 32)
    out = batched_tnet_exact_device(s, d, M, reg=0.01, sinkhorn_iters=300,
                                    max_pivots=2000, engine=engine)
    assert bool(np.all(np.asarray(out[4])))
    certs = certify_ot_basis_batch(np.asarray(out[5]), s, d, M)
    assert all(c.ok for c in certs), [c.reason for c in certs]
    _, obj_host, _, ok = batched_tnet_exact(s, d, M, engine="host")
    assert ok.all()
    np.testing.assert_allclose([c.obj_val for c in certs], obj_host,
                               rtol=1e-9)


@pytest.mark.parametrize("mode", ["adaptive", "halpern"])
def test_pdhg_matches_highs_on_card(gpu_device, rng, mode):
    from scipy.optimize import linprog

    from smart_crossover_tpu.solvers.pdhg import pdhg_solve

    m, n = 24, 96
    A = rng.standard_normal((m, n)) / np.sqrt(m)
    b = A @ rng.uniform(0.2, 0.8, n)
    c = A.T @ rng.standard_normal(m) + np.abs(rng.standard_normal(n)) + 0.05
    ref = linprog(c, A_eq=A, b_eq=b, bounds=[(0, 2)] * n, method="highs")
    res = pdhg_solve(A, b, c, np.zeros(n), np.full(n, 2.0), tol=1e-8,
                     max_iters=40_000, mode=mode)
    assert res.status == "OPTIMAL"
    assert abs(res.obj_val - ref.fun) <= 1e-6 * (1 + abs(ref.fun))


def test_ipm_big_device_f64_endgame_on_card(gpu_device, rng, monkeypatch):
    """The direct-f64 device normal equations, the GPU default for large
    ipm_big solves, forced on here at a small size.  The device stage runs
    in f32 (x64 off) so that the f64 endgame has work left to do."""
    import jax
    from scipy.optimize import linprog

    from smart_crossover_tpu.solvers import ipm_fleet

    monkeypatch.setenv("SCX_DEVICE_ENDGAME", "1")
    m, n = 60, 200
    A = rng.standard_normal((m, n)) / np.sqrt(n)
    b = A @ rng.uniform(0.2, 0.8, n)
    c = A.T @ rng.standard_normal(m) + np.abs(rng.standard_normal(n)) * 0.1
    with jax.enable_x64(False):
        res = ipm_fleet.ipm_big(A, b, c, np.zeros(n), np.ones(n), tol=1e-8)
    ref = linprog(c, A_eq=A, b_eq=b, bounds=[(0, 1)] * n, method="highs")
    assert res.status == "OPTIMAL"
    assert abs(res.obj_val - ref.fun) <= 1e-6 * (1 + abs(ref.fun))
    assert ipm_fleet.last_ne_stats["f64_direct"] > 0
