"""Sustained CERTIFIED-exact serving throughput (production shape).

Measures a sustained serving shape — K dispatches of B instances each —
for the fully-device EXACT pipeline (Sinkhorn -> indicators -> Boruvka MST ->
tree solve -> push -> device transportation simplex to optimality) plus
host certification of every instance from the returned tree basis under
the reference acceptance test (artificials < 1e-8, reduced costs >=
-1e-6; reference net_manager.py:306-319 analog in
network_methods/certify.py).

Usage: python scripts/bench_serving.py [B S D n_dispatch]
Timing: one compile + warm-up dispatch, then the wall across all
dispatches, each fetching its basis to the host as a server would.
"""
from __future__ import annotations

import json
import sys
import time

import numpy as np


def make_batch(B, S, D, seed):
    rng = np.random.default_rng(seed)
    s = rng.uniform(0.5, 2.0, (B, S))
    d = rng.uniform(0.5, 2.0, (B, D))
    d *= (s.sum(axis=1) / d.sum(axis=1))[:, None]

    def grid(N):
        side = int(np.sqrt(N))
        while N % side:
            side -= 1
        return np.stack(
            np.unravel_index(np.arange(N), (side, N // side)), -1)

    xs, xd = grid(S), grid(D)
    M0 = np.abs(xs[:, None, :] - xd[None, :, :]).sum(-1).astype(float)
    M = M0[None] + rng.uniform(0, 0.1, (B, S, D))
    return s, d, M


def main():
    import jax

    from smart_crossover_tpu.config import use_compile_cache

    use_compile_cache()

    from smart_crossover_tpu.network_methods.certify import (
        certify_ot_basis_batch,
    )
    from smart_crossover_tpu.parallel.batched import (
        batched_tnet_exact_device,
    )

    args = [int(a) for a in sys.argv[1:]]
    B, S, D, K = args if len(args) == 4 else (16, 128, 128, 16)
    backend = jax.default_backend()
    batches = [make_batch(B, S, D, seed) for seed in range(K)]

    def dispatch(s, d, M):
        return batched_tnet_exact_device(
            s.astype(np.float32), d.astype(np.float32),
            M.astype(np.float32), reg=0.005, sinkhorn_iters=1000,
            max_pivots=20000, engine="packed")

    jax.block_until_ready(dispatch(*batches[0]))     # compile + warm-up

    t0 = time.perf_counter()
    results = []
    for s, d, M in batches:
        out = dispatch(s, d, M)
        # serving consumes the basis on the host: fetch it
        results.append(np.asarray(out[5]))
    device_wall = time.perf_counter() - t0

    n_cert = 0
    worst_feas, worst_rc = 0.0, 0.0
    t0 = time.perf_counter()
    for (s, d, M), Bm in zip(batches, results):
        certs = certify_ot_basis_batch(Bm, s, d, M)
        n_cert += sum(1 for c in certs if c.ok)
        worst_feas = max(worst_feas, max(c.max_feas_err for c in certs))
        worst_rc = min(worst_rc, min(c.min_rcost for c in certs))
    certify_wall = time.perf_counter() - t0

    total = B * K
    print(json.dumps({
        "metric": "sustained_certified_exact_serving",
        "value": round(total / (device_wall + certify_wall), 1),
        "unit": "instances/s",
        "detail": {
            "backend": backend, "B": B, "S": S, "D": D,
            "n_dispatch": K, "total_instances": total,
            "device_wall_s": round(device_wall, 3),
            "device_rate_inst_per_s": round(total / device_wall, 1),
            "certify_wall_s": round(certify_wall, 3),
            "n_certified": n_cert,
            "max_feas_err": float(worst_feas),
            "min_reduced_cost": float(worst_rc),
        }}))


if __name__ == "__main__":
    main()
