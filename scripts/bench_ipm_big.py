#!/usr/bin/env python
"""Single-big-LP barrier head-to-head (VERDICT r4 item 5).

One dense LP (default 5000x15000), solved to 1e-8 two ways:

* ``ipm_big`` — fleet machinery at B=1: f32 device stage carries the bulk
  Mehrotra iterations (the 750-GFLOP normal-equations GEMM runs on the device),
  host f64 endgame pays the exact GEMM only for the last 2-5 steps;
* host dense Mehrotra (`ipm_endgame_batched` at B=1 from a cold
  midpoint start — threaded dense BLAS3, the FAIR host shape for a
  dense A: `solvers/ipm.py::ipm_solve` would CSR-ify the 100%-dense
  matrix and pay single-threaded sparse products) — pays the f64 GEMM
  every iteration (the reference's vendor-barrier shape,
  reference solver_caller/caller.py:181-189).

Usage: python scripts/bench_ipm_big.py [m n] [--device-only|--host-only]
       (default 5000 15000)
"""
from __future__ import annotations

import json
import sys
import time

import numpy as np


def make_lp(m, n, seed=0):
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((m, n)) / np.sqrt(n)
    x0 = rng.uniform(0.2, 0.8, n)
    b = A @ x0
    l = np.zeros(n)
    u = np.ones(n)
    margin = np.abs(rng.standard_normal(n)) * 0.1 + 0.01
    c = A.T @ rng.standard_normal(m) + margin
    return A, b, c, l, u


def run_device(A, b, c, l, u):
    """ipm_big compile+warm, then a timed warm run.  Returns (out, secs)."""
    from smart_crossover_tpu.solvers import ipm_fleet as _fleet
    from smart_crossover_tpu.solvers.ipm_fleet import ipm_big

    r = ipm_big(A, b, c, l, u, tol=1e-8)
    warm_s = r.runtime.total_seconds()
    print(f"ipm_big warmup: {r.status} obj={r.obj_val:.8e} "
          f"{warm_s:.1f}s ({r.iter_count} iters)", flush=True)
    t0 = time.perf_counter()
    r2 = ipm_big(A, b, c, l, u, tol=1e-8)
    big_s = time.perf_counter() - t0
    print(f"ipm_big warm: {r2.status} obj={r2.obj_val:.8e} {big_s:.1f}s "
          f"(device {r2.device_s:.1f}s/{r2.device_iters}it, "
          f"endgame {r2.endgame_s:.1f}s/{r2.endgame_iters}it)", flush=True)
    if _fleet.last_ne_stats:
        print("ne_device:", json.dumps(_fleet.last_ne_stats), flush=True)
    return r2, big_s, warm_s


def run_host(m, n, A, b, c, l, u):
    """Cold dense Mehrotra on the host, threaded BLAS3.  Returns
    (obj, secs, status)."""
    from smart_crossover_tpu.solvers.ipm_fleet import ipm_endgame_batched

    t0 = time.perf_counter()
    x0 = np.clip((l + u) / 2.0, l + 0.1, u - 0.1)[None]
    hx, hy, hzl, hzu, conv, hit = ipm_endgame_batched(
        A[None], b[None], c[None], l[None], u[None],
        x0, np.zeros((1, m)), np.ones((1, n)), np.ones((1, n)),
        tol=1e-8, max_iters=100)
    host_s = time.perf_counter() - t0
    host_obj = float(c @ hx[0])
    host_status = "OPTIMAL" if bool(np.all(conv)) else "ITERATION_LIMIT"
    print(f"host IPM (dense batched B=1, cold): {host_status} "
          f"obj={host_obj:.8e} {host_s:.1f}s ({int(hit)} iters)",
          flush=True)
    return host_obj, host_s, host_status


def main():
    import jax

    from smart_crossover_tpu.config import use_compile_cache

    use_compile_cache()

    args = [int(a) for a in sys.argv[1:] if not a.startswith("--")]
    m, n = args if len(args) == 2 else (5000, 15000)
    backend = jax.default_backend()
    print(f"backend={backend} {m}x{n} dense", flush=True)
    A, b, c, l, u = make_lp(m, n)

    if "--host-only" in sys.argv:
        run_host(m, n, A, b, c, l, u)
        return
    r2, big_s, warm_s = run_device(A, b, c, l, u)
    if "--device-only" in sys.argv:
        return
    host_obj, host_s, host_status = run_host(m, n, A, b, c, l, u)

    gap = abs(r2.obj_val - host_obj) / (1 + abs(host_obj))
    print(json.dumps({
        "metric": "ipm_big_speedup_vs_host",
        "value": round(host_s / big_s, 2),
        "unit": "x",
        "detail": {"backend": backend, "m": m, "n": n,
                   "ipm_big_warm_s": round(big_s, 1),
                   "ipm_big_first_s": round(warm_s, 1),
                   "host_s": round(host_s, 1),
                   "status": [r2.status, host_status],
                   "rel_obj_gap": float(gap)}}))


if __name__ == "__main__":
    main()
