"""Fleet barrier head-to-head: device batched IPM vs host per-instance loop.

VERDICT r2 item 2: take the batched device IPM from toy (32 x 24x64) to
real fleet scale — 64 x (256x512)-class dense LPs — with f32 batched
ADA' GEMMs + batched Cholesky on the device and a host-f64 Mehrotra endgame
per instance (solvers/ipm_fleet.py).  The comparison target is the host
per-instance IPM loop (solvers/ipm.py), which is what the reference's
vendor-barrier usage amounts to (reference solver_caller/caller.py:188-193,
one barrier solve per instance).

Usage: python scripts/bench_fleet_ipm.py [B m n]   (default 64 256 512)
Timing protocol per CLAUDE.md: fetch-forced warmup, median of reps.
"""
from __future__ import annotations

import json
import sys
import time

import numpy as np


def make_fleet(B, m, n, seed=0):
    rng = np.random.default_rng(seed)
    As = rng.standard_normal((B, m, n)) / np.sqrt(m)
    xs = rng.uniform(0.2, 0.8, (B, n))
    bs = np.einsum("bmn,bn->bm", As, xs)
    cs = rng.standard_normal((B, n))
    return As, bs, cs, np.zeros((B, n)), np.ones((B, n))


def main():
    import jax

    from smart_crossover_tpu.config import use_compile_cache

    use_compile_cache()

    from smart_crossover_tpu.solvers.ipm import ipm_solve
    from smart_crossover_tpu.solvers.ipm_batched import ipm_dense_batched
    from smart_crossover_tpu.solvers.ipm_fleet import ipm_fleet

    args = [int(a) for a in sys.argv[1:]]
    B, m, n = args if len(args) == 3 else (64, 256, 512)
    backend = jax.default_backend()
    dt = np.float64 if jax.config.jax_enable_x64 else np.float32
    print(f"backend={backend} fleet={B}x({m}x{n}) device_dtype={dt.__name__}")
    A, b, c, l, u = make_fleet(B, m, n)

    # --- device stage alone (batched GEMM + Cholesky on device) ----------
    dev_args = tuple(v.astype(dt) for v in (A, b, c, l, u))
    out = ipm_dense_batched(*dev_args, tol=1e-5, max_iters=60)
    float(np.asarray(out["x"]).sum())          # fetch-forced warmup
    ts = []
    for _ in range(5):
        t0 = time.perf_counter()
        out = ipm_dense_batched(*dev_args, tol=1e-5, max_iters=60)
        jax.block_until_ready(out)
        ts.append(time.perf_counter() - t0)
    dev_dt = float(np.median(ts))
    dev_conv = int(np.asarray(out["converged"]).sum())
    dev_iters = np.asarray(out["iters"])
    print(f"device stage: {dev_dt:.3f}s ({B / dev_dt:.1f} inst/s), "
          f"{dev_conv}/{B} converged@1e-5, iters med={np.median(dev_iters)}")

    # --- full fleet solve: device + host f64 endgame to 1e-8 --------------
    t0 = time.perf_counter()
    fleet = ipm_fleet(A, b, c, l, u, tol=1e-8)
    fleet_dt = time.perf_counter() - t0
    n_opt = sum(s == "OPTIMAL" for s in fleet.status)
    print(f"fleet (device + f64 endgame): {fleet_dt:.3f}s "
          f"({B / fleet_dt:.1f} inst/s), {n_opt}/{B} OPTIMAL@1e-8, "
          f"refine iters med={np.median(fleet.refine_iters)}")

    # --- host per-instance IPM loop (the reference's shape) ---------------
    sub = max(2, B // 16)      # subsample; scale
    t0 = time.perf_counter()
    host_obj = []
    for i in range(sub):
        r = ipm_solve(A[i], b[i], c[i], l[i], u[i], tol=1e-8)
        assert r.status == "OPTIMAL", r.status
        host_obj.append(r.obj_val)
    host_dt = (time.perf_counter() - t0) / sub
    print(f"host loop: {host_dt:.3f}s/inst ({1 / host_dt:.2f} inst/s)")

    gap = max(abs(fleet.obj[i] - host_obj[i]) / (1 + abs(host_obj[i]))
              for i in range(sub))
    speedup = host_dt / (fleet_dt / B)
    print(json.dumps({
        "metric": "fleet_ipm_speedup_vs_host_loop",
        "value": round(speedup, 2),
        "unit": "x",
        "detail": {
            "backend": backend, "B": B, "m": m, "n": n,
            "device_stage_s": round(dev_dt, 3),
            "fleet_total_s": round(fleet_dt, 3),
            "host_per_instance_s": round(host_dt, 3),
            "n_optimal_1e8": n_opt,
            "max_obj_gap_vs_host": float(gap),
        }}))


if __name__ == "__main__":
    main()
