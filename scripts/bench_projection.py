#!/usr/bin/env python
"""Projection-kernel scaling benchmark.

Measures the distributed null-space projection kernel (CG on YY' with
psum-reduced matvecs, parallel/projector.py) at several mesh widths and
reports CG iterations/s per width.

With several cards this runs over the real devices; on CPU set
  JAX_PLATFORMS=cpu XLA_FLAGS=--xla_force_host_platform_device_count=8
to exercise the same collectives over virtual devices.  Multi-process runs
use the identical code path via jax.distributed.initialize
(parallel/multihost.py).
"""
from __future__ import annotations

import json
import time

import numpy as np


def main(m: int = 512, n_per_dev: int = 4096, cg_iters: int = 100,
         reps: int = 5):
    import jax

    from smart_crossover_tpu.parallel import make_mesh, sharded_projector

    ndev = len(jax.devices())
    widths = [w for w in (1, 2, 4, 8, 16) if w <= ndev]
    rng = np.random.default_rng(0)
    rows = []
    for w in widths:
        n = n_per_dev * w
        Y = rng.standard_normal((m, n)).astype(np.float32)
        v = rng.standard_normal(n).astype(np.float32)
        mesh = make_mesh(n_batch=1, n_model=w, devices=jax.devices()[:w])
        out = sharded_projector(mesh, Y, v, tol=0.0, max_iter=cg_iters)
        jax.block_until_ready(out)
        times = []
        for _ in range(reps):
            t0 = time.perf_counter()
            out = sharded_projector(mesh, Y, v, tol=0.0, max_iter=cg_iters)
            jax.block_until_ready(out)
            times.append(time.perf_counter() - t0)
        dt = min(times)
        rows.append({
            "mesh_width": w,
            "n_cols": n,
            "cg_iters_per_sec": round(cg_iters / dt, 1),
            "time_s": round(dt, 4),
        })
        print(json.dumps(rows[-1]))
    # weak-scaling efficiency vs 1 device
    base = rows[0]["cg_iters_per_sec"]
    for r in rows:
        r["weak_scaling_efficiency"] = round(r["cg_iters_per_sec"] / base, 3)
    print(json.dumps({"backend": jax.default_backend(), "m": m,
                      "n_per_device": n_per_dev, "results": rows}))


if __name__ == "__main__":
    import argparse

    ap = argparse.ArgumentParser()
    ap.add_argument("--m", type=int, default=512)
    ap.add_argument("--n-per-dev", type=int, default=4096)
    ap.add_argument("--cg-iters", type=int, default=100)
    a = ap.parse_args()
    main(a.m, a.n_per_dev, a.cg_iters)
