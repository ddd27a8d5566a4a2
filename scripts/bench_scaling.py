#!/usr/bin/env python
"""Weak-scaling of the batched TNET pipeline over the mesh batch axis.

Per-device batch is held constant while the mesh widens; on hardware the
devices work independently (pure data parallelism), so ideal scaling is
linear in width.  Run on CPU with virtual devices:

  JAX_PLATFORMS=cpu \
  XLA_FLAGS=--xla_force_host_platform_device_count=8 \
  python scripts/bench_scaling.py
"""
from __future__ import annotations

import json
import time

import numpy as np


def main(per_dev: int = 4, S: int = 64, D: int = 64,
         sinkhorn_iters: int = 200, reps: int = 3):
    import jax

    from smart_crossover_tpu.parallel import make_mesh, sharded_batched_tnet

    ndev = len(jax.devices())
    widths = [w for w in (1, 2, 4, 8, 16) if w <= ndev]
    rng = np.random.default_rng(0)
    rows = []
    for w in widths:
        B = per_dev * w
        s = rng.uniform(0.5, 2.0, (B, S)).astype(np.float32)
        d = rng.uniform(0.5, 2.0, (B, D)).astype(np.float32)
        d *= (s.sum(1) / d.sum(1))[:, None]
        M = rng.uniform(0, 5, (B, S, D)).astype(np.float32)
        mesh = make_mesh(n_batch=w, n_model=1, devices=jax.devices()[:w])
        out = sharded_batched_tnet(mesh, s, d, M, reg=0.05,
                                   sinkhorn_iters=sinkhorn_iters)
        jax.block_until_ready(out)
        ts = []
        for _ in range(reps):
            t0 = time.perf_counter()
            out = sharded_batched_tnet(mesh, s, d, M, reg=0.05,
                                       sinkhorn_iters=sinkhorn_iters)
            jax.block_until_ready(out)
            ts.append(time.perf_counter() - t0)
        dt = min(ts)
        rows.append({"mesh_width": w, "batch": B,
                     "instances_per_sec": round(B / dt, 1),
                     "time_s": round(dt, 4)})
        print(json.dumps(rows[-1]))
    base = rows[0]["instances_per_sec"]
    for r in rows:
        r["weak_scaling_efficiency"] = round(
            r["instances_per_sec"] / (base * r["mesh_width"]), 3)
    print(json.dumps({"backend": jax.default_backend(),
                      "per_device_batch": per_dev, "S": S, "D": D,
                      "results": rows}))


if __name__ == "__main__":
    main()
