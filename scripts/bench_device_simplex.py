"""Head-to-head: device transportation simplex engines + host core.

Times the fully-device-resident exact OT crossover
(parallel/batched.py::batched_tnet_exact_device) with each device pivot
engine, and the host-native cleanup path (batched_tnet_exact), at growing
instance sizes, on whatever jax.default_backend() is.

Usage: python scripts/bench_device_simplex.py [sizes...]  (default 64 128 256)
"""
from __future__ import annotations

import sys
import time

import numpy as np


def make_batch(B, S, D, seed=0, dtype=np.float32):
    rng = np.random.default_rng(seed)
    s = rng.uniform(0.5, 2.0, (B, S)).astype(dtype)
    d = rng.uniform(0.5, 2.0, (B, D)).astype(dtype)
    d *= (s.sum(axis=1) / d.sum(axis=1))[:, None]
    def grid(N):
        side = int(np.sqrt(N))
        while N % side:      # largest divisor <= sqrt(N)
            side -= 1
        return np.stack(np.unravel_index(np.arange(N), (side, N // side)),
                        -1)

    xs = grid(S)
    xd = grid(D)
    M0 = np.abs(xs[:, None, :] - xd[None, :, :]).sum(-1).astype(dtype)
    M = M0[None] + rng.uniform(0, 0.1, (B, S, D)).astype(dtype)
    return s, d, M


def main():
    import jax

    from smart_crossover_tpu.config import use_compile_cache

    use_compile_cache()

    from smart_crossover_tpu.parallel.batched import (
        batched_tnet_exact,
        batched_tnet_exact_device,
    )

    B = 16
    engines = ("packed", "anc", "parent", "mask")
    sizes = []
    skip_host = False
    for a in sys.argv[1:]:
        if a.startswith("--batch="):
            B = int(a.split("=", 1)[1])
        elif a.startswith("--engines="):
            engines = tuple(a.split("=", 1)[1].split(","))
        elif a == "--no-host":
            skip_host = True
        else:
            sizes.append(int(a))
    sizes = sizes or [64, 128, 256]
    backend = jax.default_backend()
    print(f"backend={backend} batch={B}")
    for n in sizes:
        s, d, M = make_batch(B, n, n)
        row = {"n": n, "B": B}
        for engine in engines:
            if engine == "mask" and n > 128:
                row["mask"] = None  # the dense-propagation oracle: slow
                continue
            fn = lambda: batched_tnet_exact_device(
                s, d, M, reg=0.005, sinkhorn_iters=1000,
                max_pivots=20000, engine=engine)
            jax.block_until_ready(fn())          # compile + warm-up
            ts = []
            for _ in range(5):
                t0 = time.perf_counter()
                out = fn()
                jax.block_until_ready(out)
                ts.append(time.perf_counter() - t0)
            dt = float(np.median(ts))
            X, obj, push, piv, opt, _ = out
            row[engine] = {
                "s": round(dt, 4),
                "inst_per_s": round(B / dt, 1),
                "max_pivots": int(np.max(np.asarray(piv))),
                "all_optimal": bool(np.all(np.asarray(opt))),
            }
        if skip_host:
            print(row, flush=True)
            continue
        # host-native cleanup path (threaded C++ core)
        t0 = time.perf_counter()
        hX, hobj, hpiv, hopt = batched_tnet_exact(
            s, d, M, reg=0.005, sinkhorn_iters=1000)
        host_dt = time.perf_counter() - t0
        row["host"] = {"s": round(host_dt, 4),
                       "inst_per_s": round(B / host_dt, 1),
                       "all_optimal": bool(np.all(hopt))}
        if row.get("parent"):
            dev_obj = np.asarray(obj, dtype=np.float64)
            gap = np.max(np.abs(dev_obj - hobj) / (np.abs(hobj) + 1))
            row["obj_gap_device_vs_host"] = float(gap)
        print(row, flush=True)


if __name__ == "__main__":
    main()
