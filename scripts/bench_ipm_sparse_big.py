#!/usr/bin/env python
"""Sparse optLP-family instance barrier-solved ON-CHIP to 1e-8.

VERDICT r4 item 5's second half: one sparse >=10k-row structure-family
instance (staircase multiperiod LP, data/lp_gen.py — the dominant optLP
structure) through the single-big-LP device barrier ``ipm_big``: the f32
device stage carries the bulk Mehrotra iterations on the device (the
instance is densified device-side — at 10k x 37k the dense NE GEMM is
exactly what the device wants), the f64 endgame runs matrix-free PCG
through the device-resident f32 factor (solvers/ne_device.py), and the
result is checked against scipy HiGHS on the original sparse form.

The reference buys this capability per-instance from a vendor barrier
(reference solver_caller/caller.py:181-189).

Usage: python scripts/bench_ipm_sparse_big.py [periods] (default 20
-> 10,000 rows x 34,000 structural cols + ~3k slacks).
"""
from __future__ import annotations

import json
import sys
import time

import numpy as np


def main():
    import jax

    from smart_crossover_tpu.data.lp_gen import staircase_lp
    from smart_crossover_tpu.solvers.ipm_fleet import ipm_big

    periods = int(sys.argv[1]) if len(sys.argv) > 1 else 20
    lp = staircase_lp(periods=periods)
    A_sp = lp.get_standard_A()
    b = lp.b
    c = lp.get_standard_c()
    l, u = lp.get_standard_bounds()
    m, n = A_sp.shape
    backend = jax.default_backend()
    print(f"backend={backend} {lp.name}: standard form {m}x{n}, "
          f"nnz={A_sp.nnz} ({A_sp.nnz / (m * n):.2%} dense)", flush=True)

    A = A_sp.toarray()
    t0 = time.perf_counter()
    r = ipm_big(A, b, c, l, u, tol=1e-8)
    first_s = time.perf_counter() - t0
    print(f"ipm_big first: {r.status} obj={r.obj_val:.8e} {first_s:.1f}s "
          f"(device {r.device_s:.1f}s/{r.device_iters}it, "
          f"endgame {r.endgame_s:.1f}s/{r.endgame_iters}it)", flush=True)
    t0 = time.perf_counter()
    r2 = ipm_big(A, b, c, l, u, tol=1e-8)
    warm_s = time.perf_counter() - t0
    print(f"ipm_big warm: {r2.status} obj={r2.obj_val:.8e} {warm_s:.1f}s "
          f"(device {r2.device_s:.1f}s/{r2.device_iters}it, "
          f"endgame {r2.endgame_s:.1f}s/{r2.endgame_iters}it)", flush=True)

    # oracle on the original sparse form
    from scipy.optimize import linprog
    t0 = time.perf_counter()
    ref = linprog(c, A_eq=A_sp, b_eq=b,
                  bounds=[(li if np.isfinite(li) else None,
                           ui if np.isfinite(ui) else None)
                          for li, ui in zip(l, u)],
                  method="highs")
    highs_s = time.perf_counter() - t0
    gap = abs(r2.obj_val - ref.fun) / (1 + abs(ref.fun)) \
        if ref.status == 0 else float("nan")
    print(f"HiGHS: status={ref.status} obj={ref.fun} {highs_s:.1f}s",
          flush=True)
    print(json.dumps({
        "metric": "ipm_sparse_big_onchip",
        "value": round(warm_s, 1), "unit": "s",
        "detail": {"backend": backend, "instance": lp.name,
                   "m": m, "n": n, "nnz": int(A_sp.nnz),
                   "status": r2.status, "rel_obj_gap_vs_highs": float(gap),
                   "device_s": round(r2.device_s, 1),
                   "endgame_s": round(r2.endgame_s, 1),
                   "highs_s": round(highs_s, 1)}}))


if __name__ == "__main__":
    main()
