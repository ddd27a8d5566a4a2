"""Benchmark: CERTIFIED-EXACT batched OT crossover throughput on device.

Runs the flagship exact pipeline (Sinkhorn warm start -> flow indicators ->
Borůvka MST -> tree solve -> irrigation push -> device transportation
simplex to optimality, all on device) over a batch of MNIST-scale OT
instances, then certifies every instance on the host: exact f64 flows and
duals recomputed from the returned spanning-tree basis alone, accepted
under the reference's test (artificials < 1e-8, reduced costs >= -1e-6;
reference net_manager.py:306-319).  Certification wall-clock is INCLUDED
in the headline throughput, so the reported number is end-to-end
certified-optimal instances/s/chip.  Two shapes run: 64 x 256^2 (the
headline) and 16 x 784^2, the reference's MNIST scale.  On a CPU backend
the script exits non-zero unless ``--rehearse`` is given.

Baseline: the same warm-start pipeline implemented the way the reference
implements its crossover stage (scipy sparse MST + spsolve + sequential
numpy push; reference tree_BI.py), timed on the host CPU for a subsample.
The baseline stops at a feasible vertex (the reference then pays a vendor
network-simplex call for exactness), so vs_baseline UNDERSTATES the
speedup of the certified-exact pipeline.

Prints ONE JSON line:
{"metric": ..., "value": N, "unit": ..., "vs_baseline": N, "detail": ...}
where ``detail`` names the device (platform, device_kind, count, and the
card's name and power limit) and holds one row per shape.
"""
from __future__ import annotations

import json
import time

import numpy as np


def make_batch(B, S, D, seed=0):
    """Generate in f64 (mass balance exact at certification precision);
    the device consumes an f32 cast, the certifier/baseline the f64."""
    rng = np.random.default_rng(seed)
    s = rng.uniform(0.5, 2.0, (B, S))
    d = rng.uniform(0.5, 2.0, (B, D))
    d *= (s.sum(axis=1) / d.sum(axis=1))[:, None]
    # MNIST-like ground cost: L1 distances on a pixel grid
    side_s = int(np.sqrt(S))
    side_d = int(np.sqrt(D))
    xs = np.stack(np.unravel_index(np.arange(S), (side_s, S // side_s)), -1)
    xd = np.stack(np.unravel_index(np.arange(D), (side_d, D // side_d)), -1)
    M0 = np.abs(xs[:, None, :] - xd[None, :, :]).sum(-1).astype(np.float64)
    M = M0[None, :, :] + rng.uniform(0, 0.1, (B, S, D))
    return s, d, M


def cpu_reference_pipeline(s, d, M, reg=0.05, sinkhorn_iters=200):
    """Reference-style host implementation (scipy MST + spsolve + python
    push loop), one instance at a time."""
    import scipy.sparse as sp

    S, D = M.shape
    eps = reg * M.max()
    # numpy log-domain sinkhorn
    f = np.zeros(S)
    g = np.zeros(D)
    logs, logd = np.log(s), np.log(d)
    for _ in range(sinkhorn_iters):
        t = (g[None, :] - M) / eps
        f = eps * (logs - (t.max(1) + np.log(
            np.exp(t - t.max(1)[:, None]).sum(1))))
        t2 = (f[:, None] - M) / eps
        g = eps * (logd - (t2.max(0) + np.log(
            np.exp(t2 - t2.max(0)[None, :]).sum(0))))
    X = np.exp((f[:, None] + g[None, :] - M) / eps)
    W = np.maximum(X / s[:, None], X / d[None, :])
    # scipy MST (reference tree_BI.py:32-59 structure)
    V = S + D
    row = np.repeat(np.arange(S), D)
    col = S + np.tile(np.arange(D), S)
    gmat = sp.coo_matrix((-W.ravel() - 1e-9, (row, col)), shape=(V, V))
    tree = sp.csgraph.minimum_spanning_tree(gmat)
    ti, tj = tree.nonzero()
    mask = np.zeros((S, D), dtype=bool)
    mask[ti, tj - S] = True
    # tree solve via spsolve on the (V-1)x(V-1) basis (reference :74-76)
    cols = np.flatnonzero(mask.ravel())
    rows_A = np.concatenate([cols // D, S + cols % D])
    cols_A = np.concatenate([np.arange(cols.size), np.arange(cols.size)])
    data_A = np.concatenate([-np.ones(cols.size), np.ones(cols.size)])
    A = sp.csc_matrix((data_A, (rows_A, cols_A)), shape=(V, cols.size))
    bb = np.concatenate([-s, d])
    sol = sp.linalg.spsolve(A[:-1, :], bb[:-1])
    Xt = np.zeros(S * D)
    Xt[cols] = sol
    Xt = Xt.reshape(S, D)
    # sequential push (reference :85-110)
    it = 0
    while Xt.min() < 0 and it < 100000:
        I1, J1 = np.unravel_index(np.argmin(Xt), Xt.shape)
        J2 = np.argmax(Xt[I1, :])
        I2 = np.argmax(Xt[:, J1])
        theta = min(-Xt[I1, J1], Xt[I1, J2], Xt[I2, J1])
        Xt[I1, J1] += theta
        Xt[I2, J1] -= theta
        Xt[I1, J2] -= theta
        Xt[I2, J2] += theta
        it += 1
    return Xt


def card_name_and_power() -> str:
    """The card's name and power limit, as ``nvidia-smi`` reports them.

    Read by a child process that never imports JAX; "not available" where
    the machine has no ``nvidia-smi``."""
    import subprocess

    try:
        r = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60)
    except (OSError, subprocess.TimeoutExpired):
        return "not available"
    out = r.stdout.strip()
    return out if r.returncode == 0 and out else "not available"


def device_record() -> dict:
    """The device as JAX reports it, plus the card's name and power."""
    import jax

    dev = jax.devices()[0]
    return {"platform": dev.platform, "device_kind": dev.device_kind,
            "count": len(jax.devices()), "card": card_name_and_power()}


# (B, S, D, seed): 64 instances at 256^2, and 16 at the reference's MNIST
# scale (784^2, reference scripts/mnist2ot.py:30-40); --rehearse runs tiny
# shapes on the CPU to check the harness, never to measure it
SHAPES = ((64, 256, 256, 0), (16, 784, 784, 1))
REHEARSE_SHAPES = ((4, 16, 16, 0), (2, 25, 25, 1))


def _time_shape(B, S, D, seed, reg, iters, reps):
    """Certified-exact throughput at one shape: the device stage (median of
    blocked reps after a compile run) plus host certification."""
    import jax

    from smart_crossover_tpu.network_methods.certify import (
        certify_ot_basis_batch,
    )
    from smart_crossover_tpu.parallel.batched import (
        auto_engine,
        batched_tnet_exact_device,
    )

    # the accelerator's engine (the CPU of a rehearsal would route to host)
    engine = auto_engine(S, D, accelerator=True)
    s64, d64, M64 = make_batch(B, S, D, seed=seed)
    s, d, M = (a.astype(np.float32) for a in (s64, d64, M64))

    def run():
        return batched_tnet_exact_device(s, d, M, reg=reg,
                                         sinkhorn_iters=iters,
                                         max_pivots=20000, engine=engine)

    jax.block_until_ready(run())          # compile + warm-up
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        out = run()
        jax.block_until_ready(out)
        times.append(time.perf_counter() - t0)
    dt = float(np.median(times))
    X, obj, push, piv, opt, Bm = out
    t0 = time.perf_counter()
    certs = certify_ot_basis_batch(np.asarray(Bm), s64, d64, M64)
    cert_dt = time.perf_counter() - t0
    n_certified = sum(c.ok for c in certs)
    return {
        "batch": B, "S": S, "D": D, "engine": engine,
        "certified_instances_per_sec": B / (dt + cert_dt),
        "device_stage_s": dt,
        "device_stage_reps_s": times,
        "certify_host_s": cert_dt,
        "all_optimal_device": bool(np.all(np.asarray(opt))),
        "all_certified": bool(n_certified == B),
        "n_certified": int(n_certified),
        "max_feas_err": float(max(c.max_feas_err for c in certs)),
        "min_reduced_cost": float(min(c.min_rcost for c in certs)),
        "median_pivots": int(np.median(np.asarray(piv))),
    }, (s64, d64, M64)


def main(argv=None) -> int:
    import argparse
    import sys

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--rehearse", action="store_true",
                    help="run tiny shapes on the CPU to check the harness; "
                         "the output is labelled platform cpu")
    args = ap.parse_args(argv)

    import jax

    from smart_crossover_tpu.config import use_compile_cache

    use_compile_cache()
    platform = jax.devices()[0].platform
    if platform == "cpu" and not args.rehearse:
        print("bench.py: no accelerator found (JAX platform 'cpu'); "
              "pass --rehearse for a CPU rehearsal at tiny shapes",
              file=sys.stderr)
        return 1
    shapes = REHEARSE_SHAPES if args.rehearse else SHAPES
    reps = 3 if args.rehearse else 9
    # warm-start strength of the exact-fleet protocol: a sharper plan
    # means fewer simplex pivots
    reg, iters = 0.005, 1000 if not args.rehearse else 200

    rows = []
    for i, (B, S, D, seed) in enumerate(shapes):
        row, (s64, d64, M64) = _time_shape(B, S, D, seed, reg, iters,
                                           reps if i == 0 else 5)
        # host baseline: the reference-style pipeline on one instance
        t0 = time.perf_counter()
        cpu_reference_pipeline(s64[0], d64[0], M64[0], reg=reg,
                               sinkhorn_iters=iters)
        cpu_dt = time.perf_counter() - t0
        row["cpu_reference_instances_per_sec"] = 1.0 / cpu_dt
        row["vs_cpu_reference"] = row["certified_instances_per_sec"] * cpu_dt
        rows.append(row)

    head = rows[0]
    detail = dict(device_record(), sinkhorn_iters=iters, rows=rows)
    print(json.dumps({
        "metric": "certified_exact_ot_crossover_throughput",
        "value": head["certified_instances_per_sec"],
        "unit": "instances/s/chip",
        "vs_baseline": head["vs_cpu_reference"],
        "detail": detail,
    }))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
