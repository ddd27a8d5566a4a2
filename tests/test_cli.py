import subprocess
import sys

import numpy as np


def _run(args, timeout=300):
    import os

    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    return subprocess.run([sys.executable, "-m", "smart_crossover_tpu"] + args,
                          capture_output=True, text=True, timeout=timeout,
                          env=env)


def test_cli_solve_and_crossover(tmp_path):
    from smart_crossover_tpu.data.lp_gen import random_sparse_lp
    from smart_crossover_tpu.data.mps_write import write_mps

    p = tmp_path / "t.mps"
    write_mps(random_sparse_lp(m=15, n=40, seed=3), p)
    r = _run(["solve", str(p), "--method", "simplex"])
    assert r.returncode == 0 and "OPTIMAL" in r.stdout
    r2 = _run(["crossover", str(p)])
    assert r2.returncode == 0 and "OPTIMAL" in r2.stdout


def test_cli_bad_args():
    r = _run(["solve", "/nonexistent.mps"])
    assert r.returncode != 0
