"""Build the native library:  python -m smart_crossover_tpu.native.build"""
from __future__ import annotations

import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).parent


def build(verbose: bool = True, out: Path | None = None) -> Path:
    """Compile netsimplex.cpp into ``out`` (default: the package's
    libscxnative.so, the path ``native.load_native`` loads)."""
    src = HERE / "netsimplex.cpp"
    out = HERE / "libscxnative.so" if out is None else Path(out)
    cmd = ["g++", "-O3", "-march=native", "-fPIC", "-shared", "-std=c++17",
           str(src), "-o", str(out)]
    if verbose:
        print(" ".join(cmd))
    subprocess.run(cmd, check=True)
    return out


if __name__ == "__main__":
    path = build()
    print(f"built {path}")
    sys.exit(0)
