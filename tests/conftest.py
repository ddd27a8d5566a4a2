import os

# Force the CPU with 8 virtual devices, so that the multi-device sharding
# paths are testable without cards, unless JAX_PLATFORMS names the GPU
# (the card-only run, `python chip_smoke.py`, phase 2); enable x64 so that
# tolerances match the reference's 1e-8.  jax.config.update, not the
# environment, picks the platform: jax may already be imported.
ON_CARD = any(p in ("cuda", "gpu")
              for p in os.environ.get("JAX_PLATFORMS", "").split(","))
if not ON_CARD:
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

if not ON_CARD:
    jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture
def rng():
    return np.random.default_rng(42)


@pytest.fixture
def gpu_device():
    """The card, for tests marked ``gpu``; skips where there is none.
    Decided here, at run time, never at import: every xdist worker must
    collect the same tests."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip("needs a GPU: run `python chip_smoke.py` on the card "
                    "(its phase 2 runs `pytest -m gpu`)")
    return dev


def random_ot(rng, ns=7, nd=9):
    s = rng.uniform(0.5, 2.0, ns)
    d = rng.uniform(0.5, 2.0, nd)
    d *= s.sum() / d.sum()
    M = rng.uniform(0.0, 5.0, (ns, nd))
    from smart_crossover_tpu.models import OptTransport

    return OptTransport(s=s, d=d, M=M)


@pytest.fixture
def small_ot(rng):
    return random_ot(rng)
