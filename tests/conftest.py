import os
import pathlib

# Tests run on a virtual 8-device CPU mesh so multi-device sharding logic is
# exercised without a GPU. The platform defaults to the CPU (JAX_PLATFORMS,
# applied through jax.config before any device use; `gpu` tests are run
# with JAX_PLATFORMS=cuda,cpu). XLA_FLAGS must be set before backend init.
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402

jax.config.update("jax_platforms", os.environ["JAX_PLATFORMS"])

import pytest  # noqa: E402

GOLDEN = pathlib.Path(__file__).parent / "golden"


@pytest.fixture(scope="session")
def golden_dir():
    return GOLDEN


@pytest.fixture(scope="session")
def gpu():
    """The card for `gpu` tests; skips when JAX's default device is not a
    GPU (decided here, never at import)."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip(f"needs a GPU; JAX's default device is {dev.platform}")
    return dev
