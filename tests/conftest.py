import os

# The tests run on the CPU backend with a virtual 8-device mesh for the
# sharding tests; both must be set before JAX initialises. Tests marked
# `gpu` run only where JAX_PLATFORMS names a GPU platform (see README); they
# start child processes on the card, so no process reserves most of its
# memory up front.
os.environ.setdefault("JAX_PLATFORMS", "cpu")
os.environ.setdefault("XLA_PYTHON_CLIENT_PREALLOCATE", "false")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=8").strip()

import pathlib
import sys

import pytest

REPO = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

#: the reference repository's test_data, copied into this (gitignored)
#: directory of the checkout; the tests that need it skip without it
REF_DATA = REPO / "ref_data"


@pytest.fixture(scope="session")
def ref_data():
    """The reference repository's test fixtures (optional, see REF_DATA)."""
    if not REF_DATA.exists():
        pytest.skip("reference test_data not available")
    return REF_DATA


@pytest.fixture(scope="session")
def gpu_device():
    """The first GPU; skips when JAX has none (decided here, at run time,
    never while modules are imported)."""
    import jax

    try:
        return jax.devices("gpu")[0]
    except RuntimeError:
        pytest.skip("no GPU: JAX finds no CUDA device")
