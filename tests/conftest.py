"""Test configuration: the unit tests run on the CPU.

By default every test process uses the CPU platform with 8 virtual devices
(the sharding tests build meshes over them). Tests marked ``gpu`` need an
NVIDIA GPU: they take the ``gpu_device`` fixture, which skips when the
process has none. `chip_smoke.py` runs them in-process on the card with
``--jax-platforms=keep``, which leaves the platform its process already
chose.
"""

import os

xla_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in xla_flags:
    os.environ["XLA_FLAGS"] = (
        xla_flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402


def pytest_addoption(parser):
    parser.addoption(
        "--jax-platforms",
        default="cpu",
        help="JAX platform for the test process: 'cpu' (default) or 'keep' "
        "to leave the platform the process already uses",
    )


def pytest_configure(config):
    if config.getoption("--jax-platforms") == "cpu":
        # the env var too, so subprocesses started by tests inherit it
        os.environ["JAX_PLATFORMS"] = "cpu"
        jax.config.update("jax_platforms", "cpu")


@pytest.fixture
def gpu_device():
    """The process's first GPU; skips the test where there is none."""
    try:
        devices = jax.devices("gpu")
    except RuntimeError:
        devices = []
    if not devices:
        pytest.skip(
            "no GPU in this process: the unit tests run on the CPU; "
            "`python chip_smoke.py` runs the gpu tests on the card"
        )
    return devices[0]


@pytest.fixture(scope="session")
def n10_fixture():
    """Golden 10-variable skeleton fixture (A_N10 / C_N10).

    Loaded from the committed cache extracted from the reference's test
    data by tests/tools/extract_fixtures.py.
    """
    path = os.path.join(os.path.dirname(__file__), "data", "n10.npz")
    if not os.path.exists(path):
        pytest.skip("n10 fixture cache missing; run tests/tools/extract_fixtures.py")
    data = np.load(path)
    return data["C"], data["A"], float(data["alpha"]), int(data["sample_size"])
