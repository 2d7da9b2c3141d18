import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))
# repo root: `benchmarks` / `scripts` namespace packages (perf ledger tests)
sys.path.insert(1, os.path.join(os.path.dirname(__file__), ".."))

# Give the in-process suite an 8-chip view of the CPU so multi-rank
# semantics (hierarchical collectives, factored meshes) are testable
# without hardware. Must happen BEFORE jax is imported anywhere
# (SNIPPETS.md idiom); subprocess tests that need a different count
# override XLA_FLAGS in their own environment.
N_VIRTUAL_DEVICES = 8
if "--xla_force_host_platform_device_count" not in \
        os.environ.get("XLA_FLAGS", ""):
    os.environ["XLA_FLAGS"] = (
        f"--xla_force_host_platform_device_count={N_VIRTUAL_DEVICES} "
        + os.environ.get("XLA_FLAGS", ""))

import jax  # noqa: E402
import pytest  # noqa: E402

from repro import compat  # noqa: E402


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "slow: long-running end-to-end tests (dry-run compiles)")
    config.addinivalue_line(
        "markers", "gpu: needs a CUDA device (skipped where none is present)")


@pytest.fixture(scope="session")
def mesh11():
    return compat.make_mesh((1, 1), ("data", "model"),
                            axis_types=(compat.AxisType.Auto,) * 2)


@pytest.fixture(scope="session")
def mesh8():
    """("node"=2, "local"=4) factored data-parallel mesh over the 8 virtual
    devices -- the hierarchical-collectives test mesh."""
    from repro.launch import mesh as mesh_lib
    return mesh_lib.make_hier_mesh(node=2, local=4)


@pytest.fixture(scope="session")
def abstract_pod():
    return compat.abstract_mesh((16, 16), ("data", "model"))

