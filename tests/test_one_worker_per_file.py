"""Under pytest-xdist every case of a file runs on one worker, whatever
`--dist` says (`pytest_xdist_make_scheduler` in the repo root's
conftest.py), so a module-scoped fixture, a spawned rank group above all,
is built once a session. The module fixture here writes the id of each
worker that builds it to a file its session's workers share, and each
case reads one id there, its own. The last case runs this file's cases
again in a session of its own under `-n 2 --dist load`, which would hand
two of them to each worker, and reads one id there too."""

import os
import pathlib
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _worker():
    return os.environ.get("PYTEST_XDIST_WORKER", "main")


@pytest.fixture(scope="module")
def built_by(tmp_path_factory):
    """The file of the ids of the workers that built this fixture."""
    base = tmp_path_factory.getbasetemp()
    if "PYTEST_XDIST_WORKER" in os.environ:
        base = base.parent               # shared by the session's workers
    path = base / "built_by"
    with open(path, "a") as f:
        f.write(_worker() + "\n")
    return path


@pytest.mark.parametrize("case", range(4))
def test_module_fixture_is_built_on_this_worker_alone(built_by, case):
    assert built_by.read_text().split() == [_worker()]


def test_dist_load_keeps_a_file_on_one_worker(tmp_path):
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("PYTEST_XDIST_", "PYTEST_CURRENT_TEST"))}
    env["PYTHONPATH"] = os.pathsep.join(
        [str(ROOT / "src"), env.get("PYTHONPATH", "")])
    proc = subprocess.run(
        [sys.executable, "-m", "pytest", "-q", "-p", "no:cacheprovider",
         "-p", "xdist", "-n", "2", "--dist", "load", "-p", "no:randomly",
         f"--basetemp={tmp_path / 'inner'}",
         f"{__file__}::test_module_fixture_is_built_on_this_worker_alone"],
        env=env, cwd=ROOT, capture_output=True, text=True, timeout=180)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    assert "4 passed" in proc.stdout, proc.stdout[-3000:]
    assert len((tmp_path / "inner" / "built_by").read_text().split()) == 1
