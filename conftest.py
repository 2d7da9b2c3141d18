"""Rules for every test session of the repo, whichever of its test folders
(tests/, portbench/tests/) a run names: pytest loads this file first."""

import os

# One OpenMP thread (torch's pool, numpy's BLAS) in the xdist workers and
# in every process they start: the spawned rank groups, torchrun and the
# CLI, dry-run and benchmark subprocesses inherit it. The workers and their
# rank groups share the CPUs; pools whose threads wait for one another there
# spent an eighth of the suite's CPU time, and the test-sized tensors gain
# nothing from more threads. Set before torch or numpy loads.
os.environ["OMP_NUM_THREADS"] = "1"

import pytest  # noqa: E402


@pytest.hookimpl(optionalhook=True)
def pytest_xdist_make_scheduler(config, log):
    """Under pytest-xdist, every case of a file runs on one worker, whatever
    `--dist` says. A module-scoped fixture (a spawned 8-rank gloo group,
    the reference's runs it is compared with) is built on each worker that
    draws a case of its file: spread over workers, as `--dist load` spreads
    them, it is built again on each, and the copies of an 8-rank group
    oversubscribe the CPUs. tests/test_one_worker_per_file.py holds this."""
    from xdist.scheduler import LoadFileScheduling
    return LoadFileScheduling(config, log)
