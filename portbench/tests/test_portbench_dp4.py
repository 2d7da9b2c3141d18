"""The four-rank cell rehearsed on the CPU: four gloo ranks at the cell's
small test sizes through the harness's own spawning and rendezvous; the
check passes, and fails with the gradient exchange left out or with one
rank other than 0 leaving its parameters unmoved; a rank other than 0
that loads the JAX package's name fails the run."""

import pytest

from portbench.tests.test_portbench_run import launch, run

CELL = "yi-6b-l4.train.int8ef.dp4"


@pytest.mark.parametrize("fault", [None, "no_exchange", "unchanged_rank1"])
def test_four_gloo_ranks(fault):
    out = run(CELL, 4, fault=fault, trace=0 if fault else 1)
    assert out["device"]["count"] == 4
    assert out["correct"] is (fault is None)


def test_a_rank_that_loads_jax_fails_the_run():
    proc = launch(CELL, 4, fault="jax_rank1")
    assert proc.returncode != 0 and not proc.stdout.strip()
    assert "rank 1 loaded ['repro']" in proc.stderr, proc.stderr[-3000:]
