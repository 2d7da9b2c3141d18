"""A run of the one-chip cell on the CPU at its small test sizes: the last
line keeps the contract, the check passes, and it fails under the
lower-precision control and with the timed path broken underneath. The
sizes' limits (the cells' "cpu_test_sizes") were set from 12 seeds of the
program and 3 of the control and of each fault at these sizes."""

import json
import os
import pathlib
import subprocess
import sys

import pytest

from portbench import cells, readings
from portbench.reference import train as ref_train

ENTRY = pathlib.Path(__file__).with_name("entry.py")
CELL = "mamba2-2.7b-l8.train.int8ef"
KEYS = {"correct", "attempted", "failed", "metrics", "device"}


def launch(cell: str, seed: int, *, trace: int = 0,
           fault: str | None = None, timeout: float = 240.0):
    """The finished process of one CPU run of `cell`."""
    env = dict(os.environ, OMP_NUM_THREADS="1")
    env.pop("PORTBENCH_TEST_FAULT", None)
    if fault:
        env["PORTBENCH_TEST_FAULT"] = fault
    return subprocess.run(
        [sys.executable, str(ENTRY), "--workload", cell, "--seed", str(seed),
         "--seconds", "0.5", "--trace", str(trace)],
        capture_output=True, text=True, timeout=timeout, env=env,
        cwd=cells.ROOT)


def run(cell: str, seed: int, **kw) -> dict:
    """The result line of one CPU run of `cell`, which has to exit with 0
    and print the compared numbers last on standard error."""
    proc = launch(cell, seed, **kw)
    assert proc.returncode == 0, proc.stderr[-3000:]
    limits = cells.load_cell(cell, cpu_sizes=True)["check"]["limits"]
    tail = proc.stderr.strip().splitlines()[-len(limits):]
    assert [t.split()[1] for t in tail] == list(limits), tail
    return json.loads(proc.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("trace", [0, 1])
def test_cpu_run_prints_the_contract_line(trace):
    out = run(CELL, 5, trace=trace)
    assert KEYS <= set(out) and list(out)[-1] == "checks"
    assert out["correct"] is True and out["failed"] == 0
    assert out["attempted"] >= 4
    names = {m["name"] for m in cells.metrics_for(CELL, bool(trace))}
    assert set(out["metrics"]) <= names
    if not trace:
        assert set(out["metrics"]) == names
    assert out["device"]["count"] == 1
    for c in out["checks"].values():
        assert c["value"] <= c["limit"]


@pytest.mark.parametrize("fault", ["unchanged", "half_batch"])
def test_cpu_run_with_a_fault_is_not_correct(fault):
    out = run(CELL, 6, fault=fault)
    assert out["correct"] is False


@pytest.mark.parametrize("name", [w["name"] for w in
                                  cells.benchmark()["workloads"]])
def test_the_control_fails_the_check(name):
    """The reference in float8 in the program's place fails one of the
    cell's numbers at the small sizes; the float32 reference against
    itself passes them all."""
    cell = cells.load_cell(name, cpu_sizes=True)
    cfg = cells.load_config(cell["config"], cpu_sizes=True)
    limits = cell["check"]["limits"]
    ref = ref_train.follow(cfg, cell, 2, "cpu")
    same = readings.compare(ref_train.follow(cfg, cell, 2, "cpu"), ref)
    assert all(same[k] <= limits[k] for k in limits)
    ctl = readings.compare(ref_train.follow(cfg, cell, 2, "cpu",
                                            variant="fp8"), ref)
    assert any(ctl[k] > limits[k] for k in limits), ctl


def test_calibrate_reads_the_control_alone(capsys):
    """`calibrate.py --one-process`: the reference and the control of each
    seed in one process, one line of readings each."""
    from portbench import calibrate
    rc = calibrate.main(["--workload", CELL, "--one-process",
                         "--variant-seeds", "2", "--variants", "fp8"],
                        device_type="cpu", cpu_sizes=True)
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    assert rc == 0
    assert [x["run"] for x in lines] == ["reference", "fp8"]
    assert set(readings.NUMBERS) <= set(lines[1])
