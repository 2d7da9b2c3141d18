"""Checks shared by the CLI observability tests (tests/test_torch_train.py,
test_torch_train_hier.py, test_torch_serve.py): the stats table's rows out
of a CLI's output, and the trace and telemetry files validated under both
packages' validators. No JAX import (the reference's trace and telemetry
modules import none).
"""

from repro.obs import telemetry as jtelemetry
from repro.obs import trace as jtrace
from repro_torch.obs import telemetry as obs_telemetry
from repro_torch.obs import trace as obs_trace

# a row's columns up to the modeled time: all but the last, t_meas_us
BYTE_COLUMNS = slice(0, -1)


def table_rows(text: str) -> list:
    """The bucket rows and the sum row of the CommStats table in `text`,
    split into columns."""
    lines = text.splitlines()
    start = next(i for i, ln in enumerate(lines)
                 if ln.startswith("CommStats:"))
    rows = []
    for ln in lines[start + 4:]:
        cols = ln.split()
        rows.append(cols)
        if cols and cols[0] == "sum":
            return rows
    raise AssertionError(f"no sum row in the table:\n{text}")


def ref_table_rows(stats) -> list:
    return table_rows(stats.table())


def check_trace(path) -> dict:
    """Load the trace under both validators; return the port's load."""
    jtrace.load_trace(str(path))
    return obs_trace.load_trace(str(path))


def check_telemetry(path) -> list:
    jtelemetry.load_telemetry(str(path))
    return obs_telemetry.load_telemetry(str(path))


def spans(trace: dict, pid: int = 0, tid: int = 0) -> list:
    return [e["name"] for e in trace["traceEvents"]
            if e["ph"] == "X" and e["pid"] == pid and e["tid"] == tid]
