"""Finds a cell, its configuration, a metric's reader, a family's
reference, its program configuration and its FLOP count by name, from the
files under this directory and `BENCHMARK.json` beside it: a later cell,
configuration or metric is a new file and a new entry, never an edit."""

from __future__ import annotations

import copy
import importlib
import importlib.util
import json
import pathlib

HERE = pathlib.Path(__file__).resolve().parent
ROOT = HERE.parent


def benchmark() -> dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def load_cell(name: str, *, cpu_sizes: bool = False) -> dict:
    cell = json.loads((HERE / "workloads" / f"{name}.json").read_text())
    if cell["name"] != name:
        raise ValueError(f"workloads/{name}.json names {cell['name']!r}")
    return merged(cell, cell.get("cpu_test_sizes")) if cpu_sizes else cell


def load_config(name: str, *, cpu_sizes: bool = False) -> dict:
    cfg = json.loads((HERE / "configs" / f"{name}.json").read_text())
    if cfg["name"] != name:
        raise ValueError(f"configs/{name}.json names {cfg['name']!r}")
    return merged(cfg, cfg.get("cpu_test_sizes")) if cpu_sizes else cfg


def merged(base: dict, over: dict | None) -> dict:
    """`base` with the keys of `over` laid over it, nested groups key by
    key but for a check's limits, which replace the base's whole (the
    small sizes the CPU tests run)."""
    out = copy.deepcopy(base)
    for k, v in (over or {}).items():
        if isinstance(v, dict) and isinstance(out.get(k), dict) \
                and k != "limits":
            out[k] = merged(out[k], v)
        else:
            out[k] = v
    return out


def port_config(cfg: dict):
    """The program's ModelConfig of a configuration, derived from its
    published keys by `port/<arch_type>.py`."""
    return importlib.import_module(
        f"portbench.port.{cfg['arch_type']}").model_config(cfg)


def _load_file(path: pathlib.Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def metric_reader(name: str):
    """`read(record)` of metrics/<name>.py."""
    return _load_file(HERE / "metrics" / f"{name}.py",
                      "portbench_metric_" + name.replace(".", "_")).read


def metrics_for(cell: str, trace: bool) -> list:
    """The BENCHMARK.json metric entries a run of `cell` reports: its
    end-to-end metrics, or with `trace` its per-layer ones."""
    spec = benchmark()
    entries = spec["per_layer"] if trace else spec["end_to_end"]
    return [m for m in entries if cell in m.get("workloads", [cell])]
