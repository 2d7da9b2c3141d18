"""The benchmark's files against BENCHMARK.json and its contract, the
references' parameter layouts and bucket plans against the program's, the
FLOP counts, and the imports of every module of the benchmark."""

import ast
import json
import pathlib
import re

import pytest

from portbench import cells, flops, readings
from portbench.reference import train as ref_train

HERE = cells.HERE
SPEC = json.loads((cells.ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
CELLS = [w["name"] for w in SPEC["workloads"]]
CONFIGS = [c["name"] for c in SPEC["configs"]]


def test_benchmark_keys_and_limits():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert SPEC["paths"] == ["portbench"]
    assert SPEC["command"] == ["python3", "portbench/run.py"]
    assert 1 <= SPEC["run_seconds"] <= 51
    assert len({m["name"] for m in SPEC["end_to_end"] + SPEC["per_layer"]}) \
        == len(SPEC["end_to_end"]) + len(SPEC["per_layer"])
    assert "setup_s" in {m["name"] for m in SPEC["end_to_end"]}
    for m in SPEC["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    four = sum(w["chips"] == 4 for w in SPEC["workloads"])
    assert four <= max(1, len(SPEC["workloads"]) // 4)


@pytest.mark.parametrize("entry", SPEC["configs"] + SPEC["workloads"]
                         + SPEC["end_to_end"] + SPEC["per_layer"],
                         ids=lambda e: e["name"])
def test_names_and_units(entry):
    assert NAME.match(entry["name"])
    for key in ("config", "traffic"):
        if key in entry:
            assert NAME.match(entry[key])
    for key in entry.get("reduced", []):
        assert NAME.match(key)
    if "unit" in entry:
        assert UNIT.match(entry["unit"])
        assert entry["better"] in ("lower", "higher")
    for key in ("why", "layer", "source"):
        if key in entry:
            assert 1 <= len(entry[key]) <= 200
            assert "\n" not in entry[key] and "\t" not in entry[key]


@pytest.mark.parametrize("name", CONFIGS)
def test_config_file_loads_by_name(name):
    entry = next(c for c in SPEC["configs"] if c["name"] == name)
    assert entry["file"] == f"portbench/configs/{name}.json"
    cfg = cells.load_config(name)
    assert cfg["source"] == entry["source"]
    assert sorted(cfg["reduced"]) == sorted(entry["reduced"])
    for key, (published, run) in cfg["reduced"].items():
        assert cfg[key] == run and published != run
    assert any(w["config"] == name for w in SPEC["workloads"])


@pytest.mark.parametrize("name", CELLS)
def test_cell_file_loads_by_name(name):
    entry = next(w for w in SPEC["workloads"] if w["name"] == name)
    cell = cells.load_cell(name)
    for key in ("config", "traffic", "chips", "why"):
        assert cell[key] == entry[key]
    assert entry["config"] in CONFIGS
    limits = cell["check"]["limits"]
    assert limits and set(limits) <= set(readings.NUMBERS)
    assert all(v > 0 for v in limits.values())
    end = {m["name"] for m in cells.metrics_for(name, False)}
    layer = {m["name"] for m in cells.metrics_for(name, True)}
    assert {"setup_s", "train_tokens_per_s"} <= end and layer


@pytest.mark.parametrize("metric", SPEC["per_layer"],
                         ids=lambda m: m["name"])
def test_metric_reader_loads_by_name(metric):
    assert callable(cells.metric_reader(metric["name"]))
    assert metric["moves"] in {m["name"] for m in SPEC["end_to_end"]}
    for w in metric.get("workloads", []):
        assert w in CELLS
    assert metric["source"] in ("device_trace", "program_span",
                                "program_counter", "host_clock")


@pytest.mark.parametrize("small", [False, True], ids=["cell", "cpu"])
@pytest.mark.parametrize("name", CONFIGS)
def test_reference_matches_program_layout(name, small):
    """The reference's sizes, parameter leaves and bucket plan are the
    program's."""
    import torch

    from repro_torch import tree as tree_lib
    from repro_torch.core import engine, scheduler
    from repro_torch.core.planner import Planner
    from repro_torch.models.transformer import Model
    from repro_torch.train import trainer as tr

    cfg = cells.load_config(name, cpu_sizes=small)
    model = Model(cells.port_config(cfg))
    lay = ref_train.family(cfg["arch_type"]).layout(cfg)
    prog = {p: (tuple(d.shape), d.dtype)
            for p, d in tree_lib.leaves_with_paths(model.param_defs())}
    assert prog == {p: (tuple(s["shape"]), getattr(torch, s["dtype"]))
                    for p, s in lay.items()}
    for cell in (cells.load_cell(w["name"]) for w in SPEC["workloads"]
                 if w["config"] == name):
        c = cell["comm"]
        X = ref_train.exchange(cell)
        kind, data, model_axis = c["mesh"]
        assert kind == "host"
        mesh = {"data": data, "model": model_axis}
        planner = Planner(mesh=mesh, dp_only=c["dp_only"])
        specs = dict(tree_lib.leaves_with_paths(tr.param_specs(model,
                                                                planner)))
        comm = engine.CommConfig(mode=c["mode"], wire=c["wire"],
                                 error_feedback=c["error_feedback"],
                                 accum_steps=c["accum_steps"])
        plan = engine.build_plan(
            tr._grad_struct(model), comm, mesh, planner.batch_axes,
            device="meta", layer_index=scheduler.default_layer_index,
            group_key=lambda p: specs.get(p, ()),
            leaf_replicated=lambda p: all(a is None for a in specs[p]))
        assert all(plan.fusable)
        ref = X.plan(lay)
        got = [[(plan.buckets.paths[i], s) for i, s in
                zip(b.leaf_ids, b.shapes)] for b in plan.buckets.buckets]
        assert got == ref
        for b, rb in zip(plan.buckets.buckets, ref):
            assert X.padded(X.bucket_elems(rb), cell["chips"]) // \
                cell["chips"] == engine.cl.ef_residual_shape(
                    b.n_elems, cell["chips"])[0]


@pytest.mark.parametrize("change", [
    {"wire": "bf16"}, {"error_feedback": False}, {"mode": "gspmd"},
    {"dp_only": False}, {"mesh": ["hier", 2, 2]}, {"mesh": ["host", 2, 2]},
    {"overlap": True}], ids=lambda c: "-".join(f"{k}={v}" for k, v in
                                               c.items()))
def test_an_unmodelled_exchange_is_refused(change):
    """A cell whose "comm" group names the int8 EF reference but states
    another setting, or a key that no reference reads, is refused before
    anything runs, by the reference and by the harness's set-up."""
    cell = cells.load_cell("yi-6b-l4.train.int8ef.dp4", cpu_sizes=True)
    cell["comm"].update(change)
    with pytest.raises(ValueError):
        ref_train.exchange(cell)
    with pytest.raises(ValueError):
        ref_train.follow(cells.load_config(cell["config"], cpu_sizes=True),
                         cell, 1, "cpu")


def test_flops_of_the_cells():
    """The cells' arithmetic: yi-6b at 4 layers 3.88e14 a step of 32 x
    2048 tokens (954,204,160 parameters in products), mamba2 at 8 layers
    4.58e13 a step of 8 x 2048."""
    yi = cells.load_config("yi-6b-l4")
    mb = cells.load_config("mamba2-2.7b-l8")
    attn = 32 * 4 * 6 * 2048 ** 2 * 32 * 128
    assert flops.step_flops(yi, 32, 2048) == 6.0 * 954_204_160 * 65536 + attn
    assert flops.step_flops(mb, 8, 2048) == pytest.approx(4.58e13, rel=0.01)


FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def _imports(path: pathlib.Path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", sorted(HERE.rglob("*.py")),
                         ids=lambda p: str(p.relative_to(HERE)))
def test_no_jax_and_an_independent_reference(path):
    tops = {m.split(".")[0] for m in _imports(path)}
    assert not tops & FORBIDDEN, tops & FORBIDDEN
    if "reference" in path.relative_to(HERE).parts:
        assert "repro_torch" not in tops
