"""The port's per-bucket statistics (repro_torch.obs.stats) on 8 gloo ranks,
("node"=2, "local"=4), against the reference's on mesh8.

One group of 8 ranks is spawned once for the file (tests/torch_obs_ranks.py,
torch only). It builds the port's engine for each case of CASES — the
cases of tests/test_obs.py (flat fp32, two-level int8 + EF legs,
non-fusable buckets falling back to flat bf16, cost-model routing, the
warn-only metrics, describe) and the smoke model's plans (the CLI's
planner, dp_only, the hybrid planner) — and, for the
int8 plans, replays the buckets through BucketTimer.

`CommStats.from_plan` must give the reference's per-bucket legs, bytes,
routes, reduce axes and modeled seconds EXACTLY (the same integer byte
arithmetic, the same cost model), and the same table below its header
(the header names each package's kernel backend). The BucketTimer's tuple
is positive and the same on every rank (the MAX over the world), it calls
exactly one quantize and one dequantize per fusable bucket per replay on
the int8 plans (the non-fusable ones ride bf16 and quantize nothing), and
a training state stepped before it is unchanged after it (the replay
draws its own inputs and fresh residuals).
"""

import json

import jax
import numpy as np
import pytest

from repro.configs import registry as jreg
from repro.core import engine as jeng
from repro.core import planner as jpl
from repro.core.planner import Planner as JPlanner
from repro.models.transformer import Model as JModel
from repro.train import trainer as jtr

import torch_spawn
from torch_obs_ranks import CASES, COUNTED, ITERS, TIMED, WARMUP, TREE

WORLD = 8
DATA_AXES = ("node", "local")


@pytest.fixture(scope="module")
def port(tmp_path_factory):
    out = tmp_path_factory.mktemp("obs_ranks")
    torch_spawn.spawn("torch_obs_ranks.py", WORLD,
                      tmp_path_factory.mktemp("store"), out, timeout=150)
    return {name: [json.loads((out / name / f"rank{r}.json").read_text())
                   for r in range(WORLD)] for name in CASES}


def _ref_engine(name, mesh8):
    kw, source = CASES[name]
    comm = jtr.CommConfig(**kw)
    if source == "smoke_hybrid":
        cfg = jreg.get_smoke_config("yi-6b")
        return jtr.make_comm_engine(
            JModel(cfg), mesh8,
            jpl.make_hybrid_planner(mesh8, cfg, batch=8, seq=32), comm)
    if source.startswith("smoke"):
        return jtr.make_comm_engine(
            JModel(jreg.get_smoke_config("yi-6b")), mesh8,
            JPlanner(mesh=mesh8, dp_only=source == "smoke_dp_only"), comm)
    rng = np.random.default_rng(3)
    tree = {k: jax.numpy.asarray(rng.standard_normal(s), jax.numpy.float32)
            for k, s in TREE.items()}
    extra = ({"leaf_replicated": lambda path: False}
             if source == "tree_nonfusable" else {})
    return jeng.CommEngine.create(tree, comm, mesh8, DATA_AXES, **extra)


def _row(b):
    return {"index": b.index, "n_elems": b.n_elems, "route": b.route,
            "wire": b.wire, "fusable": b.fusable, "ef": b.ef,
            "axes": list(b.axes), "t_model": b.t_model,
            "intra_bytes": b.intra_bytes, "inter_bytes": b.inter_bytes,
            "scale_bytes": b.scale_bytes, "padded_elems": b.padded_elems,
            "pad_frac": b.pad_frac,
            "legs": [[lg.leg, lg.level, lg.wire, lg.elems, lg.payload_bytes,
                      lg.scale_bytes] for lg in b.legs]}


@pytest.fixture(scope="module")
def ref(mesh8):
    out = {}
    for name in CASES:
        engine = _ref_engine(name, mesh8)
        measured = tuple(1e-3 * (i + 1) for i in range(engine.plan.n_buckets))
        out[name] = (engine, engine.stats(measured=measured))
    return out


@pytest.mark.parametrize("name", list(CASES))
def test_comm_stats_equal_reference_exactly(port, ref, name):
    recs = port[name]
    engine, st = ref[name]
    for r in recs[1:]:                 # every rank derives the same report
        assert {k: v for k, v in r.items() if k not in (
            "sampled", "measured_again")} == \
            {k: v for k, v in recs[0].items() if k not in (
                "sampled", "measured_again")}
    got = recs[0]
    assert got["buckets"] == [_row(b) for b in st.buckets]
    assert (got["topo_name"], got["dp"], got["n_node"], got["n_local"],
            got["wire"], got["use_ef"]) == (
        st.topo_name, st.dp, st.n_node, st.n_local, st.wire, st.use_ef)
    assert got["total_bytes"] == st.total_bytes
    assert got["t_model_total"] == st.t_model_total
    assert got["t_measured_total"] == st.t_measured_total
    assert got["bucket_bytes"] == list(engine.plan.bucket_bytes_list())
    # the table and describe() below the header (which names the backend)
    assert got["table"].splitlines()[1:] == st.table().splitlines()[1:]
    assert got["describe"].splitlines()[1:] == \
        engine.plan.describe().splitlines()[1:]
    assert got["metrics"] == st.to_metrics()


def test_flat_fp32_bytes_exact(port):
    for b in port["flat_fp32"][0]["buckets"]:
        assert b["route"] == "flat" and b["intra_bytes"] == 0
        assert b["inter_bytes"] == b["n_elems"] * 4 and b["pad_frac"] == 0.0


def test_hier_int8_leg_bytes_exact(port):
    rows = [b for b in port["hier_int8_ef"][0]["buckets"]
            if b["route"] == "hier"]
    assert rows
    for b in rows:
        rs_i, rs_f, ag_f, ag_i = b["legs"]
        padded = rs_i[3]
        m = padded // 4
        assert rs_i[1] == ag_i[1] == "intra"
        assert rs_i[4] == ag_i[4] == padded * 2          # bf16 intra
        assert rs_f[1] == "inter" and rs_f[4] == 2 * m    # bf16 fabric RS
        assert ag_f[2] == "int8" and ag_f[4] == m         # int8 fabric AG
        assert ag_f[5] == m // 512 * 4                    # f32 scales
        assert b["ef"]


def test_nonfusable_falls_back_flat_bf16(port):
    for b in port["nonfusable_int8"][0]["buckets"]:
        assert not b["fusable"] and not b["ef"]
        assert b["route"] == "flat" and b["wire"] == "bf16"
        assert b["inter_bytes"] == b["n_elems"] * 2


def test_stats_metrics_warn_only(port):
    for name in CASES:
        ms = port[name][0]["metrics"]
        assert ms and all(m["better"] is None or m["stable"] is False
                          for m in ms)
        names = {m["name"] for m in ms}
        assert "comm_stats/total/total_B" in names
        assert any(n.endswith("/t_measured_us") for n in names)


def test_plan_topology_feeds_the_modeled_column(port):
    got = port["hier_int8_topo"][0]
    assert got["topo_name"] == "xeon-shm-10gbe"
    assert all(b["t_model"] > 0 for b in got["buckets"])
    # the CLI planner on the smoke model: only the norm buckets fuse
    smoke = port["smoke_cli_int8_ef"][0]["buckets"]
    assert sum(b["fusable"] for b in smoke) == 2
    assert {b["route"] for b in port["smoke_dp_only_virt"][0]["buckets"]} \
        == {"flat", "hier"}
    # hybrid: sharded buckets over "node" only, on the flat route
    hybrid = port["smoke_hybrid_int8"][0]["buckets"]
    assert {tuple(b["axes"]) for b in hybrid} == {("node",),
                                                  ("node", "local")}
    assert all(b["route"] == "flat" for b in hybrid
               if b["axes"] == ["node"])


@pytest.mark.parametrize("name", TIMED)
def test_bucket_timer_same_tuple_on_every_rank(port, name):
    recs = port[name]
    for key in ("sampled", "measured_again"):
        got = recs[0][key]
        assert all(r[key] == got for r in recs[1:])
        assert len(got) == len(recs[0]["buckets"])
        if name == "skip_reduce":
            assert got == [0.0] * len(got)
        else:
            assert all(t > 0 for t in got)


@pytest.mark.parametrize("name", TIMED)
def test_bucket_timer_calls_one_quantize_and_dequantize_per_replay(port,
                                                                   name):
    rows = port[name][0]["buckets"]
    n = sum(b["fusable"] for b in rows) * (WARMUP + ITERS)
    ef = CASES[name][0].get("error_feedback", False)
    int8 = CASES[name][0].get("wire") == "int8"
    want = dict.fromkeys(COUNTED, 0)
    if int8 and name != "skip_reduce":
        want["quantize_ef" if ef else "quantize"] = n
        want["dequantize"] = n
    for r in port[name]:
        assert r["calls"] == want


@pytest.mark.parametrize("name", [n for n in TIMED if CASES[n][1] in
                                  ("smoke", "smoke_dp_only")])
def test_bucket_timer_leaves_the_training_state_unchanged(port, name):
    assert all(r["state_unchanged"] for r in port[name])
