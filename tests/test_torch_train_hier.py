"""The port's train step on 8 gloo ranks, ("node"=2, "local"=4), against the
JAX trainer on mesh8: 3 steps from the same weights on the same data.

One group of 8 ranks is spawned once for the file (tests/torch_train_ranks.py,
torch only) and runs every case in turn: the flat and the two-level route
in fp32 under the CLI's planner, the two-level int8 + error-feedback route
with 2 microbatches under dp_only, cost-model routing on two topologies
(xeon-shm-10gbe sends every bucket two-level; cloud-virtio-sriov splits the
smoke model's buckets between both routes, each carrying its own residual
shape), and the gspmd baseline with 2 microbatches.

The weights cross packages: the reference's checkpoint is what the ranks
restore, and rank 0's final parameters come back through the reference's
`ckpt.restore`.

Tolerances: the step-0 loss depends on weights and data only, rtol 1e-5.
fp32 and gspmd: losses and gradient norms rtol 1e-4 (sums in another order
on gloo than on XLA; Adam's first steps normalize each gradient element,
so a tiny element's sign can differ), final parameters rtol 1e-2, atol 5e-4
(the reference's own bound between its flat and two-level runs) on all but
1e-4 of the elements, and every element within 3 x the summed learning
rate (a flipped sign moves an element by at most two Adam steps of about
lr each). int8: losses and gradient norms rtol 1e-3: at 8 ranks gloo rounds
every partial sum of the bf16 reduce-scatters where XLA rounds once, which
moves int8 codes by up to two steps (tests/test_torch_hier.py), on more
elements than the one rounding tie of the single-rank test (rtol 1e-4
there).
"""

import json
import os
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro import compat
from repro.checkpoint import ckpt as jckpt
from repro.configs import registry as jreg
from repro.core.planner import Planner as JPlanner
from repro.data import pipeline as jpipe
from repro.models.transformer import Batch as JBatch, Model as JModel
from repro.optim import optimizers as jopt, schedules as jsched
from repro.train import trainer as jtr

import torch_cli_obs as cli_obs
import torch_spawn
from torch_train_ranks import CASES, SEQ, STEPS

ROOT = pathlib.Path(__file__).resolve().parents[1]

WORLD = 8
INT8 = {"hier_int8_ef_accum2", "topo_virt_int8_ef"}


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    jm = JModel(jreg.get_smoke_config("yi-6b"))
    params = jax.tree_util.tree_map(np.asarray,
                                    jm.init(jax.random.PRNGKey(0)))
    path = tmp_path_factory.mktemp("weights")
    jckpt.save(str(path), {"params": params}, step=0)
    return path, params


@pytest.fixture(scope="module")
def port(weights, tmp_path_factory):
    """{case: ([rank records], final params of rank 0 read back by the
    reference's ckpt.restore)}."""
    path, params = weights
    out = tmp_path_factory.mktemp("train_ranks")
    torch_spawn.spawn("torch_train_ranks.py", WORLD,
                      tmp_path_factory.mktemp("store"), path, out,
                      timeout=180)
    like = {"params": jax.tree_util.tree_map(
        lambda a: jax.ShapeDtypeStruct(a.shape, a.dtype), params)}
    res = {}
    for name in CASES:
        recs = [json.loads((out / name / f"rank{r}.json").read_text())
                for r in range(WORLD)]
        final = jckpt.restore(str(out / name / "ckpt"), like)["params"]
        assert jckpt.latest_step(str(out / name / "ckpt")) == STEPS
        res[name] = (recs, final)
    return res


@pytest.fixture(scope="module")
def ref(weights, mesh8):
    """{case: (losses, grad norms, final params, plan)} of the reference's
    trainer on mesh8."""
    _, params = weights
    cfg = jreg.get_smoke_config("yi-6b")
    model = JModel(cfg)
    out = {}
    for name, (kw, dp_only, batch) in CASES.items():
        opt = jopt.adamw(jsched.warmup_cosine(3e-3, 1, STEPS))
        comm = jtr.CommConfig(**kw)
        planner = JPlanner(mesh=mesh8, dp_only=dp_only)
        with compat.set_mesh(mesh8):
            p = jax.tree_util.tree_map(jnp.asarray, params)
            state = jtr.TrainState(params=p, opt_state=opt.init(p),
                                   step=jnp.zeros((), jnp.int32))
            step = jax.jit(jtr.make_train_step(model, opt, mesh8, planner,
                                               comm))
            losses, norms = [], []
            dcfg = jpipe.DataConfig(vocab=cfg.vocab, seq_len=SEQ,
                                    global_batch=batch, seed=0)
            for raw in jpipe.iterate(dcfg, STEPS):
                state, m = step(state, JBatch(
                    tokens=jnp.asarray(raw["tokens"]),
                    labels=jnp.asarray(raw["labels"])))
                losses.append(float(m["loss"]))
                norms.append(float(m["grad_norm"]))
            plan = (jtr.make_comm_engine(model, mesh8, planner, comm)
                    if comm.mode == "mlsl" else None)
        out[name] = (losses, norms,
                     jax.tree_util.tree_map(np.asarray, state.params), plan)
    return out


@pytest.mark.parametrize("name", list(CASES))
def test_losses_match_jax_trainer_on_mesh8(port, ref, name):
    recs, _ = port[name]
    want_loss, want_norm, _, _ = ref[name]
    for r in recs[1:]:               # the loss is the pmean: replicated
        assert r["loss"] == recs[0]["loss"]
        assert r["grad_norm"] == recs[0]["grad_norm"]
    rtol = 1e-3 if name in INT8 else 1e-4
    np.testing.assert_allclose(recs[0]["loss"][0], want_loss[0], rtol=1e-5)
    np.testing.assert_allclose(recs[0]["loss"], want_loss, rtol=rtol)
    np.testing.assert_allclose(recs[0]["grad_norm"], want_norm, rtol=rtol)
    assert recs[0]["loss"][-1] < recs[0]["loss"][0]


@pytest.mark.parametrize("name", [n for n in CASES if n not in INT8])
def test_final_params_match_jax_trainer(port, ref, name):
    _, final = port[name]
    lr = jsched.warmup_cosine(3e-3, 1, STEPS)
    lr_sum = sum(float(lr(jnp.int32(t))) for t in range(STEPS))
    got = np.concatenate([np.asarray(a, np.float32).reshape(-1) for a in
                          jax.tree_util.tree_leaves(final)])
    want = np.concatenate([np.asarray(a, np.float32).reshape(-1) for a in
                           jax.tree_util.tree_leaves(ref[name][2])])
    diff = np.abs(got - want)
    outside = diff > 5e-4 + 1e-2 * np.abs(want)
    assert outside.mean() <= 1e-4, (outside.sum(), diff.max())
    assert diff.max() <= 3 * lr_sum, diff.max()


@pytest.mark.parametrize("name", [n for n in CASES
                                  if CASES[n][0]["mode"] == "mlsl"])
def test_routes_and_residual_shapes_match_reference(port, ref, name):
    recs, _ = port[name]
    engine = ref[name][3]
    plan = engine.plan
    assert recs[0]["algos"] == list(plan.algos)
    assert recs[0]["fusable"] == list(plan.fusable)
    jres = engine.init_residuals()
    if jres is None:
        assert all(r["residual_shapes"] == [] for r in recs)
        return
    # the reference's global view splits over the 8 ranks
    want = [[int(a.shape[0]) // WORLD] for a in jres]
    for r in recs:
        assert r["residual_shapes"] == want


def test_topology_routing_takes_both_routes(port):
    algos = port["topo_virt_int8_ef"][0][0]["algos"]
    assert set(algos) == {"flat", "hier"}
    assert set(port["topo_10gbe"][0][0]["algos"]) == {"hier"}


def test_cli_planner_fuses_only_the_norm_buckets(port):
    """The reference's caveat under Planner(mesh) on the hier mesh: every
    matrix carries the (absent) model axis, so only the two norm-scale
    buckets fuse and take the two-level route; the rest go leaf by leaf."""
    recs, _ = port["hier_fp32"]
    fusable = recs[0]["fusable"]
    assert sum(fusable) == 2 and len(fusable) == 10
    assert all(port["hier_int8_ef_accum2"][0][0]["fusable"])


def _torchrun(argv, cwd, **env):
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT / "src"), os.environ.get("PYTHONPATH", "")]), **env)
    env.pop("JAX_PLATFORMS", None)
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "8", "-m", "repro_torch.launch.train"] + argv,
        env=env, cwd=cwd, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return proc.stdout


def test_cli_observability_on_eight_torchrun_ranks(tmp_path, mesh8):
    """The verify command's twin with --stats --trace --telemetry
    --telemetry-sample 1 through torchrun on 8 gloo ranks: rank 0 alone
    prints the table and writes the trace, the telemetry and the ledger;
    the files validate under both packages; the table's byte and modeled
    columns equal the reference's table for the same arguments on mesh8;
    and the final parameters equal, bit for bit, those of the same run
    without the flags (the replay runs between steps, on its own inputs
    and residuals)."""
    argv = ["--device", "cpu", "--arch", "yi-6b", "--steps", "3", "--comm",
            "mlsl", "--wire", "int8", "--error-feedback", "--hier",
            "--batch", "8", "--seq", "32", "--log-every", "1"]
    obs = tmp_path / "obs"
    out = _torchrun(argv + ["--stats", "--trace", str(obs), "--telemetry",
                            str(obs), "--telemetry-sample", "1",
                            "--ckpt-dir", str(tmp_path / "ck_obs")],
                    cwd=ROOT, BENCH_DIR=str(tmp_path / "bench"))
    _torchrun(argv + ["--ckpt-dir", str(tmp_path / "ck")], cwd=tmp_path)
    assert out.count("CommStats:") == 1 and "health: no alarms" in out
    cfg = jreg.get_smoke_config("yi-6b")
    comm = jtr.CommConfig(mode="mlsl", wire="int8", error_feedback=True,
                          hier=True)
    want = jtr.make_comm_engine(JModel(cfg), mesh8, JPlanner(mesh=mesh8),
                                comm).stats()
    got = cli_obs.table_rows(out)
    assert [r[cli_obs.BYTE_COLUMNS] for r in got] == \
        [r[cli_obs.BYTE_COLUMNS] for r in cli_obs.ref_table_rows(want)]
    assert all(float(r[-1]) > 0 for r in got)
    trace = cli_obs.check_trace(obs / "trace.json")
    assert cli_obs.spans(trace) == ["step0", "step1", "step2"]
    events = cli_obs.check_telemetry(obs / "telemetry.jsonl")
    assert [e["step"] for e in events if e["kind"] == "bucket_times"] == \
        [0, 1, 2]
    assert sorted(os.listdir(obs)) == ["telemetry.jsonl", "trace.json"]
    assert os.listdir(tmp_path / "bench") == ["BENCH_torch_comm_stats.json"]
    like = {"params": jax.tree_util.tree_map(
        lambda a: jax.ShapeDtypeStruct(a.shape, a.dtype),
        JModel(cfg).init(jax.random.PRNGKey(0)))}
    a = jckpt.restore(str(tmp_path / "ck_obs"), like)["params"]
    b = jckpt.restore(str(tmp_path / "ck"), like)["params"]
    for x, y in zip(jax.tree_util.tree_leaves(a),
                    jax.tree_util.tree_leaves(b)):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))
