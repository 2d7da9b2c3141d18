"""The slice as a whole: the port's mlsl int8 train step against the JAX
trainer on make_host_mesh(1, 1), on converted weights and the same data.

Three configurations: (a) the default planner, int8 + error feedback, two
microbatches; (b) dp_only, the same; (c) dp_only, int8 without error
feedback, one microbatch. The step-0 loss agrees within rtol 1e-5 (the same
weights, sums in another order). Later losses are held to the int8 wire's
contract, rtol 1e-3 (PERF.md §2, "train losses rtol 1e-4 (int8 1e-3)"):
the gradient's sums run in another order, so a value at a rounding edge of
the quantizer takes the neighbouring code, which moves its element by one
scale step (amax/127 of its block of 512); error feedback carries that step
into the next step's gradient, and AdamW's normalised update spreads it.
On one CPU the losses of case (a) read 1.07e-4 apart at step 3, on another
within 1e-4: the count of flipped codes depends on the CPU's summation
order, the bound on the wire does not.
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
import torch

from repro import compat
from repro.configs import registry as jreg
from repro.core.planner import Planner as JPlanner
from repro.data import pipeline as jpipe
from repro.launch import mesh as jmesh
from repro.models.transformer import Batch as JBatch, Model as JModel
from repro.optim import optimizers as jopt, schedules as jsched
from repro.train import trainer as jtr
from repro_torch import convert, tree as tree_lib
from repro_torch.configs import registry as treg
from repro_torch.core.planner import Planner as TPlanner
from repro_torch.data import pipeline as tpipe
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import train as ttrain
from repro_torch.models.transformer import Batch as TBatch, Model as TModel
from repro_torch.optim import optimizers as topt, schedules as tsched
from repro_torch.train import trainer as ttr

ROOT = pathlib.Path(__file__).resolve().parents[1]
STEPS = 3
DATA = dict(seq_len=32, global_batch=8, seed=0)
CASES = {"a_default_ef_accum2": (False, True, 2),
         "b_dp_only_ef_accum2": (True, True, 2),
         "c_dp_only_int8_accum1": (True, False, 1)}


@pytest.fixture(scope="module")
def jax_params():
    jm = JModel(jreg.get_smoke_config("yi-6b"))
    return jax.tree_util.tree_map(np.asarray,
                                  jm.init(jax.random.PRNGKey(0)))


def _jax_losses(params, dp_only, ef, accum):
    cfg = jreg.get_smoke_config("yi-6b")
    model = JModel(cfg)
    mesh = jmesh.make_host_mesh(1, 1)
    opt = jopt.adamw(jsched.warmup_cosine(3e-3, 1, STEPS))
    comm = jtr.CommConfig(mode="mlsl", wire="int8", error_feedback=ef,
                          accum_steps=accum)
    with compat.set_mesh(mesh):
        state = jtr.TrainState(
            params=jax.tree_util.tree_map(jnp.asarray, params),
            opt_state=opt.init(jax.tree_util.tree_map(jnp.asarray, params)),
            step=jnp.zeros((), jnp.int32))
        step = jax.jit(jtr.make_train_step(
            model, opt, mesh, JPlanner(mesh=mesh, dp_only=dp_only), comm))
        losses = []
        for raw in jpipe.iterate(jpipe.DataConfig(vocab=cfg.vocab, **DATA),
                                 STEPS):
            state, m = step(state, JBatch(tokens=jnp.asarray(raw["tokens"]),
                                          labels=jnp.asarray(raw["labels"])))
            losses.append(float(m["loss"]))
    return losses


def _port_run(params, dp_only, ef, accum, overlap=False):
    cfg = treg.get_smoke_config("yi-6b")
    model = TModel(cfg)
    mesh = tmesh.make_host_mesh(1, 1, device="cpu")
    opt = topt.adamw(tsched.warmup_cosine(3e-3, 1, STEPS))
    comm = ttr.CommConfig(mode="mlsl", wire="int8", error_feedback=ef,
                          accum_steps=accum, overlap=overlap)
    state = ttr.train_state_from_params(
        convert.params_from_jax(params, device="cpu"), opt)
    step = ttr.make_train_step(model, opt, mesh,
                               TPlanner(mesh=mesh, dp_only=dp_only), comm)
    losses = []
    for raw in tpipe.iterate(tpipe.DataConfig(vocab=cfg.vocab, **DATA), STEPS):
        state, m = step(state, TBatch(tokens=torch.from_numpy(raw["tokens"]),
                                      labels=torch.from_numpy(raw["labels"])))
        losses.append(float(m["loss"]))
    return losses, state


@pytest.mark.parametrize("case", sorted(CASES))
def test_losses_match_jax_trainer(jax_params, case):
    dp_only, ef, accum = CASES[case]
    want = _jax_losses(jax_params, dp_only, ef, accum)
    got, state = _port_run(jax_params, dp_only, ef, accum)
    np.testing.assert_allclose(got[0], want[0], rtol=1e-5)
    np.testing.assert_allclose(got, want, rtol=1e-3)
    assert got[-1] < got[0]
    assert state.step == STEPS
    assert (state.comm_residuals is not None) == ef


def _run_both(params, comm_kw, optimizer="adamw"):
    """3 steps of the reference's and the port's trainer at one rank with
    the same CommConfig, optimizer and weights; (losses, final params) of
    each, as numpy."""
    cfg_j, cfg_t = jreg.get_smoke_config("yi-6b"), treg.get_smoke_config(
        "yi-6b")
    jmesh11 = jmesh.make_host_mesh(1, 1)
    tmesh11 = tmesh.make_host_mesh(1, 1, device="cpu")
    jo = jopt.make_optimizer(optimizer, jsched.warmup_cosine(3e-3, 1, STEPS))
    to = topt.make_optimizer(optimizer, tsched.warmup_cosine(3e-3, 1, STEPS))
    data = list(jpipe.iterate(jpipe.DataConfig(vocab=cfg_j.vocab, **DATA),
                              STEPS))
    with compat.set_mesh(jmesh11):
        jp = jax.tree_util.tree_map(jnp.asarray, params)
        js = jtr.TrainState(params=jp, opt_state=jo.init(jp),
                            step=jnp.zeros((), jnp.int32))
        jstep = jax.jit(jtr.make_train_step(
            JModel(cfg_j), jo, jmesh11, JPlanner(mesh=jmesh11),
            jtr.CommConfig(**comm_kw)))
        jl = []
        for raw in data:
            js, m = jstep(js, JBatch(tokens=jnp.asarray(raw["tokens"]),
                                     labels=jnp.asarray(raw["labels"])))
            jl.append(float(m["loss"]))
    ts = ttr.train_state_from_params(
        convert.params_from_jax(params, device="cpu"), to)
    tstep = ttr.make_train_step(TModel(cfg_t), to, tmesh11,
                                TPlanner(mesh=tmesh11),
                                ttr.CommConfig(**comm_kw))
    tl = []
    for raw in data:
        ts, m = tstep(ts, TBatch(tokens=torch.from_numpy(raw["tokens"]),
                                 labels=torch.from_numpy(raw["labels"])))
        tl.append(float(m["loss"]))
    return ((jl, jax.tree_util.tree_map(np.asarray, js.params)),
            (tl, tree_lib.tree_map(lambda t: t.numpy(), ts.params)))


@pytest.mark.parametrize("accum", [1, 2])
@pytest.mark.parametrize("optimizer", ["adamw", "lamb"])
def test_gspmd_matches_jax_trainer(jax_params, accum, optimizer):
    """The gspmd baseline at one rank: microbatch gradients summed in f32,
    cast to the parameter dtype, all-reduced leaf by leaf, clipped. Losses
    rtol 1e-5 (the same weights; sums in another order); parameters after 3
    updates rtol 1e-2, atol 5e-4 (the reference's bound between its own
    flat and two-level runs) on all but 1e-4 of the elements, and every
    element within 3 x the summed learning rate: Adam divides each gradient
    element by its own scale, so the sign of a near-zero element can flip,
    which moves it by at most two steps of about lr each."""
    (jl, jp), (tl, tp) = _run_both(
        jax_params, dict(mode="gspmd", accum_steps=accum), optimizer)
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    lr = jsched.warmup_cosine(3e-3, 1, STEPS)
    lr_sum = sum(float(lr(jnp.int32(t))) for t in range(STEPS))
    got = np.concatenate([b.reshape(-1) for b in tree_lib.leaves(tp)])
    want = np.concatenate([np.asarray(a).reshape(-1)
                           for a in jax.tree_util.tree_leaves(jp)])
    diff = np.abs(got - want)
    outside = diff > 5e-4 + 1e-2 * np.abs(want)
    assert outside.mean() <= 1e-4, (outside.sum(), diff.max())
    assert diff.max() <= 3 * lr_sum, diff.max()


def test_gspmd_rejects_overlap():
    mesh = tmesh.make_host_mesh(1, 1, device="cpu")
    with pytest.raises(ValueError, match="mlsl"):
        ttr.make_train_step(TModel(treg.get_smoke_config("yi-6b")),
                            topt.adamw(1e-3), mesh, TPlanner(mesh=mesh),
                            ttr.CommConfig(mode="gspmd", overlap=True,
                                           accum_steps=2))


def test_overlap_equals_blocking_bitwise(jax_params):
    """The pipelined order reduces the same values with the same ops, so
    losses, parameters and residuals are bitwise the blocking order's."""
    l_block, s_block = _port_run(jax_params, True, True, 2, overlap=False)
    l_over, s_over = _port_run(jax_params, True, True, 2, overlap=True)
    assert l_block == l_over
    for a, b in zip(tree_lib.leaves(s_block.params),
                    tree_lib.leaves(s_over.params)):
        assert torch.equal(a, b)
    for a, b in zip(s_block.comm_residuals, s_over.comm_residuals):
        assert torch.equal(a, b)


def test_data_pipeline_copy_matches_reference():
    for kw in (dict(vocab=512, seq_len=32, global_batch=8, seed=0),
               dict(vocab=64000, seq_len=7, global_batch=4, seed=3)):
        for step in (0, 5):
            a = jpipe.batch_at(jpipe.DataConfig(**kw), step)
            b = tpipe.batch_at(tpipe.DataConfig(**kw), step)
            np.testing.assert_array_equal(a["tokens"], b["tokens"])


def test_schedule_and_clip_match_reference():
    js = jsched.warmup_cosine(3e-3, 2, 10)
    ts = tsched.warmup_cosine(3e-3, 2, 10)
    for step in range(12):
        assert float(ts(step)) == pytest.approx(float(js(jnp.int32(step))),
                                                rel=1e-6)
    rng = np.random.default_rng(0)
    g = {"a": rng.standard_normal((3, 4)).astype(np.float32),
         "b": {"c": rng.standard_normal(5).astype(np.float32)}}
    jc, jn = jopt.clip_by_global_norm(jax.tree_util.tree_map(jnp.asarray, g),
                                      1.0)
    tc, tn = topt.clip_by_global_norm(tree_lib.tree_map(torch.from_numpy, g),
                                      1.0)
    assert float(tn) == pytest.approx(float(jn), rel=1e-6)
    for a, b in zip(jax.tree_util.tree_leaves(jc), tree_lib.leaves(tc)):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-6)


def test_sgd_momentum_matches_reference():
    rng = np.random.default_rng(1)
    p = {"w": rng.standard_normal((4, 3)).astype(np.float32)}
    g = {"w": rng.standard_normal((4, 3)).astype(np.float32)}
    jo = jopt.sgd_momentum(0.1, weight_decay=0.01, nesterov=True)
    jp = jax.tree_util.tree_map(jnp.asarray, p)
    js = jo.init(jp)
    to = topt.sgd_momentum(0.1, weight_decay=0.01, nesterov=True)
    tp = tree_lib.tree_map(lambda a: torch.from_numpy(a.copy()), p)
    ts = to.init(tp)
    for step in range(3):
        jp, js = jo.update(jax.tree_util.tree_map(jnp.asarray, g), js, jp,
                           jnp.int32(step))
        tp, ts = to.update(tree_lib.tree_map(torch.from_numpy, g), ts, tp,
                           step)
    np.testing.assert_allclose(tp["w"].numpy(), np.asarray(jp["w"]),
                               rtol=1e-6, atol=1e-7)


def test_cli_runs_on_cpu(capsys):
    rc = ttrain.main(["--arch", "yi-6b", "--comm", "mlsl", "--wire", "int8",
                      "--error-feedback", "--steps", "2", "--seq", "32",
                      "--log-every", "1", "--device", "cpu"])
    assert rc == 0
    out = capsys.readouterr().out
    losses = [float(line.split()[3]) for line in out.splitlines()
              if line.startswith("step")]
    assert len(losses) == 2 and all(np.isfinite(losses))


def test_cli_defaults_to_cuda_and_raises_without_it():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ttrain.main(["--steps", "1"])


@pytest.mark.parametrize("flags", [["--model-parallel", "2", "--hier"],
                                   ["--model-parallel", "2"],
                                   ["--model-parallel", "2", "--stats"]])
def test_cli_unported_flags_raise(flags):
    """No flag of the reference's CLI is left unported: --model-parallel 2
    without --hybrid builds the reference's mesh (with --hier the 3-axis
    one of 2 x 4 x 2 ranks), whose size must match the world, here one
    process, so it raises naming both sizes (tests/test_torch_mp.py runs
    it on 8 ranks)."""
    with pytest.raises(RuntimeError, match="the mesh needs (16|2) ranks but "
                                           "the world has 1"):
        ttrain.main(flags + ["--device", "cpu", "--steps", "1"])


def test_cli_model_parallel_without_hybrid_names_the_cause():
    """A model axis larger than the world is not shrunk to fit: the error
    says how to start enough ranks."""
    with pytest.raises(RuntimeError,
                       match="the mesh needs 2 ranks but the world has 1; "
                             "start one process per rank"):
        ttrain.main(["--model-parallel", "2", "--device", "cpu"])


@pytest.mark.parametrize("flags", [["--hier"],
                                   ["--hier", "--nodes", "1", "--local", "2"],
                                   ["--data-parallel", "4"]])
def test_cli_mesh_larger_than_the_world_raises(flags):
    """One process is a world of one rank: a mesh of more ranks raises,
    naming both sizes, and is never shrunk to fit."""
    with pytest.raises(RuntimeError, match="needs [248] ranks but the world "
                                           "has 1"):
        ttrain.main(flags + ["--device", "cpu", "--steps", "1"])


def test_cli_unknown_topology_raises():
    with pytest.raises(ValueError, match="unknown topology 'nowhere'"):
        ttrain.main(["--device", "cpu", "--steps", "1", "--comm", "mlsl",
                     "--hier", "--nodes", "1", "--local", "1",
                     "--topo", "nowhere"])


def test_cli_defaults_match_the_reference():
    args = ttrain._parser().parse_args([])
    assert (args.comm, args.wire, args.nodes, args.local, args.batch,
            args.seq, args.steps, args.optimizer, args.data_parallel,
            args.model_parallel) == ("gspmd", "fp32", 2, 4, 8, 64, 100,
                                     "adamw", 1, 1)
    assert ttr.CommConfig().mode == "gspmd"
    # the spelling torchrun cannot take for an abbreviation of --local-addr
    assert ttrain._parser().parse_args(["--local-size", "2"]).local == 2


def test_cli_verify_twin_on_eight_gloo_ranks(tmp_path):
    """The verify command's twin through torchrun on 8 gloo ranks of the
    CPU: mesh ("node"=2, "local"=4), finite losses, one log per step."""
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT / "src"), os.environ.get("PYTHONPATH", "")]))
    env.pop("JAX_PLATFORMS", None)
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "8", "-m", "repro_torch.launch.train",
         "--device", "cpu", "--arch", "yi-6b", "--steps", "3", "--comm",
         "mlsl", "--wire", "int8", "--error-feedback", "--hier", "--batch",
         "8", "--seq", "32", "--log-every", "1"],
        env=env, cwd=tmp_path, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-4000:]
    out = proc.stdout
    assert "mesh={'node': 2, 'local': 4}" in out
    losses = [float(line.split()[3]) for line in out.splitlines()
              if line.startswith("step")]
    assert len(losses) == 3 and all(np.isfinite(losses)), out


OBS_ARGV = ["--arch", "yi-6b", "--comm", "mlsl", "--wire", "int8",
            "--error-feedback", "--steps", "3", "--seq", "32",
            "--log-every", "1", "--device", "cpu"]


def test_cli_observability_on_one_rank(tmp_path, monkeypatch, capsys):
    """--stats --trace --telemetry --telemetry-sample 1 on one CPU rank:
    the trace and the telemetry validate under both packages, the table's
    byte and modeled columns equal the reference's table for the same
    arguments, the ledger lands in $BENCH_DIR as
    BENCH_torch_comm_stats.json, and the run trains exactly as without the
    flags (bitwise equal final parameters)."""
    from benchmarks import common as bench_common
    import torch_cli_obs as cli_obs
    monkeypatch.setenv("BENCH_DIR", str(tmp_path / "bench"))
    obs = tmp_path / "obs"
    recs, state = ttrain.run(OBS_ARGV + [
        "--stats", "--trace", str(obs), "--telemetry", str(obs),
        "--telemetry-sample", "1"])
    out = capsys.readouterr().out
    plain, plain_state = ttrain.run(OBS_ARGV)
    assert [r.loss for r in recs] == [r.loss for r in plain]
    for a, b in zip(tree_lib.leaves(state.params),
                    tree_lib.leaves(plain_state.params)):
        assert torch.equal(a, b)
    # the reference CLI's table for the same arguments
    mesh = jmesh.make_host_mesh(1, 1)
    cfg = jreg.get_smoke_config("yi-6b")
    comm = jtr.CommConfig(mode="mlsl", wire="int8", error_feedback=True)
    want = jtr.make_comm_engine(JModel(cfg), mesh, JPlanner(mesh=mesh),
                                comm).stats()
    got = cli_obs.table_rows(out)
    assert [r[cli_obs.BYTE_COLUMNS] for r in got] == \
        [r[cli_obs.BYTE_COLUMNS] for r in cli_obs.ref_table_rows(want)]
    assert all(float(r[-1]) > 0 for r in got)
    trace = cli_obs.check_trace(obs / "trace.json")
    assert cli_obs.spans(trace) == ["step0", "step1", "step2"]
    assert len(cli_obs.spans(trace, tid=1)) == len(want.buckets)
    assert any(e["pid"] == 1 and e["ph"] == "X"
               for e in trace["traceEvents"])           # modeled schedule
    events = cli_obs.check_telemetry(obs / "telemetry.jsonl")
    steps = [e for e in events if e["kind"] == "step"]
    sampled = [e for e in events if e["kind"] == "bucket_times"]
    assert [e["loss"] for e in steps] == [r.loss for r in recs]
    assert [e["step"] for e in sampled] == [0, 1, 2]
    assert all(len(e["measured"]) == len(e["modeled"]) == len(want.buckets)
               for e in sampled)
    assert "health: no alarms" in out
    led = json.loads((tmp_path / "bench" /
                      "BENCH_torch_comm_stats.json").read_text())
    bench_common.validate_ledger(led)
    assert led["module"] == "torch_comm_stats"
    assert any(m["name"] == "comm_stats/total/total_B" for m in
               led["metrics"])


def test_cli_observability_on_gspmd(tmp_path, monkeypatch, capsys):
    """gspmd has no bucket messages: --stats says so (its ledger holds the
    meter alone), the telemetry has step records only (a step-only
    monitor), the trace its step spans."""
    import torch_cli_obs as cli_obs
    monkeypatch.setenv("BENCH_DIR", str(tmp_path / "bench"))
    obs = tmp_path / "obs"
    recs, _ = ttrain.run(["--device", "cpu", "--steps", "2", "--seq", "32",
                          "--stats", "--trace", str(obs), "--telemetry",
                          str(obs)])
    out = capsys.readouterr().out
    assert "per-bucket CommStats need --comm mlsl" in out
    events = cli_obs.check_telemetry(obs / "telemetry.jsonl")
    assert [e["kind"] for e in events] == ["meta", "step", "step"]
    assert cli_obs.spans(cli_obs.check_trace(obs / "trace.json")) == \
        ["step0", "step1"]
    assert len(recs) == 2
    led = json.loads((tmp_path / "bench" /
                      "BENCH_torch_comm_stats.json").read_text())
    assert {m["name"] for m in led["metrics"]} == {"meter/step_time_us",
                                                   "meter/tokens_per_sec"}
