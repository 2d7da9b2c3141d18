"""The port's `Session` facade and FSDP planning against the reference.

* The reference's end-to-end pipeline (`tests/test_system.py`: Session ->
  train -> save -> restore -> serve) on the port, on yi-6b's smoke config
  from the reference's weights: the first 10 of the 20 steps' losses
  within rtol 1e-4 of the reference's (the mlsl bf16 wire at one rank;
  sums in another order), all 20 within rtol 1e-3 (AdamW at 3e-3 lets the
  two trajectories drift apart), the checkpoint restored bit for bit,
  greedy tokens equal.
* `decide_fsdp`/`make_planner` equal to the reference's over a grid of
  parameter counts, model-axis sizes, train/serve and budgets.
* `Planner(fsdp=True).spec_for` equal to the reference's for every leaf of
  the ten smoke configs on meshes (8, 1), (4, 2) and make_hier_mesh(2, 4).
* The Session's other surfaces (comm, comm_engine, param_shardings,
  layer_strategies, wire_savings) beside the reference's.
* At one rank, the FSDP gspmd step equals the replicated gspmd step bit for
  bit (the gathers and reduce-scatters over a group of one copy), under
  remat with two microbatches, and on grok-1's moe blocks also on the
  expert-parallel dispatch; mlsl under FSDP raises.
* `examples/quickstart_torch.py` on the CPU at a few steps.

The multi-rank FSDP cases run in tests/test_torch_mp.py's spawned group.
"""

import dataclasses
import importlib.util
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from repro import compat
from repro.checkpoint import ckpt as jckpt
from repro.configs import registry as jreg
from repro.core import c2c as jc2c
from repro.core import planner as jpl
from repro.core.api import Session as JSession
from repro.data import pipeline as jpipe
from repro.launch import mesh as jmesh
from repro.models.transformer import Batch as JBatch, Model as JModel
from repro.optim import optimizers as jopt
from repro.serve.engine import Engine as JEngine, EngineConfig as JEngineCfg
from repro.train import trainer as jtr
from repro_torch import convert, tree as tree_lib
from repro_torch.checkpoint import ckpt as tckpt
from repro_torch.configs import registry as treg
from repro_torch.core import c2c as tc2c
from repro_torch.core import planner as tpl
from repro_torch.core.api import Session as TSession
from repro_torch.data import pipeline as tpipe
from repro_torch.launch import mesh as tmesh
from repro_torch.launch.train import stub_embeds
from repro_torch.models.transformer import Batch as TBatch, Model as TModel
from repro_torch.optim import optimizers as topt
from repro_torch.serve.engine import Engine as TEngine, EngineConfig as TEngineCfg
from repro_torch.train import trainer as ttr

ROOT = pathlib.Path(__file__).resolve().parents[1]
PIPE_STEPS = 20
PIPE_CLOSE = 10         # the steps held at rtol 1e-4 (all 20: rtol 1e-3)
PIPE_DATA = dict(seq_len=32, global_batch=4)

# mesh name -> (the reference's mesh, the port's axis sizes)
MESHES = {"8x1": (lambda: jmesh.make_host_mesh(8, 1),
                  {"data": 8, "model": 1}),
          "4x2": (lambda: jmesh.make_host_mesh(4, 2),
                  {"data": 4, "model": 2}),
          "hier2x4": (lambda: jmesh.make_hier_mesh(2, 4),
                      {"node": 2, "local": 4})}


# ---------------------------------------------------------------------------
# the reference's test_system pipeline on both packages
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def pipeline_ref(tmp_path_factory):
    """The reference's pipeline: its initial weights, every step's loss,
    and the greedy tokens of the restored model."""
    mesh = compat.make_mesh((1, 1), ("data", "model"),
                            axis_types=(compat.AxisType.Auto,) * 2)
    cfg = jreg.get_smoke_config("yi-6b")
    model = JModel(cfg)
    sess = JSession.create(mesh, n_params=model.n_params(),
                           comm=jtr.CommConfig(mode="mlsl", wire="bf16"))
    opt = jopt.adamw(3e-3)
    dcfg = jpipe.DataConfig(vocab=cfg.vocab, **PIPE_DATA)
    with compat.set_mesh(mesh):
        state = jtr.make_train_state(model, opt, jax.random.PRNGKey(0))
        init = jax.tree_util.tree_map(np.asarray, state.params)
        step = jax.jit(sess.make_train_step(model, opt))
        losses = []
        for raw in jpipe.iterate(dcfg, PIPE_STEPS):
            b = JBatch(tokens=jnp.asarray(raw["tokens"]),
                       labels=jnp.asarray(raw["labels"]))
            state, m = step(state, b)
            losses.append(float(m["loss"]))
    d = jckpt.save(str(tmp_path_factory.mktemp("jck") / "ck"),
                   {"params": state.params}, step=PIPE_STEPS)
    restored = jckpt.restore(d, {"params": state.params})["params"]
    tokens = JEngine(model, restored, JEngineCfg(max_seq=48)).generate(
        np.zeros((2, 4), np.int32), 5)
    return init, losses, np.asarray(tokens), sess.wire_savings()


def test_session_pipeline_matches_reference(pipeline_ref, tmp_path):
    init, want_losses, want_tokens, want_savings = pipeline_ref
    mesh = tmesh.make_host_mesh(1, 1, device="cpu")
    cfg = treg.get_smoke_config("yi-6b")
    model = TModel(cfg)
    sess = TSession.create(mesh, n_params=model.n_params(),
                           comm=ttr.CommConfig(mode="mlsl", wire="bf16"))
    assert not sess.planner.fsdp
    opt = topt.adamw(3e-3)
    state = ttr.train_state_from_params(
        convert.params_from_jax(init, device="cpu"), opt, model=model,
        planner=sess.planner)
    step = sess.make_train_step(model, opt)
    losses = []
    for raw in tpipe.iterate(tpipe.DataConfig(vocab=cfg.vocab, **PIPE_DATA),
                             PIPE_STEPS):
        state, m = step(state, TBatch(tokens=torch.from_numpy(raw["tokens"]),
                                      labels=torch.from_numpy(raw["labels"])))
        losses.append(float(m["loss"]))
    # AdamW's normalized update turns summation-order differences of f32
    # gradients into whole steps of near-zero elements: the first 12 steps
    # agree within 1.5e-5, and by step 19 the trajectories are up to
    # 6.7e-4 apart (4.0e-4 on the fp32 wire too)
    np.testing.assert_allclose(losses[:PIPE_CLOSE], want_losses[:PIPE_CLOSE],
                               rtol=1e-4)
    np.testing.assert_allclose(losses, want_losses, rtol=1e-3)
    assert losses[-1] < losses[0] - 0.2

    d = tckpt.save(str(tmp_path / "ck"), {"params": state.params},
                   step=PIPE_STEPS)
    restored = tckpt.restore(d, {"params": state.params})["params"]
    for a, b in zip(tree_lib.leaves(state.params), tree_lib.leaves(restored)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    out = TEngine(model, restored, TEngineCfg(max_seq=48)).generate(
        np.zeros((2, 4), np.int32), 5)
    assert out.shape == (2, 5)
    np.testing.assert_array_equal(out, want_tokens)
    assert sess.wire_savings() == want_savings > 1.5


# ---------------------------------------------------------------------------
# FSDP planning
# ---------------------------------------------------------------------------

def test_decide_fsdp_and_make_planner_equal_reference():
    meshes = {m: (MESHES[m][0](), MESHES[m][1]) for m in MESHES}
    for n in (0.0, 1.3e6, 1.2e9, 6.06e9, 21.3e9, 314e9):
        for model_size in (1, 2, 8):
            for train in (True, False):
                for budget in (1e3, 16e9, 80e9, 85.0e9):
                    kw = dict(train=train, hbm_budget=budget)
                    assert tpl.decide_fsdp(n, model_size, **kw) == \
                        jpl.decide_fsdp(n, model_size, **kw), (n, model_size,
                                                              kw)
        for name, (jm, tm) in meshes.items():
            for budget in (1e3, 16e9, 80e9):
                t = tpl.make_planner(tm, n, hbm_budget=budget)
                j = jpl.make_planner(jm, n, hbm_budget=budget)
                assert (t.fsdp, t.batch_axes, t.model_size,
                        t.batch_size_total) == (
                    j.fsdp, tuple(j.batch_axes), j.model_size,
                    j.batch_size_total), (name, n, budget)
    # yi-6b on one card of 80 GB: the 4-layer cells replicate, the whole
    # model (6.06 B parameters, 85 GB of state) shards
    assert not tpl.decide_fsdp(1.216e9, 1, hbm_budget=80e9)
    assert tpl.decide_fsdp(1.216e9, 1)
    assert tpl.decide_fsdp(6.06e9, 1, hbm_budget=80e9)


def _spec_leaves(jspecs):
    return [(tuple(k.key for k in path), tuple(s)) for path, s in
            jax.tree_util.tree_leaves_with_path(
                jspecs, is_leaf=lambda s: isinstance(s, P))]


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", treg.ARCH_IDS)
def test_fsdp_specs_equal_reference(arch, mesh_name):
    """Every leaf's spec under Planner(fsdp=True), and `fsdp_dims` naming
    the dimension and axes each spec splits over the batch axes."""
    jm_fn, sizes = MESHES[mesh_name]
    tp_ = tpl.Planner(mesh=sizes, fsdp=True)
    jp_ = jpl.Planner(mesh=jm_fn(), fsdp=True)
    tm, jm = TModel(treg.get_smoke_config(arch)), JModel(
        jreg.get_smoke_config(arch))
    specs = tp_.tree_specs(tm.param_defs(), stacked_paths=TModel.stacked_path)
    jspecs = jp_.tree_specs(jm.param_defs(),
                            stacked_paths=JModel.stacked_path)
    assert tree_lib.leaves_with_paths(specs) == _spec_leaves(jspecs)
    dims = tp_.fsdp_dims(tm.param_defs(), stacked_paths=TModel.stacked_path)
    n_split = 0
    for (path, spec), d in zip(tree_lib.leaves_with_paths(specs),
                               tree_lib.leaves(dims)):
        want = [(i - len(spec), a if isinstance(a, tuple) else (a,))
                for i, a in enumerate(spec)
                if a is not None and a != "model"]
        assert d == (want[0] if want else None), path
        n_split += d is not None
    assert n_split > 0


# ---------------------------------------------------------------------------
# the Session's surfaces
# ---------------------------------------------------------------------------

def test_session_surfaces_beside_reference():
    """comm over the data axes (two-level on a ("node", "local") mesh),
    the engine's bucket plan, the spec tree, the per-layer strategy table
    and the wire saving, each as the reference's Session gives them."""
    cfg_t, cfg_j = (treg.get_smoke_config("yi-6b"),
                    jreg.get_smoke_config("yi-6b"))
    tm, jm = TModel(cfg_t), JModel(cfg_j)
    mesh = tmesh.make_hier_mesh(1, 1, device="cpu")
    jmesh_ = jmesh.make_hier_mesh(1, 1)
    comm = dict(mode="mlsl", wire="int8", hier=True)
    ts = TSession.create(mesh, n_params=tm.n_params(),
                         comm=ttr.CommConfig(**comm))
    js = JSession.create(jmesh_, n_params=jm.n_params(),
                         comm=jtr.CommConfig(**comm))
    tc, jc = ts.comm, js.comm
    assert (tc.data_axes, tc.node_axis, tc.local_axis, tc.hierarchical) == (
        tuple(jc.data_axes), jc.node_axis, jc.local_axis, jc.hierarchical)
    teng, jeng = ts.comm_engine(tm), js.comm_engine(jm)
    assert (teng.plan.fusable, teng.plan.algos, teng.plan.n_buckets) == (
        jeng.plan.fusable, jeng.plan.algos, jeng.plan.n_buckets)
    # the reference's NamedShardings need every spec axis in the mesh (its
    # planner names "model" on a mesh without one), so the trees are
    # compared on the (1, 1) host mesh
    ts11 = TSession.create(tmesh.make_host_mesh(1, 1, device="cpu"),
                           n_params=tm.n_params())
    js11 = JSession.create(jmesh.make_host_mesh(1, 1), n_params=jm.n_params())
    assert tree_lib.leaves_with_paths(ts11.param_shardings(tm)) == [
        (tuple(k.key for k in path), tuple(s.spec)) for path, s in
        jax.tree_util.tree_leaves_with_path(
            js11.param_shardings(jm),
            is_leaf=lambda x: isinstance(x, jax.sharding.NamedSharding))]
    tl = tc2c.layers_from_model_config(cfg_t, 32)
    jl = jc2c.layers_from_model_config(cfg_j, 32)
    got = [(r.name, r.kind, r.choice.strategy.value, r.choice.group_size)
           for r in ts.layer_strategies(tl, 8)]
    want = [(r.name, r.kind, r.choice.strategy.value, r.choice.group_size)
            for r in js.layer_strategies(jl, 8)]
    assert got == want and got
    assert ts.wire_savings() == js.wire_savings()


# ---------------------------------------------------------------------------
# FSDP at one rank: the replicated step's bits
# ---------------------------------------------------------------------------

def _run(model, sess, steps=3, batch=4, seq=16):
    opt = topt.adamw(1e-3)
    state = ttr.make_train_state(model, opt, torch.Generator().manual_seed(0),
                                 "cpu", planner=sess.planner)
    step = sess.make_train_step(model, opt)
    dcfg = tpipe.DataConfig(vocab=model.cfg.vocab, seq_len=seq,
                            global_batch=batch, seed=0)
    metrics = []
    for raw in tpipe.iterate(dcfg, steps):
        state, m = step(state, TBatch(
            tokens=torch.from_numpy(raw["tokens"]),
            labels=torch.from_numpy(raw["labels"]),
            **stub_embeds(model.cfg, batch, "cpu")))
        metrics.append((float(m["loss"]), float(m["grad_norm"])))
    full = convert.gather_params(state.params,
                                 ttr.param_specs(model, sess.planner),
                                 sess.mesh)
    return metrics, full, state


ONE_RANK = {"yi-6b_remat_accum2": ("yi-6b", dict(accum_steps=2)),
            "grok-1_remat_ep": ("grok-1-314b", dict(moe_impl="ep"))}


@pytest.mark.parametrize("case", list(ONE_RANK))
def test_fsdp_at_one_rank_is_the_replicated_step(case):
    """Under remat (each repeat's gather inside its checkpoint) the FSDP
    step's losses, gradient norms and parameters equal the replicated
    gspmd step's bit for bit; the state holds the split leaves, and the
    gradients come back through the reduce-scatter."""
    arch, kw = ONE_RANK[case]
    model = TModel(dataclasses.replace(treg.get_smoke_config(arch),
                                       remat=True))
    mesh = tmesh.make_host_mesh(1, 1, device="cpu")
    comm = ttr.CommConfig(mode="gspmd", **kw)
    rep = TSession.create(mesh, n_params=model.n_params(), comm=comm,
                          hbm_budget=1e12)
    fsdp = TSession.create(mesh, n_params=model.n_params(), comm=comm,
                           hbm_budget=1e3)
    assert not rep.planner.fsdp and fsdp.planner.fsdp
    want, want_params, _ = _run(model, rep)
    got, got_params, state = _run(model, fsdp)
    assert got == want
    for a, b in zip(tree_lib.leaves(got_params), tree_lib.leaves(want_params)):
        assert torch.equal(a, b)
    splits = tree_lib.leaves(fsdp.planner.fsdp_dims(
        model.param_defs(), stacked_paths=TModel.stacked_path))
    assert sum(s is not None for s in splits) >= 9
    assert all(s is None for s, (p, _) in zip(
        splits, tree_lib.leaves_with_paths(state.params)) if "ln1" in p)


def test_mlsl_and_hybrid_refuse_fsdp():
    model = TModel(treg.get_smoke_config("yi-6b"))
    mesh = tmesh.make_host_mesh(1, 1, device="cpu")
    sess = TSession.create(mesh, n_params=model.n_params(),
                           comm=ttr.CommConfig(mode="mlsl"), hbm_budget=1e3)
    assert sess.planner.fsdp
    with pytest.raises(ValueError, match=r"comm=mlsl .*\(non-FSDP\)"):
        sess.make_train_step(model, topt.adamw(1e-3))
    hybrid = tpl.make_hybrid_planner(tmesh.make_hier_mesh(1, 1, device="cpu"),
                                     model.cfg, batch=8, seq=32)
    hybrid.fsdp = True          # the hybrid step runs on mlsl only
    with pytest.raises(ValueError, match=r"comm=mlsl .*\(non-FSDP\)"):
        ttr.make_train_step(model, topt.adamw(1e-3), hybrid.mesh, hybrid,
                            ttr.CommConfig(mode="mlsl"))


def test_quickstart_example_runs_on_the_cpu():
    spec = importlib.util.spec_from_file_location(
        "quickstart_torch", ROOT / "examples" / "quickstart_torch.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    losses, out = mod.main(["--device", "cpu", "--steps", "3"])
    assert len(losses) == 3 and np.isfinite(losses).all()
    assert out.shape == (2, 8)
