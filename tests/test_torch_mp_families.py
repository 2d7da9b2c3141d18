"""Model parallelism and hybrid execution for every family of the registry,
on 8 gloo ranks, against the JAX trainer on meshes cut from the 8 virtual
devices with the same planner: minicpm3-4b (MLA), whisper-small (the
encoder and cross blocks), llava-next-mistral-7b (the image projector),
recurrentgemma-2b (RG-LRU and the local attention's gathered heads, past
its window, also on chunks of 16 keys), mamba2-2.7b (SSD), grok-1-314b (the
gather dispatch with the experts split at model 4 and each expert's ff
split at model 8, the expert-parallel dispatch over a model group of 4,
FSDP beside the model axis) and arctic-480b (the dense residual MLP); and
the hybrid plans of llava and recurrentgemma on ("node", "local") = (2, 4).
grok-1's ep dispatch on the mlsl step, which the reference's trainer
refuses (ROADMAP queue 3), is held to the port's gspmd ep run.

One group of 8 ranks is spawned once for the file
(tests/torch_mp_families_ranks.py, torch only). Each case trains 3 steps
(SGD at 0.1, data seed 3, batch 8, seq 16; recurrentgemma's 80) from the
reference's weights, with the stub patch or frame embeddings of
tests/torch_archs_ranks.py.

Tolerances (those of tests/test_torch_mp.py): losses rtol 1e-4, gradient
norms and the parameters gathered over the model group atol 1e-4 (fp32
wire; gloo sums in another order than XLA). mamba2 on the int8 + EF wire,
on which the reference aborts under a model axis (ROADMAP queue 3), is held
to the port's own fp32 run at rtol 1e-3.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro import compat
from repro.checkpoint import ckpt as jckpt
from repro.configs import registry as jreg
from repro.core import planner as jpl
from repro.data import pipeline as jpipe
from repro.launch import mesh as jmesh
from repro.models.transformer import Batch as JBatch, Model as JModel
from repro.optim import optimizers as jopt
from repro.train import trainer as jtr
from repro_torch.configs import registry as treg
from repro_torch.core import planner as tpl

import torch_spawn
from torch_archs_ranks import stub_inputs
from torch_mp_families_ranks import (BATCH, CASES, DATA_SEED, LOSSY, LR,
                                     MESHES, STEPS, TWINS)

WORLD = 8
EXACT = [n for n in CASES if n not in LOSSY and n not in TWINS]
HYBRID = [n for n in CASES if CASES[n][3] == "hybrid"]


def _jmesh(name):
    kind, *sizes = MESHES[name]
    return (jmesh.make_hier_mesh(*sizes) if kind == "hier"
            else jmesh.make_host_mesh(*sizes))


def _jplanner(kind, mesh, cfg, seq):
    if kind == "hybrid":
        return jpl.make_hybrid_planner(mesh, cfg, batch=BATCH, seq=seq)
    return jpl.Planner(mesh=mesh, fsdp=kind == "fsdp")


def _like(arch):
    return {"params": jax.tree_util.tree_map(
        lambda pd: jax.ShapeDtypeStruct(pd.shape, jnp.float32),
        JModel(jreg.get_smoke_config(arch)).param_defs(),
        is_leaf=lambda x: isinstance(x, jpl.ParamDef))}


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    path = tmp_path_factory.mktemp("families_inputs")
    params = {}
    for arch in {c[0] for c in CASES.values()}:
        params[arch] = jax.tree_util.tree_map(
            np.asarray, JModel(jreg.get_smoke_config(arch)).init(
                jax.random.PRNGKey(0)))
        jckpt.save(str(path / arch), {"params": params[arch]}, step=0)
    return path, params


@pytest.fixture(scope="module")
def port(inputs, tmp_path_factory):
    path, _ = inputs
    out = tmp_path_factory.mktemp("families_ranks")
    torch_spawn.spawn("torch_mp_families_ranks.py", WORLD,
                      tmp_path_factory.mktemp("store"), path, out,
                      timeout=900)
    res = {}
    for name, (arch, *_) in CASES.items():
        recs = [json.loads((out / name / f"rank{r}.json").read_text())
                for r in range(WORLD)]
        assert jckpt.latest_step(str(out / name / "ckpt")) == STEPS
        res[name] = (recs, jckpt.restore(str(out / name / "ckpt"),
                                         _like(arch))["params"])
    return res


def _jax_train(name, params):
    arch, mesh_name, kw, kind, seq = CASES[name]
    cfg = jreg.get_smoke_config(arch)
    mesh = _jmesh(mesh_name)
    model = JModel(cfg)
    opt = jopt.make_optimizer("sgd", LR)
    dcfg = jpipe.DataConfig(vocab=cfg.vocab, seq_len=seq, global_batch=BATCH,
                            seed=DATA_SEED)
    with compat.set_mesh(mesh):
        p = jax.tree_util.tree_map(jnp.asarray, params)
        state = jtr.TrainState(params=p, opt_state=opt.init(p),
                               step=jnp.zeros((), jnp.int32))
        step = jax.jit(jtr.make_train_step(
            model, opt, mesh, _jplanner(kind, mesh, cfg, seq),
            jtr.CommConfig(**kw)))
        metrics = []
        for s, raw in enumerate(jpipe.iterate(dcfg, STEPS)):
            stub = {k: jnp.asarray(v)
                    for k, v in stub_inputs(cfg, BATCH, s).items()}
            b = JBatch(tokens=jnp.asarray(raw["tokens"]),
                       labels=jnp.asarray(raw["labels"]), **stub)
            state, m = step(state, b)
            metrics.append((float(m["loss"]), float(m["grad_norm"])))
    return metrics, jax.tree_util.tree_map(np.asarray, state.params)


@pytest.fixture(scope="module")
def ref(inputs, port):
    _, params = inputs
    return {name: _jax_train(name, params[CASES[name][0]])
            for name in EXACT}


def _replicated(recs):
    for r in recs[1:]:               # the loss is the pmean: replicated
        assert r["loss"] == recs[0]["loss"]
        assert r["grad_norm"] == recs[0]["grad_norm"]
    assert all(np.isfinite(recs[0]["loss"] + recs[0]["grad_norm"]))


@pytest.mark.parametrize("name", EXACT)
def test_losses_and_grad_norms_match_jax_trainer(port, ref, name):
    recs, _ = port[name]
    _replicated(recs)
    metrics, _ = ref[name]
    np.testing.assert_allclose(recs[0]["loss"], [m[0] for m in metrics],
                               rtol=1e-4)
    np.testing.assert_allclose(recs[0]["grad_norm"], [m[1] for m in metrics],
                               rtol=0, atol=1e-4)


@pytest.mark.parametrize("name", EXACT)
def test_gathered_params_match_jax_trainer(port, ref, name):
    """Every leaf after 3 steps within atol 1e-4: a gradient summed over
    the model group once too often or not at all (a replicated leaf feeding
    sharded work, the load-balance term) scales it by the group size."""
    _, final = port[name]
    _, want = ref[name]
    got = jax.tree_util.tree_leaves_with_path(final)
    want = jax.tree_util.tree_leaves(want)
    assert len(got) == len(want)
    for (path, a), b in zip(got, want):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=1e-4,
                                   err_msg=jax.tree_util.keystr(path))


@pytest.mark.parametrize("name", list(LOSSY))
def test_lossy_wire_stays_near_the_fp32_run(port, name):
    recs, _ = port[name]
    _replicated(recs)
    np.testing.assert_allclose(recs[0]["loss"], port[LOSSY[name]][0][0]
                               ["loss"], rtol=1e-3)


@pytest.mark.parametrize("name", list(TWINS))
def test_cases_the_reference_cannot_run_match_the_port_twin(port, name):
    """grok-1's ep dispatch on the mlsl step, which the reference's trainer
    refuses (a shard_map inside its mlsl shard_map: "The context mesh ...
    should match the mesh passed to shard_map"), against the port's gspmd
    ep run on the same mesh (itself held to the reference): the same
    routing, the gradient sums in another order. Losses rtol 1e-4,
    gradient norms and parameters atol 1e-4."""
    recs, final = port[name]
    _replicated(recs)
    twin_recs, twin = port[TWINS[name]]
    np.testing.assert_allclose(recs[0]["loss"], twin_recs[0]["loss"],
                               rtol=1e-4)
    np.testing.assert_allclose(recs[0]["grad_norm"],
                               twin_recs[0]["grad_norm"], rtol=0, atol=1e-4)
    for a, b in zip(jax.tree_util.tree_leaves(final),
                    jax.tree_util.tree_leaves(twin)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=1e-4)


@pytest.mark.parametrize("name", list(CASES))
def test_ranks_restore_their_shards_bitwise(port, name):
    recs, _ = port[name]
    for r in recs:
        assert r["restores_bitwise"]


@pytest.mark.parametrize("name,e_loc,ff_loc", [
    ("grok_gather_gspmd_2x4", 1, 256), ("grok_ep_gspmd_2x4", 1, 256),
    ("grok_ep_mlsl_2x4", 1, 256),
    ("grok_gather_gspmd_1x8", 4, 32), ("grok_fsdp_gspmd_4x2", 2, 256)])
def test_grok_experts_split_at_e_or_ff(port, name, e_loc, ff_loc):
    """4 experts of ff 256: at model 4 one expert a rank, at model 8 every
    expert's ff in eighths (w1/w3 by column, w2 by row), at model 2 beside
    FSDP over 4 data ranks two experts a rank with d in quarters."""
    recs, _ = port[name]
    d = 256 // (4 if CASES[name][3] == "fsdp" else 1)
    for r in recs:
        shapes = r["local_shapes"]
        assert shapes["blocks/p0_moe/moe/w1"] == [2, e_loc, d, ff_loc]
        assert shapes["blocks/p0_moe/moe/w3"] == [2, e_loc, d, ff_loc]
        assert shapes["blocks/p0_moe/moe/w2"] == [2, e_loc, ff_loc, d]
        assert shapes["blocks/p0_moe/moe/router"] == [2, 256, 4]


@pytest.mark.parametrize("name", HYBRID)
def test_hybrid_plans_equal_reference_layer_by_layer(name):
    """The C2C chooser's verdict and what executes, layer by layer: llava's
    attention layer model-parallel over "local", recurrentgemma's every
    layer data-parallel (its one KV head does not split over 4)."""
    arch, mesh_name, _, _, seq = CASES[name]
    _, node, local = MESHES[mesh_name]
    tplan = tpl.plan_hybrid(treg.get_smoke_config(arch),
                            {"node": node, "local": local}, batch=BATCH,
                            seq=seq)
    jplan = jpl.plan_hybrid(jreg.get_smoke_config(arch), _jmesh(mesh_name),
                            batch=BATCH, seq=seq)

    def rows(plan):
        return [(lp.name, lp.kind, lp.executed, lp.reason,
                 lp.choice.strategy.value, lp.choice.group_size,
                 lp.choice.ratio, lp.choice.comm_bytes)
                for lp in plan.layers]
    assert rows(tplan) == rows(jplan)
    assert (tplan.tp_axis, tplan.tp, tplan.dp, tplan.data_axes) == \
        (jplan.tp_axis, jplan.tp, jplan.dp, tuple(jplan.data_axes))
    assert tplan.any_model_parallel == (arch == "llava-next-mistral-7b")
