"""The port's executed hybrid (data x model) parallelism on 8 gloo ranks,
("node"=2, "local"=4), against the JAX package on mesh8: every case of
tests/test_hybrid.py, plus the JAX hybrid trainer itself.

One group of 8 ranks is spawned once for the file (tests/torch_hybrid_ranks.py,
torch only). It runs the f/g operators around a column-sharded w1 and a
row-sharded w2, then two steps (lr 0.1, data seed 3, batch 8, seq 16) of
seven cases from converted weights: with SGD, the smoke config and the
indivisible-heads config (every layer falls back to DP), each under the
default planner (DP) and under the hybrid planner, and the smoke config's
hybrid step on the int8 wire with 2 microbatches; and the smoke config's
hybrid step with LARS and with LAMB (per-leaf norms of the local shards on
both sides).

Tolerances: the f/g ops against the dense single-rank JAX gradient, atol
1e-4 (f32, as the reference's test); tp_psum_scatter against tp_psum, rtol
1e-6. Against the JAX trainer on mesh8: losses and gradient norms rtol 1e-4
(sums in another order on gloo than on XLA; the int8 case 1e-3, as
tests/test_torch_train_hier.py), gathered parameters atol 1e-4 (fp32
wire). The port's hybrid against the port's DP: the reference's own atol
5e-4 on the loss and 1e-4 on the parameters.
"""

import dataclasses
import json
import math
import os
import pathlib
import re
import subprocess
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from repro import compat
from repro.checkpoint import ckpt as jckpt
from repro.configs import registry as jreg
from repro.core import collectives as jcl
from repro.core import planner as jpl
from repro.data import pipeline as jpipe
from repro.models.transformer import Batch as JBatch, Model as JModel
from repro.optim import optimizers as jopt
from repro.train import trainer as jtr
from repro_torch import convert, tree as tree_lib
from repro_torch.checkpoint import ckpt as tckpt
from repro_torch.core import planner as tpl
from repro_torch.models.transformer import Model as TModel
from repro_torch.optim import optimizers as topt
from repro_torch.train import trainer as ttr

import torch_spawn
from torch_hybrid_ranks import (BATCH, CASES, CONFIGS, DATA_SEED, LR,
                                OPTIMIZERS, SEQ, STEPS)

ROOT = pathlib.Path(__file__).resolve().parents[1]
WORLD = 8
AXES = {"node", "local"}
HIER8 = {"node": 2, "local": 4}
# the (2, 4) hier mesh's shape and no ranks: an engine plan needs only that
FAKE8 = types.SimpleNamespace(mesh_dim_names=("node", "local"), shape=(2, 4),
                              device_type="cpu", get_group=lambda a: a)


def _jcfg(name):
    cfg = jreg.get_smoke_config("yi-6b")
    if name == "indivisible":
        cfg = dataclasses.replace(
            cfg, attn=dataclasses.replace(cfg.attn, n_heads=2, n_kv=2))
    return cfg


def _amesh():
    return compat.abstract_mesh((2, 4), ("node", "local"))


# ---------------------------------------------------------------------------
# the 8 ranks and the reference
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    path = tmp_path_factory.mktemp("hybrid_inputs")
    rng = np.random.default_rng(0)
    fg = {"x": rng.standard_normal((4, 8)).astype(np.float32),
          "w1": (0.1 * rng.standard_normal((8, 16))).astype(np.float32),
          "w2": (0.1 * rng.standard_normal((16, 8))).astype(np.float32),
          "v": rng.standard_normal((2, 8)).astype(np.float32)}
    np.savez(path / "fg.npz", **fg)
    params = {}
    for name in CONFIGS:
        params[name] = jax.tree_util.tree_map(
            np.asarray, JModel(_jcfg(name)).init(jax.random.PRNGKey(0)))
        jckpt.save(str(path / name), {"params": params[name]}, step=0)
    return path, fg, params


@pytest.fixture(scope="module")
def port(inputs, tmp_path_factory):
    """{"fg": [per-rank npz], case: ([rank records], final full params of
    the gathered checkpoint, read back by the reference's ckpt.restore)}."""
    path, _, params = inputs
    out = tmp_path_factory.mktemp("hybrid_ranks")
    torch_spawn.spawn("torch_hybrid_ranks.py", WORLD,
                      tmp_path_factory.mktemp("store"), path, out,
                      timeout=150)
    res = {"fg": [dict(np.load(out / "fg" / f"rank{r}.npz"))
                  for r in range(WORLD)]}
    for name, (cfg_name, _, _) in CASES.items():
        recs = [json.loads((out / name / f"rank{r}.json").read_text())
                for r in range(WORLD)]
        like = {"params": jax.tree_util.tree_map(
            lambda a: jax.ShapeDtypeStruct(a.shape, a.dtype),
            params[cfg_name])}
        final = jckpt.restore(str(out / name / "ckpt"), like)["params"]
        assert jckpt.latest_step(str(out / name / "ckpt")) == STEPS
        res[name] = (recs, final, out / name / "ckpt")
    return res


def _jax_train(mesh, cfg, planner, params, comm_kw, optimizer="sgd"):
    """tests/test_hybrid.py's _train, from the given weights."""
    model = JModel(cfg)
    opt = jopt.make_optimizer(optimizer, LR)
    comm = jtr.CommConfig(**comm_kw)
    dcfg = jpipe.DataConfig(vocab=cfg.vocab, seq_len=SEQ, global_batch=BATCH,
                            seed=DATA_SEED)
    with compat.set_mesh(mesh):
        p = jax.tree_util.tree_map(jnp.asarray, params)
        state = jtr.TrainState(params=p, opt_state=opt.init(p),
                               step=jnp.zeros((), jnp.int32))
        step = jax.jit(jtr.make_train_step(model, opt, mesh, planner, comm))
        metrics = []
        for raw in jpipe.iterate(dcfg, STEPS):
            b = JBatch(tokens=jnp.asarray(raw["tokens"]),
                       labels=jnp.asarray(raw["labels"]))
            state, m = step(state, b)
            metrics.append((float(m["loss"]), float(m["grad_norm"])))
    return metrics, jax.tree_util.tree_map(np.asarray, state.params)


@pytest.fixture(scope="module")
def ref(inputs, mesh8):
    _, _, params = inputs
    out = {}
    for name, (cfg_name, hybrid, kw) in CASES.items():
        cfg = _jcfg(cfg_name)
        planner = (jpl.make_hybrid_planner(mesh8, cfg, batch=BATCH, seq=SEQ)
                   if hybrid else jpl.Planner(mesh=mesh8))
        out[name] = _jax_train(mesh8, cfg, planner, params[cfg_name], kw,
                               OPTIMIZERS.get(name, "sgd"))
    return out


def _coords(rank):
    return divmod(rank, 4)           # (node, local) of make_hier_mesh(2, 4)


# ---------------------------------------------------------------------------
# f/g activation collectives
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("g_op", ["psum", "scatter"])
def test_fg_ops_match_dense_reference(port, inputs, g_op):
    """Column-sharded w1 / row-sharded w2 through tp_replicate (f) and
    tp_psum or tp_psum_scatter (g) reproduces the dense forward AND all
    gradients, gathered over the local ranks."""
    _, fg, _ = inputs

    def dense_loss(w1, w2, x):
        return jnp.sum(jax.nn.relu(x @ w1) @ w2)

    ref_loss = dense_loss(fg["w1"], fg["w2"], fg["x"])
    d1, d2, dx = jax.grad(dense_loss, argnums=(0, 1, 2))(
        fg["w1"], fg["w2"], fg["x"])
    outs = port["fg"]
    for node in range(2):
        rows = [outs[node * 4 + l] for l in range(4)]
        g1 = np.concatenate([o[f"{g_op}_g1"] for o in rows], axis=1)
        g2 = np.concatenate([o[f"{g_op}_g2"] for o in rows], axis=0)
        np.testing.assert_allclose(g1, np.asarray(d1), atol=1e-4)
        np.testing.assert_allclose(g2, np.asarray(d2), atol=1e-4)
        for o in rows:
            np.testing.assert_allclose(o[f"{g_op}_loss"], np.asarray(ref_loss),
                                       atol=1e-4)
            np.testing.assert_allclose(o[f"{g_op}_gx"], np.asarray(dx),
                                       atol=1e-4)


def test_tp_psum_scatter_matches_tp_psum(port, inputs, mesh8):
    """The bandwidth-shaped psum (reduce-scatter + all-gather over the
    trailing dim) is numerically the plain psum, the reference's too, and
    a trailing dimension that does not divide raises naming the quantum."""
    _, fg, _ = inputs

    def run(op):
        def inner(v):
            r = jax.lax.axis_index("local").astype(jnp.float32)
            return op(v * (1.0 + r), "local")
        return compat.shard_map(inner, mesh=mesh8, in_specs=P(),
                                out_specs=P(), axis_names=AXES,
                                check_vma=False)(fg["v"])

    with compat.set_mesh(mesh8):
        want = np.asarray(run(jcl.tp_psum))
    for o in port["fg"]:
        np.testing.assert_allclose(o["scatter_v"], o["psum_v"], rtol=1e-6)
        np.testing.assert_allclose(o["psum_v"], want, rtol=1e-6)
        np.testing.assert_array_equal(o["tpcomm_v"], o["scatter_v"])
        assert int(o["tpcomm_size"]) == 4
        assert "group size 4" in str(o["quantum_error"])


# ---------------------------------------------------------------------------
# plan gating: chooser verdict -> executed sharding
# ---------------------------------------------------------------------------

def _smoke():
    from repro_torch.configs import registry as treg
    return treg.get_smoke_config("yi-6b")


def _indivisible():
    cfg = _smoke()
    return dataclasses.replace(
        cfg, attn=dataclasses.replace(cfg.attn, n_heads=2, n_kv=2))


def test_plan_hybrid_verdicts_match_execution():
    plan = tpl.plan_hybrid(_smoke(), HIER8, batch=8, seq=64)
    assert plan.tp == 4 and plan.dp == 2 and plan.data_axes == ("node",)
    blk = plan.layer("p0_attn")
    assert blk.choice.strategy.value in ("hybrid", "model")
    assert blk.model_parallel and blk.reason == ""
    for name in ("embed", "head"):
        lp = plan.layer(name)
        assert not lp.model_parallel
        assert lp.reason in ("chooser-data",) or \
            lp.reason.startswith("unsupported-kind")
    assert plan.any_model_parallel
    with pytest.raises(KeyError):
        plan.layer("p9_attn")


def _spec_leaves(jspecs):
    return [(tuple(k.key for k in path), tuple(s)) for path, s in
            jax.tree_util.tree_leaves_with_path(
                jspecs, is_leaf=lambda s: isinstance(s, P))]


def _hybrid_specs(cfg_t, cfg_j, **kw):
    tp_ = tpl.make_hybrid_planner(HIER8, cfg_t, batch=8, seq=64, **kw)
    jp_ = jpl.make_hybrid_planner(_amesh(), cfg_j, batch=8, seq=64, **kw)
    return (tp_.tree_specs(TModel(cfg_t).param_defs(),
                           stacked_paths=TModel.stacked_path),
            jp_.tree_specs(JModel(cfg_j).param_defs(),
                           stacked_paths=JModel.stacked_path))


def test_hybrid_planner_emits_sharded_specs():
    """The chooser's model-parallel verdict becomes the reference's specs,
    leaf by leaf: attention and MLP projections shard over "local",
    everything else replicates."""
    specs, jspecs = _hybrid_specs(_smoke(), _jcfg("smoke"))
    assert tree_lib.leaves_with_paths(specs) == _spec_leaves(jspecs)
    attn = specs["blocks"]["p0_attn"]["attn"]
    assert attn["wq"] == (None, None, "local")     # stacked: leading layer
    assert attn["wo"] == (None, "local", None)
    mlp = specs["blocks"]["p0_attn"]["mlp"]
    assert mlp["w1"] == (None, None, "local")
    assert mlp["w2"] == (None, "local", None)
    assert specs["embed"] == (None, None)
    assert specs["head"] == (None, None)


@pytest.mark.parametrize("g", [2, 3])
def test_group_indivisible_falls_back_to_dp(g):
    plan = tpl.plan_hybrid(_smoke(), HIER8, batch=8, seq=64, group_size=g)
    assert not plan.any_model_parallel, g
    assert any(lp.reason.startswith("group-indivisible")
               for lp in plan.layers), g
    specs, jspecs = _hybrid_specs(_smoke(), _jcfg("smoke"), group_size=g)
    assert tree_lib.leaves_with_paths(specs) == _spec_leaves(jspecs)
    for spec in tree_lib.leaves(specs):
        assert all(ax is None for ax in spec), (g, spec)


def test_indivisible_heads_fall_back_to_dp():
    plan = tpl.plan_hybrid(_indivisible(), HIER8, batch=8, seq=64)
    assert not plan.any_model_parallel
    lp = plan.layer("p0_attn")
    if lp.choice.group_size > 1:          # chooser wanted the group anyway
        assert lp.reason.startswith("indivisible-heads")
    specs, jspecs = _hybrid_specs(_indivisible(), _jcfg("indivisible"))
    assert tree_lib.leaves_with_paths(specs) == _spec_leaves(jspecs)


def test_c2c_layer_names_match_param_tree():
    from repro_torch.core import c2c
    cfg = _smoke()
    defs = TModel(cfg).param_defs()
    valid = {"embed", "head"} | set(defs.get("blocks", {})) \
        | set(defs.get("tail", {}))
    for spec in c2c.layers_from_model_config(cfg, 64):
        assert spec.name in valid, spec.name


# ---------------------------------------------------------------------------
# engine: per-bucket reduce axes
# ---------------------------------------------------------------------------

def _bucket_paths(plan):
    return [[tuple(plan.buckets.paths[i]) for i in b.leaf_ids]
            for b in plan.buckets.buckets]


def _jax_bucket_paths(plan):
    leaves = jax.tree_util.tree_leaves_with_path(
        jax.tree_util.tree_unflatten(plan.buckets.treedef,
                                     [0] * plan.buckets.treedef.num_leaves))
    paths = [tuple(k.key for k in path) for path, _ in leaves]
    return [[paths[i] for i in b.leaf_ids] for b in plan.buckets.buckets]


def _engines(mesh8, cfg_name="smoke", **comm):
    comm = {"mode": "mlsl", "hier": True, **comm}
    tcfg = _smoke() if cfg_name == "smoke" else _indivisible()
    teng = ttr.make_comm_engine(
        TModel(tcfg), FAKE8,
        tpl.make_hybrid_planner(FAKE8, tcfg, batch=8, seq=32),
        ttr.CommConfig(**comm))
    jcfg = _jcfg(cfg_name)
    jeng = jtr.make_comm_engine(
        JModel(jcfg), mesh8,
        jpl.make_hybrid_planner(mesh8, jcfg, batch=8, seq=32),
        jtr.CommConfig(**comm))
    return teng, jeng


@pytest.mark.parametrize("cfg_name", ["smoke", "indivisible"])
@pytest.mark.parametrize("comm", [{}, {"wire": "int8"},
                                  {"topo": "cloud-virtio-sriov",
                                   "bucket_bytes": 2 ** 16}])
def test_engine_hybrid_bucket_axes(mesh8, cfg_name, comm):
    """Bucket boundaries, reduce axes, routes and fusability equal the
    reference engine's on mesh8 (planned on the local shard shapes)."""
    teng, jeng = _engines(mesh8, cfg_name, **comm)
    tp_, jp_ = teng.plan, jeng.plan
    assert _bucket_paths(tp_) == _jax_bucket_paths(jp_)
    assert [b.shapes for b in tp_.buckets.buckets] == \
        [tuple(tuple(s) for s in b.shapes) for b in jp_.buckets.buckets]
    assert tp_.bucket_axes == jp_.bucket_axes
    assert tp_.algos == jp_.algos
    assert tp_.fusable == jp_.fusable
    assert (tp_.tp_axis, tp_.tp, tp_.dp, tp_.data_axes) == \
        (jp_.tp_axis, jp_.tp, jp_.dp, jp_.data_axes)
    assert teng.tp is not None and teng.tp.axis == "local"
    assert teng.tp.group == "local"
    assert [teng.groups_for(bi) for bi in range(tp_.n_buckets)] == \
        [list(ax) for ax in tp_.bucket_axes]
    if cfg_name == "smoke":
        # both flavors exist: sharded buckets reduce over the node axis
        # only, replicated ones over (node, local)
        assert set(tp_.bucket_axes) == {("node",), ("node", "local")}
    else:
        assert set(tp_.bucket_axes) == {("node", "local")}
    for axes, algo in zip(tp_.bucket_axes, tp_.algos):
        if axes == ("node",):
            assert algo == tpl.ALGO_FLAT


def test_engine_hybrid_rejects_error_feedback(mesh8):
    with pytest.raises(ValueError, match="error feedback"):
        _engines(mesh8, wire="int8", error_feedback=True)
    from repro_torch.core import engine as teng
    with pytest.raises(ValueError, match="leaf_sharded"):
        teng.build_plan({"w": torch.empty(4, device="meta")},
                        ttr.CommConfig(mode="mlsl"), HIER8, ("node",),
                        tp_axis="local")


def test_trainer_hybrid_requires_mlsl():
    cfg = _smoke()
    planner = tpl.make_hybrid_planner(HIER8, cfg, batch=8, seq=32)
    with pytest.raises(ValueError, match="mlsl"):
        ttr.make_train_step(TModel(cfg), topt.adamw(1e-3), HIER8, planner,
                            ttr.CommConfig(mode="gspmd"))


# ---------------------------------------------------------------------------
# executed training: against the JAX hybrid trainer, and hybrid == DP
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", list(CASES))
def test_losses_match_jax_trainer_on_mesh8(port, ref, name):
    recs, _, _ = port[name]
    for r in recs[1:]:               # the loss is the pmean: replicated
        assert r["loss"] == recs[0]["loss"]
        assert r["grad_norm"] == recs[0]["grad_norm"]
    metrics, _ = ref[name]
    rtol = 1e-3 if "int8" in name else 1e-4
    np.testing.assert_allclose(recs[0]["loss"], [m[0] for m in metrics],
                               rtol=rtol)
    np.testing.assert_allclose(recs[0]["grad_norm"], [m[1] for m in metrics],
                               rtol=rtol)
    assert all(np.isfinite(recs[0]["loss"] + recs[0]["grad_norm"]))


@pytest.mark.parametrize("name", [n for n in CASES if "int8" not in n])
def test_gathered_params_match_jax_trainer(port, ref, name):
    _, final, _ = port[name]
    _, want = ref[name]
    got = jax.tree_util.tree_leaves(final)
    want = jax.tree_util.tree_leaves(want)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=1e-4)


@pytest.mark.parametrize("cfg_name", ["smoke", "indivisible"])
def test_hybrid_step_matches_dp(port, cfg_name):
    """THE equivalence, on the port: with the chooser's model-parallel
    layers really sharded over "local" (smoke) or every layer fallen back
    to DP (indivisible heads), two executed steps land where pure DP-8
    lands at the same global batch."""
    dp, hy = port[f"{cfg_name}_dp"], port[f"{cfg_name}_hybrid"]
    for dl, hl in zip(dp[0][0]["loss"], hy[0][0]["loss"]):
        assert abs(dl - hl) < 5e-4, (dp[0][0], hy[0][0])
    a, b = jax.tree_util.tree_leaves(dp[1]), jax.tree_util.tree_leaves(hy[1])
    assert len(a) == len(b)
    for x, y in zip(a, b):
        np.testing.assert_allclose(np.asarray(x), np.asarray(y), atol=1e-4)


@pytest.mark.parametrize("name", list(CASES))
def test_ranks_hold_their_shards_and_restore_them_bitwise(port, name):
    """Model-sharded leaves are 1/4 of the full size on every rank; the
    gathered checkpoint restores each rank's shards bit for bit."""
    recs, final, _ = port[name]
    full = [list(a.shape) for a in jax.tree_util.tree_leaves(final)]
    for r in recs:
        assert r["restores_bitwise"]
        assert r["local_shapes"] == recs[0]["local_shapes"]
    sharded = [(f, l) for f, l in zip(full, recs[0]["local_shapes"])
               if f != l]
    if name.startswith("smoke_hybrid"):
        # wq wk wv wo w1 w2 w3 of the one stacked block
        assert len(sharded) == 7
        for f, l in sharded:
            assert sum(a != b for a, b in zip(f, l)) == 1
            assert math.prod(f) == 4 * math.prod(l)
    else:
        assert not sharded


def test_port_checkpoint_restores_bitwise_in_both_packages(port):
    """The gathered checkpoint reads the same bits through either
    package's restore, and the port's restore(specs=) cuts them into the
    shards shard_params cuts from the full tree."""
    _, final, path = port["smoke_hybrid"]
    cfg = _smoke()
    model = TModel(cfg)
    like = {"params": tree_lib.tree_map(
        lambda pd: torch.empty(pd.shape, dtype=pd.dtype, device="meta"),
        model.param_defs())}
    back = tckpt.restore(str(path), like, device="cpu")["params"]
    got = [np.asarray(a) for a in tree_lib.leaves(back)]
    want = [np.asarray(a) for a in jax.tree_util.tree_leaves(final)]
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    specs = ttr.param_specs(model, tpl.make_hybrid_planner(
        HIER8, cfg, batch=BATCH, seq=SEQ))
    for rank in (0, 6):
        node, local = _coords(rank)
        coord = {"node": node, "local": local}
        cut = convert.shard_params(back, specs, HIER8, coord)
        cut_np = convert.shard_params(
            jax.tree_util.tree_map(np.asarray, final), specs, HIER8, coord)
        for a, b in zip(tree_lib.leaves(cut), tree_lib.leaves(cut_np)):
            np.testing.assert_array_equal(a.numpy(), b)


def test_shard_params_rejects_an_indivisible_dimension():
    with pytest.raises(ValueError, match="does not split over 4 ranks"):
        convert.shard_params({"w": np.zeros((3, 6))}, {"w": (None, "local")},
                             HIER8, {"node": 0, "local": 0})


# ---------------------------------------------------------------------------
# the CLI on 8 gloo ranks through torchrun
# ---------------------------------------------------------------------------

def _reference_plan_lines(batch, seq):
    """What src/repro/launch/train.py prints for --hybrid on mesh8."""
    planner = jpl.make_hybrid_planner(_amesh(), jreg.get_smoke_config("yi-6b"),
                                      batch=batch, seq=seq)
    out = []
    for lp in planner.hybrid.layers:
        note = f" [{lp.reason}]" if lp.reason else ""
        out.append(f"plan {lp.name:12s} {lp.kind:6s} "
                   f"chooser={lp.choice.strategy.value}"
                   f"(g={lp.choice.group_size}) "
                   f"executed={lp.executed}{note}")
    return out


def test_cli_hybrid_on_eight_gloo_ranks(tmp_path):
    """`--hybrid --comm mlsl` through torchrun on 8 gloo ranks of the CPU:
    the reference's plan lines, mesh ("node"=2, "local"=4), finite losses,
    and a checkpoint of full tensors that both packages restore to the same
    bits."""
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT / "src"), os.environ.get("PYTHONPATH", "")]))
    env.pop("JAX_PLATFORMS", None)
    ckpt_dir = tmp_path / "ckpt"
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "8", "-m", "repro_torch.launch.train",
         "--device", "cpu", "--hybrid", "--comm", "mlsl", "--wire", "int8",
         "--steps", "2", "--batch", "8", "--seq", "32", "--log-every", "1",
         "--ckpt-dir", str(ckpt_dir)],
        env=env, cwd=tmp_path, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-4000:]
    out = proc.stdout.splitlines()
    assert [l for l in out if l.startswith("plan ")] == \
        _reference_plan_lines(8, 32)
    assert any("mesh={'node': 2, 'local': 4}" in l for l in out)
    losses = [float(l.split()[3]) for l in out if l.startswith("step")]
    assert len(losses) == 2 and all(np.isfinite(losses)), out
    cfg = _smoke()
    like = {"params": tree_lib.tree_map(
        lambda pd: torch.empty(pd.shape, dtype=pd.dtype, device="meta"),
        TModel(cfg).param_defs())}
    mine = tckpt.restore(str(ckpt_dir), like, device="cpu")["params"]
    jlike = {"params": tree_lib.tree_map(
        lambda pd: jax.ShapeDtypeStruct(pd.shape, jnp.float32),
        TModel(cfg).param_defs())}
    theirs = jckpt.restore(str(ckpt_dir), jlike)["params"]
    for path, a in tree_lib.leaves_with_paths(mine):
        b = theirs
        for k in path:
            b = b[k]
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_cli_hybrid_needs_mlsl():
    from repro_torch.launch import train as ttrain
    with pytest.raises(SystemExit, match=re.escape("--hybrid needs --comm "
                                                   "mlsl")):
        ttrain.main(["--hybrid", "--device", "cpu", "--steps", "1"])
