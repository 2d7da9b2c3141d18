"""The port's EnginePlan and CommEngine against the JAX reference's.

Plans are compared for the yi-6b, grok-1-314b and arctic-480b smoke configs
and for yi-6b at full width cut to 4 layers (shapes only: meta tensors on the port's side, eval_shape
on the reference's), under the default planner and under dp_only. Under the
default planner the reference puts the model axis on every matrix (even
with a model axis of size 1), so only the norm-scale buckets may fuse; with
dp_only every bucket fuses. The port reproduces both.
"""

import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from repro import compat
from repro.configs import registry as jreg
from repro.core.planner import Planner as JPlanner
from repro.launch import mesh as jmesh
from repro.models.transformer import Model as JModel
from repro.train import trainer as jtr
from repro_torch import tree as tree_lib
from repro_torch.configs import registry as treg
from repro_torch.core import collectives as cl
from repro_torch.core import engine as eng
from repro_torch.core import hier, hw
from repro_torch.core import planner as pl
from repro_torch.core import scheduler
from repro_torch.launch import mesh as tmesh
from repro_torch.models.transformer import Model as TModel
from repro_torch.optim import optimizers as topt
from repro_torch.train import trainer as ttr

COMM = dict(mode="mlsl", wire="int8", error_feedback=True)
# the MoE smoke configs: f32 routers beside the expert leaves (E, d, ff)
MOE_SMOKE = {"grok_smoke": "grok-1-314b", "arctic_smoke": "arctic-480b"}
# the (2, 4) hier mesh's shape, without ranks: plans need only the shape
HIER8 = types.SimpleNamespace(mesh_dim_names=("node", "local"), shape=(2, 4),
                              device_type="cpu", get_group=lambda a: None)


@pytest.fixture(scope="module")
def meshes():
    return jmesh.make_host_mesh(1, 1), tmesh.make_host_mesh(1, 1,
                                                            device="cpu")


def _configs(name):
    if name == "smoke":
        return jreg.get_smoke_config("yi-6b"), treg.get_smoke_config("yi-6b")
    if name in MOE_SMOKE:
        arch = MOE_SMOKE[name]
        return jreg.get_smoke_config(arch), treg.get_smoke_config(arch)
    return (dataclasses.replace(jreg.get_config("yi-6b"), n_layers=4),
            dataclasses.replace(treg.get_config("yi-6b"), n_layers=4))


def _plans(meshes, name, dp_only, **comm):
    jcfg, tcfg = _configs(name)
    jm, tm = meshes
    jeng = jtr.make_comm_engine(JModel(jcfg), jm,
                                JPlanner(mesh=jm, dp_only=dp_only),
                                jtr.CommConfig(**{**COMM, **comm}))
    teng = ttr.make_comm_engine(TModel(tcfg), tm,
                                pl.Planner(mesh=tm, dp_only=dp_only),
                                ttr.CommConfig(**{**COMM, **comm}))
    return jeng.plan, teng.plan


def _jax_bucket_paths(plan):
    leaves = jax.tree_util.tree_leaves_with_path(
        jax.tree_util.tree_unflatten(plan.buckets.treedef,
                                     [0] * plan.buckets.treedef.num_leaves))
    paths = [tuple(k.key for k in path) for path, _ in leaves]
    return [[paths[i] for i in b.leaf_ids] for b in plan.buckets.buckets]


@pytest.mark.parametrize("name", ["smoke", "yi6b_4layers", *MOE_SMOKE])
@pytest.mark.parametrize("dp_only", [False, True])
def test_plan_matches_reference(meshes, name, dp_only):
    jp, tp = _plans(meshes, name, dp_only)
    assert [[tp.buckets.paths[i] for i in b.leaf_ids]
            for b in tp.buckets.buckets] == _jax_bucket_paths(jp)
    assert [b.n_elems for b in tp.buckets.buckets] == \
        [b.n_elems for b in jp.buckets.buckets]
    assert tp.fusable == jp.fusable
    assert tp.algos == jp.algos
    assert tp.quant_pad == jp.quant_pad
    assert (tp.dp, tp.use_ef, tp.data_axes) == (jp.dp, jp.use_ef, jp.data_axes)
    assert tp.quant_backend == "torch"


def test_yi6b_4layers_fusability(meshes):
    """The reference's caveat, reproduced: 11 buckets; by default only the
    two norm-scale buckets (32,768 and 4,096 elements) fuse, with dp_only
    all 11 do and carry all 1,216,385,024 elements."""
    _, default = _plans(meshes, "yi6b_4layers", False)
    _, dp_only = _plans(meshes, "yi6b_4layers", True)
    assert default.n_buckets == dp_only.n_buckets == 11
    fused = [b.n_elems for b, f in zip(default.buckets.buckets,
                                       default.fusable) if f]
    assert fused == [32768, 4096]
    assert all(dp_only.fusable)
    assert sum(b.n_elems for b in dp_only.buckets.buckets) == 1_216_385_024
    sizes = [b.n_elems for b in dp_only.buckets.buckets]
    assert sizes[0] == 262_144_000 and 180_355_072 in sizes


def test_planner_specs_and_errors(meshes):
    _, tm = meshes
    planner = pl.Planner(mesh=tm)
    assert planner.batch_axes == ("data",) and planner.model_size == 1
    assert pl.Planner(mesh=tm, dp_only=True).batch_axes == ("data", "model")
    mat = pl.ParamDef((4, 8), pl.K_PROJ_IN)
    assert planner.spec_for(mat) == (None, "model")
    assert planner.spec_for(pl.ParamDef((2, 4, 8), pl.K_PROJ_OUT),
                            stacked=True) == (None, "model", None)
    assert pl.Planner(mesh=tm, dp_only=True).spec_for(mat) == (None, None)
    assert planner.spec_for(pl.ParamDef((8,), pl.K_NORM)) == (None,)
    fsdp = pl.Planner(mesh=tm, fsdp=True)   # the gspmd step runs FSDP
    assert fsdp.spec_for(mat) == ("data", "model")
    with pytest.raises(ValueError, match="non-FSDP"):
        ttr.make_train_step(TModel(treg.get_smoke_config("yi-6b")),
                            topt.adamw(1e-3), tm, fsdp,
                            ttr.CommConfig(mode="mlsl"))
    hm = tmesh.make_hier_mesh(1, 1, device="cpu")
    hplan = ttr.make_comm_engine(TModel(treg.get_smoke_config("yi-6b")), hm,
                                 pl.Planner(mesh=hm),
                                 ttr.CommConfig(hier=True)).plan
    assert set(hplan.algos) == {pl.ALGO_HIER}
    assert (hplan.n_node, hplan.n_local) == (1, 1)
    assert hplan.hier_spec.wire_intra == "fp32"
    with pytest.raises(ValueError, match="node"):
        ttr.make_comm_engine(TModel(treg.get_smoke_config("yi-6b")), tm,
                             planner, ttr.CommConfig(hier=True))


def test_sorted_key_flatten_order():
    """Leaves flatten in sorted-key order (jax.tree_util's), not in
    insertion order."""
    tree = {"b": {"z": 1, "a": 2}, "a": 3, "c": {"y": {"q": 4}}}
    assert tree_lib.paths(tree) == [("a",), ("b", "a"), ("b", "z"),
                                    ("c", "y", "q")]
    defs = TModel(treg.get_smoke_config("yi-6b")).param_defs()
    jdefs = JModel(jreg.get_smoke_config("yi-6b")).param_defs()
    jpaths = [tuple(k.key for k in p) for p, _ in
              jax.tree_util.tree_leaves_with_path(
                  jdefs, is_leaf=lambda x: hasattr(x, "kind"))]
    assert tree_lib.paths(defs) == jpaths
    assert tree_lib.unflatten(tree_lib.paths(tree), tree_lib.leaves(tree)) \
        == tree


def test_default_layer_index_matches_reference():
    from repro.core import scheduler as jsched
    for path in (("embed",), ("head",), ("ln_f", "scale"),
                 ("blocks", "p0_attn", "attn", "wq")):
        jpath = tuple(jax.tree_util.DictKey(k) for k in path)
        assert scheduler.default_layer_index(path) == \
            jsched.default_layer_index(jpath)


# --------------------------------------------------------------------------
# reduce / reduce_accum_chained at dp = 1 on identical gradients
# --------------------------------------------------------------------------

def _grads(cfg, seed):
    rng = np.random.default_rng(seed)
    defs = TModel(cfg).param_defs()
    return tree_lib.tree_map(
        lambda pd: (rng.standard_normal(pd.shape) * 0.01).astype(np.float32),
        defs)


def _step(np_tree):
    """An upper bound on any block's int8 scale: max |g| / 127."""
    return max(float(np.abs(a).max()) for a in tree_lib.leaves(np_tree)) / 127


def _jax_tree(np_tree):
    return jax.tree_util.tree_map(jnp.asarray, np_tree)


def _torch_tree(np_tree):
    return tree_lib.tree_map(torch.from_numpy, np_tree)


def _assert_tree_close(jtree, ttree, step):
    """Both sides quantize the same bf16 message at dp = 1. Inside jit, XLA
    may rewrite the divide (the reference's 1-LSB rounding-tie policy), so a
    value may move by one code step per exchange on a tiny fraction of
    elements; `step` bounds one step (the largest block scale)."""
    for path, j, t in zip(tree_lib.paths(ttree),
                          jax.tree_util.tree_leaves(jtree),
                          tree_lib.leaves(ttree)):
        diff = np.abs(t.numpy() - np.asarray(j))
        assert (diff <= step * (1 + 1e-6) + 1e-7).all(), (path, diff.max())
        assert (diff > 1e-7).mean() < 0.01, path


@pytest.mark.parametrize("dp_only", [False, True])
def test_reduce_and_reduce_accum_match_reference(meshes, dp_only):
    jm, tm = meshes
    jcfg, tcfg = _configs("smoke")
    jplanner = JPlanner(mesh=jm, dp_only=dp_only)
    jeng = jtr.make_comm_engine(JModel(jcfg), jm, jplanner,
                                jtr.CommConfig(**COMM))
    teng = ttr.make_comm_engine(TModel(tcfg), tm,
                                pl.Planner(mesh=tm, dp_only=dp_only),
                                ttr.CommConfig(**COMM))
    g0, g1 = _grads(tcfg, 0), _grads(tcfg, 1)
    ax = jplanner.batch_axes
    res_spec = P(ax)

    # one exchange (accum_steps == 1): tree and residuals
    jres = jeng.init_residuals()
    jout, jnew = jax.jit(compat.shard_map(
        lambda g, r: jeng.reduce(g, r), mesh=jm,
        in_specs=(jax.tree_util.tree_map(lambda _: P(), _jax_tree(g0)),
                  jeng.residual_specs(res_spec)),
        out_specs=(jax.tree_util.tree_map(lambda _: P(), _jax_tree(g0)),
                   jeng.residual_specs(res_spec)),
        axis_names=set(ax), check_vma=False))(_jax_tree(g0), jres)
    tout, tnew = teng.reduce(_torch_tree(g0), teng.init_residuals("cpu"))
    _assert_tree_close(jout, tout, _step(g0))
    assert len(tnew) == len(jnew) == teng.plan.n_buckets
    for a, b in zip(jnew, tnew):
        assert tuple(a.shape) == tuple(b.shape)
        assert (np.abs(b.numpy() - np.asarray(a)) <= _step(g0) + 1e-7).all()

    # two microbatches into the bucket-layout accumulator
    def jaccum(a, b, r):
        acc = jeng.init_accum()
        acc, r, tok = jeng.reduce_accum_chained(a, acc, r,
                                                jnp.zeros((), jnp.float32))
        acc, r, _ = jeng.reduce_accum_chained(b, acc, r, tok)
        return jeng.unfuse_accum(acc), r

    tree_spec = jax.tree_util.tree_map(lambda _: P(), _jax_tree(g0))
    jsum, jr2 = jax.jit(compat.shard_map(
        jaccum, mesh=jm,
        in_specs=(tree_spec, tree_spec, jeng.residual_specs(res_spec)),
        out_specs=(tree_spec, jeng.residual_specs(res_spec)),
        axis_names=set(ax), check_vma=False))(
            _jax_tree(g0), _jax_tree(g1), jres)
    tacc = teng.init_accum("cpu")
    tres = teng.init_residuals("cpu")
    tacc, tres = teng.reduce_accum_chained(_torch_tree(g0), tacc, tres)
    tacc, tres = teng.reduce_accum_chained(_torch_tree(g1), tacc, tres)
    _assert_tree_close(jsum, teng.unfuse_accum(tacc),
                       _step(g0) + _step(g1))
    for a, b in zip(jr2, tres):
        assert (np.abs(b.numpy() - np.asarray(a))
                <= 2 * (_step(g0) + _step(g1)) + 1e-7).all()


def test_engine_reduce_is_mean_on_fp32_wire(meshes):
    _, tm = meshes
    tree = {"a": torch.randn(3, 1000), "b": {"c": torch.randn(7)}}
    engine = eng.CommEngine.create(tree, eng.CommConfig(), tm, ("data",))
    out, res = engine.reduce(tree, None)
    assert res is None
    for a, b in zip(tree_lib.leaves(out), tree_lib.leaves(tree)):
        assert torch.equal(a, b)           # one rank: the mean is the value
    skip = eng.CommEngine.create(tree, eng.CommConfig(skip_reduce=True), tm,
                                 ("data",))
    assert skip.reduce(tree, None)[0] is tree


def test_residuals_only_where_ef_applies(meshes):
    _, tm = meshes
    tree = {"a": torch.zeros(5000), "b": torch.zeros(3, 3)}
    engine = eng.CommEngine.create(
        tree, eng.CommConfig(wire="int8", error_feedback=True), tm,
        ("data",), leaf_replicated=lambda path: path == ("a",),
        group_key=lambda path: path)
    res = engine.init_residuals("cpu")
    assert [r.shape for r in res] == [cl.ef_residual_shape(5000, 1), (0,)]
    assert engine.ef_applied(0) and not engine.ef_applied(1)


# --------------------------------------------------------------------------
# the two-level route: plans on the (2, 4) hier mesh, and dp = 1 equality
# --------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["smoke", "yi6b_4layers"])
@pytest.mark.parametrize("dp_only", [False, True])
@pytest.mark.parametrize("topo", [None] + sorted(hw.TOPOLOGIES))
def test_hier_plan_matches_reference(mesh8, name, dp_only, topo):
    """Routes, fusability, the two-level spec and the residual shapes
    (the reference's global view over 8 ranks) for the same gradient
    shapes on the (2, 4) mesh, under each topology's cost model."""
    jcfg, tcfg = _configs(name)
    comm = dict(COMM, hier=True, topo=topo)
    jeng = jtr.make_comm_engine(JModel(jcfg), mesh8,
                                JPlanner(mesh=mesh8, dp_only=dp_only),
                                jtr.CommConfig(**comm))
    teng = ttr.make_comm_engine(TModel(tcfg), HIER8,
                                pl.Planner(mesh=HIER8, dp_only=dp_only),
                                ttr.CommConfig(**comm), device="cpu")
    jp, tp = jeng.plan, teng.plan
    assert tp.algos == jp.algos
    assert tp.fusable == jp.fusable
    assert (tp.n_node, tp.n_local, tp.dp, tp.topo) == \
        (jp.n_node, jp.n_local, jp.dp, jp.topo)
    assert (tp.hier_spec.wire_intra, tp.hier_spec.wire_inter,
            tp.hier_spec.error_feedback) == \
        (jp.hier_spec.wire_intra, jp.hier_spec.wire_inter,
         jp.hier_spec.error_feedback)
    tres = teng.init_residuals("meta")
    assert [tuple(r.shape) for r in tres] == \
        [(int(r.shape[0]) // 8,) for r in jeng.init_residuals()]
    if name == "yi6b_4layers" and not dp_only:
        # the reference's caveat under the CLI's planner: 2 of 11 buckets
        # (the norm scales) fuse; the rest go leaf by leaf on bf16
        assert sum(tp.fusable) == 2 and tp.n_buckets == 11


def test_hier_plan_errors(meshes):
    _, tm = meshes
    model = TModel(treg.get_smoke_config("yi-6b"))
    with pytest.raises(ValueError, match="unknown topology"):
        ttr.make_comm_engine(model, HIER8, pl.Planner(mesh=HIER8),
                             ttr.CommConfig(mode="mlsl", hier=True,
                                            topo="nowhere"), device="cpu")
    # topo without hier routes nothing (the reference ignores it too)
    plan = ttr.make_comm_engine(model, tm, pl.Planner(mesh=tm),
                                ttr.CommConfig(mode="mlsl",
                                               topo="xeon-shm-10gbe")).plan
    assert set(plan.algos) == {pl.ALGO_FLAT}


@pytest.mark.parametrize("with_acc", [False, True])
def test_hier_route_at_world_size_one_is_the_flat_route_plus_bf16(with_acc):
    """At p = 1 the two-level int8 + EF route quantizes the same bf16 shard
    with the same residual as the flat route: codes, scales and residual
    are bitwise the flat route's. Its intra all-gather carries the
    dequantized shard on the bf16 wire (the reference's design), so the
    result is the flat route's without accumulator rounded to bf16, plus
    the accumulator."""
    hm = tmesh.make_hier_mesh(1, 1, device="cpu")
    groups = {a: hm.get_group(a) for a in ("node", "local")}
    g = torch.Generator().manual_seed(7)
    n = 70000
    x = torch.randn(n, generator=g) * 0.01
    res = torch.randn(hier.ef_residual_shape(n, 1, 1), generator=g) * 1e-4
    acc = torch.randn(n, generator=g) if with_acc else None
    spec = hier.HierSpec(wire_intra="bf16", wire_inter="int8",
                         error_feedback=True)
    got, got_res = hier.hier_allreduce_ef(x, res, groups, spec, mean=True,
                                          acc=acc)
    flat_groups = [groups["node"], groups["local"]]
    flat, flat_res = cl.allreduce_ef(x, res, flat_groups, mean=True)
    assert torch.equal(got_res, flat_res)
    want = flat.to(torch.bfloat16).to(torch.float32)
    assert torch.equal(got, want if acc is None else acc + want)
