"""The port's plain model parallelism (`Planner(mesh)` with a model axis of
more than one rank) on 8 gloo ranks, against the JAX trainer on meshes cut
from the 8 virtual devices: (data, model) = (4, 2), (2, 4) and (1, 8) (the
smoke yi-6b's 4 heads of 32 then split into half heads), and the two-level
("node", "local", "model") = (2, 2, 2).

One group of 8 ranks is spawned once for the file (tests/torch_mp_ranks.py,
torch only). It runs each new operator at model sizes 2, 4 and 8 (forward and
backward), the expert-parallel MoE layer (`moe_apply_ep`) on (data 2, model
4), the engine's leafwise-bucket and replay checks at (4, 2), then 3
steps (SGD at 0.1, LARS or LAMB; data seed 3, batch 8, seq 16) of every
case of CASES from converted weights, and 3 gspmd steps of every case of
FSDP_CASES through `Session.make_train_step` (`Planner(fsdp=True)`, AdamW
or LAMB at 1e-3, batch 16: yi-6b
on (8, 1), (4, 2) and ("node", "local") = (2, 4), grok-1 on (8, 1) on the
gather, ep and ep-int8 dispatches) against the JAX trainer with the same
planner (tolerances in `test_fsdp_matches_jax_trainer`).

Tolerances: the operators against their dense JAX forms on one device,
atol 1e-5 (f32; the sums are split over ranks). Against the JAX trainer:
losses rtol 1e-4, gradient norms and the parameters gathered over the model
group atol 1e-4 (fp32 wire; gloo sums in another order than XLA). The lossy
wires, on which the reference aborts under a model axis (XLA's "Invalid
binary instruction opcode copy"), are held to the port's own fp32 run at
rtol 1e-3, the int8 tolerance of tests/test_torch_train_hier.py.
`CommStats.from_plan` and the bucket boundaries equal the reference's
exactly. `moe_apply_ep`: y and aux against the reference's `moe_apply_ep`
and the port's `moe_apply`, rtol 2e-3 and atol 2e-4 (the reference's own
bound, tests/test_multidevice.py); gradients against `jax.grad` of the
reference's, within 1e-4 of each gradient's largest element.
"""

import dataclasses
import json
import os
import pathlib
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
from repro.configs.base import AttnConfig as JAttnConfig
from repro.core import planner as jpl
from repro.data import pipeline as jpipe
from repro.launch import mesh as jmesh
from repro.configs.base import MoEConfig as JMoE
from repro.models import attention as jattn, common as jcommon, moe as jmoe
from repro.models.transformer import Batch as JBatch, Model as JModel
from repro.optim import optimizers as jopt
from repro.train import trainer as jtr
from repro_torch import tree as tree_lib
from repro_torch.checkpoint import ckpt as tckpt
from repro_torch.configs import registry as treg
from repro_torch.core import planner as tpl
from repro_torch.launch import mesh as tmesh
from repro_torch.models import attention as tattn, moe as tmoe
from repro_torch.models.transformer import Model as TModel
from repro_torch.train import trainer as ttr

import torch_spawn
from torch_mp_ranks import (BATCH, CASES, DATA_SEED, EP_AUX_WEIGHT,
                            EP_CASES, EP_D, EP_DENSE, EP_E, EP_FF,
                            FSDP_BATCH, FSDP_CASES, FSDP_LR, FSDP_MESHES,
                            HEADS_ATTN, LR, MESHES, OPS_ATTN, OPS_SIZES,
                            RESUME_FROM, ROWS_ATTN, SEQ, SPLIT_OPS, STEPS,
                            ep_config)

ROOT = pathlib.Path(__file__).resolve().parents[1]
WORLD = 8
LOSSY = ("int8_ef_4x2", "bf16_4x2")
EXACT = [n for n in CASES if n not in LOSSY]


ARCH = {"chatglm3": "chatglm3-6b", "grok": "grok-1-314b"}


def _jcfg(name):
    if name in ARCH:
        return jreg.get_smoke_config(ARCH[name])
    cfg = jreg.get_smoke_config("yi-6b")
    return dataclasses.replace(cfg, vocab=510) if name == "odd_vocab" else cfg


def _tcfg(name):
    if name in ARCH:
        return treg.get_smoke_config(ARCH[name])
    cfg = treg.get_smoke_config("yi-6b")
    return dataclasses.replace(cfg, vocab=510) if name == "odd_vocab" else cfg


def _jmesh(name, meshes=MESHES):
    kind, *sizes = meshes[name]
    return (jmesh.make_hier_mesh(*sizes) if kind == "hier"
            else jmesh.make_host_mesh(*sizes))


def _fake(name):
    """A mesh's shape and no ranks: planners and engine plans need only
    that."""
    kind, *sizes = MESHES[name]
    names = (("node", "local", "model") if kind == "hier"
             else ("data", "model"))
    return types.SimpleNamespace(mesh_dim_names=names, shape=tuple(sizes),
                                 device_type="cpu", get_group=lambda a: a)


# ---------------------------------------------------------------------------
# the 8 ranks and the reference
# ---------------------------------------------------------------------------

def _ops_inputs():
    rng = np.random.default_rng(0)

    def normal(*shape, scale=1.0):
        return (scale * rng.standard_normal(shape)).astype(np.float32)

    d, a = 16, OPS_ATTN
    return {"x": normal(2, 3, 8), "w_gather": normal(2, 3, 8),
            "table": normal(16, 8), "ids": rng.integers(0, 16, (2, 5)),
            "w_embed": normal(2, 5, 8), "logits": normal(2, 5, 16, scale=3),
            "labels": rng.integers(0, 16, (2, 5)),
            "mask": (rng.random((2, 5)) < 0.7).astype(np.float32),
            "xa": normal(2, 6, d),
            "wq": normal(d, a.n_heads * a.head_dim, scale=0.3),
            "wk": normal(d, a.n_kv * a.head_dim, scale=0.3),
            "wv": normal(d, a.n_kv * a.head_dim, scale=0.3),
            "wo": normal(a.n_heads * a.head_dim, d, scale=0.3),
            "w_attn": normal(2, 6, d),
            **{f"{n}_{sfx}": normal(*shape, scale=0.3)
               for sfx, c in (("h", HEADS_ATTN), ("r", ROWS_ATTN))
               for n, shape in (("wq", (d, c.n_heads * c.head_dim)),
                                ("wk", (d, c.n_kv * c.head_dim)),
                                ("wv", (d, c.n_kv * c.head_dim)),
                                ("wo", (c.n_heads * c.head_dim, d)))},
            "xr": normal(2, 8, d), "enc": normal(2, 5, d),
            "w_xa": normal(2, 6, d), "w_xr": normal(2, 8, d)}


def _ep_inputs():
    """One MoE layer's weights (the router unscaled) and x, seeded."""
    rng = np.random.default_rng(11)

    def normal(*shape, scale=0.1):
        return (scale * rng.standard_normal(shape)).astype(np.float32)

    d, e, f, g = EP_D, EP_E, EP_FF, EP_DENSE
    return {"router": normal(d, e, scale=1.0), "w1": normal(e, d, f),
            "w2": normal(e, f, d), "w3": normal(e, d, f),
            "dense_w1": normal(d, g), "dense_w2": normal(g, d),
            "dense_w3": normal(d, g), "x": normal(4, 8, d, scale=0.5)}


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    path = tmp_path_factory.mktemp("mp_inputs")
    ops = _ops_inputs()
    np.savez(path / "ops.npz", **ops)
    np.savez(path / "ep.npz", **_ep_inputs())
    params = {}
    for name in {c for c, *_ in (*CASES.values(), *FSDP_CASES.values())}:
        params[name] = jax.tree_util.tree_map(
            np.asarray, JModel(_jcfg(name)).init(jax.random.PRNGKey(0)))
        jckpt.save(str(path / name), {"params": params[name]}, step=0)
    return path, ops, params


def _load_params(directory, cfg_name):
    like = {"params": jax.tree_util.tree_map(
        lambda pd: jax.ShapeDtypeStruct(pd.shape, jnp.float32),
        JModel(_jcfg(cfg_name)).param_defs(),
        is_leaf=lambda x: isinstance(x, jpl.ParamDef))}
    return jckpt.restore(str(directory), like)["params"]


@pytest.fixture(scope="module")
def port(inputs, tmp_path_factory):
    path, _, _ = inputs
    out = tmp_path_factory.mktemp("mp_ranks")
    torch_spawn.spawn("torch_mp_ranks.py", WORLD,
                      tmp_path_factory.mktemp("store"), path, out,
                      timeout=510)
    res = {"ops": {m: [dict(np.load(out / "ops" / f"m{m}" / f"rank{r}.npz"))
                       for r in range(WORLD)] for m in OPS_SIZES},
           "engine": [json.loads((out / "engine" / f"rank{r}.json")
                                 .read_text()) for r in range(WORLD)],
           "ep": {name: [dict(np.load(out / "ep" / name / f"rank{r}.npz"))
                         for r in range(WORLD)]
                  for name in EP_CASES}}
    for name, (cfg_name, *_) in (*CASES.items(), *FSDP_CASES.items()):
        recs = [json.loads((out / name / f"rank{r}.json").read_text())
                for r in range(WORLD)]
        assert jckpt.latest_step(str(out / name / "ckpt")) == STEPS
        res[name] = (recs, _load_params(out / name / "ckpt", cfg_name))
    return res


def _jax_train(mesh, cfg, params, comm_kw, optimizer):
    model = JModel(cfg)
    opt = jopt.make_optimizer(optimizer, LR)
    comm = jtr.CommConfig(**comm_kw)
    dcfg = jpipe.DataConfig(vocab=cfg.vocab, seq_len=SEQ, global_batch=BATCH,
                            seed=DATA_SEED)
    with compat.set_mesh(mesh):
        p = jax.tree_util.tree_map(jnp.asarray, params)
        state = jtr.TrainState(params=p, opt_state=opt.init(p),
                               step=jnp.zeros((), jnp.int32))
        step = jax.jit(jtr.make_train_step(model, opt, mesh,
                                           jpl.Planner(mesh=mesh), comm))
        metrics = []
        for raw in jpipe.iterate(dcfg, STEPS):
            b = JBatch(tokens=jnp.asarray(raw["tokens"]),
                       labels=jnp.asarray(raw["labels"]))
            state, m = step(state, b)
            metrics.append((float(m["loss"]), float(m["grad_norm"])))
    return metrics, jax.tree_util.tree_map(np.asarray, state.params)


@pytest.fixture(scope="module")
def ref(inputs, port):
    _, _, params = inputs
    out = {}
    for name in EXACT:
        cfg_name, mesh_name, kw, optimizer = CASES[name]
        start = (port[RESUME_FROM[name]][1] if name in RESUME_FROM
                 else params[cfg_name])
        out[name] = _jax_train(_jmesh(mesh_name), _jcfg(cfg_name), start, kw,
                               optimizer)
    return out


# ---------------------------------------------------------------------------
# the new operators against their dense forms
# ---------------------------------------------------------------------------

def _cat(outs, key, axis):
    return np.concatenate([o[key] for o in outs], axis=axis)


def _groups(m):
    """The ranks of each model group of make_host_mesh(8 // m, m)."""
    return [list(range(g * m, (g + 1) * m)) for g in range(WORLD // m)]


def _dense_grad(fn, args, weight=None):
    def loss(*a):
        y = fn(*a)
        return y if weight is None else jnp.sum(y * weight)
    return jax.jit(fn)(*args), jax.jit(jax.grad(
        loss, argnums=tuple(range(len(args)))))(*args)


def _dense(op, ops):
    """(output, gradients) of the dense form of `op`, and how each
    gradient is split over a model group: "rows", "cols" or "full"
    (every rank holds the whole gradient)."""
    J = {k: jnp.asarray(v) for k, v in ops.items()}
    if op == "gather":
        y, g = _dense_grad(lambda x: x, [J["x"]], J["w_gather"])
        return y, g, ("cols",)
    if op == "split":
        y, g = _dense_grad(lambda x: x, [J["x"]], J["w_gather"])
        return y, g, ("full",)
    if op in ("embed_vocab", "embed_dim"):
        y, g = _dense_grad(lambda t: jnp.take(t, J["ids"], axis=0),
                           [J["table"]], J["w_embed"])
        return y, g, ("rows" if op == "embed_vocab" else "cols",)
    if op in ("xent", "xent_mask"):
        mask = J["mask"] if op == "xent_mask" else None
        y, g = _dense_grad(
            lambda z: jcommon.softmax_xent(z, J["labels"], mask),
            [J["logits"]])
        return y, g, ("cols",)
    if op in SPLIT_OPS:
        c, xkey, chunk, cross = SPLIT_OPS[op]
        sfx = "h" if c is HEADS_ATTN else "r"
        keys = [xkey] + [f"{n}_{sfx}" for n in ("wq", "wk", "wv", "wo")]
        weight = J[f"w_{xkey}"]
    else:
        c, chunk, cross = OPS_ATTN, None, False
        keys, weight = ["xa", "wq", "wk", "wv", "wo"], J["w_attn"]
    a = JAttnConfig(n_heads=c.n_heads, n_kv=c.n_kv, head_dim=c.head_dim,
                    rotary_frac=c.rotary_frac)

    def attn(x, wq, wk, wv, wo, enc=None):
        p = {"wq": wq, "wk": wk, "wv": wv, "wo": wo}
        if cross:
            return jattn.gqa_apply(p, x, a,
                                   kv_override=jattn.gqa_cross_kv(p, enc, a))
        return jattn.gqa_apply(p, x, a, kv_chunk=chunk)
    y, g = _dense_grad(attn, [J[k] for k in keys + ["enc"] * cross], weight)
    return y, g, ("full", "cols", "cols", "cols", "rows", "full")


OPS = ("gather", "split", "embed_vocab", "embed_dim", "xent", "xent_mask",
       "attn_apply", "attn_gathered", *SPLIT_OPS)


@pytest.fixture(scope="module")
def dense(inputs):
    """`_dense(op, ...)` on the operators' inputs, made once an op for
    every model size."""
    _, ops, _ = inputs
    made = {}

    def get(op):
        if op not in made:
            made[op] = _dense(op, ops)
        return made[op]
    return get


@pytest.mark.parametrize("m", OPS_SIZES)
@pytest.mark.parametrize("op", OPS)
def test_operators_match_their_dense_forms(port, dense, op, m):
    """Each operator's output on every rank, and its gradients assembled
    over each model group, equal the dense single-device computation."""
    y, grads, splits = dense(op)
    suffixes = (("gx", "gwq", "gwk", "gwv", "gwo", "genc")
                if op.startswith(("attn", "cross")) else ("g",))
    outs = port["ops"][m]
    for ranks in _groups(m):
        group = [outs[r] for r in ranks]
        if op == "split":           # each rank holds its block of columns
            np.testing.assert_allclose(_cat(group, "split_y", -1),
                                       np.asarray(y), atol=0)
        else:
            for o in group:
                np.testing.assert_allclose(o[f"{op}_y"], np.asarray(y),
                                           atol=1e-5)
        for sfx, g, split in zip(suffixes, grads, splits):
            key = f"{op}_{sfx}"
            if split == "full":
                for o in group:
                    np.testing.assert_allclose(o[key], np.asarray(g),
                                               atol=1e-5)
            else:
                got = _cat(group, key, 0 if split == "rows" else -1)
                np.testing.assert_allclose(got, np.asarray(g), atol=1e-5)


def test_tp_max_is_the_group_max_without_gradient(port, inputs):
    _, ops, _ = inputs
    for m in OPS_SIZES:
        for ranks in _groups(m):
            for r in ranks:
                o = port["ops"][m][r]
                np.testing.assert_array_equal(o["max_y"], np.max(
                    [ops["x"] * (1.0 + k) for k in range(m)], axis=0))
                assert not bool(o["max_requires_grad"])


def test_attention_dispatches_on_whole_heads(port):
    """4 query heads on 2 KV heads: whole heads per rank at model size 2
    (the hybrid path), half a KV head at 4 (the gathered path)."""
    assert all(bool(o["aligned"]) for o in port["ops"][2])
    assert not any(bool(o["aligned"]) for o in port["ops"][4])


# op -> the path it takes at model sizes 2, 4 and 8
SPLIT_PATHS = {"attn_own_heads": ("aligned", "heads", "heads"),
               "attn_own_rows": ("aligned", "rows", "rows"),
               "attn_own_rows_chunk": ("aligned", "rows", "rows"),
               "attn_own_rows_padded": ("aligned", "rows", "rows"),
               "attn_own_rows_padded_chunk": ("aligned", "rows", "rows"),
               "cross_own_heads": ("aligned", "heads", "heads"),
               "cross_own_rows": ("aligned", "rows", "rows"),
               "cross_own_rows_padded": ("aligned", "rows", "rows")}


def test_split_operators_take_their_paths(port):
    """Each split operator case ran the path it is named for (at model
    sizes 4 and 8; whole heads a rank at 2)."""
    assert set(SPLIT_PATHS) == set(SPLIT_OPS)
    for name, paths in SPLIT_PATHS.items():
        for m, want in zip(OPS_SIZES, paths):
            assert {str(o[f"{name}_path"]) for o in port["ops"][m]} == \
                {want}, (name, m)


def _full(arch):
    return treg.get_config(arch)


@pytest.mark.parametrize("case,want", [
    # (arch, model size, flash: the no-grad prefill) -> path
    (("deepseek-7b", 16, False), "aligned"),
    (("yi-6b", 16, False), "heads"),
    (("yi-6b", 16, True), "heads"),
    (("chatglm3-6b", 4, False), "heads"),
    (("llava-next-mistral-7b", 16, False), "heads"),
    (("grok-1-314b", 16, False), "heads"),
    (("whisper-small", 4, False), "aligned"),
    (("whisper-small", 16, False), "rows"),
    (("whisper-small", 16, True), "whole"),
    (("arctic-480b", 16, False), "rows"),
    (("recurrentgemma-2b", 4, False), "rows"),
    (("recurrentgemma-2b", 16, True), "whole"),
    (("minicpm3-4b", 16, False), "rows"),
    (("minicpm3-4b", 8, False), "aligned"),
])
def test_mp_path_per_layout(case, want):
    """The path each production layout takes: whole heads a rank (aligned),
    own query heads, own query rows (not where the flash kernel runs), or
    every head (where it does). MLA's under `mla_path`, which never runs
    the flash kernel."""
    arch, size, flash = case
    cfg = _full(arch)
    if cfg.mla is not None:
        got = tattn.mla_path(tattn.MLA_HEAD_SHARDED, cfg.mla, size)
    else:
        got = tattn.mp_path(tattn.HEAD_SHARDED, cfg.attn, size, flash=flash)
    assert got == want


@pytest.fixture(scope="module")
def ep_ref():
    """The reference's `moe_apply_ep` on the (data 2, model 4) mesh of the
    8 virtual devices, per case of EP_CASES: y, aux, and the gradients of
    mean(y^2) + EP_AUX_WEIGHT * aux with respect to x and every weight."""
    mesh = compat.make_mesh((2, 4), ("data", "model"),
                            axis_types=(compat.AxisType.Auto,) * 2)
    data = _ep_inputs()
    out = {}
    for name, (cap, dense, fsdp, a2a, wire) in EP_CASES.items():
        m = JMoE(n_experts=EP_E, top_k=2, d_ff=EP_FF, capacity_factor=cap,
                 dense_residual_ff=dense)
        p = {k: jnp.asarray(data[k]) for k in ("router", "w1", "w2", "w3")}
        if dense:
            p["dense"] = {k: jnp.asarray(data[f"dense_{k}"])
                          for k in ("w1", "w2", "w3")}

        def fwd(pp, xx, m=m, fsdp=fsdp, a2a=a2a, wire=wire):
            return jmoe.moe_apply_ep(
                pp, xx, m, act="silu", mesh=mesh, batch_axes=("data",),
                fsdp_axes=("data",) if fsdp else (), wire_bf16_a2a=a2a,
                wgather_wire=wire)

        def loss(pp, xx, fwd=fwd):
            y, aux = fwd(pp, xx)
            return jnp.mean(y ** 2) + EP_AUX_WEIGHT * aux

        with compat.set_mesh(mesh):
            x = jnp.asarray(data["x"])
            y, aux = jax.jit(fwd)(p, x)
            gp, gx = jax.jit(jax.grad(loss, argnums=(0, 1)))(p, x)
        out[name] = {"y": np.asarray(y), "aux": float(aux),
                     "g_x": np.asarray(gx),
                     **{"g_" + "/".join(k): np.asarray(v) for k, v in zip(
                         tree_lib.paths(gp), jax.tree_util.tree_leaves(gp))}}
    return out


def _by_coords(outs):
    """{(data rank, model rank): that rank's record}."""
    return {tuple(int(c) for c in o["coords"]): o for o in outs}


@pytest.mark.parametrize("name", list(EP_CASES))
def test_ep_moe_output_matches_reference(port, ep_ref, name):
    """Every rank's y (its data rank's rows, the same on the 4 model ranks)
    and aux against the reference's moe_apply_ep: rtol 2e-3, atol 2e-4."""
    want = ep_ref[name]
    for (dr, _), o in _by_coords(port["ep"][name]).items():
        np.testing.assert_allclose(o["y"], want["y"][2 * dr:2 * dr + 2],
                                   rtol=2e-3, atol=2e-4)
        np.testing.assert_allclose(float(o["aux"]), want["aux"], rtol=2e-3,
                                   atol=2e-4)


@pytest.mark.parametrize("name", ["cap8", "cap8_dense", "cap8_a2a_bf16"])
def test_ep_moe_matches_the_gather_path(port, name):
    """At capacity factor 8 nothing is dropped: y equals the port's
    moe_apply over the whole batch (rtol 2e-3, atol 2e-4), and aux the mean
    of moe_apply's aux over the 8 source ranks' token slices (4 tokens of
    each data rank's 16 a model rank), each routed at its own capacity."""
    data = _ep_inputs()
    p = {k: torch.from_numpy(data[k]) for k in ("router", "w1", "w2", "w3")}
    m = ep_config(name)
    if m.dense_residual_ff:
        p["dense"] = {k: torch.from_numpy(data[f"dense_{k}"])
                      for k in ("w1", "w2", "w3")}
    x = torch.from_numpy(data["x"])
    with torch.no_grad():
        y, _ = tmoe.moe_apply(p, x, m)
        slices = x.reshape(2, 4, 4, EP_D)     # (data, model, t_loc, d)
        aux = np.mean([float(tmoe.moe_apply(p, slices[dr, r][None], m)[1])
                       for dr in range(2) for r in range(4)])
    for (dr, _), o in _by_coords(port["ep"][name]).items():
        np.testing.assert_allclose(o["y"], y[2 * dr:2 * dr + 2].numpy(),
                                   rtol=2e-3, atol=2e-4)
        np.testing.assert_allclose(float(o["aux"]), aux, rtol=1e-6)


def _assert_grad(got, want, what):
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-4 * np.abs(want).max(), err_msg=what)
    assert np.abs(want).max() > 0, what


@pytest.mark.parametrize("name", list(EP_CASES))
def test_ep_moe_gradients_match_reference(port, ep_ref, name):
    """The gradients against jax.grad of the reference's moe_apply_ep:
    x's and the router's the same on the model ranks of a data rank (the
    f operator all-reduces them there), x's rows per data rank and the
    router's summed over the data ranks; each model rank's experts' summed
    over the data ranks, or with FSDP each rank's (expert, d) shard as the
    reduce-scatter left it. The int8 weight gather's straight-through
    gradients are non-zero and are held to the reference's int8 run."""
    want, recs = ep_ref[name], _by_coords(port["ep"][name])
    fsdp = EP_CASES[name][2]
    e_loc, half = EP_E // 4, EP_D // 2
    for k in [k for k in want if k.startswith("g_")]:
        expert = k in ("g_w1", "g_w2", "g_w3")
        if not expert:
            for dr in range(2):
                for r in range(1, 4):
                    np.testing.assert_array_equal(recs[dr, r][k],
                                                  recs[dr, 0][k])
        if k == "g_x":
            _assert_grad(np.concatenate([recs[dr, 0][k] for dr in range(2)]),
                         want[k], k)
        elif not expert:
            _assert_grad(recs[0, 0][k] + recs[1, 0][k], want[k], k)
        elif not fsdp:
            for r in range(4):
                _assert_grad(recs[0, r][k] + recs[1, r][k],
                             want[k][r * e_loc:(r + 1) * e_loc], f"{k} {r}")
        else:
            for (dr, r), o in recs.items():
                w = want[k][r * e_loc:(r + 1) * e_loc]
                w = (w[..., dr * half:(dr + 1) * half] if k == "g_w2"
                     else w[:, dr * half:(dr + 1) * half])
                _assert_grad(o[k], w, f"{k} {dr} {r}")
                assert np.abs(o[k]).max() > 0, (k, dr, r)


# ---------------------------------------------------------------------------
# planner, engine and stats against the reference
# ---------------------------------------------------------------------------

def _spec_leaves(jspecs):
    return [(tuple(k.key for k in path), tuple(s)) for path, s in
            jax.tree_util.tree_leaves_with_path(
                jspecs, is_leaf=lambda s: isinstance(s, P))]


@pytest.mark.parametrize("cfg_name", ["smoke", "odd_vocab", "chatglm3"])
@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_planner_specs_and_layout_equal_reference(mesh_name, cfg_name):
    """Parameter specs leaf by leaf, and `model_dims` naming the dimension
    each spec puts the model axis on; the vocabulary of 510 puts it on
    the model dimension of the embedding and the head."""
    tp_ = tpl.Planner(mesh=_fake(mesh_name))
    jp_ = jpl.Planner(mesh=_jmesh(mesh_name))
    tm, jm = TModel(_tcfg(cfg_name)), JModel(_jcfg(cfg_name))
    specs = tp_.tree_specs(tm.param_defs(), stacked_paths=TModel.stacked_path)
    jspecs = jp_.tree_specs(jm.param_defs(), stacked_paths=JModel.stacked_path)
    assert tree_lib.leaves_with_paths(specs) == _spec_leaves(jspecs)
    dims = tm.mp_layout(tp_)
    for (path, spec), d in zip(tree_lib.leaves_with_paths(specs),
                               tree_lib.leaves(dims)):
        want = [i - len(spec) for i, a in enumerate(spec) if a == "model"]
        assert d == (want[0] if want else None), path
    by_vocab = tm.cfg.vocab % tp_.model_size == 0
    assert (dims["embed"], dims["head"]) == ((-2, -1) if by_vocab
                                             else (-1, -2))


@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_activation_specs_equal_reference(mesh_name):
    tp_ = tpl.Planner(mesh=_fake(mesh_name))
    jp_ = jpl.Planner(mesh=_jmesh(mesh_name))
    for batch in (1, 2, 4, 6, 8):
        assert tp_.batch_spec_axes(batch) == tuple(
            jp_.batch_spec_axes(batch))
        for extra in (1, 2):
            assert tp_.tokens_spec(batch, extra) == tuple(
                jp_.tokens_spec(batch, extra))
        for vocab in (510, 512):
            assert tp_.logits_spec(batch, vocab) == tuple(
                jp_.logits_spec(batch, vocab))
        for seq, n_kv in ((16, 2), (16, 3), (15, 3)):
            assert tp_.kv_cache_spec(batch, seq, n_kv) == tuple(
                jp_.kv_cache_spec(batch, seq, n_kv))
        for dim in (6, 8):
            assert tp_.state_spec(batch, dim) == tuple(
                jp_.state_spec(batch, dim))


def _row(b):
    return (b.index, b.n_elems, b.route, b.wire, b.fusable, b.ef,
            tuple(b.axes), b.t_model, b.intra_bytes, b.inter_bytes,
            b.scale_bytes, b.padded_elems,
            tuple((lg.leg, lg.level, lg.wire, lg.elems, lg.payload_bytes,
                   lg.scale_bytes) for lg in b.legs))


def _bucket_paths(plan):
    return [[tuple(plan.buckets.paths[i]) for i in b.leaf_ids]
            for b in plan.buckets.buckets]


def _jax_bucket_paths(plan):
    leaves = jax.tree_util.tree_leaves_with_path(
        jax.tree_util.tree_unflatten(plan.buckets.treedef,
                                     [0] * plan.buckets.treedef.num_leaves))
    paths = [tuple(k.key for k in path) for path, _ in leaves]
    return [[paths[i] for i in b.leaf_ids] for b in plan.buckets.buckets]


STATS = {"4x2_fp32": ("4x2", {}),
         "4x2_int8_ef": ("4x2", {"wire": "int8", "error_feedback": True}),
         "4x2_bf16_topo": ("4x2", {"wire": "bf16", "topo":
                                   "cloud-virtio-sriov"}),
         "2x2x2_hier_int8": ("2x2x2", {"wire": "int8", "hier": True})}


@pytest.mark.parametrize("name", list(STATS))
def test_comm_stats_and_buckets_equal_reference(name):
    """The plan on the global leaf shapes: the reference's bucket
    boundaries, fusability and routes, and `CommStats.from_plan`'s legs,
    bytes, routes and modeled seconds exactly; each rank's leafwise
    buckets hold its local shards."""
    mesh_name, kw = STATS[name]
    comm = dict(mode="mlsl", **kw)
    cfg_t, cfg_j = _tcfg("smoke"), _jcfg("smoke")
    fake = _fake(mesh_name)
    teng = ttr.make_comm_engine(TModel(cfg_t), fake, tpl.Planner(mesh=fake),
                                ttr.CommConfig(**comm))
    jm = _jmesh(mesh_name)
    jeng = jtr.make_comm_engine(JModel(cfg_j), jm, jpl.Planner(mesh=jm),
                                jtr.CommConfig(**comm))
    tp_, jp_ = teng.plan, jeng.plan
    assert _bucket_paths(tp_) == _jax_bucket_paths(jp_)
    assert (tp_.fusable, tp_.algos, tp_.dp, tp_.data_axes) == \
        (jp_.fusable, jp_.algos, jp_.dp, jp_.data_axes)
    assert sum(tp_.fusable) == 2            # the norm buckets only
    measured = tuple(1e-3 * (i + 1) for i in range(tp_.n_buckets))
    got, want = teng.stats(measured=measured), jeng.stats(measured=measured)
    assert [_row(b) for b in got.buckets] == [_row(b) for b in want.buckets]
    assert got.table().splitlines()[1:] == want.table().splitlines()[1:]
    assert got.to_metrics() == want.to_metrics()
    m = fake.shape[-1]
    for bi, b in enumerate(tp_.buckets.buckets):
        for glob, loc in zip(b.shapes, tp_.shapes_for(bi)):
            n_glob, n_loc = int(np.prod(glob)), int(np.prod(loc))
            assert n_glob == (n_loc if tp_.fusable[bi] else m * n_loc)


def test_engine_leafwise_buckets_are_local_allreduces(port):
    """At (4, 2) on the int8 wire with error feedback: every leafwise
    bucket's output is `collectives.allreduce` of the rank's local shard
    over the data group (bf16 wire, mean) bit for bit, the two fused norm
    buckets the EF int8 allreduce over the data group, and the bucket
    replay runs on each rank's shard shapes (positive, the same tuple on
    every rank)."""
    recs = port["engine"]
    for r in recs:
        assert r["fusable"].count(True) == 2
        assert r["leafwise_equal"] and all(r["leafwise_equal"])
        assert len(r["fused_equal"]) == 2 and all(r["fused_equal"])
        assert len(r["replay"]) == len(r["fusable"])
        assert all(t > 0 for t in r["replay"])
        assert r["replay"] == recs[0]["replay"]
        assert r["local_shapes"] == recs[0]["local_shapes"]
    assert recs[0]["hier_coords"] == [
        [r // 4, r // 2 % 2, r % 2] for r in range(WORLD)]


def test_mp_layout_rejects_a_layout_it_cannot_run():
    """A spec the model-parallel forward has no collectives for raises,
    naming the leaf and its spec; nothing is replicated in its place."""
    class RowSplitProjIn(tpl.Planner):
        def spec_for(self, pd, *, stacked=False, model_ok=True):
            spec = super().spec_for(pd, stacked=stacked, model_ok=model_ok)
            if pd.kind == tpl.K_PROJ_IN and pd.shape[-1] == 128:
                return (None, "model", None)
            return spec
    planner = RowSplitProjIn(mesh=_fake("4x2"))
    with pytest.raises(ValueError, match=r"cannot run blocks/p0_attn/attn/wk "
                                         r"with spec \(None, 'model', None\)"):
        TModel(_tcfg("smoke")).mp_layout(planner)


def test_hier_mesh_with_a_model_axis_needs_every_rank():
    with pytest.raises(RuntimeError, match="the mesh needs 8 ranks but the "
                                           "world has 1"):
        tmesh.make_hier_mesh(2, 2, 2, device="cpu")


# ---------------------------------------------------------------------------
# training against the JAX trainer
# ---------------------------------------------------------------------------

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
    """atol 1e-4. LAMB divides each gradient element by its own scale, as
    Adam does, so a near-zero element's update can change sign: at this
    setting the port at one rank already lands up to 1.4e-4 from the
    reference at one rank on 2 of the embedding's 131,072 elements. So
    under LAMB at most 1e-4 of a leaf's elements may exceed 1e-4, none
    5e-4."""
    _, final = port[name]
    _, want = ref[name]
    got = jax.tree_util.tree_leaves(final)
    want = jax.tree_util.tree_leaves(want)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        a, b = np.asarray(a), np.asarray(b)
        if CASES[name][3] != "lamb":
            np.testing.assert_allclose(a, b, atol=1e-4)
            continue
        diff = np.abs(a - b)
        assert (diff > 1e-4).mean() <= 1e-4 and diff.max() <= 5e-4, (
            int((diff > 1e-4).sum()), float(diff.max()))


@pytest.mark.parametrize("name", LOSSY)
def test_lossy_wires_stay_near_the_fp32_run(port, name):
    recs, _ = port[name]
    _replicated(recs)
    np.testing.assert_allclose(recs[0]["loss"], port["mlsl_4x2"][0][0]["loss"],
                               rtol=1e-3)


@pytest.mark.parametrize("name", list(CASES))
def test_ranks_hold_their_shards_and_restore_them_bitwise(port, name):
    """Every matrix is split over the model axis (the vocabulary of 510
    over 4 ranks: by the model dimension), the norm scales are whole; the
    gathered checkpoint restores each rank's shards bit for bit."""
    recs, final = port[name]
    cfg_name, mesh_name, _, _ = CASES[name]
    m = MESHES[mesh_name][-1]
    full = [list(a.shape) for a in jax.tree_util.tree_leaves(final)]
    for r in recs:
        assert r["restores_bitwise"]
        assert r["local_shapes"] == recs[0]["local_shapes"]
    split = [(f, l) for f, l in zip(full, recs[0]["local_shapes"]) if f != l]
    # wq wk wv wo w1 w2 w3 of the one stacked block, the embed, the head
    assert len(split) == 9, split
    for f, l in split:
        assert sum(a != b for a, b in zip(f, l)) == 1
        assert np.prod(f) == m * np.prod(l)


# ---------------------------------------------------------------------------
# the CLI on 8 gloo ranks through torchrun
# ---------------------------------------------------------------------------

def _torchrun(tmp_path, flags):
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT / "src"), os.environ.get("PYTHONPATH", "")]))
    env.pop("JAX_PLATFORMS", None)
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "8", "-m", "repro_torch.launch.train",
         "--device", "cpu", "--steps", "2", "--batch", "8", "--seq", "32",
         "--log-every", "1", *flags],
        env=env, cwd=tmp_path, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-4000:]
    out = proc.stdout.splitlines()
    losses = [float(l.split()[3]) for l in out if l.startswith("step")]
    assert len(losses) == 2 and all(np.isfinite(losses)), out
    return out


def test_cli_model_parallel_on_eight_gloo_ranks(tmp_path):
    """`--data-parallel 4 --model-parallel 2 --comm mlsl` runs instead of
    raising; its checkpoint holds the full tensors, which both packages
    restore to the same bits."""
    ckpt_dir = tmp_path / "ckpt"
    out = _torchrun(tmp_path, ["--data-parallel", "4", "--model-parallel",
                               "2", "--comm", "mlsl", "--ckpt-dir",
                               str(ckpt_dir)])
    assert any("mesh={'data': 4, 'model': 2}" in l for l in out)
    cfg = treg.get_smoke_config("yi-6b")
    like = {"params": tree_lib.tree_map(
        lambda pd: torch.empty(pd.shape, dtype=pd.dtype, device="meta"),
        TModel(cfg).param_defs())}
    mine = tckpt.restore(str(ckpt_dir), like, device="cpu")["params"]
    theirs = _load_params(ckpt_dir, "smoke")
    for path, a in tree_lib.leaves_with_paths(mine):
        b = theirs
        for k in path:
            b = b[k]
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_cli_model_parallel_on_the_hier_mesh(tmp_path):
    out = _torchrun(tmp_path, ["--hier", "--nodes", "2", "--local-size", "2",
                               "--model-parallel", "2", "--comm", "mlsl",
                               "--wire", "int8", "--error-feedback"])
    assert any("mesh={'node': 2, 'local': 2, 'model': 2}" in l for l in out)


# ---------------------------------------------------------------------------
# FSDP on gspmd against the JAX trainer with Planner(fsdp=True)
# ---------------------------------------------------------------------------

YI_FSDP = [n for n in FSDP_CASES if FSDP_CASES[n][0] == "smoke"]
GROK_FSDP = [n for n in FSDP_CASES if FSDP_CASES[n][0] == "grok"]
# the MoE cases: the most tokens of a moe layer's 256 whose top-k experts
# may differ from the reference's at a later step
FSDP_FLIP_MAX = 32


def _jax_route_ids(jm, params, batch) -> list:
    """The reference's top-k expert ids of every moe layer, in the
    forward's order, on `batch` from `params`: [layer][token] of k ids in
    ascending order."""
    ids, route = [], jmoe.route

    def spy(*args, **kw):
        out = route(*args, **kw)
        ids.append(np.sort(np.asarray(out[1]), axis=-1).tolist())
        return out

    jmoe.route = spy
    try:
        jm.loss(params, batch, unroll=True)
    finally:
        jmoe.route = route
    return ids


@pytest.fixture(scope="module")
def fsdp_ref(inputs):
    """The JAX trainer with Planner(mesh, fsdp=True) per case of
    FSDP_CASES: (losses, gradient norms), final parameters, and for the MoE
    cases each step's route ids from the parameters the step starts from."""
    _, _, params = inputs
    out = {}
    for name, (cfg_name, mesh_name, kw, optimizer) in FSDP_CASES.items():
        mesh = _jmesh(mesh_name, FSDP_MESHES)
        cfg = _jcfg(cfg_name)
        model = JModel(cfg)
        opt = jopt.make_optimizer(optimizer, FSDP_LR)
        planner = jpl.Planner(mesh=mesh, fsdp=True)
        dcfg = jpipe.DataConfig(vocab=cfg.vocab, seq_len=SEQ,
                                global_batch=FSDP_BATCH, seed=DATA_SEED)
        metrics, ids = [], []
        with compat.set_mesh(mesh):
            p = jax.tree_util.tree_map(jnp.asarray, params[cfg_name])
            state = jtr.TrainState(params=p, opt_state=opt.init(p),
                                   step=jnp.zeros((), jnp.int32))
            step = jax.jit(jtr.make_train_step(model, opt, mesh, planner,
                                               jtr.CommConfig(**kw)))
            for raw in jpipe.iterate(dcfg, STEPS):
                b = JBatch(tokens=jnp.asarray(raw["tokens"]),
                           labels=jnp.asarray(raw["labels"]))
                if cfg.moe is not None:
                    ids.append(_jax_route_ids(model, state.params, b))
                state, m = step(state, b)
                metrics.append((float(m["loss"]), float(m["grad_norm"])))
        out[name] = (metrics, jax.tree_util.tree_map(np.asarray,
                                                     state.params), ids)
    return out


def _flips(got, want) -> list:
    """Per step and moe layer, the tokens whose set of top-k experts
    differs between two route-id records."""
    return [[int(np.any(np.asarray(g) != np.asarray(w), axis=-1).sum())
             for g, w in zip(gs, ws)] for gs, ws in zip(got, want)]


def _adam_family_params(final, want_params):
    """The parameters of an AdamW or LAMB run against the reference's:
    their step divides each gradient element by its own scale, so a
    near-zero element whose sign the reduction order flips moves by up to
    two steps of the learning rate, where the rest agree to rounding (here
    1 to 6 of a leaf's elements). The learning rate is the constant
    FSDP_LR, so the bound is 2 * FSDP_LR on every element; on yi-6b such an
    element read 1.4e-4 on one CPU and 6.9e-4 on another, which the
    reduction order of the CPU decides. At most 1e-4 of a leaf's elements
    may exceed 1e-4 (the rule of test_gathered_params_match_jax_trainer
    for LAMB)."""
    for a, b in zip(jax.tree_util.tree_leaves(final),
                    jax.tree_util.tree_leaves(want_params)):
        diff = np.abs(np.asarray(a) - b)
        assert (diff > 1e-4).mean() <= 1e-4 and diff.max() <= 2 * FSDP_LR, (
            int((diff > 1e-4).sum()), float(diff.max()))


@pytest.mark.parametrize("name", list(FSDP_CASES))
def test_fsdp_matches_jax_trainer(port, fsdp_ref, name):
    """yi-6b on (8, 1), (4, 2) (FSDP over "data" beside the model axis)
    and ("node", "local") = (2, 4) (FSDP over both axes), AdamW with 2
    microbatches and LAMB: the loss and gradient norm replicated on every
    rank, losses rtol 1e-4, gradient norms atol 1e-4 (both agree within
    1e-6 relative), the parameters gathered over every axis by
    `_adam_family_params`.

    grok-1 on (8, 1), one step a microbatch: the top-k expert sets of
    every moe layer, from the parameters each step starts from, equal the
    reference's. On the gather dispatch both route the global batch of 256
    tokens as one (one capacity, one load-balance term; the port's ranks
    from their counts per expert), on the ep dispatch each rank's 32
    tokens. There, and with the bf16 weight gather, losses and gradient
    norms are held as yi-6b's (both read within 5e-7 relative) and the
    parameters by `_adam_family_params` (2 of the gather dispatch's
    embedding elements read up to 1.1e-3). With the int8 weight gather a code that
    the shards' last bits move moves a weight by a step of the quantizer
    (step 2's loss 3.0e-4 apart): routes may move in at most
    FSDP_FLIP_MAX of a layer's 256 tokens after step 0, losses rtol 2e-3,
    gradient norms rtol 2e-2, and the parameters are not held."""
    recs, final = port[name]
    _replicated(recs)
    metrics, want_params, want_ids = fsdp_ref[name]
    got = np.array([recs[0]["loss"], recs[0]["grad_norm"]]).T
    want = np.array(metrics)
    cfg_name, _, kw, _ = FSDP_CASES[name]
    if cfg_name == "grok":
        flips = _flips(recs[0]["route_ids"], want_ids)
        assert not any(flips[0]) and max(map(max, flips)) <= FSDP_FLIP_MAX, \
            flips
        if kw.get("wgather_wire") == "int8":
            np.testing.assert_allclose(got[:, 0], want[:, 0], rtol=2e-3)
            np.testing.assert_allclose(got[:, 1], want[:, 1], rtol=2e-2)
            return
        assert not any(map(any, flips)), flips
    np.testing.assert_allclose(got[:, 0], want[:, 0], rtol=1e-4)
    np.testing.assert_allclose(got[:, 1], want[:, 1], rtol=0, atol=1e-4)
    _adam_family_params(final, want_params)


@pytest.mark.parametrize("name", list(FSDP_CASES))
def test_fsdp_ranks_hold_their_shards_and_restore_them_bitwise(port, name):
    """Each rank's parameters are the planner's shards (the batch axes'
    split and, at (4, 2), the model axis's); the parameters and the AdamW
    or LAMB state gathered into one checkpoint restore every rank's shards
    bit for bit."""
    recs, final = port[name]
    cfg_name, mesh_name, _, _ = FSDP_CASES[name]
    kind, *sizes = FSDP_MESHES[mesh_name]
    axes = dict(zip(("node", "local") if kind == "hier" else
                    ("data", "model"), sizes))
    model = TModel(_tcfg(cfg_name))
    specs = tpl.Planner(mesh=axes, fsdp=True).tree_specs(
        model.param_defs(), stacked_paths=TModel.stacked_path)
    want, n_split = [], 0
    for (_, spec), a in zip(tree_lib.leaves_with_paths(specs),
                            jax.tree_util.tree_leaves(final)):
        shape = list(np.shape(a))
        for d, entry in enumerate(spec):
            for ax in (entry if isinstance(entry, tuple) else (entry,)):
                shape[d] //= axes.get(ax, 1)
        want.append(shape)
        n_split += shape != list(np.shape(a))
    assert n_split >= 9
    for r in recs:
        assert r["restores_bitwise"]
        assert r["local_shapes"] == want
