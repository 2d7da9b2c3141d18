"""The port's multi-pod dry-run (`repro_torch.launch.dryrun`) and roofline
against the reference's (`repro.launch.dryrun`):

  * the assigned shapes, the configs' long-decode properties, the active
    parameter estimate, the skip rule and the model FLOPs: equal for all
    ten archs and four shapes;
  * rank 0's shard shapes of the parameters and the optimizer state (the
    train planner) and of the decode cache (the serving planner, decode_32k)
    on ("data", "model") = (2, 4): equal to the reference's
    `NamedSharding(...).shard_shape` for yi-6b, grok-1-314b and mamba2-2.7b
    at full width (the reference builds them from `param_specs_sds`,
    `train_state_sds` and `cache_spec_tree` without compiling);
  * the counted FLOPs of a smoke yi-6b forward: 2 x tokens x matmul
    parameters plus the attention's products, derived below;
  * the CLI in subprocesses over a fake world (a timeout each): mamba2
    long_500k `[ok]` with the reference's record keys, rendered by
    `scripts/roofline_table.py`; whisper long_500k `skipped` with the
    reference's reason; yi-6b train_4k on mlsl int8 with `--stats`, whose
    collectives' bytes equal the plan's `CommStats` bucket by bucket, but
    for the one difference a model axis makes (stated at the test);
  * cell A's configuration on the smoke config at world size 1: the
    predicted parameter, optimizer, gradient and residual bytes equal a
    real run's state's.
"""

import json
import os
import pathlib
import subprocess
import sys

import jax
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from repro.configs import base as jbase, registry as jreg
from repro.configs import shapes as jshapes
from repro.core import planner as jpl
from repro.launch import mesh as jmesh
from repro.models.transformer import Model as JModel
from repro_torch import tree as tree_lib
from repro_torch.configs import base as tbase, registry as treg
from repro_torch.configs import shapes as tshapes
from repro_torch.core import planner as tpl
from repro_torch.kernels import flashattn
from repro_torch.launch import dryrun as tdry
from repro_torch.models.transformer import Batch as TBatch, Model as TModel
from repro_torch.train import trainer as ttr

ROOT = pathlib.Path(__file__).resolve().parents[1]
SHARD_ARCHS = ("yi-6b", "grok-1-314b", "mamba2-2.7b")
MESH24 = {"data": 2, "model": 4}
# the reference's record keys (cost_block, the layerwise correction's, has
# no counterpart: the eager counters see every layer)
REF_KEYS = {"arch", "shape", "mesh", "chips", "comm", "fsdp", "parallelism",
            "n_params", "lower_s", "compile_s", "memory", "cost_full",
            "roofline", "status", "wall_s"}


@pytest.fixture(scope="module")
def jdry():
    """The reference's dry-run module. Importing it sets XLA_FLAGS for 512
    host devices; the suite's backend is started first and the variable put
    back, so the import changes nothing else in this process."""
    jax.devices()
    saved = os.environ.get("XLA_FLAGS")
    try:
        from repro.launch import dryrun
    finally:
        if saved is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = saved
    return dryrun


def test_shapes_equal_reference():
    assert list(tshapes.SHAPES) == list(jshapes.SHAPES)
    for name, s in tshapes.SHAPES.items():
        j = jshapes.SHAPES[name]
        assert (s.name, s.seq_len, s.global_batch, s.kind) == \
            (j.name, j.seq_len, j.global_batch, j.kind)


@pytest.mark.parametrize("arch", jreg.ARCH_IDS)
def test_config_properties_equal_reference(arch):
    t, j = treg.get_config(arch), jreg.get_config(arch)
    assert t.supports_long_decode == j.supports_long_decode
    assert t.is_native_long == j.is_native_long
    assert tbase.active_param_count_estimate(t) == \
        jbase.active_param_count_estimate(j)


@pytest.mark.parametrize("shape", list(jshapes.SHAPES))
@pytest.mark.parametrize("arch", jreg.ARCH_IDS)
def test_skip_rule_and_model_flops_equal_reference(jdry, arch, shape):
    t, j = treg.get_config(arch), jreg.get_config(arch)
    ts, js = tshapes.SHAPES[shape], jshapes.SHAPES[shape]
    assert tdry.should_skip(t, ts) == jdry.should_skip(j, js)
    assert tdry.model_flops_for(t, ts) == jdry.model_flops_for(j, js)


def _bpp(cfg, train: bool) -> float:
    """The dry-run's state bytes a parameter, as both dry-runs set it."""
    if not train:
        return 2.0
    return 2.0 + 2.0 * (2.0 if jbase.param_count_estimate(cfg) > 100e9
                        else 4.0)


def _ref_shards(tree) -> list:
    return [(tuple(l.sharding.shard_shape(l.shape)), str(l.dtype))
            for l in jax.tree_util.tree_leaves(tree)]


def _port_shards(tree) -> list:
    return [(tuple(t.shape), str(t.dtype).replace("torch.", ""))
            for t in tree_lib.leaves(tree)]


@pytest.mark.parametrize("arch", SHARD_ARCHS)
def test_train_state_shards_equal_reference(jdry, arch):
    """Parameters and AdamW state (bf16 moments past 100 B parameters) of
    rank 0 on (2, 4), under each dry-run's train planner."""
    jcfg, tcfg = jreg.get_config(arch), treg.get_config(arch)
    mesh = jmesh.make_host_mesh(2, 4)
    n = jbase.param_count_estimate(jcfg)
    jp = jpl.make_planner(mesh, n, train=True,
                          bytes_per_param_state=_bpp(jcfg, True))
    tp = tpl.make_planner(MESH24, n, train=True,
                          bytes_per_param_state=_bpp(jcfg, True))
    assert tp.fsdp == jp.fsdp
    jm, tm = JModel(jcfg), TModel(tcfg)
    jstate = jdry.train_state_sds(jm, jdry._opt_for(jcfg), mesh, jp)
    tstate = tdry.train_state_meta(tm, tdry._opt_for(tcfg), MESH24, tp,
                                   ttr.CommConfig())
    assert _port_shards(tstate.params) == _ref_shards(jstate.params)
    assert _port_shards(tstate.opt_state) == _ref_shards(jstate.opt_state)
    assert any(s != p.shape for s, p in zip(
        _port_shards(tstate.params), tree_lib.leaves(tm.param_defs())))


@pytest.mark.parametrize("arch", SHARD_ARCHS)
def test_decode_cache_shards_equal_reference(jdry, arch):
    """The decode_32k cache of 128 rows x 32768 positions, rank 0's shard
    on (2, 4) under the serving planner, leaf by leaf."""
    jcfg, tcfg = jreg.get_config(arch), treg.get_config(arch)
    shape = jshapes.SHAPES["decode_32k"]
    B, S = shape.global_batch, shape.seq_len
    mesh = jmesh.make_host_mesh(2, 4)
    n = jbase.param_count_estimate(jcfg)
    jp = jpl.make_planner(mesh, n, train=False, bytes_per_param_state=2.0)
    tp = tpl.make_planner(MESH24, n, train=False, bytes_per_param_state=2.0)
    jcache = jax.eval_shape(lambda: JModel(jcfg).init_cache(B, S))
    jshards = jdry.cache_spec_tree(jcache, jp, B, mesh)
    tcache = TModel(tcfg).init_cache(B, S, device="meta")
    tshards, _ = tdry.cache_spec_tree(tcache, tp, B, MESH24)
    assert [tuple(str(k.key) for k in p) for p, _ in
            jax.tree_util.tree_leaves_with_path(jshards)] == \
        tree_lib.paths(tshards)
    assert _port_shards(tshards) == _ref_shards(jshards)
    assert any(tuple(a.shape) != tuple(b.shape) for a, b in zip(
        tree_lib.leaves(tshards), tree_lib.leaves(tcache)))


def _meta_params(model):
    return tree_lib.tree_map(
        lambda pd: torch.empty(pd.shape, dtype=pd.dtype, device="meta"),
        model.param_defs())


def _matmul_params(cfg) -> int:
    """Parameters that enter a matrix product per token of the yi-6b
    smoke model: per layer wq, wk, wv, wo and the gated MLP's three
    matrices, then the head (the embedding is a lookup)."""
    a, d = cfg.attn, cfg.d_model
    per_layer = (2 * d * a.n_heads * a.head_dim + 2 * d * a.n_kv * a.head_dim
                 + 3 * d * cfg.d_ff)
    return cfg.n_layers * per_layer + d * cfg.vocab


def test_train_forward_flops_are_matmul_params_and_attention():
    """The loss forward with autograd recording (the train step's
    forward): 2 x B S x the matmul parameters, plus per layer the dense
    attention's two products, q k^T and p v, 2 B H S^2 hd each (the
    causal mask saves no work in `_sdpa`)."""
    cfg = treg.get_smoke_config("yi-6b")
    model, B, S = TModel(cfg), 2, 64
    params = _meta_params(model)
    for p in tree_lib.leaves(params):
        p.requires_grad_(True)
    tok = torch.empty((B, S), dtype=torch.int32, device="meta")
    a = cfg.attn
    want = (2 * B * S * _matmul_params(cfg)
            + cfg.n_layers * 4 * B * a.n_heads * S * S * a.head_dim)
    with FlopCounterMode(display=False) as fc:
        model.loss(params, TBatch(tokens=tok, labels=tok))
    assert fc.get_total_flops() == want


def test_prefill_flops_count_the_flash_shape_operator():
    """`Model.prefill` on meta: the blocks' matmuls over B S tokens, the
    head on the last token only, and the flash wrapper's shape operator at
    4 hd a visible (query, key) pair, S (S + 1) / 2 of them causal."""
    flashattn.meta_shape_op()
    cfg = treg.get_smoke_config("yi-6b")
    model, B, S = TModel(cfg), 2, 64
    a, d = cfg.attn, cfg.d_model
    tok = torch.empty((B, S), dtype=torch.int32, device="meta")
    blocks = _matmul_params(cfg) - d * cfg.vocab
    want = (2 * B * S * blocks + 2 * B * d * cfg.vocab
            + cfg.n_layers * 4 * B * a.n_heads * a.head_dim * S * (S + 1) // 2)
    with FlopCounterMode(display=False) as fc:
        model.prefill(_meta_params(model), TBatch(tokens=tok), S)
    assert fc.get_total_flops() == want


def _run(code: str, timeout: float = 240) -> str:
    """Run `code` in a fresh interpreter with JAX and the reference
    blocked; returns its stdout."""
    pre = ("import sys\nsys.modules['jax'] = None\n"
           "sys.modules['repro'] = None\n")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([str(ROOT / "src"),
                                                       str(ROOT)]))
    proc = subprocess.run([sys.executable, "-c", pre + code], env=env,
                          cwd=ROOT, capture_output=True, text=True,
                          timeout=timeout)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return proc.stdout


def test_cli_mamba2_long_500k_ok_with_the_reference_keys(tmp_path):
    """The reference's own multi-device case (tests/test_multidevice.py):
    mamba2-2.7b long_500k on the 256-rank mesh; then the roofline table
    renders the directory."""
    out = _run("from repro_torch.launch import dryrun\n"
               "raise SystemExit(dryrun.main(['--arch', 'mamba2-2.7b', "
               f"'--shape', 'long_500k', '--out', {str(tmp_path)!r}]))\n")
    assert "[ok] mamba2-2.7b__long_500k__pod16x16" in out, out
    rec = json.loads((tmp_path / "mamba2-2.7b__long_500k__pod16x16.json")
                     .read_text())
    assert REF_KEYS <= set(rec) and "cost_block" not in rec
    assert rec["chips"] == 256 and rec["status"] == "ok"
    assert rec["cost_full"]["flops"] > 0 and rec["memory"]["argument_bytes"] > 0
    r = rec["roofline"]
    assert r["dominant"] in ("compute", "memory", "collective")
    assert r["t_memory"] == pytest.approx(
        rec["cost_full"]["bytes accessed"] / 3.35e12)
    proc = subprocess.run([sys.executable, "scripts/roofline_table.py",
                           str(tmp_path)], cwd=ROOT, capture_output=True,
                          text=True, timeout=60)
    assert proc.returncode == 0, proc.stderr
    assert "| mamba2-2.7b | long_500k |" in proc.stdout


def test_cli_whisper_long_500k_skipped_with_the_reference_reason(jdry,
                                                                 tmp_path):
    _run("from repro_torch.launch import dryrun\n"
         "raise SystemExit(dryrun.main(['--arch', 'whisper-small', "
         "'--shape', 'long_500k', '--both-meshes', '--out', "
         f"{str(tmp_path)!r}]))\n")
    want = jdry.should_skip(jreg.get_config("whisper-small"),
                            jshapes.SHAPES["long_500k"])
    for mesh in ("pod16x16", "pod2x16x16"):
        rec = json.loads((tmp_path / f"whisper-small__long_500k__{mesh}"
                          ".json").read_text())
        assert rec["status"] == "skipped" and rec["reason"] == want


_STATS = """
import json, math
from repro_torch import tree as tree_lib
from repro_torch.configs import registry
from repro_torch.configs.base import param_count_estimate
from repro_torch.core.planner import make_planner
from repro_torch.launch import dryrun as d
from repro_torch.models.transformer import Model
from repro_torch.train import trainer as tr
comm = tr.CommConfig(mode="mlsl", wire="int8")
rec = d.dryrun_one("yi-6b", "train_4k", comm=comm, comm_stats=True)
mesh, _ = d.make_mesh()
cfg = registry.get_config("yi-6b")
model = Model(cfg)
planner = make_planner(mesh, param_count_estimate(cfg), train=True,
                       bytes_per_param_state=10.0)
engine = tr.make_comm_engine(model, mesh, planner, comm, device="meta")
defs = tree_lib.leaves(model.param_defs())
specs = tree_lib.leaves(tr.param_specs(model, planner))
local = [math.prod(d.shard_shape(p.shape, s, mesh)) for p, s in zip(defs, specs)]
buckets = [{"whole": sum(defs[i].size for i in b.leaf_ids),
            "local": sum(local[i] for i in b.leaf_ids)}
           for b in engine.plan.buckets.buckets]
print(json.dumps({"status": rec["status"], "bucket_bytes": rec["bucket_bytes"],
                  "fsdp": rec["fsdp"], "buckets": buckets}))
"""


def test_cli_mlsl_int8_collective_bytes_equal_comm_stats():
    """yi-6b train_4k, mlsl on the int8 wire, pod16x16: the bytes of the
    collectives each bucket's range issued on rank 0 (a reduce-scatter's
    input, an all-gather's or all-reduce's output: the messages
    `obs.stats.LegBytes` counts) against `CommStats`, bucket by bucket. A
    fused bucket (replicated leaves: the norms) carries exactly CommStats'
    bytes. A leafwise bucket travels on the bf16 wire leaf by leaf; under
    the model axis of 16 each rank reduces its own shard of each leaf, so
    it carries 2 bytes a local element where CommStats, like the
    reference's, counts the whole leaf's 2 bytes an element (ROADMAP.md
    queue 3)."""
    got = json.loads(_run(_STATS).strip().splitlines()[-1])
    assert got["status"] == "ok" and not got["fsdp"]
    rows, buckets = got["bucket_bytes"], got["buckets"]
    assert len(rows) == len(buckets) > 2
    assert any(r["fusable"] for r in rows) and not all(r["fusable"]
                                                       for r in rows)
    for r, b in zip(rows, buckets):
        if r["fusable"]:
            assert r["counted"] == r["stats"] > 0, r
        else:
            assert r["stats"] == 2 * b["whole"], (r, b)
            assert r["counted"] == 2 * b["local"] < r["stats"], (r, b)


_STATE = """
import json
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh
from repro_torch.configs import registry
from repro_torch.configs.shapes import InputShape
from repro_torch.core.planner import Planner
from repro_torch.launch import dryrun as d, train as train_lib
from repro_torch import tree as tree_lib
from repro_torch.train import trainer as tr
comm = dict(mode="mlsl", wire="int8", error_feedback=True, accum_steps=2)
cfg = registry.get_smoke_config("yi-6b")
d.start_fake_world(1)
mesh = init_device_mesh("cpu", (1, 1), mesh_dim_names=("data", "model"))
rec = d.dryrun_one("yi-6b", "A", cfg=cfg, shape=InputShape("A", 32, 8, "train"),
                   comm=tr.CommConfig(**comm), mesh=mesh, mesh_name="host1x1",
                   planner=Planner(mesh=mesh))
dist.destroy_process_group()
_, state = train_lib.train(cfg, tr.CommConfig(**comm), steps=2, batch=8,
                           seq=32, device="cpu")
n = lambda ts: sum(t.numel() * t.element_size() for t in ts)
real = {"params": n(tree_lib.leaves(state.params)),
        "opt_state": n(tree_lib.leaves(state.opt_state)),
        "grads": n(tree_lib.leaves(state.params)),
        "residuals": n(state.comm_residuals)}
print(json.dumps({"predicted": rec["state_bytes"], "real": real,
                  "memory": rec["memory"]}))
"""


def test_predicted_train_state_bytes_equal_a_real_state():
    """Cell A's configuration (mlsl, int8 + EF, 2 microbatches) on the yi-6b
    smoke config at world size 1: the dry-run's parameter, optimizer,
    gradient and residual bytes equal those of the state a real run on the
    CPU ends with (chip_smoke.py holds the same at full width on the card);
    the arguments are that state and rank 0's batch."""
    got = json.loads(_run(_STATE).strip().splitlines()[-1])
    assert got["predicted"] == got["real"]
    assert got["real"]["residuals"] > 0
    p = got["predicted"]
    assert got["memory"]["argument_bytes"] == (
        p["params"] + p["opt_state"] + p["residuals"] + 2 * 8 * 32 * 4)
