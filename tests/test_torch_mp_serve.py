"""Model-parallel serving of every family of the registry, on 8 gloo ranks,
against the JAX reference's `Model.prefill` / `decode_step` on the same
numpy inputs and the reference's weights.

The cases (tests/torch_mp_serve_ranks.py, which the file spawns once as one
group of 8 ranks, torch only): the ten smoke configs at ("data", "model")
= (2, 4) under `Planner(mesh)` (KV heads split by head, chatglm3-6b's and
recurrentgemma-2b's caches by slot, minicpm3-4b's latent by slot, the
SSM's and RG-LRU's states by head and channel); yi-6b, minicpm3-4b,
whisper-small, mamba2-2.7b and grok-1-314b at (1, 8), where the heads
split past their count (the gathered heads); yi-6b and grok-1-314b under
`Planner(mesh, fsdp=True)`; grok-1-314b's prefill on the ep dispatch,
beside FSDP on the int8 weight gather too; yi-6b's int8 cache at (1, 8)
(split by slot); llava's long-context ring (window 64, a prompt of 80 +
8 image tokens) at (1, 8).

Each case: a prefill of a batch of 4 (a data rank's rows each), prompt 24,
then 6 decode steps fed the reference's greedy tokens. Tolerances (the
archs suite's, tests/torch_archs_suite.py): logits at every step within
atol 1e-4 (the sums are taken in another order, the slot-split softmax
combined over the ranks); `Engine.generate`'s greedy tokens equal; each
rank's cache leaves after the prefill and after the last step equal to
the reference cache's shard on the matching device within atol 1e-4, the
shards cut by `jax.device_put` with the reference's own
`repro.launch.dryrun.cache_spec_tree` shardings on an 8-device CPU mesh
(int8 codes within one, f16 scales within one ulp: ROADMAP's serving
contract; the int8 case decodes each step from the reference's cache, as
tests/test_torch_serve.py does). The ep cases are held to the reference's
prefill on its ep dispatch (`moe_impl="ep"` over the same mesh: each model
rank routes its slice of its data rank's tokens at their own capacity),
whose decode, like the port's, gathers.

grok-1-314b's ep prefill under FSDP on the int8 weight gather is held at
atol INT8_GATHER_ATOL = 1e-3 (logits and caches): the port's quantizer is
bitwise the reference's eager one (tests/test_torch_quant8.py), but the
reference's under `jax.jit` rounds some of the smoke layer's codes or
scales one off its eager result (169 of them over grok-1's six expert
leaves, from a check of both on the same shards), and a code one off moves
a weight by a step of its block's scale: the port read 1.05e-4 in the
logits and 2.9e-4 in a cache from the reference. The int8 wire itself
moves the reference's logits by up to 4.2e-2 from its bf16 gather on the
same inputs, forty times the tolerance, so a gather that skipped or
misplaced the quantization fails it.

The reference also runs sharded itself for yi-6b, chatglm3-6b and
minicpm3-4b at (2, 4): `jax.jit` with `planner.tree_shardings` and the
`cache_spec_tree` shardings, as its dry-run's build_prefill/build_decode
lay them out; its logits equal its unsharded run's within 1e-4.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import NamedSharding, PartitionSpec as P

from repro import compat
from repro.checkpoint import ckpt as jckpt
from repro.configs import registry as jreg
from repro.core import planner as jpl
from repro.launch import mesh as jmesh
from repro.models.transformer import Batch as JBatch, Model as JModel

import torch_spawn
from torch_mp_serve_ranks import (BATCH, CASES, DECODE_STEPS, max_seq,
                                  prompt_len)

WORLD = 8
INT8_GATHER_ATOL = 1e-3
SHARDED_REF = ("yi_2x4", "chatglm3_2x4", "minicpm3_2x4")


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


def _stub(cfg, seed: int) -> dict:
    """Standard-normal patch / frame embeddings (numpy f32) from a seed."""
    rng = np.random.default_rng(seed)
    kw = {}
    if cfg.vlm_img_tokens:
        kw["img_embeds"] = rng.standard_normal(
            (BATCH, cfg.vlm_img_tokens, cfg.vlm_d_vision)).astype(np.float32)
    if cfg.encoder is not None:
        kw["frame_embeds"] = rng.standard_normal(
            (BATCH, cfg.encoder.n_frames, cfg.encoder.d_input)
        ).astype(np.float32)
    return kw


def _mesh(name):
    return jmesh.make_host_mesh(*CASES[name][1])


def _ctx_kw(name) -> dict:
    """The reference's serving options of a case: the engine's long-context
    window and int8 cache, and the ep dispatch's mesh options (as its
    dry-run's `_ctx_kw` passes them)."""
    arch, _, kind, comm_kw, eng_kw = CASES[name]
    cfg = jreg.get_smoke_config(arch)
    kw = {}
    if eng_kw.get("long_context"):
        kw["window_override"] = cfg.long_context_window
    if eng_kw.get("kv_dtype"):
        kw["kv_dtype"] = eng_kw["kv_dtype"]
    if comm_kw.get("moe_impl") == "ep":
        kw.update(moe_impl="ep", mesh=_mesh(name), batch_axes=("data",),
                  fsdp_axes=("data",) if kind == "fsdp" else (),
                  wgather_wire=comm_kw.get("wgather_wire", "bf16"))
    return kw


def _reference(name, params):
    """The reference's prefill and DECODE_STEPS greedy decode steps: (its
    logits (1 + steps, B, V), its caches before each step and after the
    last, its greedy tokens (B, 1 + steps), the inputs)."""
    arch = CASES[name][0]
    jm = JModel(jreg.get_smoke_config(arch))
    seed = sum(map(ord, name))
    tokens = np.random.default_rng(seed).integers(
        0, jm.cfg.vocab, (BATCH, prompt_len(name))).astype(np.int32)
    stub = _stub(jm.cfg, seed + 1)
    kw = _ctx_kw(name)
    with compat.set_mesh(_mesh(name)):
        logits, cache, S = jax.jit(lambda p, b: jm.prefill(
            p, b, max_seq(name), **kw))(params, JBatch(
                tokens=jnp.asarray(tokens),
                **{k: jnp.asarray(v) for k, v in stub.items()}))
        dec = jax.jit(lambda p, c, t, pos: jm.decode_step(p, c, t, pos,
                                                           **kw))
        out, caches, toks = [logits], [cache], []
        for i in range(DECODE_STEPS):
            toks.append(np.asarray(jnp.argmax(out[-1], axis=-1)).astype(
                np.int32))
            logits, cache = dec(params, cache, jnp.asarray(toks[-1][:, None]),
                                jnp.int32(int(S) + i))
            out.append(logits)
            caches.append(cache)
    toks.append(np.asarray(jnp.argmax(out[-1], axis=-1)).astype(np.int32))
    return (np.stack([np.asarray(x) for x in out]), caches,
            np.stack(toks, axis=1), dict(tokens=tokens, **stub))


def _flat(tree) -> dict:
    return {"/".join(str(k.key) for k in p): np.asarray(a)
            for p, a in jax.tree_util.tree_leaves_with_path(tree)}


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    path = tmp_path_factory.mktemp("mp_serve_inputs")
    params = {}
    for arch in {c[0] for c in CASES.values()}:
        params[arch] = JModel(jreg.get_smoke_config(arch)).init(
            jax.random.PRNGKey(0))
        jckpt.save(str(path / arch), {"params": jax.tree_util.tree_map(
            np.asarray, params[arch])}, step=0)
    out = {}
    for name, (arch, *_, eng_kw) in CASES.items():
        logits, caches, toks, inputs = _reference(name, params[arch])
        feed = {}
        if eng_kw.get("kv_dtype") == "int8":
            for i, c in enumerate(caches[:DECODE_STEPS]):
                feed.update({f"cache{i}/{k}": v for k, v in _flat(c).items()})
        np.savez(path / f"{name}.npz", teacher=toks[:, :DECODE_STEPS],
                 **inputs, **feed)
        out[name] = (logits, caches[0], caches[-1], toks)
    return path, out, params


@pytest.fixture(scope="module")
def port(ref, tmp_path_factory):
    path = ref[0]
    out = tmp_path_factory.mktemp("mp_serve_ranks")
    torch_spawn.spawn("torch_mp_serve_ranks.py", WORLD,
                      tmp_path_factory.mktemp("store"), path, out,
                      ",".join(CASES), timeout=600)
    return {name: [np.load(out / name / f"rank{r}.npz")
                   for r in range(WORLD)] for name in CASES}


def _rank_rows(name, rank) -> slice:
    data, model = CASES[name][1]
    n = BATCH // data
    d = rank // model
    return slice(d * n, (d + 1) * n)


def _atol(name) -> float:
    int8_gather = CASES[name][3].get("wgather_wire") == "int8"
    return INT8_GATHER_ATOL if int8_gather else 1e-4


@pytest.mark.parametrize("name", list(CASES))
def test_logits_at_every_step_match_reference(ref, port, name):
    want = ref[1][name][0]
    for r, got in enumerate(port[name]):
        np.testing.assert_allclose(got["logits"],
                                   want[:, _rank_rows(name, r)], rtol=0,
                                   atol=_atol(name), err_msg=f"rank {r}")


@pytest.mark.parametrize("name", list(CASES))
def test_greedy_tokens_equal_reference(ref, port, name):
    want = ref[1][name][3][:, :DECODE_STEPS]
    for r, got in enumerate(port[name]):
        assert got["generated"].dtype == np.int32
        np.testing.assert_array_equal(got["generated"], want,
                                      err_msg=f"rank {r}")


def _device_shards(jdry, name, cache) -> dict:
    """rank -> {path: the reference cache leaf's shard on that rank's
    device}, laid out by the reference's `cache_spec_tree`."""
    mesh = _mesh(name)
    planner = jpl.Planner(mesh=mesh, fsdp=CASES[name][2] == "fsdp")
    specs = jdry.cache_spec_tree(cache, planner, BATCH, mesh)
    placed = jax.device_put(cache, jax.tree_util.tree_map(
        lambda s: s.sharding, specs))
    rank_of = {d: i for i, d in enumerate(mesh.devices.reshape(-1))}
    out = {r: {} for r in range(WORLD)}
    for key, leaf in _flat_arrays(placed).items():
        for sh in leaf.addressable_shards:
            out[rank_of[sh.device]][key] = np.asarray(sh.data)
    return out


def _flat_arrays(tree) -> dict:
    return {"/".join(str(k.key) for k in p): a
            for p, a in jax.tree_util.tree_leaves_with_path(tree)}


def _close(got, want, key, int8, atol):
    assert got.shape == want.shape, key
    if int8 and key.split("/")[-1] in ("k", "v", "k_s", "v_s"):
        codes = key.split("/")[-1] in ("k", "v")
        g, w = got.astype(np.float64), want.astype(np.float64)
        # int8 codes within one; f16 scales within one ulp of the larger
        step = 1.0 if codes else np.spacing(np.maximum(
            np.abs(got), np.abs(want))).astype(np.float64)
        assert (np.abs(g - w) <= step).all(), key
        return
    np.testing.assert_allclose(got, want, rtol=0, atol=atol, err_msg=key)


@pytest.mark.parametrize("when", ["prefill", "last"])
@pytest.mark.parametrize("name", list(CASES))
def test_cache_shards_equal_reference_layout(jdry, ref, port, name, when):
    cache = ref[1][name][1 if when == "prefill" else 2]
    int8 = CASES[name][4].get("kv_dtype") == "int8"
    want = _device_shards(jdry, name, cache)
    for r, got in enumerate(port[name]):
        keys = sorted(k[len(when) + 1:] for k in got.files
                      if k.startswith(when + "/"))
        assert keys == sorted(want[r]), r
        for k in keys:
            _close(got[f"{when}/{k}"], want[r][k], f"rank {r} {k}", int8,
                   _atol(name))


@pytest.mark.parametrize("name", SHARDED_REF)
def test_reference_sharded_serving_is_its_unsharded_function(jdry, ref,
                                                             name):
    """The reference's prefill and decode under `jax.jit` with the
    planner's parameter shardings and the `cache_spec_tree` shardings (its
    dry-run's build_prefill/build_decode layout) on the (2, 4) mesh: its
    logits within 1e-4 of its unsharded run's."""
    path, out, params = ref
    arch = CASES[name][0]
    jm = JModel(jreg.get_smoke_config(arch))
    mesh = _mesh(name)
    planner = jpl.Planner(mesh=mesh)
    inputs = np.load(path / f"{name}.npz")
    want = out[name][0]
    with compat.set_mesh(mesh):
        pshard = planner.tree_shardings(jm.param_defs(),
                                        stacked_paths=JModel.stacked_path)
        p = jax.device_put(params[arch], pshard)
        tokens = jax.device_put(jnp.asarray(inputs["tokens"]), NamedSharding(
            mesh, P("data", None)))
        logits, cache, S = jax.jit(lambda p, b: jm.prefill(
            p, b, max_seq(name)))(p, JBatch(tokens=tokens))
        np.testing.assert_allclose(np.asarray(logits), want[0], rtol=0,
                                   atol=1e-4)
        dec = jax.jit(lambda p, c, t, pos: jm.decode_step(p, c, t, pos))
        for i in range(DECODE_STEPS):
            # the cache laid out by the reference's cache_spec_tree before
            # each step, the tokens by the batch axis
            cache = jax.device_put(cache, jax.tree_util.tree_map(
                lambda s: s.sharding,
                jdry.cache_spec_tree(cache, planner, BATCH, mesh)))
            tok = jax.device_put(
                jnp.asarray(inputs["teacher"][:, i:i + 1]),
                NamedSharding(mesh, P("data", None)))
            logits, cache = dec(p, cache, tok, jnp.int32(int(S) + i))
            np.testing.assert_allclose(np.asarray(logits), want[i + 1],
                                       rtol=0, atol=1e-4,
                                       err_msg=f"step {i}")
