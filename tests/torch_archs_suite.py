"""The per-architecture tests of the port against the JAX reference,
shared by tests/test_torch_archs.py (llava, whisper),
test_torch_archs_mla.py (minicpm3), test_torch_archs_recurrent.py
(recurrentgemma, mamba2) and test_torch_archs_moe.py (grok-1, arctic):
each of those files names its architectures in a module-level `ARCHS`, and
`pytest_generate_tests` gives every test here that takes `arch` (directly
or through the `models` fixture) one case per architecture of the file
that collects it. `ranks8` spawns one group of 8 gloo ranks per file, for
that file's architectures.

Tolerances: logits and caches atol 1e-4 (the sums are taken in another
order); greedy tokens equal; decode against the full forward rel < 2e-2
and `kv_chunk=16` against dense rel < 1e-3 (the reference's own bounds,
tests/test_models.py and tests/test_models_chunked.py); the train step's
step-0 loss rtol 1e-5, later losses rtol 1e-4 on gspmd and 1e-3 on the
int8 wire (a rounding tie can move an int8 code); the decode-vs-forward case
runs the MoE archs at capacity factor 8.0, as the reference's own test does
(tests/test_models.py), so that neither path drops a token. On the CPU the
prefill's attention takes the flash kernel's plain version; the kernel
itself is held on the card by `chip_smoke.py`.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro import compat
from repro.checkpoint import ckpt as jckpt
from repro.configs import registry as jreg
from repro.core.planner import Planner as JPlanner
from repro.data import pipeline as jpipe
from repro.launch import mesh as jmesh
from repro.models import moe as jmoe
from repro.models.transformer import Batch as JBatch, Model as JModel
from repro.optim import optimizers as jopt, schedules as jsched
from repro.serve import engine as jengine
from repro.train import trainer as jtr
from repro_torch import convert, tree as tree_lib
from repro_torch.configs import registry as treg
from repro_torch.core import planner as tpl
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import serve as serve_cli, train as train_cli
from repro_torch.models import attention as tattn
from repro_torch.models.transformer import Batch as TBatch, Model as TModel
from repro_torch.optim import optimizers as topt, schedules as tsched
from repro_torch.serve import engine as tengine
from repro_torch.train import trainer as ttr
import torch

import torch_spawn
from torch_archs_ranks import BATCH, CASES, COMM, SEQ, STEPS, stub_inputs

MAX_SEQ = 48
# the 8-rank int8 + EF MoE runs: the most tokens of a moe layer's 256 whose
# top-k experts may differ from the reference's at a later step
FLIP_MAX = 32
# the serve CLI hands the engine no frame embeddings: whisper-small's case
# is test_serve_cli_refuses_whisper_without_frames
NO_SERVE_CLI = ("whisper-small",)


def pytest_generate_tests(metafunc):
    """One case per architecture of the collecting module's ARCHS, at
    module scope (the `models` fixture converts each arch's weights
    once)."""
    if "arch" in metafunc.fixturenames:
        archs = metafunc.module.ARCHS
        if metafunc.function.__name__ == "test_serve_cli_runs_on_cpu":
            archs = [a for a in archs if a not in NO_SERVE_CLI]
        metafunc.parametrize("arch", archs, scope="module")


def _stub(cfg, batch: int, seed: int) -> dict:
    """Standard-normal patch / frame embeddings (numpy f32) from a seed."""
    rng = np.random.default_rng(seed)
    kw = {}
    if cfg.vlm_img_tokens:
        kw["img_embeds"] = rng.standard_normal(
            (batch, cfg.vlm_img_tokens, cfg.vlm_d_vision)).astype(np.float32)
    if cfg.encoder is not None:
        kw["frame_embeds"] = rng.standard_normal(
            (batch, cfg.encoder.n_frames, cfg.encoder.d_input)
        ).astype(np.float32)
    return kw


def _batches(tokens, stub, labels=False):
    """The same inputs as the reference's and the port's Batch."""
    lab = {"labels": tokens} if labels else {}
    jb = JBatch(tokens=jnp.asarray(tokens),
                **{k: jnp.asarray(v) for k, v in {**lab, **stub}.items()})
    tb = TBatch(tokens=torch.from_numpy(tokens),
                **{k: torch.from_numpy(v) for k, v in {**lab, **stub}.items()})
    return jb, tb


def _tokens(vocab, shape, seed):
    return np.random.default_rng(seed).integers(0, vocab, shape).astype(
        np.int32)



@pytest.fixture(scope="module")
def models(arch):
    jm = JModel(jreg.get_smoke_config(arch))
    params = jm.init(jax.random.PRNGKey(0))
    tp = convert.params_from_jax(jax.tree_util.tree_map(np.asarray, params),
                                 device="cpu")
    return jm, params, TModel(treg.get_smoke_config(arch)), tp


# --- configs and parameters ---------------------------------------------------

def test_params_from_jax_carries_every_leaf(models):
    """Paths, shapes and values of every leaf, the stacked encoder blocks
    and the image projector included; a bf16 tree comes across bit for
    bit."""
    jm, params, tm, tp = models
    jleaves = jax.tree_util.tree_leaves_with_path(params)
    assert [tuple(k.key for k in p) for p, _ in jleaves] == \
        tree_lib.paths(tp)
    assert [pd.shape for pd in tree_lib.leaves(tm.param_defs())] == \
        [tuple(t.shape) for t in tree_lib.leaves(tp)]
    for (_, a), t in zip(jleaves, tree_lib.leaves(tp)):
        np.testing.assert_array_equal(np.asarray(a), t.numpy())
    assert tm.n_params() == jm.n_params()
    bf = jax.tree_util.tree_map(
        lambda a: np.asarray(a.astype(jnp.bfloat16)), params)
    tb = convert.params_from_jax(bf, device="cpu")
    for a, t in zip(jax.tree_util.tree_leaves(bf), tree_lib.leaves(tb)):
        assert t.dtype == torch.bfloat16
        np.testing.assert_array_equal(t.to(torch.float32).numpy(),
                                      a.astype(np.float32))


# --- forward, serving ---------------------------------------------------------

@pytest.mark.parametrize("path", ["autograd", "no_grad"])
def test_forward_logits_and_loss_match_reference(models, path):
    """The train path (autograd recording: the materialized attention) and
    the no-grad path (the flash wrapper, its plain version here)."""
    jm, params, tm, tp = models
    tok = _tokens(jm.cfg.vocab, (2, 24), 0)
    jb, tb = _batches(tok, _stub(jm.cfg, 2, 1), labels=True)
    with torch.set_grad_enabled(path == "autograd"):
        tlog = tm.forward(tp, tb)
        tl = tm.loss(tp, tb)
    n_img = jm.cfg.vlm_img_tokens
    assert tlog.shape == (2, n_img + 24, jm.cfg.vocab)
    np.testing.assert_allclose(tlog.detach().numpy(),
                               np.asarray(jm.forward(params, jb)), rtol=0,
                               atol=1e-4)
    np.testing.assert_allclose(float(tl), float(jm.loss(params, jb)),
                               rtol=1e-5)


def _assert_trees_close(tcache, jcache):
    jleaves = jax.tree_util.tree_leaves_with_path(jcache)
    assert [tuple(k.key for k in p) for p, _ in jleaves] == \
        tree_lib.paths(tcache)
    for (path, a), t in zip(jleaves, tree_lib.leaves(tcache)):
        assert tuple(t.shape) == np.shape(a), path
        np.testing.assert_allclose(t.numpy(), np.asarray(a), rtol=0,
                                   atol=1e-4, err_msg=str(path))


def test_prefill_and_teacher_forced_decode_match_reference(models):
    """Prefill logits and every cache leaf (the cross blocks' encoder K/V
    and MLA's latent included), then 5 decode steps fed the reference's
    greedy tokens: logits within 1e-4 and caches after each step."""
    jm, params, tm, tp = models
    tok = _tokens(jm.cfg.vocab, (2, 20), 2)
    jb, tb = _batches(tok, _stub(jm.cfg, 2, 3))
    jlog, jcache, jS = jax.jit(lambda p, b: jm.prefill(p, b, MAX_SEQ))(
        params, jb)
    tlog, tcache, tS = tm.prefill(tp, tb, MAX_SEQ)
    assert tS == int(jS) == 20 + jm.cfg.vlm_img_tokens
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), rtol=0,
                               atol=1e-4)
    _assert_trees_close(tcache, jcache)
    jdec = jax.jit(jm.decode_step)
    for i in range(5):
        nxt = np.asarray(jnp.argmax(jlog, axis=-1)).astype(np.int32)[:, None]
        jlog, jcache = jdec(params, jcache, jnp.asarray(nxt),
                            jnp.int32(tS + i))
        tlog, tcache = tm.decode_step(tp, tcache, torch.from_numpy(nxt),
                                      tS + i)
        np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), rtol=0,
                                   atol=1e-4, err_msg=f"step {i}")
        _assert_trees_close(tcache, jcache)


def test_greedy_tokens_through_engine_match_reference(models):
    """Both engines' generate, with the image or frame embeddings
    supplied: equal greedy tokens."""
    jm, params, tm, tp = models
    prompts = _tokens(jm.cfg.vocab, (3, 16), 4)
    stub = _stub(jm.cfg, 3, 5)
    want = jengine.Engine(jm, params, jengine.EngineConfig(
        max_seq=MAX_SEQ)).generate(prompts, 8, **stub)
    got = tengine.Engine(tm, tp, tengine.EngineConfig(
        max_seq=MAX_SEQ)).generate(prompts, 8, **stub)
    assert got.dtype == np.int32 and got.shape == (3, 8)
    np.testing.assert_array_equal(got, want)


def test_decode_matches_forward(models):
    """The KV-cache invariant at the reference's bound: the prefill of the
    first 19 tokens and one decode step give the full forward's last
    logits (the MoE archs at capacity factor 8.0)."""
    jm, _, tm, tp = models
    if tm.cfg.moe is not None:
        tm = TModel(dataclasses.replace(tm.cfg, moe=dataclasses.replace(
            tm.cfg.moe, capacity_factor=8.0)))
    tok = _tokens(tm.cfg.vocab, (2, 20), 6)
    _, tb = _batches(tok, _stub(tm.cfg, 2, 7))
    with torch.no_grad():
        full = tm.forward(tp, tb)[:, -1]
    _, cache, pos = tm.prefill(tp, dataclasses.replace(
        tb, tokens=tb.tokens[:, :-1]), 32)
    step, _ = tm.decode_step(tp, cache, tb.tokens[:, -1:], pos)
    rel = float((step - full).abs().max()) / (float(full.abs().max()) + 1e-9)
    assert rel < 2e-2, rel


def test_kv_chunk_matches_dense_and_reference(models):
    """The train path with `kv_chunk=16` (online softmax over chunks of 16
    keys) against the dense one (rel < 1e-3) and against the reference's
    chunked forward (atol 1e-4). Autograd records, as in training, so the
    port runs `chunked_sdpa` (without it, the flash path)."""
    jm, params, tm, tp = models
    tok = _tokens(jm.cfg.vocab, (2, 40), 8)
    jb, tb = _batches(tok, _stub(jm.cfg, 2, 9))
    with torch.enable_grad():
        dense = tm.forward(tp, tb).detach()
        chunked = tm.forward(tp, tb, kv_chunk=16).detach()
    rel = float((dense - chunked).abs().max()) / (
        float(dense.abs().max()) + 1e-9)
    assert rel < 1e-3, rel
    np.testing.assert_allclose(chunked.numpy(), np.asarray(
        jm.forward(params, jb, kv_chunk=16)), rtol=0, atol=1e-4)


# --- training -------------------------------------------------------------------

def _jax_route_ids(jm, params, batch) -> list:
    """The reference's top-k expert ids of every moe layer, in the
    forward's order (the repeats unrolled), on `batch` from `params`:
    [layer][token] of k ids in ascending order."""
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


def _train_both(jm, params, comm_kw, *, jax_mesh, steps=STEPS, port=True,
                route_ids=None):
    """The reference's trainer on `jax_mesh` and (with `port`) the port's
    at one rank, from the same weights and data (stub embeddings
    included): (losses, grad norms) of each (None for a port not run).
    A `route_ids` list gains the reference's `_jax_route_ids` of each step,
    from the parameters the step starts from."""
    cfg_j = jm.cfg
    tm = TModel(treg.get_smoke_config(cfg_j.name[:-len("-smoke")]))
    tmesh11 = tmesh.make_host_mesh(1, 1, device="cpu")
    data = list(jpipe.iterate(jpipe.DataConfig(
        vocab=cfg_j.vocab, seq_len=SEQ, global_batch=BATCH, seed=0), steps))
    stubs = [stub_inputs(cfg_j, BATCH, s) for s in range(steps)]
    jo = jopt.adamw(jsched.warmup_cosine(3e-3, 1, steps))
    with compat.set_mesh(jax_mesh):
        jp = jax.tree_util.tree_map(jnp.asarray, params)
        js = jtr.TrainState(params=jp, opt_state=jo.init(jp),
                            step=jnp.zeros((), jnp.int32))
        jstep = jax.jit(jtr.make_train_step(
            jm, jo, jax_mesh, JPlanner(mesh=jax_mesh),
            jtr.CommConfig(**comm_kw)))
        jrec = []
        for raw, stub in zip(data, stubs):
            jb = _batches(raw["tokens"], stub, True)[0]
            if route_ids is not None:
                route_ids.append(_jax_route_ids(jm, js.params, jb))
            js, m = jstep(js, jb)
            jrec.append((float(m["loss"]), float(m["grad_norm"])))
    if not port:
        return np.array(jrec), None
    to = topt.adamw(tsched.warmup_cosine(3e-3, 1, steps))
    ts = ttr.train_state_from_params(
        convert.params_from_jax(jax.tree_util.tree_map(np.asarray, params),
                                device="cpu"), to)
    tstep = ttr.make_train_step(tm, to, tmesh11, tpl.Planner(mesh=tmesh11),
                                ttr.CommConfig(**comm_kw))
    trec = []
    for raw, stub in zip(data, stubs):
        ts, m = tstep(ts, _batches(raw["tokens"], stub, True)[1])
        trec.append((float(m["loss"]), float(m["grad_norm"])))
    return np.array(jrec), np.array(trec)


@pytest.mark.parametrize("comm", ["gspmd", "gspmd_kv_chunk",
                                  "mlsl_int8_ef"])
def test_one_rank_train_losses_match_reference(models, comm, monkeypatch):
    """The train step at one rank against the reference's. gspmd_kv_chunk:
    both trainers with CommConfig(kv_chunk=16), and the port's attention
    must have gone through `chunked_sdpa` with chunks of 16 (mamba2-2.7b
    has no attention: never, and kv_chunk changes nothing)."""
    jm, params, _, _ = models
    comm_kw = {"gspmd": dict(mode="gspmd"),
               "gspmd_kv_chunk": dict(mode="gspmd", kv_chunk=16),
               "mlsl_int8_ef": COMM}[comm]
    chunks = []
    chunked_sdpa = tattn.chunked_sdpa

    def spy(*args, **kw):
        chunks.append(kw.get("kv_chunk"))
        return chunked_sdpa(*args, **kw)

    monkeypatch.setattr(tattn, "chunked_sdpa", spy)
    want, got = _train_both(jm, params, comm_kw,
                            jax_mesh=jmesh.make_host_mesh(1, 1))
    attends = jm.cfg.attn is not None or jm.cfg.mla is not None
    assert set(chunks) == ({16} if "kv_chunk" in comm_kw and attends
                           else set())
    rtol = 1e-3 if comm == "mlsl_int8_ef" else 1e-4
    np.testing.assert_allclose(got[0, 0], want[0, 0], rtol=1e-5)
    np.testing.assert_allclose(got, want, rtol=rtol)
    assert np.all(np.isfinite(got))


@pytest.fixture(scope="module")
def ranks8(request, tmp_path_factory):
    """One spawned group of 8 gloo ranks: the mlsl step of every
    architecture of the collecting module's ARCHS on ("node"=2,
    "local"=4), fp32 and int8 + EF; {(arch, case): [rank records]}."""
    archs = request.module.ARCHS
    weights = tmp_path_factory.mktemp("weights")
    for arch in archs:
        params = JModel(jreg.get_smoke_config(arch)).init(
            jax.random.PRNGKey(0))
        jckpt.save(str(weights / arch), {"params": jax.tree_util.tree_map(
            np.asarray, params)}, step=0)
    out = tmp_path_factory.mktemp("archs_ranks")
    torch_spawn.spawn("torch_archs_ranks.py", 8,
                      tmp_path_factory.mktemp("store"), weights, out,
                      ",".join(archs), timeout=600)
    return {(arch, case): [json.loads(
        (out / arch / case / f"rank{r}.json").read_text()) for r in range(8)]
        for arch in archs for case in CASES}


@pytest.mark.parametrize("case", list(CASES))
def test_eight_gloo_ranks_match_reference_on_mesh8(ranks8, mesh8, arch,
                                                   case):
    """mlsl on 8 gloo ranks against the JAX trainer on mesh8: the loss and
    gradient norm replicated on every rank, step 0 rtol 1e-5. fp32: then
    rtol 1e-4. int8 + EF: losses rtol 1e-3, gradient norms rtol 2e-3. At
    8 ranks gloo rounds every partial sum of the bf16 reduce-scatters where
    XLA rounds once, which moves int8 codes by up to two steps
    (tests/test_torch_train_hier.py); the error feedback carries the moved
    codes of steps 0 and 1 into step 2's gradient (minicpm3-4b's step-2
    norm: 1.7e-3 apart, where the fp32 run agrees within 1e-6).

    The MoE archs also route each step's batch from the parameters the
    step starts from, on both sides: the top-k expert sets of every moe
    layer equal at step 0, and on fp32 at every step. On int8 + EF a later
    step differs in at most FLIP_MAX of a layer's 256 tokens, and its loss
    and gradient norm are held to rtol 5e-3 and 2e-2; step 0's loss rtol
    1e-5 and gradient norm rtol 1e-4. AdamW's first step moves each
    parameter by about the learning rate whatever its gradient's size, so a
    moved code that flips a near-zero gradient's sign moves the parameters
    after step 0, which flips top-k choices; a flipped choice sends a token
    to another expert. Readings over data seeds 0-7 (this test runs seed
    0), grok-1 and arctic: step 0's loss within 1.4e-7 and norm within
    1.6e-5; later steps 0-13 flipped tokens a layer (a router left at its
    step-0 weights flips 35-131), losses within 1.4e-3 and norms within
    7.1e-3 (seed 0: 9.0e-4 and 5.4e-3)."""
    recs = ranks8[(arch, case)]
    for r in recs[1:]:
        assert r == recs[0]
    jm = JModel(jreg.get_smoke_config(arch))
    ids = [] if jm.cfg.moe is not None else None
    want, _ = _train_both(jm, jm.init(jax.random.PRNGKey(0)), CASES[case],
                          jax_mesh=mesh8, port=False, route_ids=ids)
    got = np.array([recs[0]["loss"], recs[0]["grad_norm"]]).T
    np.testing.assert_allclose(got[0, 0], want[0, 0], rtol=1e-5)
    int8 = case == "int8_ef"
    if int8 and ids is not None:
        flips = _route_flips(recs[0]["route_ids"], ids)
        assert not any(flips[0]) and max(map(max, flips)) <= FLIP_MAX, flips
        np.testing.assert_allclose(got[0, 1], want[0, 1], rtol=1e-4)
        np.testing.assert_allclose(got[1:, 0], want[1:, 0], rtol=5e-3)
        np.testing.assert_allclose(got[1:, 1], want[1:, 1], rtol=2e-2)
        return
    if ids is not None:
        assert recs[0]["route_ids"] == ids
    np.testing.assert_allclose(got[:, 0], want[:, 0],
                               rtol=1e-3 if int8 else 1e-4)
    np.testing.assert_allclose(got[:, 1], want[:, 1],
                               rtol=2e-3 if int8 else 1e-4)


def _route_flips(got, want) -> list:
    """Per step and moe layer, the tokens whose set of top-k experts
    differs between two `route_ids` records."""
    return [[int(np.any(np.asarray(g) != np.asarray(w), axis=-1).sum())
             for g, w in zip(gs, ws)] for gs, ws in zip(got, want)]


# --- CLIs -----------------------------------------------------------------------

def test_train_cli_runs_on_cpu(arch, capsys):
    """The train CLI with zero patch / frame embeddings, as the
    reference's feeds them: finite losses, one line per step."""
    rc = train_cli.main(["--arch", arch, "--comm", "mlsl", "--wire", "int8",
                         "--error-feedback", "--steps", "2", "--seq", "16",
                         "--log-every", "1", "--device", "cpu"])
    assert rc == 0
    losses = [float(line.split()[3]) for line in
              capsys.readouterr().out.splitlines() if line.startswith("step")]
    assert len(losses) == 2 and all(np.isfinite(losses))


def test_serve_cli_runs_on_cpu(arch, capsys):
    rc = serve_cli.main(["--arch", arch, "--batch", "2", "--prompt-len",
                         "12", "--new-tokens", "3", "--device", "cpu"])
    assert rc == 0
    assert "6 tokens in" in capsys.readouterr().out
