"""The port's serving path against the JAX reference on the same weights
(yi-6b smoke config, f32 on the CPU; the reference's parameters carried
across with `params_from_jax`): prefill logits and caches, teacher-forced
decode steps, the engine's greedy tokens, ragged batched requests, and the
serve CLI.

Tolerance: atol 1e-4 on logits and native caches (the sums are taken in
another order). The int8 cache's quantizer is bitwise the reference's on the
same K/V rows (codes and f16 scales); inside the model the rows differ in
their last bits, so a row near a rounding edge may move its code by one or
its f16 scale by one ulp: the contract (ROADMAP.md, "Serving"). The
whole-model comparison holds every scale within one ulp of f16 at the
larger of the two magnitudes, and every code within one, on at most one
code in a thousand. Scales get no share rule: a row's amax is a sum in
another order, so whether any of a leaf's 512 scales sits at an f16
rounding edge depends on the CPU, and one of 512 is already past a share
of one in a thousand. Such a code moves the next logits by about 2e-4, so
the int8 decode steps start from the reference's cache.

The smoke config has as many KV heads as query heads; the grouped cases
give it 2 KV heads for 4 query heads, so that the prefill's and the
decode's grouped attention are held to the reference's repeated heads."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jreg
from repro.models.transformer import Batch as JBatch, Model as JModel
from repro.serve import engine as jengine
from repro_torch import convert, tree as tree_lib
from repro_torch.configs import registry as treg
from repro_torch.kernels import flashattn
from repro_torch.launch import serve as serve_cli
from repro_torch.models.transformer import Batch as TBatch, Model as TModel
from repro_torch.serve import engine as tengine

MAX_SEQ = 96
# ctx options of Model.prefill/decode_step, as the engines pass them; the
# smoke config's long-context window is 64, and these prompts are longer
MODES = {"native": {}, "int8": {"kv_dtype": "int8"},
         "long": {"window_override": 64}}
ENGINE_CFG = {"native": {}, "int8": {"kv_dtype": "int8"},
              "long": {"long_context": True}}


def _models(grouped: bool):
    """The reference and the port on the same weights; `grouped` gives the
    smoke config 2 KV heads for its 4 query heads (yi-6b itself serves 32
    query heads from 4 KV heads)."""
    def cfg(reg):
        c = reg.get_smoke_config("yi-6b")
        if grouped:
            c = dataclasses.replace(c, attn=dataclasses.replace(c.attn,
                                                                n_kv=2))
        return c

    jm = JModel(cfg(jreg))
    params = jm.init(jax.random.PRNGKey(0))
    tp = convert.params_from_jax(jax.tree_util.tree_map(np.asarray, params),
                                 device="cpu")
    return jm, params, TModel(cfg(treg)), tp


@pytest.fixture(scope="module")
def setup():
    return _models(grouped=False)


@pytest.fixture(scope="module")
def setup_grouped():
    models = _models(grouped=True)
    assert models[2].cfg.attn.n_heads == 2 * models[2].cfg.attn.n_kv
    return models


def _prompts(cfg_vocab, shape, seed):
    return np.random.default_rng(seed).integers(
        0, cfg_vocab, shape).astype(np.int32)


def _assert_trees_close(tcache, jcache, kv_int8):
    jleaves = jax.tree_util.tree_leaves_with_path(jcache)
    assert [tuple(k.key for k in p) for p, _ in jleaves] == \
        tree_lib.paths(tcache)
    for (path, a), t in zip(jleaves, tree_lib.leaves(tcache)):
        a = np.asarray(a)
        assert tuple(t.shape) == a.shape, path
        if kv_int8:
            assert t.dtype in (torch.int8, torch.float16), path
            codes = path[-1].key in ("k", "v")
            t = t.numpy()
            if codes:
                step = 1.0
            else:       # one f16 ulp at the larger of the two magnitudes
                step = np.spacing(np.maximum(np.abs(t), np.abs(a))).astype(
                    np.float64)
            t, a = t.astype(np.float64), a.astype(np.float64)
            assert (np.abs(t - a) <= step).all(), path
            if codes:
                assert np.mean(t != a) <= 1e-3, path
        else:
            np.testing.assert_allclose(t.numpy(), a, rtol=0, atol=1e-4,
                                       err_msg=str(path))


def _check_prefill_and_decode(setup, mode):
    """Prefill logits and every cache leaf, then 6 decode steps fed the
    reference's greedy tokens (and, with the int8 cache, the reference's
    cache): logits and caches after each step."""
    jm, params, tm, tp = setup
    kw = MODES[mode]
    prompts = _prompts(jm.cfg.vocab, (2, 80), seed=1)
    jlog, jcache, jS = jax.jit(
        lambda p, b: jm.prefill(p, b, MAX_SEQ, **kw))(
            params, JBatch(tokens=jnp.asarray(prompts)))
    tlog, tcache, tS = tm.prefill(tp, TBatch(tokens=torch.from_numpy(prompts)),
                                  MAX_SEQ, **kw)
    assert tS == jS == 80
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), rtol=0,
                               atol=1e-4)
    _assert_trees_close(tcache, jcache, mode == "int8")
    jdec = jax.jit(lambda p, c, t, pos: jm.decode_step(p, c, t, pos, **kw))
    for i in range(6):
        if mode == "int8":
            # a code one off at a rounding edge moves the logits by more
            # than 1e-4, so each step decodes from the reference's cache
            tcache = jax.tree_util.tree_map(
                lambda a: torch.from_numpy(np.array(a)), jcache)
        tok = np.asarray(jnp.argmax(jlog, axis=-1)).astype(np.int32)[:, None]
        jlog, jcache = jdec(params, jcache, jnp.asarray(tok), jnp.int32(80 + i))
        tlog, tcache = tm.decode_step(tp, tcache, torch.from_numpy(tok), 80 + i,
                                      **kw)
        np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), rtol=0,
                                   atol=1e-4, err_msg=f"step {i}")
        _assert_trees_close(tcache, jcache, mode == "int8")


def _check_generate(setup, mode):
    jm, params, tm, tp = setup
    ecfg = dict(max_seq=MAX_SEQ, **ENGINE_CFG[mode])
    prompts = _prompts(jm.cfg.vocab, (3, 70), seed=3)
    want = jengine.Engine(jm, params, jengine.EngineConfig(**ecfg)).generate(
        prompts, 8)
    timings = {}
    got = tengine.Engine(tm, tp, tengine.EngineConfig(**ecfg)).generate(
        prompts, 8, timings=timings)
    assert got.dtype == np.int32 and got.shape == (3, 8)
    np.testing.assert_array_equal(got, want)
    assert len(timings["decode_s"]) == 8
    assert 0 < timings["prefill_s"] <= timings["first_token_s"]


@pytest.mark.parametrize("mode", sorted(MODES))
def test_prefill_and_teacher_forced_decode_match_reference(setup, mode):
    _check_prefill_and_decode(setup, mode)


@pytest.mark.parametrize("mode", sorted(MODES))
def test_grouped_kv_heads_match_reference(setup_grouped, mode):
    """Two query heads per KV head: the prefill's grouped flash attention
    and the decode's grouped `_decode_sdpa` against the reference's
    repeated KV heads, then the greedy tokens."""
    _check_prefill_and_decode(setup_grouped, mode)
    _check_generate(setup_grouped, mode)


@pytest.mark.parametrize("dtype", [np.float32, jnp.bfloat16])
def test_kv_quant_bitwise_on_the_same_rows(dtype):
    from repro.models import attention as jattn
    from repro_torch.models import attention as tattn
    rng = np.random.default_rng(8)
    x = (rng.standard_normal((3, 50, 4, 32)) * 2).astype(np.float32)
    x[0, 0] = 0                                    # the 1e-8 scale floor
    jx = jnp.asarray(x).astype(dtype)
    tx = torch.tensor(np.asarray(jx.astype(jnp.float32))).to(
        torch.float32 if dtype == np.float32 else torch.bfloat16)
    (jq, js), (tq, ts) = jattn._kv_quant(jx), tattn._kv_quant(tx)
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(
        tattn._kv_dequant(tq, ts, torch.float32).numpy(),
        np.asarray(jattn._kv_dequant(jq, js, jnp.float32)))


def test_windowed_prefill_compacts_the_ring(setup):
    """A prompt longer than the window leaves `window` slots, each position
    p at slot p % window (compared on the first layer, whose K does not
    depend on the attention mask)."""
    _, _, tm, tp = setup
    prompts = _prompts(tm.cfg.vocab, (1, 80), seed=2)
    _, ring, _ = tm.prefill(tp, TBatch(tokens=torch.from_numpy(prompts)),
                            MAX_SEQ, window_override=64)
    _, full, _ = tm.prefill(tp, TBatch(tokens=torch.from_numpy(prompts)),
                            MAX_SEQ)
    k_ring, k_full = ring["blocks"]["p0_attn"]["k"], full["blocks"]["p0_attn"]["k"]
    assert k_ring.shape[2] == 64 and k_full.shape[2] == MAX_SEQ
    for p in range(16, 80):
        assert torch.equal(k_ring[0, :, p % 64], k_full[0, :, p])


@pytest.mark.parametrize("mode", sorted(ENGINE_CFG))
def test_engine_greedy_tokens_equal_reference(setup, mode):
    _check_generate(setup, mode)


def test_serve_requests_ragged_equal_reference(setup):
    jm, params, tm, tp = setup
    rng = np.random.default_rng(4)
    lens, news = (5, 17, 11), (3, 6, 4)
    prompts = [rng.integers(0, jm.cfg.vocab, n).astype(np.int32) for n in lens]

    def run(mod, model, p):
        eng = mod.Engine(model, p, mod.EngineConfig(max_seq=64))
        return mod.serve_requests(eng, [mod.Request(prompt=a, max_new=m)
                                        for a, m in zip(prompts, news)])

    for j, t in zip(run(jengine, jm, params), run(tengine, tm, tp)):
        assert t.out.shape == (t.max_new,)
        np.testing.assert_array_equal(t.out, j.out)


def test_temperature_sampling_repeats_from_a_seed(setup):
    _, _, tm, tp = setup
    eng = tengine.Engine(tm, tp, tengine.EngineConfig(max_seq=64,
                                                      temperature=1.0))
    prompts = _prompts(tm.cfg.vocab, (4, 9), seed=5)
    a = eng.generate(prompts, 12, seed=7)
    np.testing.assert_array_equal(a, eng.generate(prompts, 12, seed=7))
    assert not np.array_equal(a, eng.generate(prompts, 12, seed=8))
    assert ((a >= 0) & (a < tm.cfg.vocab)).all()


def test_prefill_runs_flash_attention_and_training_does_not(setup):
    """The no-grad prefill takes the flash path (its plain version on the
    CPU: it launches nothing), which equals the materialized `_sdpa` that
    the training forward runs."""
    _, _, tm, tp = setup
    tokens = torch.from_numpy(_prompts(tm.cfg.vocab, (2, 40), seed=6))
    with torch.no_grad():
        flash = tm.forward(tp, TBatch(tokens=tokens))
    with torch.enable_grad():
        plain = tm.forward(tp, TBatch(tokens=tokens)).detach()
    torch.testing.assert_close(flash, plain, rtol=0, atol=1e-5)
    assert flashattn.LAUNCHES["flash_attention"] == 0


def test_serve_cli_on_cpu(capsys):
    assert serve_cli.main(["--device", "cpu", "--batch", "3", "--prompt-len",
                           "12", "--new-tokens", "5"]) == 0
    out = capsys.readouterr().out
    assert "req2: prompt_len=" in out and "batched on cpu" in out
    assert serve_cli.main(["--device", "cpu", "--long-context", "--batch", "2",
                           "--prompt-len", "90", "--new-tokens", "3"]) == 0


def test_serve_cli_defaults_to_cuda(capsys):
    if torch.cuda.is_available():
        assert serve_cli.main(["--new-tokens", "2"]) == 0
    else:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            serve_cli.main(["--new-tokens", "2"])
    # --stats, once refused as not ported, runs on the CPU when asked
    assert serve_cli.main(["--device", "cpu", "--stats", "--new-tokens",
                           "2"]) == 0
    assert "decode step 2" in capsys.readouterr().out


@pytest.mark.parametrize("mode", sorted(ENGINE_CFG))
def test_engine_hooks_leave_the_tokens_alone(setup, mode, tmp_path):
    """Engine(meter=, tracer=, telemetry=, monitor=): one prefill span, a
    span and a meter step per decode step, a rates counter and a telemetry
    step record per decode step; the tokens equal those of the engine
    without hooks, which equal the reference's (and the reference's own
    hooks give the same spans)."""
    from repro.obs import meter as jmeter, trace as jtrace
    from repro_torch.obs import detect, meter, telemetry, trace
    jm, params, tm, tp = setup
    ecfg = dict(max_seq=MAX_SEQ, **ENGINE_CFG[mode])
    prompts = _prompts(jm.cfg.vocab, (3, 70), seed=3)
    plain = tengine.Engine(tm, tp, tengine.EngineConfig(**ecfg)).generate(
        prompts, 8)
    hooks = dict(meter=meter.StepMeter(), tracer=trace.TraceWriter(),
                 monitor=detect.HealthMonitor())
    with telemetry.TelemetryWriter(str(tmp_path / "t.jsonl"),
                                   sample_every=0) as tel:
        got = tengine.Engine(tm, tp, tengine.EngineConfig(**ecfg),
                             telemetry=tel, **hooks).generate(prompts, 8)
    np.testing.assert_array_equal(got, plain)
    jtr = jtrace.TraceWriter()
    jengine.Engine(jm, params, jengine.EngineConfig(**ecfg),
                   meter=jmeter.StepMeter(), tracer=jtr).generate(prompts, 8)
    names = [e["name"] for e in hooks["tracer"].events if e["ph"] == "X"]
    assert names == ["prefill"] + [f"decode/{i}" for i in range(8)]
    assert names == [e["name"] for e in jtr.events if e["ph"] == "X"]
    assert sum(e["ph"] == "C" for e in hooks["tracer"].events) == 8
    assert hooks["meter"].steps == 8
    assert hooks["meter"].tokens_per_sec > 0
    trace.validate_trace(hooks["tracer"].to_json())
    events = telemetry.load_telemetry(str(tmp_path / "t.jsonl"))
    assert [e["step"] for e in events[1:]] == list(range(8))
    with pytest.raises(ValueError, match="need a meter"):
        tengine.Engine(tm, tp, monitor=detect.HealthMonitor())


def test_serve_cli_observability(tmp_path, capsys):
    """--stats --trace DIR --telemetry DIR: 1 prefill span and new_tokens
    decode spans in a trace that validates under both packages, one
    telemetry step record per decode step, the decode meter line, and the
    tokens of the same run without the flags."""
    import torch_cli_obs as cli_obs
    argv = ["--device", "cpu", "--batch", "3", "--prompt-len", "12",
            "--new-tokens", "5"]
    assert serve_cli.main(argv) == 0
    plain = capsys.readouterr().out
    obs = tmp_path / "obs"
    assert serve_cli.main(argv + ["--stats", "--trace", str(obs),
                                  "--telemetry", str(obs)]) == 0
    out = capsys.readouterr().out
    reqs = [ln for ln in out.splitlines() if ln.startswith("req")]
    assert reqs == [ln for ln in plain.splitlines() if ln.startswith("req")]
    assert "decode step 5" in out and "health: no alarms" in out
    trace = cli_obs.check_trace(obs / "trace.json")
    assert cli_obs.spans(trace) == ["prefill"] + [f"decode/{i}"
                                                  for i in range(5)]
    events = cli_obs.check_telemetry(obs / "telemetry.jsonl")
    assert [e["kind"] for e in events] == ["meta"] + ["step"] * 5


@pytest.mark.parametrize("mode", sorted(MODES))
def test_init_cache_matches_reference_tree(setup, mode):
    jm, _, tm, _ = setup
    kw = MODES[mode]
    jcache = jm.init_cache(3, MAX_SEQ, **kw)
    tcache = tm.init_cache(3, MAX_SEQ, device="cpu", **kw)
    jleaves = jax.tree_util.tree_leaves_with_path(jcache)
    assert [tuple(k.key for k in p) for p, _ in jleaves] == \
        tree_lib.paths(tcache)
    for (path, a), t in zip(jleaves, tree_lib.leaves(tcache)):
        assert tuple(t.shape) == a.shape and str(t.dtype)[6:] == str(a.dtype)
        assert not t.any(), path


def test_prefill_and_decode_with_a_tail_layer():
    """A pattern that does not divide the depth leaves tail layers, which
    keep their own (unstacked) caches."""
    jcfg = dataclasses.replace(jreg.get_smoke_config("yi-6b"),
                               block_pattern=("attn", "attn"), n_layers=3)
    tcfg = dataclasses.replace(treg.get_smoke_config("yi-6b"),
                               block_pattern=("attn", "attn"), n_layers=3)
    assert tcfg.tail_layers == ("attn",)
    jm, tm = JModel(jcfg), TModel(tcfg)
    params = jm.init(jax.random.PRNGKey(1))
    tp = convert.params_from_jax(jax.tree_util.tree_map(np.asarray, params),
                                 device="cpu")
    prompts = _prompts(jcfg.vocab, (2, 20), seed=9)
    jlog, jcache, _ = jm.prefill(params, JBatch(tokens=jnp.asarray(prompts)),
                                 32)
    tlog, tcache, _ = tm.prefill(tp, TBatch(tokens=torch.from_numpy(prompts)),
                                 32)
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), atol=1e-4)
    _assert_trees_close(tcache, jcache, False)
    tok = np.asarray(jnp.argmax(jlog, axis=-1)).astype(np.int32)[:, None]
    jlog, jcache = jm.decode_step(params, jcache, jnp.asarray(tok),
                                  jnp.int32(20))
    tlog, tcache = tm.decode_step(tp, tcache, torch.from_numpy(tok), 20)
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), atol=1e-4)
    _assert_trees_close(tcache, jcache, False)
