"""The port's MoE layer (`repro_torch.models.moe`) against the reference's
(`repro.models.moe`) on the same seeded numpy inputs, f32 on the CPU.

Routing is discrete: a flipped top-k choice moves a token to another
expert, so every case asserts the expert ids equal before it compares
numbers. Tolerances: `capacity` and the dispatch indices equal; the
router's weights and aux within 1e-6; `moe_apply`'s output and aux within
1e-5 and its gradients rtol 1e-4 (summation order differs); the dense
oracle at loose capacity as the reference's own test holds it (rtol 5e-3,
atol 5e-4); gradients with and without remat equal.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jreg
from repro.configs.base import MoEConfig as JMoE
from repro.models import moe as jmoe
from repro.models.transformer import Model as JModel
from repro_torch import convert, tree as tree_lib
from repro_torch.configs import registry as treg
from repro_torch.configs.base import MoEConfig as TMoE
from repro_torch.core.planner import ParamDef
from repro_torch.models import common, moe as tmoe
from repro_torch.models.transformer import Batch as TBatch, Model as TModel


def _cfgs(**kw):
    return JMoE(**kw), TMoE(**kw)


def _params(rng, d, m, dense_ff=0, scale=0.1):
    """Seeded numpy parameters of one MoE layer (the router unscaled)."""
    p = {"router": rng.standard_normal((d, m.n_experts)),
         "w1": rng.standard_normal((m.n_experts, d, m.d_ff)) * scale,
         "w2": rng.standard_normal((m.n_experts, m.d_ff, d)) * scale,
         "w3": rng.standard_normal((m.n_experts, d, m.d_ff)) * scale}
    if dense_ff:
        p["dense"] = {"w1": rng.standard_normal((d, dense_ff)) * scale,
                      "w2": rng.standard_normal((dense_ff, d)) * scale,
                      "w3": rng.standard_normal((d, dense_ff)) * scale}
    return tree_lib.tree_map(lambda a: a.astype(np.float32), p)


def _both(p):
    return (jax.tree_util.tree_map(jnp.asarray, p),
            tree_lib.tree_map(torch.from_numpy, p))


@pytest.mark.parametrize("n_experts,top_k", [(8, 2), (128, 2), (4, 2),
                                             (4, 1)])
def test_capacity_matches_reference(n_experts, top_k):
    """On a grid of token counts (a decode step's batch to a full prefill)
    and capacity factors: equal, and never below the floor of 8 slots."""
    for n in (1, 3, 8, 15, 64, 100, 1000, 4096, 16384):
        for f in (1.0, 1.25, 2.0, 8.0):
            jm, tm = _cfgs(n_experts=n_experts, top_k=top_k, d_ff=8,
                           capacity_factor=f)
            assert tmoe.capacity(n, tm) == jmoe.capacity(n, jm) >= 8, (n, f)


def _route_inputs(case):
    rng = np.random.default_rng({"random": 0, "ties": 1, "uniform": 2}[case])
    x = rng.standard_normal((40, 16)).astype(np.float32)
    router = rng.standard_normal((16, 8)).astype(np.float32)
    if case == "ties":
        # experts 5 and 2 have the same column as 0 and 6: exact ties
        router[:, 5], router[:, 2] = router[:, 0], router[:, 6]
    elif case == "uniform":
        router[:] = 0.0                   # every probability 1/8
    return x, router


@pytest.mark.parametrize("top_k", [1, 2])
@pytest.mark.parametrize("case", ["random", "ties", "uniform"])
def test_route_matches_reference(case, top_k):
    """The ids equal (ties take the lowest expert index first, as
    `jax.lax.top_k` does), then the normalized weights and the load-balance
    aux within 1e-6."""
    x, router = _route_inputs(case)
    jm, tm = _cfgs(n_experts=8, top_k=top_k, d_ff=8)
    jw, jids, jaux = jmoe.route(jnp.asarray(x), jnp.asarray(router), jm)
    tw, tids, taux = tmoe.route(torch.from_numpy(x), torch.from_numpy(router),
                                tm)
    np.testing.assert_array_equal(tids.numpy(), np.asarray(jids))
    if case == "uniform":
        assert (tids.numpy() == np.arange(top_k)).all()
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), rtol=0, atol=1e-6)
    np.testing.assert_allclose(float(taux), float(jaux), rtol=0, atol=1e-6)


# (tokens, experts, top_k, capacity factor): seeded ids, most of them with
# token choices past their expert's capacity (the cases stand for the
# reference's hypothesis property, tests/test_properties.py)
DISPATCH = [(4, 2, 1, 1.25), (7, 3, 2, 1.0), (50, 8, 2, 0.5),
            (200, 8, 2, 1.25), (200, 2, 1, 0.25), (37, 5, 2, 1.25),
            (128, 4, 2, 0.125), (16, 8, 1, 8.0)]


@pytest.mark.parametrize("t,e,k,f", DISPATCH)
def test_dispatch_indices_match_reference(t, e, k, f):
    """Every slot's token, validity and weight source equal the
    reference's; each valid slot holds a choice of its own expert, and no
    choice fills two slots."""
    jm, tm = _cfgs(n_experts=e, top_k=k, d_ff=8, capacity_factor=f)
    ids = np.random.RandomState(t * 31 + e).randint(0, e, size=(t, k))
    cap = tmoe.capacity(t, tm)
    want = jmoe._dispatch_indices(jnp.asarray(ids), jm, cap)
    got = tmoe._dispatch_indices(torch.from_numpy(ids), tm, cap)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    slot_token, valid, wsrc = (g.numpy() for g in got)
    experts = np.arange(e * cap) // cap
    assert (ids.reshape(-1)[wsrc[valid]] == experts[valid]).all()
    assert len(np.unique(wsrc[valid])) == valid.sum()
    assert (slot_token[valid] == wsrc[valid] // k).all()
    if f < 1:
        assert valid.sum() < t * k          # this case drops choices


def _moe_case(cap_factor, dense, act, seed=3):
    jm, tm = _cfgs(n_experts=4, top_k=2, d_ff=24, capacity_factor=cap_factor,
                   dense_residual_ff=12 if dense else 0)
    rng = np.random.default_rng(seed)
    p = _params(rng, 16, tm, dense_ff=tm.dense_residual_ff)
    x = (rng.standard_normal((2, 20, 16)) * 0.5).astype(np.float32)
    return jm, tm, p, x


@pytest.mark.parametrize("act", ["silu", "gelu"])
@pytest.mark.parametrize("dense", [False, True])
@pytest.mark.parametrize("cap_factor", [1.25, 8.0])
def test_moe_apply_matches_reference(cap_factor, dense, act):
    """y and aux within 1e-5, at the default capacity (tokens dropped) and
    at a loose one, with and without arctic's dense residual MLP."""
    jm, tm, p, x = _moe_case(cap_factor, dense, act)
    jp, tp = _both(p)
    ids = tmoe.route(torch.from_numpy(x).reshape(-1, 16), tp["router"], tm)[1]
    np.testing.assert_array_equal(ids.numpy(), np.asarray(jmoe.route(
        jnp.asarray(x).reshape(-1, 16), jp["router"], jm)[1]))
    jy, jaux = jmoe.moe_apply(jp, jnp.asarray(x), jm, act=act)
    ty, taux = tmoe.moe_apply(tp, torch.from_numpy(x), tm, act=act)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=0, atol=1e-5)
    np.testing.assert_allclose(float(taux), float(jaux), rtol=0, atol=1e-5)


@pytest.mark.parametrize("dense", [False, True])
@pytest.mark.parametrize("cap_factor", [1.25, 8.0])
def test_moe_apply_gradients_match_reference(cap_factor, dense):
    """The gradients of mean(y^2) + 0.01 aux with respect to every
    parameter (the router through the weights and the aux) and to x,
    against `jax.grad`: rtol 1e-4 of each gradient's largest element."""
    jm, tm, p, x = _moe_case(cap_factor, dense, "silu", seed=4)

    def jloss(pp, xx):
        y, aux = jmoe.moe_apply(pp, xx, jm)
        return jnp.mean(y ** 2) + 0.01 * aux

    jg, jgx = jax.grad(jloss, argnums=(0, 1))(_both(p)[0], jnp.asarray(x))
    tp = tree_lib.tree_map(lambda a: torch.from_numpy(a).requires_grad_(True),
                           p)
    tx = torch.from_numpy(x).requires_grad_(True)
    y, aux = tmoe.moe_apply(tp, tx, tm)
    loss = torch.mean(y ** 2) + 0.01 * aux
    grads = torch.autograd.grad(loss, tree_lib.leaves(tp) + [tx])
    want = jax.tree_util.tree_leaves(jg) + [jgx]
    for path, g, w in zip(tree_lib.paths(tp) + [("x",)], grads, want):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                   atol=1e-4 * np.abs(w).max(),
                                   err_msg=str(path))
        assert np.abs(w).max() > 0, path


def test_moe_matches_dense_oracle_loose_capacity():
    """At capacity factor 8 nothing is dropped: `moe_apply` equals every
    token through its top-2 experts densely (the reference's oracle,
    tests/test_models.py), and the aux is positive."""
    _, tm = _cfgs(n_experts=4, top_k=2, d_ff=32, capacity_factor=8.0)
    rng = np.random.default_rng(5)
    p = _params(rng, 16, tm)
    x = (rng.standard_normal((2, 9, 16)) * 0.5).astype(np.float32)
    tp = tree_lib.tree_map(torch.from_numpy, p)
    y, aux = tmoe.moe_apply(tp, torch.from_numpy(x), tm)
    xf = torch.from_numpy(x.reshape(-1, 16))
    w, ids, _ = tmoe.route(xf, tp["router"], tm)
    ref = torch.zeros_like(xf)
    for t in range(xf.shape[0]):
        for j in range(2):
            e = int(ids[t, j])
            h = torch.nn.functional.silu(xf[t] @ tp["w1"][e]) * (
                xf[t] @ tp["w3"][e])
            ref[t] += w[t, j] * (h @ tp["w2"][e])
    np.testing.assert_allclose(y.reshape(-1, 16).numpy(), ref.numpy(),
                               rtol=5e-3, atol=5e-4)
    assert float(aux) > 0


@pytest.mark.parametrize("arch", ["grok-1-314b", "arctic-480b"])
def test_remat_gradients_equal(arch):
    """The smoke model's loss (the aux term included) and its gradients
    with `remat` (each pattern repeat under torch.utils.checkpoint, which
    routes again in the recompute) and without: equal bit for bit, and the
    routers' gradients non-zero."""
    jm = JModel(jreg.get_smoke_config(arch))
    params = convert.params_from_jax(jax.tree_util.tree_map(
        np.asarray, jm.init(jax.random.PRNGKey(2))), device="cpu")
    tok = torch.from_numpy(np.random.default_rng(6).integers(
        0, jm.cfg.vocab, (2, 24)).astype(np.int64))
    out = []
    for remat in (False, True):
        cfg = dataclasses.replace(treg.get_smoke_config(arch), remat=remat)
        p = tree_lib.tree_map(lambda t: t.clone().requires_grad_(True),
                              params)
        loss = TModel(cfg).loss(p, TBatch(tokens=tok, labels=tok))
        out.append([loss] + list(torch.autograd.grad(loss,
                                                     tree_lib.leaves(p))))
    for path, a, b in zip([("loss",)] + tree_lib.paths(params), *out):
        assert torch.equal(a, b), path
    routers = [g for path, g in zip(tree_lib.paths(params), out[1][1:])
               if path[-1] == "router"]
    assert routers and all(float(g.abs().max()) > 0 for g in routers)


def test_loss_adds_the_weighted_router_aux():
    """`Model.loss` is the cross-entropy plus router_aux_weight times the
    blocks' summed aux, the reference's `loss` with its `_last_aux`."""
    arch = "arctic-480b"
    jm = JModel(jreg.get_smoke_config(arch))
    jp = jm.init(jax.random.PRNGKey(3))
    tp = convert.params_from_jax(jax.tree_util.tree_map(np.asarray, jp),
                                 device="cpu")
    tm = TModel(treg.get_smoke_config(arch))
    tok = np.random.default_rng(7).integers(0, jm.cfg.vocab, (2, 16)).astype(
        np.int32)
    from repro.models.transformer import Batch as JBatch
    want = float(jm.loss(jp, JBatch(tokens=jnp.asarray(tok),
                                    labels=jnp.asarray(tok))))
    jaux = float(jm._last_aux)
    tb = TBatch(tokens=torch.from_numpy(tok), labels=torch.from_numpy(tok))
    with torch.no_grad():
        logits, aux = tm._forward(tp, tb)
        got = float(tm.loss(tp, tb))
    assert jaux > 0
    np.testing.assert_allclose(float(aux), jaux, rtol=1e-5)
    np.testing.assert_allclose(got, want, rtol=1e-5)
    xent = got - tm.cfg.moe.router_aux_weight * float(aux)
    np.testing.assert_allclose(xent, want - 0.01 * jaux, rtol=1e-5)


def test_only_moe_blocks_return_an_aux():
    """A moe block returns its router's aux; the other kinds return None,
    so a dense model's forward adds no aux and its loss is the bare
    cross-entropy (the reference adds a zero scalar per block)."""
    tok = torch.from_numpy(np.random.default_rng(9).integers(
        0, 256, (2, 16)).astype(np.int64))
    b = TBatch(tokens=tok, labels=tok)
    for arch, has_aux in (("yi-6b", False), ("grok-1-314b", True)):
        tm = TModel(treg.get_smoke_config(arch))
        p = tm.init(torch.Generator().manual_seed(1), "cpu")
        with torch.no_grad():
            logits, aux = tm._forward(p, b)
            loss = float(tm.loss(p, b))
        assert (aux is not None) == has_aux, arch
        if has_aux:
            assert float(aux) > 0
        else:
            labels = tok[:, 1:]
            want = torch.nn.functional.cross_entropy(
                logits[:, :-1].float().reshape(-1, logits.shape[-1]),
                labels.reshape(-1))
            np.testing.assert_allclose(loss, float(want), rtol=1e-6)


def test_init_draws_only_leaves_past_the_one_draw_limit_in_groups(
        monkeypatch):
    """A leaf up to INIT_ONE_DRAW_BYTES of f32 is one draw, also when it
    passes INIT_CHUNK_BYTES (the dense archs' weights stay as they were
    drawn); a larger one is drawn INIT_CHUNK_BYTES of trailing matrices at
    a time, at the same scale, into a leaf of its shape and dtype."""
    monkeypatch.setattr(common, "INIT_ONE_DRAW_BYTES", 4 * 6 * 64 * 48)
    monkeypatch.setattr(common, "INIT_CHUNK_BYTES", 4 * 2 * 64 * 48)
    draws, randn = [], torch.randn

    def spy(shape, **kw):
        draws.append(tuple(shape))
        return randn(shape, **kw)

    monkeypatch.setattr(torch, "randn", spy)
    small = ParamDef((6, 64, 48), "w", dtype=torch.bfloat16)
    big = ParamDef((2, 5, 64, 48), "w", dtype=torch.bfloat16)
    for pd, want_draws in ((small, [(6, 64, 48)]), (big, [(2, 64, 48)] * 5)):
        draws.clear()
        got = common.init_param(torch.Generator().manual_seed(3), pd, "cpu")
        assert draws == want_draws
        assert got.shape == pd.shape and got.dtype == pd.dtype
        np.testing.assert_allclose(float(got.float().std()), 1 / 8.0,
                                   rtol=0.05)
    once = (randn(small.shape, generator=torch.Generator().manual_seed(3))
            / 8.0).to(small.dtype)
    assert torch.equal(common.init_param(torch.Generator().manual_seed(3),
                                         small, "cpu"), once)


def test_params_from_jax_keeps_the_f32_router_beside_bf16_experts():
    """grok-1's smoke config in bf16: the reference's stacked (repeats, E,
    d, ff) expert leaves come across as bf16 and its router as f32, every
    value bit for bit."""
    jcfg = dataclasses.replace(jreg.get_smoke_config("grok-1-314b"),
                               dtype=jnp.bfloat16)
    params = jax.tree_util.tree_map(
        np.asarray, JModel(jcfg).init(jax.random.PRNGKey(4)))
    tp = convert.params_from_jax(params, device="cpu")
    moe_p = tp["blocks"]["p0_moe"]["moe"]
    reps, m = jcfg.pattern_repeats, jcfg.moe
    assert moe_p["router"].dtype == torch.float32
    assert tuple(moe_p["router"].shape) == (reps, jcfg.d_model, m.n_experts)
    assert moe_p["w1"].dtype == torch.bfloat16
    assert tuple(moe_p["w1"].shape) == (reps, m.n_experts, jcfg.d_model,
                                        m.d_ff)
    assert tuple(moe_p["w2"].shape) == (reps, m.n_experts, m.d_ff,
                                        jcfg.d_model)
    for a, t in zip(jax.tree_util.tree_leaves(params), tree_lib.leaves(tp)):
        np.testing.assert_array_equal(t.to(torch.float32).numpy(),
                                      np.asarray(a, np.float32))


def test_long_context_engine_matches_reference():
    """The serve engine's long-context variant on a moe arch (a 64-key
    sliding-window cache on its full-attention blocks): greedy tokens of
    80-token prompts, past the window, equal the reference engine's."""
    from repro.serve import engine as jengine
    from repro_torch.serve import engine as tengine
    arch = "grok-1-314b"
    jm = JModel(jreg.get_smoke_config(arch))
    params = jm.init(jax.random.PRNGKey(5))
    tp = convert.params_from_jax(jax.tree_util.tree_map(np.asarray, params),
                                 device="cpu")
    tm = TModel(treg.get_smoke_config(arch))
    assert tm.cfg.long_context_window == 64
    prompts = np.random.default_rng(8).integers(
        0, jm.cfg.vocab, (2, 80)).astype(np.int32)
    want = jengine.Engine(jm, params, jengine.EngineConfig(
        max_seq=96, long_context=True)).generate(prompts, 6)
    eng = tengine.Engine(tm, tp, tengine.EngineConfig(max_seq=96,
                                                      long_context=True))
    assert eng.ctx_kw == {"window_override": 64}
    np.testing.assert_array_equal(eng.generate(prompts, 6), want)
