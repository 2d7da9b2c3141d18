"""The port's Mamba-2 SSD mixer (`repro_torch.models.ssm`) against the
reference's (`repro.models.ssm`) on the same numpy inputs from a seed, f32 on
the CPU: the chunked SSD with and without an initial state, at lengths a
multiple of the chunk, not a multiple (the pad path) and shorter than one
chunk, with two groups of B/C shared by the heads; the causal conv and its
one-step form; the prefill's cache against `ssm_prefill_cache`; the decode
step from an empty cache over a prompt against `ssm_apply`.

Tolerances: 1e-5 absolute on outputs of order 1 (the products are taken in
another order; the port masks the in-chunk decay before its exponential),
the decode against the chunked forward 2e-5 (a recurrence against a chunked
sum).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import SSMConfig as JSSMConfig
from repro.models import ssm as jssm
from repro_torch import tree as tree_lib
from repro_torch.configs.base import SSMConfig as TSSMConfig
from repro_torch.models import ssm as tssm

CFG = dict(d_state=16, head_dim=8, expand=2, conv_width=4, chunk=16,
           n_groups=2)
D_MODEL = 32


def _ssd_inputs(rng, S, H=4, P=8, G=2, N=16):
    xdt = rng.standard_normal((2, S, H, P)).astype(np.float32)
    a = -rng.uniform(0.01, 1.0, (2, S, H)).astype(np.float32)
    Bm, Cm = (rng.standard_normal((2, S, G, N)).astype(np.float32) * 0.5
              for _ in range(2))
    return xdt, a, Bm, Cm


@pytest.mark.parametrize("init", [False, True])
@pytest.mark.parametrize("S", [48, 37, 10])
def test_ssd_chunked_matches_reference(S, init):
    """S 48: three whole chunks; 37: padded to 48; 10: one short chunk."""
    rng = np.random.default_rng(S + 100 * init)
    xdt, a, Bm, Cm = _ssd_inputs(rng, S)
    state = (rng.standard_normal((2, 4, 16, 8)).astype(np.float32)
             if init else None)
    jy, jfinal = jssm._ssd_chunked(
        *map(jnp.asarray, (xdt, a, Bm, Cm)), JSSMConfig(**CFG),
        init_state=None if state is None else jnp.asarray(state))
    ty, tfinal = tssm._ssd_chunked(
        *map(torch.from_numpy, (xdt, a, Bm, Cm)), TSSMConfig(**CFG),
        init_state=None if state is None else torch.from_numpy(state))
    assert ty.shape == (2, S, 4, 8) and tfinal.shape == (2, 4, 16, 8)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=0, atol=1e-5)
    np.testing.assert_allclose(tfinal.numpy(), np.asarray(jfinal), rtol=0,
                               atol=1e-5)


def test_ssd_gradient_finite_at_a_full_chunk():
    """At mamba2-2.7b's chunk of 256 with decays of -0.5..-1 per step the
    hidden upper triangle's exponent reaches about 190, past f32's range:
    masked before the exponential, every gradient stays finite (the
    reference masks after it, and its gradient with respect to the decay is
    NaN there)."""
    rng = np.random.default_rng(7)
    xdt, a, Bm, Cm = _ssd_inputs(rng, 256, H=2, G=1)
    a = -rng.uniform(0.5, 1.0, a.shape).astype(np.float32)
    t = [torch.from_numpy(v).requires_grad_(True) for v in (xdt, a, Bm, Cm)]
    y, final = tssm._ssd_chunked(*t, TSSMConfig(**{**CFG, "chunk": 256}))
    (y.sum() + final.sum()).backward()
    assert all(bool(torch.isfinite(v.grad).all()) for v in t)


def test_causal_conv_and_step_match_reference():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 9, 6)).astype(np.float32)
    w = rng.standard_normal((6, 4)).astype(np.float32)
    want = jssm._causal_conv(*map(jnp.asarray, (x, w)))
    got = tssm._causal_conv(*map(torch.from_numpy, (x, w)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-6)
    state = rng.standard_normal((2, 3, 6)).astype(np.float32)
    jy, jst = jssm._conv_step(*map(jnp.asarray, (x[:, 0], state, w)))
    ty, tst = tssm._conv_step(*map(torch.from_numpy, (x[:, 0], state, w)))
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=0, atol=1e-6)
    np.testing.assert_array_equal(tst.numpy(), np.asarray(jst))


def _params(seed):
    """One mixer's parameters from a seed (numpy f32), with nonzero
    per-head vectors."""
    rng = np.random.default_rng(seed)
    defs = tssm.ssm_defs(D_MODEL, TSSMConfig(**CFG), torch.float32)
    p = tree_lib.tree_map(lambda pd: (rng.standard_normal(pd.shape)
                                      * 0.3).astype(np.float32), defs)
    p["A_log"] = rng.uniform(-1, 1, p["A_log"].shape).astype(np.float32)
    p["norm"] = 1 + p["norm"]
    return p


@pytest.mark.parametrize("S", [32, 21])
def test_prefill_output_and_cache_match_reference(S):
    """`ssm_prefill`'s output against `ssm_apply` and its cache (the final
    state and the conv tails) against `ssm_prefill_cache`."""
    p = _params(2)
    u = np.random.default_rng(3).standard_normal((2, S, D_MODEL)).astype(
        np.float32)
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    want_y = jssm.ssm_apply(jp, jnp.asarray(u), JSSMConfig(**CFG))
    want_c = jssm.ssm_prefill_cache(jp, jnp.asarray(u), JSSMConfig(**CFG))
    y, cache = tssm.ssm_prefill(tp, torch.from_numpy(u), TSSMConfig(**CFG))
    np.testing.assert_allclose(y.numpy(), np.asarray(want_y), rtol=0,
                               atol=1e-5)
    assert set(cache) == set(want_c)
    for k, v in want_c.items():
        np.testing.assert_allclose(cache[k].numpy(), np.asarray(v), rtol=0,
                                   atol=1e-5, err_msg=k)


def test_decode_steps_match_full_apply():
    """`ssm_decode` token by token from `ssm_init_cache` over a 40-token
    prompt against the reference's `ssm_apply` on the whole prompt (and the
    reference's own decode steps), the cache updated in place."""
    p = _params(4)
    u = np.random.default_rng(5).standard_normal((2, 40, D_MODEL)).astype(
        np.float32)
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    full = np.asarray(jssm.ssm_apply(jp, jnp.asarray(u), JSSMConfig(**CFG)))
    cache = tssm.ssm_init_cache(2, D_MODEL, TSSMConfig(**CFG), torch.float32)
    jcache = jssm.ssm_init_cache(2, D_MODEL, JSSMConfig(**CFG), jnp.float32)
    state = cache["state"]
    steps = []
    for i in range(40):
        y, out = tssm.ssm_decode(tp, torch.from_numpy(u[:, i:i + 1]), cache,
                                 TSSMConfig(**CFG))
        assert out is cache and out["state"] is state
        jy, jcache = jssm.ssm_decode(jp, jnp.asarray(u[:, i:i + 1]), jcache,
                                     JSSMConfig(**CFG))
        np.testing.assert_allclose(y.numpy(), np.asarray(jy), rtol=0,
                                   atol=1e-5)
        steps.append(y)
    np.testing.assert_allclose(torch.cat(steps, 1).numpy(), full, rtol=0,
                               atol=2e-5)
    for k, v in jcache.items():
        np.testing.assert_allclose(cache[k].numpy(), np.asarray(v), rtol=0,
                                   atol=1e-5, err_msg=k)
