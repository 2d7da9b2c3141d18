"""The port's RG-LRU block (`repro_torch.models.rglru`) against the
reference's (`repro.models.rglru`) on the same numpy inputs from a seed, f32
on the CPU: the log-depth `linear_scan` against `jax.lax.associative_scan`
of the same combine, with decays near 0 and near 1, at lengths 1 to 300
(powers of two and not); the gates; the prefill's output and cache against
`rglru_apply` and `rglru_prefill_cache`; the decode step from an empty
cache over a prompt against `rglru_apply`.

Tolerances: the scan rtol 1e-5 (plus 1e-6 absolute, for the elements that
cross zero; its values are of order 1 to 30), the gates and the block's
outputs 1e-5 absolute (the sums are taken in another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import RGLRUConfig as JRGLRUConfig
from repro.models import rglru as jrglru
from repro_torch import tree as tree_lib
from repro_torch.configs.base import RGLRUConfig as TRGLRUConfig
from repro_torch.models import rglru as trglru

D_MODEL = 32
WIDTH = 24


def _combine(l, r):
    a1, b1 = l
    a2, b2 = r
    return a1 * a2, a2 * b1 + b2


@pytest.mark.parametrize("decay", ["near0", "near1"])
@pytest.mark.parametrize("S", [1, 2, 7, 64, 300])
def test_linear_scan_matches_associative_scan(S, decay):
    rng = np.random.default_rng(S)
    lo, hi = (0.0, 0.05) if decay == "near0" else (0.95, 0.9999)
    a = rng.uniform(lo, hi, (2, S, 5)).astype(np.float32)
    b = rng.standard_normal((2, S, 5)).astype(np.float32)
    _, want = jax.lax.associative_scan(_combine, (jnp.asarray(a),
                                                  jnp.asarray(b)), axis=1)
    got = trglru.linear_scan(torch.from_numpy(a), torch.from_numpy(b))
    assert got.shape == (2, S, 5)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)


def test_linear_scan_runs_through_autograd():
    """The scan's gradients against those of the plain recurrence."""
    rng = np.random.default_rng(11)
    a = rng.uniform(0.5, 0.99, (2, 37, 3)).astype(np.float32)
    b = rng.standard_normal((2, 37, 3)).astype(np.float32)
    grads = []
    for scan in (trglru.linear_scan, _loop):
        ta, tb = (torch.from_numpy(v).requires_grad_(True) for v in (a, b))
        (scan(ta, tb) ** 2).sum().backward()
        grads.append((ta.grad, tb.grad))
    for got, want in zip(*grads):
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5,
                                   atol=1e-5)


def _loop(a, b):
    h, out = torch.zeros_like(b[:, 0]), []
    for t in range(b.shape[1]):
        h = a[:, t] * h + b[:, t]
        out.append(h)
    return torch.stack(out, 1)


def _params(seed):
    rng = np.random.default_rng(seed)
    defs = trglru.rglru_defs(D_MODEL, TRGLRUConfig(lru_width=WIDTH),
                             torch.float32)
    p = tree_lib.tree_map(lambda pd: (rng.standard_normal(pd.shape)
                                      * 0.3).astype(np.float32), defs)
    p["lam"] = rng.uniform(-2, 2, WIDTH).astype(np.float32)
    return p


def _both(p):
    return ({k: jnp.asarray(v) for k, v in p.items()},
            {k: torch.from_numpy(v) for k, v in p.items()})


def test_gates_match_reference():
    jp, tp = _both(_params(1))
    x = np.random.default_rng(2).standard_normal((3, 5, WIDTH)).astype(
        np.float32)
    ja, jb = jrglru._gates(jp, jnp.asarray(x), JRGLRUConfig(lru_width=WIDTH))
    ta, tb = trglru._gates(tp, torch.from_numpy(x),
                           TRGLRUConfig(lru_width=WIDTH))
    assert ta.dtype == tb.dtype == torch.float32
    np.testing.assert_allclose(ta.numpy(), np.asarray(ja), rtol=0, atol=1e-6)
    np.testing.assert_allclose(tb.numpy(), np.asarray(jb), rtol=0, atol=1e-6)


@pytest.mark.parametrize("S", [33, 2])
def test_prefill_output_and_cache_match_reference(S):
    """S 2: shorter than the conv's tail of 3, which then holds 2 rows in
    both packages."""
    jp, tp = _both(_params(3))
    x = np.random.default_rng(4).standard_normal((2, S, D_MODEL)).astype(
        np.float32)
    r_j, r_t = JRGLRUConfig(lru_width=WIDTH), TRGLRUConfig(lru_width=WIDTH)
    want_y = jrglru.rglru_apply(jp, jnp.asarray(x), r_j)
    want_c = jrglru.rglru_prefill_cache(jp, jnp.asarray(x), r_j)
    y, cache = trglru.rglru_prefill(tp, torch.from_numpy(x), r_t)
    np.testing.assert_allclose(y.numpy(), np.asarray(want_y), rtol=0,
                               atol=1e-5)
    np.testing.assert_allclose(trglru.rglru_apply(tp, torch.from_numpy(x),
                                                  r_t).numpy(),
                               np.asarray(want_y), rtol=0, atol=1e-5)
    assert set(cache) == set(want_c)
    for k, v in want_c.items():
        assert tuple(cache[k].shape) == v.shape
        np.testing.assert_allclose(cache[k].numpy(), np.asarray(v), rtol=0,
                                   atol=1e-5, err_msg=k)


def test_decode_steps_match_full_apply():
    """`rglru_decode` token by token from `rglru_init_cache` against the
    reference's `rglru_apply` over the prompt and its own decode steps,
    the cache updated in place."""
    jp, tp = _both(_params(5))
    x = np.random.default_rng(6).standard_normal((2, 30, D_MODEL)).astype(
        np.float32)
    r_j, r_t = JRGLRUConfig(lru_width=WIDTH), TRGLRUConfig(lru_width=WIDTH)
    full = np.asarray(jrglru.rglru_apply(jp, jnp.asarray(x), r_j))
    cache = trglru.rglru_init_cache(2, r_t, torch.float32)
    jcache = jrglru.rglru_init_cache(2, r_j, jnp.float32)
    h = cache["h"]
    steps = []
    for i in range(30):
        y, out = trglru.rglru_decode(tp, torch.from_numpy(x[:, i:i + 1]),
                                     cache, r_t)
        assert out is cache and out["h"] is h
        jy, jcache = jrglru.rglru_decode(jp, jnp.asarray(x[:, i:i + 1]),
                                         jcache, r_j)
        np.testing.assert_allclose(y.numpy(), np.asarray(jy), rtol=0,
                                   atol=1e-5)
        steps.append(y)
    np.testing.assert_allclose(torch.cat(steps, 1).numpy(), full, rtol=0,
                               atol=1e-5)
    for k, v in jcache.items():
        np.testing.assert_allclose(cache[k].numpy(), np.asarray(v), rtol=0,
                                   atol=1e-5, err_msg=k)
