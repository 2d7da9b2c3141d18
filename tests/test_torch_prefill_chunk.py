"""`Model.prefill(..., kv_chunk=c)` against the reference's on the same
weights (the smoke configs of minicpm3-4b, whose MLA prefill runs the
folded-rope `chunked_sdpa`, and yi-6b, whose prefill keeps the flash
kernel: it never forms the scores), f32 on the CPU, with c dividing the
prompt of 24 tokens and not.

Tolerances: the serving contract's atol 1e-4 on the last-token logits and
on every cache leaf (the sums are taken in another order); greedy tokens
after the chunked prefill equal the reference's. A spy on `chunked_sdpa`
shows which path ran: the numbers alone cannot tell an ignored `kv_chunk`
from a used one, since chunking changes only the rounding."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jreg
from repro.models.transformer import Batch as JBatch, Model as JModel
from repro_torch import convert, tree as tree_lib
from repro_torch.configs import registry as treg
from repro_torch.kernels import flashattn
from repro_torch.models import attention
from repro_torch.models.transformer import Batch as TBatch, Model as TModel

ARCHS = ("minicpm3-4b", "yi-6b")
PROMPT = 24
CHUNKS = (8, 7)             # divides the prompt, does not
MAX_SEQ = 40
STEPS = 6


@pytest.fixture(scope="module", params=ARCHS)
def models(request):
    jm = JModel(jreg.get_smoke_config(request.param))
    params = jm.init(jax.random.PRNGKey(0))
    tp = convert.params_from_jax(jax.tree_util.tree_map(np.asarray, params),
                                 device="cpu")
    return jm, params, TModel(treg.get_smoke_config(request.param)), tp


def _prompt(vocab: int) -> np.ndarray:
    return np.random.default_rng(3).integers(0, vocab, (2, PROMPT)).astype(
        np.int32)


def _jax_prefill(jm, params, tokens, chunk):
    return jax.jit(lambda p, b: jm.prefill(p, b, MAX_SEQ, kv_chunk=chunk))(
        params, JBatch(tokens=jnp.asarray(tokens)))


@pytest.mark.parametrize("chunk", CHUNKS)
def test_chunked_prefill_matches_reference(models, chunk):
    """Last-token logits and every cache leaf within 1e-4 of the
    reference's chunked prefill."""
    jm, params, tm, tp = models
    tok = _prompt(jm.cfg.vocab)
    jlog, jcache, jS = _jax_prefill(jm, params, tok, chunk)
    tlog, tcache, tS = tm.prefill(tp, TBatch(tokens=torch.from_numpy(tok)),
                                  MAX_SEQ, kv_chunk=chunk)
    assert tS == int(jS) == PROMPT
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), rtol=0,
                               atol=1e-4)
    jleaves = jax.tree_util.tree_leaves_with_path(jcache)
    assert [tuple(k.key for k in p) for p, _ in jleaves] == \
        tree_lib.paths(tcache)
    for (path, a), t in zip(jleaves, tree_lib.leaves(tcache)):
        assert tuple(t.shape) == np.shape(a), path
        np.testing.assert_allclose(t.numpy(), np.asarray(a), rtol=0,
                                   atol=1e-4, err_msg=str(path))


@pytest.mark.parametrize("chunk", CHUNKS)
def test_greedy_tokens_after_chunked_prefill_match_reference(models, chunk):
    """Each model decodes greedily from its own chunked prefill: the same
    STEPS tokens."""
    jm, params, tm, tp = models
    tok = _prompt(jm.cfg.vocab)
    jlog, jcache, jS = _jax_prefill(jm, params, tok, chunk)
    tlog, tcache, tS = tm.prefill(tp, TBatch(tokens=torch.from_numpy(tok)),
                                  MAX_SEQ, kv_chunk=chunk)
    jdec = jax.jit(jm.decode_step)
    want, got = [], []
    for i in range(STEPS):
        jn = np.asarray(jnp.argmax(jlog, axis=-1)).astype(np.int32)[:, None]
        tn = tlog.argmax(dim=-1).to(torch.int32)[:, None]
        want.append(jn)
        got.append(tn.numpy())
        jlog, jcache = jdec(params, jcache, jnp.asarray(jn),
                            jnp.int32(int(jS) + i))
        tlog, tcache = tm.decode_step(tp, tcache, tn, tS + i)
    np.testing.assert_array_equal(np.concatenate(got, 1),
                                  np.concatenate(want, 1))


@pytest.mark.parametrize("chunk", CHUNKS)
def test_prefill_takes_the_chunk(models, chunk, monkeypatch):
    """MLA's prefill runs `chunked_sdpa` with c once a layer; yi-6b's
    keeps the flash kernel (its plain version here) once a layer and never
    calls `chunked_sdpa`. Without `kv_chunk` neither calls it."""
    jm, _, tm, tp = models
    chunks, flash = [], []
    real_chunked = attention.chunked_sdpa
    real_flash = flashattn.gqa_flash_attention

    def spy_chunked(*args, **kw):
        chunks.append(kw["kv_chunk"])
        return real_chunked(*args, **kw)

    def spy_flash(*args, **kw):
        flash.append(args[0].shape)
        return real_flash(*args, **kw)

    monkeypatch.setattr(attention, "chunked_sdpa", spy_chunked)
    monkeypatch.setattr(flashattn, "gqa_flash_attention", spy_flash)
    batch = TBatch(tokens=torch.from_numpy(_prompt(jm.cfg.vocab)))
    tm.prefill(tp, batch, MAX_SEQ)
    assert chunks == []
    tm.prefill(tp, batch, MAX_SEQ, kv_chunk=chunk)
    layers = tm.cfg.pattern_repeats
    if tm.cfg.mla is not None:
        assert chunks == [chunk] * layers and flash == []
    else:
        assert chunks == [] and len(flash) == 2 * layers
