"""The recurrent-family architectures of the port against the JAX
reference on the same weights and the same numpy inputs: recurrentgemma-2b
(the hybrid: RG-LRU blocks and causal local attention with a 64-key window
at the smoke size, 4 query heads on 1 KV head, scaled embeddings,
soft-capped logits) and mamba2-2.7b (the SSM: chunked SSD, no attention,
so `kv_chunk` changes nothing), each at its smoke config, f32 on the CPU.
The per-architecture tests are tests/torch_archs_suite.py's (their
tolerances there), run here for ARCHS; this file adds recurrentgemma's
prompts of 90 tokens, past its window into the ring, and its local
attention's window.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as jbase, registry as jreg
from repro.models.transformer import Model as JModel
from repro_torch import convert, tree as tree_lib
from repro_torch.configs import base as tbase, registry as treg
from repro_torch.models import blocks
from repro_torch.models.transformer import Model as TModel

import torch_archs_ranks
from torch_archs_suite import (  # noqa: F401 (collected here for ARCHS)
    _assert_trees_close, _batches, _tokens, models, pytest_generate_tests,
    ranks8, test_decode_matches_forward,
    test_eight_gloo_ranks_match_reference_on_mesh8,
    test_forward_logits_and_loss_match_reference,
    test_greedy_tokens_through_engine_match_reference,
    test_kv_chunk_matches_dense_and_reference,
    test_one_rank_train_losses_match_reference,
    test_params_from_jax_carries_every_leaf,
    test_prefill_and_teacher_forced_decode_match_reference,
    test_serve_cli_runs_on_cpu, test_train_cli_runs_on_cpu)

ARCHS = torch_archs_ranks.RECURRENT


@pytest.mark.parametrize("n_layers", [3, 5])
def test_recurrentgemma_ring_and_tail_match_reference(n_layers):
    """recurrentgemma-2b's smoke config (window 64) on 90-token prompts,
    past the window: the forward logits (both paths), the prefill's logits
    and caches (the local blocks' rings compacted to 64 slots, the RG-LRU
    states) and 5 teacher-forced decode steps on the ring, atol 1e-4. At 5
    layers the pattern's one repeat is followed by the tail ("rglru",
    "rglru"), with the scaled embeddings and soft-capped logits around
    them."""
    jcfg = jbase.reduce_for_smoke(jreg.get_config("recurrentgemma-2b"),
                                  n_layers=n_layers)
    tcfg = tbase.reduce_for_smoke(treg.get_config("recurrentgemma-2b"),
                                  n_layers=n_layers)
    assert tcfg.tail_layers == (("rglru", "rglru") if n_layers == 5 else ())
    assert tcfg.embed_scale and tcfg.logit_softcap == 30.0
    jm, tm = JModel(jcfg), TModel(tcfg)
    params = jm.init(jax.random.PRNGKey(1))
    tp = convert.params_from_jax(jax.tree_util.tree_map(np.asarray, params),
                                 device="cpu")
    tok = _tokens(jcfg.vocab, (2, 90), 12)
    jb, tb = _batches(tok, {})
    want = np.asarray(jm.forward(params, jb))
    for grad in (True, False):
        with torch.set_grad_enabled(grad):
            got = tm.forward(tp, tb).detach().numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
    jlog, jcache, jS = jax.jit(lambda p, b: jm.prefill(p, b, 110))(params,
                                                                  jb)
    tlog, tcache, tS = tm.prefill(tp, tb, 110)
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), rtol=0,
                               atol=1e-4)
    assert tcache["blocks"]["p2_local"]["k"].shape[2] == 64
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


@pytest.mark.parametrize("path", ["autograd", "no_grad"])
def test_local_attention_is_causal_and_windowed(path):
    """One "local" block of the smoke recurrentgemma (window 64): its
    output at position i moves when inputs at i or up to 63 before it
    move, and never when later inputs or those 64 or more before it move,
    on the train path (the materialized attention) and the no-grad path
    (the flash wrapper's plain version here)."""
    cfg = treg.get_smoke_config("recurrentgemma-2b")
    rng = np.random.default_rng(13)
    p = tree_lib.tree_map(lambda pd: torch.from_numpy(
        (rng.standard_normal(pd.shape) * 0.3).astype(np.float32)),
        blocks.block_defs("local", cfg))
    ctx = blocks.BlockCtx(cfg=cfg)
    assert ctx.window_for("local") == 64
    h = torch.from_numpy(rng.standard_normal((2, 150, cfg.d_model)).astype(
        np.float32))
    i = 100
    with torch.set_grad_enabled(path == "autograd"):
        base = blocks.block_apply("local", p, h, ctx)[0].detach()
        for j, moves in ((i + 1, False), (i, True), (i - 63, True),
                         (i - 64, False)):
            h2 = h.clone()
            h2[:, j] += 1.0
            out = blocks.block_apply("local", p, h2, ctx)[0].detach()
            changed = float((out[:, i] - base[:, i]).abs().max()) > 1e-6
            assert changed == moves, (j, moves)
