"""The port's model against the JAX reference on the same weights: the
reference's parameters are carried across with `params_from_jax`, and both
compute the loss, logits and gradients on the same seeded batch (yi-6b
smoke config, f32 on the CPU; the sums are taken in another order, which is
the only difference)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jreg
from repro.models.transformer import Batch as JBatch, Model as JModel
from repro_torch import convert, tree as tree_lib
from repro_torch.configs import registry as treg
from repro_torch.models import common
from repro_torch.models.transformer import Batch as TBatch, Model as TModel


@pytest.fixture(scope="module")
def setup():
    cfg = jreg.get_smoke_config("yi-6b")
    jm = JModel(cfg)
    params = jm.init(jax.random.PRNGKey(0))
    tp = convert.params_from_jax(jax.tree_util.tree_map(np.asarray, params),
                                 device="cpu")
    tok = np.random.default_rng(0).integers(0, cfg.vocab, size=(4, 32)
                                            ).astype(np.int32)
    return jm, params, TModel(treg.get_smoke_config("yi-6b")), tp, tok


def test_params_from_jax_keeps_paths_shapes_dtypes(setup):
    _, params, tm, tp, _ = setup
    jleaves = jax.tree_util.tree_leaves_with_path(params)
    assert [tuple(k.key for k in p) for p, _ in jleaves] == tree_lib.paths(tp)
    for (_, a), t in zip(jleaves, tree_lib.leaves(tp)):
        assert tuple(a.shape) == tuple(t.shape)
        assert t.dtype == torch.float32
        np.testing.assert_array_equal(np.asarray(a), t.numpy())
    defs = tm.param_defs()
    assert [pd.shape for pd in tree_lib.leaves(defs)] == \
        [tuple(t.shape) for t in tree_lib.leaves(tp)]
    assert tm.n_params() == JModel(jreg.get_smoke_config("yi-6b")).n_params()


def test_params_from_jax_bfloat16_is_bitwise():
    a = np.asarray(jnp.asarray(np.linspace(-3, 3, 37, dtype=np.float32))
                   .astype(jnp.bfloat16))
    t = convert.params_from_jax({"w": a}, device="cpu")["w"]
    assert t.dtype == torch.bfloat16
    np.testing.assert_array_equal(t.to(torch.float32).numpy(),
                                  a.astype(np.float32))


def test_params_from_jax_defaults_to_cuda():
    """Without `device` the weights go to the card, and without a card the
    call raises instead of carrying on on the CPU."""
    a = np.zeros((3,), np.float32)
    if torch.cuda.is_available():
        assert convert.params_from_jax({"w": a})["w"].device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            convert.params_from_jax({"w": a})


def test_loss_logits_and_grads_match_reference(setup):
    jm, params, tm, tp, tok = setup
    jl, jg = jax.jit(jax.value_and_grad(jm.loss))(
        params, JBatch(tokens=jnp.asarray(tok), labels=jnp.asarray(tok)))
    leaves = tree_lib.leaves(tp)
    for p in leaves:
        p.requires_grad_(True)
    tl = tm.loss(tp, TBatch(tokens=torch.from_numpy(tok),
                            labels=torch.from_numpy(tok)))
    tg = torch.autograd.grad(tl, leaves)
    for p in leaves:
        p.requires_grad_(False)
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=1e-5)
    for path, a, b in zip(tree_lib.paths(tp), jax.tree_util.tree_leaves(jg),
                          tg):
        a = np.asarray(a)
        assert np.abs(a - b.numpy()).max() <= 1e-4 * np.linalg.norm(a), path

    jlog = jax.jit(jm.forward)(params, JBatch(tokens=jnp.asarray(tok)))
    with torch.no_grad():
        tlog = tm.forward(tp, TBatch(tokens=torch.from_numpy(tok)))
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), rtol=0,
                               atol=1e-4)


def test_remat_recomputes_the_same_forward(setup):
    """cfg.remat (torch.utils.checkpoint per repeat) recomputes the same
    forward: the loss is bitwise the one without it, and the gradients
    differ only by the order in which autograd sums their contributions."""
    import dataclasses
    _, _, tm, tp, tok = setup
    remat = TModel(dataclasses.replace(tm.cfg, remat=True))
    batch = TBatch(tokens=torch.from_numpy(tok), labels=torch.from_numpy(tok))
    out = []
    for model in (tm, remat):
        leaves = tree_lib.leaves(tp)
        for p in leaves:
            p.requires_grad_(True)
        loss = model.loss(tp, batch)
        out.append((loss.detach(), torch.autograd.grad(loss, leaves)))
        for p in leaves:
            p.requires_grad_(False)
    assert torch.equal(out[0][0], out[1][0])
    for a, b in zip(out[0][1], out[1][1]):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-7)


def test_common_blocks_match_reference():
    from repro.models import common as jcommon
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 16, 4, 32)).astype(np.float32)
    pos = np.arange(16)
    np.testing.assert_allclose(
        common.apply_rope(torch.from_numpy(x), torch.from_numpy(pos),
                          theta=5e6).numpy(),
        np.asarray(jcommon.apply_rope(jnp.asarray(x), jnp.asarray(pos),
                                      theta=5e6)), rtol=1e-5, atol=1e-5)
    h = rng.standard_normal((3, 64)).astype(np.float32)
    sc = rng.standard_normal(64).astype(np.float32)
    np.testing.assert_allclose(
        common.rmsnorm(torch.from_numpy(h), torch.from_numpy(sc)).numpy(),
        np.asarray(jcommon.rmsnorm(jnp.asarray(h), jnp.asarray(sc))),
        rtol=1e-6, atol=1e-6)
    m = common.causal_mask(5, 7, q_offset=2, window=3)
    np.testing.assert_array_equal(
        m.numpy(), np.asarray(jcommon.causal_mask(5, 7, q_offset=2, window=3)))
    logits = rng.standard_normal((2, 5, 11)).astype(np.float32)
    labels = rng.integers(0, 11, (2, 5))
    np.testing.assert_allclose(
        float(common.softmax_xent(torch.from_numpy(logits),
                                  torch.from_numpy(labels))),
        float(jcommon.softmax_xent(jnp.asarray(logits), jnp.asarray(labels))),
        rtol=1e-6)
