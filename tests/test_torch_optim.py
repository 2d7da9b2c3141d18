"""The port's optimizers, schedules and checkpoints against the reference's.

Optimizers: 3 updates of every optimizer, with f32 and bf16 state (and
bf16 parameters), on the same numpy parameters and gradients. The
arithmetic is the reference's op by op in f32; the trust ratio's norms sum
in another order, so f32 results are held to rtol 1e-5 (atol 1e-8) and
values stored in bf16 to one bf16 ulp (rtol 2^-7: an f32 difference in the
last bits can round to the neighbouring bf16 value).

Checkpoints: the same directory format in both packages; a checkpoint
written by either restores in the other bit for bit, bf16 leaves included.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import ckpt as jckpt
from repro.optim import optimizers as jopt, schedules as jsched
from repro_torch import convert, tree as tree_lib
from repro_torch.checkpoint import ckpt
from repro_torch.optim import optimizers as topt, schedules as tsched

BF16_ULP = 2.0 ** -7


def _tree(rng):
    return {"w": (rng.standard_normal((16, 8)) * 0.1).astype(np.float32),
            "b": {"z": np.zeros(8, np.float32),
                  "n": (rng.standard_normal(8)).astype(np.float32)}}


def _np(t):
    return t.float().numpy() if t.dtype == torch.bfloat16 else t.numpy()


@pytest.mark.parametrize("name", sorted(jopt.OPTIMIZERS))
@pytest.mark.parametrize("state_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("param_dtype", ["float32", "bfloat16"])
def test_optimizer_updates_match_reference(name, state_dtype, param_dtype):
    rng = np.random.default_rng(3)
    p = _tree(rng)
    grads = [_tree(rng) for _ in range(3)]
    sched_j = jsched.warmup_linear(1e-2, 1, 3)
    sched_t = tsched.warmup_linear(1e-2, 1, 3)
    jo = jopt.make_optimizer(name, sched_j,
                             state_dtype=getattr(jnp, state_dtype))
    to = topt.make_optimizer(name, sched_t,
                             state_dtype=getattr(torch, state_dtype))
    assert to.state_bytes_per_param == jo.state_bytes_per_param
    jp = jax.tree_util.tree_map(
        lambda a: jnp.asarray(a).astype(getattr(jnp, param_dtype)), p)
    tp = convert.params_from_jax(jax.tree_util.tree_map(np.asarray, jp),
                                 device="cpu")
    js, ts = jo.init(jp), to.init(tp)
    for step, g in enumerate(grads):
        jp, js = jo.update(jax.tree_util.tree_map(jnp.asarray, g), js, jp,
                           jnp.int32(step))
        tp, ts = to.update(tree_lib.tree_map(torch.from_numpy, g), ts, tp,
                           step)
    for want, got in ((jp, tp), (js, ts)):
        jl = jax.tree_util.tree_leaves(want)
        tl = tree_lib.leaves(got)
        assert len(jl) == len(tl)
        for a, b in zip(jl, tl):
            assert str(b.dtype).split(".")[1] == str(a.dtype)
            rtol = BF16_ULP if b.dtype == torch.bfloat16 else 1e-5
            np.testing.assert_allclose(_np(b), np.asarray(a, np.float32),
                                       rtol=rtol, atol=1e-8)


def test_trust_ratio_edge_cases_match_reference():
    for p, u in ((np.zeros(4), np.ones(4)), (np.ones(4), np.zeros(4)),
                 (np.full(4, 3.0), np.full(4, 0.5))):
        want = jopt._trust_ratio(jnp.asarray(p, jnp.float32),
                                 jnp.asarray(u, jnp.float32))
        got = topt._trust_ratio(torch.tensor(p, dtype=torch.float32),
                                torch.tensor(u, dtype=torch.float32))
        assert float(got) == pytest.approx(float(want), rel=1e-6)


def test_schedules_match_reference():
    pairs = [(tsched.warmup_linear(3e-3, 2, 10),
              jsched.warmup_linear(3e-3, 2, 10)),
             (tsched.warmup_cosine(1e-2, 3, 20),
              jsched.warmup_cosine(1e-2, 3, 20)),
             (tsched.constant(5e-4), jsched.constant(5e-4))]
    for ts, js in pairs:
        for step in range(22):
            assert float(ts(step)) == pytest.approx(
                float(js(jnp.int32(step))), rel=1e-6)
    assert tsched.linear_batch_scaled(0.1, 256, 8192) == \
        jsched.linear_batch_scaled(0.1, 256, 8192)


def test_unknown_optimizer_raises():
    with pytest.raises(ValueError, match="unknown optimizer"):
        topt.make_optimizer("adagrad", 1e-3)


# --------------------------------------------------------------------------
# checkpoints across packages
# --------------------------------------------------------------------------

def _ckpt_tree():
    rng = np.random.default_rng(5)
    return {"params": {
        "embed": rng.standard_normal((6, 4)).astype(np.float32),
        "blocks": {"p0_attn": {"wq": jnp.asarray(
            rng.standard_normal((2, 4, 4)), jnp.bfloat16)}},
        "ln_f": {"scale": np.ones(4, np.float32)}}}


def _as_numpy(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def test_jax_checkpoint_restores_in_the_port(tmp_path):
    tree = _as_numpy(_ckpt_tree())
    jckpt.save(str(tmp_path), tree, step=7)
    like = tree_lib.tree_map(
        lambda t: torch.empty(t.shape, dtype=t.dtype, device="meta"),
        convert.params_from_jax(tree, device="cpu"))
    got = ckpt.restore(str(tmp_path), like, device="cpu")
    assert ckpt.latest_step(str(tmp_path)) == 7
    for (path, a), b in zip(tree_lib.leaves_with_paths(tree),
                            tree_lib.leaves(got)):
        assert b.dtype == (torch.bfloat16 if a.dtype.name == "bfloat16"
                           else torch.float32), path
        want = a.view(np.uint16) if a.dtype.name == "bfloat16" else a
        have = (b.view(torch.int16).numpy().view(np.uint16)
                if b.dtype == torch.bfloat16 else b.numpy())
        np.testing.assert_array_equal(have, want)


def test_port_checkpoint_restores_in_jax(tmp_path):
    tree = convert.params_from_jax(_as_numpy(_ckpt_tree()), device="cpu")
    ckpt.save(str(tmp_path), tree, step=3)
    like = jax.tree_util.tree_map(
        lambda a: jax.ShapeDtypeStruct(a.shape, a.dtype),
        _as_numpy(_ckpt_tree()))
    got = jckpt.restore(str(tmp_path), like)
    assert jckpt.latest_step(str(tmp_path)) == 3
    for a, b in zip(tree_lib.leaves(tree), jax.tree_util.tree_leaves(got)):
        assert str(b.dtype) == str(a.dtype).split(".")[1]
        have = np.asarray(b)
        if a.dtype == torch.bfloat16:
            np.testing.assert_array_equal(
                have.view(np.uint16), a.view(torch.int16).numpy().view(
                    np.uint16))
        else:
            np.testing.assert_array_equal(have, a.numpy())


def test_port_checkpoint_round_trip_and_errors(tmp_path):
    tree = convert.params_from_jax(_as_numpy(_ckpt_tree()), device="cpu")
    ckpt.save(str(tmp_path), tree)
    got = ckpt.restore(str(tmp_path), tree)
    for a, b in zip(tree_lib.leaves(tree), tree_lib.leaves(got)):
        assert torch.equal(a, b) and a.dtype == b.dtype
    assert ckpt.latest_step(str(tmp_path)) is None
    assert ckpt.latest_step(str(tmp_path / "missing")) is None
    wrong = dict(tree, params=dict(tree["params"],
                                   embed=torch.empty(3, 4)))
    with pytest.raises(ValueError, match="shape"):
        ckpt.restore(str(tmp_path), wrong)
    with pytest.raises(KeyError, match="extra"):
        ckpt.restore(str(tmp_path), dict(tree, extra=torch.empty(1)))
    meta = tree_lib.tree_map(lambda t: t.to("meta"), tree)
    with pytest.raises(ValueError, match="device="):
        ckpt.restore(str(tmp_path), meta)
