"""The attention-family architectures of the port against the JAX reference
on the same weights (the reference's parameters carried across with
`params_from_jax`) and the same numpy inputs: llava-next-mistral-7b (the
VLM: projected patch embeddings before the text) and whisper-small (the
encoder-decoder: layernorm, the tanh GELU, an encoder over frame
embeddings, cross blocks, learned positions), each at its smoke config,
f32 on the CPU; with the shared pieces (activations, layernorm, positions,
chunked attention, the registry) and the model-parallel layout and hybrid
plan of every arch against the reference's planner. The per-architecture
tests are tests/torch_archs_suite.py's, run here for ARCHS; minicpm3-4b,
the recurrent and the MoE families run them in tests/test_torch_archs_mla.py,
test_torch_archs_recurrent.py and test_torch_archs_moe.py.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from repro.configs import registry as jreg
from repro.core import planner as jpl
from repro.launch import mesh as jmesh
from repro.models import attention as jattn, common as jcommon
from repro.models.transformer import Model as JModel
from repro_torch import tree as tree_lib
from repro_torch.configs import registry as treg
from repro_torch.core import planner as tpl
from repro_torch.launch import serve as serve_cli
from repro_torch.models import attention as tattn, blocks, common as tcommon
from repro_torch.models.transformer import Batch as TBatch, Model as TModel
from repro_torch.serve import engine as tengine

import torch_archs_ranks
from torch_archs_suite import (  # noqa: F401 (collected here for ARCHS)
    _tokens, models, pytest_generate_tests, ranks8,
    test_decode_matches_forward,
    test_eight_gloo_ranks_match_reference_on_mesh8,
    test_forward_logits_and_loss_match_reference,
    test_greedy_tokens_through_engine_match_reference,
    test_kv_chunk_matches_dense_and_reference,
    test_one_rank_train_losses_match_reference,
    test_params_from_jax_carries_every_leaf,
    test_prefill_and_teacher_forced_decode_match_reference,
    test_serve_cli_runs_on_cpu, test_train_cli_runs_on_cpu)

ARCHS = torch_archs_ranks.ATTENTION


# --- common -------------------------------------------------------------------

@pytest.mark.parametrize("name", ["silu", "gelu", "gelu_tanh", "relu"])
def test_act_fn_matches_reference(name):
    """Every activation on [-6, 6] within 1e-6 of the reference's: its
    "gelu" is jax.nn.gelu's default, the tanh approximation (the erf GELU
    differs by up to 4.7e-4)."""
    x = np.linspace(-6, 6, 10001, dtype=np.float32)
    want = np.asarray(jcommon.act_fn(name)(jnp.asarray(x)))
    got = tcommon.act_fn(name)(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_layernorm_matches_reference():
    rng = np.random.default_rng(0)
    x = (rng.standard_normal((3, 5, 64)) * 3 + 1).astype(np.float32)
    scale, bias = (rng.standard_normal(64).astype(np.float32)
                   for _ in range(2))
    for eps in (1e-5, 1e-6):
        want = np.asarray(jcommon.layernorm(*map(jnp.asarray,
                                                 (x, scale, bias)), eps))
        got = tcommon.layernorm(*map(torch.from_numpy, (x, scale, bias)),
                                eps).numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    xb = torch.from_numpy(x).to(torch.bfloat16)
    assert tcommon.layernorm(xb, torch.from_numpy(scale),
                             torch.from_numpy(bias)).dtype == torch.bfloat16


@pytest.mark.parametrize("n,d", [(16, 64), (1500, 768)])
def test_sinusoidal_positions_match_reference(n, d):
    """Within 1e-6 plus two f32 ulps of the angle pos * div (up to 1499
    rad): the two libraries' exp may round div one ulp apart, which moves
    the angle by that much."""
    got = tcommon.sinusoidal_positions(n, d).numpy()
    want = np.asarray(jcommon.sinusoidal_positions(n, d))
    tol = 1e-6 + 2 * np.finfo(np.float32).eps * np.arange(n)[:, None]
    assert (np.abs(got - want) <= tol).all(), np.abs(got - want).max()


@pytest.mark.parametrize("causal,window,sk,chunk", [
    (True, None, 40, 16), (True, 8, 33, 7), (False, None, 40, 64),
    (False, 8, 25, 16)])
def test_chunked_sdpa_matches_reference(causal, window, sk, chunk):
    rng = np.random.default_rng(sk * 7 + chunk)
    q, k, v = (rng.standard_normal((2, sk, 3, 8)).astype(np.float32)
               for _ in range(3))
    want = jattn.chunked_sdpa(*map(jnp.asarray, (q, k, v)), causal=causal,
                              window=window, kv_chunk=chunk)
    got = tattn.chunked_sdpa(*map(torch.from_numpy, (q, k, v)),
                             causal=causal, window=window, kv_chunk=chunk)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-5)


# --- configs and parameters ---------------------------------------------------
def test_registry_and_kinds():
    for arch in torch_archs_ranks.ARCHS:
        assert arch in treg.ARCH_IDS
    assert {"enc", "cross", "mla", "local", "moe", "ssm", "rglru"} <= set(
        blocks.PORTED_KINDS)
    assert set(treg.ARCH_IDS) == set(jreg.ARCH_IDS)
    cfg = treg.get_smoke_config("whisper-small")
    assert set(blocks.norm_defs(8, cfg)) == {"scale", "bias"}



def test_missing_frame_embeddings_raise():
    """The reference's serve path hands whisper no frame embeddings and
    crashes in its encoder; the port refuses with a ValueError that names
    them, from the model and from the engine."""
    tm = TModel(treg.get_smoke_config("whisper-small"))
    tp = tm.init(torch.Generator().manual_seed(0), "cpu")
    tok = _tokens(tm.cfg.vocab, (2, 8), 11)
    with pytest.raises(ValueError, match="frame embeddings"):
        tm.forward(tp, TBatch(tokens=torch.from_numpy(tok)))
    eng = tengine.Engine(tm, tp, tengine.EngineConfig(max_seq=32))
    with pytest.raises(ValueError, match="frame embeddings"):
        eng.generate(tok, 2)



def _spec_leaves(jspecs):
    return [(tuple(k.key for k in path), tuple(s)) for path, s in
            jax.tree_util.tree_leaves_with_path(
                jspecs, is_leaf=lambda s: isinstance(s, P))]


@pytest.mark.parametrize("family_arch", torch_archs_ranks.ARCHS)
def test_mp_layout_equals_reference_for_every_family(family_arch):
    """Neither use refuses the architecture. Model parallelism: at (data,
    model) = (2, 4) the port's planner specs equal the reference's leaf by
    leaf and `mp_layout` names the dimension each spec puts the model axis
    on. A hybrid plan on ("node", "local") = (2, 4): `make_hybrid_planner`'s
    specs equal the reference's leaf by leaf."""
    model = TModel(treg.get_smoke_config(family_arch))
    jm = JModel(jreg.get_smoke_config(family_arch))
    fake = types.SimpleNamespace(mesh_dim_names=("data", "model"),
                                 shape=(2, 4), device_type="cpu",
                                 get_group=lambda a: a)
    planner = tpl.Planner(mesh=fake)
    specs = planner.tree_specs(model.param_defs(),
                               stacked_paths=TModel.stacked_path)
    jspecs = jpl.Planner(mesh=jmesh.make_host_mesh(2, 4)).tree_specs(
        jm.param_defs(), stacked_paths=JModel.stacked_path)
    assert tree_lib.leaves_with_paths(specs) == _spec_leaves(jspecs)
    dims = model.mp_layout(planner)
    for (path, spec), d in zip(tree_lib.leaves_with_paths(specs),
                               tree_lib.leaves(dims)):
        model_dim = [i - len(spec) for i, a in enumerate(spec)
                     if a == "model"]
        assert d == (model_dim[0] if model_dim else None), path
    assert any(d is not None for d in tree_lib.leaves(dims))
    hybrid = tpl.make_hybrid_planner({"node": 2, "local": 4}, model.cfg,
                                     batch=8, seq=16)
    jhybrid = jpl.make_hybrid_planner(jmesh.make_hier_mesh(2, 4), jm.cfg,
                                      batch=8, seq=16)
    assert tree_lib.leaves_with_paths(hybrid.tree_specs(
        model.param_defs(), stacked_paths=TModel.stacked_path)) == \
        _spec_leaves(jhybrid.tree_specs(jm.param_defs(),
                                        stacked_paths=JModel.stacked_path))


def test_serve_cli_refuses_whisper_without_frames():
    """The serve CLI, like the reference's, hands the engine no frame
    embeddings: whisper-small stops with the ValueError naming them."""
    with pytest.raises(ValueError, match="frame embeddings"):
        serve_cli.main(["--arch", "whisper-small", "--batch", "2",
                        "--prompt-len", "8", "--new-tokens", "2", "--device",
                        "cpu"])
