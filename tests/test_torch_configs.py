"""The port's chatglm3-6b and deepseek-7b (the "attn" kind: chatglm3-6b
rotates half of each head and serves 32 query heads from 2 KV heads,
deepseek-7b is plain multi-head attention) against the reference on the
same weights: the configs field by field, and on the smoke configs (f32 on
the CPU, the reference's parameters carried across with `params_from_jax`)
the forward logits (atol 1e-4), the loss (rtol 1e-5) and the greedy tokens
of a prefill and its decode steps through each package's engine (equal).
Every ported config (the attention, recurrent and MoE families' too:
tests/test_torch_archs.py holds their models) equals the reference's field
by field, with the same parameter count and parameter-count estimate, and
the registry holds every architecture of the reference's. The paper's CNN
layer tables (`configs/cnn_tables.py`: ResNet-50, VGG-16, GoogLeNet) equal
the reference's layer by layer, field by field.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as jbase, cnn_tables as jcnn, registry as jreg
from repro.models.transformer import Batch as JBatch, Model as JModel
from repro.serve import engine as jengine
from repro_torch import convert
from repro_torch.configs import base as tbase, cnn_tables as tcnn
from repro_torch.configs import registry as treg
from repro_torch.models.transformer import Batch as TBatch, Model as TModel
from repro_torch.serve import engine as tengine

ARCHS = ("chatglm3-6b", "deepseek-7b")
CONFIG_ARCHS = ("yi-6b",) + ARCHS + ("llava-next-mistral-7b", "whisper-small",
                                     "minicpm3-4b", "recurrentgemma-2b",
                                     "mamba2-2.7b", "grok-1-314b",
                                     "arctic-480b")


def _fields(cfg, names=None):
    """The config's fields (those of `names`, a {field: sub-fields} dict,
    when given) with the dtype as its name (the packages' dtype objects
    differ)."""
    out = {}
    for f in dataclasses.fields(cfg):
        if names is not None and f.name not in names:
            continue
        v = getattr(cfg, f.name)
        if f.name == "dtype":
            v = (str(v).split(".")[-1] if isinstance(v, torch.dtype)
                 else jnp.dtype(v).name)
        elif dataclasses.is_dataclass(v):
            v = _fields(v, None if names is None else dict.fromkeys(
                names[f.name]))
        out[f.name] = v
    return out


@pytest.mark.parametrize("smoke", [False, True])
@pytest.mark.parametrize("arch", CONFIG_ARCHS)
def test_config_equals_reference(arch, smoke):
    """Every field the port's config has equals the reference's, and so do
    the parameter count and its estimate."""
    get_t = treg.get_smoke_config if smoke else treg.get_config
    get_j = jreg.get_smoke_config if smoke else jreg.get_config
    mine = _fields(get_t(arch))
    names = {k: (list(v) if isinstance(v, dict) else None)
             for k, v in mine.items()}
    assert _fields(get_j(arch), names) == mine
    assert arch in treg.ARCH_IDS
    assert TModel(get_t(arch)).n_params() == JModel(get_j(arch)).n_params()
    assert tbase.param_count_estimate(get_t(arch)) == \
        jbase.param_count_estimate(get_j(arch))


@pytest.fixture(scope="module", params=ARCHS)
def models(request):
    arch = request.param
    jm = JModel(jreg.get_smoke_config(arch))
    params = jm.init(jax.random.PRNGKey(0))
    tp = convert.params_from_jax(jax.tree_util.tree_map(np.asarray, params),
                                 device="cpu")
    return jm, params, TModel(treg.get_smoke_config(arch)), tp


def test_logits_and_loss_match_reference(models):
    jm, params, tm, tp = models
    tok = np.random.default_rng(0).integers(0, jm.cfg.vocab, size=(2, 24)
                                            ).astype(np.int32)
    jb = JBatch(tokens=jnp.asarray(tok), labels=jnp.asarray(tok))
    tb = TBatch(tokens=torch.from_numpy(tok), labels=torch.from_numpy(tok))
    with torch.no_grad():
        tlog = tm.forward(tp, tb)
        tl = tm.loss(tp, tb)
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jm.forward(params, jb)),
                               rtol=0, atol=1e-4)
    np.testing.assert_allclose(float(tl), float(jm.loss(params, jb)),
                               rtol=1e-5)


def test_greedy_prefill_and_decode_tokens_match_reference(models):
    jm, params, tm, tp = models
    prompts = np.random.default_rng(1).integers(
        0, jm.cfg.vocab, (3, 20)).astype(np.int32)
    want = jengine.Engine(jm, params, jengine.EngineConfig(
        max_seq=40)).generate(prompts, 8)
    got = tengine.Engine(tm, tp, tengine.EngineConfig(max_seq=40)).generate(
        prompts, 8)
    np.testing.assert_array_equal(got, want)


def test_registry_holds_every_reference_arch():
    assert set(treg.ARCH_IDS) == set(jreg.ARCH_IDS) and len(treg.ARCH_IDS) == 10


@pytest.mark.parametrize("topo", sorted(jcnn.TOPOLOGIES))
def test_cnn_tables_equal_reference(topo):
    """Every layer of the topology: its name, kind (by value) and the
    numbers the C2C model and the simulator read, exactly."""
    assert sorted(tcnn.TOPOLOGIES) == sorted(jcnn.TOPOLOGIES)

    def rows(layers):
        return [{k: (v.value if hasattr(v, "value") else v)
                 for k, v in dataclasses.asdict(l).items()} for l in layers]

    got, want = rows(tcnn.TOPOLOGIES[topo]()), rows(jcnn.TOPOLOGIES[topo]())
    assert len(got) == len(want) > 10
    assert got == want
