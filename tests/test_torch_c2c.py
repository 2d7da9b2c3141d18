"""The port's C2C analysis and hybrid plans against the JAX package's.

`repro_torch.core.c2c` is a copy of `repro/core/c2c.py` on the port's copy
of `core/hw.py`, and the hybrid half of `repro_torch.core.planner` a port
of the reference's: both run the same Python float arithmetic, so every
ratio, choice, plan and modeled time must equal the reference's exactly
(==, no tolerance), on a grid of layers, batches, node counts and group
sizes, for yi-6b's smoke and full configs, and, through the reference's own
config objects, for every block kind of every architecture the reference
has.
"""

import dataclasses

import pytest

from repro import compat
from repro.configs import registry as jreg
from repro.core import c2c as jc2c
from repro.core import hw as jhw
from repro.core import planner as jpl
from repro_torch.configs import registry as treg
from repro_torch.core import c2c as tc2c
from repro_torch.core import hw as thw
from repro_torch.core import planner as tpl


def _layers(m):
    """The same layer list from either module."""
    return [m.conv_layer("conv", 64, 128, 3, 56, 56),
            m.conv_layer("conv_s2", 256, 512, 3, 14, 14, stride=2),
            m.fc_layer("fc", 25088, 4096),
            m.fc_layer("fc_seq", 4096, 11008, seq=2048),
            m.attention_layer("attn", 4096, 32, 128, 4, 2048),
            m.mlp_layer("mlp", 4096, 11008, 2048),
            m.mlp_layer("mlp2", 768, 3072, 1500, gated=False),
            m.moe_layer("moe", 4096, 14336, 8, 2, 4096),
            m.ssm_layer("ssm", 2560, 5120, 128, 2048),
            m.embed_layer("embed", 64000, 4096, 2048),
            m.LayerSpec("empty", m.LayerKind.NORM, 0.0, 0.0, 0.0)]


def _choice(c):
    return (c.strategy.value, c.group_size, c.ratio, c.comm_bytes)


def _spec(l):
    return (l.name, l.kind.value, l.weight_elems, l.out_elems_per_sample,
            l.flops_fwd_per_sample, l.bwd_flops_factor)


def test_layer_constructors_equal_reference():
    assert [_spec(l) for l in _layers(tc2c)] == \
        [_spec(l) for l in _layers(jc2c)]
    assert [k.value for k in tc2c.LayerKind] == \
        [k.value for k in jc2c.LayerKind]
    assert [s.value for s in tc2c.Strategy] == \
        [s.value for s in jc2c.Strategy]


@pytest.mark.parametrize("batch", [1, 8, 32, 256])
@pytest.mark.parametrize("p", [1, 2, 3, 8, 16, 64])
def test_ratios_and_choices_equal_reference(batch, p):
    for tl, jl in zip(_layers(tc2c), _layers(jc2c)):
        for bpe in (4.0, 2.0):
            assert tc2c.data_parallel_ratio(tl, batch, p, bpe) == \
                jc2c.data_parallel_ratio(jl, batch, p, bpe)
            for g in (1, 2, 3, 4, 8, 16):
                assert tc2c.model_parallel_ratio(tl, batch, g, bpe) == \
                    jc2c.model_parallel_ratio(jl, batch, g, bpe)
                assert tc2c.hybrid_ratio(tl, batch, p, g, bpe) == \
                    jc2c.hybrid_ratio(jl, batch, p, g, bpe)
            for gs in (None, [1, 2], [1, 4, 8], [3]):
                assert _choice(tc2c.choose_strategy(tl, batch, p, gs, bpe)) \
                    == _choice(jc2c.choose_strategy(jl, batch, p, gs, bpe))


@pytest.mark.parametrize("name", ["smoke", "full"])
@pytest.mark.parametrize("seq", [32, 2048])
def test_layers_from_yi6b_equal_reference(name, seq):
    get_t = treg.get_smoke_config if name == "smoke" else treg.get_config
    get_j = jreg.get_smoke_config if name == "smoke" else jreg.get_config
    tl = tc2c.layers_from_model_config(get_t("yi-6b"), seq)
    jl = jc2c.layers_from_model_config(get_j("yi-6b"), seq)
    assert [_spec(l) for l in tl] == [_spec(l) for l in jl]
    assert [l.name for l in tl] == ["embed", "p0_attn", "head"]
    link = thw.CLOUD_10G.inter
    assert tc2c.exposed_comm_upper_bound(tl, 8, 16, link) == \
        jc2c.exposed_comm_upper_bound(jl, 8, 16, jhw.CLOUD_10G.inter)


@pytest.mark.parametrize("arch", jreg.ARCH_IDS)
def test_block_layers_of_every_reference_arch_equal_reference(arch):
    """Every block kind (attn, local, mla, moe, ssm, rglru, enc, cross),
    read from the reference's own configs: the copy reads the same fields
    and computes the same numbers."""
    for get in (jreg.get_smoke_config, jreg.get_config):
        cfg = get(arch)
        assert [_spec(l) for l in tc2c.layers_from_model_config(cfg, 64)] \
            == [_spec(l) for l in jc2c.layers_from_model_config(cfg, 64)]


@pytest.mark.parametrize("kind", ["mla", "moe", "ssm", "rglru", "nope"])
def test_kinds_the_port_config_lacks_fail_as_the_reference(kind):
    """yi-6b has no mla/moe/ssm/rglru sub-config: asking for such a block
    fails with the reference's error, type and message."""
    with pytest.raises(Exception) as want:
        jc2c.block_layer("x", kind, jreg.get_smoke_config("yi-6b"), 64)
    with pytest.raises(Exception) as got:
        tc2c.block_layer("x", kind, treg.get_smoke_config("yi-6b"), 64)
    assert (got.type, str(got.value)) == (want.type, str(want.value))


# ---------------------------------------------------------------------------
# hybrid plans
# ---------------------------------------------------------------------------

def _plan(plan):
    return (plan.tp_axis, plan.tp, plan.dp, plan.data_axes,
            [(l.name, l.kind, _choice(l.choice), l.executed, l.reason,
              l.model_parallel) for l in plan.layers],
            sorted(plan.model_layer_names), plan.any_model_parallel)


def _indivisible(cfg):
    return dataclasses.replace(
        cfg, attn=dataclasses.replace(cfg.attn, n_heads=2, n_kv=2))


def _cfgs(name):
    if name == "smoke":
        return treg.get_smoke_config("yi-6b"), jreg.get_smoke_config("yi-6b")
    if name == "indivisible":
        return (_indivisible(treg.get_smoke_config("yi-6b")),
                _indivisible(jreg.get_smoke_config("yi-6b")))
    return treg.get_config("yi-6b"), jreg.get_config("yi-6b")


# (config, (node, local), batch, seq, group_size); the full yi-6b rows are
# the meshes of the chooser's table at cells A-F's batch and sequence
PLANS = [("smoke", (2, 4), 8, 64, None), ("smoke", (2, 4), 8, 32, None),
         ("smoke", (2, 4), 8, 64, 2), ("smoke", (2, 4), 8, 64, 3),
         ("smoke", (1, 1), 8, 64, None), ("smoke", (2, 1), 8, 64, None),
         ("indivisible", (2, 4), 8, 64, None),
         ("indivisible", (2, 4), 8, 16, None),
         ("full", (1, 1), 8, 2048, None), ("full", (1, 4), 8, 2048, None),
         ("full", (2, 2), 8, 2048, None), ("full", (2, 4), 8, 2048, None),
         ("full", (1, 4), 32, 2048, None), ("full", (2, 4), 8, 2048, 8)]


@pytest.mark.parametrize("case", PLANS, ids=lambda c: "-".join(map(str, c)))
def test_plan_hybrid_equals_reference(case):
    name, (node, local), batch, seq, g = case
    tcfg, jcfg = _cfgs(name)
    tplan = tpl.plan_hybrid(tcfg, {"node": node, "local": local}, batch, seq,
                            group_size=g)
    jplan = jpl.plan_hybrid(jcfg, compat.abstract_mesh(
        (node, local), ("node", "local")), batch, seq, group_size=g)
    assert _plan(tplan) == _plan(jplan)
    layers_t = tc2c.layers_from_model_config(tcfg, seq)
    layers_j = jc2c.layers_from_model_config(jcfg, seq)
    for topo in thw.TOPOLOGIES:
        cm_t = tpl.model_hybrid_comm(tplan, layers_t, batch, tplan.dp,
                                     thw.TOPOLOGIES[topo])
        cm_j = jpl.model_hybrid_comm(jplan, layers_j, batch, jplan.dp,
                                     jhw.TOPOLOGIES[topo])
        assert dataclasses.astuple(cm_t) == dataclasses.astuple(cm_j), topo
        assert (cm_t.reduction_vs_flat, cm_t.reduction_vs_hier) == \
            (cm_j.reduction_vs_flat, cm_j.reduction_vs_hier)


def test_chooser_table_for_full_yi6b():
    """The verdicts of the chooser's table for full yi-6b (seq 2048):
    p0_attn runs model-parallel on (1, 4), (2, 2) and (2, 4) at batch 8,
    data-parallel at tp = 1 and at batch 32; embed and head never."""
    cfg = treg.get_config("yi-6b")
    want = {((1, 1), 8): ("data", 1, "data"),
            ((1, 4), 8): ("model", 4, "model"),
            ((2, 2), 8): ("hybrid", 2, "model"),
            ((2, 4), 8): ("hybrid", 4, "model"),
            ((1, 4), 32): ("data", 1, "data")}
    for ((node, local), batch), (strategy, g, executed) in want.items():
        plan = tpl.plan_hybrid(cfg, {"node": node, "local": local}, batch,
                               2048)
        lp = plan.layer("p0_attn")
        assert (lp.choice.strategy.value, lp.choice.group_size,
                lp.executed) == (strategy, g, executed), (node, local, batch)
        for name in ("embed", "head"):
            assert not plan.layer(name).model_parallel


def test_plan_hybrid_needs_the_tp_axis():
    with pytest.raises(ValueError, match="mesh has no 'local' axis"):
        tpl.plan_hybrid(treg.get_smoke_config("yi-6b"),
                        {"data": 8, "model": 1}, 8, 64)


def test_modeled_hybrid_beats_pure_dp():
    tcfg, _ = _cfgs("smoke")
    plan = tpl.plan_hybrid(tcfg, {"node": 2, "local": 4}, batch=8, seq=64)
    layers = tc2c.layers_from_model_config(tcfg, 64)
    for topo in (thw.CLOUD_10G, thw.HPC_OPA):
        cm = tpl.model_hybrid_comm(plan, layers, batch=8, nodes=plan.dp,
                                   topo=topo)
        assert cm.t_hybrid < cm.t_dp_flat, topo.name
        assert cm.reduction_vs_flat > 1.0
        assert cm.hybrid_grad_bytes < cm.dp_grad_bytes


@pytest.mark.parametrize("p", [1, 8, 64])
@pytest.mark.parametrize("group_sizes", [None, [1, 4], [2, 8]])
def test_plan_report_equals_reference(p, group_sizes):
    tl, jl = _layers(tc2c), _layers(jc2c)
    for batch in (8, 256):
        got = tpl.plan_report(tl, batch, p, group_sizes)
        want = jpl.plan_report(jl, batch, p, group_sizes)
        assert [(r.name, r.kind, _choice(r.choice)) for r in got] == \
            [(r.name, r.kind, _choice(r.choice)) for r in want]
