"""The port's simulator (repro_torch.core.simulator) against the reference's,
and the planner paths that rest on it (`estimate_overlap`, `fault=` in
`choose_allreduce_algo` and `route_buckets`).

The simulator is framework-free arithmetic copied from the reference, so
every result must equal the reference's EXACTLY (==, no tolerance): the
cases of tests/test_simulator.py and tests/test_faults.py (every Policy of
`simulate_iteration`, with and without a topology and a fault,
`scaling_efficiency`, `exposed_comm_reduction`, `FaultSpec`'s
compositions), `simulate_bucket_schedule` with and without overlap and
with `record_timeline`, and `generate_episode` on the labeled episodes of
benchmarks/bench_detect.py. Layers come from the reference's CNN tables
(plain data) through each package's own `layers_from_specs`.
"""

import dataclasses
import enum

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from benchmarks import bench_detect
from repro.configs import cnn_tables
from repro.core import hw as jhw
from repro.core import planner as jplanner
from repro.core import scheduler as jsched
from repro.core import simulator as jsim
from repro_torch.core import hw, planner, scheduler
from repro_torch.core import simulator as sim

FAULT_KW = {
    "inter_bw": dict(inter_bw_factor=0.5),
    "inter_latency": dict(inter_latency_factor=3.0),
    "intra_bw": dict(intra_bw_factor=0.3),
    "straggler": dict(straggler_slowdown=1.5, straggler_node=3),
    "hetero": dict(hetero_link_bw_factors=(1.0, 0.5, 0.9)),
    "compound": dict(inter_bw_factor=0.7, straggler_slowdown=1.2,
                     intra_latency_factor=2.0),
}


def plain(x):
    """Dataclasses, enums and sequences as plain comparable values (an
    enum by its value, so the two packages' Policy members compare)."""
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return {f.name: plain(getattr(x, f.name))
                for f in dataclasses.fields(x)}
    if isinstance(x, enum.Enum):
        return x.value
    if isinstance(x, (list, tuple)):
        return [plain(v) for v in x]
    if isinstance(x, dict):
        return {k: plain(v) for k, v in x.items()}
    return x


def _layers(name="resnet50", bs=32):
    specs = cnn_tables.TOPOLOGIES[name]()
    got = sim.layers_from_specs(specs, bs, hw.XEON_6148)
    want = jsim.layers_from_specs(specs, bs, jhw.XEON_6148)
    assert plain(got) == plain(want)
    return got, want


def _policies():
    return [(p, jsim.Policy(p.value)) for p in sim.Policy]


def test_policy_enum_matches_reference():
    assert [p.value for p in sim.Policy] == [p.value for p in jsim.Policy]


@pytest.mark.parametrize("name", sorted(cnn_tables.TOPOLOGIES))
def test_simulate_iteration_equals_reference(name):
    """Every policy, node count and link of tests/test_simulator.py, with
    the timeline recorded; the reference's invariants hold on the port."""
    layers, jlayers = _layers(name)
    for p in (1, 8, 64):
        for link in ("ETH_10G", "OMNIPATH"):
            for eff in (1.0, 0.7):
                for pol, jpol in _policies():
                    got = sim.simulate_iteration(
                        layers, p, getattr(hw, link), pol,
                        record_timeline=True, overlap_eff=eff)
                    want = jsim.simulate_iteration(
                        jlayers, p, getattr(jhw, link), jpol,
                        record_timeline=True, overlap_eff=eff)
                    assert plain(got) == plain(want)
                    assert got.timeline
    e = {pol: sim.simulate_iteration(layers, 64, hw.ETH_10G, pol,
                                     overlap_eff=0.7).exposed_comm
         for pol in sim.Policy}
    assert e[sim.Policy.PRIORITY_OVERLAP] <= e[sim.Policy.FIFO_OVERLAP] + 1e-9
    assert e[sim.Policy.FIFO_OVERLAP] <= e[sim.Policy.BLOCKING] + 1e-9


@pytest.mark.parametrize("comm_algo", ["flat", "hier", "auto"])
def test_simulate_iteration_on_topology_equals_reference(comm_algo):
    layers, jlayers = _layers("vgg16", 64)
    for tname in sorted(jhw.TOPOLOGIES):
        for wire, ef in (("fp32", False), ("int8", True)):
            for pol, jpol in _policies():
                kw = dict(topo=None, comm_algo=comm_algo, wire=wire, ef=ef)
                got = sim.simulate_iteration(
                    layers, 16, hw.ETH_10G, pol, record_timeline=True,
                    **{**kw, "topo": hw.TOPOLOGIES[tname]})
                want = jsim.simulate_iteration(
                    jlayers, 16, jhw.ETH_10G, jpol, record_timeline=True,
                    **{**kw, "topo": jhw.TOPOLOGIES[tname]})
                assert plain(got) == plain(want)


@pytest.mark.parametrize("fault", sorted(FAULT_KW))
def test_faulted_iteration_equals_reference(fault):
    """tests/test_faults.py's monotonicity cases, on the port and equal to
    the reference: every policy, bare link and topology, with the fault."""
    layers, jlayers = _layers("resnet50", 64)
    f = sim.FaultSpec(**FAULT_KW[fault])
    jf = jsim.FaultSpec(**FAULT_KW[fault])
    for pol, jpol in _policies():
        for topo, jtopo in ((None, None), (hw.CLOUD_10G, jhw.CLOUD_10G)):
            healthy = sim.simulate_iteration(layers, 64, hw.ETH_10G, pol,
                                             topo=topo)
            got = sim.simulate_iteration(layers, 64, hw.ETH_10G, pol,
                                         topo=topo, fault=f,
                                         record_timeline=True)
            want = jsim.simulate_iteration(jlayers, 64, jhw.ETH_10G, jpol,
                                           topo=jtopo, fault=jf,
                                           record_timeline=True)
            assert plain(got) == plain(want)
            assert got.total_time >= healthy.total_time - 1e-9
            assert got.exposed_comm >= healthy.exposed_comm - 1e-9
            assert got.compute_time == pytest.approx(healthy.compute_time)


@pytest.mark.parametrize("fault", sorted(FAULT_KW) + ["healthy"])
def test_fault_spec_equals_reference(fault):
    kw = FAULT_KW.get(fault, {})
    f, jf = sim.FaultSpec(**kw), jsim.FaultSpec(**kw)
    assert plain(f) == plain(jf)
    assert f.worst_inter_bw_factor == jf.worst_inter_bw_factor
    assert f.compute_slowdown == jf.compute_slowdown
    assert plain(f.apply_to_link(hw.ETH_10G)) == \
        plain(jf.apply_to_link(jhw.ETH_10G))
    for name in sorted(jhw.TOPOLOGIES):
        got = f.apply_to_topology(hw.TOPOLOGIES[name])
        want = jf.apply_to_topology(jhw.TOPOLOGIES[name])
        assert plain(got) == plain(want)
        # composing twice composes the factors, as in the reference
        assert plain(f.apply_to_topology(got)) == \
            plain(jf.apply_to_topology(want))
    assert plain(sim.HEALTHY_FAULT) == plain(jsim.HEALTHY_FAULT)


@pytest.mark.parametrize("fault", [None] + sorted(FAULT_KW))
def test_scaling_and_exposed_reduction_equal_reference(fault):
    layers, jlayers = _layers("resnet50", 64)
    f = None if fault is None else sim.FaultSpec(**FAULT_KW[fault])
    jf = None if fault is None else jsim.FaultSpec(**FAULT_KW[fault])
    for p in (1, 2, 16, 128):
        for link in ("ETH_10G", "OMNIPATH"):
            for topo in (None, "CLOUD_10G"):
                kw = dict(overlap_eff=0.7)
                got = sim.scaling_efficiency(
                    layers, p, getattr(hw, link), fault=f,
                    topo=topo and getattr(hw, topo), **kw)
                want = jsim.scaling_efficiency(
                    jlayers, p, getattr(jhw, link), fault=jf,
                    topo=topo and getattr(jhw, topo), **kw)
                assert got == want
                assert 0.0 < got <= 1.0
                got = sim.exposed_comm_reduction(
                    layers, p, getattr(hw, link), fault=f,
                    topo=topo and getattr(hw, topo), **kw)
                want = jsim.exposed_comm_reduction(
                    jlayers, p, getattr(jhw, link), fault=jf,
                    topo=topo and getattr(jhw, topo), **kw)
                assert got == want


@pytest.mark.parametrize("overlap", [False, True])
@pytest.mark.parametrize("n_micro", [1, 2, 4])
def test_bucket_schedule_equals_reference(overlap, n_micro):
    times = [1e-3, 2e-3, 5e-4, 3e-3]
    for micro in (5e-3, 1e-4):
        for rec in (False, True):
            got = sim.simulate_bucket_schedule(times, n_micro, micro,
                                               overlap=overlap,
                                               record_timeline=rec)
            want = jsim.simulate_bucket_schedule(times, n_micro, micro,
                                                 overlap=overlap,
                                                 record_timeline=rec)
            assert plain(got) == plain(want)
            assert bool(got.timeline) == rec


def test_bucket_service_times_equal_reference():
    nbytes = (25e6, 25e6, 12e6, 4e6, 1e6, 0.25e6, 1e3)
    for name in sorted(jhw.TOPOLOGIES):
        for algos in (("flat",) * 7, ("hier",) * 7,
                      ("flat", "hier") * 3 + ("flat",)):
            for nodes in (1, 2, 16):
                for wire, ef, fused in (("fp32", False, True),
                                        ("int8", True, True),
                                        ("int8", False, False)):
                    kw = dict(wire=wire, ef=ef, fused_quant=fused)
                    assert sim.bucket_service_times(
                        nbytes, algos, nodes, hw.TOPOLOGIES[name], **kw) == \
                        jsim.bucket_service_times(
                            nbytes, algos, nodes, jhw.TOPOLOGIES[name], **kw)


def _port_spec(spec):
    """A reference EpisodeSpec as the port's (its fault as the port's)."""
    kw = {f.name: getattr(spec, f.name) for f in dataclasses.fields(spec)}
    kw["fault"] = sim.FaultSpec(**dataclasses.asdict(spec.fault))
    return sim.EpisodeSpec(**kw)


@pytest.mark.parametrize("case", range(9))
def test_generate_episode_equals_reference(case):
    """The 9 labeled episodes of benchmarks/bench_detect.py: the port's
    generator gives the reference's telemetry records exactly, under the
    algos its own planner routes."""
    jspec, mode = bench_detect._episodes(smoke=False)[case]
    spec = _port_spec(jspec)
    assert spec.true_factor == jspec.true_factor
    topo = hw.TOPOLOGIES[spec.topo_name]
    algos = (tuple("hier" for _ in bench_detect.BUCKET_BYTES)
             if mode == "hier" else tuple(
                 planner.choose_allreduce_algo(b, spec.nodes, topo)
                 for b in bench_detect.BUCKET_BYTES))
    assert algos == bench_detect._algos(jspec, mode)
    got = sim.generate_episode(spec, bench_detect.BUCKET_BYTES, algos)
    want = jsim.generate_episode(jspec, bench_detect.BUCKET_BYTES, algos)
    assert got == want
    for wire, ef in (("int8", True), ("bf16", False)):
        assert sim.generate_episode(spec, bench_detect.BUCKET_BYTES, algos,
                                    wire=wire, ef=ef) == \
            jsim.generate_episode(jspec, bench_detect.BUCKET_BYTES, algos,
                                  wire=wire, ef=ef)


def test_jitter_stream_equals_reference():
    for seed in (0, 1, 9, 2 ** 40):
        a, b = sim._DetJitter(seed), jsim._DetJitter(seed)
        assert [a.factor(0.02) for _ in range(50)] == \
            [b.factor(0.02) for _ in range(50)]


# ---------------------------------------------------------------------------
# the planner paths on the simulator
# ---------------------------------------------------------------------------

def _plans():
    """(port, reference) bucket plans of one gradient tree, one leaf per
    bucket, spanning 1e3..6.4e7 bytes."""
    sizes = [256, 65536, int(4e6), int(16e6)]
    tree = {f"l{i}": n for i, n in enumerate(sizes)}
    tplan = scheduler.plan_buckets(
        {k: torch.empty((n,), device="meta") for k, n in tree.items()},
        bucket_bytes=1.0)
    jplan = jsched.plan_buckets(
        {k: jax.ShapeDtypeStruct((n,), jnp.float32) for k, n in tree.items()},
        bucket_bytes=1.0)
    assert [b.n_elems for b in tplan.buckets] == \
        [b.n_elems for b in jplan.buckets]
    return tplan, jplan


@pytest.mark.parametrize("name", sorted(jhw.TOPOLOGIES))
def test_estimate_overlap_equals_reference(name):
    tplan, jplan = _plans()
    for algos in (("flat",) * 4, ("hier",) * 4, ("flat", "hier") * 2):
        for nodes in (1, 4, 16):
            for n_micro, micro in ((1, 1e-2), (4, 1e-3), (8, 5e-2)):
                got = planner.estimate_overlap(
                    tplan.buckets, algos, nodes, hw.TOPOLOGIES[name],
                    n_micro, micro)
                want = jplanner.estimate_overlap(
                    jplan.buckets, algos, nodes, jhw.TOPOLOGIES[name],
                    n_micro, micro)
                assert plain(got) == plain(want)
                off, on = got
                assert on.total_time <= off.total_time + 1e-12


@pytest.mark.parametrize("fault", sorted(FAULT_KW) + ["healthy"])
def test_routing_under_fault_equals_reference(fault):
    """choose_allreduce_algo and route_buckets with fault= give the
    reference's routes on every topology, and the chosen route is never
    dominated on the degraded topology (tests/test_faults.py)."""
    kw = FAULT_KW.get(fault, {})
    f, jf = sim.FaultSpec(**kw), jsim.FaultSpec(**kw)
    tplan, jplan = _plans()
    for name in sorted(jhw.TOPOLOGIES):
        topo, jtopo = hw.TOPOLOGIES[name], jhw.TOPOLOGIES[name]
        for nodes in (1, 2, 16):
            for nbytes in (4e3, 1e6, 25e6, 1e8):
                for wire, ef in (("fp32", False), ("int8", True)):
                    got = planner.choose_allreduce_algo(
                        nbytes, nodes, topo, fault=f, wire=wire, ef=ef)
                    assert got == jplanner.choose_allreduce_algo(
                        nbytes, nodes, jtopo, fault=jf, wire=wire, ef=ef)
                deg = f.apply_to_topology(topo)
                algo = planner.choose_allreduce_algo(nbytes, 16, topo,
                                                     fault=f)
                t_flat = hw.flat_allreduce_time(nbytes, 16, deg)
                t_hier = hw.hier_allreduce_time(nbytes, 16, deg)
                chosen = t_flat if algo == planner.ALGO_FLAT else t_hier
                assert chosen <= min(t_flat, t_hier) + 1e-12
            assert scheduler.route_buckets(tplan, topo, nodes, fault=f) == \
                jsched.route_buckets(jplan, jtopo, nodes, fault=jf)
    if fault == "healthy":
        assert planner.choose_allreduce_algo(25e6, 16, hw.CLOUD_VIRT,
                                             fault=f) == \
            planner.choose_allreduce_algo(25e6, 16, hw.CLOUD_VIRT)


def test_degraded_inter_flips_bulk_buckets_to_hier():
    """tests/test_faults.py's routing flip, on the port: cloud-virtio
    routes bulk flat healthy and two-level on a degraded fabric."""
    fault = sim.FaultSpec(inter_bw_factor=0.4)
    for mb in (16.0, 25.0, 64.0):
        assert planner.choose_allreduce_algo(
            mb * 1e6, 16, hw.CLOUD_VIRT) == planner.ALGO_FLAT
        assert planner.choose_allreduce_algo(
            mb * 1e6, 16, hw.CLOUD_VIRT, fault=fault) == planner.ALGO_HIER
    tplan, _ = _plans()
    assert scheduler.route_buckets(tplan, hw.CLOUD_VIRT, 16) != \
        scheduler.route_buckets(tplan, hw.CLOUD_VIRT, 16, fault=fault)
    assert np.isfinite(sim.scaling_efficiency(
        _layers()[0], 64, hw.ETH_10G, fault=fault))
