"""The port's two-level collectives on 8 gloo ranks against the reference on
mesh8, and the cost-model half (hw, routing, wire bytes) against the
reference's, exactly.

One group of 8 ranks, ("node"=2, "local"=4), is spawned once for the file
(tests/torch_hier_ranks.py, torch only); rank r sits at (r // 4, r % 4), the
device order of mesh8, and takes row r of the inputs.

Tolerances:
  * fp32 legs: within 1 ulp of the port's own per-axis reduction (all-reduce
    over local, then over node); against the reference rtol 1e-6, atol 1e-8
    (the reference's own bound against the flat psum, 8-way fp32 sums of
    1e-3 values in another order).
  * lossy legs: the reference's wire tolerances against the exact sum
    (tests/test_hierarchical.py: 3e-2 for bf16 intra legs, 2e-2 with an
    int8 fabric).
  * against the reference's int8 results: gloo rounds every partial sum of
    a bf16 reduce-scatter where XLA may round once, so the fabric shard may
    differ by the roundings both sides can make (RS_ROUNDINGS of 2^-8 of
    the operands' absolute sum); given the shard the port's wire delivered,
    the codes, scales and residual are the reference quantizer's bit for
    bit, and outputs and residuals move by at most what the shard
    difference allows (two code steps and the amax element's scale
    difference: the 1-LSB policy widened by the wire's rounding). Under jit
    XLA may divide the amax by 127 through a reciprocal, so a reference
    scale may also sit one ulp off (the same policy).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax
from jax.sharding import PartitionSpec as P

from repro import compat
from repro.core import collectives as jcl
from repro.core import hier as jhier
from repro.core import hw as jhw
from repro.core import planner as jplanner
from repro.core import scheduler as jsched
from repro.kernels import ops as jops
from repro_torch import tree as tree_lib
from repro_torch.core import collectives as cl
from repro_torch.core import hier, hw, planner, scheduler

import torch_hier_ranks as ranks
import torch_spawn

WORLD, NODE, LOCAL = 8, 2, 4
N = 4097
AXES = ("node", "local")
DSPEC = P(AXES)
U = 2.0 ** -8                   # bf16 unit roundoff
# bf16 roundings a fabric shard may take on either side: the local
# reduce-scatter (3 partial sums on gloo) and the node one (1), on each side
RS_ROUNDINGS = 2 * (LOCAL - 1 + NODE - 1)
SHARD = hier.ef_residual_shape(N, LOCAL, NODE)[0]


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    rng = np.random.default_rng(2024)
    data = {"x": (rng.standard_normal((WORLD, N)) * 1e-3).astype(np.float32),
            "res": (rng.standard_normal((WORLD, SHARD)) * 1e-5
                    ).astype(np.float32),
            "acc": rng.standard_normal(N).astype(np.float32)}
    path = tmp_path_factory.mktemp("hier") / "inputs.npz"
    np.savez(path, **data)
    return path, data


@pytest.fixture(scope="module")
def port(inputs, tmp_path_factory):
    """Per-rank results of the port's collectives on 8 gloo ranks."""
    path, _ = inputs
    out_dir = tmp_path_factory.mktemp("hier_ranks")
    torch_spawn.spawn("torch_hier_ranks.py", WORLD,
                      tmp_path_factory.mktemp("store"), path, out_dir)
    return [dict(np.load(out_dir / f"rank{r}.npz")) for r in range(WORLD)]


def _run8(mesh8, fn, args, in_specs, out_specs):
    return jax.jit(compat.shard_map(fn, mesh=mesh8, in_specs=in_specs,
                                    out_specs=out_specs, axis_names=set(AXES),
                                    check_vma=False))(*args)


@pytest.fixture(scope="module")
def ref(inputs, mesh8):
    """The reference's results on mesh8 on the same inputs."""
    _, d = inputs
    x = jnp.asarray(d["x"])
    res = jnp.asarray(d["res"].reshape(-1))
    acc = jnp.asarray(d["acc"])
    ef = jhier.HierSpec(wire_intra="bf16", wire_inter="int8",
                        error_feedback=True, backend="jnp")
    out = {"psum": _run8(mesh8, lambda u: lax.psum(u[0], AXES), (x,),
                         (DSPEC,), P())}
    out["fp32"] = _run8(mesh8, lambda u: jhier.hier_allreduce(u[0]), (x,),
                        (DSPEC,), P())
    out["fp32_mean_acc"] = _run8(
        mesh8, lambda u, a: jhier.hier_allreduce(u[0], mean=True, acc=a),
        (x, acc), (DSPEC, P()), P())
    for name, spec in ranks.LOSSY.items():
        jspec = jhier.HierSpec(wire_intra=spec.wire_intra,
                               wire_inter=spec.wire_inter, backend="jnp")
        out[name] = _run8(mesh8, lambda u, s=jspec: jhier.hier_allreduce(
            u[0], s), (x,), (DSPEC,), P())

    def fabric(u, r):
        flat = jcl._pad_flat(u[0].astype(jnp.bfloat16),
                             jhier._pad_quantum(LOCAL, NODE, "int8"))
        y = lax.psum_scatter(flat, "local", scatter_dimension=0, tiled=True)
        y = lax.psum_scatter(y, "node", scatter_dimension=0, tiled=True)
        q, s, _, r2 = jops.quantize_ef(y, r, block=jcl.QUANT_BLOCK,
                                       backend="jnp")
        return y.astype(jnp.float32), q, s, r2

    out["fabric_shard"], out["q"], out["s"], out["res_of_shard"] = _run8(
        mesh8, fabric, (x, res), (DSPEC, DSPEC), (DSPEC,) * 4)
    out["ef"], out["ef_res"] = _run8(
        mesh8, lambda u, r: jhier.hier_allreduce_ef(u[0], r, ef, mean=True),
        (x, res), (DSPEC, DSPEC), (P(), DSPEC))
    out["ef_acc"], out["ef_acc_res"] = _run8(
        mesh8, lambda u, r, a: jhier.hier_allreduce_ef(u[0], r, ef,
                                                       mean=True, acc=a),
        (x, res, acc), (DSPEC, DSPEC, P()), (P(), DSPEC))
    out["all_to_all"] = _run8(
        mesh8, lambda u: jcl.all_to_all(u[0, :64].reshape(8, 8), "local",
                                        split_axis=0, concat_axis=1),
        (x,), (DSPEC,), DSPEC)
    out["broadcast"] = _run8(
        mesh8, lambda u: jcl.broadcast(u[0, :16], AXES, root=5), (x,),
        (DSPEC,), DSPEC)
    return {k: np.asarray(v, np.float32) for k, v in out.items()}


def _per_rank(port, key):
    return np.concatenate([r[key].reshape(-1) for r in port])


def _abs_sum(inputs):
    """Elementwise sum over the ranks of |bf16(x_r)|, padded to the int8
    quantum and laid out as the fabric shards are (rank r's shard is the
    node-th sub-chunk of the local-th intra chunk)."""
    _, d = inputs
    x = np.abs(np.asarray(jnp.asarray(d["x"]).astype(jnp.bfloat16),
                          np.float32)).sum(0)
    padded = np.pad(x, (0, SHARD * WORLD - N))
    return np.concatenate([padded[(r % LOCAL) * SHARD * NODE
                                  + (r // LOCAL) * SHARD:][:SHARD]
                           for r in range(WORLD)])


def _shard_bound(inputs):
    return RS_ROUNDINGS * U * _abs_sum(inputs) * 1.01


def _scale_bound(ref, inputs):
    """Per block: the amax element's shard difference over 127, plus one
    ulp of the reference's scale."""
    return (_shard_bound(inputs).reshape(-1, jcl.QUANT_BLOCK).max(1) / 127
            + np.spacing(ref["s"]))


def _step_bound(ref, inputs):
    """|dq| s + |q| |ds| per element for codes moved by the shard
    difference: two steps, and a scale moved by `_scale_bound`."""
    s = np.repeat(ref["s"], jcl.QUANT_BLOCK)
    ds = np.repeat(_scale_bound(ref, inputs), jcl.QUANT_BLOCK)
    return 2 * s + 127 * ds


def _unshard(v):
    """Fabric-shard layout (rank order) -> message order, first N."""
    parts = v.reshape(WORLD, SHARD)
    full = np.empty(WORLD * SHARD, v.dtype)
    for r in range(WORLD):
        off = (r % LOCAL) * SHARD * NODE + (r // LOCAL) * SHARD
        full[off:off + SHARD] = parts[r]
    return full[:N]


# --------------------------------------------------------------------------
# multi-rank results
# --------------------------------------------------------------------------

def test_mesh_coordinates_follow_mesh8(port):
    for r, out in enumerate(port):
        assert tuple(out["coord"]) == (r // LOCAL, r % LOCAL)


def test_ranks_agree_on_replicated_results(port):
    for key in ("fp32", "fp32_mean", *ranks.LOSSY, "ef", "ef_acc",
                "comm_fp32", "comm_int8", "broadcast"):
        for r in port[1:]:
            np.testing.assert_array_equal(r[key], port[0][key], err_msg=key)


def test_hier_fp32_within_one_ulp_of_per_axis_reduction(port):
    for r in port:
        want = r["per_axis"]
        assert (np.abs(r["fp32"] - want) <= np.spacing(np.abs(want))).all()


@pytest.mark.parametrize("key", ["fp32", "fp32_mean_acc"])
def test_hier_fp32_matches_reference(port, ref, key):
    np.testing.assert_allclose(port[0][key], ref[key], rtol=1e-6, atol=1e-8)


def test_hier_mean_divides_by_total_ranks(port, ref):
    np.testing.assert_allclose(port[0]["fp32_mean"], ref["psum"] / 8.0,
                               rtol=1e-6, atol=1e-9)


@pytest.mark.parametrize("name,tol", [("bf16_fp32", 3e-2), ("bf16_bf16", 3e-2),
                                      ("bf16_int8", 2e-2),
                                      ("fp32_int8", 2e-2)])
def test_hier_lossy_legs_within_wire_tolerance(port, ref, name, tol):
    err = np.abs(port[0][name] - ref["psum"]).max() / np.abs(ref["psum"]).max()
    assert err < tol, (name, err)
    # and the reference's own result on the same legs is held to the same
    ref_err = np.abs(ref[name] - ref["psum"]).max() / np.abs(ref["psum"]).max()
    assert ref_err < tol


def test_fabric_shard_matches_reference(port, ref, inputs):
    diff = np.abs(_per_rank(port, "fabric_shard") - ref["fabric_shard"])
    assert (diff <= _shard_bound(inputs)).all()


def test_ef_quantize_of_port_shard_bitwise_vs_reference(port, inputs):
    """Given the fabric shard the port's wire delivered and the rank's
    residual, the codes, scales and new residual are the reference
    quantizer's bit for bit, and the residual hier_allreduce_ef returns is
    that one."""
    _, d = inputs
    for rank, r in enumerate(port):
        y = jnp.asarray(r["fabric_shard"]).astype(jnp.bfloat16)
        q, s, _, res = jops.quantize_ef(y, jnp.asarray(d["res"][rank]),
                                        block=jcl.QUANT_BLOCK, backend="jnp")
        np.testing.assert_array_equal(np.asarray(q), r["q"])
        np.testing.assert_array_equal(np.asarray(s), r["s"])
        np.testing.assert_array_equal(np.asarray(res), r["res_of_shard"])
        np.testing.assert_array_equal(r["ef_res"], r["res_of_shard"])
        np.testing.assert_array_equal(r["ef_acc_res"], r["res_of_shard"])


def test_ef_codes_and_scales_match_reference(port, ref, inputs):
    ds = _scale_bound(ref, inputs)
    assert (np.abs(_per_rank(port, "s") - ref["s"]) <= ds).all()
    qdiff = np.abs(_per_rank(port, "q").astype(np.int32)
                   - ref["q"].reshape(-1).astype(np.int32))
    assert qdiff.max() <= 2, qdiff.max()


@pytest.mark.parametrize("tag", ["ef", "ef_acc"])
def test_ef_residual_shards_match_reference(port, ref, inputs, tag):
    """Rank r's residual is the r-th shard of the reference's global view
    (the node-th fabric sub-chunk of the local-th intra chunk), within
    |dr| <= |dy| + |dq| s + |q| |ds|."""
    got = _per_rank(port, f"{tag}_res")
    want = ref[f"{tag}_res"]
    assert got.shape == want.shape == (WORLD * SHARD,)
    bound = _shard_bound(inputs) + _step_bound(ref, inputs) + 1e-9
    assert (np.abs(got - want) <= bound).all()


@pytest.mark.parametrize("tag", ["ef", "ef_acc"])
def test_ef_output_matches_reference(port, ref, inputs, tag):
    """The gathered message moves by the code steps, then both sides round
    the dequantized shard to the bf16 intra wire (two roundings); mean over
    8 ranks."""
    want = ref[tag]
    deq = np.abs(_unshard(ref["s"].repeat(jcl.QUANT_BLOCK)
                          * ref["q"].reshape(-1)))
    step = _unshard(_step_bound(ref, inputs))
    bound = (step + 2 * U * (deq + step)) / WORLD * 1.01 + 1e-9
    assert (np.abs(port[0][tag] - want) <= bound).all()


def test_comm_facade(port, ref):
    sizes = port[0]["comm_sizes"]
    assert list(sizes) == [1, 0, NODE, LOCAL, WORLD, 1, 42]
    np.testing.assert_allclose(port[0]["comm_fp32"], ref["psum"], rtol=1e-6,
                               atol=1e-8)
    err = (np.abs(port[0]["comm_int8"] - ref["psum"]).max()
           / np.abs(ref["psum"]).max())
    assert err < 2e-2, err
    # without node/local axes the facade stays flat (the reference's order:
    # over node, then local)
    np.testing.assert_allclose(port[0]["comm_flat_fp32"], ref["psum"] / 8,
                               rtol=1e-6, atol=1e-9)


@pytest.mark.parametrize("key", ["all_to_all", "broadcast"])
def test_all_to_all_and_broadcast_match_reference(port, ref, key):
    np.testing.assert_array_equal(_per_rank(port, key), ref[key].reshape(-1))


# --------------------------------------------------------------------------
# the framework-free half: exact against the reference
# --------------------------------------------------------------------------

def test_hier_spec_validation():
    with pytest.raises(ValueError):
        hier.HierSpec(wire_intra="int8")           # lossy wire can't reduce
    with pytest.raises(ValueError):
        hier.HierSpec(error_feedback=True)         # EF needs int8 fabric
    with pytest.raises(ValueError):
        hier.HierSpec(wire_inter="fp8")            # unknown wire
    with pytest.raises(ValueError):
        hier.HierSpec(backend="pallas")            # no such backend here
    for wire in cl.WIRES:
        assert hier.default_wire_intra(wire) == jhier.default_wire_intra(wire)
    for local, node in ((4, 2), (1, 1), (8, 3)):
        for wire in cl.WIRES:
            assert hier._pad_quantum(local, node, wire) == \
                jhier._pad_quantum(local, node, wire)


@pytest.mark.parametrize("n", [1, 4097, 70000, 262_144_000])
def test_ef_residual_shape_matches_reference(n):
    for local, node in ((4, 2), (1, 1), (8, 3)):
        assert hier.ef_residual_shape(n, local, node) == \
            jhier.ef_residual_shape(n, local, node)


def test_wire_bytes_match_reference():
    for wi in hier.INTRA_WIRES:
        for we in cl.WIRES:
            spec = hier.HierSpec(wire_intra=wi, wire_inter=we)
            jspec = jhier.HierSpec(wire_intra=wi, wire_inter=we)
            for local, node in ((4, 2), (1, 2), (4, 1), (256, 16)):
                got = hier.hier_wire_bytes_per_elem(spec, local, node)
                want = jhier.hier_wire_bytes_per_elem(jspec, local, node)
                assert (got.intra, got.inter, got.total) == \
                    (want.intra, want.inter, want.total)
        for we in cl.WIRES:
            got = hier.flat_wire_bytes_per_elem(we)
            want = jhier.flat_wire_bytes_per_elem(we)
            assert (got.intra, got.inter, got.total) == \
                (want.intra, want.inter, want.total)


SIZES = [0, 1, 4e3, 1.31e5, 1e6, 2.5e7, 1.05e9]


@pytest.mark.parametrize("name", sorted(jhw.TOPOLOGIES))
def test_hw_cost_model_equals_reference(name):
    t, jt = hw.TOPOLOGIES[name], jhw.TOPOLOGIES[name]
    assert dataclasses_equal(t, jt)
    deg = dict(intra_bw=0.5, inter_latency=3.0, straggler=1.5)
    assert dataclasses_equal(t.degrade(**deg), jt.degrade(**deg))
    for topo, jtopo in ((t, jt), (t.degrade(**deg), jt.degrade(**deg))):
        for nb in SIZES:
            for nodes in (1, 2, 16):
                for wire in ("fp32", "int8"):
                    for ef in (False, True):
                        for fused in (False, True):
                            kw = dict(ef=ef, fused_quant=fused)
                            assert hw.hier_allreduce_time(
                                nb, nodes, topo, wire_inter=wire, **kw) == \
                                jhw.hier_allreduce_time(
                                    nb, nodes, jtopo, wire_inter=wire, **kw)
                            assert hw.flat_allreduce_time(
                                nb, nodes, topo, wire=wire, **kw) == \
                                jhw.flat_allreduce_time(
                                    nb, nodes, jtopo, wire=wire, **kw)
                            assert hw.quant_overhead_time(
                                nb, topo, ef=ef, fused=fused) == \
                                jhw.quant_overhead_time(nb, jtopo, ef=ef,
                                                        fused=fused)
            p = topo.flat_size(4)
            for fn in ("ring_allreduce_time", "reduce_scatter_time",
                       "all_gather_time", "all_to_all_time",
                       "latency_bound_fraction"):
                for link in (topo.intra, topo.effective_inter):
                    assert getattr(hw, fn)(nb, p, link) == \
                        getattr(jhw, fn)(nb, p, link)
    for p in (1, 2, 7, 512):
        assert hw.tree_depth(p) == jhw.tree_depth(p)
    assert hw._QUANT_BYTES == jhw._QUANT_BYTES
    for n in SIZES:
        for ef in (False, True):
            for fused in (False, True):
                assert hw.quant_hbm_bytes(n, ef=ef, fused=fused) == \
                    jhw.quant_hbm_bytes(n, ef=ef, fused=fused)


def dataclasses_equal(a, b) -> bool:
    """Field-by-field equality of the port's and the reference's frozen
    dataclasses (different classes, the same values)."""
    if not dataclasses.is_dataclass(a):
        return a == b
    return [f.name for f in dataclasses.fields(a)] == \
        [f.name for f in dataclasses.fields(b)] and all(
            dataclasses_equal(getattr(a, f.name), getattr(b, f.name))
            for f in dataclasses.fields(a))


def _bucket_plans():
    """Gradient trees whose buckets span the latency- and bandwidth-bound
    regimes (a few elements to 6.7e7)."""
    trees = [{"first": (4,), "bulk": (64, 1024, 256)},
             {"embed": (4096, 512), "layers": {f"l{i}": (1 << (4 + 2 * i),)
                                               for i in range(10)},
              "head": (512, 4096)}]
    for tree in trees:
        for bucket_bytes in (1 << 16, 25e6):
            tplan = scheduler.plan_buckets(tree_lib.tree_map(torch_meta, tree),
                                           bucket_bytes=bucket_bytes)
            jplan = jsched.plan_buckets(
                jax.tree_util.tree_map(lambda s: jax.ShapeDtypeStruct(
                    s, jnp.float32), tree, is_leaf=lambda x: isinstance(
                        x, tuple)), bucket_bytes=bucket_bytes)
            assert [b.n_elems for b in tplan.buckets] == \
                [b.n_elems for b in jplan.buckets]
            yield tplan, jplan


def torch_meta(shape):
    return torch.empty(shape, dtype=torch.float32, device="meta")


@pytest.mark.parametrize("name", sorted(jhw.TOPOLOGIES))
def test_routes_match_reference(name):
    topo, jtopo = hw.TOPOLOGIES[name], jhw.TOPOLOGIES[name]
    routes = set()
    for tplan, jplan in _bucket_plans():
        for nodes in (1, 2, 16):
            for wire, ef in (("fp32", False), ("int8", False),
                             ("int8", True)):
                for fused in (False, True):
                    kw = dict(wire=wire, ef=ef, fused_quant=fused)
                    got = scheduler.route_buckets(tplan, topo, nodes, **kw)
                    assert got == jsched.route_buckets(jplan, jtopo, nodes,
                                                       **kw)
                    routes.update(got)
                    for b in tplan.buckets:
                        assert planner.choose_allreduce_algo(
                            b.n_elems * 4.0, nodes, topo, **kw) == \
                            jplanner.choose_allreduce_algo(
                                b.n_elems * 4.0, nodes, jtopo, **kw)
                    algos = tuple(planner.ALGO_HIER if i % 2 else
                                  planner.ALGO_FLAT
                                  for i in range(len(tplan.buckets)))
                    assert planner.bucket_allreduce_times(
                        tplan.buckets, algos, nodes, topo, **kw) == \
                        jplanner.bucket_allreduce_times(
                            jplan.buckets, algos, nodes, jtopo, **kw)
    # at one node every message routes flat
    assert planner.ALGO_FLAT in routes


def test_routing_takes_both_routes_somewhere():
    """Across the topologies the cost model sends some buckets each way
    (a check that the route comparison above is not vacuous)."""
    seen = set()
    for name in jhw.TOPOLOGIES:
        for tplan, _ in _bucket_plans():
            seen.update(scheduler.route_buckets(tplan, hw.TOPOLOGIES[name],
                                                16))
    assert seen == {planner.ALGO_FLAT, planner.ALGO_HIER}


def test_fault_raises_not_yet_ported():
    with pytest.raises(NotImplementedError, match="not yet ported"):
        planner.choose_allreduce_algo(1e6, 2, hw.CLOUD_10G, fault=object())
    tplan, _ = next(_bucket_plans())
    with pytest.raises(NotImplementedError, match="not yet ported"):
        scheduler.route_buckets(tplan, hw.CLOUD_10G, 2, fault=object())
