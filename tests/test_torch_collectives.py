"""The port's collectives on 4 gloo ranks against the JAX reference's on a
4-device ("data",) mesh cut from the 8 virtual devices, on the same numpy
inputs.

One group of 4 ranks is spawned per file (tests/torch_collective_ranks.py,
torch only) and runs every collective once; the tests read its results.

Tolerances: fp32 sums are taken in another order on gloo than on XLA
(allclose). On the bf16 wire XLA sums the operands in f32 and rounds once,
while gloo, like NCCL's ring, rounds every partial sum to bf16; the tests
bound that difference, hold the port's quantizer bitwise to the reference's
on the shard the port's wire delivered, and bound the codes, scales,
outputs and residuals by what the shard difference allows. Fused and
composed error feedback run the same arithmetic, so the port holds them to
each other bitwise.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import PartitionSpec as P

from repro import compat
from repro.core import collectives as jcl
from repro.kernels import ops as jops

import torch_spawn

WORLD = 4
N = 70000                       # odd size: the int8 legs pad per rank
AX = ("data",)
BF16_ULP = 2.0 ** -7            # relative spacing of bf16


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    rng = np.random.default_rng(1234)
    shard = jcl.ef_residual_shape(N, WORLD)[0]
    data = {"x": rng.standard_normal((WORLD, N)).astype(np.float32),
            "res": (rng.standard_normal((WORLD, shard)) * 0.01
                    ).astype(np.float32),
            "acc": rng.standard_normal(N).astype(np.float32)}
    path = tmp_path_factory.mktemp("coll") / "inputs.npz"
    np.savez(path, **data)
    return path, data


@pytest.fixture(scope="module")
def port(inputs, tmp_path_factory):
    """Per-rank results of the port's collectives on 4 gloo ranks."""
    path, _ = inputs
    out_dir = tmp_path_factory.mktemp("ranks")
    torch_spawn.spawn("torch_collective_ranks.py", WORLD,
                      tmp_path_factory.mktemp("store"), path, out_dir,
                      timeout=60)
    return [dict(np.load(out_dir / f"rank{r}.npz")) for r in range(WORLD)]


@pytest.fixture(scope="module")
def mesh4():
    return compat.make_mesh((WORLD,), AX, devices=jax.devices()[:WORLD])


def _run(mesh4, fn, args, in_specs, out_specs):
    return jax.jit(compat.shard_map(fn, mesh=mesh4, in_specs=in_specs,
                                    out_specs=out_specs, axis_names=set(AX),
                                    check_vma=False))(*args)


@pytest.fixture(scope="module")
def ref(inputs, mesh4):
    """The reference's results on the same inputs (per-rank values gathered
    along the data axis where they differ per rank)."""
    _, d = inputs
    x = jnp.asarray(d["x"].reshape(-1))
    res = jnp.asarray(d["res"].reshape(-1))
    acc = jnp.asarray(d["acc"])
    out = {}
    for wire in jcl.WIRES:
        out[f"{wire}_mean"] = _run(
            mesh4, lambda xs, w=wire: jcl.allreduce(xs, AX, wire=w, mean=True,
                                                    backend="jnp"),
            (x,), (P(AX),), P())
        out[f"{wire}_sum_acc"] = _run(
            mesh4, lambda xs, a, w=wire: jcl.allreduce(xs, AX, wire=w, acc=a,
                                                       backend="jnp"),
            (x, acc), (P(AX), P()), P())

    def shard_q(xs):
        flat = jcl._pad_flat(xs.astype(jnp.bfloat16), WORLD * 512 * 8)
        shard = jax.lax.psum_scatter(flat, "data", scatter_dimension=0,
                                     tiled=True)
        q, s, _ = jops.quantize(shard, block=jcl.QUANT_BLOCK, backend="jnp")
        return shard.astype(jnp.float32), q, s

    out["shard"], out["q"], out["s"] = _run(mesh4, shard_q, (x,), (P(AX),),
                                            (P(AX), P(AX), P(AX)))
    out["ef"], out["ef_res"] = _run(
        mesh4, lambda xs, rs: jcl.allreduce_ef(xs, rs, AX, mean=True,
                                               backend="jnp"),
        (x, res), (P(AX), P(AX)), (P(), P(AX)))
    out["ef_acc"], out["ef_acc_res"] = _run(
        mesh4, lambda xs, rs, a: jcl.allreduce_ef(xs, rs, AX, mean=True,
                                                  backend="jnp", acc=a),
        (x, res, acc), (P(AX), P(AX), P()), (P(), P(AX)))
    out["reduce_scatter"] = _run(mesh4, lambda xs: jcl.reduce_scatter(xs, AX),
                                 (x,), (P(AX),), P(AX))
    out["all_gather"] = _run(
        mesh4, lambda xs: jcl.all_gather(xs[:64], AX), (x,), (P(AX),), P())
    return {k: np.asarray(v, np.float32) if v.dtype == jnp.bfloat16
            else np.asarray(v) for k, v in out.items()}


def _per_rank(port, key):
    return np.concatenate([r[key] for r in port])


def test_ranks_agree_on_replicated_results(port):
    for key in ("fp32_mean", "bf16_mean", "int8_mean", "int8_sum_acc",
                "ef_fused", "ef_acc_fused", "all_gather"):
        for r in port[1:]:
            np.testing.assert_array_equal(r[key], port[0][key], err_msg=key)


@pytest.mark.parametrize("key", ["fp32_mean", "fp32_sum_acc",
                                 "reduce_scatter", "all_gather"])
def test_fp32_collectives_match_reference(port, ref, key):
    got = _per_rank(port, key) if key == "reduce_scatter" else port[0][key]
    np.testing.assert_allclose(got, ref[key], rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("key", ["bf16_mean", "bf16_sum_acc"])
def test_bf16_wire_matches_reference(port, ref, key):
    # four bf16 partial sums, each rounded: a few bf16 ulps of the operands
    atol = 4 * BF16_ULP * np.abs(ref["shard"]).max()
    np.testing.assert_allclose(port[0][key], ref[key], rtol=0, atol=atol)


def _rs_bound(inputs):
    """Per-element bound on the port's bf16 reduce-scatter against the
    reference's: XLA sums the four bf16 operands in f32 and rounds once,
    gloo (like NCCL's ring) rounds every partial sum to bf16, so the two
    differ by at most (WORLD - 1) roundings of a partial sum plus the
    reference's own half ulp."""
    _, d = inputs
    x = np.abs(d["x"]).astype(np.float32)
    x = np.pad(x, ((0, 0), (0, (-N) % (WORLD * jcl.QUANT_BLOCK * 8))))
    return (WORLD - 1) * 2.0 ** -8 * x.sum(0) + 2.0 ** -9 * x.sum(0)


def _step_bound(ref, inputs):
    """|dq| * s + |q| * |ds| for codes moved by the shard difference: at most
    two steps, and a scale moved by the amax element's difference."""
    s = np.repeat(ref["s"], jcl.QUANT_BLOCK)
    ds = np.repeat(np.abs(_rs_bound(inputs)).reshape(-1, jcl.QUANT_BLOCK)
                   .max(1), jcl.QUANT_BLOCK) / 127
    return 2 * s + 127 * ds


def test_int8_reduce_scatter_leg_matches_reference(port, ref, inputs):
    got = _per_rank(port, "shard")
    assert (np.abs(got - ref["shard"]) <= _rs_bound(inputs)).all()


def test_int8_quantize_of_port_shard_bitwise_vs_reference(port):
    """Given the shard the port's wire delivered, each rank's codes and
    scales are the reference quantizer's bit for bit."""
    for r in port:
        q, s, _ = jops.quantize(jnp.asarray(r["shard"]).astype(jnp.bfloat16),
                                block=jcl.QUANT_BLOCK, backend="jnp")
        np.testing.assert_array_equal(np.asarray(q), r["q"])
        np.testing.assert_array_equal(np.asarray(s), r["s"])


def test_int8_codes_and_scales_match_reference(port, ref, inputs):
    """Codes within the steps the shard difference allows (the 1-LSB
    rounding-tie policy, widened by the wire's rounding), scales within the
    amax element's difference."""
    ds = np.abs(_rs_bound(inputs)).reshape(-1, jcl.QUANT_BLOCK).max(1) / 127
    assert (np.abs(_per_rank(port, "s") - ref["s"]) <= ds).all()
    qdiff = np.abs(_per_rank(port, "q").astype(np.int32)
                   - ref["q"].astype(np.int32))
    assert qdiff.max() <= 2, qdiff.max()
    assert (qdiff > 1).mean() < 1e-3


@pytest.mark.parametrize("key,mean", [("int8_mean", True),
                                      ("int8_sum_acc", False),
                                      ("ef_fused", True),
                                      ("ef_acc_fused", True)])
def test_int8_allreduce_matches_reference(port, ref, inputs, key, mean):
    bound = _step_bound(ref, inputs)[:N] / (WORLD if mean else 1) + 1e-6
    diff = np.abs(port[0][key] - ref[key.replace("_fused", "")])
    assert (diff <= bound).all(), (diff / bound).max()


@pytest.mark.parametrize("tag", ["ef", "ef_acc"])
def test_ef_residual_shards_match_reference(port, ref, inputs, tag):
    """Each rank's residual shard is the JAX rank's shard within the
    policy: |dr| <= |dy| + |dq| * s + |q| * |ds| (y = shard + residual)."""
    got = _per_rank(port, f"{tag}_res_fused")
    want = ref[f"{tag}_res"]
    assert got.shape == want.shape == (
        WORLD * jcl.ef_residual_shape(N, WORLD)[0],)
    bound = _rs_bound(inputs) + _step_bound(ref, inputs) + 1e-6
    assert (np.abs(got - want) <= bound).all()


@pytest.mark.parametrize("tag", ["ef", "ef_acc"])
def test_fused_equals_composed_bitwise(port, tag):
    for r in port:
        np.testing.assert_array_equal(r[f"{tag}_fused"], r[f"{tag}_composed"])
        np.testing.assert_array_equal(r[f"{tag}_res_fused"],
                                      r[f"{tag}_res_composed"])


def test_residual_shape_and_wire_bytes_match_reference():
    from repro_torch.core import collectives as cl
    for n, p in ((1, 1), (70000, 4), (262_144_000, 1), (4097, 8)):
        assert cl.ef_residual_shape(n, p) == jcl.ef_residual_shape(n, p)
    for wire in cl.WIRES:
        assert cl.wire_bytes_per_elem(wire) == jcl.wire_bytes_per_elem(wire)
