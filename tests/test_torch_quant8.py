"""The port's quantization kernels' plain versions and shape-polymorphic ops
against the JAX reference, on the CPU.

  * plain versions vs `repro.kernels.ref`: bitwise (q, scales, residual);
  * plain versions vs the Pallas kernels in interpret mode: the reference's
    own 1-LSB policy (interpret-mode XLA may fuse the divide differently);
  * `ops.*` vs `repro.kernels.ops` with backend="jnp": bitwise.

The CUDA kernels themselves are held to these plain versions on the card
(tests/test_torch_cuda.py, chip_smoke.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import quant8 as jq8
from repro.kernels import ref as jref
from repro_torch.kernels import ops, quant8, ref

SHAPES = [(8, 512), (16, 512), (64, 1024)]
DTYPES = ["float32", "bfloat16"]


def _inputs(shape, dtype, seed, *, zero_rows=(), inf_rows=()):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal(shape) * 3).astype(np.float32)
    r = (rng.standard_normal(shape) * 0.01).astype(np.float32)
    for i in zero_rows:
        x[i] = 0.0
        r[i] = 0.0
    for i in inf_rows:
        x[i, 3] = np.inf
    jx = jnp.asarray(x).astype(getattr(jnp, dtype))
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    return jx, tx, jnp.asarray(r), torch.from_numpy(r)


def _np(t):
    return np.asarray(t.to(torch.float32).numpy() if t.dtype == torch.bfloat16
                      else t.numpy())


def _eq(a, b):
    np.testing.assert_array_equal(np.asarray(a), _np(b))


# --------------------------------------------------------------------------
# plain versions vs repro.kernels.ref: bitwise
# --------------------------------------------------------------------------

@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("dtype", DTYPES)
def test_plain_versions_bitwise_vs_reference(shape, dtype):
    jx, tx, jr, tr = _inputs(shape, dtype, seed=shape[0] + len(dtype),
                             zero_rows=(1,))
    jq, js = jref.quantize_blocks(jx)
    tq, ts = ref.quantize_blocks(tx)
    _eq(jq, tq)
    _eq(js, ts)
    assert ts[1] == 0 and not tq[1].any()           # zero row: s = 0, q = 0
    jq2, js2, jn2 = jref.quantize_ef_blocks(jx, jr)
    tq2, ts2, tn2 = ref.quantize_ef_blocks(tx, tr)
    _eq(jq2, tq2)
    _eq(js2, ts2)
    _eq(jn2, tn2)
    assert not tn2[1].any()                         # zero row carries y = 0
    _eq(jref.dequantize_blocks(jq, js), ref.dequantize_blocks(tq, ts))
    acc = np.random.default_rng(1).standard_normal(shape).astype(np.float32)
    _eq(jref.dequantize_accumulate_blocks(jq, js, jnp.asarray(acc)),
        ref.dequantize_accumulate_blocks(tq, ts, torch.from_numpy(acc)))


@pytest.mark.parametrize("dtype", DTYPES)
def test_plain_versions_inf_rows_agree_on_finite_rows(dtype):
    jx, tx, jr, tr = _inputs((16, 512), dtype, seed=5, inf_rows=(0, 9))
    finite = np.ones(16, bool)
    finite[[0, 9]] = False
    jq, js, jn = jref.quantize_ef_blocks(jx, jr)
    tq, ts, tn = ref.quantize_ef_blocks(tx, tr)
    np.testing.assert_array_equal(np.asarray(js), _np(ts))   # inf scales too
    np.testing.assert_array_equal(np.asarray(jq)[finite], _np(tq)[finite])
    np.testing.assert_array_equal(np.asarray(jn)[finite], _np(tn)[finite])
    assert np.isnan(_np(tn)[0]).all() and np.isnan(np.asarray(jn)[0]).all()
    jq1, js1 = jref.quantize_blocks(jx)
    tq1, ts1 = ref.quantize_blocks(tx)
    np.testing.assert_array_equal(np.asarray(jq1)[finite], _np(tq1)[finite])
    np.testing.assert_array_equal(np.asarray(js1), _np(ts1))


def test_plain_quantize_nan_row_gets_nan_scale():
    x = torch.ones(8, 512)
    x[2, 7] = float("nan")
    _, s = ref.quantize_blocks(x)
    assert torch.isnan(s[2]) and torch.isfinite(s[[0, 1, 3]]).all()


# --------------------------------------------------------------------------
# plain versions vs the Pallas kernels (interpret mode): 1-LSB policy
# --------------------------------------------------------------------------

def _assert_lsb_policy(jq, tq, js, ts, jn=None, tn=None):
    qdiff = np.abs(np.asarray(jq, np.int32) - _np(tq).astype(np.int32))
    assert qdiff.max() <= 1, qdiff.max()
    assert (qdiff > 0).mean() < 0.01
    np.testing.assert_allclose(np.asarray(js), _np(ts), rtol=1e-6)
    if jn is not None:
        bound = np.asarray(js)[:, None] * (qdiff + 1e-3) + 1e-7
        assert (np.abs(np.asarray(jn) - _np(tn)) <= bound).all()


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("dtype", DTYPES)
def test_plain_versions_vs_pallas_interpret(shape, dtype):
    jx, tx, jr, tr = _inputs(shape, dtype, seed=11 + shape[0])
    jq, js = jq8.quantize_blocks(jx.astype(jnp.float32), interpret=True)
    tq, ts = ref.quantize_blocks(tx)
    _assert_lsb_policy(jq, tq, js, ts)
    jq2, js2, jn2 = jq8.quantize_ef_blocks(jx, jr, interpret=True)
    tq2, ts2, tn2 = ref.quantize_ef_blocks(tx, tr)
    _assert_lsb_policy(jq2, tq2, js2, ts2, jn2, tn2)
    # dequantize on identical codes
    d = jq8.dequantize_blocks(jnp.asarray(_np(tq).astype(np.int8)),
                              jnp.asarray(_np(ts)), interpret=True)
    np.testing.assert_allclose(np.asarray(d), _np(ref.dequantize_blocks(tq, ts)),
                               rtol=1e-6)
    acc = np.random.default_rng(2).standard_normal(shape).astype(np.float32)
    a = jq8.dequantize_accumulate_blocks(
        jnp.asarray(_np(tq).astype(np.int8)), jnp.asarray(_np(ts)),
        jnp.asarray(acc), interpret=True)
    np.testing.assert_allclose(
        np.asarray(a),
        _np(ref.dequantize_accumulate_blocks(tq, ts, torch.from_numpy(acc))),
        rtol=1e-4, atol=1e-5)


# --------------------------------------------------------------------------
# shape-polymorphic ops vs repro.kernels.ops (backend="jnp"): bitwise
# --------------------------------------------------------------------------

@pytest.mark.parametrize("n", [1, 511, 4097, 70000])
@pytest.mark.parametrize("dtype", DTYPES)
def test_ops_bitwise_vs_reference(n, dtype):
    rng = np.random.default_rng(n)
    x = (rng.standard_normal(n) * 0.5).astype(np.float32)
    r = (rng.standard_normal(n) * 0.01).astype(np.float32)
    acc = rng.standard_normal(n).astype(np.float32)
    jx = jnp.asarray(x).astype(getattr(jnp, dtype))
    tx = torch.from_numpy(x).to(getattr(torch, dtype))

    jq, js, jmeta = jops.quantize(jx, backend="jnp")
    tq, ts, tmeta = ops.quantize(tx)
    _eq(jq, tq)
    _eq(js, ts)
    assert tmeta.n == jmeta.n and tmeta.shape == jmeta.shape
    _eq(jops.dequantize(jq, js, jmeta, backend="jnp"),
        ops.dequantize(tq, ts, tmeta))
    _eq(jops.dequantize_accumulate(jq, js, jnp.asarray(acc), jmeta,
                                   backend="jnp"),
        ops.dequantize_accumulate(tq, ts, torch.from_numpy(acc), tmeta))

    jq2, js2, _, jn2 = jops.quantize_ef(jx, jnp.asarray(r), backend="jnp")
    tq2, ts2, _, tn2 = ops.quantize_ef(tx, torch.from_numpy(r))
    _eq(jq2, tq2)
    _eq(js2, ts2)
    _eq(jn2, tn2)
    assert tn2.shape == (n,) and tn2.dtype == torch.float32
    np.testing.assert_allclose(
        float(jops.quantization_rmse(jx, backend="jnp")),
        float(ops.quantization_rmse(tx)), rtol=1e-6)


@pytest.mark.parametrize("n", [1, 100, 4096, 4097, 70000, 262_144_000])
@pytest.mark.parametrize("block", [128, 512])
def test_pad_info_matches_reference(n, block):
    a, b = jops.pad_info(n, block), ops.pad_info(n, block)
    assert (a.n, a.padded, a.waste_elems) == (b.n, b.padded, b.waste_elems)
    assert a.waste_frac == b.waste_frac


def test_quantize_ef_rejects_mismatched_residual():
    with pytest.raises(ValueError, match="residual"):
        ops.quantize_ef(torch.zeros(100), torch.zeros(99))


# --------------------------------------------------------------------------
# shape-contract errors: the reference's ValueErrors
# --------------------------------------------------------------------------

@pytest.mark.parametrize("fn", ["quantize_blocks", "quantize_ef_blocks",
                                "dequantize_blocks",
                                "dequantize_accumulate_blocks"])
def test_ragged_rows_and_non_lane_blocks_raise(fn):
    def call(shape):
        x = torch.zeros(shape)
        q = torch.zeros(shape, dtype=torch.int8)
        s = torch.zeros(shape[0])
        return {"quantize_blocks": lambda: quant8.quantize_blocks(x),
                "quantize_ef_blocks": lambda: quant8.quantize_ef_blocks(x, x),
                "dequantize_blocks": lambda: quant8.dequantize_blocks(q, s),
                "dequantize_accumulate_blocks":
                    lambda: quant8.dequantize_accumulate_blocks(q, s, x)}[fn]()

    with pytest.raises(ValueError) as port_err:
        call((3, 512))
    with pytest.raises(ValueError) as ref_err:
        jq8.quantize_blocks(jnp.zeros((3, 512)), interpret=True)
    for e in (port_err, ref_err):
        assert "3" in str(e.value) and "TILE_ROWS" in str(e.value)
    with pytest.raises(ValueError) as port_err:
        call((8, 100))
    with pytest.raises(ValueError) as ref_err:
        jq8.quantize_blocks(jnp.zeros((8, 100)), interpret=True)
    for e in (port_err, ref_err):
        assert "100" in str(e.value) and "128" in str(e.value)


def test_wrappers_take_plain_versions_on_cpu_without_counting():
    quant8.reset_launches()
    x = torch.randn(8, 512)
    q, s = quant8.quantize_blocks(x)
    rq, rs = ref.quantize_blocks(x)
    assert torch.equal(q, rq) and torch.equal(s, rs)
    quant8.quantize_ef_blocks(x, x)
    quant8.dequantize_accumulate_blocks(q, s, x)
    assert quant8.dequantize_blocks(q, s).dtype == torch.float32
    assert all(v == 0 for v in quant8.LAUNCHES.values())
    assert quant8.TILE_ROWS == jq8.TILE_ROWS and quant8.LANE == jq8.LANE
    assert quant8.DEFAULT_BLOCK == jq8.DEFAULT_BLOCK


# --------------------------------------------------------------------------
# backend policy: by device
# --------------------------------------------------------------------------

def test_wire_backend_resolves_by_device():
    assert ops.wire_backend() == "torch"
    assert ops.wire_backend("auto", torch.device("cpu")) == "torch"
    assert ops.wire_backend("torch", "cpu") == "torch"
    # a CUDA device resolves to the kernels; the device object needs no card
    cuda = torch.device("cuda", 0)
    assert ops.wire_backend("auto", cuda) == "cuda"
    assert ops.wire_backend("cuda", cuda) == "cuda"
    with pytest.raises(ValueError, match="torch"):
        ops.wire_backend("torch", cuda)
    with pytest.raises(ValueError, match="cuda"):
        ops.wire_backend("cuda", "cpu")
    with pytest.raises(ValueError, match="unknown quantization backend"):
        ops.wire_backend("pallas", "cpu")


def test_ops_route_cuda_tensors_to_the_kernels(monkeypatch):
    """A tensor whose device is CUDA goes to quant8 (the kernels), never to
    the plain versions: checked with a stub device, since no card is here."""
    seen = []

    class Stub:
        """Stands in for a CUDA tensor's blocked view."""
        device = torch.device("cuda", 0)
        shape = (4096,)
        dtype = torch.bfloat16

    monkeypatch.setattr(ops, "_to_blocks", lambda x, block, pad_to=None:
                        (Stub(), 4096))
    monkeypatch.setattr(quant8, "quantize_cast_blocks",
                        lambda x2d: seen.append("kernel") or ("q", "s"))
    monkeypatch.setattr(ref, "quantize_blocks",
                        lambda x2d: seen.append("plain") or ("q", "s"))
    ops.quantize(Stub())
    assert seen == ["kernel"]
    with pytest.raises(ValueError):
        ops.quantize(Stub(), backend="torch")
