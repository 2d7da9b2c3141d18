"""The CUDA kernels on the card against their plain PyTorch versions.

Marked `gpu`: every test takes the `cuda` fixture, which skips where no CUDA
device is present (decided inside the fixture, so every worker collects the
same tests). On a machine with a card and without JAX:

    PYTHONPATH=src python -m pytest -m gpu --noconftest tests/test_torch_cuda.py

Tolerance: bitwise. The kernels are built without FMA contraction and with
IEEE division, so they repeat the plain versions' arithmetic exactly; rows
holding inf are compared on their scales only.
"""

import pytest
import torch

from repro_torch.kernels import ops, quant8, ref

pytestmark = pytest.mark.gpu

SHAPES = [(8, 128), (8, 512), (64, 512), (24, 384), (16, 1024), (8, 1152)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _inputs(shape, dtype, device, seed):
    g = torch.Generator(device=device).manual_seed(seed)
    x = (torch.randn(shape, generator=g, device=device) * 3).to(dtype)
    r = torch.randn(shape, generator=g, device=device) * 0.01
    x[0] = 0
    r[0] = 0
    return x, r


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernels_bitwise_vs_plain(cuda, shape, dtype):
    x, r = _inputs(shape, dtype, cuda, seed=shape[0] * shape[1])
    for a, b in zip(quant8.quantize_blocks(x), ref.quantize_blocks(x)):
        assert torch.equal(a, b)
    for a, b in zip(quant8.quantize_ef_blocks(x, r),
                    ref.quantize_ef_blocks(x, r)):
        assert torch.equal(a, b)
    q, s = ref.quantize_blocks(x)
    assert torch.equal(quant8.dequantize_blocks(q, s),
                       ref.dequantize_blocks(q, s))
    assert torch.equal(quant8.dequantize_accumulate_blocks(q, s, r),
                       ref.dequantize_accumulate_blocks(q, s, r))


def test_inf_and_nan_rows(cuda):
    x = torch.ones(16, 512, device=cuda)
    x[1, 3] = float("inf")
    x[2, 4] = float("nan")
    r = torch.zeros_like(x)
    q, s, nr = quant8.quantize_ef_blocks(x, r)
    pq, ps, pnr = ref.quantize_ef_blocks(x, r)
    assert torch.equal(s.isnan(), ps.isnan())
    assert torch.equal(s.nan_to_num(), ps.nan_to_num())
    assert torch.isinf(s[1]) and torch.isnan(s[2])
    assert torch.equal(q[3:], pq[3:]) and torch.equal(nr[3:], pnr[3:])
    assert torch.isnan(nr[1]).all() and torch.isnan(pnr[1]).all()


def test_launches_counted_per_kernel_launch(cuda):
    x, r = _inputs((8, 512), torch.bfloat16, cuda, seed=1)
    quant8.reset_launches()
    q, s = quant8.quantize_blocks(x)
    quant8.quantize_ef_blocks(x, r)
    quant8.dequantize_blocks(q, s)
    quant8.dequantize_accumulate_blocks(q, s, r)
    ref.quantize_ef_blocks(x, r)               # the plain versions never count
    torch.cuda.synchronize()
    assert quant8.LAUNCHES == {"quantize_blocks": 1, "quantize_ef_blocks": 1,
                               "dequantize_blocks": 1,
                               "dequantize_accumulate_blocks": 1}


def test_wrappers_reject_what_the_kernels_do_not_take(cuda):
    x = torch.randn(16, 512, device=cuda)
    with pytest.raises(ValueError, match="contiguous"):
        quant8.quantize_blocks(x.t().contiguous().t()[:, :512][:8])
    with pytest.raises(ValueError, match="dtype"):
        quant8.quantize_blocks(x.to(torch.float16))
    with pytest.raises(ValueError, match="aligned"):
        quant8.quantize_blocks(x.reshape(-1)[1:1 + 8 * 512].reshape(8, 512))
    with pytest.raises(ValueError, match="CUDA"):
        quant8.quantize_ef_blocks(x, torch.zeros(16, 512))
    with pytest.raises(ValueError, match="TILE_ROWS"):
        quant8.quantize_blocks(x[:3])
    with pytest.raises(ValueError, match="torch"):
        ops.quantize(x, backend="torch")


@pytest.mark.parametrize("n", [1, 511, 4097, 70000])
def test_ops_on_cuda_equal_plain_path_on_cpu(cuda, n):
    g = torch.Generator().manual_seed(n)
    x = (torch.randn(n, generator=g) * 0.5).to(torch.bfloat16)
    r = torch.randn(n, generator=g) * 0.01
    got = ops.quantize_ef(x.to(cuda), r.to(cuda))
    want = ops.quantize_ef(x, r)
    for a, b in zip((got[0], got[1], got[3]), (want[0], want[1], want[3])):
        assert torch.equal(a.cpu(), b)
    acc = torch.randn(n, generator=g)
    assert torch.equal(
        ops.dequantize_accumulate(got[0], got[1], acc.to(cuda), got[2]).cpu(),
        ops.dequantize_accumulate(want[0], want[1], acc, want[2]))


def test_smoke_train_step_runs_the_kernels(cuda):
    from repro_torch.configs import registry
    from repro_torch.launch import train as train_lib
    from repro_torch.train import trainer as tr
    quant8.reset_launches()
    recs = train_lib.train(registry.get_smoke_config("yi-6b"),
                           tr.CommConfig(wire="int8", error_feedback=True,
                                         accum_steps=2),
                           steps=2, batch=4, seq=32, device=cuda)
    assert all(torch.isfinite(torch.tensor(r.loss)) for r in recs)
    assert quant8.LAUNCHES["quantize_ef_blocks"] > 0
    assert quant8.LAUNCHES["dequantize_accumulate_blocks"] > 0
