"""The CUDA kernels on the card against their plain PyTorch versions.

Marked `gpu`: every test takes the `cuda` fixture, which skips where no CUDA
device is present (decided inside the fixture, so every worker collects the
same tests). On a machine with a card and without JAX:

    PYTHONPATH=src python -m pytest -m gpu --noconftest tests/test_torch_cuda.py

Tolerance for quant8: bitwise. Those kernels are built without FMA
contraction and with IEEE division, so they repeat the plain versions'
arithmetic exactly; rows holding inf are compared on their scales only.
flash_attention is held to a tolerance, stated at its tests.
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


# --- flash attention ------------------------------------------------------------

# (B, H, Sq, Sk, D, causal, window): ragged edges, cross lengths, windows, and
# every head dim the kernel is built for
FLASH_CASES = [(1, 2, 64, 64, 32, True, None), (2, 3, 100, 100, 32, True, 24),
               (1, 1, 128, 256, 64, True, None), (2, 2, 65, 65, 64, False, None),
               (1, 4, 300, 300, 128, True, 100), (2, 2, 130, 70, 128, False, 70)]


# (rtol, atol as a share of the RMS of the plain output's row), as in
# chip_smoke.py: bf16 two output ulps and the probabilities' bf16 rounding
# in P V; f32 summation order and exp
FLASH_TOL = {torch.float32: (2e-5, 2e-5), torch.bfloat16: (1.6e-2, 2e-2)}


def _flash_excess(out, plain, dtype):
    """The largest |out - plain| / (rtol |plain| + atol rms(row of plain));
    at most 1 within FLASH_TOL."""
    rtol, atol = FLASH_TOL[dtype]
    plain = plain.float()
    rms = plain.square().mean(-1, keepdim=True).sqrt()
    return float(((out.float() - plain).abs()
                  / (rtol * plain.abs() + atol * rms)).max())


def _control(q, k, v, causal, window):
    """The plain version with the scores of up to 64 keys set to 0: a
    result the check must reject."""
    lo = min(64, k.shape[2] // 2)
    k = k.clone()
    k[:, :, lo:lo + 64] = 0
    return ref.flash_attention(q, k, v, causal=causal, window=window)


@pytest.mark.parametrize("case", FLASH_CASES, ids=str)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_vs_plain(cuda, case, dtype):
    """Standard normal q, k, v (scores of standard deviation 1)."""
    from repro_torch.kernels import flashattn
    B, H, Sq, Sk, D, causal, window = case
    g = torch.Generator(device=cuda).manual_seed(Sq * D)
    q, k, v = (torch.randn(s, generator=g, device=cuda).to(dtype)
               for s in ((B, H, Sq, D), (B, H, Sk, D), (B, H, Sk, D)))
    flashattn.reset_launches()
    got = flashattn.flash_attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert flashattn.LAUNCHES["flash_attention"] == 1
    want = ref.flash_attention(q, k, v, causal=causal, window=window)
    assert _flash_excess(got, want, dtype) <= 1
    assert _flash_excess(_control(q, k, v, causal, window), want, dtype) > 1


def test_gqa_flash_attention_reads_kv_heads_through_strides(cuda):
    """8 query heads on 2 KV heads in the model's (B, S, H, D) layout,
    against the plain version on the transposed copies with the KV heads
    repeated."""
    from repro_torch.kernels import flashattn
    dtype = torch.bfloat16
    g = torch.Generator(device=cuda).manual_seed(3)
    q = torch.randn(2, 200, 8, 128, generator=g, device=cuda).to(dtype)
    k, v = (torch.randn(2, 200, 2, 128, generator=g, device=cuda).to(dtype)
            for _ in range(2))
    got = flashattn.gqa_flash_attention(q, k, v, causal=True, window=64)
    qt, kt, vt = (t.repeat_interleave(8 // t.shape[2], dim=2).transpose(1, 2)
                  for t in (q, k, v))
    want = ref.flash_attention(qt, kt, vt, causal=True, window=64)
    assert _flash_excess(got.transpose(1, 2), want, dtype) <= 1
    assert _flash_excess(_control(qt, kt, vt, True, 64), want, dtype) > 1


def test_flash_wrapper_rejects_what_the_kernel_does_not_take(cuda):
    from repro_torch.kernels import flashattn
    q = torch.zeros(1, 2, 16, 48, device=cuda)
    with pytest.raises(ValueError, match="head dim"):
        flashattn.flash_attention(q, q, q)
    q = torch.zeros(1, 16, 2, 32, device=cuda).transpose(1, 2)
    with pytest.raises(ValueError, match="contiguous"):
        flashattn.flash_attention(q, q, q)
    with pytest.raises(ValueError, match="cpu"):
        flashattn.flash_attention(q.contiguous(), q.cpu(), q.cpu())


def test_prefill_launches_flash_once_per_layer_and_training_never(cuda):
    from repro_torch.configs import registry
    from repro_torch.kernels import flashattn
    from repro_torch.models.transformer import Batch, Model
    model = Model(registry.get_smoke_config("yi-6b"))
    params = model.init(torch.Generator(device=cuda).manual_seed(0), cuda)
    tok = torch.randint(0, model.cfg.vocab, (2, 40), device=cuda)
    flashattn.reset_launches()
    logits, _, _ = model.prefill(params, Batch(tokens=tok), 48)
    torch.cuda.synchronize()
    assert torch.isfinite(logits).all()
    assert flashattn.LAUNCHES["flash_attention"] == model.cfg.n_layers
    flashattn.reset_launches()
    for p in params["blocks"]["p0_attn"]["attn"].values():
        p.requires_grad_(True)
    model.loss(params, Batch(tokens=tok, labels=tok)).backward()
    assert flashattn.LAUNCHES["flash_attention"] == 0
