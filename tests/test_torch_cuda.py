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
    recs, _ = train_lib.train(registry.get_smoke_config("yi-6b"),
                              tr.CommConfig(mode="mlsl", wire="int8",
                                            error_feedback=True,
                                            accum_steps=2),
                              steps=2, batch=4, seq=32, device=cuda)
    assert all(torch.isfinite(torch.tensor(r.loss)) for r in recs)
    assert quant8.LAUNCHES["quantize_ef_blocks"] > 0
    assert quant8.LAUNCHES["dequantize_accumulate_blocks"] > 0


@pytest.mark.parametrize("with_acc", [False, True])
def test_hier_route_at_world_size_one_is_the_flat_route_plus_bf16(cuda,
                                                                 with_acc):
    """At world size 1 (NCCL groups of one rank) the two-level int8 + EF
    route quantizes the same bf16 shard with the same residual as the flat
    route, on the same kernels: residual bitwise equal. Its intra
    all-gather carries the dequantized shard on the bf16 wire, so the
    result is bitwise the flat route's (without accumulator) rounded to
    bf16, plus the accumulator. It launches one quantize_ef_blocks and one
    dequantize_blocks, whatever the accumulator."""
    from repro_torch.core import collectives as cl
    from repro_torch.core import hier
    from repro_torch.launch import mesh as mesh_lib
    mesh = mesh_lib.make_hier_mesh(1, 1, device=cuda)
    groups = {a: mesh.get_group(a) for a in ("node", "local")}
    g = torch.Generator(device=cuda).manual_seed(11)
    n = 180_355_072 // 64                  # a slice of the MLP bucket
    x = torch.randn(n, generator=g, device=cuda) * 0.01
    res = torch.randn(hier.ef_residual_shape(n, 1, 1), generator=g,
                      device=cuda) * 1e-4
    acc = torch.randn(n, generator=g, device=cuda) if with_acc else None
    spec = hier.HierSpec(wire_intra="bf16", wire_inter="int8",
                         error_feedback=True, backend="cuda")
    quant8.reset_launches()
    got, got_res = hier.hier_allreduce_ef(x, res, groups, spec, mean=True,
                                          acc=acc)
    torch.cuda.synchronize()
    assert quant8.LAUNCHES == {**dict.fromkeys(quant8.LAUNCHES, 0),
                               "quantize_ef_blocks": 1,
                               "dequantize_blocks": 1}
    flat, flat_res = cl.allreduce_ef(x, res, [groups["node"],
                                              groups["local"]], mean=True)
    assert torch.equal(got_res, flat_res)
    want = flat.to(torch.bfloat16).to(torch.float32)
    assert torch.equal(got, want if acc is None else acc + want)


# --- hybrid (data x model) parallelism at tp = 1 -------------------------------

@pytest.mark.parametrize("g_op", ["tp_psum", "tp_psum_scatter"])
def test_fg_functions_are_the_identity_on_a_one_rank_nccl_group(cuda, g_op):
    """tp_replicate and tp_psum (or tp_psum_scatter) around a column- and a
    row-split projection, over the one-rank NCCL "local" group: forward and
    every gradient bitwise the dense computation's."""
    from repro_torch.core import collectives as cl
    from repro_torch.launch import mesh as mesh_lib
    group = mesh_lib.make_hier_mesh(1, 1, device=cuda).get_group("local")
    g = torch.Generator(device=cuda).manual_seed(12)
    x, w1, w2 = (torch.randn(shape, generator=g, device=cuda)
                 .to(torch.bfloat16)
                 for shape in ((2, 256, 512), (512, 384), (384, 512)))
    outs = []
    for wrap in (False, True):
        a, b, xx = (t.clone().requires_grad_(True) for t in (w1, w2, x))
        xr = cl.tp_replicate(xx, group) if wrap else xx
        y = torch.relu(xr @ a) @ b
        if wrap:
            y = getattr(cl, g_op)(y, group)
        loss = y.float().square().sum()
        outs.append([y.detach(), *torch.autograd.grad(loss, (a, b, xx))])
    for got, want in zip(*reversed(outs)):
        assert torch.equal(got, want)


def test_hybrid_step_at_tp_one_runs_the_kernels(cuda):
    """The hybrid planner on make_hier_mesh(1, 1): every layer is chooser-
    data, every bucket fuses and takes the two-level int8 route over
    ("node", "local"), one quantize_blocks and one dequantize_blocks per
    bucket and microbatch; the same losses as the dp_only planner's two-
    level step, which reduces the same buckets."""
    from repro_torch.configs import registry
    from repro_torch.core import planner as pl
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.launch import train as train_lib
    from repro_torch.models.transformer import Model
    from repro_torch.train import trainer as tr
    cfg = registry.get_smoke_config("yi-6b")
    comm = tr.CommConfig(mode="mlsl", wire="int8", hier=True, accum_steps=2)
    mesh = mesh_lib.make_hier_mesh(1, 1, device=cuda)
    planner = pl.make_hybrid_planner(mesh, cfg, batch=4, seq=32)
    assert {lp.reason for lp in planner.hybrid.layers} == {"chooser-data"}
    plan = tr.make_comm_engine(Model(cfg), mesh, planner, comm,
                               device=cuda).plan
    assert set(plan.bucket_axes) == {("node", "local")}
    assert set(plan.algos) == {pl.ALGO_HIER} and all(plan.fusable)
    losses = {}
    for name, pln in (("hybrid", planner), ("dp_only", None)):
        quant8.reset_launches()
        recs, _ = train_lib.train(cfg, comm, steps=2, batch=4, seq=32,
                                  dp_only=True, device=cuda, mesh=mesh,
                                  planner=pln)
        torch.cuda.synchronize()
        losses[name] = [r.loss for r in recs]
        n = plan.n_buckets * 2 * 2
        assert quant8.LAUNCHES == {**dict.fromkeys(quant8.LAUNCHES, 0),
                                   "quantize_blocks": n,
                                   "dequantize_blocks": n}, name
    assert all(torch.isfinite(torch.tensor(losses["hybrid"])))
    assert losses["hybrid"] == losses["dp_only"]


@pytest.mark.parametrize("ef", [False, True])
def test_bucket_replay_launches_one_quantize_and_dequantize(cuda, ef):
    """The obs hooks on the card: train() with a meter and a BucketTimer
    sampled after every step launches the steps' kernels plus exactly one
    quantize and one dequantize per bucket per replay (fresh residuals,
    its own inputs), and trains bitwise as without the hooks."""
    from repro_torch.configs import registry
    from repro_torch.core import planner as pl
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.launch import train as train_lib
    from repro_torch.models.transformer import Model
    from repro_torch.obs import meter as obs_meter
    from repro_torch.train import trainer as tr
    cfg = registry.get_smoke_config("yi-6b")
    comm = tr.CommConfig(mode="mlsl", wire="int8", error_feedback=ef)
    mesh = mesh_lib.make_host_mesh(1, 1, device=cuda)
    planner = pl.Planner(mesh=mesh, dp_only=True)
    engine = tr.make_comm_engine(Model(cfg), mesh, planner, comm,
                                 device=cuda)
    n = engine.plan.n_buckets
    runs = {}
    for hooks in (False, True):
        kw = (dict(meter=obs_meter.StepMeter(),
                   timer=engine.bucket_timer(mesh), sample_every=1)
              if hooks else {})
        quant8.reset_launches()
        recs, _ = train_lib.train(cfg, comm, steps=2, batch=4, seq=32,
                                  device=cuda, mesh=mesh, planner=planner,
                                  **kw)
        torch.cuda.synchronize()
        runs[hooks] = ([r.loss for r in recs], dict(quant8.LAUNCHES))
    q = "quantize_ef_blocks" if ef else "quantize_blocks"
    replays = 3                        # a warm-up + one per step
    assert runs[False][1] == {**dict.fromkeys(quant8.LAUNCHES, 0),
                              q: 2 * n, "dequantize_blocks": 2 * n}
    assert runs[True][1] == {**dict.fromkeys(quant8.LAUNCHES, 0),
                             q: (2 + replays) * n,
                             "dequantize_blocks": (2 + replays) * n}
    assert runs[True][0] == runs[False][0]


# --- flash attention ------------------------------------------------------------

# (B, H, Sq, Sk, D, causal, window): ragged edges, cross lengths, windows, and
# every head dim the kernels are built for. At D 128 (bf16: the Hopper
# kernel's 128-row query and 128-key tiles) lengths that are not multiples
# of 128, Sq != Sk under the causal mask, and a window narrower than a tile.
FLASH_CASES = [(1, 2, 64, 64, 32, True, None), (2, 3, 100, 100, 32, True, 24),
               (1, 1, 128, 256, 64, True, None), (2, 2, 65, 65, 64, False, None),
               (1, 4, 300, 300, 128, True, 100), (2, 2, 130, 70, 128, False, 70),
               (1, 2, 200, 200, 128, True, None),
               (1, 2, 129, 383, 128, True, 130),
               (2, 3, 300, 300, 128, True, 24)]


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
    kernel = ("fma_f32" if dtype == torch.float32 else
              "wgmma_bf16" if D == 128 else "mma_bf16")
    assert flashattn.VARIANT_LAUNCHES[kernel] == 1
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


@pytest.mark.parametrize("window", [None, 130])
def test_gqa_flash_attention_at_the_prefill_head_ratio(cuda, window):
    """yi-6b's 32 query heads on 4 KV heads at D 128 (the Hopper kernel),
    with a ragged length, against the plain version on repeated heads."""
    from repro_torch.kernels import flashattn
    dtype = torch.bfloat16
    g = torch.Generator(device=cuda).manual_seed(4)
    q = torch.randn(2, 300, 32, 128, generator=g, device=cuda).to(dtype)
    k, v = (torch.randn(2, 300, 4, 128, generator=g, device=cuda).to(dtype)
            for _ in range(2))
    flashattn.reset_launches()
    got = flashattn.gqa_flash_attention(q, k, v, causal=True, window=window)
    torch.cuda.synchronize()
    assert flashattn.VARIANT_LAUNCHES["wgmma_bf16"] == 1
    qt, kt, vt = (t.repeat_interleave(32 // t.shape[2], dim=2).transpose(1, 2)
                  for t in (q, k, v))
    want = ref.flash_attention(qt, kt, vt, causal=True, window=window)
    assert _flash_excess(got.transpose(1, 2), want, dtype) <= 1
    assert _flash_excess(_control(qt, kt, vt, True, window), want, dtype) > 1


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
