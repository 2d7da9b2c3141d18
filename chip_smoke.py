#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (src/repro_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each fatal on failure:

  1. device   -- CUDA must be present; prints the card's name, the device
                 count and `nvidia-smi`'s name and power limit;
  2. build    -- compiles the CUDA kernels from src/repro_torch/kernels/csrc
                 with nvcc, one process per source, all started together,
                 and prints ptxas's register/spill/smem lines;
  3. kernels  -- each kernel against its plain PyTorch version on the card.
                 quant8: at the main path's bucket shapes (the 262,144,000-
                 element embedding bucket, the 180,355,072-element MLP bucket
                 and the 32,768-element norm bucket of yi-6b, as (n/512, 512)
                 rows), with bf16 and f32 inputs, zero rows, an inf row and a
                 NaN row. Tolerance: bitwise on the finite rows (the kernels
                 are built without FMA contraction); equal scales and an
                 all-NaN residual on the inf row. flash_attention: at the
                 prefill shape of serve cell S-A (batch 8, 2048 tokens, 32
                 query heads on 4 KV heads, D 128) bf16 causal, of S-B
                 (1, 8192, 32 on 4, 128) bf16 causal window 4096 (compared
                 on the first 4 heads: the plain version's scores for 32
                 heads would take 8.6 GB), and a ragged f32 case (2, 1000,
                 3 on 1, 32) causal window 100; both wrappers, the model's
                 (B, S, H, D) layout with KV heads read through strides and
                 the reference's (B, H, S, D) with heads repeated; scores of
                 standard deviation 1. Tolerance (FLASH_TOL), per element,
                 rtol |plain| + atol x the RMS of the plain output's row:
                 bf16 1.6e-2 and 2e-2, f32 2e-5 and 2e-5; a control with 64
                 keys' scores zeroed must fail it. Times kernel, plain
                 version and the one PyTorch call that computes the same
                 function (`torch.mul`, `torch.addcmul` for the dequantize
                 kernels, `scaled_dot_product_attention` for flash; no single
                 call quantizes) with CUDA events;
  4. model    -- the smoke model on the card against the CPU, same weights:
                 loss and gradients (loss rtol 1e-5, gradients 1e-4 of their
                 norm), prefill logits and one decode step (atol 1e-4, f32);
  5-7. train  -- the mlsl int8 train step of yi-6b at full width cut to 4
                 layers (global batch 8, seq 2048, AdamW, warmup-cosine):
                 A, the default planner, error feedback, 2 microbatches, 3
                 steps; B, the same with Planner(dp_only=True); C, dp_only,
                 int8 without error feedback, 1 microbatch, 2 steps. Each
                 checks finite losses and its kernels' launch counts (flash
                 attention: none, the train forward records autograd);
  8. serve    -- full yi-6b (32 layers, bf16, random weights from a seed)
                 through `Engine.generate`: S-A batch 8, prompt 2048, 64 new
                 tokens, greedy (run twice: equal tokens); S-B long context
                 (window 4096), batch 1, prompt 8192, 32 new tokens; S-C as
                 S-A with the int8 KV cache. Each checks 32 flash launches
                 per prefill, finite prefill and decode logits and tokens in
                 the vocabulary, and prints prefill, first-token and decode
                 times and peak memory;
  9. cli      -- `repro_torch.launch.train.main` and
                 `repro_torch.launch.serve.main` (ragged prompts through
                 `serve_requests`) on the smoke config;
 10. report   -- the serve cells' numbers, one JSON line with every kernel,
                 then the device line.

Exits non-zero without the result line when CUDA is absent or any phase
fails. Needs one card and no network.
"""

from __future__ import annotations

import concurrent.futures
import dataclasses
import json
import math
import os
import subprocess
import sys
import time

import numpy as np

HBM_BYTES_PER_S = 3.35e12       # H100 SXM device memory (NVIDIA data sheet)
F32_OPS_PER_S = 67e12           # H100 SXM f32 outside the tensor cores
BF16_OPS_PER_S = 989e12         # H100 SXM bf16 tensor cores, dense
BLOCK = 512
BUCKETS = {"embed": 262_144_000, "mlp_w1": 180_355_072, "norm": 32_768}
SOURCES = {"quant8": "src/repro_torch/kernels/csrc/quant8.cu",
           "flashattn": "src/repro_torch/kernels/csrc/flashattn.cu"}
KERNELS = {   # wrapper -> the TPU kernel it replaces (file:line)
    "quantize_blocks": "src/repro/kernels/quant8.py:43",
    "quantize_ef_blocks": "src/repro/kernels/quant8.py:57",
    "dequantize_blocks": "src/repro/kernels/quant8.py:77",
    "dequantize_accumulate_blocks": "src/repro/kernels/quant8.py:83",
    "flash_attention": "src/repro/kernels/flashattn.py:34",
}
QUANT8 = tuple(KERNELS)[:4]
N_LAYERS = 32                   # yi-6b, served at full depth
# flash_attention shapes (B, S, H, KV, D, dtype, window, heads compared):
# the prefill of serve cells S-A and S-B (yi-6b's 32 query heads on 4 KV
# heads), and a ragged f32 case at D 32 with 3 query heads on one KV head
FLASH_SHAPES = {"S-A": (8, 2048, 32, 4, 128, "bfloat16", None, 32),
                "S-B": (1, 8192, 32, 4, 128, "bfloat16", 4096, 4),
                "ragged": (2, 1000, 3, 1, 32, "float32", 100, 3)}
# flash_attention tolerance (rtol, atol as a share of the RMS of the plain
# output's row): |out - plain| <= rtol |plain| + atol rms(row). bf16: both
# sides round the output to bf16 (rtol, two bf16 ulps), and the kernel
# feeds the probabilities to P V in bf16 (an error of about 1e-3 of the
# row's RMS per element, up to 9e-3 on 16 M elements of a CPU emulation;
# atol). f32: summation order and exp differ.
FLASH_TOL = {"bfloat16": (1.6e-2, 2e-2), "float32": (2e-5, 2e-5)}
# f32 operations per element (abs, max, divide, round, clip x2, mul, sub)
OPS_PER_ELEM = {"quantize_blocks": 6, "quantize_ef_blocks": 9,
                "dequantize_blocks": 1, "dequantize_accumulate_blocks": 2}


def log(*a):
    print(*a, flush=True)


def phase(name):
    log(f"== {name}")


class Fail(RuntimeError):
    pass


def check(cond, msg):
    if not cond:
        raise Fail(msg)


# --------------------------------------------------------------------------
# 1-2. device and build
# --------------------------------------------------------------------------

def device_phase(torch):
    phase("device")
    name = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    log(f"device {name} count={count} torch={torch.__version__} "
        f"cuda={torch.version.cuda}")
    return name, count, smi


def build_phase():
    phase("build")
    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(len(SOURCES)) as pool:
        built = list(pool.map(_build.build, SOURCES))
    log(f"built {', '.join(p.name for p, _ in built)} in "
        f"{time.perf_counter() - t0:.2f}s")
    for _, out in built:
        for line in out.splitlines():
            if any(k in line for k in ("registers", "spill", "smem",
                                       "Compiling")):
                log("  " + line.strip())


# --------------------------------------------------------------------------
# 3. kernels against their plain versions
# --------------------------------------------------------------------------

def _time_ms(torch, fn, iters):
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _nbytes(*ts):
    return sum(t.numel() * t.element_size() for t in ts)


def _max_err(torch, a, b):
    if a.numel() == 0:
        return 0.0
    return float((a.to(torch.float64) - b.to(torch.float64)).abs().max())


def _special_rows(torch, x, r):
    """Row 0 zeros (input and residual), row 1 holds an inf, row 2 a NaN;
    rows 3.. are finite."""
    x[0] = 0
    r[0] = 0
    x[1, 5] = float("inf")
    x[2, 9] = float("nan")


def kernels_phase(torch):
    phase("kernels")
    from repro_torch.kernels import quant8, ref
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    results = {k: {"max_abs_err": 0.0} for k in QUANT8}

    def compare(name, bucket, dtype, outs, plain_outs, finite_rows):
        err = 0.0
        for o, p in zip(outs, plain_outs):
            if o.dim() == 2:
                o, p = o[finite_rows:], p[finite_rows:]
                err = max(err, _max_err(torch, o, p))
                check(torch.equal(o, p),
                      f"{name} {bucket} {dtype}: differs from the plain "
                      f"version (max abs err {err})")
            else:
                # scales: every row, NaN where the plain version has NaN
                check(torch.equal(torch.isnan(o), torch.isnan(p)) and
                      torch.equal(o.nan_to_num(), p.nan_to_num()),
                      f"{name} {bucket} {dtype}: scales differ")
        results[name]["max_abs_err"] = max(results[name]["max_abs_err"], err)

    def measure(name, bucket, dtype, fn, plain, bytes_, n, iters,
                library=None):
        ms = _time_ms(torch, fn, iters)
        plain_ms = _time_ms(torch, plain, max(2, iters // 4))
        library_ms = None if library is None else _time_ms(torch, library,
                                                           iters)
        t_bytes = bytes_ / HBM_BYTES_PER_S * 1e3
        t_ops = OPS_PER_ELEM[name] * n / F32_OPS_PER_S * 1e3
        bound_ms, bound_by = max((t_bytes, "bytes"), (t_ops, "operations"))
        lib = "null" if library_ms is None else f"{library_ms:.4f} ms"
        log(f"  {name:30s} {bucket:7s} {dtype:9s} kernel {ms:.4f} ms  "
            f"bound {bound_ms:.4f} ms ({bound_by}, {bytes_} B)  "
            f"plain {plain_ms:.4f} ms  library {lib}")
        if bucket == "embed" and dtype in ("bfloat16", "int8->f32"):
            results[name].update(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                                 bound_by=bound_by, bytes=bytes_,
                                 library_ms=library_ms)

    def check_library(name, bucket, out, plain, finite_rows, tol=None):
        """The library call computes the kernel's function: on the finite
        rows it equals the plain version, or with `tol` (addcmul, which may
        fuse the multiply and the add) stays within it elementwise."""
        out, plain = out[finite_rows:], plain[finite_rows:]
        err = _max_err(torch, out, plain)
        log(f"  {name:30s} {bucket:7s} library call max abs err {err}")
        ok = (torch.equal(out, plain) if tol is None else
              bool(((out - plain).abs() <= tol[finite_rows:]).all()))
        check(ok, f"{name} {bucket}: the library call differs from the "
                  f"plain version (max abs err {err})")

    for bucket, n in BUCKETS.items():
        rows = n // BLOCK
        iters = 20 if n > 1_000_000 else 200
        r = torch.randn((rows, BLOCK), generator=gen, device=dev) * 0.01
        for dtype in (torch.bfloat16, torch.float32):
            dname = str(dtype).split(".")[1]
            x = (torch.randn((rows, BLOCK), generator=gen, device=dev)
                 * 3).to(dtype)
            _special_rows(torch, x, r)
            # quantize
            outs = quant8.quantize_blocks(x)
            compare("quantize_blocks", bucket, dname, outs,
                    ref.quantize_blocks(x), 3)
            check(bool(torch.isinf(outs[1][1])) and
                  bool(torch.isnan(outs[1][2])) and outs[1][0] == 0,
                  "quantize: inf/NaN/zero row scales")
            measure("quantize_blocks", bucket, dname,
                    lambda: quant8.quantize_blocks(x),
                    lambda: ref.quantize_blocks(x),
                    _nbytes(x, *outs), n, iters)
            # error-feedback quantize
            outs = quant8.quantize_ef_blocks(x, r)
            plain = ref.quantize_ef_blocks(x, r)
            compare("quantize_ef_blocks", bucket, dname, outs, plain, 3)
            check(bool(torch.isnan(outs[2][1]).all()) and
                  bool(torch.isnan(plain[2][1]).all()),
                  "quantize_ef: the inf row's residual must be all NaN")
            check(outs[1][0] == 0 and not outs[0][0].any()
                  and not outs[2][0].any(),
                  "quantize_ef: a zero row must give s = 0, q = 0, r' = 0")
            measure("quantize_ef_blocks", bucket, dname,
                    lambda: quant8.quantize_ef_blocks(x, r),
                    lambda: ref.quantize_ef_blocks(x, r),
                    _nbytes(x, r, *outs), n, iters)
            q, s = quant8.quantize_blocks(x)
            del outs, plain, x
        # dequantize on the codes of the last input (f32 out). The library
        # yardsticks are one PyTorch call each, which widens the int8 codes
        # inside the call; they are timed here and not used by the port.
        acc = r

        def lib_deq():
            return torch.mul(q, s[:, None])

        def lib_acc():
            return torch.addcmul(acc, q, s[:, None])

        out = quant8.dequantize_blocks(q, s)
        plain = ref.dequantize_blocks(q, s)
        compare("dequantize_blocks", bucket, "int8->f32", [out], [plain], 3)
        check_library("dequantize_blocks", bucket, lib_deq(), plain, 3)
        measure("dequantize_blocks", bucket, "int8->f32",
                lambda: quant8.dequantize_blocks(q, s),
                lambda: ref.dequantize_blocks(q, s),
                _nbytes(q, s, out), n, iters, library=lib_deq)
        out = quant8.dequantize_accumulate_blocks(q, s, acc)
        plain = ref.dequantize_accumulate_blocks(q, s, acc)
        compare("dequantize_accumulate_blocks", bucket, "int8->f32", [out],
                [plain], 3)
        # a fused multiply-add skips the product's rounding: within half an
        # ulp of |q*s| plus one of the sum
        tol = 2.0 ** -22 * (acc.abs() + (q.float() * s[:, None]).abs())
        check_library("dequantize_accumulate_blocks", bucket, lib_acc(),
                      plain, 3, tol)
        del tol
        measure("dequantize_accumulate_blocks", bucket, "int8->f32",
                lambda: quant8.dequantize_accumulate_blocks(q, s, acc),
                lambda: ref.dequantize_accumulate_blocks(q, s, acc),
                _nbytes(q, s, acc, out), n, iters, library=lib_acc)
        del q, s, out, plain, acc, r
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
    return results


def _visible_pairs(sq, sk, causal, window):
    """(query, key) pairs the causal/window mask leaves visible."""
    q = np.arange(sq)
    hi = np.minimum(q, sk - 1) if causal else np.full(sq, sk - 1)
    lo = np.maximum(q - window + 1, 0) if window else np.zeros(sq, np.int64)
    return int(np.maximum(hi - lo + 1, 0).sum())


def flash_excess(torch, out, plain, tol) -> float:
    """The largest |out - plain| / (rtol |plain| + atol rms(row of plain));
    out is within `tol` (FLASH_TOL) where this is at most 1."""
    rtol, atol = tol
    plain = plain.float()
    rms = plain.square().mean(-1, keepdim=True).sqrt()
    return float(((out.float() - plain).abs()
                  / (rtol * plain.abs() + atol * rms)).max())


def flash_phase(torch):
    """Both wrappers against the plain version at the three shapes: the
    main path's `gqa_flash_attention` on (B, S, H, D) q and (B, S, KV, D)
    k/v, and the reference's layout `flash_attention` on the transposed
    copies with the KV heads repeated. q, k and v are standard normal, so
    the scores q.k/sqrt(D) have a standard deviation of 1. A control (the
    plain version with the scores of 64 keys set to 0) must fall outside
    the tolerance. Times at S-A's prefill shape go into the report."""
    phase("kernels: flash_attention")
    from repro_torch.kernels import flashattn, ref
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(1)
    res = {"max_abs_err": 0.0}
    for label, (B, S, H, KV, D, dname, window, heads) in FLASH_SHAPES.items():
        dtype, tol = getattr(torch, dname), FLASH_TOL[dname]
        q = torch.randn((B, S, H, D), generator=gen, device=dev).to(dtype)
        k, v = (torch.randn((B, S, KV, D), generator=gen, device=dev)
                .to(dtype) for _ in range(2))
        qt = q.transpose(1, 2).contiguous()
        kt, vt = (t.repeat_interleave(H // KV, dim=2).transpose(1, 2)
                  .contiguous() for t in (k, v))
        kw = dict(causal=True, window=window)
        outs = {"gqa_flash_attention":
                flashattn.gqa_flash_attention(q, k, v, **kw).transpose(1, 2),
                "flash_attention": flashattn.flash_attention(qt, kt, vt, **kw)}
        torch.cuda.synchronize()
        sub = (qt[:, :heads], kt[:, :heads], vt[:, :heads])
        plain = ref.flash_attention(*sub, **kw)
        for name, out in outs.items():
            excess = flash_excess(torch, out[:, :heads], plain, tol)
            err = _max_err(torch, out[:, :heads], plain)
            log(f"  {name:19s} {label:6s} B={B} S={S} H={H} KV={KV} D={D} "
                f"{dname} window={window}: max abs err {err:.3e}, "
                f"{excess:.3f} of the tolerance {tol} on {heads} heads")
            check(excess <= 1, f"{name} {label}: differs from the plain "
                               f"version ({excess:.3f} of the tolerance)")
            res["max_abs_err"] = max(res["max_abs_err"], err)
        lo = min(64, S // 2)
        k_ctrl = sub[1].clone()
        k_ctrl[:, :, lo:lo + 64] = 0
        ctrl = flash_excess(torch, ref.flash_attention(sub[0], k_ctrl, sub[2],
                                                       **kw), plain, tol)
        log(f"  control {label:6s} (keys {lo}..{lo + 63} scored 0): "
            f"{ctrl:.3f} of the tolerance")
        check(ctrl > 1, f"flash {label}: the check passes a wrong result")
        del outs, plain, k_ctrl
        iters = 10 if S * B > 4096 else 50
        ms = _time_ms(torch, lambda: flashattn.gqa_flash_attention(
            q, k, v, **kw), iters)
        public_ms = _time_ms(torch, lambda: flashattn.flash_attention(
            qt, kt, vt, **kw), iters)
        plain_ms = _time_ms(torch, lambda: ref.flash_attention(*sub, **kw), 2)
        flops = 4 * D * H * B * _visible_pairs(S, S, True, window)
        bytes_ = 2 * _nbytes(q, k)         # q, k, v and o, v like k
        bound_ms, bound_by = max(
            (bytes_ / HBM_BYTES_PER_S * 1e3, "bytes"),
            (flops / (BF16_OPS_PER_S if dtype == torch.bfloat16
                      else F32_OPS_PER_S) * 1e3, "operations"))
        library_ms = None
        if label == "S-A":
            library_ms = _time_ms(
                torch, lambda: torch.nn.functional.scaled_dot_product_attention(
                    qt, kt, vt, is_causal=True), iters)
        lib = "null" if library_ms is None else f"{library_ms:.4f} ms"
        log(f"  flash {label:6s} gqa_flash_attention {ms:.4f} ms, "
            f"flash_attention {public_ms:.4f} ms  bound {bound_ms:.4f} ms "
            f"({bound_by}, {flops} FLOP, {bytes_} B)  plain {plain_ms:.4f} "
            f"ms on {heads} heads  library {lib}")
        if label == "S-A":
            res.update(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                       bound_by=bound_by, library_ms=library_ms)
        del q, k, v, qt, kt, vt, sub
        torch.cuda.empty_cache()
    return res


# --------------------------------------------------------------------------
# 4. the model on the card against the CPU
# --------------------------------------------------------------------------

def model_phase(torch):
    """The yi-6b smoke model's loss and gradients, prefill logits and one
    decode step on the card against the same computation on the CPU (which
    tests/test_torch_model.py and test_torch_serve.py hold to the JAX
    reference), on the same weights and batch, in f32. Tolerance: loss rtol
    1e-5, each gradient within 1e-4 of its norm, logits atol 1e-4 (the sums
    are taken in another order; TF32 is off for matmuls by default)."""
    from repro_torch import tree as tree_lib
    from repro_torch.configs import registry
    from repro_torch.models.transformer import Batch, Model
    phase("model: smoke config on cuda vs cpu, same weights")
    check(not torch.backends.cuda.matmul.allow_tf32, "TF32 matmuls are on")
    model = Model(registry.get_smoke_config("yi-6b"))
    params = model.init(torch.Generator().manual_seed(0), "cpu")
    tok = torch.randint(0, model.cfg.vocab, (4, 64),
                        generator=torch.Generator().manual_seed(1))
    out = {}
    for dev in ("cpu", "cuda"):
        p = tree_lib.tree_map(lambda t: t.to(dev).requires_grad_(True),
                              params)
        loss = model.loss(p, Batch(tokens=tok.to(dev), labels=tok.to(dev)))
        grads = torch.autograd.grad(loss, tree_lib.leaves(p))
        p = tree_lib.tree_map(lambda t: t.detach(), p)
        logits, cache, pos = model.prefill(p, Batch(tokens=tok.to(dev)), 72)
        step, _ = model.decode_step(p, cache, tok[:, :1].to(dev), pos)
        out[dev] = (float(loss.detach()), [g.cpu() for g in grads],
                    logits.cpu(), step.cpu())
    (l_cpu, g_cpu, *s_cpu), (l_gpu, g_gpu, *s_gpu) = out["cpu"], out["cuda"]
    for name, a, b in zip(("prefill", "decode_step"), s_cpu, s_gpu):
        err = float((a - b).abs().max())
        log(f"  {name} logits: max abs err {err:.3e} cuda vs cpu")
        check(bool(torch.isfinite(b).all()) and err <= 1e-4,
              f"model: {name} logits differ")
    worst = max(float((a - b).abs().max() / a.norm())
                for a, b in zip(g_cpu, g_gpu))
    log(f"  loss cpu {l_cpu:.7f} cuda {l_gpu:.7f}; worst gradient error "
        f"{worst:.3e} of its norm")
    check(math.isclose(l_gpu, l_cpu, rel_tol=1e-5), "model: loss differs")
    check(worst <= 1e-4, "model: gradients differ")


# --------------------------------------------------------------------------
# 5-8. the main path
# --------------------------------------------------------------------------

def reset_launches():
    from repro_torch.kernels import flashattn, quant8
    quant8.reset_launches()
    flashattn.reset_launches()


def read_launches():
    from repro_torch.kernels import flashattn, quant8
    return {**quant8.LAUNCHES, **flashattn.LAUNCHES}


def train_phase(torch, label, cfg, comm, *, steps, dp_only, expect):
    from repro_torch.launch import train as train_lib
    phase(f"train {label}: dp_only={dp_only} wire={comm.wire} "
          f"ef={comm.error_feedback} microbatches={comm.accum_steps}")
    batch, seq = 8, 2048
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    recs = train_lib.train(cfg, comm, steps=steps, batch=batch, seq=seq,
                           lr=3e-4, optimizer="adamw", dp_only=dp_only,
                           seed=0, device="cuda")
    torch.cuda.synchronize()
    launches = read_launches()
    peak = torch.cuda.max_memory_allocated()
    for rec in recs:
        log(f"  step {rec.step} loss {rec.loss:.4f} gnorm {rec.grad_norm:.4f} "
            f"step_s {rec.seconds:.3f} tok/s {batch * seq / rec.seconds:.0f}")
    steady = [r.seconds for r in recs[1:]] or [recs[0].seconds]
    step_s = sum(steady) / len(steady)
    log(f"  launches {launches}")
    log(f"  peak_memory_allocated {peak} B ({peak / 2**30:.2f} GiB); "
        f"steady step {step_s:.3f} s, {batch * seq / step_s:.0f} tok/s")
    check(all(math.isfinite(r.loss) for r in recs), f"{label}: non-finite loss")
    check(launches == expect, f"{label}: launches {launches} != {expect}")
    return launches, {"step_s": step_s, "first_step_s": recs[0].seconds,
                      "tokens_per_s": batch * seq / step_s,
                      "peak_bytes": peak, "losses": [r.loss for r in recs]}


def serve_phase(torch, model, params, label, *, batch, prompt_len, n_new,
                repeat=1, **engine_kw):
    """One serve cell through Engine.generate at full yi-6b; `repeat` runs
    it that many times on the same prompts (the greedy tokens must agree).
    Then one prefill and one decode step on the same prompts check that the
    logits are finite."""
    from repro_torch.models.transformer import Batch
    from repro_torch.serve.engine import Engine, EngineConfig
    phase(f"serve {label}: batch {batch}, prompt {prompt_len}, {n_new} new "
          f"tokens, {engine_kw or 'native cache'}")
    eng = Engine(model, params, EngineConfig(
        max_seq=prompt_len + n_new + 8, **engine_kw))
    prompts = np.random.default_rng(0).integers(
        0, model.cfg.vocab, (batch, prompt_len)).astype(np.int32)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    runs = []
    for _ in range(repeat):
        t = {}
        toks = eng.generate(prompts, n_new, timings=t)
        runs.append((toks, t))
    logits, cache, pos = model.prefill(
        params, Batch(tokens=torch.as_tensor(prompts, device=eng.device)),
        eng.cfg.max_seq, **eng.ctx_kw)
    step, _ = model.decode_step(params, cache, torch.as_tensor(
        runs[0][0][:, :1], device=eng.device), pos, **eng.ctx_kw)
    torch.cuda.synchronize()
    launches = read_launches()
    peak = torch.cuda.max_memory_allocated()
    del cache
    prefills = repeat + 1
    log(f"  launches {launches} over {prefills} prefills")
    check(launches["flash_attention"] == N_LAYERS * prefills,
          f"serve {label}: {launches['flash_attention']} flash launches, "
          f"expected {N_LAYERS} per prefill")
    check(bool(torch.isfinite(logits).all()) and
          bool(torch.isfinite(step).all()), f"serve {label}: logits not finite")
    for toks, _ in runs:
        check(toks.shape == (batch, n_new) and bool((toks >= 0).all())
              and bool((toks < model.cfg.vocab).all()),
              f"serve {label}: tokens outside the vocabulary")
        check(np.array_equal(toks, runs[0][0]),
              f"serve {label}: two greedy runs gave different tokens")
    out = []
    for toks, t in runs:
        steady = t["decode_s"][1:] or t["decode_s"]
        step_s = sum(steady) / len(steady)
        rec = {"prefill_s": t["prefill_s"],
               "prefill_tok_s": batch * prompt_len / t["prefill_s"],
               "ttft_s": t["first_token_s"], "decode_step_s": step_s,
               "decode_tok_s": batch / step_s}
        log("  " + "  ".join(f"{k} {v:.6g}" for k, v in rec.items()))
        out.append(rec)
    log(f"  peak_memory_allocated {peak} B ({peak / 2**30:.2f} GiB)")
    return launches, {"batch": batch, "prompt_len": prompt_len,
                      "new_tokens": n_new, "runs": out, "peak_bytes": peak}


def cli_phase(torch):
    from repro_torch.configs import registry
    from repro_torch.core import planner as pl
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.launch import serve as serve_lib
    from repro_torch.launch import train as train_lib
    from repro_torch.models.transformer import Model
    from repro_torch.train import trainer as tr
    phase("cli: python -m repro_torch.launch.train (smoke config)")
    steps = 2
    comm = tr.CommConfig(wire="int8", error_feedback=True)
    mesh = mesh_lib.make_host_mesh(1, 1)
    cfg = registry.get_smoke_config("yi-6b")
    plan = tr.make_comm_engine(Model(cfg), mesh, pl.Planner(mesh=mesh),
                               comm).plan
    n_fused = sum(plan.fusable)
    reset_launches()
    rc = train_lib.main(["--arch", "yi-6b", "--comm", "mlsl", "--wire", "int8",
                         "--error-feedback", "--steps", str(steps),
                         "--log-every", "1"])
    torch.cuda.synchronize()
    launches = read_launches()
    log(f"  launches {launches}")
    expect = {"quantize_blocks": 0, "quantize_ef_blocks": n_fused * steps,
              "dequantize_blocks": n_fused * steps,
              "dequantize_accumulate_blocks": 0, "flash_attention": 0}
    check(rc == 0 and launches == expect,
          f"cli: rc={rc} launches {launches} != {expect}")
    phase("cli: python -m repro_torch.launch.serve (smoke config)")
    reset_launches()
    rc = serve_lib.main(["--arch", "yi-6b", "--batch", "4", "--prompt-len",
                         "32", "--new-tokens", "8"])
    torch.cuda.synchronize()
    served = read_launches()
    log(f"  launches {served}")
    check(rc == 0 and served["flash_attention"] == cfg.n_layers,
          f"cli serve: rc={rc} launches {served}, expected "
          f"{cfg.n_layers} flash launches (one prefill)")
    return {k: launches[k] + served[k] for k in launches}


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script needs a GPU",
              file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(
        __file__)), "src"))
    import torch.distributed as dist
    from repro_torch.configs import registry
    from repro_torch.models.transformer import Model
    from repro_torch.train import trainer as tr

    t_start = time.perf_counter()
    name, count, smi = device_phase(torch)
    build_phase()
    results = kernels_phase(torch)
    results["flash_attention"] = flash_phase(torch)
    model_phase(torch)

    cfg = dataclasses.replace(registry.get_config("yi-6b"), n_layers=4)
    zero = dict.fromkeys(KERNELS, 0)
    totals = dict(zero)
    runs = {}
    for label, comm, steps, dp_only, expect in (
            ("A", tr.CommConfig(wire="int8", error_feedback=True,
                                accum_steps=2), 3, False,
             {**zero, "quantize_ef_blocks": 12,
              "dequantize_accumulate_blocks": 12}),
            ("B", tr.CommConfig(wire="int8", error_feedback=True,
                                accum_steps=2), 3, True,
             {**zero, "quantize_ef_blocks": 66,
              "dequantize_accumulate_blocks": 66}),
            ("C", tr.CommConfig(wire="int8"), 2, True,
             {**zero, "quantize_blocks": 22, "dequantize_blocks": 22})):
        launches, runs[label] = train_phase(torch, label, cfg, comm,
                                            steps=steps, dp_only=dp_only,
                                            expect=expect)
        for k, v in launches.items():
            totals[k] += v
    check(totals["flash_attention"] == 0,
          "the train step launched the flash kernel")
    serve = {}
    model = Model(registry.get_config("yi-6b"))
    check(model.cfg.n_layers == N_LAYERS, "yi-6b is not 32 layers deep")
    params = model.init(torch.Generator(device="cuda").manual_seed(0), "cuda")
    log(f"yi-6b: {model.n_params():,} parameters on the card")
    for label, kw in (
            ("S-A", dict(batch=8, prompt_len=2048, n_new=64, repeat=2)),
            ("S-B", dict(batch=1, prompt_len=8192, n_new=32,
                         long_context=True)),
            ("S-C", dict(batch=8, prompt_len=2048, n_new=64,
                         kv_dtype="int8"))):
        launches, serve[label] = serve_phase(torch, model, params, label,
                                             **kw)
        for k, v in launches.items():
            totals[k] += v
    del model, params
    torch.cuda.empty_cache()
    for k, v in cli_phase(torch).items():
        totals[k] += v
    check(all(v > 0 for v in totals.values()),
          f"a kernel was never launched on the main path: {totals}")
    if dist.is_initialized():
        dist.destroy_process_group()

    phase("report")
    log("train " + json.dumps(runs))
    print("serve " + json.dumps(serve), flush=True)
    log(f"total_s {time.perf_counter() - t_start:.1f}")
    kernels = [{"name": k, "route": "cuda",
                "source": SOURCES["flashattn" if k == "flash_attention"
                                  else "quant8"],
                "replaces": KERNELS[k], "launches": totals[k],
                "max_abs_err": results[k]["max_abs_err"],
                "ms": results[k]["ms"], "plain_ms": results[k]["plain_ms"],
                "bound_ms": results[k]["bound_ms"],
                "bound_by": results[k]["bound_by"],
                "library_ms": results[k]["library_ms"]}
               for k in KERNELS]
    print(smi, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": count}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
