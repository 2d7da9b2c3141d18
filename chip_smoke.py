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
                 keys' scores zeroed must fail it; the per-kernel counts
                 must show S-A and S-B on the Hopper kernel (`wgmma_bf16`)
                 and the ragged case on the FMA kernel. Times kernel, plain
                 version and the one PyTorch call that computes the same
                 function (`torch.mul`, `torch.addcmul` for the dequantize
                 kernels, `scaled_dot_product_attention` for flash, at S-B
                 with a boolean causal-and-window mask; no single call
                 quantizes) with CUDA events, and prints each flash time's
                 share of its bound and its ratio to the library call;
  4. model    -- the smoke model on the card against the CPU, same weights:
                 loss and gradients (loss rtol 1e-5, gradients 1e-4 of their
                 norm), prefill logits and one decode step (atol 1e-4, f32);
                 and the tensor-parallel f/g Functions (tp_replicate with
                 tp_psum, and with tp_psum_scatter) on bf16 CUDA tensors
                 over the one-rank NCCL "local" group of make_hier_mesh(1,
                 1), forward and backward: bitwise the dense computation;
  5-7. train  -- the train step of yi-6b at full width cut to 4 layers
                 (global batch 8, seq 2048, AdamW, warmup-cosine), mlsl
                 int8: A, the default planner, error feedback, 2
                 microbatches, 3 steps; B, the same with
                 Planner(dp_only=True); C, dp_only, int8 without error
                 feedback, 1 microbatch, 2 steps; D, B on the two-level
                 route (hier, on make_hier_mesh(1, 1): every bucket routes
                 two-level); E, the gspmd baseline (default planner, 1
                 microbatch, 2 steps, no kernel). Each checks finite losses
                 and its kernels' launch counts (flash attention: none, the
                 train forward records autograd);
  8. serve    -- full yi-6b (32 layers, bf16, random weights from a seed)
                 through `Engine.generate`: S-A batch 8, prompt 2048, 64 new
                 tokens, greedy (run twice: equal tokens); S-B long context
                 (window 4096), batch 1, prompt 8192, 32 new tokens; S-C as
                 S-A with the int8 KV cache. Each checks 32 flash launches
                 per prefill, all on the Hopper kernel, finite prefill and
                 decode logits and tokens in the vocabulary, and prints
                 prefill, first-token and decode times and peak memory;
  9. train F  -- A-E's configuration under the hybrid planner
                 (make_hybrid_planner on make_hier_mesh(1, 1)), int8
                 without error feedback, 2 microbatches, 3 steps: at tp = 1
                 the C2C chooser sends every layer data-parallel, so F is
                 the hybrid machinery's data-parallel fallback (split
                 reduce groups of one rank, the sharded-norm clip, local
                 optimizer state) on D's two-level route. It runs after
                 the serve cells, so that the serve cells start from the
                 state the train cells A-E leave, as before F existed;
 10. obs train -- cell B's configuration (dp_only, int8 + EF, 2
                 microbatches, 3 steps) through `train()` with every
                 observability hook: a StepMeter, a TraceWriter, a
                 TelemetryWriter sampling the bucket replay after every
                 step and a HealthMonitor, then one more replay of 3
                 iterations for the measured column of `CommStats.table()`.
                 Checks 11 rows with finite positive measured seconds, a
                 trace and a telemetry stream that validate, and the quant8
                 launches: the train steps' plus exactly one
                 `quantize_ef_blocks` and one `dequantize_blocks` per bucket
                 per replay; prints the steady step beside B's;
 11. obs serve -- S-A through `Engine(meter=, tracer=)` (one prefill span
                 and a span per decode step in a trace that validates, 32
                 flash launches), then a `torch.profiler` window over 4
                 decode steps of S-A: per step, the host time to issue it
                 (with and without the profiler), the summed CUDA kernel
                 time and the kernel launches;
 12. cli      -- `repro_torch.launch.train.main` and
                 `repro_torch.launch.serve.main` (ragged prompts through
                 `serve_requests`) on the smoke config: the flat mlsl int8
                 run, the verify command's twin (`--hier --nodes 1 --local
                 1`), `--topo xeon-shm-10gbe` with 2 microbatches (every
                 bucket routes flat at one node), the `--hybrid --nodes 1
                 --local-size 1 --comm mlsl --wire int8` twin (its plan
                 lines, every bucket two-level), and the default gspmd
                 with LAMB and `--ckpt-dir`, whose checkpoint must restore
                 bit for bit; then the observability flags: the train CLI
                 with `--stats --trace --telemetry --telemetry-sample 1`
                 (files validate; launches are the steps' plus one quantize
                 and one dequantize per fusable bucket per replay) and the
                 serve CLI with `--stats --trace`;
 13. report   -- the serve cells' numbers, one JSON line with every kernel,
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


def _window_mask(torch, s, window, dev):
    """The boolean causal-and-window mask (True: attend) of a (s, s) score
    matrix, for `scaled_dot_product_attention`'s attn_mask."""
    i = torch.arange(s, device=dev)[:, None]
    j = torch.arange(s, device=dev)[None, :]
    return (j <= i) & (j > i - window)


def flash_phase(torch):
    """Both wrappers against the plain version at the three shapes: the
    main path's `gqa_flash_attention` on (B, S, H, D) q and (B, S, KV, D)
    k/v, and the reference's layout `flash_attention` on the transposed
    copies with the KV heads repeated. q, k and v are standard normal, so
    the scores q.k/sqrt(D) have a standard deviation of 1. A control (the
    plain version with the scores of 64 keys set to 0) must fall outside
    the tolerance. The per-kernel counts must show S-A and S-B on the
    Hopper kernel (`wgmma_bf16`) and the ragged f32 case on the FMA kernel.
    Times at every shape, with the bound's share and the ratio to
    `scaled_dot_product_attention` (S-A: is_causal; S-B: a boolean causal-
    and-window mask); S-A's go into the report."""
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
        flashattn.reset_launches()
        outs = {"gqa_flash_attention":
                flashattn.gqa_flash_attention(q, k, v, **kw).transpose(1, 2),
                "flash_attention": flashattn.flash_attention(qt, kt, vt, **kw)}
        torch.cuda.synchronize()
        variant = "fma_f32" if label == "ragged" else "wgmma_bf16"
        variants = dict(flashattn.VARIANT_LAUNCHES)
        log(f"  {label}: launches per kernel {variants}")
        check(variants == {**dict.fromkeys(flashattn.VARIANTS, 0), variant: 2},
              f"flash {label}: launched {variants}, expected 2 of {variant}")
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
        del outs, k_ctrl
        library = None
        if label == "S-A":
            def library():
                return torch.nn.functional.scaled_dot_product_attention(
                    qt, kt, vt, is_causal=True)
        elif label == "S-B":
            mask = _window_mask(torch, S, window, dev)

            def library():
                return torch.nn.functional.scaled_dot_product_attention(
                    qt, kt, vt, attn_mask=mask)
        if library is not None:
            # the yardstick computes the same function: its agreement with
            # the plain version, for the record
            lib_excess = flash_excess(torch, library()[:, :heads], plain, tol)
            log(f"  library {label:6s} {lib_excess:.3f} of the tolerance on "
                f"{heads} heads")
        del plain
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
        library_ms = None if library is None else _time_ms(torch, library,
                                                           iters)
        lib = ("null" if library_ms is None else
               f"{library_ms:.4f} ms (kernel / library "
               f"{ms / library_ms:.3f})")
        log(f"  flash {label:6s} {variant} gqa_flash_attention {ms:.4f} ms, "
            f"flash_attention {public_ms:.4f} ms  bound {bound_ms:.4f} ms "
            f"({bound_by}, {flops} FLOP, {bytes_} B)  share of the bound "
            f"{bound_ms / ms:.1%}  plain {plain_ms:.4f} ms on {heads} heads  "
            f"library {lib}")
        if label == "S-A":
            res.update(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                       bound_by=bound_by, library_ms=library_ms)
        del q, k, v, qt, kt, vt, sub, library
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
    fg_check(torch)


def fg_check(torch):
    """tp_replicate, then a column- and a row-split projection, then
    tp_psum or tp_psum_scatter, over the one-rank NCCL "local" group, on
    bf16 tensors of one microbatch of train F's residual stream (4, 2048,
    4096) through 512 hidden features: output and every gradient must equal
    the dense computation's bit for bit (a collective over one rank is the
    identity)."""
    from repro_torch.core import collectives as cl
    from repro_torch.launch import mesh as mesh_lib
    phase("model: f/g Functions over a one-rank NCCL group")
    group = mesh_lib.make_hier_mesh(1, 1).get_group("local")
    gen = torch.Generator(device="cuda").manual_seed(2)
    x, w1, w2 = (torch.randn(shape, generator=gen, device="cuda")
                 .to(torch.bfloat16)
                 for shape in ((4, 2048, 4096), (4096, 512), (512, 4096)))
    for g_op in (cl.tp_psum, cl.tp_psum_scatter):
        outs = []
        for wrap in (False, True):
            a, b, xx = (t.clone().requires_grad_(True) for t in (w1, w2, x))
            xr = cl.tp_replicate(xx, group) if wrap else xx
            y = torch.relu(xr @ a) @ b
            if wrap:
                y = g_op(y, group)
            loss = y.float().square().sum()
            outs.append([y.detach(), *torch.autograd.grad(loss, (a, b, xx))])
        same = [torch.equal(got, want) for got, want in zip(*reversed(outs))]
        log(f"  tp_replicate + {g_op.__name__}: output, dw1, dw2, dx "
            f"bitwise the dense computation's: {same}")
        check(all(same), f"f/g: {g_op.__name__} is not the identity over "
                         f"one rank")


# --------------------------------------------------------------------------
# 5-10. the main path
# --------------------------------------------------------------------------

def reset_launches():
    from repro_torch.kernels import flashattn, quant8
    quant8.reset_launches()
    flashattn.reset_launches()


def read_launches():
    from repro_torch.kernels import flashattn, quant8
    return {**quant8.LAUNCHES, **flashattn.LAUNCHES}


def train_phase(torch, label, cfg, comm, *, steps, dp_only, expect,
                planner=None):
    from repro_torch.launch import train as train_lib
    phase(f"train {label}: mode={comm.mode} hier={comm.hier} "
          f"dp_only={dp_only} hybrid={planner is not None} wire={comm.wire} "
          f"ef={comm.error_feedback} microbatches={comm.accum_steps}")
    batch, seq = 8, 2048
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    recs, _ = train_lib.train(cfg, comm, steps=steps, batch=batch, seq=seq,
                              lr=3e-4, optimizer="adamw", dp_only=dp_only,
                              seed=0, device="cuda",
                              mesh=None if planner is None else planner.mesh,
                              planner=planner)
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


def check_hier_plan(cfg, comm):
    """Train D's plan on make_hier_mesh(1, 1) under dp_only: 11 fused
    buckets, every one on the two-level route, with bf16 intra legs."""
    from repro_torch.core import planner as pl
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.models.transformer import Model
    from repro_torch.train import trainer as tr
    mesh = mesh_lib.make_hier_mesh(1, 1)
    plan = tr.make_comm_engine(Model(cfg), mesh,
                               pl.Planner(mesh=mesh, dp_only=True),
                               comm).plan
    log(f"  hier plan: {plan.n_buckets} buckets, routes {set(plan.algos)}, "
        f"wire_intra {plan.hier_spec.wire_intra}")
    check(plan.n_buckets == 11 and all(plan.fusable)
          and set(plan.algos) == {pl.ALGO_HIER},
          f"train D: plan {plan.algos} {plan.fusable}")


def hybrid_planner(cfg, comm, *, batch, seq, n_buckets):
    """The hybrid planner on make_hier_mesh(1, 1), its plan lines, and the
    checks of its plan at tp = 1: every layer chooser-data, `n_buckets`
    fused buckets, each reducing over ("node", "local") on the two-level
    route."""
    from repro_torch.core import planner as pl
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.launch import train as train_lib
    from repro_torch.models.transformer import Model
    from repro_torch.train import trainer as tr
    mesh = mesh_lib.make_hier_mesh(1, 1)
    planner = pl.make_hybrid_planner(mesh, cfg, batch=batch, seq=seq)
    for lp in planner.hybrid.layers:
        log("  " + train_lib.plan_line(lp))
    check({(lp.executed, lp.reason) for lp in planner.hybrid.layers}
          == {("data", "chooser-data")},
          "hybrid: at tp = 1 the chooser must send every layer data-parallel")
    log("  tp = 1: every layer chooser-data; the hybrid machinery runs its "
        "data-parallel fallback")
    plan = tr.make_comm_engine(Model(cfg), mesh, planner, comm).plan
    log(f"  hybrid plan: {plan.n_buckets} buckets, tp_axis {plan.tp_axis} "
        f"tp {plan.tp}, reduce axes {set(plan.bucket_axes)}, routes "
        f"{set(plan.algos)}")
    check(plan.n_buckets == n_buckets and all(plan.fusable)
          and set(plan.algos) == {pl.ALGO_HIER}
          and set(plan.bucket_axes) == {("node", "local")} and plan.tp == 1,
          f"hybrid: plan {plan.algos} {plan.bucket_axes} {plan.fusable}")
    return planner


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
    from repro_torch.kernels import flashattn
    variants = dict(flashattn.VARIANT_LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    del cache
    prefills = repeat + 1
    log(f"  launches {launches} over {prefills} prefills; flash per kernel "
        f"{variants}")
    check(launches["flash_attention"] == N_LAYERS * prefills,
          f"serve {label}: {launches['flash_attention']} flash launches, "
          f"expected {N_LAYERS} per prefill")
    check(variants["wgmma_bf16"] == N_LAYERS * prefills,
          f"serve {label}: flash ran {variants}, expected every launch on "
          f"the Hopper kernel")
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


def _cli_plan(comm, hier: bool):
    """The plan the CLI builds for the smoke config (default planner)."""
    from repro_torch.configs import registry
    from repro_torch.core import planner as pl
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.models.transformer import Model
    from repro_torch.train import trainer as tr
    mesh = (mesh_lib.make_hier_mesh(1, 1) if hier
            else mesh_lib.make_host_mesh(1, 1))
    return tr.make_comm_engine(Model(registry.get_smoke_config("yi-6b")),
                               mesh, pl.Planner(mesh=mesh), comm).plan


def _cli_train(torch, label, argv, expect):
    from repro_torch.launch import train as train_lib
    phase(f"cli: python -m repro_torch.launch.train {label} (smoke config)")
    reset_launches()
    recs, state = train_lib.run(argv + ["--log-every", "1"])
    torch.cuda.synchronize()
    launches = read_launches()
    log(f"  launches {launches}")
    check(all(math.isfinite(r.loss) for r in recs) and launches == expect,
          f"cli {label}: launches {launches} != {expect}")
    return launches, state


def cli_phase(torch):
    import tempfile
    from repro_torch import tree as tree_lib
    from repro_torch.checkpoint import ckpt
    from repro_torch.configs import registry
    from repro_torch.core import planner as pl
    from repro_torch.launch import serve as serve_lib
    from repro_torch.train import trainer as tr
    zero = dict.fromkeys(KERNELS, 0)
    totals = dict(zero)
    steps = 2
    flat = ["--arch", "yi-6b", "--comm", "mlsl", "--wire", "int8",
            "--error-feedback"]
    # flat mlsl int8 + EF: one quantize_ef + one dequantize per fused bucket
    plan = _cli_plan(tr.CommConfig(mode="mlsl", wire="int8",
                                          error_feedback=True), False)
    n = sum(plan.fusable) * steps
    runs = [("mlsl int8", flat + ["--steps", str(steps)],
             {**zero, "quantize_ef_blocks": n, "dequantize_blocks": n})]
    # the verify command's twin: the two-level route at one rank
    plan = _cli_plan(tr.CommConfig(mode="mlsl", wire="int8",
                                          error_feedback=True, hier=True),
                     True)
    check(set(plan.algos) == {pl.ALGO_HIER}, f"cli hier: {plan.algos}")
    n = sum(plan.fusable) * 3
    runs.append(("--hier (verify twin)",
                 flat + ["--hier", "--nodes", "1", "--local", "1", "--batch",
                         "8", "--seq", "32", "--steps", "3"],
                 {**zero, "quantize_ef_blocks": n, "dequantize_blocks": n}))
    # cost-model routing at one node: every bucket flat, the accumulator in
    # the gather-side dequantize
    plan = _cli_plan(tr.CommConfig(
        mode="mlsl", wire="int8", error_feedback=True, hier=True,
        topo="xeon-shm-10gbe", accum_steps=2), True)
    check(set(plan.algos) == {pl.ALGO_FLAT}, f"cli topo: {plan.algos}")
    n = sum(plan.fusable) * 2 * steps
    runs.append(("--topo xeon-shm-10gbe",
                 flat + ["--hier", "--nodes", "1", "--local", "1", "--topo",
                         "xeon-shm-10gbe", "--microbatches", "2", "--steps",
                         str(steps)],
                 {**zero, "quantize_ef_blocks": n,
                  "dequantize_accumulate_blocks": n}))
    # the --hybrid twin at one rank: every layer chooser-data, every bucket
    # two-level, one quantize and one dequantize per bucket and step
    hybrid_planner(registry.get_smoke_config("yi-6b"),
                   tr.CommConfig(mode="mlsl", wire="int8", hier=True),
                   batch=8, seq=32, n_buckets=6)
    n = 6 * steps
    runs.append(("--hybrid",
                 ["--arch", "yi-6b", "--hybrid", "--nodes", "1",
                  "--local-size", "1", "--comm", "mlsl", "--wire", "int8",
                  "--batch", "8", "--seq", "32", "--steps", str(steps)],
                 {**zero, "quantize_blocks": n, "dequantize_blocks": n}))
    for label, argv, expect in runs:
        launches, _ = _cli_train(torch, label, argv, expect)
        for k, v in launches.items():
            totals[k] += v
    # the default --comm gspmd with LAMB and a checkpoint
    with tempfile.TemporaryDirectory() as ckpt_dir:
        launches, state = _cli_train(
            torch, "gspmd --optimizer lamb --ckpt-dir",
            ["--optimizer", "lamb", "--ckpt-dir", ckpt_dir, "--steps",
             str(steps)], zero)
        back = ckpt.restore(ckpt_dir, {"params": state.params})["params"]
        same = all(a.dtype == b.dtype and torch.equal(a, b) for a, b in
                   zip(tree_lib.leaves(state.params), tree_lib.leaves(back)))
        log(f"  checkpoint step {ckpt.latest_step(ckpt_dir)}, restored "
            f"bitwise: {same}")
        check(same and ckpt.latest_step(ckpt_dir) == steps,
              "cli gspmd: the checkpoint does not restore bit for bit")
    cfg = registry.get_smoke_config("yi-6b")
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
    return {k: totals[k] + served[k] for k in totals}


# --------------------------------------------------------------------------
# 10-11. the observability layer on the main path
# --------------------------------------------------------------------------

# the kernels-only estimate of B's replay (PERF.md §6): quantize-EF +
# dequantize at the 262M-element bucket, scaled to B's 11 buckets
PREDICTED_REPLAY_MS = 6.6


def obs_train_phase(torch, cfg, b_step_s):
    """Cell B through train() with meter, tracer, telemetry (a bucket
    replay after every step) and monitor; then 3 more timed replays for the
    table's measured column. Returns the launches and a record."""
    import tempfile
    from repro_torch.core import planner as pl
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.launch import train as train_lib
    from repro_torch.models.transformer import Model
    from repro_torch.obs import detect, meter as obs_meter, telemetry
    from repro_torch.obs import trace as obs_trace
    from repro_torch.train import trainer as tr
    phase("obs train: cell B with meter, tracer, telemetry (replay every "
          "step) and monitor")
    batch, seq, steps = 8, 2048, 3
    comm = tr.CommConfig(mode="mlsl", wire="int8", error_feedback=True,
                         accum_steps=2)
    mesh = mesh_lib.make_host_mesh(1, 1)
    planner = pl.Planner(mesh=mesh, dp_only=True)
    engine = tr.make_comm_engine(Model(cfg), mesh, planner, comm,
                                 device="cuda")
    n_buckets = engine.plan.n_buckets
    check(n_buckets == 11 and all(engine.plan.fusable),
          f"obs train: plan {engine.plan.fusable}")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    with tempfile.TemporaryDirectory() as tmp:
        meter = obs_meter.StepMeter(tokens_per_step=batch * seq)
        tracer = obs_trace.TraceWriter()
        tel = telemetry.TelemetryWriter(os.path.join(tmp, "telemetry.jsonl"),
                                        run_info={"source": "chip_smoke"},
                                        sample_every=1)
        monitor = detect.HealthMonitor.from_plan(
            engine.plan, config=detect.DetectorConfig.wallclock())
        reset_launches()
        timer = engine.bucket_timer(mesh)
        recs, _ = train_lib.train(
            cfg, comm, steps=steps, batch=batch, seq=seq, lr=3e-4,
            optimizer="adamw", seed=0, device="cuda", mesh=mesh,
            planner=planner, meter=meter, tracer=tracer, telemetry=tel,
            monitor=monitor, timer=timer, sample_every=1)
        measured = timer.sample(iters=3)
        torch.cuda.synchronize()
        launches = read_launches()
        tel.close()
        peak = torch.cuda.max_memory_allocated()
        events = telemetry.load_telemetry(tel.path)
        trace = obs_trace.load_trace(tracer.write(os.path.join(
            tmp, "trace.json")))
    st = engine.stats(measured=measured)
    for line in st.table().splitlines():
        log("  " + line)
    replays = 2 + (steps - 1) + 3      # warm-up + one per step, then 3
    want = dict.fromkeys(KERNELS, 0)
    want.update(quantize_ef_blocks=22 * steps + n_buckets * replays,
                dequantize_accumulate_blocks=22 * steps,
                dequantize_blocks=n_buckets * replays)
    log(f"  launches {launches} (train steps 66 + 66; replays {replays} x "
        f"{n_buckets} buckets)")
    check(launches == want, f"obs train: launches {launches} != {want}")
    check(len(st.buckets) == 11 and all(
        math.isfinite(b.t_measured) and b.t_measured > 0
        for b in st.buckets), "obs train: measured bucket seconds")
    sampled = [e for e in events if e["kind"] == "bucket_times"]
    check([e["kind"] for e in events].count("step") == steps
          and [e["step"] for e in sampled] == list(range(steps)),
          "obs train: telemetry records")
    spans = [e["name"] for e in trace["traceEvents"] if e["ph"] == "X"]
    check(spans == [f"step{i}" for i in range(steps)],
          f"obs train: trace spans {spans}")
    check(all(math.isfinite(r.loss) for r in recs), "obs train: loss")
    steady = sum(r.seconds for r in recs[1:]) / (steps - 1)
    total_ms = st.t_measured_total * 1e3
    log(f"  replay of all 11 buckets {total_ms:.4f} ms (predicted "
        f"{PREDICTED_REPLAY_MS} ms); per sample "
        + ", ".join(f"{sum(e['measured']) * 1e3:.4f}" for e in sampled)
        + " ms")
    log(f"  steady step {steady:.4f} s with the hooks (replays between "
        f"steps) vs cell B {b_step_s:.4f} s in this run; meter EMA "
        f"{meter.step_time:.4f} s, {meter.tokens_per_sec:.0f} tok/s; "
        f"alarms {len(monitor.alarms)}; peak_memory_allocated {peak} B")
    return launches, {
        "step_s": steady, "b_step_s": b_step_s, "replay_ms": total_ms,
        "bucket_ms": [b.t_measured * 1e3 for b in st.buckets],
        "model_us": [b.t_model * 1e6 for b in st.buckets],
        "sample_ms": [sum(e["measured"]) * 1e3 for e in sampled],
        "losses": [r.loss for r in recs], "peak_bytes": peak}


def _kernel_events(prof):
    """(kernel launches, summed kernel microseconds) of a profiler window,
    read from its Chrome trace (the CUDA kernels have cat "kernel")."""
    import tempfile
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "prof.json")
        prof.export_chrome_trace(path)
        with open(path) as fh:
            events = json.load(fh).get("traceEvents", [])
    kernels = [e for e in events if e.get("cat") == "kernel"]
    return len(kernels), sum(float(e.get("dur", 0.0)) for e in kernels)


def obs_serve_phase(torch, model, params):
    """S-A through Engine(meter=, tracer=): a trace with one prefill span
    and a span per decode step; then the decode step of S-A split into host
    issue and device kernel time under torch.profiler."""
    from repro_torch.models.transformer import Batch
    from repro_torch.obs import meter as obs_meter, trace as obs_trace
    from repro_torch.serve.engine import Engine, EngineConfig
    batch, prompt_len, n_new = 8, 2048, 64
    phase("obs serve: S-A with meter and tracer, then a profiler window")
    meter, tracer = obs_meter.StepMeter(), obs_trace.TraceWriter()
    eng = Engine(model, params, EngineConfig(max_seq=prompt_len + n_new + 8),
                 meter=meter, tracer=tracer)
    prompts = np.random.default_rng(0).integers(
        0, model.cfg.vocab, (batch, prompt_len)).astype(np.int32)
    reset_launches()
    toks = eng.generate(prompts, n_new)
    torch.cuda.synchronize()
    launches = read_launches()
    obs_trace.validate_trace(tracer.to_json())
    xs = [e for e in tracer.events if e["ph"] == "X"]
    check([e["name"] for e in xs] == ["prefill"] + [f"decode/{i}" for i in
                                                    range(n_new)],
          "obs serve: trace spans")
    from repro_torch.kernels import flashattn
    check(launches["flash_attention"] == N_LAYERS
          and flashattn.VARIANT_LAUNCHES["wgmma_bf16"] == N_LAYERS,
          f"obs serve: launches {launches}, flash per kernel "
          f"{dict(flashattn.VARIANT_LAUNCHES)}")
    check(toks.shape == (batch, n_new) and bool((toks >= 0).all())
          and bool((toks < model.cfg.vocab).all()), "obs serve: tokens")
    decode_ms = [e["dur"] / 1e3 for e in xs[2:]]
    log(f"  prefill span {xs[0]['dur'] / 1e3:.3f} ms; decode spans after "
        f"the first: mean {sum(decode_ms) / len(decode_ms):.3f} ms, min "
        f"{min(decode_ms):.3f}, max {max(decode_ms):.3f}; meter "
        f"{meter.summary()}")
    # the decode step split: host issue vs device kernel time
    prof_steps = 4
    logits, cache, pos = model.prefill(
        params, Batch(tokens=torch.as_tensor(prompts, device="cuda")),
        eng.cfg.max_seq)
    tok = torch.argmax(logits, dim=-1)

    def step(i):
        nonlocal cache, tok
        t0 = time.perf_counter()
        logits, cache = model.decode_step(params, cache, tok[:, None],
                                          pos + i)
        tok = torch.argmax(logits, dim=-1)
        t1 = time.perf_counter()
        torch.cuda.synchronize()
        return t1 - t0, time.perf_counter() - t0

    bare = [step(i) for i in range(2 + prof_steps)][2:]
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        profiled = [step(2 + prof_steps + i) for i in range(prof_steps)]
    n_kernels, kernel_us = _kernel_events(prof)
    rec = {"issue_ms": [a * 1e3 for a, _ in bare],
           "step_ms": [b * 1e3 for _, b in bare],
           "profiled_issue_ms": [a * 1e3 for a, _ in profiled],
           "profiled_step_ms": [b * 1e3 for _, b in profiled],
           "kernels_per_step": n_kernels / prof_steps,
           "kernel_ms_per_step": kernel_us / 1e3 / prof_steps}
    log(f"  decode step (no profiler, {prof_steps} steps): host issue "
        + ", ".join(f"{v:.3f}" for v in rec["issue_ms"]) + " ms; to the "
        "synchronized token " + ", ".join(f"{v:.3f}" for v in rec["step_ms"])
        + " ms")
    log(f"  decode step (profiler, {prof_steps} steps): host issue "
        + ", ".join(f"{v:.3f}" for v in rec["profiled_issue_ms"])
        + " ms; step " + ", ".join(f"{v:.3f}" for v in
                                   rec["profiled_step_ms"]) + " ms")
    if n_kernels:
        busy = rec["kernel_ms_per_step"] / (
            sum(rec["profiled_step_ms"]) / prof_steps)
        log(f"  per decode step: {rec['kernels_per_step']:.1f} CUDA kernel "
            f"launches, {rec['kernel_ms_per_step']:.3f} ms of summed kernel "
            f"time; device busy {busy:.1%} of the profiled step")
    else:
        log("  the profiler recorded no CUDA kernel: no device split")
    del cache, logits
    return launches, rec


def cli_obs_phase(torch):
    """The train CLI with --stats --trace --telemetry --telemetry-sample 1
    and the serve CLI with --stats --trace, on the smoke config."""
    import tempfile
    from repro_torch.configs import registry
    from repro_torch.launch import serve as serve_lib
    from repro_torch.obs import telemetry, trace as obs_trace
    from repro_torch.train import trainer as tr
    zero = dict.fromkeys(KERNELS, 0)
    steps = 2
    plan = _cli_plan(tr.CommConfig(mode="mlsl", wire="int8",
                                   error_feedback=True), False)
    n_f = sum(plan.fusable)
    # replays: the telemetry samples (a warm-up + one per step) and the
    # --stats table's (a warm-up + 2)
    n = n_f * (steps + (1 + steps) + 3)
    with tempfile.TemporaryDirectory() as tmp:
        os.environ["BENCH_DIR"] = tmp
        d = os.path.join(tmp, "obs")
        launches, _ = _cli_train(
            torch, "--stats --trace --telemetry --telemetry-sample 1",
            ["--arch", "yi-6b", "--comm", "mlsl", "--wire", "int8",
             "--error-feedback", "--steps", str(steps), "--stats", "--trace",
             d, "--telemetry", d, "--telemetry-sample", "1"],
            {**zero, "quantize_ef_blocks": n, "dequantize_blocks": n})
        tr_ = obs_trace.load_trace(os.path.join(d, "trace.json"))
        events = telemetry.load_telemetry(os.path.join(d, "telemetry.jsonl"))
        check([e["step"] for e in events if e["kind"] == "bucket_times"]
              == list(range(steps)), "cli obs: telemetry samples")
        check(os.path.exists(os.path.join(
            tmp, "BENCH_torch_comm_stats.json")), "cli obs: no ledger")
        log(f"  trace {len(tr_['traceEvents'])} events, telemetry "
            f"{len(events)} records, ledger BENCH_torch_comm_stats.json")
        phase("cli: python -m repro_torch.launch.serve --stats --trace "
              "(smoke config)")
        cfg = registry.get_smoke_config("yi-6b")
        reset_launches()
        rc = serve_lib.main(["--arch", "yi-6b", "--batch", "4",
                             "--prompt-len", "32", "--new-tokens", "8",
                             "--stats", "--trace", d])
        torch.cuda.synchronize()
        served = read_launches()
        names = [e["name"] for e in obs_trace.load_trace(os.path.join(
            d, "trace.json"))["traceEvents"] if e["ph"] == "X"]
        log(f"  launches {served}; spans {names[:3]}... ({len(names)})")
        check(rc == 0 and served["flash_attention"] == cfg.n_layers
              and names == ["prefill"] + [f"decode/{i}" for i in range(8)],
              f"cli serve obs: rc={rc} launches {served}")
    del os.environ["BENCH_DIR"]
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
            ("A", tr.CommConfig(mode="mlsl", wire="int8",
                                error_feedback=True, accum_steps=2), 3, False,
             {**zero, "quantize_ef_blocks": 12,
              "dequantize_accumulate_blocks": 12}),
            ("B", tr.CommConfig(mode="mlsl", wire="int8",
                                error_feedback=True, accum_steps=2), 3, True,
             {**zero, "quantize_ef_blocks": 66,
              "dequantize_accumulate_blocks": 66}),
            ("C", tr.CommConfig(mode="mlsl", wire="int8"), 2, True,
             {**zero, "quantize_blocks": 22, "dequantize_blocks": 22}),
            # the two-level route: 11 buckets x 2 microbatches x 3 steps,
            # the accumulator added after the bf16 all-gather
            ("D", tr.CommConfig(mode="mlsl", wire="int8",
                                error_feedback=True, accum_steps=2,
                                hier=True), 3, True,
             {**zero, "quantize_ef_blocks": 66, "dequantize_blocks": 66}),
            ("E", tr.CommConfig(mode="gspmd"), 2, False, zero)):
        if comm.hier:
            check_hier_plan(cfg, comm)
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
    launches, serve["obs S-A"] = obs_serve_phase(torch, model, params)
    for k, v in launches.items():
        totals[k] += v
    del model, params
    torch.cuda.empty_cache()
    # the hybrid planner at tp = 1: D's route without error feedback, 11
    # buckets x 2 microbatches x 3 steps
    comm = tr.CommConfig(mode="mlsl", wire="int8", accum_steps=2, hier=True)
    launches, runs["F"] = train_phase(
        torch, "F", cfg, comm, steps=3, dp_only=False,
        expect={**zero, "quantize_blocks": 66, "dequantize_blocks": 66},
        planner=hybrid_planner(cfg, comm, batch=8, seq=2048, n_buckets=11))
    for k, v in launches.items():
        totals[k] += v
    check(launches["flash_attention"] == 0,
          "the train step launched the flash kernel")
    launches, runs["obs B"] = obs_train_phase(torch, cfg, runs["B"]["step_s"])
    for k, v in launches.items():
        totals[k] += v
    for k, v in cli_phase(torch).items():
        totals[k] += v
    for k, v in cli_obs_phase(torch).items():
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
