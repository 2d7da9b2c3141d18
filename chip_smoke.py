#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (src/repro_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each fatal on failure:

  1. device   -- CUDA must be present; prints the card's name, the device
                 count and `nvidia-smi`'s name and power limit;
  2. build    -- compiles the CUDA kernels from src/repro_torch/kernels/csrc
                 with nvcc and prints ptxas's register/spill lines;
  3. kernels  -- each kernel against its plain PyTorch version on the card,
                 at the main path's bucket shapes (the 262,144,000-element
                 embedding bucket, the 180,355,072-element MLP bucket and the
                 32,768-element norm bucket of yi-6b, as (n/512, 512) rows),
                 with bf16 and f32 inputs, zero rows, an inf row and a NaN
                 row. Tolerance: bitwise on the finite rows (the kernels are
                 built without FMA contraction); equal scales and an all-NaN
                 residual on the inf row. Times kernel, plain version and,
                 for the two dequantize kernels, the one PyTorch call that
                 computes the same function (`torch.mul`, `torch.addcmul`;
                 no single call quantizes) with CUDA events;
  4. model    -- the smoke model's loss and gradients on the card against
                 the CPU, same weights (loss rtol 1e-5, gradients 1e-4 of
                 their norm);
  5-7. train  -- the mlsl int8 train step of yi-6b at full width cut to 4
                 layers (global batch 8, seq 2048, AdamW, warmup-cosine):
                 A, the default planner, error feedback, 2 microbatches, 3
                 steps; B, the same with Planner(dp_only=True); C, dp_only,
                 int8 without error feedback, 1 microbatch, 2 steps. Each
                 checks finite losses and its kernels' launch counts;
  8. cli      -- `repro_torch.launch.train.main` on the smoke config;
  9. report   -- one JSON line with every kernel, then the device line.

Exits non-zero without the result line when CUDA is absent or any phase
fails. Needs one card and no network.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import subprocess
import sys
import time

HBM_BYTES_PER_S = 3.35e12       # H100 SXM device memory (NVIDIA data sheet)
F32_OPS_PER_S = 67e12           # H100 SXM f32 outside the tensor cores
BLOCK = 512
BUCKETS = {"embed": 262_144_000, "mlp_w1": 180_355_072, "norm": 32_768}
SOURCE = "src/repro_torch/kernels/csrc/quant8.cu"
KERNELS = {   # wrapper -> the TPU kernel it replaces (file:line)
    "quantize_blocks": "src/repro/kernels/quant8.py:43",
    "quantize_ef_blocks": "src/repro/kernels/quant8.py:57",
    "dequantize_blocks": "src/repro/kernels/quant8.py:77",
    "dequantize_accumulate_blocks": "src/repro/kernels/quant8.py:83",
}
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
    path, out = _build.build("quant8")
    log(f"built {path.name} in {time.perf_counter() - t0:.2f}s")
    for line in out.splitlines():
        if any(k in line for k in ("registers", "spill", "smem", "Compiling")):
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
    results = {k: {"max_abs_err": 0.0} for k in KERNELS}

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


# --------------------------------------------------------------------------
# 4. the model on the card against the CPU
# --------------------------------------------------------------------------

def model_phase(torch):
    """The yi-6b smoke model's loss and gradients on the card against the
    same computation on the CPU (which tests/test_torch_model.py holds to
    the JAX reference), on the same weights and batch, in f32. Tolerance:
    loss rtol 1e-5, each gradient within 1e-4 of its norm (the sums are
    taken in another order; TF32 is off for matmuls by default)."""
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
        out[dev] = (float(loss.detach()), [g.cpu() for g in grads])
    (l_cpu, g_cpu), (l_gpu, g_gpu) = out["cpu"], out["cuda"]
    worst = max(float((a - b).abs().max() / a.norm())
                for a, b in zip(g_cpu, g_gpu))
    log(f"  loss cpu {l_cpu:.7f} cuda {l_gpu:.7f}; worst gradient error "
        f"{worst:.3e} of its norm")
    check(math.isclose(l_gpu, l_cpu, rel_tol=1e-5), "model: loss differs")
    check(worst <= 1e-4, "model: gradients differ")


# --------------------------------------------------------------------------
# 5-8. the main path
# --------------------------------------------------------------------------

def train_phase(torch, label, cfg, comm, *, steps, dp_only, expect):
    from repro_torch.kernels import quant8
    from repro_torch.launch import train as train_lib
    phase(f"train {label}: dp_only={dp_only} wire={comm.wire} "
          f"ef={comm.error_feedback} microbatches={comm.accum_steps}")
    batch, seq = 8, 2048
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    quant8.reset_launches()
    recs = train_lib.train(cfg, comm, steps=steps, batch=batch, seq=seq,
                           lr=3e-4, optimizer="adamw", dp_only=dp_only,
                           seed=0, device="cuda")
    torch.cuda.synchronize()
    launches = dict(quant8.LAUNCHES)
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


def cli_phase(torch):
    from repro_torch.configs import registry
    from repro_torch.core import planner as pl
    from repro_torch.kernels import quant8
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.launch import train as train_lib
    from repro_torch.models.transformer import Model
    from repro_torch.train import trainer as tr
    phase("cli: python -m repro_torch.launch.train (smoke config)")
    steps = 2
    comm = tr.CommConfig(wire="int8", error_feedback=True)
    mesh = mesh_lib.make_host_mesh(1, 1)
    plan = tr.make_comm_engine(Model(registry.get_smoke_config("yi-6b")),
                               mesh, pl.Planner(mesh=mesh), comm).plan
    n_fused = sum(plan.fusable)
    quant8.reset_launches()
    rc = train_lib.main(["--arch", "yi-6b", "--comm", "mlsl", "--wire", "int8",
                         "--error-feedback", "--steps", str(steps),
                         "--log-every", "1"])
    torch.cuda.synchronize()
    launches = dict(quant8.LAUNCHES)
    log(f"  launches {launches}")
    expect = {"quantize_blocks": 0, "quantize_ef_blocks": n_fused * steps,
              "dequantize_blocks": n_fused * steps,
              "dequantize_accumulate_blocks": 0}
    check(rc == 0 and launches == expect,
          f"cli: rc={rc} launches {launches} != {expect}")
    return launches


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
    from repro_torch.train import trainer as tr

    t_start = time.perf_counter()
    name, count, smi = device_phase(torch)
    build_phase()
    results = kernels_phase(torch)
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
    for k, v in cli_phase(torch).items():
        totals[k] += v
    check(all(v > 0 for v in totals.values()),
          f"a kernel was never launched on the main path: {totals}")
    if dist.is_initialized():
        dist.destroy_process_group()

    phase("report")
    log("train " + json.dumps(runs))
    log(f"total_s {time.perf_counter() - t_start:.1f}")
    kernels = [{"name": k, "route": "cuda", "source": SOURCE,
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
