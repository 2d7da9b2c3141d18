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
                 heads would take 8.6 GB), a ragged f32 case (2, 1000,
                 3 on 1, 32) causal window 100 and its bf16 twin (the
                 mma.sync kernel, `mma_bf16`, which no served model
                 reaches), and the attention family's prefill:
                 whisper-small's encoder W-enc (16, 1500, 12 on 12, 64)
                 bf16 non-causal, its decoder's self-attention W-dec (16,
                 32, 12 on 12, 64) causal on serve cell W-A's 32-token
                 prompt and its cross-attention W-cross (those 32 queries
                 on 1500 keys) non-causal, all three on the Hopper kernel
                 at D 64, llava's V-A (8, 2048, 32 on 8, 128) bf16 causal
                 window 4096, and recurrentgemma-2b's local attention at
                 D 256 on the prefill of R-A (8, 2048, 10 on 1, 256) and
                 R-B (1, 8192, 10 on 1, 256), bf16 causal window 2048,
                 and the MoE family's prefill at D 128 bf16 causal:
                 grok-1's G-A (8, 2048, 48 on 8) and arctic's AR-A (8,
                 2048, 56 on 8);
                 both wrappers, the model's (B, S, H, D) layout with
                 KV heads read through strides and the reference's (B, H,
                 S, D) with heads repeated; scores of
                 standard deviation 1. Tolerance (FLASH_TOL), per element,
                 rtol |plain| + atol x the RMS of the plain output's row:
                 bf16 1.6e-2 and 2e-2, f32 2e-5 and 2e-5; a control with 64
                 keys' scores zeroed (W-dec: its last 16) must fail it; the
                 per-kernel counts must show S-A, S-B, V-A, W-enc, W-dec,
                 W-cross, R-A, R-B, G-A and AR-A on the Hopper kernel
                 (`wgmma_bf16`),
                 the bf16
                 ragged case on `mma_bf16` and the f32 one on the FMA
                 kernel. Times kernel, plain version
                 and the one PyTorch call that computes the same function
                 (`torch.mul`, `torch.addcmul` for the dequantize kernels,
                 `scaled_dot_product_attention` for flash, with a boolean
                 causal-and-window mask where some row reaches past the
                 window (S-B, R-B, the ragged cases), non-causal at W-enc
                 and W-cross; no single call quantizes) with CUDA events, and
                 prints each flash time's
                 share of its bound and its ratio to the library call, and
                 each flash shape's host issue apart from its kernel: the
                 wrapper's host time per call over calls issued back to
                 back (one synchronize after them) and the kernel's device
                 time per launch from torch.profiler's key_averages, and
                 the same split for the library call (its kernels' device
                 time per call);
  4. model    -- the smoke models of yi-6b, llava-next-mistral-7b,
                 whisper-small, minicpm3-4b, recurrentgemma-2b,
                 mamba2-2.7b, grok-1-314b and arctic-480b (standard-normal
                 patch and frame embeddings) on the card against the CPU,
                 same weights: loss (the MoE routers' aux term included)
                 and gradients (loss rtol 1e-5, gradients 1e-4 of their
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
 10. mp       -- model parallelism (the path of `--model-parallel`) over
                 the one-rank NCCL "model" group of make_host_mesh(1, 1),
                 at yi-6b full width cut to 4 layers, bf16, each held
                 against its dense form on the same inputs: the
                 vocab-parallel cross-entropy on one microbatch's logits
                 (4, 2047, 64000) f32 (loss rtol 1e-6, each gradient
                 element within 1e-5 of the gradient's largest); the
                 embedding lookup split by vocabulary on the (64000, 4096)
                 table (output bitwise; the table's gradient within 1e-2
                 of its largest element: bf16 sums of repeated ids in
                 another order); the gathered-head attention
                 (`gqa_gathered`) of yi-6b and of chatglm3-6b (2 KV heads,
                 half of each head rotated) on (2, 2048, 4096) (output and
                 the gradients of x and the four projections within 1e-2
                 of the dense tensor's largest element); the model's loss
                 (rtol 1e-5) and gradients (each within 1e-4 of its
                 largest element) through the model-parallel forward, in
                 f32, batch 2 x 2048. Then train G: cell A's configuration with
                 `force_model_parallel=True` (the step's collectives over
                 the one-rank model group); its launches must be A's and
                 its losses A's (step 0 rtol 1e-5, then rtol 1e-3);
 11. obs train -- cell B's configuration (dp_only, int8 + EF, 2
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
 12. obs serve -- S-A through `Engine(meter=, tracer=)` (one prefill span
                 and a span per decode step in a trace that validates, 32
                 flash launches), then a `torch.profiler` window over 4
                 decode steps of S-A: per step, the host time to issue it
                 (with and without the profiler), the summed CUDA kernel
                 time and the kernel launches;
 13. cli      -- `repro_torch.launch.train.main` and
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
 14. family serve -- the attention family at full width and depth and the
                 MoE family at full width cut in depth, random weights from
                 a seed, through `Engine.generate`, greedy, 64 new tokens:
                 V-A llava-next-mistral-7b, batch 8 x (576 standard-normal
                 patch embeddings + 1472 tokens); W-A whisper-small, batch
                 16 x 1500 standard-normal frame embeddings, decoder prompt
                 32; M-A minicpm3-4b, batch 8 x 2048; G-A grok-1-314b at 4
                 of 64 layers (8 experts of d_ff 32768, 48 query heads on 8
                 KV heads), batch 8 x 2048, run twice (equal tokens); AR-A
                 arctic-480b at 2 of 35 layers (128 experts of 4864 and the
                 dense residual MLP, 56 heads on 8), batch 8 x 2048. Each
                 checks its flash launches per prefill (32 / 36 / 0 / 4 / 2,
                 all on `wgmma_bf16`), finite logits and tokens in the
                 vocabulary, and prints prefill, first-token and decode
                 times and peak memory; then one prefill and 3 decode steps
                 under torch.profiler: kernels, their summed time against
                 the wall time, the top kernels by time;
 15. train H  -- cell A's configuration on llava-next-mistral-7b at full
                 width cut to 4 layers, 576 zero patch embeddings + 1472
                 tokens per row (the CLI's stub); its plan fuses the norms,
                 `ln_f` and `img_proj`; finite losses and the quant8
                 launches of its 3 fused buckets;
 16. family cli -- the train CLI (mlsl int8 + EF) and the serve CLI on the
                 five smoke configs; the whisper serve CLI (no frame
                 embeddings, as the reference's) must stop with the
                 ValueError naming them;
 17. recurrent serve -- the recurrent family at full width and depth,
                 random weights from a seed, through `Engine.generate`,
                 greedy: R-A recurrentgemma-2b, batch 8 x 2048, 64 new
                 tokens (8 flash launches per prefill, D 256 on
                 `wgmma_bf16`); R-B the same model, batch 1 x 8192, 32 new
                 (the window's tile skipping, the local blocks' rings
                 compacted to 2048 slots); MB-A mamba2-2.7b, batch 8 x
                 2048, 64 new (the chunked SSD, no flash launch). Each
                 checks its launches, the cache's shapes after the prefill,
                 finite logits and tokens in the vocabulary, prints
                 prefill, first-token and decode times and peak memory,
                 and profiles one prefill and 3 decode steps;
 18. train I  -- cell A's configuration on mamba2-2.7b at full width cut to
                 8 layers (seq 2048): its bucket plan, finite losses, the
                 quant8 launches of its fused buckets, autograd through
                 the chunked SSD;
 19. recurrent cli -- the train and serve CLIs on the two smoke configs;
 20. ep       -- `moe_apply_ep` over one-rank NCCL ("data", "model")
                 groups on one grok-1 layer at full width, x (2, 2048,
                 6144) bf16: y and aux bitwise `moe_apply`'s; then with
                 FSDP over the data group, forward and backward on the bf16
                 and the int8 weight-gather wires: quantize_blocks and
                 dequantize_blocks 3 launches each, expert gradients
                 non-zero and within 5% of the bf16 wire's (of the largest
                 element);
 21. session  -- `Session.create(mesh, n_params=, comm=<cell A's>,
                 hbm_budget=<the card's memory>)`: `decide_fsdp` false (1.2
                 B parameters x 14 B under 55% of the card); 3 steps
                 through `sess.make_train_step`: losses bit for bit cell
                 A's and A's quant8 launches; the parameters saved,
                 restored bitwise and served through `Engine.generate`;
 22. fsdp     -- the same model at the reference's default budget (16e9
                 B): `decide_fsdp` true, mlsl refuses it; 3 gspmd steps
                 under FSDP over the one-rank data group (NCCL all-gathers
                 and reduce-scatters, counted) against E's configuration
                 for 3 steps: losses and the gathered parameters bitwise,
                 step time and peak beside E's, the peak within E's plus
                 one gathered repeat;
 23. moe ep block -- one grok-1 layer at full width through `Model.loss`
                 under FSDP, batch 2 x 2048: the moe block's ep branch
                 (`CommConfig(moe_impl="ep")`'s) against its gather
                 branch: with the bf16 weight gather logits, aux and every
                 gradient bitwise; with the int8 one quantize_blocks and
                 dequantize_blocks 3 launches per forward (6 under remat)
                 and expert gradients within 5% of the bf16 gather's;
 24. families mp -- each family at full width over a one-rank NCCL model
                 group (`mp_layout` of `Planner(mesh)`, whose model axis
                 of one rank splits every matrix), forward and backward
                 in bf16 against the same model and weights without a
                 layout: llava at 4 layers (batch 2 x (576 + 1472)),
                 whisper at full depth (2 x 448 tokens on 1500 frames),
                 minicpm3 at 4, recurrentgemma at 3, mamba2 at 8, grok-1
                 and arctic at 1 (2 x 2048 each), the embedding and head
                 replicated (the mp phase holds their vocab-parallel
                 forms): loss rel 1e-5 and every gradient within 1e-2 of
                 its largest element (the mp phase's bf16 bound; bitwise
                 but recurrentgemma); then mamba2 at cell I's
                 configuration
                 under `force_model_parallel` on A's int8 + EF wire (I's
                 quant8 launches), losses within rtol 1e-3 of I's;
 25. dryrun   -- the port's dry-run (`repro_torch.launch.dryrun`: rank
                 0's step on meta tensors over a fake process group, in a
                 child process) for cell A's configuration at world size 1
                 (its predicted parameter, optimizer, gradient and residual
                 bytes must equal cell A's real train state's, summed from
                 its tensors) and S-A's full-depth prefill, printed beside
                 the step, prefill and peaks this run measured: predicted
                 peak and its ratio to the measured one, the roofline's
                 t_compute and t_memory, model FLOPs / step / 989e12; then
                 yi-6b train_4k on pod16x16, grok-1 train_4k on pod2x16x16
                 (its expert buffers at their upper bound: the step sizes
                 them from the routed counts) and mamba2 long_500k, each
                 `ok`;
 26. examples -- examples/train_lm_torch.py (tiny preset, mlsl int8 + EF,
                 20 steps: finite, falling loss) and serve_batched_torch.py
                 (six requests on the mamba2 smoke model) on the card;
 27. report   -- the serve cells' numbers, one JSON line with every kernel
                 (the flash kernel's D-256 instance on a line of its own),
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
# flash_attention shapes (B, Sq, Sk, H, KV, D, dtype, window, causal,
# heads compared, the kernel it must run on): the prefill of serve cells
# S-A and S-B (yi-6b's 32 query heads on 4 KV heads), a ragged case at D 32
# with 3 query heads on one KV head in f32 and in bf16 (the mma.sync
# kernel, which no served model reaches), and the attention family's
# prefill: whisper-small's encoder (W-enc, 1500 frames, non-causal), its
# decoder's causal self-attention on serve cell W-A's 32-token prompt
# (W-dec: a sixth of one 192-row query tile) and its cross-attention
# (W-cross, those 32 queries on the 1500 encoder keys), all at D 64 on the
# Hopper kernel, and llava-next-mistral-7b's (V-A, 32 query heads on 8 KV
# heads, window 4096); then recurrentgemma-2b's local attention at D 256
# (10 query heads on one KV head, window 2048) on the prefill of serve
# cells R-A (8 x 2048: the window hides nothing) and R-B (1 x 8192); then
# the MoE family's causal prefill at D 128 in groups the other cells lack:
# grok-1's 48 query heads on 8 KV heads (G-A, groups of 6) and arctic's 56
# on 8 (AR-A, groups of 7)
FLASH_SHAPES = {
    "S-A": (8, 2048, 2048, 32, 4, 128, "bfloat16", None, True, 32,
            "wgmma_bf16"),
    "S-B": (1, 8192, 8192, 32, 4, 128, "bfloat16", 4096, True, 4,
            "wgmma_bf16"),
    "ragged": (2, 1000, 1000, 3, 1, 32, "float32", 100, True, 3, "fma_f32"),
    "ragged-bf16": (2, 1000, 1000, 3, 1, 32, "bfloat16", 100, True, 3,
                    "mma_bf16"),
    "W-enc": (16, 1500, 1500, 12, 12, 64, "bfloat16", None, False, 12,
              "wgmma_bf16"),
    "W-dec": (16, 32, 32, 12, 12, 64, "bfloat16", None, True, 12,
              "wgmma_bf16"),
    "W-cross": (16, 32, 1500, 12, 12, 64, "bfloat16", None, False, 12,
                "wgmma_bf16"),
    "V-A": (8, 2048, 2048, 32, 8, 128, "bfloat16", 4096, True, 32,
            "wgmma_bf16"),
    "R-A": (8, 2048, 2048, 10, 1, 256, "bfloat16", 2048, True, 10,
            "wgmma_bf16"),
    "R-B": (1, 8192, 8192, 10, 1, 256, "bfloat16", 2048, True, 10,
            "wgmma_bf16"),
    "G-A": (8, 2048, 2048, 48, 8, 128, "bfloat16", None, True, 48,
            "wgmma_bf16"),
    "AR-A": (8, 2048, 2048, 56, 8, 128, "bfloat16", None, True, 56,
             "wgmma_bf16")}
# the shapes whose numbers go into the report's kernel lines: S-A for
# flash_attention, R-A for its D-256 instance
FLASH_REPORTED = {"S-A": "flash_attention", "R-A": "flash_attention[D256]"}
# flash_attention tolerance (rtol, atol as a share of the RMS of the plain
# output's row): |out - plain| <= rtol |plain| + atol rms(row). bf16: both
# sides round the output to bf16 (rtol, two bf16 ulps), and the kernel
# feeds the probabilities to P V in bf16 (an error of about 1e-3 of the
# row's RMS per element, up to 9e-3 on 16 M elements of a CPU emulation;
# atol). f32: summation order and exp differ.
FLASH_TOL = {"bfloat16": (1.6e-2, 2e-2), "float32": (2e-5, 2e-5)}
# profiler windows `issue_split` may take to record every kernel of one
PROFILER_WINDOWS = 3
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
    # the Hopper flash kernel's instances (registers at launch; setmaxnreg
    # moves them between the producer and the consumers)
    for _, out in built:
        for d, regs, spill in _build.ptxas_usage(out, "flash_fwd_wgmma"):
            log(f"  flash_fwd_wgmma<{d}>: {regs} registers, {spill}")


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


def issue_split(torch, fn, n, kernel=""):
    """fn's host issue apart from its kernels' device time: (host us per
    call, device us per call of the kernels whose name holds `kernel`, their
    launches in n calls). The host time is a host clock over n calls issued
    back to back, with one synchronize after the window; the device time
    comes from torch.profiler's key_averages over n more calls (the trace's
    kernel events where key_averages shows no device time). A profiler
    window can drop kernel records (one S-B window of 10 flash launches
    recorded 7): up to PROFILER_WINDOWS windows are taken, each short one
    logged, and the first with `kernel`'s launch count a multiple of n is
    used (the last otherwise)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    host_s = (time.perf_counter() - t0) / n
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    for attempt in range(PROFILER_WINDOWS):
        with torch.profiler.profile(activities=acts) as prof:
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
        # the device's own rows (an operator's row also sums its kernels'
        # time)
        rows = [e for e in prof.key_averages()
                if e.device_type == torch.autograd.DeviceType.CUDA
                and kernel in e.key]
        dev_us = sum(getattr(e, "device_time_total", 0.0) for e in rows)
        count = sum(e.count for e in rows)
        if dev_us <= 0:
            events = [e for e in _kernels(prof)
                      if kernel in e.get("name", "")]
            dev_us = sum(float(e.get("dur", 0.0)) for e in events)
            count = len(events)
        if count and count % n == 0:
            break
        log(f"  profiler window {attempt + 1}: {count} kernel records for "
            f"{n} calls")
    return host_s * 1e6, dev_us / n, count


def _window_mask(torch, s, window, dev):
    """The boolean causal-and-window mask (True: attend) of a (s, s) score
    matrix, for `scaled_dot_product_attention`'s attn_mask."""
    i = torch.arange(s, device=dev)[:, None]
    j = torch.arange(s, device=dev)[None, :]
    return (j <= i) & (j > i - window)


def flash_phase(torch):
    """Both wrappers against the plain version at every shape of
    FLASH_SHAPES: the main path's `gqa_flash_attention` on (B, Sq, H, D) q
    and (B, Sk, KV, D) k/v, and the reference's layout `flash_attention` on
    the transposed copies with the KV heads repeated. q, k and v are
    standard normal, so the scores q.k/sqrt(D) have a standard deviation of
    1. A control (the plain version with the scores of 64 keys, or of
    keys S/2.. where S < 128, set to 0)
    must fall outside the tolerance. The per-kernel counts must show each
    shape on its kernel (FLASH_SHAPES' last entry). Times at every shape,
    with the bound's share and the ratio to `scaled_dot_product_attention`
    (causal without a window or with one no row reaches: is_causal;
    non-causal: no mask; a window some row reaches: a boolean
    causal-and-window mask); FLASH_REPORTED's shapes go into the report,
    {report name: numbers}."""
    phase("kernels: flash_attention")
    from repro_torch.kernels import flashattn, ref
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(1)
    res = {name: {"max_abs_err": 0.0} for name in FLASH_REPORTED.values()}
    for label, (B, Sq, S, H, KV, D, dname, window, causal, heads,
                variant) in FLASH_SHAPES.items():
        dtype, tol = getattr(torch, dname), FLASH_TOL[dname]
        reported = ("flash_attention[D256]" if D == 256
                    else "flash_attention")
        q = torch.randn((B, Sq, H, D), generator=gen, device=dev).to(dtype)
        k, v = (torch.randn((B, S, KV, D), generator=gen, device=dev)
                .to(dtype) for _ in range(2))
        qt = q.transpose(1, 2).contiguous()
        kt, vt = (t.repeat_interleave(H // KV, dim=2).transpose(1, 2)
                  .contiguous() for t in (k, v))
        kw = dict(causal=causal, window=window)
        flashattn.reset_launches()
        outs = {"gqa_flash_attention":
                flashattn.gqa_flash_attention(q, k, v, **kw).transpose(1, 2),
                "flash_attention": flashattn.flash_attention(qt, kt, vt, **kw)}
        torch.cuda.synchronize()
        variants = dict(flashattn.VARIANT_LAUNCHES)
        log(f"  {label}: launches per kernel {variants}")
        check(variants == {**dict.fromkeys(flashattn.VARIANTS, 0), variant: 2},
              f"flash {label}: launched {variants}, expected 2 of {variant}")
        sub = (qt[:, :heads], kt[:, :heads], vt[:, :heads])
        plain = ref.flash_attention(*sub, **kw)
        for name, out in outs.items():
            excess = flash_excess(torch, out[:, :heads], plain, tol)
            err = _max_err(torch, out[:, :heads], plain)
            log(f"  {name:19s} {label:7s} B={B} Sq={Sq} Sk={S} H={H} KV={KV} "
                f"D={D} {dname} causal={causal} window={window}: max abs err "
                f"{err:.3e}, "
                f"{excess:.3f} of the tolerance {tol} on {heads} heads")
            check(excess <= 1, f"{name} {label}: differs from the plain "
                               f"version ({excess:.3f} of the tolerance)")
            res[reported]["max_abs_err"] = max(
                res[reported]["max_abs_err"], err)
        lo = min(64, S // 2)
        k_ctrl = sub[1].clone()
        k_ctrl[:, :, lo:lo + 64] = 0
        ctrl = flash_excess(torch, ref.flash_attention(sub[0], k_ctrl, sub[2],
                                                       **kw), plain, tol)
        log(f"  control {label:7s} (keys {lo}..{min(lo + 64, S) - 1} "
            f"scored 0): "
            f"{ctrl:.3f} of the tolerance")
        check(ctrl > 1, f"flash {label}: the check passes a wrong result")
        del outs, k_ctrl
        if window is None or window >= S:
            def library():
                return torch.nn.functional.scaled_dot_product_attention(
                    qt, kt, vt, is_causal=causal)
        else:
            mask = _window_mask(torch, S, window, dev)

            def library():
                return torch.nn.functional.scaled_dot_product_attention(
                    qt, kt, vt, attn_mask=mask)
        # the yardstick computes the same function: its agreement with the
        # plain version, for the record
        lib_excess = flash_excess(torch, library()[:, :heads], plain, tol)
        log(f"  library {label:7s} {lib_excess:.3f} of the tolerance on "
            f"{heads} heads")
        del plain
        iters = 10 if Sq * S * B > 2 ** 24 else 50
        ms = _time_ms(torch, lambda: flashattn.gqa_flash_attention(
            q, k, v, **kw), iters)
        public_ms = _time_ms(torch, lambda: flashattn.flash_attention(
            qt, kt, vt, **kw), iters)
        plain_ms = _time_ms(torch, lambda: ref.flash_attention(*sub, **kw), 2)
        flops = 4 * D * H * B * _visible_pairs(Sq, S, causal, window)
        bytes_ = 2 * _nbytes(q, k)         # q, k, v and o: o like q, v like k
        bound_ms, bound_by = max(
            (bytes_ / HBM_BYTES_PER_S * 1e3, "bytes"),
            (flops / (BF16_OPS_PER_S if dtype == torch.bfloat16
                      else F32_OPS_PER_S) * 1e3, "operations"))
        library_ms = _time_ms(torch, library, iters)
        lib = f"{library_ms:.4f} ms (kernel / library {ms / library_ms:.3f})"
        log(f"  flash {label:7s} {variant} gqa_flash_attention {ms:.4f} ms, "
            f"flash_attention {public_ms:.4f} ms  bound {bound_ms:.4f} ms "
            f"({bound_by}, {flops} FLOP, {bytes_} B)  share of the bound "
            f"{bound_ms / ms:.1%}  plain {plain_ms:.4f} ms on {heads} heads  "
            f"library {lib}")
        host_us, kernel_us, profiled_n = issue_split(
            torch, lambda: flashattn.gqa_flash_attention(q, k, v, **kw),
            iters, "flash_fwd")
        check(profiled_n == iters, f"flash {label}: the profiler saw "
                                   f"{profiled_n} of {iters} launches")
        lib_host, lib_kernel, lib_n = issue_split(torch, library, iters)
        log(f"  flash {label:7s} issue split: host {host_us:.1f} us per call, "
            f"kernel {kernel_us:.1f} us per launch ({profiled_n} launches "
            f"profiled); library host {lib_host:.1f} us per call, its "
            f"{lib_n / iters:g} kernels {lib_kernel:.1f} us per call")
        if label in FLASH_REPORTED:
            res[FLASH_REPORTED[label]].update(
                ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by, library_ms=library_ms)
        del q, k, v, qt, kt, vt, sub, library
        torch.cuda.empty_cache()
    return res


# --------------------------------------------------------------------------
# 4. the model on the card against the CPU
# --------------------------------------------------------------------------

MODEL_ARCHS = ("yi-6b", "llava-next-mistral-7b", "whisper-small",
               "minicpm3-4b", "recurrentgemma-2b", "mamba2-2.7b",
               "grok-1-314b", "arctic-480b")


def normal_embeds(torch, cfg, batch, gen):
    """Standard-normal patch (VLM) or frame (encoder-decoder) embeddings
    from `gen` on the CPU, f32, as the Batch fields of the model's stub
    frontend."""
    kw = {}
    if cfg.vlm_img_tokens:
        kw["img_embeds"] = torch.randn(
            (batch, cfg.vlm_img_tokens, cfg.vlm_d_vision), generator=gen)
    if cfg.encoder is not None:
        kw["frame_embeds"] = torch.randn(
            (batch, cfg.encoder.n_frames, cfg.encoder.d_input), generator=gen)
    return kw


def model_phase(torch):
    """Each smoke model of MODEL_ARCHS: loss and gradients, prefill logits
    and one decode step on the card against the same computation on the
    CPU (which tests/test_torch_model.py, test_torch_serve.py and
    test_torch_archs.py hold to the JAX reference), on the same weights,
    tokens and patch / frame embeddings, in f32. Tolerance: loss rtol 1e-5,
    each gradient within 1e-4 of its norm, logits atol 1e-4 (the sums are
    taken in another order; TF32 is off for matmuls by default)."""
    from repro_torch import tree as tree_lib
    from repro_torch.configs import registry
    from repro_torch.models.transformer import Batch, Model
    check(not torch.backends.cuda.matmul.allow_tf32, "TF32 matmuls are on")
    for arch in MODEL_ARCHS:
        phase(f"model: {arch} smoke config on cuda vs cpu, same weights")
        model = Model(registry.get_smoke_config(arch))
        params = model.init(torch.Generator().manual_seed(0), "cpu")
        tok = torch.randint(0, model.cfg.vocab, (4, 64),
                            generator=torch.Generator().manual_seed(1))
        stub = normal_embeds(torch, model.cfg, 4,
                             torch.Generator().manual_seed(3))
        out = {}
        for dev in ("cpu", "cuda"):
            p = tree_lib.tree_map(lambda t: t.to(dev).requires_grad_(True),
                                  params)
            kw = {k: v.to(dev) for k, v in stub.items()}
            loss = model.loss(p, Batch(tokens=tok.to(dev),
                                       labels=tok.to(dev), **kw))
            grads = torch.autograd.grad(loss, tree_lib.leaves(p))
            p = tree_lib.tree_map(lambda t: t.detach(), p)
            logits, cache, pos = model.prefill(
                p, Batch(tokens=tok.to(dev), **kw),
                72 + model.cfg.vlm_img_tokens)
            step, _ = model.decode_step(p, cache, tok[:, :1].to(dev), pos)
            out[dev] = (float(loss.detach()), [g.cpu() for g in grads],
                        logits.cpu(), step.cpu())
        (l_cpu, g_cpu, *s_cpu), (l_gpu, g_gpu, *s_gpu) = (out["cpu"],
                                                          out["cuda"])
        for name, a, b in zip(("prefill", "decode_step"), s_cpu, s_gpu):
            err = float((a - b).abs().max())
            log(f"  {name} logits: max abs err {err:.3e} cuda vs cpu")
            check(bool(torch.isfinite(b).all()) and err <= 1e-4,
                  f"model {arch}: {name} logits differ")
        worst = max(float((a - b).abs().max() / a.norm())
                    for a, b in zip(g_cpu, g_gpu))
        log(f"  loss cpu {l_cpu:.7f} cuda {l_gpu:.7f}; worst gradient error "
            f"{worst:.3e} of its norm")
        check(math.isclose(l_gpu, l_cpu, rel_tol=1e-5),
              f"model {arch}: loss differs")
        check(worst <= 1e-4, f"model {arch}: gradients differ")
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
                planner=None, seq=2048, **train_kw):
    """One train cell through `train()`: global batch 8 of `seq` tokens
    (a VLM adds its image positions; tok/s counts positions)."""
    from repro_torch.launch import train as train_lib
    phase(f"train {label}: mode={comm.mode} hier={comm.hier} "
          f"dp_only={dp_only} "
          f"hybrid={planner is not None and planner.hybrid is not None} "
          f"model_parallel={train_kw.get('force_model_parallel', False)} "
          f"wire={comm.wire} ef={comm.error_feedback} "
          f"microbatches={comm.accum_steps}")
    batch = 8
    positions = seq + cfg.vlm_img_tokens
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    recs, state = train_lib.train(cfg, comm, steps=steps, batch=batch,
                                  seq=seq, lr=3e-4, optimizer="adamw",
                                  dp_only=dp_only, seed=0, device="cuda",
                                  mesh=(None if planner is None
                                        else planner.mesh),
                                  planner=planner, **train_kw)
    torch.cuda.synchronize()
    launches = read_launches()
    peak = torch.cuda.max_memory_allocated()
    for rec in recs:
        log(f"  step {rec.step} loss {rec.loss:.4f} gnorm {rec.grad_norm:.4f} "
            f"step_s {rec.seconds:.3f} tok/s "
            f"{batch * positions / rec.seconds:.0f}")
    steady = [r.seconds for r in recs[1:]] or [recs[0].seconds]
    step_s = sum(steady) / len(steady)
    log(f"  launches {launches}")
    log(f"  peak_memory_allocated {peak} B ({peak / 2**30:.2f} GiB); "
        f"steady step {step_s:.3f} s, {batch * positions / step_s:.0f} tok/s")
    check(all(math.isfinite(r.loss) for r in recs), f"{label}: non-finite loss")
    check(launches == expect, f"{label}: launches {launches} != {expect}")
    return launches, {"step_s": step_s, "first_step_s": recs[0].seconds,
                      "tokens_per_s": batch * positions / step_s,
                      "peak_bytes": peak, "losses": [r.loss for r in recs],
                      "state_bytes": state_bytes(state)}


def state_bytes(state) -> dict:
    """A TrainState's bytes by part, summed from its tensors; the step's
    gradients have the parameters' shapes and dtypes."""
    from repro_torch import tree as tree_lib

    def n(tensors):
        return sum(t.numel() * t.element_size() for t in tensors)
    params = tree_lib.leaves(state.params)
    return {"params": n(params),
            "opt_state": n(tree_lib.leaves(state.opt_state)),
            "grads": n(params), "residuals": n(state.comm_residuals or ())}


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
                repeat=1, flash=(N_LAYERS, "wgmma_bf16"), profile=False,
                check_cache=None, **engine_kw):
    """One serve cell through Engine.generate at full width; `repeat` runs
    it that many times on the same prompts (the greedy tokens must agree).
    Then one prefill and one decode step on the same prompts check that the
    logits are finite. `flash`: the flash launches each prefill makes and
    the kernel they all run on. A VLM's prompt is its standard-normal patch
    embeddings, then `prompt_len` tokens; an encoder-decoder's encoder
    takes standard-normal frame embeddings; both drawn from a seed. With
    `profile`, that prefill and 3 decode steps after it run under
    torch.profiler: kernels, summed kernel time against the wall time and
    the top kernels by time. `check_cache(cache)` checks the cache after
    that prefill and its decode steps."""
    from repro_torch.models.transformer import Batch
    from repro_torch.serve.engine import Engine, EngineConfig
    phase(f"serve {label} ({model.cfg.name}): batch {batch}, prompt "
          f"{prompt_len}, {n_new} new tokens, {engine_kw or 'native cache'}")
    positions = prompt_len + model.cfg.vlm_img_tokens
    eng = Engine(model, params, EngineConfig(
        max_seq=positions + n_new + 8, **engine_kw))
    prompts = np.random.default_rng(0).integers(
        0, model.cfg.vocab, (batch, prompt_len)).astype(np.int32)
    stub = {k: v.numpy() for k, v in normal_embeds(
        torch, model.cfg, batch, torch.Generator().manual_seed(6)).items()}
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    runs = []
    for _ in range(repeat):
        t = {}
        toks = eng.generate(prompts, n_new, timings=t, **stub)
        runs.append((toks, t))
    def prefill():
        return model.prefill(
            params, Batch(tokens=torch.as_tensor(prompts, device=eng.device),
                          **{k: torch.as_tensor(v, device=eng.device)
                             for k, v in stub.items()}),
            eng.cfg.max_seq, **eng.ctx_kw)

    def decode(n):
        out = None
        for i in range(n):
            out, _ = model.decode_step(params, cache, torch.as_tensor(
                runs[0][0][:, i:i + 1], device=eng.device), pos + i,
                **eng.ctx_kw)
        return out

    split = {}
    if profile:
        (logits, cache, pos), split["prefill"] = profiled(torch, prefill)
        step, split["decode_3"] = profiled(torch, lambda: decode(3))
        for k, v in split.items():
            log(f"  profiled {k}: {v['kernels']} kernels, {v['kernel_ms']:.3f}"
                f" ms of kernel time in {v['wall_ms']:.3f} ms wall; top "
                + "; ".join(f"{n} {ms:.3f} ms x{c}" for n, ms, c in v["top"]))
    else:
        logits, cache, pos = prefill()
        step = decode(1)
    check(pos == positions, f"serve {label}: prefill length {pos}")
    torch.cuda.synchronize()
    launches = read_launches()
    from repro_torch.kernels import flashattn
    variants = dict(flashattn.VARIANT_LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    if check_cache is not None:
        check_cache(cache)
    del cache
    prefills = repeat + 1
    per_prefill, variant = flash
    log(f"  launches {launches} over {prefills} prefills; flash per kernel "
        f"{variants}")
    check(launches["flash_attention"] == per_prefill * prefills,
          f"serve {label}: {launches['flash_attention']} flash launches, "
          f"expected {per_prefill} per prefill")
    check(variants.get(variant, 0) == per_prefill * prefills,
          f"serve {label}: flash ran {variants}, expected every launch on "
          f"{variant}")
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
               "prefill_tok_s": batch * positions / t["prefill_s"],
               "ttft_s": t["first_token_s"], "decode_step_s": step_s,
               "decode_tok_s": batch / step_s}
        log("  " + "  ".join(f"{k} {v:.6g}" for k, v in rec.items()))
        out.append(rec)
    log(f"  peak_memory_allocated {peak} B ({peak / 2**30:.2f} GiB)")
    return launches, {"batch": batch, "prompt_len": prompt_len,
                      "positions": positions, "new_tokens": n_new,
                      "runs": out, "peak_bytes": peak, **split}


def _cli_plan(comm, hier: bool, arch: str = "yi-6b"):
    """The plan the CLI builds for the smoke config (default planner)."""
    from repro_torch.configs import registry
    from repro_torch.core import planner as pl
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.models.transformer import Model
    from repro_torch.train import trainer as tr
    mesh = (mesh_lib.make_hier_mesh(1, 1) if hier
            else mesh_lib.make_host_mesh(1, 1))
    return tr.make_comm_engine(Model(registry.get_smoke_config(arch)),
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


def _grads(torch, fn, args, weight=None):
    """(fn(*args) detached, the gradients of sum(fn(*args) * weight) or of
    the scalar fn(*args), with respect to every argument)."""
    args = [a.detach().clone().requires_grad_(True) for a in args]
    out = fn(*args)
    loss = out if weight is None else (out.float() * weight).sum()
    return out.detach(), torch.autograd.grad(loss, args)


def _rel_err(torch, got, want) -> float:
    """max |got - want| over the largest |want|."""
    scale = float(want.abs().max()) or 1.0
    return _max_err(torch, got, want) / scale


def mp_phase(torch, cfg, a_run, expect):
    """Model parallelism over a one-rank NCCL model group: the new
    operators and the model-parallel forward against their dense forms at
    yi-6b's full width (tolerances in the module docstring), then train G
    against cell A's run (`a_run`); returns G's launches and record."""
    from repro_torch import tree as tree_lib
    from repro_torch.configs import registry
    from repro_torch.core import planner as pl
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.models import attention, common
    from repro_torch.models.transformer import Batch, Model
    from repro_torch.train import trainer as tr
    phase("mp: the model-parallel operators over a one-rank NCCL model "
          "group, yi-6b full width")
    mesh = mesh_lib.make_host_mesh(1, 1)
    group = mesh.get_group("model")
    gen = torch.Generator(device="cuda").manual_seed(4)

    def randn(*shape, dtype=torch.float32, scale=1.0):
        return (torch.randn(shape, generator=gen, device="cuda") * scale
                ).to(dtype)

    logits = randn(4, 2047, cfg.vocab, scale=3.0)
    labels = torch.randint(0, cfg.vocab, (4, 2047), generator=gen,
                           device="cuda")
    (l0, (g0,)), (l1, (g1,)) = (
        _grads(torch, fn, [logits]) for fn in (
            lambda z: common.softmax_xent(z, labels),
            lambda z: common.vocab_parallel_xent(z, labels, group)))
    err = _rel_err(torch, g1, g0)
    log(f"  vocab_parallel_xent: loss {float(l1):.7f} dense {float(l0):.7f};"
        f" gradient error {err:.3e} of its largest element")
    check(math.isclose(float(l1), float(l0), rel_tol=1e-6) and err <= 1e-5,
          "mp: vocab_parallel_xent differs from softmax_xent")
    del logits, g0, g1
    table = randn(cfg.vocab, cfg.d_model, dtype=torch.bfloat16, scale=0.02)
    ids = torch.randint(0, cfg.vocab, (4, 2048), generator=gen,
                        device="cuda")
    w = randn(4, 2048, cfg.d_model)
    (h0, (t0,)), (h1, (t1,)) = (
        _grads(torch, fn, [table], w) for fn in (
            lambda t: t[ids],
            lambda t: common.embed_lookup(t, ids, group=group, dim=-2)))
    err = _rel_err(torch, t1, t0)
    log(f"  embed_lookup by vocabulary: output bitwise {torch.equal(h0, h1)};"
        f" table gradient error {err:.3e} of its largest element")
    check(torch.equal(h0, h1) and err <= 1e-2,
          "mp: embed_lookup differs from the dense lookup")
    del table, w, t0, t1, h0, h1
    x = randn(2, 2048, cfg.d_model, dtype=torch.bfloat16)
    w = randn(2, 2048, cfg.d_model)
    for arch in ("yi-6b", "chatglm3-6b"):
        a = registry.get_config(arch).attn
        d_q, d_kv = a.n_heads * a.head_dim, a.n_kv * a.head_dim
        p = [randn(cfg.d_model, n, dtype=torch.bfloat16,
                   scale=cfg.d_model ** -0.5) for n in (d_q, d_kv, d_kv)]
        p.append(randn(d_q, cfg.d_model, dtype=torch.bfloat16,
                       scale=d_q ** -0.5))

        def pdict(wq, wk, wv, wo):
            return {"wq": wq, "wk": wk, "wv": wv, "wo": wo}

        dense = _grads(torch, lambda xx, *ws: attention.gqa_apply(
            pdict(*ws), xx, a), [x, *p], w)
        gathered = _grads(torch, lambda xx, *ws: attention.gqa_gathered(
            pdict(*ws), xx, a, group, attention.HEAD_SHARDED), [x, *p], w)
        errs = [_rel_err(torch, g, d) for g, d in
                zip((gathered[0],) + gathered[1], (dense[0],) + dense[1])]
        log(f"  gqa_gathered {arch} ({a.n_heads} heads on {a.n_kv}, "
            f"rotary_frac {a.rotary_frac}): errors of y, dx, dwq, dwk, dwv, "
            f"dwo {['%.3e' % e for e in errs]} of the largest elements")
        check(max(errs) <= 1e-2, f"mp: gqa_gathered {arch} differs from "
                                 f"gqa_apply")
        del dense, gathered, p
    del x, w
    # f32, so that the one rounding the two paths do differently (the
    # cross-entropy's, 1e-6 of the logits' gradient) is not amplified by
    # bf16 through four layers; train G holds the bf16 path
    model = Model(dataclasses.replace(cfg, dtype=torch.float32))
    params = model.init(torch.Generator(device="cuda").manual_seed(5), "cuda")
    tok = torch.randint(0, cfg.vocab, (2, 2048), generator=gen, device="cuda")
    batch = Batch(tokens=tok, labels=tok)
    layout = model.mp_layout(pl.Planner(mesh=mesh))
    leaves = tree_lib.leaves(params)
    out = []
    for kw in ({}, {"tp_axis": group, "layout": layout}):
        for t in leaves:
            t.requires_grad_(True)
        loss = model.loss(params, batch, **kw)
        out.append((float(loss.detach()), torch.autograd.grad(loss, leaves)))
        for t in leaves:
            t.requires_grad_(False)
        del loss
    (l0, g0), (l1, g1) = out
    worst = max(_rel_err(torch, a, b) for a, b in zip(g1, g0))
    log(f"  model loss through the model-parallel forward {l1:.7f}, dense "
        f"{l0:.7f}; worst gradient error {worst:.3e} of its largest element")
    check(math.isclose(l1, l0, rel_tol=1e-5) and worst <= 1e-4,
          "mp: the model-parallel forward differs from the dense one")
    del out, g0, g1, params, leaves
    comm = tr.CommConfig(mode="mlsl", wire="int8", error_feedback=True,
                         accum_steps=2)
    launches, run = train_phase(
        torch, "G", cfg, comm, steps=3, dp_only=False, expect=expect,
        planner=pl.Planner(mesh=mesh), force_model_parallel=True)
    log(f"  losses {run['losses']} against A's {a_run['losses']}")
    check(math.isclose(run["losses"][0], a_run["losses"][0], rel_tol=1e-5)
          and all(math.isclose(g, a, rel_tol=1e-3) for g, a in
                  zip(run["losses"], a_run["losses"])),
          "train G: losses differ from cell A's")
    log(f"  steady step {run['step_s']:.4f} s against A's "
        f"{a_run['step_s']:.4f} s")
    return launches, run


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


def _kernels(prof) -> list:
    """The CUDA kernel events of a profiler window, read from its Chrome
    trace (the CUDA kernels have cat "kernel")."""
    import tempfile
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "prof.json")
        prof.export_chrome_trace(path)
        with open(path) as fh:
            events = json.load(fh).get("traceEvents", [])
    return [e for e in events if e.get("cat") == "kernel"]


def _kernel_events(prof):
    """(kernel launches, summed kernel microseconds) of a profiler window."""
    kernels = _kernels(prof)
    return len(kernels), sum(float(e.get("dur", 0.0)) for e in kernels)


def profiled(torch, fn, top=5):
    """fn() under torch.profiler, synchronized: (its result, {wall_ms (with
    the profiler's own cost), kernels, kernel_ms summed, top: the `top`
    kernel names by summed time, each [name, ms, launches]})."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    by_name = {}
    kernels = _kernels(prof)
    for e in kernels:
        ms, n = by_name.get(e.get("name", "?"), (0.0, 0))
        by_name[e.get("name", "?")] = (ms + float(e.get("dur", 0.0)) / 1e3,
                                       n + 1)
    names = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:top]
    return out, {"wall_ms": wall * 1e3, "kernels": len(kernels),
                 "kernel_ms": sum(ms for ms, _ in by_name.values()),
                 "top": [[k[:90], ms, n] for k, (ms, n) in names]}


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


# --------------------------------------------------------------------------
# 14-16. the attention-family workloads and the MoE family's serve cells
# --------------------------------------------------------------------------

# serve cells of the attention and MoE families, full width: (label, arch,
# layers (None: full depth), shape, (flash launches per prefill, the kernel
# they run on))
FAMILY_SERVE = (
    ("V-A", "llava-next-mistral-7b", None,
     dict(batch=8, prompt_len=1472, n_new=64), (32, "wgmma_bf16")),
    ("W-A", "whisper-small", None,
     dict(batch=16, prompt_len=32, n_new=64, repeat=2), (36, "wgmma_bf16")),
    ("M-A", "minicpm3-4b", None, dict(batch=8, prompt_len=2048, n_new=64),
     (0, None)),
    ("G-A", "grok-1-314b", 4,
     dict(batch=8, prompt_len=2048, n_new=64, repeat=2), (4, "wgmma_bf16")),
    ("AR-A", "arctic-480b", 2, dict(batch=8, prompt_len=2048, n_new=64),
     (2, "wgmma_bf16")))


def family_serve_phase(torch):
    """V-A, W-A, M-A, G-A and AR-A: each model at full width from seeded
    random weights, through `serve_phase`. V-A's 576 patch embeddings and
    1472 tokens fill 2048 positions (32 launches of `wgmma_bf16`, D 128, 32
    query heads on 8 KV heads); W-A's encoder takes 1500 frame embeddings
    per request (36 launches of `wgmma_bf16`, D 64: 12 encoder non-causal,
    12 decoder causal, 12 cross non-causal on 1500 keys); M-A's MLA attention
    is plain PyTorch (no launch). G-A (grok-1-314b at 4 of 64 layers: 8
    experts of d_ff 32768, 48 query heads on 8 KV heads) and AR-A
    (arctic-480b at 2 of 35 layers: 128 experts of 4864 and the dense
    residual MLP, 56 heads on 8) launch `wgmma_bf16` once a layer and
    prefill; the prefill routes the batch's 8 x 2048 tokens together
    (capacity 5120 a grok-1 expert, 320 an arctic one), a decode step its 8
    tokens at the floor of 8 slots, so every expert's weights are read each
    step."""
    from repro_torch.configs import registry
    from repro_torch.models.transformer import Model
    totals, serve = {}, {}
    for label, arch, layers, kw, flash in FAMILY_SERVE:
        cfg = registry.get_config(arch)
        if layers is not None:
            cfg = dataclasses.replace(cfg, n_layers=layers)
        model = Model(cfg)
        params = model.init(torch.Generator(device="cuda").manual_seed(0),
                            "cuda")
        log(f"{arch} at {cfg.n_layers} layers: {model.n_params():,} "
            f"parameters on the card")
        launches, serve[label] = serve_phase(torch, model, params, label,
                                             flash=flash, profile=True, **kw)
        serve[label]["n_params"] = model.n_params()
        for k, v in launches.items():
            totals[k] = totals.get(k, 0) + v
        del model, params
        torch.cuda.empty_cache()
    return totals, serve


def train_h_phase(torch, zero):
    """Train H: cell A's configuration (default planner, mlsl int8 + EF, 2
    microbatches, 3 steps, global batch 8) on llava-next-mistral-7b at full
    width cut to 4 layers, each row 576 zero patch embeddings (the CLI's
    stub) and 1472 tokens. Its plan fuses the norms, `ln_f` and the new
    `img_proj` leaf; one quantize_ef and one dequantize_accumulate per
    fused bucket and microbatch."""
    from repro_torch.configs import registry
    from repro_torch.core import planner as pl
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.models.transformer import Model
    from repro_torch.train import trainer as tr
    cfg = dataclasses.replace(registry.get_config("llava-next-mistral-7b"),
                              n_layers=4)
    comm = tr.CommConfig(mode="mlsl", wire="int8", error_feedback=True,
                         accum_steps=2)
    mesh = mesh_lib.make_host_mesh(1, 1)
    plan = tr.make_comm_engine(Model(cfg), mesh, pl.Planner(mesh=mesh),
                               comm).plan
    fused = [plan.buckets.paths[i] for b, f in zip(plan.buckets.buckets,
                                                  plan.fusable) if f
             for i in b.leaf_ids]
    log(f"train H plan: {plan.n_buckets} buckets, {sum(plan.fusable)} "
        f"fused: {['/'.join(p) for p in fused]}")
    check(("img_proj",) in fused, "train H: img_proj is not a fused bucket")
    n = sum(plan.fusable) * 2 * 3
    return train_phase(torch, "H", cfg, comm, steps=3, dp_only=False,
                       seq=1472, expect={**zero, "quantize_ef_blocks": n,
                                         "dequantize_accumulate_blocks": n})


def family_cli_phase(torch, archs):
    """The train CLI (flat mlsl int8 + EF, 2 steps) and the serve CLI on
    the smoke configs of `archs`. The serve CLI passes no frame
    embeddings, as the reference's does: whisper-small must stop with the
    ValueError naming them. A prefill launches flash once per attn or
    local layer."""
    from repro_torch.configs import registry
    from repro_torch.launch import serve as serve_lib
    from repro_torch.train import trainer as tr
    zero = dict.fromkeys(KERNELS, 0)
    totals = dict(zero)
    steps = 2
    comm = tr.CommConfig(mode="mlsl", wire="int8", error_feedback=True)
    for arch in archs:
        n = sum(_cli_plan(comm, False, arch).fusable) * steps
        launches, _ = _cli_train(
            torch, f"--arch {arch}",
            ["--arch", arch, "--comm", "mlsl", "--wire", "int8",
             "--error-feedback", "--steps", str(steps)],
            {**zero, "quantize_ef_blocks": n, "dequantize_blocks": n})
        for k, v in launches.items():
            totals[k] += v
    for arch in archs:
        phase(f"cli: python -m repro_torch.launch.serve --arch {arch} "
              f"(smoke config)")
        cfg = registry.get_smoke_config(arch)
        argv = ["--arch", arch, "--batch", "4", "--prompt-len", "32",
                "--new-tokens", "8"]
        reset_launches()
        if cfg.encoder is not None:
            try:
                serve_lib.main(argv)
            except ValueError as e:
                log(f"  refused as expected: {e}")
                check("frame embeddings" in str(e),
                      f"cli serve {arch}: {e}")
            else:
                raise Fail(f"cli serve {arch}: ran without frame embeddings")
            continue
        rc = serve_lib.main(argv)
        torch.cuda.synchronize()
        served = read_launches()
        want = flash_layers(cfg)
        log(f"  launches {served}")
        check(rc == 0 and served["flash_attention"] == want,
              f"cli serve {arch}: rc={rc} launches {served}, expected "
              f"{want} flash launches")
        for k, v in served.items():
            totals[k] += v
    return totals


# --------------------------------------------------------------------------
# 17-19. the recurrent family
# --------------------------------------------------------------------------

# serve cells of the recurrent family, full width and depth: (label, arch,
# shape)
RECURRENT_SERVE = (
    ("R-A", "recurrentgemma-2b", dict(batch=8, prompt_len=2048, n_new=64)),
    ("R-B", "recurrentgemma-2b", dict(batch=1, prompt_len=8192, n_new=32)),
    ("MB-A", "mamba2-2.7b", dict(batch=8, prompt_len=2048, n_new=64)))
RECURRENT_ARCHS = ("recurrentgemma-2b", "mamba2-2.7b")


def flash_layers(cfg) -> int:
    """The layers whose attention a prefill runs on the flash kernel (the
    attn, local and moe kinds)."""
    return sum(cfg.layer_kind(i) in ("attn", "local", "moe")
               for i in range(cfg.n_layers))


def _recurrent_cache_check(cfg, label, batch, prompt_len):
    """The cache after a prefill: every local block a ring of its window's
    slots (R-B's 8192-token prompt compacted into it; a prompt no longer
    than the window keeps its own length), every recurrent block its state
    and conv tails at their own shapes, never max_seq."""
    def check_cache(cache):
        reps = cfg.pattern_repeats
        shapes = {}
        for i, kind in enumerate(cfg.block_pattern):
            c = cache["blocks"][f"p{i}_{kind}"]
            shapes[kind] = {k: tuple(t.shape) for k, t in c.items()}
            if kind == "local":
                a = cfg.attn
                want = (reps, batch, min(a.window, prompt_len), a.n_kv,
                        a.head_dim)
                check(shapes[kind]["k"] == want == shapes[kind]["v"],
                      f"serve {label}: local cache {shapes[kind]}")
            elif kind == "rglru":
                w = cfg.rglru.lru_width
                check(shapes[kind] == {
                    "h": (reps, batch, w),
                    "conv": (reps, batch, cfg.rglru.conv_width - 1, w)},
                    f"serve {label}: rglru cache {shapes[kind]}")
            elif kind == "ssm":
                sc = cfg.ssm
                d_in = sc.expand * cfg.d_model
                check(shapes[kind]["state"] == (
                    reps, batch, d_in // sc.head_dim, sc.d_state,
                    sc.head_dim), f"serve {label}: ssm cache {shapes[kind]}")
        log(f"  cache after the prefill: {shapes}")
    return check_cache


def recurrent_serve_phase(torch):
    """R-A, R-B and MB-A: each model at full width and depth from seeded
    random weights, through `serve_phase` with a profiler window. R-A and
    R-B: recurrentgemma-2b, 8 local blocks (10 query heads on one KV head,
    D 256, window 2048) launching `wgmma_bf16` once each per prefill, 18
    RG-LRU blocks (R-A's window hides nothing at 2048 tokens; R-B's
    8192-token prompt is compacted into the local blocks' rings). MB-A:
    mamba2-2.7b, 64 SSD blocks, no attention. Returns the launches, the
    cells' records and the D-256 flash launches."""
    from repro_torch.configs import registry
    from repro_torch.models.transformer import Model
    totals, serve, d256 = {}, {}, 0
    model = params = None
    for label, arch, kw in RECURRENT_SERVE:
        if model is None or model.cfg.name != arch:
            del model, params
            torch.cuda.empty_cache()
            model = Model(registry.get_config(arch))
            params = model.init(torch.Generator(device="cuda").manual_seed(0),
                                "cuda")
            log(f"{arch}: {model.n_params():,} parameters on the card")
        n_flash = flash_layers(model.cfg)
        launches, serve[label] = serve_phase(
            torch, model, params, label, profile=True,
            flash=(n_flash, "wgmma_bf16" if n_flash else None),
            check_cache=_recurrent_cache_check(model.cfg, label, kw["batch"],
                                               kw["prompt_len"]), **kw)
        serve[label]["n_params"] = model.n_params()
        if model.cfg.attn is not None and model.cfg.attn.head_dim == 256:
            d256 += launches["flash_attention"]
        for k, v in launches.items():
            totals[k] = totals.get(k, 0) + v
    del model, params
    torch.cuda.empty_cache()
    return totals, serve, d256


def train_i_phase(torch, zero):
    """Train I: cell A's configuration (default planner, mlsl int8 + EF, 2
    microbatches, 3 steps, global batch 8 x 2048) on mamba2-2.7b at full
    width cut to 8 layers. Its plan: the f32 per-head vectors (A_log, D,
    dt_bias) beside the bf16 matrices; one quantize_ef and one
    dequantize_accumulate per fused bucket and microbatch; autograd runs
    through the chunked SSD."""
    from repro_torch.configs import registry
    from repro_torch.core import planner as pl
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.models.transformer import Model
    from repro_torch.train import trainer as tr
    cfg = dataclasses.replace(registry.get_config("mamba2-2.7b"), n_layers=8)
    comm = tr.CommConfig(mode="mlsl", wire="int8", error_feedback=True,
                         accum_steps=2)
    mesh = mesh_lib.make_host_mesh(1, 1)
    plan = tr.make_comm_engine(Model(cfg), mesh, pl.Planner(mesh=mesh),
                               comm).plan
    for b, f in zip(plan.buckets.buckets, plan.fusable):
        log(f"  train I bucket {'fused' if f else 'leafwise'}: "
            + ", ".join("/".join(plan.buckets.paths[i]) for i in b.leaf_ids))
    n = sum(plan.fusable) * 2 * 3
    check(n > 0, "train I: no fused bucket")
    return train_phase(torch, "I", cfg, comm, steps=3, dp_only=False,
                       expect={**zero, "quantize_ef_blocks": n,
                               "dequantize_accumulate_blocks": n})


# --------------------------------------------------------------------------
# 20. the MoE family's expert-parallel path
# --------------------------------------------------------------------------

EP_X = (2, 2048)            # the ep phase's x: batch x tokens of d_model
EP_GRAD_TOL = 0.05          # int8 against bf16 weight gather, of the largest


def ep_phase(torch):
    """`moe_apply_ep` over the one-rank NCCL ("data", "model") groups of
    make_host_mesh(1, 1), on one MoE layer of grok-1 at full width (8
    experts, d 6144, d_ff 32768, bf16, seeded random weights) and x of
    EP_X x 6144 bf16 standard normal. Forward on the bf16 wire: y and aux
    equal `moe_apply`'s on the same inputs bit for bit (at one rank the
    capacity, the dispatch and the products are the same). Then with FSDP
    over the one-rank data group, forward and backward of mean(y^2) +
    router_aux_weight * aux on both weight-gather wires: the int8 run
    launches quantize_blocks and dequantize_blocks once per expert matrix,
    and its expert gradients are non-zero and within EP_GRAD_TOL of the
    bf16 run's, relative to their largest element (the straight-through
    rule)."""
    from repro_torch.configs import registry
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.models import common, moe
    phase("ep: moe_apply_ep over one-rank NCCL groups, one grok-1 layer at "
          "full width")
    cfg = registry.get_config("grok-1-314b")
    m, act = cfg.moe, cfg.mlp_act
    mesh = mesh_lib.make_host_mesh(1, 1)
    groups = dict(model_group=mesh.get_group("model"),
                  batch_groups=[mesh.get_group("data")])
    gen = torch.Generator(device="cuda").manual_seed(5)
    p = common.init_tree(gen, moe.moe_defs(cfg.d_model, m, cfg.dtype),
                         "cuda")
    x = torch.randn((*EP_X, cfg.d_model), generator=gen,
                    device="cuda").to(cfg.dtype)
    rec = {}
    with torch.no_grad():
        for name, fn in (
                ("moe_apply", lambda: moe.moe_apply(p, x, m, act=act)),
                ("moe_apply_ep", lambda: moe.moe_apply_ep(
                    p, x, m, act=act, **groups))):
            fn()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn()
            torch.cuda.synchronize()
            rec[f"{name}_s"] = time.perf_counter() - t0
            rec[name] = out
    (y_ref, aux_ref), (y, aux) = rec.pop("moe_apply"), rec.pop("moe_apply_ep")
    same = torch.equal(y, y_ref) and torch.equal(aux, aux_ref)
    log(f"  forward: moe_apply {rec['moe_apply_s']:.4f} s, moe_apply_ep "
        f"{rec['moe_apply_ep_s']:.4f} s; y and aux bitwise equal: {same} "
        f"(max abs err {_max_err(torch, y, y_ref):.3e}, aux {float(aux):.6f}"
        f" vs {float(aux_ref):.6f})")
    check(same, "ep: moe_apply_ep differs from moe_apply at one rank")
    check(bool(torch.isfinite(y).all()), "ep: y not finite")
    del y, y_ref

    def grads(wire):
        leaves = [p[k].detach().requires_grad_(True)
                  for k in ("w1", "w2", "w3")]
        pp = {**p, **dict(zip(("w1", "w2", "w3"), leaves))}
        reset_launches()
        y, aux = moe.moe_apply_ep(pp, x, m, act=act, fsdp_groups=groups[
            "batch_groups"], wgather_wire=wire, **groups)
        loss = y.float().square().mean() + m.router_aux_weight * aux
        out = torch.autograd.grad(loss, leaves)
        torch.cuda.synchronize()
        return float(loss.detach()), out, read_launches()

    l_bf16, g_bf16, _ = grads("bf16")
    l_int8, g_int8, launches = grads("int8")
    log(f"  FSDP over the data group: loss bf16 wire {l_bf16:.7f}, int8 wire "
        f"{l_int8:.7f}; int8 launches {launches}")
    check(launches["quantize_blocks"] == 3
          and launches["dequantize_blocks"] == 3,
          f"ep: the int8 weight gather launched {launches}")
    for k, a, b in zip(("w1", "w2", "w3"), g_int8, g_bf16):
        top = float(b.abs().max())
        rel = float((a.float() - b.float()).abs().max()) / top
        log(f"  d{k}: int8 vs bf16 weight gather {rel:.3e} of the largest "
            f"element ({top:.3e}); int8 max {float(a.abs().max()):.3e}")
        check(float(a.abs().max()) > 0 and rel <= EP_GRAD_TOL,
              f"ep: d{k} on the int8 wire is {rel:.3e} from the bf16 wire's")
        rec[f"d{k}_int8_vs_bf16"] = rel
    rec.update(loss_bf16=l_bf16, loss_int8=l_int8)
    del p, x, g_bf16, g_int8
    torch.cuda.empty_cache()
    return launches, rec


# --------------------------------------------------------------------------
# 21-23. the Session facade, FSDP and the moe block's ep branch
# --------------------------------------------------------------------------

A_COMM = dict(mode="mlsl", wire="int8", error_feedback=True, accum_steps=2)


def session_run(torch, sess, model, *, steps, batch=8, seq=2048, lr=3e-4,
                seed=0):
    """`steps` train steps through `sess.make_train_step`, set up as
    `launch.train.train` sets up a cell (warmup-cosine AdamW at `lr`,
    weights and data from `seed`), the state from `make_train_state` with
    the session's planner. Returns (the state, a record: losses, step
    seconds, steady step, peak allocated bytes, the launches)."""
    from repro_torch.data import pipeline
    from repro_torch.models.transformer import Batch
    from repro_torch.optim import optimizers as opt_lib, schedules
    from repro_torch.train import trainer as tr
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    opt = opt_lib.make_optimizer(
        "adamw", schedules.warmup_cosine(lr, max(steps // 10, 1), steps))
    state = tr.make_train_state(
        model, opt, torch.Generator(device="cuda").manual_seed(seed), "cuda",
        planner=sess.planner)
    step = sess.make_train_step(model, opt, device="cuda")
    dcfg = pipeline.DataConfig(vocab=model.cfg.vocab, seq_len=seq,
                               global_batch=batch, seed=seed)
    losses, secs = [], []
    for raw in pipeline.iterate(dcfg, steps):
        b = Batch(tokens=torch.from_numpy(raw["tokens"]).to("cuda"),
                  labels=torch.from_numpy(raw["labels"]).to("cuda"))
        t0 = time.perf_counter()
        state, m = step(state, b)
        losses.append(float(m["loss"]))
        secs.append(time.perf_counter() - t0)
    torch.cuda.synchronize()
    steady = secs[1:] or secs
    rec = {"losses": losses, "step_s_each": secs,
           "step_s": sum(steady) / len(steady),
           "tokens_per_s": batch * seq * len(steady) / sum(steady),
           "peak_bytes": torch.cuda.max_memory_allocated(),
           "launches": read_launches()}
    for i, (loss, sec) in enumerate(zip(losses, secs)):
        log(f"  step {i} loss {loss:.6f} step_s {sec:.4f}")
    log(f"  steady step {rec['step_s']:.4f} s, {rec['tokens_per_s']:.0f} "
        f"tok/s, peak_memory_allocated {rec['peak_bytes']} B "
        f"({rec['peak_bytes'] / 2**30:.2f} GiB); launches {rec['launches']}")
    return state, rec


def session_phase(torch, cfg, a_run, a_expect):
    """(a) `Session.create` with the card's memory as the budget: at 1.2 B
    parameters x 14 B = 17 GB, under 55% of 80 GB, `decide_fsdp` is false,
    so the planner is cell A's. Three steps of cell A's exchange through
    `sess.make_train_step`: losses bit for bit A's (the same seed) and A's
    quant8 launches. Then the parameters saved, restored bit for bit, and
    served through `Engine.generate`."""
    import tempfile
    from repro_torch import tree as tree_lib
    from repro_torch.checkpoint import ckpt
    from repro_torch.core.api import Session
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.models.transformer import Model
    from repro_torch.serve.engine import Engine, EngineConfig
    from repro_torch.train import trainer as tr
    phase("session: Session.create on the card's memory, cell A through "
          "make_train_step, save, restore, serve")
    model = Model(cfg)
    total = torch.cuda.get_device_properties(0).total_memory
    sess = Session.create(mesh_lib.make_host_mesh(1, 1),
                          n_params=model.n_params(),
                          comm=tr.CommConfig(**A_COMM), hbm_budget=total)
    log(f"  decide_fsdp {sess.planner.fsdp}: {model.n_params():,} parameters "
        f"x 14 B = {model.n_params() * 14:.4g} B against 0.55 x {total} B; "
        f"wire saving {sess.wire_savings():.3f}x")
    check(not sess.planner.fsdp, "session: decide_fsdp chose FSDP for cell A")
    state, rec = session_run(torch, sess, model, steps=3)
    log(f"  losses {rec['losses']}; cell A's {a_run['losses']}")
    check(rec["losses"] == a_run["losses"],
          "session: the losses differ from cell A's")
    check(rec["launches"] == a_expect,
          f"session: launches {rec['launches']} != cell A's {a_expect}")
    params = state.params
    del state
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        d = ckpt.save(os.path.join(tmp, "ck"), {"params": params}, step=3)
        back = ckpt.restore(d, {"params": params})["params"]
        rec["save_restore_s"] = time.perf_counter() - t0
    same = all(a.dtype == b.dtype and torch.equal(a, b) for a, b in
               zip(tree_lib.leaves(params), tree_lib.leaves(back)))
    log(f"  checkpoint saved and restored in {rec['save_restore_s']:.2f} s; "
        f"bitwise {same}")
    check(same, "session: the restored parameters differ")
    del params
    prompts = np.random.default_rng(0).integers(
        0, cfg.vocab, (2, 16)).astype(np.int32)
    out = Engine(model, back, EngineConfig(max_seq=64)).generate(prompts, 8)
    log(f"  generated {out.tolist()}")
    check(out.shape == (2, 8) and ((out >= 0) & (out < cfg.vocab)).all(),
          "session: generated tokens out of the vocabulary")
    del back
    torch.cuda.empty_cache()
    return rec["launches"], rec


def _chunked_rel_err(torch, got, want, rows=2**26) -> float:
    """`_rel_err` in f32 over slices of `rows` elements (a gradient of
    billions of bf16 elements would not fit twice more in f32); `want` may
    lie in host memory, a slice at a time moved to `got`'s device."""
    g, w = got.reshape(-1), want.reshape(-1)
    err = top = 0.0
    for i in range(0, g.numel(), rows):
        a, b = g[i:i + rows].float(), w[i:i + rows].to(g.device).float()
        err = max(err, float((a - b).abs().max()))
        top = max(top, float(b.abs().max()))
    return err / (top or 1.0)


def one_repeat_bytes(model) -> int:
    """Bytes of one pattern repeat's weights (the stacked leaves' slices):
    what FSDP's gather holds in full at a time."""
    from repro_torch import tree as tree_lib
    return sum(math.prod(pd.shape[1:]) * pd.dtype.itemsize
               for pd in tree_lib.leaves(model.param_defs()["blocks"]))


class CollectiveCount:
    """Counts the all-gathers and reduce-scatters torch.distributed issues
    while it is entered."""

    NAMES = ("all_gather_into_tensor", "reduce_scatter_tensor")

    def __init__(self, dist):
        self.dist, self.counts = dist, dict.fromkeys(self.NAMES, 0)

    def __enter__(self):
        self.saved = {n: getattr(self.dist, n) for n in self.NAMES}
        for n, fn in self.saved.items():
            def counted(*a, _n=n, _fn=fn, **kw):
                self.counts[_n] += 1
                return _fn(*a, **kw)
            setattr(self.dist, n, counted)
        return self

    def __exit__(self, *exc):
        for n, fn in self.saved.items():
            setattr(self.dist, n, fn)


def held_after_forward(torch, model, params, batch, **kw) -> int:
    """Bytes the autograd graph of one `Model.loss` forward holds for its
    backward (allocated after the forward, less before it)."""
    from repro_torch import tree as tree_lib
    leaves = tree_lib.leaves(params)
    for t in leaves:
        t.requires_grad_(True)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    loss = model.loss(params, batch, **kw)
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated() - base
    del loss
    for t in leaves:
        t.requires_grad_(False)
    return held


def fsdp_phase(torch, cfg):
    """(b) The same model with the reference's default budget (16e9):
    `decide_fsdp` is true, and mlsl must refuse it. Three gspmd steps
    under FSDP (every matrix split over the one-rank data group: NCCL
    all-gathers and reduce-scatters of a group of one) against E's
    configuration run beside it for 3 steps: losses and the gathered
    parameters bit for bit. Memory: the graph of one forward (a step's
    microbatch) must hold less above E's than one repeat's gathered
    weights (each repeat's gather sits inside its checkpoint, so none is
    kept; a gather outside would keep all 4), and the peak must stay within
    E's plus one gathered repeat."""
    import torch.distributed as dist
    from repro_torch import convert, tree as tree_lib
    from repro_torch.core.api import Session
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.models.transformer import Batch, Model
    from repro_torch.optim import optimizers as opt_lib
    from repro_torch.train import trainer as tr
    phase("fsdp: Session.create on the reference's 16e9 budget, 3 gspmd "
          "steps under FSDP against E's")
    model = Model(cfg)
    mesh = mesh_lib.make_host_mesh(1, 1)
    total = torch.cuda.get_device_properties(0).total_memory
    gspmd = tr.CommConfig(mode="gspmd")
    sess_e = Session.create(mesh, n_params=model.n_params(), comm=gspmd,
                            hbm_budget=total)
    sess = Session.create(mesh, n_params=model.n_params(), comm=gspmd)
    log(f"  decide_fsdp {sess.planner.fsdp} at 16e9 B ({sess_e.planner.fsdp} "
        f"at the card's {total} B)")
    check(sess.planner.fsdp and not sess_e.planner.fsdp,
          "fsdp: decide_fsdp did not choose FSDP at 16e9 B")
    mlsl = Session.create(mesh, n_params=model.n_params(),
                          comm=tr.CommConfig(mode="mlsl"))
    try:
        mlsl.make_train_step(model, opt_lib.adamw(3e-4))
        check(False, "fsdp: mlsl accepted FSDP")
    except ValueError as e:
        log(f"  mlsl under FSDP raises: {e}")
    splits = tree_lib.leaves(sess.planner.fsdp_dims(
        model.param_defs(), stacked_paths=Model.stacked_path))
    log(f"  {sum(s is not None for s in splits)} of {len(splits)} leaves "
        f"split over the data group")
    gen = torch.Generator(device="cuda").manual_seed(8)
    tok = torch.randint(0, cfg.vocab, (8, 2048), generator=gen,
                        device="cuda")
    batch = Batch(tokens=tok, labels=tok)
    log("  E (replicated gspmd):")
    state_e, rec_e = session_run(torch, sess_e, model, steps=3)
    held_e = held_after_forward(torch, model, state_e.params, batch)
    # kept on the host, so that the FSDP run's peak is its own
    want = tree_lib.tree_map(lambda t: t.cpu(), state_e.params)
    del state_e
    log("  FSDP:")
    with CollectiveCount(dist) as cc:
        state, rec = session_run(torch, sess, model, steps=3)
    rec["collectives"] = cc.counts
    held = held_after_forward(torch, model, state.params, batch,
                              fsdp=tr.fsdp_splits(model, sess.planner, mesh))
    got = convert.gather_params(state.params,
                                tr.param_specs(model, sess.planner), mesh)
    same = all(torch.equal(a.cpu(), b) for a, b in
               zip(tree_lib.leaves(got), tree_lib.leaves(want)))
    repeat = one_repeat_bytes(model)
    bound = rec_e["peak_bytes"] + repeat
    rec.update(e_losses=rec_e["losses"], e_step_s=rec_e["step_s"],
               e_peak_bytes=rec_e["peak_bytes"], repeat_bytes=repeat,
               held_after_forward=held, e_held_after_forward=held_e,
               params_bitwise=same)
    log(f"  collectives in the 3 steps: {cc.counts}")
    log(f"  losses {rec['losses']}; E's {rec_e['losses']}; parameters "
        f"bitwise {same}")
    log(f"  held after one forward {held} B against E's {held_e} B "
        f"({(held - held_e) / 2**30:+.3f} GiB; one gathered repeat "
        f"{repeat / 2**30:.3f} GiB)")
    log(f"  steady step {rec['step_s']:.4f} s against E's "
        f"{rec_e['step_s']:.4f} s ({rec['step_s'] / rec_e['step_s']:.4f}x); "
        f"peak {rec['peak_bytes']} B against E's {rec_e['peak_bytes']} B "
        f"({(rec['peak_bytes'] - rec_e['peak_bytes']) / 2**30:+.3f} GiB; "
        f"one gathered repeat {repeat / 2**30:.3f} GiB)")
    check(cc.counts["all_gather_into_tensor"] > 0
          and cc.counts["reduce_scatter_tensor"] > 0,
          "fsdp: no NCCL all-gather or reduce-scatter ran")
    check(rec["losses"] == rec_e["losses"] and same,
          "fsdp: losses or parameters differ from E's")
    check(held - held_e < repeat,
          "fsdp: the forward keeps gathered weights for the backward")
    check(rec["peak_bytes"] <= bound,
          "fsdp: the peak exceeds E's plus one gathered repeat")
    del state, got, want
    torch.cuda.empty_cache()
    return rec


def moe_ep_block_phase(torch):
    """(c) One grok-1 layer at full width (the model cut to 1 of 64
    layers), forward and backward through `Model.loss` on batch 2 x 2048
    under FSDP over the one-rank data group: the moe block's gather branch
    against its ep branch (`moe_apply_ep` over the one-rank model group,
    gathering its expert leaves itself) on the same weights. bf16 weight
    gather: logits, aux and every weight gradient bitwise. int8: the quant8
    quantize and dequantize kernels launch inside the step, and the expert
    gradients are within EP_GRAD_TOL of the bf16 gather's, of the largest
    element. A train step with AdamW would need about 100 GB on one card,
    so the check stops at the gradients."""
    from repro_torch import convert, tree as tree_lib
    from repro_torch.configs import registry
    from repro_torch.core import planner as pl
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.models.transformer import Batch, Model
    from repro_torch.train import trainer as tr
    phase("moe ep block: one grok-1 layer at full width, the ep branch "
          "against the gather branch under FSDP")
    cfg = dataclasses.replace(registry.get_config("grok-1-314b"), n_layers=1)
    model = Model(cfg)
    mesh = mesh_lib.make_host_mesh(1, 1)
    planner = pl.Planner(mesh=mesh, fsdp=True)
    fsdp = tr.fsdp_splits(model, planner, mesh)
    params = model.init(torch.Generator(device="cuda").manual_seed(6), "cuda")
    params = convert.shard_params(params, tr.param_specs(model, planner),
                                  mesh)
    torch.cuda.empty_cache()
    gen = torch.Generator(device="cuda").manual_seed(7)
    tok = torch.randint(0, cfg.vocab, EP_X, generator=gen, device="cuda")
    batch = Batch(tokens=tok, labels=tok)
    groups = dict(model_group=mesh.get_group("model"),
                  batch_groups=(mesh.get_group("data"),))
    leaves = tree_lib.leaves(params)
    paths = tree_lib.paths(params)
    experts = [i for i, p in enumerate(paths)
               if p[-2:] in (("moe", "w1"), ("moe", "w2"), ("moe", "w3"))]
    log(f"  {model.n_params():,} parameters; expert leaves "
        f"{[paths[i] for i in experts]}")

    def run(moe):
        with torch.no_grad():
            logits, aux = model._forward(params, batch, fsdp=fsdp, moe=moe)
        for t in leaves:
            t.requires_grad_(True)
        reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss = model.loss(params, batch, fsdp=fsdp, moe=moe)
        grads = torch.autograd.grad(loss, leaves)
        torch.cuda.synchronize()
        sec = time.perf_counter() - t0
        launches = read_launches()
        for t in leaves:
            t.requires_grad_(False)
        return logits, aux, float(loss.detach()), grads, launches, sec

    rec = {}
    ref = run(None)
    rec["gather_s"] = ref[5]
    log(f"  gather branch: loss {ref[2]:.7f} aux {float(ref[1]):.7f}, "
        f"forward and backward {ref[5]:.3f} s")
    ep = run(dict(moe_impl="ep", wgather_wire="bf16", **groups))
    same = (torch.equal(ep[0], ref[0]) and torch.equal(ep[1], ref[1])
            and all(torch.equal(a, b) for a, b in zip(ep[3], ref[3])))
    worst = max(_chunked_rel_err(torch, a, b) for a, b in zip(ep[3], ref[3]))
    rec.update(ep_bf16_s=ep[5], ep_bf16_bitwise=same,
               ep_bf16_worst_grad_err=worst)
    log(f"  ep branch, bf16 weight gather: loss {ep[2]:.7f}, {ep[5]:.3f} s; "
        f"logits, aux and gradients bitwise {same} (worst gradient "
        f"{worst:.3e} of its largest element)")
    check(same, "moe ep block: the ep branch differs from the gather branch")
    bf16_experts = [ep[3][i] for i in experts]
    rec.update(gather_loss=ref[2])
    del ep, ref
    torch.cuda.empty_cache()
    q = run(dict(moe_impl="ep", wgather_wire="int8", **groups))
    launches = q[4]
    n_fwd = 2 if cfg.remat else 1       # the checkpoint gathers again
    log(f"  ep branch, int8 weight gather: loss {q[2]:.7f}, {q[5]:.3f} s; "
        f"launches {launches}")
    check(launches["quantize_blocks"] == 3 * n_fwd
          and launches["dequantize_blocks"] == 3 * n_fwd,
          f"moe ep block: the int8 weight gather launched {launches}")
    for i, b in zip(experts, bf16_experts):
        a = q[3][i]
        rel = _chunked_rel_err(torch, a, b)
        name = "/".join(paths[i])
        log(f"  d{name}: int8 vs bf16 weight gather {rel:.3e} of the largest "
            f"element; int8 max {float(a.abs().max()):.3e}")
        check(float(a.abs().max()) > 0 and rel <= EP_GRAD_TOL,
              f"moe ep block: d{name} on the int8 wire is {rel:.3e} from "
              f"the bf16 wire's")
        rec[f"d{paths[i][-1]}_int8_vs_bf16"] = rel
    rec.update(ep_int8_s=q[5], loss_int8=q[2])
    del q, bf16_experts, params, leaves
    torch.cuda.empty_cache()
    return launches, rec


# --------------------------------------------------------------------------
# 24. model parallelism for every family over a one-rank model group
# --------------------------------------------------------------------------

# (arch, layers (None: the full depth), batch, tokens a row)
FAMILIES_MP = (
    ("llava-next-mistral-7b", 4, 2, 1472),
    ("whisper-small", None, 2, 448),
    ("minicpm3-4b", 4, 2, 2048),
    ("recurrentgemma-2b", 3, 2, 2048),
    ("mamba2-2.7b", 8, 2, 2048),
    ("grok-1-314b", 1, 2, 2048),
    ("arctic-480b", 1, 2, 2048),
)
# the dense run's gradients wait in host memory above this many bytes of
# parameters (arctic's one layer: 28 GB of weights and as much gradient)
FAMILY_GRADS_ON_HOST = 8 * 2**30
# bf16 gradients, of each leaf's largest element: the mp phase's bf16
# bound. At one rank the f/g operators are copies and each f sits where
# autograd adds the same cotangents in the same order as without a layout:
# the CPU shows every family bitwise in bf16, and the card all but
# recurrentgemma, whose gradients differ there by about one bf16 rounding
# step of the largest element with its loss bitwise
FAMILY_GRAD_TOL = 1e-2


def families_mp_phase(torch, i_run, i_launches):
    """Each arch of FAMILIES_MP at full width from seeded weights: `Model.
    loss` and its gradients with the layout of `Planner(mesh)` over the
    one-rank NCCL model group (every family's model-parallel forward: MLA's
    latents through f, the encoder and cross blocks, the SSM's split gated
    norm, the RG-LRU's gathered gates, the experts and the dense residual
    split) against the same model without one; then train I under
    `force_model_parallel`. Returns its launches and record."""
    from repro_torch import tree as tree_lib
    from repro_torch.configs import registry
    from repro_torch.core import planner as pl
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.models.transformer import Batch, Model
    from repro_torch.train import trainer as tr
    phase("families mp: every family's model-parallel forward and backward "
          "over a one-rank NCCL model group, full width, bf16")
    mesh = mesh_lib.make_host_mesh(1, 1)
    group = mesh.get_group("model")
    rec = {}
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    for arch, layers, B, S in FAMILIES_MP:
        cfg = registry.get_config(arch)
        if layers is not None:
            cfg = dataclasses.replace(cfg, n_layers=layers)
        model = Model(cfg)
        params = model.init(torch.Generator(device="cuda").manual_seed(8),
                            "cuda")
        # the blocks' layouts; the embedding and the head replicated: their
        # vocab-parallel forms round the logits' gradient otherwise, which
        # bf16 carries into every gradient (the mp phase holds them in f32)
        layout = {**model.mp_layout(pl.Planner(mesh=mesh)), "embed": None}
        if "head" in layout:
            layout["head"] = None
        gen = torch.Generator(device="cuda").manual_seed(9)
        tok = torch.randint(0, cfg.vocab, (B, S), generator=gen,
                            device="cuda")
        stub = {k: v.to("cuda") for k, v in normal_embeds(
            torch, cfg, B, torch.Generator().manual_seed(10)).items()}
        batch = Batch(tokens=tok, labels=tok, **stub)
        leaves = tree_lib.leaves(params)
        on_host = sum(t.numel() * t.element_size()
                      for t in leaves) > FAMILY_GRADS_ON_HOST
        out = []
        for kw in ({}, {"tp_axis": group, "layout": layout}):
            for t in leaves:
                t.requires_grad_(True)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            loss = model.loss(params, batch, **kw)
            grads = torch.autograd.grad(loss, leaves)
            torch.cuda.synchronize()
            sec = time.perf_counter() - t0
            for t in leaves:
                t.requires_grad_(False)
            if on_host and not kw:
                grads = [g.cpu() for g in grads]
            out.append((float(loss.detach()), grads, sec))
            del loss, grads
        (l0, g0, s0), (l1, g1, s1) = out
        errs = [_chunked_rel_err(torch, a, b) for a, b in zip(g1, g0)]
        worst = max(errs)
        worst_leaf = "/".join(tree_lib.paths(params)[errs.index(worst)])
        same = l0 == l1 and all(torch.equal(a, b.to(a.device))
                                for a, b in zip(g1, g0))
        peak = torch.cuda.max_memory_allocated()
        log(f"  {arch} at {cfg.n_layers} layers ({model.n_params():,} "
            f"parameters), batch {B} x {S}: loss {l1:.7f} against {l0:.7f}; "
            f"worst gradient error {worst:.3e} of its largest element "
            f"({worst_leaf}), bitwise {same}; forward and backward "
            f"{s1:.3f} s (without a "
            f"layout {s0:.3f} s); peak {peak / 2**30:.2f} GiB")
        check(math.isclose(l1, l0, rel_tol=1e-5) and worst <= FAMILY_GRAD_TOL,
              f"families mp: {arch}'s model-parallel forward differs from "
              f"the dense one")
        rec[arch] = {"loss": l1, "dense_loss": l0, "worst_grad_err": worst,
                     "worst_leaf": worst_leaf, "bitwise": same, "mp_s": s1,
                     "dense_s": s0, "peak_bytes": peak}
        del out, g0, g1, params, leaves, batch
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    cfg = dataclasses.replace(registry.get_config("mamba2-2.7b"), n_layers=8)
    launches, run = train_phase(
        torch, "I under model parallelism", cfg, tr.CommConfig(**A_COMM),
        steps=3, dp_only=False, expect=i_launches,
        planner=pl.Planner(mesh=mesh), force_model_parallel=True)
    log(f"  losses {run['losses']} against I's {i_run['losses']}; quant8 "
        f"launches under the layout {launches}")
    check(all(math.isclose(g, a, rel_tol=1e-3) for g, a in
              zip(run["losses"], i_run["losses"])),
          "families mp: mamba2's losses differ from cell I's")
    log(f"  steady step {run['step_s']:.4f} s against I's "
        f"{i_run['step_s']:.4f} s")
    rec["I_mp"] = run
    return launches, rec


# the dry-run phase's child: a process of its own (the dry-run's fake world
# must not meet this process's NCCL group) that prints one JSON object of
# dry-run records: cell A's configuration and S-A's prefill at world size 1,
# then three combinations on the production meshes
DRYRUN_CHILD = """
import dataclasses, json
from torch.distributed.device_mesh import init_device_mesh
from repro_torch.configs import registry
from repro_torch.configs.shapes import InputShape
from repro_torch.core.planner import Planner
from repro_torch.launch import dryrun as d
from repro_torch.train import trainer as tr
out = {}
d.start_fake_world(1)
mesh = init_device_mesh("cpu", (1, 1), mesh_dim_names=("data", "model"))
cfg = dataclasses.replace(registry.get_config("yi-6b"), n_layers=4)
out["A"] = d.dryrun_one(
    "yi-6b", "A", cfg=cfg, shape=InputShape("A", 2048, 8, "train"),
    comm=tr.CommConfig(**%r), mesh=mesh, mesh_name="host1x1",
    planner=Planner(mesh=mesh))
out["S-A"] = d.dryrun_one(
    "yi-6b", "S-A", shape=InputShape("S-A", 2048, 8, "prefill"), mesh=mesh,
    mesh_name="host1x1")
for arch, shape, multi_pod in %r:
    tag = arch + "__" + shape + ("__pod2x16x16" if multi_pod else "__pod16x16")
    try:
        out[tag] = d.dryrun_one(arch, shape, multi_pod=multi_pod)
    except Exception as e:
        out[tag] = {"status": "failed", "error": d.failure_reason(e)}
print(json.dumps(out, default=str))
"""
# (arch, shape, multi_pod) of the production-mesh combinations
DRYRUN_COMBOS = (("yi-6b", "train_4k", False), ("grok-1-314b", "train_4k", True),
                 ("mamba2-2.7b", "long_500k", False))


def _roof_line(rec) -> str:
    r, m = rec["roofline"], rec["memory"]
    return (f"args {m['argument_bytes']} B, temp {m['temp_bytes']} B, "
            f"predicted peak {m['argument_bytes'] + m['temp_bytes']} B; "
            f"flops {rec['cost_full']['flops']:.4e}, bytes "
            f"{rec['cost_full']['bytes accessed']:.4e}; t_compute "
            f"{r['t_compute']:.4f} s, t_memory {r['t_memory']:.4f} s, "
            f"t_collective {r['t_collective']:.4f} s, dominant "
            f"{r['dominant']}")


def dryrun_phase(a_run, sa_run) -> dict:
    """The port's dry-run (`repro_torch.launch.dryrun`, on meta tensors in a
    process of its own) beside what this run measured: cell A's
    configuration (its predicted parameter, optimizer, gradient and
    residual bytes must equal cell A's real train state's), S-A's
    full-depth prefill, and three production-mesh combinations."""
    phase("dryrun: cell A's configuration and S-A's prefill at world size "
          "1, then yi-6b train_4k (pod16x16), grok-1 train_4k (pod2x16x16), "
          "mamba2 long_500k (pod16x16), on meta")
    root = os.path.dirname(os.path.abspath(__file__))
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-c", DRYRUN_CHILD % (A_COMM, DRYRUN_COMBOS)],
        cwd=root, env=dict(os.environ, PYTHONPATH=os.path.join(root, "src")),
        capture_output=True, text=True, timeout=600)
    check(proc.returncode == 0, f"dryrun: the child failed: "
          f"{proc.stderr[-3000:]}")
    recs = json.loads(proc.stdout.strip().splitlines()[-1])
    log(f"  dry-run child {time.perf_counter() - t0:.1f} s")
    a = recs["A"]
    check(a["status"] == "ok", f"dryrun A: {a}")
    log(f"  A predicted state bytes {a['state_bytes']}")
    log(f"  A real state bytes      {a_run['state_bytes']}")
    check(a["state_bytes"] == a_run["state_bytes"],
          "dryrun A: predicted state bytes differ from the real state's")
    peak = a["memory"]["argument_bytes"] + a["memory"]["temp_bytes"]
    mflops = a["roofline"]["model_flops"]
    log(f"  A {_roof_line(a)}")
    log(f"  A measured: steady step {a_run['step_s']:.4f} s, peak "
        f"{a_run['peak_bytes']} B; predicted / measured peak "
        f"{peak / a_run['peak_bytes']:.4f}; model FLOPs {mflops:.4e}: "
        f"{mflops / a_run['step_s'] / BF16_OPS_PER_S:.4f} of 989e12 a "
        f"second; roofline max term / step "
        f"{max(a['roofline']['t_compute'], a['roofline']['t_memory']) / a_run['step_s']:.4f}")
    sa = recs["S-A"]
    check(sa["status"] == "ok", f"dryrun S-A: {sa}")
    sa_peak = sa["memory"]["argument_bytes"] + sa["memory"]["temp_bytes"]
    prefill = min(r["prefill_s"] for r in sa_run["runs"])
    log(f"  S-A {_roof_line(sa)}")
    log(f"  S-A measured: prefill {prefill:.5f} s (fastest run), peak "
        f"{sa_run['peak_bytes']} B (generate, max_seq 2120; predicted at "
        f"max_seq 2048); predicted / measured peak "
        f"{sa_peak / sa_run['peak_bytes']:.4f}; model FLOPs "
        f"{sa['roofline']['model_flops']:.4e}: "
        f"{sa['roofline']['model_flops'] / prefill / BF16_OPS_PER_S:.4f} of "
        f"989e12 a second")
    out = {"A": {"predicted_peak": peak, "measured_peak": a_run["peak_bytes"],
                 "step_s": a_run["step_s"], **a["roofline"]},
           "S-A": {"predicted_peak": sa_peak,
                   "measured_peak": sa_run["peak_bytes"],
                   "prefill_s": prefill, **sa["roofline"]}}
    for arch, shape, multi_pod in DRYRUN_COMBOS:
        tag = arch + "__" + shape + ("__pod2x16x16" if multi_pod
                                     else "__pod16x16")
        rec = recs[tag]
        if rec["status"] == "ok":
            log(f"  {tag}: ok, {_roof_line(rec)}")
            out[tag] = rec["roofline"] | {"memory": rec["memory"]}
        else:
            log(f"  {tag}: {rec['status']}: {rec.get('error')}")
            out[tag] = {"status": rec["status"], "error": rec.get("error")}
        if rec.get("data_dependent"):
            log(f"    {rec['data_dependent']}")
        check(rec["status"] == "ok",
              f"dryrun {tag}: {rec['status']} {rec.get('error')}")
    return out


def examples_phase(torch) -> dict:
    """The example twins on the card: train_lm_torch.py (tiny preset, mlsl
    int8 + EF, 20 steps, finite, falling loss) and serve_batched_torch.py
    (six requests on the mamba2 smoke model, tokens in the vocabulary)."""
    import tempfile
    phase("examples: train_lm_torch.py and serve_batched_torch.py on the card")
    root = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=os.path.join(root, "src"))
    out = {}
    with tempfile.TemporaryDirectory(prefix="train_lm_torch_") as tmp:
        for name, args in (
                ("train_lm_torch.py", ["--steps", "20", "--comm", "mlsl",
                                       "--wire", "int8", "--error-feedback",
                                       "--ckpt", os.path.join(tmp, "ckpt")]),
                ("serve_batched_torch.py", [])):
            t0 = time.perf_counter()
            proc = subprocess.run(
                [sys.executable, os.path.join(root, "examples", name), *args],
                cwd=root, env=env, capture_output=True, text=True,
                timeout=600)
            check(proc.returncode == 0,
                  f"examples {name}: {proc.stderr[-3000:]}")
            lines = proc.stdout.splitlines()
            for line in lines:
                log("  " + line)
            out[name] = {"wall_s": time.perf_counter() - t0}
            if name.startswith("train"):
                check("device=cuda" in lines[0], f"{name}: {lines[0]}")
                losses = [float(l.split()[3]) for l in lines
                          if l.startswith("step")]
                check(len(losses) == 2 and all(map(math.isfinite, losses))
                      and losses[-1] < losses[0], f"{name}: losses {losses}")
                out[name]["losses"] = losses
            else:
                reqs = [l for l in lines if l.startswith("req")]
                check(len(reqs) == 6 and "on cuda" in lines[-1],
                      f"{name}: {lines[-1:]}")
                out[name]["summary"] = lines[-1]
    return out


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
    results.update(flash_phase(torch))
    model_phase(torch)

    cfg = dataclasses.replace(registry.get_config("yi-6b"), n_layers=4)
    zero = dict.fromkeys(KERNELS, 0)
    # cell A: the 2 norm buckets x 2 microbatches x 3 steps
    a_launches = {**zero, "quantize_ef_blocks": 12,
                  "dequantize_accumulate_blocks": 12}
    totals = dict(zero)
    runs = {}
    for label, comm, steps, dp_only, expect in (
            ("A", tr.CommConfig(**A_COMM), 3, False, a_launches),
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
    # model parallelism at one rank: A's exchange (the 2 norm buckets on
    # the EF int8 wire), 2 buckets x 2 microbatches x 3 steps
    launches, runs["G"] = mp_phase(torch, cfg, runs["A"], a_launches)
    for k, v in launches.items():
        totals[k] += v
    launches, runs["obs B"] = obs_train_phase(torch, cfg, runs["B"]["step_s"])
    for k, v in launches.items():
        totals[k] += v
    for k, v in cli_phase(torch).items():
        totals[k] += v
    for k, v in cli_obs_phase(torch).items():
        totals[k] += v
    launches, family = family_serve_phase(torch)
    serve.update(family)
    for k, v in launches.items():
        totals[k] += v
    launches, runs["H"] = train_h_phase(torch, zero)
    for k, v in launches.items():
        totals[k] += v
    for k, v in family_cli_phase(
            torch, [arch for _, arch, *_ in FAMILY_SERVE]).items():
        totals[k] += v
    launches, recurrent, d256 = recurrent_serve_phase(torch)
    serve.update(recurrent)
    for k, v in launches.items():
        totals[k] += v
    launches, runs["I"] = train_i_phase(torch, zero)
    i_launches = launches
    for k, v in launches.items():
        totals[k] += v
    for k, v in family_cli_phase(torch, RECURRENT_ARCHS).items():
        totals[k] += v
    launches, runs["ep"] = ep_phase(torch)
    for k, v in launches.items():
        totals[k] += v
    launches, runs["session"] = session_phase(torch, cfg, runs["A"],
                                              a_launches)
    for k, v in launches.items():
        totals[k] += v
    runs["fsdp"] = fsdp_phase(torch, cfg)
    launches, runs["moe ep block"] = moe_ep_block_phase(torch)
    for k, v in launches.items():
        totals[k] += v
    launches, runs["families mp"] = families_mp_phase(torch, runs["I"],
                                                      i_launches)
    for k, v in launches.items():
        totals[k] += v
    runs["dryrun"] = dryrun_phase(runs["A"], serve["S-A"])
    runs["examples"] = examples_phase(torch)
    check(d256 > 0, "the recurrent cells never launched flash at D 256")
    check(all(v > 0 for v in totals.values()),
          f"a kernel was never launched on the main path: {totals}")
    if dist.is_initialized():
        dist.destroy_process_group()

    phase("report")
    log("train " + json.dumps(runs))
    print("serve " + json.dumps(serve), flush=True)
    log(f"total_s {time.perf_counter() - t_start:.1f}")
    # the flash kernel's D-256 instance has its own line: its launches are
    # the recurrentgemma cells' (R-A, R-B), its times R-A's shape's; the
    # smoke config's head dim of 32 runs the f32 kernel
    launched = {**totals, "flash_attention[D256]": d256}
    kernels = [{"name": k, "route": "cuda",
                "source": SOURCES["quant8" if k in QUANT8 else "flashattn"],
                "replaces": KERNELS[k.split("[")[0]],
                "launches": launched[k],
                "max_abs_err": results[k]["max_abs_err"],
                "ms": results[k]["ms"], "plain_ms": results[k]["plain_ms"],
                "bound_ms": results[k]["bound_ms"],
                "bound_by": results[k]["bound_by"],
                "library_ms": results[k]["library_ms"]}
               for k in (*KERNELS, "flash_attention[D256]")]
    print(smi, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": count}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
