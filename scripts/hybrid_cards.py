#!/usr/bin/env python3
"""Hybrid data x model parallelism, and plain model parallelism, across
the cards of one host, against the data-parallel twin.

    python3 scripts/hybrid_cards.py [--nproc 4] [--device cuda]
                                    [--parts check,cells,stats,mp,ep,fsdp,
                                             families,serve]

Both parts run on --nproc ranks through torchrun, for each mesh (node,
local) of --meshes (default 1x4 and 2x2), twice: hybrid (the C2C
chooser's plan: tensor parallelism over "local" for the layers it sends
model-parallel, data parallelism over "node") and its twin (pure data
parallelism over ("node", "local") on the same two-level mesh and wire),
both mlsl, the same weights and data.

check: the train CLI, `--hybrid` against `--hier`, on the smoke config
(batch 8, seq 64, 4 steps) for each wire of --wires (default fp32, int8,
bf16). On the fp32 wire the twins compute the same function and train
with SGD at 0.1 (tests/test_torch_hybrid.py's setting; AdamW's normalized
update would blow rounding in near-zero gradients up to its step size):
every step's loss must agree within 5e-4 and the parameters after the last
step (each run's --ckpt-dir; the hybrid run saves the full tensors gathered
over its tp group) within atol 1e-4 (that test's bounds between hybrid and
DP, the reference's own), and every step's gradient norm within 1e-3 (the
CLI prints it to 3 decimals). A wrong backward rule of an f/g operator
fails these. On the lossy wires the twins quantize different
messages (hybrid fuses every bucket; the --hier planner sends the matrices
leaf by leaf on the bf16 wire), so they are not the same computation:
there the bound is rtol 1e-3 on the losses, the 8-rank CPU tests' int8
tolerance (tests/test_torch_train_hier.py).

cells: `launch.train.train` at the train cells' configuration (yi-6b at
full width cut to 4 layers, global batch 8, seq 2048, 2 microbatches,
AdamW with warmup-cosine at 3e-4, 4 steps) on the int8 and bf16 wires
without error feedback: `make_hybrid_planner` against `Planner(mesh,
dp_only=True)` (every bucket fused, as in the hybrid plan). Prints the
plan lines, each step's loss and seconds (host clock after the device
finished, rank 0), the median of steps 1-3 and each rank's peak allocated
device memory; the losses must agree within rtol 1e-3.

stats (only when asked for: `--parts stats`): the cells' DP twin on the
(2, 2) mesh, `--hier` int8 without error feedback, through `train()` with
the observability hooks (a meter, a health monitor and a telemetry stream
on rank 0, a bucket replay after every step on all ranks), then 5 timed
replays of every bucket: prints `CommStats.table()` with each bucket's
measured exchange over the cards' links (the median, then the MAX over
the ranks) beside the cost model's column, which is model data of the
paper's Xeon + 10 GbE platform (`hw.CLOUD_10G`), not of these cards.

mp (only when asked for: `--parts mp`): plain model parallelism
(`--model-parallel`, `Planner(mesh)` with the model axis on every matrix)
on the meshes of --mp-meshes, (data, model) = (1, 4) and (2, 2) and the
two-level ("node", "local", "model") = (1, 2, 2), each against the
data-parallel twin (4, 1) on the same weights and data, mlsl:
  * the train CLI on the smoke config, fp32 wire, SGD at 0.1, 4 steps
    (the check part's setting and bounds: losses within 5e-4, gradient
    norms within 1e-3, the parameters after the last step within 1e-4;
    the model-parallel runs save the full tensors gathered over the model
    group);
  * chatglm3-6b at full width cut to 4 layers (its 2 KV heads split over 4
    ranks: the gathered-head attention) at (1, 4), and yi-6b at the train
    cells' configuration (cell A's: int8 wire with error feedback, 2
    microbatches, AdamW with warmup-cosine at 3e-4, global batch 8, seq
    2048, 4 steps) on every mesh of --mp-meshes, through `train()`: each
    step's loss and seconds, the median of steps 1-3 and each rank's peak
    allocated device memory; the losses must agree with the twin's within
    rtol 1e-3.

ep (only when asked for: `--parts ep`): expert parallelism
(`models.moe.moe_apply_ep`) over a model group of all --nproc ranks on
one grok-1 MoE layer at full width (8 experts of d_ff 32768, d 6144, bf16,
seeded random weights: 2 experts a card at 4 ranks), x (2, --cells-seq,
6144) bf16 replicated on every rank, NCCL:
  * at capacity factor 8.0 (nothing dropped), each rank's y against
    `moe_apply` of rank 0 on the whole layer: the largest error within
    EP_TOL of y's largest element (bf16 products of other shapes), and
    aux equal to the mean of `moe_apply`'s aux over the ranks' token
    slices within 1e-5;
  * at capacity factor 1.25 (the config's): y finite;
  * timed at 1.25, the medians of 5: the forward, the forward and
    backward, and the two all-to-alls of the forward alone on buffers of
    the exchange's shape, with their share of the forward.

fsdp (only when asked for: `--parts fsdp`): FSDP (`Planner(mesh,
fsdp=True)`, gspmd) on the (--nproc, 1) data mesh, NCCL:
  * pair: yi-6b at the train cells' width cut to 4 layers (global batch 8,
    seq --cells-seq, 2 microbatches, AdamW with warmup-cosine at 3e-4,
    FSDP_STEPS steps, the same weights and data), FSDP against the
    replicated gspmd step on the same cards, in one process a rank: every
    step's loss and gradient norm within LOSS_RTOL, and the final
    parameters gathered over the data axis against the replicated run's
    within the bf16 bound `bf16_param_bound`; each run's steps, median
    step and peak a rank. Two witnesses of that bound: the replicated
    mlsl step (fp32 wire, bucketed all-reduces: no shard anywhere, only
    another order of the gradient sums) against the replicated gspmd
    step, whose share of elements beyond one rounding step says what
    reduction order alone gives; and the FSDP parameters with each split
    leaf's shards rotated by one rank (a misplaced shard), which must
    exceed the bound in every split leaf;
  * full: full-depth yi-6b (32 layers, 6.06 B parameters) through
    `Session.create(mesh, n_params=, comm=gspmd with 2 microbatches,
    hbm_budget=<the card's memory>)`, which must choose FSDP (85 GB of
    replicated train state over 55% of the card), FSDP_STEPS steps at
    global batch 8 and seq --cells-seq: each step's seconds, the median,
    tok/s and each rank's peak (after the state is built, and while every
    rank draws the full weights before keeping its shards).

families (only when asked for: `--parts families`): model parallelism
for every family (or those of --families), in one process a rank (NCCL):
  * each of FAMILIES at full width in f32, cut to its depth there, at
    (data, model) = (1, --nproc) against its (--nproc, 1) data-parallel
    twin: `Planner(mesh)`, mlsl on the fp32 wire, SGD at 0.1, global batch
    8 (llava: 576 patch embeddings and 1472 tokens a row, whisper: 1500
    frame embeddings and 448 tokens, the others --cells-seq tokens), the
    same weights and data, --steps steps: every step's loss within
    LOSS_ATOL and gradient norm within GNORM_ATOL of the twin's (the
    check part's bounds; in f32 the twins differ only in the order of
    their sums); each run's steps, median step and peak a rank (during
    the steps, and apart while the state was built);
  * grok-1 at full width cut to GROK_LAYERS of its 64 layers (bf16, 8
    experts: 2 a card at 4 ranks), global batch GROK_BATCH x --cells-seq,
    AdamW with warmup-cosine at 3e-4, gspmd: (1, --nproc) on the gather
    dispatch against FSDP on (--nproc, 1) (`Planner(fsdp=True)`), which
    route the same global batch: losses within rtol LOSS_RTOL; then (1,
    --nproc) with `moe_impl="ep"`, which routes each source rank's tokens
    (not held equal). Each run's steps, median step, tok/s and peak a rank;
    for the ep run the all-to-all's median on a buffer of the exchange's
    shape, and its share of the step at 6 all-to-alls a layer (2 in the
    forward, 2 in the checkpoint's recomputation, 2 in the backward).

serve (only when asked for: `--parts serve`): model-parallel serving
(`Engine` with a mesh and a planner), in one process a rank (NCCL). The
weights are drawn one leaf at a time, a stacked leaf one repeat at a
time, each from a generator seeded by (seed, leaf path, repeat), and each
rank keeps its shards (`seeded_params`): no card holds a whole stacked
leaf, and every layout draws the same weights.
  * yi-6b at full width and depth, for each seed of YI_SEEDS (weights
    and prompts): rank 0 alone serves the whole model (SERVE_BATCH x
    SERVE_PROMPT prompts, YI_STEPS greedy decode steps) and evaluates the
    same bf16 weights in f32 on the same tokens (the witness); the greedy
    tokens are then teacher-forced through (data, model) = (1, --nproc)
    and (2, --nproc / 2) under `Planner(mesh)`. At the prefill and every
    step (relative RMS over the step's batch x vocabulary) a layout's
    distance to the f32 evaluation is within YI_F32_FACTOR of the one-card
    run's own, and its distance to the one-card run within YI_ONE_FACTOR
    of that (both derived at the constants); the first greedy token is
    equal in every row but those where the two runs' measured errors at
    the two competing logits reach the one-card run's gap between them
    (`_first_tokens`). At the first seed a control run at (1, --nproc)
    with model rank 1's `wo` shard zeroed in every layer must fail the
    bounds, and each layout generates SERVE_NEW tokens for its times;
  * grok-1 at full width cut to SERVE_GROK_LAYERS of its 64 layers (8
    experts, 2 a card at 4 ranks) at (1, --nproc) under `Planner(mesh)`,
    SERVE_BATCH x SERVE_PROMPT prompts and SERVE_NEW greedy tokens, on the
    gather dispatch and again with `moe_impl="ep"` (its prefill on the
    expert-parallel dispatch; the decode gathers, as the reference's):
    prefill s, TTFT, mean decode step, tok/s, each rank's peak allocated
    bytes (under 80 GB), and the all-reduces' share of the prefill and of
    a decode step (2 a layer and the embedding's, each timed on a buffer
    of its shape). Each grok-1 run is warmed up by a 2-token generate.
    Then, at a capacity factor where neither dispatch drops a token
    (n_experts / top_k), the gather dispatch's prefill of the same
    prompts runs every moe layer on the ep dispatch too, on the same
    input: each layer's ep output within GROK_MOE_TOL of the gather's
    (relative RMS over every token; derived at the constant), and a
    control with rank 1's `w2` zeroed in the first layer on the ep side
    must fail it. The ep dispatch's own prefill at that capacity gives
    the two cascades' last-token logits apart (recorded, not held: see
    GROK_MOE_TOL).

Writes everything to --out as JSON and exits non-zero if a run fails or a
pair disagrees. `--device cpu` runs the same on gloo ranks (a rehearsal:
no time it prints is a device's; `--cells-config smoke --cells-seq 32`
keeps the cells part small enough for the CPU).
"""

from __future__ import annotations

import argparse
import json
import os
import pathlib
import shutil
import statistics
import subprocess
import sys
import time

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parents[1]
LOSS_ATOL = 5e-4          # fp32 wire
GNORM_ATOL = 1e-3         # fp32 wire, the CLI's printed precision
PARAM_ATOL = 1e-4         # fp32 wire, parameters after the last step
LOSS_RTOL = 1e-3          # int8 and bf16 wires
EP_TOL = 2e-2             # ep part: bf16 y against moe_apply's, of its max
FSDP_STEPS = 3
# families part: (arch, layers (None: full depth), tokens a row (None:
# --cells-seq))
FAMILIES = (("minicpm3-4b", 4, None), ("recurrentgemma-2b", 3, None),
            ("mamba2-2.7b", 8, None), ("whisper-small", None, 448),
            ("llava-next-mistral-7b", 4, 1472))
GROK_LAYERS = 2
GROK_BATCH = 4
# serve part: grok-1's depth, the traffic (G-A's and S-A's), the yi-6b
# pairs' teacher-forced steps
SERVE_GROK_LAYERS = 16
SERVE_BATCH, SERVE_PROMPT, SERVE_NEW = 8, 2048, 64
YI_STEPS = 16
YI_SEEDS = (0, 1, 2)
# the yi-6b layouts' bounds, against the f32 evaluation of the same bf16
# weights (the witness). A layout and the one-card run are bf16
# evaluations of one function, each at its own rounding distance from it.
# A layout rounds where the one card rounds and, in two sublayers a layer
# (the attention's and the MLP's out-projections), more: each of its p
# partial products (each at 1/sqrt(p) of the output's RMS) once and the
# all-reduce's p - 1 partial sums (k/p of it in variance for the k-th),
# in place of the one GEMM output rounding: 1 + (p(p+1)/2 - 1)/p units of
# a rounding's variance against 1, that is 3.25 at p 4 and 2 at p 2. Of
# the ~14 roundings a layer's output passes in the one-card run (the
# norm, q, k, v, the softmax, the attention output, the out-projection,
# the residual add; the norm, gate, up, their product, down, the add)
# the layout adds 2 x 2.25 units at p 4 (2 x 1 at p 2), so its variance
# grows by about 32% (14%), its distance by about 1.15x (1.07x). The bound
# YI_F32_FACTOR is sqrt(2): a layout's extra roundings as many as all of
# the one card's own, three times the count above. The two runs' errors
# are at most independent, so the layout lies from the one-card run
# within sqrt(1 + 2) of the one card's own distance: YI_ONE_FACTOR
YI_F32_FACTOR = 2 ** 0.5
YI_ONE_FACTOR = 3 ** 0.5
# grok-1's moe layers, ep against gather on the same input at a capacity
# where neither drops a token: the same f32 routes, the same two expert
# products a token from the same bf16 weights and rows. They differ in
# the expert GEMMs' row counts (another tiling may round an output one
# ulp apart) and in the combine: the gather dispatch adds a rank's
# weighted products and then the ranks' partials in the all-reduce (zeros
# are exact: at most one more rounding a token), the ep dispatch the two
# returned products. So an element differs by at most about two bf16
# roundings (u = 2^-8 each at most u/2 of it), a relative RMS of at most
# about u = 3.9e-3; the bound is 2.5 times that. The two dispatches'
# prefills in full are not held: a layer's rounding moves the next
# layer's router logits, and a token whose second and third experts are
# that close may take another expert from there on, which no rounding
# bound covers
GROK_MOE_TOL = 1e-2
HBM = 80e9


def bf16_param_bound(a, b, lrs):
    """(max excess over the bound, share of elements beyond one rounding
    step) of two bf16 parameter tensors after AdamW steps at the rates
    `lrs`. An element may differ by one bf16 rounding step of its
    magnitude (2^-7 of it), and by two steps of every learning rate where
    its update's sign differs: AdamW's step is about the learning rate
    whatever the gradient's size, and the reduce-scatter and the all-reduce
    sum the bf16 gradients in other orders. A shard in the wrong place
    moves elements by their own size, far past the bound. The share is
    reported, not bounded: the pair's witnesses read it for a replicated
    pair summed in another order, and show that a misplaced shard
    exceeds the bound."""
    a, b = a.float(), b.float()
    diff = (a - b).abs()
    step = 2.0 ** -7 * a.abs().maximum(b.abs())
    share = float((diff > step).float().mean())
    excess = float((diff - step - 2.0 * sum(lrs)).max())
    return excess, share


def _torchrun(nproc: int, target: list, timeout: float):
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT / "src"), os.environ.get("PYTHONPATH", "")]),
        OMP_NUM_THREADS="1")
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc-per-node", str(nproc), *target]
    return subprocess.run(cmd, env=env, capture_output=True, text=True,
                          timeout=timeout)


def run_cli(nproc: int, flags: list, timeout: float) -> dict:
    proc = _torchrun(nproc, ["-m", "repro_torch.launch.train", *flags],
                     timeout)
    lines = proc.stdout.splitlines()
    steps = []
    for line in lines:
        if line.startswith("step"):
            f = line.split()
            steps.append({"step": int(f[1]), "loss": float(f[3]),
                          "grad_norm": float(f[5]),
                          "seconds": float(f[6].strip("()s"))})
    return {"flags": flags, "rc": proc.returncode,
            "plan": [l for l in lines if l.startswith("plan ")],
            "mesh": [l for l in lines if l.startswith("arch=")],
            "steps": steps, "stderr": proc.stderr[-3000:]}


def load_params(directory: str) -> dict:
    """{leaf key: float64 array} of a checkpoint (bf16 leaves widened)."""
    with open(os.path.join(directory, "manifest.json")) as f:
        bf16 = set(json.load(f).get("bf16", []))
    out = {}
    with np.load(os.path.join(directory, "payload.npz")) as payload:
        for key in payload.files:
            arr = payload[key]
            if key in bf16:
                arr = (arr.astype(np.uint32) << 16).view(np.float32)
            out[key] = arr.astype(np.float64)
    return out


def _show(label: str, r: dict) -> None:
    print(f"== {label}: rc {r['rc']}", flush=True)
    for line in r.get("mesh", []) + r["plan"]:
        print("  " + line)
    for s in r["steps"]:
        print(f"  step {s['step']} loss {s['loss']:.6f} gnorm "
              f"{s['grad_norm']:.6f} {s['seconds']:.4f}s")
    if r.get("peak_bytes"):
        print(f"  peak allocated per rank {r['peak_bytes']} B")


def check_part(args, work: pathlib.Path) -> tuple:
    results, ok = [], True
    for mesh in args.meshes.split(","):
        nodes, local = (int(v) for v in mesh.split("x"))
        for wire in args.wires.split(","):
            common = ["--device", args.device, "--comm", "mlsl", "--wire",
                      wire, "--nodes", str(nodes), "--local-size",
                      str(local), "--steps", str(args.steps), "--batch",
                      "8", "--seq", "64", "--log-every", "1"]
            pair = {}
            for mode in ("hybrid", "hier"):
                flags = [f"--{mode}"] + common
                if wire == "fp32":
                    flags += ["--optimizer", "sgd", "--lr", "0.1",
                              "--ckpt-dir", str(work / f"{mesh}_{mode}")]
                r = run_cli(args.nproc, flags, args.timeout)
                pair[mode] = r
                _show(f"cli --{mode} mesh {mesh} wire {wire}", r)
                if r["rc"] != 0 or len(r["steps"]) != args.steps:
                    ok = False
                    print(r["stderr"], file=sys.stderr)
            hy, dp = pair["hybrid"]["steps"], pair["hier"]["steps"]
            res = {"nodes": nodes, "local": local, "wire": wire, **pair}
            agree = bool(hy) and len(hy) == len(dp)
            res["max_loss_diff"] = (max(abs(a["loss"] - b["loss"])
                                        for a, b in zip(hy, dp))
                                    if agree else None)
            if wire == "fp32":
                res["max_gnorm_diff"] = (max(abs(a["grad_norm"] -
                                                 b["grad_norm"])
                                             for a, b in zip(hy, dp))
                                         if agree else None)
                try:
                    ph, pd = (load_params(str(work / f"{mesh}_{m}"))
                              for m in ("hybrid", "hier"))
                    res["max_param_diff"] = (
                        max(float(np.max(np.abs(ph[k] - pd[k])))
                            for k in pd) if ph.keys() == pd.keys()
                        else float("inf"))
                except OSError as e:
                    print(f"  no checkpoint: {e}", file=sys.stderr)
                    res["max_param_diff"] = float("inf")
                agree = (agree and res["max_loss_diff"] <= LOSS_ATOL
                         and res["max_gnorm_diff"] <= GNORM_ATOL
                         and res["max_param_diff"] <= PARAM_ATOL)
                print(f"  max |hybrid - hier|: loss {res['max_loss_diff']}"
                      f" (bound {LOSS_ATOL}), gnorm {res['max_gnorm_diff']}"
                      f" (bound {GNORM_ATOL}), parameters "
                      f"{res['max_param_diff']:.3g} (bound {PARAM_ATOL}): "
                      f"{'agree' if agree else 'DISAGREE'}", flush=True)
            else:
                agree = agree and all(
                    abs(a["loss"] - b["loss"]) <= LOSS_RTOL * abs(b["loss"])
                    for a, b in zip(hy, dp))
                print(f"  max |loss(hybrid) - loss(hier)| "
                      f"{res['max_loss_diff']} (bound rtol {LOSS_RTOL}): "
                      f"{'agree' if agree else 'DISAGREE'}", flush=True)
            res["agree"] = agree
            ok = ok and agree
            results.append(res)
    return results, ok


def cells_part(args, work: pathlib.Path) -> tuple:
    results, ok = [], True
    for mesh in args.meshes.split(","):
        nodes, local = (int(v) for v in mesh.split("x"))
        for wire in ("int8", "bf16"):
            pair = {}
            for mode in ("hybrid", "dp"):
                out = work / f"cells_{mesh}_{wire}_{mode}.json"
                proc = _torchrun(args.nproc, [
                    str(pathlib.Path(__file__).resolve()), "--worker", mode,
                    "--device", args.device, "--mesh", mesh, "--wire", wire,
                    "--cells-config", args.cells_config, "--cells-seq",
                    str(args.cells_seq), "--steps", str(args.steps),
                    "--worker-out", str(out)], args.timeout)
                r = (json.loads(out.read_text()) if out.exists()
                     else {"plan": [], "steps": []})
                r["rc"] = proc.returncode
                steady = [s["seconds"] for s in r["steps"][1:]]
                r["median_step_s"] = (statistics.median(steady) if steady
                                      else None)
                pair[mode] = r
                _show(f"cells {mode} mesh {mesh} wire {wire}", r)
                print(f"  median of steps 1-{len(steady)}: "
                      f"{r['median_step_s']} s", flush=True)
                if proc.returncode != 0 or len(r["steps"]) != args.steps:
                    ok = False
                    print(proc.stdout[-2000:], proc.stderr[-3000:],
                          file=sys.stderr)
            hy, dp = pair["hybrid"]["steps"], pair["dp"]["steps"]
            agree = bool(hy) and len(hy) == len(dp) and all(
                abs(a["loss"] - b["loss"]) <= LOSS_RTOL * abs(b["loss"])
                for a, b in zip(hy, dp))
            diff = (max(abs(a["loss"] - b["loss"]) for a, b in zip(hy, dp))
                    if hy and dp else None)
            print(f"  max |loss(hybrid) - loss(dp)| {diff} (bound rtol "
                  f"{LOSS_RTOL}): {'agree' if agree else 'DISAGREE'}",
                  flush=True)
            ok = ok and agree
            results.append({"nodes": nodes, "local": local, "wire": wire,
                            "max_loss_diff": diff, "agree": agree, **pair})
    return results, ok


def stats_part(args, work: pathlib.Path) -> tuple:
    out = work / "stats.json"
    proc = _torchrun(args.nproc, [
        str(pathlib.Path(__file__).resolve()), "--worker", "stats",
        "--device", args.device, "--mesh", "2x2", "--wire", "int8",
        "--cells-config", args.cells_config, "--cells-seq",
        str(args.cells_seq), "--steps", str(args.steps), "--worker-out",
        str(out)], args.timeout)
    r = (json.loads(out.read_text()) if out.exists()
         else {"plan": [], "steps": []})
    r["rc"] = proc.returncode
    _show("stats dp mesh 2x2 wire int8 (--hier)", r)
    print(r.get("table", ""), flush=True)
    for s in r.get("samples", []):
        print(f"  replay after step {s['step']}: "
              f"{sum(s['measured']) * 1e3:.4f} ms over "
              f"{len(s['measured'])} buckets", flush=True)
    ok = proc.returncode == 0 and len(r["steps"]) == args.steps and all(
        t > 0 for t in r.get("bucket_s", [0.0]))
    if not ok:
        print(proc.stdout[-2000:], proc.stderr[-3000:], file=sys.stderr)
    return r, ok


def _mp_flags(mesh: str) -> list:
    """CLI flags of a --mp-meshes entry: "DxM" (data x model) or "hNxLxM"
    (node x local x model, two-level)."""
    if mesh.startswith("h"):
        n, l, m = mesh[1:].split("x")
        return ["--hier", "--nodes", n, "--local-size", l,
                "--model-parallel", m]
    d, m = mesh.split("x")
    return ["--data-parallel", d, "--model-parallel", m]


def _compare_fp32(pair: dict, work: pathlib.Path, names: tuple) -> dict:
    """The check part's bounds between two fp32 CLI runs: every step's loss
    and gradient norm, and the parameters of their checkpoints."""
    a, b = (pair[n]["steps"] for n in names)
    res = {"max_loss_diff": None, "max_gnorm_diff": None,
           "max_param_diff": float("inf")}
    agree = bool(a) and len(a) == len(b)
    if agree:
        res["max_loss_diff"] = max(abs(x["loss"] - y["loss"])
                                   for x, y in zip(a, b))
        res["max_gnorm_diff"] = max(abs(x["grad_norm"] - y["grad_norm"])
                                    for x, y in zip(a, b))
    try:
        pa, pb = (load_params(str(work / n)) for n in names)
        if pa.keys() == pb.keys():
            res["max_param_diff"] = max(float(np.max(np.abs(pa[k] - pb[k])))
                                        for k in pb)
    except OSError as e:
        print(f"  no checkpoint: {e}", file=sys.stderr)
    res["agree"] = (agree and res["max_loss_diff"] <= LOSS_ATOL
                    and res["max_gnorm_diff"] <= GNORM_ATOL
                    and res["max_param_diff"] <= PARAM_ATOL)
    print(f"  max |{names[0]} - {names[1]}|: loss {res['max_loss_diff']} "
          f"(bound {LOSS_ATOL}), gnorm {res['max_gnorm_diff']} (bound "
          f"{GNORM_ATOL}), parameters {res['max_param_diff']:.3g} (bound "
          f"{PARAM_ATOL}): {'agree' if res['agree'] else 'DISAGREE'}",
          flush=True)
    return res


def _run_worker(args, mode: str, mesh: str, out: pathlib.Path,
                arch: str) -> dict:
    proc = _torchrun(args.nproc, [
        str(pathlib.Path(__file__).resolve()), "--worker", mode,
        "--device", args.device, "--mesh", mesh, "--wire", "int8",
        "--arch", arch, "--cells-config",
        args.cells_config, "--cells-seq", str(args.cells_seq), "--steps",
        str(args.steps), "--worker-out", str(out)], args.timeout)
    r = (json.loads(out.read_text()) if out.exists()
         else {"plan": [], "steps": []})
    r["rc"] = proc.returncode
    steady = [s["seconds"] for s in r["steps"][1:]]
    r["median_step_s"] = statistics.median(steady) if steady else None
    if proc.returncode != 0 or len(r["steps"]) != args.steps:
        print(proc.stdout[-2000:], proc.stderr[-3000:], file=sys.stderr)
    return r


def mp_part(args, work: pathlib.Path) -> tuple:
    results, ok = {"check": [], "cells": []}, True
    meshes = args.mp_meshes.split(",")
    common = ["--device", args.device, "--comm", "mlsl", "--wire", "fp32",
              "--steps", str(args.steps), "--batch", "8", "--seq", "64",
              "--log-every", "1", "--optimizer", "sgd", "--lr", "0.1"]
    runs = {}
    for name, flags in [("twin", ["--data-parallel", str(args.nproc)])] + [
            (m, _mp_flags(m)) for m in meshes]:
        r = run_cli(args.nproc, flags + common + [
            "--ckpt-dir", str(work / f"mp_{name}")], args.timeout)
        runs[f"mp_{name}"] = r
        _show(f"mp cli {name}", r)
        if r["rc"] != 0 or len(r["steps"]) != args.steps:
            ok = False
            print(r["stderr"], file=sys.stderr)
    for m in meshes:
        res = {"mesh": m, **_compare_fp32(runs, work, (f"mp_{m}",
                                                       "mp_twin"))}
        ok = ok and res["agree"]
        results["check"].append(res)
    twin_mesh = f"{args.nproc}x1"
    for arch, mps in (("chatglm3-6b", [meshes[0]]), ("yi-6b", meshes)):
        twin = _run_worker(args, "mp", twin_mesh,
                           work / f"mp_{arch}_twin.json", arch)
        _show(f"mp cells {arch} twin {twin_mesh}", twin)
        print(f"  median of steps 1-{args.steps - 1}: "
              f"{twin['median_step_s']} s", flush=True)
        ok = ok and twin["rc"] == 0 and len(twin["steps"]) == args.steps
        for m in mps:
            r = _run_worker(args, "mp", m, work / f"mp_{arch}_{m}.json", arch)
            _show(f"mp cells {arch} mesh {m}", r)
            print(f"  median of steps 1-{args.steps - 1}: "
                  f"{r['median_step_s']} s", flush=True)
            hy, dp = r["steps"], twin["steps"]
            agree = (r["rc"] == 0 and bool(hy) and len(hy) == len(dp)
                     and all(abs(a["loss"] - b["loss"])
                             <= LOSS_RTOL * abs(b["loss"])
                             for a, b in zip(hy, dp)))
            diff = (max(abs(a["loss"] - b["loss"]) for a, b in zip(hy, dp))
                    if hy and dp else None)
            print(f"  max |loss({m}) - loss(twin)| {diff} (bound rtol "
                  f"{LOSS_RTOL}): {'agree' if agree else 'DISAGREE'}",
                  flush=True)
            ok = ok and agree
            results["cells"].append({"arch": arch, "mesh": m, "twin": twin,
                                     "mp": r, "max_loss_diff": diff,
                                     "agree": agree})
    return results, ok


def ep_part(args, work: pathlib.Path) -> tuple:
    out = work / "ep.json"
    proc = _torchrun(args.nproc, [
        str(pathlib.Path(__file__).resolve()), "--worker", "ep",
        "--device", args.device, "--arch", "grok-1-314b", "--cells-config",
        args.cells_config, "--cells-seq", str(args.cells_seq),
        "--worker-out", str(out)], args.timeout)
    r = json.loads(out.read_text()) if out.exists() else {}
    r["rc"] = proc.returncode
    for k, v in r.items():
        print(f"ep {k}: {v}", flush=True)
    ok = proc.returncode == 0 and r.get("agree", False)
    if not ok:
        print(proc.stdout[-2000:], proc.stderr[-3000:], file=sys.stderr)
    return r, ok


def fsdp_part(args, work: pathlib.Path) -> tuple:
    results, ok = {}, True
    for kind in ("pair", "full"):
        out = work / f"fsdp_{kind}.json"
        proc = _torchrun(args.nproc, [
            str(pathlib.Path(__file__).resolve()), "--worker", f"fsdp-{kind}",
            "--device", args.device, "--cells-config", args.cells_config,
            "--cells-seq", str(args.cells_seq), "--steps", str(FSDP_STEPS),
            "--worker-out", str(out)], args.timeout)
        r = json.loads(out.read_text()) if out.exists() else {}
        r["rc"] = proc.returncode
        for k, v in r.items():
            print(f"fsdp {kind} {k}: {v}", flush=True)
        good = proc.returncode == 0 and r.get("agree", False)
        if not good:
            print(proc.stdout[-2000:], proc.stderr[-3000:], file=sys.stderr)
        ok = ok and good
        results[kind] = r
    return results, ok


def _fsdp_run(torch, sess, model, *, steps, seq, dev, lr=3e-4, seed=0):
    """`steps` train steps through `sess.make_train_step` at global batch
    8 (warmup-cosine AdamW at `lr`, weights and data from `seed`): (the
    state, each step's loss and seconds, the peak allocated bytes while
    the state was built and during the steps)."""
    import torch.distributed as dist
    from repro_torch.data import pipeline
    from repro_torch.models.transformer import Batch
    from repro_torch.optim import optimizers as opt_lib, schedules
    from repro_torch.train import trainer as tr
    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
    sched = schedules.warmup_cosine(lr, max(steps // 10, 1), steps)
    opt = opt_lib.make_optimizer("adamw", sched)
    state = tr.make_train_state(
        model, opt, torch.Generator(device=dev).manual_seed(seed), dev,
        planner=sess.planner)
    peak_init = torch.cuda.max_memory_allocated(dev) if cuda else None
    if cuda:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
    step = sess.make_train_step(model, opt, device=dev)
    dcfg = pipeline.DataConfig(vocab=model.cfg.vocab, seq_len=seq,
                               global_batch=8, seed=seed)
    recs = []
    for s, raw in enumerate(pipeline.iterate(dcfg, steps)):
        b = Batch(tokens=torch.from_numpy(raw["tokens"]).to(dev),
                  labels=torch.from_numpy(raw["labels"]).to(dev))
        dist.barrier()
        t0 = time.perf_counter()
        state, m = step(state, b)
        loss = float(m["loss"])
        recs.append({"step": s, "loss": loss,
                     "grad_norm": float(m["grad_norm"]),
                     "seconds": time.perf_counter() - t0})
    peak = torch.cuda.max_memory_allocated(dev) if cuda else None
    peaks = [None] * dist.get_world_size()
    dist.all_gather_object(peaks, (peak_init, peak))
    steady = [r["seconds"] for r in recs[1:]]
    return state, {"steps": recs,
                   "median_step_s": statistics.median(steady)
                   if steady else None,
                   "peak_bytes_init": [p[0] for p in peaks],
                   "peak_bytes": [p[1] for p in peaks],
                   "lrs": [float(sched(s)) for s in range(steps)]}


def fsdp_worker(args) -> int:
    """One rank of the fsdp part (see the module docstring)."""
    import dataclasses

    import torch
    import torch.distributed as dist
    from repro_torch import convert, tree as tree_lib
    from repro_torch.configs import registry
    from repro_torch.core.api import Session
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.models.transformer import Model
    from repro_torch.train import trainer as tr
    dev = mesh_lib.resolve_device(args.device)
    mesh = mesh_lib.make_host_mesh(args.nproc, 1, device=dev)
    rank0 = dist.get_rank() == 0
    base = (registry.get_config("yi-6b") if args.cells_config == "cells"
            else registry.get_smoke_config("yi-6b"))
    comm = tr.CommConfig(mode="gspmd", accum_steps=2)
    # a CPU rehearsal has no card: a budget of one byte chooses FSDP
    memory = (torch.cuda.get_device_properties(dev).total_memory
              if dev.type == "cuda" else 1.0)
    rec = {"device": [torch.cuda.get_device_name(dev)]
           if dev.type == "cuda" else ["cpu rehearsal"],
           "mesh": f"data {args.nproc} x model 1"}
    if args.worker == "fsdp-pair":
        cfg = (dataclasses.replace(base, n_layers=4)
               if args.cells_config == "cells" else base)
        model = Model(cfg)
        rec["config"] = (f"{cfg.name} n_layers={cfg.n_layers} batch 8 seq "
                         f"{args.cells_seq}, 2 microbatches")
        rep = Session.create(mesh, n_params=model.n_params(), comm=comm,
                             hbm_budget=1e15)
        fsdp = Session.create(mesh, n_params=model.n_params(), comm=comm,
                              hbm_budget=1.0)
        state, rec["replicated"] = _fsdp_run(torch, rep, model,
                                             steps=args.steps,
                                             seq=args.cells_seq, dev=dev)
        want = tree_lib.tree_map(lambda t: t.cpu(), state.params)
        del state
        mlsl = Session.create(mesh, n_params=model.n_params(),
                              comm=tr.CommConfig(mode="mlsl", accum_steps=2),
                              hbm_budget=1e15)
        state, rec["replicated_mlsl"] = _fsdp_run(
            torch, mlsl, model, steps=args.steps, seq=args.cells_seq,
            dev=dev)
        other = [t.cpu() for t in tree_lib.leaves(state.params)]
        del state
        state, rec["fsdp"] = _fsdp_run(torch, fsdp, model, steps=args.steps,
                                       seq=args.cells_seq, dev=dev)
        got = convert.gather_params(state.params,
                                    tr.param_specs(model, fsdp.planner),
                                    mesh)
        del state
        lrs = rec["fsdp"]["lrs"]
        excess, share = -float("inf"), 0.0
        w_excess, w_share = -float("inf"), 0.0
        planted = float("inf")
        specs = tree_lib.leaves(tr.param_specs(model, fsdp.planner))
        for a, b, o, spec in zip(tree_lib.leaves(got),
                                 tree_lib.leaves(want), other, specs):
            b = b.to(dev)
            e, sh = bf16_param_bound(a, b, lrs)
            excess, share = max(excess, e), max(share, sh)
            e, sh = bf16_param_bound(o.to(dev), b, lrs)
            w_excess, w_share = max(w_excess, e), max(w_share, sh)
            split = [d for d, ax in enumerate(spec) if ax is not None]
            if split:
                d = split[0]
                rolled = torch.roll(a, a.shape[d] // args.nproc, dims=d)
                planted = min(planted, bf16_param_bound(rolled, b, lrs)[0])
        hy, dp = rec["fsdp"]["steps"], rec["replicated"]["steps"]
        for key in ("loss", "grad_norm"):
            rec[f"max_{key}_rel_diff"] = max(abs(a[key] - b[key]) / abs(b[key])
                                             for a, b in zip(hy, dp))
        rec["param_excess_over_bound"] = excess
        rec["param_share_beyond_one_rounding"] = share
        rec["witness_mlsl_excess_over_bound"] = w_excess
        rec["witness_mlsl_share_beyond_one_rounding"] = w_share
        rec["planted_roll_min_excess_over_bound"] = planted
        rec["agree"] = (len(hy) == len(dp) == args.steps
                        and rec["max_loss_rel_diff"] <= LOSS_RTOL
                        and rec["max_grad_norm_rel_diff"] <= LOSS_RTOL
                        and excess <= 0 and planted > 0)
    else:
        model = Model(base)
        sess = Session.create(mesh, n_params=model.n_params(), comm=comm,
                              hbm_budget=memory)
        rec["config"] = (f"{base.name} n_layers={base.n_layers} "
                         f"({model.n_params():,} parameters) batch 8 seq "
                         f"{args.cells_seq}, 2 microbatches")
        rec["decide_fsdp"] = sess.planner.fsdp
        rec["replicated_state_bytes"] = model.n_params() * 14.0
        rec["hbm_budget"] = memory
        state, run = _fsdp_run(torch, sess, model, steps=args.steps,
                               seq=args.cells_seq, dev=dev)
        del state
        rec.update(run)
        rec["tokens_per_s"] = (8 * args.cells_seq / run["median_step_s"]
                               if run["median_step_s"] else None)
        rec["agree"] = bool(sess.planner.fsdp) and all(
            np.isfinite(s["loss"]) for s in run["steps"])
    if rank0:
        pathlib.Path(args.worker_out).write_text(json.dumps(rec))
    dist.destroy_process_group()
    return 0


def families_part(args, work: pathlib.Path) -> tuple:
    out = work / "families.json"
    proc = _torchrun(args.nproc, [
        str(pathlib.Path(__file__).resolve()), "--worker", "families",
        "--device", args.device, "--cells-config", args.cells_config,
        "--cells-seq", str(args.cells_seq), "--steps", str(args.steps),
        "--families", args.families, "--worker-out", str(out)],
        args.timeout)
    r = json.loads(out.read_text()) if out.exists() else {}
    r["rc"] = proc.returncode
    for pair in r.get("families", []):
        for name in ("twin", "mp"):
            _show(f"families {pair['arch']} {name}",
                  {"rc": proc.returncode, "plan": [], **pair[name]})
            print(f"  median of steps 1-{args.steps - 1}: "
                  f"{pair[name]['median_step_s']} s", flush=True)
        print(f"  max |mp - twin|: loss {pair['max_loss_diff']} (bound "
              f"{LOSS_ATOL}), gnorm {pair['max_gnorm_diff']} (bound "
              f"{GNORM_ATOL}): {'agree' if pair['agree'] else 'DISAGREE'}",
              flush=True)
    for name, run in r.get("grok", {}).items():
        if not isinstance(run, dict):
            print(f"families grok {name}: {run}", flush=True)
            continue
        _show(f"families grok {name}",
              {"rc": proc.returncode, "plan": [], **run})
        print(f"  median of steps 1-{args.steps - 1}: {run['median_step_s']}"
              f" s, {run['tokens_per_s']} tok/s; peak per rank while the "
              f"state was built {run['peak_bytes_init']} B", flush=True)
    ok = proc.returncode == 0 and r.get("agree", False)
    if not ok:
        print(proc.stdout[-2000:], proc.stderr[-3000:], file=sys.stderr)
    return r, ok


def _family_run(torch, model, mesh, planner, comm, opt, *, steps, batch,
                seq, dev, seed=0):
    """`steps` train steps of `model` from weights and data drawn from
    `seed` (the stub patch or frame embeddings standard normal): each
    step's loss, gradient norm and seconds (host clock, from a barrier to
    the loss on the host), the median of steps 1 on, tok/s (a VLM's image
    positions counted) and each rank's peak allocated bytes while the
    state was built (every rank draws the full weights before keeping its
    shards) and during the steps."""
    import torch.distributed as dist
    from repro_torch.core.planner import mesh_shape
    from repro_torch.data import pipeline
    from repro_torch.models.transformer import Batch
    from repro_torch.train import trainer as tr
    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
    state = tr.make_train_state(
        model, opt, torch.Generator(device=dev).manual_seed(seed), dev,
        planner=planner)
    peak_init = torch.cuda.max_memory_allocated(dev) if cuda else None
    if cuda:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
    step = tr.make_train_step(model, opt, mesh, planner, comm, device=dev)
    cfg = model.cfg
    dcfg = pipeline.DataConfig(vocab=cfg.vocab, seq_len=seq,
                               global_batch=batch, seed=seed)
    rng = np.random.default_rng(seed)
    recs = []
    for s, raw in enumerate(pipeline.iterate(dcfg, steps)):
        stub = {}
        if cfg.vlm_img_tokens:
            stub["img_embeds"] = rng.standard_normal(
                (batch, cfg.vlm_img_tokens, cfg.vlm_d_vision))
        if cfg.encoder is not None:
            stub["frame_embeds"] = rng.standard_normal(
                (batch, cfg.encoder.n_frames, cfg.encoder.d_input))
        b = Batch(tokens=torch.from_numpy(raw["tokens"]).to(dev),
                  labels=torch.from_numpy(raw["labels"]).to(dev),
                  **{k: torch.from_numpy(v.astype(np.float32)).to(dev)
                     for k, v in stub.items()})
        dist.barrier()
        t0 = time.perf_counter()
        state, m = step(state, b)
        loss = float(m["loss"])
        recs.append({"step": s, "loss": loss,
                     "grad_norm": float(m["grad_norm"]),
                     "seconds": time.perf_counter() - t0})
    del state, step
    peak = torch.cuda.max_memory_allocated(dev) if cuda else None
    peaks = [None] * dist.get_world_size()
    dist.all_gather_object(peaks, (peak_init, peak))
    steady = [r["seconds"] for r in recs[1:]]
    median = statistics.median(steady) if steady else None
    positions = seq + cfg.vlm_img_tokens
    return {"mesh": [f"mesh={mesh_shape(mesh)}"], "steps": recs,
            "median_step_s": median,
            "tokens_per_s": batch * positions / median if median else None,
            "peak_bytes_init": [p[0] for p in peaks],
            "peak_bytes": [p[1] for p in peaks]}


def families_worker(args) -> int:
    """One rank of the families part (see the module docstring)."""
    import dataclasses

    import torch
    import torch.distributed as dist
    from repro_torch.configs import registry
    from repro_torch.core import planner as pl
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.models import moe
    from repro_torch.models.transformer import Model
    from repro_torch.optim import optimizers as opt_lib, schedules
    from repro_torch.train import trainer as tr
    dev = mesh_lib.resolve_device(args.device)
    n = args.nproc
    twin_mesh = mesh_lib.make_host_mesh(n, 1, device=dev)
    mp_mesh = mesh_lib.make_host_mesh(1, n, device=dev)
    cells = args.cells_config == "cells"
    rec = {"device": [torch.cuda.get_device_name(dev)]
           if dev.type == "cuda" else ["cpu rehearsal"], "families": []}
    agree = True
    chosen = args.families.split(",")
    for arch, layers, seq in FAMILIES:
        if arch not in chosen:
            continue
        cfg = registry.get_config(arch) if cells else \
            registry.get_smoke_config(arch)
        if cells:
            cfg = dataclasses.replace(cfg, n_layers=layers or cfg.n_layers,
                                      dtype=torch.float32)
        seq = min(seq or args.cells_seq, cfg.learned_positions or 2 ** 31)
        model = Model(cfg)
        pair = {"arch": arch, "config": f"{cfg.name} n_layers="
                f"{cfg.n_layers} f32 ({model.n_params():,} parameters), "
                f"batch 8 seq {seq}"}
        for name, mesh in (("twin", twin_mesh), ("mp", mp_mesh)):
            pair[name] = _family_run(
                torch, model, mesh, pl.Planner(mesh=mesh),
                tr.CommConfig(mode="mlsl"), opt_lib.make_optimizer("sgd",
                                                                   0.1),
                steps=args.steps, batch=8, seq=seq, dev=dev)
        a, b = pair["mp"]["steps"], pair["twin"]["steps"]
        pair["max_loss_diff"] = max(abs(x["loss"] - y["loss"])
                                    for x, y in zip(a, b))
        pair["max_gnorm_diff"] = max(abs(x["grad_norm"] - y["grad_norm"])
                                     for x, y in zip(a, b))
        pair["agree"] = (len(a) == len(b) == args.steps
                         and pair["max_loss_diff"] <= LOSS_ATOL
                         and pair["max_gnorm_diff"] <= GNORM_ATOL)
        agree = agree and pair["agree"]
        rec["families"].append(pair)
    rec["agree"] = agree
    if "grok-1-314b" not in chosen:
        if dist.get_rank() == 0:
            pathlib.Path(args.worker_out).write_text(json.dumps(rec))
        dist.destroy_process_group()
        return 0
    cfg = registry.get_config("grok-1-314b") if cells else \
        registry.get_smoke_config("grok-1-314b")
    if cells:
        cfg = dataclasses.replace(cfg, n_layers=GROK_LAYERS)
    model = Model(cfg)
    seq = args.cells_seq
    grok = {"config": f"{cfg.name} n_layers={cfg.n_layers} "
                      f"({model.n_params():,} parameters), global batch "
                      f"{GROK_BATCH} x {seq}, AdamW warmup-cosine 3e-4, "
                      f"gspmd"}
    for name, mesh, planner, kw in (
            ("fsdp", twin_mesh, pl.Planner(mesh=twin_mesh, fsdp=True), {}),
            ("gather", mp_mesh, pl.Planner(mesh=mp_mesh), {}),
            ("ep", mp_mesh, pl.Planner(mesh=mp_mesh), {"moe_impl": "ep"})):
        sched = schedules.warmup_cosine(3e-4, 1, args.steps)
        grok[name] = _family_run(
            torch, model, mesh, planner, tr.CommConfig(mode="gspmd", **kw),
            opt_lib.make_optimizer("adamw", sched), steps=args.steps,
            batch=GROK_BATCH, seq=seq, dev=dev)
    a, b = grok["gather"]["steps"], grok["fsdp"]["steps"]
    grok["max_loss_rel_diff"] = max(abs(x["loss"] - y["loss"]) / abs(y["loss"])
                                    for x, y in zip(a, b))
    grok["agree"] = (len(a) == len(b) == args.steps
                     and grok["max_loss_rel_diff"] <= LOSS_RTOL)
    # the ep run's exchange: each source rank's GROK_BATCH * seq / n tokens
    # at their own capacity, (n, experts a rank * capacity, d) a call
    group = mp_mesh.get_group("model")
    e_loc = cfg.moe.n_experts // n
    cap = moe.capacity(GROK_BATCH * seq // n, cfg.moe)
    buf = torch.zeros((n, e_loc * cap, cfg.d_model), dtype=cfg.dtype,
                      device=dev)
    a2a = _median_s(torch, lambda: moe._all_to_all(buf, group))
    calls = 6 * cfg.n_layers
    grok["ep"]["all_to_all_s"] = a2a
    grok["ep"]["all_to_all_bytes"] = buf.numel() * buf.element_size()
    grok["ep"]["all_to_all_share"] = (calls * a2a
                                      / grok["ep"]["median_step_s"]
                                      if grok["ep"]["median_step_s"]
                                      else None)
    rec["grok"] = grok
    rec["agree"] = agree and grok["agree"]
    if dist.get_rank() == 0:
        pathlib.Path(args.worker_out).write_text(json.dumps(rec))
    dist.destroy_process_group()
    return 0


def serve_part(args, work: pathlib.Path) -> tuple:
    out = work / "serve.json"
    proc = _torchrun(args.nproc, [
        str(pathlib.Path(__file__).resolve()), "--worker", "serve",
        "--device", args.device, "--cells-config", args.cells_config,
        "--cells-seq", str(args.cells_seq), "--worker-out", str(out)],
        args.timeout)
    r = json.loads(out.read_text()) if out.exists() else {}
    r["rc"] = proc.returncode
    for seed, yi in r.get("yi", {}).items():
        print(f"serve yi-6b seed {seed} one card, bf16 against f32: "
              f"relative RMS {max(yi['one_card_vs_f32']):.3e}", flush=True)
        for name, run in yi["layouts"].items():
            print(f"serve yi-6b seed {seed} {name}: to f32 "
                  f"{max(run['rel_rms_f32']):.3e} (worst step ratio "
                  f"{run['f32_ratio']:.3f} to the one card's, bound "
                  f"{YI_F32_FACTOR:.3f}), to the one card "
                  f"{run['worst_rel_rms']:.3e} (ratio {run['one_ratio']:.3f}"
                  f", bound {YI_ONE_FACTOR:.3f}), first tokens equal in "
                  f"{run['first_tokens_equal']} rows, ties "
                  f"{run['first_token_ties']}; {_times(run)}", flush=True)
    grok = r.get("grok", {})
    for name in ("gather", "ep"):
        if name in grok:
            print(f"serve grok-1 {name}: {_times(grok[name])}", flush=True)
    if "moe_layers" in grok:
        g = grok["moe_layers"]
        print(f"serve grok-1 moe layers, ep against gather on the same "
              f"input (no drops): worst relative RMS "
              f"{max(g['rel_rms']):.3e} (bound {GROK_MOE_TOL}); control "
              f"{g['control_rel_rms']:.3e}; the two prefills' last-token "
              f"logits {g['prefill_logits_rel_rms']:.3e} apart, first "
              f"tokens equal in {g['prefill_first_tokens_equal']} rows",
              flush=True)
    ok = proc.returncode == 0 and r.get("agree", False)
    print(f"serve: {'agree' if ok else 'FAILED'}", flush=True)
    if not ok:
        print(proc.stdout[-3000:], proc.stderr[-4000:], file=sys.stderr)
    return r, ok


def _times(run: dict) -> str:
    t = run.get("times")
    if not t:
        return ""
    return (f"prefill {t['prefill_s']:.4f} s, TTFT {t['ttft_s']:.4f} s, "
            f"decode step {t['decode_step_s']:.5f} s, "
            f"{t['decode_tok_s']:.1f} tok/s; peak a rank "
            f"{run.get('peak_bytes')}")


def seeded_params(torch, model, dev, *, seed=0, planner=None, mesh=None):
    """This rank's shards under `planner` on `mesh` (the whole parameters
    without one) of weights drawn one leaf at a time, a stacked leaf one
    repeat at a time, each from a generator seeded by (seed, leaf path,
    repeat): the same weights under every layout, and at most one
    repeat of one leaf drawn whole at a time."""
    import dataclasses
    import zlib
    from repro_torch import convert, tree as tree_lib
    from repro_torch.models import common
    from repro_torch.train import trainer as tr
    specs = (tr.param_specs(model, planner) if planner is not None else
             tree_lib.tree_map(lambda pd: (None,) * len(pd.shape),
                               model.param_defs()))
    coord = (None if mesh is None else
             {a: mesh.get_local_rank(a) for a in mesh.mesh_dim_names})
    sizes = {"_": 1} if mesh is None else None

    def draw(path, pd, shape, key):
        gen = torch.Generator(device=dev).manual_seed(zlib.crc32(
            f"{seed}/{'/'.join(path)}/{key}".encode()))
        return common.init_param(gen, dataclasses.replace(pd, shape=shape),
                                 dev)

    def cut(t, spec):
        return convert.shard_params({"x": t}, {"x": spec},
                                    sizes or mesh, coord or {})["x"]

    def one(path, pd, spec):
        if not model.stacked_path(path):
            return cut(draw(path, pd, pd.shape, "-"), spec)
        out = None
        for r in range(pd.shape[0]):
            part = cut(draw(path, pd, pd.shape[1:], r), spec[1:])
            if out is None:
                out = part.new_empty((pd.shape[0], *part.shape))
            out[r] = part
            del part
        return out
    return tree_lib.map_with_path(one, model.param_defs(), specs)


def _serve_times(torch, engine, prompts, n_new, dev) -> tuple:
    """`engine.generate` timed: (the tokens, prefill s, TTFT, the mean
    decode step after the first, tok/s; each rank's peak allocated
    bytes)."""
    import torch.distributed as dist
    if dev.type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
    dist.barrier()
    t = {}
    toks = engine.generate(prompts, n_new, timings=t)
    steady = t["decode_s"][1:] or t["decode_s"]
    step = sum(steady) / len(steady)
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" \
        else None
    peaks = [None] * dist.get_world_size()
    dist.all_gather_object(peaks, peak)
    return toks, {"prefill_s": t["prefill_s"],
                  "ttft_s": t["first_token_s"], "decode_step_s": step,
                  "decode_tok_s": prompts.shape[0] / step}, peaks


def _teacher_forced(torch, model, params, engine, prompts, teacher,
                    dev) -> list:
    """The prefill's and each step's logits (f32, on the host) of the
    whole batch, `teacher` (B, steps) fed to the decode steps."""
    from repro_torch.models.transformer import Batch
    kw = {**engine.mp_kw, **engine.ctx_kw}
    if "tp_axis" in kw:
        kw["max_seq"] = engine.cfg.max_seq
    rows = torch.as_tensor(engine.rows(prompts), device=dev)
    logits, cache, pos = model.prefill(
        params, Batch(tokens=rows), engine.cfg.max_seq,
        **{k: v for k, v in kw.items() if k != "max_seq"})
    out = [engine.whole(logits).float().cpu()]
    tf = torch.as_tensor(engine.rows(teacher), device=dev)
    for i in range(teacher.shape[1]):
        logits, cache = model.decode_step(params, cache, tf[:, i:i + 1],
                                          pos + i, **kw)
        out.append(engine.whole(logits).float().cpu())
    del cache
    return out


def _first_tokens(got, one, f32) -> dict:
    """The first greedy token of each row against the one-card run's. A
    row whose tokens differ is a tie bf16 does not resolve when the two
    runs' measured errors (to the f32 evaluation) at the two competing
    logits, the one card's token and the layout's, reach the one-card
    run's gap between them: the roundings alone can then swap the two.
    Ties are counted the same way for every row (the competing logit of
    a row whose tokens agree is the one card's second), and a differing
    row that is no tie fails."""
    i1 = one.argmax(-1)
    i2 = one.topk(2, dim=-1).indices[:, 1]
    equal = got.argmax(-1) == i1
    j = got.argmax(-1).where(~equal, i2)

    def at(t, i):
        return t.gather(-1, i[:, None])[:, 0]
    gap = at(one, i1) - at(one, j)
    reach = sum((at(e, i1).abs() + at(e, j).abs())
                for e in (one - f32, got - f32))
    ties = gap <= reach
    return {"first_tokens_equal": int(equal.sum()),
            "first_token_ties": int(ties.sum()),
            "first_tokens_held": bool((equal | ties).all())}


def _rel_rms(a, b) -> float:
    return float((a - b).square().mean().sqrt() / b.square().mean().sqrt())


def serve_worker(args) -> int:
    """One rank of the serve part (see the module docstring)."""
    import dataclasses

    import torch
    import torch.distributed as dist
    from repro_torch.configs import registry
    from repro_torch.core import planner as pl
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.models.transformer import Model
    from repro_torch.serve.engine import Engine, EngineConfig
    from repro_torch.train import trainer as tr
    dev = mesh_lib.resolve_device(args.device)
    n = args.nproc
    cells = args.cells_config == "cells"
    prompt = SERVE_PROMPT if cells else args.cells_seq
    new = SERVE_NEW if cells else 4
    steps = YI_STEPS if cells else 4
    mp_mesh = mesh_lib.make_host_mesh(1, n, device=dev)
    rank0 = dist.get_rank() == 0
    rec = {"device": [torch.cuda.get_device_name(dev)]
           if dev.type == "cuda" else ["cpu rehearsal"], "yi": {}}
    agree = True

    def get(arch):
        return registry.get_config(arch) if cells else \
            registry.get_smoke_config(arch)

    # bf16 also in a rehearsal (the smoke config's f32 would be its own
    # witness)
    cfg = dataclasses.replace(get("yi-6b"), dtype=torch.bfloat16)
    for seed in YI_SEEDS:
        yi = _yi_seed(torch, Model(cfg), mp_mesh, dev, seed=seed,
                      prompt=prompt, steps=steps,
                      new=new if seed == YI_SEEDS[0] else None)
        rec["yi"][seed] = yi
        agree = agree and yi.get("agree", True)

    # grok-1 at SERVE_GROK_LAYERS layers over the model group of n ranks
    cfg = get("grok-1-314b")
    if cells:
        cfg = dataclasses.replace(cfg, n_layers=SERVE_GROK_LAYERS)
    model = Model(cfg)
    prompts = np.random.default_rng(1).integers(
        0, cfg.vocab, (SERVE_BATCH, prompt)).astype(np.int32)
    planner = pl.Planner(mesh=mp_mesh)
    params = seeded_params(torch, model, dev, planner=planner, mesh=mp_mesh)
    grok = {"config": f"{cfg.name} n_layers={cfg.n_layers} "
                      f"({model.n_params():,} parameters), (1, {n}) "
                      f"Planner(mesh), {SERVE_BATCH} x {prompt}, {new} "
                      f"new tokens, greedy"}
    group = mp_mesh.get_group("model")
    # the all-reduces' times on buffers of their shapes: the prefill's
    # (batch, prompt, d) and a decode step's (batch, 1, d), 2 a layer and
    # the embedding's
    calls = 2 * cfg.n_layers + 1
    for kind, shape in (("prefill", (SERVE_BATCH, prompt, cfg.d_model)),
                        ("decode", (SERVE_BATCH, 1, cfg.d_model))):
        buf = torch.zeros(shape, dtype=cfg.dtype, device=dev)
        grok[f"all_reduce_{kind}_s"] = _median_s(
            torch, lambda: dist.all_reduce(buf, group=group))
        del buf
    for name, comm in (("gather", tr.CommConfig()),
                       ("ep", tr.CommConfig(moe_impl="ep"))):
        eng = Engine(model, params, EngineConfig(max_seq=prompt + new + 8),
                     mesh=mp_mesh, planner=planner, comm=comm)
        # a warm-up: the ep dispatch's first all-to-all sets up NCCL's
        # peer-to-peer connections, the first prefill the allocator's pool
        eng.generate(prompts, 2)
        toks, times, peaks = _serve_times(torch, eng, prompts, new, dev)
        run = {"times": times, "peak_bytes": peaks,
               "tokens_in_vocab": bool(((toks >= 0) & (toks < cfg.vocab))
                                       .all()),
               "all_reduce_share_prefill": calls * grok[
                   "all_reduce_prefill_s"] / times["prefill_s"],
               "all_reduce_share_decode": calls * grok[
                   "all_reduce_decode_s"] / times["decode_step_s"]}
        if name == "gather":
            grok_tokens = toks
        else:
            run["tokens_equal_gather"] = float((toks == grok_tokens).mean())
        run["agree"] = run["tokens_in_vocab"] and all(
            p is None or p < HBM for p in peaks)
        agree = agree and run["agree"]
        grok[name] = run
        del eng
    m = cfg.moe
    nodrop = Model(dataclasses.replace(cfg, moe=dataclasses.replace(
        m, capacity_factor=m.n_experts / m.top_k)))
    g = _moe_layers(torch, nodrop, params, mp_mesh, planner, prompts,
                    prompt + 8, dev)
    g["agree"] = max(g["rel_rms"]) <= GROK_MOE_TOL \
        and g["control_rel_rms"] > GROK_MOE_TOL
    agree = agree and g["agree"]
    grok["moe_layers"] = g
    rec["grok"] = grok
    rec["agree"] = agree
    if rank0:
        pathlib.Path(args.worker_out).write_text(json.dumps(rec))
    dist.destroy_process_group()
    return 0


def _yi_seed(torch, model, mp_mesh, dev, *, seed, prompt, steps, new):
    """yi-6b's layouts against the one-card run and the f32 witness, at
    weights and prompts of `seed` (see the module docstring); `new`: also
    the control and each layout's times over that many new tokens."""
    import dataclasses

    import torch.distributed as dist
    from repro_torch import tree as tree_lib
    from repro_torch.core import planner as pl
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.models.transformer import Model
    from repro_torch.serve.engine import Engine, EngineConfig
    cfg, n = model.cfg, dist.get_world_size()
    rank0 = dist.get_rank() == 0
    max_seq = prompt + max(new or 0, steps) + 8
    ecfg = EngineConfig(max_seq=max_seq)
    prompts = np.random.default_rng(seed).integers(
        0, cfg.vocab, (SERVE_BATCH, prompt)).astype(np.int32)
    teacher = torch.zeros((SERVE_BATCH, steps), dtype=torch.int32,
                          device=dev)
    one_card, f32, yi = [], [], {
        "config": f"{cfg.name} ({model.n_params():,} parameters), "
                  f"{SERVE_BATCH} x {prompt}, {steps} teacher-forced steps, "
                  f"seed {seed}",
        "layouts": {}}
    if rank0:
        whole = seeded_params(torch, model, dev, seed=seed)
        eng = Engine(model, whole, ecfg)
        teacher.copy_(torch.as_tensor(eng.generate(prompts, steps),
                                      device=dev))
        one_card = _teacher_forced(torch, model, whole, eng, prompts,
                                   teacher.cpu().numpy(), dev)
        # the witness: the same bf16 weights evaluated in f32, how far
        # the one-card bf16 run itself lies from the function it rounds
        model32 = Model(dataclasses.replace(cfg, dtype=torch.float32))
        whole = tree_lib.tree_map(lambda t: t.float(), whole)
        f32 = _teacher_forced(torch, model32, whole,
                              Engine(model32, whole, ecfg), prompts,
                              teacher.cpu().numpy(), dev)
        yi["one_card_vs_f32"] = [_rel_rms(a, b) for a, b in zip(one_card,
                                                                f32)]
        del whole, eng, model32
    dist.broadcast(teacher, 0)
    teacher = teacher.cpu().numpy()
    layouts = [("1x%d" % n, (1, n), False), ("2x%d" % (n // 2), (2, n // 2),
                                            False)]
    if new:
        layouts.append(("1x%d zeroed wo shard" % n, (1, n), True))
    agree = True
    for name, (data, msize), control in layouts:
        mesh = mp_mesh if data == 1 else mesh_lib.make_host_mesh(
            data, msize, device=dev)
        planner = pl.Planner(mesh=mesh)
        params = seeded_params(torch, model, dev, seed=seed, planner=planner,
                               mesh=mesh)
        if control and mesh.get_local_rank("model") == 1:
            params["blocks"]["p0_attn"]["attn"]["wo"].zero_()
        eng = Engine(model, params, ecfg, mesh=mesh, planner=planner)
        got = _teacher_forced(torch, model, params, eng, prompts, teacher,
                              dev)
        run = {}
        if new and not control:
            _, run["times"], run["peak_bytes"] = _serve_times(
                torch, eng, prompts, new, dev)
        if rank0:
            own = yi["one_card_vs_f32"]
            errs = [_rel_rms(a, b) for a, b in zip(got, one_card)]
            to32 = [_rel_rms(a, b) for a, b in zip(got, f32)]
            run.update(rel_rms=errs, worst_rel_rms=max(errs),
                       rel_rms_f32=to32,
                       f32_ratio=max(a / b for a, b in zip(to32, own)),
                       one_ratio=max(a / b for a, b in zip(errs, own)),
                       **_first_tokens(got[0], one_card[0], f32[0]))
            within = run["f32_ratio"] <= YI_F32_FACTOR and \
                run["one_ratio"] <= YI_ONE_FACTOR
            # the control must fail the bounds
            run["agree"] = (not within) if control else \
                within and run["first_tokens_held"]
            agree = agree and run["agree"]
        yi["layouts"][name] = run
        del params, eng, got
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    yi["agree"] = agree
    return yi


def _moe_layers(torch, model, params, mesh, planner, prompts, max_seq,
                dev) -> dict:
    """The gather dispatch's prefill of `prompts` with every moe layer
    run on the ep dispatch too, on the same input: each layer's relative
    RMS of the ep output against the gather's (the cascade follows the
    gather's), and the first layer's with rank 1's `w2` shard zeroed on
    the ep side (the control); then the ep dispatch's own prefill, and
    its last-token logits against the gather's."""
    import torch.distributed as dist
    from repro_torch.models import blocks, moe
    from repro_torch.models.transformer import Batch
    from repro_torch.serve.engine import Engine, EngineConfig
    from repro_torch.train import trainer as tr
    cfg = model.cfg
    ecfg = EngineConfig(max_seq=max_seq)
    gather = Engine(model, params, ecfg, mesh=mesh, planner=planner)
    ep_eng = Engine(model, params, ecfg, mesh=mesh, planner=planner,
                    comm=tr.CommConfig(moe_impl="ep"))
    ep = ep_eng.mp_kw["moe"]
    group = ep["model_group"]
    errs, control = [], []
    residual = blocks._moe_residual

    def both(p, h, ctx):
        x = blocks.norm_apply(p["ln2"], h, cfg)
        tp, lay = ctx.sub_tp("moe")
        y, aux = moe.moe_apply(p["moe"], x, cfg.moe, act=cfg.mlp_act,
                               batch_groups=ctx.batch_groups, tp_axis=tp,
                               layout=lay)

        def on_ep(pm):
            return moe.moe_apply_ep(
                pm, x, cfg.moe, act=cfg.mlp_act, model_group=group,
                batch_groups=ep["batch_groups"], wgather_wire="bf16",
                layout=lay)[0]
        errs.append(_rel_rms(on_ep(p["moe"]).float(), y.float()))
        if not control:
            pm = p["moe"]
            if dist.get_rank(group) == 1:
                pm = {**pm, "w2": torch.zeros_like(pm["w2"])}
            control.append(_rel_rms(on_ep(pm).float(), y.float()))
        return h + y, aux

    tokens = torch.as_tensor(prompts, device=dev)
    blocks._moe_residual = both
    try:
        logits_g = model.prefill(params, Batch(tokens=tokens), max_seq,
                                 **gather.mp_kw)[0].float().cpu()
    finally:
        blocks._moe_residual = residual
    logits_e = model.prefill(params, Batch(tokens=tokens), max_seq,
                             **ep_eng.mp_kw)[0].float().cpu()
    return {"capacity_factor": cfg.moe.capacity_factor, "rel_rms": errs,
            "control_rel_rms": control[0],
            "prefill_logits_rel_rms": _rel_rms(logits_e, logits_g),
            "prefill_first_tokens_equal": int(
                (logits_e.argmax(-1) == logits_g.argmax(-1)).sum())}


def _median_s(torch, fn, n=5):
    """The median host time of fn() over n calls after one warm-up, each
    ending in a device synchronize and a barrier."""
    import torch.distributed as dist
    times = []
    for i in range(n + 1):
        dist.barrier()
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        if i:
            times.append(time.perf_counter() - t0)
    return statistics.median(times)


def ep_worker(args) -> int:
    """One rank of the ep part (see the module docstring)."""
    import dataclasses

    import torch
    import torch.distributed as dist
    from repro_torch import tree as tree_lib
    from repro_torch.configs import registry
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.models import common, moe
    dev = mesh_lib.resolve_device(args.device)
    cfg = (registry.get_config(args.arch) if args.cells_config == "cells"
           else registry.get_smoke_config(args.arch))
    mesh = mesh_lib.make_host_mesh(1, args.nproc, device=dev)
    group = mesh.get_group("model")
    ep, r = dist.get_world_size(group), dist.get_rank(group)
    rank0 = dist.get_rank() == 0
    gen = torch.Generator(device=dev).manual_seed(7)
    # rank 0 draws the whole layer and x, and every rank receives them
    defs = moe.moe_defs(cfg.d_model, cfg.moe, cfg.dtype)
    full = (common.init_tree(gen, defs, dev) if rank0 else
            tree_lib.tree_map(lambda pd: torch.empty(
                pd.shape, dtype=pd.dtype, device=dev), defs))
    x = (torch.randn((2, args.cells_seq, cfg.d_model), generator=gen,
                     device=dev) if rank0 else
         torch.empty((2, args.cells_seq, cfg.d_model), device=dev))
    x = x.to(cfg.dtype)
    for t in [x, *tree_lib.leaves(full)]:
        dist.broadcast(t, 0)
    e_loc = cfg.moe.n_experts // ep
    mine = {k: (v[r * e_loc:(r + 1) * e_loc].clone()
                if k in ("w1", "w2", "w3") else v) for k, v in full.items()}
    rec = {"config": f"{cfg.name}: one MoE layer, {cfg.moe.n_experts} "
                     f"experts of d_ff {cfg.moe.d_ff}, d {cfg.d_model}, "
                     f"x {tuple(x.shape)}, model group {ep}",
           "device": [torch.cuda.get_device_name(dev)]
           if dev.type == "cuda" else ["cpu rehearsal"]}
    m8 = dataclasses.replace(cfg.moe, capacity_factor=8.0)
    with torch.no_grad():
        y, aux = moe.moe_apply_ep(mine, x, m8, act=cfg.mlp_act,
                                  model_group=group)
        errs = torch.zeros(2, device=dev)
        if rank0:
            y_ref, _ = moe.moe_apply(full, x, m8, act=cfg.mlp_act)
            t_loc = x.shape[0] * x.shape[1] // ep
            xs = x.reshape(ep, 1, t_loc, cfg.d_model)
            aux_ref = sum(float(moe.moe_apply(full, xs[i], m8,
                                              act=cfg.mlp_act)[1])
                          for i in range(ep)) / ep
            errs[0] = (y.float() - y_ref.float()).abs().max() / \
                y_ref.float().abs().max()
            errs[1] = abs(float(aux) - aux_ref)
            del y_ref
        dist.broadcast(errs, 0)
        rec["cap8_y_rel_err"], rec["cap8_aux_abs_err"] = map(float, errs)
        y125, _ = moe.moe_apply_ep(mine, x, cfg.moe, act=cfg.mlp_act,
                                   model_group=group)
        finite = torch.tensor([float(torch.isfinite(y125).all())],
                              device=dev)
        dist.all_reduce(finite, op=dist.ReduceOp.MIN)
        rec["cap1.25_finite"] = bool(finite.item())
        del full, y, y125
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        rec["forward_s"] = _median_s(torch, lambda: moe.moe_apply_ep(
            mine, x, cfg.moe, act=cfg.mlp_act, model_group=group))
        cap = moe.capacity(x.shape[0] * x.shape[1] // ep, cfg.moe)
        buf = torch.zeros((ep, e_loc * cap, cfg.d_model), dtype=cfg.dtype,
                          device=dev)
        rec["all_to_all_s"] = _median_s(torch, lambda: [
            moe._all_to_all(buf, group) for _ in range(2)])
    leaves = {k: v.requires_grad_(True) for k, v in mine.items()}

    def fwd_bwd():
        y, aux = moe.moe_apply_ep(leaves, x, cfg.moe, act=cfg.mlp_act,
                                  model_group=group)
        loss = y.float().square().mean() + cfg.moe.router_aux_weight * aux
        torch.autograd.grad(loss, list(leaves.values()))

    rec["forward_backward_s"] = _median_s(torch, fwd_bwd)
    rec["all_to_all_share_of_forward"] = (rec["all_to_all_s"]
                                          / rec["forward_s"])
    rec["agree"] = (rec["cap8_y_rel_err"] <= EP_TOL
                    and rec["cap8_aux_abs_err"] <= 1e-5
                    and rec["cap1.25_finite"])
    if rank0:
        pathlib.Path(args.worker_out).write_text(json.dumps(rec))
    dist.destroy_process_group()
    return 0


def worker(args) -> int:
    """One rank of a cells, stats or mp run: train() on the run's mesh,
    rank 0 writes the plan lines, the step records and every rank's peak
    (stats: and the CommStats table with the measured column)."""
    import dataclasses
    import tempfile

    import torch
    import torch.distributed as dist
    from repro_torch.configs import registry
    from repro_torch.core import planner as pl
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.launch import train as train_lib
    from repro_torch.models.transformer import Model
    from repro_torch.obs import detect, meter as obs_meter, telemetry
    from repro_torch.train import trainer as tr
    dev = mesh_lib.resolve_device(args.device)
    cfg = (dataclasses.replace(registry.get_config(args.arch), n_layers=4)
           if args.cells_config == "cells"
           else registry.get_smoke_config(args.arch))
    batch, seq = 8, args.cells_seq
    if args.worker == "mp":
        # plain model parallelism or its data-parallel twin (model 1): the
        # CLI's Planner(mesh), cell A's exchange
        hier = args.mesh.startswith("h")
        sizes = [int(v) for v in args.mesh.lstrip("h").split("x")]
        mesh = (mesh_lib.make_hier_mesh(*sizes, device=dev) if hier
                else mesh_lib.make_host_mesh(*sizes, device=dev))
        comm = tr.CommConfig(mode="mlsl", wire=args.wire,
                             error_feedback=args.wire == "int8",
                             accum_steps=2, hier=hier)
        planner = pl.Planner(mesh=mesh)
    else:
        nodes, local = (int(v) for v in args.mesh.split("x"))
        mesh = mesh_lib.make_hier_mesh(nodes, local, device=dev)
        comm = tr.CommConfig(mode="mlsl", wire=args.wire, accum_steps=2,
                             hier=True)
        planner = (pl.make_hybrid_planner(mesh, cfg, batch=batch, seq=seq)
                   if args.worker == "hybrid"
                   else pl.Planner(mesh=mesh, dp_only=True))
    rank0 = dist.get_rank() == 0
    hooks, engine, tmp = {}, None, tempfile.mkdtemp()
    if args.worker == "stats":
        engine = tr.make_comm_engine(Model(cfg), mesh, planner, comm,
                                     device=dev)
        hooks = dict(meter=obs_meter.StepMeter(tokens_per_step=batch * seq),
                     timer=engine.bucket_timer(mesh), sample_every=1)
        if rank0:
            hooks["monitor"] = detect.HealthMonitor.from_plan(
                engine.plan, config=detect.DetectorConfig.wallclock())
            hooks["telemetry"] = telemetry.TelemetryWriter(
                os.path.join(tmp, "telemetry.jsonl"), sample_every=1)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    recs, state = train_lib.train(cfg, comm, steps=args.steps, batch=batch,
                                  seq=seq, lr=3e-4, optimizer="adamw",
                                  seed=0, device=dev, mesh=mesh,
                                  planner=planner, **hooks)
    del state
    stats = None
    if engine is not None:
        stats = engine.stats(measured=hooks["timer"].sample(iters=5,
                                                            warmup=1))
    peak = (torch.cuda.max_memory_allocated(dev) if dev.type == "cuda"
            else None)
    peaks = [None] * dist.get_world_size()
    dist.all_gather_object(peaks, peak)
    if rank0:
        plan = ([train_lib.plan_line(lp) for lp in planner.hybrid.layers]
                if planner.hybrid else [])
        rec = {"config": f"{cfg.name} n_layers={cfg.n_layers} batch {batch} "
                         f"seq {seq}",
               "mesh": [f"mesh={pl.mesh_shape(mesh)} wire={comm.wire} "
                        f"ef={comm.error_feedback}"], "plan": plan,
               "steps": [{"step": r.step, "loss": r.loss,
                          "grad_norm": r.grad_norm, "seconds": r.seconds}
                         for r in recs], "peak_bytes": peaks}
        if stats is not None:
            hooks["telemetry"].close()
            rec.update(
                table=stats.table(),
                bucket_s=[b.t_measured for b in stats.buckets],
                model_s=[b.t_model for b in stats.buckets],
                alarms=[a.describe() for a in hooks["monitor"].alarms],
                samples=[e for e in telemetry.load_telemetry(
                    hooks["telemetry"].path) if e["kind"] == "bucket_times"])
        pathlib.Path(args.worker_out).write_text(json.dumps(rec))
    shutil.rmtree(tmp, ignore_errors=True)
    dist.destroy_process_group()
    return 0


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--nproc", type=int, default=4)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--parts", default="check,cells")
    ap.add_argument("--meshes", default="1x4,2x2")
    ap.add_argument("--wires", default="fp32,int8,bf16")
    ap.add_argument("--steps", type=int, default=4)
    ap.add_argument("--cells-config", default="cells",
                    choices=["cells", "smoke"])
    ap.add_argument("--cells-seq", type=int, default=2048)
    ap.add_argument("--mp-meshes", default="1x4,2x2,h1x2x2")
    # the families part's archs: FAMILIES' and grok-1-314b
    ap.add_argument("--families", default=",".join(
        [a for a, *_ in FAMILIES] + ["grok-1-314b"]))
    ap.add_argument("--timeout", type=float, default=600)
    ap.add_argument("--out", default=str(ROOT / "build" /
                                         "hybrid_cards.json"))
    ap.add_argument("--worker", choices=["hybrid", "dp", "stats", "mp",
                                         "ep", "fsdp-pair", "fsdp-full",
                                         "families", "serve"],
                    default=None,
                    help=argparse.SUPPRESS)
    ap.add_argument("--arch", default="yi-6b", help=argparse.SUPPRESS)
    ap.add_argument("--mesh", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--wire", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--worker-out", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.worker == "ep":
        return ep_worker(args)
    if args.worker in ("fsdp-pair", "fsdp-full"):
        return fsdp_worker(args)
    if args.worker == "families":
        return families_worker(args)
    if args.worker == "serve":
        return serve_worker(args)
    if args.worker:
        return worker(args)
    if args.device == "cuda":
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True, timeout=60).stdout.strip().splitlines()
        print("\n".join(smi), flush=True)
    else:
        smi = ["cpu rehearsal"]
    work = pathlib.Path(args.out).parent / "hybrid_cards_work"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    report, ok = {"device": smi}, True
    parts = args.parts.split(",")
    if "check" in parts:
        report["check"], good = check_part(args, work)
        ok = ok and good
    if "cells" in parts:
        report["cells"], good = cells_part(args, work)
        ok = ok and good
    if "stats" in parts:
        report["stats"], good = stats_part(args, work)
        ok = ok and good
    if "mp" in parts:
        report["mp"], good = mp_part(args, work)
        ok = ok and good
    if "ep" in parts:
        report["ep"], good = ep_part(args, work)
        ok = ok and good
    if "fsdp" in parts:
        report["fsdp"], good = fsdp_part(args, work)
        ok = ok and good
    if "families" in parts:
        report["families"], good = families_part(args, work)
        ok = ok and good
    if "serve" in parts:
        report["serve"], good = serve_part(args, work)
        ok = ok and good
    shutil.rmtree(work, ignore_errors=True)
    pathlib.Path(args.out).write_text(json.dumps(report, indent=1))
    print(f"wrote {args.out}; {'ok' if ok else 'FAILED'}")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
