#!/usr/bin/env python3
"""Hybrid data x model parallelism, and plain model parallelism, across
the cards of one host, against the data-parallel twin.

    python3 scripts/hybrid_cards.py [--nproc 4] [--device cuda]
                                    [--parts check,cells,stats,mp,ep,fsdp,
                                             families]

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
for every family, in one process a rank (NCCL):
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
        "--worker-out", str(out)], args.timeout)
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
    for arch, layers, seq in FAMILIES:
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
    ap.add_argument("--timeout", type=float, default=600)
    ap.add_argument("--out", default=str(ROOT / "build" /
                                         "hybrid_cards.json"))
    ap.add_argument("--worker", choices=["hybrid", "dp", "stats", "mp",
                                         "ep", "fsdp-pair", "fsdp-full",
                                         "families"],
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
    shutil.rmtree(work, ignore_errors=True)
    pathlib.Path(args.out).write_text(json.dumps(report, indent=1))
    print(f"wrote {args.out}; {'ok' if ok else 'FAILED'}")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
