#!/usr/bin/env python3
"""Hybrid data x model parallelism across the cards of one host, against
its data-parallel twin.

    python3 scripts/hybrid_cards.py [--nproc 4] [--device cuda]
                                    [--parts check,cells]

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

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parents[1]
LOSS_ATOL = 5e-4          # fp32 wire
GNORM_ATOL = 1e-3         # fp32 wire, the CLI's printed precision
PARAM_ATOL = 1e-4         # fp32 wire, parameters after the last step
LOSS_RTOL = 1e-3          # int8 and bf16 wires


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


def worker(args) -> int:
    """One rank of a cells run: train() on the two-level mesh, rank 0
    writes the plan lines, the step records and every rank's peak."""
    import dataclasses

    import torch
    import torch.distributed as dist
    from repro_torch.configs import registry
    from repro_torch.core import planner as pl
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.launch import train as train_lib
    from repro_torch.train import trainer as tr
    nodes, local = (int(v) for v in args.mesh.split("x"))
    dev = mesh_lib.resolve_device(args.device)
    cfg = (dataclasses.replace(registry.get_config("yi-6b"), n_layers=4)
           if args.cells_config == "cells"
           else registry.get_smoke_config("yi-6b"))
    batch, seq = 8, args.cells_seq
    mesh = mesh_lib.make_hier_mesh(nodes, local, device=dev)
    comm = tr.CommConfig(mode="mlsl", wire=args.wire, accum_steps=2,
                         hier=True)
    planner = (pl.make_hybrid_planner(mesh, cfg, batch=batch, seq=seq)
               if args.worker == "hybrid"
               else pl.Planner(mesh=mesh, dp_only=True))
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    recs, state = train_lib.train(cfg, comm, steps=args.steps, batch=batch,
                                  seq=seq, lr=3e-4, optimizer="adamw",
                                  seed=0, device=dev, mesh=mesh,
                                  planner=planner)
    del state
    peak = (torch.cuda.max_memory_allocated(dev) if dev.type == "cuda"
            else None)
    peaks = [None] * dist.get_world_size()
    dist.all_gather_object(peaks, peak)
    if dist.get_rank() == 0:
        plan = ([train_lib.plan_line(lp) for lp in planner.hybrid.layers]
                if planner.hybrid else [])
        pathlib.Path(args.worker_out).write_text(json.dumps({
            "config": f"{cfg.name} n_layers={cfg.n_layers} batch {batch} "
                      f"seq {seq}", "mesh": [], "plan": plan,
            "steps": [{"step": r.step, "loss": r.loss,
                       "grad_norm": r.grad_norm, "seconds": r.seconds}
                      for r in recs], "peak_bytes": peaks}))
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
    ap.add_argument("--timeout", type=float, default=600)
    ap.add_argument("--out", default=str(ROOT / "build" /
                                         "hybrid_cards.json"))
    ap.add_argument("--worker", choices=["hybrid", "dp"], default=None,
                    help=argparse.SUPPRESS)
    ap.add_argument("--mesh", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--wire", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--worker-out", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args()
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
    shutil.rmtree(work, ignore_errors=True)
    pathlib.Path(args.out).write_text(json.dumps(report, indent=1))
    print(f"wrote {args.out}; {'ok' if ok else 'FAILED'}")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
