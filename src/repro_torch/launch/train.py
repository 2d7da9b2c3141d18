"""Training entry point (the CLI).

Ports `repro/launch/train.py`:

  python -m repro_torch.launch.train --arch yi-6b --steps 3 --comm mlsl \\
      --wire int8 --error-feedback --hier --nodes 1 --local 1 --batch 8 \\
      --seq 32

runs on the card (`--device cpu` for the CPU). One process is one rank:
more ranks start through torchrun, e.g. the verify command on 8 gloo ranks
of the CPU,

  python -m torch.distributed.run --standalone --nproc-per-node 8 \\
      -m repro_torch.launch.train --device cpu --hier --comm mlsl ...

and the mesh must have as many ranks as the world (`--hier` with the
default `--nodes 2 --local 4` needs 8; on one card pass `--nodes 1
--local 1`). Through torchrun, `--local-size` is the spelling of
`--local` that no torchrun option abbreviates to. `--smoke` (the default)
uses the reduced config of the same family.

`--hybrid` executes the C2C chooser's hybrid plan: tensor parallelism over
the "local" axis of `make_hier_mesh(nodes, local)` for the layers the
chooser sends model-parallel, data parallelism across "node"; it prints one
`plan ...` line per layer, implies `--hier` and needs `--comm mlsl`. With
`--ckpt-dir` it saves the full parameters gathered over the tp group.
`--model-parallel` above 1 without `--hybrid` (the reference's GSPMD
model axis, which needs a vocab-parallel embedding, head and loss) and the
observability flags are not yet ported and raise.
"""

from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import convert
from repro_torch.checkpoint import ckpt
from repro_torch.configs import registry
from repro_torch.configs.base import ModelConfig
from repro_torch.core import planner as pl
from repro_torch.data import pipeline
from repro_torch.launch import mesh as mesh_lib
from repro_torch.models.transformer import Batch, Model
from repro_torch.optim import optimizers as opt_lib, schedules
from repro_torch.train import trainer as tr

_NOT_PORTED = ("--stats", "--trace", "--telemetry", "--telemetry-sample")


@dataclasses.dataclass(frozen=True)
class StepRecord:
    step: int
    loss: float
    grad_norm: float
    seconds: float                 # host clock, synchronized with the device


def train(cfg: ModelConfig, comm: tr.CommConfig, *, steps: int, batch: int,
          seq: int, lr: float = 3e-3, optimizer: str = "adamw",
          dp_only: bool = False, seed: int = 0, device=None, mesh=None,
          planner: pl.Planner | None = None, ckpt_dir: str | None = None,
          log_every: int = 0) -> tuple:
    """Train `cfg` for `steps` steps and return (a StepRecord per step, the
    final TrainState). Weights are random from `seed`; data is the seeded
    synthetic stream. `mesh` defaults to one rank: `make_hier_mesh(1, 1)`
    with `comm.hier`, else `make_host_mesh(1, 1)`. `planner` defaults to
    `Planner(mesh, dp_only=dp_only)`; under a hybrid planner
    (`make_hybrid_planner`) every rank draws the full weights and keeps its
    shards, and the state holds shards. With `ckpt_dir`, rank 0 saves
    {"params": ...} there after the last step, the full tensors."""
    dev = mesh_lib.resolve_device(device)
    if mesh is None:
        mesh = (mesh_lib.make_hier_mesh(1, 1, device=dev) if comm.hier
                else mesh_lib.make_host_mesh(1, 1, device=dev))
    if planner is None:
        planner = pl.Planner(mesh=mesh, dp_only=dp_only)
    model = Model(cfg)
    sched = schedules.warmup_cosine(lr, max(steps // 10, 1), steps)
    opt = opt_lib.make_optimizer(optimizer, sched)
    gen = torch.Generator(device=dev).manual_seed(seed)
    specs = tr.param_specs(model, planner) if planner.hybrid else None
    params = model.init(gen, dev)
    if specs is not None:
        params = convert.shard_params(params, specs, mesh)
    state = tr.train_state_from_params(params, opt)
    step_fn = tr.make_train_step(model, opt, mesh, planner, comm, device=dev)
    dcfg = pipeline.DataConfig(vocab=cfg.vocab, seq_len=seq,
                               global_batch=batch, seed=seed)
    out = []
    for s, raw in enumerate(pipeline.iterate(dcfg, steps)):
        b = Batch(tokens=torch.from_numpy(raw["tokens"]).to(dev),
                  labels=torch.from_numpy(raw["labels"]).to(dev))
        t0 = time.perf_counter()
        state, metrics = step_fn(state, b)
        loss = float(metrics["loss"])          # waits for the device
        gnorm = float(metrics["grad_norm"])
        out.append(StepRecord(s, loss, gnorm, time.perf_counter() - t0))
        if log_every and (s % log_every == 0 or s == steps - 1):
            _log(f"step {s:5d} loss {loss:.4f} gnorm {gnorm:.3f} "
                 f"({out[-1].seconds:.3f}s)")
    if ckpt_dir:
        full = (state.params if specs is None else
                convert.gather_params(state.params, specs, mesh))
        if dist.get_rank() == 0:
            ckpt.save(ckpt_dir, {"params": full}, step=steps)
            _log(f"checkpoint -> {ckpt_dir}")
    return out, state


def plan_line(lp: pl.HybridLayerPlan) -> str:
    """The reference CLI's `plan ...` line for one layer of a hybrid plan."""
    note = f" [{lp.reason}]" if lp.reason else ""
    return (f"plan {lp.name:12s} {lp.kind:6s} "
            f"chooser={lp.choice.strategy.value}(g={lp.choice.group_size}) "
            f"executed={lp.executed}{note}")


def _log(msg: str) -> None:
    """Print on rank 0 only (every rank runs the same loop)."""
    if not dist.is_initialized() or dist.get_rank() == 0:
        print(msg, flush=True)


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.train")
    ap.add_argument("--arch", choices=registry.ARCH_IDS, default="yi-6b")
    ap.add_argument("--smoke", action="store_true", default=True)
    ap.add_argument("--no-smoke", dest="smoke", action="store_false")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--optimizer", default="adamw",
                    choices=sorted(opt_lib.OPTIMIZERS))
    ap.add_argument("--comm", default="gspmd", choices=["gspmd", "mlsl"])
    ap.add_argument("--wire", default="fp32", choices=["fp32", "bf16", "int8"])
    ap.add_argument("--error-feedback", action="store_true")
    ap.add_argument("--no-prioritize", action="store_true")
    ap.add_argument("--data-parallel", type=int, default=1)
    ap.add_argument("--model-parallel", type=int, default=1)
    # two-level collectives over a ("node", "local") factored mesh of
    # nodes * local ranks (one process each)
    ap.add_argument("--hier", action="store_true")
    # execute the C2C chooser's hybrid plan: tensor parallelism over the
    # "local" mesh axis for the layers the chooser sends model-parallel,
    # data parallelism across "node" (implies the hier mesh; needs --comm
    # mlsl)
    ap.add_argument("--hybrid", action="store_true")
    ap.add_argument("--nodes", type=int, default=2)
    # --local-size: the same value under a name torchrun's own parser does
    # not take for an abbreviation of --local-addr (an argparse that checks
    # abbreviations past the script, as Python 3.12 on the GPU machine
    # does, rejects "--local" there as ambiguous)
    ap.add_argument("--local", "--local-size", dest="local", type=int,
                    default=4)
    ap.add_argument("--wire-intra", default=None, choices=["fp32", "bf16"])
    # a machine hierarchy of repro_torch.core.hw.TOPOLOGIES: the per-level
    # cost model routes each bucket flat or two-level
    ap.add_argument("--topo", default=None)
    ap.add_argument("--microbatches", type=int, default=1,
                    help="gradient-accumulation microbatches per step")
    ap.add_argument("--overlap", action="store_true")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    for flag in _NOT_PORTED:
        ap.add_argument(flag, nargs="?", const=True, default=None,
                        help=argparse.SUPPRESS)
    return ap


def run(argv=None) -> tuple:
    """The CLI without the exit code: parse `argv`, train, and return (the
    StepRecords, the final TrainState)."""
    args = _parser().parse_args(argv)
    asked = [f for f in _NOT_PORTED
             if getattr(args, f[2:].replace("-", "_")) is not None]
    if args.model_parallel > 1 and not args.hybrid:
        asked.append(f"--model-parallel {args.model_parallel} (the GSPMD "
                     "model axis needs a vocab-parallel embedding, head and "
                     "cross-entropy)")
    if asked:
        raise NotImplementedError(
            f"{', '.join(asked)}: not yet ported to repro_torch")
    if args.hybrid and args.comm != "mlsl":
        raise SystemExit("--hybrid needs --comm mlsl (the activation "
                         "f/g collectives run in the explicit data path)")
    cfg = (registry.get_smoke_config(args.arch) if args.smoke
           else registry.get_config(args.arch))
    dev = mesh_lib.resolve_device(args.device)
    planner = None
    if args.hybrid:
        mesh = mesh_lib.make_hier_mesh(args.nodes, args.local, device=dev)
        planner = pl.make_hybrid_planner(mesh, cfg, batch=args.batch,
                                         seq=args.seq)
        for lp in planner.hybrid.layers:
            _log(plan_line(lp))
    elif args.hier:
        mesh = mesh_lib.make_hier_mesh(args.nodes, args.local, device=dev)
    else:
        mesh = mesh_lib.make_host_mesh(args.data_parallel,
                                       args.model_parallel, device=dev)
    comm = tr.CommConfig(mode=args.comm, wire=args.wire,
                         prioritize=not args.no_prioritize,
                         error_feedback=args.error_feedback,
                         hier=args.hier or args.hybrid,
                         wire_intra=args.wire_intra, topo=args.topo,
                         accum_steps=args.microbatches, overlap=args.overlap)
    _log(f"arch={cfg.name} params={Model(cfg).n_params():,} "
         f"comm={args.comm}/{args.wire} mesh={pl.mesh_shape(mesh)} "
         f"device={dev}")
    recs, state = train(cfg, comm, steps=args.steps, batch=args.batch,
                        seq=args.seq, lr=args.lr, optimizer=args.optimizer,
                        seed=args.seed, device=dev, mesh=mesh,
                        planner=planner, ckpt_dir=args.ckpt_dir,
                        log_every=args.log_every)
    if not all(np.isfinite(r.loss) for r in recs):
        raise RuntimeError(f"non-finite loss: {[r.loss for r in recs]}")
    return recs, state


def main(argv=None) -> int:
    run(argv)
    return 0


if __name__ == "__main__":
    try:
        raise SystemExit(main())
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
