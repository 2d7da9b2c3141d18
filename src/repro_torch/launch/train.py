"""Training driver, mlsl data path.

Ports `repro/launch/train.py` for the flat mlsl step:

  python -m repro_torch.launch.train --arch yi-6b --comm mlsl --wire int8 \\
      --error-feedback --microbatches 2

runs on the card (`--device cpu` for the CPU). `--smoke` (the default) uses
the reduced config of the same family. `--comm gspmd`, `--hier`,
`--hybrid`, `--topo` and the observability flags are not yet ported and
raise.
"""

from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

from repro_torch.configs import registry
from repro_torch.configs.base import ModelConfig
from repro_torch.core import planner as pl
from repro_torch.data import pipeline
from repro_torch.launch import mesh as mesh_lib
from repro_torch.models.transformer import Batch, Model
from repro_torch.optim import optimizers as opt_lib, schedules
from repro_torch.train import trainer as tr

_NOT_PORTED = ("--hier", "--hybrid", "--topo", "--stats", "--trace",
               "--telemetry", "--telemetry-sample", "--ckpt-dir")


@dataclasses.dataclass(frozen=True)
class StepRecord:
    step: int
    loss: float
    grad_norm: float
    seconds: float                 # host clock, synchronized with the device


def train(cfg: ModelConfig, comm: tr.CommConfig, *, steps: int, batch: int,
          seq: int, lr: float = 3e-3, optimizer: str = "adamw",
          dp_only: bool = False, seed: int = 0, device=None,
          log_every: int = 0) -> list:
    """Train `cfg` for `steps` steps of the mlsl step on one process and
    return a StepRecord per step. Weights are random from `seed`; data is
    the seeded synthetic stream. `dp_only` builds `Planner(mesh,
    dp_only=True)` instead of the default planner."""
    dev = mesh_lib.resolve_device(device)
    mesh = mesh_lib.make_host_mesh(1, 1, device=dev)
    planner = pl.Planner(mesh=mesh, dp_only=dp_only)
    model = Model(cfg)
    sched = schedules.warmup_cosine(lr, max(steps // 10, 1), steps)
    opt = opt_lib.make_optimizer(optimizer, sched)
    gen = torch.Generator(device=dev).manual_seed(seed)
    state = tr.make_train_state(model, opt, gen, dev)
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
            print(f"step {s:5d} loss {loss:.4f} gnorm {gnorm:.3f} "
                  f"({out[-1].seconds:.3f}s)", flush=True)
    return out


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
    ap.add_argument("--comm", default="mlsl", choices=["gspmd", "mlsl"])
    ap.add_argument("--wire", default="fp32", choices=["fp32", "bf16", "int8"])
    ap.add_argument("--error-feedback", action="store_true")
    ap.add_argument("--no-prioritize", action="store_true")
    ap.add_argument("--microbatches", type=int, default=1,
                    help="gradient-accumulation microbatches per step")
    ap.add_argument("--overlap", action="store_true")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    for flag in _NOT_PORTED:
        ap.add_argument(flag, nargs="?", const=True, default=None,
                        help=argparse.SUPPRESS)
    return ap


def main(argv=None) -> int:
    args = _parser().parse_args(argv)
    asked = [f for f in _NOT_PORTED
             if getattr(args, f[2:].replace("-", "_")) is not None]
    if asked:
        raise NotImplementedError(
            f"{', '.join(asked)}: not yet ported to repro_torch")
    if args.comm != "mlsl":
        raise NotImplementedError(
            f"--comm {args.comm}: not yet ported to repro_torch (only mlsl)")
    cfg = (registry.get_smoke_config(args.arch) if args.smoke
           else registry.get_config(args.arch))
    comm = tr.CommConfig(mode=args.comm, wire=args.wire,
                         prioritize=not args.no_prioritize,
                         error_feedback=args.error_feedback,
                         accum_steps=args.microbatches, overlap=args.overlap)
    dev = mesh_lib.resolve_device(args.device)
    print(f"arch={cfg.name} params={Model(cfg).n_params():,} "
          f"comm={args.comm}/{args.wire} device={dev}", flush=True)
    recs = train(cfg, comm, steps=args.steps, batch=args.batch, seq=args.seq,
                 lr=args.lr, optimizer=args.optimizer, seed=args.seed,
                 device=dev, log_every=args.log_every)
    if not all(np.isfinite(r.loss) for r in recs):
        raise RuntimeError(f"non-finite loss: {[r.loss for r in recs]}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
