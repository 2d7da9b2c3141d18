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

`--model-parallel N` (N > 1, without `--hybrid`) is the reference's model
axis on every matrix: `make_host_mesh(data, N)`, or with `--hier`
`make_hier_mesh(nodes, local, N)`, under `Planner(mesh)`, on gspmd or
mlsl. Both it and `--hybrid` take every arch of the registry; e.g. on 8
gloo ranks of the CPU

  python -m torch.distributed.run --standalone --nproc-per-node 8 \\
      -m repro_torch.launch.train --device cpu --data-parallel 4 \\
      --model-parallel 2 --comm mlsl --batch 8 --seq 32

With `--ckpt-dir` it saves the full parameters gathered over the model
group.

Observability (repro_torch.obs), as in the reference: `--stats` prints the
per-bucket CommStats table with each bucket's measured replay time beside
the cost model's, and the step meter, and writes them into the perf ledger
(`BENCH_torch_comm_stats.json` in `$BENCH_DIR`, when `benchmarks/` is
importable); `--trace DIR` writes DIR/trace.json (Perfetto) with a span per
step, the measured bucket replays and the modeled schedule of the same
config; `--telemetry DIR` streams DIR/telemetry.jsonl (step records, and a
bucket replay every `--telemetry-sample` steps, between steps) into the
online health monitor, whose alarms print after the run. The replay is a
collective: every rank runs it at the same points. Rank 0 prints and writes
the files.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import os
import time

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import convert
from repro_torch.checkpoint import ckpt
from repro_torch.configs import registry
from repro_torch.configs.base import ModelConfig
from repro_torch.core import planner as pl
from repro_torch.core import simulator as sim
from repro_torch.data import pipeline
from repro_torch.launch import mesh as mesh_lib
from repro_torch.models.transformer import Batch, Model
from repro_torch.obs import telemetry as obs_telemetry
from repro_torch.optim import optimizers as opt_lib, schedules
from repro_torch.train import trainer as tr


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
          log_every: int = 0, meter=None, tracer=None, telemetry=None,
          monitor=None, timer=None,
          sample_every: int = obs_telemetry.DEFAULT_SAMPLE_EVERY,
          force_model_parallel: bool = False) -> tuple:
    """Train `cfg` for `steps` steps and return (a StepRecord per step, the
    final TrainState). Weights are random from `seed`; data is the seeded
    synthetic stream (`seq` tokens; a VLM adds its image positions), with
    zero image or frame embeddings (`stub_embeds`). `mesh` defaults to one
    rank: `make_hier_mesh(1, 1)` with `comm.hier`, else
    `make_host_mesh(1, 1)`. `planner` defaults to
    `Planner(mesh, dp_only=dp_only)`; under a hybrid planner
    (`make_hybrid_planner`) or model parallelism (a planner whose model
    axis has more than one rank, or `force_model_parallel`:
    `trainer.make_train_step`) or FSDP (`planner.fsdp`, gspmd) every rank
    draws the full weights and keeps its shards, and the state holds
    shards; LARS and LAMB then take the norms of whole tensors. With `ckpt_dir`, rank 0 saves {"params": ...}
    there after the last step, the full tensors.

    Observability hooks (repro_torch.obs), each optional: `meter`
    (StepMeter) takes every step's synchronized time, loss and gradient
    norm; `tracer` (TraceWriter) gets a span per step and a rates counter;
    `telemetry` (TelemetryWriter) a step record per step; `monitor`
    (HealthMonitor) watches the step times. `timer` (BucketTimer of the
    same plan) replays the buckets between steps every `sample_every`
    steps (0: never), the first time after one warm-up replay, into
    telemetry's bucket_times and the monitor; it is a collective, so every
    rank passes a timer and the same `sample_every`. `tracer`, `telemetry`
    and `monitor` need `meter`."""
    dev = mesh_lib.resolve_device(device)
    if mesh is None:
        mesh = (mesh_lib.make_hier_mesh(1, 1, device=dev) if comm.hier
                else mesh_lib.make_host_mesh(1, 1, device=dev))
    if planner is None:
        planner = pl.Planner(mesh=mesh, dp_only=dp_only)
    if meter is None and any(h is not None
                             for h in (tracer, telemetry, monitor)):
        raise ValueError("tracer, telemetry and monitor need a meter")
    model = Model(cfg)
    sched = schedules.warmup_cosine(lr, max(steps // 10, 1), steps)
    mp = force_model_parallel or tr.model_parallel(planner)
    opt = opt_lib.make_optimizer(optimizer, sched)
    gen = torch.Generator(device=dev).manual_seed(seed)
    specs = (tr.param_specs(model, planner)
             if planner.hybrid or mp or planner.fsdp else None)
    params = model.init(gen, dev)
    if specs is not None:
        params = convert.shard_params(params, specs, mesh)
    state = tr.train_state_from_params(params, opt)
    step_fn = tr.make_train_step(model, opt, mesh, planner, comm, device=dev,
                                 force_model_parallel=force_model_parallel)
    dcfg = pipeline.DataConfig(vocab=cfg.vocab, seq_len=seq,
                               global_batch=batch, seed=seed)
    # the cost model's per-bucket seconds: the modeled exposed-comm share
    # at the measured compute scale, and telemetry's modeled column
    t_model = list(monitor.t_model) if monitor is not None else []
    n_micro = max(comm.accum_steps, 1)
    out = []
    sampled_once = False
    for s, raw in enumerate(pipeline.iterate(dcfg, steps)):
        b = Batch(tokens=torch.from_numpy(raw["tokens"]).to(dev),
                  labels=torch.from_numpy(raw["labels"]).to(dev),
                  **stub_embeds(cfg, batch, dev))
        span = (contextlib.nullcontext() if tracer is None
                else tracer.span(f"step{s}", cat="step"))
        with span:
            t0 = time.perf_counter()
            state, metrics = step_fn(state, b)
            loss = float(metrics["loss"])          # waits for the device
            gnorm = float(metrics["grad_norm"])
            out.append(StepRecord(s, loss, gnorm, time.perf_counter() - t0))
        fired = ([] if meter is None else
                 _observe_step(s, out[-1], meter, tracer, telemetry, monitor,
                               t_model, n_micro, comm.overlap))
        if timer is not None and sample_every > 0 and s % sample_every == 0:
            # the replay runs between steps: the step timer never sees it
            sampled = timer.sample(warmup=0 if sampled_once else 1)
            sampled_once = True
            if telemetry is not None:
                telemetry.bucket_times(s, sampled, modeled=t_model or None)
            if monitor is not None:
                fired += monitor.observe_bucket_times(s, sampled)
        if telemetry is not None:
            for a in fired:
                telemetry.alarm(step=a.step, kind=a.kind, factor=a.factor,
                                level=a.level, rank=a.rank, detail=a.detail)
        if log_every and (s % log_every == 0 or s == steps - 1):
            _log(f"{meter.summary()} ({out[-1].seconds:.3f}s)"
                 if meter is not None else
                 f"step {s:5d} loss {loss:.4f} gnorm {gnorm:.3f} "
                 f"({out[-1].seconds:.3f}s)")
    if ckpt_dir:
        full = (state.params if specs is None else
                convert.gather_params(state.params, specs, mesh))
        if dist.get_rank() == 0:
            ckpt.save(ckpt_dir, {"params": full}, step=steps)
            _log(f"checkpoint -> {ckpt_dir}")
    return out, state


def stub_embeds(cfg: ModelConfig, batch: int, device) -> dict:
    """The modality stubs' inputs the reference's CLI trains on: zero patch
    embeddings (VLM) and zero frame embeddings (encoder-decoder), f32."""
    kw = {}
    if cfg.vlm_img_tokens:
        kw["img_embeds"] = torch.zeros(
            (batch, cfg.vlm_img_tokens, cfg.vlm_d_vision), device=device)
    if cfg.encoder is not None:
        kw["frame_embeds"] = torch.zeros(
            (batch, cfg.encoder.n_frames, cfg.encoder.d_input), device=device)
    return kw


def _observe_step(s, rec, meter, tracer, telemetry, monitor, t_model,
                  n_micro, overlap) -> list:
    """One finished step into the meter, the trace's rates counter, the
    telemetry stream and the health monitor; returns the monitor's newly
    fired alarms."""
    meter.update(dt=rec.seconds, loss=rec.loss, grad_norm=rec.grad_norm)
    if t_model:
        # modeled exposed-comm share at the CURRENT measured compute scale
        meter.exposed_comm_model = sim.simulate_bucket_schedule(
            t_model, n_micro, meter.step_time / n_micro,
            overlap=overlap).exposed_comm
    exposed = meter.exposed_comm_frac
    if tracer is not None:
        vals = {"tokens_per_sec": meter.tokens_per_sec}
        if exposed is not None:
            vals["exposed_comm_share"] = exposed
        tracer.counter("rates", tracer.now_us(), vals)
    if telemetry is not None:
        telemetry.step(step=s, t_step_s=meter.last_dt,
                       tok_s=meter.tokens_per_sec, loss=meter.last_loss,
                       exposed_frac=exposed)
    if monitor is None:
        return []
    return monitor.observe_step(s, meter.last_dt, exposed_frac=exposed)


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
    # observability (repro_torch.obs; the module docstring says what each
    # writes)
    ap.add_argument("--stats", action="store_true")
    ap.add_argument("--trace", default=None, metavar="DIR")
    ap.add_argument("--telemetry", default=None, metavar="DIR")
    ap.add_argument("--telemetry-sample", type=int, default=None,
                    metavar="N",
                    help="bucket-replay sampling period in steps for "
                         "--telemetry (default 25; 0 disables the replay)")
    return ap


def run(argv=None) -> tuple:
    """The CLI without the exit code: parse `argv`, train, and return (the
    StepRecords, the final TrainState)."""
    args = _parser().parse_args(argv)
    if args.hybrid and args.comm != "mlsl":
        raise SystemExit("--hybrid needs --comm mlsl (the activation "
                         "f/g collectives run in the explicit data path)")
    cfg = (registry.get_smoke_config(args.arch) if args.smoke
           else registry.get_config(args.arch))
    dev = mesh_lib.resolve_device(args.device)
    if args.hybrid:
        mesh = mesh_lib.make_hier_mesh(args.nodes, args.local, device=dev)
        planner = pl.make_hybrid_planner(mesh, cfg, batch=args.batch,
                                         seq=args.seq)
        for lp in planner.hybrid.layers:
            _log(plan_line(lp))
    else:
        mesh = (mesh_lib.make_hier_mesh(args.nodes, args.local,
                                        args.model_parallel, device=dev)
                if args.hier else
                mesh_lib.make_host_mesh(args.data_parallel,
                                        args.model_parallel, device=dev))
        planner = pl.Planner(mesh=mesh)
    comm = tr.CommConfig(mode=args.comm, wire=args.wire,
                         prioritize=not args.no_prioritize,
                         error_feedback=args.error_feedback,
                         hier=args.hier or args.hybrid,
                         wire_intra=args.wire_intra, topo=args.topo,
                         accum_steps=args.microbatches, overlap=args.overlap)
    model = Model(cfg)
    _log(f"arch={cfg.name} params={model.n_params():,} "
         f"comm={args.comm}/{args.wire} mesh={pl.mesh_shape(mesh)} "
         f"device={dev}")
    hooks = _obs_hooks(args, cfg, model, mesh, planner, comm, dev)
    telemetry = hooks.get("telemetry")
    try:
        recs, state = train(cfg, comm, steps=args.steps, batch=args.batch,
                            seq=args.seq, lr=args.lr,
                            optimizer=args.optimizer, seed=args.seed,
                            device=dev, mesh=mesh, planner=planner,
                            ckpt_dir=args.ckpt_dir,
                            log_every=args.log_every, **hooks)
        if not all(np.isfinite(r.loss) for r in recs):
            raise RuntimeError(f"non-finite loss: {[r.loss for r in recs]}")
        if args.stats or args.trace:
            _emit_observability(args, mesh, planner, comm, model, dev,
                                **hooks)
    finally:
        if telemetry is not None:
            telemetry.close()        # keeps what a failed run logged
    if telemetry is not None:
        _log(f"telemetry: {telemetry.path} ({telemetry.n_records} records)")
        _report_health(hooks["monitor"])
    return recs, state


def _obs_hooks(args, cfg, model, mesh, planner, comm, dev) -> dict:
    """train()'s observability hooks for the flags: a meter on every rank;
    the tracer, the telemetry writer and the health monitor on rank 0
    (which writes the files); with --telemetry on the mlsl path, a bucket
    timer on every rank (its replay is a collective)."""
    if not (args.stats or args.trace or args.telemetry):
        return {}
    from repro_torch.obs import detect as obs_detect
    from repro_torch.obs import meter as obs_meter
    from repro_torch.obs import trace as obs_trace
    rank0 = dist.get_rank() == 0
    hooks = {"meter": obs_meter.StepMeter(
        tokens_per_step=args.batch * args.seq)}
    if args.trace and rank0:
        tracer = obs_trace.TraceWriter()
        tracer.name_process(0, "measured")
        tracer.name_thread(0, 0, "train steps")
        hooks["tracer"] = tracer
    if not args.telemetry:
        return hooks
    sample_every = (obs_telemetry.DEFAULT_SAMPLE_EVERY
                    if args.telemetry_sample is None
                    else args.telemetry_sample)
    engine = None
    if args.comm == "mlsl":
        engine = tr.make_comm_engine(model, mesh, planner, comm, device=dev)
        hooks.update(timer=engine.bucket_timer(mesh, seed=args.seed),
                     sample_every=sample_every)
    if rank0:
        os.makedirs(args.telemetry, exist_ok=True)
        hooks["telemetry"] = obs_telemetry.TelemetryWriter(
            os.path.join(args.telemetry, "telemetry.jsonl"),
            run_info={"source": "train", "arch": cfg.name,
                      "comm": args.comm, "wire": args.wire,
                      "mesh": pl.mesh_shape(mesh), "batch": args.batch,
                      "seq": args.seq, "steps": args.steps},
            sample_every=sample_every)
        # live detection runs on the de-tuned wall-clock preset; gspmd's
        # reductions are not bucket messages: only step_time_drift there
        wcfg = obs_detect.DetectorConfig.wallclock()
        hooks["monitor"] = (
            obs_detect.HealthMonitor.from_plan(engine.plan, config=wcfg)
            if engine is not None else obs_detect.HealthMonitor(config=wcfg))
    return hooks


def _report_health(monitor) -> None:
    """Post-run alarm table for --telemetry (the operator's summary)."""
    if not monitor.alarms:
        _log("health: no alarms")
        return
    _log(f"health: {len(monitor.alarms)} alarm(s)")
    for a in monitor.alarms:
        _log(f"  {a.describe()}")
        if monitor.bucket_bytes:
            _log(f"    -> {monitor.reroute(a).summary()}")


def _emit_observability(args, mesh, planner, comm, model, dev, *, meter,
                        tracer=None, **_hooks) -> None:
    """Post-run stats/trace emission (--stats / --trace).

    On the mlsl data path every rank replays each bucket's exchange
    standalone (a collective) for the measured per-bucket times; rank 0
    prints the CommStats table, writes the comm_stats and meter entries
    into the perf ledger (BENCH_torch_comm_stats.json, beside and never
    over the reference's BENCH_comm_stats.json; warn-only), and lays the
    measured bucket spans and the MODELED bucket schedule of the same
    config side by side in the trace."""
    from repro_torch.obs import stats as obs_stats
    from repro_torch.obs import trace as obs_trace

    st = None
    if args.comm == "mlsl":
        engine = tr.make_comm_engine(model, mesh, planner, comm, device=dev)
        measured = obs_stats.measure_bucket_times(engine, mesh, iters=2,
                                                  seed=args.seed)
        st = engine.stats(measured=measured)
        if tracer is not None:
            tracer.name_thread(0, 1, "bucket replay")
            t_us = tracer.now_us()
            for b in st.buckets:
                dur = (b.t_measured or 0.0) * 1e6
                tracer.complete(
                    f"bucket{b.index}/{b.route}_allreduce_{b.wire}",
                    t_us, dur, pid=0, tid=1, cat="comm",
                    args={"elems": b.n_elems, "total_B": b.total_bytes})
                t_us += dur
        # the modeled schedule for this config: per-bucket cost-model times
        # through the engine's microbatch pipeline at the measured compute
        # scale
        n_micro = max(comm.accum_steps, 1)
        micro_compute = (meter.step_time / n_micro if meter.steps
                         else 1e-3)
        modeled = sim.simulate_bucket_schedule(
            [b.t_model or 0.0 for b in st.buckets], n_micro, micro_compute,
            overlap=comm.overlap, record_timeline=True)
        meter.exposed_comm_model = modeled.exposed_comm
        if tracer is not None:
            obs_trace.export_sim_spans(modeled.timeline, tracer, pid=1,
                                       track=f"modeled ({st.topo_name})")
        if args.stats:
            _log(st.table())
    elif args.stats:
        _log("stats: per-bucket CommStats need --comm mlsl (gspmd's "
             "reductions are per-leaf all-reduces, not bucket messages)")
    if args.stats and meter.steps:
        _log(meter.summary())
    if dist.get_rank() != 0:
        return
    if args.stats:
        try:
            from benchmarks import common as bench_common
        except ImportError:
            bench_common = None     # repo root not on sys.path
        if bench_common is not None:
            led = bench_common.Ledger("torch_comm_stats")
            for m in (st.to_metrics() if st is not None else []):
                led.record(**m)
            if meter.steps:
                for m in meter.to_metrics():
                    led.record(**m)
            _log(f"stats ledger: {led.write()}")
    if tracer is not None:
        os.makedirs(args.trace, exist_ok=True)
        path = tracer.write(os.path.join(args.trace, "trace.json"))
        _log(f"trace: {path} (open in https://ui.perfetto.dev)")


def main(argv=None) -> int:
    run(argv)
    return 0


if __name__ == "__main__":
    try:
        raise SystemExit(main())
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
