"""Serving entry point: batched prefill + decode with the reduced model.

Ports `repro/launch/serve.py`:

  python -m repro_torch.launch.serve --arch yi-6b --batch 4 \\
      --prompt-len 32 --new-tokens 32

runs on the card (`--device cpu` for the CPU). Weights are random from
`--seed`; the prompts are ragged and go through `serve_requests`.

Observability (repro_torch.obs), as in the reference: `--stats` prints the
decode step meter (EMA step time, tok/s); `--trace DIR` writes
DIR/trace.json with the prefill span, one span per decode step and a tok/s
counter track (Perfetto); `--telemetry DIR` streams DIR/telemetry.jsonl
(one step record per decode step) and watches the decode step times for
sustained drift. Each synchronizes the device per decode step to time it;
the tokens are the same with them or without.
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch

from repro_torch.configs import registry
from repro_torch.launch import mesh as mesh_lib
from repro_torch.models.transformer import Model
from repro_torch.serve.engine import Engine, EngineConfig, Request, \
    serve_requests


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.serve")
    ap.add_argument("--arch", choices=registry.ARCH_IDS, default="yi-6b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--new-tokens", type=int, default=32)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--long-context", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    ap.add_argument("--stats", action="store_true")
    ap.add_argument("--trace", default=None, metavar="DIR")
    ap.add_argument("--telemetry", default=None, metavar="DIR")
    return ap


def main(argv=None) -> int:
    args = _parser().parse_args(argv)
    dev = mesh_lib.resolve_device(args.device)
    hooks = _obs_hooks(args)
    cfg = registry.get_smoke_config(args.arch)
    model = Model(cfg)
    params = model.init(torch.Generator(device=dev).manual_seed(args.seed),
                        dev)
    eng = Engine(model, params, EngineConfig(
        max_seq=args.prompt_len + args.new_tokens + 8,
        temperature=args.temperature, long_context=args.long_context),
        **hooks)

    rng = np.random.default_rng(args.seed)
    reqs = [Request(prompt=rng.integers(0, cfg.vocab,
                                        size=rng.integers(
                                            4, args.prompt_len + 1)).astype(
                                                np.int32),
                    max_new=args.new_tokens) for _ in range(args.batch)]
    telemetry = hooks.get("telemetry")
    t0 = time.perf_counter()
    try:
        serve_requests(eng, reqs)
    finally:
        if telemetry is not None:
            telemetry.close()        # keeps what a failed run logged
    dt = time.perf_counter() - t0
    total_new = sum(r.max_new for r in reqs)
    for i, r in enumerate(reqs):
        print(f"req{i}: prompt_len={len(r.prompt)} -> {r.out[:8].tolist()}...")
    print(f"{total_new} tokens in {dt:.2f}s ({total_new / dt:.1f} tok/s "
          f"batched on {dev}, reduced config)", flush=True)
    meter = hooks.get("meter")
    if args.stats and meter is not None and meter.steps:
        print(f"decode {meter.summary()}")
    if telemetry is not None:
        print(f"telemetry: {telemetry.path} ({telemetry.n_records} records)")
        monitor = hooks["monitor"]
        print(f"health: {len(monitor.alarms)} alarm(s)" if monitor.alarms
              else "health: no alarms")
        for a in monitor.alarms:
            print(f"  {a.describe()}")
    tracer = hooks.get("tracer")
    if tracer is not None:
        os.makedirs(args.trace, exist_ok=True)
        path = tracer.write(os.path.join(args.trace, "trace.json"))
        print(f"trace: {path} (open in https://ui.perfetto.dev)", flush=True)
    return 0


def _obs_hooks(args) -> dict:
    """The Engine's observability hooks for the flags (none without them)."""
    if not (args.stats or args.trace or args.telemetry):
        return {}
    from repro_torch.obs import meter as obs_meter
    from repro_torch.obs import trace as obs_trace
    hooks = {"meter": obs_meter.StepMeter()}
    if args.trace:
        hooks["tracer"] = obs_trace.TraceWriter()
        hooks["tracer"].name_process(0, "serve")
    if args.telemetry:
        from repro_torch.obs import detect as obs_detect
        from repro_torch.obs import telemetry as obs_telemetry
        os.makedirs(args.telemetry, exist_ok=True)
        hooks["telemetry"] = obs_telemetry.TelemetryWriter(
            os.path.join(args.telemetry, "telemetry.jsonl"),
            run_info={"source": "serve", "arch": args.arch,
                      "batch": args.batch, "new_tokens": args.new_tokens},
            sample_every=0)   # no bucket replay on the decode path
        hooks["monitor"] = obs_detect.HealthMonitor(
            config=obs_detect.DetectorConfig.wallclock())
    return hooks


if __name__ == "__main__":
    raise SystemExit(main())
