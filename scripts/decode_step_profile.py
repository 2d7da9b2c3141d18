#!/usr/bin/env python3
"""The serving decode step of S-A's configuration on one card: its time,
and a profiler window that says where it goes.

    python3 scripts/decode_step_profile.py [--src DIR] [--steps 32]
                                           [--profile-steps 4] [--out F]

Full-width yi-6b (32 layers, bf16, seeded random weights), a batch of 8
rows whose cache holds S-A's `max_seq` of 2120 slots, decoding from
position 2048 as S-A's first steps do. The step's time does not depend on
what the cache holds (every slot is read, those past `pos` masked), so no
prefill fills it and no kernel is built. Each step is what
`Engine.generate` does for one token: `Model.decode_step`, the greedy
token, its copy to the host.

Two paths, each timed over --steps steps after 3 warm-up steps (the
per-step host clock after the token reached the host; median and mean):
  * "one card": `decode_step` without a layout (S-A's path);
  * "mp": under `force_model_parallel` over a one-rank NCCL model group
    (`serve.engine.serving_options`, the `mp serve` phase's path), where
    the package has it.
Then `torch.profiler` over --profile-steps steps of each: the kernels
launched and the device time a step, the host time a step, and the ops
with the most host time of their own. `--src` takes the package from
another tree's `src` (an older commit's, whose decode has no "mp" path),
to compare two commits in one run on one card. Prints one JSON object;
writes it to --out too.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

BATCH, POS, MAX_SEQ = 8, 2048, 2120


def _steps(torch, step, tok, n: int) -> list:
    """n decode steps from tok, each timed on the host clock up to its
    token's arrival there."""
    out = []
    for i in range(n):
        t0 = time.perf_counter()
        tok = step(tok, i)
        tok.cpu()
        out.append(time.perf_counter() - t0)
    return out


def _profile(torch, step, tok, n: int) -> dict:
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i in range(n):
            tok = step(tok, i)
            tok.cpu()
        host = (time.perf_counter() - t0) / n
    ev = prof.key_averages()
    launches = sum(e.count for e in ev if e.key in (
        "cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
        "cuLaunchKernelEx"))
    device_us = sum(getattr(e, "self_device_time_total",
                            getattr(e, "self_cuda_time_total", 0))
                    for e in ev)
    top = sorted(ev, key=lambda e: -e.self_cpu_time_total)[:10]
    return {"host_s_per_step": host,
            "kernel_launches_per_step": launches / n,
            "device_s_per_step": device_us / 1e6 / n,
            "top_host_ops": [[e.key, e.count // n,
                              e.self_cpu_time_total / 1e6 / n]
                             for e in top]}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", default=os.path.join(ROOT, "src"))
    ap.add_argument("--steps", type=int, default=32)
    ap.add_argument("--profile-steps", type=int, default=4)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.src))
    import subprocess

    import torch
    from repro_torch.configs import registry
    from repro_torch.models.transformer import Model
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True
    ).stdout.strip().splitlines()[0]
    cfg = registry.get_config("yi-6b")
    model = Model(cfg)
    params = model.init(torch.Generator(device=dev).manual_seed(0), dev)
    paths = {"one card": {}}
    try:
        from repro_torch.core.planner import Planner
        from repro_torch.launch import mesh as mesh_lib
        from repro_torch.serve.engine import serving_options
        mesh = mesh_lib.make_host_mesh(1, 1, device=dev)
        kw = serving_options(model, mesh, Planner(mesh=mesh),
                             force_model_parallel=True)
        paths["mp"] = {**kw, "max_seq": MAX_SEQ}
    except (ImportError, TypeError):
        pass
    rec = {"card": card, "src": os.path.abspath(args.src),
           "config": f"yi-6b, batch {BATCH}, {MAX_SEQ} cache slots, from "
                     f"position {POS}"}
    for name, kw in paths.items():
        cache = model.init_cache(BATCH, MAX_SEQ, device=dev)

        def step(tok, i, kw=kw, cache=cache):
            logits, _ = model.decode_step(params, cache, tok[:, None],
                                          POS + i, **kw)
            return torch.argmax(logits, dim=-1)
        tok = torch.zeros((BATCH,), dtype=torch.long, device=dev)
        _steps(torch, step, tok, 3)
        times = _steps(torch, step, tok, args.steps)
        rec[name] = {"step_s_median": statistics.median(times),
                     "step_s_mean": statistics.fmean(times),
                     **_profile(torch, step, tok, args.profile_steps)}
        del cache
    print(card)
    line = json.dumps(rec)
    print(line, flush=True)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    if "mp" in paths:
        import torch.distributed as dist
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
