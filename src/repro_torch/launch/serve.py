"""Serving entry point: batched prefill + decode with the reduced model.

Ports `repro/launch/serve.py`:

  python -m repro_torch.launch.serve --arch yi-6b --batch 4 \\
      --prompt-len 32 --new-tokens 32

runs on the card (`--device cpu` for the CPU). Weights are random from
`--seed`; the prompts are ragged and go through `serve_requests`. The
observability flags (`--stats`, `--trace`, `--telemetry`) are not yet
ported and raise.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import registry
from repro_torch.launch import mesh as mesh_lib
from repro_torch.models.transformer import Model
from repro_torch.serve.engine import Engine, EngineConfig, Request, \
    serve_requests

_NOT_PORTED = ("--stats", "--trace", "--telemetry")


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
    for flag in _NOT_PORTED:
        ap.add_argument(flag, nargs="?", const=True, default=None,
                        help=argparse.SUPPRESS)
    return ap


def main(argv=None) -> int:
    args = _parser().parse_args(argv)
    asked = [f for f in _NOT_PORTED if getattr(args, f[2:]) is not None]
    if asked:
        raise NotImplementedError(
            f"{', '.join(asked)}: not yet ported to repro_torch")
    dev = mesh_lib.resolve_device(args.device)
    cfg = registry.get_smoke_config(args.arch)
    model = Model(cfg)
    params = model.init(torch.Generator(device=dev).manual_seed(args.seed),
                        dev)
    eng = Engine(model, params, EngineConfig(
        max_seq=args.prompt_len + args.new_tokens + 8,
        temperature=args.temperature, long_context=args.long_context))

    rng = np.random.default_rng(args.seed)
    reqs = [Request(prompt=rng.integers(0, cfg.vocab,
                                        size=rng.integers(
                                            4, args.prompt_len + 1)).astype(
                                                np.int32),
                    max_new=args.new_tokens) for _ in range(args.batch)]
    t0 = time.perf_counter()
    serve_requests(eng, reqs)
    dt = time.perf_counter() - t0
    total_new = sum(r.max_new for r in reqs)
    for i, r in enumerate(reqs):
        print(f"req{i}: prompt_len={len(r.prompt)} -> {r.out[:8].tolist()}...")
    print(f"{total_new} tokens in {dt:.2f}s ({total_new / dt:.1f} tok/s "
          f"batched on {dev}, reduced config)", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
