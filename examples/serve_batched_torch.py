"""Batched serving example on the PyTorch port: prefill a mixed batch of
requests, decode with a bounded-state model (Mamba2 SSD, the family native
to long_500k), greedy.

The twin of examples/serve_batched.py:

  PYTHONPATH=src python examples/serve_batched_torch.py        # the card
  PYTHONPATH=src python examples/serve_batched_torch.py --device cpu
      [--arch mamba2-2.7b] [--requests 6] [--new-tokens 24]
"""

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import registry
from repro_torch.launch import mesh as mesh_lib
from repro_torch.models.transformer import Model
from repro_torch.serve.engine import (Engine, EngineConfig, Request,
                                      serve_requests)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="mamba2-2.7b",
                    choices=registry.ARCH_IDS)
    ap.add_argument("--requests", type=int, default=6)
    ap.add_argument("--new-tokens", type=int, default=24)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = mesh_lib.resolve_device(args.device)

    cfg = registry.get_smoke_config(args.arch)
    model = Model(cfg)
    params = model.init(torch.Generator(device=dev).manual_seed(0), dev)
    eng = Engine(model, params, EngineConfig(max_seq=160))

    rng = np.random.default_rng(0)
    reqs = [Request(prompt=rng.integers(0, cfg.vocab,
                                        size=int(rng.integers(4, 40))).astype(
                                            np.int32),
                    max_new=int(rng.integers(4, args.new_tokens)))
            for _ in range(args.requests)]
    t0 = time.time()
    serve_requests(eng, reqs)
    dt = time.time() - t0
    tok = sum(r.max_new for r in reqs)
    for i, r in enumerate(reqs):
        print(f"req{i}: prompt={len(r.prompt):3d} new={r.max_new:3d} "
              f"-> {r.out[:6].tolist()}...")
    print(f"{tok} tokens in {dt:.1f}s ({tok/dt:.1f} tok/s, "
          f"reduced {cfg.name} on {dev})")
    return reqs


if __name__ == "__main__":
    main()
