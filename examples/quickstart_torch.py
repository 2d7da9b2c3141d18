"""Quickstart on the PyTorch port: build a model from the registry, train it
with the MLSL comm stack through a `Session`, and decode from it.

  PYTHONPATH=src python examples/quickstart_torch.py              # the card
  PYTHONPATH=src python examples/quickstart_torch.py --device cpu

The twin of examples/quickstart.py, on one rank.
"""

import argparse

import numpy as np
import torch

from repro_torch.configs import registry
from repro_torch.core.api import Session
from repro_torch.data import pipeline
from repro_torch.launch import mesh as mesh_lib
from repro_torch.models.transformer import Batch, Model
from repro_torch.optim import optimizers as opt_lib
from repro_torch.serve.engine import Engine, EngineConfig
from repro_torch.train import trainer as tr


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--steps", type=int, default=40)
    args = ap.parse_args(argv)
    dev = mesh_lib.resolve_device(args.device)

    # 1. any assigned architecture, reduced to laptop scale
    cfg = registry.get_smoke_config("yi-6b")
    model = Model(cfg)
    print(f"model: {cfg.name}  params: {model.n_params():,}")

    # 2. a Session = mesh + planner + MLSL comm config (paper C7)
    mesh = mesh_lib.make_host_mesh(1, 1, device=dev)
    sess = Session.create(
        mesh, n_params=model.n_params(),
        comm=tr.CommConfig(mode="mlsl", wire="bf16", prioritize=True))
    print(f"wire saving vs fp32: {sess.wire_savings():.1f}x")

    # 3. train
    opt = opt_lib.adamw(3e-3)
    data = pipeline.DataConfig(vocab=cfg.vocab, seq_len=64, global_batch=8)
    state = tr.make_train_state(model, opt,
                                torch.Generator(device=dev).manual_seed(0),
                                dev, planner=sess.planner)
    step = sess.make_train_step(model, opt, device=dev)
    losses = []
    for i, raw in enumerate(pipeline.iterate(data, args.steps)):
        batch = Batch(tokens=torch.from_numpy(raw["tokens"]).to(dev),
                      labels=torch.from_numpy(raw["labels"]).to(dev))
        state, m = step(state, batch)
        losses.append(float(m["loss"]))
        if i % 10 == 0:
            print(f"step {i:3d}  loss {losses[-1]:.4f}")

    # 4. serve
    eng = Engine(model, state.params, EngineConfig(max_seq=96))
    prompt = np.asarray(pipeline.batch_at(data, 999)["tokens"][:2, :16])
    out = eng.generate(prompt, 8)
    print("generated:", out.tolist())
    return losses, out


if __name__ == "__main__":
    main()
