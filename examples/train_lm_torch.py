"""End-to-end training driver on the PyTorch port.

The twin of examples/train_lm.py, on one rank: the default preset trains a
~2M-param llama-family model for 300 steps and reports the loss curve and a
checkpoint; the `100m` preset is the same driver at ~100M params.

  PYTHONPATH=src python examples/train_lm_torch.py            # the card
  PYTHONPATH=src python examples/train_lm_torch.py --device cpu --steps 3
      [--preset tiny|100m] [--comm mlsl --wire int8 --error-feedback]
"""

import argparse
import os
import tempfile
import time

import torch

from repro_torch.checkpoint import ckpt
from repro_torch.configs.base import AttnConfig, ModelConfig
from repro_torch.core.planner import Planner
from repro_torch.data import pipeline
from repro_torch.launch import mesh as mesh_lib
from repro_torch.models.transformer import Batch, Model
from repro_torch.optim import optimizers as opt_lib, schedules
from repro_torch.train import trainer as tr

PRESETS = {
    # ~2.4M params: minutes on a CPU
    "tiny": dict(n_layers=4, d_model=128, n_heads=4, n_kv=2, d_ff=384,
                 vocab=2048, seq=128, batch=8, steps=300),
    # ~106M params: the "train ~100M for a few hundred steps" target
    "100m": dict(n_layers=12, d_model=768, n_heads=12, n_kv=4, d_ff=2048,
                 vocab=32000, seq=512, batch=32, steps=300),
}


def build_config(p) -> ModelConfig:
    return ModelConfig(
        name=f"lm-{p['d_model']}", arch_type="dense", n_layers=p["n_layers"],
        d_model=p["d_model"], vocab=p["vocab"], block_pattern=("attn",),
        d_ff=p["d_ff"],
        attn=AttnConfig(n_heads=p["n_heads"], n_kv=p["n_kv"],
                        head_dim=p["d_model"] // p["n_heads"]),
        dtype=torch.float32, remat=False)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--preset", default="tiny", choices=sorted(PRESETS))
    ap.add_argument("--steps", type=int, default=None)
    ap.add_argument("--comm", default="mlsl", choices=["gspmd", "mlsl"])
    ap.add_argument("--wire", default="fp32", choices=["fp32", "bf16", "int8"])
    ap.add_argument("--error-feedback", action="store_true")
    ap.add_argument("--accum", type=int, default=1)
    ap.add_argument("--ckpt", default=os.path.join(tempfile.gettempdir(),
                                                   "repro_torch_lm_ckpt"))
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = mesh_lib.resolve_device(args.device)

    p = PRESETS[args.preset]
    steps = args.steps or p["steps"]
    cfg = build_config(p)
    model = Model(cfg)
    mesh = mesh_lib.make_host_mesh(1, 1, device=dev)
    planner = Planner(mesh=mesh)
    lr = schedules.warmup_cosine(3e-3, steps // 10, steps)
    opt = opt_lib.adamw(lr)
    comm = tr.CommConfig(mode=args.comm, wire=args.wire,
                         error_feedback=args.error_feedback,
                         accum_steps=args.accum)
    data = pipeline.DataConfig(vocab=cfg.vocab, seq_len=p["seq"],
                               global_batch=p["batch"])
    print(f"preset={args.preset} params={model.n_params():,} "
          f"comm={args.comm}/{args.wire} steps={steps} device={dev}")
    state = tr.make_train_state(model, opt,
                                torch.Generator(device=dev).manual_seed(0),
                                dev)
    step = tr.make_train_step(model, opt, mesh, planner, comm, device=dev)
    losses = []
    t0 = time.time()
    for i, raw in enumerate(pipeline.iterate(data, steps)):
        batch = Batch(tokens=torch.from_numpy(raw["tokens"]).to(dev),
                      labels=torch.from_numpy(raw["labels"]).to(dev))
        state, m = step(state, batch)
        losses.append(float(m["loss"]))
        if i % 25 == 0 or i == steps - 1:
            print(f"step {i:4d}  loss {losses[-1]:.4f}  "
                  f"gnorm {float(m['grad_norm']):.2f}  "
                  f"{time.time()-t0:.0f}s", flush=True)
    ckpt.save(args.ckpt, {"params": state.params}, step=steps)
    print(f"saved checkpoint to {args.ckpt}")
    return losses


if __name__ == "__main__":
    main()
