"""The paper's analysis on the PyTorch port, reproduced interactively, and
then executed:

  1. per-layer C2C ratios for ResNet-50/VGG-16 and what the DL Layer API
     picks (data vs model vs hybrid node groups);
  2. the message-prioritization effect on exposed communication time;
  3. the C2C chooser's hybrid plan for a transformer, gated on what the
     mesh can actually execute, with the modeled exposed-comm win;
  4. real hybrid training steps on 8 ranks, ("node", "local") = (2, 4):
     the chooser's model-parallel layers run tensor-parallel over "local"
     while gradients reduce data-parallel over "node".

The twin of examples/hybrid_parallelism_demo.py. Parts 1-3 are host math.
Part 4 starts one process a rank: with `--device cpu` 8 gloo ranks on the
CPU (as the reference runs on 8 virtual CPU devices); on the card it needs
8 of them (NCCL), and says so when there are fewer, as the reference skips
with fewer than 8 devices.

  PYTHONPATH=src python examples/hybrid_parallelism_demo_torch.py --device cpu
"""

import argparse
import tempfile

import torch
import torch.multiprocessing as mp

from repro_torch.configs import cnn_tables, registry
from repro_torch.core import c2c, hw, planner as pl, simulator as sim
from repro_torch.data import pipeline
from repro_torch.launch import mesh as mesh_lib
from repro_torch.models.transformer import Batch, Model
from repro_torch.optim import optimizers as opt_lib
from repro_torch.train import trainer as tr

RANKS = 8
BATCH, SEQ = 8, 64


def _rank(rank: int, device: str, store_dir: str) -> None:
    """Part 4 on one rank: the hybrid planner on make_hier_mesh(2, 4), three
    mlsl steps; rank 0 prints."""
    torch.set_num_threads(1)
    dev = torch.device("cuda", rank) if device == "cuda" else \
        torch.device("cpu")
    mesh_lib.init_process_group(dev, rank=rank, world_size=RANKS,
                                store_dir=store_dir)
    cfg = registry.get_smoke_config("yi-6b")
    mesh = mesh_lib.make_hier_mesh(2, 4, device=dev)
    planner = pl.make_hybrid_planner(mesh, cfg, batch=BATCH, seq=SEQ)
    model = Model(cfg)
    pspecs = planner.tree_specs(model.param_defs(),
                                stacked_paths=Model.stacked_path)
    if rank == 0:
        print(f"   wq   -> {pspecs['blocks']['p0_attn']['attn']['wq']}")
        print(f"   wo   -> {pspecs['blocks']['p0_attn']['attn']['wo']}")
        print(f"   embed-> {pspecs['embed']}")
    comm = tr.CommConfig(mode="mlsl", hier=True, topo=hw.CLOUD_10G.name)
    optimizer = opt_lib.make_optimizer("adamw", 3e-3)
    state = tr.make_train_state(model, optimizer,
                                torch.Generator(device=dev).manual_seed(0),
                                dev, planner=planner)
    step_fn = tr.make_train_step(model, optimizer, mesh, planner, comm,
                                 device=dev)
    dcfg = pipeline.DataConfig(vocab=cfg.vocab, seq_len=SEQ,
                               global_batch=BATCH, seed=0)
    for s, raw in enumerate(pipeline.iterate(dcfg, 3)):
        b = Batch(tokens=torch.from_numpy(raw["tokens"]).to(dev),
                  labels=torch.from_numpy(raw["labels"]).to(dev))
        state, metrics = step_fn(state, b)
        loss, gnorm = float(metrics["loss"]), float(metrics["grad_norm"])
        if rank == 0:
            print(f"   step {s} loss {loss:.4f} gnorm {gnorm:.3f}",
                  flush=True)
    torch.distributed.destroy_process_group()


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)

    print("=== 1. C2C ratios and strategy choice (64 nodes, batch 2048) ===")
    for topo in ("resnet50", "vgg16"):
        layers = cnn_tables.TOPOLOGIES[topo]()
        report = pl.plan_report(layers, batch=2048, p=64)
        interesting = [r for r in report
                       if r.choice.strategy != c2c.Strategy.DATA][:4]
        print(f"{topo}: {len(report)} layers, "
              f"{sum(r.choice.strategy == c2c.Strategy.DATA for r in report)}"
              f" data-parallel")
        for r in interesting:
            print(f"   {r.name:12s} {r.kind:5s} -> {r.choice.strategy.value}"
                  f" (group={r.choice.group_size},"
                  f" ratio={r.choice.ratio:.0f} flop/B)")

    print("\n=== 2. message prioritization (ResNet-50, 64 nodes, 10GbE) ===")
    layers = sim.layers_from_specs(cnn_tables.resnet50_layers(), 32,
                                   hw.XEON_6148)
    for pol in sim.Policy:
        st = sim.simulate_iteration(layers, 64, hw.ETH_10G, pol,
                                    overlap_eff=0.7)
        print(f"   {pol.value:9s} exposed={st.exposed_comm*1e3:7.1f}ms "
              f"total={st.total_time*1e3:7.1f}ms")

    print("\n=== 3. executed hybrid plan (yi-6b smoke, node=2 x local=4) ===")
    cfg = registry.get_smoke_config("yi-6b")
    plan = pl.plan_hybrid(cfg, {"node": 2, "local": 4}, batch=BATCH, seq=SEQ)
    for lp in plan.layers:
        note = f" [{lp.reason}]" if lp.reason else ""
        print(f"   {lp.name:12s} {lp.kind:6s} "
              f"chooser={lp.choice.strategy.value}(g={lp.choice.group_size}) "
              f"executed={lp.executed}{note}")
    specs = c2c.layers_from_model_config(cfg, SEQ)
    cm = pl.model_hybrid_comm(plan, specs, batch=BATCH, nodes=plan.dp,
                              topo=hw.CLOUD_10G)
    print(f"   modeled exposed comm on {hw.CLOUD_10G.name}: "
          f"pure DP {cm.t_dp_flat*1e3:.2f}ms, "
          f"hybrid {cm.t_hybrid*1e3:.2f}ms "
          f"({cm.reduction_vs_flat:.1f}x less)")

    print(f"\n=== 4. hybrid training on {RANKS} ranks ({args.device}) ===")
    if args.device == "cuda":
        mesh_lib.resolve_device("cuda")           # raises without CUDA
        if torch.cuda.device_count() < RANKS:
            print(f"   skipped: {torch.cuda.device_count()} cards; part 4 "
                  f"needs {RANKS} (--device cpu runs it on {RANKS} gloo "
                  f"CPU ranks)")
            return
    with tempfile.TemporaryDirectory(prefix="hybrid_demo_") as store_dir:
        mp.start_processes(_rank, args=(args.device, store_dir),
                           nprocs=RANKS, join=True, start_method="spawn")


if __name__ == "__main__":
    main()
