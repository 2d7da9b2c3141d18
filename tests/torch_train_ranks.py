"""Rank body for tests/test_torch_train_hier.py: one gloo rank of the port's
train step on a ("node"=2, "local"=4) DeviceMesh, for every case of CASES
in turn, each from the same weights. Imports torch and repro_torch only,
so the spawned ranks never import JAX.

    python torch_train_ranks.py RANK WORLD STORE_DIR WEIGHTS_DIR OUT_DIR

WEIGHTS_DIR is a checkpoint of {"params": ...} (either package's format).
Writes OUT_DIR/<case>/rank<RANK>.json (losses, grad norms, plan routes and
residual shapes) and, on rank 0, the final parameters as a checkpoint in
OUT_DIR/<case>/ckpt.
"""

import json
import os
import sys

import torch
import torch.distributed as dist

from repro_torch import tree as tree_lib
from repro_torch.checkpoint import ckpt
from repro_torch.configs import registry
from repro_torch.core.planner import Planner
from repro_torch.data import pipeline
from repro_torch.launch import mesh as mesh_lib
from repro_torch.models.transformer import Batch, Model
from repro_torch.optim import optimizers as opt_lib, schedules
from repro_torch.train import trainer as tr

STEPS = 3
SEQ = 32
# case -> (CommConfig kwargs, Planner dp_only, global batch)
CASES = {
    "flat_fp32": (dict(mode="mlsl"), False, 8),
    "hier_fp32": (dict(mode="mlsl", hier=True), False, 8),
    "hier_int8_ef_accum2": (dict(mode="mlsl", hier=True, wire="int8",
                                 error_feedback=True, accum_steps=2),
                            True, 16),
    "topo_10gbe": (dict(mode="mlsl", hier=True, topo="xeon-shm-10gbe"),
                   False, 8),
    "topo_virt_int8_ef": (dict(mode="mlsl", hier=True,
                               topo="cloud-virtio-sriov", wire="int8",
                               error_feedback=True, bucket_bytes=2 ** 16),
                          True, 8),
    "gspmd_accum2": (dict(mode="gspmd", accum_steps=2), False, 16),
}


def run_case(name, mesh, weights_dir, out_dir, rank):
    kw, dp_only, batch = CASES[name]
    cfg = registry.get_smoke_config("yi-6b")
    model = Model(cfg)
    like = {"params": tree_lib.tree_map(
        lambda pd: torch.empty(pd.shape, dtype=pd.dtype, device="meta"),
        model.param_defs())}
    params = ckpt.restore(weights_dir, like, device="cpu")["params"]
    opt = opt_lib.adamw(schedules.warmup_cosine(3e-3, 1, STEPS))
    planner = Planner(mesh=mesh, dp_only=dp_only)
    comm = tr.CommConfig(**kw)
    state = tr.train_state_from_params(params, opt)
    step = tr.make_train_step(model, opt, mesh, planner, comm)
    rec = {"loss": [], "grad_norm": []}
    dcfg = pipeline.DataConfig(vocab=cfg.vocab, seq_len=SEQ,
                               global_batch=batch, seed=0)
    for raw in pipeline.iterate(dcfg, STEPS):
        state, m = step(state, Batch(tokens=torch.from_numpy(raw["tokens"]),
                                     labels=torch.from_numpy(raw["labels"])))
        rec["loss"].append(float(m["loss"]))
        rec["grad_norm"].append(float(m["grad_norm"]))
    if comm.mode == "mlsl":
        plan = tr.make_comm_engine(model, mesh, planner, comm).plan
        rec["algos"] = list(plan.algos)
        rec["fusable"] = list(plan.fusable)
        rec["residual_shapes"] = [list(r.shape) for r in
                                  state.comm_residuals or ()]
    case_dir = os.path.join(out_dir, name)
    os.makedirs(case_dir, exist_ok=True)
    if rank == 0:
        ckpt.save(os.path.join(case_dir, "ckpt"), {"params": state.params},
                  step=STEPS)
    with open(os.path.join(case_dir, f"rank{rank}.json"), "w") as f:
        json.dump(rec, f)


def run(rank: int, world: int, store_dir: str, weights_dir: str,
        out_dir: str):
    mesh_lib.init_process_group("cpu", rank=rank, world_size=world,
                                store_dir=store_dir)
    try:
        mesh = mesh_lib.make_hier_mesh(2, 4, device="cpu")
        for name in CASES:
            run_case(name, mesh, weights_dir, out_dir, rank)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    r, w, store, weights, out_dir = sys.argv[1:]
    run(int(r), int(w), store, weights, out_dir)
