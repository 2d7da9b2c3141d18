"""Rank body for tests/test_torch_hybrid.py: one gloo rank of the port's
hybrid (data x model) execution on a ("node"=2, "local"=4) DeviceMesh.
Imports torch and repro_torch only, so the spawned ranks never import JAX.

    python torch_hybrid_ranks.py RANK WORLD STORE_DIR INPUTS_DIR OUT_DIR

INPUTS_DIR holds fg.npz (the f/g operator inputs) and one checkpoint of
{"params": ...} per config of CONFIGS (either package's format). Writes
OUT_DIR/fg/rank<RANK>.npz and, per case of CASES, OUT_DIR/<case>/
rank<RANK>.json (losses, grad norms, whether the final checkpoint restores
this rank's shards bit for bit) and, from rank 0, the final parameters
gathered over the tp group as a checkpoint in OUT_DIR/<case>/ckpt.
"""

import dataclasses
import json
import os
import sys

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import convert, tree as tree_lib
from repro_torch.checkpoint import ckpt
from repro_torch.configs import registry
from repro_torch.core import collectives as cl
from repro_torch.core import planner as pl
from repro_torch.data import pipeline
from repro_torch.launch import mesh as mesh_lib
from repro_torch.models.transformer import Batch, Model
from repro_torch.optim import optimizers as opt_lib
from repro_torch.train import trainer as tr

STEPS, SEQ, BATCH, DATA_SEED, LR = 2, 16, 8, 3, 0.1


def smoke_config():
    return registry.get_smoke_config("yi-6b")


def indivisible_heads_config():
    """2 query and 2 KV heads do not split over 4 local ranks: every layer
    falls back to data parallelism."""
    cfg = smoke_config()
    return dataclasses.replace(
        cfg, attn=dataclasses.replace(cfg.attn, n_heads=2, n_kv=2))


CONFIGS = {"smoke": smoke_config, "indivisible": indivisible_heads_config}
# case -> (config, hybrid planner, CommConfig kwargs)
CASES = {
    "smoke_dp": ("smoke", False, dict(mode="mlsl", hier=True)),
    "smoke_hybrid": ("smoke", True, dict(mode="mlsl", hier=True)),
    "indivisible_dp": ("indivisible", False, dict(mode="mlsl", hier=True)),
    "indivisible_hybrid": ("indivisible", True, dict(mode="mlsl", hier=True)),
    # the int8 wire without error feedback and 2 microbatches: the sharded
    # buckets take the flat int8 route over the node axis with the
    # accumulator in the gather-side dequantize
    "smoke_hybrid_int8_accum2": ("smoke", True,
                                 dict(mode="mlsl", hier=True, wire="int8",
                                      accum_steps=2)),
    # LARS and LAMB take per-leaf norms of each rank's local shards, as the
    # reference's optimizer update inside its fully manual region does
    "smoke_hybrid_lars": ("smoke", True, dict(mode="mlsl", hier=True)),
    "smoke_hybrid_lamb": ("smoke", True, dict(mode="mlsl", hier=True)),
}
# case -> optimizer (make_optimizer name, lr LR); the others train with SGD
OPTIMIZERS = {"smoke_hybrid_lars": "lars", "smoke_hybrid_lamb": "lamb"}


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().numpy()


def fg_ops(mesh, inputs: str, out_dir: str, rank: int):
    """The f/g pair around a column-sharded w1 and a row-sharded w2, forward
    and backward, with tp_psum and with tp_psum_scatter as g; the two g
    forms on per-rank distinct values; the quantum error."""
    data = np.load(inputs)
    group = mesh.get_group("local")
    loc = mesh.get_local_rank("local")
    x = torch.from_numpy(data["x"])
    w1, w2 = (convert.shard_params(
        {"w": torch.from_numpy(data[k])}, {"w": spec}, mesh)["w"]
        for k, spec in (("w1", (None, "local")), ("w2", ("local", None))))
    out = {}
    for name, g_op in (("psum", cl.tp_psum), ("scatter", cl.tp_psum_scatter)):
        a, b, xx = (t.clone().requires_grad_(True) for t in (w1, w2, x))
        xr = cl.tp_replicate(xx, group)
        loss = torch.sum(g_op(torch.relu(xr @ a) @ b, group))
        g1, g2, gx = torch.autograd.grad(loss, (a, b, xx))
        out.update({f"{name}_loss": loss, f"{name}_g1": g1,
                    f"{name}_g2": g2, f"{name}_gx": gx})
    v = torch.from_numpy(data["v"]) * (1.0 + loc)
    out["psum_v"] = cl.tp_psum(v, group)
    out["scatter_v"] = cl.tp_psum_scatter(v, group)
    comm = cl.TPComm("local", group)
    out["tpcomm_v"] = comm.psum(v, scatter=True)
    out["tpcomm_size"] = torch.tensor(comm.size)
    try:
        cl.tp_psum_scatter(v[:, :6], group)
        out["quantum_error"] = np.array("")
    except ValueError as e:
        out["quantum_error"] = np.array(str(e))
    os.makedirs(os.path.join(out_dir, "fg"), exist_ok=True)
    np.savez(os.path.join(out_dir, "fg", f"rank{rank}.npz"),
             **{k: _np(v) if isinstance(v, torch.Tensor) else v
                for k, v in out.items()})


def run_case(name, mesh, inputs_dir, out_dir, rank):
    cfg_name, hybrid, kw = CASES[name]
    cfg = CONFIGS[cfg_name]()
    model = Model(cfg)
    planner = (pl.make_hybrid_planner(mesh, cfg, batch=BATCH, seq=SEQ)
               if hybrid else pl.Planner(mesh=mesh))
    specs = tr.param_specs(model, planner) if hybrid else None
    like = {"params": tree_lib.tree_map(
        lambda pd: torch.empty(pd.shape, dtype=pd.dtype, device="meta"),
        model.param_defs())}
    params = ckpt.restore(os.path.join(inputs_dir, cfg_name), like,
                          device="cpu", specs=None if specs is None
                          else {"params": specs}, mesh=mesh)["params"]
    opt = opt_lib.make_optimizer(OPTIMIZERS.get(name, "sgd"), LR)
    comm = tr.CommConfig(**kw)
    state = tr.train_state_from_params(params, opt)
    step = tr.make_train_step(model, opt, mesh, planner, comm)
    rec = {"loss": [], "grad_norm": []}
    dcfg = pipeline.DataConfig(vocab=cfg.vocab, seq_len=SEQ,
                               global_batch=BATCH, seed=DATA_SEED)
    for raw in pipeline.iterate(dcfg, STEPS):
        state, m = step(state, Batch(tokens=torch.from_numpy(raw["tokens"]),
                                     labels=torch.from_numpy(raw["labels"])))
        rec["loss"].append(float(m["loss"]))
        rec["grad_norm"].append(float(m["grad_norm"]))
    full = (state.params if specs is None
            else convert.gather_params(state.params, specs, mesh))
    case_dir = os.path.join(out_dir, name)
    if rank == 0:
        os.makedirs(case_dir, exist_ok=True)
        ckpt.save(os.path.join(case_dir, "ckpt"), {"params": full},
                  step=STEPS)
    dist.barrier()
    back = ckpt.restore(os.path.join(case_dir, "ckpt"), like, device="cpu",
                        specs=None if specs is None else {"params": specs},
                        mesh=mesh)["params"]
    rec["restores_bitwise"] = all(
        a.dtype == b.dtype and torch.equal(a, b) for a, b in
        zip(tree_lib.leaves(state.params), tree_lib.leaves(back)))
    rec["local_shapes"] = [list(t.shape)
                           for t in tree_lib.leaves(state.params)]
    with open(os.path.join(case_dir, f"rank{rank}.json"), "w") as f:
        json.dump(rec, f)


def run(rank: int, world: int, store_dir: str, inputs_dir: str,
        out_dir: str):
    mesh_lib.init_process_group("cpu", rank=rank, world_size=world,
                                store_dir=store_dir)
    try:
        mesh = mesh_lib.make_hier_mesh(2, 4, device="cpu")
        fg_ops(mesh, os.path.join(inputs_dir, "fg.npz"), out_dir, rank)
        for name in CASES:
            run_case(name, mesh, inputs_dir, out_dir, rank)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    r, w, store, inp, out_dir = sys.argv[1:]
    run(int(r), int(w), store, inp, out_dir)
