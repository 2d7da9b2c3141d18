"""Rank body for tests/test_torch_mp_families.py: one gloo rank of the
port's model parallelism (`Planner(mesh)` with a model axis of more than
one rank, gspmd and mlsl), FSDP beside it, and hybrid execution for every
family of the registry, on meshes of 8 ranks. Imports torch, numpy and
repro_torch only, so the spawned ranks never import JAX.

    python torch_mp_families_ranks.py RANK WORLD STORE_DIR INPUTS_DIR OUT_DIR

INPUTS_DIR/<arch> is a checkpoint of {"params": ...} (either package's
format) per arch of CASES. Writes, per case, OUT_DIR/<case>/rank<RANK>.json
(losses, gradient norms, each leaf's local shape, whether the final
checkpoint restores this rank's shards bit for bit) and, from rank 0, the
final parameters gathered over the model group (FSDP: and the batch axes;
hybrid: the tp group) as a checkpoint in OUT_DIR/<case>/ckpt.
"""

import json
import os
import sys

import torch
import torch.distributed as dist

from repro_torch import convert, tree as tree_lib
from repro_torch.checkpoint import ckpt
from repro_torch.configs import registry
from repro_torch.core import planner as pl
from repro_torch.data import pipeline
from repro_torch.launch import mesh as mesh_lib
from repro_torch.models.transformer import Batch, Model
from repro_torch.optim import optimizers as opt_lib
from repro_torch.train import trainer as tr

from torch_archs_ranks import stub_inputs

STEPS, SEQ, BATCH, DATA_SEED, LR = 3, 16, 8, 3, 0.1
# recurrentgemma's local attention has a window of 64 at the smoke size:
# its cases run past it
LONG_SEQ = 80
# mesh name -> ("host", data, model) | ("hier", node, local)
MESHES = {"4x2": ("host", 4, 2), "2x4": ("host", 2, 4), "1x8": ("host", 1, 8),
          "hier2x4": ("hier", 2, 4)}
# case -> (arch, mesh, CommConfig kwargs, planner, sequence length). The
# planner: "mp" is Planner(mesh), "fsdp" Planner(mesh, fsdp=True), "hybrid"
# make_hybrid_planner(mesh, ...). SGD at LR.
CASES = {
    "minicpm3_gspmd_2x4": ("minicpm3-4b", "2x4", dict(mode="gspmd"), "mp",
                           SEQ),
    "whisper_mlsl_2x4": ("whisper-small", "2x4", dict(mode="mlsl"), "mp",
                         SEQ),
    "llava_gspmd_4x2": ("llava-next-mistral-7b", "4x2", dict(mode="gspmd"),
                        "mp", SEQ),
    # the local blocks' one KV head splits into half heads: the gathered
    # attention, past the window, materialized and on chunks of 16 keys
    "recurrentgemma_mlsl_4x2": ("recurrentgemma-2b", "4x2",
                                dict(mode="mlsl"), "mp", LONG_SEQ),
    "recurrentgemma_gspmd_2x4_kv_chunk": ("recurrentgemma-2b", "2x4",
                                          dict(mode="gspmd", kv_chunk=16),
                                          "mp", LONG_SEQ),
    # 4 heads over 8 ranks: each rank attends its own 2 of the 16 query
    # rows (MLA; whisper's encoder, decoder and cross-attention; the local
    # blocks past the window on chunks of 16 keys)
    "minicpm3_gspmd_1x8": ("minicpm3-4b", "1x8", dict(mode="gspmd"), "mp",
                           SEQ),
    "whisper_mlsl_1x8": ("whisper-small", "1x8", dict(mode="mlsl"), "mp",
                         SEQ),
    "recurrentgemma_gspmd_1x8_kv_chunk": ("recurrentgemma-2b", "1x8",
                                          dict(mode="gspmd", kv_chunk=16),
                                          "mp", LONG_SEQ),
    "mamba2_gspmd_2x4": ("mamba2-2.7b", "2x4", dict(mode="gspmd"), "mp",
                         SEQ),
    "mamba2_mlsl_4x2": ("mamba2-2.7b", "4x2", dict(mode="mlsl"), "mp", SEQ),
    # the int8 + EF wire, on which the reference aborts under a model axis:
    # held to mamba2_mlsl_4x2
    "mamba2_int8_ef_4x2": ("mamba2-2.7b", "4x2",
                           dict(mode="mlsl", wire="int8",
                                error_feedback=True), "mp", SEQ),
    # 4 experts: one a rank at model 4, each expert's ff split at model 8
    "grok_gather_gspmd_2x4": ("grok-1-314b", "2x4", dict(mode="gspmd"), "mp",
                              SEQ),
    "grok_gather_gspmd_1x8": ("grok-1-314b", "1x8", dict(mode="gspmd"), "mp",
                              SEQ),
    "grok_ep_gspmd_2x4": ("grok-1-314b", "2x4",
                          dict(mode="gspmd", moe_impl="ep"), "mp", SEQ),
    # the reference's mlsl step cannot run the ep dispatch (ROADMAP queue
    # 3): held to grok_ep_gspmd_2x4, which routes the same source-rank
    # slices and differs in the order of its gradient sums only
    "grok_ep_mlsl_2x4": ("grok-1-314b", "2x4",
                         dict(mode="mlsl", moe_impl="ep"), "mp", SEQ),
    "arctic_mlsl_4x2": ("arctic-480b", "4x2", dict(mode="mlsl"), "mp", SEQ),
    "grok_fsdp_gspmd_4x2": ("grok-1-314b", "4x2", dict(mode="gspmd"), "fsdp",
                            SEQ),
    "llava_hybrid_2x4": ("llava-next-mistral-7b", "hier2x4",
                         dict(mode="mlsl"), "hybrid", SEQ),
    "recurrentgemma_hybrid_2x4": ("recurrentgemma-2b", "hier2x4",
                                  dict(mode="mlsl"), "hybrid", LONG_SEQ),
}
LOSSY = {"mamba2_int8_ef_4x2": "mamba2_mlsl_4x2"}
TWINS = {"grok_ep_mlsl_2x4": "grok_ep_gspmd_2x4"}


def make_mesh(name: str):
    kind, *sizes = MESHES[name]
    if kind == "hier":
        return mesh_lib.make_hier_mesh(*sizes, device="cpu")
    return mesh_lib.make_host_mesh(*sizes, device="cpu")


def make_planner(kind: str, mesh, cfg, seq: int) -> pl.Planner:
    if kind == "hybrid":
        return pl.make_hybrid_planner(mesh, cfg, batch=BATCH, seq=seq)
    return pl.Planner(mesh=mesh, fsdp=kind == "fsdp")


def run_case(name, inputs_dir, out_dir, rank):
    arch, mesh_name, kw, kind, seq = CASES[name]
    cfg = registry.get_smoke_config(arch)
    mesh = make_mesh(mesh_name)
    model = Model(cfg)
    planner = make_planner(kind, mesh, cfg, seq)
    specs = {"params": tr.param_specs(model, planner)}
    like = {"params": tree_lib.tree_map(
        lambda pd: torch.empty(pd.shape, dtype=pd.dtype, device="meta"),
        model.param_defs())}
    params = ckpt.restore(os.path.join(inputs_dir, arch), like, device="cpu",
                          specs=specs, mesh=mesh)["params"]
    opt = opt_lib.make_optimizer("sgd", LR)
    state = tr.train_state_from_params(params, opt)
    step = tr.make_train_step(model, opt, mesh, planner, tr.CommConfig(**kw))
    rec = {"loss": [], "grad_norm": []}
    dcfg = pipeline.DataConfig(vocab=cfg.vocab, seq_len=seq,
                               global_batch=BATCH, seed=DATA_SEED)
    for s, raw in enumerate(pipeline.iterate(dcfg, STEPS)):
        stub = {k: torch.from_numpy(v)
                for k, v in stub_inputs(cfg, BATCH, s).items()}
        state, m = step(state, Batch(tokens=torch.from_numpy(raw["tokens"]),
                                     labels=torch.from_numpy(raw["labels"]),
                                     **stub))
        rec["loss"].append(float(m["loss"]))
        rec["grad_norm"].append(float(m["grad_norm"]))
    full = convert.gather_params(state.params, specs["params"], mesh)
    case_dir = os.path.join(out_dir, name)
    if rank == 0:
        os.makedirs(case_dir, exist_ok=True)
        ckpt.save(os.path.join(case_dir, "ckpt"), {"params": full},
                  step=STEPS)
    dist.barrier()
    back = ckpt.restore(os.path.join(case_dir, "ckpt"), like, device="cpu",
                        specs=specs, mesh=mesh)["params"]
    rec["restores_bitwise"] = all(
        a.dtype == b.dtype and torch.equal(a, b) for a, b in
        zip(tree_lib.leaves(state.params), tree_lib.leaves(back)))
    rec["local_shapes"] = {"/".join(p): list(t.shape) for p, t in
                           tree_lib.leaves_with_paths(state.params)}
    with open(os.path.join(case_dir, f"rank{rank}.json"), "w") as f:
        json.dump(rec, f)


def run(rank: int, world: int, store_dir: str, inputs_dir: str,
        out_dir: str):
    mesh_lib.init_process_group("cpu", rank=rank, world_size=world,
                                store_dir=store_dir)
    try:
        for name in CASES:
            run_case(name, inputs_dir, out_dir, rank)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    r, w, store, inp, out_dir = sys.argv[1:]
    run(int(r), int(w), store, inp, out_dir)
