"""Rank body for tests/test_torch_archs.py, test_torch_archs_mla.py,
test_torch_archs_recurrent.py and test_torch_archs_moe.py: one gloo rank
of the port's mlsl
train step on a ("node"=2, "local"=4) DeviceMesh, fp32 and int8 + error
feedback, for each architecture named on the command line in turn, each
from the reference's weights. Imports torch, numpy and repro_torch only, so
the spawned ranks never import JAX.

    python torch_archs_ranks.py RANK WORLD STORE_DIR WEIGHTS_DIR OUT_DIR ARCHS

ARCHS is a comma-separated list of architectures.

WEIGHTS_DIR/<arch> is a checkpoint of {"params": ...} (either package's
format). Writes OUT_DIR/<arch>/<case>/rank<RANK>.json (losses and grad
norms; for the MoE archs also each step's top-k expert ids of every moe
layer, from the parameters the step starts from).
"""

import json
import os
import sys

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import tree as tree_lib
from repro_torch.checkpoint import ckpt
from repro_torch.configs import registry
from repro_torch.core.planner import Planner
from repro_torch.data import pipeline
from repro_torch.launch import mesh as mesh_lib
from repro_torch.models import moe
from repro_torch.models.transformer import Batch, Model
from repro_torch.optim import optimizers as opt_lib, schedules
from repro_torch.train import trainer as tr

# the archs beside yi-6b's, by the test file that runs them:
# test_torch_archs.py, _mla.py, _recurrent.py and _moe.py (each file's
# one-rank and 8-rank train cases take 150-300 s on one worker)
ATTENTION = ("llava-next-mistral-7b", "whisper-small")
MLA = ("minicpm3-4b",)
RECURRENT = ("recurrentgemma-2b", "mamba2-2.7b")
MOE = ("grok-1-314b", "arctic-480b")
ARCHS = ATTENTION + MLA + RECURRENT + MOE
STEPS = 3
SEQ = 32
BATCH = 8
COMM = dict(mode="mlsl", wire="int8", error_feedback=True)
CASES = {"fp32": dict(mode="mlsl"), "int8_ef": COMM}


def stub_inputs(cfg, batch: int, step: int) -> dict:
    """Standard-normal patch or frame embeddings (numpy f32) for `step`,
    drawn from a seed, as both packages' trainers take them."""
    rng = np.random.default_rng(1000 + step)
    kw = {}
    if cfg.vlm_img_tokens:
        kw["img_embeds"] = rng.standard_normal(
            (batch, cfg.vlm_img_tokens, cfg.vlm_d_vision)).astype(np.float32)
    if cfg.encoder is not None:
        kw["frame_embeds"] = rng.standard_normal(
            (batch, cfg.encoder.n_frames, cfg.encoder.d_input)
        ).astype(np.float32)
    return kw


def route_ids(model, params, batch) -> list:
    """The top-k expert ids of every moe layer, in the forward's order, on
    `batch` from `params`: [layer][token] of k ids in ascending order."""
    ids, route = [], moe.route

    def spy(*args, **kw):
        out = route(*args, **kw)
        ids.append(torch.sort(out[1], dim=-1).values.tolist())
        return out

    moe.route = spy
    try:
        with torch.no_grad():
            model.loss(params, batch)
    finally:
        moe.route = route
    return ids


def run_case(arch, case, mesh, weights_dir, out_dir, rank):
    cfg = registry.get_smoke_config(arch)
    model = Model(cfg)
    like = {"params": tree_lib.tree_map(
        lambda pd: torch.empty(pd.shape, dtype=pd.dtype, device="meta"),
        model.param_defs())}
    params = ckpt.restore(os.path.join(weights_dir, arch), like,
                          device="cpu")["params"]
    opt = opt_lib.adamw(schedules.warmup_cosine(3e-3, 1, STEPS))
    state = tr.train_state_from_params(params, opt)
    step = tr.make_train_step(model, opt, mesh, Planner(mesh=mesh),
                              tr.CommConfig(**CASES[case]))
    rec = {"loss": [], "grad_norm": []}
    dcfg = pipeline.DataConfig(vocab=cfg.vocab, seq_len=SEQ,
                               global_batch=BATCH, seed=0)
    for s, raw in enumerate(pipeline.iterate(dcfg, STEPS)):
        kw = {k: torch.from_numpy(v)
              for k, v in stub_inputs(cfg, BATCH, s).items()}
        batch = Batch(tokens=torch.from_numpy(raw["tokens"]),
                      labels=torch.from_numpy(raw["labels"]), **kw)
        if cfg.moe is not None:
            rec.setdefault("route_ids", []).append(
                route_ids(model, state.params, batch))
        state, m = step(state, batch)
        rec["loss"].append(float(m["loss"]))
        rec["grad_norm"].append(float(m["grad_norm"]))
    case_dir = os.path.join(out_dir, arch, case)
    os.makedirs(case_dir, exist_ok=True)
    with open(os.path.join(case_dir, f"rank{rank}.json"), "w") as f:
        json.dump(rec, f)


def run(rank: int, world: int, store_dir: str, weights_dir: str,
        out_dir: str, archs: str):
    mesh_lib.init_process_group("cpu", rank=rank, world_size=world,
                                store_dir=store_dir)
    try:
        mesh = mesh_lib.make_hier_mesh(2, 4, device="cpu")
        for arch in archs.split(","):
            for case in CASES:
                run_case(arch, case, mesh, weights_dir, out_dir, rank)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    r, w, store, weights, out_dir, archs = sys.argv[1:]
    run(int(r), int(w), store, weights, out_dir, archs)
