"""Rank body for tests/test_torch_mp.py: one gloo rank of the port's plain
model parallelism (`Planner(mesh)` with a model axis of more than one rank)
on meshes of 8 ranks. Imports torch and repro_torch only, so the spawned
ranks never import JAX.

    python torch_mp_ranks.py RANK WORLD STORE_DIR INPUTS_DIR OUT_DIR

INPUTS_DIR holds ops.npz (the operators' inputs), ep.npz (one MoE layer's
weights and its input x) and one checkpoint of {"params": ...} per config of
CONFIGS. Writes OUT_DIR/ops/m<M>/rank<RANK>.npz (each operator's output and
gradients at model size M), OUT_DIR/ep/<case>/rank<RANK>.npz (the
expert-parallel MoE layer's output, aux and gradients on (data 2, model 4)),
OUT_DIR/engine/rank<RANK>.json (the leafwise-bucket and replay checks) and,
per case of
CASES and FSDP_CASES, OUT_DIR/<case>/rank<RANK>.json (losses, gradient
norms, local shapes, whether the final checkpoint restores this rank's
shards bit for bit; for the MoE cases each step's top-k expert ids from
rank 0) and, from rank 0, the final parameters gathered over the model
group (FSDP: and the batch axes, with the optimizer state) as a checkpoint
in OUT_DIR/<case>/ckpt.
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
from repro_torch.configs.base import AttnConfig, MoEConfig
from repro_torch.core.api import Session
from repro_torch.core import collectives as cl
from repro_torch.core import planner as pl
from repro_torch.data import pipeline
from repro_torch.launch import mesh as mesh_lib
from repro_torch.models import attention, common, moe
from repro_torch.models.transformer import Batch, Model
from repro_torch.optim import optimizers as opt_lib
from repro_torch.train import trainer as tr

STEPS, SEQ, BATCH, DATA_SEED, LR = 3, 16, 8, 3, 0.1
# the operators' attention: 4 query heads on 2 KV heads of 8, half of each
# head rotated (as chatglm3-6b); a KV shard at model size 4 is half a head
OPS_ATTN = AttnConfig(n_heads=4, n_kv=2, head_dim=8, rotary_frac=0.5)
# the split attentions (`attention.mp_path`), d 16: 24 query heads on 6 KV
# heads of 4 (own heads at model sizes 4 and 8, where a rank's 6 or 3 heads
# start mid-group; whole heads at 2), and 6 on 2 (own rows of 8 at 4 and
# 8, whole heads at 2; over 6 rows, padded to 8: at 8 two ranks hold only
# a padded row)
HEADS_ATTN = AttnConfig(n_heads=24, n_kv=6, head_dim=4, rotary_frac=0.5)
ROWS_ATTN = AttnConfig(n_heads=6, n_kv=2, head_dim=4, rotary_frac=0.5)
# op -> (config, the input x's key, kv_chunk, cross-attention)
SPLIT_OPS = {"attn_own_heads": (HEADS_ATTN, "xa", None, False),
             "attn_own_rows": (ROWS_ATTN, "xr", None, False),
             "attn_own_rows_chunk": (ROWS_ATTN, "xr", 3, False),
             "attn_own_rows_padded": (ROWS_ATTN, "xa", None, False),
             "attn_own_rows_padded_chunk": (ROWS_ATTN, "xa", 4, False),
             "cross_own_heads": (HEADS_ATTN, "xa", None, True),
             "cross_own_rows": (ROWS_ATTN, "xr", None, True),
             "cross_own_rows_padded": (ROWS_ATTN, "xa", None, True)}
OPS_SIZES = (2, 4, 8)


# moe_apply_ep on (data 2, model 4): one layer of 8 experts (2 a model
# rank), d 16, d_ff 32, top-2, silu, x (4, 8, 16); case -> (capacity
# factor, dense residual width, FSDP over "data", bf16 all-to-all, the
# weight-gather wire). Each rank's loss is sum(y^2) / y.size of the whole
# batch + EP_AUX_WEIGHT * aux / 2 (the data ranks' losses add up to the
# reference's mean(y^2) + EP_AUX_WEIGHT * aux)
EP_D, EP_E, EP_FF, EP_DENSE = 16, 8, 32, 24
EP_AUX_WEIGHT = 0.5
EP_CASES = {"cap8": (8.0, 0, False, False, "bf16"),
            "cap8_dense": (8.0, EP_DENSE, False, False, "bf16"),
            "cap8_a2a_bf16": (8.0, 0, False, True, "bf16"),
            "cap1.25": (1.25, 0, False, False, "bf16"),
            "fsdp_bf16": (8.0, 0, True, False, "bf16"),
            "fsdp_int8": (8.0, 0, True, False, "int8")}


def ep_config(name: str) -> MoEConfig:
    cap, dense, *_ = EP_CASES[name]
    return MoEConfig(n_experts=EP_E, top_k=2, d_ff=EP_FF,
                     capacity_factor=cap, dense_residual_ff=dense)


def smoke_config():
    return registry.get_smoke_config("yi-6b")


def grok_config():
    return registry.get_smoke_config("grok-1-314b")


def odd_vocab_config():
    """A vocabulary of 510 does not split over 4 ranks: the embedding is
    split by the model dimension and the head is row-parallel."""
    return dataclasses.replace(smoke_config(), vocab=510)


def chatglm3_config():
    """2 KV heads of 32 over 4 ranks: every KV shard is half a head."""
    return registry.get_smoke_config("chatglm3-6b")


CONFIGS = {"smoke": smoke_config, "odd_vocab": odd_vocab_config,
           "chatglm3": chatglm3_config, "grok": grok_config}
# mesh name -> ("host", data, model) | ("hier", node, local, model)
MESHES = {"4x2": ("host", 4, 2), "2x4": ("host", 2, 4), "1x8": ("host", 1, 8),
          "2x2x2": ("hier", 2, 2, 2)}
# case -> (config, mesh, CommConfig kwargs, optimizer); SGD at LR, the
# setting of tests/test_torch_hybrid.py (AdamW's normalized step would blow
# rounding in near-zero gradients up to its step size)
CASES = {
    **{f"{mode}_{m}": ("smoke", m, dict(mode=mode), "sgd")
       for m in ("4x2", "2x4", "1x8") for mode in ("mlsl", "gspmd")},
    "mlsl_hier_2x2x2": ("smoke", "2x2x2", dict(mode="mlsl", hier=True),
                        "sgd"),
    "gspmd_hier_2x2x2_lamb": ("smoke", "2x2x2", dict(mode="gspmd"), "lamb"),
    "lars_2x4": ("smoke", "2x4", dict(mode="mlsl"), "lars"),
    "lamb_2x4": ("smoke", "2x4", dict(mode="mlsl"), "lamb"),
    "odd_vocab_2x4": ("odd_vocab", "2x4", dict(mode="mlsl"), "sgd"),
    "chatglm3_2x4": ("chatglm3", "2x4", dict(mode="mlsl"), "sgd"),
    "accum2_overlap_4x2": ("smoke", "4x2",
                           dict(mode="mlsl", accum_steps=2, overlap=True),
                           "sgd"),
    # from the checkpoint that mlsl_2x4 saves, on the other mesh
    "resume_4x2": ("smoke", "4x2", dict(mode="mlsl"), "sgd"),
    # the lossy wires, which the reference cannot run under a model axis
    "int8_ef_4x2": ("smoke", "4x2",
                    dict(mode="mlsl", wire="int8", error_feedback=True),
                    "sgd"),
    "bf16_4x2": ("smoke", "4x2", dict(mode="mlsl", wire="bf16"), "sgd"),
}
RESUME_FROM = {"resume_4x2": "mlsl_2x4"}

# FSDP (Planner(mesh, fsdp=True)) on gspmd, against the JAX trainer with the
# same planner: mesh name -> as MESHES; case -> (config, mesh, CommConfig
# kwargs, optimizer), global batch FSDP_BATCH. AdamW and LAMB at FSDP_LR:
# their normalized step blows reduction-order rounding of a near-zero
# gradient up to a step of the learning rate's size
FSDP_MESHES = {"8x1": ("host", 8, 1), "4x2": ("host", 4, 2),
               "hier2x4": ("hier", 2, 4)}
FSDP_LR = 1e-3
FSDP_BATCH = 16         # two rows a data rank at (8, 1): two microbatches
FSDP_CASES = {
    "fsdp_8x1": ("smoke", "8x1", dict(mode="gspmd", accum_steps=2), "adamw"),
    "fsdp_4x2": ("smoke", "4x2", dict(mode="gspmd", accum_steps=2), "adamw"),
    "fsdp_hier2x4": ("smoke", "hier2x4", dict(mode="gspmd", accum_steps=2),
                     "adamw"),
    "fsdp_4x2_lamb": ("smoke", "4x2", dict(mode="gspmd"), "lamb"),
    "fsdp_grok_gather_8x1": ("grok", "8x1", dict(mode="gspmd"), "adamw"),
    "fsdp_grok_ep_8x1": ("grok", "8x1", dict(mode="gspmd", moe_impl="ep"),
                         "adamw"),
    "fsdp_grok_ep_int8_8x1": ("grok", "8x1",
                              dict(mode="gspmd", moe_impl="ep",
                                   wgather_wire="int8"), "adamw"),
}


def make_mesh(name: str, meshes=MESHES):
    kind, *sizes = meshes[name]
    if kind == "hier":
        return mesh_lib.make_hier_mesh(*sizes, device="cpu")
    return mesh_lib.make_host_mesh(*sizes, device="cpu")


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().numpy()


def _cols(x, r, m):
    n = x.shape[-1] // m
    return x[..., r * n:(r + 1) * n]


def _rows(x, r, m):
    n = x.shape[0] // m
    return x[r * n:(r + 1) * n]


def _grad(fn, args, weight=None):
    """(fn(*args), the gradients of sum(fn(*args) * weight), or of the
    scalar fn(*args) without a weight, with respect to every argument)."""
    args = [a.clone().requires_grad_(True) for a in args]
    out = fn(*args)
    loss = out if weight is None else torch.sum(out * weight)
    return out, torch.autograd.grad(loss, args)


def ops(mesh, data: dict, out_dir: str, m: int):
    """Each new operator at model size m, forward and backward, on this
    rank's shards; the test holds them to their dense forms."""
    group = mesh.get_group("model")
    r = mesh.get_local_rank("model")
    T = {k: torch.from_numpy(v) for k, v in data.items()}
    out = {}
    y, (g,) = _grad(lambda x: cl.tp_all_gather(x, group),
                    [_cols(T["x"], r, m)], T["w_gather"])
    out.update(gather_y=y, gather_g=g)
    y, (g,) = _grad(lambda x: cl.tp_split(x, group), [T["x"]],
                    _cols(T["w_gather"], r, m))
    out.update(split_y=y, split_g=g)
    mx = cl.tp_max((T["x"] * (1.0 + r)).requires_grad_(True), group)
    out.update(max_y=mx, max_requires_grad=np.array(mx.requires_grad))
    ids = T["ids"]
    for name, dim, shard in (("embed_vocab", -2, _rows(T["table"], r, m)),
                             ("embed_dim", -1, _cols(T["table"], r, m))):
        y, (g,) = _grad(lambda t, d=dim: common.embed_lookup(
            t, ids, group=group, dim=d), [shard], T["w_embed"])
        out.update({f"{name}_y": y, f"{name}_g": g})
    for name, mask in (("xent", None), ("xent_mask", T["mask"])):
        y, (g,) = _grad(lambda z, k=mask: common.vocab_parallel_xent(
            z, T["labels"], group, k), [_cols(T["logits"], r, m)])
        out.update({f"{name}_y": y, f"{name}_g": g})
    layout = attention.HEAD_SHARDED
    shards = [T["xa"], _cols(T["wq"], r, m), _cols(T["wk"], r, m),
              _cols(T["wv"], r, m), _rows(T["wo"], r, m)]

    def apply(x, wq, wk, wv, wo):
        return attention.gqa_apply({"wq": wq, "wk": wk, "wv": wv, "wo": wo},
                                   x, OPS_ATTN, tp_axis=group, layout=layout)

    def gathered(x, wq, wk, wv, wo):
        return attention.gqa_gathered(
            {"wq": wq, "wk": wk, "wv": wv, "wo": wo}, x, OPS_ATTN, group,
            layout)

    for name, fn in (("attn_apply", apply), ("attn_gathered", gathered)):
        y, grads = _grad(fn, shards, T["w_attn"])
        out[f"{name}_y"] = y
        for k, g in zip(("x", "wq", "wk", "wv", "wo"), grads):
            out[f"{name}_g{k}"] = g
    out["aligned"] = np.array(attention.head_aligned(layout, OPS_ATTN, m))
    for name, (a, xkey, chunk, cross) in SPLIT_OPS.items():
        sfx = "h" if a is HEADS_ATTN else "r"
        args = [T[xkey], _cols(T[f"wq_{sfx}"], r, m),
                _cols(T[f"wk_{sfx}"], r, m), _cols(T[f"wv_{sfx}"], r, m),
                _rows(T[f"wo_{sfx}"], r, m)] + ([T["enc"]] if cross else [])

        def fn(x, wq, wk, wv, wo, enc=None, a=a, chunk=chunk, cross=cross):
            p = {"wq": wq, "wk": wk, "wv": wv, "wo": wo}
            if not cross:
                return attention.gqa_apply(p, x, a, kv_chunk=chunk,
                                           tp_axis=group, layout=layout)
            kv = attention.gqa_cross_kv(p, enc, a, tp_axis=group,
                                        layout=layout)
            return attention.gqa_cross(p, x, kv, a, tp_axis=group,
                                       layout=layout)

        y, grads = _grad(fn, args, T[f"w_{xkey}"])
        out[f"{name}_y"] = y
        for k, g in zip(("x", "wq", "wk", "wv", "wo", "enc"), grads):
            out[f"{name}_g{k}"] = g
        out[f"{name}_path"] = np.array(attention.mp_path(layout, a, m,
                                                         flash=False))
    path = os.path.join(out_dir, "ops", f"m{m}")
    os.makedirs(path, exist_ok=True)
    np.savez(os.path.join(path, f"rank{dist.get_rank()}.npz"),
             **{k: _np(v) if isinstance(v, torch.Tensor) else v
                for k, v in out.items()})


def ep_checks(data: dict, out_dir: str):
    """Each case of EP_CASES on this rank's shards: x's rows of this data
    rank, experts of this model rank (with FSDP, also this data rank's half
    of d), forward and backward."""
    mesh = mesh_lib.make_host_mesh(2, 4, device="cpu")
    mg, dg = mesh.get_group("model"), mesh.get_group("data")
    r, dr = mesh.get_local_rank("model"), mesh.get_local_rank("data")
    T = {k: torch.from_numpy(v) for k, v in data.items()}
    e_loc, half = EP_E // 4, EP_D // 2
    x = _rows(T["x"], dr, 2)
    for name, (_, dense, fsdp, a2a, wire) in EP_CASES.items():
        p = {k: T[k][r * e_loc:(r + 1) * e_loc] for k in ("w1", "w2", "w3")}
        if fsdp:
            p["w1"], p["w3"] = (t[:, dr * half:(dr + 1) * half]
                                for t in (p["w1"], p["w3"]))
            p["w2"] = p["w2"][..., dr * half:(dr + 1) * half]
        p["router"] = T["router"]
        if dense:
            p["dense"] = {k: T[f"dense_{k}"] for k in ("w1", "w2", "w3")}
        paths = tree_lib.paths(p)
        leaves = [t.clone().requires_grad_(True)
                  for t in [x] + tree_lib.leaves(p)]
        y, aux = moe.moe_apply_ep(
            tree_lib.unflatten(paths, leaves[1:]), leaves[0],
            ep_config(name), act="silu", model_group=mg, batch_groups=[dg],
            fsdp_groups=[dg] if fsdp else [], wire_bf16_a2a=a2a,
            wgather_wire=wire)
        loss = (torch.sum(y ** 2) / (y.numel() * 2)
                + EP_AUX_WEIGHT * aux / 2)
        grads = torch.autograd.grad(loss, leaves)
        path = os.path.join(out_dir, "ep", name)
        os.makedirs(path, exist_ok=True)
        np.savez(os.path.join(path, f"rank{dist.get_rank()}.npz"), y=_np(y),
                 aux=_np(aux), coords=np.array([dr, r]), **{"g_" + "/".join(k): _np(g) for k, g in
                                  zip([("x",)] + paths, grads)})


def engine_checks(out_dir: str, rank: int):
    """At (4, 2), int8 wire with error feedback: each leafwise bucket's
    output is collectives.allreduce of the leaf's local shard over the data
    group (bf16 wire, mean), bit for bit; the fused norm buckets reduce over
    the data group; the bucket replay runs on the local shapes. And each
    rank's coordinates on make_hier_mesh(2, 2, 2)."""
    mesh = make_mesh("4x2")
    model = Model(smoke_config())
    planner = pl.Planner(mesh=mesh)
    comm = tr.CommConfig(mode="mlsl", wire="int8", error_feedback=True)
    engine = tr.make_comm_engine(model, mesh, planner, comm, device="cpu")
    p = engine.plan
    gen = torch.Generator().manual_seed(100 + rank)
    local = tree_lib.leaves(convert.shard_params(
        tree_lib.tree_map(lambda pd: torch.zeros(pd.shape),
                          model.param_defs()),
        tr.param_specs(model, planner), mesh))
    grads = tree_lib.unflatten(list(p.buckets.paths),
                               [torch.randn(t.shape, generator=gen)
                                for t in local])
    out, _ = engine.reduce(grads, engine.init_residuals("cpu"))
    leaves, reduced = tree_lib.leaves(grads), tree_lib.leaves(out)
    data = [mesh.get_group("data")]
    rec = {"leafwise_equal": [], "fused_equal": [],
           "fusable": list(p.fusable)}
    for bi, b in enumerate(p.buckets.buckets):
        if p.fusable[bi]:
            flat = cl.allreduce_ef(
                torch.cat([leaves[i].reshape(-1) for i in b.leaf_ids]),
                engine.init_residuals("cpu")[bi], data, mean=True)[0]
            rec["fused_equal"].append(torch.equal(
                torch.cat([reduced[i].reshape(-1) for i in b.leaf_ids]),
                flat))
            continue
        rec["leafwise_equal"].append(all(
            torch.equal(reduced[i], cl.allreduce(leaves[i], data,
                                                 wire="bf16", mean=True))
            for i in b.leaf_ids))
    rec["replay"] = list(engine.bucket_timer(mesh).sample())
    hier = make_mesh("2x2x2")
    coords = [None] * dist.get_world_size()
    dist.all_gather_object(coords, [hier.get_local_rank(a)
                                    for a in ("node", "local", "model")])
    rec["hier_coords"] = coords
    rec["local_shapes"] = [[list(s) for s in p.shapes_for(bi)]
                           for bi in range(p.n_buckets)]
    os.makedirs(os.path.join(out_dir, "engine"), exist_ok=True)
    with open(os.path.join(out_dir, "engine", f"rank{rank}.json"), "w") as f:
        json.dump(rec, f)


def route_ids(model, params, batch) -> list:
    """The top-k expert ids of every moe layer, in the forward's order, on
    `batch` from the full `params`: [layer][token] of k ids, ascending."""
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


def run_case(name, inputs_dir, out_dir, rank):
    fsdp = name in FSDP_CASES
    cfg_name, mesh_name, kw, optimizer = (FSDP_CASES if fsdp
                                          else CASES)[name]
    cfg = CONFIGS[cfg_name]()
    mesh = make_mesh(mesh_name, FSDP_MESHES if fsdp else MESHES)
    model = Model(cfg)
    planner = pl.Planner(mesh=mesh, fsdp=fsdp)
    specs = {"params": tr.param_specs(model, planner)}
    like = {"params": tree_lib.tree_map(
        lambda pd: torch.empty(pd.shape, dtype=pd.dtype, device="meta"),
        model.param_defs())}
    src = (os.path.join(out_dir, RESUME_FROM[name], "ckpt")
           if name in RESUME_FROM else os.path.join(inputs_dir, cfg_name))
    params = ckpt.restore(src, like, device="cpu", specs=specs,
                          mesh=mesh)["params"]
    opt = opt_lib.make_optimizer(optimizer, FSDP_LR if fsdp else LR)
    state = tr.train_state_from_params(params, opt)
    if fsdp:
        # through the Session, as a framework drives it: the step gives
        # LARS and LAMB their norm groups
        step = Session(mesh=mesh, planner=planner,
                       comm_cfg=tr.CommConfig(**kw)).make_train_step(model,
                                                                     opt)
    else:
        step = tr.make_train_step(model, opt, mesh, planner,
                                  tr.CommConfig(**kw))
    rec = {"loss": [], "grad_norm": []}
    dcfg = pipeline.DataConfig(vocab=cfg.vocab, seq_len=SEQ,
                               global_batch=FSDP_BATCH if fsdp else BATCH,
                               seed=DATA_SEED)
    for raw in pipeline.iterate(dcfg, STEPS):
        batch = Batch(tokens=torch.from_numpy(raw["tokens"]),
                      labels=torch.from_numpy(raw["labels"]))
        if cfg.moe is not None:
            whole = convert.gather_params(state.params, specs["params"],
                                          mesh)
            if rank == 0:
                rec.setdefault("route_ids", []).append(
                    route_ids(model, whole, batch))
        state, m = step(state, batch)
        rec["loss"].append(float(m["loss"]))
        rec["grad_norm"].append(float(m["grad_norm"]))
    # FSDP: the optimizer state makes the round trip too
    saved = {"params": state.params}
    if fsdp:
        saved.update(state.opt_state)
        specs.update({k: specs["params"] for k in state.opt_state})
        like.update({k: like["params"] for k in state.opt_state})
    full = {k: convert.gather_params(v, specs[k], mesh)
            for k, v in saved.items()}
    case_dir = os.path.join(out_dir, name)
    if rank == 0:
        os.makedirs(case_dir, exist_ok=True)
        ckpt.save(os.path.join(case_dir, "ckpt"), full, step=STEPS)
    dist.barrier()
    back = ckpt.restore(os.path.join(case_dir, "ckpt"), like, device="cpu",
                        specs=specs, mesh=mesh)
    rec["restores_bitwise"] = all(
        a.dtype == b.dtype and torch.equal(a, b) for a, b in
        zip(tree_lib.leaves(saved), tree_lib.leaves(back)))
    rec["local_shapes"] = [list(t.shape)
                           for t in tree_lib.leaves(state.params)]
    with open(os.path.join(case_dir, f"rank{rank}.json"), "w") as f:
        json.dump(rec, f)


def run(rank: int, world: int, store_dir: str, inputs_dir: str,
        out_dir: str):
    torch.set_num_threads(1)
    mesh_lib.init_process_group("cpu", rank=rank, world_size=world,
                                store_dir=store_dir)
    try:
        data = dict(np.load(os.path.join(inputs_dir, "ops.npz")))
        for m in OPS_SIZES:
            ops(mesh_lib.make_host_mesh(world // m, m, device="cpu"), data,
                out_dir, m)
        ep_checks(dict(np.load(os.path.join(inputs_dir, "ep.npz"))),
                  out_dir)
        engine_checks(out_dir, rank)
        for name in (*CASES, *FSDP_CASES):
            run_case(name, inputs_dir, out_dir, rank)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    r, w, store, inp, out_dir = sys.argv[1:]
    run(int(r), int(w), store, inp, out_dir)
