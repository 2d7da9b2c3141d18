"""Rank body for tests/test_torch_mp_serve.py: one gloo rank of the port's
model-parallel serving (`Engine` with a mesh and a planner, and
`Model.prefill` / `decode_step` under the planner's layout) on meshes of 8
ranks. Imports torch, numpy and repro_torch only, so the spawned ranks
never import JAX.

    python torch_mp_serve_ranks.py RANK WORLD STORE_DIR INPUTS_DIR OUT_DIR

INPUTS_DIR/<arch> is a checkpoint of {"params": ...} per arch of CASES;
INPUTS_DIR/<case>.npz holds the case's prompts (`tokens`), stub
embeddings, the reference's greedy tokens the decode steps are fed
(`teacher`, (B, DECODE_STEPS)) and, for an int8 cache, the reference's
cache before each decode step (`cache<i>/<path>`). Writes, per case,
OUT_DIR/<case>/rank<RANK>.npz: the logits of this data rank's rows after
the prefill and each decode step (`logits`, (1 + DECODE_STEPS, rows, V)),
this rank's cache leaves after the prefill (`prefill/<path>`) and after
the last step (`last/<path>`), and the tokens `Engine.generate` returned
for the whole batch (`generated`).
"""

import os
import sys

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import convert, tree as tree_lib
from repro_torch.checkpoint import ckpt
from repro_torch.configs import registry
from repro_torch.core import planner as pl
from repro_torch.launch import mesh as mesh_lib
from repro_torch.models.transformer import Batch, Model
from repro_torch.serve import engine as eng
from repro_torch.train import trainer as tr

BATCH, PROMPT, DECODE_STEPS, MAX_SEQ = 4, 24, 6, 48
# llava's long-context case: a prompt past the smoke window of 64
LONG_PROMPT, LONG_MAX_SEQ = 80, 96
# case -> (arch, (data, model), planner ("mp": Planner(mesh), "fsdp":
# Planner(mesh, fsdp=True)), CommConfig kwargs, EngineConfig kwargs)
ARCHS = ("yi-6b", "llava-next-mistral-7b", "minicpm3-4b", "chatglm3-6b",
         "whisper-small", "deepseek-7b", "recurrentgemma-2b", "mamba2-2.7b",
         "grok-1-314b", "arctic-480b")
CASES = {
    **{f"{a.split('-')[0]}_2x4": (a, (2, 4), "mp", {}, {}) for a in ARCHS},
    # heads (and grok-1's experts' ff) split past the head counts: the
    # gathered heads, the caches split by slot
    **{f"{a.split('-')[0]}_1x8": (a, (1, 8), "mp", {}, {})
       for a in ("yi-6b", "minicpm3-4b", "whisper-small", "mamba2-2.7b",
                 "grok-1-314b")},
    "yi_fsdp_2x4": ("yi-6b", (2, 4), "fsdp", {}, {}),
    "grok_fsdp_2x4": ("grok-1-314b", (2, 4), "fsdp", {}, {}),
    "grok_ep_2x4": ("grok-1-314b", (2, 4), "mp", dict(moe_impl="ep"), {}),
    "grok_ep_fsdp_int8_2x4": ("grok-1-314b", (2, 4), "fsdp",
                              dict(moe_impl="ep", wgather_wire="int8"), {}),
    # the int8 cache split by slot (4 KV heads over 8)
    "yi_kv_int8_1x8": ("yi-6b", (1, 8), "mp", {}, dict(kv_dtype="int8")),
    # the ring of 64 slots compacted and split by slot
    "llava_long_1x8": ("llava-next-mistral-7b", (1, 8), "mp", {},
                       dict(long_context=True)),
}


def prompt_len(name: str) -> int:
    return LONG_PROMPT if CASES[name][4].get("long_context") else PROMPT


def max_seq(name: str) -> int:
    return LONG_MAX_SEQ if CASES[name][4].get("long_context") else MAX_SEQ


def _flat(tree) -> dict:
    """Copies of the leaves (the decode steps write the cache in place)."""
    return {"/".join(p): t.numpy().copy()
            for p, t in tree_lib.leaves_with_paths(tree)}


def _unflat(arrays, prefix: str) -> dict:
    keys = [k for k in arrays.files if k.startswith(prefix + "/")]
    return tree_lib.unflatten(
        [tuple(k[len(prefix) + 1:].split("/")) for k in keys],
        [torch.from_numpy(arrays[k]) for k in keys])


def run_case(name, inputs_dir, out_dir, rank):
    arch, (data, model_size), kind, comm_kw, eng_kw = CASES[name]
    cfg = registry.get_smoke_config(arch)
    mesh = mesh_lib.make_host_mesh(data, model_size, device="cpu")
    model = Model(cfg)
    planner = pl.Planner(mesh=mesh, fsdp=kind == "fsdp")
    specs = {"params": tr.param_specs(model, planner)}
    like = {"params": tree_lib.tree_map(
        lambda pd: torch.empty(pd.shape, dtype=pd.dtype, device="meta"),
        model.param_defs())}
    params = ckpt.restore(os.path.join(inputs_dir, arch), like, device="cpu",
                          specs=specs, mesh=mesh)["params"]
    inp = np.load(os.path.join(inputs_dir, name + ".npz"))
    engine = eng.Engine(model, params, eng.EngineConfig(
        max_seq=max_seq(name), **eng_kw), mesh=mesh, planner=planner,
        comm=tr.CommConfig(**comm_kw))
    stub = {k: inp[k] for k in ("img_embeds", "frame_embeds") if k in inp}
    batch = Batch(tokens=torch.from_numpy(engine.rows(inp["tokens"])),
                  **{k: torch.from_numpy(engine.rows(v))
                     for k, v in stub.items()})
    kw = {**engine.mp_kw, **engine.ctx_kw}
    logits, cache, pos = model.prefill(params, batch, max_seq(name), **kw)
    out = {"logits": [logits.numpy()]}
    out.update({f"prefill/{k}": v for k, v in _flat(cache).items()})
    teacher = engine.rows(inp["teacher"])
    fed = any(k.startswith("cache0/") for k in inp.files)
    for i in range(DECODE_STEPS):
        if fed:
            # an int8 code one off moves the logits by more than 1e-4:
            # each step decodes from the reference's cache, cut to this
            # rank's shard
            whole = _unflat(inp, f"cache{i}")
            _, cspecs = eng.cache_spec_tree(whole, planner, BATCH, mesh)
            cache = convert.shard_params(whole, cspecs, mesh)
        logits, cache = model.decode_step(
            params, cache, torch.from_numpy(teacher[:, i:i + 1]), pos + i,
            max_seq=max_seq(name), **kw)
        out["logits"].append(logits.numpy())
    out["logits"] = np.stack(out["logits"])
    out.update({f"last/{k}": v for k, v in _flat(cache).items()})
    out["generated"] = engine.generate(inp["tokens"], DECODE_STEPS, **stub)
    case_dir = os.path.join(out_dir, name)
    os.makedirs(case_dir, exist_ok=True)
    np.savez(os.path.join(case_dir, f"rank{rank}.npz"), **out)


def run(rank: int, world: int, store_dir: str, inputs_dir: str,
        out_dir: str, names: str):
    mesh_lib.init_process_group("cpu", rank=rank, world_size=world,
                                store_dir=store_dir)
    try:
        for name in names.split(","):
            run_case(name, inputs_dir, out_dir, rank)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    r, w, store, inp_dir, out_dir, names = sys.argv[1:]
    run(int(r), int(w), store, inp_dir, out_dir, names)
