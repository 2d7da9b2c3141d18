"""Rank body for tests/test_torch_collectives.py: one gloo rank of the
port's collectives. Imports torch and repro_torch only, so the spawned
ranks never import JAX.

    python torch_collective_ranks.py RANK WORLD STORE_DIR INPUTS.npz OUT_DIR

Reads the per-rank inputs, runs every collective of the port over the
("data",) mesh dimension and writes the results to OUT_DIR/rank<RANK>.npz.
"""

import sys

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh

from repro_torch.core import collectives as cl
from repro_torch.kernels import ops as kops
from repro_torch.launch import mesh as mesh_lib


def _np(t: torch.Tensor) -> np.ndarray:
    t = t.detach()
    return (t.to(torch.float32) if t.dtype == torch.bfloat16 else t).numpy()


def run(rank: int, world: int, store_dir: str, inputs: str, out_dir: str):
    mesh_lib.init_process_group("cpu", rank=rank, world_size=world,
                                store_dir=store_dir)
    try:
        mesh = init_device_mesh("cpu", (world,), mesh_dim_names=("data",))
        groups = [mesh.get_group("data")]
        data = np.load(inputs)
        x = torch.from_numpy(data["x"][rank])
        res = torch.from_numpy(data["res"][rank])
        acc = torch.from_numpy(data["acc"])
        out = {}
        for wire in cl.WIRES:
            out[f"{wire}_mean"] = cl.allreduce(x, groups, wire=wire,
                                               mean=True)
            out[f"{wire}_sum_acc"] = cl.allreduce(x, groups, wire=wire,
                                                  acc=acc)
        shard, _ = cl._scatter_shard(x, groups)
        out["shard"] = shard
        out["q"], out["s"], _ = kops.quantize(shard, block=cl.QUANT_BLOCK)
        for fused in (True, False):
            tag = "fused" if fused else "composed"
            out[f"ef_{tag}"], out[f"ef_res_{tag}"] = cl.allreduce_ef(
                x, res, groups, mean=True, fused=fused)
            out[f"ef_acc_{tag}"], out[f"ef_acc_res_{tag}"] = cl.allreduce_ef(
                x, res, groups, mean=True, fused=fused, acc=acc)
        out["reduce_scatter"] = cl.reduce_scatter(x, groups)
        out["all_gather"] = cl.all_gather(x[:64], groups)
        np.savez(f"{out_dir}/rank{rank}.npz",
                 **{k: _np(v) for k, v in out.items()})
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    r, w, store, inp, out_dir = sys.argv[1:]
    run(int(r), int(w), store, inp, out_dir)
