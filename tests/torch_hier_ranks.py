"""Rank body for tests/test_torch_hier.py: one gloo rank of the port's
two-level collectives on a ("node"=2, "local"=4) DeviceMesh. Imports torch
and repro_torch only, so the spawned ranks never import JAX.

    python torch_hier_ranks.py RANK WORLD STORE_DIR INPUTS.npz OUT_DIR

Writes every result to OUT_DIR/rank<RANK>.npz.
"""

import sys

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core import collectives as cl
from repro_torch.core import hier
from repro_torch.kernels import ops as kops
from repro_torch.launch import mesh as mesh_lib

# (name, HierSpec) of the lossy-leg checks (tests/test_hierarchical.py's)
LOSSY = {"bf16_fp32": hier.HierSpec(wire_intra="bf16"),
         "bf16_bf16": hier.HierSpec(wire_intra="bf16", wire_inter="bf16"),
         "bf16_int8": hier.HierSpec(wire_intra="bf16", wire_inter="int8"),
         "fp32_int8": hier.HierSpec(wire_inter="int8")}
EF = hier.HierSpec(wire_intra="bf16", wire_inter="int8", error_feedback=True)


def _np(t: torch.Tensor) -> np.ndarray:
    t = t.detach()
    return (t.to(torch.float32) if t.dtype == torch.bfloat16 else t).numpy()


def run(rank: int, world: int, store_dir: str, inputs: str, out_dir: str):
    mesh_lib.init_process_group("cpu", rank=rank, world_size=world,
                                store_dir=store_dir)
    try:
        mesh = mesh_lib.make_hier_mesh(2, 4, device="cpu")
        groups = {a: mesh.get_group(a) for a in ("node", "local")}
        node, local = groups["node"], groups["local"]
        data = np.load(inputs)
        x = torch.from_numpy(data["x"][rank])
        res = torch.from_numpy(data["res"][rank])
        acc = torch.from_numpy(data["acc"])
        out = {"coord": torch.tensor(mesh.get_coordinate())}
        out["per_axis"] = cl._psum(x, [local, node])
        out["fp32"] = hier.hier_allreduce(x, groups)
        out["fp32_mean_acc"] = hier.hier_allreduce(x, groups, mean=True,
                                                   acc=acc)
        out["fp32_mean"] = hier.hier_allreduce(x, groups, mean=True)
        for name, spec in LOSSY.items():
            out[name] = hier.hier_allreduce(x, groups, spec)
        # the fabric shard the int8 leg quantizes (bf16 intra, then the
        # bf16 reduce-scatter over the node group), and its EF quantization
        shard, _ = hier._intra_scatter(x, EF, local, 2)
        y, _ = cl._scatter_shard(shard, [node])
        out["fabric_shard"] = y
        out["q"], out["s"], _, out["res_of_shard"] = kops.quantize_ef(y, res)
        out["ef"], out["ef_res"] = hier.hier_allreduce_ef(x, res, groups, EF,
                                                          mean=True)
        out["ef_acc"], out["ef_acc_res"] = hier.hier_allreduce_ef(
            x, res, groups, EF, mean=True, acc=acc)
        comm = cl.Comm(mesh=mesh, data_axes=("node", "local"),
                       model_axis=None, node_axis="node", local_axis="local")
        out["comm_fp32"] = comm.allreduce(x)
        out["comm_int8"] = comm.allreduce(x, wire="int8")
        flat = cl.Comm(mesh=mesh, data_axes=("node", "local"),
                       model_axis=None)
        out["comm_flat_fp32"] = flat.allreduce(x, mean=True)
        out["comm_sizes"] = torch.tensor(
            [comm.hierarchical, flat.hierarchical, comm.node_size,
             comm.local_size, comm.data_parallel_size,
             comm.model_parallel_size, comm.run(lambda a: a + 1, 41)])
        out["all_to_all"] = cl.all_to_all(x[:64].reshape(8, 8), [local],
                                          split_axis=0, concat_axis=1)
        out["broadcast"] = cl.broadcast(x[:16], [node, local], root=5)
        np.savez(f"{out_dir}/rank{rank}.npz",
                 **{k: _np(v) for k, v in out.items()})
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    r, w, store, inp, out_dir = sys.argv[1:]
    run(int(r), int(w), store, inp, out_dir)
