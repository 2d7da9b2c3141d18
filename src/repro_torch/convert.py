"""Carry the JAX reference's parameters across to the port, and cut them
into a tensor-parallel rank's shards.

`params_from_jax(tree)` takes the reference's parameter tree as numpy
arrays (`jax.tree_util.tree_map(np.asarray, params)`) and returns the port's
parameters, path by path, in the same dtype. Paths and shapes are the same
in both packages (the stacked `blocks/...` leaves included), so the
conversion is a copy; bfloat16 arrays (numpy's ml_dtypes extension type)
are reinterpreted bit for bit.

Under a hybrid plan, model parallelism or FSDP each rank holds only its
shard of a sharded parameter (on a flat or a ("node", "local", "model")
mesh). `shard_params` cuts a full tree (numpy arrays or tensors) into
one rank's shards by the planner's specs; `gather_params` is its inverse
over the ranks of a mesh, collective on every rank. A spec's entry per
dimension names the mesh axis that dimension splits over, or a tuple of
axes (FSDP over ("node", "local")), cut node-major: rank (n, l) holds
part n * local + l, the part the reference's sharding places on that
device (None: not split); the leading dimension of the stacked
`blocks/...` leaves is never split, and an axis the mesh lacks has size
1.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import tree as tree_lib
from repro_torch.core.planner import mesh_shape
from repro_torch.launch import mesh as mesh_lib


def _to_torch(a: np.ndarray, device) -> torch.Tensor:
    a = np.ascontiguousarray(a)
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a.copy())
    return t.to(device)


def params_from_jax(tree_of_numpy, device=None) -> dict:
    """Reference param tree (numpy leaves) -> port param tree (tensors) on
    `device`: `cuda` unless the caller asks for the CPU."""
    dev = mesh_lib.resolve_device(device)
    return tree_lib.tree_map(lambda a: _to_torch(np.asarray(a), dev),
                             tree_of_numpy)


def shard_params(tree, specs, mesh, coord: dict | None = None):
    """This rank's shards of a full parameter tree.

    `specs` is the planner's spec tree (`Planner.tree_specs`) for `tree`;
    `mesh` a DeviceMesh or a name -> size dict; `coord` the rank's index
    along each axis (default: this process's on a DeviceMesh). Leaves may
    be numpy arrays or tensors; a shard is a copy, never a view of the full
    leaf."""
    sizes = mesh_shape(mesh)
    if coord is None:
        coord = {a: mesh.get_local_rank(a) for a in mesh.mesh_dim_names}

    def one(_, leaf, spec):
        index = []
        for d, a in enumerate(spec):
            n, k = 1, 0
            for ax in _axes(a):             # node-major
                n, k = n * sizes.get(ax, 1), k * sizes.get(ax, 1) + (
                    coord[ax] if sizes.get(ax, 1) > 1 else 0)
            if leaf.shape[d] % n:
                raise ValueError(f"dimension {d} of {tuple(leaf.shape)} does "
                                 f"not split over {n} ranks")
            m = leaf.shape[d] // n
            index.append(slice(k * m, (k + 1) * m))
        part = leaf[tuple(index)]
        if isinstance(part, torch.Tensor):
            return part.clone(memory_format=torch.contiguous_format)
        return np.array(part)

    return tree_lib.map_with_path(one, tree, specs)


def gather_params(tree, specs, mesh):
    """Full tensors from every rank's shards: the inverse of `shard_params`,
    an all-gather over each split dimension's process group (collective:
    every rank of the mesh calls it, and every rank gets the full tree)."""
    sizes = mesh_shape(mesh)

    def one(_, leaf, spec):
        for d, a in enumerate(spec):
            for ax in reversed(_axes(a)):   # the innermost axis first
                if sizes.get(ax, 1) == 1:
                    continue
                parts = [torch.empty_like(leaf) for _ in range(sizes[ax])]
                dist.all_gather(parts, leaf.contiguous(),
                                group=mesh.get_group(ax))
                leaf = torch.cat(parts, dim=d)
        return leaf

    return tree_lib.map_with_path(one, tree, specs)


def _axes(entry) -> tuple:
    """The mesh axes of one spec entry: none, one name or a tuple."""
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)
