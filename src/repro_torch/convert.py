"""Carry the JAX reference's parameters across to the port.

`params_from_jax(tree)` takes the reference's parameter tree as numpy
arrays (`jax.tree_util.tree_map(np.asarray, params)`) and returns the port's
parameters, path by path, in the same dtype. Paths and shapes are the same
in both packages (the stacked `blocks/...` leaves included), so the
conversion is a copy; bfloat16 arrays (numpy's ml_dtypes extension type)
are reinterpreted bit for bit.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch import tree as tree_lib
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
