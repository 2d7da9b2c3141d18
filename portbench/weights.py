"""The cells' weights, made on the device from the seed: one generator on
the device, one draw per leaf in sorted-path order, each a standard normal
in float32 scaled and cast to the dtype the leaf is stored in (or ones, or
zeros, as its spec says). The program and the reference are handed the
same values."""

from __future__ import annotations

import torch

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def draw(layout: dict, seed: int, device):
    """Yields (path, tensor) for every leaf of `layout` ({path: spec}), in
    sorted-path order."""
    gen = torch.Generator(device=device).manual_seed(int(seed) % 2 ** 63)
    for path in sorted(layout):
        sp = layout[path]
        dtype = DTYPES[sp["dtype"]]
        if sp["init"] == "ones":
            t = torch.ones(sp["shape"], dtype=dtype, device=device)
        elif sp["init"] == "zeros":
            t = torch.zeros(sp["shape"], dtype=dtype, device=device)
        else:
            t = torch.randn(sp["shape"], generator=gen, dtype=torch.float32,
                            device=device).mul_(sp["scale"]).to(dtype)
        yield path, t


def nested(flat: dict) -> dict:
    """{path: leaf} -> the nested dict of the program's parameter tree."""
    root: dict = {}
    for path, leaf in flat.items():
        node = root
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = leaf
    return root
