"""Checkpointing in the reference's on-disk format.

Ports `repro/checkpoint/ckpt.py`: a directory holds `payload.npz` (one
array per leaf, keyed by its `/`-joined tree path; bf16 stored as its
uint16 bit pattern) and `manifest.json` (the paths, the step and the list
of bf16 keys). Every leaf is stored whole, so a checkpoint written by
either package, at any world size, restores in the other. A tensor-parallel
run saves the full tensors gathered over its ranks
(`convert.gather_params`), and `restore(specs=, mesh=)` cuts them into the
rank's shards again, as the reference's `restore(shardings=)` places them.
"""

from __future__ import annotations

import json
import os
from typing import Any

import numpy as np
import torch

from repro_torch import convert
from repro_torch import tree as tree_lib


def _key(path: tuple) -> str:
    return "/".join(str(k) for k in path)


def save(directory: str, tree: Any, *, step: int | None = None) -> str:
    """Write `tree` (nested dicts of tensors) under `directory`."""
    os.makedirs(directory, exist_ok=True)
    payload = {}
    manifest = {"paths": [], "step": step}
    for path, leaf in tree_lib.leaves_with_paths(tree):
        key = _key(path)
        manifest["paths"].append(key)
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            payload[key] = t.view(torch.int16).numpy().view(np.uint16)
            manifest.setdefault("bf16", []).append(key)
        else:
            payload[key] = t.numpy()
    np.savez(os.path.join(directory, "payload.npz"), **payload)
    with open(os.path.join(directory, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    return directory


def restore(directory: str, like: Any, *,
            device: torch.device | str | None = None, specs: Any = None,
            mesh: Any = None) -> Any:
    """Restore into the structure of `like` (nested dicts of tensors with
    the full shapes; meta tensors will do). Each leaf keeps its stored dtype
    and goes to `device`, by default to the device of its `like` leaf. With
    `specs` (the planner's spec tree) and `mesh` (a DeviceMesh), each leaf
    comes back as this rank's shard (`convert.shard_params`)."""
    with open(os.path.join(directory, "manifest.json")) as f:
        manifest = json.load(f)
    bf16 = set(manifest.get("bf16", []))
    out = []
    pl = tree_lib.leaves_with_paths(like)
    with np.load(os.path.join(directory, "payload.npz")) as payload:
        for path, leaf in pl:
            key = _key(path)
            if key not in payload:
                raise KeyError(f"{directory}: no leaf {key!r}")
            arr = payload[key]
            if tuple(arr.shape) != tuple(leaf.shape):
                raise ValueError(f"{directory}: {key!r} has shape "
                                 f"{arr.shape}, expected {tuple(leaf.shape)}")
            t = torch.from_numpy(arr.copy())
            if key in bf16:
                t = t.view(torch.bfloat16)
            dev = torch.device(device) if device is not None else leaf.device
            if dev.type == "meta":
                raise ValueError("restore onto meta tensors needs device=")
            out.append(t.to(dev))
    tree = tree_lib.unflatten([p for p, _ in pl], out)
    if specs is not None:
        tree = convert.shard_params(tree, specs, mesh)
    return tree


def latest_step(directory: str) -> int | None:
    """The step stored in `directory`'s manifest (None without one)."""
    try:
        with open(os.path.join(directory, "manifest.json")) as f:
            return json.load(f).get("step")
    except FileNotFoundError:
        return None
