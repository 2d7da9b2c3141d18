"""Device, process-group and mesh construction.

Ports `repro/launch/mesh.py` for the flat data-parallel slice. A mesh is a
`torch.distributed` DeviceMesh with dims ("data", "model"); each dim's
process group is what the collectives run over. Nothing here is done at
import time.
"""

from __future__ import annotations

import os
import tempfile

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh


def resolve_device(device: torch.device | str | None = None) -> torch.device:
    """The device an entry point runs on: `cuda` unless the caller asks for
    the CPU. Raises when CUDA is asked for (or defaulted to) and absent,
    rather than carrying on on the CPU."""
    dev = torch.device(device if device is not None else "cuda")
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available; pass device='cpu' (or --device cpu) "
                "to run on the CPU")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}")
    return dev


def init_process_group(device: torch.device | str, *, rank: int = 0,
                       world_size: int = 1,
                       store_dir: str | None = None) -> None:
    """Start the default process group, NCCL on `cuda` and gloo on `cpu`,
    rendezvousing through a FileStore (no ports). Every rank passes the same
    `store_dir`; a single process may leave it None (a fresh temp dir).
    Reuses a group that is already up if its world size matches."""
    dev = torch.device(device)
    if dist.is_initialized():
        if dist.get_world_size() != world_size:
            raise RuntimeError(
                f"a process group of world size {dist.get_world_size()} is "
                f"already up; asked for {world_size}")
        return
    if store_dir is None:
        store_dir = tempfile.mkdtemp(prefix="repro_torch_pg_")
    store = dist.FileStore(os.path.join(store_dir, "store"), world_size)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
        dist.init_process_group("nccl", store=store, rank=rank,
                                world_size=world_size, device_id=dev)
    else:
        dist.init_process_group("gloo", store=store, rank=rank,
                                world_size=world_size)


def make_host_mesh(data: int = 1, model: int = 1,
                   device: torch.device | str | None = None) -> DeviceMesh:
    """("data", "model") DeviceMesh over data * model ranks. Starts a
    world-size-1 process group when none is up (one process, one device)."""
    dev = resolve_device(device)
    if not dist.is_initialized():
        init_process_group(dev, world_size=data * model)
    return init_device_mesh(dev.type, (data, model),
                            mesh_dim_names=("data", "model"))
