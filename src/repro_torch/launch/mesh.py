"""Device, process-group and mesh construction.

Ports `repro/launch/mesh.py`. A mesh is a `torch.distributed` DeviceMesh;
each dimension's process group is what the collectives run over. Meshes:
("data", "model") for flat data parallelism (`make_host_mesh`) and
("node", "local") for the two-level collectives (`make_hier_mesh`), or
("node", "local", "model") when the two-level mesh also has a model axis;
the production meshes of the dry-run (`make_production_mesh`): ("data",
"model") = (16, 16), or ("pod", "data", "model") = (2, 16, 16), the
reference's shapes and axis names.

A process runs one rank. Under torchrun (`RANK`, `WORLD_SIZE` and
`LOCAL_RANK` set) the default process group starts from that environment
and each rank takes `cuda:LOCAL_RANK` on the card; otherwise one process is
a world of one. A mesh whose size differs from the world size raises: it is
never shrunk to fit. Nothing here is done at import time.
"""

from __future__ import annotations

import math
import os
import tempfile

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

_TORCHRUN_ENV = ("RANK", "WORLD_SIZE", "LOCAL_RANK")


def _under_torchrun() -> bool:
    return all(k in os.environ for k in _TORCHRUN_ENV)


def resolve_device(device: torch.device | str | None = None) -> torch.device:
    """The device an entry point runs on: `cuda` unless the caller asks for
    the CPU; under torchrun `cuda` means `cuda:LOCAL_RANK`. Raises when CUDA
    is asked for (or defaulted to) and absent, rather than carrying on on
    the CPU."""
    dev = torch.device(device if device is not None else "cuda")
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available; pass device='cpu' (or --device cpu) "
                "to run on the CPU")
        if dev.index is None:
            index = (int(os.environ["LOCAL_RANK"]) if _under_torchrun()
                     else torch.cuda.current_device())
            dev = torch.device("cuda", index)
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
    _start(dev, store=store, rank=rank, world_size=world_size)


def _start(dev: torch.device, **kw) -> None:
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
        dist.init_process_group("nccl", device_id=dev, **kw)
    else:
        dist.init_process_group("gloo", **kw)


def _ensure_world(dev: torch.device, size: int) -> None:
    """Start the default process group if none is up (from torchrun's
    environment, else a world of one) and check that it has `size` ranks."""
    if not dist.is_initialized():
        if _under_torchrun():
            _start(dev, rank=int(os.environ["RANK"]),
                   world_size=int(os.environ["WORLD_SIZE"]))
        else:
            init_process_group(dev, world_size=1)
    if dist.get_world_size() != size:
        raise RuntimeError(
            f"the mesh needs {size} ranks but the world has "
            f"{dist.get_world_size()}; start one process per rank (torchrun "
            f"--nproc-per-node {size}) or ask for a mesh of "
            f"{dist.get_world_size()}")


def make_host_mesh(data: int = 1, model: int = 1,
                   device: torch.device | str | None = None) -> DeviceMesh:
    """("data", "model") DeviceMesh over data * model ranks."""
    dev = resolve_device(device)
    _ensure_world(dev, data * model)
    return init_device_mesh(dev.type, (data, model),
                            mesh_dim_names=("data", "model"))


def make_hier_mesh(node: int = 2, local: int = 4, model: int = 1,
                   device: torch.device | str | None = None) -> DeviceMesh:
    """Factored data-parallel mesh for the two-level collectives: "node" is
    the inter-node (fabric) dimension, "local" the intra-node one; rank r
    sits at (r // local, r % local), the order of the reference's
    make_hier_mesh. `model` > 1 adds a trailing "model" axis: rank r sits
    at (r // (local * model), r // model % local, r % model)."""
    dev = resolve_device(device)
    shape, names = (node, local), ("node", "local")
    if model > 1:
        shape, names = (node, local, model), ("node", "local", "model")
    _ensure_world(dev, math.prod(shape))
    return init_device_mesh(dev.type, shape, mesh_dim_names=names)


def make_production_mesh(*, multi_pod: bool = False,
                         device: torch.device | str | None = None
                         ) -> DeviceMesh:
    """The reference's production mesh: ("data", "model") = (16, 16), 256
    ranks, or with `multi_pod` ("pod", "data", "model") = (2, 16, 16), 512,
    the "pod" axis an outer data-parallel axis. In the paper's vocabulary the
    model axis is the node group of hybrid parallelism. The world must have
    that many ranks: `launch/dryrun.py` starts a fake process group of that
    size in its own process (no collective moves data there)."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    names = ("pod", "data", "model") if multi_pod else ("data", "model")
    dev = resolve_device(device)
    _ensure_world(dev, math.prod(shape))
    return init_device_mesh(dev.type, shape, mesh_dim_names=names)


def n_chips(mesh: DeviceMesh) -> int:
    """The number of ranks (cards) of a mesh."""
    return math.prod(tuple(mesh.shape))
