"""Training step factory, mlsl mode: forward/backward + MLSL communication +
optimizer.

Ports the `mlsl` mode of `repro/train/trainer.py`. Each rank computes the
gradients of its own slice of the global batch; the gradients are fused into
priority buckets and reduced explicitly through the CommEngine, which owns
bucket planning, wire precision (fp32 / bf16 / int8 with optional error
feedback) and the issue order.

Gradient accumulation (``accum_steps > 1``) reduces each microbatch's
buckets as they are produced (DDP-style) and accumulates the *reduced*
gradients in the engine's bucket layout, so on the int8 wire the add rides
the gather-side dequantize. ``overlap=True`` runs the reference's
software-pipelined order (microbatch k-1's buckets are reduced after
microbatch k's backward) with blocking calls; both orders perform the same
operations on the same values, so they are bit-identical. With
``accum_steps == 1`` the step reduces once after the backward.

The reference's `gspmd` mode, hybrid tensor parallelism and FSDP are not
ported; asking for them raises.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch
import torch.distributed as dist

from repro_torch import tree as tree_lib
from repro_torch.core import scheduler
from repro_torch.core.engine import CommConfig, CommEngine
from repro_torch.core.planner import Planner, mesh_shape
from repro_torch.models.transformer import Batch, Model
from repro_torch.optim import optimizers as opt_lib

__all__ = ["CommConfig", "TrainState", "make_train_state", "make_comm_engine",
           "make_train_step"]


@dataclasses.dataclass
class TrainState:
    params: Any
    opt_state: Any
    step: int
    comm_residuals: Any = None       # error-feedback residuals per bucket


def make_train_state(model: Model, optimizer: opt_lib.Optimizer,
                     generator: torch.Generator, device) -> TrainState:
    """Fresh state with random parameters drawn from `generator`."""
    return train_state_from_params(model.init(generator, device), optimizer)


def train_state_from_params(params, optimizer: opt_lib.Optimizer) -> TrainState:
    """State around existing parameters (e.g. converted from the reference)."""
    return TrainState(params=params, opt_state=optimizer.init(params), step=0)


def _grad_struct(model: Model):
    """f32 meta tensors with the gradients' shapes (nothing allocated)."""
    return tree_lib.tree_map(
        lambda pd: torch.empty(pd.shape, dtype=torch.float32, device="meta"),
        model.param_defs())


def make_comm_engine(model: Model, mesh, planner: Planner,
                     comm: CommConfig, *, device=None) -> CommEngine:
    """The model's CommEngine: bucket plan from its parameter structure and
    sharding groups. Only buckets of fully replicated leaves may fuse."""
    specs = planner.tree_specs(model.param_defs(),
                               stacked_paths=Model.stacked_path)
    spec_by_path = dict(tree_lib.leaves_with_paths(specs))

    def group_key(path):
        return spec_by_path.get(path, ())

    def leaf_replicated(path):
        return all(a is None for a in spec_by_path.get(path, ()))

    return CommEngine.create(_grad_struct(model), comm, mesh,
                             planner.batch_axes, device=device,
                             layer_index=scheduler.default_layer_index,
                             group_key=group_key,
                             leaf_replicated=leaf_replicated)


def _data_rank(mesh, data_axes) -> int:
    """This rank's index over the data axes (row-major, as the reference's
    batch PartitionSpec over the same axes)."""
    shape = mesh_shape(mesh)
    idx = 0
    for a in data_axes:
        idx = idx * shape[a] + mesh.get_local_rank(a)
    return idx


def make_train_step(model: Model, optimizer: opt_lib.Optimizer, mesh,
                    planner: Planner, comm: CommConfig, *,
                    grad_clip: float = 1.0, device=None):
    """Returns train_step(state, batch) -> (state, metrics).

    `batch` is the global batch; each rank trains on its slice over the
    data axes. `device` (default: the mesh's) is where the state lives."""
    if comm.mode != "mlsl":
        raise NotImplementedError(
            f"comm mode {comm.mode!r} is not yet ported to repro_torch "
            f"(only 'mlsl')")
    if planner.fsdp:
        raise ValueError("comm=mlsl needs replicated (non-FSDP) parameters "
                         "over the batch axes")
    if device is None:
        device = torch.device(mesh.device_type)
    data_axes = planner.batch_axes
    engine = make_comm_engine(model, mesh, planner, comm, device=device)
    groups = engine.groups
    dp = engine.plan.dp
    rank = _data_rank(mesh, data_axes)

    def value_and_grad(params, batch: Batch):
        leaves = tree_lib.leaves(params)
        with torch.enable_grad():
            for p in leaves:
                p.requires_grad_(True)
            loss = model.loss(params, batch)
            grads = torch.autograd.grad(loss, leaves)
            for p in leaves:
                p.requires_grad_(False)
        return loss.detach(), tree_lib.unflatten(tree_lib.paths(params),
                                                 list(grads))

    def _to_f32(tree):
        return tree_lib.tree_map(lambda x: x.to(torch.float32), tree)

    def accum_reduce(params, batch: Batch, residuals):
        """Per-microbatch exchange into the bucket-layout accumulator."""
        n = comm.accum_steps
        bacc = engine.init_accum(device)
        lsum = None
        pending = None
        for k in range(n):
            loss, g = value_and_grad(params, _rows(batch, k, n))
            g = _to_f32(g)
            lsum = loss if lsum is None else lsum + loss
            if comm.overlap:
                # software pipeline: microbatch k-1's buckets are reduced
                # after microbatch k's backward
                if pending is not None:
                    bacc, residuals = engine.reduce_accum_chained(
                        pending, bacc, residuals)
                pending = g
            else:
                bacc, residuals = engine.reduce_accum_chained(g, bacc,
                                                              residuals)
            del g
        if pending is not None:
            bacc, residuals = engine.reduce_accum_chained(pending, bacc,
                                                          residuals)
        gsum = engine.unfuse_accum(bacc)
        grads = tree_lib.tree_map(lambda g, p: (g / n).to(p.dtype), gsum,
                                  params)
        return lsum / n, grads, residuals

    def train_step(state: TrainState, batch: Batch):
        residuals = state.comm_residuals
        if engine.plan.use_ef and residuals is None:
            residuals = engine.init_residuals(device)
        local = _rows(batch, rank, dp)
        if comm.accum_steps > 1:
            loss, grads, residuals = accum_reduce(state.params, local,
                                                  residuals)
        else:
            loss, grads = value_and_grad(state.params, local)
            grads, residuals = engine.reduce(grads, residuals)
        grads, gnorm = opt_lib.clip_by_global_norm(grads, grad_clip)
        loss = loss.clone()
        for g in groups:                    # pmean over the data axes
            dist.all_reduce(loss, op=dist.ReduceOp.SUM, group=g)
        loss = loss / dp
        params, opt_state = optimizer.update(grads, state.opt_state,
                                             state.params, state.step)
        new = TrainState(params=params, opt_state=opt_state,
                         step=state.step + 1, comm_residuals=residuals)
        return new, {"loss": loss, "grad_norm": gnorm}

    return train_step


def _rows(batch: Batch, k: int, n: int) -> Batch:
    """The k-th of n equal row slices of a batch (this rank's share of the
    global batch, or one microbatch of it)."""
    def one(x):
        if x is None:
            return None
        if x.shape[0] % n:
            raise ValueError(f"a batch of {x.shape[0]} rows does not split "
                             f"into {n} equal parts")
        m = x.shape[0] // n
        return x[k * m:(k + 1) * m]
    return Batch(tokens=one(batch.tokens), labels=one(batch.labels),
                 mask=one(batch.mask))
