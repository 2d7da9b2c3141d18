"""Training step factory: forward/backward + communication + optimizer.

Ports `repro/train/trainer.py`'s two communication modes. Each rank computes
the gradients of its own slice of the global batch (its index over the data
axes, row-major), then:

  * ``gspmd``  -- the baseline: the microbatch gradients are accumulated in
    f32 and cast to the parameter dtype, and each leaf is all-reduced (mean
    over the data axes) on its own, in priority order. (The reference lets
    the partitioner insert these reductions.)

  * ``mlsl``   -- the paper's data path: the gradients are fused into
    priority buckets and reduced explicitly through the CommEngine, which
    owns bucket planning, flat-vs-two-level routing, wire precision (fp32 /
    bf16 / int8 with optional error feedback) and the order of the calls.

Gradient accumulation (``accum_steps > 1``) reduces each microbatch's
buckets as they are produced (DDP-style) and accumulates the *reduced*
gradients in the engine's bucket layout, so on the int8 wire the add rides
the gather-side dequantize. ``overlap=True`` runs the reference's
software-pipelined order (microbatch k-1's buckets are reduced after
microbatch k's backward) with blocking calls; both orders perform the same
operations on the same values, so they are bit-identical. With
``accum_steps == 1`` the step reduces once after the backward.

Hybrid (data x model) execution (`planner.hybrid`, mlsl only): the ranks of
one tp group see the same rows (the batch splits over the data axes only);
parameters and optimizer state are each rank's local shards
(`convert.shard_params` by the planner's specs); model-sharded layers
exchange activations through the f/g collectives over the tp group; the
engine reduces sharded buckets over the data axes and replicated ones over
data axes + tp axis; the clip adds the sharded leaves' sum of squares over
the tp group. LARS and LAMB take per-leaf norms of the local shards there,
which differ from the dense norms; the reference's do too, and the two
agree (tests/test_torch_hybrid.py).

FSDP is not ported; asking for it raises.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch
import torch.distributed as dist

from repro_torch import tree as tree_lib
from repro_torch.core import collectives as cl
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


def param_specs(model: Model, planner: Planner):
    """The planner's spec tree for the model's parameters."""
    return planner.tree_specs(model.param_defs(),
                              stacked_paths=Model.stacked_path)


def make_comm_engine(model: Model, mesh, planner: Planner,
                     comm: CommConfig, *, device=None) -> CommEngine:
    """The model's CommEngine: bucket plan from its parameter structure and
    sharding groups. Only buckets of fully replicated leaves may fuse,
    except under a hybrid plan, where the engine plans on each rank's local
    shards and every bucket fuses."""
    specs = param_specs(model, planner)
    spec_by_path = dict(tree_lib.leaves_with_paths(specs))

    def group_key(path):
        return spec_by_path.get(path, ())

    def leaf_replicated(path):
        return all(a is None for a in spec_by_path.get(path, ()))

    grad_struct = _grad_struct(model)
    hybrid = planner.hybrid
    if hybrid is None:
        return CommEngine.create(grad_struct, comm, mesh, planner.batch_axes,
                                 device=device,
                                 layer_index=scheduler.default_layer_index,
                                 group_key=group_key,
                                 leaf_replicated=leaf_replicated)

    # model-sharded leaves shrink to their local 1/tp shard
    def shard_struct(path, leaf):
        shape = [n // hybrid.tp if ax == hybrid.tp_axis else n
                 for n, ax in zip(leaf.shape, spec_by_path.get(path, ()))]
        return torch.empty(shape, dtype=leaf.dtype, device="meta")

    return CommEngine.create(tree_lib.map_with_path(shard_struct, grad_struct),
                             comm, mesh, hybrid.data_axes, device=device,
                             layer_index=scheduler.default_layer_index,
                             group_key=group_key,
                             leaf_replicated=leaf_replicated,
                             tp_axis=hybrid.tp_axis,
                             leaf_sharded=lambda p: not leaf_replicated(p))


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
    data axes. `device` (default: the mesh's) is where the state lives.
    Under a hybrid planner the state holds this rank's local shards."""
    if comm.mode not in ("gspmd", "mlsl"):
        raise ValueError(f"unknown comm mode {comm.mode!r}")
    hybrid = planner.hybrid
    if hybrid is not None and comm.mode != "mlsl":
        raise ValueError("hybrid execution (planner.hybrid) needs comm mode "
                         "'mlsl': the activation f/g collectives and the "
                         "split gradient reduction run inside the explicit "
                         "data path")
    if comm.overlap and comm.mode != "mlsl":
        raise ValueError("CommConfig(overlap=True) needs the explicit mlsl "
                         "data path; gspmd reduces each leaf after the "
                         "backward and cannot be pipelined")
    if device is None:
        device = torch.device(mesh.device_type)
    data_axes = planner.batch_axes
    groups = [mesh.get_group(a) for a in data_axes]
    dp = math.prod(mesh_shape(mesh)[a] for a in data_axes)
    rank = _data_rank(mesh, data_axes)
    engine = None
    if comm.mode == "mlsl":
        if planner.fsdp:
            raise ValueError("comm=mlsl needs replicated (non-FSDP) "
                             "parameters over the batch axes")
        engine = make_comm_engine(model, mesh, planner, comm, device=device)
    # under a hybrid plan the engine hands out the tp axis's communicator;
    # blocks detect model-sharded weights by their shard shapes and place
    # the f/g activation collectives over its group; DP-fallback layers
    # see full-size (replicated) weights and ignore it
    tp = None if engine is None else engine.tp
    tp_group = None if tp is None else tp.group

    def value_and_grad(params, batch: Batch):
        leaves = tree_lib.leaves(params)
        with torch.enable_grad():
            for p in leaves:
                p.requires_grad_(True)
            loss = model.loss(params, batch, tp_axis=tp_group)
            grads = torch.autograd.grad(loss, leaves)
            for p in leaves:
                p.requires_grad_(False)
        return loss.detach(), tree_lib.unflatten(tree_lib.paths(params),
                                                 list(grads))

    def _to_f32(tree):
        return tree_lib.tree_map(lambda x: x.to(torch.float32), tree)

    def grads_fn(params, batch: Batch):
        """(loss, unreduced grads) over comm.accum_steps microbatches: the
        sum in f32, divided by the count and cast to the parameter dtype."""
        n = comm.accum_steps
        if n <= 1:
            return value_and_grad(params, batch)
        lsum = gsum = None
        for k in range(n):
            loss, g = value_and_grad(params, _rows(batch, k, n))
            lsum = loss if lsum is None else lsum + loss
            gsum = (_to_f32(g) if gsum is None else tree_lib.tree_map(
                lambda a, b: a + b.to(torch.float32), gsum, g))
        return lsum / n, tree_lib.tree_map(
            lambda g, p: (g / n).to(p.dtype), gsum, params)

    if hybrid is None:
        clip_grads = opt_lib.clip_by_global_norm
    else:
        sharded_flags = [any(ax == hybrid.tp_axis for ax in spec)
                         for spec in tree_lib.leaves(param_specs(model,
                                                                 planner))]

        def clip_grads(grads, max_norm):
            """clip_by_global_norm with the model-sharded leaves' sum of
            squares all-reduced over the tp group (each rank holds a
            distinct shard; replicated leaves are counted once). The norm
            comes out the same on every rank of the group, so replicated
            parameters keep taking identical updates."""
            z = torch.zeros((), dtype=torch.float32, device=device)
            sq = [(torch.sum(g.to(torch.float32) ** 2), sh) for g, sh
                  in zip(tree_lib.leaves(grads), sharded_flags)]
            sq_sh = sum((v for v, sh in sq if sh), z)
            sq_rep = sum((v for v, sh in sq if not sh), z)
            gn = torch.sqrt(sq_rep + cl.allreduce(sq_sh, [tp.group]))
            return opt_lib.clip_by_global_norm(grads, max_norm,
                                               global_norm=gn)

    def finish(state: TrainState, loss, grads, residuals):
        """Clip, pmean the loss over the data axes, update."""
        grads, gnorm = clip_grads(grads, grad_clip)
        loss = loss.clone()
        for g in groups:
            dist.all_reduce(loss, op=dist.ReduceOp.SUM, group=g)
        loss = loss / dp
        params, opt_state = optimizer.update(grads, state.opt_state,
                                             state.params, state.step)
        new = TrainState(params=params, opt_state=opt_state,
                         step=state.step + 1, comm_residuals=residuals)
        return new, {"loss": loss, "grad_norm": gnorm}

    if comm.mode == "gspmd":
        plan = scheduler.plan_buckets(_grad_struct(model),
                                      scheduler.default_layer_index,
                                      bucket_bytes=comm.bucket_bytes)

        def reduce_leaf(g, _bucket):
            return cl.allreduce(g, groups, mean=True)

        def gspmd_step(state: TrainState, batch: Batch):
            loss, grads = grads_fn(state.params, _rows(batch, rank, dp))
            # leaf by leaf (fuse=False), as the reference's partitioner-
            # inserted reductions are
            grads = scheduler.reduce_with_priority(
                grads, reduce_leaf, plan, prioritize=comm.prioritize,
                fuse=False)
            return finish(state, loss, grads, state.comm_residuals)
        return gspmd_step

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
        return finish(state, loss, grads, residuals)

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
