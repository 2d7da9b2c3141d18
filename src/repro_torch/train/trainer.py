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

Plain model parallelism (`Planner(mesh)` with a model axis of more than one
rank, gspmd or mlsl): the reference's planner puts the model axis on every
matrix and its partitioner inserts the collectives; here they are
explicit. The ranks of one model group see the same rows; parameters and
optimizer state are each rank's shards (`convert.shard_params` of the full
tree), laid out by `Model.mp_layout`; the embedding, the blocks (whole
heads per rank, or the gathered-head attention when a shard splits a
head), the head and the vocab-parallel cross-entropy exchange activations
over the model group. gspmd all-reduces each leaf's local shard over the
data axes; mlsl keeps the reference's bucket plan on the global shapes
(only the replicated leaves fuse) and reduces each rank's shards over the
data axes. The clip adds the sharded leaves' sum of squares over the
model group, and LARS and LAMB take norms of the whole tensors (the step
passes `norm_groups` to the optimizer's update), as the reference's
automatic model axis does.

FSDP (`Planner(fsdp=True)`, gspmd only, as in the reference): parameters
and optimizer state are each rank's shards over the batch axes
(`convert.shard_params`, from `make_train_state`/`train_state_from_params`
with the planner); the model gathers each repeat's weights just in time
(`collectives.fsdp_gather`, inside the repeat's checkpoint), and their
gradients come back reduce-scattered, summed over the data ranks, which the
step divides by the data-parallel size. Replicated leaves keep the per-leaf
all-reduce in priority order. The clip and LARS/LAMB's norms add the
split leaves' sums of squares over their groups. FSDP composes with a
model axis (both splits on one leaf); mlsl (and so hybrid) refuses it.

MoE models train on the gather dispatch (`models.moe.moe_apply`), as the
reference's CLIs do (under model parallelism a rank runs its experts, or
its ff slice of every expert), or with `CommConfig(moe_impl="ep")` on the
expert-parallel one (`models.moe.moe_apply_ep`) over the model group
(its experts split over it), which under FSDP gathers the expert weights
itself (int8 with `wgather_wire="int8"`); their loss carries the routers'
load-balance term. Model parallelism and hybrid plans run every family of
the registry; under a hybrid plan only the "attn" and "local" layers whose
heads divide run tensor-parallel (`planner.TP_KINDS`), the others on
data parallelism with whole weights.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch
import torch.distributed as dist

from repro_torch import convert
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
                     generator: torch.Generator, device, *,
                     planner: Planner | None = None) -> TrainState:
    """Fresh state with random parameters drawn from `generator` (the full
    tensors, then with `planner` this rank's shards)."""
    return train_state_from_params(model.init(generator, device), optimizer,
                                   model=model, planner=planner)


def train_state_from_params(params, optimizer: opt_lib.Optimizer, *,
                            model: Model | None = None,
                            planner: Planner | None = None) -> TrainState:
    """State around existing parameters (e.g. converted from the
    reference). With `planner` (and `model`) the full parameters are cut
    into this rank's shards where its step holds shards (`sharded_state`),
    and the optimizer state is made for the shards."""
    if planner is not None and sharded_state(planner):
        params = convert.shard_params(params, param_specs(model, planner),
                                      planner.mesh)
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


def model_parallel(planner: Planner) -> bool:
    """Does `planner` split parameters over a model axis of more than one
    rank outside a hybrid plan (the reference's `Planner(mesh)` with its
    model axis on every matrix)?"""
    return planner.hybrid is None and planner.model_size > 1


def sharded_state(planner: Planner) -> bool:
    """Does the step under `planner` hold shards of the parameters (FSDP,
    a hybrid plan or model parallelism)?"""
    return planner.fsdp or planner.hybrid is not None or model_parallel(
        planner)


def fsdp_splits(model: Model, planner: Planner, mesh):
    """The model's FSDP tree for `Model.loss(fsdp=)`: per leaf, (its split
    dimension from the end, the process groups of its batch axes), or
    None where the planner leaves it whole over the batch axes."""
    dims = planner.fsdp_dims(model.param_defs(),
                             stacked_paths=Model.stacked_path)
    return tree_lib.tree_map(
        lambda s: None if s is None else (s[0], [mesh.get_group(a)
                                                 for a in s[1]]), dims)


def norm_groups(model: Model, planner: Planner, mesh, *,
                mp: bool | None = None) -> list:
    """Per parameter leaf, in tree order, the process groups over which its
    shards' sums of squares add up to the whole tensor's: its FSDP axes'
    groups, and the model group where model parallelism (`mp`, default
    `model_parallel(planner)`) splits it too. What the step's clip sums
    over and the optimizer's update takes as `norm_groups`."""
    if mp is None:
        mp = model_parallel(planner)
    model_split = (sharded_flags(model, planner, planner.model_axis)
                   if mp else None)
    out = []
    for i, s in enumerate(tree_lib.leaves(fsdp_splits(model, planner,
                                                      mesh))):
        groups = [] if s is None else list(s[1])
        if model_split is not None and model_split[i]:
            groups.append(mesh.get_group(planner.model_axis))
        out.append(groups)
    return out


def _local_struct(grad_struct, specs, axis: str, size: int):
    """`grad_struct` with each leaf split `size` ways along its `axis`
    dimension: what one rank holds."""
    def one(_, leaf, spec):
        shape = [n // size if ax == axis else n
                 for n, ax in zip(leaf.shape, spec)]
        return torch.empty(shape, dtype=leaf.dtype, device="meta")
    return tree_lib.map_with_path(one, grad_struct, specs)


def make_comm_engine(model: Model, mesh, planner: Planner,
                     comm: CommConfig, *, device=None) -> CommEngine:
    """The model's CommEngine: bucket plan from its parameter structure and
    sharding groups. Only buckets of fully replicated leaves may fuse,
    except under a hybrid plan, where the engine plans on each rank's local
    shards and every bucket fuses. Under model parallelism
    (`model_parallel(planner)`) the plan is the reference's, on the global
    shapes, and each rank reduces its local shards of the leafwise buckets
    over the data axes."""
    specs = param_specs(model, planner)
    spec_by_path = dict(tree_lib.leaves_with_paths(specs))

    def group_key(path):
        return spec_by_path.get(path, ())

    def leaf_replicated(path):
        return all(a is None for a in spec_by_path.get(path, ()))

    grad_struct = _grad_struct(model)
    hybrid = planner.hybrid
    if hybrid is None:
        local = None
        if model_parallel(planner):
            local = _local_struct(grad_struct, specs, planner.model_axis,
                                  planner.model_size)
        return CommEngine.create(grad_struct, comm, mesh, planner.batch_axes,
                                 device=device,
                                 layer_index=scheduler.default_layer_index,
                                 group_key=group_key,
                                 leaf_replicated=leaf_replicated,
                                 local_struct=local)

    # model-sharded leaves shrink to their local 1/tp shard
    return CommEngine.create(_local_struct(grad_struct, specs, hybrid.tp_axis,
                                           hybrid.tp),
                             comm, mesh, hybrid.data_axes, device=device,
                             layer_index=scheduler.default_layer_index,
                             group_key=group_key,
                             leaf_replicated=leaf_replicated,
                             tp_axis=hybrid.tp_axis,
                             leaf_sharded=lambda p: not leaf_replicated(p))


def sharded_flags(model: Model, planner: Planner, axis: str) -> list:
    """Per parameter leaf, in tree order: is it split over `axis`?"""
    return [axis in spec for spec in tree_lib.leaves(param_specs(model,
                                                                 planner))]


def data_rank(mesh, data_axes) -> int:
    """This rank's index over the data axes (row-major, as the reference's
    batch PartitionSpec over the same axes)."""
    shape = mesh_shape(mesh)
    idx = 0
    for a in data_axes:
        idx = idx * shape[a] + mesh.get_local_rank(a)
    return idx


def make_train_step(model: Model, optimizer: opt_lib.Optimizer, mesh,
                    planner: Planner, comm: CommConfig, *,
                    grad_clip: float = 1.0, device=None,
                    force_model_parallel: bool = False):
    """Returns train_step(state, batch) -> (state, metrics).

    `batch` is the global batch; each rank trains on its slice over the
    data axes. `device` (default: the mesh's) is where the state lives.
    Under a hybrid planner or model parallelism the state holds this
    rank's local shards. `force_model_parallel` runs the model-parallel
    step over the planner's model axis even when it has one rank (its
    collectives then run over a group of one)."""
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
    mp = force_model_parallel or model_parallel(planner)
    if mp and hybrid is not None:
        raise ValueError("a hybrid plan has its own model-parallel layers; "
                         "force_model_parallel does not apply")
    if planner.fsdp and comm.mode == "mlsl":
        raise ValueError("comm=mlsl manages gradient communication "
                         "explicitly and requires replicated (non-FSDP) "
                         "parameters over the batch axes; use gspmd for "
                         "ZeRO-sharded giants")
    if device is None:
        device = torch.device(mesh.device_type)
    data_axes = planner.batch_axes
    groups = [mesh.get_group(a) for a in data_axes]
    dp = math.prod(mesh_shape(mesh)[a] for a in data_axes)
    rank = data_rank(mesh, data_axes)
    fsdp = fsdp_splits(model, planner, mesh) if planner.fsdp else None
    moe = moe_options(comm, planner, mesh, groups)
    engine = None
    if comm.mode == "mlsl":
        engine = make_comm_engine(model, mesh, planner, comm, device=device)
    # under a hybrid plan the engine hands out the tp axis's communicator;
    # blocks detect model-sharded weights by their shard shapes and place
    # the f/g activation collectives over its group; DP-fallback layers
    # see full-size (replicated) weights and ignore it
    tp = None if engine is None else engine.tp
    tp_group = None if tp is None else tp.group
    # model parallelism: every block, the embedding and the head place
    # their collectives over the model group by the planner's layout
    layout = None
    if mp:
        tp_group = mesh.get_group(planner.model_axis)
        layout = model.mp_layout(planner)

    def value_and_grad(params, batch: Batch):
        leaves = tree_lib.leaves(params)
        with torch.enable_grad():
            for p in leaves:
                p.requires_grad_(True)
            loss = model.loss(params, batch, tp_axis=tp_group, layout=layout,
                              kv_chunk=comm.kv_chunk or None, fsdp=fsdp,
                              moe=moe)
            grads = torch.autograd.grad(loss, leaves)
            for p in leaves:
                p.requires_grad_(False)
        return loss.detach(), tree_lib.unflatten(tree_lib.paths(params),
                                                 list(grads))

    def _to_f32(tree):
        return tree_lib.tree_map(lambda x: x.to(torch.float32), tree)

    def grads_fn(params, batch: Batch):
        """(loss, unreduced grads) of this rank's rows of the global
        `batch` over comm.accum_steps microbatches, each a slice of the
        global batch as in the reference (a moe layer routes it whole): the
        sum in f32, divided by the count and cast to the parameter dtype."""
        n = comm.accum_steps
        if n <= 1:
            return value_and_grad(params, _rows(batch, rank, dp))
        lsum = gsum = None
        for k in range(n):
            loss, g = value_and_grad(params,
                                     _rows(_rows(batch, k, n), rank, dp))
            lsum = loss if lsum is None else lsum + loss
            gsum = (_to_f32(g) if gsum is None else tree_lib.tree_map(
                lambda a, b: a + b.to(torch.float32), gsum, g))
        return lsum / n, tree_lib.tree_map(
            lambda g, p: (g / n).to(p.dtype), gsum, params)

    if hybrid is not None:
        # the clip adds the tp-sharded leaves' squares over the tp group;
        # LARS and LAMB take the local shards' norms, as the reference's
        clip_groups = [[tp_group] if f else [] for f in
                       sharded_flags(model, planner, hybrid.tp_axis)]
        opt_groups = None
    else:
        clip_groups = opt_groups = norm_groups(model, planner, mesh, mp=mp)
    clip_grads = _clip_over(clip_groups)

    def finish(state: TrainState, loss, grads, residuals):
        """Clip, pmean the loss over the data axes, update."""
        grads, gnorm = clip_grads(grads, grad_clip)
        loss = loss.clone()
        for g in groups:
            dist.all_reduce(loss, op=dist.ReduceOp.SUM, group=g)
        loss = loss / dp
        params, opt_state = optimizer.update(grads, state.opt_state,
                                             state.params, state.step,
                                             norm_groups=opt_groups)
        new = TrainState(params=params, opt_state=opt_state,
                         step=state.step + 1, comm_residuals=residuals)
        return new, {"loss": loss, "grad_norm": gnorm}

    if comm.mode == "gspmd":
        plan = scheduler.plan_buckets(_grad_struct(model),
                                      scheduler.default_layer_index,
                                      bucket_bytes=comm.bucket_bytes)

        # each leaf summed over the batch axes it is not split over (FSDP's
        # split leaves arrive reduce-scattered over theirs), then the mean;
        # leaf by leaf in priority order, as the reference's partitioner-
        # inserted reductions are
        sum_over = [[mesh.get_group(a) for a in data_axes
                     if s is None or a not in s[1]]
                    for s in tree_lib.leaves(planner.fsdp_dims(
                        model.param_defs(), stacked_paths=Model.stacked_path))]

        def reduce_grads(grads):
            leaves = tree_lib.leaves(grads)
            out = list(leaves)
            for bucket in plan.buckets:
                for lid in bucket.leaf_ids:
                    g = leaves[lid]
                    if sum_over[lid]:
                        g = cl._psum(g, sum_over[lid])
                    out[lid] = cl._div(g, dp)
            return tree_lib.unflatten(list(plan.paths), out)

        def gspmd_step(state: TrainState, batch: Batch):
            loss, grads = grads_fn(state.params, batch)
            grads = reduce_grads(grads)
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


def _clip_over(leaf_groups: list):
    """`clip_by_global_norm` whose norm is the whole tensors': each split
    leaf's sum of squares all-reduced over its groups (one call per set of
    groups), then all summed in tree order, so a replicated leaf counts
    once and the norm is the same on every rank. The plain clip where no
    leaf is split."""
    by_groups: dict = {}
    for i, gs in enumerate(leaf_groups):
        if gs:
            by_groups.setdefault(tuple(gs), []).append(i)
    if not by_groups:
        return opt_lib.clip_by_global_norm

    def clip_grads(grads, max_norm):
        sq = [torch.sum(g.to(torch.float32) ** 2)
              for g in tree_lib.leaves(grads)]
        for gs, ids in by_groups.items():
            total = cl.allreduce(torch.stack([sq[i] for i in ids]), list(gs))
            for i, v in zip(ids, total.unbind(0)):
                sq[i] = v
        return opt_lib.clip_by_global_norm(grads, max_norm,
                                           global_norm=torch.sqrt(sum(sq)))
    return clip_grads


def moe_options(comm: CommConfig, planner: Planner, mesh, groups):
    """The moe blocks' dispatch options for `Model.loss(moe=)`. On the
    gather dispatch the gspmd step routes the whole batch over the data
    ranks (the reference's gspmd step routes the global batch), the mlsl
    step each rank's rows (as its shard_map does): None there."""
    if comm.moe_impl not in ("gather", "ep"):
        raise ValueError(f"unknown moe_impl {comm.moe_impl!r}")
    if comm.wgather_wire not in ("bf16", "int8"):
        raise ValueError(f"unknown wgather_wire {comm.wgather_wire!r}")
    if comm.moe_impl == "gather":
        return dict(batch_groups=tuple(groups)) if comm.mode == "gspmd" \
            else None
    if planner.dp_only or planner.model_axis not in mesh_shape(mesh):
        raise ValueError("moe_impl='ep' runs the experts over the mesh's "
                         f"{planner.model_axis!r} axis, which this planner "
                         "does not have")
    return dict(moe_impl="ep", model_group=mesh.get_group(planner.model_axis),
                batch_groups=tuple(groups), wgather_wire=comm.wgather_wire)


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
                 mask=one(batch.mask), img_embeds=one(batch.img_embeds),
                 frame_embeds=one(batch.frame_embeds))
