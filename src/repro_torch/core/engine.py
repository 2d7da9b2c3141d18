"""CommEngine: the unified bucket-reduction data path (paper §2, MLSL EP servers).

Ports the flat data-parallel half of `repro/core/engine.py`:

  * ``CommConfig``  -- the declarative knobs (mode, wire precision, bucket
    size, error feedback, overlap), shared by the trainer and the driver;
  * ``EnginePlan``  -- the static plan compiled from a gradient structure +
    CommConfig + mesh: bucket boundaries (scheduler.plan_buckets), which
    buckets may travel fused, each bucket's route, and the resolved int8
    kernel backend;
  * ``CommEngine``  -- executes the plan eagerly over `torch.distributed`.

The reference threads an `optimization_barrier` token through the buckets
so XLA issues them in priority order. Eagerly, the engine issues the
buckets in plan order, which is the priority order, and every collective of
the exchange is ordered on the stream; `prioritize` is recorded for the plan
but changes nothing here. Two-level (`hier`, `topo`) routing and hybrid
tensor parallelism (`tp_axis`) are later slices and raise.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

from repro_torch import tree as tree_lib
from repro_torch.core import collectives as cl
from repro_torch.core import planner as planner_lib
from repro_torch.core import scheduler
from repro_torch.kernels import ops as kops

_HIER_SLICE = ("two-level (hier/topo) collectives are not yet ported to "
               "repro_torch; they come with the hierarchical-collectives slice")


@dataclasses.dataclass(frozen=True)
class CommConfig:
    """Declarative communication configuration (consumed by CommEngine and
    the train-step factory)."""

    mode: str = "mlsl"               # mlsl (gspmd is not yet ported)
    wire: str = cl.WIRE_FP32
    prioritize: bool = True
    bucket_bytes: float = 25e6
    error_feedback: bool = False     # int8 wire only
    accum_steps: int = 1             # microbatch gradient accumulation
    hier: bool = False               # later slice
    topo: Optional[str] = None       # later slice (with hier)
    # accum_steps > 1: reduce microbatch k-1's buckets after microbatch k's
    # backward (the reference's software-pipelined order), with blocking
    # calls; False reduces each microbatch right after its own backward
    overlap: bool = False
    # int8 wire kernel dispatch: "auto" resolves by device through
    # kernels.ops.wire_backend; EnginePlan.quant_backend records the result.
    # fused_quant=False runs the composed (multi-pass) ablation path.
    quant_backend: str = "auto"
    fused_quant: bool = True
    # benchmark ablation: skip gradient reduction entirely
    skip_reduce: bool = False


@dataclasses.dataclass(frozen=True)
class EnginePlan:
    """Static description of one model's gradient exchange."""

    buckets: scheduler.BucketPlan
    algos: tuple                     # planner.ALGO_FLAT per bucket
    fusable: tuple                   # bool per bucket: may travel flattened
    data_axes: tuple
    dp: int                          # total data-parallel ranks
    wire: str
    prioritize: bool
    use_ef: bool
    overlap: bool
    accum_steps: int
    skip_reduce: bool = False
    # int8 wire execution detail, resolved once at plan-build time: the
    # kernel backend ("cuda" | "torch"), whether the single-pass fused
    # kernels run, and the per-bucket padding waste of the tiling
    quant_backend: str = "torch"
    fused_quant: bool = True
    quant_pad: tuple = ()

    @property
    def n_buckets(self) -> int:
        return len(self.buckets.buckets)


def build_plan(grad_struct, comm: CommConfig, mesh, data_axes, *,
               device: torch.device | str | None = None,
               layer_index: Callable[[tuple], float] | None = None,
               group_key: Callable[[tuple], object] | None = None,
               leaf_replicated: Callable[[tuple], bool] | None = None,
               tp_axis: Optional[str] = None) -> EnginePlan:
    """Compile CommConfig + gradient structure + mesh into an EnginePlan.

    `grad_struct` is a nested dict of tensors with the gradients' shapes
    (meta tensors will do). `group_key(path)` marks sharding groups that
    must not fuse across; `leaf_replicated(path)` says whether a leaf is
    fully replicated (only such buckets travel as one flat message).
    `device` is where the gradients live (default: the mesh's device type);
    it resolves the int8 kernel backend."""
    if comm.hier or comm.topo is not None:
        raise NotImplementedError(_HIER_SLICE)
    if tp_axis is not None:
        raise NotImplementedError(
            "hybrid tensor parallelism (tp_axis) is not yet ported to "
            "repro_torch; it comes with the hybrid data x model slice")
    if layer_index is None:
        layer_index = scheduler.default_layer_index
    plan = scheduler.plan_buckets(grad_struct, layer_index,
                                  bucket_bytes=comm.bucket_bytes,
                                  group_key=group_key)
    if leaf_replicated is None:
        fusable = tuple(True for _ in plan.buckets)
    else:
        fusable = tuple(all(leaf_replicated(plan.paths[i]) for i in b.leaf_ids)
                        for b in plan.buckets)
    shape = planner_lib.mesh_shape(mesh)
    dp = 1
    for a in data_axes:
        dp *= shape[a]
    use_ef = comm.error_feedback and comm.wire == cl.WIRE_INT8
    if device is None:
        device = getattr(mesh, "device_type", "cpu")
    qb = kops.wire_backend(comm.quant_backend, device)
    quant_pad = ()
    if comm.wire == cl.WIRE_INT8:
        quant_pad = tuple(kops.pad_info(b.n_elems).waste_frac
                          for b in plan.buckets)
    return EnginePlan(buckets=plan,
                      algos=tuple(planner_lib.ALGO_FLAT for _ in plan.buckets),
                      fusable=fusable, data_axes=tuple(data_axes), dp=dp,
                      wire=comm.wire, prioritize=comm.prioritize,
                      use_ef=use_ef, overlap=comm.overlap,
                      accum_steps=comm.accum_steps,
                      skip_reduce=comm.skip_reduce, quant_backend=qb,
                      fused_quant=comm.fused_quant, quant_pad=quant_pad)


@dataclasses.dataclass(frozen=True)
class CommEngine:
    """Executes an EnginePlan: the single entry point for bucket reduction.

    `groups` are the process groups of the plan's data axes, in order."""

    plan: EnginePlan
    groups: tuple

    @classmethod
    def create(cls, grad_struct, comm: CommConfig, mesh, data_axes,
               **kw) -> "CommEngine":
        plan = build_plan(grad_struct, comm, mesh, data_axes, **kw)
        return cls(plan=plan,
                   groups=tuple(mesh.get_group(a) for a in data_axes))

    # -- residual (error-feedback) state -----------------------------------

    def ef_applied(self, bi: int) -> bool:
        """Does bucket `bi` run the error-feedback int8 wire? Non-fusable
        buckets are forced onto the bf16 wire and carry their (empty)
        residual through unchanged."""
        return self.plan.use_ef and self.plan.fusable[bi]

    def init_residuals(self, device):
        """Zero residuals: this rank's fabric shard per EF bucket, and a
        zero-length placeholder per other bucket (one entry per bucket).
        The reference returns the global view (shard x dp ranks); each rank
        here holds its own shard."""
        p = self.plan
        if not p.use_ef:
            return None
        return tuple(
            torch.zeros(cl.ef_residual_shape(b.n_elems, p.dp)
                        if self.ef_applied(bi) else (0,),
                        dtype=torch.float32, device=device)
            for bi, b in enumerate(p.buckets.buckets))

    # -- the data path ------------------------------------------------------

    def _leaves(self, grads) -> list:
        leaves = tree_lib.leaves(grads)
        if len(leaves) != len(self.plan.buckets.paths):
            raise ValueError(f"gradient tree has {len(leaves)} leaves, the "
                             f"plan {len(self.plan.buckets.paths)}")
        return leaves

    def _reduce_bucket(self, flat, residual, acc=None):
        """One fused message over the data axes (flat route). Returns
        (reduced, new_residual_or_None). `acc` folds an accumulator into the
        gather-side dequantize."""
        p = self.plan
        if p.use_ef:
            return cl.allreduce_ef(flat, residual, self.groups, mean=True,
                                   backend=p.quant_backend,
                                   fused=p.fused_quant, acc=acc)
        return cl.allreduce(flat, self.groups, wire=p.wire, mean=True,
                            backend=p.quant_backend, fused=p.fused_quant,
                            acc=acc), None

    def _reduce_leafwise(self, vals):
        """A non-fusable bucket: per leaf, shape-preserving, on the bf16
        wire when the plan's wire is int8."""
        wire = self.plan.wire if self.plan.wire != cl.WIRE_INT8 \
            else cl.WIRE_BF16
        return [cl.allreduce(v, self.groups, wire=wire, mean=True)
                for v in vals]

    def reduce_chained(self, grads, residuals):
        """Fused, prioritized, wire-precision gradient exchange: buckets are
        issued in plan (priority) order. Replicated buckets travel as one
        flat message; the others per leaf. Returns (reduced_tree,
        new_residuals)."""
        p = self.plan
        if p.skip_reduce:
            return grads, residuals
        leaves = self._leaves(grads)
        new_leaves = list(leaves)
        new_residuals = []
        for bi, bucket in enumerate(p.buckets.buckets):
            if p.fusable[bi]:
                flat = scheduler.fuse_bucket(leaves, bucket)
                red, res = self._reduce_bucket(
                    flat, residuals[bi] if p.use_ef else None)
                if p.use_ef:
                    new_residuals.append(res)
                for lid, leaf in scheduler.unfuse_bucket(red, bucket).items():
                    new_leaves[lid] = leaf
            else:
                vals = self._reduce_leafwise([leaves[i] for i in bucket.leaf_ids])
                if p.use_ef:
                    new_residuals.append(residuals[bi])
                for lid, leaf in zip(bucket.leaf_ids, vals):
                    new_leaves[lid] = leaf
        out = tree_lib.unflatten(list(p.buckets.paths), new_leaves)
        return out, (tuple(new_residuals) if p.use_ef else residuals)

    def reduce(self, grads, residuals):
        """The whole exchange as one call. Returns (reduced_tree,
        new_residuals)."""
        return self.reduce_chained(grads, residuals)

    # -- bucket-layout gradient accumulation (microbatch loop) --------------

    def init_accum(self, device):
        """Zero accumulators in bucket layout: one flat f32 buffer per
        fusable bucket, a per-leaf f32 tuple for the others."""
        p = self.plan
        return tuple(
            torch.zeros((b.n_elems,), dtype=torch.float32, device=device)
            if p.fusable[bi]
            else tuple(torch.zeros(shape, dtype=torch.float32, device=device)
                       for shape in b.shapes)
            for bi, b in enumerate(p.buckets.buckets))

    def reduce_accum_chained(self, grads, acc, residuals):
        """acc'[bi] = acc[bi] + reduce(bucket bi of grads), in bucket layout.

        On the int8 wire the accumulate is fused into the gather-side
        dequantize (one pass). Returns (new_acc, new_residuals); unbucket
        with `unfuse_accum` after the last microbatch."""
        p = self.plan
        leaves = self._leaves(grads)
        new_acc = []
        new_residuals = []
        for bi, bucket in enumerate(p.buckets.buckets):
            if p.fusable[bi]:
                flat = scheduler.fuse_bucket(leaves, bucket)
                if p.skip_reduce:
                    new_acc.append(acc[bi] + flat)
                    res = residuals[bi] if p.use_ef else None
                else:
                    red, res = self._reduce_bucket(
                        flat, residuals[bi] if p.use_ef else None,
                        acc=acc[bi])
                    new_acc.append(red)
            else:
                vals = [leaves[i] for i in bucket.leaf_ids]
                if not p.skip_reduce:
                    vals = self._reduce_leafwise(vals)
                new_acc.append(tuple(a + v.to(torch.float32)
                                     for a, v in zip(acc[bi], vals)))
                res = residuals[bi] if p.use_ef else None
            if p.use_ef:
                new_residuals.append(res)
        return (tuple(new_acc),
                tuple(new_residuals) if p.use_ef else residuals)

    def unfuse_accum(self, acc):
        """Bucket-layout accumulator -> f32 gradient tree."""
        p = self.plan
        leaves = [None] * len(p.buckets.paths)
        for bi, b in enumerate(p.buckets.buckets):
            if p.fusable[bi]:
                off = 0
                for lid, size, shape in zip(b.leaf_ids, b.sizes, b.shapes):
                    leaves[lid] = acc[bi][off:off + size].reshape(shape)
                    off += size
            else:
                for lid, a in zip(b.leaf_ids, acc[bi]):
                    leaves[lid] = a
        return tree_lib.unflatten(list(p.buckets.paths), leaves)
