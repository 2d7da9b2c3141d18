"""CommEngine: the unified bucket-reduction data path (paper §2, MLSL EP servers).

Ports the data-parallel half of `repro/core/engine.py`:

  * ``CommConfig``  -- the declarative knobs (mode, wire precision, bucket
    size, error feedback, two-level hierarchy, overlap), shared by the
    trainer and the CLI;
  * ``EnginePlan``  -- the static plan compiled from a gradient structure +
    CommConfig + mesh: bucket boundaries (scheduler.plan_buckets), which
    buckets may travel fused, each bucket's flat-vs-two-level route
    (scheduler.route_buckets over the hw.Topology cost model), each
    bucket's reduce axes under hybrid tensor parallelism, and the resolved
    int8 kernel backend;
  * ``CommEngine``  -- executes the plan eagerly over `torch.distributed`.

The reference threads an `optimization_barrier` token through the buckets
so XLA issues them in priority order. Eagerly, the engine issues the
buckets in plan order, which is the priority order, and every collective of
the exchange is ordered on the stream; `prioritize` is recorded for the plan
but changes nothing here.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

from repro_torch import tree as tree_lib
from repro_torch.core import collectives as cl
from repro_torch.core import hier as hier_lib
from repro_torch.core import hw
from repro_torch.core import planner as planner_lib
from repro_torch.core import scheduler
from repro_torch.kernels import ops as kops


@dataclasses.dataclass(frozen=True)
class CommConfig:
    """Declarative communication configuration (consumed by CommEngine and
    the train-step factory)."""

    mode: str = "gspmd"              # gspmd | mlsl
    wire: str = cl.WIRE_FP32
    prioritize: bool = True
    bucket_bytes: float = 25e6
    error_feedback: bool = False     # int8 wire only
    # the moe blocks' dispatch: "gather" (models.moe.moe_apply) or "ep"
    # (moe_apply_ep: all-to-all expert parallelism over the model group);
    # under FSDP the ep path gathers its expert weights itself, on the int8
    # wire with wgather_wire="int8"
    moe_impl: str = "gather"
    wgather_wire: str = "bf16"
    accum_steps: int = 1             # microbatch gradient accumulation
    # two-level collectives over a ("node", "local") factored data dimension
    # (repro_torch.core.hier): `wire` selects the fabric leg and
    # `wire_intra` the intra-node legs (None: hier.default_wire_intra).
    # `topo` names a machine hierarchy (hw.TOPOLOGIES); when set, each
    # bucket is routed flat vs two-level by the per-level cost model
    # (scheduler.route_buckets) instead of always going two-level.
    hier: bool = False
    wire_intra: Optional[str] = None
    topo: Optional[str] = None
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
    # >0: the train forward's attention runs online-softmax over chunks of
    # this many keys (models.attention.chunked_sdpa)
    kv_chunk: int = 0
    # int8: the quantized GQA KV cache of serving (the dry-run's prefill and
    # decode read it; the engines take `kv_dtype` themselves)
    kv_dtype: str = "native"


@dataclasses.dataclass(frozen=True)
class EnginePlan:
    """Static description of one model's gradient exchange."""

    buckets: scheduler.BucketPlan
    algos: tuple                     # planner.ALGO_FLAT|ALGO_HIER per bucket
    fusable: tuple                   # bool per bucket: may travel flattened
    data_axes: tuple
    dp: int                          # total data-parallel ranks
    wire: str
    prioritize: bool
    use_ef: bool
    hier_spec: Optional[hier_lib.HierSpec]
    n_node: int                      # 1 when not hierarchical
    n_local: int
    overlap: bool
    accum_steps: int
    skip_reduce: bool = False
    # hybrid (data x model) execution: gradients of model-sharded parameters
    # reduce over the data axes only (each rank owns a distinct 1/tp shard),
    # while replicated-parameter gradients reduce over data axes + tp_axis
    # (their per-rank copies are identical, so the mean is unchanged and the
    # two-level path gets the intra link back). bucket_axes records the
    # reduce axes per bucket; () means "use data_axes for every bucket".
    tp_axis: Optional[str] = None
    tp: int = 1
    bucket_axes: tuple = ()
    # int8 wire execution detail, resolved once at plan-build time: the
    # kernel backend ("cuda" | "torch"), whether the single-pass fused
    # kernels run, and the per-bucket padding waste of the tiling
    quant_backend: str = "torch"
    fused_quant: bool = True
    quant_pad: tuple = ()
    # the hw.TOPOLOGIES name the buckets were routed against (None: no
    # cost-model routing)
    topo: Optional[str] = None
    # model parallelism: the plan is the reference's, on the global leaf
    # shapes, but each rank reduces its local shard of a model-sharded
    # leaf; per bucket, its leaves' shapes on this rank (() when they are
    # the global shapes)
    local_shapes: tuple = ()

    def axes_for(self, bi: int) -> tuple:
        return self.bucket_axes[bi] if self.bucket_axes else self.data_axes

    def shapes_for(self, bi: int) -> tuple:
        """Bucket `bi`'s leaf shapes as this rank holds them."""
        if self.local_shapes:
            return self.local_shapes[bi]
        return self.buckets.buckets[bi].shapes

    @property
    def n_buckets(self) -> int:
        return len(self.buckets.buckets)

    def bucket_bytes_list(self, bytes_per_elem: float = 4.0) -> tuple:
        return tuple(b.n_elems * bytes_per_elem for b in self.buckets.buckets)

    def describe(self, *, topo=None) -> str:
        """The MLSL-style per-bucket stats table for this plan (wire bytes
        per leg, route, modeled service time). Lazy import: repro_torch.obs
        sits above core, so the plan only reaches it when a human asks."""
        from repro_torch.obs import stats as obs_stats
        return obs_stats.CommStats.from_plan(self, topo=topo).table()


def build_plan(grad_struct, comm: CommConfig, mesh, data_axes, *,
               device: torch.device | str | None = None,
               layer_index: Callable[[tuple], float] | None = None,
               group_key: Callable[[tuple], object] | None = None,
               leaf_replicated: Callable[[tuple], bool] | None = None,
               tp_axis: Optional[str] = None,
               leaf_sharded: Callable[[tuple], bool] | None = None,
               local_struct=None) -> EnginePlan:
    """Compile CommConfig + gradient structure + mesh into an EnginePlan.

    `grad_struct` is a nested dict of tensors with the gradients' shapes
    (meta tensors will do). `group_key(path)` marks sharding groups that
    must not fuse across; `leaf_replicated(path)` says whether a leaf is
    fully replicated (only such buckets travel as one flat message).
    `device` is where the gradients live (default: the mesh's device type);
    it resolves the int8 kernel backend. With `comm.hier` the data axes
    must hold the ("node", "local") factoring (launch.mesh.make_hier_mesh);
    every bucket then goes two-level, or, with `comm.topo`, the route the
    cost model picks.

    `tp_axis` + `leaf_sharded` switch on hybrid (data x model) execution:
    `grad_struct` then describes each rank's LOCAL gradient shards, and
    `leaf_sharded(path)` marks leaves whose parameter is model-sharded over
    `tp_axis`. Sharded buckets reduce over the data axes only, on the flat
    route; replicated buckets reduce over data axes + tp_axis, on the route
    the plan picks. Every leaf is a local tensor, so all buckets fuse.

    `local_struct` (model parallelism: `grad_struct`'s tree with each
    leaf's shape on this rank) keeps the plan on the global shapes, as the
    reference's, and records the local ones for what a rank allocates per
    leaf (`EnginePlan.shapes_for`). Only replicated leaves fuse, and their
    local shapes are the global ones."""
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

    tp = 1
    bucket_axes = ()
    sharded_buckets = tuple(False for _ in plan.buckets)
    if tp_axis is not None:
        if leaf_sharded is None:
            raise ValueError("tp_axis requires a leaf_sharded predicate")
        if use_ef:
            raise ValueError(
                "error feedback is unsupported with hybrid tensor "
                "parallelism: the int8 residual is a per-rank fabric shard, "
                "but model-sharded gradients reduce over the node axis only "
                "while replicated ones reduce over (node, local)")
        tp = int(shape[tp_axis])
        sharded_buckets = tuple(
            any(leaf_sharded(plan.paths[i]) for i in b.leaf_ids)
            for b in plan.buckets)
        full = tuple(data_axes) + (tp_axis,)
        bucket_axes = tuple(tuple(data_axes) if sh else full
                            for sh in sharded_buckets)
        fusable = tuple(True for _ in plan.buckets)

    local_shapes = ()
    if local_struct is not None:
        local = [tuple(t.shape) for t in tree_lib.leaves(local_struct)]
        local_shapes = tuple(tuple(local[i] for i in b.leaf_ids)
                             for b in plan.buckets)
        for bi, b in enumerate(plan.buckets):
            if fusable[bi] and local_shapes[bi] != b.shapes:
                raise ValueError(f"bucket {bi} fuses leaves whose local "
                                 f"shapes {local_shapes[bi]} differ from "
                                 f"the global {b.shapes}")

    hier_spec = None
    n_node, n_local = 1, dp
    if comm.hier:
        hier_axes = tuple(data_axes) + ((tp_axis,) if tp_axis else ())
        if not (hier_lib.NODE_AXIS in hier_axes
                and hier_lib.LOCAL_AXIS in hier_axes):
            raise ValueError(
                "comm.hier needs the data dimension factored over "
                f"({hier_lib.NODE_AXIS!r}, {hier_lib.LOCAL_AXIS!r}) mesh "
                f"axes (launch.mesh.make_hier_mesh); got {hier_axes}")
        wire_intra = comm.wire_intra or hier_lib.default_wire_intra(comm.wire)
        hier_spec = hier_lib.HierSpec(wire_intra=wire_intra,
                                      wire_inter=comm.wire,
                                      error_feedback=use_ef, backend=qb,
                                      fused=comm.fused_quant)
        n_node = shape[hier_lib.NODE_AXIS]
        n_local = shape[hier_lib.LOCAL_AXIS]
        if comm.topo is not None:
            if comm.topo not in hw.TOPOLOGIES:
                raise ValueError(
                    f"unknown topology {comm.topo!r}; known: "
                    f"{sorted(hw.TOPOLOGIES)}")
            # small latency-bound buckets may stay flat while bulk buckets
            # take the hierarchy (MLSL's per-message phase choice)
            algos = scheduler.route_buckets(plan, hw.TOPOLOGIES[comm.topo],
                                            nodes=n_node, wire=comm.wire,
                                            ef=use_ef,
                                            fused_quant=comm.fused_quant)
        else:
            algos = tuple(planner_lib.ALGO_HIER for _ in plan.buckets)
        if tp_axis is not None:
            # the two-level path needs BOTH hierarchy axes in a bucket's
            # reduce axes; model-sharded buckets reduce over the node axis
            # only, so they always go flat
            algos = tuple(planner_lib.ALGO_FLAT if sh else a
                          for a, sh in zip(algos, sharded_buckets))
    else:
        algos = tuple(planner_lib.ALGO_FLAT for _ in plan.buckets)

    return EnginePlan(buckets=plan, algos=algos, fusable=fusable,
                      data_axes=tuple(data_axes), dp=dp, wire=comm.wire,
                      prioritize=comm.prioritize, use_ef=use_ef,
                      hier_spec=hier_spec, n_node=n_node, n_local=n_local,
                      overlap=comm.overlap, accum_steps=comm.accum_steps,
                      skip_reduce=comm.skip_reduce, tp_axis=tp_axis, tp=tp,
                      bucket_axes=bucket_axes, quant_backend=qb,
                      fused_quant=comm.fused_quant, quant_pad=quant_pad,
                      topo=comm.topo, local_shapes=local_shapes)


def bucket_range(bi: int):
    """The range every collective of bucket `bi`'s exchange runs in: a
    `torch.profiler.record_function` named "bucket <bi>", which a profile
    shows and the dry-run's collective log (`launch/roofline.py`) reads."""
    return torch.profiler.record_function(f"bucket {bi}")


@dataclasses.dataclass(frozen=True)
class CommEngine:
    """Executes an EnginePlan: the single entry point for bucket reduction.

    `groups` are the process groups of the plan's data axes, in order;
    `tp_group` is the group of its tp axis (None on pure-DP plans)."""

    plan: EnginePlan
    groups: tuple
    tp_group: object = None

    @classmethod
    def create(cls, grad_struct, comm: CommConfig, mesh, data_axes,
               **kw) -> "CommEngine":
        plan = build_plan(grad_struct, comm, mesh, data_axes, **kw)
        return cls(plan=plan,
                   groups=tuple(mesh.get_group(a) for a in data_axes),
                   tp_group=(None if plan.tp_axis is None
                             else mesh.get_group(plan.tp_axis)))

    @property
    def axis_groups(self) -> dict:
        """{axis name: its process group} over the data axes and the tp
        axis (the two-level route looks up the spec's node and local axes
        here)."""
        out = dict(zip(self.plan.data_axes, self.groups))
        if self.plan.tp_axis is not None:
            out[self.plan.tp_axis] = self.tp_group
        return out

    def groups_for(self, bi: int) -> list:
        """The process groups bucket `bi` reduces over."""
        groups = self.axis_groups
        return [groups[a] for a in self.plan.axes_for(bi)]

    @property
    def tp(self) -> Optional[cl.TPComm]:
        """Activation-exchange communicator for the plan's model axis (None
        on pure-DP plans). The train step takes its tp group from here, so
        the f/g operators the blocks place around their sharded projections
        run over the group the engine's replicated buckets reduce over."""
        if self.plan.tp_axis is None:
            return None
        return cl.TPComm(self.plan.tp_axis, self.tp_group)

    # -- residual (error-feedback) state -----------------------------------

    def ef_applied(self, bi: int) -> bool:
        """Does bucket `bi` run the error-feedback int8 wire? Non-fusable
        buckets are forced onto the bf16 wire and carry their (empty)
        residual through unchanged."""
        return self.plan.use_ef and self.plan.fusable[bi]

    def init_residuals(self, device):
        """Zero residuals: this rank's fabric shard per EF bucket, sized by
        the bucket's route, and a zero-length placeholder per other bucket
        (one entry per bucket). The reference returns the global view
        (shard x dp ranks, rank n * local + l holding the n-th fabric
        sub-chunk of the l-th intra chunk on the two-level route); each rank
        here holds its own shard of that view."""
        p = self.plan

        def shape(bi, b):
            if not self.ef_applied(bi):
                return (0,)
            if p.algos[bi] == planner_lib.ALGO_HIER:
                return hier_lib.ef_residual_shape(b.n_elems, p.n_local,
                                                  p.n_node)
            return cl.ef_residual_shape(b.n_elems, p.dp)

        if not p.use_ef:
            return None
        return tuple(torch.zeros(shape(bi, b), dtype=torch.float32,
                                 device=device)
                     for bi, b in enumerate(p.buckets.buckets))

    # -- the data path ------------------------------------------------------

    def _leaves(self, grads) -> list:
        leaves = tree_lib.leaves(grads)
        if len(leaves) != len(self.plan.buckets.paths):
            raise ValueError(f"gradient tree has {len(leaves)} leaves, the "
                             f"plan {len(self.plan.buckets.paths)}")
        return leaves

    def _reduce_bucket(self, flat, residual, bi: int, acc=None):
        """One fused message over the data axes, flat or two-level per the
        bucket's route. Returns (reduced, new_residual_or_None). `acc` folds
        an accumulator into the result (on the flat int8 route inside the
        gather-side dequantize)."""
        p = self.plan
        with bucket_range(bi):
            if p.algos[bi] == planner_lib.ALGO_HIER:
                if p.use_ef:
                    return hier_lib.hier_allreduce_ef(
                        flat, residual, self.axis_groups, p.hier_spec,
                        mean=True, acc=acc)
                return hier_lib.hier_allreduce(flat, self.axis_groups,
                                               p.hier_spec, mean=True,
                                               acc=acc), None
            if p.use_ef:
                return cl.allreduce_ef(flat, residual, self.groups, mean=True,
                                       backend=p.quant_backend,
                                       fused=p.fused_quant, acc=acc)
            return cl.allreduce(flat, self.groups_for(bi), wire=p.wire,
                                mean=True, backend=p.quant_backend,
                                fused=p.fused_quant, acc=acc), None

    def _reduce_leafwise(self, vals, bi: int):
        """A non-fusable bucket: per leaf, shape-preserving, on the bf16
        wire when the plan's wire is int8."""
        wire = self.plan.wire if self.plan.wire != cl.WIRE_INT8 \
            else cl.WIRE_BF16
        groups = self.groups_for(bi)
        with bucket_range(bi):
            return [cl.allreduce(v, groups, wire=wire, mean=True)
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
                    flat, residuals[bi] if p.use_ef else None, bi)
                if p.use_ef:
                    new_residuals.append(res)
                for lid, leaf in scheduler.unfuse_bucket(red, bucket).items():
                    new_leaves[lid] = leaf
            else:
                vals = self._reduce_leafwise(
                    [leaves[i] for i in bucket.leaf_ids], bi)
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

    # -- observability -------------------------------------------------------

    def stats(self, *, measured=None, topo=None):
        """MLSL-style per-message statistics for this engine's plan
        (repro_torch.obs.stats.CommStats): per-bucket wire bytes by
        leg/level, route, modeled service time on `topo` (default: the
        plan's routing topology), and the measured column when `measured`
        (per-bucket seconds, e.g. obs.stats.measure_bucket_times) is given.
        Lazy import keeps core independent of obs."""
        from repro_torch.obs import stats as obs_stats
        return obs_stats.CommStats.from_plan(self.plan, measured=measured,
                                             topo=topo)

    def bucket_timer(self, mesh, *, seed: int = 0):
        """Build-once per-bucket replay of this engine's reduce path
        (repro_torch.obs.stats.BucketTimer), a collective every rank builds
        and samples at the same points. Lazy import keeps core independent
        of obs."""
        from repro_torch.obs import stats as obs_stats
        return obs_stats.BucketTimer(self, mesh, seed=seed)

    # -- bucket-layout gradient accumulation (microbatch loop) --------------

    def init_accum(self, device):
        """Zero accumulators in bucket layout: one flat f32 buffer per
        fusable bucket, a per-leaf f32 tuple for the others."""
        p = self.plan
        return tuple(
            torch.zeros((b.n_elems,), dtype=torch.float32, device=device)
            if p.fusable[bi]
            else tuple(torch.zeros(shape, dtype=torch.float32, device=device)
                       for shape in p.shapes_for(bi))
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
                        flat, residuals[bi] if p.use_ef else None, bi,
                        acc=acc[bi])
                    new_acc.append(red)
            else:
                vals = [leaves[i] for i in bucket.leaf_ids]
                if not p.skip_reduce:
                    vals = self._reduce_leafwise(vals, bi)
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
