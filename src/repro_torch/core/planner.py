"""The DL Layer API: per-parameter partition specs, and the cost model that
routes each gradient message flat or two-level.

Ports the parameter half, the flat-vs-hierarchical router (with
`estimate_overlap`, the overlap-aware schedule estimate) and the executed
hybrid plan of `repro/core/planner.py`. Models declare their parameters as
`ParamDef`s with a *kind*; the planner owns the kind -> sharding rules. A
spec is a tuple with one entry per dimension: a mesh axis name, a tuple of
names, or None (replicated along that dimension).

The data-parallel step reads the specs for one thing: which gradient
buckets may travel fused (only fully replicated leaves may). The hybrid
step (`make_hybrid_planner`) also cuts each rank's parameter shards by them
(`convert.shard_params`). The rules are the reference's exactly, including
one of its quirks: outside `dp_only` and without `model_paths`, every
matrix kind gets the model axis when its dimension divides the model size,
even when that size is 1 or the mesh has no model axis at all. Under the
default planner only norm scales are replicated.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable

import torch

from repro_torch import tree as tree_lib
from repro_torch.core import c2c, hw

# Parameter kinds understood by the planner.
K_EMBED = "embed"            # (vocab, d)
K_HEAD = "head"              # (d, vocab)
K_PROJ_IN = "proj_in"        # (d_in, d_out): output dim model-sharded
K_PROJ_OUT = "proj_out"      # (d_in, d_out): input dim model-sharded
K_EXPERT_IN = "expert_in"    # (E, d, ff)
K_EXPERT_OUT = "expert_out"  # (E, ff, d)
K_VEC_MODEL = "vec_model"    # (n,): per-channel param of a model-sharded dim
K_CONV_MODEL = "conv_model"  # (channels, kwidth): channels model-sharded
K_NORM = "norm"              # replicated small vectors
K_SCALAR = "scalar"
K_REPLICATED = "replicated"  # explicitly replicated projections


@dataclasses.dataclass(frozen=True)
class ParamDef:
    """Declarative parameter: shape + dtype + planner kind + init style."""

    shape: tuple
    kind: str
    dtype: torch.dtype = torch.float32
    init: str = "normal"       # normal | zeros | ones | scaled
    init_scale: float | None = None   # overrides 1/sqrt(fan_in)

    @property
    def size(self) -> int:
        return int(math.prod(self.shape))


def _divides(dim: int, size: int) -> bool:
    return size > 0 and dim % size == 0


def mesh_shape(mesh) -> dict:
    """{axis name: size} of a DeviceMesh (or of a plain name->size dict)."""
    if isinstance(mesh, dict):
        return dict(mesh)
    return dict(zip(mesh.mesh_dim_names, tuple(mesh.shape)))


@dataclasses.dataclass
class Planner:
    """Maps ParamDefs to partition specs on a mesh."""

    mesh: object
    model_axis: str = "model"
    fsdp: bool = False
    # node-group size 1 (paper C2): pure data parallelism over EVERY mesh
    # axis; the model axis joins the batch axes
    dp_only: bool = False
    # executed hybrid parallelism (plan_hybrid): `model_paths(path) -> bool`
    # restricts model-axis sharding to parameters of layers the per-layer
    # C2C verdict sends model-parallel; `hybrid` carries the HybridPlan the
    # specs were derived from (the trainer keys its tp group off it)
    model_paths: Callable[[tuple], bool] | None = None
    hybrid: "HybridPlan | None" = None

    def __post_init__(self):
        if self.fsdp:
            raise ValueError(
                "Planner(fsdp=True) is not supported: the mlsl step manages "
                "gradient communication explicitly and needs parameters "
                "replicated over the batch axes")
        shape = mesh_shape(self.mesh)
        names = tuple(shape)
        if self.dp_only:
            self.batch_axes = names
            self.model_size = 1
        else:
            self.batch_axes = tuple(a for a in names if a != self.model_axis)
            self.model_size = shape.get(self.model_axis, 1)

    def spec_for(self, pd: ParamDef, *, stacked: bool = False,
                 model_ok: bool = True) -> tuple:
        """Partition spec of a parameter (optionally with a leading,
        replicated scan dimension). `model_ok=False` suppresses model-axis
        sharding for this parameter (the hybrid plan's DP-fallback layers
        stay replicated)."""
        dims = [None] * len(pd.shape)
        offset = 1 if stacked else 0
        shape = pd.shape[offset:]

        def try_model(cands):
            if self.dp_only or not model_ok:
                return
            for d in cands:
                if _divides(shape[d], self.model_size):
                    dims[d + offset] = self.model_axis
                    return

        kind = pd.kind
        if kind in (K_NORM, K_SCALAR, K_REPLICATED):
            pass
        elif kind == K_EMBED:
            try_model([0, 1])
        elif kind == K_HEAD:
            try_model([1, 0])
        elif kind == K_PROJ_IN:
            try_model([len(shape) - 1])
        elif kind == K_PROJ_OUT:
            try_model([0])
        elif kind == K_EXPERT_IN:
            try_model([0, 2])
        elif kind == K_EXPERT_OUT:
            try_model([0, 1])
        elif kind in (K_VEC_MODEL, K_CONV_MODEL):
            try_model([0])
        else:
            raise ValueError(f"unknown param kind {kind!r}")
        return tuple(dims)

    def tree_specs(self, defs_tree,
                   *, stacked_paths: Callable[[tuple], bool] | None = None):
        """ParamDef tree -> spec tree. `stacked_paths(path)` marks leaves
        with a leading (L,) scan dimension."""
        def one(path, pd):
            st = stacked_paths(path) if stacked_paths else False
            ok = self.model_paths(path) if self.model_paths else True
            return self.spec_for(pd, stacked=st, model_ok=ok)
        return tree_lib.map_with_path(one, defs_tree)


# --- flat vs hierarchical collective choice (machine-hierarchy planning) -----

ALGO_FLAT = "flat"
ALGO_HIER = "hier"


def bucket_allreduce_times(buckets, algos, nodes: int, topo: hw.Topology, *,
                           bytes_per_elem: float = 4.0, wire: str = "fp32",
                           ef: bool = False,
                           fused_quant: bool = True) -> tuple:
    """Per-bucket allreduce service time under each bucket's route
    (ALGO_FLAT rings over all ranks, ALGO_HIER two-level). `buckets` has
    `n_elems` per bucket, `algos` the matching routes (an EnginePlan's).
    `wire`/`ef`/`fused_quant` charge the int8 wire's quantization term."""
    out = []
    for b, algo in zip(buckets, algos):
        nbytes = b.n_elems * bytes_per_elem
        t = (hw.hier_allreduce_time(nbytes, nodes, topo, wire_inter=wire,
                                    ef=ef, fused_quant=fused_quant)
             if algo == ALGO_HIER else
             hw.flat_allreduce_time(nbytes, nodes, topo, wire=wire, ef=ef,
                                    fused_quant=fused_quant))
        out.append(t)
    return tuple(out)


def estimate_overlap(buckets, algos, nodes: int, topo: hw.Topology,
                     n_micro: int, micro_compute: float, *,
                     bytes_per_elem: float = 4.0):
    """Overlap-aware schedule estimate for an engine bucket plan: (blocking,
    overlapped) simulator.BucketScheduleStats of the engine's
    per-microbatch exchange, with each bucket's service time from the
    per-level cost model."""
    from repro_torch.core import simulator as sim
    times = bucket_allreduce_times(buckets, algos, nodes, topo,
                                   bytes_per_elem=bytes_per_elem)
    off = sim.simulate_bucket_schedule(times, n_micro, micro_compute,
                                       overlap=False)
    on = sim.simulate_bucket_schedule(times, n_micro, micro_compute,
                                      overlap=True)
    return off, on


def choose_allreduce_algo(nbytes: float, nodes: int, topo: hw.Topology,
                          fault=None, *, wire: str = "fp32",
                          ef: bool = False, fused_quant: bool = True) -> str:
    """Flat vs two-level allreduce for one message, from the per-level
    bandwidth/latency model (repro_torch.core.hw): the hierarchy wins when
    the fabric-volume saving (1/local_size of the bytes cross the slow
    link) beats the two extra intra-node phases. `wire`/`ef`/`fused_quant`
    add the int8 wire's quantization term to both candidates.

    `fault` (simulator.FaultSpec) composes injected degradation onto the
    topology before costing, so routing re-plans under the degraded model."""
    if topo.local_size <= 1 or nodes <= 1:
        return ALGO_FLAT
    if fault is not None:
        topo = fault.apply_to_topology(topo)
    t_flat = hw.flat_allreduce_time(nbytes, nodes, topo, wire=wire, ef=ef,
                                    fused_quant=fused_quant)
    t_hier = hw.hier_allreduce_time(nbytes, nodes, topo, wire_inter=wire,
                                    ef=ef, fused_quant=fused_quant)
    return ALGO_HIER if t_hier < t_flat else ALGO_FLAT


# --- executed hybrid parallelism: C2C verdict -> per-layer sharding ----------

# Block kinds whose parameters the executed tensor-parallel path can shard
# (attention heads / MLP hidden features over the model axis); every other
# kind falls back to data parallelism regardless of the chooser's verdict.
TP_KINDS = ("attn", "local")


def _block_kind(name: str) -> str | None:
    """`p{i}_{kind}` / `t{i}_{kind}` param-tree key -> block kind."""
    if "_" in name and name[0] in ("p", "t"):
        head, kind = name.split("_", 1)
        if head[1:].isdigit():
            return kind
    return None


@dataclasses.dataclass(frozen=True)
class HybridLayerPlan:
    """One layer's C2C verdict plus what actually executes."""

    name: str                  # param-tree key (c2c.layers_from_model_config)
    kind: str                  # block kind (or "embed"/"head")
    choice: c2c.StrategyChoice
    executed: str              # c2c.Strategy value: "model" or "data"
    reason: str = ""           # why executed != the chooser's pick ("": agrees)

    @property
    def model_parallel(self) -> bool:
        return self.executed == c2c.Strategy.MODEL.value


@dataclasses.dataclass(frozen=True)
class HybridPlan:
    """Executable per-layer sharding derived from the C2C chooser.

    Tensor/model parallelism runs over the intra-node `tp_axis` (the model
    group is exactly one node's fast-link domain); data parallelism runs
    across the remaining `data_axes` -- the paper's node groups mapped onto
    the machine hierarchy."""

    tp_axis: str
    tp: int                    # model-group size (the tp_axis's size)
    dp: int                    # number of data-parallel groups
    data_axes: tuple
    layers: tuple              # HybridLayerPlan per c2c layer

    @property
    def model_layer_names(self) -> frozenset:
        return frozenset(l.name for l in self.layers if l.model_parallel)

    @property
    def any_model_parallel(self) -> bool:
        return bool(self.model_layer_names)

    def layer(self, name: str) -> HybridLayerPlan:
        for l in self.layers:
            if l.name == name:
                return l
        raise KeyError(name)

    def param_filter(self) -> Callable[[tuple], bool]:
        """Path predicate for Planner.model_paths: True exactly for the
        parameters of layers this plan executes model-parallel (a path is
        the tuple of the tree's keys)."""
        names = self.model_layer_names

        def ok(path) -> bool:
            return any(k in names for k in path)
        return ok


def _tp_divisible(cfg, kind: str, tp: int) -> tuple[bool, str]:
    if kind not in TP_KINDS:
        return False, f"unsupported-kind:{kind}"
    a = cfg.attn
    if a.n_heads % tp or a.n_kv % tp:
        return False, f"indivisible-heads:{a.n_heads}q/{a.n_kv}kv%{tp}"
    if cfg.d_ff % tp:
        return False, f"indivisible-ff:{cfg.d_ff}%{tp}"
    return True, ""


def plan_hybrid(cfg, mesh, batch: int, seq: int, *, tp_axis: str = "local",
                group_size: int | None = None,
                bytes_per_elem: float = 4.0) -> HybridPlan:
    """Run the C2C chooser per layer and gate each verdict on executability.

    The chooser is evaluated at the candidate group sizes {1, g} (g defaults
    to the `tp_axis` size; an invalid g contributes ratio 0). A layer
    executes model-parallel IFF the chooser picked the group AND (a) the
    group tiles the `tp_axis` exactly and (b) the layer's head / KV-head /
    hidden-feature counts divide by it -- otherwise it cleanly falls back to
    data parallelism with the reason recorded on the layer plan. `mesh` is
    a DeviceMesh or a name -> size dict."""
    shape = mesh_shape(mesh)
    names = tuple(shape)
    if tp_axis not in names:
        raise ValueError(f"mesh has no {tp_axis!r} axis (axes: {names})")
    tp = int(shape[tp_axis])
    data_axes = tuple(a for a in names if a != tp_axis)
    dp = 1
    for a in data_axes:
        dp *= int(shape[a])
    p = dp * tp
    g = tp if group_size is None else group_size
    group_ok = (g == tp)
    group_reason = "" if group_ok else (
        f"group-indivisible:g={g} must equal the {tp_axis!r} axis size {tp}")
    plans = []
    for spec in c2c.layers_from_model_config(cfg, seq):
        choice = c2c.choose_strategy(spec, batch, p,
                                     group_sizes=sorted({1, g}),
                                     bytes_per_elem=bytes_per_elem)
        kind = _block_kind(spec.name) or spec.name
        executed, reason = c2c.Strategy.DATA.value, ""
        if choice.group_size > 1:
            if not group_ok:
                reason = group_reason
            else:
                ok, reason = _tp_divisible(cfg, kind, tp)
                if ok:
                    executed = c2c.Strategy.MODEL.value
        else:
            reason = group_reason if not group_ok else "chooser-data"
        plans.append(HybridLayerPlan(name=spec.name, kind=kind, choice=choice,
                                     executed=executed, reason=reason))
    return HybridPlan(tp_axis=tp_axis, tp=tp, dp=dp, data_axes=data_axes,
                      layers=tuple(plans))


def make_hybrid_planner(mesh, cfg, batch: int, seq: int, *,
                        tp_axis: str = "local",
                        group_size: int | None = None) -> Planner:
    """Planner wired to an executed HybridPlan: parameters shard over
    `tp_axis` only for the layers the (divisibility-gated) C2C chooser
    sends model-parallel; everything else stays replicated and reduces over
    the data axes."""
    plan = plan_hybrid(cfg, mesh, batch, seq, tp_axis=tp_axis,
                       group_size=group_size)
    return Planner(mesh=mesh, model_axis=tp_axis,
                   model_paths=plan.param_filter(), hybrid=plan)


@dataclasses.dataclass(frozen=True)
class HybridCommModel:
    """Modeled per-iteration exposed communication: executed hybrid vs DP."""

    t_dp_flat: float           # pure DP, flat ring over all ranks (fabric)
    t_dp_hier: float           # pure DP routed through the two-level path
    t_hybrid: float            # grads (replicated hier + sharded node ring)
                               #   + activation psums on the intra link
    t_hybrid_grads: float
    t_hybrid_acts: float
    dp_grad_bytes: float       # full-gradient bytes (both DP schedules)
    hybrid_grad_bytes: float   # fabric bytes per local rank under hybrid
    hybrid_act_bytes: float    # intra-link bytes per rank (fwd + bwd psums)

    @property
    def reduction_vs_flat(self) -> float:
        return self.t_dp_flat / self.t_hybrid if self.t_hybrid > 0 else math.inf

    @property
    def reduction_vs_hier(self) -> float:
        return self.t_dp_hier / self.t_hybrid if self.t_hybrid > 0 else math.inf


def model_hybrid_comm(plan: HybridPlan, layers, batch: int, nodes: int,
                      topo: hw.Topology, *,
                      bytes_per_elem: float = 4.0) -> HybridCommModel:
    """Cost the executed hybrid schedule against pure DP on `topo`.

    Mirrors the engine's executed structure: replicated-parameter gradients
    reduce two-level over (node, local); model-sharded gradients reduce as
    per-local-rank rings over the node axis only (each rank moves its own
    1/tp shard -- the factor-tp fabric-volume saving is the hybrid win);
    activations psum over the tp group on the intra link, twice per
    model-parallel layer (forward combine + backward replicate-grad).
    Uses the same hw.*_allreduce_time cost model the bucket router uses."""
    by_name = {l.name: l for l in layers}
    w_rep = w_model = 0.0
    act_t = act_bytes = 0.0
    local_batch = batch / max(nodes, 1)
    for lp in plan.layers:
        spec = by_name[lp.name]
        if lp.model_parallel:
            w_model += spec.weight_elems
            ab = spec.out_elems_per_sample * local_batch * bytes_per_elem
            act_bytes += 2.0 * ab
            act_t += 2.0 * hw.ring_allreduce_time(ab, plan.tp,
                                                  topo.effective_intra)
        else:
            w_rep += spec.weight_elems
    total_bytes = (w_rep + w_model) * bytes_per_elem
    t_dp_flat = hw.flat_allreduce_time(total_bytes, nodes, topo)
    t_dp_hier = hw.hier_allreduce_time(total_bytes, nodes, topo)
    grads_t = hw.hier_allreduce_time(w_rep * bytes_per_elem, nodes, topo) \
        if w_rep else 0.0
    shard_bytes = w_model * bytes_per_elem / max(plan.tp, 1)
    if w_model and nodes > 1:
        grads_t += hw.ring_allreduce_time(shard_bytes, nodes,
                                          topo.effective_inter)
    return HybridCommModel(
        t_dp_flat=t_dp_flat, t_dp_hier=t_dp_hier,
        t_hybrid=grads_t + act_t, t_hybrid_grads=grads_t, t_hybrid_acts=act_t,
        dp_grad_bytes=total_bytes,
        hybrid_grad_bytes=w_rep * bytes_per_elem + shard_bytes,
        hybrid_act_bytes=act_bytes)


# --- the per-layer strategy report (the paper's Table-1-style view) ----------

@dataclasses.dataclass(frozen=True)
class LayerPlan:
    name: str
    kind: str
    choice: c2c.StrategyChoice


def plan_report(layers, batch: int, p: int, group_sizes=None) -> list:
    """Run the C2C chooser over a layer list -- what MLSL's DL Layer API would
    decide for each layer of the network on p nodes."""
    report = []
    for l in layers:
        choice = c2c.choose_strategy(l, batch, p, group_sizes=group_sizes)
        report.append(LayerPlan(name=l.name, kind=l.kind.value, choice=choice))
    return report
