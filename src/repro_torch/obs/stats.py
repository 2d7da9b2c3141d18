"""CommStats: MLSL-style per-message statistics for an EnginePlan.

The paper's proof points (§4) are per-message numbers — how many bytes each
gradient message put on which link, under which algorithm, and how long it
took — that only the library owning the exchange can produce. This module
derives exactly that report from an ``EnginePlan``:

  * per-bucket wire legs (``LegBytes``): what each phase of the routed
    collective actually carries — flat ring vs two-level, intra vs inter
    level, fp32/bf16/int8 payload after quantization plus the f32 scale
    sideband, including the tiling padding the int8 wire adds;
  * modeled service time from the ``hw.Topology`` cost model (the same
    ``planner.bucket_allreduce_times`` the router and benchmarks use);
  * measured service time from ``measure_bucket_times`` — a per-bucket
    replay of the engine's own ``_reduce_bucket`` data path over the
    plan's process groups, a collective every rank runs in lockstep.

Byte convention: ``LegBytes`` counts the MESSAGE each leg carries (payload
+ scale sideband), not per-hop ring traffic — so a flat fp32 bucket is
exactly ``n_elems * 4`` bytes and the hierarchical int8 fabric gather leg is
exactly ``elems * 1 + scale_bytes``, assertable against the plan.

Surfaced as ``EnginePlan.describe()`` / ``CommEngine.stats()`` (lazy
imports on the core side keep the layering acyclic: this module sits ABOVE
``repro_torch.core``) and serialized into the perf-ledger schema via
``to_metrics()`` — every stats metric is informational (``better=None``) or
unstable (wall-clock), so the ledger diff gate warns and never fails on it.

Ports `repro/obs/stats.py`: the byte and modeled-time columns equal the
reference's on the same plan (tests/test_torch_obs_ranks.py); the replay
is the port's own (``BucketTimer``).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional

import torch
import torch.distributed as dist

from repro_torch.core import collectives as cl
from repro_torch.core import hier as hier_lib
from repro_torch.core import hw
from repro_torch.core import planner as planner_lib

_SCALE_BYTES = 4  # one f32 scale per QUANT_BLOCK elements on the int8 wire


def _roundup(n: int, quantum: int) -> int:
    return ((n + quantum - 1) // quantum) * quantum


def _float_bytes(wire: str) -> int:
    return 2 if wire == cl.WIRE_BF16 else 4


@dataclasses.dataclass(frozen=True)
class LegBytes:
    """One phase of a routed collective: the message it carries."""

    leg: str             # "allreduce" | "reduce_scatter" | "all_gather"
    level: str           # "intra" (node-local link) | "inter" (fabric)
    wire: str            # payload dtype on the wire: fp32 | bf16 | int8
    elems: int           # elements in this leg's message (incl. padding)
    payload_bytes: int
    scale_bytes: int = 0  # f32 scale sideband (int8 payload only)

    @property
    def total_bytes(self) -> int:
        return self.payload_bytes + self.scale_bytes


def _flat_legs(n_elems: int, wire: str, dp: int) -> tuple:
    """Legs of `collectives.allreduce` over `dp` ranks (the flat route)."""
    if wire == cl.WIRE_INT8:
        # _allreduce_int8: pad to whole (TILE_ROWS x QUANT_BLOCK) rows per
        # rank, reduce-scatter bf16, all-gather int8 + f32 block scales
        padded = _roundup(n_elems, dp * cl.QUANT_BLOCK * 8)
        return (
            LegBytes("reduce_scatter", "inter", cl.WIRE_BF16, padded,
                     2 * padded),
            LegBytes("all_gather", "inter", cl.WIRE_INT8, padded, padded,
                     padded // cl.QUANT_BLOCK * _SCALE_BYTES),
        )
    # float wires psum the message unpadded: exactly n_elems * width bytes
    return (LegBytes("allreduce", "inter", wire, n_elems,
                     n_elems * _float_bytes(wire)),)


def _hier_legs(n_elems: int, spec: hier_lib.HierSpec, local: int,
               node: int) -> tuple:
    """Legs of `hier.hier_allreduce`: intra RS -> fabric allreduce on
    1/local of the volume -> intra AG, per-leg wire precision."""
    padded = _roundup(n_elems,
                      hier_lib._pad_quantum(local, node, spec.wire_inter))
    isz = _float_bytes(spec.wire_intra)
    m = padded // local                       # fabric-leg message
    legs = [LegBytes("reduce_scatter", "intra", spec.wire_intra, padded,
                     padded * isz)]
    if spec.wire_inter == cl.WIRE_INT8:
        # the two-level pad quantum already makes m a whole number of
        # quantization rows per node rank — the inner allreduce never re-pads
        legs += [
            LegBytes("reduce_scatter", "inter", cl.WIRE_BF16, m, 2 * m),
            LegBytes("all_gather", "inter", cl.WIRE_INT8, m, m,
                     m // cl.QUANT_BLOCK * _SCALE_BYTES),
        ]
    else:
        legs.append(LegBytes("allreduce", "inter", spec.wire_inter, m,
                             m * _float_bytes(spec.wire_inter)))
    legs.append(LegBytes("all_gather", "intra", spec.wire_intra, padded,
                         padded * isz))
    return tuple(legs)


@dataclasses.dataclass(frozen=True)
class BucketStats:
    """One bucket's row of the report."""

    index: int
    n_elems: int
    route: str               # planner.ALGO_FLAT | ALGO_HIER
    wire: str                # wire actually used (int8 falls back to bf16
                             # on non-fusable buckets — see reduce_chained)
    fusable: bool
    ef: bool
    axes: tuple
    legs: tuple              # LegBytes per phase; () when skip_reduce
    t_model: Optional[float] = None      # seconds, hw.Topology cost model
    t_measured: Optional[float] = None   # seconds, measure_bucket_times

    def _level_bytes(self, level: str) -> int:
        return sum(lg.total_bytes for lg in self.legs if lg.level == level)

    @property
    def intra_bytes(self) -> int:
        return self._level_bytes("intra")

    @property
    def inter_bytes(self) -> int:
        return self._level_bytes("inter")

    @property
    def total_bytes(self) -> int:
        return self.intra_bytes + self.inter_bytes

    @property
    def scale_bytes(self) -> int:
        return sum(lg.scale_bytes for lg in self.legs)

    @property
    def padded_elems(self) -> int:
        return max((lg.elems for lg in self.legs if lg.level != "inter"),
                   default=max((lg.elems for lg in self.legs), default=0))

    @property
    def pad_frac(self) -> float:
        if self.n_elems == 0 or not self.legs:
            return 0.0
        return self.padded_elems / self.n_elems - 1.0


def _bucket_stats(plan, bi: int, bucket, t_model, t_measured) -> BucketStats:
    route = plan.algos[bi]
    fusable = plan.fusable[bi]
    ef = plan.use_ef and fusable
    wire = plan.wire
    if plan.skip_reduce:
        legs = ()
    elif not fusable:
        # reduce_chained reduces non-fusable buckets per-leaf on a float
        # wire (the int8 flatten/scatter composition would reshard them) —
        # always the flat path, one unpadded message per leaf summed here
        route = planner_lib.ALGO_FLAT
        wire = cl.WIRE_BF16 if wire == cl.WIRE_INT8 else wire
        legs = (LegBytes("allreduce", "inter", wire, bucket.n_elems,
                         bucket.n_elems * _float_bytes(wire)),)
    elif route == planner_lib.ALGO_HIER:
        legs = _hier_legs(bucket.n_elems, plan.hier_spec, plan.n_local,
                          plan.n_node)
    else:
        legs = _flat_legs(bucket.n_elems, wire, plan.dp)
    return BucketStats(index=bi, n_elems=bucket.n_elems, route=route,
                       wire=wire, fusable=fusable, ef=ef,
                       axes=tuple(plan.axes_for(bi)), legs=legs,
                       t_model=t_model, t_measured=t_measured)


@dataclasses.dataclass(frozen=True)
class CommStats:
    """The per-bucket exchange report for one EnginePlan."""

    buckets: tuple           # BucketStats per bucket
    topo_name: str
    dp: int
    n_node: int
    n_local: int
    wire: str
    use_ef: bool
    quant_backend: str
    fused_quant: bool
    overlap: bool
    accum_steps: int

    @classmethod
    def from_plan(cls, plan, *, topo=None, measured=None) -> "CommStats":
        """Derive the report from an EnginePlan.

        `topo` (hw.Topology, a TOPOLOGIES name, or None) selects the cost
        model for the modeled column; None falls back to the plan's routing
        topology, then to hw.CLOUD_10G (the paper's baseline platform).
        `measured` is an optional per-bucket seconds sequence
        (measure_bucket_times).
        """
        if topo is None:
            topo = getattr(plan, "topo", None) or hw.CLOUD_10G
        if isinstance(topo, str):
            topo = hw.TOPOLOGIES[topo]
        # flat-only plans report n_node == 1; recover the node count the
        # cost model needs from dp over the topology's node width
        nodes = plan.n_node if plan.n_node > 1 else max(
            1, plan.dp // topo.local_size)
        t_model = planner_lib.bucket_allreduce_times(
            plan.buckets.buckets, plan.algos, nodes, topo, wire=plan.wire,
            ef=plan.use_ef, fused_quant=plan.fused_quant)
        if measured is None:
            measured = (None,) * plan.n_buckets
        rows = tuple(
            _bucket_stats(plan, bi, b, t_model[bi], measured[bi])
            for bi, b in enumerate(plan.buckets.buckets))
        return cls(buckets=rows, topo_name=topo.name, dp=plan.dp,
                   n_node=plan.n_node, n_local=plan.n_local, wire=plan.wire,
                   use_ef=plan.use_ef, quant_backend=plan.quant_backend,
                   fused_quant=plan.fused_quant, overlap=plan.overlap,
                   accum_steps=plan.accum_steps)

    # -- aggregates ---------------------------------------------------------

    @property
    def total_bytes(self) -> int:
        return sum(b.total_bytes for b in self.buckets)

    @property
    def intra_bytes(self) -> int:
        return sum(b.intra_bytes for b in self.buckets)

    @property
    def inter_bytes(self) -> int:
        return sum(b.inter_bytes for b in self.buckets)

    @property
    def t_model_total(self) -> float:
        return sum(b.t_model or 0.0 for b in self.buckets)

    @property
    def t_measured_total(self) -> Optional[float]:
        vals = [b.t_measured for b in self.buckets]
        if any(v is None for v in vals):
            return None
        return sum(vals)

    # -- rendering ----------------------------------------------------------

    def table(self) -> str:
        """The MLSL-style stats table (one row per bucket + totals)."""
        hdr = (f"CommStats: dp={self.dp} (node={self.n_node} x "
               f"local={self.n_local})  wire={self.wire}"
               f"{' +ef' if self.use_ef else ''}  "
               f"backend={self.quant_backend}"
               f"{' fused' if self.fused_quant else ' composed'}  "
               f"overlap={self.overlap} accum={self.accum_steps}  "
               f"model topo={self.topo_name}")
        cols = ("bkt", "elems", "route", "wire", "ef", "pad%", "intra_B",
                "inter_B", "scale_B", "total_B", "t_model_us", "t_meas_us")
        rows = [cols]
        for b in self.buckets:
            rows.append((
                str(b.index), str(b.n_elems), b.route, b.wire,
                "y" if b.ef else "-", f"{b.pad_frac * 100:.1f}",
                str(b.intra_bytes), str(b.inter_bytes), str(b.scale_bytes),
                str(b.total_bytes),
                f"{b.t_model * 1e6:.1f}" if b.t_model is not None else "-",
                f"{b.t_measured * 1e6:.1f}"
                if b.t_measured is not None else "-",
            ))
        tm = self.t_measured_total
        rows.append((
            "sum", str(sum(b.n_elems for b in self.buckets)), "", "", "", "",
            str(self.intra_bytes), str(self.inter_bytes),
            str(sum(b.scale_bytes for b in self.buckets)),
            str(self.total_bytes), f"{self.t_model_total * 1e6:.1f}",
            f"{tm * 1e6:.1f}" if tm is not None else "-"))
        widths = [max(len(r[c]) for r in rows) for c in range(len(cols))]
        lines = [hdr, ""]
        for i, r in enumerate(rows):
            lines.append("  ".join(v.rjust(w) for v, w in zip(r, widths)))
            if i == 0:
                lines.append("  ".join("-" * w for w in widths))
        return "\n".join(lines)

    def to_metrics(self) -> list:
        """Ledger entries (dicts matching benchmarks.common.Metric).

        Warn-only by construction: byte/count metrics are informational
        (``better=None``), time metrics are wall-clock-class
        (``stable=False``) — the diff gate never hard-fails on either.
        """
        out = []

        def info(name, value, unit=""):
            out.append({"name": name, "value": value, "unit": unit,
                        "better": None, "stable": True})

        def wallclock(name, value, unit="us"):
            out.append({"name": name, "value": value, "unit": unit,
                        "better": "lower", "stable": False})

        for b in self.buckets:
            pre = f"comm_stats/b{b.index:02d}"
            info(f"{pre}/elems", float(b.n_elems))
            info(f"{pre}/route", b.route)
            info(f"{pre}/wire", b.wire)
            info(f"{pre}/intra_B", float(b.intra_bytes), "B")
            info(f"{pre}/inter_B", float(b.inter_bytes), "B")
            info(f"{pre}/total_B", float(b.total_bytes), "B")
            if b.t_model is not None:
                wallclock(f"{pre}/t_model_us", b.t_model * 1e6)
            if b.t_measured is not None:
                wallclock(f"{pre}/t_measured_us", b.t_measured * 1e6)
        info("comm_stats/total/n_buckets", float(len(self.buckets)))
        info("comm_stats/total/topo", self.topo_name)
        info("comm_stats/total/intra_B", float(self.intra_bytes), "B")
        info("comm_stats/total/inter_B", float(self.inter_bytes), "B")
        info("comm_stats/total/total_B", float(self.total_bytes), "B")
        wallclock("comm_stats/total/t_model_us", self.t_model_total * 1e6)
        if self.t_measured_total is not None:
            wallclock("comm_stats/total/t_measured_us",
                      self.t_measured_total * 1e6)
        return out


# ---------------------------------------------------------------------------
# measured per-bucket service time (the engine's own data path, replayed)
# ---------------------------------------------------------------------------

class BucketTimer:
    """Build-once, sample-many per-bucket replay of the engine data path.

    Each bucket's exchange runs standalone: the fused flat message (or the
    per-leaf messages of a non-fusable bucket, on the bf16 wire when the
    plan's wire is int8) goes through exactly the call ``reduce_chained``
    makes for that bucket (``engine._reduce_bucket`` or
    ``engine._reduce_leafwise``), so the replay launches the same kernels
    and collectives. The inputs are synthetic — the wire traffic and
    kernel work are what is being measured, not the values: standard
    normal f32 drawn from a ``torch.Generator`` seeded by `seed`, and fresh
    zero residuals (``engine.init_residuals``), never the training state's.

    The replay is a collective: every rank of the plan's groups must build
    the timer and call ``sample`` at the same points, and gets the same
    tuple back. Building allocates the inputs once (each bucket's size in
    f32, plus its residual); ``sample()`` is then cheap enough for the
    telemetry loop to call every N steps between training steps.
    """

    def __init__(self, engine, mesh, *, seed: int = 0):
        p = engine.plan
        self.device = torch.device(mesh.device_type)
        gen = torch.Generator(device=self.device).manual_seed(seed)
        residuals = engine.init_residuals(self.device)
        self.n_buckets = p.n_buckets
        self._cases = []          # a replay closure, or None (skip_reduce)
        for bi, bucket in enumerate(p.buckets.buckets):
            if p.skip_reduce:
                self._cases.append(None)
            elif p.fusable[bi]:
                flat = torch.randn(bucket.n_elems, generator=gen,
                                   device=self.device)
                res = residuals[bi] if engine.ef_applied(bi) else None
                self._cases.append(
                    lambda f=flat, r=res, b=bi: engine._reduce_bucket(f, r, b))
            else:
                vals = [torch.randn(shape, generator=gen, device=self.device)
                        for shape in bucket.shapes]
                self._cases.append(
                    lambda v=vals, b=bi: engine._reduce_leafwise(v, b))

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def sample(self, *, iters: int = 1, warmup: int = 0) -> tuple:
        """Median wall seconds per bucket over `iters` timed replays, each
        timed from a finished device to a finished device; then the MAX
        over the world, since the exchange ends when its slowest rank
        does."""
        times = []
        for case in self._cases:
            if case is None:
                times.append(0.0)
                continue
            for _ in range(warmup):
                case()
            ts = []
            for _ in range(max(iters, 1)):
                self._sync()
                t0 = time.perf_counter()
                case()
                self._sync()
                ts.append(time.perf_counter() - t0)
            ts.sort()
            times.append(ts[len(ts) // 2])
        out = torch.tensor(times, dtype=torch.float64, device=self.device)
        dist.all_reduce(out, op=dist.ReduceOp.MAX)
        return tuple(out.tolist())


def measure_bucket_times(engine, mesh, *, iters: int = 3, warmup: int = 1,
                         seed: int = 0) -> tuple:
    """Median wall seconds per bucket of the engine's `_reduce_bucket` path
    (one-shot convenience over ``BucketTimer``; a collective)."""
    return BucketTimer(engine, mesh, seed=seed).sample(
        iters=iters, warmup=warmup)
