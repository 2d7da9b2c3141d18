"""Discrete-event simulator of synchronous-SGD communication scheduling.

A copy of `repro/core/simulator.py` (framework-free arithmetic on the
port's `core/hw.py`): the port keeps its own copy and imports nothing of
the reference. It must equal the reference's exactly
(tests/test_torch_simulator.py). Its TPU and Xeon constants come from
`hw.py` and are the cost model's data, never measurements of this port.

The simulator models one training iteration's backward pass, the
gradient allreduce traffic it generates, and the next forward pass that
consumes the reduced gradients, under three network-scheduling policies:

  * BLOCKING        -- allreduce synchronously at each layer boundary
                       (no overlap at all; the naive baseline).
  * FIFO_OVERLAP    -- asynchronous allreduce, serviced in issue order
                       (backprop issues last-layer gradients first, so the
                       first layer's small, urgent reduction queues behind
                       all the bulk transfers -- MPI semantics).
  * PRIORITY_OVERLAP-- MLSL's message prioritization: the network always
                       services the ready transfer needed EARLIEST in the
                       next forward pass, preempting bulk transfers
                       (preempted transfers keep their progress).

It also models the CommEngine's per-microbatch bucket schedule
(`simulate_bucket_schedule`, the modeled side of the train CLI's
`--stats`/`--trace`) and replays labeled fault episodes in the telemetry
schema (`generate_episode`, the health monitor's ground truth).
"""

from __future__ import annotations

import bisect
import dataclasses
import enum
from typing import Sequence

from repro_torch.core import hw


class Policy(str, enum.Enum):
    BLOCKING = "blocking"
    FIFO_OVERLAP = "fifo"
    PRIORITY_OVERLAP = "priority"


@dataclasses.dataclass(frozen=True)
class SimLayer:
    """One layer as the simulator sees it.

    fwd_time / bwd_time are seconds of compute on one node; wgrad_bytes is
    the full (unsharded) weight-gradient size in bytes.
    """

    name: str
    fwd_time: float
    bwd_time: float
    wgrad_bytes: float


@dataclasses.dataclass(frozen=True)
class SimSpan:
    """One interval of the modeled timeline (``record_timeline=True``).

    Times are seconds from iteration start. ``cat`` is "compute" (fwd/bwd
    work), "comm" (the network servicing a transfer — a preempted priority
    transfer yields one span per serviced segment), or "stall" (compute
    waiting on an unfinished allreduce — the exposed time, per layer).
    ``obs.trace.export_sim_spans`` turns these into Chrome-trace events.
    """

    name: str
    cat: str                    # "compute" | "comm" | "stall"
    start: float
    end: float
    layer: int = -1

    @property
    def duration(self) -> float:
        return self.end - self.start


@dataclasses.dataclass
class IterationStats:
    policy: Policy
    total_time: float
    compute_time: float
    exposed_comm: float
    comm_busy: float            # seconds the link was transferring
    completion_times: list     # allreduce completion per layer index
    timeline: list             # SimSpan intervals (record_timeline=True)


@dataclasses.dataclass(frozen=True)
class _Job:
    layer: int
    ready: float
    duration: float


@dataclasses.dataclass(frozen=True)
class FaultSpec:
    """Injected degradation for a simulated iteration (the paper's
    Cloud-vs-HPC story off the happy path; Keuper & Pfreundt 1609.06870).

    * ``straggler_slowdown`` (>= 1): the slowest node's compute runs this
      much slower. Synchronous SGD is paced by the critical-path node, so
      the simulator scales the modeled compute timeline by it; the wait is
      accounted as EXPOSED time (``compute_time`` stays the healthy value),
      since cycles spent waiting on a straggler buy no useful work.
      ``straggler_node`` optionally names which node (metadata only — the
      single-server model tracks the critical path, not identities).
    * ``inter_bw_factor`` / ``inter_latency_factor``: degraded inter-node
      fabric (congestion, oversubscription). Without a topology these apply
      to the bare ``link``, which *is* the fabric.
    * ``intra_bw_factor`` / ``intra_latency_factor``: degraded intra-node
      transport (shared-memory pressure, virtio stack contention).
    * ``hetero_link_bw_factors``: per-link bandwidth factors of a
      heterogeneous fabric; a ring is paced by its slowest link, so the
      minimum composes into the effective fabric bandwidth.
    """

    straggler_slowdown: float = 1.0
    straggler_node: int | None = None
    inter_bw_factor: float = 1.0
    inter_latency_factor: float = 1.0
    intra_bw_factor: float = 1.0
    intra_latency_factor: float = 1.0
    hetero_link_bw_factors: tuple = ()

    @property
    def worst_inter_bw_factor(self) -> float:
        worst = min(self.hetero_link_bw_factors, default=1.0)
        return min(self.inter_bw_factor, worst)

    def apply_to_link(self, link: hw.Link) -> hw.Link:
        """Degrade a bare fabric link (the no-topology case)."""
        return hw.LinkDegradation(
            bw_factor=self.worst_inter_bw_factor,
            latency_factor=self.inter_latency_factor).apply(link)

    def apply_to_topology(self, topo: hw.Topology) -> hw.Topology:
        """Compose this fault onto a (possibly already degraded) topology."""
        return topo.degrade(intra_bw=self.intra_bw_factor,
                            intra_latency=self.intra_latency_factor,
                            inter_bw=self.worst_inter_bw_factor,
                            inter_latency=self.inter_latency_factor,
                            straggler=self.straggler_slowdown)

    @property
    def compute_slowdown(self) -> float:
        return max(self.straggler_slowdown, 1.0)


HEALTHY_FAULT = FaultSpec()


def _allreduce_durations(layers: Sequence[SimLayer], p: int, link: hw.Link,
                         overlap_eff: float = 1.0,
                         topo: hw.Topology | None = None,
                         comm_algo: str = "auto", wire: str = "fp32",
                         ef: bool = False,
                         fused_quant: bool = True) -> list:
    """Per-layer allreduce service times.

    `overlap_eff` (0 < eta <= 1) models imperfect asynchronous progress:
    transfers overlapped with compute share host resources (progress thread
    cycles, memory bandwidth, PCIe) and achieve only eta of the wire rate --
    the effect MLSL's dedicated progress cores mitigate but do not remove.
    Applied uniformly to both policies, so policy comparisons stay fair.

    With a `topo` (two-level machine hierarchy), `p` counts NODES and each
    layer's time is the flat ring over the fabric, the two-level
    decomposition, or the per-message cost-model choice (`comm_algo` in
    {"flat", "hier", "auto"}) -- how plans weigh hierarchical collectives.
    `wire`/`ef`/`fused_quant` charge the int8 wire's quantization-overhead
    term (hw.quant_overhead_time) on the topology-costed paths.
    """
    if topo is None:
        return [hw.ring_allreduce_time(l.wgrad_bytes, p, link) / overlap_eff
                for l in layers]
    out = []
    for l in layers:
        t_flat = hw.flat_allreduce_time(l.wgrad_bytes, p, topo, wire=wire,
                                        ef=ef, fused_quant=fused_quant)
        t_hier = hw.hier_allreduce_time(l.wgrad_bytes, p, topo,
                                        wire_inter=wire, ef=ef,
                                        fused_quant=fused_quant)
        t = {"flat": t_flat, "hier": t_hier,
             "auto": min(t_flat, t_hier)}[comm_algo]
        out.append(t / overlap_eff)
    return out


def _serve_fifo(jobs: Sequence[_Job]):
    """Single network resource, service in ready (issue) order.

    Returns (done, segments): per-job completion times plus the serviced
    intervals as (job_index, start, end) — FIFO never preempts, so exactly
    one segment per job.
    """
    order = sorted(range(len(jobs)), key=lambda i: (jobs[i].ready, -jobs[i].layer))
    done = [0.0] * len(jobs)
    segments = []
    t = 0.0
    for i in order:
        start = max(t, jobs[i].ready)
        t = start + jobs[i].duration
        done[i] = t
        segments.append((i, start, t))
    return done, segments


def _serve_priority(jobs: Sequence[_Job]):
    """Preemptive priority service: lowest layer index first.

    Event-driven single-server simulation. When a more urgent job becomes
    ready, the in-flight transfer is preempted and resumed later with its
    remaining bytes intact (MLSL 'completes preempted operations in an
    optimal manner as and when they are required').

    Returns (done, segments): per-job completion times plus the serviced
    intervals as (job_index, start, end) — a preempted job contributes one
    segment per serviced stretch.
    """
    n = len(jobs)
    remaining = [j.duration for j in jobs]
    done = [0.0] * n
    segments = []
    arrivals = sorted(range(n), key=lambda i: jobs[i].ready)
    arrived: list = []          # layer-sorted list of not-yet-finished jobs
    t = 0.0
    ai = 0
    finished = 0
    while finished < n:
        # admit everything that has arrived by t
        while ai < n and jobs[arrivals[ai]].ready <= t:
            i = arrivals[ai]
            bisect.insort(arrived, (jobs[i].layer, i))
            ai += 1
        if not arrived:
            t = jobs[arrivals[ai]].ready
            continue
        _, cur = arrived[0]
        # run until completion or the next arrival, whichever is first
        next_arrival = jobs[arrivals[ai]].ready if ai < n else float("inf")
        finish_at = t + remaining[cur]
        if finish_at <= next_arrival:
            segments.append((cur, t, finish_at))
            t = finish_at
            done[cur] = t
            arrived.pop(0)
            finished += 1
        else:
            if next_arrival > t:
                segments.append((cur, t, next_arrival))
            remaining[cur] -= next_arrival - t
            t = next_arrival
    return done, segments


def simulate_iteration(layers: Sequence[SimLayer], p: int, link: hw.Link,
                       policy: Policy = Policy.PRIORITY_OVERLAP,
                       record_timeline: bool = False,
                       overlap_eff: float = 1.0,
                       topo: hw.Topology | None = None,
                       comm_algo: str = "auto",
                       fault: FaultSpec | None = None, wire: str = "fp32",
                       ef: bool = False,
                       fused_quant: bool = True) -> IterationStats:
    """Simulate bwd(iter k) + allreduce + fwd(iter k+1) under a policy.

    Backward runs layers L-1..0; layer i's allreduce becomes ready when its
    bwd completes. The next forward runs layers 0..L-1 and layer i's forward
    cannot start before its allreduce completed (weights must be updated) --
    exactly the dependency structure the paper exploits.

    With `topo`, `p` counts nodes of `topo.local_size` ranks and the
    collectives are costed on the two-level hierarchy (`comm_algo` selects
    flat / hier / per-message auto); `link` is then ignored.

    With a `fault` (FaultSpec), the links are degraded (composed onto
    `topo`'s own degradation factors, or onto the bare `link`) and a
    straggler stretches the compute timeline; `compute_time` stays the
    HEALTHY compute, so straggler wait shows up as exposed time and every
    fault is monotone in both `total_time` and `exposed_comm`.
    """
    n = len(layers)
    compute = sum(l.fwd_time + l.bwd_time for l in layers)
    if fault is not None:
        if topo is not None:
            topo = fault.apply_to_topology(topo)
        else:
            link = fault.apply_to_link(link)
    slow = max(1.0, topo.straggler if topo is not None else 1.0,
               fault.compute_slowdown if fault is not None else 1.0)
    durations = _allreduce_durations(layers, p, link,
                                     overlap_eff=overlap_eff,
                                     topo=topo, comm_algo=comm_algo,
                                     wire=wire, ef=ef,
                                     fused_quant=fused_quant)
    timeline = []

    def span(name, cat, start, end, layer=-1):
        if record_timeline and end > start:
            timeline.append(SimSpan(name=name, cat=cat, start=start,
                                    end=end, layer=layer))

    if policy is Policy.BLOCKING:
        t = 0.0
        done = [0.0] * n
        for i in range(n - 1, -1, -1):
            span(f"bwd:{layers[i].name}", "compute", t,
                 t + layers[i].bwd_time * slow, layer=i)
            t += layers[i].bwd_time * slow
            span(f"allreduce:{layers[i].name}", "comm", t,
                 t + durations[i], layer=i)
            t += durations[i]          # synchronous allreduce, no overlap
            done[i] = t
        for i in range(n):
            span(f"fwd:{layers[i].name}", "compute", t,
                 t + layers[i].fwd_time * slow, layer=i)
            t += layers[i].fwd_time * slow
        total = t
        return IterationStats(policy=policy, total_time=total,
                              compute_time=compute,
                              exposed_comm=total - compute,
                              comm_busy=sum(durations),
                              completion_times=done, timeline=timeline)

    # --- overlapped policies -------------------------------------------------
    t = 0.0
    jobs = []
    for i in range(n - 1, -1, -1):
        span(f"bwd:{layers[i].name}", "compute", t,
             t + layers[i].bwd_time * slow, layer=i)
        t += layers[i].bwd_time * slow
        jobs.append(_Job(layer=i, ready=t, duration=durations[i]))
    bwd_end = t
    jobs = sorted(jobs, key=lambda j: j.layer)
    if policy is Policy.FIFO_OVERLAP:
        done, segments = _serve_fifo(jobs)
    else:
        done, segments = _serve_priority(jobs)
    for ji, start, end in segments:
        span(f"allreduce:{layers[jobs[ji].layer].name}", "comm", start, end,
             layer=jobs[ji].layer)

    t = bwd_end
    for i in range(n):
        # fwd(i) waits on allreduce(i): the wait IS the exposed time
        span(f"stall:{layers[i].name}", "stall", t, done[i], layer=i)
        t = max(t, done[i])
        span(f"fwd:{layers[i].name}", "compute", t,
             t + layers[i].fwd_time * slow, layer=i)
        t += layers[i].fwd_time * slow
    total = t
    return IterationStats(policy=policy, total_time=total,
                          compute_time=compute,
                          exposed_comm=total - compute,
                          comm_busy=sum(durations),
                          completion_times=done, timeline=timeline)


def scaling_efficiency(layers: Sequence[SimLayer], p: int, link: hw.Link,
                       policy: Policy = Policy.PRIORITY_OVERLAP,
                       topo: hw.Topology | None = None,
                       comm_algo: str = "auto",
                       overlap_eff: float = 1.0,
                       fault: FaultSpec | None = None) -> float:
    """Weak-scaling efficiency at p nodes (fixed per-node mini-batch).

    efficiency = compute-only time / simulated iteration time.

    With a `topo`, p counts NODES: a single node still holds
    topo.local_size communicating ranks, so p == 1 is only trivially
    efficient when the whole hierarchy is one rank. With a `fault`,
    straggler wait and degraded links both cut efficiency (the healthy
    compute is the numerator).
    """
    ranks = topo.flat_size(p) if topo is not None else p
    if ranks <= 1 and (fault is None or fault.compute_slowdown <= 1.0):
        return 1.0
    stats = simulate_iteration(layers, p, link, policy, topo=topo,
                               comm_algo=comm_algo, overlap_eff=overlap_eff,
                               fault=fault)
    return stats.compute_time / stats.total_time


def exposed_comm_reduction(layers: Sequence[SimLayer], p: int,
                           link: hw.Link, *,
                           overlap_eff: float = 1.0,
                           topo: hw.Topology | None = None,
                           comm_algo: str = "auto",
                           fault: FaultSpec | None = None) -> float:
    """Paper headline metric: exposed-comm(FIFO) / exposed-comm(PRIORITY).

    Accepts the same knobs as its siblings (`simulate_iteration`,
    `scaling_efficiency`) so the headline can be computed on a hierarchical
    topology, under imperfect async progress, or under injected faults —
    both policies see identical conditions, keeping the ratio fair.
    """
    kw = dict(overlap_eff=overlap_eff, topo=topo, comm_algo=comm_algo,
              fault=fault)
    fifo = simulate_iteration(layers, p, link, Policy.FIFO_OVERLAP, **kw)
    prio = simulate_iteration(layers, p, link, Policy.PRIORITY_OVERLAP, **kw)
    if prio.exposed_comm <= 0:
        return float("inf") if fifo.exposed_comm > 0 else 1.0
    return fifo.exposed_comm / prio.exposed_comm


# --------------------------------------------------------------------------
# Overlap-aware bucket schedule (the CommEngine's microbatch pipeline)
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class BucketScheduleStats:
    """One training step of the engine's per-microbatch exchange."""

    overlap: bool
    n_micro: int
    total_time: float
    compute_time: float          # n_micro * per-microbatch fwd+bwd
    exposed_comm: float          # total - compute
    comm_busy: float             # n_micro * sum(bucket service times)
    timeline: tuple = ()         # SimSpan intervals (record_timeline=True)


def simulate_bucket_schedule(bucket_times: Sequence[float], n_micro: int,
                             micro_compute: float, *, overlap: bool,
                             record_timeline: bool = False
                             ) -> BucketScheduleStats:
    """Estimate one step of the CommEngine's accumulation-scan exchange.

    Mirrors train.trainer exactly: every microbatch's buckets are reduced
    (service times `bucket_times`, one entry per bucket of the EnginePlan);
    with ``overlap=False`` microbatch k+1's compute waits for microbatch k's
    reduction chain (blocking), with ``overlap=True`` the chain is serviced
    by the network (single resource, in priority order) while the next
    microbatches compute, and only the drain past the last microbatch's
    compute is exposed — the modeled counterpart of what
    benchmarks/bench_overlap.py measures on the virtual-device mesh.

    With ``n_micro == 1`` both schedules degrade to reduce-at-end and the
    full chain is exposed, matching the trainer's fallback.

    ``record_timeline=True`` fills ``timeline`` with SimSpan intervals
    (compute per microbatch, comm per bucket message, the end-of-step drain
    as "stall") in the same span format as ``simulate_iteration`` —
    ``obs.trace.export_sim_spans`` renders either.
    """
    comm_per_micro = float(sum(bucket_times))
    compute = n_micro * micro_compute
    timeline = []

    def span(name, cat, start, end, layer=-1):
        if record_timeline and end > start:
            timeline.append(SimSpan(name=name, cat=cat, start=start,
                                    end=end, layer=layer))

    if not overlap or n_micro == 1:
        # blocking: microbatch k+1's compute gates on k's reduction chain
        t = 0.0
        for k in range(n_micro):
            span(f"micro{k}/compute", "compute", t, t + micro_compute)
            t += micro_compute
            for bi, bt in enumerate(bucket_times):
                span(f"micro{k}/bucket{bi}", "comm", t, t + bt, layer=bi)
                t += bt
        total = compute + n_micro * comm_per_micro
    else:
        t_link = 0.0
        for k in range(n_micro):
            span(f"micro{k}/compute", "compute", k * micro_compute,
                 (k + 1) * micro_compute)
            ready = (k + 1) * micro_compute    # bwd of microbatch k done
            for bi, t in enumerate(bucket_times):
                start = max(t_link, ready)
                span(f"micro{k}/bucket{bi}", "comm", start, start + t,
                     layer=bi)
                t_link = start + t
        total = max(compute, t_link)
        # only the chain's drain past the last microbatch's compute is
        # exposed: that wait is the step's stall
        span("drain", "stall", compute, t_link)
    return BucketScheduleStats(overlap=overlap, n_micro=n_micro,
                               total_time=total, compute_time=compute,
                               exposed_comm=total - compute,
                               comm_busy=n_micro * comm_per_micro,
                               timeline=tuple(timeline))


# --------------------------------------------------------------------------
# labeled fault episodes (ground truth for the health monitor)
# --------------------------------------------------------------------------

class _DetJitter:
    """Tiny deterministic multiplicative-noise stream (64-bit LCG).

    The detector benchmark gates precision/recall as STABLE ledger metrics,
    so episode noise must be bit-reproducible across hosts and library
    versions — numpy's generator streams are not guaranteed stable across
    numpy releases, a plain LCG on Python ints is.
    """

    _A = 6364136223846793005
    _C = 1442695040888963407
    _M = (1 << 64) - 1

    def __init__(self, seed: int):
        self._s = ((seed ^ 0x9E3779B97F4A7C15) * self._A + self._C) & self._M

    def uniform(self) -> float:
        """One draw in [-1, 1)."""
        self._s = (self._A * self._s + self._C) & self._M
        return (self._s >> 11) / float(1 << 53) * 2.0 - 1.0

    def factor(self, amplitude: float) -> float:
        """A multiplicative jitter factor in [1 - amplitude, 1 + amplitude)."""
        return 1.0 + amplitude * self.uniform()


@dataclasses.dataclass(frozen=True)
class EpisodeSpec:
    """One deterministic simulated fault episode (telemetry ground truth).

    ``label`` names the alarm the health monitor SHOULD raise ("clean" for
    none): the episode generator replays ``n_steps`` of the engine's bucket
    schedule on ``topo_name``, composing ``fault`` onto the topology from
    ``onset`` onward, and emits records in the telemetry schema
    (repro_torch.obs.telemetry) — so the detector consumes one format
    whether the stream came from a live run or from this generator.

    ``sample_every`` mirrors the driver's bucket-replay sampling knob
    (0 disables bucket_times records entirely — the no-sampling regime where
    only the generic ``step_time_drift`` alarm is reachable).
    """

    name: str
    label: str                    # "clean"|"straggler"|"link_degraded"|
                                  # "step_time_drift"
    fault: FaultSpec = HEALTHY_FAULT
    level: str = ""               # expected link level: "inter" | "intra"
    topo_name: str = "cloud-virtio-sriov"
    nodes: int = 16
    n_steps: int = 60
    onset: int = 20
    sample_every: int = 5
    n_micro: int = 4
    micro_compute: float = 0.2    # seconds of healthy compute per microbatch
    overlap: bool = True
    tokens_per_step: float = 8192.0
    jitter: float = 0.02          # multiplicative measurement noise amplitude
    seed: int = 0

    @property
    def true_factor(self) -> float:
        """The injected degradation factor the detector should estimate, in
        ``hw.Topology.degrade`` convention (straggler >= 1, link bw <= 1)."""
        if self.label == "link_degraded" and self.level == "intra":
            return self.fault.intra_bw_factor
        if self.label == "link_degraded":
            return self.fault.worst_inter_bw_factor
        if self.label in ("straggler", "step_time_drift"):
            return self.fault.compute_slowdown
        return 1.0


def bucket_service_times(bucket_bytes: Sequence[float], algos,
                          nodes: int, topo: hw.Topology, *,
                          wire: str = "fp32", ef: bool = False,
                          fused_quant: bool = True) -> list:
    """Per-bucket allreduce seconds under each bucket's routed algorithm —
    the same hw cost calls as planner.bucket_allreduce_times, inlined here
    so the simulator never imports the planner (which lazily imports this
    module)."""
    out = []
    for nbytes, algo in zip(bucket_bytes, algos):
        if algo == "hier":
            out.append(hw.hier_allreduce_time(nbytes, nodes, topo,
                                              wire_inter=wire, ef=ef,
                                              fused_quant=fused_quant))
        else:
            out.append(hw.flat_allreduce_time(nbytes, nodes, topo, wire=wire,
                                              ef=ef, fused_quant=fused_quant))
    return out


def generate_episode(spec: EpisodeSpec, bucket_bytes: Sequence[float],
                     algos: Sequence[str], *, wire: str = "fp32",
                     ef: bool = False, fused_quant: bool = True) -> list:
    """Replay one labeled fault episode; returns telemetry-schema records.

    Each step runs the engine's bucket schedule (simulate_bucket_schedule)
    with per-bucket service times costed on the healthy topology before
    ``spec.onset`` and on ``spec.fault.apply_to_topology(topo)`` after; a
    straggler stretches the per-microbatch compute. Measured values carry a
    small deterministic multiplicative jitter (``_DetJitter``) so the
    detector's robust statistics are exercised, while the stream stays
    bit-reproducible for the gated precision/recall ledger.

    The first record is a ``meta`` dict (schema_version 1) whose ``run``
    block carries the ground-truth label/onset/factor — the benchmark's
    scoring key. ``repro_torch.obs.telemetry.validate_telemetry`` accepts the
    output verbatim (covered by tests/test_torch_detect.py).
    """
    topo = hw.TOPOLOGIES[spec.topo_name]
    jit = _DetJitter(spec.seed)
    healthy = bucket_service_times(bucket_bytes, algos, spec.nodes, topo,
                                    wire=wire, ef=ef, fused_quant=fused_quant)
    degraded_topo = spec.fault.apply_to_topology(topo)
    degraded = bucket_service_times(bucket_bytes, algos, spec.nodes,
                                     degraded_topo, wire=wire, ef=ef,
                                     fused_quant=fused_quant)
    records = [{
        "kind": "meta", "schema_version": 1, "created_unix": 0.0,
        "sample_every": spec.sample_every,
        "run": {"source": "simulator", "episode": spec.name,
                "label": spec.label, "level": spec.level,
                "topo": spec.topo_name, "nodes": spec.nodes,
                "onset": spec.onset, "true_factor": spec.true_factor,
                "n_buckets": len(list(bucket_bytes))},
    }]
    for step in range(spec.n_steps):
        active = step >= spec.onset
        base = degraded if active else healthy
        slow = spec.fault.compute_slowdown if active else 1.0
        times = [t * jit.factor(spec.jitter) for t in base]
        mc = spec.micro_compute * slow * jit.factor(spec.jitter)
        st = simulate_bucket_schedule(times, spec.n_micro, mc,
                                      overlap=spec.overlap)
        if spec.sample_every > 0 and step % spec.sample_every == 0:
            records.append({"kind": "bucket_times", "step": step,
                            "measured": times, "modeled": list(healthy)})
        exposed = (st.exposed_comm / st.total_time
                   if st.total_time > 0 else 0.0)
        records.append({
            "kind": "step", "step": step, "t_step_s": st.total_time,
            "tok_s": (spec.tokens_per_step / st.total_time
                      if st.total_time > 0 else 0.0),
            "exposed_frac": exposed,
        })
    return records


def layers_from_specs(specs, batch_per_node: int, chip: hw.Chip,
                      bytes_per_elem: float = 4.0) -> list:
    """Turn c2c.LayerSpec shapes into SimLayers using a chip compute model."""
    out = []
    eff_flops = chip.peak_flops * chip.sustained_frac
    for s in specs:
        fwd = s.flops_fwd_per_sample * batch_per_node / eff_flops
        bwd = fwd * s.bwd_flops_factor
        out.append(SimLayer(name=s.name, fwd_time=fwd, bwd_time=bwd,
                            wgrad_bytes=s.weight_elems * bytes_per_elem))
    return out
