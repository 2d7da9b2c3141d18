"""Online health monitor: measured-vs-modeled residual drift -> typed alarms.

A copy of `repro/obs/detect.py` on the port's simulator, cost model and
planner.

Keuper & Pfreundt (arXiv:1609.06870) show the gap between modeled and
achieved communication time IS the scaling limit at scale — so the gap must
be watched continuously. This module closes the loop between the exact
per-bucket byte/time accounting (obs.stats) and fault injection
(core.simulator.FaultSpec): a
``HealthMonitor`` consumes the telemetry stream (obs.telemetry) a live
run or a simulated episode produces, maintains rolling residuals of
measured vs ``hw.Topology``-modeled time, and classifies *sustained* drift
into typed alarms:

  * ``straggler``        -- step time drifted while the sampled per-bucket
    reduce times stayed on model: the fabric is healthy, a node's compute
    is not. Factor estimate: the compute slowdown ``s >= 1``.
  * ``link_degraded``    -- the per-bucket reduce times drifted. The monitor
    fits the drift against degradation hypotheses generated by the SAME cost
    model the router uses (``topo.degrade(level_bw=f)`` for each level and a
    factor grid), picking the (level, factor) whose predicted per-bucket
    ratios best explain the observed ones — small latency-bound buckets and
    bulk volume-bound buckets drift differently per level, which is exactly
    the signature that separates an intra fault from an inter fault.
  * ``step_time_drift``  -- step time drifted but bucket sampling is off
    (no residual stream to classify against): the generic alarm.

Every alarm carries a degradation-factor estimate in ``Topology.degrade``
convention, so ``HealthMonitor.reroute(alarm)`` can feed it straight back
into the cost model and re-run the per-bucket flat-vs-hier routing
(``planner.choose_allreduce_algo``) — reporting "would re-route K buckets",
the detection-to-reaction hook the ROADMAP's elastic-membership item needs.

Detection is EWMA + robust-z: ratios to a warm-up baseline are smoothed
with a bias-corrected EWMA, scored against a MAD-derived scale (floored, so
a noiseless deterministic stream cannot produce infinite z), and must stay
past the relative threshold for ``sustain`` consecutive observations before
anything fires — warm-up steps NEVER alarm, and recovery re-arms the
detector. ``DetectorConfig.wallclock()`` is the de-tuned preset the live
drivers use (CPU wall clocks jitter far more than the simulator's 2%).

Validated against the fault harness as labeled ground truth: the episodes
of ``benchmarks/bench_detect.py`` (``simulator.generate_episode``), run
through this module, give the reference's alarms
(tests/test_torch_detect.py).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Sequence

from repro_torch.core import hw
from repro_torch.core import planner as planner_lib
from repro_torch.core import simulator as sim

ALARM_STRAGGLER = "straggler"
ALARM_LINK_DEGRADED = "link_degraded"
ALARM_STEP_DRIFT = "step_time_drift"
ALARM_KINDS = (ALARM_STRAGGLER, ALARM_LINK_DEGRADED, ALARM_STEP_DRIFT)

LEVEL_INTER = "inter"
LEVEL_INTRA = "intra"


@dataclasses.dataclass(frozen=True)
class Alarm:
    """One typed health alarm.

    ``factor`` is in ``hw.Topology.degrade`` convention: a compute slowdown
    ``>= 1`` for straggler/step_time_drift, a link bandwidth factor
    ``<= 1`` for link_degraded (on ``level``). ``rank`` is the suspected
    straggler rank when the telemetry identifies one (-1: unknown — the
    single-stream channel sees the critical path, not identities).
    """

    kind: str
    step: int
    factor: float
    level: str = ""
    rank: int = -1
    detail: str = ""

    def degrade_kwargs(self) -> dict:
        """The ``Topology.degrade`` keywords this alarm's estimate maps to."""
        if self.kind == ALARM_LINK_DEGRADED:
            key = "intra_bw" if self.level == LEVEL_INTRA else "inter_bw"
            return {key: min(self.factor, 1.0)}
        return {"straggler": max(self.factor, 1.0)}

    def describe(self) -> str:
        lvl = f"{self.level}, " if self.level else ""
        who = f" rank={self.rank}" if self.rank >= 0 else ""
        return (f"[step {self.step}] {self.kind}({lvl}factor~{self.factor:.2f})"
                f"{who}" + (f": {self.detail}" if self.detail else ""))


@dataclasses.dataclass(frozen=True)
class DetectorConfig:
    """Detection thresholds. Defaults are tuned for the deterministic
    simulated episodes (2% jitter); live drivers should use ``wallclock()``.
    """

    warmup_steps: int = 10        # observations that only calibrate
    ewma_decay: float = 0.5       # ratio EWMA decay (bias-corrected)
    step_rel_threshold: float = 0.12   # step ratio drift floor (relative)
    bucket_rel_threshold: float = 0.15  # per-bucket ratio drift floor
    z_threshold: float = 3.0      # robust-z gate on top of the rel floor
    scale_floor: float = 0.02     # MAD scale floor (relative) — finite z
    step_sustain: int = 3         # consecutive drifted steps before firing
    link_sustain: int = 2         # consecutive drifted bucket samples
    min_drift_byte_frac: float = 0.25  # drifted buckets must carry this
    factor_grid: tuple = tuple(round(0.05 * i, 2) for i in range(1, 20))

    @classmethod
    def wallclock(cls) -> "DetectorConfig":
        """De-tuned preset for live wall-clock streams: CPU step times and
        replayed bucket times jitter tens of percent across hosts, so only
        gross sustained drift should page anyone."""
        return cls(step_rel_threshold=1.0, bucket_rel_threshold=1.5,
                   scale_floor=0.25, step_sustain=5, link_sustain=3)


@dataclasses.dataclass(frozen=True)
class RerouteReport:
    """What re-running the bucket router under an alarm's estimate changes."""

    alarm: Alarm
    topo_name: str
    old_algos: tuple
    new_algos: tuple

    @property
    def n_changed(self) -> int:
        return sum(o != n for o, n in zip(self.old_algos, self.new_algos))

    def summary(self) -> str:
        n = len(self.old_algos)
        if n == 0:
            return "no bucket plan to re-route"
        if self.n_changed == 0:
            return f"routing still optimal ({n} buckets unchanged)"
        to_hier = sum(o == "flat" and nw == "hier"
                      for o, nw in zip(self.old_algos, self.new_algos))
        to_flat = self.n_changed - to_hier
        moves = []
        if to_hier:
            moves.append(f"flat->hier {to_hier}")
        if to_flat:
            moves.append(f"hier->flat {to_flat}")
        return (f"would re-route {self.n_changed}/{n} buckets "
                f"({', '.join(moves)}) on {self.topo_name}")


class _Ewma:
    """Bias-corrected EWMA of a ratio stream (starts reporting the first
    value exactly, converges to the plain EWMA)."""

    def __init__(self, decay: float):
        self.decay = decay
        self._acc = 0.0
        self.n = 0

    def update(self, x: float) -> float:
        self._acc = self.decay * self._acc + (1 - self.decay) * x
        self.n += 1
        return self.value

    @property
    def value(self) -> float:
        if self.n == 0:
            return 0.0
        return self._acc / (1 - self.decay ** self.n)


def _median(vals: Sequence[float]) -> float:
    s = sorted(vals)
    n = len(s)
    if n == 0:
        return 0.0
    return s[n // 2] if n % 2 else 0.5 * (s[n // 2 - 1] + s[n // 2])


class HealthMonitor:
    """Rolling measured-vs-modeled residual tracking over one run's stream.

    Feed it ``observe_step`` once per step and ``observe_bucket_times``
    whenever the sampled per-bucket replay ran; both return the alarms that
    newly fired (edge-triggered: an active condition alarms once, recovery
    re-arms it). ``replay(events)`` drives both from a telemetry record list.

    The first ``config.warmup_steps`` step observations only calibrate the
    baselines (median step time, median per-bucket reduce time, the modeled
    exposed-comm share) and can never alarm.

    Built either directly from the bucket model (``bucket_bytes`` +
    ``algos`` + ``nodes`` + ``topo``) or from an ``EnginePlan`` via
    ``from_plan`` — the same derivation ``obs.stats.CommStats`` uses, so
    detector residuals and the stats table share one cost model. With no
    bucket model (``bucket_bytes=()``, e.g. the gspmd driver or the serve
    decode loop), only the generic ``step_time_drift`` alarm is reachable.
    """

    def __init__(self, *, bucket_bytes: Sequence[float] = (),
                 algos: Sequence[str] = (), nodes: int = 1,
                 topo: Optional[hw.Topology] = None, wire: str = "fp32",
                 ef: bool = False, fused_quant: bool = True,
                 config: Optional[DetectorConfig] = None):
        if isinstance(topo, str):
            topo = hw.TOPOLOGIES[topo]
        self.topo = topo or hw.CLOUD_10G
        self.bucket_bytes = tuple(float(b) for b in bucket_bytes)
        self.algos = tuple(algos)
        assert len(self.algos) == len(self.bucket_bytes)
        self.nodes = nodes
        self.wire = wire
        self.ef = ef
        self.fused_quant = fused_quant
        self.config = config or DetectorConfig()
        # healthy modeled per-bucket service times (the residual denominator
        # hypotheses are expressed against)
        self.t_model = tuple(sim.bucket_service_times(
            self.bucket_bytes, self.algos, nodes, self.topo, wire=wire,
            ef=ef, fused_quant=fused_quant))
        self.alarms: list = []

        # -- step-time state --
        self._n_steps = 0
        self._warm_steps: list = []
        self._warm_exposed: list = []
        self.baseline_step: Optional[float] = None
        self._step_scale = self.config.scale_floor
        self._exposed_base: Optional[float] = None
        self._step_ewma = _Ewma(self.config.ewma_decay)
        self._step_drift_count = 0
        self._step_drift_sum = 0.0

        # -- bucket state --
        self.sampling_seen = False
        self._warm_buckets: list = []
        self.baseline_buckets: Optional[tuple] = None
        self._bucket_ewmas = [_Ewma(self.config.ewma_decay)
                              for _ in self.bucket_bytes]
        self._bucket_drift_count = 0
        self._bucket_drift_sums = [0.0] * len(self.bucket_bytes)

        self._active: set = set()      # {(kind, level)} currently firing

    @classmethod
    def from_plan(cls, plan, *, topo=None,
                  config: Optional[DetectorConfig] = None) -> "HealthMonitor":
        """Build from an engine.EnginePlan (same topology/node recovery as
        CommStats.from_plan). Non-fusable buckets reduce per-leaf on the
        flat path regardless of their routed algo, so their model follows."""
        if topo is None:
            topo = getattr(plan, "topo", None) or hw.CLOUD_10G
        if isinstance(topo, str):
            topo = hw.TOPOLOGIES[topo]
        nodes = plan.n_node if plan.n_node > 1 else max(
            1, plan.dp // topo.local_size)
        algos = tuple(a if plan.fusable[bi] else "flat"
                      for bi, a in enumerate(plan.algos))
        return cls(bucket_bytes=plan.bucket_bytes_list(), algos=algos,
                   nodes=nodes, topo=topo, wire=plan.wire, ef=plan.use_ef,
                   fused_quant=plan.fused_quant, config=config)

    # -- internals ----------------------------------------------------------

    @property
    def in_warmup(self) -> bool:
        return self._n_steps < self.config.warmup_steps

    def _fire(self, alarm: Alarm) -> list:
        key = (alarm.kind, alarm.level)
        if key in self._active:
            return []
        self._active.add(key)
        self.alarms.append(alarm)
        return [alarm]

    def _clear(self, kind: str, level: str = "") -> None:
        self._active.discard((kind, level))

    def _finalize_step_baseline(self) -> None:
        cfg = self.config
        med = _median(self._warm_steps)
        self.baseline_step = med if med > 0 else None
        if self.baseline_step:
            mad = _median([abs(t - med) for t in self._warm_steps]) / med
            self._step_scale = max(mad, cfg.scale_floor)
        if self._warm_exposed:
            self._exposed_base = (sum(self._warm_exposed)
                                  / len(self._warm_exposed))

    # -- observations -------------------------------------------------------

    def observe_step(self, step: int, t_step_s: float, *,
                     exposed_frac: Optional[float] = None) -> list:
        """One step's wall time (+ optional modeled exposed-comm share).
        Returns alarms that newly fired on this observation."""
        cfg = self.config
        self._n_steps += 1
        if self._n_steps <= cfg.warmup_steps:
            self._warm_steps.append(t_step_s)
            if exposed_frac is not None:
                self._warm_exposed.append(exposed_frac)
            if self._n_steps == cfg.warmup_steps:
                self._finalize_step_baseline()
            return []
        if self.baseline_step is None:      # degenerate all-zero warmup
            self.baseline_step = t_step_s if t_step_s > 0 else None
            return []
        ratio = t_step_s / self.baseline_step
        smoothed = self._step_ewma.update(ratio)
        z = (smoothed - 1.0) / self._step_scale
        drifted = (smoothed > 1.0 + cfg.step_rel_threshold
                   and z >= cfg.z_threshold)
        if drifted:
            self._step_drift_count += 1
            self._step_drift_sum += ratio
        else:
            self._step_drift_count = 0
            self._step_drift_sum = 0.0
            self._clear(ALARM_STEP_DRIFT)
            self._clear(ALARM_STRAGGLER)
        if self.sampling_seen:
            # with a residual stream available, step drift is classified at
            # the next bucket sample (straggler vs link) — never here
            return []
        if self._step_drift_count >= cfg.step_sustain:
            mean_ratio = self._step_drift_sum / self._step_drift_count
            return self._fire(Alarm(
                kind=ALARM_STEP_DRIFT, step=step, factor=mean_ratio,
                detail=f"step time {mean_ratio:.2f}x baseline, bucket "
                       "sampling off — enable --telemetry-sample to classify"))
        return []

    def observe_bucket_times(self, step: int, measured: Sequence[float]
                             ) -> list:
        """One sampled per-bucket replay. Returns alarms that newly fired."""
        cfg = self.config
        self.sampling_seen = True
        if not self.bucket_bytes or len(measured) != len(self.bucket_bytes):
            return []
        if self.in_warmup:
            self._warm_buckets.append(tuple(float(t) for t in measured))
            return []
        if self.baseline_buckets is None:
            warm = self._warm_buckets or [tuple(float(t) for t in measured)]
            self.baseline_buckets = tuple(
                _median([s[i] for s in warm])
                for i in range(len(self.bucket_bytes)))
            if not self._warm_buckets:
                return []       # first sample became the baseline
        ratios = []
        for i, t in enumerate(measured):
            base = self.baseline_buckets[i]
            ratios.append(t / base if base > 0 else 1.0)
        drifted_bytes = 0.0
        for i, r in enumerate(ratios):
            smoothed = self._bucket_ewmas[i].update(r)
            z = (smoothed - 1.0) / cfg.scale_floor
            if smoothed > 1.0 + cfg.bucket_rel_threshold \
                    and z >= cfg.z_threshold:
                drifted_bytes += self.bucket_bytes[i]
        total = sum(self.bucket_bytes)
        drift = total > 0 and drifted_bytes >= cfg.min_drift_byte_frac * total
        if drift:
            self._bucket_drift_count += 1
            for i, r in enumerate(ratios):
                self._bucket_drift_sums[i] += r
        else:
            self._bucket_drift_count = 0
            self._bucket_drift_sums = [0.0] * len(self.bucket_bytes)
            self._clear(ALARM_LINK_DEGRADED, LEVEL_INTER)
            self._clear(ALARM_LINK_DEGRADED, LEVEL_INTRA)

        if drift and self._bucket_drift_count >= cfg.link_sustain:
            mean_ratios = [s / self._bucket_drift_count
                           for s in self._bucket_drift_sums]
            level, factor, resid = self._fit_link(mean_ratios)
            return self._fire(Alarm(
                kind=ALARM_LINK_DEGRADED, step=step, factor=factor,
                level=level,
                detail=(f"{level} bw at ~{factor:.2f}x healthy "
                        f"(fit residual {resid:.3f})")))
        if not drift and self._step_drift_count >= cfg.step_sustain \
                and (ALARM_LINK_DEGRADED, LEVEL_INTER) not in self._active \
                and (ALARM_LINK_DEGRADED, LEVEL_INTRA) not in self._active:
            # sustained step drift with on-model bucket times: compute-side
            # straggler. Scale the step drift by the compute share of the
            # step (1 - warm-up exposed-comm share) to estimate the slowdown.
            mean_ratio = self._step_drift_sum / self._step_drift_count
            phi = 1.0 - (self._exposed_base or 0.0)
            phi = min(max(phi, 0.05), 1.0)
            s_hat = 1.0 + (mean_ratio - 1.0) / phi
            return self._fire(Alarm(
                kind=ALARM_STRAGGLER, step=step, factor=s_hat,
                detail=(f"step time {mean_ratio:.2f}x baseline, bucket "
                        f"reduce times on model (compute share {phi:.2f})")))
        return []

    def _fit_link(self, observed_ratios: Sequence[float]) -> tuple:
        """Fit (level, bw_factor) whose cost-model-predicted per-bucket
        service-time ratios best explain the observed ones (least squares
        in log space). Returns (level, factor, residual)."""
        obs = [math.log(max(r, 1e-9)) for r in observed_ratios]
        best = None
        for level in (LEVEL_INTER, LEVEL_INTRA):
            for f in self.config.factor_grid:
                kw = {f"{level}_bw": f}
                deg = self.topo.degrade(**kw)
                pred_t = sim.bucket_service_times(
                    self.bucket_bytes, self.algos, self.nodes, deg,
                    wire=self.wire, ef=self.ef, fused_quant=self.fused_quant)
                pred = [math.log(max(pt / bt, 1e-9)) if bt > 0 else 0.0
                        for pt, bt in zip(pred_t, self.t_model)]
                sse = sum((o - p) ** 2 for o, p in zip(obs, pred))
                if best is None or sse < best[0]:
                    best = (sse, level, f)
        sse, level, f = best
        resid = math.sqrt(sse / max(len(obs), 1))
        return level, f, resid

    # -- stream driving ------------------------------------------------------

    def replay(self, events: Sequence[dict]) -> list:
        """Drive the monitor from a telemetry record list (live file or
        simulator episode); returns every alarm that fired."""
        fired = []
        for rec in events:
            kind = rec.get("kind")
            if kind == "step":
                fired += self.observe_step(
                    rec["step"], rec["t_step_s"],
                    exposed_frac=rec.get("exposed_frac"))
            elif kind == "bucket_times" and "measured" in rec:
                fired += self.observe_bucket_times(rec["step"],
                                                   rec["measured"])
        return fired

    # -- reaction hook -------------------------------------------------------

    def reroute(self, alarm: Alarm) -> RerouteReport:
        """Re-run the per-bucket flat-vs-hier routing on the topology
        degraded by this alarm's factor estimate: the "would re-route K
        buckets" report. (A straggler estimate degrades only compute, so
        its report legitimately says the routing is unchanged.)"""
        deg = self.topo.degrade(**alarm.degrade_kwargs())
        new = tuple(
            planner_lib.choose_allreduce_algo(
                nb, self.nodes, deg, wire=self.wire, ef=self.ef,
                fused_quant=self.fused_quant)
            for nb in self.bucket_bytes)
        return RerouteReport(alarm=alarm, topo_name=self.topo.name,
                             old_algos=self.algos, new_algos=new)
