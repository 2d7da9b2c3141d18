"""Streaming per-step telemetry: a schema-versioned JSONL event log.

A copy of `repro/obs/telemetry.py`, writing the same schema.

MLSL exposes internal statistics so operators can watch a run *while it
executes* — the post-mortem CommStats table (obs.stats) is not enough
when the question is "did step 4000 stop matching the model?". This module
is the streaming channel: one JSON object per line, flushed as written, so a
`tail -f` (or the online health monitor, obs.detect) sees each step
as it lands and a killed run keeps everything it logged.

Record kinds (``SCHEMA_VERSION = 1``):

  * ``meta``          -- first line: schema version, creation time, free-form
    ``run`` info (config echo), the bucket-replay ``sample_every`` knob;
  * ``step``          -- one per training/decode step: ``step``,
    ``t_step_s`` (wall seconds), optional ``tok_s`` / ``loss`` /
    ``exposed_frac`` (the step meter's modeled exposed-comm share);
  * ``bucket_times``  -- sampled every N steps: per-bucket ``measured``
    reduce seconds (obs.stats.BucketTimer standalone replay) beside the
    ``modeled`` hw.Topology costs, the residual stream the detector watches;
  * ``alarm``         -- a typed health alarm (obs.detect.Alarm):
    ``alarm`` {kind, factor, level, rank, detail} at ``step``.

Cheap enough to leave on: a step record is ~100 bytes of host-side JSON and
the per-bucket replay is *sampled* (default every 25 steps, 0 disables), so
the hot step path is never perturbed — the meter times only the step
function, and the replay runs between steps.

This module imports nothing of ``repro_torch`` (same rule as
``obs.trace``): the simulator's labeled episode generator
(``core.simulator.generate_episode``) emits plain dicts in this
schema without a dependency edge, and ``validate_telemetry`` is the single
contract both sides are tested against.
"""

from __future__ import annotations

import json
import time
from typing import Optional, Sequence

SCHEMA_VERSION = 1

KIND_META = "meta"
KIND_STEP = "step"
KIND_BUCKET_TIMES = "bucket_times"
KIND_ALARM = "alarm"

# default bucket-replay sampling period (steps); 0 disables the replay
DEFAULT_SAMPLE_EVERY = 25


class TelemetryWriter:
    """Appends schema-v1 JSONL records to `path`, one flushed line each.

    Usage::

        with TelemetryWriter(path, run_info={...}, sample_every=25) as tel:
            tel.step(step=s, t_step_s=dt, tok_s=..., loss=...)
            if tel.should_sample(s):
                tel.bucket_times(s, measured, modeled=modeled)
            tel.alarm(step=s, kind="straggler", factor=1.5)
    """

    def __init__(self, path: str, *, run_info: Optional[dict] = None,
                 sample_every: int = DEFAULT_SAMPLE_EVERY):
        self.path = path
        self.sample_every = int(sample_every)
        self.n_records = 0
        self._fh = open(path, "w")
        self._emit({"kind": KIND_META, "schema_version": SCHEMA_VERSION,
                    "created_unix": time.time(),
                    "sample_every": self.sample_every,
                    "run": dict(run_info or {})})

    # -- record emission -----------------------------------------------------

    def _emit(self, rec: dict) -> None:
        json.dump(rec, self._fh)
        self._fh.write("\n")
        self._fh.flush()          # tail -f / crash durability per record
        self.n_records += 1

    def step(self, *, step: int, t_step_s: float,
             tok_s: Optional[float] = None, loss: Optional[float] = None,
             exposed_frac: Optional[float] = None) -> None:
        rec = {"kind": KIND_STEP, "step": int(step),
               "t_step_s": float(t_step_s)}
        if tok_s is not None:
            rec["tok_s"] = float(tok_s)
        if loss is not None:
            rec["loss"] = float(loss)
        if exposed_frac is not None:
            rec["exposed_frac"] = float(exposed_frac)
        self._emit(rec)

    def bucket_times(self, step: int, measured: Optional[Sequence] = None,
                     *, modeled: Optional[Sequence] = None) -> None:
        """Sampled per-bucket reduce seconds; either column may be absent
        (the dry-run logs modeled-only, a replay without a cost model logs
        measured-only), but not both."""
        rec: dict = {"kind": KIND_BUCKET_TIMES, "step": int(step)}
        if measured is not None:
            rec["measured"] = [float(t) for t in measured]
        if modeled is not None:
            rec["modeled"] = [float(t) for t in modeled]
        if "measured" not in rec and "modeled" not in rec:
            raise ValueError("bucket_times needs measured and/or modeled")
        self._emit(rec)

    def alarm(self, *, step: int, kind: str, factor: float,
              level: str = "", rank: int = -1, detail: str = "") -> None:
        self._emit({"kind": KIND_ALARM, "step": int(step),
                    "alarm": {"kind": str(kind), "factor": float(factor),
                              "level": str(level), "rank": int(rank),
                              "detail": str(detail)}})

    # -- sampling ------------------------------------------------------------

    def should_sample(self, step: int) -> bool:
        """Is `step` a bucket-replay sampling step? Step 0 always samples
        (the detector's healthy baseline needs at least one warm-up sample);
        ``sample_every <= 0`` disables the replay entirely."""
        if self.sample_every <= 0:
            return False
        return step % self.sample_every == 0

    # -- lifecycle -----------------------------------------------------------

    def close(self) -> None:
        if self._fh is not None:
            self._fh.close()
            self._fh = None

    def __enter__(self) -> "TelemetryWriter":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


# ---------------------------------------------------------------------------
# loading / validation (the round-trip contract)
# ---------------------------------------------------------------------------

def load_telemetry(path: str) -> list:
    """Parse + validate a telemetry JSONL file into a list of record dicts."""
    events = []
    with open(path) as fh:
        for ln, line in enumerate(fh, 1):
            line = line.strip()
            if not line:
                continue
            try:
                events.append(json.loads(line))
            except json.JSONDecodeError as e:
                raise ValueError(f"{path}:{ln}: not JSON: {e}") from e
    validate_telemetry(events)
    return events


def _require_num(rec: dict, key: str) -> None:
    if not isinstance(rec.get(key), (int, float)) \
            or isinstance(rec.get(key), bool):
        raise ValueError(f"record needs numeric {key!r}: {rec!r}")


def validate_telemetry(events: Sequence) -> None:
    """Raise ValueError unless `events` is a well-formed schema-v1 stream:
    a leading ``meta`` record with a supported ``schema_version``, then
    ``step`` / ``bucket_times`` / ``alarm`` records with their required
    fields. Unknown kinds are rejected (a version bump must be explicit)."""
    if not events:
        raise ValueError("empty telemetry stream (missing meta record)")
    head = events[0]
    if not isinstance(head, dict) or head.get("kind") != KIND_META:
        raise ValueError(f"first record must be kind=meta: {head!r}")
    ver = head.get("schema_version")
    if not isinstance(ver, int) or ver < 1 or ver > SCHEMA_VERSION:
        raise ValueError(f"unsupported schema_version {ver!r} "
                         f"(supported: 1..{SCHEMA_VERSION})")
    for rec in events[1:]:
        if not isinstance(rec, dict):
            raise ValueError(f"record must be an object: {rec!r}")
        kind = rec.get("kind")
        if kind == KIND_STEP:
            _require_num(rec, "step")
            _require_num(rec, "t_step_s")
        elif kind == KIND_BUCKET_TIMES:
            _require_num(rec, "step")
            cols = [c for c in ("measured", "modeled") if c in rec]
            if not cols:
                raise ValueError(
                    f"bucket_times needs measured and/or modeled: {rec!r}")
            for col in cols:
                vals = rec[col]
                if not isinstance(vals, list) or not all(
                        isinstance(t, (int, float)) and t >= 0
                        for t in vals):
                    raise ValueError(
                        f"bucket_times {col} must be a list of non-negative "
                        f"numbers: {rec!r}")
        elif kind == KIND_ALARM:
            _require_num(rec, "step")
            al = rec.get("alarm")
            if not isinstance(al, dict) or not isinstance(
                    al.get("kind"), str):
                raise ValueError(f"alarm record needs alarm.kind: {rec!r}")
            _require_num(al, "factor")
        elif kind == KIND_META:
            raise ValueError("duplicate meta record (one stream, one meta)")
        else:
            raise ValueError(f"unknown record kind {kind!r}: {rec!r}")
