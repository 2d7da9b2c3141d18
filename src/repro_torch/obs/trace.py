"""Chrome-trace-event timeline writer (Perfetto / chrome://tracing format).

One ``TraceWriter`` collects events from any mix of sources — host-side
``span()`` context managers around real work, measured per-bucket replay
durations, and the simulator's modeled span timeline
(``export_sim_spans``) — and writes a single JSON object file

    {"traceEvents": [...], "displayTimeUnit": "ms", ...}

loadable in https://ui.perfetto.dev. Tracks are labeled through process/
thread metadata events, so a measured mesh run (pid 0) and the modeled
iteration for the same config (pid 1) open side by side in one view — the
visual form of the repo's measured-vs-modeled story.

Timestamps are microseconds. All spans are emitted as complete ("X")
events, which Perfetto nests by containment, so writers never need to
balance begin/end pairs; ``validate_trace`` still checks "B"/"E" balance
for externally produced event lists.

Ports `repro/obs/trace.py`, writing the same schema. It imports nothing of
``repro_torch`` (core modules may import it without cycles). Each host span
also runs inside ``torch.profiler.record_function``, so it lands in a
``torch.profiler`` trace taken around the same run, where the reference
wraps it in ``jax.profiler.TraceAnnotation``.
"""

from __future__ import annotations

import contextlib
import json
import time
from typing import Iterable, Optional

import torch

# microseconds per second: Chrome trace ts/dur are in us
_US = 1e6


class TraceWriter:
    """Collects Chrome trace events; `write()` emits the JSON object file."""

    def __init__(self, *, clock=time.perf_counter):
        self.events: list = []
        self._clock = clock
        self._t0 = clock()
        self._named_tracks: set = set()

    # -- clock --------------------------------------------------------------

    def now_us(self) -> float:
        """Wall-clock microseconds since this writer was created."""
        return (self._clock() - self._t0) * _US

    # -- raw events ---------------------------------------------------------

    def complete(self, name: str, ts_us: float, dur_us: float, *,
                 pid: int = 0, tid: int = 0, cat: str = "",
                 args: Optional[dict] = None) -> None:
        """One complete ("X") span event at an explicit time."""
        ev = {"name": name, "ph": "X", "ts": float(ts_us),
              "dur": max(float(dur_us), 0.0), "pid": pid, "tid": tid}
        if cat:
            ev["cat"] = cat
        if args:
            ev["args"] = args
        self.events.append(ev)

    def counter(self, name: str, ts_us: float, values: dict, *,
                pid: int = 0, tid: int = 0) -> None:
        """One counter ("C") sample: Perfetto renders each key of `values`
        as a series on the `name` counter track — e.g.
        ``counter("rates", ts, {"tokens_per_sec": 1.2e4})`` gives the rate
        timeline next to the span rows. Values must be numeric."""
        self.events.append({"name": name, "ph": "C", "ts": float(ts_us),
                            "pid": pid, "tid": tid,
                            "args": {k: float(v) for k, v in values.items()}})

    def instant(self, name: str, ts_us: float, *, pid: int = 0,
                tid: int = 0, cat: str = "") -> None:
        ev = {"name": name, "ph": "i", "ts": float(ts_us), "s": "t",
              "pid": pid, "tid": tid}
        if cat:
            ev["cat"] = cat
        self.events.append(ev)

    def name_process(self, pid: int, name: str) -> None:
        """Label a track group (Perfetto shows this as the process name)."""
        if ("p", pid) in self._named_tracks:
            return
        self._named_tracks.add(("p", pid))
        self.events.append({"name": "process_name", "ph": "M", "pid": pid,
                            "tid": 0, "args": {"name": name}})

    def name_thread(self, pid: int, tid: int, name: str) -> None:
        if ("t", pid, tid) in self._named_tracks:
            return
        self._named_tracks.add(("t", pid, tid))
        self.events.append({"name": "thread_name", "ph": "M", "pid": pid,
                            "tid": tid, "args": {"name": name}})

    # -- host-side spans ----------------------------------------------------

    @contextlib.contextmanager
    def span(self, name: str, *, pid: int = 0, tid: int = 0, cat: str = "",
             args: Optional[dict] = None):
        """Measure a host-side region: ``with writer.span("bucket3/inter")``.

        Nested spans nest in the viewer (containment of "X" events). The
        region is also a ``torch.profiler.record_function`` range, so it
        appears in a profiler trace taken around the same run.
        """
        t0 = self.now_us()
        with torch.profiler.record_function(name):
            try:
                yield self
            finally:
                self.complete(name, t0, self.now_us() - t0, pid=pid,
                              tid=tid, cat=cat, args=args)

    # -- output -------------------------------------------------------------

    def to_json(self) -> dict:
        return {"traceEvents": list(self.events), "displayTimeUnit": "ms"}

    def write(self, path: str) -> str:
        obj = self.to_json()
        validate_trace(obj)
        with open(path, "w") as fh:
            json.dump(obj, fh, indent=1)
            fh.write("\n")
        return path


# --------------------------------------------------------------------------
# modeled-timeline export (core.simulator span timelines)
# --------------------------------------------------------------------------

# one viewer row per span category, in a stable order
_CAT_TIDS = {"compute": 0, "comm": 1, "stall": 2}


def export_sim_spans(spans: Iterable, writer: TraceWriter, *, pid: int = 1,
                     track: str = "modeled", t0_us: float = 0.0) -> int:
    """Export a simulator span timeline into `writer`.

    `spans` is any iterable of objects with ``name`` / ``cat`` / ``start`` /
    ``end`` attributes and times in SECONDS (``simulator.SimSpan``:
    ``IterationStats.timeline`` / ``BucketScheduleStats.timeline`` with
    ``record_timeline=True``). Events land on `pid` with one thread row per
    category (compute / comm / stall), offset by `t0_us` so a modeled
    iteration can be laid next to a measured one. Returns the number of
    span events written.
    """
    writer.name_process(pid, track)
    n = 0
    for s in spans:
        tid = _CAT_TIDS.get(s.cat, len(_CAT_TIDS))
        writer.name_thread(pid, tid, s.cat)
        writer.complete(s.name, t0_us + s.start * _US,
                        (s.end - s.start) * _US, pid=pid, tid=tid, cat=s.cat)
        n += 1
    return n


# --------------------------------------------------------------------------
# loading / validation (tests and post-run assertions)
# --------------------------------------------------------------------------

def load_trace(path: str) -> dict:
    with open(path) as fh:
        obj = json.load(fh)
    validate_trace(obj)
    return obj


def validate_trace(obj) -> None:
    """Raise ValueError unless `obj` is a well-formed Chrome trace object:
    a JSON object whose ``traceEvents`` is a list of events with the
    required phase fields, non-negative "X" durations, numeric-valued "C"
    counter samples, and balanced "B"/"E" pairs per (pid, tid) track."""
    if not isinstance(obj, dict) or not isinstance(
            obj.get("traceEvents"), list):
        raise ValueError("trace must be an object with a traceEvents list")
    depth: dict = {}
    for ev in obj["traceEvents"]:
        if not isinstance(ev, dict) or "ph" not in ev or "name" not in ev:
            raise ValueError(f"malformed event: {ev!r}")
        ph = ev["ph"]
        if ph == "M":
            continue
        if "ts" not in ev or not isinstance(ev["ts"], (int, float)):
            raise ValueError(f"event missing numeric ts: {ev!r}")
        key = (ev.get("pid", 0), ev.get("tid", 0))
        if ph == "X":
            if not isinstance(ev.get("dur"), (int, float)) or ev["dur"] < 0:
                raise ValueError(f"X event needs dur >= 0: {ev!r}")
        elif ph == "C":
            args = ev.get("args")
            if not isinstance(args, dict) or not args or not all(
                    isinstance(v, (int, float)) and not isinstance(v, bool)
                    for v in args.values()):
                raise ValueError(
                    f"C event needs numeric args series: {ev!r}")
        elif ph == "B":
            depth[key] = depth.get(key, 0) + 1
        elif ph == "E":
            depth[key] = depth.get(key, 0) - 1
            if depth[key] < 0:
                raise ValueError(f"unbalanced E event on track {key}")
    bad = {k: v for k, v in depth.items() if v != 0}
    if bad:
        raise ValueError(f"unbalanced B/E spans on tracks {bad}")
