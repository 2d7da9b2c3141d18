"""Reduces a profiler trace of a few training steps to what the per-layer
metrics read: every device operation (kernel, copy, set) with its start,
length and the exchange bucket whose `record_function` range launched it,
the benchmark's own host ranges ("data", "step call", "loss sync"), and
the traced window from the first range's start to the last one's end.
Times are microseconds on the profiler's clock."""

from __future__ import annotations

import bisect
import json
import math
import re

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
HOST_RANGES = ("data", "step call", "loss sync")
BUCKET = re.compile(r"^bucket (\d+)$")


def summarize(path: str, steps: int) -> dict:
    """The reduced record of the Chrome trace at `path`."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    events = [e for e in events if e.get("ph") == "X"]
    host = sorted(((e["ts"], e["ts"] + e["dur"], e["name"]) for e in events
                   if e.get("cat") == "user_annotation"
                   and e["name"] in HOST_RANGES), key=lambda r: r[0])
    if not host:
        raise ValueError("the trace holds none of the benchmark's ranges")
    t0, t1 = host[0][0], max(r[1] for r in host)
    # each bucket range, by thread, and each launch's time and thread
    buckets: dict = {}
    for e in events:
        m = BUCKET.match(e.get("name", ""))
        if m and e.get("cat") == "user_annotation":
            buckets.setdefault(e["tid"], []).append(
                (e["ts"], e["ts"] + e["dur"], int(m.group(1))))
    for v in buckets.values():
        v.sort()
    launch = {}
    for e in events:
        if e.get("cat") in LAUNCH_CATS and "correlation" in e.get("args", {}):
            launch[e["args"]["correlation"]] = (e["tid"], e["ts"])
    gpu_ranges = sorted((e["ts"], e["ts"] + e["dur"],
                         int(BUCKET.match(e["name"]).group(1)))
                        for e in events
                        if e.get("cat") == "gpu_user_annotation"
                        and BUCKET.match(e.get("name", "")))
    ops = []
    for e in events:
        if e.get("cat") not in DEVICE_CATS:
            continue
        start, dur = e["ts"], e["dur"]
        if start + dur < t0 or start > t1:
            continue
        b = None
        corr = e.get("args", {}).get("correlation")
        if corr in launch:
            tid, ts = launch[corr]
            b = _inside(buckets.get(tid, ()), ts)
        else:
            b = _inside(gpu_ranges, start)
        ops.append((e["name"], start, dur, b))
    return {"steps": steps, "t0": t0, "t1": t1, "ops": ops,
            "host": host}


def _inside(ranges, t):
    """The bucket of the range in `ranges` (sorted (start, end, bucket))
    that holds time t, else None."""
    i = bisect.bisect_right(ranges, (t, math.inf, math.inf)) - 1
    if i >= 0 and ranges[i][0] <= t <= ranges[i][1]:
        return ranges[i][2]
    return None


def busy_intervals(rec: dict) -> list:
    """The union of the device operations' intervals inside the window."""
    spans = sorted((max(s, rec["t0"]), min(s + d, rec["t1"]))
                   for _, s, d, _ in rec["ops"])
    out = []
    for s, e in spans:
        if e <= s:
            continue
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def busy_us(rec: dict) -> float:
    return sum(e - s for s, e in busy_intervals(rec))


def window_us(rec: dict) -> float:
    return rec["t1"] - rec["t0"]


def top_ops(rec: dict, n: int = 10) -> list:
    """[[kernel name, seconds]] of the n operations with the most device
    time in the window."""
    tot: dict = {}
    for name, _, dur, _ in rec["ops"]:
        tot[name] = tot.get(name, 0.0) + dur
    best = sorted(tot.items(), key=lambda kv: -kv[1])[:n]
    return [[name[:200], us / 1e6] for name, us in best]


def idle_gaps(rec: dict, n: int = 10) -> list:
    """[[host range, seconds]] of the n longest stretches of the window
    with nothing on the device, each named by the benchmark's host range
    open at its middle ("between ranges" where none is)."""
    busy = busy_intervals(rec)
    edges = [rec["t0"]] + [x for iv in busy for x in iv] + [rec["t1"]]
    gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
            if edges[i + 1] > edges[i]]
    out = []
    for s, e in sorted(gaps, key=lambda g: g[0] - g[1])[:n]:
        mid = (s + e) / 2
        name = next((r[2] for r in rec["host"] if r[0] <= mid <= r[1]),
                    "between ranges")
        out.append([name, (e - s) / 1e6])
    return out


def compact(rec: dict) -> dict:
    """What the metric readers take from one rank's record: the window,
    the busy time, the device time inside and outside the exchange's
    bucket ranges, each int8-wire kernel launch as (name, bucket,
    microseconds), and the breakdown's two lists."""
    inside = sum(d for _, _, d, b in rec["ops"] if b is not None)
    return {"steps": rec["steps"], "window_us": window_us(rec),
            "busy_us": busy_us(rec), "bucket_us": inside,
            "other_us": sum(d for _, _, d, _ in rec["ops"]) - inside,
            "quant8": [(n, b, d) for n, _, d, b in rec["ops"]
                       if "quantize_rows" in n],
            "device_ops": top_ops(rec), "idle_gaps": idle_gaps(rec)}
