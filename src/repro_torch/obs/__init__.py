"""Observability: MLSL-style comm stats, Chrome-trace timelines, step meter,
streaming telemetry and the online health monitor.

Ports `repro/obs/`. MLSL's proof points (paper §4) are per-message
statistics — bytes, algorithm, exposed vs overlapped time — that only the
library owning the exchange can produce. This subpackage is that
accounting layer for the port:

  repro_torch.obs.trace  -- Chrome-trace-event (Perfetto-compatible) writer
                      with host-side span helpers (each also a
                      torch.profiler.record_function range) and an exporter
                      for the simulator's modeled span timeline, so a
                      measured run and a modeled iteration open side by
                      side in one Perfetto view.
  repro_torch.obs.stats  -- CommStats: the per-bucket wire-byte / route /
                      modeled-vs-measured-time report derived from an
                      EnginePlan (surfaced as EnginePlan.describe() /
                      CommEngine.stats() and serialized into the
                      perf-ledger schema), and BucketTimer, the collective
                      per-bucket replay that measures the engine's own data
                      path on every rank.
  repro_torch.obs.meter  -- StepMeter: step-time EMA, tokens/sec,
                      loss/grad-norm tracking for the train/serve drivers
                      (--stats).
  repro_torch.obs.telemetry -- streaming schema-versioned JSONL event log
                      (step time, sampled per-bucket reduce times, tok/s,
                      alarms) cheap enough to leave on for a whole run.
  repro_torch.obs.detect -- HealthMonitor: online measured-vs-modeled
                      residual tracking with EWMA/robust-z detectors
                      classifying sustained drift into typed alarms
                      (straggler / link_degraded / step_time_drift), each
                      carrying a Topology.degrade-ready factor estimate and
                      a "would re-route K buckets" reaction hook through the
                      port's planner.

Layering: trace.py, meter.py and telemetry.py depend on nothing in
repro_torch (core modules may emit their schemas without a cycle); stats.py
and detect.py sit ABOVE repro_torch.core (core reaches them only through
lazy imports). Nothing here imports JAX or the reference package.
"""
