"""The port's trace writer and step meter (repro_torch.obs.trace, .meter)
against the reference's (repro.obs): the cases of tests/test_obs.py on the
port, files written by either package validating under the other's
`validate_trace`, the same StepMeter arithmetic on one sequence of updates,
and `export_sim_spans` of the same modeled timelines giving the same
events. Times are host-clock values, so spans are compared by structure;
everything computed from given numbers is compared exactly.
"""

import json

import pytest
import torch

from repro.configs import cnn_tables
from repro.core import hw as jhw
from repro.core import simulator as jsim
from repro.obs import meter as jmeter
from repro.obs import trace as jtrace
from repro_torch.core import hw
from repro_torch.core import simulator as sim
from repro_torch.obs import meter as obs_meter
from repro_torch.obs import trace as obs_trace


# --------------------------------------------------------------------------
# trace writer
# --------------------------------------------------------------------------

def _fixed_events(w):
    w.name_process(0, "measured")
    w.name_thread(0, 0, "steps")
    w.complete("step0", 0.0, 100.0, pid=0, tid=0, cat="step",
               args={"loss": 1.0})
    w.instant("ckpt", 50.0)
    w.counter("rates", 10.0, {"tokens_per_sec": 123.0,
                              "exposed_comm_share": 0.25})
    return w


def test_trace_round_trip(tmp_path):
    w = _fixed_events(obs_trace.TraceWriter())
    path = w.write(str(tmp_path / "trace.json"))
    obj = obs_trace.load_trace(path)
    assert obj["displayTimeUnit"] == "ms"
    names = [e["name"] for e in obj["traceEvents"]]
    assert "step0" in names and "ckpt" in names
    x = next(e for e in obj["traceEvents"] if e["name"] == "step0")
    assert x["ph"] == "X" and x["dur"] == 100.0 and x["args"]["loss"] == 1.0
    # the same calls give the reference's events, byte for byte
    ref = _fixed_events(jtrace.TraceWriter())
    assert obj == json.loads(json.dumps(ref.to_json()))


def test_trace_span_nesting():
    """Host spans nest by containment: inner X interval inside outer's."""
    w = obs_trace.TraceWriter()
    with w.span("outer", cat="step"):
        with w.span("inner", cat="comm", args={"k": 1}):
            pass
    by_name = {e["name"]: e for e in w.events}
    outer, inner = by_name["outer"], by_name["inner"]
    assert inner["ts"] >= outer["ts"]
    assert inner["ts"] + inner["dur"] <= outer["ts"] + outer["dur"] + 1e-6
    assert inner["cat"] == "comm" and inner["args"] == {"k": 1}
    obs_trace.validate_trace(w.to_json())


def test_trace_span_closes_on_error():
    w = obs_trace.TraceWriter()
    with pytest.raises(RuntimeError):
        with w.span("failing"):
            raise RuntimeError("boom")
    assert [e["name"] for e in w.events] == ["failing"]


def test_trace_spans_reach_the_torch_profiler():
    """A span is also a torch.profiler.record_function range: a profile
    taken around it names it (the reference's TraceAnnotation)."""
    w = obs_trace.TraceWriter()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with w.span("decode/0", cat="serve"):
            torch.ones(4) + 1
    assert "decode/0" in {e.key for e in prof.key_averages()}


def test_trace_metadata_dedup_and_negative_dur():
    w = obs_trace.TraceWriter()
    w.name_process(1, "modeled")
    w.name_process(1, "modeled again")          # deduped
    w.name_thread(1, 2, "comm")
    w.name_thread(1, 2, "comm again")           # deduped
    assert sum(e["ph"] == "M" for e in w.events) == 2
    w.complete("clamp", 10.0, -5.0)             # clamped, never invalid
    assert w.events[-1]["dur"] == 0.0
    obs_trace.validate_trace(w.to_json())


BAD_TRACES = [
    "nope",
    {"traceEvents": "nope"},
    {"traceEvents": [{"ph": "X", "name": "a", "ts": 0.0}]},            # dur
    {"traceEvents": [{"ph": "X", "name": "a", "ts": 0.0, "dur": -1}]},
    {"traceEvents": [{"ph": "B", "name": "a", "ts": 0.0}]},            # no E
    {"traceEvents": [{"ph": "E", "name": "a", "ts": 0.0}]},            # no B
    {"traceEvents": [{"ph": "X", "name": "a", "dur": 1.0}]},           # ts
    {"traceEvents": [{"name": "a", "ts": 0.0}]},                       # ph
    {"traceEvents": [{"ph": "C", "name": "r", "ts": 0.0}]},            # args
    {"traceEvents": [{"ph": "C", "name": "r", "ts": 0.0, "args": {}}]},
    {"traceEvents": [{"ph": "C", "name": "r", "ts": 0.0,
                      "args": {"x": "y"}}]},
    {"traceEvents": [{"ph": "C", "name": "r", "ts": 0.0,
                      "args": {"x": True}}]},
]


@pytest.mark.parametrize("bad", range(len(BAD_TRACES)))
def test_validate_trace_rejects_what_the_reference_rejects(bad):
    obj = BAD_TRACES[bad]
    with pytest.raises(ValueError):
        jtrace.validate_trace(obj)
    with pytest.raises(ValueError):
        obs_trace.validate_trace(obj)


def test_trace_files_validate_across_packages(tmp_path):
    """A file the port writes loads under the reference's validator and
    the other way round (one schema)."""
    ours = obs_trace.TraceWriter()
    with ours.span("step0", cat="step"):
        pass
    ours.counter("rates", ours.now_us(), {"tokens_per_sec": 1.5})
    theirs = jtrace.TraceWriter()
    with theirs.span("step0", cat="step"):
        pass
    theirs.counter("rates", theirs.now_us(), {"tokens_per_sec": 1.5})
    p1 = ours.write(str(tmp_path / "port.json"))
    p2 = theirs.write(str(tmp_path / "ref.json"))
    a, b = jtrace.load_trace(p1), obs_trace.load_trace(p2)
    assert [(e["name"], e["ph"]) for e in a["traceEvents"]] == \
        [(e["name"], e["ph"]) for e in b["traceEvents"]]
    assert set(a) == set(b)


# --------------------------------------------------------------------------
# modeled-timeline export
# --------------------------------------------------------------------------

def _iterations(policy):
    specs = cnn_tables.TOPOLOGIES["resnet50"]()
    got = sim.simulate_iteration(
        sim.layers_from_specs(specs, 32, hw.XEON_6148), 8, hw.ETH_10G,
        sim.Policy(policy), record_timeline=True)
    want = jsim.simulate_iteration(
        jsim.layers_from_specs(specs, 32, jhw.XEON_6148), 8, jhw.ETH_10G,
        jsim.Policy(policy), record_timeline=True)
    return got, want


@pytest.mark.parametrize("policy", [p.value for p in sim.Policy])
def test_export_sim_spans_matches_reference(policy):
    st, jst = _iterations(policy)
    w, jw = obs_trace.TraceWriter(), jtrace.TraceWriter()
    n = obs_trace.export_sim_spans(st.timeline, w, pid=1, track="modeled",
                                   t0_us=5.0)
    assert n == jtrace.export_sim_spans(jst.timeline, jw, pid=1,
                                        track="modeled", t0_us=5.0)
    assert w.events == jw.events
    xs = [e for e in w.events if e["ph"] == "X"]
    assert len(xs) == n == len(st.timeline)

    def total(cat):
        return sum(e["dur"] for e in xs if e["cat"] == cat) / 1e6

    assert total("compute") == pytest.approx(st.compute_time, rel=1e-9)
    assert total("comm") == pytest.approx(st.comm_busy, rel=1e-9)
    obs_trace.validate_trace(w.to_json())


@pytest.mark.parametrize("overlap", [False, True])
def test_export_bucket_schedule_matches_reference(overlap):
    kw = dict(overlap=overlap, record_timeline=True)
    st = sim.simulate_bucket_schedule([1e-3, 2e-3], 4, 5e-3, **kw)
    jst = jsim.simulate_bucket_schedule([1e-3, 2e-3], 4, 5e-3, **kw)
    w, jw = obs_trace.TraceWriter(), jtrace.TraceWriter()
    obs_trace.export_sim_spans(st.timeline, w)
    jtrace.export_sim_spans(jst.timeline, jw)
    assert w.events == jw.events
    xs = [e for e in w.events if e["ph"] == "X"]
    end = max(e["ts"] + e["dur"] for e in xs) / 1e6
    assert end == pytest.approx(st.total_time, rel=1e-9)


# --------------------------------------------------------------------------
# step meter
# --------------------------------------------------------------------------

UPDATES = [dict(dt=0.5, loss=3.0, grad_norm=2.0), dict(dt=0.25),
           dict(dt=0.75, tokens=10.0), dict(dt=0.5, loss=2.5),
           dict(dt=1e-3, grad_norm=0.5)] * 7


@pytest.mark.parametrize("decay", [0.9, 0.5])
def test_meter_equals_reference(decay):
    m = obs_meter.StepMeter(ema_decay=decay, tokens_per_step=100)
    j = jmeter.StepMeter(ema_decay=decay, tokens_per_step=100)
    for i, u in enumerate(UPDATES):
        m.update(**u)
        j.update(**u)
        m.exposed_comm_model = j.exposed_comm_model = (
            None if i % 3 == 0 else 0.01 * i)
        assert (m.step_time, m.tokens_per_sec, m.exposed_comm_frac,
                m.last_loss, m.last_grad_norm, m.steps) == \
            (j.step_time, j.tokens_per_sec, j.exposed_comm_frac,
             j.last_loss, j.last_grad_norm, j.steps)
        assert m.summary() == j.summary()
        assert m.to_metrics("serve") == j.to_metrics("serve")


def test_meter_ema_bias_correction():
    m = obs_meter.StepMeter(ema_decay=0.9, tokens_per_step=100)
    m.update(dt=0.5)
    # after one step the bias-corrected EMA IS the observation
    assert m.step_time == pytest.approx(0.5)
    for _ in range(200):
        m.update(dt=0.5)
    assert m.step_time == pytest.approx(0.5)
    assert m.tokens_per_sec == pytest.approx(200.0)


def test_meter_exposed_frac_and_metrics():
    m = obs_meter.StepMeter()
    assert m.exposed_comm_frac is None
    m.update(dt=0.1, loss=2.0, grad_norm=1.5)
    m.exposed_comm_model = 0.02
    assert m.exposed_comm_frac == pytest.approx(0.2)
    m.exposed_comm_model = 1e9            # model overestimate: capped
    assert m.exposed_comm_frac == 1.0
    assert "loss 2.0000" in m.summary()
    for entry in m.to_metrics():
        assert entry["stable"] is False
    with pytest.raises(ValueError):
        obs_meter.StepMeter().update()    # update without start()


def test_meter_start_update_times_the_step():
    m = obs_meter.StepMeter()
    m.start()
    m.update()
    assert m.steps == 1 and m.last_dt >= 0.0


def test_meter_ledger_compatible(tmp_path):
    """Meter entries record cleanly into a schema-valid ledger."""
    from benchmarks import common as bench_common
    m = obs_meter.StepMeter(tokens_per_step=10)
    m.update(dt=0.01)
    led = bench_common.Ledger("torch_obs_test")
    for entry in m.to_metrics():
        led.record(**entry)
    path = led.write(str(tmp_path))
    rec = json.load(open(path))
    bench_common.validate_ledger(rec)
    assert any(e["name"] == "meter/step_time_us" for e in rec["metrics"])
